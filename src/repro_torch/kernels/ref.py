"""DFT-matrix oracles for the FFT kernels, in torch (float64 ground truth).

Port of ``repro.kernels.ref``. Only the O(N^2) matrix products come over:
they are independent of every FFT schedule in the package, which is what
an oracle has to be.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dft_matmul", "dft2_matmul"]


@functools.lru_cache(maxsize=32)
def _dft_matrix(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n)  # complex128


def dft_matmul(x: torch.Tensor) -> torch.Tensor:
    """DFT along the last axis by an explicit complex128 matrix product."""
    w = torch.from_numpy(_dft_matrix(x.shape[-1])).to(x.device)
    return x.to(torch.complex128) @ w.T


def dft2_matmul(x: torch.Tensor) -> torch.Tensor:
    """2D DFT over the last two axes: W_H @ x @ W_W^T in complex128."""
    wh = torch.from_numpy(_dft_matrix(x.shape[-2])).to(x.device)
    ww = torch.from_numpy(_dft_matrix(x.shape[-1])).to(x.device)
    return wh @ x.to(torch.complex128) @ ww.T
