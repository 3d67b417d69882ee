"""Separable 2D FFT: row pass, then column pass (the paper's fig. 1).

Port of ``repro.core.fft2d``. The ``fused`` variants run the whole frame in
one CUDA block when it fits, else the row / corner turn / column
composition on the 1D kernel (``repro_torch.kernels.ops.fft2_kernel``).
The streaming ping-pong pipeline (``fft2_stream``) is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.core.fft1d import _check_variant, fft_impl, ifft_impl
from repro_torch.kernels.ops import fft2_kernel

__all__ = ["fft2_impl", "ifft2_impl", "fftshift2", "ifftshift2"]


def _radix(variant: str) -> int:
    return 4 if variant == "fused_r4" else 2


def fft2_impl(x: torch.Tensor, variant: str = "stockham",
              dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """2D FFT over the last two axes under ``variant``; ``dtype``
    (complex64, or complex128 on a plain schedule)."""
    _check_variant(variant, dtype)
    if variant in ("fused", "fused_r4"):
        return fft2_kernel(x, radix=_radix(variant))
    y = fft_impl(x, axis=-1, variant=variant, dtype=dtype)   # rows
    return fft_impl(y, axis=-2, variant=variant, dtype=dtype)  # columns


def ifft2_impl(x: torch.Tensor, variant: str = "stockham",
               dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Inverse 2D FFT. The fused kernels conjugate on the way in and out
    and scale by 1/(H W) inside, the identity the reference applies around
    its kernel; the schedules invert each pass."""
    _check_variant(variant, dtype)
    if variant in ("fused", "fused_r4"):
        return fft2_kernel(x, radix=_radix(variant), inverse=True)
    y = ifft_impl(x, axis=-1, variant=variant, dtype=dtype)
    return ifft_impl(y, axis=-2, variant=variant, dtype=dtype)


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """Centre the zero-frequency bin of the trailing two axes."""
    return torch.roll(x, shifts=(x.shape[-2] // 2, x.shape[-1] // 2), dims=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`fftshift2` (rolls by the negated half sizes,
    which matters for odd lengths)."""
    return torch.roll(
        x, shifts=(-(x.shape[-2] // 2), -(x.shape[-1] // 2)), dims=(-2, -1)
    )
