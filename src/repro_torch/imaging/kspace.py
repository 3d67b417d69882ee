"""Centered k-space transforms — the MRI community's convention.

Port of ``repro.imaging.kspace``. MRI raw data ("k-space") puts the
zero-frequency sample at the ARRAY CENTRE, not at index 0, and uses the
unitary (``ortho``) scaling so the forward/adjoint pair of iterative
reconstruction is an isometry:

    kspace = fftshift(fft2(ifftshift(image)))     # norm="ortho"
    image  = fftshift(ifft2(ifftshift(kspace)))

The inner transform resolves through ``repro_torch.plan`` like any other
``repro_torch.xfft`` call, the shifts are index rolls, and leading axes
(coils, frames, slices) batch through untouched.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import xfft
from repro_torch.xfft._transforms import _as_tensor, _cdtype

__all__ = ["image_to_kspace", "kspace_to_image"]


def _complex(x) -> torch.Tensor:
    """``x`` as a tensor; real input is upcast to the scope's complex dtype
    (complex128 under ``xfft.config(precision="double")``), complex input
    keeps its dtype: complex128 is never cast down here."""
    x = _as_tensor(x)
    return x if x.is_complex() else x.to(_cdtype())


def image_to_kspace(
    image,
    axes: Tuple[int, int] = (-2, -1),
    norm: Optional[str] = "ortho",
) -> torch.Tensor:
    """Image -> centered k-space over ``axes`` (leading axes batched).

    ``fftshift(fft2(ifftshift(image)))`` with unitary scaling by default:
    ``kspace_to_image(image_to_kspace(x)) == x`` and energy is preserved
    (Parseval) — the contract iterative reconstruction relies on.
    """
    shifted = xfft.ifftshift(_complex(image), axes=axes)
    return xfft.fftshift(xfft.fft2(shifted, axes=axes, norm=norm), axes=axes)


def kspace_to_image(
    kspace,
    axes: Tuple[int, int] = (-2, -1),
    norm: Optional[str] = "ortho",
) -> torch.Tensor:
    """Centered k-space -> image over ``axes`` (exact inverse of
    :func:`image_to_kspace` under the same ``norm``)."""
    shifted = xfft.ifftshift(_complex(kspace), axes=axes)
    return xfft.fftshift(xfft.ifft2(shifted, axes=axes, norm=norm), axes=axes)
