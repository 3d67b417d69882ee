"""Multi-coil Cartesian MRI operators on the planned transform stack.

Port of ``repro.mri.operators``. The encoding model of parallel (SENSE)
MRI: an array of ``C`` receive coils sees the object ``x`` through
per-coil sensitivity profiles ``S_c``, and the scanner samples each
coil's centered k-space on a Cartesian grid masked by the undersampling
pattern ``M``:

    y_c = M · F(S_c · x)                (forward, per coil)
    x̃  = Σ_c S_c* · F⁻¹(M · y_c)        (adjoint)

``F`` is the centered, ortho-normalised 2D transform of
:func:`repro_torch.imaging.kspace.image_to_kspace`, so ``F`` is unitary and
the pair above is a true adjoint pair: ``<A x, y> == <x, Aᴴ y>``, the
identity every iterative reconstruction (:mod:`repro_torch.mri.recon`)
leans on.

Every transform resolves through ``repro_torch.xfft`` → ``repro_torch.plan``:
the coil and frame axes ride the batched leading axes of ONE planned
``fft2`` a call, so on the card the fused kernels run the whole coil
stack, and a ``precision="double"`` scope runs it at complex128.

Entry points take the tensors' device: numpy or Python arguments join the
first tensor argument's device, and with no tensor argument go to
``torch.device("cuda")`` (raising where CUDA is absent), as ``xfft`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.imaging.kspace import image_to_kspace, kspace_to_image
from repro_torch.xfft._transforms import _default_device

__all__ = ["apply_mask", "sense_forward", "sense_adjoint", "rss_combine"]


def _tensors(*xs):
    """``xs`` as tensors on one device: that of the first tensor among them,
    else the card. ``None`` stays ``None``."""
    device = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if device is None:
        device = _default_device()
    return tuple(
        x if x is None or isinstance(x, torch.Tensor)
        else torch.as_tensor(np.asarray(x), device=device)
        for x in xs
    )


def _as_mask(mask: torch.Tensor) -> torch.Tensor:
    """Sampling mask as a real multiplicand: bool masks become float32
    (complex·bool promotion is surprising); real dtypes pass through, so
    multiplying complex k-space by a real mask keeps the k-space dtype."""
    return mask.to(torch.float32) if mask.dtype == torch.bool else mask


def apply_mask(kspace, mask) -> torch.Tensor:
    """Zero the unsampled k-space locations: ``M · y``.

    ``mask`` broadcasts against the trailing axes of ``kspace`` — a
    ``(H, W)`` mask masks every coil/frame of a ``(..., C, H, W)``
    array; a per-shot ``(S, 1, H, W)`` mask masks per shot.
    """
    kspace, mask = _tensors(kspace, mask)
    return kspace * _as_mask(mask)


def sense_forward(image, smaps, mask=None) -> torch.Tensor:
    """SENSE forward model: image ``(..., H, W)`` -> k-space ``(..., C, H, W)``.

    ``smaps`` is ``(..., C, H, W)`` (leading axes broadcast against the
    image's). The coil axis rides the batched leading axes of one
    planned centered ``fft2``; ``mask=None`` means fully sampled.
    """
    image, smaps, mask = _tensors(image, smaps, mask)
    if image.dim() < 2:
        raise ValueError(f"image must be (..., H, W), got shape {tuple(image.shape)}")
    if smaps.dim() < 3:
        raise ValueError(f"smaps must be (..., C, H, W), got shape {tuple(smaps.shape)}")
    if smaps.shape[-2:] != image.shape[-2:]:
        raise ValueError(
            f"smaps frame {tuple(smaps.shape[-2:])} does not match "
            f"image frame {tuple(image.shape[-2:])}"
        )
    kspace = image_to_kspace(smaps * image[..., None, :, :])
    return kspace if mask is None else apply_mask(kspace, mask)


def sense_adjoint(kspace, smaps, mask=None) -> torch.Tensor:
    """SENSE adjoint: k-space ``(..., C, H, W)`` -> image ``(..., H, W)``.

    The exact adjoint of :func:`sense_forward` under the ortho-normalised
    centered transform: mask, inverse-transform every coil (one planned
    ``ifft2``), weight by conjugate sensitivities, sum over coils.
    """
    kspace, smaps, mask = _tensors(kspace, smaps, mask)
    if kspace.dim() < 3:
        raise ValueError(f"kspace must be (..., C, H, W), got shape {tuple(kspace.shape)}")
    if smaps.shape[-3:] != kspace.shape[-3:]:
        raise ValueError(
            f"smaps coil block {tuple(smaps.shape[-3:])} does not match "
            f"kspace coil block {tuple(kspace.shape[-3:])}"
        )
    if mask is not None:
        kspace = apply_mask(kspace, mask)
    coil_images = kspace_to_image(kspace)
    return (torch.conj(smaps) * coil_images).sum(dim=-3)


def rss_combine(coil_images, axis: int = -3) -> torch.Tensor:
    """Root-sum-of-squares coil combination: ``sqrt(Σ_c |x_c|²)``.

    The sensitivity-free magnitude combine — the standard display/
    reference image when no maps are available, and the normaliser the
    ESPIRiT-lite map estimate divides by.
    """
    (coil_images,) = _tensors(coil_images)
    return torch.sqrt(torch.sum(coil_images.abs() ** 2, dim=axis))
