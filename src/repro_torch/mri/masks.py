"""Reproducible Cartesian undersampling masks + ESPIRiT-lite coil maps.

Port of ``repro.mri.masks``. Cartesian MRI undersamples along the
phase-encode axis (rows here): a mask keeps whole k-space rows, and the
acceleration factor ``R`` is the ratio of total to kept rows. Two
generators:

* :func:`uniform_mask` — every ``R``-th row (the classic SENSE pattern,
  coherent fold-over aliasing), plus a fully-sampled calibration block;
* :func:`variable_density_mask` — seeded random rows with a Gaussian
  density concentrated at the k-space centre (incoherent aliasing, the
  pattern iterative reconstruction prefers), plus the calibration block.

Both are the port's own copies of the reference's numpy code, bit for bit:
mask generation is a *fixture*, it must be bit-reproducible from its seed
and must not exercise the transform engines under test.

:func:`estimate_sensitivities` is the ESPIRiT-lite map estimate: window
the fully-sampled calibration region, one planned low-resolution inverse
transform for the whole coil stack, normalise by the root-sum-of-squares
image. Good enough to close the CG-SENSE loop without carrying the full
ESPIRiT eigen-decomposition.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "uniform_mask",
    "variable_density_mask",
    "acceleration",
    "estimate_sensitivities",
]


def _check_mask_args(shape: Tuple[int, int], accel: int, calib: int) -> None:
    if len(shape) != 2:
        raise ValueError(f"mask shape must be (H, W), got {tuple(shape)}")
    if accel < 1:
        raise ValueError(f"acceleration must be >= 1, got {accel}")
    if not 0 <= calib <= shape[0]:
        raise ValueError(
            f"calibration rows must be in 0..{shape[0]}, got {calib}"
        )


def _calib_rows(h: int, calib: int) -> slice:
    start = (h - calib) // 2
    return slice(start, start + calib)


def uniform_mask(
    shape: Tuple[int, int], accel: int, calib: int = 16
) -> np.ndarray:
    """Every ``accel``-th phase-encode row + a centred ``calib``-row block.

    Returns a float32 ``(H, W)`` mask. Row 0 is always kept, so the
    pattern is deterministic without a seed.
    """
    _check_mask_args(shape, accel, calib)
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    mask[::accel, :] = 1.0
    if calib:
        mask[_calib_rows(h, calib), :] = 1.0
    return mask


def variable_density_mask(
    shape: Tuple[int, int], accel: int, calib: int = 16, seed: int = 0
) -> np.ndarray:
    """Seeded random rows, Gaussian-dense at the centre, calib block kept.

    The per-row keep probability is a Gaussian in the distance from the
    k-space centre, scaled so the EXPECTED kept-row count is ``H/accel``
    (calibration rows count toward the budget; probabilities clip at 1).
    Same ``(shape, accel, calib, seed)`` -> bit-identical mask.
    """
    _check_mask_args(shape, accel, calib)
    h, w = shape
    rows = np.arange(h, dtype=np.float64)
    dist = np.abs(rows - h / 2.0) / (h / 2.0)            # 0 centre .. 1 edge
    density = np.exp(-(dist**2) / (2 * 0.35**2))
    target = h / accel
    density *= target / density.sum()
    # iterate the clip-renormalise once: clipped centre rows push their
    # excess budget outward instead of silently under-sampling
    excess = np.clip(density - 1.0, 0.0, None).sum()
    density = np.clip(density, 0.0, 1.0)
    tail = density < 1.0
    if excess > 0 and tail.any():
        density[tail] += excess * density[tail] / density[tail].sum()
        density = np.clip(density, 0.0, 1.0)
    keep = np.random.default_rng(seed).random(h) < density
    if calib:
        keep[_calib_rows(h, calib)] = True
    mask = np.zeros((h, w), np.float32)
    mask[keep, :] = 1.0
    return mask


def acceleration(mask) -> float:
    """The realised acceleration factor ``R = size / samples`` of a mask.

    A tensor mask is counted where it lies, with one host read."""
    if isinstance(mask, torch.Tensor):
        size, kept = mask.numel(), float((mask != 0).sum().item())
    else:
        mask = np.asarray(mask)
        size, kept = mask.size, float((mask != 0).sum())
    if kept == 0:
        raise ValueError("mask keeps no samples")
    return size / kept


def estimate_sensitivities(
    kspace,
    calib: int = 16,
    eps: float = 1e-6,
    mask=None,
) -> torch.Tensor:
    """ESPIRiT-lite sensitivity maps from the calibration region.

    ``kspace``: centered ``(..., C, H, W)`` multi-coil data whose
    central ``calib`` rows (and columns) are fully sampled. A smooth
    (Hann) window over that block suppresses truncation ringing; one
    planned inverse transform gives low-resolution coil images, and the
    maps are those images normalised by their root-sum-of-squares:

        S_c = lowres_c / (RSS(lowres) + eps)

    so ``RSS(S) ≈ 1`` wherever the object has signal — which makes the
    CG-SENSE normal operator well conditioned. ``mask`` is accepted for
    convenience (it is ignored beyond a sanity check that the
    calibration block is actually sampled).
    """
    from repro_torch.imaging.kspace import kspace_to_image
    from repro_torch.mri.operators import _tensors, rss_combine

    (kspace,) = _tensors(kspace)
    if kspace.dim() < 3:
        raise ValueError(f"kspace must be (..., C, H, W), got shape {tuple(kspace.shape)}")
    h, w = kspace.shape[-2], kspace.shape[-1]
    if not 0 < calib <= min(h, w):
        raise ValueError(f"calib must be in 1..{min(h, w)}, got {calib}")
    if mask is not None:
        block = (mask if isinstance(mask, torch.Tensor) else np.asarray(mask))[
            _calib_rows(h, calib), :]
        if not bool((block != 0).all()):
            raise ValueError(
                "mask does not fully sample the calibration block "
                f"(central {calib} rows)"
            )

    def axis_window(n: int, keep: int) -> np.ndarray:
        win = np.zeros(n, np.float32)
        start = (n - keep) // 2
        win[start:start + keep] = np.hanning(keep + 2)[1:-1].astype(np.float32)
        return win

    window = torch.from_numpy(np.outer(axis_window(h, calib), axis_window(w, calib)))
    lowres = kspace_to_image(kspace * window.to(kspace.device))
    rss = rss_combine(lowres)
    return lowres / (rss[..., None, :, :] + eps)
