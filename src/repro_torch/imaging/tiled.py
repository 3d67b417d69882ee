"""Overlap-save tiled FFT convolution: frames bigger than any transform.

Port of ``repro.imaging.tiled``. The whole-frame kernels run a frame in
one block only while it fits the block's shared memory; imaging inputs
(stitched microscopy, holograms, wide-area correlation scenes) are far
larger. Overlap-save is the classical answer: slide a block-sized tile
with ``K − 1`` overlap across the frame, circularly convolve each tile in
the spectrum, keep each tile's valid interior, and the seams vanish by
construction.

The tile is a *planning* decision: small tiles waste work on overlap, big
tiles on padding, and past the whole-frame kernels' shared-memory census
(``repro_torch.kernels.ops.fft2_fits_budget``) a tile leaves the one-block
kernels for the composed passes. ``oaconvolve2`` therefore asks
``repro_torch.plan`` (problem kind ``oaconv2d``) for the tile, on the
image's device. The tile stack goes through one batched ``rfft2`` /
``irfft2`` (or complex) call per direction, and every transform goes
through ``repro_torch.xfft``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import xfft
from repro_torch.core.spectral import _next_pow2
from repro_torch.plan.api import resolve_call
from repro_torch.xfft._transforms import _as_tensor

__all__ = ["oaconvolve2", "fftconv2", "matched_filter2"]


def _check_2d_pair(image, kernel, name: str):
    image = _as_tensor(image)
    kernel = _as_tensor(kernel).to(image.device)
    if image.dim() < 2 or kernel.dim() < 2:
        raise ValueError(
            f"{name} needs (..., H, W) image and (..., KH, KW) kernel, got "
            f"{tuple(image.shape)} and {tuple(kernel.shape)}"
        )
    return image, kernel


def _crop_mode(full: torch.Tensor, h: int, w: int, kh: int, kw: int,
               mode: str) -> torch.Tensor:
    """Crop a full (H+KH−1, W+KW−1) convolution to ``mode`` (scipy names)."""
    if mode == "full":
        return full
    if mode == "same":
        top, left = (kh - 1) // 2, (kw - 1) // 2
        return full[..., top:top + h, left:left + w]
    if mode == "valid":
        if kh > h or kw > w:
            raise ValueError(
                f"valid-mode convolution needs kernel <= image, got "
                f"({kh}, {kw}) vs ({h}, {w})"
            )
        return full[..., kh - 1:h, kw - 1:w]
    raise ValueError(f'mode must be "full", "same" or "valid", got {mode!r}')


def _pad_tail(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, w - x.shape[-1], 0, h - x.shape[-2]))


def _spectral_multiply(a: torch.Tensor, b: torch.Tensor, real: bool) -> torch.Tensor:
    """Circular convolution of equal-size frames through planned FFTs."""
    if real:
        return xfft.irfft2(xfft.rfft2(a) * xfft.rfft2(b))
    return xfft.ifft2(xfft.fft2(a) * xfft.fft2(b))


def fftconv2(image, kernel, mode: str = "full") -> torch.Tensor:
    """Linear 2D convolution via ONE padded transform pair (plan-backed).

    The reference and small-input path: both operands zero-pad to the
    power-of-two cover of (H+KH−1, W+KW−1) and multiply in the spectrum.
    Use :func:`oaconvolve2` when the padded frame outgrows a sensible
    single transform. Kernel leading axes broadcast against the image's.
    """
    image, kernel = _check_2d_pair(image, kernel, "fftconv2")
    h, w = image.shape[-2], image.shape[-1]
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    fh, fw = h + kh - 1, w + kw - 1
    ph, pw = _next_pow2(fh), _next_pow2(fw)
    real = not image.is_complex() and not kernel.is_complex()
    if not real:
        image = image.to(torch.complex64)
        kernel = kernel.to(torch.complex64)
    full = _spectral_multiply(
        _pad_tail(image, ph, pw), _pad_tail(kernel, ph, pw), real
    )[..., :fh, :fw]
    return _crop_mode(full, h, w, kh, kw, mode)


def _gather_tiles(xp: torch.Tensor, th: int, tw: int, sh: int, sw: int) -> torch.Tensor:
    """(..., PH, PW) -> (..., nbh, nbw, th, tw) overlapping tile stack with
    steps (sh, sw), a strided view of ``xp`` (PH = (nbh−1)·sh + th,
    PW = (nbw−1)·sw + tw)."""
    return xp.unfold(-2, th, sh).unfold(-2, tw, sw)


def oaconvolve2(
    image,
    kernel,
    mode: str = "same",
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Overlap-save tiled FFT convolution of (..., H, W) with (..., KH, KW).

    The frame streams through (TH, TW) tiles with (KH−1, KW−1) overlap, the
    whole tile stack one planned ``rfft2``/``irfft2`` (or complex) round
    trip, seams exact by construction. ``tile=None`` asks the planner
    (problem kind ``oaconv2d``) on the image's device for the tile that
    best trades overlap waste against padding waste within the whole-frame
    kernels' census. Kernel leading axes broadcast against the image's.
    Matches :func:`fftconv2` to fp32 tolerance.
    """
    image, kernel = _check_2d_pair(image, kernel, "oaconvolve2")
    h, w = image.shape[-2], image.shape[-1]
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    real = not image.is_complex() and not kernel.is_complex()
    if tile is None:
        tile = resolve_call("oaconv2d", (h, w, kh, kw), image.device,
                            dtype="float32" if real else "complex64").tile
    th, tw = int(tile[0]), int(tile[1])
    if th < kh or tw < kw:
        raise ValueError(
            f"tile {(th, tw)} smaller than kernel {(kh, kw)}: the "
            "overlap-save step T-K+1 would be empty"
        )
    fh, fw = h + kh - 1, w + kw - 1
    sh, sw = th - kh + 1, tw - kw + 1
    nbh, nbw = math.ceil(fh / sh), math.ceil(fw / sw)
    if nbh * nbw == 1:
        # One tile covers the whole output: the single-transform path is
        # the same arithmetic without the gather.
        return fftconv2(image, kernel, mode=mode)
    if not real:
        image = image.to(torch.complex64)
        kernel = kernel.to(torch.complex64)
    ph = (nbh - 1) * sh + th
    pw = (nbw - 1) * sw + tw
    xp = torch.nn.functional.pad(image, (kw - 1, pw - (kw - 1) - w, kh - 1, ph - (kh - 1) - h))
    tiles = _gather_tiles(xp, th, tw, sh, sw)
    kf = _pad_tail(kernel, th, tw)[..., None, None, :, :]  # broadcast over tiles
    out = _spectral_multiply(tiles, kf, real)
    valid = out[..., kh - 1:, kw - 1:]                # (..., nbh, nbw, sh, sw)
    joined = valid.movedim(-3, -2)                    # (..., nbh, sh, nbw, sw)
    full = joined.reshape(*joined.shape[:-4], nbh * sh, nbw * sw)
    return _crop_mode(full[..., :fh, :fw], h, w, kh, kw, mode)


def matched_filter2(
    scene,
    template,
    mode: str = "same",
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Cross-correlate ``scene`` with ``template`` at any scene size — the
    paper's correlation-pattern-recognition workload, tiled.

    ``corr[i, j] = Σ scene[i+u, j+v]·conj(template[u, v])``, computed as an
    overlap-save convolution with the conjugate-flipped template. The peak
    of the result locates the template.
    """
    template = _as_tensor(template)
    flipped = torch.conj_physical(torch.flip(template, dims=(-2, -1)))
    return oaconvolve2(scene, flipped, mode=mode, tile=tile)
