"""Periodic-plus-smooth decomposition: edge-artifact-free spectra.

Port of ``repro.imaging.psd``. The DFT treats every frame as one period of
a torus; a natural image's opposite borders do not match, so the implicit
wrap is a step edge that stamps a bright cross over the spectrum.
Moisan's periodic-plus-smooth decomposition splits the frame ``x = p + s``
where ``s`` (the *smooth* component) is the harmonic image carrying all
the border mismatch and ``p`` (the *periodic* component) tiles seamlessly.

Mahmood et al. ("2D DFT with Simultaneous Edge Artifact Removal") solve
the smooth component *in the spectrum*: its right-hand side is nonzero only
on the frame border, so its spectrum is a closed form over TWO 1D FFTs of
the border-difference vectors:

    v̂[q, r] = B̂1[r]·(1 − e^{2πiq/H}) + B̂2[q]·(1 − e^{2πir/W})
    ŝ[q, r] = v̂[q, r] / (2cos(2πq/H) + 2cos(2πr/W) − 4),   ŝ[0,0] = 0

where ``b1 = x[H−1,:] − x[0,:]`` and ``b2 = x[:,W−1] − x[:,0]``. That is
what :func:`fft2_psd` computes: one planned 2D transform plus two planned
1D transforms. The axis, norm and scaling contract is the
``repro_torch.xfft`` front door's own. Every grid is made on the input's
device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import xfft
from repro_torch.imaging.registration import hermitian_full
from repro_torch.xfft._transforms import _as_tensor, _canon_axes, _check_norm, _scale

__all__ = ["psd_decompose", "fft2_psd", "smooth_spectrum"]


def _to_last_two(x, axes: Tuple[int, int], name: str):
    x = _as_tensor(x)
    if x.dim() < 2:
        raise ValueError(f"{name} needs at least a 2D image, got shape {tuple(x.shape)}")
    if len(axes) != 2:
        raise ValueError(f"{name} decomposes exactly 2 axes, got {tuple(axes)}")
    canon = _canon_axes(axes, x.dim(), name)
    moved = canon != (x.dim() - 2, x.dim() - 1)
    if moved:
        x = x.movedim(canon, (-2, -1))
    return x, canon, moved


def _poisson_solve(vhat: torch.Tensor, h: int, w: int, q: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """``vhat`` over the discrete Laplacian's symbol at (q, r), with the DC
    term set to zero (the smooth component has zero mean)."""
    denom = (
        2.0 * torch.cos(2.0 * math.pi * q / h)[:, None]
        + 2.0 * torch.cos(2.0 * math.pi * r / w)[None, :]
        - 4.0
    )
    denom[0, 0] = 1.0                                   # avoid 0/0 at DC
    shat = vhat / denom.to(vhat.dtype)
    shat[..., 0, 0] = 0.0
    return shat


def smooth_spectrum(x) -> torch.Tensor:
    """Spectrum (backward norm) of the smooth component of ``(..., H, W)``:
    two planned 1D FFTs of the border differences, a closed-form Poisson
    division, no 2D transform."""
    x = _as_tensor(x)
    h, w = x.shape[-2], x.shape[-1]
    cdt = x.dtype if x.is_complex() else torch.complex64
    b1 = (x[..., -1, :] - x[..., 0, :]).to(cdt)       # (..., W)
    b2 = (x[..., :, -1] - x[..., :, 0]).to(cdt)       # (..., H)
    bhat1 = xfft.fft(b1)                              # planned length-W pass
    bhat2 = xfft.fft(b2)                              # planned length-H pass
    q = torch.arange(h, dtype=torch.float32, device=x.device)
    r = torch.arange(w, dtype=torch.float32, device=x.device)
    fq = (1.0 - torch.exp(2j * math.pi * q / h)).to(bhat1.dtype)   # (H,)
    fr = (1.0 - torch.exp(2j * math.pi * r / w)).to(bhat1.dtype)   # (W,)
    vhat = bhat1[..., None, :] * fq[:, None] + bhat2[..., :, None] * fr[None, :]
    return _poisson_solve(vhat, h, w, q, r)


def _smooth_spectrum_half(x: torch.Tensor) -> torch.Tensor:
    """Half-width smooth spectrum ``shat[..., :, :W/2+1]`` of a REAL frame.

    The two-for-one route of :func:`smooth_spectrum`: real border
    differences take ``rfft``, the row-axis half is Hermitian-extended
    (1D flip + conj, no transform), and the Poisson division runs only on
    the half the real 2D path consumes.
    """
    h, w = x.shape[-2], x.shape[-1]
    wh = w // 2 + 1
    bhat1 = xfft.rfft(x[..., -1, :] - x[..., 0, :])   # (..., W/2+1)
    bhat2h = xfft.rfft(x[..., :, -1] - x[..., :, 0])  # (..., H/2+1)
    # full-length row spectrum by Hermitian symmetry: B2[q] = conj(B2[H-q])
    tail = torch.conj_physical(torch.flip(bhat2h[..., 1:h - h // 2], dims=(-1,)))
    bhat2 = torch.cat([bhat2h, tail], dim=-1)         # (..., H)
    q = torch.arange(h, dtype=torch.float32, device=x.device)
    r = torch.arange(wh, dtype=torch.float32, device=x.device)
    fq = (1.0 - torch.exp(2j * math.pi * q / h)).to(bhat1.dtype)
    fr = (1.0 - torch.exp(2j * math.pi * r / w)).to(bhat1.dtype)
    vhat = bhat1[..., None, :wh] * fq[:, None] + bhat2[..., :, None] * fr[None, :]
    return _poisson_solve(vhat, h, w, q, r)


def psd_decompose(x, axes: Tuple[int, int] = (-2, -1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` into ``(periodic, smooth)`` with ``periodic + smooth == x``.

    The periodic component tiles seamlessly (opposite borders match), so
    its spectrum carries no cross artifact; the smooth component is the
    harmonic border-mismatch image. Leading axes are batched.
    """
    x, canon, moved = _to_last_two(x, axes, "psd_decompose")
    if not x.is_complex():
        # two-for-one: a real frame's smooth component is real, so one
        # irfft2 of the half spectrum does
        smooth = xfft.irfft2(_smooth_spectrum_half(x)).to(x.dtype)
    else:
        smooth = xfft.ifft2(smooth_spectrum(x))
    periodic = x - smooth
    if moved:
        periodic = periodic.movedim((-2, -1), canon)
        smooth = smooth.movedim((-2, -1), canon)
    return periodic, smooth


def fft2_psd(x, axes: Tuple[int, int] = (-2, -1), norm: Optional[str] = None) -> torch.Tensor:
    """2D spectrum of the *periodic* component of ``x``: ``fft2`` minus the
    in-spectrum smooth solve (Mahmood et al.'s simultaneous edge-artifact
    removal). Same shape, layout and ``norm`` conventions as
    :func:`repro_torch.xfft.fft2`. Real frames take the two-for-one route
    throughout (``rfft2`` plus the half-width smooth solve); the Hermitian
    half spectrum is expanded to full width only at the end."""
    norm = _check_norm(norm)
    x, canon, moved = _to_last_two(x, axes, "fft2_psd")
    h, w = x.shape[-2], x.shape[-1]
    if not x.is_complex():
        shat_h = _scale(_smooth_spectrum_half(x), norm, h * w, forward=True)
        phat = hermitian_full(xfft.rfft2(x, norm=norm) - shat_h, w)
    else:
        shat = _scale(smooth_spectrum(x), norm, h * w, forward=True)
        phat = xfft.fft2(x, norm=norm) - shat
    return phat.movedim((-2, -1), canon) if moved else phat
