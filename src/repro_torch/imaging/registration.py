"""Translation registration / motion correction via phase correlation.

Port of ``repro.imaging.registration``. The cross-power spectrum of two
frames is a pure phase ramp whose inverse transform is a delta at the
displacement:

    R = F(ref) · conj(F(mov)) / |F(ref) · conj(F(mov))|
    corr = IFFT2(R)  →  peak at the shift

Whole-pixel estimation is one planned forward/inverse transform pair (the
two-for-one real path for camera/MRI magnitude frames). Subpixel
refinement is the Guizar-Sicairos upsampled-DFT trick: evaluate the
inverse transform on a tiny ``O(1.5·u)²`` grid around the coarse peak by
matrix-multiply DFT at ``u``× upsampling.

Conventions match ``skimage.registration.phase_cross_correlation``: the
returned ``(dy, dx)`` is the shift to APPLY to ``mov`` to register it onto
``ref`` — ``apply_shift(mov, register_phase_correlation(ref, mov)) ≈ ref``.
Every grid and ramp is made on the frames' device.
"""

from __future__ import annotations

import math

import torch

from repro_torch import xfft
from repro_torch.xfft._transforms import _as_tensor

__all__ = [
    "register_phase_correlation",
    "register_logpolar",
    "apply_shift",
    "hermitian_full",
]


def hermitian_full(rh: torch.Tensor, w: int) -> torch.Tensor:
    """Full-width spectrum from its Hermitian (..., H, W/2+1) half.

    A real frame's spectrum satisfies ``R[q, r] = conj(R[−q mod H, W−r])``,
    so the missing columns are a conjugated, double-flipped copy of
    columns ``1 .. W/2−1``: no second (complex) transform is needed.
    """
    tail = torch.conj_physical(rh[..., :, 1:w - w // 2])     # cols 1 .. W/2-1
    tail = torch.flip(tail, dims=(-1,))                       # -> cols W-1 .. W/2+1
    tail = torch.roll(torch.flip(tail, dims=(-2,)), 1, dims=-2)  # row q -> (-q) mod H
    return torch.cat([rh, tail], dim=-1)


def _upsampled_peak(r_full: torch.Tensor, coarse: torch.Tensor, upsample: int) -> torch.Tensor:
    """Refine per-item peaks by evaluating IFFT2(R) on a ±(region/2u)
    window around ``coarse`` at ``u``× upsampling (matrix-multiply DFT)."""
    dev = r_full.device
    h, w = r_full.shape[-2], r_full.shape[-1]
    region = int(math.ceil(1.5 * upsample))
    centre = region // 2
    grid = (torch.arange(region, dtype=torch.float32, device=dev) - centre) / upsample
    fy = xfft.fftfreq(h, dtype=torch.float32, device=dev)      # cycles/sample
    fx = xfft.fftfreq(w, dtype=torch.float32, device=dev)
    ys = coarse[..., 0:1] + grid                               # (..., region)
    xs = coarse[..., 1:2] + grid
    ey = torch.exp(2j * math.pi * ys[..., :, None] * fy)     # (..., region, H)
    ex = torch.exp(2j * math.pi * xs[..., :, None] * fx)     # (..., region, W)
    cc = torch.einsum("...ah,...hw,...bw->...ab", ey, r_full.to(ey.dtype), ex)
    flat = cc.abs().reshape(*cc.shape[:-2], region * region)
    idx = torch.argmax(flat, dim=-1)                           # the first maximum
    dy = (idx // region).to(torch.float32)
    dx = (idx % region).to(torch.float32)
    return torch.stack(
        [coarse[..., 0] + (dy - centre) / upsample,
         coarse[..., 1] + (dx - centre) / upsample],
        dim=-1,
    )


def register_phase_correlation(
    ref,
    mov,
    upsample_factor: int = 1,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Estimate the (dy, dx) translation registering ``mov`` onto ``ref``.

    ``ref``/``mov``: (..., H, W), real or complex, leading axes batched —
    one planned transform pair serves the whole batch. Returns float32
    ``(..., 2)``. ``upsample_factor > 1`` adds subpixel refinement to
    within ``1/upsample_factor`` px (Guizar-Sicairos upsampled DFT).
    """
    ref = _as_tensor(ref)
    mov = _as_tensor(mov).to(ref.device)
    if ref.shape != mov.shape:
        raise ValueError(
            f"ref and mov must share a shape, got {tuple(ref.shape)} vs {tuple(mov.shape)}"
        )
    if ref.dim() < 2:
        raise ValueError(f"need (..., H, W) frames, got shape {tuple(ref.shape)}")
    h, w = ref.shape[-2], ref.shape[-1]
    real = not ref.is_complex() and not mov.is_complex()
    if real:
        fr_ = xfft.rfft2(ref)
        fm = xfft.rfft2(mov)
    else:
        fr_ = xfft.fft2(ref.to(torch.complex64))
        fm = xfft.fft2(mov.to(torch.complex64))
    r = fr_ * torch.conj(fm)
    r = r / torch.clamp(r.abs(), min=eps)               # pure phase ramp
    corr = xfft.irfft2(r) if real else torch.real(xfft.ifft2(r))
    idx = torch.argmax(corr.reshape(*corr.shape[:-2], h * w), dim=-1)
    py = idx // w
    px = idx % w
    coarse = torch.stack(
        [torch.where(py > h // 2, py - h, py).to(torch.float32),
         torch.where(px > w // 2, px - w, px).to(torch.float32)],
        dim=-1,
    )
    if upsample_factor <= 1:
        return coarse
    r_full = hermitian_full(r, w) if real else r
    return _upsampled_peak(r_full, coarse, int(upsample_factor))


def _bilinear(img: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``img`` (..., H, W) sampled at (``rows``, ``cols``) by linear
    interpolation, with the semantics of
    ``jax.scipy.ndimage.map_coordinates(order=1, mode="constant", cval=0)``:
    each of the four neighbours contributes weight × value, and a neighbour
    outside the frame contributes zero (scipy treats the border otherwise).
    The four terms are summed in JAX's order."""
    h, w = img.shape[-2], img.shape[-1]
    nodes = []
    for coord in (rows, cols):
        lower = torch.floor(coord)
        upper_weight = coord - lower
        index = lower.to(torch.int64)
        nodes.append(((index, 1 - upper_weight), (index + 1, upper_weight)))
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            value = img[..., iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
            term = (wy * wx) * torch.where(valid, value, torch.zeros_like(value))
            out = term if out is None else out + term
    return out.to(img.dtype)


def _logpolar_resample(mag: torch.Tensor) -> torch.Tensor:
    """Resample a centred (H, W) magnitude spectrum onto a log-polar grid.

    Rows sweep θ over [0, π) (a real frame's magnitude spectrum is
    point-symmetric, so the half-turn carries all the information and the
    axis stays circular for phase correlation); columns sweep radius
    log-uniformly from 1 to ``min(H, W)/2 − 1``. The output keeps the
    (H, W) shape, so both axes stay pow2 for the planned transforms that
    phase correlation runs next.
    """
    dev = mag.device
    h, w = mag.shape[-2], mag.shape[-1]
    n_theta, n_r = h, w
    rmax = min(h, w) / 2.0 - 1.0
    theta = torch.arange(n_theta, dtype=torch.float32, device=dev) * (math.pi / n_theta)
    logr = torch.exp(
        torch.arange(n_r, dtype=torch.float32, device=dev) * (math.log(rmax) / (n_r - 1))
    )
    rows = h / 2.0 + logr[None, :] * torch.sin(theta)[:, None]
    cols = w / 2.0 + logr[None, :] * torch.cos(theta)[:, None]
    return _bilinear(mag, rows, cols)


def register_logpolar(ref, mov, upsample_factor: int = 10):
    """Estimate the rotation + scale of ``mov`` relative to ``ref``.

    The Fourier-Mellin trick: a rotation of the frame rotates its spectrum
    magnitude, an isotropic scale by ``s`` scales it by ``1/s``, and on a
    log-polar resampling of the magnitude both become pure translations
    (rotation along θ, log-scale along log-r), which
    :func:`register_phase_correlation` recovers to subpixel precision. The
    magnitude comes from :func:`repro_torch.imaging.psd.fft2_psd`, so the
    border cross artifact never enters.

    Returns ``(angle, scale)`` floats: ``mov`` looks like ``ref`` rotated
    by ``angle`` radians (counter-clockwise, y-up convention) and magnified
    by ``scale`` about the centre. 2D frames only; the angle is recovered
    modulo π.
    """
    from repro_torch.imaging.psd import fft2_psd  # lazy: psd imports hermitian_full

    ref = _as_tensor(ref)
    mov = _as_tensor(mov).to(ref.device)
    if ref.dim() != 2 or mov.dim() != 2:
        raise ValueError(
            f"register_logpolar takes single (H, W) frames, got "
            f"{tuple(ref.shape)} and {tuple(mov.shape)}"
        )
    if ref.shape != mov.shape:
        raise ValueError(
            f"ref and mov must share a shape, got {tuple(ref.shape)} vs {tuple(mov.shape)}"
        )
    h, w = ref.shape
    lp_ref = _logpolar_resample(torch.log1p(xfft.fftshift2(fft2_psd(ref)).abs()))
    lp_mov = _logpolar_resample(torch.log1p(xfft.fftshift2(fft2_psd(mov)).abs()))
    d_theta, d_logr = register_phase_correlation(
        lp_ref, lp_mov, upsample_factor=upsample_factor
    ).tolist()
    rmax = min(h, w) / 2.0 - 1.0
    angle = d_theta * (math.pi / h)
    scale = math.exp(d_logr * (math.log(rmax) / (w - 1)))
    return angle, scale


def apply_shift(x, shift) -> torch.Tensor:
    """Translate ``x`` by ``shift = (dy, dx)`` (fractional ok) via the
    Fourier shift theorem: ``y[i, j] = x[i − dy, j − dx]`` with circular
    boundary. ``shift`` broadcasts over leading axes (``(..., 2)``); real
    frames stay on the two-for-one half-spectrum path end to end. The
    transforms keep the scope's precision (complex128 passes through a
    double scope uncast); the ramp is float32, as the reference's."""
    x = _as_tensor(x)
    if x.dim() < 2:
        raise ValueError(f"need (..., H, W) frames, got shape {tuple(x.shape)}")
    dev = x.device
    shift = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    if shift.dim() == 0 or shift.shape[-1] != 2:
        raise ValueError(f"shift must end in (dy, dx), got shape {tuple(shift.shape)}")
    h, w = x.shape[-2], x.shape[-1]
    dy = shift[..., 0][..., None, None]
    dx = shift[..., 1][..., None, None]
    fy = xfft.fftfreq(h, dtype=torch.float32, device=dev)[:, None]
    if not x.is_complex():
        fx = xfft.rfftfreq(w, dtype=torch.float32, device=dev)[None, :]
        ramp = torch.exp(-2j * math.pi * (fy * dy + fx * dx))
        return xfft.irfft2(xfft.rfft2(x) * ramp).to(x.dtype)
    fx = xfft.fftfreq(w, dtype=torch.float32, device=dev)[None, :]
    ramp = torch.exp(-2j * math.pi * (fy * dy + fx * dx))
    return xfft.ifft2(xfft.fft2(x) * ramp)
