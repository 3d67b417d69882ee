"""Iterative reconstruction: CG-SENSE and the zero-filled baseline.

Port of ``repro.mri.recon``. CG-SENSE (Pruessmann et al.) solves the
regularised normal equations of the SENSE forward model with conjugate
gradients:

    (AᴴA + λI) x = Aᴴ y,      A = M · F · S

Every CG iteration applies ``A`` and ``Aᴴ`` once — two planned centered
2D transforms over the full coil stack (on the card, the fused kernels
over every coil of every item at once) — so a ten-iteration recon is
twenty planned ``fft2`` resolutions of two problem keys (forward and
inverse of the same batched coil shape): the first recon of a key plans
it, every later iteration is a cache hit.

The loop runs on the host, as in the reference: each iteration reads
its residual back to the host (one synchronisation an iteration) and
emits one ``mri.cg.iter`` obs event with the residual trace. Leading batch
axes are first-class: a ``(B, C, H, W)`` k-space stack runs ONE batched
CG with per-item step sizes.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import obs
from repro_torch.mri.operators import _tensors, sense_adjoint, sense_forward

__all__ = ["recon_zero_filled", "recon_cg_sense", "cg_normal", "nrmse"]

_TINY = 1e-30


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-item real inner product ``Re<a, b>`` over the frame axes."""
    return torch.real(torch.sum(torch.conj(a) * b, dim=(-2, -1)))


def recon_zero_filled(kspace, smaps, mask=None) -> torch.Tensor:
    """The non-iterative baseline: ``Aᴴ y`` (coil-combined zero-filled).

    With RSS-normalised maps this is the sensitivity-weighted zero-filled
    image — the thing CG-SENSE must beat, and its own first iterate.
    """
    return sense_adjoint(kspace, smaps, mask)


def cg_normal(
    normal_op: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    iters: int = 10,
    tol: float = 0.0,
    event: str = "mri.cg.iter",
    **event_fields,
) -> torch.Tensor:
    """Conjugate gradients on ``normal_op(x) = b`` from ``x = 0``.

    ``normal_op`` must be self-adjoint positive (semi-)definite — any
    ``AᴴA + λI`` qualifies; :func:`recon_cg_sense` and the
    motion-compensated model in :mod:`repro_torch.mri.moco` both drive
    their solves through here. ``b`` may carry leading batch axes: inner
    products reduce over the trailing frame axes only, so every batch
    item takes its own step sizes.

    Emits one ``event`` obs event per iteration with the worst-case
    relative residual ``max_B ||r|| / ||b||`` (a host sync per iteration
    — the residual trace is the point of the loop, not a by-product).
    ``tol > 0`` stops early once that residual falls below it.
    """
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = _dot(r, r)
    bnorm = torch.sqrt(torch.clamp(rs, min=_TINY))
    for i in range(iters):
        q = normal_op(p)
        alpha = rs / torch.clamp(_dot(p, q), min=_TINY)
        x = x + alpha[..., None, None] * p
        r = r - alpha[..., None, None] * q
        rs_new = _dot(r, r)
        residual = float(torch.max(torch.sqrt(torch.clamp(rs_new, min=0.0)) / bnorm))
        # emit bumps the event's counter itself — one count per iteration
        obs.emit(event, iter=i, residual=residual, **event_fields)
        if tol > 0.0 and residual <= tol:
            break
        beta = rs_new / torch.clamp(rs, min=_TINY)
        p = r + beta[..., None, None] * p
        rs = rs_new
    return x


def recon_cg_sense(
    kspace,
    smaps,
    mask=None,
    iters: int = 10,
    lam: float = 0.0,
    tol: float = 0.0,
) -> torch.Tensor:
    """CG-SENSE: solve ``(AᴴA + λI) x = Aᴴ y`` for the image.

    ``kspace``/``smaps``: ``(..., C, H, W)``; ``mask`` broadcasts over
    the coil axis (``None`` = fully sampled). ``lam`` is the Tikhonov
    weight (0 is plain SENSE; a small ``lam`` tames the nullspace of
    heavily undersampled problems). Returns the ``(..., H, W)`` image.
    """
    if lam < 0.0:
        raise ValueError(f"lam must be >= 0, got {lam}")
    kspace, smaps, mask = _tensors(kspace, smaps, mask)
    b = sense_adjoint(kspace, smaps, mask)

    def normal_op(x: torch.Tensor) -> torch.Tensor:
        ax = sense_adjoint(sense_forward(x, smaps, mask), smaps, mask)
        return ax + lam * x if lam else ax

    shape = (kspace.shape[-2], kspace.shape[-1])
    return cg_normal(
        normal_op, b, iters=iters, tol=tol,
        model="sense", shape=shape, coils=kspace.shape[-3],
    )


def nrmse(estimate, reference, magnitude: bool = True) -> float:
    """Normalised RMSE ``||est − ref|| / ||ref||`` (on magnitudes by
    default — MRI images carry coil/acquisition phase the phantom ground
    truth doesn't)."""
    est, ref = _tensors(estimate, reference)
    if magnitude:
        est, ref = est.abs(), ref.abs()
    denom = torch.sqrt(torch.sum(ref.abs() ** 2))
    return float(torch.sqrt(torch.sum((est - ref).abs() ** 2)) / torch.clamp(denom, min=_TINY))
