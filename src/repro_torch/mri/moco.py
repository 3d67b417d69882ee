"""Batchelor-style motion-compensated forward model and reconstruction.

Port of ``repro.mri.moco``. Multi-shot MRI acquires k-space in
interleaved *shots*; a patient who moves between shots corrupts the data
in a way zero-filling cannot undo — but that motion can be modelled.
Batchelor's general matrix model composes a rigid motion operator ``T_s``
per shot into the SENSE encoding:

    y = Σ_s M_s · F · S · T_s x,      x̂ = Σ_s T_s⁻¹ · Sᴴ · F⁻¹ · M_s y

where ``M_s`` are the disjoint per-shot sampling masks. For pure
translation ``T_s`` is :func:`repro_torch.imaging.apply_shift` — the
Fourier-shift operator, unitary and circular, so its adjoint is the shift
by ``−d_s`` and the pair above is again a true adjoint pair. The per-shot
motion itself is estimable from the data with the registration machinery
(:func:`estimate_shot_shifts`, on
:func:`repro_torch.imaging.register_phase_correlation`).

Reconstruction reuses the shared CG solver
(:func:`repro_torch.mri.recon.cg_normal`) on this model's normal
equations; every inner transform is the same planned centered ``fft2``
the SENSE path uses, batched one axis deeper (shots × coils).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.imaging.registration import apply_shift, register_phase_correlation
from repro_torch.mri.operators import _tensors, apply_mask, sense_adjoint, sense_forward
from repro_torch.mri.recon import cg_normal
from repro_torch.xfft._transforms import _cdtype

__all__ = [
    "shot_masks",
    "moco_forward",
    "moco_adjoint",
    "recon_cg_moco",
    "estimate_shot_shifts",
]


def shot_masks(mask, n_shots: int) -> np.ndarray:
    """Partition a sampling mask into ``n_shots`` interleaved shot masks.

    Sampled phase-encode rows are dealt round-robin to shots (the
    standard interleaved multi-shot ordering), so the per-shot masks are
    disjoint and sum back to ``mask``. Returns float32
    ``(n_shots, H, W)`` on the host; a tensor mask is copied there first.
    """
    mask = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be (H, W), got shape {mask.shape}")
    if n_shots < 1:
        raise ValueError(f"n_shots must be >= 1, got {n_shots}")
    sampled_rows = np.flatnonzero((mask != 0).any(axis=1))
    if len(sampled_rows) < n_shots:
        raise ValueError(
            f"mask has {len(sampled_rows)} sampled rows, too few for "
            f"{n_shots} shots"
        )
    shots = np.zeros((n_shots, *mask.shape), np.float32)
    for i, row in enumerate(sampled_rows):
        shots[i % n_shots, row, :] = mask[row, :]
    return shots


def _shots(masks: torch.Tensor, shifts: torch.Tensor):
    """``masks`` and ``shifts`` (as float32), the shot layout checked."""
    if masks.dim() != 3:
        raise ValueError(f"shot masks must be (S, H, W), got shape {tuple(masks.shape)}")
    if tuple(shifts.shape) != (masks.shape[0], 2):
        raise ValueError(
            f"shifts must be ({masks.shape[0]}, 2) to match the shot "
            f"masks, got shape {tuple(shifts.shape)}"
        )
    return masks, shifts.to(torch.float32)


def moco_forward(image, smaps, masks, shifts) -> torch.Tensor:
    """Motion-compensated forward model: ``Σ_s M_s F S T_s x``.

    ``image``: ``(H, W)``; ``smaps``: ``(C, H, W)``; ``masks``:
    ``(S, H, W)`` disjoint shot masks; ``shifts``: ``(S, 2)`` per-shot
    ``(dy, dx)`` object translations. Returns ``(C, H, W)`` k-space —
    the shots' disjoint masks make the sum a k-space interleave. All
    shots ride the leading batch axis of ONE planned transform.
    """
    image, smaps, masks, shifts = _tensors(image, smaps, masks, shifts)
    if image.dim() != 2:
        raise ValueError(f"image must be (H, W), got shape {tuple(image.shape)}")
    masks, shifts = _shots(masks, shifts)
    if not image.is_complex():
        image = image.to(_cdtype())
    moved = apply_shift(image, shifts)                    # (S, H, W)
    kspace = sense_forward(moved, smaps, mask=None)       # (S, C, H, W)
    return torch.sum(apply_mask(kspace, masks[:, None]), dim=0)


def moco_adjoint(kspace, smaps, masks, shifts) -> torch.Tensor:
    """Adjoint of :func:`moco_forward`: ``Σ_s T_s⁻¹ Sᴴ F⁻¹ M_s y``.

    ``apply_shift`` is unitary, so its adjoint is the opposite shift —
    each shot's coil-combined image is shifted back before the sum.
    """
    kspace, smaps, masks, shifts = _tensors(kspace, smaps, masks, shifts)
    masks, shifts = _shots(masks, shifts)
    per_shot = apply_mask(kspace[None], masks[:, None])   # (S, C, H, W)
    images = sense_adjoint(per_shot, smaps, mask=None)    # (S, H, W)
    return torch.sum(apply_shift(images, -shifts), dim=0)


def recon_cg_moco(
    kspace,
    smaps,
    masks,
    shifts,
    iters: int = 10,
    lam: float = 0.0,
    tol: float = 0.0,
) -> torch.Tensor:
    """CG on the motion-compensated normal equations.

    The moco analogue of :func:`repro_torch.mri.recon.recon_cg_sense`:
    with the true (or well-estimated) per-shot ``shifts``, inter-shot
    motion stops being an artifact and becomes part of the encoding — the
    gate test shows it beating motion-blind CG-SENSE on the same data.
    """
    if lam < 0.0:
        raise ValueError(f"lam must be >= 0, got {lam}")
    kspace, smaps, masks, shifts = _tensors(kspace, smaps, masks, shifts)
    b = moco_adjoint(kspace, smaps, masks, shifts)

    def normal_op(x: torch.Tensor) -> torch.Tensor:
        ax = moco_adjoint(moco_forward(x, smaps, masks, shifts), smaps,
                          masks, shifts)
        return ax + lam * x if lam else ax

    return cg_normal(
        normal_op, b, iters=iters, tol=tol,
        model="moco", shape=(kspace.shape[-2], kspace.shape[-1]),
        coils=kspace.shape[-3], shots=int(masks.shape[0]),
    )


def estimate_shot_shifts(
    kspace,
    smaps,
    masks,
    ref_shot: int = 0,
    upsample_factor: int = 4,
) -> torch.Tensor:
    """Estimate per-shot object shifts by registering shot navigators.

    Each shot's zero-filled coil combine is a (heavily aliased) snapshot
    of the object at that shot's motion state; registering every shot's
    magnitude onto ``ref_shot``'s with
    :func:`repro_torch.imaging.register_phase_correlation` recovers the
    relative translations (real navigators: the two-for-one ``rfft2`` /
    ``irfft2`` path). Returns ``(S, 2)`` shifts in the
    :func:`moco_forward` convention (``shifts[ref_shot] == 0``), ready
    to hand to :func:`recon_cg_moco`.
    """
    kspace, smaps, masks = _tensors(kspace, smaps, masks)
    n_shots = masks.shape[0]
    if not 0 <= ref_shot < n_shots:
        raise ValueError(f"ref_shot must be in 0..{n_shots - 1}, got {ref_shot}")
    per_shot = apply_mask(kspace[None], masks[:, None])   # (S, C, H, W)
    navs = sense_adjoint(per_shot, smaps, mask=None).abs()  # (S, H, W)
    ref = navs[ref_shot].expand(navs.shape)
    # register returns the shift that maps each nav ONTO the reference;
    # the shot's own motion is the opposite of that correction
    correction = register_phase_correlation(
        ref, navs, upsample_factor=upsample_factor
    )
    return -correction
