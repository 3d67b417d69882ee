"""Imaging request serving: registration, tiled convolution and MRI
reconstruction, batched.

Port of ``repro.serve.imaging``. :class:`ImagingService` extends
:class:`~repro_torch.serve.engine.SpectrumService` from bare transforms to
the ``repro_torch.imaging`` and ``repro_torch.mri`` operators, with the
same serving policy: classify requests into PROBLEM-KEY lanes, resolve
one plan per lane through ``repro_torch.plan``, and run each lane batch as
a single call — all on the shared :class:`~repro_torch.serve.loop.ServeLoop`.

* registration requests lane by (frame shape, realness, upsample factor,
  device): one ``rfft2``/``irfft2`` round trip registers the whole batch;
* convolution requests lane by (image shape, kernel shape, mode,
  realness, device): the lane shares one ``oaconv2d`` plan — one
  overlap-save tile — and the per-request kernels ride the batched
  leading axis of :func:`repro_torch.imaging.oaconvolve2`;
* reconstruction requests (:class:`ReconRequest`) lane by (frame shape,
  coil count, acceleration, CG iterations, Tikhonov weight, precision,
  device): the lane stacks every member's k-space, maps and mask and runs
  ONE batched CG-SENSE solve;
* plain :class:`SpectrumRequest` frames still work; a mixed queue is
  partitioned into lanes and each family served by its own executor.

A lane's device is that of its request's first array (a frame, ``ref``,
``image`` or ``kspace``; ``"numpy"`` runs on the card); the request's
other arrays are moved there when the lane is stacked. Before each
executor runs its operator it warms the plan of the batched problem under
the lane's device, so the operator's own transforms hit the cache. Like
the parent, the service honours scoped :func:`repro_torch.xfft.config`
overrides unless the constructor pinned ``plan_mode``, waits for the card
inside the policy's attempt, and leaves results where they were computed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import obs
from repro_torch.resilience.policies import execute_with_policy
from repro_torch.serve.engine import (
    SpectrumRequest,
    SpectrumService,
    _finished,
    _is_complex,
    _lane_device,
    _lane_dtype,
    _shape,
    _source,
    _stack,
)
from repro_torch.serve.loop import LaneKey

__all__ = [
    "RegistrationRequest",
    "ConvolutionRequest",
    "ReconRequest",
    "ImagingService",
]


@dataclasses.dataclass
class RegistrationRequest:
    """Estimate the translation registering ``mov`` onto ``ref``."""

    ref: Any                                # (H, W) real or complex
    mov: Any                                # (H, W), same shape/realness
    upsample: int = 1                       # >1 -> subpixel refinement
    shift: Any = None                       # filled by serve: (2,) float32
    done: bool = False


@dataclasses.dataclass
class ConvolutionRequest:
    """Convolve ``image`` with ``kernel`` (overlap-save, plan-tiled)."""

    image: Any                              # (H, W) real or complex
    kernel: Any                             # (KH, KW)
    mode: str = "same"                      # "full" | "same" | "valid"
    out: Any = None                         # filled by serve
    done: bool = False


@dataclasses.dataclass
class ReconRequest:
    """CG-SENSE reconstruct undersampled multi-coil k-space to an image."""

    kspace: Any                             # (C, H, W) complex, centered
    smaps: Any                              # (C, H, W) coil sensitivities
    mask: Any                               # (H, W) sampling mask
    iters: int = 10                         # CG iterations
    lam: float = 0.0                        # Tikhonov weight
    image: Any = None                       # filled by serve: (H, W) complex
    done: bool = False


class ImagingService(SpectrumService):
    """Plan-aware batched serving for spectra, registration, convolution
    and MRI reconstruction.

    One loop, four request families: classification is the only
    family-specific intake code, so validation stays all-or-nothing (a
    bad request anywhere in a call fails the call before any lane runs)
    and admission control sheds the FULL mixed queue before any family
    is touched.
    """

    name = "imaging"

    # --------------------------- lane machinery ---------------------------

    def _classify(self, r) -> LaneKey:
        if isinstance(r, SpectrumRequest):
            return super()._classify(r)
        if isinstance(r, RegistrationRequest):
            ref, mov = _shape(r.ref), _shape(r.mov)
            if len(ref) != 2 or ref != mov:
                raise ValueError(
                    f"ref/mov must be matching (H, W) frames, got {ref} vs {mov}"
                )
            real = not (_is_complex(r.ref) or _is_complex(r.mov))
            return LaneKey("registration", (ref, real, int(r.upsample), _source(r.ref)))
        if isinstance(r, ConvolutionRequest):
            image, kernel = _shape(r.image), _shape(r.kernel)
            if len(image) != 2 or len(kernel) != 2:
                raise ValueError(
                    f"image and kernel must be 2D, got {image} and {kernel}"
                )
            if r.mode not in ("full", "same", "valid"):
                raise ValueError(
                    f'mode must be "full", "same" or "valid", got {r.mode!r}'
                )
            if r.mode == "valid" and (kernel[0] > image[0] or kernel[1] > image[1]):
                raise ValueError(
                    f"valid-mode convolution needs kernel <= image, got {kernel} vs {image}"
                )
            real = not (_is_complex(r.image) or _is_complex(r.kernel))
            return LaneKey("convolution", (image, kernel, r.mode, real, _source(r.image)))
        if isinstance(r, ReconRequest):
            from repro_torch.mri import acceleration
            from repro_torch.xfft import get_config

            kspace, smaps, mask = _shape(r.kspace), _shape(r.smaps), _shape(r.mask)
            if len(kspace) != 3 or kspace != smaps:
                raise ValueError(
                    f"kspace and smaps must be matching (C, H, W) stacks, "
                    f"got {kspace} vs {smaps}"
                )
            if mask != kspace[-2:]:
                raise ValueError(
                    f"mask {mask} does not match the k-space frame {kspace[-2:]}"
                )
            if r.iters < 1:
                raise ValueError(f"iters must be >= 1, got {r.iters}")
            if r.lam < 0.0:
                raise ValueError(f"lam must be >= 0, got {r.lam}")
            # Acceleration is part of the key so lightly and heavily
            # undersampled solves don't share a convergence budget;
            # precision is, because a scoped config(precision="double")
            # changes the plan the lane must warm. A mask on the card is
            # counted there, with one host read.
            accel = int(round(acceleration(r.mask)))
            return LaneKey(
                "recon",
                (kspace[-2:], kspace[0], accel, int(r.iters), float(r.lam),
                 get_config().precision, _source(r.kspace)),
            )
        raise TypeError(
            f"expected SpectrumRequest, RegistrationRequest, "
            f"ConvolutionRequest or ReconRequest, got {type(r)!r}"
        )

    def _queue_fields(self, requests, lanes) -> dict:
        families = [lane.family for lane in lanes]
        return {
            "spectra": families.count("spectrum"),
            "registrations": families.count("registration"),
            "convolutions": families.count("convolution"),
            "recons": families.count("recon"),
        }

    def _execute_lane(self, lane: LaneKey, members: list) -> None:
        if lane.family == "registration":
            self._execute_registrations(lane, members)
        elif lane.family == "convolution":
            self._execute_convolutions(lane, members)
        elif lane.family == "recon":
            self._execute_recons(lane, members)
        else:
            self._execute_spectra(lane, members)

    # ------------------------------ executors ------------------------------

    def _execute_registrations(self, lane: LaneKey, members: list) -> None:
        from repro_torch.imaging import register_phase_correlation

        shape, real, upsample, source = lane.signature
        device = _lane_device(source)
        # Warm the plan of the BATCHED problem the lane's transform pair
        # runs ((B, H, W): xfft keys on the full shape), so a repeat batch
        # of this shape and size is a cache hit inside the operator.
        self._plan_for(
            "rfft2d" if real else "fft2d",
            (len(members), *shape),
            "float32" if real else "complex64",
            device,
        )
        dtype = _lane_dtype(real)
        refs = _stack([r.ref for r in members], device, dtype)
        movs = _stack([r.mov for r in members], device, dtype)
        with obs.span(
            "serve.batch", service="registration", shape=shape,
            batch=len(members), upsample=upsample, device=str(device),
        ):
            shifts = execute_with_policy(
                self.policy,
                lambda: _finished(register_phase_correlation(
                    refs, movs, upsample_factor=upsample
                )),
                service="registration",
            )
        for r, shift in zip(members, shifts):
            r.shift = shift
            r.done = True

    def _execute_convolutions(self, lane: LaneKey, members: list) -> None:
        from repro_torch.imaging import oaconvolve2

        ishape, kshape, mode, real, source = lane.signature
        device = _lane_device(source)
        # One oaconv2d plan per (image, kernel) geometry: every member
        # shares the tile, kernels ride the batched leading axis.
        plan = self._plan_for(
            "oaconv2d",
            (*ishape, *kshape),
            "float32" if real else "complex64",
            device,
        )
        dtype = _lane_dtype(real)
        images = _stack([r.image for r in members], device, dtype)
        kernels = _stack([r.kernel for r in members], device, dtype)
        with obs.span(
            "serve.batch", service="convolution", shape=ishape,
            kernel=kshape, batch=len(members), tile=plan.tile, device=str(device),
        ):
            out = execute_with_policy(
                self.policy,
                lambda: _finished(oaconvolve2(images, kernels, mode=mode, tile=plan.tile)),
                service="convolution",
            )
        for r, res in zip(members, out):
            r.out = res
            r.done = True

    def _execute_recons(self, lane: LaneKey, members: list) -> None:
        from repro_torch.mri import recon_cg_sense

        shape, coils, accel, iters, lam, _precision, source = lane.signature
        device = _lane_device(source)
        # Warm the plan of the BATCHED coil stack every CG iteration
        # transforms ((B, C, H, W)), so the whole solve runs on cache hits.
        self._plan_for("fft2d", (len(members), coils, *shape), "complex64", device)
        dtype = _lane_dtype(real=False)
        kspaces = _stack([r.kspace for r in members], device, dtype)
        smapss = _stack([r.smaps for r in members], device, dtype)
        masks = _stack([r.mask for r in members], device, torch.float32)[:, None]
        with obs.span(
            "serve.batch", service="recon", shape=shape, coils=coils,
            accel=accel, batch=len(members), iters=iters, device=str(device),
        ):
            out = execute_with_policy(
                self.policy,
                lambda: _finished(recon_cg_sense(
                    kspaces, smapss, mask=masks, iters=iters, lam=lam
                )),
                service="recon",
            )
        for r, img in zip(members, out):
            r.image = img
            r.done = True
