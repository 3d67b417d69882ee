"""Plan-aware 2D-FFT serving over the shared continuous-batching loop.

Port of ``repro.serve.engine``'s :class:`SpectrumService`: the paper's
2D-FFT processor as a service. Plan-aware batching groups frame requests
by problem key (shape × realness × device), plans ONE transform per group
through ``repro_torch.plan``, and runs each group as a single batched
transform. Real frames take the two-for-one ``rfft2`` path, complex
frames ``fft2``. Engine choice goes through ``resolve_call``, so a scoped
``repro_torch.xfft.config(precision="double")`` or ``config(backend=...)``
around ``serve()`` steers the whole service (and its wisdom keys).

The service delegates admission, lane queues, coalescing and fairness to
its :class:`~repro_torch.serve.loop.ServeLoop` (``svc.loop``): ``serve()``
is the call-scoped contract, ``svc.loop.submit()`` / ``svc.loop.start()``
the streaming one. (The reference's LM ``ServeEngine`` comes with the LM
stack.)

Where frames live:

* a lane batches frames of one device: a tensor's own, or ``"numpy"`` for
  anything else, so a numpy or CPU frame never coalesces with a card
  frame. A lane of card tensors is stacked on the card, a lane of CPU
  tensors on the CPU (where the plain versions run), and a lane of numpy
  frames on the host and then sent to the card, as the front door sends
  them (without CUDA its intake raises);
* the classifier reads ``.shape`` and ``.is_complex()`` of a tensor and
  copies nothing to the host;
* an executor waits, inside the policy's retried attempt, until the card
  has finished the lane's work on its stream: a ticket is done, and a
  lane's latency recorded, when the card is done, and a fault that
  surfaces at that wait is retried as one raised by the launch. Results
  stay where they were computed: each request's result is a view of the
  lane's batched output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.resilience.policies import ServicePolicy, execute_with_policy
from repro_torch.serve.loop import LaneKey, ServeLoop, record_lane_key
from repro_torch.serve.queue import BatchPolicy

__all__ = ["SpectrumRequest", "SpectrumService"]

#: The lane source of input that is not a tensor: it runs on the card.
NUMPY = "numpy"


# ------------------------------ lane helpers ------------------------------


def _source(x) -> str:
    """Where ``x`` lives: a tensor's device, else ``"numpy"``. Numpy input
    checks at intake that the card it will run on is there."""
    if isinstance(x, torch.Tensor):
        return str(x.device)
    _lane_device(NUMPY)
    return NUMPY


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _is_complex(x) -> bool:
    return x.is_complex() if isinstance(x, torch.Tensor) else bool(np.iscomplexobj(x))


def _lane_device(source: str) -> torch.device:
    """The device a lane runs on: its tensors', or the card for numpy input
    (raises where CUDA is absent)."""
    if source == NUMPY:
        from repro_torch.xfft._transforms import _default_device

        return _default_device()
    return torch.device(source)


def _lane_dtype(real: bool) -> torch.dtype:
    """The scope's real or complex dtype, as the front door casts input."""
    from repro_torch.xfft._transforms import _cdtype, _rdtype

    return _rdtype() if real else _cdtype()


def _stack(xs: Sequence[Any], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One ``(B, ...)`` tensor of ``xs`` on ``device``: tensors are stacked
    where they are (no host round trip for a lane of card tensors), other
    input on the host, then sent in one copy."""
    if all(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack([x.to(device) for x in xs]).to(dtype)
    host = np.stack([x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                     for x in xs])
    return torch.from_numpy(host).to(device=device, dtype=dtype)


def _finished(out):
    """``out`` once the card has finished it: waits for the current stream
    of a CUDA tensor's device (a no-op on the CPU)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


# ----------------------- plan-aware 2D-FFT serving ------------------------


@dataclasses.dataclass
class SpectrumRequest:
    """One frame to transform. Real frames are served via the two-for-one
    ``rfft2`` path (half spectrum out); complex frames via ``fft2``.
    ``frame`` is a numpy array or a tensor; ``spectrum`` is a tensor on the
    device the lane ran on."""

    frame: Any                              # (H, W) real or complex
    spectrum: Any = None                    # filled by SpectrumService.serve
    done: bool = False


class SpectrumService:
    """Serve batched 2D-FFT requests with plan-aware batching.

    Requests are grouped by problem key — frame shape, realness and device
    — so ONE plan (``repro_torch.plan``) serves a whole group as a single
    batched transform. Plans are memoized across ``serve`` calls; with a
    MEASURE-mode, file-backed cache (or a :mod:`repro_torch.serve.wisdom`
    warm start) a service tunes once per shape for its lifetime.

    Scheduling lives in ``self.loop``: ``serve()`` is the call-scoped
    entry, ``loop.submit()`` the streaming one, and a ``batch``
    :class:`BatchPolicy` bounds coalescing for both.
    """

    name = "spectrum"

    def __init__(self, plan_mode: str | None = None, cache=None,
                 policy: ServicePolicy | None = None,
                 batch: BatchPolicy | None = None):
        # None defers to the scoped repro_torch.xfft.config mode; an
        # explicit plan_mode pins the policy.
        if plan_mode is not None and plan_mode not in ("estimate", "measure"):
            raise ValueError(f"plan_mode must be 'estimate' or 'measure', got {plan_mode!r}")
        self.plan_mode = plan_mode
        self.cache = cache
        self.policy = policy if policy is not None else ServicePolicy()
        self.plans: dict = {}               # (config, cache_key) -> FFTPlan memo
        self.loop = ServeLoop(
            self._classify, self._execute_lane, service=self.name,
            policy=self.policy, batch=batch, queue_fields=self._queue_fields,
        )

    # --------------------------- lane machinery ---------------------------

    def _classify(self, r: Any) -> LaneKey:
        if not isinstance(r, SpectrumRequest):
            raise TypeError(f"expected SpectrumRequest, got {type(r)!r}")
        shape = _shape(r.frame)
        if len(shape) != 2:
            raise ValueError(f"expected a (H, W) frame, got {shape}")
        return LaneKey("spectrum", (shape, not _is_complex(r.frame), _source(r.frame)))

    def _queue_fields(self, requests, lanes) -> dict:
        return {"groups": len(set(lanes))}

    def _execute_lane(self, lane: LaneKey, members: List[Any]) -> None:
        self._execute_spectra(lane, members)

    def _execute_spectra(self, lane: LaneKey, members: List[Any]) -> None:
        from repro_torch.plan import execute

        shape, real, source = lane.signature
        device = _lane_device(source)
        batch = _stack([r.frame for r in members], device, _lane_dtype(real))
        kind = "rfft2d" if real else "fft2d"
        dtype = "float32" if real else "complex64"
        # Plan under the per-frame shape: the schedule depends on the frame
        # geometry, not on how many requests happened to arrive.
        plan = self._plan_for(kind, shape, dtype, device)
        with obs.span(
            "serve.batch", service="spectrum", kind=kind, shape=shape,
            batch=len(members), variant=plan.variant, device=str(device),
        ):
            out = execute_with_policy(
                self.policy,
                lambda: _finished(execute(plan, batch)),
                service="spectrum", kind=kind,
            )
        for j, r in enumerate(members):
            r.spectrum = out[j]
            r.done = True

    # ------------------------------ planning ------------------------------

    def _plan_for(self, kind: str, shape, dtype: str, device: torch.device):
        from repro_torch.plan import problem_key, resolve_call
        from repro_torch.resilience import quarantine
        from repro_torch.xfft import get_config

        # resolve_call (not plan_fft): the service honours scoped
        # repro_torch.xfft.config overrides. The plan memo keys on the
        # active config too, so a scoped override neither reads nor leaves
        # stale memo entries. The lane's device is passed explicitly: the
        # port's planner takes it third (ROADMAP queue 3, divergence 5).
        pk = problem_key(kind, shape, device, dtype)
        record_lane_key(self.name, pk.cache_key())
        memo_key = (get_config(), pk.cache_key())
        plan = self.plans.get(memo_key)
        breaker = quarantine()
        if plan is not None and breaker.excluded(plan.variant, pk):
            # memoized engine is benched: re-resolve around it
            obs.emit(
                "serve.lane.replan", service=self.name,
                key=pk.cache_key(), engine=plan.variant,
            )
            obs.count(f"serve.replan.{self.name}")
            plan = None
        if plan is None:
            plan = resolve_call(kind, shape, device, dtype=dtype, mode=self.plan_mode,
                                cache=self.cache)
            # A plan resolved under an active quarantine is a workaround:
            # not memoized, so the benched engine returns once it recovers.
            if not breaker.affects(pk):
                self.plans[memo_key] = plan
        return plan

    # ------------------------------- entry -------------------------------

    def serve(self, requests: List[SpectrumRequest]) -> List[SpectrumRequest]:
        """Transform every request in-place; returns the same list.

        Admission first: a queue deeper than the policy's ``max_queue``
        sheds with ``Overloaded`` before any group executes. Each group
        then runs under the policy's deadline/retry envelope.
        """
        return self.loop.serve(requests)
