"""Batched serving engines over the shared continuous-batching loop.

Port of ``repro.serve.engine``:

* :class:`ServeEngine` — LM serving: prefill, then greedy decode steps
  over the ``Model`` API (``repro_torch.models.build``). Requests route
  through the same :class:`~repro_torch.serve.loop.ServeLoop` lane
  machinery as the FFT services; lanes are power-of-two prompt-length
  buckets, and a lane batch is left-padded to its longest prompt, as the
  reference pads. The engine runs where its parameters lie (on the card,
  prefill attention launches ``flash_attention_fwd`` once a layer, an
  xLSTM prefill ``slstm_scan`` once an sLSTM layer). Its caches are
  written in place, so each lane batch starts by returning every cache
  leaf to the value the model's ``init_cache_fn`` gave it (recorded when
  the engine is built: zeros, ``slot_pos`` −1, a recurrent state's
  stabiliser at −inf): every batch starts from empty caches, as in the
  reference, whose caches are never mutated.
* :class:`SpectrumService` — the paper's 2D-FFT processor as a service.
  Plan-aware batching groups frame requests
by problem key (shape × realness × device), plans ONE transform per group
through ``repro_torch.plan``, and runs each group as a single batched
transform. Real frames take the two-for-one ``rfft2`` path, complex
frames ``fft2``. Engine choice goes through ``resolve_call``, so a scoped
``repro_torch.xfft.config(precision="double")`` or ``config(backend=...)``
around ``serve()`` steers the whole service (and its wisdom keys).

The service delegates admission, lane queues, coalescing and fairness to
its :class:`~repro_torch.serve.loop.ServeLoop` (``svc.loop``): ``serve()``
is the call-scoped contract, ``svc.loop.submit()`` / ``svc.loop.start()``
the streaming one.

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
from repro_torch.models.param import tree_leaves
from repro_torch.resilience.policies import ServicePolicy, execute_with_policy
from repro_torch.serve.loop import LaneKey, ServeLoop, record_lane_key
from repro_torch.serve.queue import BatchPolicy

__all__ = ["Request", "ServeEngine", "SpectrumRequest", "SpectrumService"]

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


# ------------------------------- LM serving -------------------------------


def _host_tokens(prompt) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        return prompt.detach().cpu().numpy()
    return np.asarray(prompt)


def _initial(t: torch.Tensor) -> torch.Tensor:
    """The one value every element of ``t`` holds as the model's
    ``init_cache_fn`` made it (zeros, a stabiliser at −inf, ``slot_pos``
    −1), as a 0-d tensor."""
    value = t.reshape(-1)[:1].reshape(()).clone()
    if not bool((t == value).all()):
        raise ValueError("ServeEngine: init_cache_fn made a cache leaf that does not hold "
                         "one value throughout")
    return value


@dataclasses.dataclass
class Request:
    prompt: Any                   # (S,) int: numpy array, list or tensor
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    name = "lm"

    def __init__(self, model, params, *, batch: int, max_len: int, dtype=torch.float32,
                 policy: ServicePolicy | None = None,
                 batch_policy: BatchPolicy | None = None):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = tree_leaves(params)[0].device
        # Serving hardening (repro_torch.resilience): per-batch deadline,
        # bounded retry with jittered backoff, queue-depth load shedding. The
        # default policy is maximally permissive.
        self.policy = policy if policy is not None else ServicePolicy()
        self.caches = model.init_cache_fn(batch, max_len, dtype, self.device)
        # each lane batch starts from these values (see _empty)
        self._initial = [_initial(t) for t in tree_leaves(self.caches)]
        self._extras: dict | None = None
        if batch_policy is None:
            batch_policy = BatchPolicy(max_batch=batch)
        elif batch_policy.max_batch is None or batch_policy.max_batch > batch:
            # the caches hold `batch` slots; a lane batch can never exceed them
            batch_policy = dataclasses.replace(batch_policy, max_batch=batch)
        self.loop = ServeLoop(
            self._classify, self._execute_lane, service=self.name,
            policy=self.policy, batch=batch_policy,
            queue_fields=self._queue_fields,
        )

    def generate(self, prompts: List[Any], max_new: int = 16,
                 extras: dict | None = None) -> List[List[int]]:
        """Greedy generation for a single batch of equal-length prompts,
        from empty caches."""
        if len(prompts) != self.batch:
            raise ValueError(f"generate takes {self.batch} prompts (the engine's slots), "
                             f"got {len(prompts)}")
        s = len(prompts[0])
        tokens = np.stack([_host_tokens(p) for p in prompts]).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tokens).to(self.device)}
        if extras:
            batch.update({k: torch.as_tensor(v, device=self.device) for k, v in extras.items()})
        self._empty()
        logits, caches = self.model.prefill_fn(self.params, batch, self.caches)
        outs: List[List[int]] = [[] for _ in prompts]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        pos = s
        for _ in range(max_new):
            for i, t in enumerate(tok[:, 0].tolist()):
                outs[i].append(int(t))
            logits, caches = self.model.decode_fn(self.params, tok, pos, caches)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            pos += 1
        return outs

    def _empty(self) -> None:
        """Return every cache leaf to the value ``init_cache_fn`` gave it."""
        for t, value in zip(tree_leaves(self.caches), self._initial):
            t.copy_(value)

    # --------------------------- lane machinery ---------------------------

    def _classify(self, r: Any) -> LaneKey:
        if not isinstance(r, Request):
            raise TypeError(f"expected Request, got {type(r)!r}")
        s = len(_host_tokens(r.prompt))
        if not 0 < s <= self.max_len:
            raise ValueError(
                f"prompt length must be in 1..{self.max_len}, got {s}"
            )
        # pow2 length buckets: prompts in one lane pad to at most 2x the
        # shortest member, instead of to the longest prompt in the call
        bucket = min(1 << (s - 1).bit_length(), self.max_len)
        return LaneKey(self.name, (bucket,))

    def _queue_fields(self, requests, lanes) -> dict:
        return {"slots": self.batch, "lanes": len(set(lanes))}

    def _execute_lane(self, lane: LaneKey, members: List[Request]) -> None:
        prompts = [_host_tokens(a.prompt) for a in members]
        s = max(len(p) for p in prompts)
        toks = np.zeros((self.batch, s), np.int32)
        for i, p in enumerate(prompts):
            toks[i, s - len(p):] = p
        with obs.span(
            "serve.batch",
            service=self.name,
            batch=len(members),
            slots=self.batch,
            queued=self.loop.queue.depth(),
            prompt_len=s,
        ):
            outs = execute_with_policy(
                self.policy,
                lambda: self.generate(
                    [toks[i] for i in range(self.batch)],
                    max_new=max(a.max_new for a in members),
                    extras=self._extras,
                ),
                service=self.name,
            )
        for i, a in enumerate(members):
            a.out = outs[i][: a.max_new]
            a.done = True

    def serve_queue(self, queue: List[Request], extras: dict | None = None) -> List[Request]:
        """Continuous batching: serve a request queue through the loop's
        prompt-length lanes, at most ``batch`` requests per execution.

        Under a bounding :class:`~repro_torch.resilience.ServicePolicy`, a
        queue deeper than ``max_queue`` is rejected whole with
        ``Overloaded`` (shed at admission — no request is half-served), and
        each batch step runs with the policy's deadline/retry envelope.
        """
        requests = list(queue)
        self._extras = extras
        try:
            self.loop.serve(requests)
        finally:
            self._extras = None
        return requests


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
