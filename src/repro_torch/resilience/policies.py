"""Serving hardening policy: deadlines, bounded retry, load shedding.

Port of ``repro.resilience.policies``. A :class:`ServicePolicy` is the
frozen knob-set the serve layer (``SpectrumService``/``ImagingService``,
ROADMAP queue 1, item 9) executes under:

* **deadline_s** — per-request wall-clock budget. A request that can't
  start (or retry) inside it fails fast with :class:`DeadlineExceeded`
  instead of occupying a batch slot forever.
* **max_retries / backoff_s / backoff_jitter** — bounded retry with
  exponential backoff and seeded jitter, so a transient engine failure
  costs one delayed batch, and a fleet of retrying servers doesn't
  thundering-herd in lockstep.
* **max_queue** — load shedding: past this queue depth, new work is
  rejected with the typed :class:`Overloaded` error (callers can back
  off) instead of growing the queue unboundedly.

:func:`execute_with_policy` is the single enforcement point; it consults
the ``serve.batch`` fault seam (:mod:`.faults`) on every attempt, so a
chaos plan targeting serving exercises the exact retry/deadline code
paths production failures would take. Retries emit ``resilience.retry``
events; sheds emit ``serve.shed``.

On the card a kernel launch is asynchronous: a retry sees only the errors
that the launch itself reports (a build failure, an argument check, a
launch the card refuses), not a fault that surfaces at a later
synchronisation. Likewise ``deadline_s`` is host wall time: it covers the
card's work only when ``fn`` waits for the card.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional

from repro_torch import obs
from repro_torch.resilience import faults

__all__ = [
    "DeadlineExceeded",
    "Overloaded",
    "ServicePolicy",
    "admit",
    "execute_with_policy",
]


class Overloaded(RuntimeError):
    """Queue depth exceeded ``max_queue``: the service sheds this request.

    Typed (with ``depth``/``limit``) so callers can distinguish
    backpressure from failure and retry elsewhere/later.
    """

    def __init__(self, depth: int, limit: int):
        super().__init__(
            f"service overloaded: queue depth {depth} exceeds limit {limit}"
        )
        self.depth = depth
        self.limit = limit


class DeadlineExceeded(RuntimeError):
    """The request's ``deadline_s`` budget ran out before it completed."""

    def __init__(self, deadline_s: float, elapsed_s: float):
        super().__init__(
            f"deadline of {deadline_s:.3f}s exceeded after {elapsed_s:.3f}s"
        )
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """Frozen serving policy; the default is maximally permissive (no
    deadline, no retry, no shedding) so existing callers see no change."""

    deadline_s: Optional[float] = None
    max_retries: int = 0
    backoff_s: float = 0.05
    backoff_jitter: float = 0.25
    max_queue: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_jitter < 0:
            raise ValueError(
                f"backoff_jitter must be >= 0, got {self.backoff_jitter}"
            )
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


def admit(policy: ServicePolicy, depth: int, **ctx: Any) -> None:
    """Shed (raise :class:`Overloaded`) when ``depth`` exceeds the policy.

    Call at enqueue/serve time with the *incoming* queue depth; emits a
    ``serve.shed`` event so dropped load is visible in ``xfft.report()``
    counters, not silent.
    """
    if policy.max_queue is not None and depth > policy.max_queue:
        obs.emit("serve.shed", depth=depth, limit=policy.max_queue, **ctx)
        obs.count("serve.shed")
        raise Overloaded(depth, policy.max_queue)


def execute_with_policy(
    policy: ServicePolicy,
    fn: Callable[[], Any],
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    **ctx: Any,
):
    """Run ``fn`` under the policy: deadline-checked, retried with backoff.

    ``fn`` is one batched execution attempt. The ``serve.batch`` fault
    seam fires inside each attempt (before ``fn``), so injected serve
    faults are retried exactly like real ones. :class:`Overloaded` and
    :class:`DeadlineExceeded` are never retried — backpressure and
    budget exhaustion are answers, not transients. ``clock``/``sleep``
    are injectable so tests drive deadlines without wall time.
    """
    rng = random.Random(policy.seed)
    start = clock()
    attempt = 0
    while True:
        if policy.deadline_s is not None:
            elapsed = clock() - start
            if elapsed >= policy.deadline_s:
                raise DeadlineExceeded(policy.deadline_s, elapsed)
        try:
            faults.maybe_fail("serve.batch", attempt=attempt, **ctx)
            return fn()
        except (Overloaded, DeadlineExceeded):
            raise
        except Exception as e:  # noqa: BLE001 — retry is the whole point
            attempt += 1
            if attempt > policy.max_retries:
                raise
            delay = policy.backoff_s * (2.0 ** (attempt - 1))
            delay *= 1.0 + policy.backoff_jitter * rng.random()
            if policy.deadline_s is not None:
                remaining = policy.deadline_s - (clock() - start)
                if remaining <= 0:
                    raise DeadlineExceeded(
                        policy.deadline_s, clock() - start
                    ) from e
                delay = min(delay, remaining)
            obs.emit(
                "resilience.retry", attempt=attempt, delay_s=delay,
                error=repr(e), **ctx,
            )
            obs.count("resilience.retry")
            sleep(delay)
