"""Admission queue with per-problem-key lanes for the serve loop.

Port of ``repro.serve.queue``; it holds no tensors. The paper's RAM
controller sits between the functional blocks and decides which buffered
samples feed which engine next; this module is that controller for
serving. Incoming requests are classified into **lanes** — one lane per
problem key (frame shape × realness × device, registration geometry ×
upsample, convolution geometry, reconstruction geometry) — so the
scheduler can coalesce *compatible* work into one batched execution
while unrelated traffic queues independently.

Pieces:

* :class:`LaneKey` — the lane identity: a request family plus the
  family-specific problem signature. Requests in one lane share a plan.
* :class:`Ticket` — one admitted request: completion event, error slot,
  submit timestamp (the tail-latency clock starts at admission).
* :class:`BatchPolicy` — when a lane's backlog becomes a batch: at
  ``max_batch`` requests, or when the oldest ticket has waited
  ``max_wait_s`` (the coalescing window), whichever comes first.
* :class:`AdmissionQueue` — thread-safe lanes + round-robin rotation.
  Backpressure is the existing :func:`repro_torch.resilience.admit` shedding:
  a submit that would push the total depth past the policy's
  ``max_queue`` raises the typed ``Overloaded`` — the request is
  *rejected to its submitter*, never silently dropped.

Fairness is structural: :meth:`AdmissionQueue.take` walks the lane
rotation and moves a dispatched lane to the back, so a lane under
sustained load cannot starve a lane with a single waiting request.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.resilience.policies import ServicePolicy, admit

__all__ = ["AdmissionQueue", "BatchPolicy", "LaneKey", "Ticket"]


@dataclasses.dataclass(frozen=True)
class LaneKey:
    """Identity of one serve lane: request family + problem signature.

    ``family`` names the request kind (``"spectrum"``, ``"registration"``,
    ``"convolution"``, ``"recon"``, ...); ``signature`` is the
    family-specific problem key material (hashable), e.g. ``((H, W),
    real)`` for spectrum frames. Two requests with equal lane keys may
    legally ride one batched execution under one plan.
    """

    family: str
    signature: Tuple

    def label(self) -> str:
        """Compact human form for events and report rows."""
        sig = ",".join(str(s) for s in self.signature)
        return f"{self.family}[{sig}]"


class Ticket:
    """One admitted request: completion state + the latency clock.

    The ticket is what a streaming submitter holds while the loop works:
    :meth:`wait` blocks until the batch containing the request executed,
    :meth:`result` returns the request (results are filled in-place, as
    everywhere in the serve layer) or re-raises the batch's error.
    """

    __slots__ = ("request", "lane", "submitted_at", "error", "_done")

    def __init__(self, request: Any, lane: LaneKey, submitted_at: float):
        self.request = request
        self.lane = lane
        self.submitted_at = submitted_at
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def mark_done(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request's batch ran; False on timeout."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """The served request, or the batch's exception re-raised."""
        if not self.wait(timeout):
            raise TimeoutError(f"ticket for lane {self.lane.label()} still pending")
        if self.error is not None:
            raise self.error
        return self.request


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """When a lane's backlog is dispatched as one batch.

    ``max_batch`` — coalesce at most this many requests per execution
    (``None`` = the whole lane). A full lane is always ready.
    ``max_wait_s`` — the coalescing window: a non-full lane is ready once
    its oldest ticket has waited this long. The default ``0.0`` keeps
    call-scoped serving eager (every tick dispatches), while a streaming
    loop sets a small window to trade first-request latency for batch
    occupancy.
    """

    max_batch: Optional[int] = None
    max_wait_s: float = 0.0

    def __post_init__(self):
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 or None, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")


class AdmissionQueue:
    """Thread-safe per-lane FIFO queues with round-robin dispatch order.

    ``policy.max_queue`` is enforced at :meth:`submit` over the *total*
    pending depth — per-request backpressure via the typed ``Overloaded``
    (:func:`repro_torch.resilience.admit`), so a producer learns immediately
    that it must back off. ``clock`` is injectable so tests drive
    coalescing windows without wall time.
    """

    def __init__(
        self,
        policy: Optional[ServicePolicy] = None,
        service: str = "serve",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy if policy is not None else ServicePolicy()
        self.service = service
        self.clock = clock
        self._lanes: "OrderedDict[LaneKey, Deque[Ticket]]" = OrderedDict()
        self._lock = threading.RLock()
        self.cond = threading.Condition(self._lock)

    def depth(self) -> int:
        """Total pending requests across all lanes."""
        with self._lock:
            return sum(len(q) for q in self._lanes.values())

    def lane_depths(self) -> Dict[LaneKey, int]:
        """Pending depth per lane — the queue-depth gauge the loop emits."""
        with self._lock:
            return {lane: len(q) for lane, q in self._lanes.items()}

    def submit(self, request: Any, lane: LaneKey, shed: bool = True) -> Ticket:
        """Admit one request into its lane; returns its :class:`Ticket`.

        ``shed=True`` (streaming submits) applies the policy's
        ``max_queue`` backpressure; a call-scoped ``serve()`` admits its
        whole queue up front and enqueues with ``shed=False`` so a
        half-admitted call can never happen.
        """
        with self._lock:
            if shed:
                admit(
                    self.policy,
                    self.depth() + 1,
                    service=self.service,
                    lane=lane.label(),
                )
            ticket = Ticket(request, lane, self.clock())
            self._lanes.setdefault(lane, deque()).append(ticket)
            obs.emit("serve.loop.enqueue", service=self.service, lane=lane.label())
            self.cond.notify_all()
            return ticket

    def _ready(self, q: Deque[Ticket], batch: BatchPolicy, now: float) -> bool:
        if batch.max_batch is not None and len(q) >= batch.max_batch:
            return True
        return now - q[0].submitted_at >= batch.max_wait_s

    def take(
        self, batch: BatchPolicy, drain: bool = False
    ) -> Optional[Tuple[LaneKey, List[Ticket]]]:
        """Pop the next ready batch in round-robin lane order, or None.

        The first *ready* lane (full, or past its coalescing window;
        ``drain`` makes every non-empty lane ready) yields up to
        ``batch.max_batch`` tickets. A lane with leftover backlog moves
        to the back of the rotation — one hot lane cannot monopolise the
        scheduler while another lane waits.
        """
        now = self.clock()
        with self._lock:
            for _ in range(len(self._lanes)):
                lane, q = next(iter(self._lanes.items()))
                if not (drain or self._ready(q, batch, now)):
                    self._lanes.move_to_end(lane)  # not ready: check the next lane
                    continue
                n = len(q) if batch.max_batch is None else min(len(q), batch.max_batch)
                tickets = [q.popleft() for _ in range(n)]
                if q:
                    self._lanes.move_to_end(lane)  # backlog left: to the back
                else:
                    del self._lanes[lane]
                return lane, tickets
            return None

    def next_deadline(self) -> Optional[float]:
        """Earliest clock() value at which a waiting lane becomes ready
        by age alone (None when empty) — what a background loop sleeps to."""
        with self._lock:
            oldest = [q[0].submitted_at for q in self._lanes.values() if q]
        return min(oldest) if oldest else None
