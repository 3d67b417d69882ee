"""Continuous-batching serve loop: one long-lived scheduler for all services.

Port of ``repro.serve.loop``. The paper's control unit time-multiplexes
N/2 physical butterflies across every stage of the transform;
:class:`ServeLoop` is the same economy at serving scale — one scheduler time-multiplexes the planner/engine
population across a continuous request stream instead of spinning up
call-scoped batching per ``serve()`` invocation.

A loop is built from two service-supplied functions:

* ``classify(request) -> LaneKey`` — validate one request and name its
  lane (problem key). Raising here rejects the request *before*
  admission; nothing is half-served.
* ``execute(lane, requests) -> None`` — run one coalesced batch for a
  lane, filling results in-place (the serve layer's convention).

Everything else — per-lane FIFO queues, round-robin fairness,
``max_batch``/``max_wait`` coalescing, ``Overloaded`` backpressure,
completion tickets, the background thread — is shared by
``SpectrumService`` and ``ImagingService`` (the reference's LM
``ServeEngine`` comes with the LM stack). There is exactly one batching
implementation in the package.

Two entry styles over the same queue:

* **call-scoped** — :meth:`ServeLoop.serve` admits a whole request list,
  enqueues it, and drains: the pre-loop ``service.serve(requests)``
  contract, preserved verbatim for existing callers (same grouping, same
  events, same memoization).
* **streaming** — :meth:`ServeLoop.submit` returns a :class:`Ticket`;
  batches form across submitters as lanes fill or age past the
  coalescing window, driven by explicit :meth:`tick` calls or the
  :meth:`start`-ed background thread.

Quarantine awareness rides on the services' ``_plan_for`` (a lane whose
memoized engine gets benched by :mod:`repro_torch.resilience.breaker`
re-resolves around the bench instead of stalling), so a mid-stream
engine failure costs one ``resilience.failover`` and the lane keeps
serving. The loop additionally keeps a lane → problem-key registry so
``xfft.report()`` can group the quarantine table by *service*, not just
engine × key.

On the card the services' executors wait for a batch's work to finish
before they return, so a ticket is done, and a lane's latency recorded,
only when the card is done. The background thread launches on its
current stream, the legacy default stream.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs
from repro_torch.obs.hist import LatencyHistogram, histogram
from repro_torch.resilience.policies import ServicePolicy, admit
from repro_torch.serve.queue import AdmissionQueue, BatchPolicy, LaneKey, Ticket

__all__ = [
    "ServeLoop",
    "record_lane_key",
    "reset_lane_keys",
    "services_for_key",
]


# --------------------- lane -> problem-key registry ---------------------
#
# Which services planned which problem keys. Deliberately process-wide
# (like obs counters): the quarantine table in xfft.report() is
# process-wide too, and grouping its rows by service needs the union of
# every live service's lanes, not one loop's view.

_LANE_KEYS: Dict[str, Set[str]] = {}
_LANE_LOCK = threading.Lock()


def record_lane_key(service: str, cache_key: str) -> None:
    """Record that ``service`` serves a lane planned under ``cache_key``."""
    with _LANE_LOCK:
        _LANE_KEYS.setdefault(service, set()).add(cache_key)


def services_for_key(cache_key: str) -> Tuple[str, ...]:
    """Services whose lanes plan under ``cache_key`` (sorted; may be empty)."""
    with _LANE_LOCK:
        return tuple(
            sorted(s for s, keys in _LANE_KEYS.items() if cache_key in keys)
        )


def reset_lane_keys() -> None:
    """Forget all lane -> key mappings (tests)."""
    with _LANE_LOCK:
        _LANE_KEYS.clear()


# ------------------------------ the loop ------------------------------


class ServeLoop:
    """Continuous-batching scheduler over an :class:`AdmissionQueue`.

    ``policy`` is the service's :class:`ServicePolicy` (its ``max_queue``
    is the admission backpressure); ``batch`` the coalescing
    :class:`BatchPolicy` (default: dispatch eagerly, whole lanes).
    ``queue_fields(requests, lanes)`` lets a service decorate the
    call-scoped ``serve.queue`` event with its own fields (group counts,
    slot counts) without owning the emission point.
    """

    def __init__(
        self,
        classify: Callable[[Any], LaneKey],
        execute: Callable[[LaneKey, List[Any]], None],
        *,
        service: str,
        policy: Optional[ServicePolicy] = None,
        batch: Optional[BatchPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        queue_fields: Optional[
            Callable[[Sequence[Any], Sequence[LaneKey]], Dict[str, Any]]
        ] = None,
    ):
        self.classify = classify
        self.execute = execute
        self.service = service
        self.policy = policy if policy is not None else ServicePolicy()
        self.batch = batch if batch is not None else BatchPolicy()
        self.clock = clock
        self.queue_fields = queue_fields
        self.queue = AdmissionQueue(self.policy, service=service, clock=clock)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------ intake ------------------------------

    def submit(self, request: Any) -> Ticket:
        """Classify + admit one streaming request; returns its ticket.

        Raises the classifier's error for an invalid request and
        ``Overloaded`` past the policy's ``max_queue`` — backpressure is
        an answer to the submitter, never a silent drop.
        """
        lane = self.classify(request)
        return self.queue.submit(request, lane)

    def serve(self, requests: List[Any]) -> List[Any]:
        """Call-scoped entry: admit, enqueue and drain a whole queue.

        Mirrors the pre-loop ``service.serve()`` contract exactly:
        validation is all-or-nothing (every request classifies before any
        is admitted, errors carry a ``request {i}:`` prefix), admission
        sheds the whole call with ``Overloaded`` before any batch runs,
        one ``serve.queue`` event describes the intake, and the same list
        comes back with results filled in-place.
        """
        lanes: List[LaneKey] = []
        for i, r in enumerate(requests):
            try:
                lanes.append(self.classify(r))
            except (TypeError, ValueError) as e:
                raise type(e)(f"request {i}: {e}") from e
        admit(
            self.policy,
            self.queue.depth() + len(requests),
            service=self.service,
        )
        fields = (
            self.queue_fields(requests, lanes) if self.queue_fields else {}
        )
        obs.emit(
            "serve.queue",
            service=self.service,
            depth=len(requests),
            **fields,
        )
        for r, lane in zip(requests, lanes):
            # already admitted above as one unit — per-submit shedding off,
            # or a half-admitted call could strand earlier requests
            self.queue.submit(r, lane, shed=False)
        self.drain(raise_errors=True)
        return requests

    # ------------------------------ dispatch ------------------------------

    def _lane_histogram(self, lane: LaneKey) -> LatencyHistogram:
        """The process-wide admission->completion latency histogram of one
        lane (``serve.lane.<service>.<label>`` in the registry): bounded,
        mergeable, and readable by ``xfft.report()`` and the Prometheus
        exporter without touching the loop."""
        return histogram(f"serve.lane.{self.service}.{lane.label()}")

    def tick(self, *, drain: bool = False, raise_errors: bool = False) -> int:
        """Dispatch at most one ready lane batch; returns tickets served.

        The scheduler heartbeat: takes the next ready batch in round-robin
        lane order, emits ``serve.loop.tick`` (with the queue-depth gauge),
        runs the service executor, and completes the tickets. A batch
        that raises marks every member ticket failed (streaming callers
        see the error from :meth:`Ticket.result`); ``raise_errors`` also
        re-raises for call-scoped serving.
        """
        taken = self.queue.take(self.batch, drain=drain)
        if taken is None:
            return 0
        lane, tickets = taken
        now = self.clock()
        hist = self._lane_histogram(lane)
        obs.emit(
            "serve.loop.tick",
            service=self.service,
            lane=lane.label(),
            batch=len(tickets),
            depth=self.queue.depth(),
            waited_s=now - tickets[0].submitted_at,
            # the lane's latency-tail gauges as of the PREVIOUS batches:
            # a monitoring scrape of the tick stream sees the live tail
            # without holding a capture scope open
            lane_n=hist.count,
            lane_p50_us=hist.percentile(50) if hist.count else None,
            lane_p99_us=hist.percentile(99) if hist.count else None,
        )
        try:
            self.execute(lane, [t.request for t in tickets])
        except BaseException as e:
            obs.emit(
                "serve.lane.error",
                service=self.service,
                lane=lane.label(),
                batch=len(tickets),
                error=repr(e),
            )
            for t in tickets:
                t.mark_done(error=e)
            if raise_errors:
                raise
            return len(tickets)
        done_at = self.clock()
        for t in tickets:
            t.mark_done()
            # admission -> completion, on the same injectable clock the
            # ticket was stamped with
            hist.record((done_at - t.submitted_at) * 1e6)
        return len(tickets)

    def drain(self, *, raise_errors: bool = False) -> int:
        """Tick until the queue is empty (every lane ready); returns total."""
        served = 0
        while True:
            n = self.tick(drain=True, raise_errors=raise_errors)
            if n == 0:
                return served
            served += n

    # --------------------------- background loop ---------------------------

    def start(self) -> "ServeLoop":
        """Run the loop on a daemon thread: batches form as lanes fill or
        age out, without any caller driving :meth:`tick`. Idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"serve-loop[{self.service}]", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float = 5.0) -> None:
        """Stop the background thread; ``drain`` serves remaining work first."""
        self._stop.set()
        with self.queue.cond:
            self.queue.cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if drain:
            self.drain()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.tick():
                continue
            with self.queue.cond:
                if self._stop.is_set():
                    return
                oldest = self.queue.next_deadline()
                if oldest is None:
                    self.queue.cond.wait()  # idle until a submit arrives
                else:
                    # sleep only until the oldest lane ages past the
                    # coalescing window (a fill-triggered submit notifies)
                    remaining = self.batch.max_wait_s - (self.clock() - oldest)
                    self.queue.cond.wait(max(remaining, 0.0005))
