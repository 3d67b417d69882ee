"""Always-on telemetry: the flight recorder and the calibration ledger.

Port of ``repro.obs.telemetry`` (pure Python). Two process-wide sinks
(:func:`repro_torch.obs.record.add_sink`) that run with *no* capture scope
open — the black box a serving fleet member carries:

* :class:`FlightRecorder` — a bounded ring of the most recent events
  (``collections.deque(maxlen=...)``: one GIL-atomic append per event,
  no lock on the hot path). When an **armed trigger** fires — an engine
  failover, a circuit breaker opening, a shed request, a lane error —
  the ring is dumped to a JSONL snapshot *at that instant*, so the
  events leading up to the failure are preserved even though nobody had
  a ``capture()`` open when it happened. Replace it with
  :func:`set_flight_recorder`.
* :class:`CalibrationLedger` — joins the planner's *predictions*
  (``plan.resolve``'s ``est_time_s``/``measured_us``, per-candidate
  ``plan.measure.candidate`` timings) against *observed* ``engine.apply``
  span durations per (engine, kind, shape, precision): the mispricing
  table (observed/predicted ratio, sample counts) that recalibrating
  ESTIMATE needs. The port's planner emits ``plan.resolve`` and MEASURE
  ``plan.measure.candidate``; the degradation ladder
  (``repro_torch.resilience.run_plan``) emits an ``engine.apply`` span
  for every transform it runs.

Both are installed at ``repro_torch.obs`` import (:func:`install_default`)
— always-on is the default. The recorder reads the reference's
environment: ``$REPRO_FLIGHT_DIR`` (dump directory, default a pid-scoped
temporary directory, so two processes never dump into each other's),
``$REPRO_FLIGHT_CAPACITY`` and ``REPRO_FLIGHT_RECORDER=0`` (off). Neither
sink ever emits events of its own (counters only), so a recorder can never
recurse through itself.
"""

from __future__ import annotations

import collections
import os
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import record as _record
from repro_torch.obs.export import write_jsonl
from repro_torch.obs.hist import LatencyHistogram, histogram
from repro_torch.obs.record import Event

__all__ = [
    "CalibrationLedger",
    "DEFAULT_TRIGGERS",
    "FlightRecorder",
    "calibration_ledger",
    "flight_recorder",
    "install_default",
    "set_calibration_ledger",
    "set_flight_recorder",
]

#: Event names that trigger an automatic flight dump. ``resilience.breaker``
#: is special-cased: only the ``state="open"`` transition dumps (half-open
#: probes and closes are recovery, not failure).
DEFAULT_TRIGGERS = frozenset({
    "resilience.failover",
    "resilience.breaker",
    "serve.shed",
    "serve.lane.error",
})


def _default_dump_dir() -> str:
    return os.environ.get(
        "REPRO_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), f"repro-flight-{os.getpid()}"),
    )


class FlightRecorder:
    """Bounded always-on event ring with trigger-armed JSONL dumps.

    ``capacity`` — ring size in events (default 4096 ≈ a few thousand
    transform calls of context). ``triggers`` — event names that dump the
    ring; ``max_dumps`` caps files written per process so a flapping
    breaker cannot fill a disk (excess triggers are counted, not written).
    ``dump_dir`` defaults to ``$REPRO_FLIGHT_DIR`` or a pid-scoped tmpdir,
    created lazily on first dump.
    """

    def __init__(
        self,
        capacity: int = 4096,
        dump_dir: Optional[str] = None,
        triggers: frozenset = DEFAULT_TRIGGERS,
        max_dumps: int = 8,
    ):
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.triggers = frozenset(triggers)
        self.max_dumps = int(max_dumps)
        self._ring: "collections.deque[Event]" = collections.deque(maxlen=capacity)
        self._thread_names: Dict[int, str] = {}
        self._dumps: List[Dict[str, Any]] = []
        self._dropped_dumps = 0
        self._recorded = 0
        self._dump_lock = threading.Lock()

    # -- the sink (hot path: one deque append, no lock) ---------------------

    def record(self, event: Event) -> None:
        self._ring.append(event)
        self._recorded += 1
        tid = event.tid
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name
        if event.name in self.triggers:
            if event.name == "resilience.breaker" and \
                    event.fields.get("state") != "open":
                return
            self._auto_dump(event.name)

    # -- reading the box ----------------------------------------------------

    def events(self) -> List[Event]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def thread_names(self) -> Dict[int, str]:
        """tid -> thread name for every thread seen by this recorder."""
        return dict(self._thread_names)

    def clear(self) -> None:
        self._ring.clear()

    def stats(self) -> Dict[str, Any]:
        """Report payload: capacity, retention, dump accounting."""
        return {
            "capacity": self.capacity,
            "retained": len(self._ring),
            "recorded_total": self._recorded,
            "dumps": list(self._dumps),
            "dropped_dumps": self._dropped_dumps,
        }

    # -- dumping ------------------------------------------------------------

    def _auto_dump(self, trigger: str) -> None:
        with self._dump_lock:
            if len(self._dumps) >= self.max_dumps:
                self._dropped_dumps += 1
                _record.count("obs.flight.dump_dropped")
                return
            seq = len(self._dumps) + 1
        try:
            self.dump(trigger=trigger, _seq=seq)
        except OSError:
            _record.count("obs.flight.dump_error")

    def dump(self, path: Optional[str] = None, trigger: str = "manual",
             _seq: Optional[int] = None) -> str:
        """Write the ring snapshot as JSONL; returns the path written.

        The snapshot is taken *before* any IO, so the triggering event —
        appended by :meth:`record` before the trigger check — is the last
        line of the file. Counts ``obs.flight.dump``; never emits (a dump
        inside event delivery must not re-enter event delivery).
        """
        snapshot = list(self._ring)
        if path is None:
            directory = self.dump_dir or _default_dump_dir()
            os.makedirs(directory, exist_ok=True)
            seq = _seq if _seq is not None else len(self._dumps) + 1
            slug = trigger.replace(".", "_")
            path = os.path.join(directory, f"flight-{seq:04d}-{slug}.jsonl")
        write_jsonl(snapshot, path)
        with self._dump_lock:
            self._dumps.append(
                {"path": path, "trigger": trigger, "events": len(snapshot)}
            )
        _record.count("obs.flight.dump")
        return path


# ---------------------------- calibration ----------------------------------

RowKey = Tuple[str, str, Tuple[int, ...], str]  # (engine, kind, shape, precision)


class CalibrationLedger:
    """Joins planner predictions against observed engine dispatch times.

    Predictions arrive from two event families: ``plan.resolve`` carries
    the chosen variant's analytic estimate (``est_time_s``) and, for
    MEASURE-grade plans, the swept ``measured_us``; per-candidate
    ``plan.measure.candidate`` events carry swept timings for the
    variants that *lost* (so mispricing is visible even for engines the
    planner never picks). Observations are ``engine.apply`` span
    durations with ``ok=True`` — dispatches that raised (injected faults,
    real failures) never pollute the timing population.
    """

    def __init__(self):
        self._rows: Dict[RowKey, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._handlers: Dict[str, Callable[[Event], None]] = {
            "plan.resolve": self._on_resolve,
            "plan.measure.candidate": self._on_candidate,
            "engine.apply": self._on_apply,
        }

    # the sink: one dict lookup for every non-ledger event
    def record(self, event: Event) -> None:
        handler = self._handlers.get(event.name)
        if handler is not None:
            handler(event)

    @staticmethod
    def _row_key(f: Dict[str, Any], engine_field: str) -> Optional[RowKey]:
        engine = f.get(engine_field)
        kind = f.get("kind")
        shape = f.get("shape")
        if engine is None or kind is None or shape is None:
            return None
        return (
            str(engine), str(kind), tuple(shape), str(f.get("precision", "single"))
        )

    def _row(self, key: RowKey) -> Dict[str, Any]:
        row = self._rows.get(key)
        if row is None:
            row = {
                "estimate_us": None,   # analytic estimate_variant_time
                "measured_us": None,   # MEASURE sweep median
                "observed": LatencyHistogram(),
            }
            self._rows[key] = row
        return row

    def _on_resolve(self, event: Event) -> None:
        f = event.fields
        key = self._row_key(f, "variant")
        if key is None:
            return
        with self._lock:
            row = self._row(key)
            est = f.get("est_time_s")
            if isinstance(est, (int, float)):
                row["estimate_us"] = float(est) * 1e6
            measured = f.get("measured_us")
            if isinstance(measured, (int, float)):
                row["measured_us"] = float(measured)

    def _on_candidate(self, event: Event) -> None:
        f = event.fields
        key = self._row_key(f, "engine")
        if key is None:
            return
        us = f.get("median_us")
        if not isinstance(us, (int, float)):
            return
        with self._lock:
            self._row(key)["measured_us"] = float(us)

    def _on_apply(self, event: Event) -> None:
        f = event.fields
        if not f.get("ok"):
            return
        dur = f.get("duration_us")
        if not isinstance(dur, (int, float)):
            return
        key = self._row_key(f, "engine")
        if key is None:
            return
        with self._lock:
            self._row(key)["observed"].record(float(dur))
        # per-engine latency view, beside the per-lane serve histograms
        histogram(f"engine.{f['engine']}").record(float(dur))

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()

    def table(self) -> List[Dict[str, Any]]:
        """The mispricing table: one row per (engine, kind, shape,
        precision) with a prediction, sorted worst mispricing first.

        ``predicted_us`` prefers the swept measurement over the analytic
        estimate (MEASURE *is* the planner's belief when present);
        ``ratio`` is observed-p50 / predicted — >1 means the planner is
        optimistic about that engine, <1 pessimistic.
        """
        with self._lock:
            items = [(k, dict(v, observed=v["observed"])) for k, v in
                     self._rows.items()]
        rows: List[Dict[str, Any]] = []
        for (engine, kind, shape, precision), row in items:
            hist: LatencyHistogram = row["observed"]
            predicted = row["measured_us"]
            source = "measure"
            if predicted is None:
                predicted = row["estimate_us"]
                source = "estimate"
            if predicted is None:
                continue
            observed_p50 = hist.percentile(50)
            ratio = (observed_p50 / predicted) if (hist.count and predicted) else None
            rows.append({
                "engine": engine,
                "kind": kind,
                "shape": list(shape),
                "precision": precision,
                "predicted_us": round(float(predicted), 2),
                "predicted_source": source,
                "observed_p50_us": round(observed_p50, 2) if hist.count else None,
                "observed_n": hist.count,
                "ratio": round(ratio, 3) if ratio is not None else None,
            })
        rows.sort(
            key=lambda r: abs((r["ratio"] or 1.0) - 1.0), reverse=True
        )
        return rows


# -------------------------- process-wide install ----------------------------

_RECORDER: Optional[FlightRecorder] = None
_LEDGER: Optional[CalibrationLedger] = None
_INSTALL_LOCK = threading.Lock()


def flight_recorder() -> Optional[FlightRecorder]:
    """The installed process-wide flight recorder (None when disabled)."""
    return _RECORDER


def set_flight_recorder(
    recorder: Optional[FlightRecorder],
) -> Optional[FlightRecorder]:
    """Install ``recorder`` as the process flight recorder (None turns the
    black box off); returns the previous recorder for restore."""
    global _RECORDER
    with _INSTALL_LOCK:
        previous = _RECORDER
        if previous is not None:
            _record.remove_sink(previous.record)
        _RECORDER = recorder
        if recorder is not None:
            _record.add_sink(recorder.record)
        return previous


def calibration_ledger() -> CalibrationLedger:
    """The process-wide calibration ledger (installed at obs import)."""
    with _INSTALL_LOCK:
        return _LEDGER if _LEDGER is not None else _install_ledger()


def set_calibration_ledger(
    ledger: Optional[CalibrationLedger],
) -> Optional[CalibrationLedger]:
    """Swap the process ledger (tests); returns the previous one."""
    global _LEDGER
    with _INSTALL_LOCK:
        previous = _LEDGER
        if previous is not None:
            _record.remove_sink(previous.record)
        _LEDGER = ledger
        if ledger is not None:
            _record.add_sink(ledger.record)
        return previous


def _install_ledger() -> CalibrationLedger:
    global _LEDGER
    _LEDGER = CalibrationLedger()
    _record.add_sink(_LEDGER.record)
    return _LEDGER


def install_default() -> None:
    """Install the default always-on recorder + ledger (idempotent); the
    capacity default can be overridden via ``$REPRO_FLIGHT_CAPACITY``
    and the whole recorder disabled via ``REPRO_FLIGHT_RECORDER=0``."""
    global _RECORDER
    with _INSTALL_LOCK:
        if _LEDGER is None:
            _install_ledger()
        if _RECORDER is None and os.environ.get(
            "REPRO_FLIGHT_RECORDER", "1"
        ) not in ("0", "off", "false"):
            capacity = int(os.environ.get("REPRO_FLIGHT_CAPACITY", "4096"))
            _RECORDER = FlightRecorder(capacity=capacity)
            _record.add_sink(_RECORDER.record)
