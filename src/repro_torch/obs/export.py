"""Event-stream exporters: JSONL, Chrome trace, Prometheus exposition.

Port of ``repro.obs.export`` (pure Python, unchanged).

The obs substrate records decisions; this module makes them *legible to
standard tooling* without taking a single dependency:

* :func:`write_jsonl` — one JSON object per event, the flight-recorder
  dump format (replayable, greppable, diffable);
* :func:`chrome_trace` / :func:`write_chrome_trace` — the Trace Event
  Format that ``chrome://tracing`` and Perfetto load: span events
  (anything carrying ``duration_us``) become complete ``"X"`` slices on
  per-thread lanes (the serve loop's background thread renders as its
  own track beside callers), instant events become ``"i"`` marks;
* :func:`prometheus_text` / :func:`write_prometheus` — text exposition
  of the process-wide counters, gauges, and latency-histogram quantiles
  in the format every metrics scraper already parses.

Everything here is pure formatting over snapshots — no locks held while
writing, no imports from plan/engines/serve.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional

from repro_torch.obs.hist import LatencyHistogram
from repro_torch.obs.record import Event

__all__ = [
    "chrome_trace",
    "event_dict",
    "prometheus_text",
    "write_chrome_trace",
    "write_jsonl",
    "write_prometheus",
]


def _jsonable(v: Any) -> Any:
    """Coerce a field value to something json.dump accepts (repr fallback:
    a dump must never fail because an event carried an exotic object)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, Mapping):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def event_dict(event: Event) -> Dict[str, Any]:
    """One event as a JSON-safe dict (the JSONL line schema)."""
    return {
        "name": event.name,
        "t": event.t,
        "tid": event.tid,
        "fields": {str(k): _jsonable(v) for k, v in event.fields.items()},
    }


def write_jsonl(events: Iterable[Event], path: str) -> str:
    """Write ``events`` to ``path`` as JSON Lines; returns the path."""
    with open(path, "w") as fh:
        for event in events:
            fh.write(json.dumps(event_dict(event)) + "\n")
    return path


# ------------------------------ Chrome trace -------------------------------


def chrome_trace(
    events: Iterable[Event],
    thread_names: Optional[Mapping[int, str]] = None,
    pid: Optional[int] = None,
) -> Dict[str, Any]:
    """Build a Trace Event Format document from an event snapshot.

    Span events (``duration_us`` present) become complete ``"X"`` slices —
    ``ts`` is the span *start* (emission happens at exit, so the start is
    ``t - duration``); other events become instant ``"i"`` marks. Each
    emitting thread gets its own lane, labeled via ``thread_names`` (the
    flight recorder collects that map as events arrive).
    """
    pid = os.getpid() if pid is None else pid
    trace_events: List[Dict[str, Any]] = []
    seen_tids: Dict[int, bool] = {}
    names = dict(thread_names or {})
    for event in events:
        seen_tids[event.tid] = True
        args = {str(k): _jsonable(v) for k, v in event.fields.items()}
        dur = event.fields.get("duration_us")
        ts_us = event.t * 1e6
        if isinstance(dur, (int, float)):
            trace_events.append({
                "name": event.name, "ph": "X", "pid": pid, "tid": event.tid,
                "ts": ts_us - float(dur), "dur": float(dur), "args": args,
            })
        else:
            trace_events.append({
                "name": event.name, "ph": "i", "s": "t", "pid": pid,
                "tid": event.tid, "ts": ts_us, "args": args,
            })
    main_tid = threading.main_thread().ident
    for tid in seen_tids:
        label = names.get(tid) or (
            "caller (main)" if tid == main_tid else f"thread-{tid}"
        )
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": label},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    events: Iterable[Event],
    path: str,
    thread_names: Optional[Mapping[int, str]] = None,
) -> str:
    """Write :func:`chrome_trace` of ``events`` to ``path``; returns it."""
    with open(path, "w") as fh:
        json.dump(chrome_trace(events, thread_names=thread_names), fh)
    return path


# ------------------------------ Prometheus ---------------------------------


def _label_value(value: Any) -> str:
    s = str(value)
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(
    counters: Optional[Mapping[str, int]] = None,
    gauges: Optional[Mapping[str, float]] = None,
    histograms: Optional[Mapping[str, LatencyHistogram]] = None,
) -> str:
    """Render counters, gauges, and histogram quantiles as Prometheus
    text exposition (counters under one ``repro_events_total`` family,
    histograms as summary-style quantile series in microseconds)."""
    lines: List[str] = []
    if counters:
        lines.append("# TYPE repro_events_total counter")
        for name, value in sorted(counters.items()):
            lines.append(
                f'repro_events_total{{event="{_label_value(name)}"}} {int(value)}'
            )
    if gauges:
        lines.append("# TYPE repro_gauge gauge")
        for name, value in sorted(gauges.items()):
            lines.append(
                f'repro_gauge{{name="{_label_value(name)}"}} {float(value)}'
            )
    if histograms:
        lines.append("# TYPE repro_latency_us summary")
        for name, h in sorted(histograms.items()):
            label = _label_value(name)
            for q in (50, 95, 99):
                lines.append(
                    f'repro_latency_us{{hist="{label}",quantile="0.{q}"}} '
                    f"{h.percentile(q)}"
                )
            lines.append(f'repro_latency_us_count{{hist="{label}"}} {h.count}')
            lines.append(f'repro_latency_us_sum{{hist="{label}"}} {h.sum_us}')
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(
    path: str,
    counters: Optional[Mapping[str, int]] = None,
    gauges: Optional[Mapping[str, float]] = None,
    histograms: Optional[Mapping[str, LatencyHistogram]] = None,
) -> str:
    """Write :func:`prometheus_text` to ``path``; returns the path."""
    with open(path, "w") as fh:
        fh.write(prometheus_text(counters=counters, gauges=gauges,
                                 histograms=histograms))
    return path
