"""The observability substrate: events, spans, counters, capture scopes.

Port of ``repro.obs.record``, pure Python like the reference. The
software control unit (``repro_torch.plan`` over ``repro_torch.engines``)
decides — cache hit or fresh ESTIMATE, one batched group or many — and
this module is where those decisions become *records* instead of
vanishing into return values.

Three primitives, one cost rule:

* :func:`emit` — one structured :class:`Event` (name + fields). Delivered
  to every :func:`capture` scope on the contextvars stack; when no scope
  is active the only work done is one counter increment and one
  contextvar read.
* :func:`span` — a timed region of host wall time (no
  ``torch.cuda.synchronize``: a span around asynchronous launches times
  their enqueue, as the reference's spans time JAX's dispatch). Emits its
  event (with ``duration_us``) on exit and, when profiling is scoped on
  (``capture(profile=True)``), also wraps the region in
  ``torch.profiler.record_function`` so it lands in PyTorch profiles.
* :func:`count` / :func:`counters` — process-wide monotonic counters.
  Always on: they are how a process that never opens a capture scope
  still answers "did my shipped wisdom load?".

Scoping is :mod:`contextvars`-based: capture scopes nest (an inner scope
sees only its own window; every enclosing scope sees the inner events
too), compose across async tasks, and never observe another thread's
events. This module imports nothing from the rest of the package — plan,
mri and the rest instrument through it.

Process-wide **sinks** (:func:`add_sink`) sit beside the capture stack:
a sink receives every event from every thread, scope or no scope — the
hook the always-on flight recorder and the planner calibration ledger
(:mod:`repro_torch.obs.telemetry`) hang off. Sinks do not change
:func:`emit`'s return contract (still ``None`` with no capture scope), and
a sink that raises is counted (``obs.sink.error``) and skipped, never
propagated into the instrumented call.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Event",
    "Trace",
    "add_sink",
    "capture",
    "count",
    "counters",
    "emit",
    "enabled",
    "profiling",
    "remove_sink",
    "reset_counters",
    "span",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded decision: a dotted name, a timestamp, its fields."""

    name: str
    t: float                    # time.perf_counter() at emission
    fields: Dict[str, Any]
    tid: int = 0                # threading.get_ident() of the emitter

    def __getitem__(self, field: str) -> Any:
        return self.fields[field]

    def get(self, field: str, default: Any = None) -> Any:
        return self.fields.get(field, default)


class Trace:
    """Events recorded by one :func:`capture` scope, in emission order."""

    def __init__(self):
        self.events: List[Event] = []

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def append(self, event: Event) -> None:
        self.events.append(event)

    def select(self, name: str) -> List[Event]:
        """Events with exactly ``name``, or under a ``"prefix.*"`` glob."""
        if name.endswith(".*"):
            prefix = name[:-1]  # keep the dot: "plan.*" -> "plan."
            return [e for e in self.events if e.name.startswith(prefix)]
        return [e for e in self.events if e.name == name]

    def first(self, name: str) -> Optional[Event]:
        hits = self.select(name)
        return hits[0] if hits else None

    def counts(self) -> Dict[str, int]:
        """Event-name histogram of this trace's window."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.name] = out.get(e.name, 0) + 1
        return out

    def summary(self) -> str:
        """Human-readable one-line-per-event rendering."""
        lines = [f"trace: {len(self.events)} events"]
        for e in self.events:
            fields = " ".join(f"{k}={_short(v)}" for k, v in e.fields.items())
            lines.append(f"  {e.name}  {fields}")
        return "\n".join(lines)


def _short(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    s = str(v)
    return s if len(s) <= 48 else s[:45] + "..."


# ------------------------------ collectors --------------------------------

_STACK: contextvars.ContextVar[Tuple[Trace, ...]] = contextvars.ContextVar(
    "repro_obs_stack", default=()
)
_PROFILE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_obs_profile", default=False
)

_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()

# Process-wide sinks: callables fed every Event from every thread. Stored
# as an immutable tuple so emit() reads one reference with no lock; the
# lock only serialises (un)installation.
_SINKS: Tuple[Any, ...] = ()
_SINKS_LOCK = threading.Lock()


def add_sink(sink) -> None:
    """Install ``sink(event)`` to receive every event process-wide."""
    global _SINKS
    with _SINKS_LOCK:
        if sink not in _SINKS:
            _SINKS = _SINKS + (sink,)


def remove_sink(sink) -> None:
    """Uninstall a sink previously passed to :func:`add_sink` (no-op if
    absent). Matches by equality, not identity: ``recorder.record`` is a
    fresh bound-method object at every attribute access, and bound
    methods compare equal when receiver and function match."""
    global _SINKS
    with _SINKS_LOCK:
        _SINKS = tuple(s for s in _SINKS if s != sink)


def enabled() -> bool:
    """True when at least one capture scope is collecting events here."""
    return bool(_STACK.get())


def profiling() -> bool:
    """True when spans should also become ``torch.profiler`` ranges."""
    return _PROFILE.get()


def count(name: str, n: int = 1) -> None:
    """Bump the process-wide counter ``name`` by ``n`` (thread-safe)."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Snapshot of every process-wide counter, sorted by name."""
    with _COUNTS_LOCK:
        return dict(sorted(_COUNTS.items()))


def reset_counters() -> None:
    """Zero the process-wide counters (tests / benchmark harnesses)."""
    with _COUNTS_LOCK:
        _COUNTS.clear()


def emit(name: str, **fields: Any) -> Optional[Event]:
    """Record one event; returns it when any capture scope received it.

    Always bumps the ``name`` counter. With no active scope and no
    installed sink that counter increment, one contextvar read and one
    global read are the entire cost — the fields dict the caller built
    is dropped without ever becoming an Event. Sinks receive the event
    regardless of scope, but the return value reflects only the capture
    stack (callers test it to know whether anyone in *their* context is
    listening).
    """
    count(name)
    stack = _STACK.get()
    sinks = _SINKS
    if not stack and not sinks:
        return None
    event = Event(
        name=name, t=time.perf_counter(), fields=fields,
        tid=threading.get_ident(),
    )
    for sink in sinks:
        try:
            sink(event)
        except Exception:
            count("obs.sink.error")
    for trace in stack:
        trace.append(event)
    return event if stack else None


def _annotation(name: str):
    """A ``torch.profiler.record_function`` for ``name`` (the reference's
    ``jax.profiler.TraceAnnotation``): a labelled range in a PyTorch
    profiler trace, and nearly free when no profiler runs."""
    import torch.profiler  # lazy: record and count never need torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, **fields: Any):
    """Time a region; emit ``name`` with ``duration_us`` on exit.

    Yields a mutable dict merged into the final event's fields, so
    results computed inside the region can ride the span's event::

        with obs.span("plan.measure", kind=key.kind) as out:
            out["chosen"] = sweep()

    When profiling is scoped on, the region is also wrapped in a
    ``torch.profiler.record_function`` so it shows up in PyTorch traces.
    """
    extra: Dict[str, Any] = {}
    stack = _STACK.get()
    prof = _PROFILE.get()
    if not stack and not prof and not _SINKS:
        # Disabled fast path: one counter bump, no timing, no Event.
        count(name)
        yield extra
        return
    annotation = _annotation(name) if prof else None
    if annotation is not None:
        annotation.__enter__()
    t0 = time.perf_counter()
    try:
        yield extra
    finally:
        duration_us = (time.perf_counter() - t0) * 1e6
        if annotation is not None:
            annotation.__exit__(None, None, None)
        emit(name, duration_us=duration_us, **{**fields, **extra})


@contextlib.contextmanager
def capture(profile: Optional[bool] = None):
    """Collect every event emitted in this scope into a fresh :class:`Trace`.

    Scopes nest: the inner trace holds only its own window, every
    enclosing trace receives the inner events too. ``profile=True`` also
    turns spans into ``torch.profiler`` ranges for the scope
    (``profile=False`` forces them off; ``None`` inherits).
    """
    trace = Trace()
    token = _STACK.set(_STACK.get() + (trace,))
    profile_token = (
        _PROFILE.set(bool(profile)) if profile is not None else None
    )
    try:
        yield trace
    finally:
        if profile_token is not None:
            _PROFILE.reset(profile_token)
        _STACK.reset(token)


# Scope hooks for an ``observe`` policy (the reference's
# ``xfft.config(observe=...)``): push/pop without a with-block, for callers
# that hold the tokens themselves.


def push_observe(observe) -> Tuple[Any, Any]:
    """Apply an ``observe`` policy; returns tokens for :func:`pop_observe`.

    ``observe`` is a :class:`Trace` (collect the scope's events into it),
    ``True`` (profiler ranges on), or ``False`` (both off).
    """
    stack_token = None
    if isinstance(observe, Trace):
        stack_token = _STACK.set(_STACK.get() + (observe,))
        profile_token = _PROFILE.set(_PROFILE.get())
    else:
        profile_token = _PROFILE.set(bool(observe))
        if observe is False:
            stack_token = _STACK.set(())
    return stack_token, profile_token


def pop_observe(tokens: Tuple[Any, Any]) -> None:
    """Undo one :func:`push_observe` (LIFO)."""
    stack_token, profile_token = tokens
    _PROFILE.reset(profile_token)
    if stack_token is not None:
        _STACK.reset(stack_token)
