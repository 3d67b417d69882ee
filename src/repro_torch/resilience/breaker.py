"""Per-problem engine quarantine: a circuit breaker over the registry.

Port of ``repro.resilience.breaker``. When an engine raises
mid-transform (a kernel that fails to build, an argument check, a launch
the card refuses), retrying it on the very next call costs every call
that failure. Instead the degradation ladder records the failure here,
and the planner excludes the (engine, problem) pair from
``variant_candidates()`` until a cooldown passes — the classic circuit
breaker, keyed per :class:`~repro_torch.plan.ProblemKey` because an
engine that fails on 2048² frames may be healthy on 128².

States per (engine, problem-key) entry:

* **closed** — healthy; failures below threshold just count.
* **open** — quarantined: ``excluded()`` is True, the planner routes
  around the engine. Entered when failures reach ``threshold`` (default
  1 — a crashed transform is expensive enough to route around
  immediately).
* **half_open** — after ``cooldown_s`` the next ``excluded()`` check
  flips open → half_open and starts admitting calls again. A success
  closes the breaker; a failure reopens it and restarts the cooldown.
  Half-open is deliberately *non-consuming*: every caller is admitted
  until one resolves the probe, so no probe-token bookkeeping leaks
  between the planner and the ladder.

Transitions emit ``resilience.breaker`` obs events, so the acceptance
flow (open → cooldown → half-open probe → close) is assertable straight
from the event stream, and :meth:`QuarantineRegistry.table` gives the
quarantine table that ``xfft.report()`` will render (ROADMAP queue 1,
item 10). Healthy calls take no lock: with no entry ever recorded,
:meth:`~QuarantineRegistry.excluded`, :meth:`~QuarantineRegistry.affects`
and :meth:`~QuarantineRegistry.record_success` return at once.

A module-level singleton (:func:`quarantine`) holds process state, like
the engine registry it filters; tests swap the clock and call
:func:`reset` between cases.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import obs

__all__ = [
    "BreakerEntry",
    "QuarantineRegistry",
    "configure",
    "quarantine",
    "reset",
]


class BreakerEntry:
    """Mutable breaker state for one (engine, problem-key) pair."""

    __slots__ = ("state", "failures", "opened_at", "last_error")

    def __init__(self):
        self.state = "closed"
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.last_error: Optional[str] = None


class QuarantineRegistry:
    """Circuit breakers keyed by (engine_name, ProblemKey.cache_key()).

    ``threshold`` failures open a breaker; after ``cooldown_s`` the next
    exclusion check admits a half-open probe. ``clock`` is injectable so
    tests drive cooldown without sleeping.
    """

    def __init__(
        self,
        threshold: int = 1,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._entries: Dict[Tuple[str, str], BreakerEntry] = {}
        self._lock = threading.Lock()

    # -- queries ----------------------------------------------------------

    def excluded(self, engine: str, key) -> bool:
        """Should the planner route around ``engine`` for this problem?

        Open breakers past their cooldown transition to half_open here
        (and stop excluding): exclusion checks are the only place the
        planner consults the breaker, so they double as the probe gate.
        """
        if not self._entries:  # fast path: nothing ever failed
            return False
        with self._lock:
            entry = self._entries.get((engine, key.cache_key()))
            if entry is None or entry.state == "closed":
                return False
            if entry.state == "open":
                if self.clock() - entry.opened_at >= self.cooldown_s:
                    entry.state = "half_open"
                    obs.emit(
                        "resilience.breaker", state="half_open",
                        engine=engine, key=key.cache_key(),
                    )
                    return False
                return True
            return False  # half_open admits every caller until resolved

    def affects(self, key) -> bool:
        """True when any engine is quarantined (open/half-open) for ``key``.

        The planner uses this to keep quarantine-shaped fallback plans
        out of the wisdom cache: a plan chosen while an engine was
        benched must not outlive the bench.
        """
        if not self._entries:
            return False
        kstr = key.cache_key()
        with self._lock:
            return any(
                k == kstr and e.state != "closed"
                for (_, k), e in self._entries.items()
            )

    # -- transitions ------------------------------------------------------

    def record_failure(self, engine: str, key, error: str = "") -> bool:
        """Count a failure; open the breaker at threshold. True if opened.

        A failure during a half-open probe reopens immediately — the
        probe answered.
        """
        with self._lock:
            k = (engine, key.cache_key())
            entry = self._entries.setdefault(k, BreakerEntry())
            entry.failures += 1
            entry.last_error = error or entry.last_error
            should_open = (
                entry.state == "half_open" or entry.failures >= self.threshold
            )
            if should_open and entry.state != "open":
                entry.state = "open"
                entry.opened_at = self.clock()
                obs.emit(
                    "resilience.breaker", state="open", engine=engine,
                    key=key.cache_key(), failures=entry.failures,
                    cooldown_s=self.cooldown_s,
                )
                obs.count("resilience.breaker.open")
                return True
            return False

    def record_success(self, engine: str, key) -> None:
        """A call through ``engine`` succeeded: close or reset its breaker."""
        if not self._entries:  # fast path: every healthy call lands here
            return
        with self._lock:
            entry = self._entries.get((engine, key.cache_key()))
            if entry is None:
                return
            if entry.state in ("half_open", "open"):
                entry.state = "closed"
                entry.failures = 0
                entry.opened_at = None
                obs.emit(
                    "resilience.breaker", state="closed", engine=engine,
                    key=key.cache_key(),
                )
                obs.count("resilience.breaker.close")
            else:
                entry.failures = 0

    # -- introspection ----------------------------------------------------

    def table(self) -> List[dict]:
        """Quarantine rows for ``xfft.report()`` (non-closed entries only)."""
        now = self.clock()
        with self._lock:
            rows = []
            for (engine, kstr), e in sorted(self._entries.items()):
                if e.state == "closed":
                    continue
                rows.append({
                    "engine": engine,
                    "key": kstr,
                    "state": e.state,
                    "failures": e.failures,
                    "cooldown_remaining_s": (
                        max(0.0, self.cooldown_s - (now - e.opened_at))
                        if e.state == "open" and e.opened_at is not None
                        else 0.0
                    ),
                    "last_error": e.last_error,
                })
            return rows

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_REGISTRY = QuarantineRegistry()


def quarantine() -> QuarantineRegistry:
    """The process-wide quarantine registry."""
    return _REGISTRY


def reset() -> None:
    """Drop all breaker state (tests; a deliberate ops 'unbench all')."""
    _REGISTRY.clear()


def configure(
    threshold: Optional[int] = None,
    cooldown_s: Optional[float] = None,
    clock: Optional[Callable[[], float]] = None,
) -> QuarantineRegistry:
    """Adjust the process-wide breaker policy in place (None = keep).

    In-place rather than replacing the singleton so modules that
    imported ``quarantine()`` results early never see a stale registry.
    """
    if threshold is not None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        _REGISTRY.threshold = threshold
    if cooldown_s is not None:
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        _REGISTRY.cooldown_s = cooldown_s
    if clock is not None:
        _REGISTRY.clock = clock
    return _REGISTRY
