"""Fixed log-bucket latency histograms: mergeable, bounded, exact-ish tails.

Port of ``repro.obs.hist`` (pure Python, unchanged).

The serve loop's product is its latency *tail*, and raw-sample
percentiles (``np.percentile`` over an unbounded list) are the wrong
tool for a long-running process: memory grows with traffic, merging two
processes' samples means shipping both lists, and the estimate jumps
around with every batch. A :class:`LatencyHistogram` fixes all three
with the standard HDR trick — fixed logarithmic buckets over the
microsecond domain:

* **bounded** — ``buckets`` integer cells, regardless of sample count;
* **mergeable** — two histograms with the same geometry add cell-wise,
  so per-lane, per-engine and per-process views compose;
* **exact within bucket resolution** — a reported percentile is the
  upper bound of the cell holding that rank, so it is within one
  ``growth`` factor (~19% at the default quarter-octave geometry) of
  the true order statistic, *by construction*, at any traffic volume.

The process-wide named registry (:func:`histogram`) is how the serve
loop and the engine dispatch spans attach their observations without
threading handles through every layer; the Prometheus exporter reads
:func:`histograms` back out.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

__all__ = [
    "LatencyHistogram",
    "histogram",
    "histograms",
    "reset_histograms",
]


class LatencyHistogram:
    """Log-bucket histogram over microseconds: record / merge / percentile.

    Geometry: cell 0 holds everything ``<= min_us``; cell ``i`` holds
    ``(min_us * growth**(i-1), min_us * growth**i]``; the last cell is a
    catch-all for the far tail. The default quarter-octave growth
    (``2**0.25 ≈ 1.19``) over 128 cells spans 1 µs to ~66 minutes.
    """

    __slots__ = ("min_us", "growth", "buckets", "_log_growth", "_cells",
                 "count", "sum_us", "max_us", "_lock")

    def __init__(self, min_us: float = 1.0, growth: float = 2 ** 0.25,
                 buckets: int = 128):
        if min_us <= 0 or growth <= 1.0 or buckets < 2:
            raise ValueError(
                f"bad histogram geometry: min_us={min_us} growth={growth} "
                f"buckets={buckets}"
            )
        self.min_us = float(min_us)
        self.growth = float(growth)
        self.buckets = int(buckets)
        self._log_growth = math.log(self.growth)
        self._cells = [0] * self.buckets
        self.count = 0
        self.sum_us = 0.0
        self.max_us = 0.0
        self._lock = threading.Lock()

    def bucket_index(self, us: float) -> int:
        """The cell a latency of ``us`` microseconds falls into.

        Upper bounds are inclusive: the epsilon keeps a value sitting
        exactly on ``bucket_bound(i)`` (e.g. a reported percentile fed
        back in) in cell ``i`` despite floating-point log round-off.
        """
        if us <= self.min_us:
            return 0
        i = 1 + int(math.log(us / self.min_us) / self._log_growth - 1e-9)
        return min(i, self.buckets - 1)

    def bucket_bound(self, index: int) -> float:
        """Upper bound (µs) of cell ``index`` — what percentiles report."""
        return self.min_us * self.growth ** index

    def record(self, us: float) -> None:
        """Add one observation of ``us`` microseconds."""
        us = max(float(us), 0.0)
        i = self.bucket_index(us)
        with self._lock:
            self._cells[i] += 1
            self.count += 1
            self.sum_us += us
            if us > self.max_us:
                self.max_us = us

    def merge(self, other: "LatencyHistogram") -> None:
        """Add ``other``'s cells into this histogram (same geometry only)."""
        if (other.min_us, other.growth, other.buckets) != (
            self.min_us, self.growth, self.buckets
        ):
            raise ValueError("cannot merge histograms with different geometry")
        with other._lock:
            cells = list(other._cells)
            count, sum_us, max_us = other.count, other.sum_us, other.max_us
        with self._lock:
            for i, c in enumerate(cells):
                self._cells[i] += c
            self.count += count
            self.sum_us += sum_us
            if max_us > self.max_us:
                self.max_us = max_us

    def percentile(self, p: float) -> float:
        """The latency (µs) at percentile ``p`` — the upper bound of the
        cell where the cumulative count crosses rank ``ceil(p/100 * n)``.
        Returns 0.0 when empty."""
        with self._lock:
            n = self.count
            if n == 0:
                return 0.0
            target = max(1, math.ceil(n * p / 100.0))
            seen = 0
            for i, c in enumerate(self._cells):
                seen += c
                if seen >= target:
                    return self.bucket_bound(i)
        return self.bucket_bound(self.buckets - 1)  # pragma: no cover

    def mean_us(self) -> float:
        with self._lock:
            return self.sum_us / self.count if self.count else 0.0

    def cells(self) -> List[int]:
        """Snapshot of the raw cell counts (tests / exporters)."""
        with self._lock:
            return list(self._cells)

    def to_dict(self) -> Dict[str, float]:
        """Summary for benchmark JSON and the report: count + tail stats."""
        return {
            "count": self.count,
            "mean_us": round(self.mean_us(), 2),
            "p50_us": round(self.percentile(50), 2),
            "p95_us": round(self.percentile(95), 2),
            "p99_us": round(self.percentile(99), 2),
            "max_us": round(self.max_us, 2),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LatencyHistogram(n={self.count}, p50={self.percentile(50):.1f}us, "
                f"p99={self.percentile(99):.1f}us)")


# ------------------------ process-wide registry ----------------------------

_HISTS: Dict[str, LatencyHistogram] = {}
_HISTS_LOCK = threading.Lock()


def histogram(name: str, *, min_us: float = 1.0, growth: float = 2 ** 0.25,
              buckets: int = 128) -> LatencyHistogram:
    """Get-or-create the process-wide histogram ``name``.

    Geometry arguments apply only on first creation; every later caller
    shares the same instance (that is what makes lane and engine views
    accumulate across the process lifetime).
    """
    with _HISTS_LOCK:
        h = _HISTS.get(name)
        if h is None:
            h = LatencyHistogram(min_us=min_us, growth=growth, buckets=buckets)
            _HISTS[name] = h
        return h


def histograms(prefix: Optional[str] = None) -> Dict[str, LatencyHistogram]:
    """Snapshot of the registry (optionally filtered by name prefix)."""
    with _HISTS_LOCK:
        items = sorted(_HISTS.items())
    if prefix is None:
        return dict(items)
    return {k: v for k, v in items if k.startswith(prefix)}


def reset_histograms() -> None:
    """Drop every registered histogram (tests / benchmark harnesses)."""
    with _HISTS_LOCK:
        _HISTS.clear()
