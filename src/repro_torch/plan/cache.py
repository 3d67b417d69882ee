"""Plan cache: an in-memory map with versioned JSON persistence.

Port of ``repro.plan.cache``. Files use the reference's wisdom format
(``file_format`` 1, plan schema v5), so a file either package saves loads
in the other. Saves are atomic: a temp file in the same directory, fsynced,
then renamed over the target. Every load is accounted for in a
:class:`LoadReport`, emitted as a ``plan.cache.load`` event and counted
under ``plan.cache.load.*``; every save emits ``plan.cache.save``, as in
the reference. Reads and writes consult the ``plan.cache.load`` and
``plan.cache.save`` fault seams (``repro_torch.resilience``); a write that
fails, injected or real, degrades the cache to memory-only and says so
(``plan.cache.readonly``). The process-wide default cache is backed by
the file named in ``$REPRO_PLAN_CACHE``, read once a process.

The cache keeps the reference's accounting: hits per key (what
``repro_torch.xfft.report`` shows), the sum of every load's report, and
the wisdom staleness of loaded entries — a live MEASURE ``put`` that
disagrees with a loaded entry's engine emits ``serve.wisdom.stale`` and
counts one more consecutive loss against it
(``repro_torch.serve.wisdom.export`` ages such entries out).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
from typing import Dict, Optional, Tuple

from repro_torch import obs
from repro_torch.plan.plan import PLAN_SCHEMA_VERSION, FFTPlan, ProblemKey
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.faults import InjectedFault

__all__ = ["LoadReport", "PlanCache", "default_cache", "reset_default_cache"]

#: Environment variable naming the on-disk cache file for the process-wide
#: default cache. Unset -> the default cache is memory-only.
CACHE_ENV_VAR = "REPRO_PLAN_CACHE"

_FILE_FORMAT = 1

_log = logging.getLogger("repro_torch.plan.cache")


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """Accounting for one :meth:`PlanCache.load`.

    kept         — entries merged into the cache.
    stale_schema — dropped: cache-key version prefix != current schema.
    malformed    — dropped: the plan failed to deserialise (this includes
                   an engine the port has not registered).
    key_mismatch — dropped: stored key and plan's own key disagree.
    file_error   — the file was unreadable; ``None`` when it parsed.
    """

    kept: int = 0
    stale_schema: int = 0
    malformed: int = 0
    key_mismatch: int = 0
    file_error: Optional[str] = None

    @property
    def dropped(self) -> int:
        return self.stale_schema + self.malformed + self.key_mismatch

    def __add__(self, other: "LoadReport") -> "LoadReport":
        return LoadReport(
            kept=self.kept + other.kept,
            stale_schema=self.stale_schema + other.stale_schema,
            malformed=self.malformed + other.malformed,
            key_mismatch=self.key_mismatch + other.key_mismatch,
            file_error=other.file_error or self.file_error,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """Maps ``ProblemKey.cache_key()`` strings to :class:`FFTPlan`.

    ``path`` (optional) backs the cache with a JSON file: it is loaded at
    construction (unless ``autoload=False``) and rewritten atomically by
    :meth:`save`. Besides the aggregate ``hits``/``misses``, the cache
    counts hits per key (:meth:`hit_count`) and sums the accounting of
    every :meth:`load` on :attr:`load_report`.
    """

    def __init__(self, path: Optional[str] = None, autoload: bool = True):
        self._plans: Dict[str, FFTPlan] = {}
        self.path = path
        self.hits = 0
        self.misses = 0
        self.key_hits: Dict[str, int] = {}
        self.load_report: Optional[LoadReport] = None
        #: Set when a save hit an unwritable path and the cache degraded
        #: to memory-only; holds the path that refused the write.
        self.readonly_path: Optional[str] = None
        #: The engine each loaded entry arrived with, and how many
        #: consecutive live MEASURE re-tunes disagreed with it.
        self._artifact_variants: Dict[str, str] = {}
        self.stale_losses: Dict[str, int] = {}
        if path and autoload and os.path.exists(path):
            self.load(path)

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: ProblemKey) -> bool:
        return key.cache_key() in self._plans

    def get(self, key: ProblemKey) -> Optional[FFTPlan]:
        ck = key.cache_key()
        plan = self._plans.get(ck)
        if plan is None:
            self.misses += 1
        else:
            self.hits += 1
            self.key_hits[ck] = self.key_hits.get(ck, 0) + 1
        return plan

    def put(self, plan: FFTPlan) -> FFTPlan:
        ck = plan.key.cache_key()
        loaded = self._artifact_variants.get(ck)
        if loaded is not None and plan.mode == "measure":
            if plan.variant != loaded:
                # A live MEASURE sweep beat the loaded entry: one more loss.
                losses = self.stale_losses.get(ck, 0) + 1
                self.stale_losses[ck] = losses
                obs.emit("serve.wisdom.stale", key=ck, artifact_variant=loaded,
                         measured_variant=plan.variant, losses=losses)
                obs.count("serve.wisdom.stale")
            elif ck in self.stale_losses:
                # The loaded choice was confirmed: losses are consecutive.
                del self.stale_losses[ck]
        self._plans[ck] = plan
        return plan

    def clear(self) -> None:
        self._plans.clear()
        self.key_hits.clear()
        self.hits = 0
        self.misses = 0
        self.load_report = None
        self._artifact_variants.clear()
        self.stale_losses.clear()

    def entries(self) -> Tuple[Tuple[str, FFTPlan], ...]:
        """(cache_key, plan) pairs, sorted by key."""
        return tuple(sorted(self._plans.items()))

    def hit_count(self, cache_key: str) -> int:
        """How many :meth:`get` hits the entry under ``cache_key`` served."""
        return self.key_hits.get(cache_key, 0)

    def save(
        self,
        path: Optional[str] = None,
        *,
        measured_only: bool = False,
        exclude: Tuple[str, ...] = (),
    ) -> Optional[str]:
        """Atomically write the plans to ``path`` (default ``self.path``).

        ``measured_only=True`` writes only MEASURE-mode plans (the form a
        wisdom artifact ships in); ``exclude`` drops the named cache keys.
        The write goes to a temp file in the same directory, is fsynced,
        then renamed over the target, so a killed process never leaves a
        truncated wisdom file.

        An unwritable path (or an injected ``plan.cache.save`` fault) does
        NOT raise: the cache degrades to memory-only — ``self.path`` is
        cleared, the path is kept on :attr:`readonly_path`, and a
        ``plan.cache.readonly`` event and counter record it. Returns the
        path written, or ``None`` after a degrade.
        """
        path = path or self.path
        if not path:
            raise ValueError("PlanCache.save needs a path (none configured)")
        plans = self._plans
        if measured_only:
            plans = {k: p for k, p in plans.items() if p.mode == "measure"}
        if exclude:
            dropped = frozenset(exclude)
            plans = {k: p for k, p in plans.items() if k not in dropped}
        payload = {
            "file_format": _FILE_FORMAT,
            "plan_schema_version": PLAN_SCHEMA_VERSION,
            "plans": {k: p.to_dict() for k, p in plans.items()},
        }
        try:
            _faults.maybe_fail("plan.cache.save", path=path)
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except (OSError, InjectedFault) as e:
            self.readonly_path = path
            if self.path == path:
                self.path = None  # memory-only from here on
            obs.emit("plan.cache.readonly", path=path, error=str(e), entries=len(self._plans))
            obs.count("plan.cache.readonly")
            _log.warning("plan cache path %s is unwritable (%s); degrading to in-memory "
                         "caching", path, e)
            return None
        obs.emit("plan.cache.save", path=path, entries=len(plans))
        return path

    def load(self, path: Optional[str] = None) -> LoadReport:
        """Merge plans from ``path``; returns the kept/dropped accounting."""
        path = path or self.path
        if not path:
            raise ValueError("PlanCache.load needs a path (none configured)")
        try:
            _faults.maybe_fail("plan.cache.load", path=path)
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError, InjectedFault) as e:
            return self._account_load(path, LoadReport(file_error=str(e)))
        prefix = f"v{PLAN_SCHEMA_VERSION}|"
        kept = stale = malformed = mismatch = 0
        for key, plan_dict in payload.get("plans", {}).items():
            if not key.startswith(prefix):
                stale += 1
                continue
            try:
                plan = FFTPlan.from_dict(plan_dict)
            except (KeyError, TypeError, ValueError):
                malformed += 1
                continue
            if plan.key.cache_key() != key:
                mismatch += 1
                continue
            self._plans[key] = plan
            self._artifact_variants[key] = plan.variant
            kept += 1
        return self._account_load(path, LoadReport(
            kept=kept, stale_schema=stale, malformed=malformed, key_mismatch=mismatch
        ))

    def _account_load(self, path: str, report: LoadReport) -> LoadReport:
        """Add ``report`` to :attr:`load_report`, emit ``plan.cache.load``
        and bump the ``plan.cache.load.*`` counters."""
        self.load_report = report if self.load_report is None else self.load_report + report
        obs.emit("plan.cache.load", path=path, kept=report.kept,
                 stale_schema=report.stale_schema, malformed=report.malformed,
                 key_mismatch=report.key_mismatch, file_error=report.file_error)
        obs.count("plan.cache.load.kept", report.kept)
        obs.count("plan.cache.load.stale_schema", report.stale_schema)
        obs.count("plan.cache.load.malformed", report.malformed)
        obs.count("plan.cache.load.key_mismatch", report.key_mismatch)
        if report.file_error is not None:
            obs.count("plan.cache.load.file_error")
        return report


_DEFAULT: Optional[PlanCache] = None


def default_cache() -> PlanCache:
    """The process-wide cache ``resolve_call`` uses by default.

    Backed by the file named in ``$REPRO_PLAN_CACHE`` when set, else
    memory-only. The variable is read once a process, at the first touch,
    which emits a ``plan.cache.attached`` event (path, entries kept from
    the wisdom file, source) and logs it: the record of what it resolved
    to.
    """
    global _DEFAULT
    if _DEFAULT is None:
        path = os.environ.get(CACHE_ENV_VAR) or None
        _DEFAULT = PlanCache(path=path)
        obs.emit("plan.cache.attached", path=path, entries=len(_DEFAULT),
                 source=CACHE_ENV_VAR if path else "memory")
        _log.info("default plan cache attached: path=%s entries=%d", path, len(_DEFAULT))
    return _DEFAULT


def reset_default_cache() -> None:
    """Drop the process-wide cache (tests; or after changing the env var)."""
    global _DEFAULT
    _DEFAULT = None
