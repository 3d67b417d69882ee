"""Wisdom artifacts: ship pre-tuned plan caches with the package (FFTW model).

Port of ``repro.serve.wisdom``. MEASURE tuning times every candidate
engine — a sweep per problem key. A fleet of servers must not pay that per
process: FFTW solved this with *wisdom files* exported once and imported
everywhere, and this module is that model for ``repro_torch.plan``:

* :func:`export` writes the active plan cache's MEASURE entries to a
  wisdom artifact (atomic, via :meth:`PlanCache.save`), leaving out
  entries that live re-tunes keep outvoting (staleness aging);
* :func:`warm_start` merges an artifact into a process's cache, with the
  full :class:`~repro_torch.plan.cache.LoadReport` accounting;
* :func:`pretune` runs the MEASURE sweeps that *produce* wisdom for a
  list of frame sizes on one device;
* :data:`WISDOM_DIR` holds the artifacts packaged with the port
  (``wisdom_files/<backend>.json``, ``backend`` a torch device type).

Plan cache keys embed the device type and the device's name (a card's
keys carry its model), the precision and the schema version, so an
artifact tuned on one card can never poison another: foreign entries
never match, and stale schema versions are dropped (and counted) at load.

Regenerating a packaged artifact (from the repo root)::

    PYTHONPATH=src python -m repro_torch.serve.wisdom --backend cuda --sizes 64,128,256,512,1024
    PYTHONPATH=src python -m repro_torch.serve.wisdom --backend cpu --sizes 64,128,256

writes ``src/repro_torch/serve/wisdom_files/<backend>.json``; ``--backend``
is the port's explicit-device counterpart of the reference's
``JAX_PLATFORMS``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.plan.cache import LoadReport, PlanCache, default_cache

__all__ = [
    "WISDOM_DIR",
    "artifact_path",
    "export",
    "pretune",
    "warm_start",
]

#: Directory of wisdom artifacts packaged with the port, one per backend
#: (``<backend>.json``, named after the torch device type they were tuned on).
WISDOM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wisdom_files")

#: The backend of the device the port's entry points use by default.
DEFAULT_BACKEND = "cuda"


def _active_cache() -> PlanCache:
    """The cache the current scope plans against: a scoped ``cache_dir``'s
    file-backed cache when one is configured, else the process default."""
    from repro_torch.plan.api import _cache_for_dir
    from repro_torch.xfft import get_config

    cfg = get_config()
    if cfg.cache_dir:
        return _cache_for_dir(cfg.cache_dir)
    return default_cache()


def artifact_path(backend: Optional[str] = None) -> Optional[str]:
    """Path of the packaged artifact for ``backend`` (default: ``"cuda"``,
    the device the port runs on unless told otherwise), or ``None`` when no
    artifact ships for it."""
    backend = backend if backend is not None else DEFAULT_BACKEND
    path = os.path.join(WISDOM_DIR, f"{backend}.json")
    return path if os.path.exists(path) else None


def export(
    path: str,
    cache: Optional[PlanCache] = None,
    *,
    measured_only: bool = True,
    stale_loss_threshold: Optional[int] = 3,
) -> str:
    """Write ``cache`` (default: the active scope's cache) to ``path``.

    Only MEASURE entries ship by default — ESTIMATE plans cost nothing to
    recreate and would pin one machine's heuristics on another. Raises
    ``RuntimeError`` when the path is unwritable.

    **Staleness aging**: loaded entries that lost to a live MEASURE re-tune
    ``stale_loss_threshold`` or more consecutive times
    (:attr:`PlanCache.stale_losses`) are left out of the written artifact.
    ``None`` disables aging.
    """
    cache = cache if cache is not None else _active_cache()
    stale = (
        tuple(
            k for k, losses in cache.stale_losses.items()
            if losses >= stale_loss_threshold
        )
        if stale_loss_threshold is not None else ()
    )
    written = cache.save(path, measured_only=measured_only, exclude=stale)
    if written is None:
        raise RuntimeError(
            f"wisdom export to {path!r} failed: path is unwritable "
            f"(see the plan.cache.readonly event for the cause)"
        )
    obs.emit(
        "serve.wisdom.export",
        path=written,
        entries=len(cache),
        measured_only=measured_only,
        dropped_stale=len(stale),
    )
    return written


def warm_start(
    path: Optional[str] = None, cache: Optional[PlanCache] = None
) -> LoadReport:
    """Merge a wisdom artifact into ``cache`` (default: the active cache).

    ``path=None`` uses the packaged artifact of the default backend
    (:func:`artifact_path`). Returns the :class:`LoadReport`; a missing
    packaged artifact is not an error (``file_error`` says so), because a
    fresh process can always tune itself.
    """
    cache = cache if cache is not None else _active_cache()
    if path is None:
        path = artifact_path()
    if path is None:
        report = LoadReport(file_error="no packaged wisdom artifact for backend")
    else:
        report = cache.load(path)
    obs.emit(
        "serve.wisdom.warm_start",
        path=path,
        kept=report.kept,
        dropped=report.dropped,
        file_error=report.file_error,
    )
    return report


def pretune(
    sizes: Sequence[int],
    kinds: Tuple[str, ...] = ("rfft2d", "fft2d"),
    directions: Tuple[str, ...] = ("fwd",),
    cache: Optional[PlanCache] = None,
    measure_iters: int = 3,
    device=None,
) -> PlanCache:
    """Run the MEASURE sweeps that produce wisdom for square frames.

    Tunes ``kind × direction`` for every ``N × N`` size on ``device``
    (default: the card) into ``cache`` (default: a fresh in-memory cache,
    so an artifact holds exactly what was asked for).
    """
    from repro_torch.plan import plan_fft

    cache = cache if cache is not None else PlanCache()
    for n in sizes:
        for kind in kinds:
            dtype = "float32" if kind.startswith("r") else "complex64"
            for direction in directions:
                plan_fft(
                    kind,
                    (int(n), int(n)),
                    device,
                    dtype=dtype,
                    mode="measure",
                    cache=cache,
                    direction=direction,
                    measure_iters=measure_iters,
                )
    return cache


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate a packaged wisdom artifact (MEASURE sweeps)."
    )
    ap.add_argument("--backend", default=DEFAULT_BACKEND,
                    help="torch device type to tune on: cuda (default) or cpu")
    ap.add_argument("--sizes", default="64,128,256",
                    help="comma-separated square frame sizes")
    ap.add_argument("--kinds", default="rfft2d,fft2d")
    ap.add_argument("--out", default=None,
                    help="output path (default: wisdom_files/<backend>.json)")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    kinds = tuple(k for k in args.kinds.split(",") if k)
    out = args.out or os.path.join(WISDOM_DIR, f"{args.backend}.json")
    cache = pretune(sizes, kinds=kinds, device=args.backend)
    written = export(out, cache)
    print(f"wrote {len(cache)} measured plans to {written}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
