"""repro_torch.engines — the FFT engine registry the planner schedules.

Importing this package registers the built-in engines and the
double-precision ``reference_x64`` engine. Third-party engines register
with :func:`register_engine` or the :func:`engine` decorator and are
reached through :func:`apply_engine`.
"""

from repro_torch.engines.registry import (
    PRECISIONS,
    CostHints,
    EngineSpec,
    engine,
    get_engine,
    has_engine,
    iter_engines,
    register_alias,
    register_engine,
    registered_backends,
    registered_variants,
    unregister_engine,
)
from repro_torch.engines import builtin as _builtin  # noqa: F401
from repro_torch.engines import x64 as _x64  # noqa: F401

__all__ = [
    "PRECISIONS",
    "CostHints",
    "EngineSpec",
    "apply_engine",
    "engine",
    "get_engine",
    "has_engine",
    "iter_engines",
    "register_alias",
    "register_engine",
    "registered_backends",
    "registered_variants",
    "unregister_engine",
]


def apply_engine(name: str, kind: str, x, *, direction: str = "fwd",
                 axis: int | None = None):
    """Run ``x`` through engine ``name``'s executor for ``(kind, direction)``.

    The fallback the ``repro_torch.core`` entries take for a variant their
    builtin dispatch does not know (``fft2_stream`` under
    ``reference_x64``, a third-party engine), so a registered engine serves
    every call path without those layers learning its name. A tensor runs
    on its own device; other input goes to the card. ``axis`` (1D kinds
    only) names the transform axis; the executor always sees it last.

    The ``engine.apply`` span is not emitted here: it belongs to
    :func:`repro_torch.resilience.run_plan`, which wraps every planned
    dispatch.
    """
    fn = get_engine(name).op(kind, direction)
    from repro_torch.xfft._transforms import _as_tensor  # lazy: xfft builds on engines

    x = _as_tensor(x)
    if axis is not None and kind in ("fft1d", "rfft1d"):
        ax = axis % x.dim()
        if ax != x.dim() - 1:
            return fn(x.movedim(ax, -1)).movedim(-1, ax)
    return fn(x)
