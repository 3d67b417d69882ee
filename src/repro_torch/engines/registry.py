"""The engine registry: capability-described FFT engines, FFTW-style.

Port of ``repro.engines.registry``. An :class:`EngineSpec` declares what an
engine can do — problem kinds, precisions, backend family, radix, fusion, a
shared-memory working-set callback and ESTIMATE cost hints — and how to run
it. ``repro_torch.plan`` enumerates the registry by capability instead of a
hardcoded variant list. ``reliable`` is declared as in the reference and
read by the planner's quarantine filter, the degradation ladder's bottom
(``repro_torch.plan.autotune.variant_candidates``). The reference's
``requires_x64`` has no counterpart: PyTorch keeps 64-bit dtypes without a
mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "PRECISIONS",
    "CostHints",
    "EngineSpec",
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

#: Numeric precisions an engine may declare.
PRECISIONS = ("single", "double")


@dataclasses.dataclass(frozen=True)
class CostHints:
    """ESTIMATE-model coefficients for one engine (see ``plan.autotune``).

    traffic_factor   — HBM element-touches per butterfly pass.
    stage_overhead_s — per-stage dispatch overhead (seconds).
    flop_scale       — multiplier on the radix-2 butterfly FLOP count.
    entry_overhead_s — fixed per-call cost.
    """

    traffic_factor: float = 4.0
    stage_overhead_s: float = 0.8e-6
    flop_scale: float = 1.0
    entry_overhead_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One registered FFT engine: identity, capabilities, cost, executors.

    name               — registry key; the value ``FFTPlan.variant`` holds.
    backend            — execution-backend family ("torch" = plain tensor
                         ops, "cuda" = the hand-written kernels).
    kinds              — problem kinds the engine serves.
    precisions         — subset of :data:`PRECISIONS`.
    dtypes             — canonical I/O dtype names, documentation-grade.
    radix              — butterfly radix (stage count = log_radix N).
    fused              — True for whole-transform-on-chip kernels.
    reliable           — True marks an always-works degradation rung (plain
                         tensor ops): the ladder's bottom for its precision
                         (not on a CUDA key without a backend scope, whose
                         rungs are the kernels).
    single_device_only — engine cannot take part in multi-device plans.
    working_set        — optional ``(ProblemKey) -> bytes|None``: the
                         shared memory one block needs for that problem;
                         the planner drops the engine when it exceeds
                         ``repro_torch.kernels.ops.smem_budget_bytes()``.
    predicate          — optional extra capability check ``(ProblemKey) -> bool``.
    cost               — :class:`CostHints` for ESTIMATE.
    ops                — op factory ``(kind, direction) -> callable|None``;
                         the callable takes one tensor with the transform
                         axes last and returns the transform under the
                         backward convention (inverse scaled by 1/N).
    """

    name: str
    backend: str
    kinds: Tuple[str, ...]
    precisions: Tuple[str, ...] = ("single",)
    dtypes: Tuple[str, ...] = ("complex64", "float32")
    radix: int = 2
    fused: bool = False
    reliable: bool = False
    single_device_only: bool = False
    working_set: Optional[Callable] = None
    predicate: Optional[Callable] = None
    cost: CostHints = dataclasses.field(default_factory=CostHints)
    ops: Optional[Callable] = None

    def supports(self, key) -> bool:
        """True when this engine may serve ``key``: kind × precision ×
        backend scope × device count × shared-memory fit."""
        if key.kind not in self.kinds:
            return False
        if key.precision not in self.precisions:
            return False
        if key.backends and self.backend not in key.backends:
            return False
        if self.single_device_only and key.n_devices != 1:
            return False
        if self.predicate is not None and not self.predicate(key):
            return False
        if self.working_set is not None:
            ws = self.working_set(key)
            if ws is not None:
                from repro_torch.kernels.ops import smem_budget_bytes  # lazy

                if ws > smem_budget_bytes():
                    return False
        return True

    def op(self, kind: str, direction: str = "fwd") -> Callable:
        """The executor for ``(kind, direction)``; raises when unserved."""
        fn = None
        if kind in self.kinds and self.ops is not None:
            fn = self.ops(kind, direction)
        if fn is None:
            raise ValueError(
                f"engine {self.name!r} has no executor for kind {kind!r} "
                f"direction {direction!r} (declared kinds: {self.kinds})"
            )
        return fn


_REGISTRY: Dict[str, EngineSpec] = {}
#: Other names of registered engines; never enumerated by the planner.
_ALIASES: Dict[str, str] = {}
#: The builtin engines, whose bodies the ``repro_torch.core`` dispatch
#: chains run by name: replacing or removing one would leave dispatch
#: running the original while the registry advertised another, so the
#: registry refuses both, as the reference's does.
_PROTECTED: set = set()


def register_engine(spec: EngineSpec, *, replace: bool = False,
                    _protect: bool = False) -> EngineSpec:
    """Add ``spec`` to the registry, validating kinds and precisions, and
    refusing a duplicate name unless ``replace=True``; a builtin engine
    cannot be replaced at all (register under a new name instead)."""
    if not spec.name or not isinstance(spec.name, str):
        raise ValueError(f"engine name must be a non-empty string, got {spec.name!r}")
    if not spec.kinds:
        raise ValueError(f"engine {spec.name!r} declares no problem kinds")
    from repro_torch.plan.plan import KINDS  # lazy: plan builds on this module

    for kind in spec.kinds:
        if kind not in KINDS:
            raise ValueError(
                f"engine {spec.name!r} declares unknown kind {kind!r}; want members of {KINDS}"
            )
    for precision in spec.precisions:
        if precision not in PRECISIONS:
            raise ValueError(
                f"engine {spec.name!r} declares unknown precision {precision!r}; "
                f"want members of {PRECISIONS}"
            )
    if spec.name in _ALIASES:
        raise ValueError(f"{spec.name!r} is an alias of engine {_ALIASES[spec.name]!r}")
    if spec.name in _REGISTRY:
        if spec.name in _PROTECTED:
            raise ValueError(
                f"engine {spec.name!r} is a builtin fused into the core dispatch chains "
                "and cannot be replaced; register your engine under a new name"
            )
        if not replace:
            raise ValueError(
                f"engine {spec.name!r} is already registered (pass replace=True to override)"
            )
    _REGISTRY[spec.name] = spec
    if _protect:
        _PROTECTED.add(spec.name)
    return spec


def unregister_engine(name: str) -> None:
    """Remove an engine (plugin teardown, tests); an unknown name is a
    no-op. Builtin engines, and their aliases, cannot be removed: core
    dispatch would keep running them while the planner denied they exist."""
    if _ALIASES.get(name, name) in _PROTECTED:
        raise ValueError(f"builtin engine {name!r} cannot be unregistered")
    _REGISTRY.pop(name, None)
    for alias in [a for a, target in _ALIASES.items() if target == name]:
        del _ALIASES[alias]


def engine(name: str, **fields):
    """Decorator-based registration: the decorated function is the spec's
    ``ops`` factory (it receives ``(kind, direction)`` and returns the
    transform callable, or None for a combination it cannot serve).
    Returns the registered :class:`EngineSpec`."""

    def deco(ops_factory: Callable) -> EngineSpec:
        return register_engine(EngineSpec(name=name, ops=ops_factory, **fields))

    return deco


def register_alias(alias: str, name: str) -> None:
    """Let ``alias`` name the registered engine ``name``: plans and scopes
    may carry it, :func:`get_engine` resolves it, and :func:`iter_engines`
    never lists it, so the planner ranks the engine once."""
    if name not in _REGISTRY:
        raise ValueError(f"cannot alias unknown engine {name!r}")
    if alias in _REGISTRY:
        raise ValueError(f"{alias!r} is a registered engine, not a free alias")
    _ALIASES[alias] = name


def get_engine(name: str) -> EngineSpec:
    """Look an engine up by name or alias; the error names what IS registered."""
    spec = _REGISTRY.get(_ALIASES.get(name, name))
    if spec is None:
        raise ValueError(f"unknown engine {name!r}; registered engines: {tuple(_REGISTRY)}")
    return spec


def has_engine(name: str) -> bool:
    return _ALIASES.get(name, name) in _REGISTRY


def iter_engines(
    kind: Optional[str] = None,
    precision: Optional[str] = None,
    backend: Optional[str] = None,
) -> Tuple[EngineSpec, ...]:
    """Registered engines in registration order, optionally filtered."""
    return tuple(
        spec for spec in _REGISTRY.values()
        if (kind is None or kind in spec.kinds)
        and (precision is None or precision in spec.precisions)
        and (backend is None or spec.backend == backend)
    )


def registered_variants(precision: Optional[str] = None) -> Tuple[str, ...]:
    """Engine names, optionally restricted to one precision."""
    return tuple(s.name for s in iter_engines(precision=precision))


def registered_backends() -> Tuple[str, ...]:
    """Distinct backend families currently registered (sorted)."""
    return tuple(sorted({s.backend for s in _REGISTRY.values()}))
