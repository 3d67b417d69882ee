"""repro_torch.resilience — fault injection, engine quarantine, degradation.

Port of ``repro.resilience``, the robustness counterpart to
:mod:`repro_torch.obs`: every failure survivable, and deliberately
injectable, so survival is tested instead of hoped for.

* :mod:`.faults`   — ``FaultPlan``/``FaultSpec``: a seeded, frozen chaos
  schedule scoped via ``repro_torch.xfft.config(faults=...)``; named seams
  across planner, cache, kernels, engines and serving.
* :mod:`.breaker`  — per-(engine, problem-key) circuit breakers
  (closed → open → cooldown → half-open probe → closed); the planner
  excludes quarantined engines from its candidate sweep.
* :mod:`.ladder`   — ``run_plan``: engine dispatch with failover down
  the ESTIMATE-ranked rungs (on the card: the hand-written kernels), plus
  the opt-in ``check_health="nan"`` output guard.
* :mod:`.policies` — ``ServicePolicy``: per-request deadlines, bounded
  jittered retry, and queue-depth load shedding (typed ``Overloaded``)
  for the serve layer.

Layering: this package imports only ``repro_torch.obs`` and the standard
library at module scope (the ladder reaches into the planner lazily),
so plan, engines, kernels, xfft and serve can all depend on it without
cycles.
"""

from repro_torch.resilience.breaker import (
    QuarantineRegistry,
    configure,
    quarantine,
    reset,
)
from repro_torch.resilience.faults import (
    FAULT_MODES,
    FAULT_SEAMS,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active_faults,
    pop_faults,
    push_faults,
)
from repro_torch.resilience.ladder import run_plan
from repro_torch.resilience.policies import (
    DeadlineExceeded,
    Overloaded,
    ServicePolicy,
    admit,
    execute_with_policy,
)

__all__ = [
    "FAULT_MODES",
    "FAULT_SEAMS",
    "DeadlineExceeded",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "Overloaded",
    "QuarantineRegistry",
    "ServicePolicy",
    "active_faults",
    "admit",
    "configure",
    "execute_with_policy",
    "pop_faults",
    "push_faults",
    "quarantine",
    "reset",
    "run_plan",
]
