"""repro_torch.obs — structured tracing, metrics and plan introspection.

Port of ``repro.obs``: the same events, counters, histograms, exporters
and always-on telemetry, pure Python (``torch.profiler`` takes the place
of ``jax.profiler`` for span ranges). Decision points of the port emit
structured events through this package: planner resolution
(``plan.resolve``, ``plan.degrade``, ``plan.measure`` and
``plan.measure.candidate`` in ``repro_torch.plan``), wisdom load, save,
attach and read-only degrade (``plan.cache.*``), engine dispatch and
failover (``engine.apply``, ``resilience.*`` in
``repro_torch.resilience``), the 2D kernels' composed route
(``kernel.failover``), and each CG iteration of MRI reconstruction
(``mri.cg.iter`` in ``repro_torch.mri``).

    from repro_torch import obs
    import repro_torch.xfft as xfft

    with obs.capture() as trace:
        xfft.fft2(x)                       # cold: plan miss
        xfft.fft2(x)                       # warm: plan hit
    [e["outcome"] for e in trace.select("plan.resolve")]  # ['miss', 'hit']

Process-wide counters stay on even without a capture scope (one dict
increment per event).

Always-on telemetry rides the sink hook (:mod:`repro_torch.obs.telemetry`,
installed at import): a bounded **flight recorder** keeps the most
recent events with no capture scope open and dumps a JSONL snapshot
when a failure trigger fires, and a **calibration ledger** joins planner
predictions against observed engine dispatch times. Latency histograms
(:mod:`repro_torch.obs.hist`) and exporters — JSONL, Chrome trace,
Prometheus text (:mod:`repro_torch.obs.export`) — make all of it
consumable by standard tooling.
"""

from repro_torch.obs import export, hist, telemetry
from repro_torch.obs.hist import (
    LatencyHistogram,
    histogram,
    histograms,
    reset_histograms,
)
from repro_torch.obs.record import (
    Event,
    Trace,
    add_sink,
    capture,
    count,
    counters,
    emit,
    enabled,
    pop_observe,
    profiling,
    push_observe,
    remove_sink,
    reset_counters,
    span,
)
from repro_torch.obs.telemetry import (
    CalibrationLedger,
    FlightRecorder,
    calibration_ledger,
    flight_recorder,
    set_flight_recorder,
)

__all__ = [
    "CalibrationLedger",
    "Event",
    "FlightRecorder",
    "LatencyHistogram",
    "Trace",
    "add_sink",
    "calibration_ledger",
    "capture",
    "count",
    "counters",
    "emit",
    "enabled",
    "export",
    "flight_recorder",
    "hist",
    "histogram",
    "histograms",
    "pop_observe",
    "profiling",
    "push_observe",
    "remove_sink",
    "reset_counters",
    "reset_histograms",
    "set_flight_recorder",
    "span",
    "telemetry",
]

# Always-on by default: the black box records from the first import.
telemetry.install_default()
