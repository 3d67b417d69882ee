"""repro_torch.resilience against repro.resilience, and the ladder on the CPU.

``faults``, ``breaker`` and ``policies`` are pure Python in both packages
(the reference's import no JAX), so the same calls run through both and
are compared exactly: the same ``FaultPlan`` and seed fire on the same
consultations, the same events carry the same fields, the same breaker
walks the same states under an injected clock, and ``execute_with_policy``
sleeps the same backoff sequence for a seed. Times are left out: obs does
no arithmetic beyond timing.

The reference's ``run_plan`` fails when called on this jax except on a
forced plan (its health check imports ``repro.xfft._config``,
``src/repro/resilience/ladder.py:35``), so the port's ladder is held to
that module's docstring and to the assertions of
``tests/resilience/test_ladder.py``, on CPU tensors through
``repro_torch.xfft`` scoped to ``backend="torch"`` (the plain schedules,
whose bottom rung is ``stockham``, as the reference's is), against numpy at
rtol/atol 1e-4 (the reference test's tolerance). The forced plan's
``engine.apply`` span is compared with the reference's field for field.
The port's divergence, kernels-only rungs on a CUDA key, is pinned on keys
built without a card.
"""

import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import resilience as jres
from repro.kernels import ops as jops
from repro.plan import plan as jplan
from repro.resilience import breaker as jbreaker
from repro.resilience import faults as jfaults
from repro.resilience import ladder as jladder
from repro_torch import obs, resilience, xfft
from repro_torch.kernels import ops
from repro_torch.plan import PlanCache, resolve_call
from repro_torch.plan.autotune import variant_candidates
from repro_torch.plan.plan import FFTPlan, ProblemKey
from repro_torch.resilience import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    active_faults,
    configure,
    pop_faults,
    push_faults,
    quarantine,
    reset,
)
from repro_torch.resilience import breaker, faults, ladder, policies
from repro_torch.resilience.faults import FaultState, maybe_corrupt, maybe_fail, vmem_exhausted

CPU = torch.device("cpu")
SHAPE = (8, 8)
TOL = 1e-4  # the reference ladder test's rtol/atol against numpy
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_breakers():
    for mod in (resilience, jres):
        mod.reset()
        mod.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    yield
    for mod in (resilience, jres):
        mod.reset()
        mod.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)


class Clock:
    """A settable clock: ``clock.now += 31.0`` drives a cooldown."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _fields(event):
    return {k: v for k, v in event.fields.items() if k != "duration_us"}


# ------------------------------ faults ------------------------------------


def test_vocabulary_and_exports_match_the_reference():
    assert resilience.FAULT_SEAMS == jres.FAULT_SEAMS
    assert resilience.FAULT_MODES == jres.FAULT_MODES
    assert resilience.__all__ == jres.__all__
    assert faults.__all__ == jfaults.__all__


@pytest.mark.parametrize("kwargs,match", [
    (dict(seam="engine.appply"), "unknown fault seam"),
    (dict(seam="engine.apply", mode="segfault"), "unknown fault mode"),
    (dict(seam="engine.apply", p=0.0), "probability"),
    (dict(seam="engine.apply", p=1.5), "probability"),
    (dict(seam="engine.apply", times=0), "times"),
])
def test_spec_validation_matches_the_reference(kwargs, match):
    with pytest.raises(ValueError, match=match) as port:
        FaultSpec(**kwargs)
    with pytest.raises(ValueError) as ref:
        jres.FaultSpec(**kwargs)
    assert str(port.value) == str(ref.value)


def test_specs_and_plans_normalise_as_the_reference_does():
    spec = FaultSpec("engine.apply", match={"kind": "fft2d", "engine": "radix4"})
    jspec = jres.FaultSpec("engine.apply", match={"kind": "fft2d", "engine": "radix4"})
    assert spec.match == jspec.match == (("engine", "radix4"), ("kind", "fft2d"))
    assert FaultPlan(FaultSpec("serve.batch")).specs == (FaultSpec("serve.batch"),)
    hash(FaultPlan(spec, seed=3))
    with pytest.raises(TypeError, match="FaultSpec"):
        FaultPlan(specs=("engine.apply",))


#: Consultations a schedule is replayed over: (seam, modes, ctx).
_CONSULTS = [
    ("engine.apply", ("error", "latency", "vmem"), {"engine": e, "kind": "fft2d"})
    for e in ("fused_r4", "fused", "stockham", "radix4")
] * 12 + [("kernel.fused", ("vmem",), {"kind": "rfft2d", "h": 8, "w": 8})] * 10 \
    + [("engine.apply", ("nan", "inf"), {"engine": "fused_r4"})] * 10


@pytest.mark.parametrize("specs,seed", [
    ((dict(seam="engine.apply", p=0.3),), 7),
    ((dict(seam="engine.apply", p=0.5),), 1),
    ((dict(seam="engine.apply", p=0.5, times=3, match={"engine": "fused"}),), 2),
    ((dict(seam="engine.apply", p=0.4, match={"engine": "fused_r4"}),
      dict(seam="kernel.fused", mode="vmem", p=0.6, times=4),
      dict(seam="engine.apply", mode="nan", p=0.5)), 11),
    ((dict(seam="engine.apply", times=2),), 0),
])
def test_same_plan_and_seed_fire_on_the_same_consultations(specs, seed):
    """The seeded RNG takes one draw a consultation with p < 1 in both
    packages, so the fired indices and specs agree one for one."""
    port = FaultState(FaultPlan(tuple(FaultSpec(**s) for s in specs), seed=seed))
    ref = jfaults.FaultState(jres.FaultPlan(tuple(jres.FaultSpec(**s) for s in specs),
                                            seed=seed))

    def fired(state):
        out = []
        for i, (seam, modes, ctx) in enumerate(_CONSULTS):
            spec = state.fire(seam, modes, dict(ctx))
            if spec is not None:
                out.append((i, spec.seam, spec.mode))
        return out

    got = fired(port)
    assert got == fired(ref)
    assert got  # the schedule fires somewhere


def test_fired_faults_emit_the_reference_events_and_counters():
    seen = {}
    for name, mod, res in (("port", obs, resilience), ("reference", jobs, jres)):
        faults_mod = faults if res is resilience else jfaults
        mod.reset_counters()
        plan = res.FaultPlan((res.FaultSpec("serve.batch", times=1),
                              res.FaultSpec("kernel.fused", mode="vmem", times=1),
                              res.FaultSpec("engine.apply", mode="latency", latency_s=0.0)))
        token = res.push_faults(plan)
        try:
            with mod.capture() as trace:
                with pytest.raises(res.InjectedFault) as err:
                    faults_mod.maybe_fail("serve.batch", service="lm")
                assert faults_mod.vmem_exhausted("kernel.fused", kind="fft2d", h=8, w=8)
                assert not faults_mod.vmem_exhausted("kernel.fused", kind="fft2d", h=8, w=8)
                faults_mod.maybe_fail("engine.apply", engine="fused")
        finally:
            res.pop_faults(token)
        seen[name] = ([(e.name, e.fields) for e in trace], (err.value.seam, err.value.mode),
                      {k: v for k, v in mod.counters().items() if k.startswith("resilience")})
    assert seen["port"] == seen["reference"]
    assert [e for e, _ in seen["port"][0]] == ["resilience.fault"] * 3


def test_hooks_are_no_ops_without_a_plan():
    assert active_faults() is None
    maybe_fail("engine.apply")
    x = torch.ones(4)
    assert maybe_corrupt("engine.apply", x) is x
    assert vmem_exhausted("kernel.fused") is False


def test_error_and_vmem_faults_raise_injected_faults():
    token = push_faults(FaultPlan((FaultSpec("plan.cache.load", message="boom", times=1),
                                   FaultSpec("engine.apply", mode="vmem"))))
    try:
        with pytest.raises(InjectedFault, match="boom") as err:
            maybe_fail("plan.cache.load", path="/x")
        assert (err.value.seam, err.value.mode) == ("plan.cache.load", "error")
        # On the card the vmem mode stands for the shared-memory census:
        # the message reads like CUDA's launch refusal, not XLA's.
        with pytest.raises(InjectedFault, match="too many resources requested for launch"):
            maybe_fail("engine.apply")
    finally:
        pop_faults(token)


def test_latency_fault_stalls_then_returns():
    token = push_faults(FaultPlan(FaultSpec("plan.measure", mode="latency", latency_s=0.02)))
    try:
        t0 = time.perf_counter()
        maybe_fail("plan.measure")
        assert time.perf_counter() - t0 >= 0.015
    finally:
        pop_faults(token)


@pytest.mark.parametrize("mode,bad", [("nan", torch.isnan), ("inf", torch.isinf)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_maybe_corrupt_poisons_a_clone_on_the_tensors_device(mode, bad, dtype):
    """One element at the origin of a clone; the caller's tensor stays as it
    was, and the result stays on the input's device with its dtype."""
    x = torch.ones(3, 4, dtype=dtype)
    token = push_faults(FaultPlan(FaultSpec("engine.apply", mode=mode)))
    try:
        out = maybe_corrupt("engine.apply", x)
    finally:
        pop_faults(token)
    assert out is not x and out.device == x.device and out.dtype == x.dtype
    assert bool(bad(out[0, 0].real if out.is_complex() else out[0, 0]))
    assert int(torch.isfinite(out).sum()) == out.numel() - 1
    assert bool(torch.isfinite(x).all())


def test_maybe_corrupt_takes_numpy_payloads_like_the_reference():
    token = push_faults(FaultPlan(FaultSpec("engine.apply", mode="nan")))
    jtoken = jres.push_faults(jres.FaultPlan(jres.FaultSpec("engine.apply", mode="nan")))
    try:
        got = maybe_corrupt("engine.apply", np.ones((3, 4)))
        want = np.asarray(jfaults.maybe_corrupt("engine.apply", np.ones((3, 4))))
    finally:
        pop_faults(token)
        jres.pop_faults(jtoken)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_config_scopes_faults_and_check_health_like_the_reference():
    plan = FaultPlan(FaultSpec("engine.apply"))
    assert active_faults() is None
    with xfft.config(faults=plan):
        assert active_faults() is not None and active_faults().plan is plan
        with xfft.config(faults=False):
            assert active_faults() is None
        with xfft.config(variant="stockham"):  # inheriting keeps the firing state
            assert active_faults().plan is plan
        assert active_faults().plan is plan
    assert active_faults() is None
    assert xfft.get_config().check_health == "off"
    with xfft.config(check_health="nan"):
        assert xfft.get_config().check_health == "nan"
    assert xfft.get_config().check_health == "off"
    with pytest.raises(ValueError, match="FaultPlan"):
        xfft.config(faults="chaos")
    with pytest.raises(ValueError, match="check_health"):
        xfft.config(check_health="inf")


# ------------------------------ breaker -----------------------------------


def _breaker_script(registry, key, clock):
    """One scripted life of a breaker: returns its answers and table."""
    answers = [registry.excluded("fused_r4", key), registry.affects(key)]
    answers.append(registry.record_failure("fused_r4", key, error="boom"))
    answers += [registry.excluded("fused_r4", key), registry.affects(key),
                registry.excluded("fused", key)]
    table_open = registry.table()
    clock.now += 10.0
    answers.append(registry.excluded("fused_r4", key))      # still cooling down
    clock.now += 25.0
    answers.append(registry.excluded("fused_r4", key))      # half-open probe admitted
    answers.append(registry.record_failure("fused_r4", key, error="again"))  # reopens
    clock.now += 31.0
    answers.append(registry.excluded("fused_r4", key))
    registry.record_success("fused_r4", key)                 # closes
    answers += [registry.excluded("fused_r4", key), registry.affects(key)]
    registry.threshold = 2
    answers.append(registry.record_failure("fused", key))   # below threshold
    answers.append(registry.record_failure("fused", key))   # opens
    return answers, table_open, registry.table()


def test_breaker_transitions_match_the_reference():
    fields = dict(kind="fft2d", backend="cpu", device_kind="cpu", shape=(4, 64, 64),
                  dtype="complex64")
    seen = {}
    for name, mod, reg_mod, key in (
            ("port", obs, breaker, ProblemKey(**fields)),
            ("reference", jobs, jbreaker, jplan.ProblemKey(**fields))):
        clock = Clock()
        registry = reg_mod.QuarantineRegistry(threshold=1, cooldown_s=30.0, clock=clock)
        mod.reset_counters()
        with mod.capture() as trace:
            answers, table_open, table_end = _breaker_script(registry, key, clock)
        seen[name] = (answers, table_open, table_end, [(e.name, e.fields) for e in trace],
                      {k: v for k, v in mod.counters().items() if k.startswith("resilience")})
    assert seen["port"] == seen["reference"]
    states = [f["state"] for _, f in seen["port"][3]]
    assert states == ["open", "half_open", "open", "half_open", "closed", "open"]


def test_healthy_calls_take_no_lock():
    """With no failure ever recorded, the breaker's queries return before
    touching its lock (the hot path of every transform)."""

    class Forbidden:
        def __enter__(self):
            raise AssertionError("the breaker took its lock on a healthy call")

        def __exit__(self, *exc):
            return False

    registry = breaker.QuarantineRegistry()
    registry._lock = Forbidden()
    key = ProblemKey(kind="fft1d", backend="cpu", device_kind="cpu", shape=(64,),
                     dtype="complex64")
    assert registry.excluded("fused", key) is False
    assert registry.affects(key) is False
    registry.record_success("fused", key)


@pytest.mark.parametrize("kwargs", [dict(threshold=0), dict(cooldown_s=0.0)])
def test_breaker_configuration_is_validated_like_the_reference(kwargs):
    with pytest.raises(ValueError) as port:
        configure(**kwargs)
    with pytest.raises(ValueError) as ref:
        jres.configure(**kwargs)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError):
        breaker.QuarantineRegistry(**kwargs)


# ------------------------------ policies ----------------------------------


def _flaky(failures):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise RuntimeError("transient")
        return "ok"

    return fn


@pytest.mark.parametrize("seed", [0, 5, 6])
def test_backoff_sequence_and_retry_events_match_the_reference(seed):
    seen = {}
    for name, mod, res in (("port", obs, resilience), ("reference", jobs, jres)):
        slept, now = [], [0.0]
        policy = res.ServicePolicy(max_retries=3, backoff_s=0.01, backoff_jitter=0.25,
                                   deadline_s=5.0, seed=seed)
        with mod.capture() as trace:
            out = res.execute_with_policy(policy, _flaky(3), clock=lambda: now[0],
                                          sleep=slept.append, service="lm")
        seen[name] = (out, slept, [(e.name, e.fields) for e in trace])
    assert seen["port"] == seen["reference"]
    assert len(seen["port"][1]) == 3 and seen["port"][1][2] > seen["port"][1][0]


def test_shedding_deadline_and_seam_match_the_reference():
    seen = {}
    for name, mod, res in (("port", obs, resilience), ("reference", jobs, jres)):
        got = []
        with mod.capture() as trace:
            res.admit(res.ServicePolicy(max_queue=4), 4)
            with pytest.raises(res.Overloaded) as err:
                res.admit(res.ServicePolicy(max_queue=4), 5, service="spectrum")
            got.append((err.value.depth, err.value.limit, str(err.value)))
            clock = [0.0]

            def failing():
                clock[0] += 0.6
                raise RuntimeError("slow failure")

            with pytest.raises(res.DeadlineExceeded) as err:
                res.execute_with_policy(res.ServicePolicy(deadline_s=1.0, max_retries=5,
                                                          backoff_s=0.0),
                                        failing, clock=lambda: clock[0], sleep=lambda _: None)
            got.append((err.value.deadline_s, err.value.elapsed_s))
            token = res.push_faults(res.FaultPlan(res.FaultSpec("serve.batch", times=1)))
            try:
                got.append(res.execute_with_policy(res.ServicePolicy(max_retries=1,
                                                                     backoff_s=0.0),
                                                   lambda: "served", sleep=lambda _: None))
            finally:
                res.pop_faults(token)
        seen[name] = (got, [(e.name, e.fields) for e in trace])
    assert seen["port"] == seen["reference"]
    assert [n for n, _ in seen["port"][1]] == ["serve.shed", "resilience.retry",
                                               "resilience.fault", "resilience.retry"]


@pytest.mark.parametrize("kwargs", [dict(deadline_s=0), dict(max_retries=-1),
                                    dict(backoff_s=-0.1), dict(backoff_jitter=-1),
                                    dict(max_queue=0)])
def test_policy_validation_matches_the_reference(kwargs):
    with pytest.raises(ValueError) as port:
        policies.ServicePolicy(**kwargs)
    with pytest.raises(ValueError) as ref:
        jres.ServicePolicy(**kwargs)
    assert str(port.value) == str(ref.value)


def test_never_retried_answers():
    calls = []

    def shed():
        calls.append(1)
        raise resilience.Overloaded(10, 1)

    with pytest.raises(resilience.Overloaded):
        resilience.execute_with_policy(resilience.ServicePolicy(max_retries=5, backoff_s=0.0),
                                       shed, sleep=lambda _: None)
    assert len(calls) == 1


# ------------------------------ the ladder --------------------------------


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)


def _fft2(x):
    return xfft.fft2(torch.from_numpy(x))


def _assert_parity(y, x):
    np.testing.assert_allclose(y.numpy(), np.fft.fft2(x), rtol=TOL, atol=TOL)


@pytest.fixture
def torch_scope():
    """The plain schedules only, on a fresh default cache."""
    from repro_torch.plan import cache as cache_mod

    saved = cache_mod._DEFAULT
    cache_mod._DEFAULT = PlanCache()
    with xfft.config(backend="torch"):
        yield
    cache_mod._DEFAULT = saved


def _first_choice():
    variant = resolve_call("fft2d", SHAPE, CPU).variant
    reset()
    return variant


def test_acceptance_failover_quarantine_and_recovery(torch_scope):
    clock = Clock()
    configure(cooldown_s=30.0, clock=clock)
    first = _first_choice()
    x = _frame()
    plan = FaultPlan(FaultSpec("engine.apply", mode="error", match={"engine": first}, times=1))
    with obs.capture() as trace, xfft.config(faults=plan):
        _assert_parity(_fft2(x), x)
        _assert_parity(_fft2(x), x)
        clock.now += 31.0
        _assert_parity(_fft2(x), x)
    (fault,) = trace.select("resilience.fault")
    assert fault["seam"] == "engine.apply"
    (failover,) = trace.select("resilience.failover")
    assert failover["engine"] == first and failover["quarantined"] is True
    assert failover["reason"] == "error" and failover["kind"] == "fft2d"
    assert tuple(failover["shape"]) == SHAPE
    assert failover["next"] is not None and failover["next"] != first
    assert "InjectedFault" in failover["error"]
    assert [e["outcome"] for e in trace.select("plan.resolve")][1:] == ["quarantined", "hit"]
    assert [e["state"] for e in trace.select("resilience.breaker")] == [
        "open", "half_open", "closed"]
    applied = [(e["engine"], e["ok"]) for e in trace.select("engine.apply")]
    assert applied == [(failover["next"], True), (failover["next"], True), (first, True)]


def test_failed_engine_never_cached_as_fallback(torch_scope):
    clock = Clock()
    configure(cooldown_s=30.0, clock=clock)
    first = _first_choice()
    x = _frame()
    plan = FaultPlan(FaultSpec("engine.apply", mode="error", match={"engine": first}, times=1))
    with xfft.config(faults=plan):
        _fft2(x)
        clock.now += 31.0
        _fft2(x)
    assert resolve_call("fft2d", SHAPE, CPU).variant == first


def test_forced_variant_bypasses_ladder_with_the_reference_span():
    x = _frame()
    plan = FaultPlan(FaultSpec("engine.apply", mode="error"))
    with obs.capture() as trace, xfft.config(variant="stockham", faults=plan):
        _assert_parity(_fft2(x), x)
    assert trace.select("resilience.fault") == [] and trace.select("resilience.failover") == []
    (span,) = trace.select("engine.apply")
    key = jplan.ProblemKey(kind="fft2d", backend="cpu", device_kind="cpu", shape=SHAPE,
                           dtype="complex64")
    with jobs.capture() as jtrace:
        jladder.run_plan(jplan.FFTPlan(key=key, variant="stockham", mode="forced"), lambda v: v)
    (ref,) = jtrace.select("engine.apply")
    assert list(span.fields) == list(ref.fields)
    assert {**_fields(span), "backend": None} == {**_fields(ref), "backend": None}
    assert (span["backend"], ref["backend"]) == ("torch", "jnp")


def test_check_health_nan_fails_over(torch_scope):
    first = _first_choice()
    x = _frame()
    plan = FaultPlan(FaultSpec("engine.apply", mode="nan", match={"engine": first}, times=1))
    with obs.capture() as trace, xfft.config(faults=plan, check_health="nan"):
        y = _fft2(x)
    assert bool(torch.isfinite(y).all())
    _assert_parity(y, x)
    (failover,) = trace.select("resilience.failover")
    assert failover["engine"] == first and failover["reason"] == "nonfinite"
    assert failover["error"] is None


def test_health_guard_off_by_default(torch_scope):
    first = _first_choice()
    x = _frame()
    plan = FaultPlan(FaultSpec("engine.apply", mode="nan", match={"engine": first}, times=1))
    with obs.capture() as trace, xfft.config(faults=plan):
        y = _fft2(x)
    assert not bool(torch.isfinite(y).all())
    assert trace.select("resilience.failover") == []


def test_health_guard_reads_a_cpu_tensor_and_skips_what_it_cannot_read(monkeypatch):
    """On a CPU tensor the guard still reads the values: a NaN or an inf is
    unhealthy. While a CUDA graph is captured or torch.compiler traces the
    call (``plan.api._trace_safe`` false) it reads nothing and counts the
    output healthy, as the reference counts a tracer; a payload that is
    not a tensor is healthy too."""
    from repro_torch.plan import api

    bad = torch.tensor([1.0, float("nan")])
    assert not ladder._is_finite(bad)
    assert not ladder._is_finite(torch.tensor([1.0, float("inf")], dtype=torch.complex64))
    assert ladder._is_finite(torch.ones(3)) and ladder._is_finite(np.array([np.nan]))
    monkeypatch.setattr(api, "_trace_safe", lambda: False)
    assert ladder._is_finite(bad)
    monkeypatch.undo()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert ladder._is_finite(bad)


def test_all_rungs_nonfinite_returns_last_output(torch_scope):
    x = _frame()
    with obs.capture() as trace, xfft.config(faults=FaultPlan(FaultSpec("engine.apply",
                                                                        mode="inf")),
                                             check_health="nan"):
        y = _fft2(x)
    assert not bool(torch.isfinite(y).all())
    failovers = trace.select("resilience.failover")
    assert len(failovers) >= 2 and failovers[-1]["next"] is None


def test_all_rungs_error_raises_last_error(torch_scope):
    with obs.capture() as trace, xfft.config(faults=FaultPlan(FaultSpec("engine.apply"))):
        with pytest.raises(InjectedFault):
            _fft2(_frame())
    failovers = trace.select("resilience.failover")
    assert failovers[-1]["next"] is None
    # Every plain schedule was a rung, the reliable stockham among them.
    assert sorted(f["engine"] for f in failovers) == ["looped", "radix4", "stockham"]


def test_variant_candidates_exclude_quarantined_and_bottom_out_at_reliable():
    key = ProblemKey(kind="fft2d", backend="cpu", device_kind="cpu", shape=SHAPE,
                     dtype="complex64", backends=("torch",))
    baseline = variant_candidates(key)
    quarantine().record_failure(baseline[0], key)
    assert set(variant_candidates(key)) == set(baseline) - {baseline[0]}
    for name in baseline:
        quarantine().record_failure(name, key)
    assert variant_candidates(key) == ("stockham",)


def test_the_ladder_raises_what_the_runner_raises_with_no_rung_left():
    key = ProblemKey(kind="fft1d", backend="cpu", device_kind="cpu", shape=(4, 16),
                     dtype="complex64", backends=("torch",))
    rungs, tried = variant_candidates(key), []

    def runner(v):
        tried.append(v)
        raise RuntimeError(f"launch refused by {v}")

    with pytest.raises(RuntimeError, match="launch refused by"):
        ladder.run_plan(FFTPlan(key=key, variant="radix4"), runner)
    assert tried[0] == "radix4" and sorted(tried) == sorted(rungs)
    assert variant_candidates(key) == ("stockham",)  # all benched: the reliable rung


# ----------------- the divergence: kernels-only rungs on a CUDA key -----------------


def _cuda_key(**kw):
    fields = dict(kind="fft2d", backend="cuda", device_kind=H100, shape=(512, 128, 128),
                  dtype="complex64")
    return ProblemKey(**{**fields, **kw})


@pytest.mark.parametrize("kind,shape", [("fft2d", (512, 128, 128)), ("rfft2d", (32, 512, 512)),
                                        ("fft1d", (64, 2 ** 18)), ("rfft1d", (256, 2 ** 16))])
def test_cuda_key_rungs_are_kernels_only(kind, shape):
    """On a CUDA key with no backend scope every rung is a hand-written
    kernel: quarantining them all brings them back, never the plain
    schedules; the ladder walks fused_r4, then fused, then raises the
    last error. The reference would bottom out at its jnp engines."""
    key = _cuda_key(kind=kind, shape=shape, dtype="float32" if kind.startswith("r") else
                    "complex64")
    assert set(variant_candidates(key)) == {"fused", "fused_r4"}
    tried = []

    def runner(v):
        tried.append(v)
        raise RuntimeError(f"CUDA error at launch of {v}")

    with obs.capture() as trace, pytest.raises(RuntimeError, match="CUDA error at launch of fused"):
        ladder.run_plan(FFTPlan(key=key, variant="fused_r4"), runner)
    assert tried == ["fused_r4", "fused"]
    assert [(e["engine"], e["next"]) for e in trace.select("resilience.failover")] == [
        ("fused_r4", "fused"), ("fused", None)]
    assert set(variant_candidates(key)) == {"fused", "fused_r4"}  # both benched: both back


def test_cuda_key_double_rung_is_reference_x64_and_a_torch_scope_widens():
    double = _cuda_key(precision="double")
    assert variant_candidates(double) == ("reference_x64",)
    tried = []

    def runner(v):
        tried.append(v)
        raise RuntimeError(f"{v} failed")

    with pytest.raises(RuntimeError, match="reference_x64 failed"):
        ladder.run_plan(FFTPlan(key=double, variant="reference_x64"), runner)
    assert tried == ["reference_x64"]
    scoped = _cuda_key(backends=("torch",))
    assert set(variant_candidates(scoped)) == {"looped", "stockham", "radix4"}


# ----------------------------- the census seam ------------------------------


@pytest.mark.parametrize("name,kind,real", [("fft2_kernel", "fft2d", False),
                                            ("rfft2_kernel", "rfft2d", True),
                                            ("irfft2_kernel", "irfft2d", True)])
def test_census_seam_takes_the_composed_route(name, kind, real):
    """A vmem fault at ``kernel.fused`` on a frame that fits one block runs
    the composed route (rows, then the column pass: here the kernels'
    plain versions on CPU tensors), emits ``kernel.failover`` with the
    reference's fields, and gives the one-block route's result (1e-5 of
    the largest value)."""
    rng = np.random.default_rng(3)
    if kind == "irfft2d":
        x = torch.from_numpy(np.fft.rfft2(rng.standard_normal((2, 16, 16))).astype(np.complex64))
    elif real:
        x = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32))
    else:
        x = torch.from_numpy(_frame().reshape(1, 8, 8).repeat(2, 0))
    fn = getattr(ops, name)
    want = fn(x, radix=4)
    with obs.capture() as trace, xfft.config(faults=FaultPlan(FaultSpec("kernel.fused",
                                                                        mode="vmem"))):
        got = fn(x, radix=4)
    (event,) = trace.select("kernel.failover")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    h, w = 16 if real else 8, 16 if real else 8
    assert (event["kind"], event["shape"], event["frames"]) == (kind, (h, w), 2)
    assert event["working_set"] == ops.fft2_working_set(h, w, real=real)
    assert event["budget"] == ops.smem_budget_bytes()
    token = jres.push_faults(jres.FaultPlan(jres.FaultSpec("kernel.fused", mode="vmem")))
    try:
        with jobs.capture() as jtrace:
            getattr(jops, name)(x.numpy(), interpret=True)
    finally:
        jres.pop_faults(token)
    (ref,) = jtrace.select("kernel.failover")
    assert list(event.fields) == list(ref.fields)
    assert (ref["kind"], ref["shape"], ref["frames"]) == (event["kind"], event["shape"], 2)
    assert [e.fields for e in trace.select("resilience.fault")] == \
        [e.fields for e in jtrace.select("resilience.fault")]
