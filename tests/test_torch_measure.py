"""MEASURE, wisdom files, ``plan_fft`` and ``execute`` on the CPU.

The port's MEASURE times every candidate engine on the key's device
(``time.perf_counter`` on the CPU, CUDA events on the card; the card's
path is in ``tests/test_torch_kernels_cuda.py``). The engines differ from
the reference's, so winners are not compared: the structure is — the
plan's fields, the events and their fields, the degrade reasons, the
cache's fault seams and read-only degrade, ``$REPRO_PLAN_CACHE`` — each
held to ``repro.plan`` (its ``plan_fft``, ``measure_plan`` and
``PlanCache`` run on this jax) under ``repro.resilience.push_faults``.
``execute`` is held to numpy at 1e-4 of the largest value.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import resilience as jres
from repro.plan import api as japi
from repro.plan import autotune as jautotune
from repro.plan import cache as jcache
from repro.plan import plan as jplan
from repro_torch import obs, resilience, xfft
from repro_torch.plan import (
    FFTPlan,
    PlanCache,
    ProblemKey,
    default_cache,
    execute,
    measure_plan,
    plan_fft,
    reset_default_cache,
    resolve_call,
    variant_candidates,
)
from repro_torch.plan import api as api_mod
from repro_torch.plan import autotune
from repro_torch.resilience import FaultPlan, FaultSpec

CPU = torch.device("cpu")
KEY_FIELDS = dict(kind="fft2d", backend="cpu", device_kind="cpu", shape=(2, 8, 8),
                  dtype="complex64")
KEY = ProblemKey(**KEY_FIELDS)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (resilience, jres):
        mod.reset()
        mod.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_default_cache()
    api_mod._DIR_CACHES.clear()
    yield
    for mod in (resilience, jres):
        mod.reset()
    reset_default_cache()
    api_mod._DIR_CACHES.clear()


# ------------------------------ MEASURE -----------------------------------


@pytest.mark.parametrize("kind,shape,direction", [
    ("fft1d", (4, 64), "fwd"), ("fft1d", (4, 64), "inv"), ("fft2d", (2, 8, 16), "fwd"),
    ("rfft1d", (3, 32), "fwd"), ("rfft1d", (3, 32), "inv"), ("rfft2d", (2, 16, 8), "inv"),
])
def test_timings_cover_every_candidate(kind, shape, direction):
    key = ProblemKey(kind=kind, backend="cpu", device_kind="cpu", shape=shape,
                     dtype="float32" if kind.startswith("r") else "complex64",
                     direction=direction)
    timings = {}
    with obs.capture() as trace:
        plan = measure_plan(key, timings_out=timings)
    assert list(timings) == list(variant_candidates(key))
    assert all(us > 0 for us in timings.values())
    assert plan.mode == "measure" and plan.variant == min(timings, key=timings.get)
    assert plan.measured_us == timings[plan.variant] and plan.degrade_reason is None
    assert plan.est_time_s == autotune.estimate_variant_time(key, plan.variant)
    (span,) = trace.select("plan.measure")
    assert span["chosen"] == plan.variant and span["timings"] == timings
    assert span["candidates"] == len(timings) and "skipped" not in span.fields
    assert [e["engine"] for e in trace.select("plan.measure.candidate")] == list(timings)


def test_measure_input_is_the_references():
    """The same numpy draw from the same seed, moved once to the key's
    device, for every kind and direction (the reference makes a jax array)."""
    for kind, shape, direction, dtype in (("fft2d", (2, 8, 8), "fwd", "complex64"),
                                          ("rfft2d", (2, 8, 8), "inv", "float32"),
                                          ("rfft1d", (3, 16), "fwd", "float32")):
        fields = dict(kind=kind, backend="cpu", device_kind="cpu", shape=shape, dtype=dtype,
                      direction=direction)
        got = autotune._measure_input(ProblemKey(**fields))
        want = np.asarray(jautotune._measure_input(jplan.ProblemKey(**fields)))
        assert got.device == CPU
        np.testing.assert_array_equal(got.numpy(), want)


def test_zero_budget_times_out_every_candidate():
    with obs.capture() as trace:
        plan = measure_plan(KEY, budget_s=0.0)
    assert plan.mode == "estimate" and plan.degrade_reason == "measure_timeout"
    (span,) = trace.select("plan.measure")
    assert set(span["skipped"].values()) == {"timeout"} and span["chosen"] is None
    (degrade,) = trace.select("plan.degrade")
    assert degrade["reason"] == "measure_timeout"


def test_an_injected_candidate_error_is_skipped_and_recorded():
    timings = {}
    crash = FaultPlan(FaultSpec("plan.measure", mode="error", match={"engine": "stockham"}))
    with obs.capture() as trace, xfft.config(faults=crash):
        plan = measure_plan(KEY, timings_out=timings)
    assert "stockham" not in timings and plan.variant != "stockham"
    assert plan.mode == "measure"
    (span,) = trace.select("plan.measure")
    assert span["skipped"]["stockham"].startswith("error: InjectedFault")
    assert span["candidates"] == len(variant_candidates(KEY))


@pytest.mark.parametrize("spec,budget,reason", [
    (dict(seam="plan.measure", mode="latency", latency_s=0.05), 0.02, "measure_timeout"),
    (dict(seam="plan.measure", mode="error"), 5.0, "measure_failed"),
])
def test_sweep_degrades_like_the_reference(spec, budget, reason):
    seen = {}
    for name, mod, res, measure, key in (
            ("port", obs, resilience, measure_plan, KEY),
            ("reference", jobs, jres, jautotune.measure_plan, jplan.ProblemKey(**KEY_FIELDS,
                                                                              backends=("jnp",)))):
        token = res.push_faults(res.FaultPlan(res.FaultSpec(**spec)))
        try:
            with mod.capture() as trace:
                plan = measure(key, budget_s=budget)
        finally:
            res.pop_faults(token)
        (span,) = trace.select("plan.measure")
        seen[name] = (plan.mode, plan.degrade_reason, [e.fields for e in
                                                       trace.select("plan.degrade")],
                      sorted(span.fields), set(span["skipped"].values()) if reason ==
                      "measure_timeout" else None)
    assert seen["port"] == seen["reference"]
    assert seen["port"][1] == reason


def test_measure_under_quarantine_degrades_instead_of_sweeping():
    first = resolve_call("fft2d", (8, 8), CPU, cache=PlanCache()).variant
    key = ProblemKey(kind="fft2d", backend="cpu", device_kind="cpu", shape=(8, 8),
                     dtype="complex64")
    resilience.quarantine().record_failure(first, key, error="boom")
    with obs.capture() as trace, xfft.config(mode="measure"):
        plan = resolve_call("fft2d", (8, 8), CPU, cache=PlanCache())
    assert plan.mode == "estimate" and plan.degrade_reason == "engine_quarantined"
    assert plan.variant != first
    assert trace.select("plan.measure") == []
    (e,) = trace.select("plan.degrade")
    assert e["reason"] == "engine_quarantined"


def test_quarantined_cache_hit_re_resolves_and_stays_out_of_the_cache():
    cache = PlanCache()
    first = resolve_call("fft2d", (8, 8), CPU, cache=cache)
    resilience.quarantine().record_failure(first.variant, first.key, error="boom")
    with obs.capture() as trace:
        fallback = resolve_call("fft2d", (8, 8), CPU, cache=cache)
    assert fallback.variant != first.variant
    assert trace.select("plan.resolve")[0]["outcome"] == "quarantined"
    assert cache.get(first.key) == first
    resilience.reset()
    assert resolve_call("fft2d", (8, 8), CPU, cache=cache).variant == first.variant


def test_measure_upgrades_cached_estimates_but_not_timeouts(monkeypatch):
    cache = PlanCache()
    estimate = resolve_call("fft1d", (4, 32), CPU, cache=cache)
    assert estimate.mode == "estimate"
    with obs.capture() as trace, xfft.config(mode="measure"):
        measured = resolve_call("fft1d", (4, 32), CPU, cache=cache)
        again = resolve_call("fft1d", (4, 32), CPU, cache=cache)
    assert measured.mode == "measure" and again == measured
    assert [e["outcome"] for e in trace.select("plan.resolve")] == ["measured", "hit"]
    assert len(trace.select("plan.measure")) == 1
    monkeypatch.setattr(autotune, "MEASURE_CANDIDATE_BUDGET_S", 0.0)
    other = PlanCache()
    with xfft.config(mode="measure"):
        first = resolve_call("fft1d", (4, 64), CPU, cache=other)
    assert first.degrade_reason == "measure_timeout"
    with obs.capture() as trace, xfft.config(mode="measure"):
        assert resolve_call("fft1d", (4, 64), CPU, cache=other).degrade_reason == \
            "measure_timeout"
    assert trace.select("plan.measure") == []


def test_measure_degrades_under_a_forced_variant_and_for_analytic_kinds():
    with obs.capture() as trace:
        with xfft.config(mode="measure", variant="stockham"):
            forced = resolve_call("fft1d", (2, 64), CPU, cache=PlanCache())
        with xfft.config(mode="measure"):
            tile = resolve_call("oaconv2d", (96, 80, 7, 5), CPU, dtype="float32",
                                cache=PlanCache())
    assert forced.mode == "forced" and forced.degrade_reason == "forced_variant"
    assert tile.degrade_reason == "estimate_only_kind" and tile.tile is not None
    assert [e["reason"] for e in trace.select("plan.degrade")] == ["forced_variant",
                                                                   "estimate_only_kind"]
    assert trace.select("plan.measure") == []


def test_trace_not_clean_degrades(monkeypatch):
    """While a CUDA graph is captured (here: the check itself patched, as
    no card is present) MEASURE degrades and times nothing."""
    monkeypatch.setattr(api_mod, "_trace_safe", lambda: False)
    with obs.capture() as trace, xfft.config(mode="measure"):
        plan = resolve_call("fft2d", (4, 8), CPU, cache=PlanCache())
    assert plan.mode == "estimate" and plan.degrade_reason == "trace_not_clean"
    assert trace.select("plan.measure") == []
    monkeypatch.undo()
    assert api_mod._trace_safe() is True


@pytest.mark.parametrize("kind", ["fft2d_stream", "fft2d_pencil"])
def test_stream_and_pencil_measure_name_their_queue_items(kind):
    """The pencil kind (item 11) is not timed: ``measure_plan`` raises the
    reference's message (a live mesh is needed), and ``execute`` of its plan
    needs ``mesh=``; the stream (item 8) is measured at each unroll and
    executed."""
    key = ProblemKey(kind=kind, backend="cpu", device_kind="cpu", shape=(2, 8, 8),
                     dtype="complex64")
    if kind == "fft2d_pencil":
        with pytest.raises(ValueError, match="pencil problems need a live mesh"):
            measure_plan(key)
        with pytest.raises(ValueError, match="needs mesh="):
            execute(FFTPlan(key=key, variant="stockham"), torch.zeros(2, 8, 8))
        return
    timings = {}
    plan = measure_plan(key, iters=1, timings_out=timings)
    assert plan.mode == "measure" and plan.unroll in (1, 2)
    assert set(timings) == {f"{v}{s}" for v in ("looped", "stockham", "radix4")
                            for s in ("", "/unroll=2")}
    x = np.random.default_rng(8).standard_normal((2, 8, 8)).astype(np.complex64)
    got = execute(plan, torch.from_numpy(x)).numpy()
    assert np.abs(got - np.fft.fft2(x)).max() <= TOL * np.abs(np.fft.fft2(x)).max()


# ------------------------------ plan_fft ----------------------------------


def test_plan_fft_measure_matches_the_reference_in_structure(tmp_path):
    """Same key string, same plan fields, the same event sequence with the
    same fields; the winner may differ (different engines)."""
    seen = {}
    for name, mod, plan_fn, cache in (
            ("port", obs, lambda **kw: plan_fft(**kw, device=CPU, backends=("torch",)),
             PlanCache(path=str(tmp_path / "port.json"))),
            ("reference", jobs, lambda **kw: japi.plan_fft(**kw, backends=("jnp",)),
             jcache.PlanCache(path=str(tmp_path / "reference.json")))):
        timings = {}
        with mod.capture() as trace:
            plan = plan_fn(kind="fft1d", shape=(4, 64), mode="measure", cache=cache,
                           timings_out=timings)
            again = plan_fn(kind="fft1d", shape=(4, 64), mode="measure", cache=cache)
        seen[name] = plan, again, timings, trace
    (port, pagain, ptimes, ptrace), (ref, ragain, rtimes, rtrace) = seen["port"], \
        seen["reference"]
    assert port.key.cache_key().replace("betorch", "") == \
        ref.key.cache_key().replace("bejnp", "")
    assert (port.mode, port.degrade_reason, ref.mode) == ("measure", None, "measure")
    assert list(port.to_dict()) == list(ref.to_dict())
    assert port.measured_us == ptimes[port.variant] and pagain == port and ragain == ref
    assert set(ptimes) == {"looped", "stockham", "radix4"}

    def collapse(trace):
        names = []
        for e in trace:
            if not names or names[-1] != e.name:
                names.append(e.name)
        return names

    assert collapse(ptrace) == collapse(rtrace) == [
        "plan.measure.candidate", "plan.measure", "plan.cache.save", "plan.resolve"]
    for pname in ("plan.measure.candidate", "plan.measure", "plan.cache.save", "plan.resolve"):
        assert list(ptrace.select(pname)[0].fields) == list(rtrace.select(pname)[0].fields)
    assert [e["outcome"] for e in ptrace.select("plan.resolve")] == \
        [e["outcome"] for e in rtrace.select("plan.resolve")] == ["measured", "hit"]


def test_plan_fft_on_a_file_leaves_a_second_process_nothing_to_time(tmp_path):
    path = str(tmp_path / "xfft_plans.json")
    keys = [("fft2d", (2, 8, 8), "fwd"), ("fft2d", (2, 8, 8), "inv"), ("rfft1d", (4, 32), "fwd")]
    for kind, shape, direction in keys:
        plan_fft(kind, shape, CPU, dtype="float32" if kind.startswith("r") else "complex64",
                 mode="measure", cache=PlanCache(path=path), direction=direction)
    fresh = PlanCache(path=path)
    with obs.capture() as trace:
        for kind, shape, direction in keys:
            plan_fft(kind, shape, CPU, dtype="float32" if kind.startswith("r") else "complex64",
                     mode="measure", cache=fresh, direction=direction)
    assert [e["outcome"] for e in trace.select("plan.resolve")] == ["hit"] * 3
    assert trace.select("plan.measure") == [] and trace.select("plan.cache.save") == []
    # The wisdom file loads in the reference too: the formats are one.
    ref = jcache.PlanCache(path=path)
    assert len(ref) == 3 and all(p.mode == "measure" for _, p in ref.entries())


def test_plan_fft_force_re_times_and_estimate_only_kinds_degrade():
    cache = PlanCache()
    first = plan_fft("fft1d", (2, 32), CPU, mode="measure", cache=cache)
    with obs.capture() as trace:
        again = plan_fft("fft1d", (2, 32), CPU, mode="measure", cache=cache, force=True)
        tile = plan_fft("oaconv2d", (64, 64, 5, 5), CPU, dtype="float32", mode="measure",
                        cache=cache)
    assert first.mode == again.mode == "measure" and len(trace.select("plan.measure")) == 1
    assert tile.degrade_reason == "estimate_only_kind"
    with pytest.raises(ValueError, match="mode must be"):
        plan_fft("fft1d", (2, 32), CPU, mode="patient")


def test_config_cache_dir_selects_one_wisdom_file(tmp_path):
    with xfft.config(mode="measure", cache_dir=str(tmp_path)):
        plan = resolve_call("fft1d", (4, 16), CPU)
        assert resolve_call("fft1d", (4, 16), CPU) == plan
        with xfft.config(cache_dir=""):
            assert xfft.get_config().cache_dir is None
    path = tmp_path / "xfft_plans.json"
    payload = json.loads(path.read_text())
    assert list(payload["plans"]) == [plan.key.cache_key()]
    assert api_mod._cache_for_dir(str(tmp_path)).path == str(path)


# ------------------------------ execute -----------------------------------


def test_execute_runs_the_plan_through_the_ladder():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 8, 16)) + 1j * rng.standard_normal((2, 8, 16))).astype(
        np.complex64)
    plan = plan_fft("fft2d", x.shape, CPU, cache=PlanCache())
    inv = plan_fft("fft2d", x.shape, CPU, cache=PlanCache(), direction="inv")
    with obs.capture() as trace:
        y = execute(plan, torch.from_numpy(x))
        back = execute(inv, y)
    np.testing.assert_allclose(y.numpy(), np.fft.fft2(x), atol=TOL * np.abs(np.fft.fft2(x)).max())
    np.testing.assert_allclose(back.numpy(), x, atol=TOL * np.abs(x).max())
    assert [e["engine"] for e in trace.select("engine.apply")] == [plan.variant, inv.variant]
    fault = FaultPlan(FaultSpec("engine.apply", match={"engine": plan.variant}, times=1))
    with obs.capture() as trace, xfft.config(faults=fault):
        again = execute(plan, torch.from_numpy(x))
    np.testing.assert_allclose(again.numpy(), y.numpy(), atol=TOL * np.abs(y.numpy()).max())
    (failover,) = trace.select("resilience.failover")
    assert failover["engine"] == plan.variant and failover["next"] != plan.variant


def test_execute_oaconv2d_runs_the_plans_tile():
    from repro_torch.imaging.tiled import oaconvolve2

    rng = np.random.default_rng(6)
    image = torch.from_numpy(rng.standard_normal((40, 48)).astype(np.float32))
    kernel = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    plan = plan_fft("oaconv2d", (40, 48, 5, 7), CPU, dtype="float32", cache=PlanCache())
    got = execute(plan, (image, kernel))
    want = oaconvolve2(image, kernel, tile=plan.tile)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="image, kernel"):
        execute(plan, image)


# ------------------------------ the cache ---------------------------------


def _populate(cache_mod_cache, plan_fn):
    plan_fn(kind="fft2d", shape=(8, 8), cache=cache_mod_cache)
    plan_fn(kind="fft1d", shape=(64,), cache=cache_mod_cache)
    return cache_mod_cache


_BOTH = [("port", obs, resilience, PlanCache,
          lambda **kw: plan_fft(**kw, device=CPU)),
         ("reference", jobs, jres, jcache.PlanCache, japi.plan_fft)]


def _readonly_fields(trace):
    return [{k: v for k, v in e.fields.items() if k not in ("path", "error")}
            for e in trace.select("plan.cache.readonly")]


def test_injected_save_fault_degrades_like_the_reference(tmp_path):
    seen = {}
    for name, mod, res, cache_cls, plan_fn in _BOTH:
        path = str(tmp_path / f"{name}.json")
        cache = _populate(cache_cls(), plan_fn)
        cache.path = path
        mod.reset_counters()
        token = res.push_faults(res.FaultPlan(res.FaultSpec("plan.cache.save", times=1)))
        try:
            with mod.capture() as trace:
                out = cache.save()
        finally:
            res.pop_faults(token)
        seen[name] = (out, cache.path, cache.readonly_path == path, os.path.exists(path),
                      _readonly_fields(trace), [e.name for e in trace],
                      mod.counters().get("plan.cache.readonly"))
    assert seen["port"] == seen["reference"]
    assert seen["port"][:4] == (None, None, True, False)


def test_unwritable_path_degrades_like_the_reference(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where a directory must go")
    seen = {}
    for name, mod, res, cache_cls, plan_fn in _BOTH:
        path = str(blocker / name / "wisdom.json")
        cache = _populate(cache_cls(), plan_fn)
        cache.path = path
        with mod.capture() as trace:
            out = cache.save()
        seen[name] = (out, cache.path, cache.readonly_path == path, _readonly_fields(trace))
    assert seen["port"] == seen["reference"]
    assert seen["port"][3] == [{"entries": 2}]
    assert resolve_call("fft2d", (8, 8), CPU) is not None


def test_injected_load_fault_accounts_as_file_error_like_the_reference(tmp_path):
    seen = {}
    for name, mod, res, cache_cls, plan_fn in _BOTH:
        path = str(tmp_path / f"{name}.json")
        _populate(cache_cls(), plan_fn).save(path)
        cache = cache_cls()
        token = res.push_faults(res.FaultPlan(res.FaultSpec("plan.cache.load", times=1)))
        try:
            first = cache.load(path)
        finally:
            res.pop_faults(token)
        second = cache.load(path)
        seen[name] = (first.kept, first.file_error.split(" (")[0], second.kept,
                      second.file_error)
    assert seen["port"] == seen["reference"]
    assert seen["port"][0] == 0 and seen["port"][1] == "injected fault at plan.cache.load"
    assert seen["port"][2] == 2


@pytest.mark.parametrize("measured_only,exclude", [(False, ()), (True, ()), (False, (0,)),
                                                   (True, (1,))])
def test_save_filters_like_the_reference(tmp_path, measured_only, exclude):
    written = {}
    for name, _, _, cache_cls, plan_fn in _BOTH:
        cache = cache_cls()
        plan_fn(kind="fft1d", shape=(4, 32), cache=cache, mode="measure",
                **({"backends": ("torch",)} if name == "port" else {"backends": ("jnp",)}))
        plan_fn(kind="fft1d", shape=(2, 16), cache=cache)
        plan_fn(kind="fft2d", shape=(2, 8, 8), cache=cache, mode="measure",
                **({"backends": ("torch",)} if name == "port" else {"backends": ("jnp",)}))
        keys = [k for k, _ in cache.entries()]
        path = str(tmp_path / f"{name}.json")
        cache.save(path, measured_only=measured_only, exclude=tuple(keys[i] for i in exclude))
        saved = json.loads(open(path).read())["plans"]
        written[name] = sorted((k.replace("betorch", "be").replace("bejnp", "be"), p["mode"])
                               for k, p in saved.items())
    assert written["port"] == written["reference"]


def test_env_var_backs_the_default_cache_and_attaches_like_the_reference(tmp_path,
                                                                         monkeypatch):
    path = str(tmp_path / "wisdom.json")
    plan_fft("fft1d", (2, 16), CPU, cache=PlanCache(path=path))
    monkeypatch.setenv("REPRO_PLAN_CACHE", path)
    seen = {}
    for name, mod, reset_fn, default in (("port", obs, reset_default_cache, default_cache),
                                         ("reference", jobs, jcache.reset_default_cache,
                                          jcache.default_cache)):
        reset_fn()
        try:
            with mod.capture() as trace:
                cache = default()
                assert default() is cache  # read once a process
            seen[name] = (cache.path, len(cache), [(e.name, e.fields) for e in trace])
        finally:
            reset_fn()
    assert seen["port"] == seen["reference"]
    assert seen["port"][2][-1] == ("plan.cache.attached",
                                   {"path": path, "entries": 1, "source": "REPRO_PLAN_CACHE"})
    monkeypatch.delenv("REPRO_PLAN_CACHE")
    with obs.capture() as trace:
        assert default_cache().path is None
    assert trace.select("plan.cache.attached")[0]["source"] == "memory"
