"""repro_torch.obs against repro.obs, which imports (it is pure Python).

The same calls on both packages give the same event names, fields,
counters, histogram cells and exports; capture scopes nest, sinks add and
remove, and the flight recorder keeps its ring bound and dumps on its
triggers. The port's planner emits ``plan.resolve`` / ``plan.degrade`` and
its plan cache ``plan.cache.save`` / ``plan.cache.load`` with the
reference's fields, held against the reference's ``plan_fft`` and
``PlanCache`` (which run on this jax). Comparisons are exact: obs does no
arithmetic beyond timing, which is left out.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro import obs as jobs
from repro.obs import telemetry as jtelemetry
from repro.plan import api as japi
from repro.plan import cache as jcache
from repro_torch import obs, xfft
from repro_torch.obs import export, telemetry
from repro_torch.plan import PlanCache, resolve_call

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
BOTH = pytest.mark.parametrize("mod", [jobs, obs], ids=["reference", "port"])


def _fields(event):
    return {k: v for k, v in event.fields.items() if k != "duration_us"}


def _script(mod):
    """One scripted session of every record primitive; returns what it saw."""
    mod.reset_counters()
    with mod.capture() as outer:
        mod.emit("unit.a", x=1, y="two")
        with mod.capture() as inner:
            with mod.span("unit.span", kind="fft2d") as extra:
                extra["chosen"] = "fused_r4"
            mod.emit("unit.b", shape=(4, 64, 64))
        mod.emit("unit.a", x=3)
    assert mod.emit("unit.outside") is None          # no scope: counted only
    with mod.span("unit.quiet"):
        pass
    seen = {
        "outer": [(e.name, _fields(e)) for e in outer],
        "inner": [(e.name, _fields(e)) for e in inner],
        "select": [e["x"] for e in outer.select("unit.a")],
        "glob": [e.name for e in outer.select("unit.*")],
        "first": outer.first("unit.b").fields,
        "counts": outer.counts(),
        "summary": inner.summary().splitlines()[0],
        "span_us": isinstance(outer.first("unit.span")["duration_us"], float),
    }
    seen["counters"] = {k: v for k, v in mod.counters().items() if k.startswith("unit.")}
    return seen


def test_record_primitives_match_the_reference():
    assert _script(obs) == _script(jobs)


@BOTH
def test_capture_nests_and_restores(mod):
    assert not mod.enabled()
    with mod.capture() as a:
        with mod.capture() as b:
            mod.emit("unit.nest")
        assert mod.enabled()
    assert not mod.enabled()
    assert [e.name for e in a] == [e.name for e in b] == ["unit.nest"]


@BOTH
def test_profile_scope_and_observe_tokens(mod):
    with mod.capture(profile=True):
        assert mod.profiling()
        with mod.span("unit.profiled"):      # a torch.profiler range in the port
            pass
    assert not mod.profiling()
    trace = mod.Trace()
    tokens = mod.push_observe(trace)
    mod.emit("unit.observed")
    mod.pop_observe(tokens)
    mod.emit("unit.after")
    assert [e.name for e in trace] == ["unit.observed"]
    with mod.capture() as outer:
        tokens = mod.push_observe(False)
        mod.emit("unit.silenced")
        mod.pop_observe(tokens)
    assert len(outer) == 0


def test_profiled_span_lands_in_a_torch_profile():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.capture(profile=True):
            with obs.span("unit.ranged"):
                torch.ones(4).sum()
    assert "unit.ranged" in {e.key for e in prof.key_averages()}


@BOTH
def test_sinks_add_remove_and_errors_are_counted(mod):
    got = []

    def bad(event):
        raise RuntimeError("sink failure")

    mod.add_sink(got.append)
    mod.add_sink(got.append)                 # idempotent
    mod.add_sink(bad)
    before = mod.counters().get("obs.sink.error", 0)
    try:
        assert mod.emit("unit.sunk", v=1) is None
    finally:
        mod.remove_sink(got.append)
        mod.remove_sink(bad)
    mod.emit("unit.unsunk")
    assert [e.name for e in got] == ["unit.sunk"]
    assert mod.counters()["obs.sink.error"] == before + 1


@BOTH
def test_threads_do_not_observe_each_other(mod):
    seen = {}

    def worker(tag):
        with mod.capture() as t:
            mod.emit("unit.thread", tag=tag)
        seen[tag] = [e["tag"] for e in t]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert seen == {i: [i] for i in range(4)}


# ------------------------------ histograms ------------------------------


SAMPLES_US = [0.5, 1.0, 1.19, 3.7, 12.0, 12.0, 250.0, 999.9, 4096.0, 1e7, 1e12]


def _hist(mod, samples, **geometry):
    h = mod.LatencyHistogram(**geometry)
    for us in samples:
        h.record(us)
    return h


@pytest.mark.parametrize("geometry", [{}, {"min_us": 10.0, "growth": 2.0, "buckets": 16}])
def test_histogram_buckets_match_the_reference(geometry):
    ref, port = _hist(jobs, SAMPLES_US, **geometry), _hist(obs, SAMPLES_US, **geometry)
    assert port.cells() == ref.cells()
    assert [port.bucket_index(u) for u in SAMPLES_US] == [ref.bucket_index(u) for u in SAMPLES_US]
    assert [port.percentile(p) for p in (0, 50, 95, 99, 100)] == \
        [ref.percentile(p) for p in (0, 50, 95, 99, 100)]
    assert port.to_dict() == ref.to_dict()
    ref.merge(_hist(jobs, SAMPLES_US[:3], **geometry))
    port.merge(_hist(obs, SAMPLES_US[:3], **geometry))
    assert port.cells() == ref.cells() and port.count == ref.count


@BOTH
def test_histogram_geometry_and_registry(mod):
    with pytest.raises(ValueError, match="geometry"):
        mod.LatencyHistogram(growth=1.0)
    with pytest.raises(ValueError, match="different geometry"):
        mod.LatencyHistogram().merge(mod.LatencyHistogram(buckets=8))
    mod.reset_histograms()
    assert mod.histogram("unit.lane") is mod.histogram("unit.lane", buckets=8)
    assert list(mod.histograms("unit.")) == ["unit.lane"]
    mod.reset_histograms()
    assert mod.histograms() == {}


# ------------------------------- exports -------------------------------


def _events(mod):
    return [
        mod.Event(name="unit.span", t=2.0, fields={"duration_us": 500.0, "k": (1, 2)}, tid=7),
        mod.Event(name="unit.mark", t=3.0, fields={"obj": complex(1, 2), "n": None}, tid=7),
    ]


def test_exports_match_the_reference(tmp_path):
    from repro.obs import export as jexport

    ref, port = _events(jobs), _events(obs)
    assert [export.event_dict(e) for e in port] == [jexport.event_dict(e) for e in ref]
    assert export.chrome_trace(port, {7: "w"}, pid=1) == jexport.chrome_trace(ref, {7: "w"}, pid=1)
    hists = {"lane": _hist(obs, SAMPLES_US)}
    jhists = {"lane": _hist(jobs, SAMPLES_US)}
    counters, gauges = {"a.b": 3, 'q"x': 1}, {"depth": 2.5}
    assert export.prometheus_text(counters, gauges, hists) == \
        jexport.prometheus_text(counters, gauges, jhists)
    assert export.prometheus_text() == ""
    path = export.write_jsonl(port, str(tmp_path / "port.jsonl"))
    jpath = jexport.write_jsonl(ref, str(tmp_path / "ref.jsonl"))
    assert Path(path).read_text() == Path(jpath).read_text()


# ---------------------------- flight recorder ----------------------------


@pytest.fixture(params=["reference", "port"])
def recorder(request, tmp_path):
    """A small fresh recorder of either package, the previous one restored."""
    mod, tel = (jobs, jtelemetry) if request.param == "reference" else (obs, telemetry)
    rec = tel.FlightRecorder(capacity=64, dump_dir=str(tmp_path / "flight"))
    prev = tel.set_flight_recorder(rec)
    yield mod, rec
    tel.set_flight_recorder(prev)


def test_default_recorder_and_ledger_installed_at_import():
    rec = obs.flight_recorder()
    assert rec is not None
    before = rec.stats()["recorded_total"]
    assert obs.emit("unit.noscope") is None
    assert rec.stats()["recorded_total"] == before + 1
    assert isinstance(obs.calibration_ledger(), telemetry.CalibrationLedger)


def test_ring_is_bounded_and_keeps_most_recent(recorder):
    mod, rec = recorder
    for i in range(200):
        mod.emit("unit.flood", i=i)
    assert [e["i"] for e in rec.events()] == list(range(136, 200))
    assert rec.stats()["recorded_total"] == 200 and rec.stats()["retained"] == 64


def test_trigger_dumps_jsonl_with_trigger_event_last(recorder):
    mod, rec = recorder
    for i in range(10):
        mod.emit("unit.lead", i=i)
    mod.emit("resilience.breaker", state="half_open", engine="e")   # recovery: no dump
    assert rec.stats()["dumps"] == []
    mod.emit("serve.lane.error", service="spectrum", lane="x", error="boom")
    (dump,) = rec.stats()["dumps"]
    assert dump["trigger"] == "serve.lane.error"
    lines = [json.loads(line) for line in open(dump["path"])]
    assert Path(dump["path"]).name == "flight-0001-serve_lane_error.jsonl"
    assert lines[-1]["name"] == "serve.lane.error" and lines[-1]["fields"]["error"] == "boom"
    assert [ln["name"] for ln in lines[-12:-2]] == ["unit.lead"] * 10
    mod.emit("resilience.breaker", state="open", engine="e")
    assert [d["trigger"] for d in rec.stats()["dumps"]] == ["serve.lane.error",
                                                            "resilience.breaker"]


def test_dump_cap_counts_drops_the_same_way(tmp_path):
    stats = {}
    for name, mod, tel in (("reference", jobs, jtelemetry), ("port", obs, telemetry)):
        rec = tel.FlightRecorder(capacity=8, dump_dir=str(tmp_path / name), max_dumps=2)
        prev = tel.set_flight_recorder(rec)
        try:
            for _ in range(5):
                mod.emit("serve.shed", lane="x")
        finally:
            tel.set_flight_recorder(prev)
        got = rec.stats()
        stats[name] = (len(got["dumps"]), got["dropped_dumps"],
                       sorted(p.name for p in (tmp_path / name).iterdir()))
    assert stats["port"] == stats["reference"] == (
        2, 3, ["flight-0001-serve_shed.jsonl", "flight-0002-serve_shed.jsonl"])


def test_environment_sets_capacity_and_turns_the_recorder_off(monkeypatch):
    prev = telemetry.set_flight_recorder(None)
    try:
        monkeypatch.setenv("REPRO_FLIGHT_CAPACITY", "17")
        telemetry.install_default()
        assert obs.flight_recorder().capacity == 17
        telemetry.set_flight_recorder(None)
        monkeypatch.setenv("REPRO_FLIGHT_RECORDER", "0")
        telemetry.install_default()
        assert obs.flight_recorder() is None
    finally:
        telemetry.set_flight_recorder(prev)


_DUMP_DEFAULT = (
    "import os, sys; sys.path.insert(0, {src!r}); from {pkg} import obs; "
    "rec = obs.flight_recorder(); obs.emit('serve.shed', lane='x'); "
    "print(rec.stats()['dumps'][0]['path']); print(os.getpid())"
)


def test_reference_and_port_processes_dump_into_their_own_directories(tmp_path):
    """The default dump directory is scoped by the process id, so a
    reference process and a port process never dump into each other's."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_FLIGHT")}
    env["TMPDIR"] = str(tmp_path)
    dirs = {}
    for pkg in ("repro", "repro_torch"):
        out = subprocess.run(
            [sys.executable, "-c", _DUMP_DEFAULT.format(src=str(ROOT / "src"), pkg=pkg)],
            capture_output=True, text=True, env=env, timeout=300, check=True)
        path, pid = out.stdout.split()
        assert Path(path).parent == tmp_path / f"repro-flight-{pid}"
        dirs[pkg] = Path(path).parent
    assert dirs["repro"] != dirs["repro_torch"]
    assert [p.name for p in dirs["repro_torch"].iterdir()] == ["flight-0001-serve_shed.jsonl"]


# --------------------------- calibration ledger ---------------------------


def _ledger_stream(mod):
    key = {"kind": "fft2d", "shape": (8, 64, 64), "precision": "single"}
    return [
        mod.Event("plan.resolve", 0.0, {**key, "variant": "fused_r4", "est_time_s": 20e-6}),
        mod.Event("plan.measure.candidate", 0.0, {**key, "engine": "stockham",
                                                  "median_us": 90.0}),
        mod.Event("engine.apply", 0.0, {**key, "engine": "fused_r4", "ok": True,
                                        "duration_us": 40.0}),
        mod.Event("engine.apply", 0.0, {**key, "engine": "fused_r4", "ok": False,
                                        "duration_us": 9000.0}),
    ]


def test_calibration_ledger_matches_the_reference():
    ref, port = jtelemetry.CalibrationLedger(), telemetry.CalibrationLedger()
    for e in _ledger_stream(jobs):
        ref.record(e)
    for e in _ledger_stream(obs):
        port.record(e)
    assert port.table() == ref.table()
    top = port.table()[0]              # the failed dispatch is not observed
    assert (top["engine"], top["observed_n"], top["predicted_source"]) == ("fused_r4", 1,
                                                                             "estimate")


def test_port_planner_feeds_the_ledger():
    ledger = telemetry.CalibrationLedger()
    prev = telemetry.set_calibration_ledger(ledger)
    try:
        plan = resolve_call("fft2d", (2, 32, 32), CPU, cache=PlanCache())
    finally:
        telemetry.set_calibration_ledger(prev)
    (row,) = ledger.table()
    assert (row["engine"], row["shape"]) == (plan.variant, [2, 32, 32])
    assert row["predicted_us"] == round(plan.est_time_s * 1e6, 2)


# ------------------------- planner instrumentation -------------------------


_SAME_VALUE = ("kind", "shape", "dtype", "direction", "precision", "backend", "mode",
               "plan_mode", "measured_us", "degrade_reason", "cache_path", "key")


def test_plan_resolve_event_matches_the_reference():
    obs.reset_counters()
    with obs.capture() as trace:
        resolve_call("fft2d", (4, 64, 64), CPU, cache=(cache := PlanCache()))
        resolve_call("fft2d", (4, 64, 64), CPU, cache=cache)
        with xfft.config(variant="looped"):
            resolve_call("fft2d", (4, 64, 64), CPU, cache=cache)
    with jobs.capture() as jtrace:
        japi.plan_fft("fft2d", (4, 64, 64), cache=jcache.PlanCache())
    port, (ref,) = trace.select("plan.resolve"), jtrace.select("plan.resolve")
    assert [e["outcome"] for e in port] == ["miss", "hit", "forced"]
    assert all(list(e.fields) == list(ref.fields) for e in port)
    assert {k: port[0][k] for k in _SAME_VALUE} == {k: ref[k] for k in _SAME_VALUE}
    assert port[0]["entry"] == "resolve_call" and port[2]["variant"] == "looped"
    assert port[2]["plan_mode"] == "forced"
    assert {k: v for k, v in obs.counters().items() if k.startswith("plan.resolve.")} == \
        {"plan.resolve.forced": 1, "plan.resolve.hit": 1, "plan.resolve.miss": 1}


def test_plan_degrade_event_matches_the_reference():
    obs.reset_counters()
    key = (96, 80, 7, 5)
    with obs.capture() as trace:
        plan = resolve_call("oaconv2d", key, CPU, dtype="float32", cache=PlanCache(),
                            mode="measure")
        with xfft.config(variant="stockham"):
            resolve_call("fft1d", (2, 64), CPU, cache=PlanCache(), mode="measure")
    with jobs.capture() as jtrace:
        japi.plan_fft("oaconv2d", key, dtype="float32", cache=jcache.PlanCache(),
                      mode="measure")
    degrades = trace.select("plan.degrade")
    (jdegrade,) = jtrace.select("plan.degrade")
    assert degrades[0].fields == jdegrade.fields
    assert [e["reason"] for e in degrades] == ["estimate_only_kind", "forced_variant"]
    assert plan.degrade_reason == "estimate_only_kind" and plan.tile is not None
    assert trace.select("plan.resolve")[0]["mode"] == "measure"
    assert obs.counters()["plan.degrade.estimate_only_kind"] == 1
    assert obs.counters()["plan.degrade.forced_variant"] == 1


def test_plan_cache_events_match_the_reference(tmp_path):
    events, counters = {}, {}
    for name, mod, cache_mod in (("reference", jobs, jcache), ("port", obs, None)):
        mod.reset_counters()
        cache = jcache.PlanCache() if cache_mod else PlanCache()
        if cache_mod:
            japi.plan_fft("fft1d", (2, 8), cache=cache)
        else:
            resolve_call("fft1d", (2, 8), CPU, cache=cache)
        path = tmp_path / f"{name}.json"
        with mod.capture() as trace:
            cache.save(str(path))
            payload = json.loads(path.read_text())
            payload["plans"]["v4|stale"] = {}
            payload["plans"]["v5|broken"] = {"key": {}}
            path.write_text(json.dumps(payload))
            fresh = jcache.PlanCache() if cache_mod else PlanCache()
            fresh.load(str(path))
            fresh.load(str(tmp_path / "missing.json"))
        events[name] = [(e.name, {k: v for k, v in e.fields.items() if k != "path"})
                        for e in trace]
        counters[name] = {k: v for k, v in mod.counters().items()
                          if k.startswith("plan.cache")}
    assert events["port"] == events["reference"]
    assert [n for n, _ in events["port"]] == ["plan.cache.save", "plan.cache.load",
                                              "plan.cache.load"]
    assert events["port"][1][1]["kept"] == 1 and events["port"][1][1]["stale_schema"] == 1
    assert events["port"][1][1]["malformed"] == 1 and events["port"][2][1]["file_error"]
    assert counters["port"] == counters["reference"]
