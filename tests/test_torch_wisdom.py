"""repro_torch.serve.wisdom and PlanCache's accounting, against the reference.

``repro.plan.cache.PlanCache`` and ``repro.serve.wisdom``'s ``export`` and
``warm_start`` run on this jax, so the same ``put``/``get``/``load``
sequence goes through both caches and gives the same ``stale_losses``,
``hit_count``, ``serve.wisdom.stale`` events and ``LoadReport``s, and a
file written by either package loads in the other with the same report.
On a CPU key the port's cache keys equal the reference's
(``v5|kind|dir|cpu|cpu|...``), so the port also reads the reference's
packaged ``src/repro/serve/wisdom_files/cpu.json`` — read here as a check
of the format; the port never reads it at run time and ships its own
``wisdom_files/cpu.json``, written by its own ``pretune`` on the CPU.

The reference's ``tests/serve/test_wisdom.py`` is ported one for one; its
packaged-artifact cases name the ``cpu`` artifact, since the port's
default backend is the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.plan import cache as jcache
from repro.plan import plan as jplan
from repro.serve import wisdom as jwisdom
from repro_torch import obs, resilience
from repro_torch.plan import PlanCache, plan_fft
from repro_torch.plan.cache import LoadReport
from repro_torch.plan.plan import FFTPlan, problem_key
from repro_torch.serve import SpectrumRequest, SpectrumService, wisdom
from repro_torch.serve.loop import reset_lane_keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_CPU_ARTIFACT = os.path.join(ROOT, "src", "repro", "serve", "wisdom_files", "cpu.json")


@pytest.fixture(autouse=True)
def _clean_serve_state():
    resilience.reset()
    reset_lane_keys()
    yield
    resilience.reset()
    reset_lane_keys()


def _key(kind="rfft2d", shape=(8, 8), dtype="float32"):
    return problem_key(kind, shape, "cpu", dtype)


def _measured_plan(shape=(8, 8), kind="rfft2d", dtype="float32"):
    return FFTPlan(key=_key(kind, shape, dtype), variant="stockham", mode="measure",
                   measured_us=12.5)


def _estimate_plan(shape=(16, 16), kind="fft2d", dtype="complex64"):
    return FFTPlan(key=_key(kind, shape, dtype), variant="stockham", mode="estimate",
                   est_time_s=1e-5)


# --------------------- tests/serve/test_wisdom.py ---------------------


def test_export_warm_start_roundtrip(tmp_path):
    src = PlanCache()
    src.put(_measured_plan())
    path = wisdom.export(str(tmp_path / "w.json"), src)
    assert os.path.exists(path)
    fresh = PlanCache()
    with obs.capture() as trace:
        report = wisdom.warm_start(path, cache=fresh)
    assert report.kept == 1 and report.dropped == 0
    assert len(fresh) == 1
    (ev,) = trace.select("serve.wisdom.warm_start")
    assert ev["kept"] == 1 and ev["file_error"] is None
    got = fresh.get(_measured_plan().key)
    assert got is not None and got.mode == "measure"


def test_export_ships_measured_entries_only(tmp_path):
    src = PlanCache()
    src.put(_measured_plan())
    src.put(_estimate_plan())
    path = wisdom.export(str(tmp_path / "w.json"), src)
    assert PlanCache().load(path).kept == 1
    path_all = wisdom.export(str(tmp_path / "all.json"), src, measured_only=False)
    assert PlanCache().load(path_all).kept == 2


def test_export_to_unwritable_path_raises(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    src = PlanCache()
    src.put(_measured_plan())
    with pytest.raises(RuntimeError, match="unwritable"):
        wisdom.export(str(blocker / "w.json"), src)


def test_warm_start_missing_artifact_reports_not_raises(tmp_path):
    report = wisdom.warm_start(str(tmp_path / "absent.json"), cache=PlanCache())
    assert report.kept == 0 and report.file_error is not None


def test_pretune_produces_measured_wisdom():
    cache = wisdom.pretune([8], kinds=("rfft2d",), measure_iters=1, device="cpu")
    assert len(cache) == 1
    ((_, plan),) = cache.entries()
    assert plan.key.kind == "rfft2d" and plan.key.shape == (8, 8)
    assert plan.key.backend == "cpu"
    assert plan.mode == "measure" or plan.degrade_reason is not None


def test_packaged_cpu_artifact_loads_under_current_schema():
    path = wisdom.artifact_path("cpu")
    assert path is not None, "src/repro_torch/serve/wisdom_files/cpu.json missing"
    assert os.path.dirname(path) == wisdom.WISDOM_DIR
    cache = PlanCache()
    report = cache.load(path)
    assert report.kept > 0, f"packaged wisdom is stale: {report}"
    assert report.file_error is None
    assert all(p.mode == "measure" for _, p in cache.entries())


def test_warm_started_service_serves_without_measure_sweeps(rng):
    cache = PlanCache()
    report = wisdom.warm_start(wisdom.artifact_path("cpu"), cache=cache)
    assert report.kept > 0
    covered = next(p.key.shape for _, p in cache.entries() if p.key.kind == "rfft2d")
    svc = SpectrumService(plan_mode="measure", cache=cache)
    reqs = [SpectrumRequest(frame=torch.from_numpy(rng.standard_normal(covered).astype(np.float32)))
            for _ in range(3)]
    with obs.capture() as trace:
        svc.serve(reqs)
    assert all(r.done for r in reqs)
    assert trace.select("plan.measure") == []
    assert [e["outcome"] for e in trace.select("plan.resolve")] == ["hit"]


def _warmed_cache(tmp_path, variant="stockham"):
    src = PlanCache()
    key = _key()
    src.put(FFTPlan(key=key, variant=variant, mode="measure", measured_us=12.5))
    path = wisdom.export(str(tmp_path / "seed.json"), src)
    fresh = PlanCache()
    wisdom.warm_start(path, cache=fresh)
    return fresh, key


def test_stale_losses_count_consecutive_retune_disagreements(tmp_path):
    cache, key = _warmed_cache(tmp_path, variant="stockham")
    ck = key.cache_key()
    retuned = FFTPlan(key=key, variant="radix4", mode="measure", measured_us=9.0)
    with obs.capture() as trace:
        cache.put(retuned)
        cache.put(retuned)
    assert cache.stale_losses[ck] == 2
    assert [e["losses"] for e in trace.select("serve.wisdom.stale")] == [1, 2]
    ev = trace.select("serve.wisdom.stale")[0]
    assert ev["artifact_variant"] == "stockham"
    assert ev["measured_variant"] == "radix4"


def test_stale_losses_reset_when_artifact_choice_reconfirmed(tmp_path):
    cache, key = _warmed_cache(tmp_path, variant="stockham")
    ck = key.cache_key()
    cache.put(FFTPlan(key=key, variant="radix4", mode="measure", measured_us=9.0))
    assert cache.stale_losses[ck] == 1
    cache.put(FFTPlan(key=key, variant="stockham", mode="measure", measured_us=11.0))
    assert ck not in cache.stale_losses


def test_export_drops_entries_past_stale_loss_threshold(tmp_path):
    cache, key = _warmed_cache(tmp_path, variant="stockham")
    retuned = FFTPlan(key=key, variant="radix4", mode="measure", measured_us=9.0)
    cache.put(retuned)
    cache.put(retuned)
    with obs.capture() as trace:
        aged = wisdom.export(str(tmp_path / "aged.json"), cache, stale_loss_threshold=2)
    assert PlanCache().load(aged).kept == 0
    (ev,) = trace.select("serve.wisdom.export")
    assert ev["dropped_stale"] == 1
    kept = wisdom.export(str(tmp_path / "kept.json"), cache, stale_loss_threshold=3)
    assert PlanCache().load(kept).kept == 1
    kept_all = wisdom.export(str(tmp_path / "all.json"), cache, stale_loss_threshold=None)
    assert PlanCache().load(kept_all).kept == 1


def test_estimate_retunes_do_not_count_stale_losses(tmp_path):
    cache, key = _warmed_cache(tmp_path, variant="stockham")
    cache.put(FFTPlan(key=key, variant="radix4", mode="estimate", est_time_s=1e-5))
    assert cache.stale_losses == {}


def test_pretune_wisdom_roundtrips_through_plan_fft(tmp_path):
    src = PlanCache()
    src.put(_measured_plan(shape=(8, 8)))
    path = wisdom.export(str(tmp_path / "w.json"), src)
    fresh = PlanCache()
    wisdom.warm_start(path, cache=fresh)
    with obs.capture() as trace:
        plan = plan_fft("rfft2d", (8, 8), "cpu", dtype="float32", mode="measure", cache=fresh)
    assert plan.mode == "measure" and plan.measured_us == 12.5
    assert trace.select("plan.measure") == []


# ----------------------------- the port's own -----------------------------


def test_artifact_path_names_the_card_by_default(monkeypatch, tmp_path):
    """``artifact_path()`` names the backend the port's entry points use by
    default, the card; ``warm_start()`` without an artifact for it reports
    ``file_error``, as the reference does."""
    monkeypatch.setattr(wisdom, "WISDOM_DIR", str(tmp_path))
    assert wisdom.DEFAULT_BACKEND == "cuda"
    assert wisdom.artifact_path() is None
    report = wisdom.warm_start(cache=PlanCache())
    assert report.kept == 0 and report.file_error is not None
    (tmp_path / "cuda.json").write_text(json.dumps({"plans": {}}))
    assert wisdom.artifact_path() == str(tmp_path / "cuda.json")


def test_packaged_artifacts_name_their_device():
    """Each packaged artifact holds keys of its own backend only; a card's
    keys carry the card's name."""
    names = sorted(os.listdir(wisdom.WISDOM_DIR))
    assert "cpu.json" in names
    for name in names:
        backend = name[:-len(".json")]
        cache = PlanCache()
        assert cache.load(os.path.join(wisdom.WISDOM_DIR, name)).kept > 0
        for _, plan in cache.entries():
            assert plan.key.backend == backend
            if backend == "cpu":
                assert plan.key.device_kind == "cpu"
            else:
                assert plan.key.device_kind not in ("cpu", "cuda", "")


def test_cli_writes_an_artifact_for_the_named_backend(tmp_path):
    out = tmp_path / "cpu.json"
    assert wisdom._main(["--backend", "cpu", "--sizes", "8", "--kinds", "fft2d",
                         "--out", str(out)]) == 0
    cache = PlanCache()
    assert cache.load(str(out)).kept == 1
    ((_, plan),) = cache.entries()
    assert plan.key.backend == "cpu" and plan.key.shape == (8, 8) and plan.mode == "measure"


def test_cache_accounting_api(tmp_path):
    """``autoload``, ``__contains__``, ``hit_count`` and ``clear``, as the
    reference's ``PlanCache`` has them."""
    path = tmp_path / "w.json"
    src = PlanCache()
    src.put(_measured_plan())
    src.save(str(path))
    assert len(PlanCache(path=str(path), autoload=False)) == 0
    cache = PlanCache(path=str(path))
    key = _measured_plan().key
    assert key in cache and _estimate_plan().key not in cache
    cache.get(key)
    cache.get(key)
    cache.get(_estimate_plan().key)
    assert cache.hit_count(key.cache_key()) == 2 and (cache.hits, cache.misses) == (2, 1)
    assert cache.load_report.kept == 1
    cache.clear()
    assert len(cache) == 0 and cache.hits == 0 and cache.load_report is None
    assert cache.hit_count(key.cache_key()) == 0 and cache.stale_losses == {}


# ------------------------ parity with the reference ------------------------


def _both(kind="rfft2d", shape=(8, 8), dtype="float32", variant="stockham", mode="measure",
          measured_us=12.5):
    """The same plan in each package: (port plan, reference plan)."""
    kw = {"variant": variant, "mode": mode, "measured_us": measured_us, "est_time_s": 1e-5}
    return (FFTPlan(key=_key(kind, shape, dtype), **kw),
            jplan.FFTPlan(key=jplan.problem_key(kind, shape, dtype), **kw))


PUTS = [("rfft2d", "radix4", "measure"), ("rfft2d", "radix4", "measure"),
        ("fft2d", "looped", "estimate"), ("rfft2d", "stockham", "measure"),
        ("rfft2d", "radix4", "measure"), ("fft2d", "radix4", "measure"),
        ("fft2d", "radix4", "measure"), ("fft2d", "radix4", "measure"),
        ("fft2d", "stockham", "measure")]


def test_put_sequence_matches_the_reference(tmp_path):
    """The same load, ``put`` and ``get`` sequence gives the same
    ``stale_losses``, ``hit_count``, hit/miss counts, ``serve.wisdom.stale``
    events and export aging in both caches."""
    seeded = {}
    for pkg in ("port", "reference"):
        src = PlanCache() if pkg == "port" else jcache.PlanCache()
        for kind, dtype in (("rfft2d", "float32"), ("fft2d", "complex64")):
            pair = _both(kind, (16, 16), dtype)
            src.put(pair[0] if pkg == "port" else pair[1])
        path = str(tmp_path / f"{pkg}.json")
        (wisdom if pkg == "port" else jwisdom).export(path, src)
        seeded[pkg] = path
    results = {}
    for pkg in ("port", "reference"):
        cache = PlanCache() if pkg == "port" else jcache.PlanCache()
        (wisdom if pkg == "port" else jwisdom).warm_start(seeded[pkg], cache=cache)
        with (obs if pkg == "port" else jobs).capture() as trace:
            for kind, variant, mode in PUTS:
                dtype = "float32" if kind == "rfft2d" else "complex64"
                pair = _both(kind, (16, 16), dtype, variant, mode)
                cache.put(pair[0] if pkg == "port" else pair[1])
                cache.get(pair[0].key if pkg == "port" else pair[1].key)
            missing = _both("fft2d", (32, 32), "complex64")
            cache.get(missing[0].key if pkg == "port" else missing[1].key)
        aged = str(tmp_path / f"{pkg}-aged.json")
        (wisdom if pkg == "port" else jwisdom).export(aged, cache, stale_loss_threshold=2)
        results[pkg] = (
            dict(cache.stale_losses), dict(cache.key_hits), cache.hits, cache.misses,
            [(e.name, dict(e.fields)) for e in trace if e.name == "serve.wisdom.stale"],
            sorted(json.load(open(aged))["plans"]),
        )
    assert results["port"] == results["reference"]
    assert results["port"][0], "the sequence left no stale loss"


def _doctored(tmp_path, name, writer):
    """A wisdom file with one good entry, one stale-schema, one malformed and
    one mismatched, written from ``writer``'s cache."""
    cache = PlanCache() if writer == "port" else jcache.PlanCache()
    pair = _both("fft2d", (16, 16), "complex64")
    cache.put(pair[0] if writer == "port" else pair[1])
    path = str(tmp_path / name)
    cache.save(path)
    payload = json.load(open(path))
    (good_key,) = payload["plans"]
    good = payload["plans"][good_key]
    payload["plans"]["v1|" + good_key.split("|", 1)[1]] = good
    payload["plans"][good_key + "|tampered"] = good
    payload["plans"][good_key.replace("16x16", "8x8")] = {}
    json.dump(payload, open(path, "w"))
    return path


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_load_reports_match_the_reference(tmp_path, writer):
    """A file either package wrote loads in both with the same
    ``LoadReport``, summed the same way over two loads (and a missing file),
    and round-trips export -> warm_start the same."""
    path = _doctored(tmp_path, "doctored.json", writer)
    reports = {}
    for pkg in ("port", "reference"):
        cache = PlanCache() if pkg == "port" else jcache.PlanCache()
        first = cache.load(path).to_dict()
        cache.load(path)
        missing = cache.load(str(tmp_path / "absent.json"))
        out = str(tmp_path / f"{pkg}-out.json")
        (wisdom if pkg == "port" else jwisdom).export(out, cache, measured_only=False)
        fresh = PlanCache() if pkg == "port" else jcache.PlanCache()
        warm = (wisdom if pkg == "port" else jwisdom).warm_start(out, cache=fresh).to_dict()
        total = cache.load_report.to_dict()
        total["file_error"] = total["file_error"] is not None
        reports[pkg] = (first, total, missing.kept, warm, sorted(k for k, _ in fresh.entries()))
    assert reports["port"] == reports["reference"]
    assert reports["port"][0] == LoadReport(kept=1, stale_schema=1, malformed=1,
                                            key_mismatch=1).to_dict()


def test_the_port_reads_the_reference_cpu_artifact():
    """The reference's packaged file, loaded by path: every entry kept, with
    the engines the reference's cache loads."""
    cache, ref = PlanCache(), jcache.PlanCache()
    report = cache.load(REFERENCE_CPU_ARTIFACT)
    assert report.to_dict() == ref.load(REFERENCE_CPU_ARTIFACT).to_dict()
    assert report.kept == 6
    assert ([(k, p.variant, p.measured_us) for k, p in cache.entries()]
            == [(k, p.variant, p.measured_us) for k, p in ref.entries()])


def test_warm_start_event_matches_the_reference(tmp_path):
    path = _doctored(tmp_path, "w.json", "reference")
    events = {}
    for pkg, mod, o in (("port", wisdom, obs), ("reference", jwisdom, jobs)):
        cache = PlanCache() if pkg == "port" else jcache.PlanCache()
        with o.capture() as trace:
            mod.warm_start(path, cache=cache)
        events[pkg] = [(e.name, dict(e.fields)) for e in trace
                       if e.name in ("serve.wisdom.warm_start", "plan.cache.load")]
    assert events["port"] == events["reference"]
