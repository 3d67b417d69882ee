"""repro_torch.xfft.report / report_data on CPU tensors.

The reference's ``repro.xfft._report`` cannot be called on this jax (it
reads ``repro.xfft._config``, whose package fails at
``src/repro/xfft/_transforms.py:37``), so the port's snapshot is held to the
sections and keys the reference's ``report_data`` builds — each listed key
is checked to appear in the reference's source, so the list cannot drift
from it — and to the assertions of the reference's report tests
(``tests/obs/test_telemetry.py::test_report_renders_telemetry_sections``,
``tests/obs/test_instrumentation.py::test_report_renders_live_entries_and_counters``
and ``::test_load_report_accounts_for_every_dropped_entry``,
``tests/plan/test_plan_resilience.py::test_default_cache_degrade_via_env``),
plus the quarantine table grouped by serve lane and the rule that a report
replans nothing.
"""

import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs, resilience, xfft
from repro_torch.plan import PlanCache, problem_key, resolve_call
from repro_torch.plan.autotune import estimate_plan
from repro_torch.resilience import FaultPlan, FaultSpec
from repro_torch.serve import SpectrumRequest, SpectrumService
from repro_torch.serve.loop import reset_lane_keys

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = (ROOT / "src" / "repro" / "xfft" / "_report.py").read_text()

SECTIONS = {
    "config": ["variant", "mode", "precision", "backends", "cache_dir"],
    "cache": ["path", "entries", "hits", "misses", "load", "readonly_path"],
    "resilience": ["quarantine", "quarantine_by_service"],
    "telemetry": ["flight_recorder", "calibration", "histograms"],
    "counters": None,
}
ENTRY_KEYS = ["key", "kind", "direction", "shape", "dtype", "precision", "backend", "variant",
              "mode", "est_time_s", "measured_us", "tile", "degrade_reason", "hits"]


@pytest.fixture(autouse=True)
def _clean_state():
    resilience.reset()
    resilience.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_lane_keys()
    yield
    resilience.reset()
    resilience.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_lane_keys()


def _frame(rng):
    return torch.from_numpy((rng.standard_normal((16, 16))
                             + 1j * rng.standard_normal((16, 16))).astype(np.complex64))


def test_the_listed_keys_are_the_references():
    for name in [*SECTIONS, *ENTRY_KEYS] + [k for ks in SECTIONS.values() if ks for k in ks]:
        assert f'"{name}"' in REFERENCE, name


def test_report_data_holds_the_reference_sections_and_keys(rng, tmp_path):
    with xfft.config(cache_dir=str(tmp_path)):
        xfft.fft2(_frame(rng))
        data = xfft.report_data()
    assert set(SECTIONS) <= set(data)
    for section, keys in SECTIONS.items():
        if keys:
            assert set(keys) <= set(data[section]), section
    (entry,) = data["cache"]["entries"]
    assert set(ENTRY_KEYS) <= set(entry)
    assert entry["backend"] == "cpu" and entry["device_kind"] == "cpu"
    json.dumps(data)  # a plain, serialisable snapshot


def test_report_renders_telemetry_sections(rng):
    xfft.fft2(_frame(rng))
    data = xfft.report_data()
    assert data["telemetry"]["flight_recorder"]["capacity"] >= 1
    assert isinstance(data["telemetry"]["calibration"], list)
    text = xfft.report()
    assert "flight recorder:" in text
    assert "planner calibration" in text


def test_report_renders_live_entries_and_counters(rng, tmp_path):
    x = _frame(rng)
    with xfft.config(cache_dir=str(tmp_path)):
        xfft.fft2(x)
        xfft.fft2(x)
        text = xfft.report()
        data = xfft.report_data()
    assert "fft2d fwd 16x16 complex64" in text
    assert "hits=1" in text
    assert "plan.resolve.hit" in text
    (entry,) = data["cache"]["entries"]
    assert entry["kind"] == "fft2d" and entry["hits"] == 1


def test_report_renders_the_load_accounting(tmp_path):
    path = str(tmp_path / "xfft_plans.json")
    cache = PlanCache(path=path)
    cache.put(estimate_plan(problem_key("fft2d", (16, 16), "cpu")))
    cache.save()
    payload = json.load(open(path))
    (good_key,) = payload["plans"]
    good = payload["plans"][good_key]
    payload["plans"]["v1|" + good_key.split("|", 1)[1]] = good
    payload["plans"][good_key + "|tampered"] = good
    payload["plans"][good_key.replace("16x16", "8x8")] = {}
    json.dump(payload, open(path, "w"))
    loaded = PlanCache(path=path)
    assert (loaded.load_report.kept, loaded.load_report.dropped) == (1, 3)
    text = xfft.report(cache=loaded)
    assert "kept=1 stale_schema=1 malformed=1 key_mismatch=1" in text
    assert xfft.report_data(cache=loaded)["cache"]["load"]["malformed"] == 1


def test_report_surfaces_an_unwritable_wisdom_path(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    cache = PlanCache(path=str(blocker / "wisdom.json"))
    resolve_call("fft2d", (8, 8), "cpu", cache=cache)
    assert cache.save() is None
    assert "unwritable" in xfft.report(cache)


def test_quarantine_table_is_grouped_by_serve_lane(rng):
    svc = SpectrumService()
    frame = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    svc.serve([SpectrumRequest(frame=frame)])
    (plan,) = svc.plans.values()
    faults = FaultPlan(FaultSpec("engine.apply", mode="error",
                                 match={"engine": plan.variant}, times=1))
    with xfft.config(faults=faults):
        svc.serve([SpectrumRequest(frame=frame)])
    data = xfft.report_data()
    (row,) = data["resilience"]["quarantine"]
    assert row["engine"] == plan.variant and row["services"] == ["spectrum"]
    assert data["resilience"]["quarantine_by_service"]["spectrum"] == [row]
    text = xfft.report()
    assert "quarantine (by service lane):" in text
    assert f"spectrum     {plan.variant}" in text
    assert "serve.lane.spectrum.spectrum[(8, 8),True,cpu]" in data["telemetry"]["histograms"]


def test_report_replans_nothing(rng, tmp_path):
    with xfft.config(cache_dir=str(tmp_path)):
        xfft.fft2(_frame(rng))
        from repro_torch.plan.api import _cache_for_dir

        cache = _cache_for_dir(str(tmp_path))
        before = (cache.hits, cache.misses, len(cache), dict(cache.key_hits))
        with obs.capture() as trace:
            xfft.report()
            xfft.report_data()
        assert (cache.hits, cache.misses, len(cache), dict(cache.key_hits)) == before
    assert [e.name for e in trace] == []
    assert not os.listdir(tmp_path)  # nothing saved either
