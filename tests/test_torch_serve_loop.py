"""repro_torch.serve's loop and queue, against repro.serve.loop.

``repro.serve.queue`` and ``repro.serve.loop`` import and run on this jax
(they touch no array), so the same requests and classifier go through the
reference's ``ServeLoop`` and the port's, under one injected clock, and
give the same lanes, batches and round-robin order and the same
``serve.queue``, ``serve.loop.enqueue``, ``serve.loop.tick``,
``serve.shed`` and ``serve.lane.error`` events, field for field. The
reference's ``tests/serve/test_loop.py`` and ``test_loop_telemetry.py``
are ported one for one (their ``SpectrumService`` cases on CPU tensors,
held to numpy at the reference's rtol/atol 1e-4).
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import hist as jhist
from repro.resilience import ServicePolicy as JServicePolicy
from repro.serve import loop as jloop
from repro.serve import queue as jqueue
from repro_torch import obs, resilience, xfft
from repro_torch.obs import telemetry
from repro_torch.obs.hist import histogram, reset_histograms
from repro_torch.obs.telemetry import FlightRecorder
from repro_torch.resilience import (
    FaultPlan,
    FaultSpec,
    Overloaded,
    ServicePolicy,
    configure,
    quarantine,
)
from repro_torch.serve import (
    BatchPolicy,
    LaneKey,
    ServeLoop,
    SpectrumRequest,
    SpectrumService,
)
from repro_torch.serve.loop import record_lane_key, reset_lane_keys, services_for_key

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _clean_serve_state():
    resilience.reset()
    configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_lane_keys()
    reset_histograms()
    yield
    resilience.reset()
    configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_lane_keys()
    reset_histograms()


class _Clock:
    """A settable clock: ``clock.now += 31.0`` drives a cooldown."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def fake_clock():
    return _Clock()


@pytest.fixture
def recorder(tmp_path):
    rec = FlightRecorder(capacity=128, dump_dir=str(tmp_path / "flight"))
    prev = telemetry.set_flight_recorder(rec)
    yield rec
    telemetry.set_flight_recorder(prev)


def _toy_loop(batches, **kw):
    """A loop whose executor just records (lane, members) per batch."""

    def classify(r):
        return LaneKey(r["lane"], ())

    def execute(lane, members):
        batches.append((lane.family, list(members)))
        for m in members:
            m["served"] = True

    return ServeLoop(classify, execute, service="toy", **kw)


def _reqs(lane, n):
    return [{"lane": lane, "i": i, "served": False} for i in range(n)]


# ------------------------------ scheduling ------------------------------


def test_lane_coalescing_respects_max_batch():
    batches = []
    loop = _toy_loop(batches, batch=BatchPolicy(max_batch=4))
    for r in _reqs("a", 10):
        loop.submit(r)
    assert loop.drain() == 10
    assert [len(m) for _, m in batches] == [4, 4, 2]
    assert all(m["served"] for _, ms in batches for m in ms)


def test_lanes_coalesce_across_interleaved_arrival_order():
    batches = []
    loop = _toy_loop(batches, batch=BatchPolicy(max_batch=8))
    reqs = [r for pair in zip(_reqs("a", 4), _reqs("b", 4)) for r in pair]
    loop.serve(reqs)
    assert sorted((fam, len(ms)) for fam, ms in batches) == [("a", 4), ("b", 4)]


def test_round_robin_prevents_lane_starvation():
    batches = []
    loop = _toy_loop(batches, batch=BatchPolicy(max_batch=2))
    for r in _reqs("hot", 8):
        loop.submit(r)
    quiet = _reqs("quiet", 1)[0]
    loop.submit(quiet)
    loop.tick(drain=True)
    loop.tick(drain=True)
    assert quiet["served"], [fam for fam, _ in batches]
    assert [fam for fam, _ in batches] == ["hot", "quiet"]
    assert loop.queue.depth() == 6
    loop.drain()
    assert loop.queue.depth() == 0


def test_max_wait_window_holds_then_releases(fake_clock):
    batches = []
    loop = _toy_loop(batches, batch=BatchPolicy(max_batch=4, max_wait_s=1.0), clock=fake_clock)
    loop.submit(_reqs("a", 1)[0])
    assert loop.tick() == 0
    fake_clock.now += 0.5
    loop.submit(_reqs("a", 1)[0])
    assert loop.tick() == 0
    fake_clock.now += 0.6
    assert loop.tick() == 2
    assert [len(ms) for _, ms in batches] == [2]


def test_full_lane_dispatches_inside_wait_window(fake_clock):
    loop = _toy_loop([], batch=BatchPolicy(max_batch=2, max_wait_s=60.0), clock=fake_clock)
    for r in _reqs("a", 2):
        loop.submit(r)
    assert loop.tick() == 2


# ---------------------------- backpressure ----------------------------


def test_streaming_shed_at_max_queue_never_drops_admitted():
    loop = _toy_loop([], policy=ServicePolicy(max_queue=2))
    t1 = loop.submit(_reqs("a", 1)[0])
    t2 = loop.submit(_reqs("b", 1)[0])
    with obs.capture() as trace:
        with pytest.raises(Overloaded) as ei:
            loop.submit(_reqs("a", 1)[0])
    assert ei.value.depth == 3 and ei.value.limit == 2
    (shed,) = trace.select("serve.shed")
    assert shed["service"] == "toy" and shed["lane"] == "a[]"
    loop.drain()
    assert t1.done and t2.done
    assert t1.result()["served"] and t2.result()["served"]


def test_call_scoped_serve_sheds_whole_call():
    loop = _toy_loop([], policy=ServicePolicy(max_queue=2))
    reqs = _reqs("a", 3)
    with pytest.raises(Overloaded):
        loop.serve(reqs)
    assert not any(r["served"] for r in reqs)
    assert loop.queue.depth() == 0


def test_classify_error_prefixes_request_index():
    def classify(r):
        raise ValueError("boom")

    loop = ServeLoop(classify, lambda lane, ms: None, service="toy")
    with pytest.raises(ValueError, match="request 0: boom"):
        loop.serve([{"lane": "a"}])


# ------------------------------ tickets ------------------------------


def test_ticket_carries_batch_error_to_submitter():
    def execute(lane, members):
        raise RuntimeError("lane exploded")

    loop = ServeLoop(lambda r: LaneKey("a", ()), execute, service="toy")
    t = loop.submit({"x": 1})
    with obs.capture() as trace:
        served = loop.tick(drain=True)
    assert served == 1 and t.done
    with pytest.raises(RuntimeError, match="lane exploded"):
        t.result()
    (err,) = trace.select("serve.lane.error")
    assert err["service"] == "toy" and err["lane"] == "a[]"


def test_tick_emits_depth_gauge_and_lane_label():
    loop = _toy_loop([], batch=BatchPolicy(max_batch=2))
    for r in _reqs("a", 3):
        loop.submit(r)
    with obs.capture() as trace:
        loop.tick()
    (tick,) = trace.select("serve.loop.tick")
    assert tick["service"] == "toy" and tick["lane"] == "a[]"
    assert tick["batch"] == 2 and tick["depth"] == 1


# --------------------------- background thread ---------------------------


def test_background_loop_serves_streaming_submits():
    batches = []
    loop = _toy_loop(batches, batch=BatchPolicy(max_batch=4)).start()
    try:
        tickets = [loop.submit(r) for r in _reqs("a", 6)]
        for t in tickets:
            assert t.wait(timeout=5.0), "background loop never served ticket"
        assert all(t.result()["served"] for t in tickets)
    finally:
        loop.stop()
    assert loop.queue.depth() == 0


# ----------------------- lane -> key registry -----------------------


def test_lane_key_registry_groups_by_service():
    record_lane_key("spectrum", "v5|k1")
    record_lane_key("imaging", "v5|k1")
    record_lane_key("imaging", "v5|k2")
    assert services_for_key("v5|k1") == ("imaging", "spectrum")
    assert services_for_key("v5|k2") == ("imaging",)
    assert services_for_key("v5|unknown") == ()


# ------------------- SpectrumService over the loop -------------------


def test_streaming_submits_match_call_scoped_parity(rng):
    svc = SpectrumService(batch=BatchPolicy(max_batch=4))
    frames = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(6)]
    tickets = [svc.loop.submit(SpectrumRequest(frame=T(f))) for f in frames]
    svc.loop.drain()
    for t, f in zip(tickets, frames):
        np.testing.assert_allclose(t.result().spectrum.numpy(), np.fft.rfft2(f),
                                   rtol=1e-4, atol=1e-4)
    assert len(svc.plans) == 1


def test_benched_engine_mid_stream_keeps_lane_serving(fake_clock, rng):
    configure(cooldown_s=30.0, clock=fake_clock)
    svc = SpectrumService(batch=BatchPolicy(max_batch=2))
    frames = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(6)]
    svc.serve([SpectrumRequest(frame=T(frames[0]))])
    ((_, plan),) = list(svc.plans.items())
    first = plan.variant
    resilience.reset()

    faults = FaultPlan(
        FaultSpec("engine.apply", mode="error", match={"engine": first}, times=1)
    )
    with obs.capture() as trace, xfft.config(faults=faults):
        tickets = [svc.loop.submit(SpectrumRequest(frame=T(f))) for f in frames]
        svc.loop.drain()
    for t, f in zip(tickets, frames):
        np.testing.assert_allclose(t.result().spectrum.numpy(), np.fft.rfft2(f),
                                   rtol=1e-4, atol=1e-4)
    (failover,) = trace.select("resilience.failover")
    assert failover["engine"] == first
    assert len(trace.select("serve.lane.replan")) >= 1
    assert quarantine().table() != []
    fake_clock.now += 31.0
    svc.serve([SpectrumRequest(frame=T(frames[0]))])
    assert quarantine().table() == []


def test_injected_serve_fault_retries_per_lane_policy(rng):
    svc = SpectrumService(
        policy=ServicePolicy(max_retries=1, backoff_s=0.0),
        batch=BatchPolicy(max_batch=4),
    )
    plan = FaultPlan(FaultSpec("serve.batch", mode="error", times=1))
    with obs.capture() as trace, xfft.config(faults=plan):
        t = svc.loop.submit(
            SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))
        )
        svc.loop.drain()
    assert t.result().done
    assert len(trace.select("resilience.retry")) == 1


# ------------------- tests/serve/test_loop_telemetry.py -------------------


def _toy(**kw):
    def classify(r):
        return LaneKey(r["lane"], ())

    def execute(lane, members):
        for m in members:
            m["served"] = True

    return ServeLoop(classify, execute, service="toy", **kw)


def test_background_thread_events_reach_recorder_not_caller_capture(recorder):
    loop = _toy(batch=BatchPolicy(max_batch=4, max_wait_s=0.0))
    loop.start()
    try:
        with obs.capture() as trace:
            tickets = [loop.submit({"lane": "a", "i": i, "served": False}) for i in range(8)]
            for t in tickets:
                assert t.result(timeout=5.0)["served"]
    finally:
        loop.stop()
    assert len(trace.select("serve.loop.enqueue")) == 8
    assert trace.select("serve.loop.tick") == []
    ticks = [e for e in recorder.events() if e.name == "serve.loop.tick"]
    assert ticks and all(e["service"] == "toy" for e in ticks)
    loop_tids = {e.tid for e in ticks}
    assert threading.get_ident() not in loop_tids
    names = recorder.thread_names()
    assert any("serve-loop[toy]" in names[tid] for tid in loop_tids)


def test_ring_stays_bounded_under_sustained_loop_emission(recorder):
    loop = _toy(batch=BatchPolicy(max_batch=2, max_wait_s=0.0))
    loop.start()
    try:
        for _ in range(20):
            tickets = [loop.submit({"lane": "a", "i": i, "served": False}) for i in range(16)]
            for t in tickets:
                t.result(timeout=5.0)
            assert len(recorder.events()) <= recorder.capacity
    finally:
        loop.stop()
    stats = recorder.stats()
    assert stats["retained"] <= stats["capacity"] == 128
    assert stats["recorded_total"] > 128


def test_lane_error_in_background_thread_dumps_flight_snapshot(recorder):
    def execute(lane, members):
        raise RuntimeError("executor exploded")

    loop = ServeLoop(lambda r: LaneKey(r["lane"], ()), execute, service="toy",
                     batch=BatchPolicy(max_batch=1, max_wait_s=0.0))
    loop.start()
    try:
        ticket = loop.submit({"lane": "a"})
        with pytest.raises(RuntimeError):
            ticket.result(timeout=5.0)
    finally:
        loop.stop()
    assert any(d["trigger"] == "serve.lane.error" for d in recorder.stats()["dumps"])


def test_tick_latency_lands_in_lane_histogram(fake_clock):
    loop = _toy(batch=BatchPolicy(max_batch=8), clock=fake_clock)
    for i in range(4):
        loop.submit({"lane": "a", "i": i, "served": False})
    fake_clock.now = 0.002
    assert loop.tick(drain=True) == 4
    h = histogram("serve.lane.toy.a[]")
    assert h.count == 4
    assert h.bucket_index(h.percentile(50)) == h.bucket_index(2000.0)


def test_tick_event_carries_lane_tail_gauges():
    loop = _toy(batch=BatchPolicy(max_batch=4))
    with obs.capture() as trace:
        for i in range(4):
            loop.submit({"lane": "a", "i": i, "served": False})
        loop.tick(drain=True)
        for i in range(4):
            loop.submit({"lane": "a", "i": i, "served": False})
        loop.tick(drain=True)
    first, second = trace.select("serve.loop.tick")
    assert first["lane_n"] == 0 and first["lane_p99_us"] is None
    assert second["lane_n"] == 4
    assert second["lane_p50_us"] > 0 and second["lane_p99_us"] > 0


def test_failed_batches_stay_out_of_latency_histograms():
    calls = {"n": 0}

    def execute(lane, members):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("first batch fails")

    loop = ServeLoop(lambda r: LaneKey(r["lane"], ()), execute, service="toy",
                     batch=BatchPolicy(max_batch=1))
    t1 = loop.submit({"lane": "a"})
    loop.tick(drain=True)
    with pytest.raises(RuntimeError):
        t1.result(timeout=1.0)
    t2 = loop.submit({"lane": "a"})
    loop.tick(drain=True)
    t2.result(timeout=1.0)
    assert histogram("serve.lane.toy.a[]").count == 1


def test_histograms_merge_across_lanes_for_service_view():
    loop = _toy(batch=BatchPolicy(max_batch=4))
    for lane in ("a", "b"):
        for i in range(3):
            loop.submit({"lane": lane, "i": i, "served": False})
    loop.drain()
    merged = obs.LatencyHistogram()
    for _, h in obs.histograms(prefix="serve.lane.toy.").items():
        merged.merge(h)
    assert merged.count == 6


# -------------------- parity with repro.serve.loop --------------------

SERVED_EVENTS = ("serve.queue", "serve.loop.enqueue", "serve.loop.tick", "serve.shed",
                 "serve.lane.error")


def _drive(pkg, scenario):
    """Run ``scenario`` through one package's loop under a fake clock;
    returns the dispatch order [(lane label, [request ids])], the tickets'
    outcomes and the serve events [(name, fields)]."""
    if pkg == "port":
        obs_mod, hist_mod, Loop, Key, Batch, Policy = (
            obs, reset_histograms, ServeLoop, LaneKey, BatchPolicy, ServicePolicy)
    else:
        obs_mod, hist_mod, Loop, Key, Batch, Policy = (
            jobs, jhist.reset_histograms, jloop.ServeLoop, jqueue.LaneKey, jqueue.BatchPolicy,
            JServicePolicy)
    hist_mod()
    clock, dispatched = _Clock(), []

    def classify(r):
        if r.get("bad"):
            raise ValueError("bad request")
        return Key(r["lane"], (r.get("h", 8), r.get("real", True)))

    def execute(lane, members):
        clock.now += 0.001 * len(members)
        dispatched.append((lane.label(), [m["id"] for m in members]))
        if any(m.get("explode") for m in members):
            raise RuntimeError("lane exploded")

    kind, batch, max_queue, reqs = scenario
    loop = Loop(classify, execute, service="svc",
                policy=Policy(max_queue=max_queue), batch=Batch(**batch), clock=clock,
                queue_fields=lambda rs, lanes: {"groups": len(set(lanes))})
    outcomes = []
    with obs_mod.capture() as trace:
        if kind == "serve":
            try:
                loop.serve(reqs)
                outcomes.append("served")
            except Exception as e:  # noqa: BLE001 — the outcome is compared
                outcomes.append(type(e).__name__)
        else:
            tickets = []
            for r in reqs:
                clock.now += 0.0005
                try:
                    tickets.append(loop.submit(r))
                except Exception as e:  # noqa: BLE001
                    outcomes.append(type(e).__name__)
                if kind == "stream-tick":
                    loop.tick()
            clock.now += 1.0
            while loop.tick():
                pass
            loop.drain()
            outcomes += ["error" if t.error else "ok" for t in tickets]
    events = [(e.name, dict(e.fields)) for e in trace if e.name in SERVED_EVENTS]
    return dispatched, outcomes, events


def _mixed(n, explode=None):
    lanes = [("spectrum", 8, True), ("spectrum", 16, False), ("registration", 8, True)]
    reqs = []
    for i in range(n):
        lane, h, real = lanes[(i * 7 + i // 3) % len(lanes)]
        reqs.append({"id": i, "lane": lane, "h": h, "real": real,
                     "explode": explode is not None and i == explode})
    return reqs


SCENARIOS = {
    "call-scoped": ("serve", {"max_batch": 4}, None, _mixed(23)),
    "call-scoped whole lanes": ("serve", {}, None, _mixed(11)),
    "call-scoped shed": ("serve", {"max_batch": 2}, 5, _mixed(6)),
    "call-scoped invalid": ("serve", {}, None, _mixed(3) + [{"id": 3, "bad": True}]),
    "call-scoped lane error": ("serve", {"max_batch": 3}, None, _mixed(9, explode=4)),
    "streaming": ("stream", {"max_batch": 3, "max_wait_s": 0.002}, 12, _mixed(17)),
    "streaming with ticks": ("stream-tick", {"max_batch": 4, "max_wait_s": 0.001}, None,
                             _mixed(19, explode=7)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_loop_matches_the_reference(name):
    """Lanes, batches, round-robin order, ticket outcomes and every serve
    event with its fields agree with ``repro.serve.loop`` under one clock."""
    ported = _drive("port", SCENARIOS[name])
    reference = _drive("reference", SCENARIOS[name])
    assert ported[0] == reference[0]
    assert ported[1] == reference[1]
    assert [n for n, _ in ported[2]] == [n for n, _ in reference[2]]
    assert ported[2] == reference[2]
    assert ported[0] or ported[1] != ["served"], "the scenario did nothing"


def test_spectrum_lanes_name_the_reference_signature_and_the_device(rng):
    """The port's spectrum lane is the reference's ``((H, W), real)`` with
    the frame's device appended: one lane a device."""
    svc = SpectrumService()
    frame = T(rng.standard_normal((8, 8)).astype(np.float32))
    lane = svc._classify(SpectrumRequest(frame=frame))
    assert lane.family == "spectrum" and lane.signature[:2] == ((8, 8), True)
    assert lane.signature[2] == "cpu"
    meta = svc._classify(SpectrumRequest(frame=torch.empty(8, 8, device="meta")))
    assert meta != lane and meta.signature[:2] == lane.signature[:2]


def test_a_fault_budget_is_spent_once_across_threads(rng):
    """Four threads serving under one scoped ``FaultPlan`` (the same fault
    state, through copied contexts) spend its ``times=1`` budget once: one
    fault and one retry in all, and every thread's spectra are right."""
    import contextvars

    plan = FaultPlan(FaultSpec("serve.batch", mode="error", times=1))
    frames = [T(rng.standard_normal((8, 8)).astype(np.float32)) for _ in range(16)]
    results, errors = {}, []

    def serve(i):
        svc = SpectrumService(policy=ServicePolicy(max_retries=1, backoff_s=0.0))
        try:
            results[i] = svc.serve([SpectrumRequest(frame=f) for f in frames[i::4]])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    with obs.capture() as trace, xfft.config(faults=plan):
        contexts = [contextvars.copy_context() for _ in range(4)]
    workers = [threading.Thread(target=ctx.run, args=(serve, i))
               for i, ctx in enumerate(contexts)]
    for th in workers:
        th.start()
    for th in workers:
        th.join()
    assert errors == []
    assert len(trace.select("resilience.fault")) == 1
    assert len(trace.select("resilience.retry")) == 1
    for i, reqs in results.items():
        for r, f in zip(reqs, frames[i::4]):
            np.testing.assert_allclose(r.spectrum.numpy(), np.fft.rfft2(f.numpy()),
                                       rtol=1e-4, atol=1e-4)
