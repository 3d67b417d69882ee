"""repro_torch.plan: ESTIMATE on the card's keys, and wisdom carried across.

The system has no weights; the state it carries is wisdom, the plan cache
file. Files written by either package must load in the other with equal
keys and variants. No card is needed: keys name one.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.engines import registry as jregistry
from repro.plan import autotune as jautotune
from repro.plan import cache as jcache
from repro.plan import plan as jplan
from repro_torch import xfft
from repro_torch.engines import get_engine, has_engine, iter_engines
from repro_torch.plan import PlanCache, ProblemKey, estimate_plan, resolve_call
from repro_torch.plan.autotune import _row_cost, variant_candidates
from repro_torch.plan.plan import FFTPlan

H100 = "NVIDIA H100 80GB HBM3"

SMOKE_KEYS = [
    ("fft2d", (512, 128, 128), "complex64"),
    ("fft2d", (16, 1024, 1024), "complex64"),
    ("rfft2d", (512, 128, 128), "float32"),
    ("rfft2d", (32, 512, 512), "float32"),
    ("fft1d", (8192, 2048), "complex64"),
    ("rfft1d", (8192, 2048), "float32"),
    ("fft1d", (64, 262144), "complex64"),
    ("rfft1d", (256, 65536), "float32"),
    ("rfft2d", (8, 512, 32768), "float32"),
]


@pytest.mark.parametrize("kind,shape,dtype", SMOKE_KEYS)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_estimate_picks_a_fused_kernel_on_the_card(kind, shape, dtype, direction):
    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype=dtype, direction=direction)
    assert estimate_plan(key).variant in ("fused", "fused_r4")


@pytest.mark.parametrize("kind,shape,dtype", SMOKE_KEYS)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_estimate_picks_the_radix4_kernel_on_the_card(kind, shape, dtype, direction):
    """The radix-4 panel has about half the Stockham passes of the radix-2
    one for the same HBM bytes where the radix-2 kernel runs the stage
    panel, and the same register passes with fewer operations on the
    one-block rows; ESTIMATE must rank it first wherever both fit."""
    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype=dtype, direction=direction)
    assert estimate_plan(key).variant == "fused_r4"


# chip_smoke's requests: (kind, shape, direction, dtype), each planned onto
# the radix-4 kernels before their one-block rows moved to register passes.
SMOKE_REQUESTS = [(kind, shape, direction, dtype) for kind, shape, dtype in SMOKE_KEYS
                  for direction in ("fwd", "inv")]


@pytest.mark.parametrize("kind,shape,direction,dtype", SMOKE_REQUESTS)
def test_smoke_requests_keep_their_engine(kind, shape, direction, dtype):
    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype=dtype, direction=direction)
    assert estimate_plan(key).variant == "fused_r4"


@pytest.mark.parametrize("n,radix,real,inverse,cost", [
    (2048, 4, False, False, (1, 2)),   # fft_fused: 16·16·8, two exchanges
    (2048, 4, True, False, (1, 2)),    # rfft_fused: 16·16·4, mirror bins paired
    (8192, 4, True, False, (1, 3)),    # 16·16·16 and the recombination's exchange
    (2048, 4, True, True, (1, 2)),     # irfft_fused: 16·16·4, untangled in the first pass
    (2048, 2, False, False, (1, 2)),   # radix 2: the same register passes, 16·16·8
    (2048, 2, True, False, (1, 2)),    # radix-2 rfft_fused: 16·16·4, mirror bins paired
    (2048, 2, True, True, (1, 2)),     # radix-2 irfft_fused: the same passes, 16·16·4
    (16, 4, False, False, (1, 0)),     # one pass, HBM to HBM
    (2 ** 18, 4, False, False, (1, 4)),  # cluster: 64 lines of 2^12, 16·16·16 + 1 exchange
    (2 ** 16, 4, True, False, (1, 4)),   # cluster at N/2: 16 lines of 2^11, 16·16·8 + 1
    (2 ** 18, 2, False, False, (2, 4)),  # two-pass kernels: 512 x 512, 16·16·2 each, 2 + 2
    (2 ** 16, 2, True, False, (3, 2)),    # real two-pass: 256 x 128 at N/2, 16·16 and 16·8
])
def test_row_cost_counts_the_kernels_shared_memory_passes(n, radix, real, inverse, cost):
    assert _row_cost(n, radix, real, inverse) == cost


@pytest.mark.parametrize("kind,shape,radix,passes", [
    ("fft2d", (512, 128, 128), 2, 3),   # fft2_fused r2: the frame passes, 16·8 each way
    ("fft2d", (512, 128, 128), 4, 3),   # the same passes at radix 4
    ("rfft2d", (512, 128, 128), 4, 3),  # rfft2_fused r4: 16·4 rows, 16·8 columns
    ("rfft2d", (512, 128, 128), 2, (3, 3)),  # r2: rfft2_fused's and irfft2_fused's frame passes
])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_whole_frames_are_priced_by_the_passes_that_run(kind, shape, radix, passes, direction):
    """ESTIMATE prices a whole frame by its kernel's shared-memory passes:
    the register passes' exchanges, which ``fft2_fused``, ``rfft2_fused``
    and ``irfft2_fused`` run at both radices (``passes`` a pair: forward,
    inverse); one HBM trip, one launch."""
    from repro_torch.launch.roofline import HBM_BW, SMEM_BW
    from repro_torch.plan import autotune

    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype="complex64" if kind == "fft2d" else "float32", direction=direction)
    real = kind == "rfft2d"
    if isinstance(passes, tuple):
        passes = passes[direction == "inv"]
    assert autotune._frame_passes(*shape[-2:], radix, real, direction == "inv") == passes
    elems = float(np.prod(shape)) * (0.5 if real else 1.0)
    want = (max(16.0 * elems / HBM_BW, 16.0 * elems * passes / SMEM_BW)
            + autotune._KERNEL_LAUNCH_S + passes * 1e-6)
    assert autotune._fused_cuda_time(key, radix, 1e-6) == pytest.approx(want, rel=1e-12)


# Keys with rows over one block (2^14 < N <= 2^18): 1D rows and strip frames.
LONG_ROW_KEYS = [("fft1d", (64, 2 ** 18), "complex64"), ("fft1d", (4, 2 ** 15), "complex64"),
                 ("rfft1d", (256, 2 ** 16), "float32"), ("rfft1d", (2, 2 ** 18), "float32"),
                 ("rfft2d", (8, 512, 32768), "float32"), ("fft2d", (2, 8, 2 ** 17), "complex64")]


@pytest.mark.parametrize("kind,shape,dtype", LONG_ROW_KEYS)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_long_rows_on_the_card_plan_the_cluster_kernel_at_one_round_trip(
        monkeypatch, kind, shape, dtype, direction):
    """Rows over one block plan ``fused_r4``, whose cluster kernel moves a
    row through HBM once; where the card reports no active cluster for an
    instance the key launches, the same key plans ``fused`` (the two-pass
    kernels) before any launch."""
    from repro_torch.kernels import fft_radix2

    asked = []

    def occupancy(active):
        def report(m, kind="fft"):
            asked.append((m, kind))
            return active
        return report

    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape, dtype=dtype,
                     direction=direction)
    monkeypatch.setattr(fft_radix2, "cluster_occupancy", occupancy(4))
    assert estimate_plan(key).variant == "fused_r4"
    real = kind.startswith("r")
    n = shape[-1]
    trips, _ = _row_cost(n, 4, real, direction == "inv")
    assert trips == 1
    assert _row_cost(n, 2, real, direction == "inv")[0] == (3 if real else 2)
    want = ("irfft" if direction == "inv" else "rfft") if real else "fft"
    assert (n // 2 if real else n, want) in asked
    monkeypatch.setattr(fft_radix2, "cluster_occupancy", occupancy(0))
    assert variant_candidates(key) == ("fused",)
    assert estimate_plan(key).variant == "fused"


def test_cluster_gate_asks_nothing_of_a_cpu_key_or_a_one_block_row(monkeypatch):
    from repro_torch.kernels import fft_radix2

    monkeypatch.setattr(fft_radix2, "cluster_occupancy", lambda *a, **kw: 0)
    cpu = ProblemKey(kind="fft1d", backend="cpu", device_kind="cpu", shape=(2, 2 ** 18),
                     dtype="complex64")
    assert "fused_r4" in variant_candidates(cpu)
    for shape in ((8192, 2048), (4, 2 ** 14)):
        card = ProblemKey(kind="fft1d", backend="cuda", device_kind=H100, shape=shape,
                          dtype="complex64")
        assert estimate_plan(card).variant == "fused_r4"
    frames = ProblemKey(kind="rfft2d", backend="cuda", device_kind=H100,
                        shape=(512, 128, 128), dtype="float32")
    assert estimate_plan(frames).variant == "fused_r4"


def test_no_active_cluster_keeps_the_over_2_24_wording(monkeypatch):
    from repro_torch.kernels import fft_radix2

    monkeypatch.setattr(fft_radix2, "cluster_occupancy", lambda *a, **kw: 0)
    key = ProblemKey(kind="fft1d", backend="cuda", device_kind=H100, shape=(4, 2 ** 19),
                     dtype="complex64")
    assert "fused" in variant_candidates(key)  # no cluster: the two passes
    key = ProblemKey(kind="fft1d", backend="cuda", device_kind=H100, shape=(4, 2 ** 25),
                     dtype="complex64")
    with pytest.raises(NotImplementedError,
                       match=r"its rows exceed the fused kernels' envelope \(2\^24 values"):
        variant_candidates(key)


@pytest.mark.parametrize("kind,shape", [("fft1d", (1, 2)), ("fft1d", (3, 8)),
                                        ("fft1d", (2, 16)), ("fft2d", (1, 2, 4)),
                                        ("rfft1d", (1, 4)), ("rfft2d", (1, 2, 2))])
def test_tiny_transforms_on_the_card_plan_onto_a_kernel(kind, shape):
    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype="complex64")
    assert set(variant_candidates(key)) == {"fused", "fused_r4"}
    assert estimate_plan(key).variant in ("fused", "fused_r4")


# Every card key this file plans, with the engine ESTIMATE gives it. The
# radix-2 fft_fused and rfft_fused run the radix-4 kernels' register passes
# (the same exchanges), so on one-block rows the model times the two
# engines alike; ESTIMATE then ranks the engine of fewer operations first
# (``flop_scale``), and fused_r4 keeps every key it had. The 2-point half
# row and the 2x2 real frame were ties before as well (both kernels do the
# same work there) and went to ``fused`` by registry order; they now go to
# fused_r4 too. Whole complex frames tie as well since the radix-2
# fft2_fused runs the radix-4 kernel's frame passes (the same exchanges),
# and so do the inverse real rows and the real frames since the radix-2
# irfft_fused, rfft2_fused and irfft2_fused run theirs, and the composed
# frames whose rows fit one block since the radix-2 fft2_columns runs the
# radix-4 column panel's passes.
CARD_KEYS = sorted(set(SMOKE_KEYS) | set(LONG_ROW_KEYS) | {
    ("fft1d", (1, 2), "complex64"), ("fft1d", (3, 8), "complex64"),
    ("fft1d", (2, 16), "complex64"), ("fft2d", (1, 2, 4), "complex64"),
    ("rfft1d", (1, 4), "complex64"), ("rfft2d", (1, 2, 2), "complex64"),
    ("fft1d", (4, 2 ** 14), "complex64")})
TIES = {("fft1d", (8192, 2048), "complex64"), ("rfft1d", (8192, 2048), "float32"),
        ("fft1d", (1, 2), "complex64"), ("fft1d", (3, 8), "complex64"),
        ("fft1d", (2, 16), "complex64"), ("rfft1d", (1, 4), "complex64"),
        ("fft1d", (4, 2 ** 14), "complex64"), ("rfft2d", (1, 2, 2), "complex64"),
        ("fft2d", (512, 128, 128), "complex64"), ("fft2d", (1, 2, 4), "complex64"),
        ("rfft2d", (512, 128, 128), "float32"), ("fft2d", (16, 1024, 1024), "complex64"),
        ("rfft2d", (32, 512, 512), "float32")}


@pytest.mark.parametrize("kind,shape,dtype", CARD_KEYS)
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_estimate_keeps_each_keys_engine(kind, shape, dtype, direction):
    from repro_torch.plan.autotune import estimate_variant_time

    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype=dtype, direction=direction)
    assert estimate_plan(key).variant == "fused_r4"
    # ties: the one-block rows, the whole frames and the composed frames of
    # one-block rows, which run the same register passes at both radices
    tie = (kind, shape, dtype) in TIES
    times = [estimate_variant_time(key, v) for v in ("fused", "fused_r4")]
    assert (times[0] == times[1]) == tie, times


def test_radix4_panel_wins_where_radix2_is_bound_by_shared_memory():
    key = ProblemKey(kind="fft2d", backend="cuda", device_kind=H100,
                     shape=(512, 128, 128), dtype="complex64")
    assert estimate_plan(key).variant == "fused_r4"


@pytest.mark.parametrize("kind,n", [("fft1d", 2 ** 25), ("rfft1d", 2 ** 25), ("fft2d", 2 ** 25)])
def test_rows_over_one_block_exclude_the_kernels(kind, n):
    """Rows past the card's fused envelope (2^24; rows between one block
    and 2^24 take the cluster or the two-pass kernels)."""
    shape = (4, n) if kind != "fft2d" else (2, n)
    key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                     dtype="complex64")
    with pytest.raises(NotImplementedError, match="backend='torch'"):
        variant_candidates(key)
    scoped = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                        dtype="complex64", backends=("torch",))
    names = variant_candidates(scoped)
    assert "fused" not in names and "fused_r4" not in names
    assert "stockham" in names


def test_scoped_backend_restricts_candidates():
    with xfft.config(backend="torch"):
        plan = resolve_call("fft2d", (4, 64, 64), torch.device("cpu"), cache=PlanCache())
    assert plan.variant in ("looped", "stockham", "radix4")
    assert plan.key.backends == ("torch",)


def test_resolve_call_caches_estimates_and_never_forced_plans():
    cache = PlanCache()
    cpu = torch.device("cpu")
    first = resolve_call("fft1d", (8, 64), cpu, cache=cache)
    assert resolve_call("fft1d", (8, 64), cpu, cache=cache) == first
    assert (cache.hits, cache.misses) == (1, 1)
    other = "fused" if first.variant != "fused" else "stockham"
    with xfft.config(variant=other):
        forced = resolve_call("fft1d", (8, 64), cpu, cache=cache)
    assert forced.variant == other and forced.mode == "forced"
    assert cache.get(first.key).variant == first.variant


def test_measure_and_double_are_not_ported_yet():
    """MEASURE is ported: ``xfft.config(mode="measure")`` scopes the mode
    (and restores the outer one), an unknown mode raises, and
    ``resolve_call`` under the scope times the candidates of a cache miss.
    Double precision is ported (the reference_x64 engine): the config
    accepts it, and a single-precision scope refuses to force the double
    engine, as the reference's does."""
    with xfft.config(mode="measure"):
        assert xfft.get_config().mode == "measure"
        plan = resolve_call("fft1d", (8, 64), torch.device("cpu"), cache=PlanCache())
        assert plan.mode == "measure" and plan.measured_us > 0
        with xfft.config(mode="estimate"):
            assert xfft.get_config().mode == "estimate"
        assert xfft.get_config().mode == "measure"
    assert xfft.get_config().mode == "estimate"
    with pytest.raises(ValueError, match="mode must be"):
        xfft.config(mode="exhaustive")
    with xfft.config(mode="estimate", precision="single"):
        assert xfft.get_config() == xfft.XFFTConfig()
    with xfft.config(precision="double"):
        assert xfft.get_config().precision == "double"
    with pytest.raises(ValueError, match="cannot serve precision"):
        xfft.config(variant="reference_x64")


def test_unrolled_names_the_looped_engine_and_is_ranked_once():
    assert has_engine("unrolled") and get_engine("unrolled") is get_engine("looped")
    assert "unrolled" not in [s.name for s in iter_engines()]
    with xfft.config(variant="unrolled"):
        plan = resolve_call("fft1d", (2, 8), torch.device("cpu"), cache=PlanCache())
    assert plan.variant == "unrolled" and plan.mode == "forced"


def test_cache_keys_match_reference():
    fields = dict(kind="rfft2d", backend="cpu", device_kind="cpu", shape=(3, 16, 32),
                  dtype="float32", direction="inv")
    assert ProblemKey(**fields).cache_key() == jplan.ProblemKey(**fields).cache_key()


def test_cache_key_built_once_is_the_keys_own():
    """The key string is built once a key and reused; a key made by
    ``dataclasses.replace`` builds its own, and equality, hashing and the
    dict form see only the fields."""
    import dataclasses

    fields = dict(kind="fft2d", backend="cpu", device_kind="cpu", shape=(4, 64, 64),
                  dtype="complex64", direction="fwd")
    key = ProblemKey(**fields)
    first = key.cache_key()
    assert key.cache_key() is first
    assert first == jplan.ProblemKey(**fields).cache_key()
    wide = dataclasses.replace(key, precision="double")
    assert wide.cache_key() == jplan.ProblemKey(**fields, precision="double").cache_key()
    assert wide.cache_key() != first and key.cache_key() is first
    fresh = ProblemKey(**fields)
    assert fresh == key and hash(fresh) == hash(key)
    assert "_cache_key" not in key.to_dict() and ProblemKey.from_dict(key.to_dict()) == key


def _jax_keys():
    return [
        jplan.ProblemKey(kind=kind, backend="cpu", device_kind="cpu", shape=shape,
                         dtype=dtype, direction=direction)
        for kind, shape, dtype in [("fft2d", (4, 64, 64), "complex64"),
                                   ("fft1d", (2, 8), "complex64"),
                                   ("rfft2d", (2, 256, 256), "float32"),
                                   ("rfft1d", (16, 1024), "float32")]
        for direction in ("fwd", "inv")
    ]


def test_wisdom_written_by_reference_loads_in_port(tmp_path):
    path = str(tmp_path / "wisdom.json")
    ref = jcache.PlanCache()
    for key in _jax_keys():
        ref.put(jautotune.estimate_plan(key))
    ref.save(path)
    port = PlanCache(path)
    assert len(port) == len(ref)
    assert [(k, p.variant) for k, p in port.entries()] == \
        [(k, p.variant) for k, p in ref.entries()]


def test_wisdom_written_by_port_loads_in_reference(tmp_path):
    path = str(tmp_path / "wisdom.json")
    port = PlanCache()
    for key in _jax_keys():
        port.put(estimate_plan(ProblemKey.from_dict(key.to_dict())))
    port.put(estimate_plan(ProblemKey(kind="fft2d", backend="cuda", device_kind=H100,
                                      shape=(512, 128, 128), dtype="complex64")))
    port.save(path)
    assert [p.name for p in tmp_path.iterdir()] == ["wisdom.json"]  # no temp file left
    with open(path) as f:
        assert json.load(f)["plan_schema_version"] == 5
    ref = jcache.PlanCache()
    report = ref.load(path)
    assert report.kept == len(port) and report.dropped == 0
    assert [(k, p.variant) for k, p in ref.entries()] == \
        [(k, p.variant) for k, p in port.entries()]


def test_engines_the_port_lacks_are_dropped_and_counted(tmp_path):
    """The port now registers every engine of the reference's registry, so
    the engine it lacks is one registered in the reference for this test."""
    path = str(tmp_path / "wisdom.json")
    ref = jcache.PlanCache()
    key = jplan.ProblemKey(kind="fft1d", backend="cpu", device_kind="cpu", shape=(2, 8),
                           dtype="complex64")
    ref.put(jplan.FFTPlan(key=key, variant="stockham"))
    jregistry.register_engine(jregistry.EngineSpec(name="reference_only", backend="xla",
                                                   kinds=("fft1d",)))
    try:
        ref.put(jplan.FFTPlan(key=jplan.ProblemKey(kind="fft1d", backend="cpu",
                                                   device_kind="cpu", shape=(2, 16),
                                                   dtype="complex64"),
                              variant="reference_only"))
        ref.save(path)
    finally:
        jregistry.unregister_engine("reference_only")
    port = PlanCache()
    report = port.load(path)
    assert (report.kept, report.malformed) == (1, 1)
    assert port.get(ProblemKey.from_dict(key.to_dict())).variant == "stockham"
    assert not os.path.exists(path + ".tmp")


def test_plan_round_trips_through_dict():
    plan = estimate_plan(ProblemKey(kind="fft1d", backend="cuda", device_kind=H100,
                                    shape=(8192, 2048), dtype="complex64"))
    assert FFTPlan.from_dict(plan.to_dict()) == plan
