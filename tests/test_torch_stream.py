"""The ping-pong streaming processor and the ``fft2d_stream`` kind on the CPU.

``repro_torch.core.fft2d.fft2_stream`` is held to
``repro.core.fft2d.fft2_stream`` under the same explicit variant: the
schedules at unroll 1 and 2, and ``fused``/``fused_r4`` as the reference
runs them here (its Pallas kernels in interpret mode; the port's wrappers
take their plain versions on a CPU tensor). Inputs are made with numpy
from a seed; outputs are compared after dividing both by
max(1, max|reference|), at atol 2e-5. The planner is held to the
reference's ESTIMATE (variant and unroll) and MEASURE labels on CPU keys;
``reference_x64``'s stream to numpy in float64 at 1e-10 (the reference's
double engine needs ``jax.experimental.enable_x64``, which this jax lacks).
The two-stream schedule itself runs only on the card
(``tests/test_torch_kernels_cuda.py``); here its step order is checked on
the plain versions.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engines as jengines
from repro.engines import registry as jregistry
from repro.plan import autotune as jautotune
from repro.plan import plan as jplan
from repro_torch import engines, xfft
from repro_torch.engines import registry
from repro_torch.kernels import fft_radix2 as k
from repro_torch.kernels import ops
from repro_torch.plan import (
    FFTPlan,
    PlanCache,
    ProblemKey,
    default_cache,
    estimate_plan,
    execute,
    measure_plan,
    plan_fft,
    problem_key,
    reset_default_cache,
    variant_candidates,
)

# repro.core and repro_torch.core re-export functions named like their
# modules; take the modules.
jfft2d = importlib.import_module("repro.core.fft2d")
fft2d = importlib.import_module("repro_torch.core.fft2d")

CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"
ATOL = 2e-5
TOL_X64 = 1e-10
SCHEDULES = ("stockham", "radix4", "looped", "unrolled")
FUSED = ("fused", "fused_r4")
#: (name, shape, complex): the inputs of the parity tests.
INPUTS = {
    "frames": ((5, 16, 32), True),
    "one frame": ((1, 16, 32), True),
    "batch": ((4, 3, 16, 16), True),
    "real": ((5, 16, 32), False),
}
#: The reference's ESTIMATE on these keys: radix4, unroll 2 on the first
#: three, unroll 1 on the last two.
ESTIMATE_KEYS = ((4, 8, 8), (8, 128, 128), (16, 2, 128, 128), (8, 256, 256), (1, 64, 64))


@pytest.fixture(autouse=True)
def _fresh_cache():
    reset_default_cache()
    yield
    reset_default_cache()


@functools.lru_cache(maxsize=None)
def _input(name: str) -> np.ndarray:
    shape, cplx = INPUTS[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(variant: str, name: str) -> np.ndarray:
    """The reference's stream of input ``name`` (its scan unroll leaves the
    output as it is, so unroll 1 serves both)."""
    return np.asarray(jfft2d.fft2_stream(jnp.asarray(_input(name)), variant=variant, unroll=1))


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _stream(x, **kw):
    return fft2d.fft2_stream(torch.from_numpy(x), **kw)


# ------------------------------ parity ----------------------------------


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("variant", SCHEDULES + FUSED)
def test_stream_matches_reference(variant, unroll, name):
    got = _stream(_input(name), variant=variant, unroll=unroll)
    assert got.dtype == torch.complex64
    _close(got.numpy(), _reference(variant, name))


def test_stream_reference_drain_is_the_same_output():
    """The reference scans T + 1 steps over a zero drain frame and drops the
    first output; the port runs a drain step of columns alone: the same
    outputs, each the 2D FFT of its frame."""
    x = _input("frames")
    _close(_stream(x, variant="radix4", unroll=1).numpy(), np.fft.fft2(x.astype(np.complex128)))


# Mirrors tests/core/test_fft2d.py:28-70.


def test_stream_equals_per_frame(rng):
    frames = rng.standard_normal((7, 16, 32)).astype(np.float32)
    _close(_stream(frames).numpy(), np.fft.fft2(frames), atol=1e-5)


def test_stream_single_frame(rng):
    frames = rng.standard_normal((1, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(_stream(frames).numpy(), np.fft.fft2(frames), atol=1e-4)


def test_stream_batched_frames(rng):
    frames = rng.standard_normal((4, 2, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(_stream(frames).numpy(), np.fft.fft2(frames), atol=1e-4)


@pytest.mark.parametrize("unroll", [2, 4])
def test_stream_unrolled_scan_matches(rng, unroll):
    """The unroll (frames a step) leaves the output as it is, also where T
    is not a multiple of it."""
    frames = rng.standard_normal((7, 16, 16)).astype(np.float32)
    got = _stream(frames, unroll=unroll).numpy()
    _close(got, np.fft.fft2(frames), atol=1e-5)
    np.testing.assert_allclose(got, _stream(frames, unroll=1).numpy(), atol=1e-6)


def test_stream_auto_plan(rng):
    frames = rng.standard_normal((4, 8, 8)).astype(np.float32)
    got = _stream(frames, variant="auto", unroll="auto").numpy()
    np.testing.assert_allclose(got, np.fft.fft2(frames), atol=1e-4)
    plan = default_cache().get(problem_key("fft2d_stream", (4, 8, 8), CPU))
    assert plan is not None and plan.unroll >= 1


def test_fft2_stream_auto_matches_float64_oracle():
    """Mirrors tests/plan/test_plan_api.py:84."""
    frames = _input("frames")
    got = _stream(frames, variant="auto", unroll="auto").numpy()
    _close(got, np.fft.fft2(frames.astype(np.complex128)), atol=1e-5)


def test_stream_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match=r"\(T, H, W\)"):
        fft2d.fft2_stream(torch.zeros(8, 8))
    with pytest.raises(ValueError, match=r"\(T, H, W\)"):
        jfft2d.fft2_stream(jnp.zeros((8, 8)))
    with pytest.raises(ValueError, match="power of two"):
        fft2d.fft2_stream(torch.zeros(2, 8, 12), variant="stockham", unroll=1)
    with pytest.raises(ValueError, match="unroll"):
        fft2d.fft2_stream(torch.zeros(2, 8, 8), variant="stockham", unroll=0)


def test_numpy_frames_go_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fft2d.fft2_stream(np.zeros((2, 8, 8), np.complex64), variant="stockham", unroll=1)


# ------------------------- the schedule of the engines -------------------------


@pytest.mark.parametrize("t,unroll", [(5, 1), (5, 2), (4, 2), (1, 1), (3, 4)])
def test_fused_steps_interleave_as_the_ping_pong(monkeypatch, t, unroll):
    """Step k runs the rows of chunk k after the columns of chunk k - 1
    (engine 2 on what engine 1 wrote a step before), plus a drain step:
    ceil(T / u) row passes and as many column passes, each on u frames."""
    calls = []
    rows, cols = fft2d.stream_rows, fft2d.stream_columns

    def spy_rows(z, out, **kw):
        calls.append(("rows", z.shape[0]))
        return rows(z, out, **kw)

    def spy_cols(y, **kw):
        calls.append(("cols", y.shape[0]))
        return cols(y, **kw)

    monkeypatch.setattr(fft2d, "stream_rows", spy_rows)
    monkeypatch.setattr(fft2d, "stream_columns", spy_cols)
    x = np.random.default_rng(t).standard_normal((t, 2, 8, 16)).astype(np.complex64)
    got = _stream(x, variant="fused_r4", unroll=unroll)
    _close(got.numpy(), np.fft.fft2(x.astype(np.complex128)))
    steps = -(-t // unroll)
    sizes = [2 * min(unroll, t - s * unroll) for s in range(steps)]
    want = [("rows", sizes[0])]
    for s in range(1, steps):
        want += [("cols", sizes[s - 1]), ("rows", sizes[s])]
    want.append(("cols", sizes[-1]))
    assert calls == want


def test_stream_row_and_column_entries_match_numpy():
    """ops.stream_rows writes the row FFTs into the output slot it is given;
    ops.stream_columns transforms the columns in place, on fft2_columns or,
    for columns over 4096 values, the turn route copied back."""
    rng = np.random.default_rng(3)
    for shape in ((3, 16, 32), (1, 8192, 4)):
        x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        z = torch.from_numpy(x)
        out = torch.zeros_like(z)
        ops.stream_rows(z, out, radix=4)
        _close(out.numpy(), np.fft.fft(x.astype(np.complex128), axis=-1))
        before = out.data_ptr()
        ops.stream_columns(out, radix=4)
        assert out.data_ptr() == before
        _close(out.numpy(), np.fft.fft2(x.astype(np.complex128)))


def test_fft_fused_writes_out():
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((6, 64)) + 1j * rng.standard_normal((6, 64))
                          ).astype(np.complex64))
    big = torch.zeros(10, 64, dtype=torch.complex64)
    for radix in (2, 4):
        got = k.fft_fused(x, radix=radix, out=big[2:8])
        assert got.data_ptr() == big[2:8].data_ptr()
        _close(big[2:8].numpy(), np.fft.fft(x.numpy().astype(np.complex128)))
        assert not big[:2].any() and not big[8:].any()
    with pytest.raises(ValueError, match="out must match"):
        k.fft_fused(x, out=torch.zeros(6, 32, dtype=torch.complex64))
    with pytest.raises(ValueError, match="out must match"):
        k.fft_fused(x, out=torch.zeros(6, 64, dtype=torch.complex128))


# ------------------------------- planning --------------------------------


@pytest.mark.parametrize("shape", ESTIMATE_KEYS)
def test_estimate_gives_the_references_variant_and_unroll(shape):
    ref = jautotune.estimate_plan(jplan.problem_key("fft2d_stream", shape))
    got = estimate_plan(problem_key("fft2d_stream", shape, CPU))
    assert (got.variant, got.unroll) == (ref.variant, ref.unroll)
    assert got.unroll == (2 if shape[-1] * shape[-2] <= 128 * 128 and shape[0] >= 2 else 1)


def test_estimate_unroll_is_one_for_other_kinds():
    for kind, shape in (("fft2d", (8, 64, 64)), ("fft1d", (8, 64)), ("rfft2d", (8, 64, 64))):
        dtype = "float32" if kind.startswith("r") else "complex64"
        assert estimate_plan(problem_key(kind, shape, CPU, dtype=dtype)).unroll == 1


def test_measure_labels_are_the_references_less_its_unrolled_engine():
    """The reference times (variant, u) for u in (1, 2) on each jnp engine;
    the port's ``unrolled`` is an alias of ``looped``, timed once."""
    shape = (3, 8, 16)
    ref_t, got_t = {}, {}
    jautotune.measure_plan(jplan.problem_key("fft2d_stream", shape), iters=1,
                           timings_out=ref_t)
    plan = measure_plan(problem_key("fft2d_stream", shape, CPU), iters=1, timings_out=got_t)
    assert set(got_t) == {label for label in ref_t if not label.startswith("unrolled")}
    variant, _, u = min(got_t, key=got_t.get).partition("/unroll=")
    assert (plan.variant, plan.unroll) == (variant, int(u or 1))
    assert plan.measured_us == pytest.approx(min(got_t.values()))


def test_execute_dispatch_matches_direct_calls():
    """Mirrors tests/plan/test_plan_api.py:131 (its stream part; the
    pencil's run on a mesh is in tests/test_torch_distributed.py)."""
    cache = PlanCache()
    frames = np.random.default_rng(5).standard_normal((3, 16, 16)).astype(np.complex64)
    ps = plan_fft("fft2d_stream", (3, 16, 16), device=CPU, cache=cache)
    np.testing.assert_array_equal(
        execute(ps, torch.from_numpy(frames)).numpy(),
        _stream(frames, variant=ps.variant, unroll=ps.unroll).numpy())
    pm = plan_fft("fft2d_stream", (3, 16, 16), device=CPU, mode="measure", cache=cache,
                  measure_iters=1)
    assert pm.mode == "measure" and cache.get(pm.key) is pm
    _close(execute(pm, torch.from_numpy(frames)).numpy(),
           np.fft.fft2(frames.astype(np.complex128)))
    pencil = problem_key("fft2d_pencil", (64, 32), CPU, n_devices=8)
    with pytest.raises(ValueError, match="needs mesh="):  # the reference's message
        execute(FFTPlan(key=pencil, variant="stockham"), torch.zeros(64, 32))


def test_stream_candidates_keep_the_schedules_on_a_cpu_key():
    """Mirrors tests/plan/test_plan_variants.py:35-37, and divergence 6: no
    fused engine is a candidate for a CPU stream key, as in the reference,
    while a CUDA stream key plans the kernels, ``fused_r4`` among them."""
    cands = variant_candidates(problem_key("fft2d_stream", (4, 32, 32), CPU))
    assert "fused" not in cands and "fused_r4" not in cands and "radix4" in cands
    ref = jautotune.variant_candidates(jplan.problem_key("fft2d_stream", (4, 32, 32)))
    assert set(cands) == set(ref) - {"unrolled"}
    for shape in ((8, 128, 128), (64, 512, 512), (16, 16, 256, 256)):
        key = ProblemKey(kind="fft2d_stream", backend="cuda", device_kind=H100, shape=shape,
                         dtype="complex64")
        assert set(variant_candidates(key)) == {"fused", "fused_r4"}
        assert estimate_plan(key).variant == "fused_r4"
    scoped = ProblemKey(kind="fft2d_stream", backend="cuda", device_kind=H100,
                        shape=(8, 64, 64), dtype="complex64", backends=("torch",))
    assert set(variant_candidates(scoped)) == {"looped", "stockham", "radix4"}


def test_cuda_stream_key_is_priced_as_the_composed_route():
    """A stream never runs a frame in one block: on a CUDA key its fused
    price is the composed route's over every frame, plus two launches a
    step."""
    from repro_torch.plan.autotune import estimate_variant_time

    for shape in ((8, 128, 128), (16, 1024, 1024)):
        stream = ProblemKey(kind="fft2d_stream", backend="cuda", device_kind=H100,
                            shape=shape, dtype="complex64")
        frame = ProblemKey(kind="fft2d", backend="cuda", device_kind=H100, shape=shape,
                           dtype="complex64")
        for v in FUSED:
            assert estimate_variant_time(stream, v) > estimate_variant_time(frame, v)


# ------------------------------- double ----------------------------------


def test_reference_x64_stream_matches_numpy():
    frames = _input("frames").astype(np.complex128) * (1 + 1e-9j)
    want = np.fft.fft2(frames)
    for got in (fft2d.fft2_stream(torch.from_numpy(frames), variant="reference_x64"),
                engines.get_engine("reference_x64").op("fft2d_stream")(torch.from_numpy(frames))):
        assert got.dtype == torch.complex128
        assert np.abs(got.numpy() - want).max() <= TOL_X64 * np.abs(want).max()
    with xfft.config(precision="double"):
        got = fft2d.fft2_stream(torch.from_numpy(frames))
        plan = default_cache().get(problem_key("fft2d_stream", frames.shape, CPU,
                                               precision="double"))
    assert plan.variant == "reference_x64" and got.dtype == torch.complex128
    assert np.abs(got.numpy() - want).max() <= TOL_X64 * np.abs(want).max()


def test_stream_op_is_forward_only():
    for name in ("stockham", "fused_r4", "reference_x64"):
        spec = engines.get_engine(name)
        assert "fft2d_stream" in spec.kinds
        with pytest.raises(ValueError, match="no executor"):
            spec.op("fft2d_stream", "inv")


# Mirrors tests/engines/test_conformance.py:29, :42: every engine that
# declares the stream kind, forward only, through execute on a hand-built
# plan.


@pytest.mark.parametrize("name", [s.name for s in engines.iter_engines(kind="fft2d_stream")])
def test_conformance_stream_forward(name):
    spec = engines.get_engine(name)
    double = "double" in spec.precisions
    key = problem_key("fft2d_stream", (3, 8, 16), CPU,
                      precision="double" if double else "single")
    x = np.random.default_rng(6).standard_normal((3, 8, 16))
    x = (x + 1j * np.random.default_rng(7).standard_normal((3, 8, 16))).astype(
        np.complex128 if double else np.complex64)
    got = execute(FFTPlan(key=key, variant=name, precision=key.precision), torch.from_numpy(x))
    want = np.fft.fft2(x.astype(np.complex128))
    tol = TOL_X64 if double else 2e-3
    assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())


# ------------------------------- engines ----------------------------------


def _op_factory(kind, direction):
    from repro_torch.core.fft1d import fft_impl

    if kind == "fft1d" and direction == "fwd":
        return lambda x: fft_impl(x, variant="stockham")
    return None


def _jop_factory(kind, direction):
    from repro.core.fft1d import fft_impl

    if kind == "fft1d" and direction == "fwd":
        return lambda x: fft_impl(x, variant="stockham")
    return None


def test_engine_decorator_and_unregister_behave_as_the_references():
    for mod, cost, factory in ((registry, engines.CostHints, _op_factory),
                               (jregistry, jengines.CostHints, _jop_factory)):
        spec = mod.engine("plugin_stream_test", backend="plugin", kinds=("fft1d",),
                          cost=cost())(factory)
        try:
            assert mod.get_engine("plugin_stream_test") is spec and spec.ops is factory
            assert "plugin_stream_test" in mod.registered_variants()
            with pytest.raises(ValueError, match="already registered"):
                mod.engine("plugin_stream_test", backend="plugin", kinds=("fft1d",))(factory)
        finally:
            mod.unregister_engine("plugin_stream_test")
        assert not mod.has_engine("plugin_stream_test")
        mod.unregister_engine("plugin_stream_test")  # unknown: a no-op
        for builtin in ("stockham", "fused_r4"):
            with pytest.raises(ValueError, match="cannot be unregistered"):
                mod.unregister_engine(builtin)
            with pytest.raises(ValueError, match="cannot be replaced"):
                mod.register_engine(mod.get_engine(builtin), replace=True)
            assert mod.has_engine(builtin)
    with pytest.raises(ValueError, match="cannot be unregistered"):
        registry.unregister_engine("unrolled")  # the alias of a builtin


def test_apply_engine_matches_the_reference():
    x = np.random.default_rng(9).standard_normal((4, 16, 32)).astype(np.complex64)
    for kind, kw in (("fft1d", {"axis": 1}), ("fft1d", {}), ("fft2d", {}),
                     ("fft2d_stream", {})):
        got = engines.apply_engine("radix4", kind, torch.from_numpy(x), **kw).numpy()
        want = np.asarray(jengines.apply_engine("radix4", kind, jnp.asarray(x), **kw))
        _close(got, want)
    with pytest.raises(ValueError, match="unknown engine"):
        engines.apply_engine("no_such_engine", "fft1d", torch.from_numpy(x))


def test_apply_engine_serves_a_registered_engine_in_the_stream():
    """A variant outside the builtin schedules reaches the registry through
    apply_engine, as the reference's fft2_stream does."""
    seen = []

    def factory(kind, direction):
        if kind == "fft2d_stream":
            def run(frames):
                seen.append(tuple(frames.shape))
                return fft2d.fft2_stream(frames, variant="stockham", unroll=1)
            return run
        return None

    engines.engine("plugin_stream_only", backend="plugin", kinds=("fft2d_stream",))(factory)
    try:
        x = _input("frames")
        got = _stream(x, variant="plugin_stream_only", unroll=1)
        _close(got.numpy(), np.fft.fft2(x.astype(np.complex128)))
        assert seen == [x.shape]
    finally:
        engines.unregister_engine("plugin_stream_only")
