"""Rows of 2^18 < N <= 2^24 on the card: fft_fused, rfft_fused and
irfft_fused on the two-pass kernels (``csrc/fft_two_pass.cu``) past the
reference's fused envelope (ROADMAP queue 3, divergence 1).

The reference plans its jnp schedules for such rows; a CUDA key of the port
plans ``fused`` / ``fused_r4``, whose wrappers run the two passes there (a
CPU key keeps the reference's envelope and plans as it does). Here, on the
CPU:

* the plain versions of the two passes at N = 2^19 and 2^20, every kind,
  against the reference's stockham schedules (``repro.core.fft1d`` and
  ``repro.core.rfft``, each under ``jax.jit``) and numpy in float64, at
  max|port - ref| <= 1e-5 * max|ref|; the wrappers on CPU tensors run them;
* the census of the new instances (n1, n2 = 1024, 2048, 4096), the exact
  twiddle exponents up to 2^24 and the C entries' rule (2^24 admitted,
  2^25 refused) through ``tools/cuda_emu``;
* ``csrc/fft_two_pass.cu`` through ``tools/cuda_emu`` at 2^19 (the column
  instance n1 = 1024) and 2^20 (the row instance n2 = 1024), within 2e-5 of
  the plain versions (the 2048- and 4096-line instances, at 16 s an
  emulated fft at 2^21 and 169 s at 2^24, are held by the numpy model of
  tests/test_torch_two_pass_regpass.py and on the card);
* the planner on CUDA keys up to 2^24 and past it, on CPU keys against the
  reference's, and the wrappers' launches on meta tensors.
"""

import ctypes
import functools
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fft1d import fft_impl, ifft_impl
from repro.core.rfft import irfft_impl, rfft_impl
from repro.plan import autotune as jautotune
from repro.plan import plan as jplan
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fft_radix2 as k
from repro_torch.plan import ProblemKey, estimate_plan
from repro_torch.plan.autotune import _row_cost, estimate_variant_time, variant_candidates

TOL = 1e-5
TOL_EMU = 2e-5
H100 = "NVIDIA H100 80GB HBM3"
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
LONG = [2 ** p for p in range(19, 25)]
PARITY = {2 ** 19: 2, 2 ** 20: 1}  # length: rows


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


@functools.lru_cache(maxsize=None)
def _inputs(n):
    rng = np.random.default_rng(n)
    b = PARITY[n]
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    r = rng.standard_normal((b, n)).astype(np.float32)
    h = (rng.standard_normal((b, n // 2 + 1))
         + 1j * rng.standard_normal((b, n // 2 + 1))).astype(np.complex64)  # not Hermitian
    return {"fft": x, "ifft": x, "rfft": r, "irfft": h}


@functools.lru_cache(maxsize=None)
def _reference(kind, n):
    """The reference's stockham schedule, jitted, on the kind's input."""
    fn = {"fft": fft_impl, "ifft": ifft_impl, "rfft": rfft_impl, "irfft": irfft_impl}[kind]
    return np.asarray(jax.jit(functools.partial(fn, variant="stockham"))(
        jnp.asarray(_inputs(n)[kind])))


PLAIN = {"fft": k.fft_two_pass_plain,
         "ifft": functools.partial(k.fft_two_pass_plain, inverse=True),
         "rfft": k.rfft_two_pass_plain, "irfft": k.irfft_two_pass_plain}
NUMPY = {"fft": np.fft.fft, "ifft": np.fft.ifft, "rfft": np.fft.rfft, "irfft": np.fft.irfft}
WRAPPER = {"fft": k.fft_fused, "ifft": functools.partial(k.fft_fused, inverse=True),
           "rfft": k.rfft_fused, "irfft": k.irfft_fused}


# ------------------------------- parity -------------------------------------


@pytest.mark.parametrize("n", list(PARITY))
@pytest.mark.parametrize("kind", list(PLAIN))
def test_plain_two_passes_match_the_references_schedules(kind, n):
    """The plain version of the two passes against the reference's stockham
    schedule on the same input and against numpy in float64; irfft on a half
    spectrum that is not Hermitian (both drop the imaginary parts at DC and
    Nyquist)."""
    a = _inputs(n)[kind]
    got = PLAIN[kind](torch.from_numpy(a)).numpy()
    _close(got, _reference(kind, n))
    wide = a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
    _close(got, NUMPY[kind](wide))


@pytest.mark.parametrize("kind", list(PLAIN))
def test_wrappers_serve_the_long_rows_on_cpu_tensors(kind):
    """On a CPU tensor the wrappers serve the card's envelope through the
    two passes' plain version, at both radices (the two passes run radix-2
    layers whatever the engine's radix)."""
    n = 2 ** 19
    a = torch.from_numpy(_inputs(n)[kind])
    want = PLAIN[kind](a)
    for radix in (2, 4):
        assert torch.equal(WRAPPER[kind](a, radix=radix), want), radix


# ------------------------------- census -------------------------------------


def test_census_gives_every_long_row_an_instance():
    """Every N = 2^19 ... 2^24 splits exactly into n2 <= n1 <= 2 n2, each
    pass within 1024 threads of 16 values and the shared-memory budget, with
    every HBM run at least one 32-byte sector: panels and tiles of 16 lines
    up to 1024 values, 8 of 2048 and 4 of 4096 (the C instances of
    fft_two_pass.cu)."""
    instances = set()
    for n in LONG:
        g = k.two_pass_geometry(n)
        assert g.n1 * g.n2 == n and g.n2 <= g.n1 <= 2 * g.n2 and (g.n1, g.n2) == k.fft_split(n)
        for lines, length, threads, smem in ((g.cols, g.n1, g.col_threads, g.col_smem),
                                             (g.rows, g.n2, g.row_threads, g.row_smem)):
            assert threads * k.ELEMS_PER_THREAD == lines * length <= 16 * k.MAX_THREADS
            assert smem <= k.SMEM_BUDGET_BYTES and lines * 8 >= 32
        assert g.row_smem == (g.rows * k.two_pass_row_stride(g.n2, g.rows)
                              + k.smem_slot(g.n2 // 2)) * 8
        assert k.fft_fits_card(n) and not k.fft_fits_fused(n)
        assert k.row_smem_bytes(n, fits=k.fft_fits_card) == max(g.col_smem, g.row_smem)
        instances |= {("columns", g.n1, g.cols), ("rows", g.n2, g.rows)}
    assert instances == {("columns", 1024, 16), ("columns", 2048, 8), ("columns", 4096, 4),
                         ("rows", 512, 16), ("rows", 1024, 16), ("rows", 2048, 8),
                         ("rows", 4096, 4)}
    assert [k.fft_split(n) for n in (2 ** 19, 2 ** 20, 2 ** 24)] == [
        (1024, 512), (1024, 1024), (4096, 4096)]
    assert not k.fft_fits_card(2 ** 25)
    # the tile's rows: odd S from 16 rows on, S - padded(n2) = 16/T under 16
    assert [k.two_pass_row_stride(n2, t) - k.smem_slot(n2)
            for n2, t in ((512, 16), (1024, 16), (2048, 8), (4096, 4))] == [1, 1, 2, 4]


def test_twiddle_exponents_are_exact_up_to_2_24():
    """The column pass's twiddle W_N^p, p = j2 k1 <= (n1 - 1)(n2 - 1), is
    sincospif(-p 2/N) on float32 operands: p is below 2^24, so exact, and
    2/N a power of two, so the product is exact too. At 2^25 the largest
    exponents pass 2^24 and odd ones round."""
    for n in (*LONG, 2 ** 25):
        n1, n2 = k.fft_split(n)
        top = (n1 - 1) * (n2 - 1)
        ps = np.array([1, n2 - 1, n1 - 1, top - 2, top - 1, top], dtype=np.int64)
        ps = ps[ps % 2 == 1] if n == 2 ** 25 else ps
        arg = -ps.astype(np.float32) * np.float32(2.0 / n)
        exact = bool(np.all(ps.astype(np.float32).astype(np.int64) == ps)
                     and np.all(arg.astype(np.float64) == -2.0 * ps / n))
        assert exact == (n <= 2 ** 24) == (top < 2 ** 24), n


# ------------------------------ the CUDA source -----------------------------


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    so = mod.compile_library(tmp_path_factory.mktemp("long_rows_emu"), ("fft_two_pass.cu",))
    for name in mod.TWO_PASS_ENTRIES:
        getattr(so, name).argtypes = list(_build._SIGNATURES[name])
        getattr(so, name).restype = ctypes.c_int
    return mod, so


@pytest.mark.parametrize("n,inverse", [(2 ** 19, 0), (2 ** 20, 1)])
def test_emulated_long_rows_match_plain(emulate, n, inverse):
    """fft at 2^19 (the column instance n1 = 1024 at 1024 threads, the row
    instance n2 = 512) and ifft at 2^20 (both 1024-line instances) through
    the C entries the wrapper launches, at the census's geometry, against
    the plain version."""
    mod, so = emulate
    x = _inputs(2 ** 19)["fft"][:1] if n == 2 ** 19 else _inputs(n)["fft"]
    y = np.full_like(x, np.nan)
    mod._two_pass(so, x, y, 1, n, inverse, 1.0 / n if inverse else 1.0)
    want = PLAIN["ifft" if inverse else "fft"](torch.from_numpy(x)).numpy()
    assert mod.rel(y, want) <= TOL_EMU


def test_emulated_entries_admit_2_24_and_refuse_2_25(emulate):
    """The C entries' rule: n1 n2 <= 2^24. At 4096 x 4096 both entries pass
    their value checks and find an instance, so a thread count off the
    census is what they refuse (9, invalid configuration); at 8192 x 4096
    they refuse the row itself (1, invalid value) before any geometry."""
    _, so = emulate
    g = k.two_pass_geometry(2 ** 24)
    x = np.zeros((1, 4), np.complex64)  # never read: every call here is refused
    ptrs = (x.ctypes.data, x.ctypes.data, 1)
    assert so.repro_two_pass_columns(*ptrs, 4096, 4096, g.cols, 2 * g.col_threads, g.col_smem,
                                     0, 0, None) == 9
    assert so.repro_two_pass_rows(*ptrs, 4096, 4096, g.rows, 2 * g.row_threads, g.row_smem, 0,
                                  1.0, 0, None) == 9
    assert so.repro_two_pass_columns(*ptrs, 8192, 4096, g.cols, g.col_threads, g.col_smem, 0,
                                     0, None) == 1
    assert so.repro_two_pass_rows(*ptrs, 8192, 4096, g.rows, g.row_threads, g.row_smem, 0,
                                  1.0, 0, None) == 1


# ------------------------------- planner ------------------------------------

KINDS = [("fft1d", (4, None), "complex64"), ("rfft1d", (2, None), "float32"),
         ("fft2d", (2, 8, None), "complex64"), ("fft2d", (None, 8), "complex64"),
         ("rfft2d", (None, 8), "float32"), ("rfft2d", (2, 4, None), "float32"),
         ("fft2d_stream", (2, 8, None), "complex64"), ("fft2d_pencil", (8, None), "complex64")]


def _key(kind, shape, dtype, n, backend="cuda", direction="fwd"):
    return ProblemKey(kind=kind, backend=backend, device_kind=H100 if backend == "cuda" else "cpu",
                      shape=tuple(n if d is None else d for d in shape), dtype=dtype,
                      direction=direction)


@pytest.mark.parametrize("kind,shape,dtype", KINDS)
def test_card_keys_plan_the_fused_engines_up_to_2_24(kind, shape, dtype):
    """A CUDA key whose transform dims are all <= 2^24 plans the fused
    engines (a real row counted by its N reals); past 2^24 it raises and
    names 2^24."""
    directions = ("fwd",) if kind == "fft2d_stream" else ("fwd", "inv")
    for n in LONG:
        for direction in directions:
            key = _key(kind, shape, dtype, n, direction=direction)
            assert set(variant_candidates(key)) == {"fused", "fused_r4"}, (n, direction)
    with pytest.raises(NotImplementedError, match=r"2\^24 values"):
        variant_candidates(_key(kind, shape, dtype, 2 ** 25))


@pytest.mark.parametrize("kind,shape,dtype", KINDS)
def test_cpu_keys_plan_as_the_reference_does(kind, shape, dtype):
    """A CPU key keeps the reference's envelope (2^18): no fused engine, and
    ESTIMATE picks the reference's schedule."""
    for n in (2 ** 19, 2 ** 24):
        key = _key(kind, shape, dtype, n, backend="cpu")
        names = variant_candidates(key)
        assert "fused" not in names and "fused_r4" not in names
        ref = jplan.ProblemKey(kind=kind, backend="cpu", device_kind="cpu", shape=key.shape,
                               dtype=dtype)
        assert estimate_plan(key).variant == jautotune.estimate_plan(ref).variant


def test_long_rows_are_priced_at_two_or_three_trips_and_the_engines_tie():
    """Past 2^18 both engines run the two passes: 2 HBM trips a complex row
    and 3 a real one, each pass's register-pass exchanges, the same price at
    both radices; the tie goes to ``fused_r4`` (fewer butterfly operations),
    which launches the same kernels. Up to 2^18 radix 4 stays the cluster's
    one trip."""
    for n in LONG:
        n1, n2 = k.fft_split(n)
        exchanges = k.regpass_exchanges(n1) + k.regpass_exchanges(n2)
        for radix in (2, 4):
            assert _row_cost(n, radix, False) == (2, exchanges), (n, radix)
            m1, m2 = k.fft_split(n // 2)
            assert _row_cost(n, radix, True) == (
                3, k.regpass_exchanges(m1) + k.regpass_exchanges(m2)), (n, radix)
        key = _key("fft1d", (4, None), "complex64", n)
        assert estimate_variant_time(key, "fused") == estimate_variant_time(key, "fused_r4")
        assert estimate_plan(key).variant == "fused_r4"
    assert _row_cost(2 ** 18, 4, False)[0] == 1
    assert ops.hbm_traffic_model(4, 2 ** 20, True) == 2 * ops.hbm_traffic_model(4, 2 ** 18, True) * 4
    assert ops.hbm_traffic_model(4, 2 ** 20, True, real=True) == 3 * 4 * 2 ** 20 * 8


@pytest.mark.parametrize("kind,n,want", [
    ("fft", 2 ** 24, ["columns", "rows"]),
    ("rfft", 2 ** 24, ["columns", "rows", "recombine"]),
    ("irfft", 2 ** 20, ["untangle", "columns", "rows"]),
])
@pytest.mark.parametrize("radix", [2, 4])
def test_wrappers_take_the_two_passes_past_2_18_on_meta_tensors(monkeypatch, kind, n, want,
                                                                 radix):
    """On a meta tensor the wrappers take the card route up to the launch:
    rows past 2^18 call the two passes' C entries at both radices, with the
    census's geometry, all charged to ``fft_two_pass``, and return the
    transform's shape."""
    calls = []
    monkeypatch.setattr(k, "_launch", lambda entry, name, x, *args: calls.append(
        (entry, name, args)))
    meta = torch.device("meta")
    if kind == "fft":
        out = k.fft_fused(torch.empty(2, n, dtype=torch.complex64, device=meta), radix=radix)
        assert out.shape == (2, n) and out.dtype == torch.complex64
    elif kind == "rfft":
        out = k.rfft_fused(torch.empty(2, n, device=meta), radix=radix)
        assert out.shape == (2, n // 2 + 1) and out.dtype == torch.complex64
    else:
        out = k.irfft_fused(torch.empty(2, n // 2 + 1, dtype=torch.complex64, device=meta),
                            radix=radix)
        assert out.shape == (2, n) and out.dtype == torch.float32
    assert [entry for entry, _, _ in calls] == [f"repro_two_pass_{w}" for w in want]
    assert {name for _, name, _ in calls} == {"fft_two_pass"}
    g = k.two_pass_geometry(n if kind == "fft" else n // 2)
    by_entry = {entry: args for entry, _, args in calls}
    assert by_entry["repro_two_pass_columns"][2:6] == (2, g.n1, g.n2, g.cols)
    assert by_entry["repro_two_pass_rows"][2:6] == (2, g.n1, g.n2, g.rows)


def test_composed_routes_past_2_18_on_meta_tensors(monkeypatch):
    """The 2D entries need no new route: a frame 2^19 wide runs its rows on
    the two passes, then ``fft2_columns``; a column of 2^19 takes the turn
    route onto the two passes (rfft2: the half spectra's 5 columns)."""
    names = []
    monkeypatch.setattr(k, "_launch", lambda entry, name, x, *args: names.append(name))
    meta = torch.device("meta")
    out = ops.fft2_kernel(torch.empty(2, 8, 2 ** 19, dtype=torch.complex64, device=meta))
    assert out.shape == (2, 8, 2 ** 19) and names == ["fft_two_pass"] * 2 + ["fft2_columns"]
    names.clear()
    out = ops.rfft2_kernel(torch.empty(2 ** 19, 8, device=meta), radix=4)
    assert out.shape == (2 ** 19, 5) and names == ["rfft_fused", "fft_two_pass", "fft_two_pass"]
