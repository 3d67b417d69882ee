"""The sLSTM scan's backward on the CPU: ``slstm_scan_bwd_plain``,
``SlstmScan`` and ``csrc/slstm_scan_bwd.cu`` run through ``tools/cuda_emu``.

* The plain reverse recurrence against ``torch.autograd.grad`` of
  ``slstm_scan_plain`` (float32, 1e-6 of each gradient's largest value)
  and of the step loop in float64 (1e-12): with m0 = -inf and -1e30,
  cotangents on hs and on all four final states, and a tie of
  max(log f + m, i) forced at the first step (half the gradient each way).
* ``SlstmScan``'s gradients of every input against ``jax.vjp`` of the
  reference's own ``lax.scan`` over ``repro.models.xlstm._slstm_step``, on
  the same seeded numpy inputs (1e-5); ``gradcheck`` in float64, where it
  runs the plain forward and backward.
* The kernel compiled with g++ against the emulator's headers and run
  through its C entry at geometries ``slstm_bwd_grid`` computes for a card
  of a few SMs: its rows of wr in shared memory in double, in float32 and
  read from device memory (the last two forced by a small shared-memory
  limit, with batch groups), head widths that are not a multiple of 4
  (a CTA whose units straddle two heads), and a last CTA owning fewer
  units; each in the card's build and in one without the threads' fixed
  load slots (``REPRO_SLSTM_SLOTS=0``), where every load of the gate
  gradients takes the general path. The saving forward's gates and states are held to the plain
  forward's and the backward, on them, to the plain backward, both at
  1e-5 (float32 sums over a few dozen serial steps in another order).
* ``slstm_bwd_grid``'s arithmetic.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jx
from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, reset_launches
from repro_torch.kernels.slstm_scan import (
    ROUTES,
    SMEM_LIMIT,
    THREADS,
    SlstmScan,
    _scan_saving_plain,
    slstm_bwd_grid,
    slstm_grid,
    slstm_scan,
    slstm_scan_bwd,
    slstm_scan_bwd_plain,
    slstm_scan_plain,
    slstm_scan_saving,
    slstm_step,
)

EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
TOL_F32 = 1e-6
TOL_F64 = 1e-12
TOL_REF = 1e-5
TOL_EMU = 1e-5
NAMES = ("xg", "wr", "bias", "c0", "n0", "h0", "m0")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else float(np.abs(got).max())


def _inputs(b, l, d, m0, seed):
    """Seeded numpy inputs (float32) and cotangents of hs and the final
    (c, n, h, m): recurrent weights at the scale that keeps the recurrence
    from amplifying a rounding over L steps."""
    rng = np.random.default_rng(seed)
    f = np.float32
    ins = {"xg": rng.standard_normal((b, l, 4 * d)) * 0.5,
           "wr": rng.standard_normal((4, d // 4, d)) * 0.5 / np.sqrt(d // 4),
           "bias": rng.standard_normal(4 * d) * 0.1,
           "c0": rng.standard_normal((b, d)) * 0.1,
           "n0": np.abs(rng.standard_normal((b, d))),
           "h0": rng.standard_normal((b, d)) * 0.1,
           "m0": np.full((b, d), m0)}
    cots = [rng.standard_normal((b, l, d))] + [rng.standard_normal((b, d)) for _ in range(4)]
    return {n: x.astype(f) for n, x in ins.items()}, [x.astype(f) for x in cots]


def _tied(b, l, d, seed):
    """Inputs where log f + m0 == i at step 0 for every odd unit: h0 = 0
    and bias 0 leave the gates at xg, f = 100 makes log f = -3.7e-44,
    which leaves m0 = 0.5 as it is, and i = 0.5."""
    ins, cots = _inputs(b, l, d, 0.0, seed)
    ins["h0"][:] = 0.0
    ins["bias"][:] = 0.0
    ins["m0"][:, 1::2] = 0.5
    ins["xg"][:, 0, d + 1:2 * d:2] = 100.0
    ins["xg"][:, 0, 1:d:2] = 0.5
    return ins, cots


def _loop(xg, wr, bias, c0, n0, h0, m0):
    """slstm_step over L in the inputs' dtype: (hs, c, n, h, m)."""
    d = xg.shape[-1] // 4
    s = {"c": c0, "n": n0, "h": h0, "m": m0}
    hs = []
    for t in range(xg.shape[1]):
        s = slstm_step({"wr": wr, "bias": bias}, s, xg[:, t], d)
        hs.append(s["h"])
    return torch.stack(hs, dim=1), s["c"], s["n"], s["h"], s["m"]


def _autograd(fn, ins, cots, dtype):
    xs = [torch.from_numpy(ins[n]).to(dtype).requires_grad_() for n in NAMES]
    out = fn(*xs)
    out = (out[0], *out[1]) if isinstance(out[1], tuple) else out
    return torch.autograd.grad(out, xs, [torch.from_numpy(c).to(dtype) for c in cots])


def _plain_bwd(ins, cots, dtype):
    """slstm_scan_bwd_plain on the plain forward's saved gates and states,
    with dwr and dbias as SlstmScan forms them: gradients of NAMES."""
    x = {n: torch.from_numpy(v).to(dtype) for n, v in ins.items()}
    hs, _, saved = _scan_saving_plain(*(x[n] for n in NAMES))
    cot = [torch.from_numpy(c).to(dtype) for c in cots]
    dxg, (dc0, dn0, dh0, dm0) = slstm_scan_bwd_plain(saved, x["wr"], x["c0"], x["n0"],
                                                     x["m0"], cot[0], tuple(cot[1:]))
    from repro_torch.kernels.slstm_scan import _dwr
    return dxg, _dwr(hs, x["h0"], dxg), dxg.sum(dim=(0, 1)), dc0, dn0, dh0, dm0


M0S = pytest.mark.parametrize("m0", [float("-inf"), -1e30, 0.3], ids=["m0=-inf", "m0=-1e30",
                                                                     "m0=0.3"])


@M0S
@pytest.mark.parametrize("b,l,d", [(3, 32, 64), (2, 64, 128), (1, 5, 16)])
def test_plain_backward_matches_autograd_float32(b, l, d, m0):
    ins, cots = _inputs(b, l, d, m0, seed=b * 1000 + l + d)
    ref = _autograd(slstm_scan_plain, ins, cots, torch.float32)
    got = _plain_bwd(ins, cots, torch.float32)
    for name, g, r in zip(NAMES, got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= TOL_F32, name


@M0S
@pytest.mark.parametrize("b,l,d", [(3, 32, 64), (2, 17, 36)])
def test_plain_backward_matches_autograd_float64(b, l, d, m0):
    ins, cots = _inputs(b, l, d, m0, seed=b * 1000 + l + d)
    ref = _autograd(_loop, ins, cots, torch.float64)
    got = _plain_bwd(ins, cots, torch.float64)
    for name, g, r in zip(NAMES, got, ref):
        assert _rel(g, r) <= TOL_F64, name


def test_minus_inf_stabiliser_gives_finite_gradients_and_no_dm0():
    ins, cots = _inputs(2, 8, 16, float("-inf"), seed=3)
    got = _plain_bwd(ins, cots, torch.float32)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert not got[NAMES.index("m0")].any()
    assert not got[NAMES.index("c0")].any() and not got[NAMES.index("n0")].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_F32), (torch.float64, TOL_F64)],
                         ids=["float32", "float64"])
def test_a_tie_of_the_max_splits_the_gradient_in_half(dtype, tol):
    b, l, d = 2, 6, 16
    ins, cots = _tied(b, l, d, seed=5)
    x = {n: torch.from_numpy(v).to(dtype) for n, v in ins.items()}
    gates = x["xg"][:, 0]
    a = torch.nn.functional.logsigmoid(gates[:, d:2 * d]) + x["m0"]
    tie = a == gates[:, :d]
    assert tie[:, 1::2].all() and not tie[:, 0::2].any()
    ref = _autograd(_loop if dtype == torch.float64 else slstm_scan_plain, ins, cots, dtype)
    got = _plain_bwd(ins, cots, dtype)
    for name, g, r in zip(NAMES, got, ref):
        assert _rel(g, r) <= tol, name
    # the tied units' m0 takes half of what reaches the max, i the other half
    assert got[NAMES.index("m0")][:, 1::2].abs().min() > 0


def _reference_vjp(ins, cots):
    """jax.vjp of the reference's lax.scan over _slstm_step, as its
    slstm_apply runs it."""
    d = ins["xg"].shape[-1] // 4

    def scan(xg, wr, bias, c0, n0, h0, m0):
        p = {"wr": wr, "bias": bias}

        def step(s, x_t):
            s2 = jx._slstm_step(p, s, x_t, d)
            return s2, s2["h"]

        s, hs = jax.lax.scan(step, {"c": c0, "n": n0, "h": h0, "m": m0},
                             jnp.moveaxis(xg, 0, 1))
        return jnp.moveaxis(hs, 0, 1), s["c"], s["n"], s["h"], s["m"]

    _, vjp = jax.vjp(scan, *(jnp.asarray(ins[n]) for n in NAMES))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cots))]


@pytest.mark.parametrize("m0", [float("-inf"), -1e30, 0.3], ids=["m0=-inf", "m0=-1e30", "m0=0.3"])
def test_slstm_scan_function_matches_the_reference_vjp(m0):
    b, l, d = 3, 24, 64
    ins, cots = _inputs(b, l, d, m0, seed=11)
    ref = _reference_vjp(ins, cots)
    xs = [torch.from_numpy(ins[n]).requires_grad_() for n in NAMES]
    out = SlstmScan.apply(*xs)
    got = torch.autograd.grad(out, xs, [torch.from_numpy(c) for c in cots])
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == torch.float32, name
        assert _rel(g, r) <= TOL_REF, name


def test_slstm_scan_function_passes_gradcheck_in_float64():
    b, l, d = 2, 4, 8
    ins, _ = _inputs(b, l, d, 0.0, seed=2)
    xs = [torch.from_numpy(ins[n]).double().requires_grad_() for n in NAMES]
    assert torch.autograd.gradcheck(SlstmScan.apply, xs)


def test_cpu_scan_keeps_the_plain_autograd_and_launches_nothing():
    ins, _ = _inputs(2, 4, 16, float("-inf"), seed=1)
    xs = [torch.from_numpy(ins[n]).requires_grad_() for n in NAMES]
    reset_launches()
    hs, final = slstm_scan(*xs)
    assert type(hs.grad_fn).__name__ != "SlstmScanBackward"
    hs.sum().backward()
    assert not any(LAUNCHES.values())


def test_saving_forward_returns_what_the_backward_reads():
    ins, _ = _inputs(2, 6, 16, 0.2, seed=4)
    x = [torch.from_numpy(ins[n]) for n in NAMES]
    hs, final, (gates, cs, ns, ms) = slstm_scan_saving(*x)
    ref_hs, ref_final = slstm_scan_plain(*x)
    assert torch.equal(hs, ref_hs)
    for got, ref in zip(final, ref_final):
        assert torch.equal(got, ref)
    assert gates.shape == (2, 6, 64) and cs.shape == ns.shape == ms.shape == (2, 6, 16)
    assert torch.equal(cs[:, -1], final[0]) and torch.equal(ms[:, -1], final[3])


def test_backward_entry_checks_its_input():
    ins, cots = _inputs(2, 4, 16, 0.0, seed=0)
    x = [torch.from_numpy(ins[n]) for n in NAMES]
    _, _, saved = slstm_scan_saving(*x)
    cot = [torch.from_numpy(c) for c in cots]
    with pytest.raises(ValueError, match="dhs"):
        slstm_scan_bwd(saved, x[1], x[3], x[4], x[6], cot[0][:, :3], tuple(cot[1:]))
    with pytest.raises(ValueError, match="wr"):
        slstm_scan_bwd(saved, x[1][:, :2], x[3], x[4], x[6], cot[0], tuple(cot[1:]))


# --- csrc/slstm_scan_bwd.cu through tools/cuda_emu --------------------------

@pytest.fixture(scope="module", params=[(), ("REPRO_SLSTM_SLOTS=0",)], ids=["slots", "no-slots"])
def lib(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    so = emulate.compile_library(tmp_path_factory.mktemp("slstm_bwd_emu"),
                                 ("slstm_scan.cu", "slstm_scan_bwd.cu"), request.param)
    for name in ("repro_slstm_scan", "repro_slstm_scan_bwd"):
        fn = getattr(so, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return so


def _emu_forward(lib, grid, ins):
    b, l, d4 = ins["xg"].shape
    d = d4 // 4
    f = np.float32
    hs = np.full((b, l, d), np.nan, f)
    final = [np.full((b, d), np.nan, f) for _ in range(4)]
    saved = [np.full((b, l, d4), np.nan, f)] + [np.full((b, l, d), np.nan, f) for _ in range(3)]
    count = np.zeros(1, np.uint64)
    args = [np.ascontiguousarray(ins[n]) for n in NAMES] + [hs, *final, *saved, count]
    rc = lib.repro_slstm_scan(*(x.ctypes.data for x in args), b, l, d, grid.ctas, grid.units,
                              grid.threads, grid.rows, ROUTES.index(grid.route), grid.smem_bytes,
                              0, None)
    assert rc == 0, f"rc {rc}"
    return hs, saved


def _emu_backward(lib, grid, saved, ins, cots):
    b, l, d4 = saved[0].shape
    d = d4 // 4
    f = np.float32
    dxg = np.full((b, l, d4), np.nan, f)
    grads = [np.full((b, d), np.nan, f) for _ in range(4)]
    count = np.zeros(1, np.uint64)
    args = [*saved, ins["wr"], ins["c0"], ins["n0"], ins["m0"], *cots, dxg, *grads, count]
    rc = lib.repro_slstm_scan_bwd(*(np.ascontiguousarray(x).ctypes.data for x in args), b, l, d,
                                  grid.ctas, grid.units, grid.threads, grid.rows,
                                  ROUTES.index(grid.route), grid.smem_bytes, 0, None)
    assert rc == 0, f"rc {rc}"
    return dxg, grads, int(count[0])


INF = float("-inf")


@pytest.mark.parametrize("b,l,d,sms,smem_limit,route,span,m0", [
    (3, 16, 64, 4, SMEM_LIMIT, "smem_f64", 1, INF),    # 4 CTAs of 16 units, hd 16
    (3, 16, 64, 4, SMEM_LIMIT, "smem_f64", 1, -1e30),
    (2, 16, 36, 5, SMEM_LIMIT, "smem_f64", 2, INF),    # hd 9: units 8 straddle heads; the last CTA 4
    (3, 16, 64, 4, 8000, "smem_f32", 1, INF),          # a group of 2 rows, then 1
    (3, 12, 44, 4, 2100, "global", 1, -1e30),          # 11 units a CTA (odd); groups of 2 rows and 1
    (2, 10, 36, 5, 1500, "global", 2, INF),            # straddling heads from device memory; groups of 1
    (1, 8, 16, 5, SMEM_LIMIT, "smem_f64", 1, INF),     # 4 CTAs of 4 units from 5 SMs
], ids=["f64-b3-d64-m0=-inf", "f64-b3-d64-m0=-1e30", "f64-b2-d36", "f32-groups-b3-d64",
        "global-groups-b3-d44-m0=-1e30", "global-groups-b2-d36", "f64-b1-d16"])
def test_emulated_backward_matches_plain(lib, b, l, d, sms, smem_limit, route, span, m0):
    grid = slstm_bwd_grid(d, b, sms, smem_limit=smem_limit)
    fwd = slstm_grid(d, b, sms)
    assert grid.route == route and (grid.ctas, grid.units) == (fwd.ctas, fwd.units)
    if smem_limit < SMEM_LIMIT:
        assert grid.groups > 1
    hd = d // 4
    assert max((min(u + grid.units, d) - 1) // hd - u // hd + 1
               for u in range(0, d, grid.units)) == span
    ins, cots = _inputs(b, l, d, m0, seed=b * 100 + d)
    hs, saved = _emu_forward(lib, fwd, ins)
    x = {n: torch.from_numpy(v) for n, v in ins.items()}
    ref_hs, _, ref_saved = _scan_saving_plain(*(x[n] for n in NAMES))
    assert _rel(hs, ref_hs) <= TOL_EMU
    for name, got, ref in zip(("gates", "cs", "ns", "ms"), saved, ref_saved):
        assert _rel(got, ref) <= TOL_EMU, name
    dxg, grads, count = _emu_backward(lib, grid, saved, ins, cots)
    t = [torch.from_numpy(v) for v in saved]
    cot = [torch.from_numpy(c) for c in cots]
    ref_dxg, ref_grads = slstm_scan_bwd_plain(t, x["wr"], x["c0"], x["n0"], x["m0"], cot[0],
                                              tuple(cot[1:]))
    assert np.isfinite(dxg).all() and all(np.isfinite(g).all() for g in grads)
    assert _rel(dxg, ref_dxg) <= TOL_EMU
    for name, got, ref in zip(("dc0", "dn0", "dh0", "dm0"), grads, ref_grads):
        assert _rel(got, ref) <= TOL_EMU, name
    # one arrival of every CTA at each step's barrier, every group
    assert count == grid.ctas * grid.groups * l


def test_emulated_backward_of_a_tie_matches_plain(lib):
    b, l, d = 2, 6, 16
    ins, cots = _tied(b, l, d, seed=5)
    fwd, grid = slstm_grid(d, b, 4), slstm_bwd_grid(d, b, 4)
    _, saved = _emu_forward(lib, fwd, ins)
    dxg, grads, _ = _emu_backward(lib, grid, saved, ins, cots)
    x = {n: torch.from_numpy(v) for n, v in ins.items()}
    cot = [torch.from_numpy(c) for c in cots]
    ref_dxg, ref_grads = slstm_scan_bwd_plain([torch.from_numpy(v) for v in saved], x["wr"],
                                              x["c0"], x["n0"], x["m0"], cot[0], tuple(cot[1:]))
    assert _rel(dxg, ref_dxg) <= TOL_EMU
    for got, ref in zip(grads, ref_grads):
        assert _rel(got, ref) <= TOL_EMU
    assert np.abs(grads[3][:, 1::2]).min() > 0


def test_emulated_backward_refuses_a_geometry_the_grid_did_not_give(lib):
    b, l, d = 3, 4, 64
    ins, cots = _inputs(b, l, d, 0.0, seed=0)
    _, saved = _emu_forward(lib, slstm_grid(d, b, 4), ins)
    grid = slstm_bwd_grid(d, b, 4)
    for bad in (grid._replace(smem_bytes=grid.smem_bytes + 4), grid._replace(ctas=grid.ctas + 1),
                grid._replace(threads=grid.threads + 1), grid._replace(rows=4)):
        with pytest.raises(AssertionError, match="rc 1\n"):
            _emu_backward(lib, bad, saved, ins, cots)


# --- slstm_bwd_grid: the geometry's arithmetic, no compiler needed ---------

@pytest.mark.parametrize("d", [4, 36, 64, 1024, 2048, 4096])
@pytest.mark.parametrize("batch", [1, 4, 8, 64])
@pytest.mark.parametrize("sms", [132, 16])
def test_bwd_grid_shards_as_the_forward_and_fits(d, batch, sms):
    g, f = slstm_bwd_grid(d, batch, sms), slstm_grid(d, batch, sms)
    assert (g.ctas, g.units, g.threads) == (f.ctas, f.units, THREADS)
    assert g.rows * g.groups >= batch > g.rows * (g.groups - 1)
    assert g.smem_bytes <= SMEM_LIMIT


def test_bwd_grid_at_xlstm_350m():
    """D 1024 on an H100's 132 SMs: 128 CTAs of 8 units, each holding its 8
    rows of wr (D each) in double (64 KB) beside 8 batch rows of one head's
    gate gradients; at the training batch of 4, 4 rows."""
    g = slstm_bwd_grid(1024, 8, 132)
    assert (g.ctas, g.units, g.rows, g.groups, g.route) == (128, 8, 8, 1, "smem_f64")
    assert g.smem_bytes == 4 * (2 * 8 * 1028 + 8 * 1028 + 16 * 8 * 8 + 3 * 8 * 8)
    assert slstm_bwd_grid(1024, 4, 132).rows == 4
    assert slstm_bwd_grid(2048, 8, 132).route == "smem_f32"
    assert slstm_bwd_grid(4096, 8, 132).route == "global"
