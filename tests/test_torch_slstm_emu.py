"""The CUDA sLSTM scan (``csrc/slstm_scan.cu``) run on the CPU, and the
arithmetic of its geometry.

``tools/cuda_emu`` compiles the ``.cu`` with g++ against stand-in CUDA
headers: one ``std::thread`` per CUDA thread, a cooperative launch that runs
all CTAs' threads at once, ``std::atomic`` under the grid barrier's release
add and acquire load, and the warp's double-precision mma on a barrier per
warp. The kernel then runs through its own C entry at geometries
:func:`slstm_grid` computes for a card of a few SMs: wr's slice in shared
memory in double, in float32 and read every step from device memory (the
last two forced by a small shared-memory limit, with batch groups), head
widths that are not a multiple of 4, a last CTA owning fewer units, and
m0 = -inf and -1e30. Each runs in the build the card gets and in one
without the threads' fixed load slots (``REPRO_SLSTM_SLOTS=0``), where
every load of h and xg takes the general path. Each result is held to
:func:`slstm_scan_plain` at 1e-5 relative, the float32 rounding of a few
dozen serial steps (the card's gate is 1e-4 over 16 steps at D 1024).
Skips where g++ is absent.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan import (
    ROUTES,
    SMEM_LIMIT,
    THREADS,
    slstm_grid,
    slstm_scan_plain,
)

TOL = 1e-5
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


@pytest.fixture(scope="module", params=[(), ("REPRO_SLSTM_SLOTS=0",)], ids=["slots", "no-slots"])
def lib(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    so = emulate.compile_library(tmp_path_factory.mktemp("slstm_emu"), ("slstm_scan.cu",),
                                 request.param)
    for name in ("repro_slstm_scan", "repro_slstm_barriers"):
        fn = getattr(so, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return so


def _inputs(b, l, d, m0, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    xg = (rng.standard_normal((b, l, 4 * d)) * 0.5).astype(f)
    wr = (rng.standard_normal((4, d // 4, d)) * 0.5 / np.sqrt(d // 4)).astype(f)
    bias = (rng.standard_normal(4 * d) * 0.1).astype(f)
    c0 = (rng.standard_normal((b, d)) * 0.1).astype(f)
    n0 = np.abs(rng.standard_normal((b, d))).astype(f)
    h0 = (rng.standard_normal((b, d)) * 0.1).astype(f)
    return xg, wr, bias, c0, n0, h0, np.full((b, d), m0, f)


def _run(lib, grid, xg, wr, bias, c0, n0, h0, m0):
    b, l, d4 = xg.shape
    d = d4 // 4
    hs = np.full((b, l, d), np.nan, np.float32)
    final = [np.full((b, d), np.nan, np.float32) for _ in range(4)]
    count = np.zeros(1, np.uint64)
    ins = [np.ascontiguousarray(x) for x in (xg, wr, bias, c0, n0, h0, m0)]
    rc = lib.repro_slstm_scan(*(x.ctypes.data for x in ins), hs.ctypes.data,
                              *(x.ctypes.data for x in final), *(None,) * 4,
                              count.ctypes.data, b, l, d,
                              grid.ctas, grid.units, grid.threads, grid.rows,
                              ROUTES.index(grid.route), grid.smem_bytes, 0, None)
    assert rc == 0, f"rc {rc}"
    return hs, final, int(count[0])


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("m0", [float("-inf"), -1e30], ids=["m0=-inf", "m0=-1e30"])
@pytest.mark.parametrize("b,l,d,sms,smem_limit,route", [
    (3, 24, 64, 4, SMEM_LIMIT, "smem_f64"),  # 4 CTAs of 16 units, hd 16
    (2, 16, 36, 5, SMEM_LIMIT, "smem_f64"),  # hd 9: scalar h loads, K padded; units 8, the last 4
    (3, 24, 64, 4, 10000, "smem_f32"),       # a group of 2 rows, then 1
    (3, 12, 44, 4, 2000, "global"),          # 11 units a CTA (odd); groups of 2 rows and 1
    (1, 8, 16, 5, SMEM_LIMIT, "smem_f64"),   # 4 CTAs of 4 units from 5 SMs
], ids=["f64-b3-d64", "f64-b2-d36", "f32-groups-b3-d64", "global-groups-b3-d44", "f64-b1-d16"])
def test_emulated_kernel_matches_plain(lib, b, l, d, sms, smem_limit, route, m0):
    grid = slstm_grid(d, b, sms, smem_limit=smem_limit)
    assert grid.route == route
    if smem_limit < SMEM_LIMIT:
        assert grid.groups > 1
    xg, wr, bias, c0, n0, h0, m = _inputs(b, l, d, m0, seed=b * 100 + d)
    hs, final, count = _run(lib, grid, xg, wr, bias, c0, n0, h0, m)
    ref_hs, ref_final = slstm_scan_plain(*(torch.from_numpy(x) for x in
                                           (xg, wr, bias, c0, n0, h0, m)))
    assert np.isfinite(hs).all() and all(np.isfinite(x).all() for x in final)
    assert _rel(hs, ref_hs.numpy()) <= TOL
    for got, ref, name in zip(final, ref_final, "cnhm"):
        assert _rel(got, ref.numpy()) <= TOL, name
    np.testing.assert_array_equal(final[2], hs[:, -1])
    # one arrival of every CTA at each barrier: all steps but the last
    assert count == grid.ctas * (grid.groups * l - 1)


def test_emulated_barriers_count_every_arrival(lib):
    count = np.zeros(1, np.uint64)
    assert lib.repro_slstm_barriers(count.ctypes.data, 6, THREADS, 50, 0, None) == 0
    assert int(count[0]) == 6 * 50


def test_emulated_entry_refuses_a_geometry_the_grid_did_not_give(lib):
    grid = slstm_grid(64, 3, 4)
    args = _inputs(3, 4, 64, -np.inf, seed=0)
    for bad in (grid._replace(smem_bytes=grid.smem_bytes + 4), grid._replace(ctas=grid.ctas + 1),
                grid._replace(threads=grid.threads + 1), grid._replace(rows=4)):
        with pytest.raises(AssertionError, match="rc 1\n"):
            _run(lib, bad, *args)


# --- slstm_grid: the geometry's arithmetic, no compiler needed ------------

@pytest.mark.parametrize("d", [4, 36, 64, 1024, 2048, 3072, 4096])
@pytest.mark.parametrize("batch", [1, 3, 8, 64])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_grid_covers_every_unit_once_and_fits(d, batch, sms):
    g = slstm_grid(d, batch, sms)
    assert g.ctas <= sms and g.ctas * g.units >= d > (g.ctas - 1) * g.units
    owned = np.zeros(d, int)
    for j in range(g.ctas):
        owned[j * g.units:min(d, (j + 1) * g.units)] += 1
    assert (owned == 1).all()
    assert g.rows * g.groups >= batch > g.rows * (g.groups - 1)
    assert g.smem_bytes <= SMEM_LIMIT
    assert g.threads == THREADS
    hd = d // 4
    ws = -(-hd // 4) * 4 + 4
    one_row = 4 * (4 * ws + 27 * g.units)  # a batch row's buffers and the bias
    fits = [4 * 4 * e * g.units * ws + one_row <= SMEM_LIMIT for e in (1, 2)]  # float32, double
    assert g.route == ("smem_f64" if fits[1] else "smem_f32" if fits[0] else "global")


def test_grid_at_xlstm_350m():
    """xlstm-350m (D 1024, batch 8) on an H100's 132 SMs: 128 CTAs of 8
    units, 8 warps (one 8 x 8 tile of a gate over half of K each), wr's
    slice in shared memory in double (64 KB), one group."""
    g = slstm_grid(1024, 8, 132)
    assert (g.ctas, g.units, g.threads, g.rows, g.groups, g.route) == (
        128, 8, 256, 8, 1, "smem_f64")
    assert g.smem_bytes == 4 * (8 * 8 * 260 + 4 * 8 * 260 + 23 * 8 * 8 + 4 * 8)


def test_grid_routes_by_width():
    assert slstm_grid(2048, 8, 132).route == "smem_f32"      # 128 KB slice; 256 KB in double
    wide = slstm_grid(4096, 8, 132)                           # 512 KB slice: global
    assert (wide.route, wide.units, wide.threads, wide.groups) == ("global", 32, 256, 1)
    assert slstm_grid(1024, 8, 16).units == 64                # a MIG slice: fewer CTAs
    big = slstm_grid(1024, 1000, 132)
    assert big.groups > 1 and big.rows * big.groups >= 1000


def test_grid_rejects_what_the_kernel_does_not_take():
    for d, batch, sms in ((6, 1, 132), (2, 1, 132), (64, 0, 132), (64, 1, 0)):
        with pytest.raises(ValueError):
            slstm_grid(d, batch, sms)
