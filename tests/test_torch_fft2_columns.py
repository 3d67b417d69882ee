"""The column pass of the composed 2D route (``fft2_columns``) and the route.

Frames over one block (H·W > 16384) take the composed route: the row pass
on the 1D kernels, then ``fft2_columns``, which runs the FFT down panels of
neighbouring columns in place in HBM, with no corner turn
(``csrc/fft2_columns.cu``). Held here on the CPU:

* ``fft2_columns_plain`` against numpy's column FFT, forward and inverse,
  radix 2 and 4, on full widths and on half-spectrum widths whose last
  panel is partial, at 1e-5 of max|ref| (float32 rounding over up to 10
  butterfly stages);
* ``ops.fft2_kernel`` / ``rfft2_kernel`` / ``irfft2_kernel`` on frames over
  one block against ``repro.kernels.ops`` in Pallas interpret mode, at the
  reference's 1e-5;
* which column lengths the kernel serves, its census, and that the route
  runs no corner turn wherever it serves (the turn route only above);
* ESTIMATE's price of a composed frame: no corner-turn trip where the
  kernel serves the columns;
* ``csrc/fft2_columns.cu`` itself, compiled with g++ against
  ``tools/cuda_emu`` and run through its C entry at the census's launch
  geometry, against ``fft2_columns_plain`` at 1e-5 (skips where g++ is
  absent).
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fft_radix2 as k

TOL = 1e-5
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


def _crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ------------------------------ plain version -------------------------------


@pytest.mark.parametrize("shape", [(2, 256, 256), (1, 1024, 48), (2, 128, 129), (1, 256, 257)])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_numpy_column_fft(shape, radix, inverse):
    x = _crandn(np.random.default_rng(sum(shape) + radix), *shape)
    got = k.fft2_columns_plain(torch.from_numpy(x), radix=radix, inverse=inverse)
    ref = (np.fft.ifft if inverse else np.fft.fft)(x.astype(np.complex128), axis=1)
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) <= TOL


def test_wrapper_on_cpu_writes_out_and_leaves_x_otherwise():
    x = torch.from_numpy(_crandn(np.random.default_rng(1), 2, 64, 33))
    keep = x.clone()
    y = k.fft2_columns(x, radix=4)
    assert torch.equal(x, keep) and y.data_ptr() != x.data_ptr()
    same = k.fft2_columns(x, radix=4, out=x)
    assert same is x and torch.equal(x, y)
    with pytest.raises(ValueError, match="out must match"):
        k.fft2_columns(keep, out=torch.empty(2, 64, 32, dtype=torch.complex64))
    with pytest.raises(ValueError, match="exceed one block's panel"):
        k.fft2_columns(torch.zeros(1, 8192, 2, dtype=torch.complex64))


# ------------------------------- the census --------------------------------


@pytest.mark.parametrize("h,serves,cols", [(2, True, 2048), (16, True, 256), (64, True, 64),
                                           (128, True, 32), (256, True, 16), (512, True, 16),
                                           (1024, True, 16), (2048, True, 8), (4096, True, 4),
                                           (8192, False, None), (2 ** 18, False, None)])
def test_which_column_lengths_the_kernel_serves(h, serves, cols):
    """H <= 1024 at 16 or more columns a panel (whole 128-byte lines), 2048
    and 4096 at 8 and 4 (whole 32-byte sectors); longer columns take the
    turn route. A panel holds at most 16384 values, 16 a thread."""
    assert k.fft2_columns_serves(h) is serves
    if serves:
        g = k.fft2_columns_geometry(h, 4096)
        assert g.cols == cols and g.cols * h <= k.COLUMN_PANEL_VALUES
        assert g.threads == g.cols * h // min(16, g.cols * h) <= 1024
        assert g.smem == (k.smem_slot(g.cols * h) + k.smem_slot(h // 2)) * 8
        assert g.smem <= k.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("width,cols,tiles", [(257, 16, 17), (513, 16, 33), (512, 16, 32),
                                              (9, 16, 1), (3, 4, 1), (1, 1, 1)])
def test_panels_cover_the_width(width, cols, tiles):
    """The last panel of a half-spectrum width is partial (masked); a frame
    narrower than the panel takes one panel of its width rounded up to a
    power of two."""
    g = k.fft2_columns_geometry(256, width)
    assert (g.cols, g.tiles) == (cols, tiles)
    assert (g.tiles - 1) * g.cols < width <= g.tiles * g.cols


# --------------------------------- the route --------------------------------


def _reference(name, x, radix):
    return np.asarray(getattr(jops, name)(x, radix=radix, interpret=True))


@pytest.mark.parametrize("shape", [(2, 256, 256), (1, 256, 512), (1, 512, 256)])
@pytest.mark.parametrize("radix", [2, 4])
def test_composed_fft2_matches_reference(shape, radix):
    x = _crandn(np.random.default_rng(shape[1] + radix), *shape)
    assert not ops.fft2_fits_budget(*shape[1:])
    got = ops.fft2_kernel(torch.from_numpy(x), radix=radix)
    assert _rel(got.numpy(), _reference("fft2_kernel", x, radix)) <= TOL
    back = ops.fft2_kernel(got, radix=radix, inverse=True)
    assert _rel(back.numpy(), x) <= TOL


@pytest.mark.parametrize("shape", [(2, 256, 256), (1, 256, 512), (1, 512, 256)])
@pytest.mark.parametrize("radix", [2, 4])
def test_composed_rfft2_and_irfft2_match_reference(shape, radix):
    rng = np.random.default_rng(shape[2] + radix)
    x = rng.standard_normal(shape).astype(np.float32)
    assert not ops.fft2_fits_budget(*shape[1:], real=True)
    got = ops.rfft2_kernel(torch.from_numpy(x), radix=radix)
    assert _rel(got.numpy(), _reference("rfft2_kernel", x, radix)) <= TOL
    half = _crandn(rng, shape[0], shape[1], shape[2] // 2 + 1)
    keep = torch.from_numpy(half.copy())
    spec = torch.from_numpy(half)
    out = ops.irfft2_kernel(spec, radix=radix)
    assert torch.equal(spec, keep)  # the caller's spectrum stays as it was
    assert _rel(out.numpy(), _reference("irfft2_kernel", half, radix)) <= TOL


def _spy(monkeypatch, name):
    calls, fn = [], getattr(ops, name)

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape))
        return fn(*args, **kw)

    monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("name,shape", [("fft2_kernel", (2, 256, 256)),
                                        ("rfft2_kernel", (1, 512, 256)),
                                        ("irfft2_kernel", (1, 256, 129)),
                                        ("fft2_kernel", (1, 4096, 8))])
def test_composed_route_runs_no_corner_turn(monkeypatch, name, shape):
    """Wherever fft2_columns serves the columns, the composed route is one
    row pass and one fft2_columns call, and ``_turn`` never runs."""
    turns, columns = _spy(monkeypatch, "_turn"), _spy(monkeypatch, "fft2_columns")
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape).astype(np.float32) if name == "rfft2_kernel"
         else _crandn(rng, *shape))
    getattr(ops, name)(torch.from_numpy(x), radix=4)
    assert turns == [] and columns == [shape if name != "rfft2_kernel"
                                       else (shape[0], shape[1], shape[2] // 2 + 1)]


def test_columns_past_the_panel_take_the_turn_route(monkeypatch):
    """Columns of 8192 values are more than one panel holds: the planned turn
    route, two corner turns and fft_fused on the columns as rows."""
    turns, columns = _spy(monkeypatch, "_turn"), _spy(monkeypatch, "fft2_columns")
    x = _crandn(np.random.default_rng(6), 1, 8192, 4)
    got = ops.fft2_kernel(torch.from_numpy(x), radix=4)
    assert len(turns) == 2 and columns == []
    assert _rel(got.numpy(), np.fft.fft2(x.astype(np.complex128))) <= TOL


# -------------------------------- the planner --------------------------------


@pytest.mark.parametrize("kind,shape,radix,trips", [
    ("fft2d", (16, 1024, 1024), 4, 2), ("fft2d", (32, 512, 512), 2, 2),
    ("rfft2d", (32, 512, 512), 4, 2), ("rfft2d", (8, 512, 32768), 4, 2),
    ("fft2d", (1, 8192, 4), 4, 3)])
def test_estimate_prices_the_composed_frame_without_corner_turns(kind, shape, radix, trips):
    """ESTIMATE's composed frame: the row pass's round trips plus one for
    fft2_columns (its passes those of its column panel: the register
    passes at both radices), and one more for the two corner turns only
    where the turn route runs (H > 4096)."""
    from repro_torch.launch.roofline import HBM_BW, SMEM_BW
    from repro_torch.plan import autotune
    from repro_torch.plan.plan import ProblemKey

    key = ProblemKey(kind=kind, backend="cuda", device_kind="NVIDIA H100 80GB HBM3",
                     shape=shape, dtype="complex64" if kind == "fft2d" else "float32")
    real = kind == "rfft2d"
    h, w = shape[-2:]
    _, row_passes = autotune._row_cost(w, radix, real)
    _, col_passes = autotune._column_cost(h, radix)
    elems = float(np.prod(shape)) * (0.5 if real else 1.0)
    passes = row_passes + col_passes
    want = (max(16.0 * elems * trips / HBM_BW, 16.0 * elems * passes / SMEM_BW)
            + trips * autotune._KERNEL_LAUNCH_S)
    assert autotune._fused_cuda_time(key, radix, 0.0) == pytest.approx(want, rel=1e-12)


# ------------------------------ the CUDA source -----------------------------


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    so = emulate.compile_library(tmp_path_factory.mktemp("fft2_columns_emu"),
                                 ("fft2_columns.cu",))
    so.repro_fft2_columns.argtypes = list(_build._SIGNATURES["repro_fft2_columns"])
    so.repro_fft2_columns.restype = ctypes.c_int
    return so


@pytest.mark.parametrize("shape", [(2, 64, 129), (1, 256, 48), (1, 32, 33), (1, 8, 20),
                                   (2, 16, 3), (1, 2048, 9), (1, 4, 17), (3, 2, 40)])
@pytest.mark.parametrize("radix", [2, 4])
def test_emulated_kernel_matches_plain(lib, shape, radix):
    """Partial last panels (129, 48, 33, 9, 3, 17 and 40 columns), one-pass
    columns (2, 4, 8, 16: one pass of radix H, then one of radix 1 through
    shared memory), an 8-column panel (2048), in place and into a new
    buffer, each forward and inverse, at the launch geometry of
    fft2_columns_geometry."""
    f, h, wc = shape
    x = _crandn(np.random.default_rng(h + wc + radix), *shape)
    g = k.fft2_columns_geometry(h, wc)
    for inverse in (False, True):
        twin = k.fft2_columns_plain(torch.from_numpy(x), radix=radix, inverse=inverse).numpy()
        for in_place in (False, True):
            src = x.copy()
            dst = src if in_place else np.full_like(x, np.nan)
            rc = lib.repro_fft2_columns(src.ctypes.data, dst.ctypes.data, f, h, wc, radix,
                                        g.cols, g.threads, g.smem, int(inverse),
                                        1.0 / h if inverse else 1.0, 0, None)
            assert rc == 0, (shape, radix, inverse, in_place)
            assert _rel(dst, twin) <= TOL, (shape, radix, inverse, in_place)
            if not in_place:
                assert np.array_equal(src, x)


def test_emulated_kernel_refuses_a_geometry_off_the_census(lib):
    """Both radices take the padded census (panel and ROM padded, 16 values
    a thread): it launches, and one slot less, twice the threads or the
    stage panel's unpadded block are refused."""
    x = np.zeros((1, 256, 48), np.complex64)
    g = k.fft2_columns_geometry(256, 48)
    unpadded = (g.cols * 256 + 256 // 2) * 8
    for radix in (4, 2):
        args = (x.ctypes.data, x.ctypes.data, 1, 256, 48, radix, g.cols)
        assert lib.repro_fft2_columns(*args, g.threads, g.smem, 0, 1.0, 0, None) == 0
        assert lib.repro_fft2_columns(*args, g.threads * 2, g.smem, 0, 1.0, 0, None) == 9
        assert lib.repro_fft2_columns(*args, g.threads, g.smem - 8, 0, 1.0, 0, None) == 9
        assert lib.repro_fft2_columns(*args, g.threads, unpadded, 0, 1.0, 0, None) == 9
        assert lib.repro_fft2_columns(x.ctypes.data, x.ctypes.data, 1, 96, 48, radix, g.cols,
                                      g.threads, g.smem, 0, 1.0, 0, None) == 1
