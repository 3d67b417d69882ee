"""The register passes of the radix-2 ``irfft_fused`` and ``rfft2_fused``.

``csrc/fft_fused.cu`` (``irfft_regs_kernel<LOG_M, 2>``) and
``csrc/rfft2_fused.cu`` (``rfft2_regs_kernel<LOG_H, LOG_M, 2>``, and
``irfft2_regs_kernel<LOG_H, LOG_M, 2>`` beside it, whose own tests are in
``test_torch_columns_irfft2_regpass_r2.py``) run on the card only. Here,
on the CPU:

* the plain versions at radix 2 (``irfft_fused_plain``,
  ``rfft2_fused_plain``) are held to the Pallas kernels in interpret mode
  and to numpy at max|port - ref| <= 1e-5 * max|ref|, the inverse on half
  spectra that are not Hermitian (the kernel drops the imaginary parts of
  the DC and Nyquist bins, as numpy does);
* the kernels' schedules, each pass on ``_regpass_panel_r2``, are
  ``torch.equal`` to the plain versions, whose passes run
  ``_stockham_panel``;
* both CUDA sources, compiled with g++ against ``tools/cuda_emu`` and run
  through their C entries at the census's launch geometry, are held to the
  plain versions at 2e-5 of max|plain| (skips where g++ is absent);
* the census admits the same rows and frames and counts the radix-2
  kernels' passes as the radix-4 ones'; the planner prices them so.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch.kernels import _build
from repro_torch.kernels import fft_radix2 as k
from repro_torch.plan import autotune

TOL = 1e-5
TOL_EMU = 2e-5
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
ROWS = [2 ** p for p in range(2, 15)]
FRAMES = [(2, 2), (8, 8), (16, 64), (64, 16), (8, 2), (2, 512), (128, 128)]
ALL_REAL = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)
            if k.rfft2_fits_smem(1 << a, 1 << b)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def _half_spectra(rng, b, n):
    m = n // 2
    return (rng.standard_normal((b, m + 1))
            + 1j * rng.standard_normal((b, m + 1))).astype(np.complex64)


def _frame_id(hw):
    return f"{hw[0]}x{hw[1]}"


# ---------------------------- the plain versions ----------------------------


@pytest.mark.parametrize("n", ROWS)
def test_irfft_plain_matches_pallas_and_numpy(n):
    y = _half_spectra(np.random.default_rng(n), 3, n)
    ref = np.asarray(jref.irfft_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=2,
                                      interpret=True))
    got = k.irfft_fused_plain(torch.from_numpy(y), radix=2).numpy()
    _close(got, ref)
    _close(got, np.fft.irfft(y.astype(np.complex128), n))


@pytest.mark.parametrize("hw", FRAMES, ids=_frame_id)
def test_rfft2_plain_matches_pallas_and_numpy(hw):
    h, w = hw
    x = np.random.default_rng(h * 1000 + w).standard_normal((2, h, w)).astype(np.float32)
    yr, yi = jref.rfft2_fused(jnp.asarray(x), radix=2, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = k.rfft2_fused_plain(torch.from_numpy(x), radix=2).numpy()
    _close(got, ref)
    _close(got, np.fft.rfft2(x.astype(np.float64)))


# ------------------------------- the twins ----------------------------------


@pytest.mark.parametrize("n", [4, 32, 2048, 16384])
def test_irfft_register_passes_are_the_plain_version_bit_for_bit(n):
    """The kernel's order: untangle, then the half-size inverse on the
    radix-2 register passes, against the plain version's panel
    (``_stockham_panel``)."""
    y = torch.from_numpy(_half_spectra(np.random.default_rng(3 * n), 3, n))
    re, im = k._planes(y)
    got = k._irfft_panel(re, im, n, 2, panel=k._regpass_panel_r2)
    assert torch.equal(got, k.irfft_fused_plain(y, radix=2))


@pytest.mark.parametrize("hw", FRAMES, ids=_frame_id)
def test_rfft2_register_passes_are_the_plain_version_bit_for_bit(hw):
    """The kernel's order (rows, the recombination in the first column
    pass, columns with DC + i Nyquist packed in column 0, the split), each
    panel on the radix-2 register passes, against the plain version."""
    h, w = hw
    x = torch.from_numpy(
        np.random.default_rng(h * 7 + w).standard_normal((2, h, w)).astype(np.float32))
    got = k._rfft2_regpass(x, k._regpass_panel_r2)
    assert torch.equal(got, k.rfft2_fused_plain(x, radix=2))


# ------------------------------ the CUDA sources ----------------------------


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    so = mod.compile_library(tmp_path_factory.mktemp("real_r2_emu"),
                             ("fft_fused.cu", "fft2_fused.cu", "rfft2_fused.cu"))
    for name in ("repro_fft_fused", "repro_rfft_fused", "repro_irfft_fused",
                 "repro_fft2_fused", "repro_rfft2_fused", "repro_irfft2_fused"):
        getattr(so, name).argtypes = list(_build._SIGNATURES[name])
        getattr(so, name).restype = ctypes.c_int
    return mod, so


@pytest.mark.parametrize("n", [4, 64, 2048, 16384])
@pytest.mark.parametrize("batch", [3, 1])
def test_emulated_irfft_r2_matches_plain(emulate, n, batch):
    """irfft_fused at radix 2 (``emulate.rows``, its fourth error) beside
    the other row kernels: one, two and three passes, a batch of 3 masking
    the last row tile's fourth row where a tile holds four or more."""
    mod, so = emulate
    errs = mod.rows(so, n, batch, np.random.default_rng(n + batch), radix=2)
    assert np.all(np.asarray(errs) <= TOL_EMU), (n, batch, errs)


@pytest.mark.parametrize("hw", [(2, 2), (8, 2), (2, 512), (64, 16), (16, 1024), (128, 128),
                                (256, 64), (128, 256)], ids=_frame_id)
def test_emulated_rfft2_r2_matches_plain(emulate, hw):
    """rfft2_fused at radix 2 (``emulate.frames``, its rfft2 error): the
    128x128 instance and the runtime-geometry one on one-pass, tall, wide
    and thin frames, where the row lines are shorter than the ROM's half
    turn; the other frame kernels at radix 2 beside it, irfft2_fused among
    them on the same frames (the tall 256x64 on the runtime-geometry
    instance) and on a 16384-value frame (128x256), which has an instance
    of its own."""
    mod, so = emulate
    h, w = hw
    errs, lines = mod.frames(so, h, w, np.random.default_rng(h * 1000 + w), radix=2)
    assert np.all(np.asarray(errs) <= TOL_EMU), (hw, lines)


def test_emulated_entries_refuse_a_geometry_off_the_census(emulate):
    """At radix 2 the entries take the register-pass census (padded values
    and ROM, 16 values a thread) and refuse anything else: irfft_fused,
    rfft2_fused and irfft2_fused, which the stage panel's unpadded block
    no longer launches."""
    _, so = emulate
    n, b = 2048, 4
    t = k.pick_row_tile(b, n // 2)
    y = np.zeros((b, n // 2 + 1), np.complex64)
    x = np.zeros((b, n), np.float32)
    row = (y.ctypes.data, x.ctypes.data, b, n, 2, t)
    good = (k.block_threads(t * n // 2), k.irfft_smem_bytes(n, t))
    assert so.repro_irfft_fused(*row, *good, 0, None) == 0
    assert so.repro_irfft_fused(*row, 2 * good[0], good[1], 0, None) == 9
    padded_rom = (k.smem_slot(t * n // 2) + k.smem_slot(n // 4)) * 8
    assert so.repro_irfft_fused(*row, good[0], padded_rom, 0, None) == 0
    assert so.repro_irfft_fused(*row, good[0], padded_rom - 8, 0, None) == 9
    h, w = 16, 64
    f = np.zeros((1, h, w), np.float32)
    z = np.zeros((1, h, w // 2 + 1), np.complex64)
    frame = (f.ctypes.data, z.ctypes.data, 1, h, w, 2)
    good = (k.block_threads(h * w // 2), k.rfft2_smem_bytes(h, w))
    unpadded = (h * w // 2 + max(h, w) // 2 + 1) * 8  # the stage panel's block
    back = (z.ctypes.data, f.ctypes.data, 1, h, w, 2)
    for entry, args in ((so.repro_rfft2_fused, frame), (so.repro_irfft2_fused, back)):
        assert entry(*args, *good, 0, None) == 0
        assert entry(*args, good[0] // 2, good[1], 0, None) == 9
        assert entry(*args, good[0], unpadded, 0, None) == 9
        assert entry(*args[:4], 48, 2, *good, 0, None) == 1


# ----------------------------- census and planner ---------------------------


def test_census_admits_the_same_rows_and_frames():
    """One-block real rows up to 2^14 and the same 105 real frames, as
    before the radix-2 kernels moved to register passes (the census sizes
    their blocks alike at both radices)."""
    assert [n for n in (2 ** p for p in range(1, 19)) if k.fft_fits_smem(n, real=True)] == [
        2 ** p for p in range(1, 15)]
    assert len(ALL_REAL) == 105
    assert ALL_REAL[0] == (2, 2) and (128, 256) in ALL_REAL and (256, 256) not in ALL_REAL


@pytest.mark.parametrize("n", [2 ** p for p in range(1, 15)])
def test_irfft_passes_are_counted_and_priced_as_at_radix_4(n):
    assert (k.regpass_exchanges(n, real=True, inverse=True, radix=2)
            == k.regpass_exchanges(n, real=True, inverse=True, radix=4)
            == len(k.regpass_radices(max(n // 2, 1))) - 1)
    assert (k.regpass_barriers(n, real=True, inverse=True, radix=2)
            == k.regpass_barriers(n, real=True, inverse=True, radix=4))
    assert autotune._row_cost(n, 2, True, True) == autotune._row_cost(n, 4, True, True)


def test_real_frames_are_priced_by_their_passes():
    """Every admitted frame: the radix-2 passes of the forward and of the
    inverse (``irfft2_fused`` on register passes too) are radix 4's
    (``frame_passes``)."""
    for h, w in ALL_REAL:
        fwd = k.frame_passes(h, w, real=True).exchanges
        assert autotune._frame_passes(h, w, 2, True, False) == fwd, (h, w)
        assert autotune._frame_passes(h, w, 4, True, False) == fwd, (h, w)
        inv = k.frame_passes(h, w, real=True, inverse=True).exchanges
        assert autotune._frame_passes(h, w, 2, True, True) == inv, (h, w)
        assert autotune._frame_passes(h, w, 4, True, True) == inv, (h, w)
    assert k.frame_passes(128, 128, real=True) == ((16, 4), (16, 8), 3, 6)
