"""The register passes of the radix-2 ``fft_fused`` and ``rfft_fused``
(``irfft_fused``'s: ``tests/test_torch_real_regpass_r2.py``).

``csrc/stockham_regs.cuh`` (``r2_layers``) runs on the card only. Here, on
the CPU:

* its twin, ``fft_radix2._regpass_panel_r2``, is ``torch.equal`` to the
  stage-at-a-time ``_stockham_panel`` (the plain version of the two
  kernels at radix 2) on every power of two from 2 to 16384: the same
  butterflies with the same twiddles in the same stage order, grouped four
  stages a pass; the plain versions are held to the Pallas kernels in
  interpret mode at max|port - ref| <= 1e-5 * max|ref|;
* ``csrc/fft_fused.cu`` itself, compiled with g++ against
  ``tools/cuda_emu`` and run through its C entries at the census's launch
  geometry, is held to the plain versions at 2e-5 of max|plain| (skips
  where g++ is absent);
* a numpy model of the kernels' twiddle reads states the bank ways of
  each (8-byte accesses: a half-warp's distinct slots over 16 bank pairs)
  and gates on none where the padded ROM allows it; the exchanges are the
  radix-4 passes' own slots, which
  ``test_torch_fft_regpass.py::test_padded_exchange_is_conflict_free``
  holds conflict-free;
* the census and the planner count the passes that run.
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
SIZES = [2 ** p for p in range(1, 15)]
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


# ------------------------------- the twin ----------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_register_passes_are_the_stage_panel_bit_for_bit(n):
    rng = np.random.default_rng(n)
    for dtype in (np.float32, np.float64):
        re = torch.from_numpy(rng.standard_normal((3, n)).astype(dtype))
        im = torch.from_numpy(rng.standard_normal((3, n)).astype(dtype))
        got = k._regpass_panel_r2(re, im, n)
        ref = k._stockham_panel(re, im, n)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (n, dtype)


@pytest.mark.parametrize("n", [16, 256, 2048])
def test_plain_versions_match_pallas(n):
    rng = np.random.default_rng(7 * n)
    x = (rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))).astype(np.complex64)
    yr, yi = jref.fft_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=2, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    _close(k.fft_fused_plain(torch.from_numpy(x), radix=2).numpy(), ref)
    _close(k.fft_fused(torch.from_numpy(x), radix=2).numpy(), ref)
    r = rng.standard_normal((5, n)).astype(np.float32)
    yr, yi = jref.rfft_fused(jnp.asarray(r), radix=2, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    _close(k.rfft_fused_plain(torch.from_numpy(r), radix=2).numpy(), ref)
    _close(k.rfft_fused(torch.from_numpy(r), radix=2).numpy(), ref)


# ------------------------------ the CUDA source -----------------------------


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    so = mod.compile_library(tmp_path_factory.mktemp("fft_fused_emu"), ("fft_fused.cu",))
    for name in ("repro_fft_fused", "repro_rfft_fused", "repro_irfft_fused"):
        getattr(so, name).argtypes = list(_build._SIGNATURES[name])
        getattr(so, name).restype = ctypes.c_int
    return mod, so


@pytest.mark.parametrize("n", SIZES)
def test_emulated_kernels_match_plain(emulate, n):
    """fft_fused forward and inverse, rfft_fused and irfft_fused at radix
    2, batches 3 and 1: a batch of 3 leaves the last row tile's fourth row
    masked wherever a tile holds four rows or more (n <= 1024)."""
    mod, so = emulate
    for batch in (3, 1):
        errs = mod.rows(so, n, batch, np.random.default_rng(n + batch), radix=2)
        assert np.all(np.asarray(errs) <= TOL_EMU), (n, batch, errs)


def test_emulated_kernel_refuses_a_geometry_off_the_census(emulate):
    _, so = emulate
    x = np.zeros((4, 256), np.complex64)
    t = k.pick_row_tile(4, 256)
    args = (x.ctypes.data, x.ctypes.data, 4, 256, 2, t)
    good = (k.block_threads(t * 256), k.fft_smem_bytes(256, t))
    assert so.repro_fft_fused(*args, *good, 0, 1.0, 0, None) == 0
    assert so.repro_fft_fused(*args, good[0] * 2, good[1], 0, 1.0, 0, None) == 9
    assert so.repro_fft_fused(*args, good[0], good[1] - 8, 0, 1.0, 0, None) == 9
    assert so.repro_fft_fused(x.ctypes.data, x.ctypes.data, 1, 2 ** 15, 2, 1, 1024,
                              k.fft_smem_bytes(2 ** 15), 0, 1.0, 0, None) == 1


# ------------------------------ the twiddle reads ---------------------------

HALF_WARP = 16
_slot = k.smem_slot  # works on numpy arrays too


def _ways(addr, threads):
    """Bank ways of one access instruction (addr: the slot each thread
    touches, -1 none): the most distinct slots of a half-warp that share a
    bank pair (slot mod 16)."""
    worst = 1
    for h0 in range(0, threads, HALF_WARP):
        a = addr[h0:h0 + HALF_WARP]
        a = np.unique(a[a >= 0])
        if len(a):
            worst = max(worst, int(np.bincount(a % 16).max()))
    return worst


def _geometry(line, batch):
    rows = k.pick_row_tile(batch, line)
    p = rows * line
    return p, k.block_threads(p)


def _passes(line):
    """(radix, log2 of the span) of each pass over a line."""
    out, log_l = [], 0
    for radix in k.regpass_radices(line):
        out.append((radix, log_l))
        log_l += radix.bit_length() - 1
    return out


def _groups(line, p, threads, radix):
    """Per group slot a thread holds: (ok, t) arrays."""
    s = line // radix
    tid = np.arange(threads)
    for i in range(16 // radix):
        g = tid + i * threads
        yield g < p // radix, g % s


def _stage_twiddles(kk, ok, log_l, log_half, lr, rom0):
    """ROM slots r2_layers reads for groups at k = kk, stage by stage: per
    stage, one instruction per twiddle (2^s of them); a first pass's W = 1
    is no read."""
    out = []
    for st in range(lr):
        stage = []
        for h in range(1 << st):
            c = k._bit_reverse(h, st)
            if log_l == 0 and c == 0:
                continue
            e = (kk + (c << log_l)) << (log_half - log_l - st)
            stage.append(np.where(ok, rom0 + _slot(e), -1))
        out.append(stage)
    return out


def _twiddle_ways(line, p, threads, log_half, paired=False):
    """Ways of every twiddle read of the panel over lines of ``line`` (ROM
    W_{2 half}^e after the padded values): {(pass, stage): [ways, ...]};
    ``paired``: the last pass's groups p and l - p (l/2 for p = 0) of
    rfft_fused's paired recombination."""
    rom0 = _slot(p)
    out = {}
    passes = _passes(line)
    for idx, (radix, log_l) in enumerate(passes):
        lr = radix.bit_length() - 1
        l = 1 << log_l
        if paired and idx == len(passes) - 1:
            tid = np.arange(threads)
            for i in range(16 // (2 * radix)):
                pp = tid + i * threads
                q = pp % (l // 2)
                ok = pp < p // (2 * radix)
                for kk in (q, np.where(q == 0, l // 2, l - q)):
                    for st, stage in enumerate(_stage_twiddles(kk, ok, log_l, log_half, lr, rom0)):
                        out.setdefault((idx, st), []).extend(_ways(a, threads) for a in stage)
            continue
        for ok, t in _groups(line, p, threads, radix):
            for st, stage in enumerate(_stage_twiddles(t % l, ok, log_l, log_half, lr, rom0)):
                out.setdefault((idx, st), []).extend(_ways(a, threads) for a in stage)
    return out


def _padded_ways(stride):
    """Ways the padded ROM gives 16 lanes reading at a stride of 2^a
    entries: none up to 16; past that it cannot spread them, stride/16
    lanes to a bank pair, at most 16."""
    return min(16, max(1, stride // 16))


@pytest.mark.parametrize("n", [2 ** p for p in range(2, 15)])
@pytest.mark.parametrize("real", [False, True], ids=["fft_fused", "rfft_fused"])
def test_twiddle_reads_conflict_only_where_the_padded_rom_cannot_spread_them(n, real):
    """Each twiddle read of stage s of a pass over span l: 16 consecutive
    groups of a half-warp read W_{2 half}^e at e = (k + l c) 2^(log_half -
    log l - s), consecutive k, so a stride of 2^(log_half - log l - s) ROM
    entries (broadcasts in a first pass, k = 0): conflict-free up to a
    stride of 16, ``_padded_ways`` beyond, as the model finds them."""
    line = n // 2 if real else n
    log_half = line.bit_length() - 1 if real else line.bit_length() - 2
    paired = real and k.rfft_pairs_in_registers(line)
    for batch in (8192, 1):
        p, threads = _geometry(line, batch)
        ways = _twiddle_ways(line, p, threads, log_half, paired)
        for (idx, st), got in ways.items():
            if not got:  # a first pass's first stage: W = 1, no read
                continue
            log_l = _passes(line)[idx][1]
            stride = 1 << (log_half - log_l - st)
            want = 1 if log_l == 0 or threads < HALF_WARP else _padded_ways(stride)
            if paired and idx == len(_passes(line)) - 1 and want == 1:
                want = max(got)  # lane p = 0's group l/2 may share a pair: stated below
                assert want <= 2, (idx, st, got)
            assert max(got) == want, (n, real, batch, idx, st, got)


def test_twiddle_ways_of_chip_smokes_rows():
    """At (8192, 2048) the second pass's first two stages read at strides of
    64 and 32 ROM entries, 4 and 2 ways; every other twiddle read of
    fft_fused is conflict-free: 20 + 7 half-warp wavefronts a group of 16
    (the 15 + 7 reads of the second and third passes). rfft_fused's half row
    of 1024 reads the same 20 in its second pass; its paired last pass reads
    3 twiddles for group p and 3 for group l - p, whose reads are 2-way in
    the half-warp that holds p = 0 (its lane reads group l/2's): 9
    wavefronts a pair there, 6 elsewhere."""
    p, threads = _geometry(2048, 8192)
    ways = _twiddle_ways(2048, p, threads, 10)
    assert ways[(1, 0)] == [4] and ways[(1, 1)] == [2, 2]
    assert sum(sum(v) for (idx, _), v in ways.items() if idx == 1) == 20
    assert sum(sum(v) for (idx, _), v in ways.items() if idx == 2) == 2 * 7  # two groups a thread
    assert all(w == 1 for (idx, _), v in ways.items() if idx != 1 for w in v)
    p, threads = _geometry(1024, 8192)
    ways = _twiddle_ways(1024, p, threads, 10, paired=True)
    assert sum(sum(v) for (idx, _), v in ways.items() if idx == 1) == 20
    assert ways[(2, 0)] == [1, 2] * 2 and ways[(2, 1)] == [1, 1, 2, 2] * 2  # two pairs a thread


# ----------------------------- census and planner ---------------------------


def test_exchange_and_barrier_counts_are_the_radix_4_passes():
    """chip_smoke's rows: 2048 values in passes 16·16·8, two exchanges and
    three barriers where the stage panel had eleven stages and 22 barriers;
    rfft_fused's half row of 1024 in 16·16·4, its mirror bins paired in the
    last pass; irfft_fused's half row of 1024 in the same passes, untangled
    in the first pass's reads, at either radix."""
    for n in (2 ** p for p in range(1, 15)):
        for real, inverse in ((False, False), (True, False), (True, True)):
            assert (k.regpass_exchanges(n, real=real, inverse=inverse, radix=2)
                    == k.regpass_exchanges(n, real=real, inverse=inverse, radix=4))
            assert (k.regpass_barriers(n, real=real, inverse=inverse, radix=2)
                    == k.regpass_barriers(n, real=real, inverse=inverse, radix=4))
    assert (k.regpass_exchanges(2048, radix=2), k.regpass_barriers(2048, radix=2)) == (2, 3)
    assert (k.regpass_exchanges(2048, real=True, radix=2),
            k.regpass_barriers(2048, real=True, radix=2)) == (2, 3)
    assert (k.regpass_exchanges(2048, real=True, inverse=True, radix=2),
            k.regpass_barriers(2048, real=True, inverse=True, radix=2)) == (2, 3)
    with pytest.raises(ValueError, match="radix must be 2 or 4"):
        k.regpass_barriers(2048, radix=8)


def test_planner_prices_the_passes_that_run():
    """A one-block radix-2 fft, rfft or irfft row: the register passes'
    exchanges; fft2_columns' radix-2 column panels too (the same passes as
    radix 4's); columns over 4096 take the row kernels."""
    assert autotune._row_cost(2048, 2, False) == autotune._row_cost(2048, 4, False) == (1, 2)
    assert autotune._row_cost(2048, 2, True) == (1, 2)
    assert autotune._row_cost(2048, 2, True, True) == (1, 2)
    assert autotune._row_cost(8192, 2, True) == (1, 3)  # 16·16·16 and the recombination
    assert autotune._column_cost(512, 2) == (1, 2)
    assert autotune._column_cost(512, 4) == (1, 2)
    assert autotune._column_cost(8192, 2) == autotune._row_cost(8192, 2, False) == (1, 3)
