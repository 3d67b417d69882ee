"""The radix-2 two-pass kernels and the radix-2 ``fft2_fused`` on register passes.

``csrc/fft_two_pass.cu`` (rows of 2^14 < N <= 2^18 at radix 2, and past
2^18 at both radices) and
``csrc/fft2_fused.cu`` at radix 2 run the register passes of
``csrc/stockham_regs.cuh`` with radix-2 layers, on the card only. Here, on
the CPU:

* the twins of their schedules (the four-step ``_two_pass_panel`` and the
  frame's rows-then-columns, each pass on ``_regpass_panel_r2``) are
  ``torch.equal`` to the stage-at-a-time plain versions they replace on the
  card (``_stockham_panel``); those plain versions are held to the Pallas
  kernels in interpret mode by ``tests/test_torch_fft_two_pass.py`` and
  ``tests/test_torch_kernels.py``;
* both CUDA sources, compiled with g++ against ``tools/cuda_emu`` and run
  through their C entries at the census's launch geometry, are held to the
  plain versions at 2e-5 of max|plain| (skips where g++ is absent);
* a numpy model of every access of the two passes (the column pass's HBM
  loads, its exchanges through the padded frame of C columns, its twiddled
  stores; the row pass's coalesced loads, its tile of rows S slots apart
  (``two_pass_row_stride``), its turned reads and stores) states the bank
  ways of each shared-memory access and the 32-byte sectors of each warp's
  HBM access, and gates on none past one way (the twiddle reads of the
  panels of 4 lines: two) and none past the fewest sectors, at every line
  length the census launches up to 2^24;
* the census's instances and the wrappers' launches on meta tensors
  (``tests/test_torch_plan.py`` pins the planner's price of the passes).
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fft_radix2 as k

TOL_EMU = 2e-5
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
TWO_PASS = [2 ** p for p in range(14, 19)]  # the complex rows and the real rows' halves
LONG = [2 ** p for p in range(19, 25)]  # rows past the reference's envelope, on the card


# ------------------------------- the twins ----------------------------------


@pytest.mark.parametrize("n", TWO_PASS)
def test_two_pass_register_passes_are_the_stage_panel_bit_for_bit(n):
    """The kernels' schedule (each pass's lines on the radix-2 register
    passes) against the plain version (each on the stage panel), float32 and
    float64."""
    rng = np.random.default_rng(n)
    for dtype in (np.float32, np.float64):
        re = torch.from_numpy(rng.standard_normal((2, n)).astype(dtype))
        im = torch.from_numpy(rng.standard_normal((2, n)).astype(dtype))
        got = k._two_pass_panel(re, im, n, k._regpass_panel_r2)
        ref = k._two_pass_panel(re, im, n, k._stockham_panel)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (n, dtype)


@pytest.mark.parametrize("hw", [(2, 2), (8, 8), (16, 64), (64, 16), (128, 128), (2, 8192)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_frame_register_passes_are_the_stage_panel_bit_for_bit(hw):
    """fft2_fused at radix 2: rows, then columns, on the register passes
    (``frame_panel<COLS, 2>``), against ``fft2_fused_plain(radix=2)``."""
    h, w = hw
    rng = np.random.default_rng(h * 7 + w)
    x = torch.from_numpy((rng.standard_normal((2, h, w))
                          + 1j * rng.standard_normal((2, h, w))).astype(np.complex64))
    re, im = k._planes(x)
    yr, yi = k._regpass_panel_r2(re.reshape(2 * h, w), im.reshape(2 * h, w), w)
    yr = yr.reshape(2, h, w).transpose(-1, -2).reshape(2 * w, h)
    yi = yi.reshape(2, h, w).transpose(-1, -2).reshape(2 * w, h)
    yr, yi = k._regpass_panel_r2(yr, yi, h)
    got = k._complex(yr.reshape(2, w, h).transpose(-1, -2), yi.reshape(2, w, h).transpose(-1, -2))
    assert torch.equal(got, k.fft2_fused_plain(x, radix=2))


# ------------------------------ the CUDA sources ----------------------------


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    so = mod.compile_library(tmp_path_factory.mktemp("two_pass_emu"),
                             ("fft_two_pass.cu", "fft2_fused.cu", "rfft2_fused.cu"))
    for name in (*mod.TWO_PASS_ENTRIES, "repro_fft2_fused", "repro_rfft2_fused",
                 "repro_irfft2_fused"):
        getattr(so, name).argtypes = list(_build._SIGNATURES[name])
        getattr(so, name).restype = ctypes.c_int
    return mod, so


@pytest.mark.parametrize("n", [2 ** 15, 2 ** 16])
@pytest.mark.parametrize("batch", [3, 1])
def test_emulated_two_pass_matches_plain(emulate, n, batch):
    """fft, ifft, rfft and irfft through the C entries the wrappers launch:
    complex rows of (256, 128) and (256, 256), real rows' halves of (128,
    128) and (256, 128), so every column instance but n1 = 512 and every
    row instance but n2 = 512 (``emulate.py --two-pass`` runs 2^17 and
    2^18 too); irfft on a half spectrum that is not Hermitian."""
    mod, so = emulate
    errs = mod.two_pass(so, n, batch, np.random.default_rng(n + batch))
    assert np.all(np.asarray(errs) <= TOL_EMU), (n, batch, errs)


@pytest.mark.parametrize("hw", [(128, 128), (16, 64), (64, 8), (2, 2)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_emulated_fft2_fused_r2_matches_plain(emulate, hw):
    """repro_fft2_fused at radix 2, forward and inverse (``emulate.frames``
    at radix 2): the 128x128 instance and the runtime-geometry one on wide,
    tall and one-pass frames; rfft2 (register passes too) and irfft2 (the
    stage panel) at radix 2 beside them."""
    mod, so = emulate
    h, w = hw
    errs, lines = mod.frames(so, h, w, np.random.default_rng(h * 1000 + w), radix=2)
    assert len(errs) == 4 and np.all(np.asarray(errs) <= TOL_EMU), (hw, lines)


def test_emulated_entries_refuse_a_geometry_off_the_census(emulate):
    """The C entries keep their validation: the census's threads and shared
    memory, its panel and tile widths (one instance each), power-of-two
    sides; and the radix argument is gone."""
    _, so = emulate
    n, b = 2 ** 15, 1
    g = k.two_pass_geometry(n)
    x = np.zeros((b, n), np.complex64)
    y = np.zeros_like(x)
    cols = (x.ctypes.data, y.ctypes.data, b, g.n1, g.n2)
    assert so.repro_two_pass_columns(*cols, g.cols, g.col_threads, g.col_smem, 0, 0, None) == 0
    assert so.repro_two_pass_columns(*cols, g.cols, g.col_threads, g.col_smem - 8, 0, 0,
                                     None) == 9
    assert so.repro_two_pass_columns(*cols, g.cols, 2 * g.col_threads, g.col_smem, 0, 0,
                                     None) == 9
    assert so.repro_two_pass_columns(*cols, 2 * g.cols, 2 * g.col_threads,
                                     2 * g.col_smem, 0, 0, None) == 1  # no such instance
    assert so.repro_two_pass_columns(x.ctypes.data, y.ctypes.data, b, 3 * 64, 128, g.cols,
                                     g.col_threads, g.col_smem, 0, 0, None) == 1
    rows = (x.ctypes.data, y.ctypes.data, b, g.n1, g.n2)
    assert so.repro_two_pass_rows(*rows, g.rows, g.row_threads, g.row_smem, 0, 1.0, 0, None) == 0
    assert so.repro_two_pass_rows(*rows, g.rows, g.row_threads, g.row_smem - 8, 0, 1.0, 0,
                                  None) == 9
    assert so.repro_two_pass_rows(*rows, g.rows // 2, g.row_threads // 2, g.row_smem, 0, 1.0, 0,
                                  None) == 1


# -------------------------- the model of the passes -------------------------

HALF_WARP = 16
WARP = 32
_slot = k.smem_slot  # works on numpy arrays too


def _ways(addr, threads):
    """Bank ways of one shared-memory instruction (addr: the slot each
    thread touches, -1 none): the most distinct slots of a half-warp that
    share a bank pair (slot mod 16)."""
    worst = 1
    for h0 in range(0, threads, HALF_WARP):
        a = addr[h0:h0 + HALF_WARP]
        a = np.unique(a[a >= 0])
        if len(a):
            worst = max(worst, int(np.bincount(a % 16).max()))
    return worst


def _sectors(addr, threads):
    """(sectors touched, fewest possible) of the worst warp of one HBM
    instruction (addr: the complex value each thread moves, -1 none):
    32-byte sectors of 4 values."""
    worst = (0, 0)
    for w0 in range(0, threads, WARP):
        a = addr[w0:w0 + WARP]
        a = np.unique(a[a >= 0])
        if len(a):
            got = (len(np.unique(a // 4)), -(-len(a) // 4))
            worst = max(worst, got, key=lambda s: s[0] - s[1])
    return worst


def _log2(v):
    return v.bit_length() - 1


def _first_row_lanes(g, log_s):
    """``FirstRowLanes`` in csrc/fft_two_pass.cu: (line, t) of group g."""
    t = g & ((1 << log_s) - 1)
    q = g >> log_s
    if log_s == 3:
        q = (q & ~9) | ((q & 1) << 3) | ((q >> 3) & 1)
    return q, t


def _column_lanes(width):
    """``Lanes<true>`` over lines that are ``width`` neighbouring columns."""
    return lambda g, log_s: (g % width, g // width)


class _Pass:
    """One register pass of radix R over span l on lines of n values, its
    groups mapped to ``threads`` threads by ``lanes``."""

    def __init__(self, n, lines, radix, log_l, lanes):
        self.n, self.radix, self.log_l = n, radix, log_l
        self.threads = lines * n // 16
        self.s, self.l = n // radix, 1 << log_l
        tid = np.arange(self.threads)
        self.slots = []  # per group slot of a thread: (ok, line, t)
        for i in range(16 // radix):
            g = tid + i * self.threads
            line, t = lanes(g, _log2(self.s))
            self.slots.append((g < lines * n // radix, line, t))

    def reads(self):
        """(ok, line, element) of each read instruction."""
        for ok, line, t in self.slots:
            for j in range(self.radix):
                yield ok, line, t + j * self.s

    def writes(self):
        for ok, line, t in self.slots:
            pos = (t // self.l) * self.radix * self.l + t % self.l
            for c in range(self.radix):
                yield ok, line, pos + c * self.l

    def twiddles(self, log_half):
        """ROM entries each r2_layers read of the pass takes (a first pass's
        W = 1 is no read): W_{2 half}^e at e = (k + l c) 2^(log_half - log l
        - s)."""
        for ok, _, t in self.slots:
            kk = t % self.l
            for st in range(_log2(self.radix)):
                for h in range(1 << st):
                    c = k._bit_reverse(h, st)
                    if self.log_l == 0 and c == 0:
                        continue
                    e = (kk + (c << self.log_l)) << (log_half - self.log_l - st)
                    yield ok, e


def _passes(n, lines, first_lanes, lanes):
    out, log_l = [], 0
    for p, radix in enumerate(k.regpass_radices(n)):
        out.append(_Pass(n, lines, radix, log_l, first_lanes if p == 0 else lanes))
        log_l += _log2(radix)
    return out


def _column_pass_model(n):
    """Every access of the column pass on rows of n: {what: [ways or
    (sectors, fewest)]}, and the slots each exchange wrote (must be every
    slot of its layout once)."""
    g = k.two_pass_geometry(n)
    n1, n2, c = g.n1, g.n2, g.cols
    lanes = _column_lanes(c)
    passes = _passes(n1, c, lanes, lanes)
    rom0 = _slot(c * n1)
    out, written = {}, []
    for p, ps in enumerate(passes):
        last = p == len(passes) - 1
        src_pad = p == 1  # the first exchange is padded (SmemFrame<true>)
        for ok, line, i in ps.reads():
            if p == 0:  # HBM: x[i n2 + c0 + line], c0 = 0
                out.setdefault("loads", []).append(
                    _sectors(np.where(ok, i * n2 + line, -1), ps.threads))
            else:
                idx = i * c + line
                a = np.where(ok, _slot(idx) if src_pad else idx, -1)
                out.setdefault(f"pass {p} reads", []).append(_ways(a, ps.threads))
        wrote = []
        for ok, line, i in ps.writes():
            if last:  # HBM: the twiddled scratch, y[k1 n2 + j2]
                out.setdefault("twiddled stores", []).append(
                    _sectors(np.where(ok, i * n2 + line, -1), ps.threads))
            else:
                idx = i * c + line
                a = np.where(ok, _slot(idx) if p == 0 else idx, -1)
                out.setdefault(f"pass {p} writes", []).append(_ways(a, ps.threads))
                wrote.append(a[a >= 0])
        if not last:
            want = _slot(np.arange(c * n1)) if p == 0 else np.arange(c * n1)
            written.append((np.sort(np.concatenate(wrote)), want))
        for ok, e in ps.twiddles(_log2(n1) - 1):
            out.setdefault("twiddle reads", []).append(
                _ways(np.where(ok, rom0 + _slot(e), -1), ps.threads))
    return out, written


def _row_pass_model(n):
    """The same for the row pass: its tile of T rows, S slots apart."""
    g = k.two_pass_geometry(n)
    n1, n2, t_rows = g.n1, g.n2, g.rows
    stride = k.two_pass_row_stride(n2, t_rows)
    passes = _passes(n2, t_rows, _first_row_lanes, _column_lanes(t_rows))
    rom0 = t_rows * stride
    out, written = {}, []
    for p, ps in enumerate(passes):
        last = p == len(passes) - 1
        for ok, line, i in ps.reads():
            if p == 0:  # HBM: the tile's rows, one contiguous run
                out.setdefault("loads", []).append(
                    _sectors(np.where(ok, line * n2 + i, -1), ps.threads))
            else:
                a = np.where(ok, line * stride + _slot(i), -1)
                out.setdefault("turned reads", []).append(_ways(a, ps.threads))
        wrote = []
        for ok, line, i in ps.writes():
            if last:  # HBM: out[k2 n1 + k0 + line], k0 = 0
                out.setdefault("turned stores", []).append(
                    _sectors(np.where(ok, i * n1 + line, -1), ps.threads))
            else:
                a = np.where(ok, line * stride + _slot(i), -1)
                out.setdefault(f"pass {p} writes", []).append(_ways(a, ps.threads))
                wrote.append(a[a >= 0])
        if not last:
            rows = np.arange(t_rows).reshape(-1, 1)
            want = (rows * stride + _slot(np.arange(n2)).reshape(1, -1)).ravel()
            written.append((np.sort(np.concatenate(wrote)), np.sort(want)))
        for ok, e in ps.twiddles(_log2(n2) - 1):
            out.setdefault("twiddle reads", []).append(
                _ways(np.where(ok, rom0 + _slot(e), -1), ps.threads))
    return out, written


@pytest.mark.parametrize("n", TWO_PASS)
@pytest.mark.parametrize("which", ["columns", "rows"])
def test_two_pass_accesses_are_conflict_free_and_whole_sectors(n, which):
    """Every shared-memory access of both passes, at every line length the
    census launches, falls on distinct bank pairs per half-warp: the
    column pass's exchanges through the padded frame of C columns (its
    half-warps take 16 neighbouring columns), the row pass's first-pass
    writes (stride 16, padded inside a row; at n2 = 128 the half-warp's two
    rows 8 apart) and its turned reads and writes (16 neighbouring rows, S
    odd); every twiddle read is a broadcast. Every warp's HBM load and
    store touches the fewest 32-byte sectors its values fill: runs of C or
    T neighbouring values of a row (128 bytes or more), the row pass's loads
    runs of 8 or 16 neighbouring values of a row. Every exchange writes each
    slot of its layout once."""
    model, written = (_column_pass_model if which == "columns" else _row_pass_model)(n)
    for what, got in model.items():
        if what in ("loads", "stores", "twiddled stores", "turned stores"):
            assert all(s == f for s, f in got), (n, which, what, max(got))
        else:
            assert max(got) == 1, (n, which, what, max(got))
    for slots, want in written:
        assert np.array_equal(slots, want), (n, which)


@pytest.mark.parametrize("n", LONG)
@pytest.mark.parametrize("which", ["columns", "rows"])
def test_long_row_accesses_are_conflict_free_and_whole_sectors(n, which):
    """The same model at the instances of the rows past 2^18 (n1, n2 = 1024,
    2048, 4096; 1024 threads a block): panels and tiles of 16, 8 and 4
    lines, whose half-warps take 16/C (16/T) neighbouring groups t of C (T)
    lines. The tile's rows S = padded(n2) + 16/T slots apart keep the
    turned reads and writes on 16 bank pairs; every HBM run is a whole
    32-byte sector or more; each exchange writes each slot once. The
    twiddle reads of the 4-line instances (n1 or n2 = 4096) meet 2 ways:
    the half-warp's 4 groups read 4 ROM entries 2^7 or more apart, whose
    padded slots fall on 2 bank pairs (fft2_columns.cu's 4096-row panel
    reads its ROM so too); all others are broadcasts or 1 way."""
    g = k.two_pass_geometry(n)
    lines = g.cols if which == "columns" else g.rows
    model, written = (_column_pass_model if which == "columns" else _row_pass_model)(n)
    for what, got in model.items():
        if what in ("loads", "twiddled stores", "turned stores"):
            assert all(s == f for s, f in got), (n, which, what, max(got))
        elif what == "twiddle reads":
            assert max(got) == (2 if lines == 4 else 1), (n, which, what, max(got))
        else:
            assert max(got) == 1, (n, which, what, max(got))
    for slots, want in written:
        assert np.array_equal(slots, want), (n, which)


def test_the_model_sees_the_conflicts_the_layout_removes():
    """The model is not blind: with the rows S = padded(n2) slots apart (an
    even stride) the turned reads of 16 neighbouring rows meet 2 bank
    pairs at n2 = 128 (8-way); with the plain first-pass mapping (rows q
    and q + 1 in a half-warp) the first pass's writes at n2 = 128 are
    2-way."""
    n2, t_rows = 128, 32
    ps = _passes(n2, t_rows, _first_row_lanes, _column_lanes(t_rows))
    even = _slot(n2)
    ways = [_ways(np.where(ok, line * even + _slot(i), -1), ps[1].threads)
            for ok, line, i in ps[1].reads()]
    assert max(ways) == 8
    plain = _Pass(n2, t_rows, 16, 0, lambda g, log_s: (g >> log_s, g & ((1 << log_s) - 1)))
    stride = k.two_pass_row_stride(n2)
    ways = [_ways(np.where(ok, line * stride + _slot(i), -1), plain.threads)
            for ok, line, i in plain.writes()]
    assert max(ways) == 2


@pytest.mark.parametrize("n2,t_rows,ways", [(2048, 8, 2), (4096, 4, 4)])
def test_the_model_sees_the_conflicts_of_an_odd_stride_under_16_rows(n2, t_rows, ways):
    """With tiles of T < 16 rows kept S = padded(n2) + 1 slots apart, a
    half-warp's T rows at 16/T neighbouring groups overlap on the bank
    pairs (16/T ways); S = padded(n2) + 16/T is what removes it."""
    ps = _passes(n2, t_rows, _first_row_lanes, _column_lanes(t_rows))
    odd = _slot(n2) + 1
    got = [_ways(np.where(ok, line * odd + _slot(i), -1), ps[1].threads)
           for ok, line, i in ps[1].reads()]
    assert max(got) == ways
    stride = k.two_pass_row_stride(n2, t_rows)
    got = [_ways(np.where(ok, line * stride + _slot(i), -1), ps[1].threads)
           for ok, line, i in ps[1].reads()]
    assert max(got) == 1


# ------------------------------ census and route -----------------------------


def test_census_launches_one_instance_a_line_length():
    """The row lengths the two passes serve (complex 2^15 ... 2^18, real
    rows' halves 2^14 ... 2^17) split into n1, n2 = 128, 256, 512; each has
    one panel width and one tile width (the C instances of
    fft_two_pass.cu), 16 values a thread, within one block's shared memory;
    the register-pass census pads the panel and both ROMs."""
    instances = set()
    for n in TWO_PASS:
        g = k.two_pass_geometry(n)
        instances |= {("columns", g.n1, g.cols), ("rows", g.n2, g.rows)}
        assert g.col_threads * 16 == g.cols * g.n1 and g.row_threads * 16 == g.rows * g.n2
        assert g.col_smem == (_slot(g.cols * g.n1) + _slot(g.n1 // 2)) * 8
        assert g.row_smem == (g.rows * (_slot(g.n2) + 1) + _slot(g.n2 // 2)) * 8
        assert k.two_pass_row_stride(g.n2) % 2 == 1
        assert max(g.col_smem, g.row_smem) <= 72_000 and max(g.col_threads, g.row_threads) <= 512
    assert instances == {("columns", 128, 32), ("columns", 256, 16), ("columns", 512, 16),
                         ("rows", 128, 32), ("rows", 256, 16), ("rows", 512, 16)}


@pytest.mark.parametrize("kind,n,want", [("fft", 2 ** 18, ["columns", "rows"]),
                                         ("fft", 2 ** 15, ["columns", "rows"]),
                                         ("rfft", 2 ** 16, ["columns", "rows", "recombine"]),
                                         ("irfft", 2 ** 16, ["untangle", "columns", "rows"])])
def test_wrappers_take_the_two_pass_entries_on_meta_tensors(monkeypatch, kind, n, want):
    """On a meta tensor the radix-2 wrappers take the card route up to the
    launch: rows over one block call the two passes' C entries (with the
    census's geometry, no radix), in order, all charged to
    ``fft_two_pass``: 2 launches a complex call and 3 a real one on the
    card; nothing is launched or counted here."""
    calls = []
    real_launch = k._launch

    def record(entry, name, x, *args):
        calls.append((entry, name, args))
        return real_launch(entry, name, x, *args)

    monkeypatch.setattr(k, "_launch", record)
    k.reset_launches()
    if kind == "fft":
        k.fft_fused(torch.empty(2, n, dtype=torch.complex64, device="meta"), radix=2)
    elif kind == "rfft":
        k.rfft_fused(torch.empty(2, n, device="meta"), radix=2)
    else:
        k.irfft_fused(torch.empty(2, n // 2 + 1, dtype=torch.complex64, device="meta"), radix=2)
    assert [entry for entry, _, _ in calls] == [f"repro_two_pass_{w}" for w in want]
    assert {name for _, name, _ in calls} == {"fft_two_pass"}
    assert not any(k.LAUNCHES.values())
    g = k.two_pass_geometry(n if kind == "fft" else n // 2)
    by_entry = {entry: args for entry, _, args in calls}
    assert by_entry["repro_two_pass_columns"][2:] == (2, g.n1, g.n2, g.cols, g.col_threads,
                                                      g.col_smem, int(kind == "irfft"))
    assert by_entry["repro_two_pass_rows"][2:7] == (2, g.n1, g.n2, g.rows, g.row_threads)
