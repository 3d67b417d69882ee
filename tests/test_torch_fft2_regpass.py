"""The register-pass panels of the radix-4 ``fft2_fused`` and ``rfft2_fused``.

``csrc/fft2_fused.cu`` and ``csrc/rfft2_fused.cu`` run on the card only.
Here, on the CPU:

* their twins (the plain versions at radix 4: ``_regpass_panel`` over the
  rows, then over the columns; for ``rfft2_fused`` the kernel's packed
  recombination and column-0 split) are held to the Pallas kernels in
  interpret mode and to numpy at max|port - ref| <= 1e-5 * max|ref| (the
  reference's kernel tolerance), forward and inverse, on square, non-square
  and thin frames;
* a numpy model of the kernels' shared-memory accesses replays each
  thread's reads and writes in every pass (rows: consecutive threads on
  consecutive groups of a row; columns: on consecutive columns) and the
  recombination's reads of Z[r][c] and its mirror Z[r][m-c], at the
  census's launch geometry, and asserts that every slot of a pass's layout
  is written exactly once and that the distinct 8-byte slots of each
  half-warp fall in distinct bank pairs (slot mod 16); it also asserts that
  each warp's stores to HBM from the last column pass are runs of
  consecutive addresses, and that rfft2_fused's column-0 exchange (the
  packed DC + i Nyquist column stored by the last pass, read back from the
  output after a barrier and split by one thread per row pair) gives every
  row to exactly one thread, with its mirror;
* the census: padding the frame and the ROM leaves exactly the frames that
  fitted before, and the limit stays the 1024 threads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch.kernels import fft_radix2 as k

TOL = 1e-5
FRAMES = [(2, 2), (8, 8), (16, 64), (64, 16), (2, 512), (512, 2), (4, 32), (128, 128)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


# ------------------------------- the twins ---------------------------------


@pytest.mark.parametrize("hw", FRAMES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_fft2_regpass_twin_matches_pallas_and_numpy(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    x = (rng.standard_normal((3, *hw)) + 1j * rng.standard_normal((3, *hw))).astype(np.complex64)
    yr, yi = jref.fft2_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=4, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    t = torch.from_numpy(x)
    got = k.fft2_fused(t, radix=4).numpy()
    _close(got, ref)
    _close(got, np.fft.fft2(x.astype(np.complex128)))
    _close(k.fft2_fused(t, radix=4, inverse=True).numpy(), np.fft.ifft2(x.astype(np.complex128)))


@pytest.mark.parametrize("hw", FRAMES + [(8, 2), (2, 8), (64, 512)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_rfft2_regpass_twin_matches_pallas_and_numpy(hw):
    x = np.random.default_rng(7 * hw[0] + hw[1]).standard_normal((3, *hw)).astype(np.float32)
    yr, yi = jref.rfft2_fused(jnp.asarray(x), radix=4, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = k.rfft2_fused(torch.from_numpy(x), radix=4)
    _close(got.numpy(), ref)
    _close(got.numpy(), np.fft.rfft2(x.astype(np.float64)))
    # the inverse on its register passes; the round trip closes
    _close(k.irfft2_fused(got, radix=4).numpy(), x, tol=1e-4)


def test_frame_passes_of_the_serving_frame():
    """chip_smoke's (128, 128) frames: 16·8 each way, three exchanges and
    five barriers; rfft2's packed rows of 64 are 16·4, and its column-0
    split adds a barrier."""
    assert k.frame_passes(128, 128) == ((16, 8), (16, 8), 3, 5)
    assert k.frame_passes(128, 128, real=True) == ((16, 4), (16, 8), 3, 6)
    assert k.frame_passes(2, 2) == ((2,), (2,), 1, 1)
    assert k.frame_passes(8192, 2) == ((2,), (16, 16, 16, 2), 4, 7)


# --------------------- the model of shared memory ---------------------------

HALF_WARP = 16
WARP = 32
_slot = k.smem_slot  # works on numpy arrays too


def _bank_conflicts(instrs, threads):
    """Half-warps of the instructions (each an array of one slot per thread,
    -1: no access) whose distinct slots share a bank pair."""
    bad = []
    pad = (-threads) % HALF_WARP
    for n, a in enumerate(instrs):
        a = np.concatenate([a, np.full(pad, -1)]).reshape(-1, HALF_WARP)
        srt = np.sort(a, axis=1)
        new = np.ones_like(srt, dtype=bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        addrs = ((srt >= 0) & new).sum(axis=1)
        banks = np.sort(np.where(srt >= 0, srt % 16, -1), axis=1)
        bnew = np.ones_like(banks, dtype=bool)
        bnew[:, 1:] = banks[:, 1:] != banks[:, :-1]
        nbanks = ((banks >= 0) & bnew).sum(axis=1)
        bad += [(n, h) for h in np.nonzero(nbanks < addrs)[0]]
    return bad


class _Frame:
    """The launch geometry of one frame and the kernel's index maps."""

    def __init__(self, h, w, real):
        self.h, self.real = h, real
        self.wl = w // 2 if real else w  # row length in the block
        self.P = h * self.wl
        self.T = k.block_threads(self.P)
        self.rom = _slot(self.P)  # the ROM follows the padded frame
        self.log_rom = max(h, w).bit_length() - 1

    def index(self, line, i, cols):
        return i * self.wl + line if cols else line * self.wl + i

    @staticmethod
    def at(i, padded):
        return _slot(i) if padded else i

    def groups(self, radix, n, cols):
        """(ok, line, t) per group slot i of a pass of ``radix`` over lines
        of n (``Lanes`` in csrc/stockham_regs.cuh)."""
        tid = np.arange(self.T)
        for i in range(16 // radix):
            g = tid + i * self.T
            ok = g < self.P // radix
            if cols:
                yield ok, g % self.wl, g // self.wl
            else:
                s = n // radix
                yield ok, g // s, g % s


def _panel_accesses(fr, cols, src_pad, first_read=None):
    """Shared-memory instructions of one panel (``frame_panel``): a list of
    (what, slots) and the slots each pass wrote, per pass. ``src_pad`` is
    the layout the first pass reads (None: HBM); the first pass writes the
    padded layout, middle passes the plain one; the last pass of the row
    panel writes the plain layout (padded where it is the only pass), the
    column panel's last stores to HBM. ``first_read(ok, line, t, s, j)``
    adds the first pass's extra reads (rfft2's recombination)."""
    n = fr.h if cols else fr.wl
    radices = k.regpass_radices(n)
    instrs, written = [], []
    log_l = 0
    for p, radix in enumerate(radices):
        last = p == len(radices) - 1
        s, l = n // radix, 1 << log_l
        src = src_pad if p == 0 else p == 1
        dst = None if (cols and last) else (p == 0)
        wrote = []
        for ok, line, t in fr.groups(radix, n, cols):
            for j in range(radix):
                if src is not None:
                    instrs.append((f"pass {p} read",
                                   np.where(ok, fr.at(fr.index(line, t + j * s, cols), src), -1)))
                if p == 0 and first_read is not None:
                    instrs += first_read(ok, line, t, s, j)
            pos = (t // l) * radix * l + t % l
            for c in range(radix):
                if dst is not None:
                    a = np.where(ok, fr.at(fr.index(line, pos + c * l, cols), dst), -1)
                    instrs.append((f"pass {p} write", a))
                    wrote.append(a[a >= 0])
        if dst is not None:
            written.append((np.concatenate(wrote), dst))
        log_l += radix.bit_length() - 1
    return instrs, written


def _last_col_pass(fr):
    """(radix, ok, line, t, pos, l) of each group slot of the last column
    pass."""
    radix = k.regpass_radices(fr.h)[-1]
    l = fr.h // radix
    for ok, line, t in fr.groups(radix, fr.h, True):
        yield radix, ok, line, t, (t // l) * radix * l + t % l, l


def _frame_accesses(h, w, real):
    """Every shared-memory instruction of the radix-4 kernel on one (h, w)
    frame, the slots each pass wrote, and the HBM stores of its last column
    pass (per instruction, one address per thread)."""
    fr = _Frame(h, w, real)
    rows_single = len(k.regpass_radices(fr.wl)) == 1
    instrs, written = _panel_accesses(fr, False, None)
    extra = None
    if real:
        m = fr.wl

        def extra(ok, c, t, s, j):  # the mirror Z[r][m-c]
            mirror = fr.at(fr.index(m - np.maximum(c, 1), t + j * s, True), rows_single)
            return [("recombine mirror", np.where(ok, mirror, -1))]
    col_instrs, col_written = _panel_accesses(fr, True, rows_single, extra)
    instrs += col_instrs
    written += col_written
    stores = []
    out_w = fr.wl + 1 if real else fr.wl
    for radix, ok, line, t, pos, l in _last_col_pass(fr):
        for c in range(radix):
            stores.append(np.where(ok, (pos + c * l) * out_w + line, -1))
    return fr, instrs, written, stores


def _column0_split(h, w):
    """The rows whose DC and Nyquist bins each thread of rfft2_fused's split
    writes (rfft2_regs_kernel): thread r, for r <= h/2 (in steps of the
    block's threads), takes rows r and -r. {thread: [rows]}."""
    threads = _Frame(h, w, True).T
    rows = {}
    for r in range(h // 2 + 1):
        rows.setdefault(r % threads, []).extend({r, (h - r) % h})
    return rows


ALL_COMPLEX = [(1 << a, 1 << b) for a in range(1, 14) for b in range(1, 14)
               if k.fft2_fits_smem(1 << a, 1 << b)]
ALL_REAL = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)
            if k.rfft2_fits_smem(1 << a, 1 << b)]


@pytest.mark.parametrize("real", [False, True], ids=["fft2_fused", "rfft2_fused"])
def test_frame_exchanges_are_conflict_free(real):
    """Every frame the census admits (91 complex, 105 real, among them the
    frames under 16 wide, where a half-warp spans several rows): every
    pass's reads and writes and the recombination's reads of Z and of its
    mirror fall in distinct bank pairs per half-warp."""
    for h, w in (ALL_REAL if real else ALL_COMPLEX):
        fr, instrs, _, _ = _frame_accesses(h, w, real)
        assert not _bank_conflicts([a for _, a in instrs], fr.T), (h, w)


def test_column0_split_takes_each_row_once():
    """rfft2_fused's column-0 exchange: the last pass stores column 0 packed
    (DC + i Nyquist transformed); after the barrier each row of the frame
    gets its DC and Nyquist bins from exactly one thread, which reads the
    row and its mirror back, so no thread reads a bin another has
    rewritten."""
    for h, w in ALL_REAL:
        split = _column0_split(h, w)
        rows = [r for rs in split.values() for r in rs]
        assert sorted(rows) == list(range(h)), (h, w)
        for rs in split.values():
            assert all((h - r) % h in rs for r in rs), (h, w)


@pytest.mark.parametrize("real", [False, True], ids=["fft2_fused", "rfft2_fused"])
def test_every_pass_writes_each_slot_once(real):
    """Each pass through shared memory writes every slot of its layout (the
    padded one after a first pass) exactly once."""
    for h, w in (ALL_REAL if real else ALL_COMPLEX):
        fr, _, written, _ = _frame_accesses(h, w, real)
        for slots, padded in written:
            assert np.array_equal(np.sort(slots), fr.at(np.arange(fr.P), padded)), (h, w)


@pytest.mark.parametrize("real", [False, True], ids=["fft2_fused", "rfft2_fused"])
def test_last_pass_stores_coalesce(real):
    """Each warp's stores from the last column pass are runs of consecutive
    addresses: one run for fft2_fused; for rfft2_fused one per row touched
    (rows of W/2 + 1 bins; the split writes column W/2 and rewrites 0)."""
    for h, w in (ALL_REAL if real else ALL_COMPLEX):
        fr, _, _, stores = _frame_accesses(h, w, real)
        out_w = fr.wl + 1 if real else fr.wl
        for a in stores:
            pad = (-fr.T) % WARP
            for warp in np.concatenate([a, np.full(pad, -1)]).reshape(-1, WARP):
                warp = np.sort(warp[warp >= 0])
                if not len(warp):
                    continue
                rows = warp // out_w
                for r in np.unique(rows):
                    run = warp[rows == r]
                    assert run[-1] - run[0] + 1 == len(run), (h, w)
                if not real:
                    assert len(np.unique(rows)) == 1 or fr.wl < WARP, (h, w)
                    assert warp[-1] - warp[0] + 1 == len(warp), (h, w)


# ------------------------------- census -------------------------------------


def test_padded_census_admits_the_same_frames():
    """The census pads frame and ROM by one slot per 16; every frame fits
    exactly where the unpadded census fitted (91 complex, 105 real). The
    limit is the 1024 threads of 16 values: every frame of up to 16384
    values fits shared memory padded (at most 174,080 and 208,904 bytes)."""
    budget, threads = k.SMEM_BUDGET_BYTES, k.MAX_THREADS
    for a in range(1, 16):
        for b in range(1, 16):
            h, w = 1 << a, 1 << b
            old_c = ((h * w + max(h, w) // 2) * 8 <= budget
                     and k.block_threads(h * w) <= threads)
            old_r = ((h * (w // 2) + max(h, w) // 2 + 1) * 8 <= budget
                     and k.block_threads(h * (w // 2)) <= threads)
            assert k.fft2_fits_smem(h, w) == old_c, (h, w)
            assert k.rfft2_fits_smem(h, w) == old_r, (h, w)
            if old_c:
                assert k.fft2_smem_bytes(h, w) <= 174_080
            if old_r:
                assert k.rfft2_smem_bytes(h, w) <= 208_904
            # the frames one size past the envelope need 2048 threads
            if h * w == 2 * 16384:
                assert k.block_threads(h * w) > threads and not k.fft2_fits_smem(h, w)
            if h * (w // 2) == 2 * 16384:
                assert k.block_threads(h * (w // 2)) > threads and not k.rfft2_fits_smem(h, w)
    assert len(ALL_COMPLEX) == 91 and len(ALL_REAL) == 105
    assert k.fft2_smem_bytes(128, 128) == (_slot(16384) + _slot(64)) * 8
    assert k.rfft2_smem_bytes(128, 128) == (_slot(8192) + _slot(65)) * 8
