"""The register-pass panels of the radix-4 ``irfft_fused`` and ``irfft2_fused``.

``csrc/fft_fused.cu`` (``irfft_regs_kernel``) and ``csrc/rfft2_fused.cu``
(``irfft2_regs_kernel``) run on the card only. Here, on the CPU:

* their twins (the plain versions at radix 4: ``_irfft_panel`` on
  ``_regpass_panel``, and ``_irfft2_regpass``, the kernel's own order) are
  held to the Pallas kernels in interpret mode and to numpy at
  max|port - ref| <= 1e-5 * max|ref| (the reference's kernel tolerance), on
  rows n = 4 ... 2^14 and on square, non-square and thin frames, with half
  spectra that are not Hermitian: the imaginary parts that the inverse
  drops (the DC and Nyquist bins of a row; the anti-Hermitian parts of the
  DC and Nyquist columns of a frame) must be dropped as numpy drops them;
* a numpy model of the kernels' accesses replays each thread's reads and
  writes in every pass at the census's launch geometry: the distinct 8-byte
  slots of each half-warp fall in distinct bank pairs (slot mod 16), the
  untangle's mirror reads included; every pass through shared memory writes
  each slot of its layout once; and each warp's loads of the half spectra
  and stores of the packed reals are runs of consecutive addresses per row;
* the census: padding the irfft block leaves every row fitting one block
  where it fitted before, and the frames stay the 105 of rfft2_fused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch.kernels import fft_radix2 as k

TOL = 1e-5
SIZES = [2 ** p for p in range(2, 15)]
FRAMES = [(2, 2), (8, 8), (16, 64), (64, 16), (128, 128), (128, 256), (8, 2), (2, 512)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ------------------------------- the twins ---------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_irfft_regpass_twin_matches_pallas_and_numpy(n):
    """A half spectrum that is not Hermitian: the kernel, the Pallas kernel
    and numpy all drop the imaginary parts of its DC and Nyquist bins."""
    batch = 5 if n <= 1024 else 3
    y = _crandn(np.random.default_rng(5 * n), (batch, n // 2 + 1))
    ref = np.asarray(jref.irfft_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=4,
                                      interpret=True))
    got = k.irfft_fused(torch.from_numpy(y), radix=4).numpy()
    _close(got, ref)
    _close(got, np.fft.irfft(y.astype(np.complex128), n))
    _close(k.irfft_fused_plain(torch.from_numpy(y), radix=4).numpy(), ref)


@pytest.mark.parametrize("hw", FRAMES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_irfft2_regpass_twin_matches_pallas_and_numpy(hw):
    h, w = hw
    rng = np.random.default_rng(11 * h + w)
    y = _crandn(rng, (3, h, w // 2 + 1))
    ref = np.asarray(jref.irfft2_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=4,
                                       interpret=True))
    got = k.irfft2_fused(torch.from_numpy(y), radix=4).numpy()
    _close(got, ref)
    _close(got, np.fft.irfft2(y.astype(np.complex128), s=(h, w)))
    # the round trip through rfft2_fused closes
    x = rng.standard_normal((2, h, w)).astype(np.float32)
    back = k.irfft2_fused(k.rfft2_fused(torch.from_numpy(x), radix=4), radix=4).numpy()
    _close(back, x, tol=1e-4)


@pytest.mark.parametrize("n", [4, 64, 2048])
def test_irfft_drops_the_imaginary_parts_of_dc_and_nyquist(n):
    """Changing Im Y[0] and Im Y[N/2] changes nothing."""
    y = _crandn(np.random.default_rng(n), (3, n // 2 + 1))
    z = y.copy()
    z[:, 0] += 5j
    z[:, -1] -= 3j
    a = k.irfft_fused(torch.from_numpy(y), radix=4).numpy()
    b = k.irfft_fused(torch.from_numpy(z), radix=4).numpy()
    assert np.array_equal(a, b)


@pytest.mark.parametrize("hw", [(2, 2), (8, 16), (64, 64), (128, 2)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_irfft2_drops_the_anti_hermitian_parts_of_dc_and_nyquist(hw):
    """The row inverse keeps only the real parts of the DC and Nyquist
    columns' inverses: adding d with d[-r] = -conj d[r] to either column
    changes the frame by rounding only, as in numpy."""
    h, w = hw
    rng = np.random.default_rng(h + 7 * w)
    y = _crandn(rng, (2, h, w // 2 + 1))
    d = _crandn(rng, (2, h))
    d = d - np.conj(d[:, (-np.arange(h)) % h])  # anti-Hermitian
    z = y.copy()
    z[:, :, 0] += d
    z[:, :, -1] += 2 * d
    a = k.irfft2_fused(torch.from_numpy(y), radix=4).numpy()
    b = k.irfft2_fused(torch.from_numpy(z), radix=4).numpy()
    _close(b, a)
    _close(b, np.fft.irfft2(z.astype(np.complex128), s=(h, w)))


def test_exchanges_and_barriers_of_chip_smokes_rows():
    """irfft_fused on rows of 2048: its half row of 1024 is 16·16·4, two
    exchanges and three barriers, the untangle adding neither; on every
    one-block row it counts what fft_fused counts on the half row."""
    assert (k.regpass_exchanges(2048, real=True, inverse=True),
            k.regpass_barriers(2048, real=True, inverse=True)) == (2, 3)
    for n in (2 ** p for p in range(1, 15)):
        assert k.regpass_exchanges(n, real=True, inverse=True) == k.regpass_exchanges(n // 2)
        assert k.regpass_barriers(n, real=True, inverse=True) == k.regpass_barriers(n // 2)


def test_frame_passes_of_the_serving_frame():
    """irfft2_fused on chip_smoke's (128, 128) frames: columns 16·8, rows of
    64 16·4, three exchanges and five barriers (no split barrier: the DC and
    Nyquist columns are packed in the first column pass's reads)."""
    assert k.frame_passes(128, 128, real=True, inverse=True) == ((16, 4), (16, 8), 3, 5)
    assert k.frame_passes(2, 2, real=True, inverse=True) == ((1,), (2,), 1, 1)
    assert k.frame_passes(128, 128, real=True) == ((16, 4), (16, 8), 3, 6)


# ------------------------- the model of the accesses -------------------------

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
        for h, row in enumerate(a):
            slots = np.unique(row[row >= 0])
            if len(np.unique(slots % 16)) < len(slots):
                bad.append((n, h))
    return bad


def _runs_per_row(instrs, threads, row_len):
    """True when every warp's addresses in each instruction form one run of
    consecutive addresses per row of ``row_len``."""
    pad = (-threads) % WARP
    for a in instrs:
        for warp in np.concatenate([a, np.full(pad, -1)]).reshape(-1, WARP):
            warp = np.unique(warp[warp >= 0])
            rows = warp // row_len
            for r in np.unique(rows):
                run = warp[rows == r]
                if run[-1] - run[0] + 1 != len(run):
                    return False
    return True


def _at(i, padded):
    return np.where(i >= 0, _slot(i) if padded else i, -1)


class _Block:
    """One block of P = lines x w values (a tile of rows, or a frame of h
    rows of m) at the census's threads, and the maps of ``Lanes``."""

    def __init__(self, lines, w):
        self.lines, self.w, self.P = lines, w, lines * w
        self.T = k.block_threads(self.P)

    def index(self, line, i, cols):
        return i * self.w + line if cols else line * self.w + i

    def groups(self, radix, n, cols):
        """(ok, line, t) per group slot of a pass of ``radix`` over lines of n."""
        tid = np.arange(self.T)
        for i in range(16 // radix):
            g = tid + i * self.T
            ok = g < self.P // radix
            if cols:
                yield ok, g % self.w, g // self.w
            else:
                yield ok, g // (n // radix), g % (n // radix)


def _panel(bl, cols, src_first, dst_last, first_reads=None):
    """One ``frame_panel`` (or ``panel``): its shared-memory instructions, the
    slots each pass through shared memory wrote (with their layout), and the
    elements its last pass stores to HBM when ``dst_last`` is None.
    ``src_first``: the layout the first pass reads (None: HBM, where
    ``first_reads(ok, line, t, s, radix)`` gives its loads);
    ``dst_last``: the layout the last pass writes (None: HBM). Between them
    the first pass writes the padded layout and the middle passes the plain
    one."""
    n = bl.lines if cols else bl.w
    radices = k.regpass_radices(n)
    instrs, written, stores, loads = [], [], [], []
    log_l = 0
    for p, radix in enumerate(radices):
        last = p == len(radices) - 1
        s, l = n // radix, 1 << log_l
        src = src_first if p == 0 else p == 1
        dst = dst_last if last else p == 0
        wrote = []
        for ok, line, t in bl.groups(radix, n, cols):
            if src is not None:
                for j in range(radix):
                    instrs.append(_at(np.where(ok, bl.index(line, t + j * s, cols), -1), src))
            if p == 0 and first_reads is not None:
                extra = first_reads(ok, line, t, s, radix)
                (loads if src is None else instrs).extend(extra)
            pos = (t // l) * radix * l + t % l
            for c in range(radix):
                a = np.where(ok, bl.index(line, pos + c * l, cols), -1)
                if dst is None:
                    stores.append(a)
                else:
                    a = _at(a, dst)
                    instrs.append(a)
                    wrote.append(a[a >= 0])
        if dst is not None:
            written.append((np.concatenate(wrote), dst))
        log_l += radix.bit_length() - 1
    return instrs, written, stores, loads


def _row_mirrors(m):
    """The elements of its own row that lane t reads at step j of the first
    row pass as the mirror of k = t + j s (``UntangledRows``: group s - t in
    reverse), and the one it untangles k with: its read, but for lane 0 the
    previous step's read, and at k = 0 the packed slot: (read, used) per
    (t, j)."""
    radix = k.regpass_radices(m)[0]
    s = m // radix
    t = np.arange(s).reshape(s, 1)
    j = np.arange(radix).reshape(1, radix)
    read = (s - t) % s + (radix - 1 - j) * s
    carried = np.roll(read, 1, axis=1)
    carried[:, 0] = 0
    return read, np.where(t == 0, carried, read)


def _irfft2_accesses(h, w):
    """Every shared-memory instruction of the radix-4 irfft2_fused on one
    frame, the slots each pass wrote, the column panel's HBM loads (element
    offsets in the (H, m+1) half spectrum) and the row panel's HBM stores
    (offsets in the (H, m) packed output)."""
    m = w // 2
    bl = _Block(h, m)

    def col_loads(ok, c, t, s, radix):  # HalfSpectrumCols: x[r (m+1) + c]
        return [np.where(ok, (t + j * s) * (m + 1) + c, -1) for j in range(radix)]

    padded = m < 256  # C's layout (irfft2_regs_kernel)

    def row_mirrors(ok, r, t, s, radix):  # UntangledRows: group s - t, reversed
        read, _ = _row_mirrors(m)
        return [_at(np.where(ok, r * m + read[t, j], -1), padded) for j in range(radix)]

    instrs, written, _, loads = _panel(bl, True, None, padded, col_loads)
    row_instrs, row_written, stores, _ = _panel(bl, False, padded, None, row_mirrors)
    return bl, instrs + row_instrs, written + row_written, loads, stores


def _irfft_accesses(n, batch):
    """The same for the radix-4 irfft_fused on rows of n, the tile the census
    picks for ``batch`` rows: HBM loads of Y[k] and Y[m-k], element offsets
    in the (rows, m+1) half spectra."""
    m = n // 2
    bl = _Block(k.pick_row_tile(batch, m), m)

    def untangle_loads(ok, line, t, s, radix):  # UntangledHalfRows
        out = []
        for j in range(radix):
            out.append(np.where(ok, line * (m + 1) + t + j * s, -1))
            out.append(np.where(ok, line * (m + 1) + m - t - j * s, -1))
        return out

    instrs, written, stores, loads = _panel(bl, False, None, None, untangle_loads)
    return bl, instrs, written, loads, stores


ALL_REAL = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)
            if k.rfft2_fits_smem(1 << a, 1 << b)]


def test_row_untangle_reads_the_mirror_of_each_bin():
    """UntangledRows' index map: lane t > 0 reads m - k from group s - t;
    lane 0 reads its own group in reverse and untangles k with the value
    read one step before, (m - k) mod m; k = 0 (lane 0, j = 0) is the
    packed slot itself. Rows of 2 ... 8192."""
    for m in (2 ** p for p in range(1, 14)):
        radix = k.regpass_radices(m)[0]
        s = m // radix
        kk = np.arange(s).reshape(s, 1) + np.arange(radix).reshape(1, radix) * s
        _, used = _row_mirrors(m)
        assert np.array_equal(used, (m - kk) % m), m


def test_irfft2_accesses_are_conflict_free():
    """Every admitted frame (105, among them the frames under 16 wide and
    the thin ones): every pass's reads and writes, the column panel's padded
    output and the untangle's reads of Z and of its mirror, fall in distinct
    bank pairs per half-warp."""
    for h, w in ALL_REAL:
        bl, instrs, _, _, _ = _irfft2_accesses(h, w)
        assert not _bank_conflicts(instrs, bl.T), (h, w)


def test_irfft2_passes_write_each_slot_once():
    for h, w in ALL_REAL:
        bl, _, written, _, _ = _irfft2_accesses(h, w)
        for slots, padded in written:
            assert np.array_equal(np.sort(slots), _at(np.arange(bl.P), padded)), (h, w)


def test_irfft2_hbm_loads_and_stores_coalesce():
    """Each warp's loads of the half spectrum (rows of m+1 bins) and stores
    of the packed reals (rows of m) are one run of consecutive addresses per
    row."""
    for h, w in ALL_REAL:
        bl, _, _, loads, stores = _irfft2_accesses(h, w)
        m = w // 2
        assert _runs_per_row(loads, bl.T, m + 1), (h, w)
        assert _runs_per_row(stores, bl.T, m), (h, w)


@pytest.mark.parametrize("n", [2 ** p for p in range(1, 15)])
def test_irfft_accesses(n):
    """The radix-4 irfft_fused on chip_smoke's batch of 8192 rows and on one
    row: shared-memory exchanges free of bank conflicts, each slot written
    once a pass, the untangle's loads of Y[k] and of the mirror Y[m-k] and
    the stores one run per row."""
    m = n // 2
    for batch in (8192, 1):
        bl, instrs, written, loads, stores = _irfft_accesses(n, batch)
        assert not _bank_conflicts(instrs, bl.T), (n, batch)
        for slots, padded in written:
            assert np.array_equal(np.sort(slots), _at(np.arange(bl.P), padded)), (n, batch)
        assert _runs_per_row(loads, bl.T, m + 1), (n, batch)
        assert _runs_per_row(stores, bl.T, m), (n, batch)


# ------------------------------- census -------------------------------------


def test_census_admits_the_same_rows_and_frames():
    """The padded irfft block (values and ROM, one slot per 16) leaves every
    power of two up to 2^18 fitting one block where the unpadded one fitted,
    and the whole-frame census admits the same 105 real frames."""
    for n in (2 ** p for p in range(1, 19)):
        m = n // 2
        old = (2 * m + 1) * 8 <= k.SMEM_BUDGET_BYTES and k.block_threads(max(m, 1)) <= 1024
        assert k.fft_fits_smem(n, real=True) == old, n
    assert k.irfft_smem_bytes(2048, 4) == (_slot(4096) + _slot(1024)) * 8
    assert k.irfft_smem_bytes(16384) <= k.rfft_smem_bytes(16384) <= k.SMEM_BUDGET_BYTES
    assert len(ALL_REAL) == 105
