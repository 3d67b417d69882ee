"""The fused FFT kernels for Hopper, their plain versions and their census.

Port of ``repro.kernels.fft_radix2``. The TPU kernels kept a row tile or a
whole frame resident in VMEM and streamed every Stockham stage over it; the
CUDA kernels in ``csrc/`` keep the tile in one block's shared memory, which
on an H100 is 227 KB (232,448 bytes) rather than megabytes. Three things
live here:

* **The census.** The shared memory and threads each CUDA kernel really
  uses, derived from ``csrc/``: a block holds its P complex values (8 bytes
  each) once, because each pass is done in place through registers, plus
  one twiddle ROM, both padded by one slot per 16 (:func:`smem_slot`), the
  layout of the register-pass panel that every kernel runs at both
  radices. ``pick_row_tile``, ``fft_fits_smem``, ``fft2_fits_smem``, the
  two-pass, cluster and column-panel geometries, ``kernels.ops``, the engines' gate and
  the planner all read it. ``fft_fits_fused`` is the reference's
  envelope of the 1D kernels, rows of up to 2^18 values, which CPU keys
  plan by; ``fft_fits_card`` is the wrappers' own, rows of up to 2^24
  values, which CUDA keys plan by.
* **The plain versions**: ``_stockham_panel``, ``_stockham_panel_r4``,
  ``_rfft_panel`` and ``_irfft_panel`` as torch ops on (re, im) planes,
  step for step the Pallas panels, ``_regpass_panel`` (the register passes
  of ``csrc/stockham_regs.cuh``, which every kernel of this module runs at
  radix 4: the rows, the three whole-frame kernels over a frame's rows and
  columns, with ``_rfft2_regpass`` and ``_irfft2_regpass``, and
  ``fft2_columns``), ``_regpass_panel_r2`` (the same passes of radix-2
  layers, the schedule every kernel runs at radix 2, bit for bit
  ``_stockham_panel``, which stands for it as their plain version),
  ``_two_pass_panel`` (the
  four-step FFT of ``csrc/fft_two_pass.cu``), ``_cluster_panel`` (the one-trip four-step
  FFT of ``csrc/fft_cluster.cu``), and ``*_plain`` around them. They are
  what the CPU runs and what the kernels are held against on the card.
* **The wrappers** ``fft_fused``, ``rfft_fused``, ``irfft_fused``,
  ``fft2_fused``, ``rfft2_fused`` and ``irfft2_fused``, and
  ``fft2_columns``, the column pass of the composed 2D route on frames over
  one block (``csrc/fft2_columns.cu``: panels of neighbouring columns read
  in place from HBM, no corner turn). A CPU tensor takes the plain version. A CUDA tensor
  launches the kernel or raises; nothing falls back. Each launch adds one
  to ``LAUNCHES[name]`` (the registry of ``kernels._launch``, shared by
  every wrapper of the port). A 1D row over one block (2^14 < N <= 2^18)
  takes one cluster of CTAs at radix 4, counted under ``"fft_cluster"``,
  and the two-pass kernels at radix 2, counted under ``"fft_two_pass"``;
  a longer row (2^18 < N <= 2^24) takes the two-pass kernels at both
  radices.
  A meta tensor takes the card route up to the launch, launches nothing
  and charges the call's cost (``fft_cost``, ``rfft_cost``, ``fft2_cost``,
  ``rfft2_cost``, ``fft2_columns_cost``: the transform's bytes in and out)
  to an active cost counter, as the card route does (``kernels._launch``).

The wrappers take complex64 tensors (``torch.view_as_real`` layout, re/im
interleaved) where the Pallas ABI took separate planes: on the card the
interleaved pair is one 8-byte load.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._launch import LAUNCHES, Cost, charge, refuse_grad, reset_launches
from repro_torch.kernels._launch import launch as _launch

__all__ = [
    "LAUNCHES",
    "SMEM_BUDGET_BYTES",
    "cluster_exchanges",
    "cluster_geometry",
    "cluster_occupancy",
    "fft2_columns",
    "fft2_columns_cost",
    "fft2_columns_geometry",
    "fft2_columns_plain",
    "fft2_columns_serves",
    "fft2_cost",
    "fft2_fits_smem",
    "fft2_fused",
    "fft2_fused_plain",
    "fft2_smem_bytes",
    "fft_cost",
    "fft_fits_card",
    "fft_fits_fused",
    "fft_cluster_plain",
    "fft_fits_smem",
    "fft_fused",
    "fft_fused_plain",
    "fft_smem_bytes",
    "fft_split",
    "fft_two_pass_plain",
    "frame_passes",
    "irfft2_fused",
    "irfft2_fused_plain",
    "irfft_cluster_plain",
    "irfft_fused",
    "irfft_fused_plain",
    "irfft_smem_bytes",
    "irfft_two_pass_plain",
    "pick_row_tile",
    "reset_launches",
    "rfft2_cost",
    "rfft2_fits_smem",
    "rfft2_fused",
    "rfft2_fused_plain",
    "rfft2_smem_bytes",
    "rfft_cluster_plain",
    "rfft_cost",
    "rfft_fused",
    "rfft_fused_plain",
    "rfft_smem_bytes",
    "regpass_barriers",
    "regpass_exchanges",
    "regpass_radices",
    "rfft_pairs_in_registers",
    "rfft_two_pass_plain",
    "row_smem_bytes",
    "smem_slot",
    "two_pass_geometry",
    "two_pass_row_stride",
]

# ------------------------------- census -----------------------------------

#: Dynamic shared memory one Hopper block may opt into (sm_90: 227 KB).
SMEM_BUDGET_BYTES = 232_448

#: Most threads a block may have.
MAX_THREADS = 1024

#: Complex values each thread holds in registers in a pass
#: (``kMaxPerThread`` in ``csrc/fft_common.cuh``).
ELEMS_PER_THREAD = 16

#: Complex values a 1D block aims to hold: 32 KiB, so that several blocks
#: share an SM and hide each other's loads.
ROW_TILE_ELEMS = 4096

_COMPLEX_BYTES = 8


def smem_slot(i: int) -> int:
    """Shared-memory slot of value ``i`` in the padded layout of the
    register-pass panel (``slot`` in ``csrc/stockham_regs.cuh``): one pad
    slot after every 16 values, which keeps the first pass's stride-16
    writes free of bank conflicts. The block is sized for its values and
    its twiddle ROM padded alike; later passes use the plain layout."""
    return i + (i >> 4)


def _padded_block_bytes(elems: int, rom: int) -> int:
    """A register-pass block: its values and its ROM, each padded."""
    return (smem_slot(elems) + smem_slot(rom)) * _COMPLEX_BYTES


def block_threads(elems: int) -> int:
    """Threads of a block holding ``elems`` values: min(16, elems) each."""
    return elems // min(ELEMS_PER_THREAD, elems)


def fft_smem_bytes(n: int, rows: int = 1) -> int:
    """``fft_fused``: ``rows`` rows of n values and a ROM of n/2 twiddles,
    each padded for the register-pass panel (both radices)."""
    return _padded_block_bytes(rows * n, n // 2)


def rfft_smem_bytes(n: int, rows: int = 1) -> int:
    """``rfft_fused``: ``rows`` packed rows of N/2 values and a ROM of
    N/2+1 twiddles W_N^k, each padded as in :func:`fft_smem_bytes` (the
    register-pass panel reads only N/2 of the twiddles; the radix-4
    recombination reads them too, W_N^{N/2-k} being -conj W_N^k)."""
    return _padded_block_bytes(rows * (n // 2), n // 2 + 1)


def irfft_smem_bytes(n: int, rows: int = 1) -> int:
    """``irfft_fused``: ``rows`` packed rows of N/2 values and room for N/2
    twiddles, each padded as in :func:`fft_smem_bytes`. The kernel (either
    radix) untangles by ``sincospif`` and its panel reads N/4 of the
    twiddles, W_{N/2}^k."""
    return _padded_block_bytes(rows * (n // 2), n // 2)


def fft2_smem_bytes(h: int, w: int) -> int:
    """``fft2_fused``: the whole frame and one ROM of max(H, W)/2 twiddles
    for the longer side, each padded for the register passes (both
    radices)."""
    return _padded_block_bytes(h * w, max(h, w) // 2)


def rfft2_smem_bytes(h: int, w: int) -> int:
    """``rfft2_fused`` and ``irfft2_fused``: the frame as H rows of W/2
    packed values (DC and Nyquist share slot 0), and one ROM of
    max(H, W)/2 + 1 twiddles, each padded for the register passes (both
    kernels read max(H, W)/2 of the twiddles at either radix; the entries'
    check asks no more)."""
    return _padded_block_bytes(h * (w // 2), max(h, w) // 2 + 1)


def _fits(smem: int, elems: int) -> bool:
    return smem <= SMEM_BUDGET_BYTES and block_threads(elems) <= MAX_THREADS


def fft_fits_smem(n: int, *, real: bool = False) -> bool:
    """True when one row of length ``n`` fits a block (complex, or the real
    pair when ``real``)."""
    if real:
        m = max(n // 2, 1)
        return _fits(max(rfft_smem_bytes(n), irfft_smem_bytes(n)), m)
    return _fits(fft_smem_bytes(n), n)


def fft2_fits_smem(h: int, w: int) -> bool:
    """True when a whole (H, W) complex frame fits one ``fft2_fused`` block:
    H·W <= 16384, the 1024 threads of 16 values; the padded shared memory
    of such a frame is at most 174,080 bytes, under the budget."""
    return _fits(fft2_smem_bytes(h, w), h * w)


def rfft2_fits_smem(h: int, w: int) -> bool:
    """True when a whole (H, W) real frame fits one ``rfft2_fused`` /
    ``irfft2_fused`` block: H·W/2 <= 16384, the thread limit, as for
    :func:`fft2_fits_smem` (padded, at most 208,904 bytes)."""
    return _fits(rfft2_smem_bytes(h, w), h * max(w // 2, 1))


#: The reference's fused-kernel budget (``repro.kernels.fft_radix2``:
#: ``_VMEM_BUDGET_BYTES``, and the six float32 row arrays its 1D panel
#: holds). It sets the envelope of the port's 1D kernels, so that a key
#: plans onto the fused engines on the card exactly where the reference
#: plans onto its fused kernels.
_REFERENCE_BUDGET_BYTES = 8 * 1024 * 1024
_REFERENCE_ROW_ARRAYS = 6

#: Fewest lines a two-pass block holds: 16 neighbouring complex values are
#: 128 bytes, so each load and store of a pass moves whole 128-byte lines.
TWO_PASS_MIN_LINES = 16


#: Longest row the 1D wrappers serve: the two-pass kernels' twiddle
#: exponents p = j2·k1 <= (n1-1)(n2-1) stay exact float32 integers below
#: 2^24 (``csrc/fft_two_pass.cu``).
CARD_ROW_LIMIT = 2 ** 24


def fft_fits_fused(n: int) -> bool:
    """True when the reference's fused kernels serve rows of length ``n``:
    its rule N·4·6 <= 8 MiB, so N <= 2^18. The reference counts a real row
    by its N reals, like a complex one. The planner holds CPU keys to it."""
    return n * 4 * _REFERENCE_ROW_ARRAYS <= _REFERENCE_BUDGET_BYTES


def fft_fits_card(n: int) -> bool:
    """True when ``fft_fused``, ``rfft_fused`` and ``irfft_fused`` serve rows
    of length ``n``: N <= 2^24 (``CARD_ROW_LIMIT``), a real row counted by
    its N reals, as :func:`fft_fits_fused` counts it. Rows past one block
    take the cluster (radix 4, N <= 2^18) or the two passes. The planner
    holds CUDA keys to it."""
    return n <= CARD_ROW_LIMIT


def fft_split(n: int) -> Tuple[int, int]:
    """(n1, n2) with n = n1·n2, both powers of two and n2 <= n1 <= 2·n2:
    the two-pass view of a row as an (n1, n2) matrix (2^18 = 512 x 512,
    2^24 = 4096 x 4096)."""
    n2 = 1 << ((n.bit_length() - 1) // 2)
    return n // n2, n2


class TwoPassGeometry(NamedTuple):
    """Launch geometry of ``csrc/fft_two_pass.cu`` on rows of n complex
    values, viewed as (n1, n2)."""

    n1: int
    n2: int
    cols: int  # columns of n1 values per column-pass block
    col_threads: int
    col_smem: int
    rows: int  # rows of n2 values per row-pass block
    row_threads: int
    row_smem: int


def two_pass_row_stride(n2: int, rows: int = TWO_PASS_MIN_LINES) -> int:
    """Slots between neighbouring rows of the row pass's tile of ``rows``
    rows (``SmemTile`` in ``csrc/fft_two_pass.cu``). A half-warp of a
    turned pass takes min(16, T) neighbouring rows at 16/T neighbouring
    groups t: the padded row and one more (an odd count) where T >= 16, so
    that 16 rows fall on 16 bank pairs; the padded row and 16/T more where
    T < 16 (the padded row is a multiple of 16 slots from n2 = 256 on), so
    that row r and group t fall on bank pair r·16/T + t."""
    return smem_slot(n2) + max(1, TWO_PASS_MIN_LINES // rows)


def _panel_lines(n: int) -> int:
    """Lines of n values a two-pass block holds: ``ROW_TILE_ELEMS``/n but at
    least ``TWO_PASS_MIN_LINES`` where 16 lines fit the column panel's
    ``COLUMN_PANEL_VALUES`` (n <= 1024: every run 128 bytes or more), else
    ``COLUMN_PANEL_VALUES``/n (8 at 2048, 4 at 4096: whole 32-byte
    sectors), as :func:`fft2_columns_geometry` sizes its panels."""
    if n * TWO_PASS_MIN_LINES <= COLUMN_PANEL_VALUES:
        return max(TWO_PASS_MIN_LINES, ROW_TILE_ELEMS // n)
    return COLUMN_PANEL_VALUES // n


def two_pass_geometry(n: int) -> TwoPassGeometry:
    """The register-pass census of the two passes, 16 values a thread. The
    column pass holds a panel of ``cols`` columns of n1 values and a ROM of
    n1/2 twiddles, each padded (:func:`fft_smem_bytes`); the row pass a tile
    of ``rows`` rows of n2 values, :func:`two_pass_row_stride` slots apart,
    and a padded ROM of n2/2. Each holds :func:`_panel_lines` lines: 32
    lines of 128, 16 of 256 to 1024, 8 of 2048 and 4 of 4096, at most
    16384 values and 1024 threads a block, every HBM run of the column pass
    and every store run of the row pass at least one 32-byte sector."""
    n1, n2 = fft_split(n)
    cols, rows = _panel_lines(n1), _panel_lines(n2)
    return TwoPassGeometry(
        n1, n2,
        cols, block_threads(cols * n1), _padded_block_bytes(cols * n1, n1 // 2),
        rows, block_threads(rows * n2),
        (rows * two_pass_row_stride(n2, rows) + smem_slot(n2 // 2)) * _COMPLEX_BYTES,
    )


#: Values one CTA of a cluster holds (M), and the most CTAs a cluster may
#: have (16: H100's non-portable limit; 8 is portable).
CLUSTER_VALUES = 2 ** 13
MAX_CLUSTER = 16

#: The kinds of ``csrc/fft_cluster.cu`` (its ``Kind``), by name.
CLUSTER_KINDS = {"fft": 0, "rfft": 1, "irfft": 2}


class ClusterGeometry(NamedTuple):
    """Launch geometry of ``csrc/fft_cluster.cu`` on rows of m complex
    values (a real row of N as its m = N/2 packed values), viewed as
    ``lines`` lines of m / lines values: one cluster of ``ctas`` CTAs per
    row, each holding ``values`` = m / ctas of them as lines / ctas whole
    lines."""

    m: int
    ctas: int  # C
    values: int  # M
    lines: int  # A
    threads: int
    smem: int  # bytes per CTA


def cluster_geometry(m: int) -> ClusterGeometry:
    """M = 2^13 (two CTAs an SM) wherever that needs at most 16 CTAs, else
    M = 2^14 (one CTA an SM): C = 2, 4, 8, 16 at m = 2^14 ... 2^17 and
    C = 16 at 2^18. At m = 2^17, C = 16 (a non-portable cluster size) timed
    faster than C = 8 at M = 2^14 on an H100 (PERF.md). A CTA holds 4
    lines (8 at C = 2), so that each run of its load is a whole 32-byte
    sector, and the A = 16, 32 or 64 lines of a row are shared 16 to a
    thread's DFT. Its shared memory holds its values and the panel's ROM of
    Q/2 twiddles (Q = m/A), each padded as in :func:`fft_smem_bytes`, the A
    twiddles W_m^t and the 128 twiddles W_128^p."""
    values = CLUSTER_VALUES if m // CLUSTER_VALUES <= MAX_CLUSTER else 2 * CLUSTER_VALUES
    ctas = m // values
    per_cta = 8 if ctas == 2 else 4
    lines = ctas * per_cta
    smem = (_padded_block_bytes(values, values // per_cta // 2)
            + (lines + 128) * _COMPLEX_BYTES)
    return ClusterGeometry(m, ctas, values, lines, block_threads(values), smem)


def cluster_exchanges(m: int) -> int:
    """Exchanges through shared memory of ``csrc/fft_cluster.cu`` on a row
    of m: the panel's over its lines of Q = m/A values, plus the load's
    regrouping of each CTA's runs into lines (which the panel's first pass
    reads) and the one read across the cluster between the panel's last
    pass and the A-point DFTs."""
    return regpass_exchanges(m // cluster_geometry(m).lines) + 2


@functools.lru_cache(maxsize=None)
def _device_cluster_occupancy(m: int, kind: str, device: int) -> int:
    g = cluster_geometry(m)
    from repro_torch.kernels._build import library  # lazy: builds at first use

    active = library().repro_fft_cluster_occupancy(m, CLUSTER_KINDS[kind], g.ctas, g.values,
                                                   g.threads, g.smem, device)
    if active < 0:
        raise RuntimeError(f"cluster_occupancy: CUDA error {-active}")
    return active


def cluster_occupancy(m: int, kind: str = "fft"):
    """Clusters of the ``kind`` instance for rows of m that the current
    card holds at once (``cudaOccupancyMaxActiveClusters``; builds the
    kernels at first use, launches nothing), or None where no card is
    visible. 0 means the card cannot run the instance (a MIG slice, say):
    the engines' gate then keeps ``fused_r4`` off such keys."""
    if not torch.cuda.is_available():
        return None
    return _device_cluster_occupancy(m, kind, torch.cuda.current_device())


#: Most values one ``fft2_columns`` block holds (C columns of H): 1024
#: threads of 16; and its narrowest panel, 4 complex values a row, one
#: whole 32-byte sector a run.
COLUMN_PANEL_VALUES = 2 ** 14
COLUMN_PANEL_MIN_COLS = 4


class ColumnGeometry(NamedTuple):
    """Launch geometry of ``csrc/fft2_columns.cu`` on frames of H rows of
    ``width`` values: one block a panel of ``cols`` neighbouring columns of
    one frame, ``tiles`` panels a frame (the last masked where ``cols`` does
    not divide the width)."""

    cols: int  # C
    tiles: int
    threads: int
    smem: int


def fft2_columns_serves(h: int) -> bool:
    """True when ``fft2_columns`` runs columns of length ``h``: a power of
    two of which at least ``COLUMN_PANEL_MIN_COLS`` columns fit one block
    (2 <= H <= 4096). The composed 2D route takes the corner turns through
    HBM for longer columns (``repro_torch.kernels.ops``)."""
    return h >= 2 and not h & (h - 1) and h * COLUMN_PANEL_MIN_COLS <= COLUMN_PANEL_VALUES


def fft2_columns_geometry(h: int, width: int) -> ColumnGeometry:
    """C = :func:`_panel_lines` of H (so that several blocks share an SM
    where H <= 1024, as a 1D block aims, each run of a row a whole 128-byte
    line: 64 columns at H = 64, 16 at 256 to 1024; 8 at 2048, 4 at 4096:
    whole 32-byte sectors), never wider than the width rounded up to a
    power of two. Threads: 16 values each. Shared memory: the panel and a
    ROM of H/2 twiddles, each padded (:func:`fft_smem_bytes`), at both
    radices."""
    cols = min(_panel_lines(h), 1 << max(width - 1, 0).bit_length())
    return ColumnGeometry(cols, -(-width // cols), block_threads(cols * h),
                          _padded_block_bytes(cols * h, h // 2))


def row_smem_bytes(n: int, *, real: bool = False, radix: int = 2,
                   fits=fft_fits_fused) -> int:
    """Largest block the 1D wrappers launch on rows of length ``n``
    (``real``: ``rfft_fused`` and ``irfft_fused``): the one block where a
    row fits one, else one CTA of the cluster (radix 4, N <= 2^18) or the
    larger two-pass block, at N/2 complex values for a real row. A row
    outside the envelope ``fits`` (the reference's :func:`fft_fits_fused`
    by default; CUDA keys pass :func:`fft_fits_card`) reports its one-block
    size, which is over the budget, so that the engines' gate drops it."""
    one = max(rfft_smem_bytes(n), irfft_smem_bytes(n)) if real else fft_smem_bytes(n)
    if fft_fits_smem(n, real=real) or not fits(n):
        return one
    m = n // 2 if real else n
    if radix == 4 and fft_fits_fused(n):
        return cluster_geometry(m).smem
    g = two_pass_geometry(m)
    return max(g.col_smem, g.row_smem)


def pick_row_tile(batch: int, elems_per_row: int) -> int:
    """Rows per 1D block: a power of two near ``ROW_TILE_ELEMS`` values,
    at most the batch rounded up to a power of two. The batch need not be
    a multiple: the last block masks its rows past the batch."""
    tile = max(1, ROW_TILE_ELEMS // elems_per_row)
    tile = 1 << (tile.bit_length() - 1)
    cap = 1 << max(batch - 1, 0).bit_length()
    return max(1, min(tile, cap))


# --------------------------- plain panels ---------------------------------


def _stockham_rom(n: int, dtype: torch.dtype, device):
    """The radix-2 panels' cos/sin table W_N^j, j < N/2, for the largest
    stage (smaller stages stride it), computed in the planes' dtype
    (float64 for the double engine)."""
    l_max = n // 2
    j = torch.arange(l_max, dtype=dtype, device=device).reshape(1, 1, l_max)
    ang = (-math.pi / l_max) * j
    return torch.cos(ang), torch.sin(ang)


def _stockham_panel(re: torch.Tensor, im: torch.Tensor, n: int):
    """All log2(N) radix-2 stages over a (tile, N) panel."""
    stages = int(math.log2(n)) if n > 1 else 0
    tb = re.shape[0]
    yr = re.reshape(tb, n, 1)
    yi = im.reshape(tb, n, 1)
    if stages == 0:
        return yr.reshape(tb, n), yi.reshape(tb, n)
    l_max = n // 2
    rom_r, rom_i = _stockham_rom(n, re.dtype, re.device)
    for s in range(stages):
        l = 1 << s
        r = n >> (s + 1)
        yr = yr.reshape(tb, 2, r, l)
        yi = yi.reshape(tb, 2, r, l)
        stride = l_max // l
        wr = rom_r[..., ::stride]
        wi = rom_i[..., ::stride]
        ar, ai = yr[:, 0], yi[:, 0]
        br, bi = yr[:, 1], yi[:, 1]
        tr = br * wr - bi * wi
        ti = br * wi + bi * wr
        yr = torch.cat([ar + tr, ar - tr], dim=-1)
        yi = torch.cat([ai + ti, ai - ti], dim=-1)
    return yr.reshape(tb, n), yi.reshape(tb, n)


def _stockham_panel_r4(re: torch.Tensor, im: torch.Tensor, n: int):
    """Radix-4 panel: one twiddle-free radix-2 stage when log2(N) is odd,
    then radix 4, with W^2 and W^3 from W by complex multiplication."""
    stages = int(math.log2(n)) if n > 1 else 0
    tb = re.shape[0]
    yr = re.reshape(tb, n, 1)
    yi = im.reshape(tb, n, 1)
    if stages == 0:
        return yr.reshape(tb, n), yi.reshape(tb, n)
    l = 1
    if stages % 2:
        r = n >> 1
        yr = yr.reshape(tb, 2, r, 1)
        yi = yi.reshape(tb, 2, r, 1)
        ar, ai = yr[:, 0], yi[:, 0]
        br, bi = yr[:, 1], yi[:, 1]
        yr = torch.cat([ar + br, ar - br], dim=-1)
        yi = torch.cat([ai + bi, ai - bi], dim=-1)
        l = 2
    if l < n:
        l_max = n // 4
        j = torch.arange(l_max, dtype=re.dtype, device=re.device).reshape(1, 1, l_max)
        ang = (-2.0 * math.pi / n) * j
        rom_r, rom_i = torch.cos(ang), torch.sin(ang)
    while l < n:
        r = n // (4 * l)
        yr = yr.reshape(tb, 4, r, l)
        yi = yi.reshape(tb, 4, r, l)
        stride = (n // 4) // l
        w1r = rom_r[..., ::stride]
        w1i = rom_i[..., ::stride]
        w2r = w1r * w1r - w1i * w1i
        w2i = 2.0 * w1r * w1i
        w3r = w2r * w1r - w2i * w1i
        w3i = w2r * w1i + w2i * w1r
        a0r, a0i = yr[:, 0], yi[:, 0]
        a1r = yr[:, 1] * w1r - yi[:, 1] * w1i
        a1i = yr[:, 1] * w1i + yi[:, 1] * w1r
        a2r = yr[:, 2] * w2r - yi[:, 2] * w2i
        a2i = yr[:, 2] * w2i + yi[:, 2] * w2r
        a3r = yr[:, 3] * w3r - yi[:, 3] * w3i
        a3i = yr[:, 3] * w3i + yi[:, 3] * w3r
        s02r, s02i = a0r + a2r, a0i + a2i
        d02r, d02i = a0r - a2r, a0i - a2i
        s13r, s13i = a1r + a3r, a1i + a3i
        d13r, d13i = a1r - a3r, a1i - a3i
        yr = torch.cat([s02r + s13r, d02r + d13i, s02r - s13r, d02r - d13i], dim=-1)
        yi = torch.cat([s02i + s13i, d02i - d13r, s02i - s13i, d02i + d13r], dim=-1)
        l *= 4
    return yr.reshape(tb, n), yi.reshape(tb, n)


def regpass_radices(n: int) -> Tuple[int, ...]:
    """Radices of the register passes over a line of n values (``panel`` in
    ``csrc/stockham_regs.cuh``): passes of 16, the last one taking what is
    left (8, 4 or 2); a line of at most 16 values is one pass of radix n."""
    log_n = n.bit_length() - 1
    if log_n <= 4:
        return (n,)
    rest = log_n % 4
    return (16,) * (log_n // 4) + ((1 << rest,) if rest else ())


def rfft_pairs_in_registers(m: int) -> bool:
    """True where ``rfft_fused`` (either radix) on half rows of m values pairs
    the mirror bins k and m - k in registers (``rfft_pairs_in_registers``
    in ``csrc/fft_fused.cu``): a last pass of radix at most 8 over a span
    of at least 256 (m = 2^9, 2^10, 2^11, 2^13). Elsewhere its last pass
    writes the half spectrum to shared memory for the recombination."""
    radices = regpass_radices(m)
    return len(radices) >= 3 and radices[-1] <= 8


def _spills_recombination(n: int, real: bool, inverse: bool) -> bool:
    return real and not inverse and not rfft_pairs_in_registers(n // 2)


def _check_regpass(radix: int) -> None:
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")


def regpass_exchanges(n: int, *, real: bool = False, inverse: bool = False,
                      radix: int = 4) -> int:
    """Exchanges through shared memory of the register-pass ``fft_fused``
    on a row of n (``real``: ``rfft_fused``, on its half row of n/2; ``real``
    and ``inverse``: ``irfft_fused``, which untangles in its first pass's
    reads): the passes less one, as the first pass loads from HBM and the
    last stores to HBM, plus one for ``rfft_fused``'s recombination where it
    does not pair the mirror bins in registers. The radix-2 and radix-4
    layers share the passes, so the ``radix`` changes no count."""
    _check_regpass(radix)
    m = n // 2 if real else n
    return len(regpass_radices(m)) - 1 + int(_spills_recombination(n, real, inverse))


def regpass_barriers(n: int, *, real: bool = False, inverse: bool = False,
                     radix: int = 4) -> int:
    """Block barriers per row tile of the same kernels: one after the first
    pass, two in each middle pass (in place: read, barrier, write, barrier
    before the next read), one before the last; where ``rfft_fused``'s last
    pass writes shared memory it is in place too, and one more precedes
    the recombination."""
    _check_regpass(radix)
    m = n // 2 if real else n
    passes = len(regpass_radices(m))
    if _spills_recombination(n, real, inverse):
        return 2 * passes - 1 if passes > 1 else 1
    return max(2 * passes - 3, 0)


class FramePasses(NamedTuple):
    """The register passes of the whole-frame kernels on one frame
    (``frame_panel`` in ``csrc/stockham_regs.cuh``)."""

    rows: Tuple[int, ...]  # radices of the row panel (rfft2: over W/2)
    cols: Tuple[int, ...]  # radices of the column panel
    exchanges: int  # round trips of the whole frame through shared memory
    barriers: int  # block barriers per frame


def frame_passes(h: int, w: int, *, real: bool = False, inverse: bool = False) -> FramePasses:
    """Passes, exchanges and barriers of the register-pass whole-frame
    kernels on an (H, W) frame: ``fft2_fused``, ``rfft2_fused`` and
    ``irfft2_fused`` at either radix (the radix-2 layers take the radix-4
    passes). The first panel's first pass loads from HBM and the
    second panel's last stores to HBM, so T passes make T - 1 exchanges;
    each boundary between passes is a barrier, and so is the middle of every
    pass that reads and writes shared memory in place: 2T - 3. ``rfft2_fused``
    recombines in its first column pass's reads (no exchange of its own) and
    adds one barrier before it splits column 0 into DC and Nyquist;
    ``irfft2_fused`` (``real`` and ``inverse``: columns first) packs them in
    its first column pass's reads and untangles in its first row pass's,
    adding neither."""
    rows = regpass_radices(w // 2 if real else w)
    cols = regpass_radices(h)
    t = len(rows) + len(cols)
    return FramePasses(rows, cols, t - 1, 2 * t - 3 + int(real and not inverse))


# cos and sin of 2 pi p / 16: the kernel's float32 constants, and float64
# ones for planes in double precision.
_W16 = {
    dtype: ([float(torch.tensor(math.cos(2 * math.pi * p / 16), dtype=dtype)) for p in range(16)],
            [float(torch.tensor(math.sin(2 * math.pi * p / 16), dtype=dtype)) for p in range(16)])
    for dtype in (torch.float32, torch.float64)
}


def _mul_w16(xr, xi, p: int):
    """(xr, xi) * W_16^p as ``mul_w16`` computes it: quarter turns are
    swaps, eighth turns two products."""
    p &= 15
    if p == 0:
        return xr, xi
    if p == 4:
        return xi, -xr
    if p == 8:
        return -xr, -xi
    if p == 12:
        return -xi, xr
    c16, s16 = _W16[xr.dtype]
    c2 = c16[2]
    if p == 2:
        return c2 * (xr + xi), c2 * (xi - xr)
    if p == 6:
        return c2 * (xi - xr), -c2 * (xr + xi)
    c, s = c16[p], s16[p]
    return xr * c + xi * s, xi * c - xr * s


def _bfly4(a):
    """The radix-4 butterfly on four (re, im) pairs, as ``bfly4``."""
    (a0r, a0i), (a1r, a1i), (a2r, a2i), (a3r, a3i) = a
    s02r, s02i, d02r, d02i = a0r + a2r, a0i + a2i, a0r - a2r, a0i - a2i
    s13r, s13i, d13r, d13i = a1r + a3r, a1i + a3i, a1r - a3r, a1i - a3i
    return [(s02r + s13r, s02i + s13i), (d02r + d13i, d02i - d13r),
            (s02r - s13r, s02i - s13i), (d02r - d13i, d02i + d13r)]


def _dft_regs(v, radix: int):
    """The R-point DFT of the list v of R (re, im) pairs in the kernel's
    layers (``dft`` in ``csrc/stockham_regs.cuh``): R = A·B, j = B·j1 + j2,
    A-point DFTs over j1, the inner twiddle W_R^{j2·c1}, B-point DFTs over
    j2; returns the outputs in natural order."""
    if radix == 1:
        return v
    if radix == 2:
        (ar, ai), (br, bi) = v
        return [(ar + br, ai + bi), (ar - br, ai - bi)]
    if radix == 4:
        return _bfly4(v)
    b = radix // 4  # A = 4, B = 2 (R = 8) or 4 (R = 16)
    y = [_bfly4([v[b * j1 + j2] for j1 in range(4)]) for j2 in range(b)]  # y[j2][c1]
    y = [[_mul_w16(*y[j2][c1], (16 // radix) * j2 * c1) for c1 in range(4)]
         for j2 in range(b)]
    out = [None] * radix
    for c1 in range(4):
        col = [y[j2][c1] for j2 in range(b)]
        col = _bfly4(col) if b == 4 else _dft_regs(col, 2)
        for c2 in range(b):
            out[c1 + 4 * c2] = col[c2]
    return out


def _regpass_panel(re: torch.Tensor, im: torch.Tensor, n: int):
    """The register-pass panel of the radix-4 ``fft_fused`` and
    ``rfft_fused`` kernels over a (tile, N) panel, step for step: passes of
    :func:`regpass_radices`; in a pass of radix R over span l, group t of a
    line takes a_j = in[t + j·N/R] · W_{R·l}^{j·k} (k = t mod l, the ROM
    entry W_N^{e mod N/2} at e = j·k·N/(R·l), negated past the half turn),
    runs the R-point DFT of :func:`_dft_regs` and writes output c to
    q·R·l + c·l + k (q = t / l)."""
    tb = re.shape[0]
    half = max(n // 2, 1)
    ang = torch.arange(half, dtype=torch.float64, device=re.device) * (-2.0 * math.pi / n)
    rom_r, rom_i = torch.cos(ang).to(re.dtype), torch.sin(ang).to(re.dtype)
    yr, yi = re.reshape(tb, n), im.reshape(tb, n)
    l = 1
    for radix in regpass_radices(n):
        s = n // radix
        ar, ai = yr.reshape(tb, radix, s), yi.reshape(tb, radix, s)
        if l > 1:
            k = torch.arange(s, device=re.device) % l
            e = torch.arange(radix, device=re.device).reshape(radix, 1) * k * (n // (radix * l))
            sign = torch.where(e >= half, -1.0, 1.0)
            wr, wi = rom_r[e % half] * sign, rom_i[e % half] * sign
            ar, ai = ar * wr - ai * wi, ar * wi + ai * wr
        out = _dft_regs([(ar[:, j], ai[:, j]) for j in range(radix)], radix)
        br = torch.stack([o[0] for o in out], dim=1)  # [b, c, t], t = q·l + k
        bi = torch.stack([o[1] for o in out], dim=1)
        yr = br.reshape(tb, radix, s // l, l).transpose(1, 2).reshape(tb, n)
        yi = bi.reshape(tb, radix, s // l, l).transpose(1, 2).reshape(tb, n)
        l *= radix
    return yr, yi


def _bit_reverse(v: int, bits: int) -> int:
    """The lowest ``bits`` bits of v in reverse order (``bit_reverse``)."""
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _regpass_panel_r2(re: torch.Tensor, im: torch.Tensor, n: int):
    """The register passes of the radix-2 ``fft_fused`` and ``rfft_fused``
    kernels over a (tile, N) panel (``r2_layers`` in
    ``csrc/stockham_regs.cuh``): the passes of :func:`regpass_radices`; in a
    pass of radix R = 2^LR over span l, group t of a line holds its R values
    in[t + j·N/R] and runs LR radix-2 stages on them, stage s pairing the
    values whose register indices differ by R/2^(s+1) and taking a ± W·b at
    W = W_{2l'}^{k'}, l' = l·2^s, k' = k + l·c (k = t mod l, c the bit
    reversal of the index's top s bits); output c, in register
    bit_reverse(c), goes to q·R·l + c·l + k. The butterflies and twiddles of
    :func:`_stockham_panel` (its table, its operations in its order), so the
    result is the same bit for bit; only where each value sits between
    stages differs."""
    tb = re.shape[0]
    yr, yi = re.reshape(tb, n), im.reshape(tb, n)
    if n == 1:
        return yr, yi
    l_max = n // 2
    rom_r, rom_i = (w.reshape(l_max) for w in _stockham_rom(n, re.dtype, re.device))
    log_l = 0
    for radix in regpass_radices(n):
        lr = radix.bit_length() - 1
        s, l = n // radix, 1 << log_l
        vr, vi = yr.reshape(tb, radix, s), yi.reshape(tb, radix, s)  # [b, register, t]
        k = torch.arange(s, device=re.device) % l
        for st in range(lr):
            h = 1 << st  # twiddles of the stage: one for each value of the top st bits
            c = torch.tensor([_bit_reverse(v, st) for v in range(h)], device=re.device)
            e = (k.reshape(1, s) + l * c.reshape(h, 1)) * (l_max // (l << st))
            wr, wi = rom_r[e].reshape(1, h, 1, s), rom_i[e].reshape(1, h, 1, s)
            vr = vr.reshape(tb, h, 2, radix // (2 * h), s)
            vi = vi.reshape(tb, h, 2, radix // (2 * h), s)
            ar, ai = vr[:, :, 0], vi[:, :, 0]
            br, bi = vr[:, :, 1], vi[:, :, 1]
            tr = br * wr - bi * wi
            ti = br * wi + bi * wr
            vr = torch.stack([ar + tr, ar - tr], dim=2).reshape(tb, radix, s)
            vi = torch.stack([ai + ti, ai - ti], dim=2).reshape(tb, radix, s)
        order = [_bit_reverse(c, lr) for c in range(radix)]  # output c's register
        yr = vr[:, order].reshape(tb, radix, s // l, l).transpose(1, 2).reshape(tb, n)
        yi = vi[:, order].reshape(tb, radix, s // l, l).transpose(1, 2).reshape(tb, n)
        log_l += lr
    return yr, yi


def _panel(radix: int):
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    return _stockham_panel_r4 if radix == 4 else _stockham_panel


def _one_block_panel(radix: int):
    """The panel of the one-block kernels: the register passes at radix 4,
    the Stockham stages at radix 2 (bit for bit the radix-2 kernels'
    register passes, :func:`_regpass_panel_r2`, which every one-block
    kernel and ``fft2_columns`` run there)."""
    _panel(radix)
    return _regpass_panel if radix == 4 else _stockham_panel


def _two_pass_panel(re: torch.Tensor, im: torch.Tensor, n: int, panel):
    """Four-step FFT over a (tile, N) panel, as ``csrc/fft_two_pass.cu``
    computes it on the row viewed as (n1, n2) (:func:`fft_split`):
    ``panel`` over the n2 columns of length n1, the twiddle W_N^{j2·k1} on
    element (k1, j2), ``panel`` over the n1 rows of length n2, and the
    transposed write out[k2·n1 + k1]. The kernels run each panel as
    :func:`_regpass_panel_r2`; the plain version runs
    :func:`_stockham_panel`, the same bit for bit."""
    n1, n2 = fft_split(n)
    tb = re.shape[0]

    def lines(z, a, b):  # (tb, a, b) -> (tb·b, a): the lines along axis a
        return z.reshape(tb, a, b).transpose(1, 2).reshape(tb * b, a)

    yr, yi = panel(lines(re, n1, n2), lines(im, n1, n2), n1)  # [b, j2, k1]
    j2 = torch.arange(n2, dtype=torch.int64, device=re.device).reshape(n2, 1)
    k1 = torch.arange(n1, dtype=torch.int64, device=re.device).reshape(1, n1)
    ang = (j2 * k1).to(torch.float64) * (-2.0 * math.pi / n)  # j2·k1 < N: exact
    wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
    yr, yi = yr.reshape(tb, n2, n1), yi.reshape(tb, n2, n1)
    yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
    yr, yi = panel(lines(yr, n2, n1), lines(yi, n2, n1), n2)  # [b, k1, k2]
    return lines(yr, n1, n2).reshape(tb, n), lines(yi, n1, n2).reshape(tb, n)


def _cluster_panel(re: torch.Tensor, im: torch.Tensor, n: int):
    """The radix-4 route of rows over one block over a (tile, N) panel, as
    ``csrc/fft_cluster.cu`` computes it on the row viewed as A lines of
    Q = N/A (:func:`cluster_geometry`): line a holds
    x[a + A·n'], ``_regpass_panel`` runs over each line, element (a, q)
    takes the twiddle W_N^{a·q}, and the A-point DFT over a = a1 + L·a2
    (L = A/16) gives X[q + Q·(k2 + 16·k1)]: the 16-point DFT over a2
    (:func:`_dft_regs`), the twiddle W_A^{a1·k2}, the L-point DFT over a1."""
    lines_ = cluster_geometry(n).lines
    q_, l_ = n // lines_, lines_ // 16
    tb = re.shape[0]
    dev = re.device

    def lines(z):  # (tb, n) -> (tb·A, Q): line a holds z[a + A·n']
        return z.reshape(tb, q_, lines_).transpose(1, 2).reshape(tb * lines_, q_)

    def twiddle(zr, zi, e, period):  # z·W_period^e, e exact in float64
        ang = e.to(torch.float64) * (-2.0 * math.pi / period)
        wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
        return zr * wr - zi * wi, zr * wi + zi * wr

    yr, yi = _regpass_panel(lines(re), lines(im), q_)
    a = torch.arange(lines_, dtype=torch.int64, device=dev).reshape(lines_, 1)
    q = torch.arange(q_, dtype=torch.int64, device=dev).reshape(1, q_)
    yr, yi = twiddle(yr.reshape(tb, lines_, q_), yi.reshape(tb, lines_, q_), a * q, n)
    yr, yi = yr.reshape(tb, 16, l_, q_), yi.reshape(tb, 16, l_, q_)  # [b, a2, a1, q]
    out = _dft_regs([(yr[:, j], yi[:, j]) for j in range(16)], 16)  # [k2] (tb, L, Q)
    yr = torch.stack([o[0] for o in out], dim=1)  # [b, k2, a1, q]
    yi = torch.stack([o[1] for o in out], dim=1)
    a1k2 = (torch.arange(16, device=dev).reshape(16, 1, 1)
            * torch.arange(l_, device=dev).reshape(1, l_, 1))
    yr, yi = twiddle(yr, yi, a1k2, lines_)
    out = _dft_regs([(yr[:, :, j], yi[:, :, j]) for j in range(l_)], l_)  # [k1] (tb, 16, Q)
    xr = torch.stack([o[0] for o in out], dim=1).reshape(tb, n)  # [b, k1, k2, q]
    xi = torch.stack([o[1] for o in out], dim=1).reshape(tb, n)
    return xr, xi


def _row_panel(radix: int, two_pass: bool):
    """The panel a row takes: one block's, or the two-pass composition of it."""
    panel = _panel(radix)
    return functools.partial(_two_pass_panel, panel=panel) if two_pass else panel


def _rfft_panel(x: torch.Tensor, n: int, radix: int, *, two_pass: bool = False,
                panel=None):
    """Real (tile, N) -> half spectrum (tile, N/2+1) re/im: pack, half-size
    panel (``panel``, else the Stockham one of ``radix``), Hermitian
    recombination Y[k] = Xe[k] + W_N^k Xo[k]."""
    m = n // 2
    zr = x[:, 0::2]
    zi = x[:, 1::2]
    zr, zi = (panel or _row_panel(radix, two_pass))(zr, zi, m)
    zkr = torch.cat([zr, zr[:, :1]], dim=-1)
    zki = torch.cat([zi, zi[:, :1]], dim=-1)
    zmkr = torch.cat([zr[:, :1], torch.flip(zr[:, 1:], dims=(-1,)), zr[:, :1]], dim=-1)
    zmki = -torch.cat([zi[:, :1], torch.flip(zi[:, 1:], dims=(-1,)), zi[:, :1]], dim=-1)
    k = torch.arange(m + 1, dtype=torch.float32, device=x.device).reshape(1, m + 1)
    ang = (-2.0 * math.pi / n) * k
    return _recombine(zkr, zki, zmkr, zmki, torch.cos(ang), torch.sin(ang))


def _irfft_panel(yr: torch.Tensor, yi: torch.Tensor, n: int, radix: int, *,
                 two_pass: bool = False, panel=None):
    """Half spectrum (tile, N/2+1) re/im -> real (tile, N): untangle, then
    the half-size inverse by conjugation on ``panel`` (else the Stockham
    one of ``radix``)."""
    tb = yr.shape[0]
    m = n // 2
    edge = torch.arange(m + 1, device=yr.device).reshape(1, m + 1)
    yi = torch.where((edge == 0) | (edge == m), torch.zeros_like(yi), yi)
    ykr, yki = yr[:, :m], yi[:, :m]
    ymkr = torch.flip(yr[:, 1:], dims=(-1,))
    ymki = -torch.flip(yi[:, 1:], dims=(-1,))
    xer = 0.5 * (ykr + ymkr)
    xei = 0.5 * (yki + ymki)
    txr = 0.5 * (ykr - ymkr)
    txi = 0.5 * (yki - ymki)
    k = torch.arange(m, dtype=torch.float32, device=yr.device).reshape(1, m)
    ang = (2.0 * math.pi / n) * k
    wr, wi = torch.cos(ang), torch.sin(ang)
    xor_ = txr * wr - txi * wi
    xoi = txr * wi + txi * wr
    zr = xer - xoi
    zi = xei + xor_
    fr, fi = (panel or _row_panel(radix, two_pass))(zr, -zi, m)
    inv = 1.0 / m
    zr, zi = fr * inv, -fi * inv
    return torch.stack([zr, zi], dim=-1).reshape(tb, n)


# --------------------------- plain versions -------------------------------


def _planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    v = torch.view_as_real(x.resolve_conj())
    return v[..., 0], v[..., 1]


def _complex(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re.contiguous(), im.contiguous())


def _fft_plain(x: torch.Tensor, panel, inverse: bool) -> torch.Tensor:
    re, im = _planes(x)
    n = x.shape[-1]
    if inverse:
        yr, yi = panel(re, -im, n)
        return _complex(yr / n, -yi / n)
    yr, yi = panel(re, im, n)
    return _complex(yr, yi)


def fft_fused_plain(x: torch.Tensor, *, radix: int = 2, inverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`fft_fused` on a (B, N) complex64 tensor: the
    register passes at radix 4, the Stockham stages at radix 2. A complex128
    tensor runs the same panel in double precision (twiddles computed in
    float64): the Stockham schedules of the ``reference_x64`` engine."""
    return _fft_plain(x, _one_block_panel(radix), inverse)


def rfft_fused_plain(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Plain version of :func:`rfft_fused`: (B, N) float32 -> (B, N/2+1),
    on the panel of :func:`fft_fused_plain`."""
    yr, yi = _rfft_panel(x, x.shape[-1], radix, panel=_one_block_panel(radix))
    return _complex(yr, yi)


def irfft_fused_plain(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Plain version of :func:`irfft_fused`: (B, N/2+1) -> (B, N) float32,
    the untangling, then the half-size inverse on the panel of
    :func:`fft_fused_plain` by conjugation."""
    re, im = _planes(y)
    return _irfft_panel(re, im, 2 * (y.shape[-1] - 1), radix, panel=_one_block_panel(radix))


def fft_two_pass_plain(x: torch.Tensor, *, radix: int = 2, inverse: bool = False) -> torch.Tensor:
    """Plain version of the two-pass kernels on (B, N) complex64: what
    :func:`fft_fused` computes for rows over one block."""
    return _fft_plain(x, _row_panel(radix, True), inverse)


def rfft_two_pass_plain(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Plain version of :func:`rfft_fused` for rows over one block: the
    two-for-one pack, the two passes at N/2, the recombination."""
    yr, yi = _rfft_panel(x, x.shape[-1], radix, two_pass=True)
    return _complex(yr, yi)


def irfft_two_pass_plain(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Plain version of :func:`irfft_fused` for rows over one block: the
    untangling, then the two passes at N/2 by conjugation."""
    re, im = _planes(y)
    return _irfft_panel(re, im, 2 * (y.shape[-1] - 1), radix, two_pass=True)


def fft_cluster_plain(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Plain version of the cluster kernel on (B, N) complex64: what the
    radix-4 :func:`fft_fused` computes for rows over one block."""
    return _fft_plain(x, _cluster_panel, inverse)


def rfft_cluster_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the radix-4 :func:`rfft_fused` for rows over one
    block: the two-for-one pack, the cluster panel at N/2, the
    recombination."""
    yr, yi = _rfft_panel(x, x.shape[-1], 4, panel=_cluster_panel)
    return _complex(yr, yi)


def irfft_cluster_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version of the radix-4 :func:`irfft_fused` for rows over one
    block: the untangling, then the cluster panel at N/2 by conjugation."""
    re, im = _planes(y)
    return _irfft_panel(re, im, 2 * (y.shape[-1] - 1), 4, panel=_cluster_panel)


def fft2_fused_plain(x: torch.Tensor, *, radix: int = 2, inverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`fft2_fused` on (F, H, W) complex64: row
    panel, corner turn, column panel, turn back; the register passes at
    radix 4, the Stockham stages at radix 2."""
    f, h, w = x.shape
    re, im = _planes(x)
    if inverse:
        im = -im
    panel = _one_block_panel(radix)
    yr, yi = panel(re.reshape(f * h, w), im.reshape(f * h, w), w)
    yr = yr.reshape(f, h, w).transpose(-1, -2).reshape(f * w, h)
    yi = yi.reshape(f, h, w).transpose(-1, -2).reshape(f * w, h)
    yr, yi = panel(yr, yi, h)
    yr = yr.reshape(f, w, h).transpose(-1, -2)
    yi = yi.reshape(f, w, h).transpose(-1, -2)
    if inverse:
        return _complex(yr / (h * w), -yi / (h * w))
    return _complex(yr, yi)


def fft2_columns_plain(x: torch.Tensor, *, radix: int = 2,
                       inverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`fft2_columns` on (F, H, Wc) complex64: the
    panel of :func:`fft_fused_plain` (the register passes at radix 4, the
    Stockham stages at radix 2, bit for bit the kernel's radix-2 passes)
    down each of the Wc columns; ``inverse`` by conjugation, scaled by
    1/H."""
    f, h, wc = x.shape
    cols = x.transpose(-1, -2).reshape(f * wc, h)
    y = _fft_plain(cols, _one_block_panel(radix), inverse)
    return y.reshape(f, wc, h).transpose(-1, -2).contiguous()


def _recombine(zr, zi, mr, mi, wr, wi):
    """``regs::recombine``: Y = Xe + w·Xo from z = Z[k] and zm = conj Z[m-k]
    given as (mr, mi)."""
    xer, xei = 0.5 * (zr + mr), 0.5 * (zi + mi)
    xor_, xoi = 0.5 * (zi - mi), -0.5 * (zr - mr)
    return xer + wr * xor_ - wi * xoi, xei + wr * xoi + wi * xor_


def _rfft2_regpass(x: torch.Tensor, panel) -> torch.Tensor:
    """The ``rfft2_fused`` kernel (``csrc/rfft2_fused.cu``,
    ``rfft2_regs_kernel``) step for step, its passes on ``panel`` (see
    :func:`_one_block_panel`): the passes over the H packed rows of m =
    W/2; the first column pass's recombination, column c
    of row r becoming Y[r][c] = Xe + W_W^c·Xo from Z[r][c] and
    conj Z[r][m-c], column 0 (Re + Im) + i(Re - Im) of Z[r][0] (DC + i
    Nyquist); the passes over the m columns; column 0 split into
    A = (Z[r] + conj Z[-r])/2 (DC) and B = -i(Z[r] - conj Z[-r])/2
    (Nyquist)."""
    f, h, w = x.shape
    m = w // 2
    packed = x.reshape(f * h, m, 2)
    zr, zi = panel(packed[..., 0], packed[..., 1], m)  # (f·h, m)
    mirror = (-torch.arange(m, device=x.device)) % m
    c = torch.arange(m, dtype=torch.float64, device=x.device)
    ang = c * (-2.0 * math.pi / w)
    yr, yi = _recombine(zr, zi, zr[:, mirror], -zi[:, mirror], torch.cos(ang).float(),
                        torch.sin(ang).float())
    yr[:, 0], yi[:, 0] = zr[:, 0] + zi[:, 0], zr[:, 0] - zi[:, 0]

    def turn(z, a, b):  # (f, a, b) -> (f·b, a)
        return z.reshape(f, a, b).transpose(1, 2).reshape(f * b, a)

    yr, yi = panel(turn(yr, h, m), turn(yi, h, m), h)  # (f·m, h)
    yr, yi = turn(yr, m, h).reshape(f, h, m), turn(yi, m, h).reshape(f, h, m)
    rows = (-torch.arange(h, device=x.device)) % h
    zr, zi = yr[:, :, 0], yi[:, :, 0]
    mr, mi = zr[:, rows], -zi[:, rows]
    dc = torch.complex(0.5 * (zr + mr), 0.5 * (zi + mi))
    ny = torch.complex(0.5 * (zi - mi), -0.5 * (zr - mr))
    body = _complex(yr[:, :, 1:], yi[:, :, 1:])
    return torch.cat([dc[:, :, None], body, ny[:, :, None]], dim=-1)


def rfft2_fused_plain(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Plain version of :func:`rfft2_fused`: (F, H, W) float32 ->
    (F, H, W/2+1) in the kernel's own order (:func:`_rfft2_regpass`) on
    the panel of :func:`fft_fused_plain`: the packed columns DC + i Nyquist
    go through the column panel together."""
    return _rfft2_regpass(x, _one_block_panel(radix))


def _irfft2_regpass(y: torch.Tensor, panel) -> torch.Tensor:
    """The ``irfft2_fused`` kernel (``csrc/rfft2_fused.cu``,
    ``irfft2_regs_kernel``) step for step, its passes on ``panel`` (see
    :func:`_one_block_panel`): slot 0 of row r packs the Hermitian parts of
    the DC column a and the Nyquist column b as A + iB,
    A = (a[r] + conj a[-r])/2, B likewise; the passes over the m = W/2
    columns by conjugation leave C = conj(H·ifft) of each column; the rows
    see Y = conj C, with Y[0] = Re C[0] (DC) and Y[m] = -Im C[0]
    (Nyquist), and take the untangling and the passes over their m values
    by conjugation; the result is scaled by 1/(H·m)."""
    f, h, half = y.shape
    m = half - 1
    re, im = _planes(y)
    rows = (-torch.arange(h, device=y.device)) % h
    ar, ai, br, bi = re[..., 0], im[..., 0], re[..., m], im[..., m]
    zr, zi = re[..., :m].clone(), im[..., :m].clone()
    zr[..., 0] = 0.5 * (ar + ar[:, rows]) - 0.5 * (bi - bi[:, rows])
    zi[..., 0] = 0.5 * (ai - ai[:, rows]) + 0.5 * (br + br[:, rows])

    def turn(z, a, b):  # (f, a, b) -> (f·b, a)
        return z.reshape(f, a, b).transpose(1, 2).reshape(f * b, a)

    cr, ci = panel(turn(zr, h, m), turn(-zi, h, m), h)  # (f·m, h)
    cr, ci = turn(cr, m, h).reshape(f * h, m), turn(ci, m, h).reshape(f * h, m)
    yr = torch.cat([cr, -ci[:, :1]], dim=-1)
    yi = torch.cat([-ci, torch.zeros_like(ci[:, :1])], dim=-1)
    out = _irfft_panel(yr, yi, 2 * m, 4, panel=panel)
    return (out / h).reshape(f, h, 2 * m)


def irfft2_fused_plain(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Plain version of :func:`irfft2_fused`: (F, H, W/2+1) -> (F, H, W)
    float32 in the kernel's own order (:func:`_irfft2_regpass`) on the
    panel of :func:`fft_fused_plain`: the packed columns DC + i Nyquist go
    through the column panel together."""
    return _irfft2_regpass(y, _one_block_panel(radix))


# ------------------------------ wrappers ----------------------------------


def fft_cost(rows: int, n: int) -> Cost:
    """The flops and bytes of a complex FFT of (rows, N), whatever its route:
    5 N log2 N a row; every complex64 value read and written once."""
    return Cost(5.0 * rows * n * math.log2(n), float(16 * rows * n))


def rfft_cost(rows: int, n: int) -> Cost:
    """The flops and bytes of a real FFT of (rows, N) float32 to (rows, N/2+1)
    complex64 (and of its inverse): half a complex FFT's operations; the
    input read and the output written once."""
    return Cost(2.5 * rows * n * math.log2(n), float(4 * rows * n + 8 * rows * (n // 2 + 1)))


def fft2_cost(frames: int, h: int, w: int) -> Cost:
    """The flops and bytes of a 2D complex FFT of (F, H, W): 5 HW log2(HW) a
    frame, every value read and written once."""
    return Cost(5.0 * frames * h * w * math.log2(h * w), float(16 * frames * h * w))


def rfft2_cost(frames: int, h: int, w: int) -> Cost:
    """The flops and bytes of a real 2D FFT of (F, H, W) float32 to (F, H,
    W/2+1) complex64 (and of its inverse)."""
    return Cost(2.5 * frames * h * w * math.log2(h * w),
                float(4 * frames * h * w + 8 * frames * h * (w // 2 + 1)))


def fft2_columns_cost(frames: int, h: int, wc: int) -> Cost:
    """The flops and bytes of the column FFTs of (F, H, Wc): 5 H log2 H a
    column, every value read and written once."""
    return Cost(5.0 * frames * h * wc * math.log2(h), float(16 * frames * h * wc))


def _row_kernel(n: int, real: bool, radix: int, fused: str) -> str:
    """The kernel a row call on rows of length ``n`` launches, and the name
    it is charged and counted under: ``fused`` within one block, else the
    cluster (radix 4, N <= 2^18, the rows ``cluster_geometry`` serves) or
    the two passes. The one routing decision of the row entries, on every
    device."""
    if fft_fits_smem(n, real=real):
        return fused
    return "fft_cluster" if radix == 4 and fft_fits_fused(n) else "fft_two_pass"


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-D tensor, got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name} runs on cpu, cuda or meta tensors, got {x.device}")


def _check_pow2(n: int, name: str, what: str = "length") -> None:
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: {what} must be a power of two >= 2, got {n}")


def _check_launchable(x: torch.Tensor, name: str) -> None:
    refuse_grad(name, x)
    if x.is_conj() or x.is_neg():
        raise ValueError(f"{name}: resolve the conjugate/negative view first")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if x.data_ptr() % 8:
        raise ValueError(f"{name} needs an 8-byte aligned tensor")


def _check_out(x: torch.Tensor, out: torch.Tensor | None, name: str) -> None:
    """An ``out=`` buffer must match ``x`` in shape, dtype and device."""
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"{name}: out must match x, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")


def _check_fused_row(n: int, name: str) -> None:
    """Raise past the wrappers' envelope (N > 2^24, :func:`fft_fits_card`),
    in the reference's words."""
    if not fft_fits_card(n):
        raise ValueError(
            f"{name}: length-{n} rows exceed the fused-kernel budget (N <= 2^24, "
            "the two-pass kernels' exact twiddles); use an unfused variant"
        )


def _column_pass(x: torch.Tensor, src: int, scratch: int, b: int, n: int,
                 conj: bool) -> None:
    """Launch the column pass of ``csrc/fft_two_pass.cu`` on b rows of n
    complex values at ``src``, into the (b, n1, n2) ``scratch`` (``x`` names
    the device and stream)."""
    g = two_pass_geometry(n)
    _launch("repro_two_pass_columns", "fft_two_pass", x, src, scratch, b, g.n1, g.n2,
            g.cols, g.col_threads, g.col_smem, int(conj))


def _row_pass(x: torch.Tensor, scratch: int, dst: int, b: int, n: int,
              conj: bool, scale: float) -> None:
    """Launch the row pass of ``csrc/fft_two_pass.cu``: ``scratch`` from the
    column pass into b rows of n complex values at ``dst``."""
    g = two_pass_geometry(n)
    _launch("repro_two_pass_rows", "fft_two_pass", x, scratch, dst, b, g.n1, g.n2,
            g.rows, g.row_threads, g.row_smem, int(conj), scale)


def _two_pass(x: torch.Tensor, src: int, dst: int, b: int, n: int,
              conj: bool, scale: float) -> None:
    """The column and the row pass on b rows of n complex values at ``src``,
    into ``dst``. The scratch between the passes is freed on return; the
    allocator reuses it only for work queued after both passes."""
    scratch = torch.empty((b, n), dtype=torch.complex64, device=x.device)
    _column_pass(x, src, scratch.data_ptr(), b, n, conj)
    _row_pass(x, scratch.data_ptr(), dst, b, n, conj, scale)


def _cluster(x: torch.Tensor, src: int, dst: int, b: int, m: int, kind: str, conj: bool = False,
             scale: float = 1.0) -> None:
    """Launch ``csrc/fft_cluster.cu`` on b rows of m complex values (the
    packed half rows of a real ``kind``): one cluster a row, one HBM round
    trip."""
    g = cluster_geometry(m)
    _launch("repro_fft_cluster", "fft_cluster", x, src, dst, b, m, CLUSTER_KINDS[kind], g.ctas,
            g.values, g.threads, g.smem, int(conj), scale)


def fft_fused(x: torch.Tensor, *, radix: int = 2, inverse: bool = False,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """FFT along the last axis of (B, N) complex64, N <= 2^24
    (:func:`fft_fits_card`).

    A row that fits one block costs one HBM round trip. A longer row
    (2^14 < N) takes one cluster of CTAs at radix 4 up to 2^18 (one round
    trip, one launch) and the two-pass kernels at radix 2, and at radix 4
    past 2^18 (two of each).
    ``inverse`` conjugates on the way in and out and scales by 1/N: the
    inverse transform on the same panels, without extra passes over HBM.
    Writes ``out`` (a new tensor when None): a buffer of ``x``'s shape,
    dtype and device that does not overlap ``x``, such as a slice of a
    larger output.
    """
    _check(x, "fft_fused", torch.complex64, 2)
    b, n = x.shape
    _check_pow2(n, "fft_fused")
    _panel(radix)
    _check_fused_row(n, "fft_fused")
    route = _row_kernel(n, False, radix, "fft_fused")
    _check_out(x, out, "fft_fused")
    if x.device.type == "cpu":
        if route == "fft_fused":
            y = fft_fused_plain(x, radix=radix, inverse=inverse)
        elif route == "fft_cluster":
            y = fft_cluster_plain(x, inverse=inverse)
        else:  # the two passes run radix-2 layers at either radix
            y = fft_two_pass_plain(x, inverse=inverse)
        return y if out is None else out.copy_(y)
    _check_launchable(x, "fft_fused")
    if out is None:
        out = torch.empty_like(x)
    _check_launchable(out, "fft_fused")
    scale = 1.0 / n if inverse else 1.0
    if b:
        charge(route, fft_cost, b, n)
    if b and route == "fft_fused":
        rows = pick_row_tile(b, n)
        _launch("repro_fft_fused", "fft_fused", x, x.data_ptr(), out.data_ptr(), b, n, radix,
                rows, block_threads(rows * n), fft_smem_bytes(n, rows), int(inverse), scale)
    elif b and route == "fft_cluster":
        _cluster(x, x.data_ptr(), out.data_ptr(), b, n, "fft", inverse, scale)
    elif b:
        _two_pass(x, x.data_ptr(), out.data_ptr(), b, n, inverse, scale)
    return out


def rfft_fused(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Real FFT of (B, N) float32 -> (B, N/2+1) complex64, two for one,
    N <= 2^24. Rows over one block take one cluster launch at radix 4 up
    to 2^18, which recombines on its way out; at radix 2, and past 2^18,
    the two passes at N/2 and a recombination pass: three launches."""
    _check(x, "rfft_fused", torch.float32, 2)
    b, n = x.shape
    _check_pow2(n, "rfft_fused")
    _panel(radix)
    _check_fused_row(n, "rfft_fused")
    route = _row_kernel(n, True, radix, "rfft_fused")
    if x.device.type == "cpu":
        if route == "rfft_fused":
            return rfft_fused_plain(x, radix=radix)
        if route == "fft_cluster":
            return rfft_cluster_plain(x)
        return rfft_two_pass_plain(x)
    _check_launchable(x, "rfft_fused")
    out = torch.empty((b, n // 2 + 1), dtype=torch.complex64, device=x.device)
    m = n // 2
    if b:
        charge(route, rfft_cost, b, n)
    if b and route == "rfft_fused":
        rows = pick_row_tile(b, m)
        _launch("repro_rfft_fused", "rfft_fused", x, x.data_ptr(), out.data_ptr(), b, n, radix,
                rows, block_threads(rows * m), rfft_smem_bytes(n, rows))
    elif b and route == "fft_cluster":
        _cluster(x, x.data_ptr(), out.data_ptr(), b, m, "rfft")
    elif b:
        z = torch.empty((b, m), dtype=torch.complex64, device=x.device)
        _two_pass(x, x.data_ptr(), z.data_ptr(), b, m, False, 1.0)
        _launch("repro_two_pass_recombine", "fft_two_pass", x, z.data_ptr(), out.data_ptr(),
                b, m)
    return out


def irfft_fused(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Inverse of :func:`rfft_fused`: (B, N/2+1) complex64 -> (B, N) float32.
    The imaginary parts at DC and Nyquist are dropped, as numpy does. Rows
    over one block take one cluster launch at radix 4 up to N = 2^18, which
    untangles on its way in; at radix 2, and past 2^18, an untangling pass,
    then the two passes at N/2: three launches."""
    _check(y, "irfft_fused", torch.complex64, 2)
    b, half = y.shape
    n = 2 * (half - 1)
    _check_pow2(n, "irfft_fused", "2 * (width - 1)")
    _panel(radix)
    _check_fused_row(n, "irfft_fused")
    route = _row_kernel(n, True, radix, "irfft_fused")
    if y.device.type == "cpu":
        if route == "irfft_fused":
            return irfft_fused_plain(y, radix=radix)
        if route == "fft_cluster":
            return irfft_cluster_plain(y)
        return irfft_two_pass_plain(y)
    _check_launchable(y, "irfft_fused")
    out = torch.empty((b, n), dtype=torch.float32, device=y.device)
    m = n // 2
    if b:
        charge(route, rfft_cost, b, n)
    if b and route == "irfft_fused":
        rows = pick_row_tile(b, m)
        _launch("repro_irfft_fused", "irfft_fused", y, y.data_ptr(), out.data_ptr(), b, n,
                radix, rows, block_threads(rows * m), irfft_smem_bytes(n, rows))
    elif b and route == "fft_cluster":
        _cluster(y, y.data_ptr(), out.data_ptr(), b, m, "irfft", scale=1.0 / m)
    elif b:
        # The untangled half-size rows go into ``out`` itself (B x N/2
        # complex is B x N float32); the column pass reads them from there
        # before the row pass overwrites ``out`` with the result.
        _launch("repro_two_pass_untangle", "fft_two_pass", y, y.data_ptr(), out.data_ptr(),
                b, m)
        _two_pass(y, out.data_ptr(), out.data_ptr(), b, m, True, 1.0 / m)
    return out


def fft2_fused(x: torch.Tensor, *, radix: int = 2, inverse: bool = False) -> torch.Tensor:
    """2D FFT of (F, H, W) complex64 frames, one block per frame.

    Only frames that fit one block (:func:`fft2_fits_smem`); ``inverse``
    as in :func:`fft_fused`, scaled by 1/(H W).
    """
    _check(x, "fft2_fused", torch.complex64, 3)
    f, h, w = x.shape
    _check_pow2(h, "fft2_fused", "frame height")
    _check_pow2(w, "fft2_fused", "frame width")
    _panel(radix)
    if not fft2_fits_smem(h, w):
        raise ValueError(f"fft2_fused: frame {(h, w)} exceeds one block's shared memory")
    if x.device.type == "cpu":
        return fft2_fused_plain(x, radix=radix, inverse=inverse)
    _check_launchable(x, "fft2_fused")
    out = torch.empty_like(x)
    if f:
        charge("fft2_fused", fft2_cost, f, h, w)
        _launch("repro_fft2_fused", "fft2_fused", x, x.data_ptr(), out.data_ptr(), f, h, w,
                radix, block_threads(h * w), fft2_smem_bytes(h, w), int(inverse),
                1.0 / (h * w) if inverse else 1.0)
    return out


def rfft2_fused(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Real 2D FFT of (F, H, W) float32 frames -> (F, H, W/2+1) complex64,
    one block per frame. Only frames that fit one block
    (:func:`rfft2_fits_smem`)."""
    _check(x, "rfft2_fused", torch.float32, 3)
    f, h, w = x.shape
    _check_pow2(h, "rfft2_fused", "frame height")
    _check_pow2(w, "rfft2_fused", "frame width")
    _panel(radix)
    if not rfft2_fits_smem(h, w):
        raise ValueError(f"rfft2_fused: frame {(h, w)} exceeds one block's shared memory")
    if x.device.type == "cpu":
        return rfft2_fused_plain(x, radix=radix)
    _check_launchable(x, "rfft2_fused")
    out = torch.empty((f, h, w // 2 + 1), dtype=torch.complex64, device=x.device)
    if f:
        charge("rfft2_fused", rfft2_cost, f, h, w)
        _launch("repro_rfft2_fused", "rfft2_fused", x, x.data_ptr(), out.data_ptr(), f, h, w,
                radix, block_threads(h * (w // 2)), rfft2_smem_bytes(h, w))
    return out


def irfft2_fused(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Inverse of :func:`rfft2_fused`: (F, H, W/2+1) complex64 -> (F, H, W)
    float32. The imaginary parts that the row inverse drops (DC and
    Nyquist, after the column inverse) are dropped, as numpy does."""
    _check(y, "irfft2_fused", torch.complex64, 3)
    f, h, half = y.shape
    w = 2 * (half - 1)
    _check_pow2(h, "irfft2_fused", "frame height")
    _check_pow2(w, "irfft2_fused", "2 * (width - 1)")
    _panel(radix)
    if not rfft2_fits_smem(h, w):
        raise ValueError(f"irfft2_fused: frame {(h, w)} exceeds one block's shared memory")
    if y.device.type == "cpu":
        return irfft2_fused_plain(y, radix=radix)
    _check_launchable(y, "irfft2_fused")
    out = torch.empty((f, h, w), dtype=torch.float32, device=y.device)
    if f:
        charge("irfft2_fused", rfft2_cost, f, h, w)
        _launch("repro_irfft2_fused", "irfft2_fused", y, y.data_ptr(), out.data_ptr(), f, h, w,
                radix, block_threads(h * (w // 2)), rfft2_smem_bytes(h, w))
    return out


def fft2_columns(x: torch.Tensor, *, radix: int = 2, inverse: bool = False,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """FFT down the columns of (F, H, Wc) complex64 frames: the column pass
    of the composed 2D route, after the rows (fft2, rfft2) or before them
    (irfft2). Wc is any width (W, or W/2+1 for a half spectrum); H a power
    of two that :func:`fft2_columns_serves`.

    Writes ``out`` (a new tensor when None); ``out`` may be ``x`` itself,
    which the kernel transforms in place. One launch, one HBM round trip:
    each block reads a panel of neighbouring columns as runs of whole rows,
    so the corner turn is addressing. ``inverse`` conjugates on the way in
    and out and scales by 1/H.
    """
    _check(x, "fft2_columns", torch.complex64, 3)
    f, h, wc = x.shape
    _check_pow2(h, "fft2_columns", "frame height")
    _panel(radix)
    if not fft2_columns_serves(h):
        raise ValueError(f"fft2_columns: columns of {h} values exceed one block's panel "
                         f"(H <= {COLUMN_PANEL_VALUES // COLUMN_PANEL_MIN_COLS})")
    _check_out(x, out, "fft2_columns")
    if x.device.type == "cpu":
        y = fft2_columns_plain(x, radix=radix, inverse=inverse)
        return y if out is None else out.copy_(y)
    _check_launchable(x, "fft2_columns")
    if out is None:
        out = torch.empty_like(x)
    _check_launchable(out, "fft2_columns")
    if f and wc:
        charge("fft2_columns", fft2_columns_cost, f, h, wc)
        g = fft2_columns_geometry(h, wc)
        _launch("repro_fft2_columns", "fft2_columns", x, x.data_ptr(), out.data_ptr(), f, h,
                wc, radix, g.cols, g.threads, g.smem, int(inverse),
                1.0 / h if inverse else 1.0)
    return out
