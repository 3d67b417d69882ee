"""The register-pass panel of the radix-4 ``fft_fused`` and ``rfft_fused``.

``csrc/stockham_regs.cuh`` runs on the card only. Here, on the CPU:

* its twin, ``fft_radix2._regpass_panel`` (the plain version of the two
  kernels at radix 4), is held to the Pallas kernels in interpret mode and
  to numpy at max|port - ref| <= 1e-5 * max|ref| (the reference's kernel
  tolerance), on every power of two from 2 to 16384 with odd batches;
* a numpy model of the kernels' shared-memory accesses replays each
  thread's reads and writes in each pass, and in ``rfft_fused``'s
  recombination (or its paired last pass), at the launch geometry the
  census gives, and asserts that
  every slot of a pass's layout (padded after the first pass, plain
  after later ones) is written exactly once and that the
  distinct 8-byte addresses of each half-warp fall in distinct bank pairs
  (slot mod 16);
* the census: padding the two kernels' blocks leaves every power of two
  fitting one block exactly where it fitted before.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch.kernels import fft_radix2 as k

TOL = 1e-5
SIZES = [2 ** p for p in range(1, 15)]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


# ------------------------------- the twin ----------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_regpass_fft_matches_pallas_and_numpy(n):
    batch = 5 if n <= 1024 else 3
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    yr, yi = jref.fft_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=4, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    pr, pi = k._regpass_panel(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()), n)
    _close(pr.numpy() + 1j * pi.numpy(), ref)
    _close(pr.numpy() + 1j * pi.numpy(), np.fft.fft(x.astype(np.complex128)))
    t = torch.from_numpy(x)
    _close(k.fft_fused(t, radix=4).numpy(), ref)
    _close(k.fft_fused_plain(t, radix=4, inverse=True).numpy(),
           np.fft.ifft(x.astype(np.complex128)))


@pytest.mark.parametrize("n", SIZES)
def test_regpass_rfft_matches_pallas_and_numpy(n):
    batch = 5 if n <= 1024 else 3
    x = np.random.default_rng(3 * n).standard_normal((batch, n)).astype(np.float32)
    yr, yi = jref.rfft_fused(jnp.asarray(x), radix=4, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = k.rfft_fused(torch.from_numpy(x), radix=4).numpy()
    _close(got, ref)
    _close(got, np.fft.rfft(x.astype(np.float64)))


def test_regpass_radices_factor_the_line():
    assert k.regpass_radices(2048) == (16, 16, 8)
    assert k.regpass_radices(1024) == (16, 16, 4)
    assert k.regpass_radices(16384) == (16, 16, 16, 4)
    assert k.regpass_radices(8) == (8,) and k.regpass_radices(1) == (1,)
    for n in SIZES:
        assert int(np.prod(k.regpass_radices(n))) == n


# --------------------- the padded shared-memory exchange ---------------------

HALF_WARP = 16


_slot = k.smem_slot  # works on numpy arrays too


def _geometry(n, batch):
    rows = k.pick_row_tile(batch, n)
    p = rows * n
    return p, k.block_threads(p)


def _check_half_warps(addr, threads):
    """addr: one access instruction, the slot each thread touches (-1: no
    access). Distinct slots of a half-warp must fall in distinct bank pairs."""
    for h0 in range(0, threads, HALF_WARP):
        a = addr[h0:h0 + HALF_WARP]
        a = np.unique(a[a >= 0])
        assert len(np.unique(a % 16)) == len(a), (h0, a)


def _at(i, padded):
    return _slot(i) if padded else i


def _pass_accesses(n, p, threads, radix, log_l, src_padded, dst_padded):
    """Slots read (at t + j n/R) and written (at q R l + c l + k) by one
    pass of ``pass`` in csrc/stockham_regs.cuh: per instruction, one slot
    per thread. The first pass writes the padded layout, the second reads
    it and writes the plain one."""
    log_r = radix.bit_length() - 1
    s = n >> log_r
    l = 1 << log_l
    reads, writes = [], []
    tid = np.arange(threads)
    for i in range(16 // radix):
        g = tid + i * threads
        ok = g < (p >> log_r)
        line, t = g // s, g % s
        kk, q = t % l, t // l
        for j in range(radix):
            reads.append(np.where(ok, _at(line * n + t + j * s, src_padded), -1))
        for c in range(radix):
            writes.append(np.where(ok, _at(line * n + q * radix * l + c * l + kk, dst_padded),
                                   -1))
    return reads, writes


def _panel_passes(n):
    """(radix, log_l) of each pass over a line of n."""
    out, log_l = [], 0
    for radix in k.regpass_radices(n):
        out.append((radix, log_l))
        log_l += radix.bit_length() - 1
    return out


@pytest.mark.parametrize("n", [2 ** p for p in range(4, 15)])
@pytest.mark.parametrize("real", [False, True], ids=["fft_fused", "rfft_fused"])
def test_padded_exchange_is_conflict_free(n, real):
    """Every pass that goes through shared memory: fft_fused's reads after
    its first pass and writes before its last (the first loads from HBM, the
    last stores to it); rfft_fused's panel on its half rows, whose last pass
    also writes shared memory. Geometry: chip_smoke's batch of 8192 rows and
    a single row. The radix-2 kernels' register passes exchange through the
    same slots (their layers differ in registers only)."""
    line = n // 2 if real else n
    passes = _panel_passes(line)
    # rfft_fused's paired last pass reads otherwise (its own test below)
    # and writes to HBM, like fft_fused's
    paired = real and k.rfft_pairs_in_registers(line)
    spilled = real and not paired
    for batch in (8192, 1):
        p, threads = _geometry(line, batch)
        for idx, (radix, log_l) in enumerate(passes):
            last = idx == len(passes) - 1
            reads, writes = _pass_accesses(line, p, threads, radix, log_l, idx == 1, idx == 0)
            if idx > 0 and not (paired and last):
                for a in reads:
                    _check_half_warps(a, threads)
            if not last or spilled:
                for a in writes:
                    _check_half_warps(a, threads)
                written = np.concatenate([a[a >= 0] for a in writes])
                assert np.array_equal(np.sort(written), _at(np.arange(p), idx == 0))


def _paired_last_pass_reads(m, p, threads):
    """Slots read by rfft_fused's last pass where it pairs the mirror groups
    p and l - p in registers (fft_fused.cu, rfft_last_pass_paired), from
    the plain layout: group p's inputs, group l - p's (l/2's for p = 0),
    and the recombination's ROM reads W_{2m}^{p + c l} (l/2 + c l for the
    pair p = 0)."""
    radix = k.regpass_radices(m)[-1]
    l = m // radix
    tid = np.arange(threads)
    rom = _slot(p)
    acc = []
    for i in range(16 // (2 * radix)):
        pp = tid + i * threads
        line, q = pp // (l // 2), pp % (l // 2)
        base = line * m
        for j in range(radix):
            acc += [base + q + j * l, base + np.where(q == 0, l // 2, l - q) + j * l]
        for c in range(radix):
            acc += [rom + _slot(q + c * l), np.where(q == 0, rom + _slot(l // 2 + c * l), -1)]
    return acc


def _recombination_reads(m, p, threads):
    """Slots rfft_fused's recombination reads (fft_fused.cu,
    rfft_regs_kernel): values (plain after two or more passes, padded after
    one) and ROM, per instruction."""
    if k.rfft_pairs_in_registers(m):
        return _paired_last_pass_reads(m, p, threads)
    padded = len(k.regpass_radices(m)) == 1
    tid = np.arange(threads)
    rom = _slot(p)  # the ROM follows the padded values
    acc = []
    for s in range(-(-p // threads)):
        it = tid + s * threads
        ok = it < p
        line, kk = it // m, it % m
        acc += [np.where(ok, _at(it, padded), -1),
                np.where(ok, _at(line * m + m - np.maximum(kk, 1), padded), -1),
                np.where(ok, rom + _slot(kk), -1)]
    return acc


@pytest.mark.parametrize("n", [2 ** p for p in range(4, 15)])
def test_rfft_recombination_reads_are_conflict_free(n):
    m = n // 2
    for batch in (8192, 1):
        p, threads = _geometry(m, batch)
        for a in _recombination_reads(m, p, threads):
            _check_half_warps(a, threads)


def test_exchange_and_barrier_counts():
    """chip_smoke's rows: fft_fused on 2048 values is 16·16·8, two
    exchanges and three barriers; rfft_fused's half row of 1024 is 16·16·4
    with the mirror bins paired in its last pass, the same two and three."""
    assert (k.regpass_exchanges(2048), k.regpass_barriers(2048)) == (2, 3)
    assert k.rfft_pairs_in_registers(1024)
    assert (k.regpass_exchanges(2048, real=True), k.regpass_barriers(2048, real=True)) == (2, 3)
    # a last pass of 16 keeps the recombination's exchange: 16·16·16
    assert not k.rfft_pairs_in_registers(4096)
    assert (k.regpass_exchanges(8192, real=True), k.regpass_barriers(8192, real=True)) == (3, 5)
    assert [m for m in (2 ** p for p in range(14)) if k.rfft_pairs_in_registers(m)] == \
        [2 ** 9, 2 ** 10, 2 ** 11, 2 ** 13]


def test_padding_keeps_every_fit():
    """The census pads values and ROM by one slot per 16; every power of two
    up to 2^18 fits one block exactly where the unpadded census fitted."""
    for n in (2 ** p for p in range(1, 19)):
        m = n // 2
        old_complex = (n + n // 2) * 8 <= k.SMEM_BUDGET_BYTES and k.block_threads(n) <= 1024
        old_real = (max(2 * m + 1, 2 * m) * 8 <= k.SMEM_BUDGET_BYTES
                    and k.block_threads(max(m, 1)) <= 1024)
        assert k.fft_fits_smem(n) == old_complex, n
        assert k.fft_fits_smem(n, real=True) == old_real, n
    assert k.fft_smem_bytes(16384) == (17408 + 8704) * 8 <= k.SMEM_BUDGET_BYTES
    assert k.rfft_smem_bytes(2048, 4) == (_slot(4096) + _slot(1025)) * 8
