"""Rows over one block at radix 4: the cluster kernel of ``fft_fused``,
``rfft_fused`` and ``irfft_fused`` (2^14 < N <= 2^18).

``csrc/fft_cluster.cu`` runs on the card only. Here, on the CPU:

* its twin (``fft_radix2._cluster_panel``, which the radix-4 wrappers run
  on a CPU tensor) is held to the Pallas kernels in interpret mode at the
  rows of ``tests/test_torch_fft_two_pass.py``, both directions, and to
  numpy at N = 2^17 and 2^18, at max|port - ref| <= 1e-5 * max|ref|
  (the reference's kernel tolerance); round trips 1e-4;
* a numpy model replays the kernel's data movement at every instance the
  census launches: each thread's HBM reads (whole 32-byte sectors), its
  shared-memory accesses, local and remote, and the lanes' shuffles, with
  the numpy FFT in place of the panel that
  ``tests/test_torch_fft_regpass.py`` models. It asserts that the result
  is the FFT, that every value is written exactly once, that no phase
  between two barriers both reads and writes a slot of one CTA's buffer
  (so no buffer is overwritten before the barrier that ends its reads),
  and that the distinct 8-byte addresses of each half-warp fall in
  distinct bank pairs (slot mod 16), the exchange's twiddle reads at most
  4-way;
* the census and the launch arguments the wrappers pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch.kernels import fft_radix2 as k

TOL = 1e-5
ROUND_TRIP_TOL = 1e-4
HALF_WARP = 16


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pallas_fft(x):
    yr, yi = jref.fft_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=4, interpret=True)
    return np.asarray(yr) + 1j * np.asarray(yi)


# ------------------------------- the twin ----------------------------------


@pytest.mark.parametrize("n,batch", [(2 ** 15, 3), (2 ** 16, 2)])
def test_cluster_fft_matches_pallas(n, batch):
    """Forward, and inverse as the reference computes it: conj(fft(conj x)) / N."""
    x = _crandn(np.random.default_rng(40 + n + batch), (batch, n))
    ref = _pallas_fft(x)
    got = k.fft_fused(torch.from_numpy(x), radix=4)
    _close(got.numpy(), ref)
    _close(k.fft_cluster_plain(torch.from_numpy(x)).numpy(), ref)
    spec = ref.astype(np.complex64)
    ref_inv = np.conj(_pallas_fft(np.conj(spec))) / n
    _close(k.fft_fused(torch.from_numpy(spec), radix=4, inverse=True).numpy(), ref_inv)
    back = k.fft_fused(got, radix=4, inverse=True)
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))


@pytest.mark.parametrize("n,batch", [(2 ** 15, 2), (2 ** 16, 3)])
def test_cluster_rfft_irfft_match_pallas(n, batch):
    rng = np.random.default_rng(50 + n + batch)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    yr, yi = jref.rfft_fused(jnp.asarray(x), radix=4, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = k.rfft_fused(torch.from_numpy(x), radix=4)
    _close(got.numpy(), ref)
    _close(k.rfft_cluster_plain(torch.from_numpy(x)).numpy(), ref)
    back = k.irfft_fused(got, radix=4)
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))
    # a half spectrum that is not the rfft of a real row: DC's and
    # Nyquist's imaginary parts must be dropped as the reference drops them
    y = _crandn(rng, (batch, n // 2 + 1))
    ref_back = jref.irfft_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=4,
                                interpret=True)
    _close(k.irfft_fused(torch.from_numpy(y), radix=4).numpy(), np.asarray(ref_back))
    _close(k.irfft_cluster_plain(torch.from_numpy(y)).numpy(), np.asarray(ref_back))


@pytest.mark.parametrize("n", [2 ** 17, 2 ** 18])
def test_cluster_twin_matches_numpy(n):
    """Complex and real rows against numpy in float64: 16 and 64 lines
    (one and four lanes a position) for the complex rows, 16 and 32 for the
    real ones at N/2."""
    rng = np.random.default_rng(n)
    x = _crandn(rng, (1, n))
    got = k.fft_cluster_plain(torch.from_numpy(x))
    _close(got.numpy(), np.fft.fft(x.astype(np.complex128)))
    inv = k.fft_cluster_plain(got, inverse=True)
    _close(inv.numpy(), np.fft.ifft(got.numpy().astype(np.complex128)))
    r = rng.standard_normal((1, 2 * n)).astype(np.float32)
    half = k.rfft_cluster_plain(torch.from_numpy(r))
    _close(half.numpy(), np.fft.rfft(r.astype(np.float64)))
    back = k.irfft_cluster_plain(half)
    _close(back.numpy(), np.fft.irfft(half.numpy().astype(np.complex128)))
    assert np.max(np.abs(back.numpy() - r)) <= ROUND_TRIP_TOL * np.max(np.abs(r))


# ----------------------------- the census ----------------------------------

# Every row length m the census launches (packed real rows from 2^14).
ROWS = [2 ** p for p in range(14, 19)]


def test_census_of_the_clusters():
    """C <= 16, and 16 only at m >= 2^17; every CTA within the budget; M/16
    threads; the smem the C entry checks."""
    for m in ROWS:
        g = k.cluster_geometry(m)
        assert g.ctas * g.values == m and g.values in (2 ** 13, 2 ** 14)
        assert 2 <= g.ctas <= k.MAX_CLUSTER
        assert g.ctas < 16 or m >= 2 ** 17
        assert g.threads * 16 == g.values <= 16 * k.MAX_THREADS
        slot = k.smem_slot
        per_cta = g.lines // g.ctas
        assert per_cta == (8 if g.ctas == 2 else 4)  # each load run a whole sector or two
        assert g.lines in (16, 32, 64) and g.lines // 16 <= 4  # lanes a q
        assert g.smem == (slot(g.values) + slot(m // g.lines // 2) + g.lines + 128) * 8
        assert g.smem <= k.SMEM_BUDGET_BYTES
    assert [k.cluster_geometry(2 ** p).ctas for p in range(14, 19)] == [2, 4, 8, 16, 16]
    # what each wrapper launches over one block at radix 4 fits the budget
    for p in range(15, 19):
        n = 2 ** p
        assert k.row_smem_bytes(n, radix=4) == k.cluster_geometry(n).smem
        assert k.row_smem_bytes(n, real=True, radix=4) == k.cluster_geometry(n // 2).smem
    assert k.row_smem_bytes(2 ** 14, radix=4) == k.fft_smem_bytes(2 ** 14)  # one block
    assert k.row_smem_bytes(2 ** 19, radix=4) > k.SMEM_BUDGET_BYTES  # the reference's
    assert (k.row_smem_bytes(2 ** 19, radix=4, fits=k.fft_fits_card)
            == k.two_pass_geometry(2 ** 19).col_smem)  # past 2^18: the two passes
    assert k.cluster_exchanges(2 ** 18) == 2 + k.regpass_exchanges(2 ** 12) == 4
    assert k.cluster_exchanges(2 ** 15) == 2 + k.regpass_exchanges(2 ** 11) == 4


@pytest.mark.parametrize("kind,conj,scale", [("fft", True, 2.0 ** -18), ("rfft", False, 1.0),
                                             ("irfft", False, 2.0 ** -17)])
def test_cluster_launch_arguments(monkeypatch, kind, conj, scale):
    """The wrapper hands the C entry the rows, the census's C, M, threads
    and bytes; the entry launches a grid of B·C blocks in clusters of C."""
    calls = []
    monkeypatch.setattr(k, "_launch", lambda *args: calls.append(args))
    x = torch.zeros(1, 2)
    k._cluster(x, 16, 32, 7, 2 ** 17, kind, conj, scale)
    g = k.cluster_geometry(2 ** 17)
    assert calls == [("repro_fft_cluster", "fft_cluster", x, 16, 32, 7, 2 ** 17,
                      k.CLUSTER_KINDS[kind], g.ctas, g.values, g.threads, g.smem, int(conj),
                      scale)]


def test_cpu_rows_over_one_block_count_no_launch():
    k.reset_launches()
    x = torch.from_numpy(_crandn(np.random.default_rng(1), (1, 2 ** 15)))
    k.irfft_fused(k.rfft_fused(k.fft_fused(x, radix=4).real.contiguous(), radix=4), radix=4)
    assert not any(k.LAUNCHES.values())


# -------------------------- the kernel's data flow ---------------------------


_slot = k.smem_slot  # works on numpy arrays too


def _check_half_warps(addr):
    """addr: one access instruction, the slot each thread touches (-1: no
    access). Distinct slots of a half-warp must fall in distinct bank pairs."""
    for h0 in range(0, len(addr), HALF_WARP):
        a = addr[h0:h0 + HALF_WARP]
        a = np.unique(a[a >= 0])
        assert len(np.unique(a % 16)) == len(a), (h0, a)


class _Cluster:
    """The C buffers of one row's cluster and the accesses of one phase
    (between two barriers): per CTA, the slots read and written."""

    def __init__(self, ctas, slots):
        self.buf = np.full((ctas, slots), np.nan + 0j)
        self.writes = np.zeros((ctas, slots), np.int64)
        self.read_now = np.zeros(self.buf.shape, bool)
        self.written_now = np.zeros(self.buf.shape, bool)

    def barrier(self):
        """End a phase: no slot may be both read and written within it."""
        assert not np.any(self.read_now & self.written_now), "read and written in one phase"
        self.read_now[:] = False
        self.written_now[:] = False

    def read(self, cta, slot):
        """One instruction: thread i reads slot[i] of CTA ``cta`` (-1: none)."""
        _check_half_warps(slot)
        ok = slot >= 0
        self.read_now[cta, slot[ok]] = True
        return np.where(ok, self.buf[cta, np.where(ok, slot, 0)], np.nan)

    def write(self, cta, slot, v):
        _check_half_warps(slot)
        self.written_now[cta, slot] = True
        self.writes[cta, slot] += 1
        self.buf[cta, slot] = v


def _recombine(z, zm, k, m):
    """Y[k] = Xe + W_2m^k Xo from z = Z[k] and zm = conj Z[m-k]."""
    return 0.5 * (z + zm) + np.exp(-1j * np.pi * k / m) * (-0.5j) * (z - zm)


def _lanes(g, r, real):
    """(q, a1) of each thread of CTA r in the exchange: L = A/16 lanes take
    one q, lane a1 of them lines a1 + L a2; for rfft, lanes l and l + 16
    hold p and Q - p (Q/2 for p = 0)."""
    t, q_, l_ = g.threads, g.m // g.lines, g.lines // 16
    tid = np.arange(t)
    lane, a1 = tid % 32, tid % l_
    qc = q_ // g.ctas
    q = r * qc + tid // l_
    if real:
        p = r * (qc // 2) + (tid // 32) * (16 // l_) + (lane % 16) // l_
        q = np.where(lane < 16, p, np.where(p == 0, q_ // 2, q_ - p))
    return q, a1


def _run_model(x, m, real):
    """csrc/fft_cluster.cu on one packed row x of m values, thread by
    thread (vectorised over the threads of a CTA): returns X = FFT(x), or
    for ``real`` the half spectrum of the real row that x packs."""
    g = k.cluster_geometry(m)
    ctas, t, lines_ = g.ctas, g.threads, g.lines
    q_, p_, l_ = m // lines_, lines_ // ctas, lines_ // 16
    load_stride, line_stride = q_ + 16 // p_, q_ + 16 // l_
    tid = np.arange(t)
    lane = tid % 32
    cl = _Cluster(ctas, _slot(g.values))
    # 1. load: value i of CTA r is value j = i mod P of the run A n + P r
    for r in range(ctas):
        for s in range(16):
            i = tid + s * t
            n, j = i // p_, i % p_
            addr = lines_ * n + p_ * r + j
            runs = addr.reshape(-1, p_)  # whole runs of P: 32-byte sectors (64 at C = 2)
            assert (np.diff(runs, axis=1) == 1).all() and (runs[:, 0] % 4 == 0).all()
            cl.write(r, j * load_stride + n, x[addr])
    assert (cl.writes.sum(axis=1) == g.values).all() and cl.writes.max() == 1
    cl.barrier()  # __syncthreads
    for r in range(ctas):  # line a = P r + j, as the panel's first pass reads it
        for j in range(p_):
            np.testing.assert_array_equal(cl.buf[r, j * load_stride + np.arange(q_)],
                                          x[p_ * r + j::lines_])
    # 2. the panel, shared memory to shared memory (its own accesses:
    # tests/test_torch_fft_regpass.py), leaving line j at j (Q + 16/L)
    for r in range(ctas):
        lines = np.stack([cl.buf[r, j * load_stride + np.arange(q_)] for j in range(p_)])
        cl.buf[r, :] = np.nan
        for j in range(p_):
            cl.buf[r, j * line_stride + np.arange(q_)] = np.fft.fft(lines[j])
    cl.barrier()  # cluster barrier: every Y_a is complete
    # 3. the A-point DFTs across the cluster, and the store
    out = np.full(m + 1 if real else m, np.nan + 0j)
    stored = np.zeros(out.shape, np.int64)
    k1_of = np.array([0, 2, 1, 3]) if l_ == 4 else np.arange(l_)  # lane a1 -> output k1

    def store(at, val):
        out[at] = val
        stored[at] += 1

    for r in range(ctas):
        q, a1 = _lanes(g, r, real)
        v = []
        for a2 in range(16):
            a = a1 + l_ * a2
            v.append(cl.read(a // p_, (a % p_) * line_stride + q)
                     * np.exp(-2j * np.pi * a * q / m))
        z = np.fft.fft(np.stack(v), axis=0) * np.exp(  # [k2, thread], times W_A^(a1 k2)
            -2j * np.pi * np.arange(16).reshape(16, 1) * a1 / lines_)
        groups = np.fft.fft(z.reshape(16, t // l_, l_), axis=2)  # over a1: [k2, q, k1]
        z = groups[:, np.arange(t) // l_, k1_of[a1]]  # what lane a1 holds: output k1_of[a1]
        k1 = k1_of[a1]
        if not real:
            for k2 in range(16):
                store(q + q_ * (k2 + 16 * k1), z[k2])
            continue
        for k2 in range(16):  # the shuffles: each lane sends, each takes from src
            send = np.where(q == 0, z[(16 - k2) % 16], z[15 - k2])
            src = tid ^ (16 | (l_ - 1))
            src = np.where((q == q_ // 2) | ((q == 0) & (k2 != 0)), tid ^ (l_ - 1), src)
            zero_a1 = np.where(a1 < 2, a1, a1 ^ 1) if l_ == 4 else a1
            src = np.where((q == 0) & (k2 == 0), (tid & ~(l_ - 1)) | zero_a1, src)
            assert (src // 32 == tid // 32).all()  # within the warp
            zm = send[src]
            kk = q + q_ * (k2 + 16 * k1)
            store(kk, _recombine(z[k2], np.conj(zm), kk, m))
        first = np.flatnonzero((q == 0) & (a1 == 0))
        if first.size:
            store(np.array([m]), _recombine(z[0, first], np.conj(z[0, first]), m, m))
    cl.barrier()  # the last: no peer reads a buffer past it
    assert (stored == 1).all()
    return out


@pytest.mark.parametrize("m", ROWS)
def test_cluster_model_computes_the_fft_conflict_free(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    out = _run_model(x, m, real=False)
    np.testing.assert_allclose(out, np.fft.fft(x), atol=1e-8 * np.sqrt(m))


@pytest.mark.parametrize("m", ROWS[:-1])
def test_cluster_model_recombines_mirror_pairs_in_registers(m):
    """rfft's second exchange: thread pairs (k2, M - k2) read both groups
    from every CTA and store every bin of the half spectrum once."""
    rng = np.random.default_rng(3 * m)
    r = rng.standard_normal(2 * m)
    out = _run_model(r[0::2] + 1j * r[1::2], m, real=True)
    np.testing.assert_allclose(out, np.fft.rfft(r), atol=1e-8 * np.sqrt(m))


def _ways(addr):
    """Most distinct slots of one half-warp in one bank pair."""
    worst = 1
    for h0 in range(0, len(addr), HALF_WARP):
        a = addr[h0:h0 + HALF_WARP]
        a = np.unique(a[a >= 0])
        worst = max(worst, np.bincount(a % 16).max(initial=1))
    return worst


@pytest.mark.parametrize("m", ROWS)
def test_cluster_twiddle_reads_conflict_at_most_four_way(m):
    """The exchange's twiddles W_m^(a q), per instruction, for the complex
    kinds' lanes and rfft's: the padded ROM entry (a q) / A mod Q/2 and the
    table entry (a q) mod A. Where one lane takes each q (A = 16) the table
    reads are free of bank conflicts and the ROM's at most 2-way (a run of
    16 entries that starts off a group of 16 spans a pad slot), as the
    one-block kernels' ROM reads (tests/test_torch_fft_regpass.py); where
    L = 2 or 4 lanes share a q, on lines a1 + L a2, up to 4-way."""
    g = k.cluster_geometry(m)
    q_, l_ = m // g.lines, g.lines // 16
    rom = _slot(g.values)  # the ROM follows the padded values, the table the ROM
    fine = rom + _slot(q_ // 2)
    for r in range(g.ctas):
        for real in (False, True):
            q, a1 = _lanes(g, r, real)
            for a2 in range(16):
                e = (a1 + l_ * a2) * q
                assert _ways(rom + _slot((e // g.lines) % (q_ // 2))) <= (2 if l_ == 1 else 4)
                assert _ways(fine + e % g.lines) <= (1 if l_ == 1 else 4)
