"""Rows over one block: the two-pass route of fft_fused, rfft_fused and
irfft_fused (2^14 < N <= 2^18), against the reference on the same inputs.

On a CPU tensor the wrappers run the two-pass plain versions, which are
held to the Pallas kernels in interpret mode at N = 2^15 and 2^16 to
max|port - ref| <= 1e-5 * max|ref| (the reference's own kernel tolerance),
and to numpy in float64 at N = 2^18, where one Pallas interpret call would
take most of a minute; round trips to 1e-4. The fused engines' envelope
must be the reference's on a CPU key; a CUDA key's reaches 2^24
(tests/test_torch_long_rows.py holds the rows past 2^18). The CUDA kernels
are held to these plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch import xfft
from repro_torch.kernels import fft_radix2 as k
from repro_torch.plan.autotune import variant_candidates
from repro_torch.plan.plan import ProblemKey

TOL = 1e-5
ROUND_TRIP_TOL = 1e-4
H100 = "NVIDIA H100 80GB HBM3"


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _pallas_fft(x, radix):
    yr, yi = jref.fft_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=radix,
                            interpret=True)
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("n,batch", [(2 ** 15, 3), (2 ** 16, 2)])
@pytest.mark.parametrize("radix", [2, 4])
def test_fft_fused_two_pass_matches_pallas(n, batch, radix):
    """Forward, and inverse as the reference computes it: conj(fft(conj x)) / N."""
    x = _crandn(np.random.default_rng(n + batch + radix), (batch, n))
    ref = _pallas_fft(x, radix)
    got = k.fft_fused(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), ref)
    _close(k.fft_two_pass_plain(torch.from_numpy(x), radix=radix).numpy(), ref)
    spec = ref.astype(np.complex64)
    ref_inv = np.conj(_pallas_fft(np.conj(spec), radix)) / n
    _close(k.fft_fused(torch.from_numpy(spec), radix=radix, inverse=True).numpy(), ref_inv)
    back = k.fft_fused(got, radix=radix, inverse=True)
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))


@pytest.mark.parametrize("n,batch", [(2 ** 15, 2), (2 ** 16, 3)])
@pytest.mark.parametrize("radix", [2, 4])
def test_rfft_irfft_fused_two_pass_match_pallas(n, batch, radix):
    rng = np.random.default_rng(3 * n + batch + radix)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    yr, yi = jref.rfft_fused(jnp.asarray(x), radix=radix, interpret=True)
    got = k.rfft_fused(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
    back = k.irfft_fused(got, radix=radix)
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))
    # a half spectrum that is not the rfft of a real row: DC's and
    # Nyquist's imaginary parts must be dropped as the reference drops them
    y = _crandn(rng, (batch, n // 2 + 1))
    ref_back = jref.irfft_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=radix,
                                interpret=True)
    _close(k.irfft_fused(torch.from_numpy(y), radix=radix).numpy(), np.asarray(ref_back))


@pytest.mark.parametrize("radix", [2, 4])
def test_two_pass_at_the_longest_row_matches_numpy(radix):
    n = 2 ** 18
    rng = np.random.default_rng(18 + radix)
    x = _crandn(rng, (1, n))
    got = k.fft_fused(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), np.fft.fft(x.astype(np.complex128)))
    inv = k.fft_fused(got, radix=radix, inverse=True)
    _close(inv.numpy(), np.fft.ifft(got.numpy().astype(np.complex128)))
    assert np.max(np.abs(inv.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))
    r = x.real.copy()
    half = k.rfft_fused(torch.from_numpy(r), radix=radix)
    _close(half.numpy(), np.fft.rfft(r.astype(np.float64)))
    back = k.irfft_fused(half, radix=radix)
    _close(back.numpy(), np.fft.irfft(half.numpy().astype(np.complex128)))
    assert np.max(np.abs(back.numpy() - r)) <= ROUND_TRIP_TOL * np.max(np.abs(r))


@pytest.mark.parametrize("variant", ["fused", "fused_r4"])
def test_xfft_rfft2_on_strip_frames_matches_numpy(variant):
    """A (1, 8, 32768) frame: rows on the two passes, a corner turn, columns
    on the one-block kernel; the launch counts stay 0 on the CPU."""
    x = np.random.default_rng(7).standard_normal((1, 8, 32768)).astype(np.float32)
    k.reset_launches()
    with xfft.config(variant=variant):
        half = xfft.rfft2(torch.from_numpy(x))
        back = xfft.irfft2(half)
    _close(half.numpy(), np.fft.rfft2(x.astype(np.float64)))
    _close(back.numpy(), np.fft.irfft2(half.numpy().astype(np.complex128)))
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))
    assert not any(k.LAUNCHES.values())


@pytest.mark.parametrize("real", [False, True])
def test_fused_envelope_is_the_references(real):
    """The wrappers serve a row, and its largest block fits the budget the
    engines' gate holds it to, exactly where the reference's fused kernels
    take it."""
    for p in range(1, 21):
        n = 2 ** p
        assert k.fft_fits_fused(n) == jref.fft_fits_vmem(n), p
        fits = k.row_smem_bytes(n, real=real) <= k.SMEM_BUDGET_BYTES
        assert fits == jref.fft_fits_vmem(n), p


@pytest.mark.parametrize("kind,shape", [("fft1d", (4, None)), ("rfft1d", (4, None)),
                                        ("fft2d", (2, None)), ("fft2d", (None, 2)),
                                        ("rfft2d", (1, 8, None)), ("rfft2d", (None, 4))])
def test_card_keys_plan_onto_the_kernels_up_to_2_24(kind, shape):
    def key(n):
        return ProblemKey(kind=kind, backend="cuda", device_kind=H100,
                          shape=tuple(n if d is None else d for d in shape), dtype="complex64")

    for n in (2 ** 15, 2 ** 18, 2 ** 19, 2 ** 24):
        assert set(variant_candidates(key(n))) == {"fused", "fused_r4"}, n
    with pytest.raises(NotImplementedError, match="2\\^24"):
        variant_candidates(key(2 ** 25))


def test_two_pass_geometry_fits_a_block():
    """Both passes of every row the two passes serve hold at least 16 lines
    and fit one block; the split is exact. The census is the register
    passes': the column pass's panel and ROM padded, the row pass's tile
    rows ``two_pass_row_stride`` slots apart and its ROM padded. The card's
    envelope reaches 2^24; the default one stays the reference's."""
    for p in range(14, 25):
        n = 2 ** p
        g = k.two_pass_geometry(n)
        assert (g.n1, g.n2) == k.fft_split(n) and g.n1 * g.n2 == n and g.n2 <= g.n1 <= 2 * g.n2
        assert k.COLUMN_PANEL_MIN_COLS <= g.cols <= g.n2
        assert k.COLUMN_PANEL_MIN_COLS <= g.rows <= g.n1
        assert g.col_threads * k.ELEMS_PER_THREAD == g.cols * g.n1 <= 16 * k.MAX_THREADS
        assert g.row_threads * k.ELEMS_PER_THREAD == g.rows * g.n2 <= 16 * k.MAX_THREADS
        assert g.col_smem == (k.smem_slot(g.cols * g.n1) + k.smem_slot(g.n1 // 2)) * 8
        assert g.row_smem == (g.rows * k.two_pass_row_stride(g.n2, g.rows)
                              + k.smem_slot(g.n2 // 2)) * 8
        assert max(g.col_smem, g.row_smem) <= k.SMEM_BUDGET_BYTES
    assert k.fft_split(2 ** 18) == (512, 512)
    assert k.row_smem_bytes(2 ** 14) == k.fft_smem_bytes(2 ** 14)  # one block
    assert k.row_smem_bytes(2 ** 18) == k.two_pass_geometry(2 ** 18).row_smem
    assert k.row_smem_bytes(2 ** 15, real=True) == k.two_pass_geometry(2 ** 14).row_smem
    assert k.row_smem_bytes(2 ** 19) > k.SMEM_BUDGET_BYTES
    assert k.row_smem_bytes(2 ** 24, fits=k.fft_fits_card) == k.two_pass_geometry(2 ** 24).row_smem
    assert k.row_smem_bytes(2 ** 25, fits=k.fft_fits_card) > k.SMEM_BUDGET_BYTES


def test_rows_past_2_24_raise_with_the_references_wording():
    with pytest.raises(ValueError, match="exceed the fused-kernel budget.*unfused variant"):
        k.fft_fused(torch.zeros(1, 2 ** 25, dtype=torch.complex64, device="meta"))
    with pytest.raises(ValueError, match="exceed the fused-kernel budget"):
        k.rfft_fused(torch.zeros(1, 2 ** 25, device="meta"))
    with pytest.raises(ValueError, match="exceed the fused-kernel budget"):
        k.irfft_fused(torch.zeros(1, 2 ** 24 + 1, dtype=torch.complex64, device="meta"))
