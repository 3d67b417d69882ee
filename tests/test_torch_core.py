"""repro_torch.core against repro.core on the same inputs.

Each schedule is held to the reference engine entry under the same
explicit variant (never "auto"), at max|port - ref| <= 1e-5 * max|ref|;
round trips to 1e-4. The numpy tables are compared exactly.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import fft1d, fft2d

# repro.core and repro_torch.core re-export functions named like their
# modules (``rfft``); take the modules.
rfft = importlib.import_module("repro_torch.core.rfft")
jfft1d = importlib.import_module("repro.core.fft1d")
jfft2d = importlib.import_module("repro.core.fft2d")
jrfft = importlib.import_module("repro.core.rfft")

TOL = 1e-5
SCHEDULES = ["looped", "unrolled", "stockham", "radix4"]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


def _ref(fn, x, **kw):
    """The reference entry, jitted: one compile instead of op-by-op dispatch."""
    return jax.jit(functools.partial(fn, **kw))(jnp.asarray(x))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_numpy_tables_equal_reference(n):
    assert np.array_equal(fft1d.bit_reversal_permutation(n), jfft1d.bit_reversal_permutation(n))
    for a, b in zip(fft1d.fft_routing_tables(n), jfft1d.fft_routing_tables(n)):
        assert np.array_equal(a, b)
    for proposed in (True, False):
        assert fft1d.butterfly_counts(n, proposed) == jfft1d.butterfly_counts(n, proposed)


@pytest.mark.parametrize("variant", SCHEDULES)
@pytest.mark.parametrize("n", [2, 8, 64, 256])
def test_schedule_matches_reference(variant, n):
    x = _crandn(np.random.default_rng(n), (3, n))
    got = fft1d.fft_impl(torch.from_numpy(x), variant=variant)
    _close(got.numpy(), _ref(jfft1d.fft_impl, x, variant=variant))
    back = fft1d.ifft_impl(got, variant=variant)
    _close(back.numpy(), _ref(jfft1d.ifft_impl, got.numpy(), variant=variant))


@pytest.mark.parametrize("variant", SCHEDULES + ["fused", "fused_r4"])
def test_fft_impl_on_a_middle_axis(variant):
    x = _crandn(np.random.default_rng(5), (2, 16, 3))
    got = fft1d.fft_impl(torch.from_numpy(x), axis=1, variant=variant)
    _close(got.numpy(), _ref(jfft1d.fft_impl, x, axis=1, variant="stockham"))
    back = fft1d.ifft_impl(got, axis=1, variant=variant)
    _close(back.numpy(), x, 1e-4)


@pytest.mark.parametrize("variant", SCHEDULES + ["fused", "fused_r4"])
@pytest.mark.parametrize("n", [2, 8, 64])
def test_real_schedules_match_reference(variant, n):
    x = np.random.default_rng(n + 1).standard_normal((3, n)).astype(np.float32)
    got = rfft.rfft_impl(torch.from_numpy(x), variant=variant)
    ref = _ref(jrfft.rfft_impl, x, variant=variant)
    _close(got.numpy(), ref)
    back = rfft.irfft_impl(got, variant=variant)
    _close(back.numpy(), _ref(jrfft.irfft_impl, ref, variant=variant))
    assert np.max(np.abs(back.numpy() - x)) <= 1e-4


@pytest.mark.parametrize("variant", SCHEDULES + ["fused", "fused_r4"])
def test_2d_impls_match_reference(variant):
    rng = np.random.default_rng(9)
    x = _crandn(rng, (2, 8, 16))
    got = fft2d.fft2_impl(torch.from_numpy(x), variant=variant)
    _close(got.numpy(), _ref(jfft2d.fft2_impl, x, variant=variant))
    _close(fft2d.ifft2_impl(got, variant=variant).numpy(),
           _ref(jfft2d.ifft2_impl, got.numpy(), variant=variant))
    r = rng.standard_normal((2, 8, 16)).astype(np.float32)
    half = rfft.rfft2_impl(torch.from_numpy(r), variant=variant)
    ref = _ref(jrfft.rfft2_impl, r, variant=variant)
    _close(half.numpy(), ref)
    _close(rfft.irfft2_impl(half, variant=variant).numpy(),
           _ref(jrfft.irfft2_impl, ref, variant=variant))


def test_shifts_match_reference():
    x = np.arange(5 * 6, dtype=np.float32).reshape(5, 6)
    t = torch.from_numpy(x)
    assert np.array_equal(fft2d.fftshift2(t).numpy(), np.asarray(jfft2d.fftshift2(jnp.asarray(x))))
    assert np.array_equal(fft2d.ifftshift2(fft2d.fftshift2(t)).numpy(), x)


def test_bad_input_is_refused():
    with pytest.raises(ValueError, match="axis 0 has length 6"):
        fft1d.fft_impl(torch.zeros(6, dtype=torch.complex64), axis=0)
    with pytest.raises(ValueError):
        fft1d.fft_impl(torch.zeros(8, dtype=torch.complex64), variant="auto")
    with pytest.raises(TypeError):
        rfft.rfft_impl(torch.zeros(8, dtype=torch.complex64))
    with pytest.raises(ValueError):
        rfft.irfft_impl(torch.zeros(6, dtype=torch.complex64))
