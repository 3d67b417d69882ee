"""repro_torch.kernels against repro.kernels on the same inputs.

The plain panels and the wrappers on CPU tensors (which run the plain
versions) are held to the Pallas kernels in interpret mode, and the
``ops`` entry points to ``repro.kernels.ops`` in interpret mode, at
max|port - ref| <= 1e-5 * max|ref| (the reference's own kernel tolerance,
tests/kernels/test_fft_kernels.py); the irfft(rfft(x)) round trip to 1e-4.
The CUDA kernels themselves are tested on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro.kernels import ops as jops
from repro.kernels import ref as jkref
from repro_torch.kernels import fft_radix2 as k
from repro_torch.kernels import ops, ref

TOL = 1e-5
ROUND_TRIP_TOL = 1e-4


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * max(np.max(np.abs(ref)), 1e-30), (err, np.max(np.abs(ref)))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ------------- plain panels and wrappers on CPU tensors -------------------


@pytest.mark.parametrize("n", [2, 8, 64, 256])
@pytest.mark.parametrize("radix", [2, 4])
def test_fft_fused_matches_pallas(n, radix):
    batch = 3 if n < 256 else 5  # odd batches
    x = _crandn(np.random.default_rng(n + radix), (batch, n))
    yr, yi = jref.fft_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=radix,
                            interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    pr, pi = k._panel(radix)(torch.from_numpy(x.real.copy()),
                             torch.from_numpy(x.imag.copy()), n)
    _close(pr.numpy() + 1j * pi.numpy(), ref)
    got = k.fft_fused(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), ref)
    inv = k.fft_fused(got, radix=radix, inverse=True)
    assert np.max(np.abs(inv.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))


@pytest.mark.parametrize("n", [2, 8, 64, 256])
@pytest.mark.parametrize("radix", [2, 4])
def test_rfft_irfft_fused_match_pallas(n, radix):
    x = np.random.default_rng(3 * n + radix).standard_normal((5, n)).astype(np.float32)
    yr, yi = jref.rfft_fused(jnp.asarray(x), radix=radix, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    pr, pi = k._rfft_panel(torch.from_numpy(x), n, radix)
    _close(pr.numpy() + 1j * pi.numpy(), ref)
    got = k.rfft_fused(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), ref)
    ref_back = np.asarray(jref.irfft_fused(yr, yi, radix=radix, interpret=True))
    _close(k._irfft_panel(pr, pi, n, radix).numpy(), ref_back)
    back = k.irfft_fused(got, radix=radix)
    _close(back.numpy(), ref_back)
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL


@pytest.mark.parametrize("hw", [(2, 8), (8, 2), (64, 64), (8, 256)])
@pytest.mark.parametrize("radix", [2, 4])
def test_fft2_fused_matches_pallas(hw, radix):
    x = _crandn(np.random.default_rng(hw[0] + hw[1] + radix), (3, *hw))
    got = k.fft2_fused(torch.from_numpy(x), radix=radix)
    yr, yi = jref.fft2_fused(jnp.asarray(x.real), jnp.asarray(x.imag), radix=radix,
                             interpret=True)
    _close(got.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
    inv = k.fft2_fused(got, radix=radix, inverse=True)
    assert np.max(np.abs(inv.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))


@pytest.mark.parametrize("hw", [(2, 2), (2, 8), (8, 2), (16, 32), (64, 64)])
@pytest.mark.parametrize("radix", [2, 4])
def test_rfft2_irfft2_fused_match_pallas(hw, radix):
    rng = np.random.default_rng(hw[0] * hw[1] + radix)
    x = rng.standard_normal((3, *hw)).astype(np.float32)
    yr, yi = jref.rfft2_fused(jnp.asarray(x), radix=radix, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    got = k.rfft2_fused(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), ref)
    back = k.irfft2_fused(got, radix=radix)
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL * np.max(np.abs(x))
    # a half spectrum that is not the rfft2 of a real frame: the imaginary
    # parts the row inverse drops must be dropped the same way
    y = _crandn(rng, (3, hw[0], hw[1] // 2 + 1))
    ref_back = jref.irfft2_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=radix,
                                 interpret=True)
    _close(k.irfft2_fused(torch.from_numpy(y), radix=radix).numpy(), np.asarray(ref_back))


def test_wrappers_check_their_input():
    with pytest.raises(TypeError):
        k.fft_fused(torch.zeros(2, 8))  # real, not complex64
    with pytest.raises(ValueError):
        k.fft_fused(torch.zeros(2, 12, dtype=torch.complex64))
    with pytest.raises(ValueError):
        k.fft_fused(torch.zeros(2, 8, dtype=torch.complex64), radix=8)
    with pytest.raises(ValueError):
        k.fft2_fused(torch.zeros(1, 256, 128, dtype=torch.complex64))  # over one block
    with pytest.raises(ValueError):
        k.irfft_fused(torch.zeros(2, 6, dtype=torch.complex64))  # 2*(6-1) = 10
    with pytest.raises(ValueError):
        k.rfft2_fused(torch.zeros(1, 256, 256))  # over one block
    with pytest.raises(TypeError):
        k.rfft2_fused(torch.zeros(1, 8, 8, dtype=torch.complex64))
    with pytest.raises(ValueError):
        k.irfft2_fused(torch.zeros(1, 8, 6, dtype=torch.complex64))  # 2*(6-1) = 10


def test_plain_path_launches_nothing():
    k.reset_launches()
    k.fft_fused(torch.zeros(3, 8, dtype=torch.complex64))
    k.rfft_fused(torch.zeros(3, 8))
    k.irfft_fused(torch.zeros(3, 5, dtype=torch.complex64))
    k.fft2_fused(torch.zeros(1, 8, 8, dtype=torch.complex64))
    k.irfft2_fused(k.rfft2_fused(torch.zeros(1, 8, 8)))
    assert set(k.LAUNCHES.values()) == {0}


def test_dft_oracles_match_reference_and_hold_the_plain_versions():
    x = _crandn(np.random.default_rng(11), (3, 8, 64))
    t = torch.from_numpy(x)
    rr, ri = jkref.dft_matmul(jnp.asarray(x.real), jnp.asarray(x.imag))
    _close(ref.dft_matmul(t).numpy(), np.asarray(rr) + 1j * np.asarray(ri))
    _close(ref.dft2_matmul(t).numpy(), np.fft.fft2(x.astype(np.complex128)), 1e-12)
    for radix in (2, 4):
        _close(k.fft_fused(t.reshape(24, 64), radix=radix).numpy(),
               ref.dft_matmul(t.reshape(24, 64)).numpy())
        _close(k.fft2_fused(t, radix=radix).numpy(), ref.dft2_matmul(t).numpy())


# ------------------------------- ops ---------------------------------------


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("hw", [(64, 64), (256, 256)])
def test_fft2_kernel_matches_reference_ops(radix, hw):
    """(64, 64) runs fft2_fused; (256, 256) is over one block on Hopper and
    takes the row / turn / column composition."""
    assert ops.fft2_fits_budget(*hw) == (hw == (64, 64))
    x = _crandn(np.random.default_rng(radix), (2, *hw))
    got = ops.fft2_kernel(torch.from_numpy(x), radix=radix)
    _close(got.numpy(), jops.fft2_kernel(jnp.asarray(x), radix=radix, interpret=True))


@pytest.mark.parametrize("radix", [2, 4])
def test_real_ops_match_reference_ops(radix):
    x = np.random.default_rng(radix).standard_normal((2, 3, 16, 32)).astype(np.float32)
    got = ops.rfft2_kernel(torch.from_numpy(x), radix=radix)
    ref = jops.rfft2_kernel(jnp.asarray(x), radix=radix, interpret=True)
    _close(got.numpy(), ref)
    back = ops.irfft2_kernel(got, radix=radix)
    _close(back.numpy(), jops.irfft2_kernel(ref, radix=radix, interpret=True))
    assert np.max(np.abs(back.numpy() - x)) <= ROUND_TRIP_TOL
    row = ops.rfft_kernel(torch.from_numpy(x), radix=radix)
    _close(row.numpy(), jops.rfft_kernel(jnp.asarray(x), radix=radix, interpret=True))
    _close(ops.irfft_kernel(row, radix=radix).numpy(), x)
    z = _crandn(np.random.default_rng(7), (3, 5, 64))
    _close(ops.fft_kernel(torch.from_numpy(z), radix=radix).numpy(),
           jops.fft_kernel(jnp.asarray(z), radix=radix, interpret=True))


@pytest.mark.parametrize("radix", [2, 4])
def test_real_2d_ops_route_on_the_frame_shape(radix):
    """(16, 32) runs rfft2_fused/irfft2_fused; (256, 256) is over one block
    and takes the row / turn / column composition. Both agree with the
    reference ops, which run the whole-frame Pallas kernels at both sizes."""
    assert ops.fft2_fits_budget(16, 32, real=True)
    assert not ops.fft2_fits_budget(256, 256, real=True)
    x = np.random.default_rng(radix).standard_normal((1, 256, 256)).astype(np.float32)
    got = ops.rfft2_kernel(torch.from_numpy(x), radix=radix)
    ref = jops.rfft2_kernel(jnp.asarray(x), radix=radix, interpret=True)
    _close(got.numpy(), ref)
    _close(ops.irfft2_kernel(got, radix=radix).numpy(),
           jops.irfft2_kernel(ref, radix=radix, interpret=True))


def test_ops_take_views_and_conjugates():
    z = _crandn(np.random.default_rng(1), (4, 32, 16))
    t = torch.from_numpy(z)
    got = ops.fft_kernel(t.transpose(-1, -2).conj())
    ref = np.fft.fft(np.conj(z.transpose(0, 2, 1)).astype(np.complex128))
    _close(got.numpy(), ref)


def test_hbm_traffic_model_matches_reference():
    for args in [(8, 1024, True), (8, 1024, False), (4, 256, False)]:
        for radix in (2, 4):
            for real in (False, True):
                assert ops.hbm_traffic_model(*args, radix=radix, real=real) == \
                    jops.hbm_traffic_model(*args, radix=radix, real=real)


# ------------------------------- census ------------------------------------


def test_census_bounds_follow_the_block_limits():
    assert ops.smem_budget_bytes() == 232_448
    assert ops.fft2_fits_budget(128, 128) and ops.fft2_fits_budget(64, 256)
    assert not ops.fft2_fits_budget(256, 128) and not ops.fft2_fits_budget(1024, 1024)
    assert ops.fft2_working_set(128, 128) == (k.smem_slot(128 * 128) + k.smem_slot(64)) * 8
    assert ops.fft2_fits_budget(128, 256, real=True) and ops.fft2_fits_budget(256, 128, real=True)
    assert not ops.fft2_fits_budget(256, 256, real=True)
    assert (ops.fft2_working_set(128, 256, real=True)
            == (k.smem_slot(128 * 128) + k.smem_slot(129)) * 8)
    assert k.fft_fits_smem(16384) and not k.fft_fits_smem(32768)
    assert k.fft_fits_smem(16384, real=True) and not k.fft_fits_smem(32768, real=True)
    assert k.fft_fits_fused(2 ** 18) and not k.fft_fits_fused(2 ** 19)
    assert (k.row_smem_bytes(2 ** 18, real=True) <= k.SMEM_BUDGET_BYTES
            < k.row_smem_bytes(2 ** 19, real=True))
    for n in (2 ** p for p in range(1, 15)):
        for batch in (1, 3, 8192):
            rows = k.pick_row_tile(batch, n)
            assert rows & (rows - 1) == 0 and rows <= max(1, 2 * batch)
            assert rows * n <= max(k.ROW_TILE_ELEMS, n)
            assert k.block_threads(rows * n) <= k.MAX_THREADS
            assert k.fft_smem_bytes(n, rows) <= k.SMEM_BUDGET_BYTES
