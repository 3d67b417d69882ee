"""repro_torch's butterfly stage and stage-at-a-time FFT against repro's.

The same seeded numpy inputs go through the Pallas ``butterfly_stage`` and
``ops.fft_staged`` in interpret mode and through the port on CPU tensors
(which run the plain versions), held to max|port - ref| <= 1e-5 * max|ref|,
the reference's own kernel tolerance (tests/kernels/test_fft_kernels.py).
The CUDA kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import butterfly as jbf
from repro.kernels import ops as jops
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import fft_staged
from repro_torch.kernels._launch import LAUNCHES, reset_launches

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * max(np.max(np.abs(ref)), 1e-30), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("stage", [0, 1, 3, 5])
def test_butterfly_stage_matches_pallas(stage):
    rng = np.random.default_rng(stage)
    re = rng.standard_normal((3, 64)).astype(np.float32)
    im = rng.standard_normal((3, 64)).astype(np.float32)
    rr, ri = jbf.butterfly_stage(jnp.asarray(re), jnp.asarray(im), stage=stage, interpret=True)
    pr, pi = bf.butterfly_stage_plain(torch.from_numpy(re), torch.from_numpy(im), stage=stage)
    _close(pr.numpy(), np.asarray(rr))
    _close(pi.numpy(), np.asarray(ri))
    gr, gi = bf.butterfly_stage(torch.from_numpy(re), torch.from_numpy(im), stage=stage)
    _close(gr.numpy(), np.asarray(rr))
    _close(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("n", [2, 8, 64, 256])
@pytest.mark.parametrize("complex_input", [False, True])
def test_fft_staged_matches_reference_and_numpy(n, complex_input):
    rng = np.random.default_rng(n + complex_input)
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    if complex_input:
        x = (x + 1j * rng.standard_normal((2, 3, n))).astype(np.complex64)
    got = fft_staged(torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.complex64
    _close(got.numpy(), np.asarray(jops.fft_staged(jnp.asarray(x), interpret=True)))
    _close(got.numpy(), np.fft.fft(x.astype(np.complex128)))


def test_butterfly_stage_checks_its_input():
    z = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        bf.butterfly_stage(z.double(), z.double(), stage=0)
    with pytest.raises(ValueError):
        bf.butterfly_stage(z, z, stage=3)  # log2(8) = 3 stages: 0, 1, 2
    with pytest.raises(ValueError):
        bf.butterfly_stage(torch.zeros(2, 12), torch.zeros(2, 12), stage=0)
    with pytest.raises(ValueError):
        bf.butterfly_stage(z, torch.zeros(2, 16), stage=0)


def test_plain_path_launches_nothing():
    reset_launches()
    fft_staged(torch.ones(4, 16, dtype=torch.complex64))
    assert set(LAUNCHES.values()) == {0}


def test_stage_grid_covers_every_butterfly_or_strides():
    assert bf.stage_grid(1, 2) == 1
    assert bf.stage_grid(2, 256) == 1
    assert bf.stage_grid(4, 256) == 2
    assert bf.stage_grid(8192, 2048) == bf.MAX_BLOCKS
