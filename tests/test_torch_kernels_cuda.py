"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where CUDA is absent. This file imports
torch and repro_torch only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance max|kernel - plain| <= 2e-5 * max|plain|: CUDA ``sincospif``
against the host's cos/sin, and FMA contraction over up to 14 stages.
"""

import pytest
import torch

from repro_torch import xfft
from repro_torch.kernels import fft_radix2 as k

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2, 4])
def test_cuda_kernels_match_plain_versions(cuda, radix):
    """Each kernel against its plain version, with odd batches so the
    masked edge of the last block is exercised."""
    g = torch.Generator(device=cuda).manual_seed(radix)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=cuda),
                             torch.randn(*shape, generator=g, device=cuda))

    k.reset_launches()
    for n in (2, 8, 64, 2048, 16384):
        x = crandn(7, n)
        assert _rel(k.fft_fused(x, radix=radix), k.fft_fused_plain(x, radix=radix)) <= TOL
        r = torch.randn(7, n, generator=g, device=cuda)
        assert _rel(k.rfft_fused(r, radix=radix), k.rfft_fused_plain(r, radix=radix)) <= TOL
        y = crandn(7, n // 2 + 1)
        assert _rel(k.irfft_fused(y, radix=radix), k.irfft_fused_plain(y, radix=radix)) <= TOL
    for hw in ((2, 2), (8, 64), (128, 128)):
        x = crandn(5, *hw)
        assert _rel(k.fft2_fused(x, radix=radix), k.fft2_fused_plain(x, radix=radix)) <= TOL
    for hw in ((2, 2), (2, 8), (8, 2), (64, 32), (128, 128), (128, 256), (256, 128)):
        r = torch.randn(5, *hw, generator=g, device=cuda)
        assert _rel(k.rfft2_fused(r, radix=radix), k.rfft2_fused_plain(r, radix=radix)) <= TOL
        y = crandn(5, hw[0], hw[1] // 2 + 1)
        assert _rel(k.irfft2_fused(y, radix=radix),
                    k.irfft2_fused_plain(y, radix=radix)) <= TOL
    assert k.LAUNCHES == {"fft_fused": 5, "rfft_fused": 5, "irfft_fused": 5, "fft2_fused": 3,
                          "rfft2_fused": 7, "irfft2_fused": 7}


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_strided_tensor(cuda):
    x = torch.zeros(8, 16, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        k.fft_fused(x.t())


@pytest.mark.cuda
def test_cuda_xfft_plans_onto_the_kernels(cuda):
    """A front-door call on the card launches the kernel its plan names and
    agrees with the plain version of the same plan."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 64, 64, generator=g, device=cuda)
    k.reset_launches()
    with xfft.config(variant="fused_r4"):
        y = xfft.fft2(x)
        half = xfft.rfft2(x)
        back = xfft.irfft2(half)
    assert k.LAUNCHES["fft2_fused"] == 1
    assert k.LAUNCHES["rfft2_fused"] == 1 and k.LAUNCHES["irfft2_fused"] == 1
    assert k.LAUNCHES["fft_fused"] == 0
    with xfft.config(variant="fused_r4"):
        ref = xfft.fft2(x.cpu())
    assert _rel(y.cpu(), ref) <= TOL
    assert float((back - x).abs().max()) <= 1e-4 * float(x.abs().max())
    big = torch.randn(2, 256, 256, generator=g, device=cuda)  # over one block
    k.reset_launches()
    back = xfft.irfft2(xfft.rfft2(big))
    assert k.LAUNCHES["rfft_fused"] == 1 and k.LAUNCHES["irfft_fused"] == 1
    assert k.LAUNCHES["fft_fused"] == 2 and k.LAUNCHES["rfft2_fused"] == 0
    assert float((back - big).abs().max()) <= 1e-4 * float(big.abs().max())


@pytest.mark.cuda
def test_cuda_tensor_never_plans_onto_plain_code(cuda):
    """Tiny transforms plan onto a kernel; rows longer than a block raise
    unless the caller scopes the plain schedules."""
    k.reset_launches()
    xfft.fft(torch.ones(1, 4, dtype=torch.complex64, device=cuda))
    assert k.LAUNCHES["fft_fused"] == 1
    long = torch.ones(2, 32768, dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError):
        xfft.fft(long)
    with xfft.config(backend="torch"):
        assert float(xfft.fft(long)[:, 0].real.min()) == 32768.0
