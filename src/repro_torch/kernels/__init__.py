"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), their
plain torch versions, and the complex-in/complex-out entry points."""

from repro_torch.kernels.ops import (
    fft2_kernel,
    fft_kernel,
    hbm_traffic_model,
    irfft2_kernel,
    irfft_kernel,
    rfft2_kernel,
    rfft_kernel,
)

__all__ = [
    "fft2_kernel",
    "fft_kernel",
    "hbm_traffic_model",
    "irfft2_kernel",
    "irfft_kernel",
    "rfft2_kernel",
    "rfft_kernel",
]
