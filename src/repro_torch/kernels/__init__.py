"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``), their
plain torch versions, and their entry points: the FFT family, the
stage-at-a-time FFT, flash attention and the sLSTM scan; and
``fft2_columns``, the column pass of the composed 2D route."""

from repro_torch.kernels.butterfly import butterfly_stage
from repro_torch.kernels.fft_radix2 import fft2_columns, fft2_columns_plain
from repro_torch.kernels.flash_attention import flash_attention_fwd, mha_reference
from repro_torch.kernels.ops import (
    fft2_kernel,
    fft_kernel,
    fft_staged,
    hbm_traffic_model,
    irfft2_kernel,
    irfft_kernel,
    rfft2_kernel,
    rfft_kernel,
)
from repro_torch.kernels.slstm_scan import slstm_scan

__all__ = [
    "butterfly_stage",
    "fft2_columns",
    "fft2_columns_plain",
    "fft2_kernel",
    "fft_kernel",
    "fft_staged",
    "flash_attention_fwd",
    "hbm_traffic_model",
    "irfft2_kernel",
    "irfft_kernel",
    "mha_reference",
    "rfft2_kernel",
    "rfft_kernel",
    "slstm_scan",
]
