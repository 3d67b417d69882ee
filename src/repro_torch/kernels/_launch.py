"""Launch counts and the one ctypes launch path shared by every wrapper.

Each wrapper calls :func:`launch` where it launches its kernel, and
nowhere else, so ``LAUNCHES`` counts kernel launches only: a run can show
that its path went through the kernels and not through plain code.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["LAUNCHES", "launch", "reset_launches"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {
    "fft_fused": 0, "rfft_fused": 0, "irfft_fused": 0, "fft2_fused": 0,
    "rfft2_fused": 0, "irfft2_fused": 0, "butterfly_stage": 0,
    "flash_attention_fwd": 0, "slstm_scan": 0, "fft_two_pass": 0, "fft_cluster": 0,
    "fft2_columns": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(entry: str, name: str, x: torch.Tensor, *args) -> None:
    """Call the C entry ``entry`` with ``args``, then ``x``'s device and
    current stream; raise on any CUDA error the launch reports, else count
    one launch of ``name``."""
    from repro_torch.kernels._build import library  # lazy: builds at first use

    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(library(), entry)(*args, x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
