"""One radix-2 DIT stage on the card: the paper's N/2 butterfly units,
stage at a time.

Port of ``repro.kernels.butterfly``. One launch runs exactly one FFT stage
(one pass through the N/2 butterfly units) over bit-reversed (B, N) rows.
At stage s (half-span h = 2^s) the row viewed as (N/2h, 2, h) puts every
butterfly's two inputs h apart, so the routing network is index
arithmetic: top' = A + W B, bot' = A - W B with W = exp(-i pi p / h).

Running all log2 N stages through it (``ops.fft_staged``) is the column
architecture the paper compares against: the data makes log2 N round trips
through HBM, where ``fft_fused`` makes one.

The TPU kernel's tile picker (``pick_block_tile``) has no counterpart: the
CUDA kernel (``csrc/butterfly.cu``) runs one thread per butterfly over a
grid-stride loop, and the wrapper sizes the grid. :func:`stage_cost` is
one stage's work; a meta tensor takes the card route, launches nothing and
charges it to an active cost counter (``kernels._launch``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels._launch import Cost, charge, launch, refuse_grad

__all__ = ["THREADS", "butterfly_stage", "butterfly_stage_plain", "stage_cost", "stage_grid"]

#: Threads per block of the CUDA kernel.
THREADS = 256

#: Most blocks of one launch: 16 resident blocks on each of 132 SMs; the
#: grid-stride loop covers the rest.
MAX_BLOCKS = 132 * 16


def stage_grid(batch: int, n: int) -> int:
    """Blocks of one launch on B rows of N: one thread per butterfly, at
    most :data:`MAX_BLOCKS`."""
    return max(1, min(MAX_BLOCKS, -(-(batch * n // 2) // THREADS)))


def stage_cost(batch: int, n: int) -> Cost:
    """The flops and bytes of one stage on B rows of N: a butterfly's complex
    multiply and two adds, 10 flops for every two values; both float32
    planes read and written once."""
    return Cost(5.0 * batch * n, float(16 * batch * n))


def _check(re: torch.Tensor, im: torch.Tensor, stage: int) -> None:
    for name, x in (("re", re), ("im", im)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"butterfly_stage: {name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"butterfly_stage takes float32 planes, got {name} {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"butterfly_stage takes (B, N) planes, got {tuple(x.shape)}")
        if x.device.type not in ("cpu", "cuda", "meta"):
            raise ValueError(f"butterfly_stage runs on cpu, cuda or meta tensors, got {x.device}")
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("butterfly_stage: re and im differ in shape or device")
    n = re.shape[1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"butterfly_stage: length must be a power of two >= 2, got {n}")
    if not 0 <= stage < int(math.log2(n)):
        raise ValueError(f"butterfly_stage: stage {stage} out of range for length {n}")


def butterfly_stage_plain(
    re: torch.Tensor, im: torch.Tensor, *, stage: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`butterfly_stage` on the (B, N/2h, 2, h) view,
    the twiddles from cos/sin of a float32 angle as the TPU kernel does."""
    b, n = re.shape
    h = 1 << stage
    re4 = re.reshape(b, n // (2 * h), 2, h)
    im4 = im.reshape(b, n // (2 * h), 2, h)
    p = torch.arange(h, dtype=torch.float32, device=re.device)
    ang = (-math.pi / h) * p
    wr, wi = torch.cos(ang), torch.sin(ang)
    ar, br = re4[..., 0, :], re4[..., 1, :]
    ai, bi = im4[..., 0, :], im4[..., 1, :]
    tr = br * wr - bi * wi
    ti = br * wi + bi * wr
    out_re = torch.stack([ar + tr, ar - tr], dim=-2).reshape(b, n)
    out_im = torch.stack([ai + ti, ai - ti], dim=-2).reshape(b, n)
    return out_re, out_im


def butterfly_stage(
    re: torch.Tensor, im: torch.Tensor, *, stage: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply DIT stage ``stage`` to (B, N) float32 re/im planes.

    The input must already be bit-reversed (before stage 0): this is the
    engine the control unit re-invokes with SB = stage. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel or raises.
    """
    _check(re, im, stage)
    if re.device.type == "cpu":
        return butterfly_stage_plain(re, im, stage=stage)
    refuse_grad("butterfly_stage", re, im)
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("butterfly_stage needs contiguous planes")
    b, n = re.shape
    out_re = torch.empty_like(re)
    out_im = torch.empty_like(im)
    if b:
        charge("butterfly_stage", stage_cost, b, n)
        launch("repro_butterfly_stage", "butterfly_stage", re, re.data_ptr(), im.data_ptr(),
               out_re.data_ptr(), out_im.data_ptr(), b, n, stage, stage_grid(b, n), THREADS)
    return out_re, out_im
