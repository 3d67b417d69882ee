"""Separable 2D FFT and the paper's ping-pong streaming processor.

Port of ``repro.core.fft2d``. The ``fused`` variants run the whole frame
in one CUDA block when it fits, else the row / column composition on the
kernels (``repro_torch.kernels.ops.fft2_kernel``).

The paper's 2D processor (fig. 3) runs two 1D FFT engines at once: engine
1 performs the row FFTs of frame k into RAM1 while engine 2 reads frame
k-1's rows from RAM2 and produces its column FFTs; a RAM controller flips
``sel`` when both RAMs fill. :func:`fft2_stream` is that pipeline. On a
CUDA tensor under ``fused``/``fused_r4`` the two engines are two CUDA
streams: the row stream runs ``fft_fused`` on step k's frames straight
into their output slots, and the column stream, once an event says step
k-1's rows are written, runs ``fft2_columns`` in place on those slots. RAM1
and RAM2 are output slots k and k-1, and ``sel`` is the event: a frame
crosses HBM twice and nothing is allocated beyond the output.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core._deprecation import forward
from repro_torch.core.fft1d import BUILTIN_VARIANTS, _check_pow2, _check_variant, fft_impl, ifft_impl
from repro_torch.kernels.ops import _launchable, fft2_kernel, stream_columns, stream_rows

__all__ = [
    "fft2",
    "fft2_impl",
    "fft2_stream",
    "fftshift2",
    "ifft2",
    "ifft2_impl",
    "ifftshift2",
]


def _radix(variant: str) -> int:
    return 4 if variant == "fused_r4" else 2


def fft2_impl(x: torch.Tensor, variant: str = "stockham",
              dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """2D FFT over the last two axes under ``variant``; ``dtype``
    (complex64, or complex128 on a plain schedule)."""
    _check_variant(variant, dtype)
    if variant in ("fused", "fused_r4"):
        return fft2_kernel(x, radix=_radix(variant))
    y = fft_impl(x, axis=-1, variant=variant, dtype=dtype)   # rows
    return fft_impl(y, axis=-2, variant=variant, dtype=dtype)  # columns


def ifft2_impl(x: torch.Tensor, variant: str = "stockham",
               dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Inverse 2D FFT. The fused kernels conjugate on the way in and out
    and scale by 1/(H W) inside, the identity the reference applies around
    its kernel; the schedules invert each pass."""
    _check_variant(variant, dtype)
    if variant in ("fused", "fused_r4"):
        return fft2_kernel(x, radix=_radix(variant), inverse=True)
    y = ifft_impl(x, axis=-1, variant=variant, dtype=dtype)
    return ifft_impl(y, axis=-2, variant=variant, dtype=dtype)


def fft2(x, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.fft2` (kept for old call sites)."""
    return forward("repro_torch.core.fft2d.fft2", "fft2", x, variant)


def ifft2(x, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.ifft2` (kept for old call sites)."""
    return forward("repro_torch.core.fft2d.ifft2", "ifft2", x, variant)


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """Centre the zero-frequency bin of the trailing two axes."""
    return torch.roll(x, shifts=(x.shape[-2] // 2, x.shape[-1] // 2), dims=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`fftshift2` (rolls by the negated half sizes,
    which matters for odd lengths)."""
    return torch.roll(
        x, shifts=(-(x.shape[-2] // 2), -(x.shape[-1] // 2)), dims=(-2, -1)
    )


# ------------------------- the streaming processor -------------------------

#: Each thread's engines on each card: (row stream, column stream, the
#: event that hands a step's rows to the column stream), made at first use.
_ENGINES = threading.local()


def _engines(device: torch.device):
    """The two CUDA streams of the fused pipeline on ``device`` and its
    hand-over event, created once per device (and thread)."""
    table = getattr(_ENGINES, "table", None)
    if table is None:
        table = _ENGINES.table = {}
    index = device.index if device.index is not None else torch.cuda.current_device()
    engines = table.get(index)
    if engines is None:
        engines = table[index] = (torch.cuda.Stream(device=index),
                                  torch.cuda.Stream(device=index), torch.cuda.Event())
    return engines


def _pipeline(steps: int, row_pass, column_pass, engines=None, caller=None) -> None:
    """The ping-pong schedule over ``steps`` steps and one drain step: at
    step k engine 1 runs ``row_pass(k)`` while engine 2 runs
    ``column_pass(k - 1)`` on what engine 1 wrote at step k - 1.

    ``engines`` (a row stream, a column stream and an event) puts the two
    engines on their own CUDA streams: the column stream waits on the
    event recorded after the previous step's rows, and nothing on the host
    waits for the card. Each pass runs with its engine's stream current
    (``torch.cuda.set_stream``: the launches and any tensor work of the
    pass go there), and ``caller`` is current again on return. ``None``
    runs the same steps in order on the current stream."""
    if engines is None:
        for k in range(steps + 1):
            if k:
                column_pass(k - 1)
            if k < steps:
                row_pass(k)
        return
    rows, cols, handover = engines
    try:
        for k in range(steps + 1):
            if k:
                cols.wait_event(handover)
                torch.cuda.set_stream(cols)
                column_pass(k - 1)
            if k < steps:
                torch.cuda.set_stream(rows)
                row_pass(k)
                handover.record(rows)
    finally:
        torch.cuda.set_stream(caller)


def _frames_input(frames) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames
    from repro_torch.xfft._transforms import _as_tensor  # lazy: xfft builds on core

    return _as_tensor(frames)


def fft2_stream(
    frames,
    variant: str = "auto",
    unroll: Union[int, str] = "auto",
    dtype: torch.dtype = torch.complex64,
) -> torch.Tensor:
    """Streaming 2D FFT over ``frames[t, H, W]`` (or ``(T, ..., H, W)``)
    with ping-pong double buffering: output t is the 2D FFT of frame t.

    Frame t's row pass and frame t-1's column pass belong to the same step
    (the two engines). The reference feeds a zero frame through to drain
    the pipe and drops the first output; here the drain step runs the last
    column pass alone, which gives the same outputs.

    ``variant="auto"`` / ``unroll="auto"`` resolve through
    ``repro_torch.plan.api.resolve`` with the stream's own problem key (the
    unroll is part of the plan). A variant outside the builtin schedules
    runs the registered engine's stream op
    (:func:`repro_torch.engines.apply_engine`); under
    ``xfft.config(precision="double")`` the planner picks
    ``reference_x64``, the same pipeline at complex128. Real input is cast
    to ``dtype`` (complex64; complex128 on a plain schedule).

    ``unroll`` is the number of frames one step carries: the row pass of
    step k covers frames [k u, (k + 1) u) and the column pass the u frames
    before them. The output is the same at any unroll, as the reference's
    scan unroll leaves it; what it changes is what the unroll changes on
    XLA, fewer and larger steps: on the card, 2 ceil(T / u) launches.

    Plain schedules (``looped``, ``unrolled``, ``stockham``, ``radix4``)
    run the steps in order on any device. ``fused``/``fused_r4`` on a CUDA
    tensor run the row engine (``fft_fused``) and the column engine
    (``fft2_columns``) on two CUDA streams created once per device, both
    forked from the caller's current stream and joined back into it before
    the call returns, so the call can be captured in a CUDA graph; on a CPU
    tensor they run the same steps on the kernels' plain versions. On a
    CUDA tensor the fused stream launches its kernels on the two streams
    or raises.
    """
    ndim = frames.dim() if isinstance(frames, torch.Tensor) else np.ndim(frames)
    if ndim < 3:
        raise ValueError("fft2_stream expects (T, H, W) or (T, ..., H, W)")
    frames = _frames_input(frames)
    if variant == "auto" or unroll == "auto":
        from repro_torch.plan.api import resolve  # lazy: plan imports core

        plan = resolve("fft2d_stream", tuple(frames.shape), frames.device)
        if variant == "auto":
            variant = plan.variant
        if unroll == "auto":
            unroll = plan.unroll
    if variant not in BUILTIN_VARIANTS:
        # A registered engine (e.g. reference_x64) runs its own stream op.
        from repro_torch.engines import apply_engine  # lazy: engines build on core

        return apply_engine(variant, "fft2d_stream", frames)
    _check_variant(variant, dtype)
    unroll = int(unroll)
    if unroll < 1:
        raise ValueError(f"fft2_stream: unroll must be >= 1, got {unroll}")
    h, w = frames.shape[-2], frames.shape[-1]
    _check_pow2(h, axis=frames.dim() - 2)
    _check_pow2(w, axis=frames.dim() - 1)
    steps = -(-frames.shape[0] // unroll)

    def step(k: int) -> slice:
        return slice(k * unroll, (k + 1) * unroll)

    if variant in ("fused", "fused_r4"):
        # Input and output live on the caller's stream and outlive the
        # join, so the side streams allocate nothing of theirs.
        z = _launchable(frames, torch.complex64)
        out = torch.empty_like(z)
        radix = _radix(variant)

        def rows(k):
            stream_rows(z[step(k)].reshape(-1, h, w), out[step(k)].reshape(-1, h, w),
                        radix=radix)

        def columns(k):
            stream_columns(out[step(k)].reshape(-1, h, w), radix=radix)

        if not z.is_cuda:
            _pipeline(steps, rows, columns)
            return out
        engines = _engines(z.device)
        caller = torch.cuda.current_stream(z.device)
        engines[0].wait_stream(caller)
        engines[1].wait_stream(caller)
        _pipeline(steps, rows, columns, engines, caller)
        caller.wait_stream(engines[0])
        caller.wait_stream(engines[1])
        return out

    out = torch.empty(frames.shape, dtype=dtype, device=frames.device)

    def plain_rows(k):
        out[step(k)] = fft_impl(frames[step(k)], axis=-1, variant=variant, dtype=dtype)

    def plain_columns(k):
        out[step(k)] = fft_impl(out[step(k)], axis=-2, variant=variant, dtype=dtype)

    _pipeline(steps, plain_rows, plain_columns)
    return out
