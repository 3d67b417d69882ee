"""Complex-in/complex-out entry points for the fused FFT kernels.

Port of ``repro.kernels.ops``. Any leading batch dims are flattened into the
kernels' row or frame batch.

  fft_kernel(x)    — fused 1D FFT along the last axis (``fft_fused``)
  fft2_kernel(x)   — 2D FFT of (..., H, W): ``fft2_fused`` when the frame
                     fits one block, else ``fft_fused`` rows, then
                     ``fft2_columns`` in place on their output
  rfft_kernel(x)   — real-input 1D FFT, two-for-one (``rfft_fused``)
  irfft_kernel(y)  — its inverse (``irfft_fused``)
  rfft2_kernel(x)  — ``rfft2_fused`` when the real frame fits one block,
                     else ``rfft_fused`` rows, then ``fft2_columns`` in
                     place on the F·H·(W/2+1) half spectra
  irfft2_kernel(y) — ``irfft2_fused`` when it fits, else ``fft2_columns``
                     inverse into a new buffer, then ``irfft_fused`` rows
  fft_staged(x)    — stage at a time: a bit-reversal gather, then log2 N
                     launches of ``butterfly_stage``, log2 N HBM round trips
  stream_rows(z, out)  — engine 1 of the paper's ping-pong processor (fig.
                     3): the row FFTs of frames into their output slots
                     (``fft_fused`` with ``out=``)
  stream_columns(y)    — engine 2: the column FFTs of those slots in place
                     (``fft2_columns``, or the turn route for H > 4096)

The multi-device pencil (``repro_torch.core.distributed``) runs the same
two engines on each rank: ``stream_rows`` on the rank's (..., H/d, W) rows,
``stream_columns`` on its turned (..., H, W/d) columns.

The whole-frame-or-composition choice of the 2D entries is made on the
frame shape (:func:`fft2_fits_budget`) and on the ``kernel.fused`` fault
seam (``repro_torch.resilience.faults.vmem_exhausted``), as in the
reference: an injected ``vmem`` fault stands for a frame over the census.
The composed route emits a ``kernel.failover`` event with the reference's
fields, ``budget`` being the block's shared-memory budget. It is a
planned route, visible as an event, not a fallback under a kernel: both
routes are hand-written kernels, and every pass runs a kernel; none falls
back to plain code. The composed route is two HBM round trips: the row
pass, and ``fft2_columns``, which reads panels of neighbouring columns
straight from the row pass's layout, so the corner turn is addressing.
Columns longer than that kernel's panel (H > 4096,
:func:`~repro_torch.kernels.fft_radix2.fft2_columns_serves`) take the
planned turn route instead: a corner turn through HBM, ``fft_fused`` on the
columns as rows, a turn back. A row of 2^14 < N <=
2^18 values, on a 1D entry or on a pass of the composition, takes the
1D wrappers' cluster kernel (radix 4) or two-pass kernels (radix 2), and a
row of 2^18 < N <= 2^24 the two-pass kernels at both radices: two HBM
round trips a complex row, three a real one (the recombination or the
untangling on top). So a frame W > 2^18 wide runs its rows on the two
passes, then ``fft2_columns`` (H <= 4096) or the turn route; a column
longer than 2^18 takes the turn route onto those rows. The planner's
working-set gate keeps rows past 2^24 away from these entry points on a
CUDA key, and rows past 2^18 on a CPU key, as the reference's does.
"""

from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.kernels.butterfly import butterfly_stage
from repro_torch.kernels.fft_radix2 import (
    SMEM_BUDGET_BYTES,
    fft2_columns,
    fft2_columns_serves,
    fft2_fits_smem,
    fft2_fused,
    fft2_smem_bytes,
    fft_fits_fused,
    fft_fused,
    irfft2_fused,
    irfft_fused,
    rfft2_fits_smem,
    rfft2_fused,
    rfft2_smem_bytes,
    rfft_fused,
)
from repro_torch.resilience import faults as _faults

__all__ = [
    "fft_kernel",
    "fft_staged",
    "fft2_kernel",
    "stream_rows",
    "stream_columns",
    "rfft_kernel",
    "irfft_kernel",
    "rfft2_kernel",
    "irfft2_kernel",
    "hbm_traffic_model",
    "fft2_working_set",
    "fft2_fits_budget",
    "smem_budget_bytes",
]


def smem_budget_bytes() -> int:
    """Shared memory one block may use; kernels, planner and engines all
    size against this one number."""
    return SMEM_BUDGET_BYTES


def fft2_working_set(h: int, w: int, *, real: bool = False) -> int:
    """Shared memory (bytes) of one whole-frame block on an (H, W) frame:
    the frame once (packed to H x W/2 when ``real``), plus the twiddle ROM."""
    return rfft2_smem_bytes(h, w) if real else fft2_smem_bytes(h, w)


def fft2_fits_budget(h: int, w: int, *, real: bool = False) -> bool:
    """True when an (H, W) frame runs as one whole-frame block — the
    predicate the 2D entries route on (``real`` for rfft2/irfft2)."""
    return rfft2_fits_smem(h, w) if real else fft2_fits_smem(h, w)


def _whole_frame(kind: str, h: int, w: int, frames: int, *, real: bool) -> bool:
    """True when an (H, W) frame runs as one whole-frame block: it fits the
    census and no ``vmem`` fault fires at ``kernel.fused``. Else emits the
    ``kernel.failover`` event of the composed route and returns False."""
    if fft2_fits_budget(h, w, real=real) and not _faults.vmem_exhausted(
        "kernel.fused", kind=kind, h=h, w=w
    ):
        return True
    obs.emit("kernel.failover", kind=kind, shape=(h, w), frames=frames,
             working_set=fft2_working_set(h, w, real=real), budget=smem_budget_bytes())
    return False


def _launchable(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a contiguous, resolved, 8-byte aligned tensor of ``dtype``."""
    x = x.to(dtype).resolve_conj().resolve_neg().contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    return x


def _turn(z: torch.Tensor, f: int, a: int, b: int) -> torch.Tensor:
    """Corner turn through HBM: (f*a, b) rows -> (f*b, a) rows. Only the
    turn route of columns longer than ``fft2_columns`` serves runs it."""
    return z.reshape(f, a, b).transpose(-1, -2).contiguous().reshape(f * b, a)


def _columns(z: torch.Tensor, f: int, h: int, wc: int, *, radix: int,
             inverse: bool = False, in_place: bool = True) -> torch.Tensor:
    """The column FFT of ``z`` viewed as (f, h, wc) frames, back as (f*h, wc)
    rows: ``fft2_columns`` (in place on ``z`` unless ``in_place`` is False,
    which leaves ``z`` as it was), or, for columns longer than it serves,
    the turn route."""
    if fft2_columns_serves(h):
        frames = z.reshape(f, h, wc)
        y = fft2_columns(frames, radix=radix, inverse=inverse,
                         out=frames if in_place else None)
        return y.reshape(f * h, wc)
    y = fft_fused(_turn(z, f, h, wc), radix=radix, inverse=inverse)
    return _turn(y, f, wc, h)


def fft_kernel(x: torch.Tensor, *, radix: int = 2, inverse: bool = False) -> torch.Tensor:
    """Fused-kernel FFT along the last axis (any leading batch dims)."""
    n = x.shape[-1]
    z = _launchable(x, torch.complex64).reshape(-1, n)
    return fft_fused(z, radix=radix, inverse=inverse).reshape(x.shape)


def fft_staged(x: torch.Tensor) -> torch.Tensor:
    """Stage-at-a-time FFT along the last axis: log2(N) kernel launches,
    log2(N) HBM round trips (the paper's column architecture)."""
    from repro_torch.core.fft1d import bit_reversal_permutation  # lazy: core imports kernels

    n = x.shape[-1]
    planes = torch.view_as_real(_launchable(x, torch.complex64).reshape(-1, n))
    rev = torch.from_numpy(bit_reversal_permutation(n)).to(planes.device)
    re = planes[..., 0].index_select(-1, rev)
    im = planes[..., 1].index_select(-1, rev)
    for s in range(int(math.log2(n))):  # the control unit's stage counter
        re, im = butterfly_stage(re, im, stage=s)
    return torch.complex(re, im).reshape(x.shape)


def fft2_kernel(x: torch.Tensor, *, radix: int = 2, inverse: bool = False) -> torch.Tensor:
    """2D FFT of (..., H, W): one block per frame when it fits, else
    ``fft_fused`` rows and the column pass in place on their output."""
    h, w = x.shape[-2], x.shape[-1]
    z = _launchable(x, torch.complex64).reshape(-1, h, w)
    f = z.shape[0]
    if _whole_frame("fft2d", h, w, f, real=False):
        y = fft2_fused(z, radix=radix, inverse=inverse)
    else:
        y = fft_fused(z.reshape(f * h, w), radix=radix, inverse=inverse)
        y = _columns(y, f, h, w, radix=radix, inverse=inverse)
    return y.reshape(x.shape)


def stream_rows(z: torch.Tensor, out: torch.Tensor, *, radix: int = 2) -> None:
    """Engine 1 of the ping-pong processor: the row FFTs of (F, H, W)
    contiguous complex64 frames ``z``, written into ``out`` (the write RAM,
    a slot of the stream's output): one ``fft_fused`` call, nothing
    allocated (rows over one block at radix 2 take the two-pass kernels and
    their scratch, as on every entry)."""
    f, h, w = z.shape
    fft_fused(z.reshape(f * h, w), radix=radix, out=out.reshape(f * h, w))


def stream_columns(y: torch.Tensor, *, radix: int = 2) -> None:
    """Engine 2: the column FFTs of (F, H, W) contiguous complex64 frames
    ``y`` in place (the read RAM, holding the previous step's rows):
    ``fft2_columns`` on ``y`` itself; columns longer than it serves take the
    turn route, whose result is copied back."""
    f, h, w = y.shape
    rows = y.reshape(f * h, w)
    cols = _columns(rows, f, h, w, radix=radix)
    if not fft2_columns_serves(h):
        rows.copy_(cols)


def rfft_kernel(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Real-input fused FFT along the last axis -> (..., N/2+1) complex."""
    n = x.shape[-1]
    y = rfft_fused(_launchable(x, torch.float32).reshape(-1, n), radix=radix)
    return y.reshape(*x.shape[:-1], n // 2 + 1)


def irfft_kernel(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Inverse of :func:`rfft_kernel`: (..., N/2+1) complex -> real (..., N)."""
    half = y.shape[-1]
    out = irfft_fused(_launchable(y, torch.complex64).reshape(-1, half), radix=radix)
    return out.reshape(*y.shape[:-1], out.shape[-1])


def rfft2_kernel(x: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Real 2D FFT of (..., H, W) -> (..., H, W/2+1): one ``rfft2_fused``
    block per frame when it fits, else ``rfft_fused`` rows and the column
    pass in place on the F·(W/2+1) columns of their half spectra."""
    h, w = x.shape[-2], x.shape[-1]
    half = w // 2 + 1
    z = _launchable(x, torch.float32).reshape(-1, h, w)
    f = z.shape[0]
    if _whole_frame("rfft2d", h, w, f, real=True):
        y = rfft2_fused(z, radix=radix)
    else:
        y = rfft_fused(z.reshape(f * h, w), radix=radix)
        y = _columns(y, f, h, half, radix=radix)
    return y.reshape(*x.shape[:-1], half)


def irfft2_kernel(y: torch.Tensor, *, radix: int = 2) -> torch.Tensor:
    """Inverse of :func:`rfft2_kernel`: (..., H, W/2+1) -> real (..., H, W):
    one ``irfft2_fused`` block per frame when it fits, else the inverse
    column pass into a new buffer (the caller's spectrum stays as it was),
    then ``irfft_fused`` rows."""
    h, half = y.shape[-2], y.shape[-1]
    w = 2 * (half - 1)
    z = _launchable(y, torch.complex64).reshape(-1, h, half)
    f = z.shape[0]
    if _whole_frame("irfft2d", h, w, f, real=True):
        out = irfft2_fused(z, radix=radix)
    else:
        z = _columns(z, f, h, half, radix=radix, inverse=True, in_place=False)
        out = irfft_fused(z, radix=radix)
    return out.reshape(*y.shape[:-1], w)


def hbm_traffic_model(
    batch: int, n: int, fused: bool, *, radix: int = 2, real: bool = False
) -> int:
    """Bytes moved between HBM and the chip (re+im f32, read+write per pass).

    fused: one round trip, as the reference counts it, up to its envelope
    (N <= 2^18); past it the rows the card serves take the two-pass kernels,
    two round trips (three when ``real``: the recombination or the
    untangling). staged: one per stage — the paper's α = 1/log2 N shows up
    as traffic(fused)/traffic(staged). ``radix=4`` halves the pass count of
    the staged path; ``real`` halves every pass.
    """
    stages = int(math.log2(n))
    if fused:
        passes = 1 if fft_fits_fused(n) else (3 if real else 2)
    else:
        passes = math.ceil(stages / math.log2(radix))
    per_pass = batch * n * 4 * 2 * 2
    if real:
        per_pass //= 2
    return passes * per_pass
