"""Iterative radix-2 FFT with butterfly-unit reuse (the paper's 1D engine).

Port of ``repro.core.fft1d``. The schedules:

  * ``"looped"`` — the paper's engine: N/2 butterfly units reused over
    log2(N) stages, steered by per-stage routing tables (the routing
    network) and a twiddle ROM. The reference also has ``"unrolled"``, the
    same stages laid out for XLA instead of a ``fori_loop``; PyTorch runs
    eagerly, so that name runs this same loop and is kept only so that the
    reference's wisdom files, which name it, load.
  * ``"stockham"`` — Stockham autosort: no bit-reversal gather, contiguous
    reshapes only.
  * ``"radix4"`` — radix-4 Stockham, one radix-2 stage when log2(N) is odd.
  * ``"fused"`` / ``"fused_r4"`` — the CUDA kernels (``repro_torch.kernels``),
    one HBM round trip; ``fused_r4`` runs the radix-4 panel inside.

``stockham`` and ``radix4`` are the fused kernels' plain panels
(``kernels.fft_radix2.fft_fused_plain``): one body of Stockham code, which
the CUDA kernels are held against on the card.

All compute the same DFT. The engine entries take an explicit variant; the
planner (``repro_torch.plan``) chooses one for the ``xfft`` front door.
They compute in complex64 unless ``dtype=torch.complex128`` asks for double
precision (the ``reference_x64`` engine): the plain schedules then run at
complex128 with twiddles computed in float64; the fused kernels are single
precision only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core._deprecation import forward
from repro_torch.kernels.fft_radix2 import fft_fused_plain
from repro_torch.kernels.ops import fft_kernel

__all__ = [
    "BUILTIN_VARIANTS",
    "bit_reversal_permutation",
    "butterfly_counts",
    "canonical_axis",
    "fft",
    "fft_impl",
    "fft_routing_tables",
    "ifft",
    "ifft_impl",
]

BUILTIN_VARIANTS = ("looped", "unrolled", "stockham", "radix4", "fused", "fused_r4")
_FUSED = ("fused", "fused_r4")
#: Complex dtypes the schedules compute in: single, and double for the
#: reference_x64 engine.
DTYPES = (torch.complex64, torch.complex128)


def _check_pow2(n: int, axis: Optional[int] = None) -> int:
    """log2(n), or a ValueError that names the offending axis and size."""
    if n < 2 or (n & (n - 1)) != 0:
        if axis is not None:
            raise ValueError(
                f"axis {axis} has length {n}; xfft requires a power of two >= 2"
            )
        raise ValueError(f"radix-2 FFT needs a power-of-two length, got {n}")
    return int(math.log2(n))


def canonical_axis(axis: int, ndim: int, name: str = "fft") -> int:
    """Normalize ``axis`` into [0, ndim), naming the axis in the error."""
    if not -ndim <= axis < ndim:
        raise ValueError(
            f"{name}: axis {axis} is out of bounds for an array of dimension {ndim}"
        )
    return axis % ndim


@functools.lru_cache(maxsize=64)
def bit_reversal_permutation(n: int) -> np.ndarray:
    """Index permutation that bit-reverses ``n`` positions (DIT input order)."""
    bits = _check_pow2(n)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=64)
def fft_routing_tables(n: int, dtype=np.complex64):
    """Per-stage routing network + twiddle ROM for the looped engine.

    Returns numpy arrays, all indexed by stage ``s`` (the Stage Bus value):
      idx_a   (L, N/2) int32 — top input index of each butterfly unit
      idx_b   (L, N/2) int32 — bottom input index (= idx_a + half)
      twiddle (L, N/2) dtype — W_m^p per butterfly unit, computed in
                               complex128 and rounded to ``dtype``
      unperm  (L, N)   int32 — position i of the stage output gathers from
                               concat([top_out, bot_out])[unperm[i]]
    """
    stages = _check_pow2(n)
    half_n = n // 2
    idx_a = np.zeros((stages, half_n), dtype=np.int32)
    idx_b = np.zeros((stages, half_n), dtype=np.int32)
    twiddle = np.zeros((stages, half_n), dtype=dtype)
    unperm = np.zeros((stages, n), dtype=np.int32)
    for s in range(stages):
        half = 1 << s
        m = half * 2
        j = 0
        pos_of = np.zeros(n, dtype=np.int32)
        for blk in range(0, n, m):
            for p in range(half):
                a = blk + p
                b = a + half
                idx_a[s, j] = a
                idx_b[s, j] = b
                twiddle[s, j] = np.exp(-2j * np.pi * p / m).astype(dtype)
                pos_of[a] = j
                pos_of[b] = half_n + j
                j += 1
        unperm[s] = pos_of
    return idx_a, idx_b, twiddle, unperm


def butterfly_counts(n: int, proposed: bool) -> dict:
    """Analytic resource counts from the paper (Tables 1 & 2), 1D engine."""
    stages = _check_pow2(n)
    bu = n // 2 if proposed else (n // 2) * stages
    return {
        "butterfly_units": bu,
        "multipliers": bu,
        "adders_subtractors": 2 * bu,
        "stages": stages,
    }


def _fft_routed(x: torch.Tensor, n: int) -> torch.Tensor:
    """The paper's engine: bit-reversed input, then per stage the N/2
    butterflies top = A + W·B, bot = A − W·B and the routing shuffle."""
    stages = _check_pow2(n)
    rom = np.complex128 if x.dtype == torch.complex128 else np.complex64
    idx_a, idx_b, tw, unperm = (
        torch.from_numpy(t).to(x.device) for t in fft_routing_tables(n, rom)
    )
    idx_a, idx_b, unperm = idx_a.long(), idx_b.long(), unperm.long()
    rev = torch.from_numpy(bit_reversal_permutation(n)).to(x.device)
    x = x.index_select(-1, rev)
    for s in range(stages):
        a = x.index_select(-1, idx_a[s])
        b = x.index_select(-1, idx_b[s]) * tw[s]
        merged = torch.cat([a + b, a - b], dim=-1)
        x = merged.index_select(-1, unperm[s])
    return x


def _fft_panel(x: torch.Tensor, n: int, radix: int) -> torch.Tensor:
    """The Stockham schedules: the fused kernels' plain panel over every
    row of ``x`` (any leading dims), in ``x``'s precision."""
    return fft_fused_plain(x.reshape(-1, n), radix=radix).reshape(x.shape)


def _check_variant(variant: str, dtype: torch.dtype = torch.complex64) -> None:
    if variant not in BUILTIN_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; want one of {BUILTIN_VARIANTS}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
    if dtype == torch.complex128 and variant in _FUSED:
        raise ValueError(f"variant {variant!r} runs the single-precision CUDA kernels; "
                         "double precision runs the plain schedules")


def fft_impl(x: torch.Tensor, axis: int = -1, variant: str = "stockham",
             dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Radix-2 FFT along ``axis`` under ``variant``; returns ``dtype``
    (complex64, or complex128 on a plain schedule) on ``x``'s device."""
    _check_variant(variant, dtype)
    user_axis = axis
    axis = canonical_axis(axis, x.dim())
    n = x.shape[axis]
    _check_pow2(n, axis=user_axis)
    x = x.to(dtype)
    last = axis == x.dim() - 1
    if not last:
        x = x.movedim(axis, -1)
    if variant in ("looped", "unrolled"):
        y = _fft_routed(x, n)
    elif variant in ("stockham", "radix4"):
        y = _fft_panel(x, n, 4 if variant == "radix4" else 2)
    else:
        y = fft_kernel(x, radix=4 if variant == "fused_r4" else 2)
    return y if last else y.movedim(-1, axis)


def ifft_impl(x: torch.Tensor, axis: int = -1, variant: str = "stockham",
              dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Inverse FFT by the conjugation identity on the forward engine; the
    fused kernels conjugate and scale inside the kernel."""
    _check_variant(variant, dtype)
    axis_n = canonical_axis(axis, x.dim())
    n = x.shape[axis_n]
    x = x.to(dtype)
    if variant in _FUSED:
        _check_pow2(n, axis=axis)
        last = axis_n == x.dim() - 1
        z = x if last else x.movedim(axis_n, -1)
        y = fft_kernel(z, radix=4 if variant == "fused_r4" else 2, inverse=True)
        return y if last else y.movedim(-1, axis_n)
    return torch.conj(fft_impl(torch.conj(x), axis=axis, variant=variant, dtype=dtype)) / n


def fft(x, axis: int = -1, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.fft` (kept for old call
    sites). ``None``/``"auto"`` lets the planner pick; a concrete variant is
    honoured by scoping ``repro_torch.xfft.config(variant=...)`` around the
    call."""
    return forward("repro_torch.core.fft1d.fft", "fft", x, variant, axis=axis)


def ifft(x, axis: int = -1, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.ifft` (kept for old call sites)."""
    return forward("repro_torch.core.fft1d.ifft", "ifft", x, variant, axis=axis)
