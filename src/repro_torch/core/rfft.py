"""Real-input FFTs via two-for-one Hermitian packing — half the work.

Port of ``repro.core.rfft``. N real samples pack as N/2 complex values
z[j] = x[2j] + i·x[2j+1]; one half-size complex FFT and the symmetry
recombination Y[k] = Xe[k] + W_N^k · Xo[k], k = 0..N/2, give the
non-redundant half spectrum. The ``fused`` variants run pack, panel and
recombination in one CUDA kernel (``repro_torch.kernels``). ``dtype`` is
the complex dtype of the spectrum: complex128 (real side float64) runs the
plain schedules in double precision, twiddles computed in float64.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core._deprecation import forward
from repro_torch.core.fft1d import _check_pow2, _check_variant, fft_impl, ifft_impl
from repro_torch.kernels.ops import irfft2_kernel, irfft_kernel, rfft2_kernel, rfft_kernel

__all__ = ["rfft", "irfft", "rfft2", "irfft2", "rfft_impl", "irfft_impl", "rfft2_impl",
           "irfft2_impl"]

_FUSED = ("fused", "fused_r4")


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _ensure_real(x: torch.Tensor, name: str,
                 dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    if x.is_complex():
        raise TypeError(f"{name} expects real input; use fft/fft2 for complex")
    return x.to(_real_dtype(dtype))


def _radix(variant: str) -> int:
    return 4 if variant == "fused_r4" else 2


def _rfft_torch(x: torch.Tensor, n: int, variant: str) -> torch.Tensor:
    """Pack N reals as N/2 complex, half-size FFT, symmetry recombination."""
    m = n // 2
    z = torch.complex(x[..., 0::2].contiguous(), x[..., 1::2].contiguous())
    zf = fft_impl(z, variant=variant, dtype=z.dtype) if m > 1 else z
    k = torch.arange(m + 1, device=x.device)
    zk = zf.index_select(-1, k % m)                       # Z[k], Z[M] = Z[0]
    zmk = torch.conj(zf.index_select(-1, (-k) % m))       # conj(Z[(M-k) mod M])
    xe = 0.5 * (zk + zmk)
    xo = -0.5j * (zk - zmk)
    w = torch.exp(-2j * torch.pi * k.to(torch.float64) / n).to(zf.dtype)
    return xe + w * xo


def _irfft_torch(y: torch.Tensor, n: int, variant: str) -> torch.Tensor:
    """Invert the recombination, one half-size IFFT, de-interleave."""
    m = n // 2
    edge = torch.arange(m + 1, device=y.device)
    y = torch.where((edge == 0) | (edge == m), torch.real(y).to(y.dtype), y)
    k = torch.arange(m, device=y.device)
    yk = y[..., :m]
    ymk = torch.conj(torch.flip(y[..., 1:], dims=(-1,)))
    xe = 0.5 * (yk + ymk)
    xo = 0.5 * (yk - ymk) * torch.exp(
        2j * torch.pi * k.to(torch.float64) / n
    ).to(y.dtype)
    z = xe + 1j * xo
    zi = ifft_impl(z, variant=variant, dtype=y.dtype) if m > 1 else z
    out = torch.stack([torch.real(zi), torch.imag(zi)], dim=-1)
    return out.reshape(*zi.shape[:-1], n).to(_real_dtype(y.dtype))


def rfft_impl(x: torch.Tensor, axis: int = -1, variant: str = "stockham",
              dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Real-input FFT along ``axis`` -> (..., N/2+1) ``dtype``."""
    _check_variant(variant, dtype)
    x = _ensure_real(x, "rfft", dtype)
    user_axis = axis
    axis = axis % x.dim()
    n = x.shape[axis]
    _check_pow2(n, axis=user_axis)
    last = axis == x.dim() - 1
    if not last:
        x = x.movedim(axis, -1)
    y = rfft_kernel(x, radix=_radix(variant)) if variant in _FUSED else _rfft_torch(x, n, variant)
    return y if last else y.movedim(-1, axis)


def irfft_impl(y: torch.Tensor, axis: int = -1, variant: str = "stockham",
               dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Inverse of :func:`rfft_impl`: (..., N/2+1) half spectrum -> real (..., N)."""
    _check_variant(variant, dtype)
    user_axis = axis
    axis = axis % y.dim()
    n = 2 * (y.shape[axis] - 1)
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"axis {user_axis} has a half spectrum of width {y.shape[axis]}; "
            "irfft requires width N/2+1 with N a power of two"
        )
    y = y.to(dtype)
    last = axis == y.dim() - 1
    if not last:
        y = y.movedim(axis, -1)
    if variant in _FUSED:
        out = irfft_kernel(y, radix=_radix(variant))
    else:
        out = _irfft_torch(y, n, variant)
    return out if last else out.movedim(-1, axis)


def rfft2_impl(x: torch.Tensor, variant: str = "stockham",
               dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """2D real-input FFT over the last two axes -> (..., H, W/2+1)."""
    _check_variant(variant, dtype)
    x = _ensure_real(x, "rfft2", dtype)
    if variant in _FUSED:
        return rfft2_kernel(x, radix=_radix(variant))
    y = rfft_impl(x, axis=-1, variant=variant, dtype=dtype)
    return fft_impl(y, axis=-2, variant=variant, dtype=dtype)


def irfft2_impl(y: torch.Tensor, variant: str = "stockham",
                dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Inverse of :func:`rfft2_impl`: (..., H, W/2+1) -> real (..., H, W)."""
    _check_variant(variant, dtype)
    y = y.to(dtype)
    if variant in _FUSED:
        return irfft2_kernel(y, radix=_radix(variant))
    z = ifft_impl(y, axis=-2, variant=variant, dtype=dtype)
    return irfft_impl(z, axis=-1, variant=variant, dtype=dtype)


def rfft(x, axis: int = -1, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.rfft` (kept for old call sites)."""
    return forward("repro_torch.core.rfft.rfft", "rfft", x, variant, axis=axis)


def irfft(y, axis: int = -1, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.irfft` (kept for old call sites)."""
    return forward("repro_torch.core.rfft.irfft", "irfft", y, variant, axis=axis)


def rfft2(x, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.rfft2` (kept for old call sites)."""
    return forward("repro_torch.core.rfft.rfft2", "rfft2", x, variant)


def irfft2(y, variant: Optional[str] = None):
    """Deprecated alias of :func:`repro_torch.xfft.irfft2` (kept for old call sites)."""
    return forward("repro_torch.core.rfft.irfft2", "irfft2", y, variant)
