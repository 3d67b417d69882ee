"""The eight xfft transforms and their helpers, all plan-backed.

Port of ``repro.xfft._transforms``. Every transform:

1. takes its input where it lies: a ``torch.Tensor`` runs on its own
   device; a numpy array or Python data goes to ``torch.device("cuda")``,
   and raises when CUDA is absent;
2. validates axes and norm, and crops or zero-pads to ``n``/``s`` (scipy
   style); errors name the offending axis and size;
3. moves the transform axes last, resolves the call through
   :func:`repro_torch.plan.api.resolve_call` (under the scope's ``mode``)
   and runs the chosen engine through the degradation ladder
   (:func:`repro_torch.resilience.run_plan`): an engine that fails is
   quarantined for the key and the call retries the next-best rung — on
   the card another hand-written kernel, never the plain schedules unless
   the scope asked for ``backend="torch"``;
4. applies the ``norm`` scaling on top of the engines' backward convention.

Precision follows the scoped ``xfft.config(precision=...)``, as the
reference's ``_precision_scope``, ``_cdtype`` and ``_rdtype`` set it:
single casts the input to complex64 (float32 for the real transforms'
input), double to complex128 (float64), the plan key carries the
precision (so a double call plans ``reference_x64``), the norm scale is a
float64 factor on double data, and ``fftfreq`` / ``rfftfreq`` default to
the scope's real dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fft1d import _check_pow2 as _core_check_pow2
from repro_torch.core.fft1d import canonical_axis as _canon_axis
from repro_torch.core.fft2d import fftshift2 as _core_fftshift2
from repro_torch.core.fft2d import ifftshift2 as _core_ifftshift2
from repro_torch.engines import get_engine
from repro_torch.plan.api import resolve_call
from repro_torch.plan.plan import NORMS
from repro_torch.resilience.ladder import run_plan
from repro_torch.xfft._config import get_config

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "fftshift", "ifftshift", "fftshift2", "ifftshift2",
    "fftfreq", "rfftfreq",
]


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.xfft runs non-tensor input on torch.device('cuda'), and "
            "CUDA is not available; pass a CPU tensor to compute on the CPU"
        )
    return torch.device("cuda")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    device = _default_device()
    return torch.as_tensor(np.asarray(x)).to(device)


def _cdtype() -> torch.dtype:
    """The scope's complex dtype (what complex entry points cast input to)."""
    return torch.complex128 if get_config().precision == "double" else torch.complex64


def _rdtype() -> torch.dtype:
    """The scope's real dtype (what real-input entry points cast to)."""
    return torch.float64 if get_config().precision == "double" else torch.float32


def _complex_input(x) -> torch.Tensor:
    return _as_tensor(x).to(_cdtype())


def _real_input(x, name: str) -> torch.Tensor:
    x = _as_tensor(x)
    if x.is_complex():
        raise TypeError(f"{name} expects real input; use fft/fft2 for complex")
    return x.to(_rdtype())


def _check_norm(norm: Optional[str]) -> str:
    if norm is None:
        return "backward"
    if norm not in NORMS:
        raise ValueError(f'norm must be one of {NORMS} (or None for "backward"), got {norm!r}')
    return norm


def _canon_axes(axes: Sequence[int], ndim: int, name: str) -> Tuple[int, ...]:
    canon = tuple(_canon_axis(a, ndim, name) for a in axes)
    if len(set(canon)) != len(canon):
        raise ValueError(f"{name}: axes {tuple(axes)} name an axis twice")
    return canon


def _resize_axis(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """scipy-style ``n``/``s`` handling: crop or zero-pad along ``axis``."""
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        return x.narrow(axis, 0, n)
    pad = list(x.shape)
    pad[axis] = n - cur
    return torch.cat([x, x.new_zeros(pad)], dim=axis)


def _scale(y: torch.Tensor, norm: str, n: int, forward: bool) -> torch.Tensor:
    """Norm correction on top of the engines' backward convention. The
    factor is a Python float: PyTorch applies it at the data's width, so a
    complex128 result is scaled in float64 and a complex64 one in float32."""
    if norm == "backward":
        return y
    if norm == "ortho":
        factor = 1.0 / math.sqrt(n) if forward else math.sqrt(n)
    else:
        factor = 1.0 / n if forward else float(n)
    return y * factor


def _run(kind: str, x: torch.Tensor, key_shape, *, inverse: bool,
         dtype: str = "complex64") -> torch.Tensor:
    """Plan the call and run the chosen engine on ``x`` (axes last) through
    the degradation ladder."""
    direction = "inv" if inverse else "fwd"
    plan = resolve_call(kind, tuple(key_shape), x.device, dtype=dtype, direction=direction)
    return run_plan(plan, lambda v: get_engine(v).op(kind, direction)(x))


# ------------------------------ 1D complex ------------------------------


def _fft1(x, n, axis, norm, *, inverse: bool, name: str):
    norm = _check_norm(norm)
    x = _complex_input(x)
    ax = _canon_axis(axis, x.dim(), name)
    if n is not None:
        x = _resize_axis(x, int(n), ax)
    length = x.shape[ax]
    _core_check_pow2(length, axis=ax)
    y = _run("fft1d", x.movedim(ax, -1), x.movedim(ax, -1).shape, inverse=inverse)
    return _scale(y.movedim(-1, ax), norm, length, forward=not inverse)


def fft(x, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None):
    """1D FFT along ``axis``; scipy.fft-compatible, plan-backed dispatch."""
    return _fft1(x, n, axis, norm, inverse=False, name="fft")


def ifft(x, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None):
    """Inverse 1D FFT along ``axis`` (norm-aware, plan-backed)."""
    return _fft1(x, n, axis, norm, inverse=True, name="ifft")


# ------------------------------ 2D complex ------------------------------


def _prep_2d(x: torch.Tensor, s, axes, name: str):
    """Validate, resize, move the two axes to (-2, -1)."""
    if x.dim() < 2:
        raise ValueError(f"{name} needs at least a 2D array, got shape {tuple(x.shape)}")
    if len(axes) != 2:
        raise ValueError(f"{name} transforms exactly 2 axes, got {tuple(axes)}")
    canon = _canon_axes(axes, x.dim(), name)
    if s is not None:
        if len(s) != 2:
            raise ValueError(f"{name}: s must have 2 entries, got {tuple(s)}")
        for target, ax in zip(s, canon):
            x = _resize_axis(x, int(target), ax)
    for ax in canon:
        _core_check_pow2(x.shape[ax], axis=ax)
    return x.movedim(canon, (-2, -1)), canon


def _fft2(x, s, axes, norm, *, inverse: bool, name: str):
    norm = _check_norm(norm)
    x, canon = _prep_2d(_complex_input(x), s, axes, name)
    h, w = x.shape[-2], x.shape[-1]
    y = _run("fft2d", x, x.shape, inverse=inverse)
    return _scale(y, norm, h * w, forward=not inverse).movedim((-2, -1), canon)


def fft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None):
    """2D FFT over ``axes``; scipy.fft-compatible, plan-backed dispatch."""
    return _fft2(x, s, axes, norm, inverse=False, name="fft2")


def ifft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None):
    """Inverse 2D FFT over ``axes`` (norm-aware, plan-backed)."""
    return _fft2(x, s, axes, norm, inverse=True, name="ifft2")


# ------------------------------ N-D complex ------------------------------


def _fftn_axes(x: torch.Tensor, s, axes, name: str) -> Tuple[int, ...]:
    if axes is None:
        axes = tuple(range(x.dim())) if s is None else tuple(range(x.dim() - len(s), x.dim()))
    axes = tuple(int(a) for a in axes)
    if s is not None and len(s) != len(axes):
        raise ValueError(f"{name}: s has {len(s)} entries for {len(axes)} axes")
    return axes


def _fftn(x, s, axes, norm, *, inverse: bool, name: str):
    x = _complex_input(x)
    axes = _fftn_axes(x, s, axes, name)
    if len(axes) == 2:
        return _fft2(x, s, axes, norm, inverse=inverse, name=name)
    norm = _check_norm(norm)
    canon = _canon_axes(axes, x.dim(), name)
    total = 1
    for i, ax in enumerate(canon):
        if s is not None:
            x = _resize_axis(x, int(s[i]), ax)
        total *= x.shape[ax]
        x = _fft1(x, None, ax, None, inverse=inverse, name=name)
    return _scale(x, norm, total, forward=not inverse)


def fftn(x, s=None, axes=None, norm: Optional[str] = None):
    """N-D FFT: 2-axis calls take the ``fft2d`` kind via :func:`fft2`, any
    other axis count runs separable 1D passes."""
    return _fftn(x, s, axes, norm, inverse=False, name="fftn")


def ifftn(x, s=None, axes=None, norm: Optional[str] = None):
    """Inverse N-D FFT (see :func:`fftn`)."""
    return _fftn(x, s, axes, norm, inverse=True, name="ifftn")


# ------------------------------- real input -------------------------------


def rfft(x, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None):
    """Real-input FFT -> non-redundant half spectrum (..., N/2+1)."""
    norm = _check_norm(norm)
    x = _real_input(x, "rfft")
    ax = _canon_axis(axis, x.dim(), "rfft")
    if n is not None:
        x = _resize_axis(x, int(n), ax)
    length = x.shape[ax]
    _core_check_pow2(length, axis=ax)
    xm = x.movedim(ax, -1)
    y = _run("rfft1d", xm, xm.shape, inverse=False, dtype="float32")
    return _scale(y.movedim(-1, ax), norm, length, forward=True)


def irfft(x, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None):
    """Inverse of :func:`rfft`: half spectrum -> real signal of length ``n``
    (default ``2*(width-1)``)."""
    norm = _check_norm(norm)
    x = _complex_input(x)
    ax = _canon_axis(axis, x.dim(), "irfft")
    length = int(n) if n is not None else 2 * (x.shape[ax] - 1)
    _core_check_pow2(length, axis=ax)
    x = _resize_axis(x, length // 2 + 1, ax)  # numpy: crop/pad to n//2+1 bins
    xm = x.movedim(ax, -1)
    y = _run("rfft1d", xm, xm.shape[:-1] + (length,), inverse=True, dtype="float32")
    return _scale(y.movedim(-1, ax), norm, length, forward=False)


def rfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None):
    """2D real-input FFT -> (..., H, W/2+1) half spectrum, plan-backed."""
    norm = _check_norm(norm)
    x, canon = _prep_2d(_real_input(x, "rfft2"), s, axes, "rfft2")
    h, w = x.shape[-2], x.shape[-1]
    y = _run("rfft2d", x, x.shape, inverse=False, dtype="float32")
    return _scale(y, norm, h * w, forward=True).movedim((-2, -1), canon)


def irfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None):
    """Inverse of :func:`rfft2`: (..., H, W/2+1) -> real (..., H, W)."""
    norm = _check_norm(norm)
    x = _complex_input(x)
    if x.dim() < 2:
        raise ValueError(f"irfft2 needs at least a 2D array, got shape {tuple(x.shape)}")
    if len(axes) != 2:
        raise ValueError(f"irfft2 transforms exactly 2 axes, got {tuple(axes)}")
    if s is not None and len(s) != 2:
        raise ValueError(f"irfft2: s must have 2 entries, got {tuple(s)}")
    canon = _canon_axes(axes, x.dim(), "irfft2")
    x = x.movedim(canon, (-2, -1))
    h = int(s[0]) if s is not None else x.shape[-2]
    w = int(s[1]) if s is not None else 2 * (x.shape[-1] - 1)
    _core_check_pow2(h, axis=canon[0])
    _core_check_pow2(w, axis=canon[1])
    x = _resize_axis(_resize_axis(x, h, x.dim() - 2), w // 2 + 1, x.dim() - 1)
    y = _run("rfft2d", x, x.shape[:-1] + (w,), inverse=True, dtype="float32")
    return _scale(y, norm, h * w, forward=False).movedim((-2, -1), canon)


def rfftn(x, s=None, axes=None, norm: Optional[str] = None):
    """N-D real-input FFT: the two-for-one :func:`rfft` along the last of
    ``axes``, complex :func:`fft` passes over the rest, so a real array
    never round-trips through a full complex ``fftn``. One- and two-axis
    calls take the ``rfft1d``/``rfft2d`` kinds."""
    x = _real_input(x, "rfftn")
    axes = _fftn_axes(x, s, axes, "rfftn")
    if len(axes) == 1:
        return rfft(x, n=None if s is None else int(s[0]), axis=axes[0], norm=norm)
    if len(axes) == 2:
        return rfft2(x, s=s, axes=axes, norm=norm)
    norm = _check_norm(norm)
    canon = _canon_axes(axes, x.dim(), "rfftn")
    if s is not None:
        for target, ax in zip(s, canon):
            x = _resize_axis(x, int(target), ax)
    total = math.prod(x.shape[ax] for ax in canon)
    y = rfft(x, axis=canon[-1])
    for ax in canon[:-1]:
        y = fft(y, axis=ax)
    return _scale(y, norm, total, forward=True)


def irfftn(x, s=None, axes=None, norm: Optional[str] = None):
    """Inverse of :func:`rfftn`: complex inverse passes over the leading
    axes, then the half-spectrum :func:`irfft` along the last, to a real
    output."""
    x = _complex_input(x)
    axes = _fftn_axes(x, s, axes, "irfftn")
    if len(axes) == 1:
        return irfft(x, n=None if s is None else int(s[0]), axis=axes[0], norm=norm)
    if len(axes) == 2:
        return irfft2(x, s=s, axes=axes, norm=norm)
    norm = _check_norm(norm)
    canon = _canon_axes(axes, x.dim(), "irfftn")
    total = 1
    for i, ax in enumerate(canon[:-1]):
        if s is not None:
            x = _resize_axis(x, int(s[i]), ax)
        total *= x.shape[ax]
        x = ifft(x, axis=ax)
    last = canon[-1]
    n_last = int(s[-1]) if s is not None else 2 * (x.shape[last] - 1)
    total *= n_last
    y = irfft(x, n=n_last, axis=last)
    return _scale(y, norm, total, forward=False)


# ------------------------------- shifts -------------------------------


def _shift(x, axes, sign: int, name: str):
    x = _as_tensor(x)
    if axes is None:
        axes = tuple(range(x.dim()))
    elif isinstance(axes, int):
        axes = (axes,)
    axes = _canon_axes(axes, x.dim(), name)
    return torch.roll(x, [sign * (x.shape[a] // 2) for a in axes], axes)


def fftshift(x, axes=None):
    """Move the zero-frequency bin to the centre (numpy-compatible)."""
    return _shift(x, axes, 1, "fftshift")


def ifftshift(x, axes=None):
    """Exact inverse of :func:`fftshift` (correct for odd lengths too)."""
    return _shift(x, axes, -1, "ifftshift")


def fftshift2(x):
    """Centre the zero-frequency bin of the trailing two axes."""
    return _core_fftshift2(_as_tensor(x))


def ifftshift2(x):
    """Exact inverse of :func:`fftshift2`."""
    return _core_ifftshift2(_as_tensor(x))


# ---------------------------- sample frequencies ----------------------------


def fftfreq(n, d: float = 1.0, *, dtype=None, device=None):
    """Sample frequencies of an ``n``-point FFT (scipy.fft parity), on
    ``device`` (default: the card), in ``dtype`` (default: the scope's real
    dtype, float64 under ``precision="double"``)."""
    n = int(n)
    if n <= 0:
        raise ValueError(f"fftfreq needs a positive sample count, got {n}")
    dtype = _rdtype() if dtype is None else dtype
    device = torch.device(device) if device is not None else _default_device()
    k = torch.cat([
        torch.arange(0, (n - 1) // 2 + 1, dtype=dtype, device=device),
        torch.arange(-(n // 2), 0, dtype=dtype, device=device),
    ])
    return k / (n * d)


def rfftfreq(n, d: float = 1.0, *, dtype=None, device=None):
    """Sample frequencies of the :func:`rfft` half spectrum (scipy parity),
    in ``dtype`` (default: the scope's real dtype)."""
    n = int(n)
    if n <= 0:
        raise ValueError(f"rfftfreq needs a positive sample count, got {n}")
    dtype = _rdtype() if dtype is None else dtype
    device = torch.device(device) if device is not None else _default_device()
    return torch.arange(0, n // 2 + 1, dtype=dtype, device=device) / (n * d)
