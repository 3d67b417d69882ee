"""LM-facing applications of the paper's FFT engine.

Port of ``repro.core.spectral``:

* ``fourier_mixing`` — FNet-style token mixing: Re(FFT2(x)) over (seq, d).
  FNet's mixing sublayer *is* a 2D Fourier transform, so the paper's 2D
  engine drops in as the mixing layer of a trainable LM
  (``repro.configs.fourier_lm``).
* ``fftconv`` — long convolution via the engine (Hyena-style), the
  spectral primitive offered to the SSM/hybrid archs.
* ``correlate2`` — matched-filter cross-correlation in the Fourier domain.
* ``stft`` / ``log_mel`` — a real spectrogram frontend for the audio arch:
  a streamed bank of 1D FFTs.

``fourier_mixing`` and ``fourier_mixing_rfft`` carry their gradient in an
``autograd.Function`` (:class:`ReFFT2`) on every device: for real x,
y = Re(F x) with F = F_S ⊗ F_D the 2D DFT matrix, which is symmetric, so
dL/dx = Re(F g), the same mixing applied to the cotangent g, with the
reference's casts (g to complex64, the real part back to x's dtype). On
the card the backward therefore runs the same planned FFT kernels as the
forward; no kernel's output reaches autograd without a backward.

``variant="auto"`` plans every transform through :mod:`repro_torch.xfft`
(on the card: the fused CUDA kernels); an explicit variant runs the
``repro_torch.core`` entries under that engine, as the reference's
``*_impl(variant=...)`` do. Inputs run where the tensor lies; numpy or
Python input goes to the card. Every tensor built here (windows, the mel
bank) is made on the input's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import xfft
from repro_torch.core.fft1d import fft_impl, ifft_impl
from repro_torch.core.fft2d import fft2_impl, ifft2_impl
from repro_torch.core.rfft import irfft2_impl, irfft_impl, rfft2_impl, rfft_impl
from repro_torch.xfft._transforms import _as_tensor

__all__ = ["ReFFT2", "fourier_mixing", "fftconv", "correlate2", "stft", "log_mel"]


_CORE_ENTRIES = {
    "fft": fft_impl, "ifft": ifft_impl, "rfft": rfft_impl, "irfft": irfft_impl,
    "fft2": fft2_impl, "ifft2": ifft2_impl, "rfft2": rfft2_impl, "irfft2": irfft2_impl,
}


def _transform(name: str, x: torch.Tensor, variant: str, **kw) -> torch.Tensor:
    """The transform ``name``: planned by ``repro_torch.xfft`` under
    ``"auto"``, else the ``repro_torch.core`` entry under ``variant``."""
    if variant == "auto":
        return getattr(xfft, name)(x, **kw)
    return _CORE_ENTRIES[name](x, variant=variant, **kw)


class ReFFT2(torch.autograd.Function):
    """y = ``mix(x)``, a real mixing Re(F x) by a symmetric F, whose
    backward is ``mix`` of the cotangent (forward and backward each run
    with grad disabled, so the FFT kernels see no graph)."""

    @staticmethod
    def forward(ctx, x, mix):
        ctx.mix = mix
        return mix(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mix(g), None


def fourier_mixing(x, variant: str = "auto") -> torch.Tensor:
    """FNet mixing sublayer: real part of the 2D FFT over (seq, hidden).

    x: (..., seq, d) real. Both dims must be powers of two (pad upstream).
    variant="rfft" uses the real-input specialisation: about half the
    FLOPs and bytes, by conjugate symmetry. Differentiable through
    :class:`ReFFT2`.
    """
    x = _as_tensor(x)
    if variant == "rfft":
        return fourier_mixing_rfft(x)
    return ReFFT2.apply(x, functools.partial(_re_fft2, variant=variant))


def _re_fft2(x: torch.Tensor, variant: str) -> torch.Tensor:
    return torch.real(_transform("fft2", x.to(torch.complex64), variant)).to(x.dtype)


def rfft_last_axis(x, variant: str = "auto") -> torch.Tensor:
    """Real-input FFT along the last axis via the packed half-length trick:
    one complex FFT of length D/2 and O(D) untangling. Returns the
    non-redundant half spectrum (..., D//2 + 1)."""
    return _transform("rfft", _as_tensor(x), variant)


def fourier_mixing_rfft(x, variant: str = "auto") -> torch.Tensor:
    """Re(FFT_seq(FFT_d(x))) for real x, computing only the non-redundant
    half of the d-spectrum and mirroring the real part back:

      Re(Y)[s, k] = Re(Y)[(S−s) mod S, D−k]   for k > D/2

    Differentiable through :class:`ReFFT2` (the same function as
    :func:`fourier_mixing`, so the same symmetric backward).
    """
    return ReFFT2.apply(_as_tensor(x), functools.partial(_re_fft2_half, variant=variant))


def _re_fft2_half(x: torch.Tensor, variant: str) -> torch.Tensor:
    s, d = x.shape[-2], x.shape[-1]
    xh = rfft_last_axis(x, variant=variant)          # (..., S, D/2+1)
    re = torch.real(_transform("fft", xh, variant, axis=-2))  # seq-axis complex FFT
    s_mirror = (-torch.arange(s, device=x.device)) % s
    tail_k = torch.arange(d // 2 - 1, 0, -1, device=x.device)  # D−k, k = D/2+1 .. D−1
    tail = re.index_select(-2, s_mirror).index_select(-1, tail_k)
    return torch.cat([re, tail], dim=-1).to(x.dtype)


def _next_pow2(n: int) -> int:
    """Power-of-two cover of ``n``, floored at 2 (the engines' minimum
    transform length). Shared by fftconv, the imaging tiled-convolution
    padding and the planner's oaconv2d tile sweep."""
    return max(2, 1 << max(int(n) - 1, 0).bit_length())


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def fftconv(x, kernel, variant: str = "auto") -> torch.Tensor:
    """Causal long convolution y[t] = sum_s k[s]·x[t−s] via the FFT engine.

    x: (..., seq, d); kernel: (seq_k, d) with seq_k <= seq. O(L log L)
    against the O(L²) direct form. Real inputs (the usual case) take the
    two-for-one ``rfft``/``irfft`` path over the half spectrum.
    """
    x = _as_tensor(x)
    kernel = _as_tensor(kernel).to(x.device)
    seq = x.shape[-2]
    n = _next_pow2(2 * seq)  # zero-pad to avoid circular wrap
    xp = _pad_last(x.transpose(-1, -2), n)              # (..., d, n)
    kp = _pad_last(kernel.transpose(-1, -2), n)         # (d, n)
    if not x.is_complex() and not kernel.is_complex():
        spec = _transform("rfft", xp, variant) * _transform("rfft", kp, variant)
        y = _transform("irfft", spec, variant)[..., :seq]
        return y.transpose(-1, -2).to(x.dtype)
    spec = _transform("fft", xp, variant) * _transform("fft", kp, variant)
    y = _transform("ifft", spec, variant)[..., :seq]
    return torch.real(y).transpose(-1, -2).to(x.dtype)


def correlate2(scene, template, variant: str = "auto") -> torch.Tensor:
    """Matched-filter cross-correlation entirely in the Fourier domain:

        corr = IFFT2( FFT2(scene) · conj(FFT2(template)) )

    — the paper's correlation-pattern-recognition application. Real
    inputs take the two-for-one ``rfft2``/``irfft2`` path.
    """
    scene = _as_tensor(scene)
    template = _as_tensor(template).to(scene.device)
    if not scene.is_complex() and not template.is_complex():
        fs = _transform("rfft2", scene, variant)
        ft = _transform("rfft2", template, variant)
        return _transform("irfft2", fs * torch.conj(ft), variant)
    fs = _transform("fft2", scene.to(torch.complex64), variant)
    ft = _transform("fft2", template.to(torch.complex64), variant)
    return torch.real(_transform("ifft2", fs * torch.conj(ft), variant))


@functools.lru_cache(maxsize=8)
def _hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft(audio, frame: int = 512, hop: int = 256, variant: str = "auto") -> torch.Tensor:
    """Short-time Fourier transform: (..., T) -> (..., frames, frame//2+1)."""
    audio = _as_tensor(audio)
    windows = audio.unfold(-1, frame, hop)              # (..., frames, frame), a view
    windows = windows * torch.from_numpy(_hann(frame)).to(audio.device)
    spec = _transform("fft", windows.to(torch.complex64), variant)
    return spec[..., : frame // 2 + 1]


@functools.lru_cache(maxsize=8)
def _mel_filterbank(n_fft_bins: int, n_mels: int, sr: float = 16000.0) -> np.ndarray:
    """Triangular mel filterbank (slaney-style, simplified)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft_bins - 1) * 2 * hz_pts / sr).astype(int)
    bins = np.clip(bins, 0, n_fft_bins - 1)
    fb = np.zeros((n_mels, n_fft_bins), dtype=np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        if c > lo:
            fb[m - 1, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if hi > c:
            fb[m - 1, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    return fb


def log_mel(
    audio,
    frame: int = 512,
    hop: int = 256,
    n_mels: int = 80,
    variant: str = "auto",
) -> torch.Tensor:
    """Whisper-style log-mel spectrogram built on the paper's engine."""
    spec = stft(audio, frame=frame, hop=hop, variant=variant)
    power = spec.abs() ** 2
    fb = torch.from_numpy(_mel_filterbank(frame // 2 + 1, n_mels)).to(power.device)
    mel = torch.einsum("...tf,mf->...tm", power, fb)
    return torch.log10(torch.clamp(mel, min=1e-10))
