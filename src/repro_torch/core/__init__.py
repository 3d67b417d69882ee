"""The FFT engines in torch: the paper's reused-butterfly schedules, the
Stockham family, the two-for-one real path, the separable 2D passes and
the ping-pong streaming processor, with the reference's package exports.

``fft``, ``ifft``, ``fft2``, ``ifft2``, ``rfft``, ``irfft``, ``rfft2`` and
``irfft2`` are the deprecated per-call ``variant=`` entry points: each
warns once per process and calls ``repro_torch.xfft``. The spectral
applications (``correlate2``, ``fftconv``, ``fourier_mixing``, ``log_mel``,
``stft``) load at first access, since ``core.spectral`` builds on
``repro_torch.xfft``, which builds on this package.
"""

from repro_torch.core.fft1d import (
    bit_reversal_permutation,
    butterfly_counts,
    fft,
    fft_routing_tables,
    ifft,
)
from repro_torch.core.fft2d import fft2, fft2_stream, fftshift2, ifft2, ifftshift2
from repro_torch.core.rfft import irfft, irfft2, rfft, rfft2

_SPECTRAL = ("correlate2", "fftconv", "fourier_mixing", "log_mel", "stft")

__all__ = [
    "bit_reversal_permutation",
    "butterfly_counts",
    "fft",
    "fft_routing_tables",
    "ifft",
    "fft2",
    "fft2_stream",
    "fftshift2",
    "ifftshift2",
    "ifft2",
    "rfft",
    "irfft",
    "rfft2",
    "irfft2",
    *_SPECTRAL,
]


def __getattr__(name: str):
    if name in _SPECTRAL:
        from repro_torch.core import spectral

        return getattr(spectral, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
