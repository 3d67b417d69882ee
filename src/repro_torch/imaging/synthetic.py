"""Deterministic synthetic frames for demos, benchmarks and tests.

Port of ``repro.imaging.synthetic``: the band-limited random frame that
makes subpixel registration well posed (a Gaussian-windowed white
spectrum). The spectral shaping runs in numpy on purpose, so generating
inputs exercises none of the transform engines under test, and the
frequency grid is ``np.fft.fftfreq`` cast to float32: bit for bit the
reference's grid, whose dtype it pins to float32.
"""

from __future__ import annotations

import numpy as np

__all__ = ["band_limited_frame"]


def band_limited_frame(n: int, seed: int, bandwidth: float = 0.05) -> np.ndarray:
    """(n, n) float32 frame with a Gaussian-bounded spectrum, max-normed.

    ``bandwidth`` is the Gaussian's std in cycles/sample; 0.05 leaves
    enough low-frequency structure that phase correlation locks on and
    little enough high frequency that fractional shifts interpolate
    cleanly.
    """
    rng = np.random.default_rng(seed)
    spectrum = np.fft.fft2(rng.standard_normal((n, n)))
    freqs = np.fft.fftfreq(n).astype(np.float32).astype(np.float64)
    ky = freqs[:, None]
    kx = freqs[None, :]
    spectrum *= np.exp(-(ky**2 + kx**2) / (2 * bandwidth**2))
    frame = np.real(np.fft.ifft2(spectrum))
    return (frame / np.abs(frame).max()).astype(np.float32)
