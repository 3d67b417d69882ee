"""repro_torch.imaging — spectral image processing on the paper's 2D engine.

Port of ``repro.imaging``: the operator set an imaging user calls, each
one built on the ``repro_torch.xfft`` / ``repro_torch.plan`` stack (every
FFT in here resolves through the planner; on the card it runs the fused
CUDA kernels):

* :mod:`repro_torch.imaging.psd` — periodic-plus-smooth decomposition
  (``psd_decompose`` / ``fft2_psd``): spectra free of the cross-shaped
  boundary artifact.
* :mod:`repro_torch.imaging.registration` — translation registration:
  ``register_phase_correlation`` (whole-pixel peak plus subpixel
  upsampled-DFT refinement), ``apply_shift`` (Fourier shift theorem) and
  ``register_logpolar`` (rotation and scale).
* :mod:`repro_torch.imaging.kspace` — the MRI centered-transform
  convention: ``image_to_kspace`` / ``kspace_to_image``.
* :mod:`repro_torch.imaging.tiled` — overlap-save tiled convolution:
  ``oaconvolve2`` (tile planned by the ``oaconv2d`` kind against the
  whole-frame kernels' shared-memory census), ``fftconv2`` and
  ``matched_filter2``.

Entry points run where the tensor lies; numpy or Python input goes to
``torch.device("cuda")``.
"""

from repro_torch.imaging.kspace import image_to_kspace, kspace_to_image
from repro_torch.imaging.psd import fft2_psd, psd_decompose
from repro_torch.imaging.registration import apply_shift, register_phase_correlation
from repro_torch.imaging.synthetic import band_limited_frame
from repro_torch.imaging.tiled import fftconv2, matched_filter2, oaconvolve2

__all__ = [
    "band_limited_frame",
    "psd_decompose",
    "fft2_psd",
    "register_phase_correlation",
    "apply_shift",
    "image_to_kspace",
    "kspace_to_image",
    "oaconvolve2",
    "fftconv2",
    "matched_filter2",
]
