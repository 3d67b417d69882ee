"""repro_torch.xfft — the scipy.fft-style front door, plan-backed.

Port of ``repro.xfft``: eight transforms (``fft``/``ifft``, ``fft2``/
``ifft2``, ``rfft``/``irfft``, ``rfft2``/``irfft2``), ``fftn``/``ifftn``,
``rfftn``/``irfftn`` over any number of axes, the shifts and the sample
frequencies, with ``norm="backward"|"ortho"|"forward"``, ``axes=`` and
``n``/``s`` resizing. Every transform is planned by ``repro_torch.plan``
over the ``repro_torch.engines`` registry; on the card the planner's fused
engines run the hand-written CUDA kernels. A CPU tensor runs on the CPU;
anything else runs on ``torch.device("cuda")``. ``report()`` renders the
live plan cache, quarantine table, telemetry and counters; it touches no
device.
"""

from repro_torch.xfft._config import XFFTConfig, config, get_config
from repro_torch.xfft._report import report, report_data
from repro_torch.xfft._transforms import (
    fft,
    fft2,
    fftfreq,
    fftn,
    fftshift,
    fftshift2,
    ifft,
    ifft2,
    ifftn,
    ifftshift,
    ifftshift2,
    irfft,
    irfft2,
    irfftn,
    rfft,
    rfft2,
    rfftfreq,
    rfftn,
)

__all__ = [
    "fft",
    "ifft",
    "fft2",
    "ifft2",
    "fftn",
    "ifftn",
    "rfft",
    "irfft",
    "rfft2",
    "irfft2",
    "rfftn",
    "irfftn",
    "fftshift",
    "ifftshift",
    "fftshift2",
    "ifftshift2",
    "fftfreq",
    "rfftfreq",
    "config",
    "get_config",
    "report",
    "report_data",
    "XFFTConfig",
]
