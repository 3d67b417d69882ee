"""repro_torch.serve — one continuous-batching loop behind every service.

Port of ``repro.serve``: ``SpectrumService``, ``ImagingService`` and the
LM ``ServeEngine`` share the :class:`~repro_torch.serve.loop.ServeLoop`
scheduler (per-problem-key lanes, coalescing, round-robin fairness,
``Overloaded`` backpressure); :mod:`repro_torch.serve.wisdom` ships
pre-tuned plan caches as artifacts so a fresh process serves with zero
MEASURE cost.
"""

from repro_torch.serve import wisdom
from repro_torch.serve.engine import Request, ServeEngine, SpectrumRequest, SpectrumService
from repro_torch.serve.imaging import (
    ConvolutionRequest,
    ImagingService,
    ReconRequest,
    RegistrationRequest,
)
from repro_torch.serve.loop import ServeLoop
from repro_torch.serve.queue import AdmissionQueue, BatchPolicy, LaneKey, Ticket

__all__ = [
    "AdmissionQueue",
    "BatchPolicy",
    "ConvolutionRequest",
    "ImagingService",
    "LaneKey",
    "ReconRequest",
    "RegistrationRequest",
    "Request",
    "ServeEngine",
    "ServeLoop",
    "SpectrumRequest",
    "SpectrumService",
    "Ticket",
    "wisdom",
]
