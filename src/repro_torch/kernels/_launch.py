"""Launch counts and the one ctypes launch path shared by every wrapper.

Each wrapper calls :func:`launch` where it launches its kernel, and
nowhere else, so ``LAUNCHES`` counts kernel launches only: a run can show
that its path went through the kernels and not through plain code.

A kernel writes into a tensor its wrapper allocated, so its output has no
``grad_fn``: on the card each wrapper calls :func:`refuse_grad` before it
launches, and raises :class:`NoBackward` where autograd would otherwise
lose a gradient without a word (ROADMAP, divergence 19). The kernels with
a backward run inside their ``autograd.Function``, whose forward and
backward run with grad disabled.

On a ``meta`` tensor (the dry-run, ``repro_torch.launch.dryrun``) a
wrapper takes its card route up to the launch: the same casts and the same
outputs, allocated on the meta device. :func:`launch` then launches
nothing and counts nothing. Each wrapper calls :func:`charge` with its
kernel's ``cost`` function on the card and on meta alike, so a cost
counter in :data:`COUNTERS` (``repro_torch.launch.hlo_cost.CostCounter``
enters itself there) sees the same work on both. With no counter in force
the cost is not computed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

__all__ = ["COUNTERS", "Cost", "LAUNCHES", "NoBackward", "charge", "launch", "refuse_grad",
           "reset_launches"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {
    "fft_fused": 0, "rfft_fused": 0, "irfft_fused": 0, "fft2_fused": 0,
    "rfft2_fused": 0, "irfft2_fused": 0, "butterfly_stage": 0,
    "flash_attention_fwd": 0, "flash_attention_bwd": 0, "slstm_scan": 0, "slstm_scan_bwd": 0,
    "fft_two_pass": 0, "fft_cluster": 0, "fft2_columns": 0,
}


class Cost(NamedTuple):
    """A kernel call's work: the ``flops`` it does and the ``bytes`` it must
    move (each input read once, each output written once)."""

    flops: float
    bytes: float


#: The cost counters in force, innermost last. A global list and not the
#: thread's dispatch-mode stack: autograd runs a CUDA backward on a thread
#: of its own, whose kernels are charged too.
COUNTERS: List = []


#: Where a kernel without a backward gets one, named when it refuses; the
#: others refuse naming ROADMAP's divergence 19.
BACKWARD_ITEM: Dict[str, str] = {}


class NoBackward(NotImplementedError):
    """A kernel entry reached under grad with an input that requires grad,
    where the kernel has no backward: the call's engine is not at fault,
    so the resilience ladder re-raises it at once."""


def refuse_grad(name: str, *tensors) -> None:
    """Raise :class:`NoBackward` when grad is enabled and one of
    ``tensors`` requires grad: the kernel ``name`` has no backward here,
    and its output would silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        where = BACKWARD_ITEM.get(name, "ROADMAP, divergence 19")
        raise NoBackward(
            f"{name} on the card has no backward: under grad its output would carry no "
            f"gradient ({where}); run under torch.no_grad(), or differentiate a route "
            "that has one (kernels.flash_attention.flash_attention, "
            "kernels.slstm_scan.slstm_scan, core.spectral.fourier_mixing)"
        )


def charge(name: str, cost: Callable[..., Cost], *args, **kwargs) -> None:
    """Hand every counter in :data:`COUNTERS` the kernel ``name``'s
    ``cost(*args, **kwargs)``; where none is in force, nothing is computed."""
    if not COUNTERS:
        return
    work = cost(*args, **kwargs)
    for counter in COUNTERS:
        counter.charge_kernel(name, work)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(entry: str, name: str, x: torch.Tensor, *args) -> None:
    """Call the C entry ``entry`` with ``args``, then ``x``'s device and
    current stream; raise on any CUDA error the launch reports, else count
    one launch of ``name``. On a meta ``x`` nothing is launched or counted."""
    if x.device.type == "meta":
        return
    from repro_torch.kernels._build import library  # lazy: builds at first use

    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(library(), entry)(*args, x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
