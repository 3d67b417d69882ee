"""``reference_x64`` — the double-precision engine.

Port of ``repro.engines.x64``. The reference runs ``jnp.fft`` under
``jax.enable_x64``; the port calls no library FFT, so this engine runs the
port's own radix-2 Stockham schedules (``repro_torch.core``, the plain
panel of ``kernels.fft_radix2.fft_fused_plain``) at complex128, with
twiddles computed in float64, on the tensor's device: the input is cast to
complex128 (float64 for a real transform's input) and every stage, the
accumulation and the output stay there.

It registers with ``precisions=("double",)`` only, so the planner proposes
it exactly when a scope asks for ``xfft.config(precision="double")`` and
never lets it into a single-precision plan. It is the only double engine,
on the CPU and on the card alike: a double key on a CUDA tensor plans it
(``plan.autotune.variant_candidates``), and it launches no single-precision
kernel. ``reliable`` marks it, as in the reference, the double ladder's
always-works rung. The reference's ``requires_x64`` has no counterpart:
PyTorch keeps 64-bit dtypes without a mode. Its ``fft2d_stream`` op is the
ping-pong pipeline of ``repro_torch.core.fft2d.fft2_stream`` on the same
schedules at complex128 (the reference's ``x64.py`` stream, forward only):
the row pass of frame t and the column pass of frame t-1 in one step, the
carried rows at complex128 too.
"""

from __future__ import annotations

import torch

from repro_torch.engines.builtin import _KINDS, _core_ops
from repro_torch.engines.registry import CostHints, EngineSpec, register_engine

register_engine(EngineSpec(
    name="reference_x64",
    backend="x64",
    kinds=_KINDS,
    precisions=("double",),
    dtypes=("complex128", "float64"),
    reliable=True,
    cost=CostHints(traffic_factor=4.0, stage_overhead_s=0.8e-6),
    ops=_core_ops("stockham", dtype=torch.complex128),
))
