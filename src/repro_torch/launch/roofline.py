"""Roofline terms for one NVIDIA H100 SXM (the card the port targets).

  compute    = flops_per_device / peak_flops
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / NVLINK_BW

plus MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (inference) and the
usefulness ratio MODEL_FLOPS / (counted flops × n_devices).

Port of ``repro.launch.roofline``, with the H100's own rates in place of
the TPU's. ``peak_flops`` is :data:`PEAK_FLOPS_FP32` by default (the
planner's FFT model, three terms given); the dry-run passes
:data:`PEAK_FLOPS_BF16`, the rate of the models' bf16 products. The rates
assume the card's full 700 W power limit; a card set lower runs slower
under load. Every figure here is a model at data-sheet rates, not a
measurement.
"""

from __future__ import annotations

import dataclasses
import math

#: float32 outside the tensor cores, dense (NVIDIA H100 SXM data sheet).
PEAK_FLOPS_FP32 = 67e12
#: BF16 on the tensor cores, dense (NVIDIA H100 SXM data sheet: 1,979
#: TFLOP/s with sparsity, half of it dense).
PEAK_FLOPS_BF16 = 989.5e12
#: HBM3 bandwidth, bytes/s (NVIDIA H100 SXM data sheet).
HBM_BW = 3.35e12
#: NVLink to the other cards of the host, each way, bytes/s (900 GB/s in
#: all; NVIDIA H100 SXM data sheet).
NVLINK_BW = 450e9
#: Shared memory, all SMs: 132 SMs x 128 bytes/clock x 1.98 GHz boost
#: (Hopper architecture white paper: SM count, per-SM shared-memory width
#: and the SXM5 boost clock).
SMEM_BW = 132 * 128 * 1.98e9


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int = 1
    model_flops_global: float = 0.0
    peak_flops: float = PEAK_FLOPS_FP32

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        t = self.step_time_s
        if t == 0:
            return 0.0
        return self.model_flops_global / (t * self.n_devices * self.peak_flops)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "n_devices": self.n_devices,
            "model_flops_global": self.model_flops_global,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_step_s": self.step_time_s,
            "mfu_at_roofline": self.mfu,
        }


def expert_param_count(skeleton) -> int:
    """Parameters living on an 'experts' logical axis."""
    from repro_torch.models.param import tree_leaves

    return sum(math.prod(d.shape) for d in tree_leaves(skeleton)
               if "experts" in d.logical_axes)


def model_flops(cfg, skeleton, kind: str, seq: int, batch: int) -> float:
    """6·N·D (train) / 2·N_active·D (prefill) / 2·N_active·B (decode)."""
    from repro_torch.models.param import param_count

    n = param_count(skeleton)
    if cfg.moe is not None:
        e_params = expert_param_count(skeleton)
        active_frac = cfg.moe.top_k / cfg.moe.n_experts
        n = n - e_params + e_params * active_frac
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch  # decode: one token per request
