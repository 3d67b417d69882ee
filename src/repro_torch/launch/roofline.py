"""Roofline terms for one NVIDIA H100 SXM (the card the port targets).

  compute    = flops_per_device / PEAK_FLOPS_FP32
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / NVLINK_BW

Port of the ``Roofline`` dataclass of ``repro.launch.roofline`` (the terms
the planner reads), with the H100's own terms in place of the TPU's. The rates assume the card's full
700 W power limit; a card set lower runs slower under load.
"""

from __future__ import annotations

import dataclasses

#: float32 outside the tensor cores, dense (NVIDIA H100 SXM data sheet).
PEAK_FLOPS_FP32 = 67e12
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

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_FP32

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def step_time_s(self) -> float:
        """Roofline time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)
