"""ModelConfig — every assigned architecture is an instance of this.

Port of ``repro.models.config``: the same dataclasses, field for field
(plain data; later slices read every field)."""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm", "spectral"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    n_shared_experts: int = 0
    n_dense_layers: int = 0          # leading layers that stay dense
    router_norm: Literal["softmax", "sigmoid"] = "softmax"
    capacity_factor: float = 1.25
    impl: Literal["grouped_local", "ep_a2a", "dense_small"] = "grouped_local"
    ep_axes: tuple = ()                  # mesh axes for expert parallelism
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    seq_pad_to_pow2: bool = False        # spectral archs need pow-2 seq
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    attention: Literal["gqa", "mla", "none"] = "gqa"
    sliding_window: int | None = None    # SWA (mixtral)
    tie_embeddings: bool = False
    act: Literal["swiglu", "gelu"] = "swiglu"
    # encoder-decoder (audio family)
    n_enc_layers: int = 0
    enc_frames: int = 1500               # whisper 30 s encoder length
    # hybrid (zamba2): shared attention block every k SSM layers
    shared_attn_every: int = 6
    # xLSTM: alternate mLSTM/sLSTM
    slstm_every: int = 2                 # every k-th block is sLSTM
    # vlm: number of patch-embedding positions provided by the stub frontend
    n_patches: int = 256
    # spectral (fourier_lm): use the paper's engine as the mixing layer
    # ("auto" = the repro_torch.plan-backed unified default; see repro_torch.xfft)
    fft_variant: str = "auto"
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # training-time knobs
    remat: bool = True
    remat_policy: Literal["full", "dots"] = "full"  # "dots": save matmul outputs
    scan_layers: bool = True
    attn_block_q: int = 512
    attn_block_k: int = 1024
    compute_dtype: str = "bfloat16"
    # long_500k eligibility (sub-quadratic sequence mixing)
    subquadratic: bool = False
    # deepseek-v3 multi-token prediction head
    mtp: bool = False
    mtp_weight: float = 0.3

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **overrides)
