"""Architecture registry + assigned input shapes + input specs.

Port of ``repro.configs.registry``; ``input_specs`` gives ``meta`` tensors
where the reference gives ShapeDtypeStructs.

Shapes (assignment):
  train_4k      seq_len=4096   global_batch=256   (training)
  prefill_32k   seq_len=32768  global_batch=32    (inference-prefill)
  decode_32k    seq_len=32768  global_batch=128   (one token, KV=seq_len)
  long_500k     seq_len=524288 global_batch=1     (one token; sub-quadratic only)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.models.config import MLAConfig, ModelConfig, SSMConfig

_MODULES = {
    "whisper-medium": "whisper_medium",
    "starcoder2-3b": "starcoder2_3b",
    "llama3.2-3b": "llama3_2_3b",
    "glm4-9b": "glm4_9b",
    "stablelm-12b": "stablelm_12b",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-350m": "xlstm_350m",
    "internvl2-76b": "internvl2_76b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mixtral-8x22b": "mixtral_8x22b",
    "fourier_lm": "fourier_lm",
}

ARCH_IDS = [k for k in _MODULES if k != "fourier_lm"]  # the 10 assigned
ALL_IDS = list(_MODULES)

SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def shape_skips(cfg: ModelConfig, shape: str) -> str | None:
    """Returns a skip reason or None (assignment skip policy)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return "pure full attention — long_500k needs sub-quadratic mixing (DESIGN.md §6)"
    if shape in ("decode_32k", "long_500k") and cfg.family == "spectral":
        return "encoder-style MLM (bidirectional FNet mixing) — no causal decode step"
    return None


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (one step, no NaNs)."""
    cfg = get_config(arch)
    common = dict(
        vocab=512,
        rope_theta=10000.0,
        attn_block_q=16,
        attn_block_k=16,
        remat=False,
        compute_dtype="float32",
    )
    if cfg.family == "audio":
        return cfg.scaled(
            n_layers=2, n_enc_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
            d_ff=64, enc_frames=8, **common,
        )
    if cfg.family == "vlm":
        return cfg.scaled(
            n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            n_patches=4, **common,
        )
    if cfg.family == "hybrid":
        return cfg.scaled(
            n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
            shared_attn_every=2,
            ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=8, chunk=8),
            **common,
        )
    if cfg.family == "ssm":
        return cfg.scaled(n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, d_ff=0, **common)
    if cfg.family == "moe":
        moe = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
            n_dense_layers=min(cfg.moe.n_dense_layers, 1), capacity_factor=2.0,
        )
        extra: dict[str, Any] = {"moe": moe}
        if cfg.attention == "mla":
            extra["mla"] = MLAConfig(
                q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=8,
            )
        if cfg.sliding_window:
            extra["sliding_window"] = 8
        return cfg.scaled(
            n_layers=3, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, **extra, **common,
        )
    if cfg.family == "spectral":
        return cfg.scaled(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, **common)
    # dense
    return cfg.scaled(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        head_dim=8, **common,
    )


def input_specs(
    cfg: ModelConfig,
    shape: str,
    *,
    seq: int | None = None,
    batch: int | None = None,
) -> dict[str, Any]:
    """``meta`` tensor stand-ins for every model input of a (arch × shape)
    cell — shapes and dtypes, zero allocation.

    For train/prefill: the batch dict. For decode: {"token", "pos"} (caches
    are built separately by the cache initialiser).
    """
    info = SHAPES[shape]
    s = seq if seq is not None else info["seq"]
    b = batch if batch is not None else info["batch"]
    kind = info["kind"]
    i32 = torch.int32
    f32 = torch.float32

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "decode":
        return {
            "token": spec((b, 1), i32),
            "pos": spec((), i32),
        }

    specs: dict[str, Any] = {}
    if cfg.family == "audio":
        specs["tokens"] = spec((b, s), i32)
        specs["frames"] = spec((b, cfg.enc_frames, cfg.d_model), f32)
    elif cfg.family == "vlm":
        specs["tokens"] = spec((b, s - cfg.n_patches), i32)
        specs["patches"] = spec((b, cfg.n_patches, cfg.d_model), f32)
    elif cfg.family == "spectral":
        specs["tokens"] = spec((b, s), i32)
        specs["targets"] = spec((b, s), i32)
        specs["mlm_mask"] = spec((b, s), f32)
    else:
        specs["tokens"] = spec((b, s), i32)
    return specs
