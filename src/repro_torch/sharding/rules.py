"""Logical-axis sharding rules (MaxText-style), per config and mesh.

Port of ``repro.sharding.rules``; the specs are ``repro_torch.compat``'s
``PartitionSpec`` (``to_placements`` turns one into
``torch.distributed.tensor`` placements on a mesh).

Strategy (the reference's):
  * DP/FSDP over ("pod","data") — params' "embed" axis sharded over data,
    gathered per layer (ZeRO-3-style).
  * TP over "model" — MLP hidden, vocab, attention heads (only when the head
    count divides the model-axis size; otherwise attention weights stay
    FSDP-only and attention compute is batch-sharded — "hybrid TP").
  * EP: experts' hidden is TP'd; expert weights are FSDP'd (the ep_a2a MoE
    path re-shards tokens instead).
  * SP: long-context decode shards the KV/state sequence dim over "model"
    (and over every axis for the 500k single-request cell).

The port's data-parallel launcher (``launch/train.py --distributed``)
replicates the parameters and uses :func:`batch_specs` only (ROADMAP,
divergence 21).
"""

from __future__ import annotations

from typing import Any

from repro_torch.compat import P
from repro_torch.models.config import ModelConfig

__all__ = ["batch_specs", "cache_specs", "dp_axes", "param_rules", "use_tp"]


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def use_tp(cfg: ModelConfig, model_size: int = 16) -> bool:
    """TP strategy selector: archs whose head count doesn't divide the model
    axis (llama/starcoder2 24H, xlstm 4H) run pure 2-D batch FSDP
    instead."""
    return cfg.n_heads % model_size == 0


def param_rules(cfg: ModelConfig, *, multi_pod: bool, model_size: int = 16) -> dict:
    dp = dp_axes(multi_pod)
    tp = use_tp(cfg, model_size)
    ep = cfg.moe is not None and cfg.moe.impl == "ep_a2a"
    return {
        "embed": dp,                        # FSDP
        "vocab": "model" if tp and cfg.vocab % model_size == 0 else None,
        "mlp": "model" if tp else None,
        "heads": "model" if tp else None,
        "kv_heads": None,                   # KV heads replicated across TP
        "head_dim": None,
        # expert-parallel: experts sharded over cfg.moe.ep_axes (tokens travel
        # by all_to_all; the expert FFN hidden is not TP'd: the spec's
        # first-use rule drops "model" from it when ep_axes use it)
        "experts": tuple(cfg.moe.ep_axes) if ep else None,
        "q_lora": None,
        "kv_lora": None,
        "ssm_in": "model" if tp else None,
        "layers": None,                     # the stacked layer dim is never sharded
    }


def batch_specs(cfg: ModelConfig, kind: str, *, multi_pod: bool,
                batch: int | None = None) -> dict:
    """PartitionSpecs for the input batch of a train/prefill/decode step."""
    dp = dp_axes(multi_pod)
    n_dp = 32 if multi_pod else 16
    if batch is not None and batch % n_dp != 0:
        dp = None  # batch-1 long-context cell: replicate batch, SP the cache
    if kind == "decode":
        return {"token": P(dp, None), "pos": P()}
    specs: dict[str, Any] = {"tokens": P(dp, None)}
    if cfg.family == "audio":
        specs["frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        specs["patches"] = P(dp, None, None)
    if cfg.family == "spectral":
        specs["targets"] = P(dp, None)
        specs["mlm_mask"] = P(dp, None)
    return specs


def _seq_axes(batch: int, multi_pod: bool, model_size: int):
    """How to shard a cache's sequence dim: across "model" normally; across
    EVERYTHING when the whole cell has batch 1 (long-context SP)."""
    if batch == 1:
        return ("pod", "data", "model") if multi_pod else ("data", "model")
    return ("model",)


def _spec_for(keys: list, shape: tuple, bspec, seq_ax, heads_ok: bool, model_size: int):
    name = next((k for k in reversed(keys) if isinstance(k, str)), None)
    nd = len(shape)
    if "slstm" in keys:
        # the sequential recurrence distributes over batch only
        return P(*([None, bspec] + [None] * (nd - 2)))
    if name in ("k", "v"):            # (L, B, S, KV, Dh)
        return P(None, bspec, seq_ax, None, None)
    if name in ("cross_k", "cross_v"):  # (L, B, T, H, Dh)
        return P(None, bspec, None, "model" if heads_ok else None, None)
    if name == "c_kv":                # (L, B, S, r)
        return P(None, bspec, seq_ax, None)
    if name == "k_rope":              # (L, B, S, dr)
        return P(None, bspec, seq_ax, None)
    if name == "slot_pos":            # (L, S) or (S,)
        return P(*([None] * (nd - 1)), seq_ax)
    if name == "ssd":                 # (L, B, H, P, N)
        return P(None, bspec, "model" if shape[2] % model_size == 0 else None, None, None)
    if name == "c" and nd == 5:       # mLSTM matrix memory (L, B, H, dk, dv)
        return P(None, bspec, None, "model" if shape[3] % model_size == 0 else None, None)
    # generic recurrent-state fallback (conv, sLSTM vectors, mLSTM n/m):
    # batch dim -> dp, last dim -> model when divisible.
    if nd >= 3:
        last = "model" if shape[-1] % model_size == 0 else None
        return P(None, bspec, *([None] * (nd - 3)), last)
    return P(*([None] * nd))


def cache_specs(cfg: ModelConfig, cache_tree: Any, batch: int, *, multi_pod: bool,
                model_size: int = 16) -> Any:
    """Name-based PartitionSpecs for every cache leaf (KV, ring, MLA latent,
    SSM/xLSTM state), in ``cache_tree``'s structure: each leaf is named by
    the last string key on its path, as the reference names a pytree leaf
    by its last dict key. Leaves start with a leading stacked-layer dim."""
    dp = dp_axes(multi_pod)
    bspec = dp if batch > 1 else None
    seq_ax = _seq_axes(batch, multi_pod, model_size)
    heads_ok = cfg.n_heads % model_size == 0

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, keys + [i]) for i, v in enumerate(tree))
        return _spec_for(keys, tuple(tree.shape), bspec, seq_ax, heads_ok, model_size)

    return walk(cache_tree, [])
