"""Model stacks, assembled from the component layers.

Port of ``repro.models.transformer``, the dense part: the pre-norm GQA
decoder (dense and vlm families; vlm prepends the stub frontend's patch
embeddings). Layer weights are stacked along a leading layer axis, as in
the reference, whose ``lax.scan`` over them becomes a loop over the layer
index here; a stacked cache is walked the same way, each layer writing
into its slice.

The moe block, ``mtp_logits`` and the hybrid, xlstm, encoder-decoder and
spectral stacks come with their slices (ROADMAP, queue 1, item 12).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed,
    embedding_skel,
    mlp,
    mlp_skel,
    rmsnorm,
    rmsnorm_skel,
    unembed,
    unembed_skel,
)
from repro_torch.models.param import stack_skeleton, tree_map

__all__ = [
    "decoder_block_apply",
    "decoder_block_skel",
    "lm_forward",
    "lm_init_cache",
    "lm_skel",
]


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the moe block is not ported yet (ROADMAP, queue 1, item 12 (c))"
        )
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention} attention is not ported yet "
            "(ROADMAP, queue 1, item 12 (c))"
        )
    if cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: the multi-token prediction head is not ported yet "
            "(ROADMAP, queue 1, item 12 (c))"
        )


# ------------------------- decoder block (dense) -------------------------

def decoder_block_skel(cfg: ModelConfig, use_moe: bool = False) -> dict:
    if use_moe:
        raise NotImplementedError(
            f"{cfg.name}: the moe block is not ported yet (ROADMAP, queue 1, item 12 (c))"
        )
    _dense_only(cfg)
    return {
        "ln1": rmsnorm_skel(cfg.d_model),
        "ln2": rmsnorm_skel(cfg.d_model),
        "attn": attn.gqa_skel(cfg),
        "mlp": mlp_skel(cfg.d_model, cfg.d_ff, cfg.act),
    }


def decoder_block_apply(p, x, cfg: ModelConfig, *, positions, cache=None, decode=False,
                        pos=None):
    """Returns (x, new_cache, aux); aux is 0 (no moe)."""
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    a, new_cache = attn.gqa_apply(
        p["attn"], h, cfg, positions=positions, cache=cache, decode=decode, pos=pos
    )
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.rms_eps)
    f = mlp(p["mlp"], h, cfg.act)
    return x + f, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)


# ----------------------------- decoder-only LM -----------------------------

def lm_skel(cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    skel: dict[str, Any] = {
        "embed": embedding_skel(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_skel(cfg.d_model),
        "dense_layers": stack_skeleton(decoder_block_skel(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        skel["unembed"] = unembed_skel(cfg.vocab, cfg.d_model)
    return skel


def _logits(params, x, cfg):
    if cfg.tie_embeddings:
        table = params["embed"]["table"].to(x.dtype)
        return torch.matmul(x, table.t()).float()
    return unembed(params["unembed"], x)


def lm_forward(params, tokens, cfg: ModelConfig, *, pos0=0, caches=None, decode=False,
               prefill=False, prefix_embeds=None, return_hidden=False):
    """Shared forward for dense/vlm LMs.

    Returns (logits, new_caches, aux[, hidden]). ``prefix_embeds`` (B, P, D)
    is the vlm stub frontend's patch embeddings, prepended to the tokens.
    ``pos0`` is an int or a 0-d tensor; ``caches`` are written in place and
    returned.
    """
    _dense_only(cfg)
    dt = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, dt)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    b, s, _ = x.shape
    pos0 = int(pos0)
    positions = (pos0 + torch.arange(s, dtype=torch.int32, device=x.device))[None, :]
    positions = positions.expand(b, s)

    layers = params["dense_layers"]
    stacked = caches["dense_layers"] if caches is not None else None
    for i in range(cfg.n_layers):
        c_l = tree_map(lambda t: t[i], stacked) if stacked is not None else None
        x, _, _ = decoder_block_apply(
            tree_map(lambda t: t[i], layers), x, cfg,
            positions=positions, cache=c_l, decode=decode, pos=pos0,
        )
    new_caches = {"dense_layers": stacked} if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    hidden = x
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = _logits(params, x, cfg)
    if return_hidden:
        return logits, new_caches, aux_total, hidden
    return logits, new_caches, aux_total


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Empty stacked caches: every layer's ``make_cache`` along a leading
    layer axis."""
    _dense_only(cfg)
    one = attn.make_cache(cfg, batch, max_len, dtype, device)
    return {"dense_layers": tree_map(
        lambda a: a.unsqueeze(0).repeat(cfg.n_layers, *([1] * a.dim())), one
    )}
