"""Model stacks, assembled from the component layers.

Port of ``repro.models.transformer``: the pre-norm decoder (dense and vlm
families with GQA; vlm prepends the stub frontend's patch embeddings; the
moe family with GQA or MLA attention and the MoE FFN after its leading
dense layers, and deepseek's multi-token prediction head), the
hybrid stack (zamba2: Mamba2 layers with one shared attention block
re-invoked every k layers), the xLSTM stack (alternating mLSTM and sLSTM
blocks), the encoder-decoder (audio: whisper's encoder over precomputed
frame embeddings, a decoder with self- and cross-attention) and the
spectral stack (fourier_lm: FNet blocks whose token mixing is Re(FFT2)
through ``repro_torch.core.spectral.fourier_mixing``). Layer weights are
stacked along a leading layer axis, as in the reference, whose
``lax.scan`` over them becomes a loop over the layers here, each leaf
unbound once (``param.unstack``); a stacked cache is walked by index, each
layer writing its new cache or state into its slice, a view of the
stacked tensors.

Remat: where the reference wraps its scanned block in ``jax.checkpoint``
(``cfg.remat``; ``_maybe_remat``), :func:`_remat` wraps the same block in
``torch.utils.checkpoint`` (non-reentrant): ``remat_policy="full"`` keeps
only the block's inputs and runs its forward again in the backward;
``"dots"`` also keeps the outputs of the matrix products without batch
dimensions (``aten.mm`` / ``addmm``, as ``dots_with_no_batch_dims_saveable``
keeps ``dot_general``'s). It applies only to a forward without caches run
while grad is enabled: serving and every call under ``no_grad`` run the
blocks as they are.
"""

from __future__ import annotations

from typing import Any

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.spectral import fourier_mixing
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
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
from repro_torch.models.param import (
    ParamDef,
    _device,
    stack_skeleton,
    tree_leaves,
    tree_map,
    unstack,
)

__all__ = [
    "decoder_block_apply",
    "decoder_block_skel",
    "encdec_block_apply",
    "encdec_forward",
    "encdec_init_cache",
    "encdec_skel",
    "encoder_block_apply",
    "encoder_forward",
    "hybrid_forward",
    "hybrid_init_cache",
    "hybrid_skel",
    "lm_forward",
    "lm_init_cache",
    "lm_skel",
    "mtp_logits",
    "rmsnorm_like",
    "shared_block_apply",
    "spectral_block_apply",
    "spectral_forward",
    "spectral_skel",
    "xlstm_forward",
    "xlstm_init_cache",
    "xlstm_pair_apply",
    "xlstm_skel",
]


# ----------------------------------- remat -----------------------------------

def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep matrix products without batch dims."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig, caches=None):
    """``fn`` under activation checkpointing per ``cfg.remat`` /
    ``cfg.remat_policy`` (the reference's ``_maybe_remat``) when grad is
    enabled and the forward carries no caches; else ``fn`` itself."""
    if not cfg.remat or caches is not None or not torch.is_grad_enabled():
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, **kw)


# ------------------------- decoder block (dense/moe) -------------------------

def decoder_block_skel(cfg: ModelConfig, use_moe: bool = False) -> dict:
    skel = {
        "ln1": rmsnorm_skel(cfg.d_model),
        "ln2": rmsnorm_skel(cfg.d_model),
        "attn": attn.mla_skel(cfg) if cfg.attention == "mla" else attn.gqa_skel(cfg),
    }
    if use_moe:
        skel["moe"] = moe_mod.moe_skel(cfg)
    else:
        skel["mlp"] = mlp_skel(cfg.d_model, cfg.d_ff, cfg.act)
    return skel


def decoder_block_apply(p, x, cfg: ModelConfig, *, positions, cache=None, decode=False,
                        pos=None):
    """Returns (x, new_cache, aux); aux is the moe block's router loss (0
    without one)."""
    h = rmsnorm(p["ln1"], x, cfg.rms_eps)
    apply = attn.mla_apply if cfg.attention == "mla" else attn.gqa_apply
    a, new_cache = apply(p["attn"], h, cfg, positions=positions, cache=cache, decode=decode,
                         pos=pos)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.rms_eps)
    if "moe" in p:
        f, aux = moe_mod.moe_apply(p["moe"], h, cfg)
    else:
        f, aux = mlp(p["mlp"], h, cfg.act), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, new_cache, aux


# ----------------------------- decoder-only LM -----------------------------

def _stacks(cfg: ModelConfig):
    """(name, layers, use_moe) of the decoder's stacks that hold layers: the
    leading dense layers, then the moe layers."""
    n_dense = min(cfg.moe.n_dense_layers if cfg.moe else cfg.n_layers, cfg.n_layers)
    n_moe = cfg.n_layers - n_dense if cfg.moe else 0
    return [(name, n, use_moe) for name, n, use_moe in (("dense_layers", n_dense, False),
                                                         ("moe_layers", n_moe, True)) if n]


def lm_skel(cfg: ModelConfig) -> dict:
    skel: dict[str, Any] = {
        "embed": embedding_skel(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_skel(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        skel["unembed"] = unembed_skel(cfg.vocab, cfg.d_model)
    for name, n, use_moe in _stacks(cfg):
        skel[name] = stack_skeleton(decoder_block_skel(cfg, use_moe), n)
    if cfg.mtp:
        skel["mtp"] = {
            "norm_h": rmsnorm_skel(cfg.d_model),
            "norm_e": rmsnorm_skel(cfg.d_model),
            "proj": {
                "down": ParamDef((2 * cfg.d_model, cfg.d_model), ("mlp", "embed"))
            },
            "block": decoder_block_skel(cfg, use_moe=False),
        }
    return skel


def _logits(params, x, cfg):
    if cfg.tie_embeddings:
        table = params["embed"]["table"].to(x.dtype)
        return torch.matmul(x, table.t()).float()
    return unembed(params["unembed"], x)


def lm_forward(params, tokens, cfg: ModelConfig, *, pos0=0, caches=None, decode=False,
               prefill=False, prefix_embeds=None, return_hidden=False):
    """Shared forward for dense/moe/vlm LMs.

    Returns (logits, new_caches, aux[, hidden]); aux sums the moe layers'
    router losses. ``prefix_embeds`` (B, P, D) is the vlm stub frontend's
    patch embeddings, prepended to the tokens. ``pos0`` is an int or a 0-d
    tensor; ``caches`` are written in place and returned.
    """
    dt = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, dt)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    b, s, _ = x.shape
    pos0 = int(pos0)
    positions = (pos0 + torch.arange(s, dtype=torch.int32, device=x.device))[None, :]
    positions = positions.expand(b, s)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(decoder_block_apply, cfg, caches)
    for name, n, _ in _stacks(cfg):
        layers = unstack(params[name], n)
        stacked = caches[name] if caches is not None else None
        for i in range(n):
            c_l = tree_map(lambda t: t[i], stacked) if stacked is not None else None
            x, _, aux = block(
                layers[i], x, cfg,
                positions=positions, cache=c_l, decode=decode, pos=pos0,
            )
            aux_total = aux_total + aux

    hidden = x
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = _logits(params, x, cfg)
    if return_hidden:
        return logits, caches, aux_total, hidden
    return logits, caches, aux_total


def mtp_logits(params, hidden, tokens, cfg: ModelConfig):
    """DeepSeek-V3 multi-token prediction: predict t+2 from (h_t, emb_{t+1}).

    hidden: (B, S, D) pre-final-norm states. Returns logits (B, S-1, V)
    aligned so position t predicts tokens[t+2]. The block runs without a
    cache, positions from 0 (its prefill attention is ``flash_attention``:
    on the card one ``flash_attention_fwd``).
    """
    dt = getattr(torch, cfg.compute_dtype)
    p = params["mtp"]
    h = rmsnorm(p["norm_h"], hidden[:, :-1], cfg.rms_eps)
    e = rmsnorm(p["norm_e"], embed(params["embed"], tokens[:, 1:], dt), cfg.rms_eps)
    x = torch.matmul(torch.cat([h, e], dim=-1), p["proj"]["down"].to(dt))
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    x, _, _ = decoder_block_apply(p["block"], x, cfg, positions=positions)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return _logits(params, x, cfg)


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Empty stacked caches: every layer's ``make_cache`` (``make_mla_cache``
    under MLA) along a leading layer axis, one stack for the dense layers
    and one for the moe layers."""
    make = attn.make_mla_cache if cfg.attention == "mla" else attn.make_cache
    return {name: _stacked(make(cfg, batch, max_len, dtype, device), n)
            for name, n, _ in _stacks(cfg)}


def _stacked(one: dict, n: int) -> dict:
    """``n`` copies of a layer's cache along a leading layer axis."""
    return tree_map(lambda a: a.unsqueeze(0).repeat(n, *([1] * a.dim())), one)


def _write(slot: dict, new: dict) -> None:
    """Copy a block's new state into its slice of the stacked cache."""
    for dst, src in zip(tree_leaves(slot), tree_leaves(new)):
        dst.copy_(src)


# ------------------------------ hybrid (zamba2) ------------------------------

def hybrid_skel(cfg: ModelConfig) -> dict:
    """Mamba2 stack + ONE shared attention/MLP block over concat(x, x0)."""
    shared_cfg = _shared_block_cfg(cfg)
    return {
        "embed": embedding_skel(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_skel(cfg.d_model),
        "unembed": unembed_skel(cfg.vocab, cfg.d_model),
        "mamba_layers": stack_skeleton(ssm_mod.mamba2_skel(cfg), cfg.n_layers),
        "shared": {
            "ln1": rmsnorm_skel(shared_cfg.d_model),
            "attn": attn.gqa_skel(shared_cfg),
            "ln2": rmsnorm_skel(shared_cfg.d_model),
            "mlp": mlp_skel(shared_cfg.d_model, cfg.d_ff, cfg.act),
            "proj": {
                "down": ParamDef((shared_cfg.d_model, cfg.d_model), ("mlp", "embed"))
            },
        },
    }


def _shared_block_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        d_model=2 * cfg.d_model,
        head_dim=2 * cfg.d_model // cfg.n_heads,
        attention="gqa",
    )


def _n_shared_invocations(cfg: ModelConfig) -> int:
    return max(1, cfg.n_layers // cfg.shared_attn_every)


def shared_block_apply(p: dict, x, x0, cfg: ModelConfig, *, positions, cache=None,
                       decode: bool = False, pos: int = 0):
    """zamba2's shared attention/MLP block on concat(x, x0), projected back
    to d_model and added to x. ``cache`` is this invocation's KV cache,
    written in place."""
    xa = torch.cat([x, x0], dim=-1)
    h = rmsnorm(p["ln1"], xa, cfg.rms_eps)
    a_out, _ = attn.gqa_apply(p["attn"], h, _shared_block_cfg(cfg), positions=positions,
                              cache=cache, decode=decode, pos=pos)
    xa = xa + a_out
    xa = xa + mlp(p["mlp"], rmsnorm(p["ln2"], xa, cfg.rms_eps), cfg.act)
    return x + torch.matmul(xa, p["proj"]["down"].to(x.dtype))


def hybrid_forward(params, tokens, cfg: ModelConfig, *, pos0=0, caches=None, decode=False,
                   **_):
    """Returns (logits, caches, aux). Each group of ``n_layers // n_inv``
    Mamba2 layers is followed by the shared block on concat(x, x0), x0 the
    token embeddings; its prefill attention is ``gqa_apply``'s (on the card
    ``flash_attention_fwd``). As in the reference, layers past
    ``n_inv * group`` are not run."""
    dt = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, dt)
    x0 = x  # the embeddings, re-fed to every shared-block invocation
    b, s, _ = x.shape
    pos0 = int(pos0)
    positions = (pos0 + torch.arange(s, dtype=torch.int32, device=x.device))[None, :]
    positions = positions.expand(b, s)

    n_inv = _n_shared_invocations(cfg)
    group = cfg.n_layers // n_inv
    layers = unstack(params["mamba_layers"], cfg.n_layers)
    mamba = _remat(ssm_mod.mamba2_apply, cfg, caches)
    for gi in range(n_inv):
        for i in range(gi * group, (gi + 1) * group):
            st = tree_map(lambda t: t[i], caches["mamba"]) if caches is not None else None
            x, st_new = mamba(layers[i], x, cfg, state=st, decode=decode)
            if st is not None:
                _write(st, st_new)

        # the shared block, its weights reused every invocation
        c_sh = tree_map(lambda t: t[gi], caches["shared"]) if caches is not None else None
        x = shared_block_apply(params["shared"], x, x0, cfg, positions=positions, cache=c_sh,
                               decode=decode, pos=pos0)

    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return (unembed(params["unembed"], x), caches,
            torch.zeros((), dtype=torch.float32, device=x.device))


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """Float32 Mamba2 states for every layer, and a KV cache in ``dtype``
    for every shared-block invocation."""
    device = _device(device)
    return {
        "mamba": _stacked(ssm_mod.mamba2_state(cfg, batch, device=device), cfg.n_layers),
        "shared": _stacked(attn.make_cache(_shared_block_cfg(cfg), batch, max_len, dtype,
                                           device), _n_shared_invocations(cfg)),
    }


# -------------------------------- ssm (xlstm) --------------------------------

def xlstm_skel(cfg: ModelConfig) -> dict:
    n_pairs = cfg.n_layers // 2
    return {
        "embed": embedding_skel(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_skel(cfg.d_model),
        "unembed": unembed_skel(cfg.vocab, cfg.d_model),
        "mlstm_layers": stack_skeleton(xlstm_mod.mlstm_skel(cfg), n_pairs),
        "slstm_layers": stack_skeleton(xlstm_mod.slstm_skel(cfg), n_pairs),
    }


def xlstm_forward(params, tokens, cfg: ModelConfig, *, pos0=0, caches=None, decode=False,
                  **_):
    """Returns (logits, caches, aux): the (mLSTM, sLSTM) pairs in turn,
    each block behind a parameter-free pre-norm and a residual."""
    dt = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, dt)
    pair = _remat(xlstm_pair_apply, cfg, caches)
    n_pairs = cfg.n_layers // 2
    mlstm = unstack(params["mlstm_layers"], n_pairs)
    slstm = unstack(params["slstm_layers"], n_pairs)
    for i in range(n_pairs):
        cm = tree_map(lambda t: t[i], caches["mlstm"]) if caches is not None else None
        cs = tree_map(lambda t: t[i], caches["slstm"]) if caches is not None else None
        x, sm, ss = pair(mlstm[i], slstm[i], x, cfg, cm=cm, cs=cs, decode=decode)
        if caches is not None:
            _write(cm, sm)
            _write(cs, ss)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return (unembed(params["unembed"], x), caches,
            torch.zeros((), dtype=torch.float32, device=x.device))


def xlstm_pair_apply(pm, ps, x, cfg: ModelConfig, *, cm=None, cs=None, decode=False):
    """One (mLSTM, sLSTM) pair, each behind a parameter-free pre-norm and a
    residual; returns (x, mLSTM state, sLSTM state)."""
    dm, sm = xlstm_mod.mlstm_apply(pm, rmsnorm_like(x, cfg), cfg, state=cm, decode=decode)
    x = x + dm
    ds, ss = xlstm_mod.slstm_apply(ps, rmsnorm_like(x, cfg), cfg, state=cs, decode=decode)
    return x + ds, sm, ss


def rmsnorm_like(x, cfg: ModelConfig):
    """Parameter-free pre-norm inside the xLSTM residual blocks (the blocks
    carry their own learned norms)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + cfg.rms_eps).to(x.dtype)


def xlstm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
                     device=None):
    """Float32 mLSTM and sLSTM states for every pair, whatever ``dtype``
    (as the reference's), m at −inf."""
    device = _device(device)
    n_pairs = cfg.n_layers // 2
    return {
        "mlstm": _stacked(xlstm_mod.mlstm_state(cfg, batch, device=device), n_pairs),
        "slstm": _stacked(xlstm_mod.slstm_state(cfg, batch, device=device), n_pairs),
    }


# ------------------------------ audio (whisper) ------------------------------

def encdec_skel(cfg: ModelConfig) -> dict:
    enc_block = {
        "ln1": rmsnorm_skel(cfg.d_model),
        "attn": attn.gqa_skel(cfg),
        "ln2": rmsnorm_skel(cfg.d_model),
        "mlp": mlp_skel(cfg.d_model, cfg.d_ff, "gelu"),
    }
    dec_block = {
        "ln1": rmsnorm_skel(cfg.d_model),
        "attn": attn.gqa_skel(cfg),
        "lnx": rmsnorm_skel(cfg.d_model),
        "xattn": attn.cross_attn_skel(cfg),
        "ln2": rmsnorm_skel(cfg.d_model),
        "mlp": mlp_skel(cfg.d_model, cfg.d_ff, "gelu"),
    }
    return {
        "embed": embedding_skel(cfg.vocab, cfg.d_model),
        "enc_norm": rmsnorm_skel(cfg.d_model),
        "final_norm": rmsnorm_skel(cfg.d_model),
        "unembed": unembed_skel(cfg.vocab, cfg.d_model),
        "enc_layers": stack_skeleton(enc_block, cfg.n_enc_layers or cfg.n_layers),
        "dec_layers": stack_skeleton(dec_block, cfg.n_layers),
    }


def _positions(b: int, s: int, pos0: int, device):
    return (pos0 + torch.arange(s, dtype=torch.int32, device=device))[None, :].expand(b, s)


def encoder_forward(params, frames, cfg: ModelConfig):
    """frames: (B, T, D), the stub frontend's precomputed frame embeddings.
    Pre-norm blocks of full (non-causal) self-attention with RoPE over the
    T positions, then the encoder's final norm."""
    dt = getattr(torch, cfg.compute_dtype)
    x = frames.to(dt)
    b, t, _ = x.shape
    positions = _positions(b, t, 0, x.device)
    block = _remat(encoder_block_apply, cfg)
    for p_l in unstack(params["enc_layers"], cfg.n_enc_layers or cfg.n_layers):
        x = block(p_l, x, cfg, positions=positions)
    return rmsnorm(params["enc_norm"], x, cfg.rms_eps)


def encoder_block_apply(p, x, cfg: ModelConfig, *, positions):
    """One encoder block: pre-norm non-causal self-attention, then the MLP."""
    a, _ = attn.gqa_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.rms_eps), cfg,
                          positions=positions, causal=False)
    x = x + a
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps), "gelu")


def encdec_block_apply(p, x, cross, cfg: ModelConfig, *, positions, cache=None,
                       decode: bool = False, pos: int = 0):
    """One decoder block: pre-norm causal self-attention (``cache`` written
    in place), cross-attention over ``cross`` (the (k, v) pair or the
    encoder output), then the MLP."""
    a, _ = attn.gqa_apply(p["attn"], rmsnorm(p["ln1"], x, cfg.rms_eps), cfg,
                          positions=positions, cache=cache, decode=decode, pos=pos)
    x = x + a
    x = x + attn.cross_attn_apply(p["xattn"], rmsnorm(p["lnx"], x, cfg.rms_eps), cross, cfg)
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps), "gelu")


def _encdec_block_with_cross(p, x, enc_out, cfg: ModelConfig, *, positions):
    """A decoder block without a cache, its cross K/V computed from the
    encoder output inside it."""
    kv = attn.cross_kv(p["xattn"], enc_out, getattr(torch, cfg.compute_dtype))
    return encdec_block_apply(p, x, kv, cfg, positions=positions)


def _fit_cross(stacked: dict, frames: int) -> None:
    """Give the stacked cross K/V buffers ``frames`` positions: a prefill
    over another number of encoder frames than the cache was made for
    replaces them (in the caller's dict), as the reference's prefill
    returns cross K/V of any length."""
    for key in ("cross_k", "cross_v"):
        buf = stacked[key]
        if buf.shape[2] != frames:
            stacked[key] = buf.new_zeros((*buf.shape[:2], frames, *buf.shape[3:]))


def encdec_forward(params, tokens, cfg: ModelConfig, *, frames=None, enc_out=None, pos0=0,
                   caches=None, decode=False, **_):
    """Decoder forward; returns (logits, caches, aux). ``enc_out`` (or
    ``frames``, run through :func:`encoder_forward`) feeds every layer's
    cross-attention. With caches, a prefill writes each layer's cross K/V
    into them and a decode step reads them back, cast to the compute
    dtype: the buffers hold at least that precision (``encdec_init_cache``),
    so the round trip is exact and decode reads the values the
    reference's prefill returns (ROADMAP, divergence 16)."""
    dt = getattr(torch, cfg.compute_dtype)
    if enc_out is None and frames is not None:
        enc_out = encoder_forward(params, frames, cfg)
    x = embed(params["embed"], tokens, dt)
    b, s, _ = x.shape
    pos0 = int(pos0)
    positions = _positions(b, s, pos0, x.device)

    stacked = caches["dec"] if caches is not None else None
    if stacked is not None and not decode:
        _fit_cross(stacked, enc_out.shape[1])
    # Without caches (training) the block computes its cross K/V inside, one
    # remat unit as the reference's scanned body.
    block = _remat(_encdec_block_with_cross, cfg)
    for i, p_l in enumerate(unstack(params["dec_layers"], cfg.n_layers)):
        if stacked is None:
            x = block(p_l, x, enc_out, cfg, positions=positions)
            continue
        c_l = tree_map(lambda t: t[i], stacked)
        if decode:
            kx, vx = c_l["cross_k"].to(dt), c_l["cross_v"].to(dt)
        else:
            kx, vx = attn.cross_kv(p_l["xattn"], enc_out, dt)
            c_l["cross_k"].copy_(kx)
            c_l["cross_v"].copy_(vx)
        x = encdec_block_apply(p_l, x, (kx, vx), cfg, positions=positions, cache=c_l["self"],
                               decode=decode, pos=pos0)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return (unembed(params["unembed"], x), caches,
            torch.zeros((), dtype=torch.float32, device=x.device))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None):
    """Every decoder layer's self-attention KV cache in ``dtype`` and its
    cross K/V over ``cfg.enc_frames`` positions, zeros, along a leading
    layer axis. The cross K/V are held in the wider of ``dtype`` and the
    compute dtype (the reference's prefill returns them in the compute
    dtype whatever ``dtype`` is)."""
    device = _device(device)
    cross = torch.promote_types(dtype, getattr(torch, cfg.compute_dtype))
    shape = (batch, cfg.enc_frames, cfg.n_heads, cfg.resolved_head_dim)
    per_layer = {
        "self": attn.make_cache(cfg, batch, max_len, dtype, device),
        "cross_k": torch.zeros(shape, dtype=cross, device=device),
        "cross_v": torch.zeros(shape, dtype=cross, device=device),
    }
    return {"dec": _stacked(per_layer, cfg.n_layers)}


# ----------------------------- spectral (fourier) -----------------------------

def spectral_skel(cfg: ModelConfig) -> dict:
    block = {
        "ln1": rmsnorm_skel(cfg.d_model),
        "ln2": rmsnorm_skel(cfg.d_model),
        "mlp": mlp_skel(cfg.d_model, cfg.d_ff, "gelu"),
    }
    return {
        "embed": embedding_skel(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_skel(cfg.d_model),
        "unembed": unembed_skel(cfg.vocab, cfg.d_model),
        "layers": stack_skeleton(block, cfg.n_layers),
    }


def spectral_block_apply(p, x, cfg: ModelConfig):
    """One FNet block: pre-norm Re(FFT2) mixing, then the MLP."""
    x = x + fourier_mixing(rmsnorm(p["ln1"], x, cfg.rms_eps), variant=cfg.fft_variant)
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.rms_eps), "gelu")


def spectral_forward(params, tokens, cfg: ModelConfig, **_):
    """FNet-style encoder LM; returns (logits, None, aux). Each block's
    token mixing is Re(FFT2) over (seq, d_model) under ``cfg.fft_variant``
    (``"auto"`` plans it through ``repro_torch.xfft``: on the card the FFT
    kernels). Both axes must be powers of two: as in the reference, the
    sequence is not padded here (``seq_pad_to_pow2`` is the caller's)."""
    dt = getattr(torch, cfg.compute_dtype)
    x = embed(params["embed"], tokens, dt)
    block = _remat(spectral_block_apply, cfg)
    for p_l in unstack(params["layers"], cfg.n_layers):
        x = block(p_l, x, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return unembed(params["unembed"], x), None, torch.zeros((), dtype=torch.float32,
                                                             device=x.device)
