"""Attention: flash-style online softmax, GQA, and the KV caches.

Port of ``repro.models.attention``, the GQA part. Prefill attention is
:func:`flash_attention`:

* on a CUDA tensor it runs the hand-written kernel
  ``repro_torch.kernels.flash_attention.flash_attention_fwd`` in float32
  (query head h reads kv head h // g, laid out as (B·H, S, D); the result
  is cast back to the compute dtype), under grad inside the kernels'
  ``FlashAttention`` Function, whose backward launches
  ``flash_attention_bwd``; the group's repeat, the casts and the query's
  scale stay ordinary ops outside it, so autograd sums dK and dV over each
  group and casts them back. q is scaled in the compute dtype
  first, the reference's rounding step, and the kernel takes scale 1. The
  reference's model runs a jnp function in the compute dtype; the kernel
  computes the same function, keeping the softmax weights in float32
  where the reference rounds them to the compute dtype (ROADMAP,
  divergence 13). ``q_offset`` goes to the kernel: query row r sits at
  position ``q_offset + r``;
* on a CPU tensor it runs :func:`flash_attention_blocks`, a plain twin of
  the reference's function in the compute dtype, with its rounding steps
  (q scaled before the product, the weights ``p`` cast to v's dtype).

Decode scores one query against a cache with plain tensor ops, as the
reference's jnp ``decode_attention`` does: a dense buffer for full
attention, a ring buffer (size = window) for sliding-window attention.
Caches are written in place (:func:`_cache_insert`), where the reference
returns new arrays (ROADMAP, divergence 14).

Cross-attention (the audio family's decoder over the encoder output) runs
:func:`flash_attention` non-causally, in prefill and in every decode step
alike, as the reference's does: on the card each call launches
``flash_attention_fwd`` (ROADMAP, divergence 17).

MLA (DeepSeek's multi-head latent attention, the moe family): a prefill
expands the latent to per-head k (nope, with the one rope head broadcast
to every head) and v, and runs :func:`flash_attention` at D = nope + rope
against Dv (on the card ``flash_attention_fwd`` at 192 against 128); its
cache keeps the latent ``c_kv`` and the rope key only, and a decode step
is the reference's absorbed one in plain ops (the latent is never
expanded per head).

Context-parallel attention (:func:`flash_attention_cp`) runs under
``repro_torch.compat.shard_map``: each rank of the axis attends its slice
of the queries, at its own ``q_offset``, against every key, and the
slices are gathered. ``gqa_apply`` takes it where the activation-sharding
context names a context-parallel axis that the batch cannot fill
(``repro_torch.sharding.ctx.cp_axis_for``), as the reference does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch import compat
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.param import ParamDef, _device
from repro_torch.sharding.ctx import cp_axis_for

__all__ = [
    "NEG_INF",
    "cross_attn_apply",
    "cross_attn_skel",
    "cross_kv",
    "decode_attention",
    "flash_attention",
    "flash_attention_blocks",
    "flash_attention_cp",
    "gqa_apply",
    "gqa_from_heads",
    "gqa_qkv",
    "gqa_skel",
    "gqa_to_heads",
    "make_cache",
    "make_mla_cache",
    "mla_apply",
    "mla_qkv",
    "mla_skel",
]

NEG_INF = -1.0e30


# ------------------------- flash attention -------------------------

def gqa_to_heads(q, k, v):
    """(B, S, H, D) q and (B, S, KV, D) k, v as the kernel's (B·H, S, D)
    float32 operands: query head h reads kv head h // g."""
    b, _, h, _ = q.shape
    g = h // k.shape[2]

    def heads(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], x.shape[3]).float()

    return heads(q), heads(k.repeat_interleave(g, dim=2)), heads(v.repeat_interleave(g, dim=2))


def gqa_from_heads(out, b: int):
    """The kernel's (B·H, S, Dv) output as (B, S, H, Dv)."""
    bh, s, dv = out.shape
    return out.reshape(b, bh // b, s, dv).permute(0, 2, 1, 3)


def flash_attention_blocks(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                           q_offset: int = 0, block_q: int = 512, block_k: int = 1024):
    """The reference's ``flash_attention`` as plain tensor ops: an online
    softmax over its padded key blocks in the compute dtype, products
    accumulated in float32. Every query row runs the reference's recurrence
    (its query blocks only pad, and padded rows are cut), so all rows go at
    once."""
    b, sq0, h, dk = q.shape
    _, sk0, kv, _ = k.shape
    dv = v.shape[-1]
    g = h // kv
    block_k = min(block_k, sk0)
    # Padded k positions are masked out; no query padding is needed here.
    pad_k = (-sk0) % block_k
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    nk = (sk0 + pad_k) // block_k
    scale = 1.0 / math.sqrt(dk)
    dev = q.device

    qs = (q * scale).reshape(b, sq0, kv, g, dk).float()
    qpos = q_offset + torch.arange(sq0, device=dev)
    acc = torch.zeros(b, sq0, kv, g, dv, dtype=torch.float32, device=dev)
    m = torch.full((b, sq0, kv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(b, sq0, kv, g, dtype=torch.float32, device=dev)
    for j in range(nk):
        kj = k[:, j * block_k:(j + 1) * block_k]
        vj = v[:, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs, kj.float())
        kpos = j * block_k + torch.arange(block_k, device=dev)
        mask = (kpos[None, :] < sk0).expand(sq0, block_k)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vj.dtype).float(), vj.float()
        )
        m = m_new
    out = (acc / torch.clamp(l[..., None], min=1e-20)).to(q.dtype)
    return out.reshape(b, sq0, h, dv)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = 512, block_k: int = 1024):
    """q: (B, Sq, H, Dk); k: (B, Sk, KV, Dk); v: (B, Sk, KV, Dv). GQA via
    H = KV·g. A CUDA tensor launches ``flash_attention_fwd`` (under grad
    with ``flash_attention_bwd`` as its backward) or raises; a meta tensor
    (the dry-run) takes the same route and launches nothing; a CPU tensor
    runs :func:`flash_attention_blocks`, differentiated by autograd."""
    if q.device.type not in ("cuda", "meta"):
        return flash_attention_blocks(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, block_q=block_q, block_k=block_k)
    qs = q * (1.0 / math.sqrt(q.shape[-1]))  # rounded to the compute dtype, as the reference
    out = fa.flash_attention(*gqa_to_heads(qs, k, v), causal=causal, window=window,
                             block_q=block_q, block_k=block_k, scale=1.0, q_offset=q_offset)
    return gqa_from_heads(out, q.shape[0]).to(q.dtype)


def flash_attention_cp(q, k, v, axis: str, **kw):
    """Context-parallel flash attention: Q sequence-sharded over the mesh
    axis ``axis``, K and V whole (each rank attends its query slice,
    at ``q_offset = axis_index(axis) · Sq_loc``, against every key); the
    output is gathered back along the sequence. Under the ambient mesh of
    ``compat.set_mesh``; every rank of the mesh calls it with the same
    q, k, v."""
    P = compat.P
    mesh = compat.get_abstract_mesh()

    @functools.partial(compat.shard_map, mesh=mesh,
                       in_specs=(P(None, axis, None, None), P(), P()),
                       out_specs=P(None, axis, None, None), axis_names={axis})
    def run(q_loc, k_full, v_full):
        off = compat.axis_index(axis) * q_loc.shape[1]
        return flash_attention(q_loc, k_full, v_full, q_offset=off, **kw)

    return run(q, k, v)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos):
    """One-token attention over a cache buffer.

    q: (B, 1, H, Dk); caches (B, S, KV, D*); slot_pos (S,) giving the global
    position stored in each slot (−1 = empty) — valid for both dense caches
    (slot_pos = arange) and SWA ring caches (rotating slots). The products
    run in float32 on the operands as given (JAX promotes a bf16 query
    against a float32 cache to float32), the weights cast to the cache's
    dtype first, the result cast to q's dtype.
    """
    b, _, h, dk = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dk)
    qh = q.reshape(b, kv, g, dk) * scale
    s = torch.einsum("bhgd,bshd->bhgs", qh.float(), k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# ----------------------------- GQA layer -----------------------------

def gqa_skel(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, dh, d), ("heads", "head_dim", "embed")),
    }


def make_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Dense or ring (SWA) KV cache for one layer, empty (slot_pos −1), on
    ``device`` (default: the card)."""
    device = _device(device)
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, size, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, dh), dtype=dtype, device=device),
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def _cache_insert(cache: dict, k_new, v_new, pos: int):
    """Insert (B, S_new, KV, Dh) at global position ``pos`` (ring-aware),
    writing into the cache's tensors; returns the cache."""
    size = cache["k"].shape[1]
    s_new = k_new.shape[1]
    if s_new == 1:
        slot = pos % size
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][slot] = pos
    else:
        # prefill: keep the last ``size`` entries (ring) or all (dense)
        take = min(s_new, size)
        cache["k"][:, :take] = k_new[:, s_new - take:].to(cache["k"].dtype)
        cache["v"][:, :take] = v_new[:, s_new - take:].to(cache["v"].dtype)
        cache["slot_pos"][:take] = torch.arange(
            s_new - take, s_new, dtype=torch.int32, device=cache["slot_pos"].device
        )
    return cache


def _project(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def gqa_qkv(p: dict, x, cfg: ModelConfig, positions):
    """q (B, S, H, Dh), k, v (B, S, KV, Dh) of x (B, S, D), rotated."""
    dt = x.dtype
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def gqa_apply(p: dict, x, cfg: ModelConfig, *, positions, causal: bool = True,
              cache: dict | None = None, decode: bool = False, pos: Optional[int] = None):
    """Returns (out, new_cache). x: (B, S, D); positions (B, S). ``pos``,
    the first position, is read from ``positions`` where the caller does
    not give it (a host read of a card tensor)."""
    dt = x.dtype
    q, k, v = gqa_qkv(p, x, cfg, positions)
    new_cache = None
    if cache is not None and pos is None:
        pos = int(positions[0, 0]) if positions.ndim == 2 else int(positions[0])
    if decode:
        if cache is None:
            raise ValueError("gqa_apply: decode needs a cache")
        new_cache = _cache_insert(cache, k, v, pos)
        out = decode_attention(q, new_cache["k"], new_cache["v"], new_cache["slot_pos"], pos)
    else:
        opts = dict(causal=causal, window=cfg.sliding_window, block_q=cfg.attn_block_q,
                    block_k=cfg.attn_block_k)
        cp = cp_axis_for(q.shape[0], q.shape[1])
        if cp is not None and q.shape[1] == k.shape[1]:
            out = flash_attention_cp(q, k, v, cp, **opts)
        else:
            out = flash_attention(q, k, v, **opts)
        if cache is not None:
            new_cache = _cache_insert(cache, k, v, pos)
    h, dh, d = p["wo"].shape
    y = torch.matmul(out.reshape(*out.shape[:2], h * dh), p["wo"].to(dt).reshape(h * dh, d))
    return y, new_cache


# ------------------------- cross attention -------------------------

def cross_attn_skel(cfg: ModelConfig) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, h, dh), ("embed", "heads", "head_dim")),
        "wv": ParamDef((d, h, dh), ("embed", "heads", "head_dim")),
        "wo": ParamDef((h, dh, d), ("heads", "head_dim", "embed")),
    }


def _project_promoted(x, w, dt):
    """einsum("btd,dhk->bthk", x, w.astype(dt)) with JAX's promotion: the
    product runs in the wider of x's dtype and ``dt``."""
    pt = torch.promote_types(x.dtype, dt)
    return _project(x.to(pt), w.to(dt).to(pt))


def cross_attn_apply(p: dict, x, enc_kv, cfg: ModelConfig):
    """x: (B, S, D); enc_kv: precomputed (k, v), each (B, T, H, Dh), or the
    encoder output (B, T, D). Full (non-causal) attention over the T
    encoder positions through :func:`flash_attention`."""
    dt = x.dtype
    q = _project(x, p["wq"].to(dt))
    if isinstance(enc_kv, tuple):
        k, v = enc_kv
    else:
        k = _project_promoted(enc_kv, p["wk"], dt)
        v = _project_promoted(enc_kv, p["wv"], dt)
    out = flash_attention(q, k, v, causal=False, block_q=cfg.attn_block_q,
                          block_k=min(cfg.attn_block_k, k.shape[1]))
    h, dh, d = p["wo"].shape
    return torch.matmul(out.reshape(*out.shape[:2], h * dh), p["wo"].to(dt).reshape(h * dh, d))


def cross_kv(p: dict, enc_out, dtype):
    """The cross-attention's k, v (B, T, H, Dh) of the encoder output, in
    ``dtype``."""
    enc = enc_out.to(dtype)
    return _project(enc, p["wk"].to(dtype)), _project(enc, p["wv"].to(dtype))


# ------------------------------- MLA -------------------------------

def mla_skel(cfg: ModelConfig) -> dict:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": ParamDef((m.q_lora_rank,), ("q_lora",), init="ones"),
        "wq_b": ParamDef((m.q_lora_rank, h, dq), ("q_lora", "heads", "head_dim")),
        "wkv_a": ParamDef(
            (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora")
        ),
        "kv_norm": ParamDef((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "wk_b": ParamDef(
            (m.kv_lora_rank, h, m.qk_nope_head_dim), ("kv_lora", "heads", "head_dim")
        ),
        "wv_b": ParamDef(
            (m.kv_lora_rank, h, m.v_head_dim), ("kv_lora", "heads", "head_dim")
        ),
        "wo": ParamDef((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def make_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
    """One layer's latent cache, empty (slot_pos −1), on ``device``
    (default: the card): the normed latent ``c_kv`` and the rotated rope
    key, one head."""
    device = _device(device)
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "slot_pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def _mla_project(p: dict, x, cfg: ModelConfig, positions):
    """MLA's projections of x (B, S, D): q_nope, q_rope (B, S, H, *),
    rotated; the normed latent c_kv (B, S, r) and the rotated rope key
    (B, S, rope), one head. The latent norms are the reference's ``_rms``,
    which computes ``rmsnorm`` (eps 1e-5) with the weight given bare."""
    m: MLAConfig = cfg.mla
    dt = x.dtype
    nope = m.qk_nope_head_dim
    q = _project(rmsnorm({"scale": p["q_norm"]}, torch.matmul(x, p["wq_a"].to(dt))),
                 p["wq_b"].to(dt))
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv_full = torch.matmul(x, p["wkv_a"].to(dt))
    c_kv = rmsnorm({"scale": p["kv_norm"]}, ckv_full[..., :m.kv_lora_rank])
    k_rope = apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_qkv(p: dict, x, cfg: ModelConfig, positions):
    """The prefill's attention operands: q and k (B, S, H, nope + rope), the
    one rope key head broadcast to every head, and v (B, S, H, Dv), the
    latent expanded per head; also c_kv and k_rope, which the cache keeps."""
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, x, cfg, positions)
    dt = x.dtype
    b, s, _ = x.shape
    k_nope = _project(c_kv, p["wk_b"].to(dt))
    v = _project(c_kv, p["wv_b"].to(dt))
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, cfg.n_heads,
                                                             k_rope.shape[-1])], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k_full, v, c_kv, k_rope


def mla_apply(p: dict, x, cfg: ModelConfig, *, positions, cache: dict | None = None,
              decode: bool = False, pos: Optional[int] = None):
    """DeepSeek Multi-head Latent Attention. Returns (out, new_cache).
    x: (B, S, D); positions (B, S). The cache is written in place; ``pos``,
    the first position, is read from ``positions`` where not given."""
    m: MLAConfig = cfg.mla
    dt = x.dtype
    s = x.shape[1]
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    new_cache = None
    if cache is not None and pos is None:
        pos = int(positions[0, 0]) if positions.ndim == 2 else int(positions[0])

    if decode:
        if cache is None:
            raise ValueError("mla_apply: decode needs a cache")
        q_nope, q_rope, c_kv, k_rope = _mla_project(p, x, cfg, positions)
        size = cache["c_kv"].shape[1]
        slot = pos % size
        cache["c_kv"][:, slot] = c_kv[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, slot] = k_rope[:, 0].to(cache["k_rope"].dtype)
        cache["slot_pos"][slot] = pos
        new_cache = cache
        c_buf, r_buf, sp = cache["c_kv"].to(dt), cache["k_rope"].to(dt), cache["slot_pos"]
        # Absorbed decode: never expand per-head K/V from the latent.
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(dt))
        s_lat = torch.einsum("bshr,btr->bhst", q_abs, c_buf)
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, r_buf)
        logits = (s_lat + s_rope).float() * scale
        valid = (sp >= 0) & (sp <= pos)
        logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
        w = torch.softmax(logits, dim=-1).to(dt)
        o_lat = torch.einsum("bhst,btr->bshr", w, c_buf)
        out = torch.einsum("bshr,rhv->bshv", o_lat, p["wv_b"].to(dt))
    else:
        q_full, k_full, v, c_kv, k_rope = mla_qkv(p, x, cfg, positions)
        out = flash_attention(q_full, k_full, v, causal=True,
                              block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        if cache is not None:
            size = cache["c_kv"].shape[1]
            take = min(s, size)
            cache["c_kv"][:, :take] = c_kv[:, s - take:].to(cache["c_kv"].dtype)
            cache["k_rope"][:, :take] = k_rope[:, s - take:].to(cache["k_rope"].dtype)
            cache["slot_pos"][:take] = torch.arange(
                s - take, s, dtype=torch.int32, device=cache["slot_pos"].device
            )
            new_cache = cache

    h, dv, d = p["wo"].shape
    y = torch.matmul(out.reshape(*out.shape[:2], h * dv), p["wo"].to(dt).reshape(h * dv, d))
    return y, new_cache
