"""Mixture-of-Experts: token-choice top-k routing.

Port of ``repro.models.moe``. Two dispatch paths run on one device:

  * ``dense_small``   — every expert on every token (tiny E, smoke tests).
  * ``grouped_local`` — capacity-grouped batched products per batch row,
    the path of the moe configs.

``ep_a2a`` (expert parallelism, tokens exchanged with all-to-all under
``shard_map``) comes with the sharding slice (ROADMAP, queue 1, item
12 (h)): as in the reference, without a mesh, or with one that lacks the
expert axes, it runs ``grouped_local``; under a mesh that has them it
raises ``NotImplementedError`` (ROADMAP, divergence 18).

Both paths share the router and the (E, D, F) expert weight layout, drop
over-capacity assignments (standard dropped-token semantics) and return
the Switch-style load-balance loss. As in the reference, a prefill of S
tokens groups at capacity ``max(1, int(S·k/E·cf))`` a row, so it may drop
assignments, while a decode step (S = 1: capacity 1, k distinct experts)
never does.

Where the port must match JAX's choices exactly:

* the top k are the first k of a stable descending sort, so equal scores
  (a sigmoid saturated at 1.0) go to the lower expert index, as
  ``jax.lax.top_k`` breaks ties (``torch.topk`` does not promise that);
* the sort of assignments by expert is stable, as ``jnp.argsort(...,
  stable=True)``; each slot's position is the running max of its group's
  start (``torch.cummax`` for the reference's ``associative_scan``);
* the grouping scatter adds each kept row onto zeros and dropped rows as
  zeros (the reference's ``.at[].add``), so its result does not depend on
  the order of the adds; the combine gathers each token's k weighted
  expert outputs back through the inverse permutation and sums them in
  the order of the router's choice, so it is the same on every run (the
  reference scatter-adds them in the sorted order: the sums differ by
  rounding only).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.param import ParamDef

__all__ = ["moe_apply", "moe_skel", "top_k", "with_expert_dtype"]


def moe_skel(cfg: ModelConfig) -> dict:
    m: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    skel = {
        "router": ParamDef((d, e), ("embed", "experts")),
        "wg": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "wu": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "wd": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        skel["shared"] = {
            "wg": ParamDef((d, fs), ("embed", "mlp")),
            "wu": ParamDef((d, fs), ("embed", "mlp")),
            "wd": ParamDef((fs, d), ("mlp", "embed")),
        }
    return skel


def with_expert_dtype(skeleton, dtype):
    """``skeleton`` (an LM's) with every moe layer's routed expert weights
    (``wg``, ``wu``, ``wd``) held in ``dtype``, the rest as it was: at a
    bf16 compute dtype the reference casts them to it before every product,
    so bf16 experts give its products of float32 weights rounded once, in
    half the memory (``init_params`` then draws them without a float32
    copy)."""
    out = dict(skeleton)
    if "moe_layers" in out:
        layers = dict(out["moe_layers"])
        layers["moe"] = {k: dataclasses.replace(d, dtype=dtype) if k in ("wg", "wu", "wd") else d
                         for k, d in layers["moe"].items()}
        out["moe_layers"] = layers
    return out


def top_k(scores, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, largest first,
    equal values in index order (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _act(g, u, act: str):
    return F.silu(g) * u if act == "swiglu" else F.gelu(g, approximate="tanh") * u


def _router(p, x, m: MoEConfig):
    """Returns (gates (..., k) in x's dtype, expert_ids (..., k) int32,
    aux_loss scalar); in float32 as the reference."""
    logits = torch.matmul(x.float(), p["router"].float())
    if m.router_norm == "sigmoid":  # deepseek-v3 style
        gates, ids = top_k(torch.sigmoid(logits), m.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    else:  # mixtral style: softmax over the selected logits
        top_logits, ids = top_k(logits, m.top_k)
        gates = torch.softmax(top_logits, dim=-1)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    n_tok = ids[..., 0].numel()
    # fraction routed per expert (x k): one-hot counts are exact in float32
    frac = torch.bincount(ids.reshape(-1), minlength=e).float() / n_tok
    mean_prob = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(frac / m.top_k * mean_prob)
    return gates.to(x.dtype), ids.to(torch.int32), aux


def _expert_ffn_batched(wg, wu, wd, h, act: str = "swiglu"):
    """h: (B, E, C, D) grouped tokens; per-expert FFN, the weights cast to
    h's dtype at use. Runs as (E, B·C, D) batched products."""
    b, e, c, d = h.shape
    dt = h.dtype
    he = h.transpose(0, 1).reshape(e, b * c, d)
    a = _act(torch.bmm(he, wg.to(dt)), torch.bmm(he, wu.to(dt)), act)
    y = torch.bmm(a, wd.to(dt))
    return y.reshape(e, b, c, d).transpose(0, 1)


def _moe_grouped_rows(p, x, m: MoEConfig, act: str, stats: dict | None = None):
    """Per-batch-row capacity grouping. x: (B, S, D) -> (B, S, D), aux.
    ``stats``, where given, receives the row capacity and the kept and
    total assignment counts (0-d tensors)."""
    b, s, d = x.shape
    gates, ids, aux = _router(p, x, m)
    k = m.top_k
    e = m.n_experts
    capacity = max(1, int(s * k / e * m.capacity_factor))
    a = s * k
    dev = x.device

    ids_flat = ids.reshape(b, a).long()
    gate_flat = gates.reshape(b, a)
    tok_of_a = torch.arange(s, device=dev).repeat_interleave(k)            # (A,)
    order = torch.sort(ids_flat, dim=-1, stable=True).indices               # (B, A)
    sorted_ids = torch.gather(ids_flat, 1, order)
    idx = torch.arange(a, device=dev).expand(b, a)
    is_start = torch.ones(b, a, dtype=torch.bool, device=dev)
    is_start[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    pos = idx - seg_start
    keep = pos < capacity
    slot = sorted_ids * capacity + torch.clamp(pos, max=capacity - 1)      # (B, A)
    tok_sorted = tok_of_a[order]
    gate_sorted = torch.where(keep, torch.gather(gate_flat, 1, order), 0.0)
    if stats is not None:
        stats.update(capacity=capacity, kept=keep.sum(), assignments=keep.numel())

    x_sorted = torch.gather(x, 1, tok_sorted[..., None].expand(b, a, d))   # (B, A, D)
    x_sorted = torch.where(keep[..., None], x_sorted, 0)
    rows = torch.arange(b, device=dev)[:, None].expand(b, a)
    grouped = torch.zeros(b, e * capacity, d, dtype=x.dtype, device=dev)
    # one kept row a slot, the dropped ones zeros: exact in any order
    grouped.index_put_((rows, slot), x_sorted, accumulate=True)

    h = _expert_ffn_batched(p["wg"], p["wu"], p["wd"], grouped.reshape(b, e, capacity, d), act)
    h = h.reshape(b, e * capacity, d)

    y_sorted = torch.gather(h, 1, slot[..., None].expand(b, a, d)) * gate_sorted[..., None]
    y_sorted = torch.where(keep[..., None], y_sorted, 0.0)
    # each assignment back in the router's order: token t's k choices at
    # t*k .. t*k+k-1, summed in that order
    inverse = torch.empty_like(order)
    inverse.scatter_(1, order, torch.arange(a, device=dev).expand(b, a))
    y_assign = torch.gather(y_sorted, 1, inverse[..., None].expand(b, a, d))
    return y_assign.reshape(b, s, k, d).sum(dim=2), aux


def _moe_dense_small(p, x, m: MoEConfig, act: str):
    """All experts on all tokens, combined by gate weights (tiny E only)."""
    gates, ids, aux = _router(p, x, m)
    combine = torch.sum(
        F.one_hot(ids.long(), m.n_experts).to(x.dtype) * gates[..., None], dim=-2
    )  # (..., E)
    dt = x.dtype
    g = torch.einsum("bsd,edf->besf", x, p["wg"].to(dt))
    u = torch.einsum("bsd,edf->besf", x, p["wu"].to(dt))
    h = torch.einsum("besf,efd->besd", _act(g, u, act), p["wd"].to(dt))
    y = torch.einsum("besd,bse->bsd", h, combine)
    return y, aux


def moe_apply(p: dict, x, cfg: ModelConfig, *, ep_axis: Any = None, stats: dict | None = None):
    """Returns (y, aux_loss). Adds shared experts if configured. ``stats``
    (``grouped_local`` only) receives the capacity and the kept
    assignments."""
    m: MoEConfig = cfg.moe
    impl = m.impl
    ep_axes = tuple(ep_axis) if ep_axis else tuple(m.ep_axes)
    if impl == "ep_a2a":
        mesh = compat.get_abstract_mesh()
        names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
        if not ep_axes or mesh is None or any(a not in names for a in ep_axes):
            impl = "grouped_local"  # no mesh context (one device)
        else:
            raise NotImplementedError(
                f"{cfg.name}: expert-parallel dispatch (ep_a2a over {ep_axes}) is not "
                "ported yet (ROADMAP, queue 1, item 12 (h))"
            )
    if impl == "dense_small":
        y, aux = _moe_dense_small(p, x, m, cfg.act)
    else:
        y, aux = _moe_grouped_rows(p, x, m, cfg.act, stats)
    if m.n_shared_experts:
        sp = p["shared"]
        dt = x.dtype
        a = _act(torch.matmul(x, sp["wg"].to(dt)), torch.matmul(x, sp["wu"].to(dt)), cfg.act)
        y = y + torch.matmul(a, sp["wd"].to(dt))
    return y, aux
