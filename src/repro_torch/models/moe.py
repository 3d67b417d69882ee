"""Mixture-of-Experts: token-choice top-k routing.

Port of ``repro.models.moe``, with three dispatch paths:

  * ``dense_small``   — every expert on every token (tiny E, smoke tests).
  * ``grouped_local`` — capacity-grouped batched products per batch row,
    the path of the moe configs on one device.
  * ``ep_a2a``        — expert parallelism under ``compat.shard_map``:
    tokens and experts sharded over ``ep_axes``, tokens sent to their
    experts' ranks and back with two ``all_to_all`` (and one for the
    expert ids), each rank running only its own experts. As in the
    reference, without a mesh, or with one that lacks the expert axes, it
    runs ``grouped_local``. A parameter passed as a ``DTensor`` sharded
    over ``ep_axes`` is used as its local experts, so a rank holds only
    those.

The paths share the router and the (E, D, F) expert weight layout, drop
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
  rounding only);
* ``ep_a2a``'s expert-id buffer is written as the reference's
  ``.at[slot].set`` is on its CPU backend: where several assignments clip
  to one slot, the last in sorted order wins. An assignment over a rank's
  send capacity clips to its segment's last slot, so under overflow that
  slot's id becomes -1 and the kept assignment there is dropped as well
  (the reference's behaviour, ported as is).
"""

from __future__ import annotations

import dataclasses
import functools
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
    # fraction routed per expert (x k): one-hot counts are exact in float32;
    # scatter_add_ of ones gives bincount's counts and runs on meta tensors
    flat = ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat.long(), torch.ones_like(flat, dtype=torch.int64))
    frac = counts.float() / n_tok
    mean_prob = probs.reshape(-1, e).mean(dim=0)
    aux = e * torch.sum(frac / m.top_k * mean_prob)
    return gates.to(x.dtype), ids.to(torch.int32), aux


def _expert_ffn(wg, wu, wd, h, act: str = "swiglu"):
    """h: (E, C, D) grouped tokens; per-expert FFN (the ep_a2a path), the
    weights cast to h's dtype at use."""
    dt = h.dtype
    a = _act(torch.bmm(h, wg.to(dt)), torch.bmm(h, wu.to(dt)), act)
    return torch.bmm(a, wd.to(dt))


def _group_by_expert(ids_flat, n_experts: int, capacity: int):
    """Sort assignment slots by expert; compute each slot's position in its
    expert group (the running max of its group's start).

    Returns (order, slot, keep): ``order`` sorts assignments by expert
    (stable), ``slot`` is the flat (e*C + pos) destination (clipped),
    ``keep`` masks assignments that fit under capacity.
    """
    a = ids_flat.shape[0]
    order = torch.sort(ids_flat, stable=True).indices
    sorted_ids = ids_flat[order]
    idx = torch.arange(a, device=ids_flat.device)
    is_start = torch.ones(a, dtype=torch.bool, device=ids_flat.device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    pos = idx - seg_start
    keep = pos < capacity
    slot = sorted_ids * capacity + torch.clamp(pos, max=capacity - 1)
    return order, slot, keep


def _set_last(n: int, slot, values, fill: int):
    """``full(n, fill).at[slot].set(values)`` with the last write to a slot
    winning, as the reference's scatter on its CPU backend."""
    writer = torch.full((n,), -1, dtype=torch.long, device=slot.device).scatter_reduce(
        0, slot, torch.arange(slot.shape[0], device=slot.device), reduce="amax")
    out = torch.full((n,), fill, dtype=values.dtype, device=slot.device)
    has = writer >= 0
    out[has] = values[writer[has]]
    return out


def _moe_ep_a2a(p, x, m: MoEConfig, act: str, ep_axis):
    """Expert-parallel dispatch on this rank's tokens and experts (inside
    ``shard_map``): route local tokens, bucket them by destination rank
    (fixed send capacity), all_to_all, run local experts, all_to_all back,
    combine."""
    axis_size = compat.axis_size(ep_axis)
    e_loc = m.n_experts // axis_size
    b, s, d = x.shape  # local shapes
    gates, ids, aux = _router(p, x, m)
    k = m.top_k
    t = b * s
    dev = x.device
    x_flat = x.reshape(t, d)
    ids_flat = ids.reshape(t * k).long()
    gates_flat = gates.reshape(t * k)
    tok_of_a = torch.arange(t, device=dev).repeat_interleave(k)

    # Bucket assignments by destination EP rank, fixed capacity per rank.
    cap_send = max(1, int(t * k / axis_size * m.capacity_factor))
    dest = ids_flat // e_loc
    order, slot, keep = _group_by_expert(dest, axis_size, cap_send)
    send_x = torch.zeros(axis_size * cap_send, d, dtype=x.dtype, device=dev)
    send_x = send_x.index_add(0, slot, torch.where(keep[:, None], x_flat[tok_of_a[order]], 0.0))
    send_eid = _set_last(axis_size * cap_send, slot,
                         torch.where(keep, ids_flat[order] % e_loc, -1), -1)
    # Exchange tokens.
    recv_x = compat.all_to_all(send_x.reshape(axis_size, cap_send, d), ep_axis, 0, 0)
    recv_x = recv_x.reshape(axis_size * cap_send, d)
    recv_eid = compat.all_to_all(send_eid.reshape(axis_size, cap_send), ep_axis, 0, 0)
    recv_eid = recv_eid.reshape(axis_size * cap_send)

    # Group received tokens by local expert and run the FFN.
    cap_e = max(1, int(recv_x.shape[0] * m.capacity_factor / e_loc))
    r_order, r_slot, r_keep = _group_by_expert(
        torch.where(recv_eid >= 0, recv_eid, e_loc), e_loc + 1, cap_e)
    grouped = torch.zeros((e_loc + 1) * cap_e, d, dtype=x.dtype, device=dev)
    grouped = grouped.index_add(0, r_slot, torch.where(r_keep[:, None], recv_x[r_order], 0.0))
    h = _expert_ffn(p["wg"], p["wu"], p["wd"],
                    grouped.reshape(e_loc + 1, cap_e, d)[:e_loc], act)
    h_flat = torch.cat([h.reshape(e_loc * cap_e, d), torch.zeros(cap_e, d, dtype=h.dtype,
                                                                  device=dev)])
    y_recv = torch.zeros_like(recv_x).index_add(
        0, r_order, torch.where(r_keep[:, None], h_flat[r_slot], 0.0))
    # Send results home.
    back = compat.all_to_all(y_recv.reshape(axis_size, cap_send, d), ep_axis, 0, 0)
    back = back.reshape(axis_size * cap_send, d)
    y_assign = back[slot] * torch.where(keep, gates_flat[order], 0.0)[:, None]
    y_flat = torch.zeros_like(x_flat).index_add(0, tok_of_a[order], y_assign)
    return y_flat.reshape(b, s, d), aux


def _moe_ep_shard_map(p, x, m: MoEConfig, act: str, ep_axes: tuple):
    """The EP dispatch under ``shard_map``: tokens and experts sharded over
    ``ep_axes``, the router whole (its gradient summed over the ranks);
    aux is the mean over the ranks. Collectives a layer: three
    ``all_to_all`` forward (tokens, expert ids, results), two backward."""
    P = compat.P
    mesh = compat.get_abstract_mesh()
    axis_name = ep_axes if len(ep_axes) > 1 else ep_axes[0]

    @functools.partial(
        compat.shard_map, mesh=mesh,
        in_specs=({"router": P(), "wg": P(ep_axes, None, None), "wu": P(ep_axes, None, None),
                   "wd": P(ep_axes, None, None)}, P(ep_axes, None, None)),
        out_specs=(P(ep_axes, None, None), P()),
        axis_names=set(ep_axes),
    )
    def inner(p_loc, x_loc):
        y, aux = _moe_ep_a2a(p_loc, x_loc, m, act, axis_name)
        return y, compat.pmean(aux, axis_name)

    routed = {k: p[k] for k in ("router", "wg", "wu", "wd")}
    return inner(routed, x)


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
    assignments. ``ep_a2a`` runs its dispatch under the ambient mesh of
    ``compat.set_mesh`` when the mesh has every axis of ``ep_axes``
    (``ep_axis`` or the config's); every rank of the mesh calls it."""
    m: MoEConfig = cfg.moe
    impl = m.impl
    ep_axes = tuple(ep_axis) if ep_axis else tuple(m.ep_axes)
    if impl == "ep_a2a":
        mesh = compat.get_abstract_mesh()
        names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
        if not ep_axes or mesh is None or any(a not in names for a in ep_axes):
            impl = "grouped_local"  # no mesh context (one device)
    if impl == "dense_small":
        y, aux = _moe_dense_small(p, x, m, cfg.act)
    elif impl == "ep_a2a":
        y, aux = _moe_ep_shard_map(p, x, m, cfg.act, ep_axes)
    else:
        y, aux = _moe_grouped_rows(p, x, m, cfg.act, stats)
    if m.n_shared_experts:
        sp = p["shared"]
        dt = x.dtype
        a = _act(torch.matmul(x, sp["wg"].to(dt)), torch.matmul(x, sp["wu"].to(dt)), cfg.act)
        y = y + torch.matmul(a, sp["wd"].to(dt))
    return y, aux
