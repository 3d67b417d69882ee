"""Collective accounting per device: what the placement of a dry-run cell
implies.

Port of ``repro.launch.hlo_analysis``. The reference parses the
collectives XLA's SPMD partitioner wrote into the compiled module. Eager
PyTorch has no partitioner, so the port derives them from the placement
the reference gives the same cell: ``param_rules`` (through
``Model.specs``), ``batch_specs``, ``cache_specs`` and the dry-run's
choice of data, tensor and context parallelism (:func:`plan_collectives`):

  FSDP          each leaf whose "embed" dim is split over data axes is
                all-gathered over them a layer at a time: in the forward,
                and again in the backward (where remat recomputes, the
                same gather serves the recompute), its gradient
                reduce-scattered back; the batch axes it is not split over
                all-reduce the gradient too, and a leaf split over none
                has its gradient all-reduced over them
  TP            where the model axis is tensor-parallel, one all-reduce of
                the activations (local batch × sequence × the product's
                output) after each row-parallel product (a leaf whose
                first dim, after any experts dim, is split over it), and
                in the backward one of the input's gradient for each
                product that reads the model-wide activation (a leaf whose
                first dim, after any experts dim, is "embed"); an expert
                weight's over its grouped rows (top-k slots a token times
                the capacity factor)
  EP            ``ep_a2a``: three ``all_to_all`` a moe layer forward
                (tokens, expert ids, results), two more backward
  CP            ``flash_attention_cp``: K and V gathered over the context
                axis, and the output gathered back, an attention layer

Each record is one collective of a layer body (``trips``: the layers it
repeats over), as the reference's static count is one a ``while`` body.
Traffic per device uses the reference's formulas:

  all-reduce          2·S·(g−1)/g      (ring reduce + broadcast)
  all-gather          S·(g−1)/g        (S = gathered result size)
  reduce-scatter      S·(g−1)          (S = scattered result size; input = S·g)
  all-to-all          S·(g−1)/g
  collective-permute  S                (one hop)
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

__all__ = ["Collective", "collective_schedule", "collective_stats", "plan_collectives",
           "traffic"]


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str          # one of the reference's five kinds
    site: str          # what it moves, e.g. "fsdp fwd dense_layers/attn/wq f32[32,2,8]"
    result_bytes: int  # S: the result buffer on one device
    group: int         # g: devices in its group
    trips: int = 1     # layers (or steps) it repeats over


def traffic(c: Collective) -> int:
    """Per-device link traffic of one ``c`` (module docstring)."""
    s, g = c.result_bytes, c.group
    if c.kind == "all-reduce":
        return int(2 * s * (g - 1) / max(g, 1))
    if c.kind in ("all-gather", "all-to-all"):
        return int(s * (g - 1) / max(g, 1))
    if c.kind == "reduce-scatter":
        return int(s * (g - 1))
    return s  # collective-permute: one hop


def collective_stats(collectives: List[Collective]) -> dict:
    """{kind: {count, result_bytes, traffic_bytes}} + totals, one count a
    record (a layer body's collective once, as the reference counts an op
    of a ``while`` body once)."""
    stats: dict = {}
    for c in collectives:
        s = stats.setdefault(c.kind, {"count": 0, "result_bytes": 0, "traffic_bytes": 0})
        s["count"] += 1
        s["result_bytes"] += c.result_bytes
        s["traffic_bytes"] += traffic(c)
    out = dict(stats)
    out["total_traffic_bytes"] = sum(v["traffic_bytes"] for v in stats.values())
    out["total_count"] = sum(v["count"] for v in stats.values())
    return out


def collective_schedule(collectives: List[Collective], limit: int = 40) -> List[str]:
    """Ordered summary of the collectives, one line each."""
    return [f"{c.kind} {c.site} group={c.group} trips={c.trips}"
            for c in collectives[:limit]]


_DTYPE_NAMES = {1: "s8", 2: "bf16", 4: "f32", 8: "f64"}


def _shape_text(shape, itemsize: int) -> str:
    return f"{_DTYPE_NAMES.get(itemsize, 'b' + str(itemsize))}[{','.join(map(str, shape))}]"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _leaves(skeleton, specs, prefix=""):
    """(path, ParamDef, spec) of every leaf, in tree order."""
    if isinstance(skeleton, dict):
        for k in sorted(skeleton):
            yield from _leaves(skeleton[k], specs[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, skeleton, specs


def plan_collectives(
    cfg,
    skeleton,
    specs,
    *,
    kind: str,
    mesh: dict,
    batch_axes: tuple,
    tp: Optional[str],
    cp: Optional[str],
    local_batch: int,
    seq: int,
    param_itemsize: int,
    grad_itemsize: int,
    act_itemsize: int,
) -> List[Collective]:
    """The collectives of one step of a cell (module docstring).

    ``mesh``: {axis: size}; ``batch_axes``: the axes the step's batch is
    split over (the data axes, and the model axis under 2-D batch);
    ``tp``: the tensor-parallel axis or None; ``cp``: the context axis
    where context parallelism applies to this step, else None;
    ``local_batch`` and ``seq``: one device's batch rows and the tokens a
    row brings to the step (1 for a decode step)."""
    train = kind == "train"
    out: List[Collective] = []
    size = lambda axes: math.prod(mesh[a] for a in axes)  # noqa: E731
    tokens = local_batch * seq
    for path, d, spec in _leaves(skeleton, specs):
        names = d.logical_axes
        entries = list(spec) + [None] * (len(names) - len(spec))
        trips = math.prod(n for n, a in zip(d.shape, names) if a == "layers")
        dims = [(n, a, _axes(e)) for n, a, e in zip(d.shape, names, entries) if a != "layers"]
        local = [-(-n // size(ax)) if ax else n for n, _, ax in dims]
        fsdp = next((ax for _, a, ax in dims if a == "embed" and ax), ())
        gathered = [-(-n // size(ax)) if ax and a != "embed" else n for n, a, ax in dims]
        shard_bytes = math.prod(local) * grad_itemsize
        if fsdp and size(fsdp) > 1:
            g = size(fsdp)
            s = math.prod(gathered) * param_itemsize
            text = _shape_text(gathered, param_itemsize)
            for when in (("fwd", "bwd") if train else ("fwd",)):
                out.append(Collective("all-gather", f"fsdp {when} {path} {text}", s, g, trips))
            if train:
                out.append(Collective("reduce-scatter",
                                      f"grad {path} {_shape_text(local, grad_itemsize)}",
                                      shard_bytes, g, trips))
        rest = tuple(a for a in batch_axes if a not in fsdp)
        if train and size(rest) > 1:
            out.append(Collective("all-reduce", f"grad {path} {_shape_text(local, grad_itemsize)}",
                                  shard_bytes, size(rest), trips))
        if tp and mesh[tp] > 1 and len(dims) >= 2:
            lead = dims[1] if dims[0][1] == "experts" else dims[0]
            rows = tokens
            if dims[0][1] == "experts":  # the grouped rows: k slots a token, cf spare
                rows = int(tokens * cfg.moe.top_k * cfg.moe.capacity_factor)
            width = None
            if tp in lead[2]:  # row-parallel: partial sums of its output, forward
                width = dims[-1][0] if dims[-1][1] == "embed" else math.prod(
                    n for n, _, _ in dims[dims.index(lead) + 1:])
                when = "fwd"
            elif train and lead[1] == "embed":  # its input's gradient, backward
                width, when = lead[0], "bwd"
            if width is not None:
                out.append(Collective(
                    "all-reduce", f"tp {when} {path} {_shape_text((rows, width), act_itemsize)}",
                    rows * width * act_itemsize, mesh[tp], trips))
    moe = cfg.moe
    if moe is not None and moe.impl == "ep_a2a":
        ep = size(moe.ep_axes)
        n_moe = cfg.n_layers - moe.n_dense_layers
        cap = max(1, int(tokens * moe.top_k / ep * moe.capacity_factor))
        exchanges = [("fwd tokens", cfg.d_model, act_itemsize), ("fwd ids", 1, 4),
                     ("fwd results", cfg.d_model, act_itemsize)]
        if train:  # the cotangents of the tokens and the results
            exchanges += [("bwd tokens", cfg.d_model, act_itemsize),
                          ("bwd results", cfg.d_model, act_itemsize)]
        for what, width, item in exchanges:
            text = _shape_text((ep, cap, width), item)
            out.append(Collective("all-to-all", f"ep {what} {text}", ep * cap * width * item,
                                  ep, n_moe))
    if cp and _attention_layers(cfg):
        g = mesh[cp]
        kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        layers = _attention_layers(cfg)
        for name, width in (("k", kv * hd), ("v", kv * hd), ("out", cfg.n_heads * hd)):
            s = tokens * width * act_itemsize
            text = _shape_text((local_batch, seq, width), act_itemsize)
            out.append(Collective("all-gather", f"cp {name} {text}", s, g, layers))
    return out


def _attention_layers(cfg) -> int:
    """Attention layers a forward runs (self-attention blocks)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family in ("ssm", "spectral"):
        return 0
    return cfg.n_layers
