"""Dry-run: count every (architecture × input-shape × mesh) cell's step on
``meta`` tensors (nothing is allocated on any device) and record its
memory, flops, bytes and collective traffic per device, and its roofline.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell with XLA against a mesh of 512 fake devices and reads the compiled
module. The port has no compiler to ask, so the counterpart of each
reading is its own:

* **argument bytes**: every argument leaf (the train state, or the serving
  weights and caches, and the batch) split by its spec
  (``param_rules`` through ``Model.specs``, ``batch_specs``,
  ``cache_specs``) with ceiling division by its axes' sizes, as XLA pads
  an uneven split;
* **flops and bytes**: the step counted op by op by
  ``hlo_cost.CostCounter`` on meta tensors, the kernel entries charging
  what their kernels do on the card (``kernels._launch``);
* **temp bytes**: the counter's peak of the step's own live storages;
* **collectives**: ``hlo_analysis.plan_collectives`` from the same
  placement.

Per device. The step runs at one device's batch: the global batch divided
by the leading batch axes that divide it, the reference's rule for its
activations (``sharding.ctx``'s largest prefix; the batch axes are the
data axes, and the model axis too where the reference runs 2-D batch,
``dryrun.py:149-170``). Where the model axis is tensor-parallel the
counted flops, bytes and temp are divided by its size; where context
parallelism applies (inference whose batch cannot fill the model axis),
the attention kernels' charges are divided by it and the rest is counted
whole, as the reference replicates it there. The weights keep their full
shapes in the counted step (a gathered layer, as FSDP runs it).

The JSON keys are the reference's; ``port_notes`` says what stands where
a key has no meaning without XLA (``lower_s``, ``compile_s``,
``code_bytes``, ``cost_xla_once_per_body``). ``--save-hlo`` writes the
counter's per-op table beside the JSON.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-existing
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.registry import (
    ALL_IDS,
    ARCH_IDS,
    SHAPES,
    get_config,
    input_specs,
    shape_skips,
)
from repro_torch.launch.hlo_analysis import (
    collective_schedule,
    collective_stats,
    plan_collectives,
)
from repro_torch.launch.hlo_cost import CostCounter, loop_aware_cost, top_collectives
from repro_torch.launch.mesh import mesh_axes, mesh_name
from repro_torch.launch.roofline import PEAK_FLOPS_BF16, Roofline, model_flops
from repro_torch.models.build import build
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.sharding import batch_specs, cache_specs, param_rules
from repro_torch.sharding.ctx import _largest_prefix, activation_sharding, cp_axis_for
from repro_torch.sharding.rules import use_tp
from repro_torch.train.loop import TrainState, make_train_step

__all__ = ["Cell", "arg_bytes", "build_cell", "count_step", "main", "run_cell"]

# archs whose optimizer state is bf16 in the reference's dry-run (to fit
# 512 v5e chips); kept so the two count the same state
_BF16_OPT = {"deepseek-v3-671b", "internvl2-76b", "mixtral-8x22b"}

#: Kernels whose work context parallelism splits over its axis.
_ATTENTION_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")

PORT_NOTES = {
    "lower_s": "seconds to build the model and the cell's meta arguments",
    "compile_s": "seconds of the counted step on meta tensors (no compiler)",
    "code_bytes": "0: no compiled module",
    "cost_xla_once_per_body": "the counted step's totals (eager counting has no "
                              "once-per-body view); transcendentals: elements of exp, "
                              "log, the trigonometric and the root ops",
    "collectives": "one count a layer body's collective, derived from the placement "
                   "(launch.hlo_analysis)",
}


@dataclasses.dataclass
class Cell:
    """One cell: its step, its meta arguments at one device's batch, and
    what the count needs."""

    arch: str
    shape: str
    mesh: str
    cfg: Any
    model: Any
    kind: str
    seq: int
    batch: int
    local_batch: int
    batch_axes: tuple
    tp: Optional[str]
    cp: Optional[str]
    step: Callable
    args: tuple
    arg_specs: tuple        # the arguments' specs, over the global trees below
    global_args: tuple      # meta arguments at the global batch


def _batch_specs(cfg, kind: str, mesh: dict, multi_pod: bool, batch: int) -> dict:
    """``batch_specs`` on ``mesh``: the batch split over the data axes where
    their product divides it (the reference's production meshes ask 16 or
    32 of it), else replicated."""
    n_dp = math.prod(s for a, s in mesh.items() if a != "model")
    return batch_specs(cfg, kind, multi_pod=multi_pod, batch=None if batch % n_dp == 0 else batch)


def _leaf_bytes(t: torch.Tensor, spec, mesh: dict) -> int:
    entries = list(spec) + [None] * (t.dim() - len(spec))
    n = 1
    for dim, e in zip(t.shape, entries):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        n *= -(-dim // math.prod(mesh[a] for a in axes))
    return n * t.element_size()


def arg_bytes(tree, specs, mesh: dict) -> int:
    """Per-device bytes of ``tree`` (meta tensors at global shapes) placed by
    ``specs`` (the same structure; None for an absent subtree) on
    ``mesh``."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return _leaf_bytes(tree, specs, mesh)
    if isinstance(tree, dict):
        return sum(arg_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(arg_bytes(t, s, mesh) for t, s in zip(tree, specs))
    return 0


def _tp_cp(cfg, kind: str, mesh: dict, multi_pod: bool):
    """The reference's choice (``dryrun.py:149-170``): (batch axes and
    sizes, tp axis, cp axis)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    dp_sizes = tuple(mesh[a] for a in dp)
    cp = None
    if not use_tp(cfg, mesh["model"]):
        dp, dp_sizes = dp + ("model",), dp_sizes + (mesh["model"],)
        tp = None
        if kind != "train":
            cp = "model"
    else:
        tp = "model"
    return dp, dp_sizes, tp, cp


def build_cell(arch: str, shape: str, mesh: str = "pod1_16x16", overrides=None,
               bf16_params: bool = False, *, config=None, seq: int | None = None,
               batch: int | None = None) -> Cell:
    """The cell's step and its meta arguments. ``config`` replaces the
    registry's config (a smoke config, say); ``seq`` and ``batch`` replace
    the shape's global sequence and batch."""
    cfg = config if config is not None else get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    model = build(cfg)
    info = SHAPES[shape]
    kind = info["kind"]
    seq = seq if seq is not None else info["seq"]
    batch = batch if batch is not None else info["batch"]
    axes = mesh_axes(mesh)
    multi_pod = "pod" in axes
    dp, dp_sizes, tp, cp = _tp_cp(cfg, kind, axes, multi_pod)
    split = _largest_prefix(batch, dp, dp_sizes) or ()
    local_b = batch // math.prod(axes[a] for a in split)
    with activation_sharding(dp=dp, dp_sizes=dp_sizes, tp=tp, tp_size=axes["model"],
                             cp=cp, cp_size=axes["model"]):
        cp = cp_axis_for(batch, seq)
    rules = param_rules(cfg, multi_pod=multi_pod, model_size=axes["model"])
    pspecs = model.specs(rules)
    bspecs = _batch_specs(cfg, kind, axes, multi_pod, batch)
    common = dict(arch=arch, shape=shape, mesh=mesh, cfg=cfg, model=model, kind=kind, seq=seq,
                  batch=batch, local_batch=local_b, batch_axes=tuple(split), tp=tp, cp=cp)

    if kind == "train":
        params = model.abstract(torch.float32)
        opt_dtype = torch.bfloat16 if arch in _BF16_OPT else torch.float32
        state = TrainState(params, adamw_init(params, opt_dtype))
        state_specs = {"params": pspecs, "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}
        step = make_train_step(model.loss_fn,
                               cast_params=torch.bfloat16 if bf16_params else None)
        return Cell(**common, step=step,
                    args=(state, input_specs(cfg, shape, seq=seq, batch=local_b)),
                    arg_specs=(state_specs, bspecs),
                    global_args=(state.tree(), input_specs(cfg, shape, seq=seq, batch=batch)))

    params = model.abstract(torch.bfloat16)  # serving weights

    def caches_at(b):
        if model.init_cache_fn is None:  # encoder-style arch: no KV cache
            return None
        return model.init_cache_fn(b, seq, torch.bfloat16, device="meta")

    global_caches = caches_at(batch)
    cspecs = (None if global_caches is None
              else cache_specs(cfg, global_caches, batch, multi_pod=multi_pod,
                               model_size=axes["model"]))
    if kind == "prefill":
        def step(params, batch_in, caches):
            with torch.no_grad():
                return model.prefill_fn(params, batch_in, caches)

        return Cell(**common, step=step,
                    args=(params, input_specs(cfg, shape, seq=seq, batch=local_b),
                          caches_at(local_b)),
                    arg_specs=(pspecs, bspecs, cspecs),
                    global_args=(params, input_specs(cfg, shape, seq=seq, batch=batch),
                                 global_caches))

    # decode: one token a row at the last position; pos a Python int (the
    # decode step reads it on the host)
    def step(params, token, pos, caches):
        with torch.no_grad():
            return model.decode_fn(params, token, pos, caches)

    specs = input_specs(cfg, shape, seq=seq, batch=batch)
    local = input_specs(cfg, shape, seq=seq, batch=local_b)
    return Cell(**common, step=step, args=(params, local["token"], seq - 1, caches_at(local_b)),
                arg_specs=(pspecs, bspecs["token"], bspecs["pos"], cspecs),
                global_args=(params, specs["token"], specs["pos"], global_caches))


def count_step(cell: Cell, args: tuple | None = None):
    """(counter, outputs) of the cell's step on ``args`` (by default its meta
    arguments) under a fresh :class:`CostCounter`."""
    counter = CostCounter()
    with counter:
        out = cell.step(*(cell.args if args is None else args))
    return counter, out


def _new_bytes(out, args) -> int:
    """Bytes of the outputs that are not arguments updated in place."""
    own = {id(t) for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
    if isinstance(out, tuple) and isinstance(out[0], TrainState):
        out = out[1]
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and id(t) not in own)


def run_cell(arch: str, shape: str, multi_pod: bool = False, overrides=None,
             hlo_path: str | None = None, bf16_params: bool = False, *,
             mesh: str | None = None, config=None, seq: int | None = None,
             batch: int | None = None) -> dict:
    cfg = config if config is not None else get_config(arch)
    mesh = mesh or mesh_name(multi_pod=multi_pod)
    skip = shape_skips(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "skip", "reason": skip}
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, overrides, bf16_params, config=config, seq=seq,
                      batch=batch)
    t_lower = time.perf_counter() - t0
    counter, out = count_step(cell)
    t_compile = time.perf_counter() - t0 - t_lower
    axes = mesh_axes(mesh)
    n_dev = math.prod(axes.values())
    split = axes[cell.tp] if cell.tp else 1
    attention = sum(counter.kernels.get(k, {}).get("flops", 0.0) for k in _ATTENTION_KERNELS)
    attention_bytes = sum(counter.kernels.get(k, {}).get("bytes", 0.0)
                          for k in _ATTENTION_KERNELS)
    cp_cut = (1 - 1 / axes[cell.cp]) if cell.cp else 0.0
    flops = (counter.flops - cp_cut * attention) / split
    nbytes = (counter.bytes - cp_cut * attention_bytes) / split
    if hlo_path:
        with open(hlo_path, "w") as f:
            f.write(counter.table())
    args_b = arg_bytes(cell.global_args, cell.arg_specs, axes)
    if cell.kind == "train":
        out_b = arg_bytes(cell.global_args[0], cell.arg_specs[0], axes)
    else:
        caches = cell.global_args[-1]
        out_b = arg_bytes(caches, cell.arg_specs[-1], axes)
    out_b += _new_bytes(out, cell.args) // split
    temp_b = counter.peak_bytes // split
    act = torch.empty((), dtype=getattr(torch, cell.cfg.compute_dtype)).element_size()
    train = cell.kind == "train"
    colls = plan_collectives(
        cell.cfg, cell.model.skeleton, cell.arg_specs[0]["params"] if train else cell.arg_specs[0],
        kind=cell.kind, mesh=axes, batch_axes=cell.batch_axes, tp=cell.tp, cp=cell.cp,
        local_batch=cell.local_batch, seq=1 if cell.kind == "decode" else cell.seq,
        param_itemsize=(2 if bf16_params else 4) if train else max(2, act),
        grad_itemsize=2 if bf16_params else 4, act_itemsize=act)
    lac = loop_aware_cost(counter, colls)
    stats = collective_stats(colls)
    mf = model_flops(cell.cfg, cell.model.skeleton, cell.kind, cell.seq, cell.batch)
    rl = Roofline(
        flops_per_device=flops,
        bytes_per_device=nbytes,
        collective_bytes_per_device=float(lac["collective_traffic_bytes"]),
        n_devices=n_dev,
        model_flops_global=mf,
        peak_flops=PEAK_FLOPS_BF16,
    )
    return {
        "arch": arch,
        "shape": shape,
        "mesh": mesh,
        "status": "ok",
        "n_devices": n_dev,
        "kind": cell.kind,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "code_bytes": 0,
            "total_bytes": args_b + temp_b + out_b,
        },
        "cost_xla_once_per_body": {"flops": flops, "bytes accessed": nbytes,
                                   "transcendentals": counter.transcendentals / split},
        "cost": {"flops": flops, "bytes accessed": nbytes},
        "collectives": {k: v for k, v in stats.items() if isinstance(v, dict)},
        "collective_traffic_bytes": lac["collective_traffic_bytes"],
        "collective_count": lac["collective_count"],
        "schedule_head": collective_schedule(colls, limit=20),
        "top_collectives": top_collectives(colls, 15),
        "roofline": rl.to_dict(),
        "local_batch": cell.local_batch,
        "kernels": counter.kernels,
        "port_notes": PORT_NOTES,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--include-fourier", action="store_true",
                    help="also dry-run the paper's own fourier_lm arch")
    ap.add_argument("--moe-impl", default=None,
                    choices=["grouped_local", "ep_a2a", "dense_small"],
                    help="override: MoE dispatch path")
    ap.add_argument("--ep-axes", default="data,model",
                    help="mesh axes for expert parallelism (comma list)")
    ap.add_argument("--fft-variant", default=None,
                    choices=["looped", "unrolled", "stockham", "rfft"],
                    help="override: spectral mixing variant")
    ap.add_argument("--attn-block-q", type=int, default=None)
    ap.add_argument("--attn-block-k", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true",
                    help="override: disable per-layer rematerialisation")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"],
                    help="override: selective checkpoint policy")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the counter's per-op table next to the JSON")
    ap.add_argument("--bf16-params", action="store_true",
                    help="override: differentiate at a bf16 view of the f32 master "
                         "weights (bf16 gathers + grad reductions)")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else (ALL_IDS if args.include_fourier else ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                overrides = {}
                if args.moe_impl:
                    base_moe = get_config(arch).moe
                    if base_moe is not None:
                        overrides["moe"] = dataclasses.replace(
                            base_moe, impl=args.moe_impl,
                            ep_axes=tuple(args.ep_axes.split(",")))
                if args.fft_variant:
                    overrides["fft_variant"] = args.fft_variant
                if args.no_remat:
                    overrides["remat"] = False
                if args.remat_policy:
                    overrides["remat_policy"] = args.remat_policy
                if args.attn_block_q:
                    overrides["attn_block_q"] = args.attn_block_q
                if args.attn_block_k:
                    overrides["attn_block_k"] = args.attn_block_k
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip-existing] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp, overrides or None,
                                   hlo_path=path.replace(".json", ".ops.txt")
                                   if args.save_hlo else None,
                                   bf16_params=args.bf16_params)
                except Exception as e:  # record the failure, keep sweeping
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-3000:]}
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                if res["status"] == "ok":
                    r = res["roofline"]
                    print(
                        f"  ok: compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                        f"collective={r['collective_s']:.3e}s dominant={r['dominant']} "
                        f"(lower {res['lower_s']}s count {res['compile_s']}s)",
                        flush=True,
                    )
                elif res["status"] == "skip":
                    print(f"  skip: {res['reason']}")
                else:
                    print(f"  ERROR: {res['error']}")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run sweep complete")


if __name__ == "__main__":
    main()
