"""The sharding layer and the paths that use it, on the CPU.

* ``repro_torch.sharding.rules`` and ``models.param.partition_specs``
  (``Model.specs``) against ``repro.sharding.rules`` and the reference's
  ``Model.specs``, compared as tuples: ``param_rules`` on every config,
  single and multi-pod; ``batch_specs`` of every kind; ``cache_specs``
  over ``tests/sharding/test_rules.py``'s shapes (decode_32k, long_500k),
  the reference's caches from ``jax.eval_shape``, the port's on the meta
  device. ``repro_torch.sharding.ctx`` (``cp_axis_for``, ``tp_size``,
  ``_largest_prefix``) against the reference's under its own
  ``activation_sharding``.
* The multi-rank paths run once, in a module fixture: one gloo group of 8
  CPU ranks (one ``python -c`` process a rank, a ``FileStore`` under the
  test's directory, a 60 s timeout), one JAX subprocess with 8 fake CPU
  devices computing the reference's outputs as its own tests compute them
  (``tests/models/test_moe_ep.py``, ``tests/models/test_cp_attention.py``,
  under ``jax.jit``), and two pairs of ``launch.train --distributed
  --device cpu`` ranks, all started together with a 180 s deadline. The
  tests assert on what they wrote:
  - ``ep_a2a`` on a (4, 2) ("data", "model") mesh under ``ep_axes``
    ("data",) and ("data", "model") against the reference's ``ep_a2a`` and
    ``grouped_local``: outputs within 1e-4, gradients of sum(y²) within
    1e-4 of the largest (the reference test's bounds); three
    ``all_to_all`` a layer forward; experts held as ``DTensor`` shards;
  - ``flash_attention_cp`` over "model" against the reference's, causal,
    window 24 and non-causal, within 1e-5, its q gradient within 1e-4,
    each rank at its own query offset; ``gqa_apply``'s cp branch;
  - ``restore_resharded`` with ``to_placements(model.specs(...))`` from an
    (8, 1) mesh to a (2, 4) mesh (``tests/checkpoint/test_elastic.py``'s
    case): values equal, placed on the new mesh;
  - ``launch.train --distributed`` at 2 ranks against one process on the
    whole batch (fourier_lm's masked loss, 2 smoke steps): losses within
    1e-5 relative; under ``--compress`` the first step's loss equal.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.sharding import ctx as jctx
from repro.sharding import rules as jrules
from repro_torch.compat import P, PartitionSpec, to_placements
from repro_torch.configs import registry as reg
from repro_torch.models.build import build
from repro_torch.sharding import ctx, rules

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 180.0
WORLD = 8
TOL_EP = 1e-4
TOL_CP = 1e-5
TOL_CP_GRAD = 1e-4
EP_AXES = {"data": ("data",), "data+model": ("data", "model")}
CP_KW = {"causal": {"causal": True}, "window 24": {"causal": True, "window": 24},
         "non-causal": {"causal": False}}
#: --distributed runs: name -> launcher arguments (each also run by one process).
TRAIN_RUNS = {"fourier_lm": ["--smoke", "--arch", "fourier_lm", "--steps", "2", "--batch", "4",
                             "--seq", "32"],
              "llama compress": ["--smoke", "--arch", "llama3.2-3b", "--steps", "2", "--batch",
                                 "4", "--seq", "16", "--compress"]}


# ------------------------------- the specs -------------------------------


def _jflat(specs) -> dict:
    from jax.sharding import PartitionSpec as JP

    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in flat}


def _tflat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _tflat(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _tflat(sub, path + (i,)).items()}
    assert isinstance(tree, PartitionSpec)
    return {"/".join(map(str, path)): tuple(tree)}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", reg.ALL_IDS)
def test_param_specs_equal_the_reference(arch, multi_pod):
    """``param_rules`` and ``Model.specs`` (the first use of a mesh axis
    wins) give every leaf the reference's spec."""
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    assert rules.param_rules(cfg, multi_pod=multi_pod) == jrules.param_rules(
        jcfg, multi_pod=multi_pod)
    assert rules.use_tp(cfg) == jrules.use_tp(jcfg)
    got = _tflat(build(cfg).specs(rules.param_rules(cfg, multi_pod=multi_pod)))
    want = _jflat(jbuild(jcfg).specs(jrules.param_rules(jcfg, multi_pod=multi_pod)))
    assert got == want


@pytest.mark.parametrize("arch", reg.ALL_IDS)
def test_batch_specs_equal_the_reference(arch):
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    for kind in ("train", "prefill", "decode"):
        for multi_pod in (False, True):
            for batch in (None, 1, 32, 128):
                got = rules.batch_specs(cfg, kind, multi_pod=multi_pod, batch=batch)
                want = jrules.batch_specs(jcfg, kind, multi_pod=multi_pod, batch=batch)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (kind, multi_pod, batch)
    assert rules.dp_axes(False) == ("data",) and rules.dp_axes(True) == ("pod", "data")


CACHE_CASES = [(a, s) for a in reg.ALL_IDS if a != "fourier_lm"
               for s in ("decode_32k", "long_500k")
               if not reg.shape_skips(reg.get_config(a), s)]


@pytest.mark.parametrize("arch,shape", CACHE_CASES)
def test_cache_specs_equal_the_reference(arch, shape):
    """Every cache leaf's spec, the port's caches built on the meta device
    (no storage), by path."""
    info = jreg.SHAPES[shape]
    jcfg, cfg = jreg.get_config(arch), reg.get_config(arch)
    jm = jbuild(jcfg)
    jcaches = jax.eval_shape(lambda: jm.init_cache_fn(info["batch"], info["seq"], jnp.bfloat16))
    caches = build(cfg).init_cache_fn(info["batch"], info["seq"], torch.bfloat16, device="meta")
    for multi_pod in (False, True):
        got = rules.cache_specs(cfg, caches, info["batch"], multi_pod=multi_pod)
        want = jrules.cache_specs(jcfg, jcaches, info["batch"], multi_pod=multi_pod)
        assert _tflat(got) == _jflat(want)


CONTEXTS = {
    "2-D batch": dict(dp=("data",), dp_sizes=(16,), tp="model", tp_size=16),
    "cp over model": dict(dp=("data",), dp_sizes=(16,), tp=None, tp_size=16, cp="model",
                          cp_size=16),
    "multi-pod cp": dict(dp=("pod", "data"), dp_sizes=(2, 16), tp="model", tp_size=16,
                         cp="model", cp_size=16),
    "cp among dp": dict(dp=("data", "model"), dp_sizes=(4, 2), tp=None, tp_size=2, cp="model",
                        cp_size=2),
}


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_context_equals_the_reference(name):
    """``cp_axis_for`` over batches and sequences, ``tp_size`` and
    ``enabled`` under each package's own ``activation_sharding``; ``shard``
    returns its input and raises as the reference does on a rank
    mismatch."""
    kw = CONTEXTS[name]
    assert not ctx.enabled() and ctx.tp_size() == 1 and ctx.cp_axis_for(1, 8) is None
    with ctx.activation_sharding(**kw), jctx.activation_sharding(**kw):
        assert ctx.enabled() and ctx.tp_size() == jctx.tp_size()
        for batch in (1, 2, 4, 8, 16, 32, 64):
            for seq in (7, 32, 4096):
                assert ctx.cp_axis_for(batch, seq) == jctx.cp_axis_for(batch, seq), (batch, seq)
        x = torch.zeros(32, 8, 6)
        assert ctx.shard(x, "dp", None, "tp") is x
        with pytest.raises(ValueError, match="tokens"):
            ctx.shard(x, "dp", None)
        with pytest.raises(ValueError, match="unknown axis token"):
            ctx.shard(x, "dp", None, "ep")


@pytest.mark.parametrize("dim", [1, 2, 4, 6, 8, 12, 16, 32, 64, 96, 128, 256, 512])
def test_largest_prefix_equals_the_reference(dim):
    for axes, sizes in ((("pod", "data", "model"), (2, 16, 16)), (("data", "model"), (4, 2)),
                        (("data",), (16,))):
        got = ctx._largest_prefix(dim, axes, sizes)
        assert got == jctx._largest_prefix(dim, axes, sizes)
        with ctx.activation_sharding(dp=axes, dp_sizes=sizes, tp=None, tp_size=1):
            spec = ctx.shard_spec(torch.zeros(dim, 3), "dp", None)
        assert spec == P(got, None)


def test_partition_spec_is_jax_s():
    """Entries as JAX keeps them: a one-name tuple is the name, an empty one
    None; to_placements needs no mesh to be checked against."""
    from jax.sharding import PartitionSpec as JP

    for entries in [(("data",), None), ((), "model"), (("pod", "data"), None, "model"), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P("data", None) == ("data", None) and len(P(None, "x")) == 2
    assert P(("a", "b"))[0] == ("a", "b")


# --------------------------- the multi-rank runs ---------------------------


REFERENCE = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.models.attention import flash_attention, flash_attention_cp
from repro.models.config import ModelConfig, MoEConfig
from repro.models.moe import moe_apply

tmp = sys.argv[1]
inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
mesh = compat.make_mesh((4, 2), ("data", "model"))
cfg_g = ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                    d_ff=64, vocab=100,
                    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                                  capacity_factor=8.0, impl="grouped_local"))
p = {k: jnp.asarray(inp["p|" + k]) for k in ("router", "wg", "wu", "wd")}
p["shared"] = {k: jnp.asarray(inp["p|shared/" + k]) for k in ("wg", "wu", "wd")}
x = jnp.asarray(inp["x"])
out = {}


def flat(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(prefix + k + "/", v)
        else:
            out[prefix + k] = np.asarray(v)


for tag, ep_axes in (("data", ("data",)), ("data+model", ("data", "model"))):
    cfg_e = dataclasses.replace(cfg_g, moe=dataclasses.replace(cfg_g.moe, impl="ep_a2a",
                                                               ep_axes=ep_axes))
    with compat.set_mesh(mesh):
        for name, cfg in (("grouped", cfg_g), ("ep|" + tag, cfg_e)):
            y, aux = jax.jit(lambda p, x: moe_apply(p, x, cfg))(p, x)
            g = jax.jit(jax.grad(lambda p: jnp.sum(moe_apply(p, x, cfg)[0] ** 2)))(p)
            out[name + "|y"] = np.asarray(y)
            out[name + "|aux"] = np.asarray(aux)
            flat(name + "|g|", g)

q, k, v = (jnp.asarray(inp["cp|" + n]) for n in "qkv")
with compat.set_mesh(mesh):
    for name, kw in ((n, dict(kw)) for n, kw in CP_KW):
        out["cp|" + name] = np.asarray(jax.jit(lambda q, k, v: flash_attention_cp(
            q, k, v, "model", block_q=16, block_k=16, **kw))(q, k, v))
    out["cp|grad"] = np.asarray(jax.jit(jax.grad(lambda q: flash_attention_cp(
        q, k, v, "model", causal=True, block_q=16, block_k=16).sum()))(q))
np.savez(os.path.join(tmp, "reference.npz"), **out)
"""

RANK = r"""
import dataclasses, datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
try:
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch import compat
    from repro_torch.checkpoint import restore_resharded, save
    from repro_torch.compat import P, to_placements
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import attention, moe, param
    from repro_torch.models.build import build
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.sharding import ctx, rules

    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    mesh = compat.make_mesh((4, 2), ("data", "model"), device_type="cpu")
    out, flags = {}, {"rank": rank, "data": compat.axis_index("data", mesh),
                      "model": compat.axis_index("model", mesh),
                      "both": compat.axis_index(("data", "model"), mesh)}
    cfg_g = ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                        d_ff=64, vocab=100,
                        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
                                      capacity_factor=8.0, impl="grouped_local"))
    x = torch.from_numpy(inp["x"])
    names = ["router", "wg", "wu", "wd", "shared/wg", "shared/wu", "shared/wd"]

    def params():
        p = {k: torch.from_numpy(inp["p|" + k]).requires_grad_() for k in names[:4]}
        p["shared"] = {k: torch.from_numpy(inp["p|shared/" + k]).requires_grad_()
                       for k in ("wg", "wu", "wd")}
        return p

    def leaves(p):
        return [p[k] for k in names[:4]] + [p["shared"][k] for k in ("wg", "wu", "wd")]

    for tag, ep_axes in (("data", ("data",)), ("data+model", ("data", "model"))):
        cfg_e = dataclasses.replace(cfg_g, moe=dataclasses.replace(cfg_g.moe, impl="ep_a2a",
                                                                   ep_axes=ep_axes))
        for name, cfg in (("grouped", cfg_g), ("ep|" + tag, cfg_e)):
            p = params()
            with compat.set_mesh(mesh):
                compat.reset_collectives()
                y, aux = moe.moe_apply(p, x, cfg)
                flags[name + "|forward"] = dict(compat.COLLECTIVES)
                grads = torch.autograd.grad((y ** 2).sum(), leaves(p))
            out[name + "|y"] = y.detach().numpy()
            out[name + "|aux"] = aux.detach().numpy()
            for n, g in zip(names, grads):
                out[name + "|g|" + n] = g.numpy()

    # all_gather in a body: the whole argument back, its gradient the whole
    # cotangent (each rank's slice, no sum); stacked when not tiled
    xx = x.clone().requires_grad_()
    w_ct = torch.from_numpy(inp["x"][::-1].copy())
    for tiled in (True, False):
        body = compat.shard_map(
            lambda a, t=tiled: compat.all_gather(a, "data", axis=0, tiled=t), mesh=mesh,
            in_specs=(P("data"),), out_specs=P(), axis_names={"data"})
        with compat.set_mesh(mesh):
            got = body(xx)
        whole = got if tiled else got.reshape(x.shape)
        flags[f"all_gather|{tiled}"] = [list(got.shape), torch.equal(whole, x),
                                        torch.equal(torch.autograd.grad(
                                            (whole * w_ct).sum(), xx)[0], w_ct)]

    # each rank holds only its experts: DTensors sharded over ("data",)
    cfg_e = dataclasses.replace(cfg_g, moe=dataclasses.replace(cfg_g.moe, impl="ep_a2a",
                                                               ep_axes=("data",)))
    placed = to_placements(P("data", None, None), mesh)
    p = params()
    for k in ("wg", "wu", "wd"):
        p[k] = distribute_tensor(p[k].detach(), mesh, placed).requires_grad_()
    with compat.set_mesh(mesh):
        y, _ = moe.moe_apply(p, x, cfg_e)
        grads = torch.autograd.grad((y ** 2).sum(), leaves(p))
    out["dtensor|y"] = y.detach().numpy()
    for n, g in zip(names, grads):
        out["dtensor|g|" + n] = (g.to_local() if isinstance(g, DTensor) else g).numpy()
    flags["dtensor|local"] = list(p["wg"].to_local().shape)

    # context-parallel attention over "model"; the offset each rank passes
    q, k, v = (torch.from_numpy(inp["cp|" + n]) for n in "qkv")
    offsets, inner = [], attention.flash_attention

    def spy(*a, **kw):
        offsets.append(kw.get("q_offset", 0))
        return inner(*a, **kw)

    attention.flash_attention = spy
    with compat.set_mesh(mesh):
        for name, kw in CP_KW:
            out["cp|" + name] = attention.flash_attention_cp(q, k, v, "model", block_q=16,
                                                             block_k=16, **kw).numpy()
        qq = q.clone().requires_grad_()
        out["cp|grad"] = torch.autograd.grad(attention.flash_attention_cp(
            qq, k, v, "model", causal=True, block_q=16, block_k=16).sum(), qq)[0].numpy()
    attention.flash_attention = inner
    flags["cp|offsets"] = offsets

    # gqa_apply takes the cp branch where the context names an axis the batch cannot fill
    gcfg = ModelConfig(name="g", family="dense", n_layers=1, d_model=32, n_heads=4,
                       n_kv_heads=2, d_ff=64, vocab=100, attn_block_q=16, attn_block_k=16)
    gp = {n: torch.from_numpy(inp["gqa|" + n]) for n in ("wq", "wk", "wv", "wo")}
    gx = torch.from_numpy(inp["gqa|x"])
    pos = torch.arange(gx.shape[1]).expand(gx.shape[0], -1)
    calls, cp_inner = [], attention.flash_attention_cp

    def cp_spy(*a, **kw):
        calls.append(a[3])
        return cp_inner(*a, **kw)

    attention.flash_attention_cp = cp_spy
    with compat.set_mesh(mesh), ctx.activation_sharding(dp=("data",), dp_sizes=(4,), tp=None,
                                                        tp_size=1, cp="model", cp_size=2):
        out["gqa|cp"] = attention.gqa_apply(gp, gx, gcfg, positions=pos)[0].numpy()
    attention.flash_attention_cp = cp_inner
    out["gqa|plain"] = attention.gqa_apply(gp, gx, gcfg, positions=pos)[0].numpy()
    flags["gqa|cp axes"] = calls

    # elastic restore: an (8, 1) mesh's checkpoint onto a (2, 4) mesh
    cfg = smoke_config("llama3.2-3b")
    model = build(cfg)
    full = model.init(torch.Generator().manual_seed(0), device="cpu")
    specs = model.specs(rules.param_rules(cfg, multi_pod=False, model_size=1))
    mesh_a = compat.make_mesh((8, 1), ("data", "model"), device_type="cpu")
    mesh_b = compat.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    tree_a = param.tree_map(lambda t, s: distribute_tensor(t, mesh_a, to_placements(s, mesh_a)),
                            full, specs)
    save(os.path.join(tmp, "ckpt"), 42, tree_a)
    placements = param.tree_map(lambda s: to_placements(s, mesh_b), specs)
    got = restore_resharded(os.path.join(tmp, "ckpt"), 42, full, placements, mesh=mesh_b)
    got_leaves, full_leaves = param.tree_leaves(got), param.tree_leaves(full)
    flags["elastic"] = {
        "equal": all(torch.equal(g.full_tensor(), f) for g, f in zip(got_leaves, full_leaves)),
        "meshes": sorted({tuple(g.device_mesh.shape) for g in got_leaves}),
        "sharded": sum(any(pl.is_shard() for pl in g.placements) for g in got_leaves),
        "leaves": len(got_leaves)}

    # the mesh builders
    flags["test mesh"] = list(launch_mesh.make_test_mesh(device_type="cpu").shape)
    try:
        launch_mesh.make_production_mesh(device_type="cpu")
        flags["production mesh"] = None
    except RuntimeError as e:
        flags["production mesh"] = str(e)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(flags, f)
finally:
    dist.destroy_process_group()
"""

TRAIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.train import main
res = main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({"losses": {str(k): v for k, v in res["losses"].items()}, "rank": res["rank"],
               "world": res["world"], "writes": res["loop"].ckpt is not None}, f)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(37)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    out = {"p|router": w(32, 8), "p|wg": w(8, 32, 32), "p|wu": w(8, 32, 32),
           "p|wd": w(8, 32, 32), "p|shared/wg": w(32, 32), "p|shared/wu": w(32, 32),
           "p|shared/wd": w(32, 32),
           "x": rng.standard_normal((8, 16, 32)).astype(np.float32)}
    for n, kv in (("q", 6), ("k", 2), ("v", 2)):
        out["cp|" + n] = rng.standard_normal((4, 64, kv, 16)).astype(np.float32)
    out.update({"gqa|wq": w(32, 4, 8), "gqa|wk": w(32, 2, 8), "gqa|wv": w(32, 2, 8),
                "gqa|wo": w(4, 8, 32), "gqa|x": rng.standard_normal((4, 16, 32)).astype(
                    np.float32)})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, tmp: Path, label: str, env=None):
    log = open(tmp / f"{label}.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **(env or {}))
    proc = subprocess.Popen([sys.executable, "-c", *args], stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=str(ROOT))
    log.close()
    return proc


def _join(procs: dict, tmp: Path, deadline: float) -> None:
    for label, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            for p in procs.values():
                p.kill()
                p.wait()
            pytest.fail(f"{label} exited {rc}: {(tmp / f'{label}.log').read_text()[-3000:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    np.savez(tmp / "inputs.npz", **_inputs())
    cp_kw = repr([(n, kw) for n, kw in CP_KW.items()])
    procs = {"reference": _start([f"CP_KW = {cp_kw}\n" + REFERENCE, str(tmp)], tmp,
                                 "reference")}
    for r in range(WORLD):
        procs[f"rank{r}"] = _start([f"CP_KW = {cp_kw}\n" + RANK, str(r), str(WORLD), str(tmp)],
                                   tmp, f"rank{r}")
    for i, (name, args) in enumerate(TRAIN_RUNS.items()):
        port = str(_free_port())
        for r in range(2):
            env = {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
            procs[f"train{i}_{r}"] = _start(
                [TRAIN, str(tmp / f"train{i}_{r}.json"), "--distributed", "--device", "cpu",
                 "--ckpt", str(tmp / f"ckpt{i}"), *args], tmp, f"train{i}_{r}", env)
    deadline = time.monotonic() + DEADLINE_S
    from repro_torch.launch.train import main

    single = {name: main(["--device", "cpu", "--ckpt", "", *args])["losses"]
              for name, args in TRAIN_RUNS.items()}
    _join(procs, tmp, deadline)
    return {"reference": dict(np.load(tmp / "reference.npz")),
            "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            "flags": [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)],
            "train": {name: [json.loads((tmp / f"train{i}_{r}.json").read_text())
                             for r in range(2)] for i, name in enumerate(TRAIN_RUNS)},
            "single": single, "tmp": tmp}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


GRAD_LEAVES = ["router", "wg", "wu", "wd", "shared/wg", "shared/wu", "shared/wd"]


@pytest.mark.parametrize("tag", list(EP_AXES))
def test_ep_a2a_matches_the_reference_s(runs, tag):
    """Every rank's gathered output and its gradients against the
    reference's ``ep_a2a`` on the same mesh and ``ep_axes``."""
    ref = runs["reference"]
    for out in runs["ranks"]:
        assert np.abs(out[f"ep|{tag}|y"] - ref[f"ep|{tag}|y"]).max() < TOL_EP
        for leaf in GRAD_LEAVES:
            assert _rel(out[f"ep|{tag}|g|{leaf}"], ref[f"ep|{tag}|g|{leaf}"]) < TOL_EP, leaf


@pytest.mark.parametrize("tag", list(EP_AXES))
def test_ep_a2a_matches_grouped_local(runs, tag):
    """At capacity factor 8 nothing drops: ``ep_a2a`` is ``grouped_local``
    (the port's and the reference's), outputs and gradients."""
    ref = runs["reference"]
    for out in runs["ranks"]:
        for grouped in (out, ref):
            assert np.abs(out[f"ep|{tag}|y"] - grouped["grouped|y"]).max() < TOL_EP
            for leaf in GRAD_LEAVES:
                assert _rel(out[f"ep|{tag}|g|{leaf}"], grouped[f"grouped|g|{leaf}"]) < TOL_EP
        assert np.abs(out["grouped|y"] - ref["grouped|y"]).max() < TOL_EP


@pytest.mark.parametrize("tag", list(EP_AXES))
def test_ep_a2a_aux_is_the_mean_of_the_shards(runs, tag):
    """aux is each rank's router statistics' loss, ``pmean``ed over the
    expert axes, as the reference's (not the whole batch's)."""
    ref = runs["reference"]
    for out in runs["ranks"]:
        assert abs(float(out[f"ep|{tag}|aux"]) - float(ref[f"ep|{tag}|aux"])) < 1e-5
        assert abs(float(out["grouped|aux"]) - float(ref["grouped|aux"])) < 1e-5


@pytest.mark.parametrize("tag", list(EP_AXES))
def test_ep_a2a_sends_three_all_to_all_a_layer(runs, tag):
    """Forward: tokens, expert ids, results; the output gathered once over
    the expert axes, aux averaged once; grouped_local no collective."""
    for flags in runs["flags"]:
        assert flags[f"ep|{tag}|forward"] == {"all_to_all": 3, "all_gather": 1, "all_reduce": 1}
        assert flags["grouped|forward"] == {"all_to_all": 0, "all_gather": 0, "all_reduce": 0}


def test_ep_a2a_ranks_hold_only_their_experts(runs):
    """Experts given as DTensors sharded over "data" are used as each
    rank's local shard (2 of 8): the output is the same, and each expert
    gradient is this rank's shard of the whole one."""
    ref = runs["reference"]
    for out, flags in zip(runs["ranks"], runs["flags"]):
        assert flags["dtensor|local"] == [2, 32, 32]
        assert np.abs(out["dtensor|y"] - ref["ep|data|y"]).max() < TOL_EP
        d = flags["data"]
        for leaf in ("wg", "wu", "wd"):
            whole = ref[f"ep|data|g|{leaf}"]
            assert _rel(out[f"dtensor|g|{leaf}"], whole[2 * d:2 * d + 2]) < TOL_EP
        assert _rel(out["dtensor|g|router"], ref["ep|data|g|router"]) < TOL_EP


@pytest.mark.parametrize("name", list(CP_KW))
def test_flash_attention_cp_matches_the_reference_s(runs, name):
    for out in runs["ranks"]:
        assert np.abs(out[f"cp|{name}"] - runs["reference"][f"cp|{name}"]).max() < TOL_CP


def test_flash_attention_cp_q_gradient_matches_the_reference_s(runs):
    for out in runs["ranks"]:
        assert np.abs(out["cp|grad"] - runs["reference"]["cp|grad"]).max() < TOL_CP_GRAD


def test_flash_attention_cp_ranks_attend_at_their_own_offsets(runs):
    """Each rank of the model axis holds 32 of the 64 queries at offset
    axis_index · 32, in every call (three forward, one under grad); the
    axis indices are the mesh's row-major coordinates."""
    for r, flags in enumerate(runs["flags"]):
        assert (flags["data"], flags["model"], flags["both"]) == (r // 2, r % 2, r)
        assert flags["cp|offsets"] == [32 * flags["model"]] * 4


def test_gqa_apply_takes_the_cp_branch(runs):
    """Under ``activation_sharding(cp="model")`` with a batch of 4 over 4
    data ranks (which cannot fill the model axis) ``gqa_apply`` runs
    ``flash_attention_cp`` over "model", with the layer's result."""
    for out, flags in zip(runs["ranks"], runs["flags"]):
        assert flags["gqa|cp axes"] == ["model"]
        assert np.abs(out["gqa|cp"] - out["gqa|plain"]).max() < 1e-6


def test_restore_resharded_from_8x1_onto_2x4(runs):
    for flags in runs["flags"]:
        e = flags["elastic"]
        assert e["equal"] and e["meshes"] == [[2, 4]] and 0 < e["sharded"] <= e["leaves"]


def test_all_gather_in_a_body(runs):
    """``compat.all_gather`` over "data" inside a shard_map body gives every
    rank the whole argument (tiled, or stacked a block a rank), and the
    gradient through it is the cotangent once, not once a rank."""
    for flags in runs["flags"]:
        assert flags["all_gather|True"] == [[8, 16, 32], True, True]
        assert flags["all_gather|False"] == [[4, 2, 16, 32], True, True]


def test_mesh_builders(runs):
    for flags in runs["flags"]:
        assert flags["test mesh"] == [4, 2]
        assert "needs a process group of 256 ranks" in flags["production mesh"]


def test_distributed_training_equals_one_process(runs):
    """fourier_lm's masked loss at 2 ranks (each rank's gradient weighted by
    its share of the masked positions): the one process's losses within
    1e-5; rank 0 alone writes the checkpoint."""
    single = runs["single"]["fourier_lm"]
    for res in runs["train"]["fourier_lm"]:
        assert res["world"] == 2 and len(res["losses"]) == len(single) == 2
        for step, loss in single.items():
            assert abs(res["losses"][str(step)] - loss) <= 1e-5 * abs(loss)
        assert res["writes"] == (res["rank"] == 0)
    assert (runs["tmp"] / "ckpt0" / "step_2" / "manifest.json").exists()


def test_distributed_training_under_compression(runs):
    """Under ``--compress`` the group's mean is ``compressed_mean``'s: the
    first step's loss (before any update) is the one process's, and both
    ranks report the same losses."""
    single = runs["single"]["llama compress"]
    a, b = runs["train"]["llama compress"]
    assert a["losses"] == b["losses"]
    assert abs(a["losses"]["0"] - single[0]) <= 1e-5 * abs(single[0])
    assert all(np.isfinite(v) for v in a["losses"].values())


def test_to_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")

    assert to_placements(P(None, "data"), Mesh()) == [Shard(1), Replicate()]
    assert to_placements(P("model", None), Mesh()) == [Replicate(), Shard(0)]
    assert to_placements(P(), Mesh()) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="pod"):
        to_placements(P("pod"), Mesh())
