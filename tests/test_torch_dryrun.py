"""repro_torch.launch's dry-run against repro.launch's, on the CPU.

* ``model_flops`` and ``expert_param_count`` equal the reference's for all
  eleven architectures × four shapes at full width.
* On the 4×2 test mesh at smoke width (batch 8 × 32 tokens), the
  reference's step compiled by XLA in one subprocess with 8 fake devices
  (the placement of ``tests/launch/test_dryrun_small.py``; its optimizer
  state in bf16 for the reference dry-run's ``_BF16_OPT`` archs) against
  the port's meta count, on llama3.2-3b, mixtral-8x22b and xlstm-350m
  training and llama3.2-3b prefill and decode:
  - per-device argument bytes equal ``memory_analysis()`` exactly;
  - flops: the port's count within [0.75, 1.1] of ``loop_aware_cost``'s.
    The port charges each attention kernel its kept pairs and divides the
    step by the model axis; XLA costs the reference's blocked attention
    over every key block, counts each elementwise op of a fusion apart and
    runs the unsplit pieces (norms, router, embedding) on both model
    ranks, so the port reads 0.83-0.92 of it;
  - collectives, ``collective_stats``' once-per-body counts: total traffic
    within 2x; all-gathers (FSDP) within 2x in count and traffic; the
    reductions (the port's reduce-scatters and all-reduces against the
    reference's all-reduces: XLA's CPU backend lowers a gradient's
    reduce-scatter as an all-reduce of the whole gradient, twice the
    traffic) within 2x in traffic and 3x in count (XLA's combiner merges
    up to a dozen reductions into one tuple op, the port counts one a
    leaf); the resharding XLA adds between layouts (all-to-all,
    collective-permute), which the placement does not imply, at most 15%
    of the reference's traffic.
* Every architecture × shape kind runs on the test mesh at smoke width
  (``ok``, or the reference's skip reason), with the reference's JSON
  keys; llama3.2-3b's train_4k and decode_32k at full width on
  ``pod1_16x16``, on meta tensors alone.
* Each kernel entry's meta route gives its CPU plain version's shapes and
  dtypes, charges its ``cost`` and launches nothing; the cost formulas
  give PERF.md §6's bounds at its shapes.
* ``report``'s tables equal the reference's strings on the same rows.

About 40 s here, most of it the reference's five compiles.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import ALL_IDS, SHAPES, get_config, shape_skips, smoke_config
from repro_torch.kernels import _launch
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import fft_radix2 as fr
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, report
from repro_torch.launch.hlo_cost import CostCounter
from repro_torch.launch.roofline import PEAK_FLOPS_FP32, Roofline, expert_param_count, model_flops
from repro_torch.models.build import build

# the module (the package exports the function of the same name)
ss = importlib.import_module("repro_torch.kernels.slstm_scan")

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH = 32, 8
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
CELLS = ("llama3.2-3b:train", "mixtral-8x22b:train", "xlstm-350m:train",
         "llama3.2-3b:prefill", "llama3.2-3b:decode")

#: The keys of the reference's ``run_cell`` result for an ``ok`` cell.
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "n_devices", "kind", "lower_s", "compile_s",
                  "memory", "cost_xla_once_per_body", "cost", "collectives",
                  "collective_traffic_bytes", "collective_count", "schedule_head",
                  "top_collectives", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes", "total_bytes"}

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.registry import smoke_config, input_specs
from repro.launch.dryrun import _BF16_OPT
from repro.launch.hlo_analysis import collective_stats
from repro.launch.hlo_cost import loop_aware_cost
from repro.launch.mesh import make_test_mesh
from repro.models.build import build
from repro.optim import adamw_init
from repro.sharding import cache_specs, param_rules
from repro.sharding.ctx import activation_sharding
from repro.train.loop import TrainState, make_train_step

SEQ, BATCH = int(sys.argv[2]), int(sys.argv[3])
mesh = make_test_mesh()
named = lambda t: jax.tree.map(lambda sp: NamedSharding(mesh, sp), t,
                               is_leaf=lambda x: isinstance(x, P))
out = {}
for cell in sys.argv[4:]:
    arch, kind = cell.split(":")
    cfg = smoke_config(arch)
    model = build(cfg)
    pspecs = model.specs(param_rules(cfg, multi_pod=False, model_size=2))
    shape = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    specs = input_specs(cfg, shape, seq=SEQ, batch=BATCH)
    bspec = {k: P(("data",), *([None] * (len(v.shape) - 1))) for k, v in specs.items()}
    if kind == "train":
        params = model.abstract(jnp.float32)
        dt = jnp.bfloat16 if arch in _BF16_OPT else jnp.float32
        opt = jax.eval_shape(lambda p: adamw_init(p, dt), params)
        fn = make_train_step(model.loss_fn)
        args = (TrainState(params, opt, None), specs)
        shard = (named(TrainState(pspecs, {"mu": pspecs, "nu": pspecs, "step": P()}, None)),
                 named(bspec))
    else:
        params = model.abstract(jnp.bfloat16)
        caches = jax.eval_shape(lambda: model.init_cache_fn(BATCH, SEQ, jnp.bfloat16))
        cspecs = cache_specs(cfg, caches, BATCH, multi_pod=False, model_size=2)
        if kind == "prefill":
            fn = lambda p, b, c: model.prefill_fn(p, b, c)
            args = (params, specs, caches)
            shard = (named(pspecs), named(bspec), named(cspecs))
        else:
            fn = lambda p, t, pos, c: model.decode_fn(p, t, pos, c)
            args = (params, specs["token"], specs["pos"], caches)
            shard = (named(pspecs), named(P(("data",), None)), named(P()), named(cspecs))
    with compat.set_mesh(mesh), activation_sharding(dp=("data",), dp_sizes=(4,), tp="model",
                                                    tp_size=2):
        compiled = jax.jit(fn, in_shardings=shard).lower(*args).compile()
    hlo = compiled.as_text()
    lac = loop_aware_cost(hlo)
    out[cell] = {"argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
                 "flops": lac["flops"], "collectives": collective_stats(hlo)}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path), str(SEQ), str(BATCH),
                          *CELLS], capture_output=True, text=True, env=env, cwd=str(ROOT),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port():
    out = {}
    for cell in CELLS:
        arch, kind = cell.split(":")
        out[cell] = dryrun.run_cell(arch, KIND_SHAPE[kind], mesh="test_4x2",
                                    config=smoke_config(arch), seq=SEQ, batch=BATCH)
    return out


# ------------------------------ model flops ------------------------------


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_IDS)
def test_model_flops_equal_reference(arch, shape):
    from repro.configs.registry import get_config as jget_config
    from repro.launch import roofline as jroofline
    from repro.models.build import build as jbuild

    info = SHAPES[shape]
    cfg, jcfg = get_config(arch), jget_config(arch)
    skel, jskel = build(cfg).skeleton, jbuild(jcfg).skeleton
    assert expert_param_count(skel) == jroofline.expert_param_count(jskel)
    assert model_flops(cfg, skel, info["kind"], info["seq"], info["batch"]) == \
        jroofline.model_flops(jcfg, jskel, info["kind"], info["seq"], info["batch"])


# ------------------------- against the reference's compile -------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_reference(cell, reference, port):
    assert port[cell]["memory"]["argument_bytes"] == reference[cell]["argument_bytes"]
    if cell == "llama3.2-3b:train":
        assert port[cell]["memory"]["argument_bytes"] == 56_036


@pytest.mark.parametrize("cell", CELLS)
def test_flops_within_tolerance_of_reference(cell, reference, port):
    ratio = port[cell]["cost"]["flops"] / reference[cell]["flops"]
    assert 0.75 <= ratio <= 1.1, ratio


def _kinds(stats, *kinds):
    rows = [stats[k] for k in kinds if isinstance(stats.get(k), dict)]
    return sum(r["count"] for r in rows), sum(r["traffic_bytes"] for r in rows)


@pytest.mark.parametrize("cell", CELLS)
def test_collectives_within_tolerance_of_reference(cell, reference, port):
    ref, got = reference[cell]["collectives"], port[cell]["collectives"]
    total = sum(v["traffic_bytes"] for v in got.values())
    assert 0.5 <= total / ref["total_traffic_bytes"] <= 2.0
    n, t = _kinds(got, "all-gather")
    rn, rt = _kinds(ref, "all-gather")
    assert 0.5 <= n / rn <= 2.0 and 0.5 <= t / rt <= 2.0, (n, rn, t, rt)
    n, t = _kinds(got, "all-reduce", "reduce-scatter")
    rn, rt = _kinds(ref, "all-reduce", "reduce-scatter")
    assert 1 / 3 <= n / rn <= 3.0 and 0.5 <= t / rt <= 2.0, (n, rn, t, rt)
    _, rt = _kinds(ref, "all-to-all", "collective-permute")
    assert rt <= 0.15 * ref["total_traffic_bytes"]
    assert _kinds(got, "all-to-all", "collective-permute") == (0, 0)


# ------------------------------ every cell runs ------------------------------


@pytest.mark.parametrize("kind", list(KIND_SHAPE))
@pytest.mark.parametrize("arch", ALL_IDS)
def test_every_cell_runs_on_the_test_mesh(arch, kind):
    from repro.configs.registry import get_config as jget_config
    from repro.configs.registry import shape_skips as jshape_skips

    shape = KIND_SHAPE[kind]
    res = dryrun.run_cell(arch, shape, mesh="test_4x2", config=smoke_config(arch), seq=SEQ,
                          batch=BATCH)
    skip = jshape_skips(jget_config(arch), shape)
    if skip:
        assert res == {"arch": arch, "shape": shape, "mesh": "test_4x2", "status": "skip",
                       "reason": skip}
        return
    assert res["status"] == "ok" and REFERENCE_KEYS <= set(res)
    assert set(res["memory"]) == MEMORY_KEYS and res["n_devices"] == 8
    assert res["cost"]["flops"] > 0 and res["memory"]["argument_bytes"] > 0
    json.dumps(res)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_full_width_cells_on_the_production_mesh(shape):
    """llama3.2-3b at full width on pod1_16x16: 2-D batch (24 heads do not
    divide 16), so one sequence a device in training; nothing leaves the
    meta device."""
    cell = dryrun.build_cell("llama3.2-3b", shape, "pod1_16x16")
    counter, _ = dryrun.count_step(cell)
    assert counter.flops > 0 and counter.peak_bytes > 0
    assert all(t.device.type == "meta" for t in _tensors(cell.args))
    res = dryrun.run_cell("llama3.2-3b", shape)
    assert res["status"] == "ok" and REFERENCE_KEYS <= set(res) and res["n_devices"] == 256
    assert res["local_batch"] == (1 if shape == "train_4k" else 8)
    rl = res["roofline"]
    assert rl["model_flops_global"] == model_flops(cell.cfg, cell.model.skeleton, cell.kind,
                                                   cell.seq, cell.batch)
    if shape == "train_4k":
        # the counted step beside 6ND a device: remat's recompute and the
        # attention's pairs come on top
        assert 1.0 < rl["flops_per_device"] * 256 / rl["model_flops_global"] < 2.0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "tree"):
        return _tensors(tree.tree())
    return []


def test_cli_writes_the_reference_keys_and_fails_on_errors(tmp_path, monkeypatch):
    dryrun.main(["--arch", "xlstm-350m", "--shape", "long_500k", "--multi-pod", "both",
                 "--out", str(tmp_path), "--save-hlo", "--tag", "t"])
    for mesh in ("single", "multi"):
        res = json.loads((tmp_path / f"xlstm-350m__long_500k__{mesh}__t.json").read_text())
        assert res["status"] == "ok" and REFERENCE_KEYS <= set(res)
        assert "total" in (tmp_path / f"xlstm-350m__long_500k__{mesh}__t.ops.txt").read_text()

    def broken(*a, **k):
        raise RuntimeError("broken")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-3b", "--shape", "train_4k", "--multi-pod", "single",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    res = json.loads((tmp_path / "llama3.2-3b__train_4k__single.json").read_text())
    assert res["status"] == "error" and "broken" in res["error"]


# ------------------------------ kernel meta routes ------------------------------


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [s for o in out for s in _shapes(o)]


def _crandn(*shape):
    g = torch.Generator().manual_seed(0)
    return torch.complex(torch.randn(*shape, generator=g), torch.randn(*shape, generator=g))


def _slstm_inputs(b=2, l=8, d=32):
    g = torch.Generator().manual_seed(1)
    xg = torch.randn(b, l, 4 * d, generator=g)
    wr = torch.randn(4, d // 4, d, generator=g) * 0.1
    bias = torch.zeros(4 * d)
    states = [torch.zeros(b, d), torch.zeros(b, d), torch.zeros(b, d),
              torch.full((b, d), -1e30)]
    return xg, wr, bias, states


def _slstm_bwd_args():
    xg, wr, bias, states = _slstm_inputs()
    hs, final, saved = ss.slstm_scan_saving(xg, wr, bias, *states)
    c0, n0, _, m0 = states
    dfinal = tuple(torch.randn_like(t) for t in final)
    return (saved, wr, c0, n0, m0, torch.randn_like(hs), dfinal)


ENTRIES = {  # name: (call, inputs, {charged kernel: cost})
    "flash_attention_fwd": (
        lambda q, k, v: fa.flash_attention_fwd(q, k, v, causal=True, window=8),
        lambda: [torch.randn(3, 40, 16), torch.randn(3, 40, 16), torch.randn(3, 40, 8)],
        {"flash_attention_fwd": fa.fwd_cost(3, 40, 40, 16, 8, causal=True, window=8)}),
    "flash_attention_fwd lse offset": (
        lambda q, k, v: fa.flash_attention_fwd(q, k, v, return_lse=True, q_offset=24),
        lambda: [torch.randn(3, 16, 16), torch.randn(3, 40, 16), torch.randn(3, 40, 16)],
        {"flash_attention_fwd": fa.fwd_cost(3, 16, 40, 16, 16, q_offset=24, lse=True)}),
    "flash_attention_bwd": (
        lambda *a: fa.flash_attention_bwd(*a, causal=True),
        lambda: [torch.randn(3, 40, 16), torch.randn(3, 40, 16), torch.randn(3, 40, 8),
                 torch.randn(3, 40, 8), torch.randn(3, 40, 8), torch.randn(3, 40)],
        {"flash_attention_bwd": fa.bwd_cost(3, 40, 40, 16, 8, causal=True)}),
    "slstm_scan": (
        lambda xg, wr, bias, c, n, h, m: ss.slstm_scan(xg, wr, bias, c, n, h, m),
        lambda: [*_slstm_inputs()[:3], *_slstm_inputs()[3]],
        {"slstm_scan": ss.scan_cost(2, 8, 32)}),
    "slstm_scan_saving": (
        ss.slstm_scan_saving, lambda: [*_slstm_inputs()[:3], *_slstm_inputs()[3]],
        {"slstm_scan": ss.scan_cost(2, 8, 32, save=True)}),
    "slstm_scan_bwd": (
        lambda saved, wr, c0, n0, m0, dhs, dfinal: ss.slstm_scan_bwd(
            saved, wr, c0, n0, m0, dhs, dfinal),
        lambda: list(_slstm_bwd_args()),
        {"slstm_scan_bwd": ss.scan_bwd_cost(2, 8, 32)}),
    "fft_fused": (lambda x: fr.fft_fused(x, radix=4, inverse=True), lambda: [_crandn(6, 256)],
                  {"fft_fused": fr.fft_cost(6, 256)}),
    "fft_fused cluster": (lambda x: fr.fft_fused(x, radix=4), lambda: [_crandn(2, 2 ** 15)],
                          {"fft_cluster": fr.fft_cost(2, 2 ** 15)}),
    "fft_fused two pass": (lambda x: fr.fft_fused(x, radix=2), lambda: [_crandn(2, 2 ** 15)],
                           {"fft_two_pass": fr.fft_cost(2, 2 ** 15)}),
    "rfft_fused": (lambda x: fr.rfft_fused(x, radix=4), lambda: [torch.randn(6, 256)],
                   {"rfft_fused": fr.rfft_cost(6, 256)}),
    "irfft_fused": (lambda y: fr.irfft_fused(y, radix=4), lambda: [_crandn(6, 129)],
                    {"irfft_fused": fr.rfft_cost(6, 256)}),
    "fft2_fused": (lambda x: fr.fft2_fused(x, radix=4), lambda: [_crandn(3, 32, 64)],
                   {"fft2_fused": fr.fft2_cost(3, 32, 64)}),
    "rfft2_fused": (lambda x: fr.rfft2_fused(x, radix=4), lambda: [torch.randn(3, 32, 64)],
                    {"rfft2_fused": fr.rfft2_cost(3, 32, 64)}),
    "irfft2_fused": (lambda y: fr.irfft2_fused(y, radix=4), lambda: [_crandn(3, 32, 33)],
                     {"irfft2_fused": fr.rfft2_cost(3, 32, 64)}),
    "fft2_columns": (lambda x: fr.fft2_columns(x, radix=4), lambda: [_crandn(2, 64, 20)],
                     {"fft2_columns": fr.fft2_columns_cost(2, 64, 20)}),
    "butterfly_stage": (lambda re, im: bf.butterfly_stage(re, im, stage=3),
                        lambda: [torch.randn(4, 64), torch.randn(4, 64)],
                        {"butterfly_stage": bf.stage_cost(4, 64)}),
}


def _tree_meta(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_meta(e) for e in x)
    return _meta(x)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_kernel_meta_route(name):
    call, inputs, charges = ENTRIES[name]
    args = inputs()
    plain = call(*args)  # CPU: the plain version, uncharged
    _launch.reset_launches()
    with CostCounter() as counter:
        got = call(*_tree_meta(args))
    assert _shapes(got) == _shapes(plain)
    assert all(t.device.type == "meta" for t in _tensors(got))
    assert {k: (v["calls"], v["flops"], v["bytes"]) for k, v in counter.kernels.items()} == {
        k: (1, *cost) for k, cost in charges.items()}
    assert not any(_launch.LAUNCHES.values())
    with CostCounter() as cpu:
        call(*args)
    assert cpu.kernels == {}


def test_differentiable_entries_charge_forward_and_backward_on_meta():
    q, k, v = (torch.randn(2, 24, 8, device="meta", requires_grad=True) for _ in range(3))
    with CostCounter() as counter:
        fa.flash_attention(q, k, v).sum().backward()
    assert {n: r["calls"] for n, r in counter.kernels.items()} == {
        "flash_attention_fwd": 1, "flash_attention_bwd": 1}
    assert q.grad.shape == q.shape and q.grad.device.type == "meta"
    xg, wr, bias, states = (_tree_meta(x) for x in _slstm_inputs())
    xg.requires_grad_()
    with CostCounter() as counter:
        hs, _ = ss.slstm_scan(xg, wr, bias, *states)
        hs.sum().backward()
    assert {n: r["calls"] for n, r in counter.kernels.items()} == {
        "slstm_scan": 1, "slstm_scan_bwd": 1}
    assert not any(_launch.LAUNCHES.values())


def test_meta_key_plans_the_cards_route():
    """fourier_lm's mixing on meta: the card's planned fft_fused rows and
    fft2_columns, not a plain schedule."""
    from repro_torch import xfft

    x = torch.empty(8, 2048, 512, dtype=torch.complex64, device="meta")
    with CostCounter() as counter:
        y = xfft.fft2(x)
    assert y.shape == x.shape and y.device.type == "meta"
    assert counter.kernels == {
        "fft_fused": {"calls": 1, **fr.fft_cost(8 * 2048, 512)._asdict()},
        "fft2_columns": {"calls": 1, **fr.fft2_columns_cost(8, 2048, 512)._asdict()}}


# ------------------------------ cost formulas ------------------------------


def test_cost_formulas_give_perf_md_bounds():
    """The bounds of PERF.md §6's table, from the kernels' ``cost``: bytes
    over 3.35 TB/s, operations over 67 TFLOP/s (flash: 165, a third of
    dense TF32), to the digits the table prints."""
    def ms(cost, rate=67e12):
        return max(cost.bytes / 3.35e12, cost.flops / rate) * 1e3

    for got, table in ((ms(fa.fwd_cost(24, 4096, 4096, 128, 128), 165e12), 0.625),
                       (ms(fa.fwd_cost(24, 4096, 8192, 128, 128, q_offset=4096), 165e12), 1.874),
                       (ms(fa.fwd_cost(96, 1024, 1024, 128, 128), 165e12), 0.1563),
                       (ms(fa.bwd_cost(48, 1024, 1024, 128, 128), 165e12), 0.1954),
                       (ms(fa.bwd_cost(48, 512, 1024, 128, 128, q_offset=512), 165e12), 0.1465),
                       (ms(ss.scan_cost(8, 4096, 1024)), 1.026),
                       (ms(ss.scan_bwd_cost(8, 4096, 1024)), 1.026),
                       (ms(fr.fft_cost(8192, 2048)), 0.0801),
                       (ms(fr.rfft_cost(8192, 2048)), 0.0401),
                       (ms(fr.fft2_cost(512, 128, 128)), 0.0401),
                       (ms(fr.rfft2_cost(512, 128, 128)), 0.0202),
                       (ms(fr.fft2_columns_cost(32, 512, 512)), 0.0401),
                       (ms(bf.stage_cost(8192, 2048)), 0.0801)):
        assert round(got, len(str(table).split(".")[1])) == table, (got, table)
    assert fa.attention_pairs(4096, 4096, True, None) == 4096 * 4097 // 2


def test_counter_rules():
    a, b = torch.empty(4, 6, device="meta"), torch.empty(6, 5, device="meta")
    with CostCounter() as c:
        y = a @ b            # 2 |result| K
        z = torch.exp(y)     # elementwise
        z.t()                # views: nothing
        z.reshape(-1)
        del y
    assert c.flops == 2 * 20 * 6 + 20 and c.transcendentals == 20
    assert c.bytes == 2 * 80 + 2 * 80 and c.peak_bytes == 160


def test_charge_computes_a_cost_only_under_a_counter():
    """A kernel call outside a counter computes no cost; nested counters
    each get the charge once, and leave the registry as they found it."""
    calls = []

    def cost(*args, **kwargs):
        calls.append((args, kwargs))
        return _launch.Cost(flops=3.0, bytes=8.0)

    _launch.charge("fft_fused", cost, 2, n=4)
    assert calls == [] and _launch.COUNTERS == []
    with CostCounter() as outer, CostCounter() as inner:
        _launch.charge("fft_fused", cost, 2, n=4)
    assert calls == [((2,), {"n": 4})] and _launch.COUNTERS == []
    for c in (outer, inner):
        assert c.kernels == {"fft_fused": {"calls": 1, "flops": 3.0, "bytes": 8.0}}
        assert (c.flops, c.bytes) == (3.0, 8.0)


# ------------------------------ roofline, report, moe ------------------------------


def test_roofline_keys_and_the_planners_three_terms():
    from repro.launch.roofline import Roofline as JRoofline

    three = Roofline(67e12, 3.35e12, 0.0)
    assert three.compute_s == 1.0 == 67e12 / PEAK_FLOPS_FP32 and three.step_time_s == 1.0
    got = Roofline(1e12, 1e11, 1e9, 16, 4e12).to_dict()
    want = JRoofline(1e12, 1e11, 1e9, 16, 4e12).to_dict()
    assert list(got) == list(want)
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]


def test_report_tables_equal_reference(tmp_path):
    from repro.launch import report as jreport

    rows = [dryrun.run_cell(arch, shape, mesh=mesh, config=smoke_config(arch), seq=SEQ,
                            batch=BATCH)
            for arch, shape in (("llama3.2-3b", "train_4k"), ("xlstm-350m", "decode_32k"),
                                ("llama3.2-3b", "long_500k"))
            for mesh in ("pod1_16x16", "pod2_2x16x16")]
    rows.append({"arch": "x", "shape": "train_4k", "mesh": "pod1_16x16", "status": "error",
                 "error": "E"})
    for i, r in enumerate(rows):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    loaded = report.load(str(tmp_path))
    assert loaded == jreport.load(str(tmp_path))
    assert report.roofline_table(loaded) == jreport.roofline_table(loaded)
    assert report.roofline_table(loaded, "pod2_2x16x16") == jreport.roofline_table(
        loaded, "pod2_2x16x16")
    assert report.dryrun_table(loaded) == jreport.dryrun_table(loaded)
    assert "*skip*" in report.roofline_table(loaded) and "**ERROR**" in report.dryrun_table(
        loaded)


def test_moe_expert_counts_equal_bincount():
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig

    m = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 20, 16, generator=g)
    p = {"router": torch.randn(16, 8, generator=g)}
    _, ids, aux = moe._router(p, x, m)
    probs = torch.softmax(torch.matmul(x.float(), p["router"].float()), dim=-1)
    frac = torch.bincount(ids.reshape(-1).long(), minlength=8).float() / 60
    want = 8 * torch.sum(frac / 2 * probs.reshape(-1, 8).mean(dim=0))
    assert torch.equal(aux, want)
    _, ids_m, aux_m = moe._router({"router": p["router"].to("meta")}, x.to("meta"), m)
    assert ids_m.shape == ids.shape and aux_m.shape == () and aux_m.device.type == "meta"
