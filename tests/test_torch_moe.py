"""repro_torch.models.moe against repro.models.moe, on the CPU.

The same seeded numpy inputs go through the reference's jnp functions and
the port's on CPU tensors; weights are drawn by the reference's
``init_params`` and carried across by ``params_from_numpy``. Tolerances are
relative to the largest reference value: the router's gates and aux loss
to 1e-6 and its expert ids equal (float32 in both); the MoE block's output
to 1e-5 at float32 (sums in another order) and 3e-2 at bfloat16 (a few
bf16 roundings in other places), its aux loss to 1e-6.

Routing must make JAX's discrete choices: ``jax.lax.top_k`` gives equal
scores to the lower expert index, which the port's stable descending sort
reproduces (a sigmoid router's scores saturate at exactly 1.0 at the
reference's init, so ties are common there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models.param import init_params as jinit
from repro_torch import compat
from repro_torch.configs import registry as reg
from repro_torch.models import moe
from repro_torch.models import param

ARCHS = ["mixtral-8x22b", "deepseek-v3-671b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cfgs(arch, **moe_kw):
    """The smoke config with its MoEConfig changed by ``moe_kw``, in the
    port and in the reference."""
    cfg, jcfg = reg.smoke_config(arch), jreg.smoke_config(arch)
    return (cfg.scaled(moe=dataclasses.replace(cfg.moe, **moe_kw)),
            jcfg.scaled(moe=dataclasses.replace(jcfg.moe, **moe_kw)))


def _weights(cfg, jcfg, seed, router_scale=None):
    """The MoE block's weights as the reference draws them, in both forms."""
    from repro.models.moe import moe_skel as jmoe_skel

    jp = jinit(jmoe_skel(jcfg), jax.random.PRNGKey(seed))
    if router_scale is not None:
        jp["router"] = jp["router"] * router_scale
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), _t(x).to(getattr(torch, dtype))


def test_moe_skel_matches_reference():
    from repro.models.moe import moe_skel as jmoe_skel
    from repro.models.param import ParamDef as JParamDef

    for arch in ARCHS:
        cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
        leaves = param.tree_leaves(moe.moe_skel(cfg))
        jleaves = jax.tree.leaves(jmoe_skel(jcfg), is_leaf=lambda x: isinstance(x, JParamDef))
        assert [(d.shape, d.logical_axes, d.init) for d in leaves] == [
            (d.shape, d.logical_axes, d.init) for d in jleaves]


# ------------------------------ the router ------------------------------


@pytest.mark.parametrize("arch", ARCHS, ids=["softmax", "sigmoid"])
def test_router_matches_reference(arch):
    """Both norms: mixtral's softmax over the chosen logits, deepseek's
    normalised sigmoid scores; ids equal, gates and aux to 1e-6."""
    cfg, jcfg = _cfgs(arch, n_experts=16, top_k=4)
    jp, p = _weights(cfg, jcfg, 1)
    jx, x = _x((3, 20, cfg.d_model), 2)
    jg, ji, ja = jmoe._router(jp, jx, jcfg.moe)
    g, i, a = moe._router(p, x, cfg.moe)
    assert i.dtype == torch.int32 and g.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert _rel(g, jg) <= 1e-6
    assert abs(float(a) - float(ja)) <= 1e-6 * abs(float(ja))


def test_saturated_sigmoid_scores_route_by_the_lower_expert_index():
    """Observation (the reference's behaviour, ported as is): with logits
    of std ~85, as the router's init gives at one moe layer (fan_in is the
    stacked layer count), most sigmoid scores are exactly 1.0 or 0.0 in
    float32, and ``jax.lax.top_k`` takes the tied experts in index order.
    The port's ids equal the reference's on every token, and a row of ties
    routes to the lowest tied indices. (``torch.topk`` makes no such
    promise: on such rows its ids are not JAX's.)"""
    cfg, jcfg = _cfgs("deepseek-v3-671b", n_experts=32, top_k=8)
    jp, p = _weights(cfg, jcfg, 3, router_scale=85.0 * np.sqrt(cfg.d_model))
    jx, x = _x((4, 16, cfg.d_model), 4)
    jg, ji, _ = jmoe._router(jp, jx, jcfg.moe)
    g, i, _ = moe._router(p, x, cfg.moe)
    scores = torch.sigmoid(torch.matmul(x, p["router"]))
    ones = scores == 1.0
    assert float(ones.float().mean()) > 0.3  # saturated
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert _rel(g, jg) <= 1e-6
    # where more than k experts score 1.0, the k chosen are the lowest of them
    tied = ones.sum(-1) > cfg.moe.top_k
    assert bool(tied.any())
    lowest = torch.stack([torch.nonzero(r)[:cfg.moe.top_k, 0] for r in ones[tied]])
    assert torch.equal(i[tied].long(), lowest)


def test_top_k_is_a_stable_descending_sort():
    scores = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0], [3.0, -1.0, 3.0, 3.0, 2.0]])
    vals, ids = moe.top_k(scores, 3)
    jvals, jids = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert ids.tolist() == [[1, 2, 4], [0, 2, 3]]


# --------------------------- the dispatch paths ---------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 2.0], ids=["drops", "keeps all"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_rows_matches_reference(arch, capacity_factor, dtype):
    """``_moe_grouped_rows`` at a capacity that drops assignments
    (cf 0.5: capacity int(S·k/E·0.5)) and one that drops none: output 1e-5
    at float32, 3e-2 at bf16, aux 1e-6."""
    cfg, jcfg = _cfgs(arch, n_experts=8, top_k=2, capacity_factor=capacity_factor)
    jp, p = _weights(cfg, jcfg, 5)
    jx, x = _x((2, 24, cfg.d_model), 6, dtype)
    jy, ja = jmoe._moe_grouped_rows(jp, jx, jcfg.moe, jcfg.act)
    stats = {}
    y, a = moe._moe_grouped_rows(p, x, cfg.moe, cfg.act, stats)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert _rel(y, jy) <= (1e-5 if dtype == "float32" else 3e-2)
    assert abs(float(a) - float(ja)) <= 1e-6 * abs(float(ja))
    assert stats["capacity"] == max(1, int(24 * 2 / 8 * capacity_factor))
    dropped = stats["assignments"] - int(stats["kept"])
    assert (dropped > 0) == (capacity_factor < 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_small_matches_reference(dtype):
    cfg, jcfg = _cfgs("mixtral-8x22b", impl="dense_small")
    jp, p = _weights(cfg, jcfg, 7)
    jx, x = _x((2, 10, cfg.d_model), 8, dtype)
    jy, ja = jmoe._moe_dense_small(jp, jx, jcfg.moe, jcfg.act)
    y, a = moe._moe_dense_small(p, x, cfg.moe, cfg.act)
    assert y.dtype == x.dtype
    assert _rel(y, jy) <= (1e-5 if dtype == "float32" else 3e-2)
    assert abs(float(a) - float(ja)) <= 1e-6 * abs(float(ja))


@pytest.mark.parametrize("arch", ARCHS, ids=["routed only", "shared expert"])
@pytest.mark.parametrize("impl", ["grouped_local", "dense_small", "ep_a2a"])
def test_moe_apply_matches_reference(arch, impl):
    """``moe_apply`` with and without deepseek's shared expert, under each
    impl; ``ep_a2a`` without a mesh runs ``grouped_local``, as the
    reference's does."""
    cfg, jcfg = _cfgs(arch, impl=impl, ep_axes=("data",) if impl == "ep_a2a" else ())
    assert ("shared" in moe.moe_skel(cfg)) == (arch == "deepseek-v3-671b")
    jp, p = _weights(cfg, jcfg, 9)
    jx, x = _x((2, 12, cfg.d_model), 10)
    jy, ja = jmoe.moe_apply(jp, jx, jcfg)
    y, a = moe.moe_apply(p, x, cfg)
    assert _rel(y, jy) <= 1e-5
    assert abs(float(a) - float(ja)) <= 1e-6 * abs(float(ja))


def test_prefill_drops_over_capacity_assignments_and_decode_never_does():
    """Observation (the reference's behaviour, ported as is): a prefill of S
    tokens groups at capacity max(1, int(S·k/E·cf)) a row, so at the
    configs' cf 1.25 it drops the assignments over it, and the tokens whose
    experts are full lose them; a decode step (S = 1) has capacity 1 and k
    distinct experts, so it never drops. Hence at cf 1.25 a prefill and
    the decode steps over the same tokens are different functions; at
    cf = E/k capacity is S and they agree."""
    cfg, jcfg = _cfgs("mixtral-8x22b", n_experts=8, top_k=2, capacity_factor=1.25)
    jp, p = _weights(cfg, jcfg, 11)
    jx, x = _x((2, 32, cfg.d_model), 12)
    stats = {}
    y, _ = moe._moe_grouped_rows(p, x, cfg.moe, cfg.act, stats)
    jy, _ = jmoe._moe_grouped_rows(jp, jx, jcfg.moe, jcfg.act)
    assert _rel(y, jy) <= 1e-5
    assert stats["capacity"] == 10 and int(stats["kept"]) < stats["assignments"]
    # one token at a time: capacity 1, nothing dropped
    steps = []
    for t in range(x.shape[1]):
        one = {}
        steps.append(moe._moe_grouped_rows(p, x[:, t:t + 1], cfg.moe, cfg.act, one)[0])
        assert one["capacity"] == 1 and int(one["kept"]) == one["assignments"]
    steps = torch.cat(steps, dim=1)
    assert _rel(steps, y.numpy()) > 1e-2  # the dropped tokens differ
    wide, _ = _cfgs("mixtral-8x22b", n_experts=8, top_k=2, capacity_factor=8 / 2)
    full, _ = moe._moe_grouped_rows(p, x, wide.moe, wide.act)
    assert _rel(steps, full.numpy()) <= 1e-5


# ------------------------------ divergence 18 ------------------------------


def test_divergence_18_ep_a2a_under_a_mesh_with_its_axes_raises(tmp_path):
    """Divergence 18, closed: under a mesh that has the expert axes the port
    runs the reference's shard_map all-to-all dispatch (here a one-rank
    mesh, where every expert is local), which at this capacity equals
    grouped_local, aux included; under a mesh without them it runs
    grouped_local, as the reference does. (Many ranks:
    tests/test_torch_sharding.py.)"""
    import torch.distributed as dist

    cfg, _ = _cfgs("mixtral-8x22b", impl="ep_a2a", ep_axes=("data",))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    jp_cfg = reg.smoke_config("mixtral-8x22b")
    p = param.init_params(moe.moe_skel(jp_cfg), torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with compat.set_mesh(compat.make_mesh((1,), ("data",), device_type="cpu")):
            compat.reset_collectives()
            y_ep, aux_ep = moe.moe_apply(p, x, cfg)
            assert compat.COLLECTIVES["all_to_all"] == 3
        with compat.set_mesh(compat.make_mesh((1,), ("model",), device_type="cpu")):
            compat.reset_collectives()
            y, _ = moe.moe_apply(p, x, cfg)
            assert compat.COLLECTIVES["all_to_all"] == 0
    finally:
        dist.destroy_process_group()
    ref, aux = moe.moe_apply(p, x, dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="grouped_local")))
    assert torch.equal(y, ref)
    torch.testing.assert_close(y_ep, ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(aux_ep, aux, rtol=0, atol=1e-7)


def test_bf16_experts_are_drawn_a_chunk_at_a_time(monkeypatch):
    """``with_expert_dtype`` holds every moe layer's routed experts (wg,
    wu, wd) in bf16 and nothing else; ``init_params`` draws such a leaf in
    float32 DRAW_CHUNK elements at a time, at the reference's std (fan_in
    the stacked moe layer count), so no float32 copy of it is ever whole.
    A skeleton without moe layers comes back as it was."""
    from repro_torch.models.build import build

    cfg = reg.smoke_config("deepseek-v3-671b").scaled(d_model=64)
    skel = moe.with_expert_dtype(build(cfg).skeleton, torch.bfloat16)
    draws = []
    randn = torch.randn

    def counted(*shape, **kw):
        draws.append(int(np.prod(shape)))
        return randn(*shape, **kw)

    monkeypatch.setattr(param, "DRAW_CHUNK", 1000)
    monkeypatch.setattr(torch, "randn", counted)
    p = param.init_params(skel, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch, "randn", randn)
    experts = p["moe_layers"]["moe"]
    for key in ("wg", "wu", "wd"):
        assert experts[key].dtype == torch.bfloat16
        std = float(experts[key].float().std())
        assert abs(std - 1 / np.sqrt(experts[key].shape[0])) < 0.05 * std, key
    half = {id(experts[key]) for key in ("wg", "wu", "wd")}
    assert all(t.dtype == torch.float32 for t in param.tree_leaves(p) if id(t) not in half)
    assert max(draws) == max(t.numel() for t in param.tree_leaves(p) if id(t) not in half)
    assert 1000 in draws and experts["wg"].numel() > 1000
    dense = build(reg.smoke_config("llama3.2-3b")).skeleton
    assert moe.with_expert_dtype(dense, torch.bfloat16) == dense
