"""repro_torch.models.ssm and the zamba2-2.7b hybrid stack against repro's, on the CPU.

The same seeded numpy inputs go through the reference's jnp functions and
the port's on CPU tensors; weights are drawn by the reference's
``init_params`` and carried across by ``params_from_numpy``. Tolerances
are relative to the largest reference value: 1e-5 for the SSD pieces at
float32 (sums in another order), 1e-4 for the Mamba2 block and the smoke
model's logits at float32 and 3e-2 for the blocks at bfloat16 (a few bf16
roundings, taken in other orders).

At bfloat16 the stack is held block by block, each port block given the
reference's input and state: the smoke model at its random init amplifies
a change of one bf16 rounding in its embeddings (4e-3) to 0.42 of the
largest logit even in float32 (each Mamba2 layer replaces x, no residual),
so two bf16 evaluations that round in other places (XLA's fusions, torch's
ops) part by more than 3e-2 at the logits (the reference's own eager
blocks and its compiled forward part by 0.125).

The smoke config (d 32, 4 layers, the shared block every 2, SSM chunk 8)
runs the shared attention block twice; prompts of 13 tokens pad the SSD's
last chunk of 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro.models.build import build as jbuild
from repro.models.param import init_params as jinit
from repro_torch.configs import registry as reg
from repro_torch.models import param
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.build import build

ARCH = "zamba2-2.7b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cfgs(**kw):
    return reg.smoke_config(ARCH).scaled(**kw), jreg.smoke_config(ARCH).scaled(**kw)


def _layer(cfg_ref, seed):
    jp = jinit(jssm.mamba2_skel(cfg_ref), jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _state_np(cfg, rng, b):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    return {"ssd": rng.standard_normal((b, nh, s.head_dim, s.d_state)).astype(np.float32) * 0.3,
            "conv": rng.standard_normal((b, s.d_conv - 1, d_in + 2 * s.d_state))
            .astype(np.float32) * 0.5}


# ------------------------------- pieces -------------------------------


def _ssd_inputs(rng, b, l, h, p, n):
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, bm, cm, d_skip


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(rng, chunk, with_state):
    b, l, h, p, n = 2, 24, 3, 4, 5
    args = _ssd_inputs(rng, b, l, h, p, n)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    ref_y, ref_s = jssm._ssd_chunked(*(jnp.asarray(x) for x in args), chunk,
                                     init_state=None if init is None else jnp.asarray(init))
    got_y, got_s = ssm._ssd_chunked(*(_t(x) for x in args), chunk,
                                    init_state=None if init is None else _t(init))
    assert got_y.shape == ref_y.shape and got_s.shape == ref_s.shape
    assert _rel(got_y, ref_y) <= 1e-5
    assert _rel(got_s, ref_s) <= 1e-5


def test_ssd_chunked_equals_the_recurrence(rng):
    """The chunked form against the recurrence it decomposes,
    h_t = h_{t-1} e^{dt a} + dt B ⊗ x, y = C h_t + D x, in float64."""
    b, l, h, p, n = 2, 16, 3, 4, 5
    x, dt, a, bm, cm, d_skip = _ssd_inputs(rng, b, l, h, p, n)
    got, final = ssm._ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm, d_skip)), 4)
    st = np.zeros((b, h, p, n))
    ys = []
    for t in range(l):
        st = st * np.exp(dt[:, t] * a)[..., None, None] + \
            (dt[:, t, :, None, None] * x[:, t, :, :, None] * bm[:, t, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", st, cm[:, t]) + x[:, t] * d_skip[:, None])
    assert _rel(got, np.stack(ys, 1)) <= 1e-5
    assert _rel(final, st) <= 1e-5


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(rng, with_state):
    b, l, c, k = 2, 7, 6, 4
    xbc = rng.standard_normal((b, l, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    st = rng.standard_normal((b, k - 1, c)).astype(np.float32) if with_state else None
    ref, ref_s = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
                                   None if st is None else jnp.asarray(st))
    got, got_s = ssm._causal_conv(_t(xbc), _t(w), _t(bias), None if st is None else _t(st))
    assert _rel(got, ref) <= 1e-6
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_gated_rmsnorm_and_split_match_reference(rng):
    y = rng.standard_normal((2, 5, 16)).astype(np.float32)
    z = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    ref = jssm._gated_rmsnorm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(w))
    assert _rel(ssm._gated_rmsnorm(_t(y), _t(z), _t(w)), ref) <= 1e-6
    zz = rng.standard_normal((2, 5, 2 * 8 + 2 * 3 + 2)).astype(np.float32)
    for got, want in zip(ssm._split_proj(_t(zz), 8, 3, 2), jssm._split_proj(zz, 8, 3, 2)):
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------- the block -------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba2_apply_prefill_matches_reference(with_state, compute_dtype):
    """L 13 pads the last chunk of 8 with dt = 0 (decay 1, no injection):
    the output and the final state equal the reference's."""
    cfg, jcfg = _cfgs(compute_dtype=compute_dtype)
    jp, p = _layer(jcfg, 1)
    rng = np.random.default_rng(13)
    b, l = 2, 13
    x = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    js = ts = None
    if with_state:
        st = _state_np(cfg, rng, b)
        js, ts = {k: jnp.asarray(v) for k, v in st.items()}, {k: _t(v) for k, v in st.items()}
    jdt, dt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    ref_y, ref_s = jssm.mamba2_apply(jp, jnp.asarray(x, jdt), jcfg, state=js)
    got_y, got_s = ssm.mamba2_apply(p, _t(x).to(dt), cfg, state=ts)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    assert got_y.dtype == dt and got_y.shape == ref_y.shape
    assert _rel(got_y, ref_y.astype(jnp.float32)) <= tol
    for key in ("ssd", "conv"):
        assert got_s[key].dtype == torch.float32
        assert _rel(got_s[key], ref_s[key]) <= tol, key


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba2_apply_decode_matches_reference(compute_dtype):
    cfg, jcfg = _cfgs(compute_dtype=compute_dtype)
    jp, p = _layer(jcfg, 2)
    rng = np.random.default_rng(14)
    b = 2
    st = _state_np(cfg, rng, b)
    js, ts = {k: jnp.asarray(v) for k, v in st.items()}, {k: _t(v) for k, v in st.items()}
    jdt, dt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    for step in range(3):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        ref_y, js = jssm.mamba2_apply(jp, jnp.asarray(x, jdt), jcfg, state=js, decode=True)
        got_y, ts = ssm.mamba2_apply(p, _t(x).to(dt), cfg, state=ts, decode=True)
        assert _rel(got_y, ref_y.astype(jnp.float32)) <= tol, step
        for key in ("ssd", "conv"):
            assert _rel(ts[key], js[key]) <= tol, (step, key)


def test_mamba2_a_is_minus_one_at_init():
    """A reference quirk, ported as it is: ``a_log`` starts at zeros, so
    a = −exp(a_log) = −1 on every head (and dt_bias 0, D 1)."""
    cfg, jcfg = _cfgs()
    jp, p = _layer(jcfg, 0)
    for got, ref in ((p, jp),):
        assert np.all(np.asarray(ref["a_log"]) == 0) and bool((got["a_log"] == 0).all())
    a = -torch.exp(p["a_log"].float())
    assert torch.equal(a, -torch.ones_like(a))
    assert bool((p["d_skip"] == 1).all()) and bool((p["dt_bias"] == 0).all())


def test_mamba2_state_and_skeleton_match_reference():
    cfg, jcfg = _cfgs()
    got, ref = ssm.mamba2_state(cfg, 3, device="cpu"), jssm.mamba2_state(jcfg, 3)
    for key in ("ssd", "conv"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for full in (False, True):
        c = reg.get_config(ARCH) if full else cfg
        jc = jreg.get_config(ARCH) if full else jcfg
        skel, jskel = ssm.mamba2_skel(c), jssm.mamba2_skel(jc)
        assert {k: (v.shape, v.logical_axes, v.init, v.scale) for k, v in skel.items()} == {
            k: (v.shape, v.logical_axes, v.init, v.scale) for k, v in jskel.items()}


# ------------------------------ the model ------------------------------


def _carried(jmodel, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_shared_block_config_matches_reference():
    """At full width the shared block runs at d_model 5120 with 32 heads of
    160 (kv 32), 9 times in 54 layers."""
    cfg, jcfg = reg.get_config(ARCH), jreg.get_config(ARCH)
    got, ref = T._shared_block_cfg(cfg), jT._shared_block_cfg(jcfg)
    assert (got.d_model, got.resolved_head_dim, got.n_kv_heads) == (5120, 160, 32)
    assert (ref.d_model, ref.resolved_head_dim) == (got.d_model, got.resolved_head_dim)
    assert T._n_shared_invocations(cfg) == jT._n_shared_invocations(jcfg) == 9
    smoke, jsmoke = _cfgs()
    assert T._n_shared_invocations(smoke) == jT._n_shared_invocations(jsmoke) == 2


def test_prefill_and_decode_logits_match_reference():
    cfg, jcfg = _cfgs()
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 3)
    rng = np.random.default_rng(4)
    b, s = 2, 13
    toks = rng.integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    jc = jm.init_cache_fn(b, 32, jnp.float32)
    c = m.init_cache_fn(b, 32, torch.float32, "cpu")
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc)
    l, c2 = m.prefill_fn(p, {"tokens": _t(toks[:, :s])}, c)
    assert c2 is c  # written in place
    tol = 1e-4
    assert l.shape == jl.shape and l.dtype == torch.float32
    assert _rel(l, jl) <= tol
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jd, jc = jm.decode_fn(jp, jnp.asarray(tok), jnp.asarray(s + i, jnp.int32), jc)
        d, c = m.decode_fn(p, _t(tok), s + i, c)
        assert _rel(d, jd) <= tol, i
    for key in ("ssd", "conv"):
        assert _rel(c["mamba"][key], jc["mamba"][key]) <= tol, key
    for key in ("k", "v"):
        assert _rel(c["shared"][key], jc["shared"][key]) <= tol, key
    np.testing.assert_array_equal(c["shared"]["slot_pos"].numpy(),
                                  np.asarray(jc["shared"]["slot_pos"]))
    jfull, _, _ = jT.hybrid_forward(jp, jnp.asarray(toks), jcfg)
    got, _, _ = T.hybrid_forward(p, _t(toks), cfg)
    assert _rel(got, jfull) <= tol
    jloss, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    loss, _ = m.loss_fn(p, {"tokens": _t(toks)})
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))


def _tensors(tree, dtype=None):
    return param.tree_map(lambda a: _t(np.asarray(a, np.float32)).to(dtype or torch.float32),
                          tree)


def _reference_shared_block(p, jh, jh0, jcfg, positions, cache, decode, pos):
    """The reference's shared-block invocation, as ``hybrid_forward``
    writes it inline."""
    from repro.models import attention as jattn
    from repro.models.layers import mlp as jmlp
    from repro.models.layers import rmsnorm as jrms

    xa = jnp.concatenate([jh, jh0], axis=-1)
    h = jrms(p["ln1"], xa, jcfg.rms_eps)
    a, new_cache = jattn.gqa_apply(p["attn"], h, jT._shared_block_cfg(jcfg), positions=positions,
                                   cache=cache, decode=decode)
    xa = xa + a
    xa = xa + jmlp(p["mlp"], jrms(p["ln2"], xa, jcfg.rms_eps), jcfg.act)
    return jh + jnp.einsum("bsk,kd->bsd", xa, p["proj"]["down"].astype(jh.dtype)), new_cache


def test_bfloat16_stack_matches_reference_block_by_block():
    """Every Mamba2 layer and shared-block invocation of the bf16 smoke
    model, a prefill of 13 (a padded chunk) then a decode step, each given
    the reference's input (rounded to bf16, as it is), state and KV cache:
    outputs, states and caches within 3e-2; the logits of the reference's
    last hidden too."""
    cfg, jcfg = _cfgs(compute_dtype="bfloat16")
    jm = jbuild(jcfg)
    jp, p = _carried(jm, 3)
    b, s = 2, 13
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    jc = jm.init_cache_fn(b, 32, jnp.float32)
    bf = torch.bfloat16
    n_inv = T._n_shared_invocations(cfg)
    group = cfg.n_layers // n_inv
    for decode, tk, pos in ((False, toks[:, :s], 0), (True, toks[:, s:], s)):
        jh0 = jnp.take(jp["embed"]["table"], jnp.asarray(tk), axis=0).astype(jnp.bfloat16)
        jh = jh0
        positions = pos + np.broadcast_to(np.arange(tk.shape[1], dtype=np.int32), tk.shape)
        for gi in range(n_inv):
            for i in range(gi * group, (gi + 1) * group):
                jpl = jax.tree.map(lambda t: t[i], jp["mamba_layers"])
                pl = param.tree_map(lambda t: t[i], p["mamba_layers"])
                jst = jax.tree.map(lambda t: t[i], jc["mamba"])
                jy, jnew = jssm.mamba2_apply(jpl, jh, jcfg, state=jst, decode=decode)
                y, new = ssm.mamba2_apply(pl, _tensors(jh, bf), cfg, state=_tensors(jst),
                                          decode=decode)
                assert y.dtype == bf and _rel(y, jy.astype(jnp.float32)) <= 3e-2, i
                for key in new:
                    assert _rel(new[key], jnew[key]) <= 3e-2, (i, key)
                jc["mamba"] = jax.tree.map(lambda c, u: c.at[i].set(u), jc["mamba"], jnew)
                jh = jy
            jkv = jax.tree.map(lambda t: t[gi], jc["shared"])
            kv = param.tree_map(lambda a: _t(np.asarray(a)), jkv)
            jy, jkv = _reference_shared_block(jp["shared"], jh, jh0, jcfg, jnp.asarray(positions),
                                              jkv, decode, pos)
            y = T.shared_block_apply(p["shared"], _tensors(jh, bf), _tensors(jh0, bf), cfg,
                                     positions=_t(positions), cache=kv, decode=decode, pos=pos)
            assert y.dtype == bf and _rel(y, jy.astype(jnp.float32)) <= 3e-2, gi
            for key in ("k", "v"):
                assert _rel(kv[key], jkv[key]) <= 3e-2, (gi, key)
            np.testing.assert_array_equal(kv["slot_pos"].numpy(), np.asarray(jkv["slot_pos"]))
            jc["shared"] = jax.tree.map(lambda c, u: c.at[gi].set(u), jc["shared"], jkv)
            jh = jy
    from repro.models.layers import rmsnorm as jrms
    from repro.models.layers import unembed as junembed
    from repro_torch.models.layers import rmsnorm, unembed

    ref = junembed(jp["unembed"], jrms(jp["final_norm"], jh, jcfg.rms_eps))
    got = unembed(p["unembed"], rmsnorm(p["final_norm"], _tensors(jh, bf), cfg.rms_eps))
    assert _rel(got, ref) <= 3e-2


@pytest.mark.parametrize("n_layers", [4, 5])
def test_layers_past_the_last_group_are_not_run(n_layers):
    """As in the reference: 5 layers with the shared block every 2 run two
    groups of 2, and the fifth layer's weights change nothing."""
    cfg, jcfg = _cfgs(n_layers=n_layers)
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    ref, _, _ = jT.hybrid_forward(jp, jnp.asarray(toks), jcfg)
    got, _, _ = T.hybrid_forward(p, _t(toks), cfg)
    assert _rel(got, ref) <= 1e-4
    if n_layers == 5:
        p["mamba_layers"]["in_proj"][4].mul_(3.0)
        again, _, _ = T.hybrid_forward(p, _t(toks), cfg)
        assert torch.equal(again, got)


@pytest.mark.parametrize("s", [8, 13])
def test_decode_after_a_prefill_of_s_equals_the_prefill_of_s_plus_one(s):
    """tests/models/test_arch_smoke.py::test_decode_matches_full_forward
    for zamba2, ported, and at s 13 across the SSD's padded chunk."""
    cfg = reg.smoke_config(ARCH)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(2)
    b = 2
    toks = _t(rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32))
    full, _ = model.prefill_fn(params, {"tokens": toks},
                               model.init_cache_fn(b, 32, torch.float32, "cpu"))
    caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    _, caches = model.prefill_fn(params, {"tokens": toks[:, :s]}, caches)
    dec, _ = model.decode_fn(params, toks[:, s:], s, caches)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_init_cache_matches_reference_leaf_for_leaf():
    """Float32 Mamba2 states whatever dtype; the shared KV caches in it."""
    cfg, jcfg = _cfgs()
    jc = jbuild(jcfg).init_cache_fn(3, 16, jnp.bfloat16)
    c = build(cfg).init_cache_fn(3, 16, torch.bfloat16, "cpu")
    jl = jax.tree.leaves(jc)
    tl = param.tree_leaves(c)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
