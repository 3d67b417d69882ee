"""repro_torch.models.xlstm and the xlstm-350m stack against repro's, on the CPU.

The same seeded numpy inputs go through the reference's jnp functions and
the port's on CPU tensors; weights are drawn by the reference's
``init_params`` and carried across by ``params_from_numpy``. Tolerances
are relative to the largest reference value: 1e-5 for the mLSTM forms at
float32 (sums in another order), 1e-4 for the blocks and the smoke model's
logits at float32 and 3e-2 for the blocks at bfloat16 (a few bf16
roundings, taken in other orders). Greedy tokens are held equal.

At bfloat16 the stack is held block by block, each port block given the
reference's input and state: the smoke model at its random init amplifies
a change of one bf16 rounding in its embeddings (4e-3) to 0.14 of the
largest logit even in float32, so two bf16 evaluations that round in other
places (XLA's fusions, torch's ops) part by more than 3e-2 at the logits
(the reference's own eager blocks and its compiled forward part by 0.31).

The sLSTM prefill runs ``repro_torch.kernels.slstm_scan.slstm_scan``
(divergence 15): on a CPU tensor its plain version, held here to the
reference's ``lax.scan`` of ``_slstm_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jT
from repro.models import xlstm as jx
from repro.models.build import build as jbuild
from repro_torch.configs import registry as reg
from repro_torch.models import param
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.build import build

ARCH = "xlstm-350m"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _cfgs(**kw):
    return reg.smoke_config(ARCH).scaled(**kw), jreg.smoke_config(ARCH).scaled(**kw)


def _layer(jskel, seed):
    """One layer's weights as the reference's init_params draws them
    (numpy), and as the port's tensors."""
    from repro.models.param import init_params

    jp = init_params(jskel, jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _state_pair(state_np: dict):
    return ({k: jnp.asarray(v) for k, v in state_np.items()},
            {k: _t(v) for k, v in state_np.items()})


def _mlstm_gates(rng, b, l, h, dh):
    q, k, v = (rng.standard_normal((b, l, h, dh)).astype(np.float32) for _ in range(3))
    log_i = rng.standard_normal((b, l, h)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-(rng.standard_normal((b, l, h)) + 2)))).astype(np.float32)
    return q, k, v, log_i, log_f


def _mlstm_state_np(rng, b, h, dh, fresh: bool):
    if fresh:
        return {"c": np.zeros((b, h, dh, dh), np.float32), "n": np.zeros((b, h, dh), np.float32),
                "m": np.full((b, h), -np.inf, np.float32)}
    return {"c": rng.standard_normal((b, h, dh, dh)).astype(np.float32) * 0.3,
            "n": rng.standard_normal((b, h, dh)).astype(np.float32) * 0.3,
            "m": rng.standard_normal((b, h)).astype(np.float32)}


# ------------------------------- mLSTM -------------------------------


def test_mlstm_parallel_matches_reference(rng):
    gates = _mlstm_gates(rng, 2, 20, 3, 8)
    ref = jx._mlstm_parallel(*(jnp.asarray(g) for g in gates))
    got = X._mlstm_parallel(*(_t(g) for g in gates))
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("fresh", [True, False], ids=["m -inf", "carried state"])
@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_mlstm_chunked_matches_reference(rng, fresh, chunk):
    b, l, h, dh = 2, 24, 3, 8
    gates = _mlstm_gates(rng, b, l, h, dh)
    js, ts = _state_pair(_mlstm_state_np(rng, b, h, dh, fresh))
    ref_y, ref_s = jx._mlstm_chunked(*(jnp.asarray(g) for g in gates), chunk, js)
    got_y, got_s = X._mlstm_chunked(*(_t(g) for g in gates), chunk, ts)
    assert _rel(got_y, ref_y) <= 1e-5
    for key in ("c", "n", "m"):
        assert _rel(got_s[key], ref_s[key]) <= 1e-5, key


def test_mlstm_chunked_equals_parallel_from_an_empty_state(rng):
    """The two forms of the reference's docstring agree in the port too."""
    b, l, h, dh = 2, 24, 3, 8
    gates = [_t(g) for g in _mlstm_gates(rng, b, l, h, dh)]
    _, ts = _state_pair(_mlstm_state_np(rng, b, h, dh, True))
    y, _ = X._mlstm_chunked(*gates, 8, ts)
    par = X._mlstm_parallel(*gates)
    assert _rel(y, par.numpy()) <= 1e-5


@pytest.mark.parametrize("fresh", [True, False], ids=["m -inf", "carried state"])
def test_mlstm_recurrent_step_matches_reference(rng, fresh):
    b, h, dh = 2, 3, 8
    q, k, v, log_i, log_f = (g[:, 0] for g in _mlstm_gates(rng, b, 1, h, dh))
    js, ts = _state_pair(_mlstm_state_np(rng, b, h, dh, fresh))
    ref_y, ref_s = jx._mlstm_recurrent_step(js, *(jnp.asarray(g) for g in (q, k, v, log_i, log_f)))
    got_y, got_s = X._mlstm_recurrent_step(ts, *(_t(g) for g in (q, k, v, log_i, log_f)))
    assert _rel(got_y, ref_y) <= 1e-5
    for key in ("c", "n", "m"):
        assert _rel(got_s[key], ref_s[key]) <= 1e-5, key


@pytest.mark.parametrize("l", [12, 300], ids=["L12", "L300 padded"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mlstm_apply_prefill_matches_reference(l, with_state, compute_dtype):
    """L 300 takes the padded path (two chunks of 256, the second padded
    with log_i = NEG_INF): the output and the state equal an unpadded
    reference's."""
    cfg, jcfg = _cfgs(compute_dtype=compute_dtype)
    jp, p = _layer(jx.mlstm_skel(jcfg), 1)
    rng = np.random.default_rng(l)
    b = 2
    x = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    jdt, dt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    js = ts = None
    if with_state:
        h, dh = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
        js, ts = _state_pair(_mlstm_state_np(rng, b, h, dh, False))
    ref_y, ref_s = jx.mlstm_apply(jp, jnp.asarray(x, jdt), jcfg, state=js)
    got_y, got_s = X.mlstm_apply(p, _t(x).to(dt), cfg, state=ts)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    assert got_y.dtype == dt and got_y.shape == ref_y.shape
    assert _rel(got_y, ref_y.astype(jnp.float32)) <= tol
    assert (got_s is None) == (ref_s is None)
    if with_state:
        for key in ("c", "n", "m"):
            assert got_s[key].dtype == torch.float32
            assert _rel(got_s[key], ref_s[key]) <= tol, key


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mlstm_apply_decode_matches_reference(compute_dtype):
    cfg, jcfg = _cfgs(compute_dtype=compute_dtype)
    jp, p = _layer(jx.mlstm_skel(jcfg), 2)
    rng = np.random.default_rng(5)
    b = 2
    h, dh = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    js, ts = _state_pair(_mlstm_state_np(rng, b, h, dh, False))
    jdt, dt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    for step in range(3):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        ref_y, js = jx.mlstm_apply(jp, jnp.asarray(x, jdt), jcfg, state=js, decode=True)
        got_y, ts = X.mlstm_apply(p, _t(x).to(dt), cfg, state=ts, decode=True)
        assert _rel(got_y, ref_y.astype(jnp.float32)) <= tol, step
        for key in ("c", "n", "m"):
            assert _rel(ts[key], js[key]) <= tol, (step, key)


def test_mlstm_state_starts_the_stabiliser_at_minus_inf():
    cfg, jcfg = _cfgs()
    got, ref = X.mlstm_state(cfg, 2, device="cpu"), jx.mlstm_state(jcfg, 2)
    for key in ("c", "n", "m"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    assert bool(torch.isneginf(got["m"]).all())


def test_mlstm_forget_bias_starts_at_one_whatever_its_scale():
    """A reference quirk, ported as it is: ``ParamDef(init="ones",
    scale=3.0)`` gives ones (``init_params`` ignores scale for "ones"), so
    the forget bias is 1.0, not 3.0, in both packages."""
    cfg, jcfg = _cfgs()
    d = X.mlstm_skel(cfg)["fb"]
    assert (d.init, d.scale) == ("ones", 3.0)
    jp, p = _layer(jx.mlstm_skel(jcfg), 0)
    assert np.all(np.asarray(jp["fb"]) == 1.0)
    got = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(got["mlstm_layers"]["fb"], torch.ones(cfg.n_layers // 2, cfg.n_heads))


# ------------------------------- sLSTM -------------------------------


def _slstm_state_np(rng, b, d, fresh: bool):
    if fresh:
        z = np.zeros((b, d), np.float32)
        return {"c": z, "n": z, "h": z, "m": np.full((b, d), -np.inf, np.float32)}
    return {"c": rng.standard_normal((b, d)).astype(np.float32) * 0.5,
            "n": np.abs(rng.standard_normal((b, d))).astype(np.float32) + 0.5,
            "h": np.tanh(rng.standard_normal((b, d))).astype(np.float32),
            "m": rng.standard_normal((b, d)).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_slstm_apply_prefill_matches_reference(with_state, compute_dtype):
    cfg, jcfg = _cfgs(compute_dtype=compute_dtype)
    jp, p = _layer(jx.slstm_skel(jcfg), 3)
    rng = np.random.default_rng(6)
    b, l = 2, 13
    x = rng.standard_normal((b, l, cfg.d_model)).astype(np.float32)
    js = ts = None
    if with_state:
        js, ts = _state_pair(_slstm_state_np(rng, b, cfg.d_model, False))
    jdt, dt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    ref_y, ref_s = jx.slstm_apply(jp, jnp.asarray(x, jdt), jcfg, state=js)
    got_y, got_s = X.slstm_apply(p, _t(x).to(dt), cfg, state=ts)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    assert got_y.dtype == dt and _rel(got_y, ref_y.astype(jnp.float32)) <= tol
    assert (got_s is None) == (ref_s is None)
    if with_state:
        for key in "cnhm":
            assert _rel(got_s[key], ref_s[key]) <= tol, key


@pytest.mark.parametrize("fresh", [True, False], ids=["m -inf", "carried state"])
def test_slstm_apply_decode_matches_reference(fresh):
    cfg, jcfg = _cfgs()
    jp, p = _layer(jx.slstm_skel(jcfg), 4)
    rng = np.random.default_rng(7)
    b = 2
    js, ts = _state_pair(_slstm_state_np(rng, b, cfg.d_model, fresh))
    for step in range(3):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        ref_y, js = jx.slstm_apply(jp, jnp.asarray(x), jcfg, state=js, decode=True)
        got_y, ts = X.slstm_apply(p, _t(x), cfg, state=ts, decode=True)
        assert _rel(got_y, ref_y) <= 1e-4, step
        for key in "cnhm":
            assert _rel(ts[key], js[key]) <= 1e-4, (step, key)


def test_slstm_prefill_runs_slstm_scan_and_equals_the_reference_scan(monkeypatch):
    """Divergence 15, pinned: the port's sLSTM prefill calls ``slstm_scan``
    once (chunk = L, here 300, where the wrapper's default tile of 256
    would not divide L) on ``xg = x @ wx`` and the layer's four states, where the
    reference runs ``lax.scan`` over ``_slstm_step``; on a CPU tensor the
    scan's plain version gives the reference's hidden states and final
    state."""
    cfg, jcfg = _cfgs()
    jp, p = _layer(jx.slstm_skel(jcfg), 5)
    rng = np.random.default_rng(8)
    b, l, d = 2, 300, cfg.d_model
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    calls = []
    real = X.slstm_scan

    def counted(xg, *args, **kw):
        calls.append((tuple(xg.shape), kw))
        out = real(xg, *args, **kw)
        calls[-1] += (out,)
        return out

    monkeypatch.setattr(X, "slstm_scan", counted)
    js, ts = _state_pair(_slstm_state_np(rng, b, d, True))
    X.slstm_apply(p, _t(x), cfg, state=ts)
    assert len(calls) == 1
    shape, kw, (hs, final) = calls[0]
    assert shape == (b, l, 4 * d) and kw == {"chunk": l}

    xg = jnp.einsum("bld,dk->blk", jnp.asarray(x), jp["wx"])

    def step(s, x_t):
        s2 = jx._slstm_step(jp, s, x_t, d)
        return s2, s2["h"]

    ref_final, ref_hs = jax.lax.scan(step, js, jnp.moveaxis(xg, 0, 1))
    assert _rel(hs, jnp.moveaxis(ref_hs, 0, 1)) <= 1e-5
    for key, got in zip("cnhm", final):
        assert _rel(got, ref_final[key]) <= 1e-5, key
    monkeypatch.undo()
    # a decode step is one slstm_step: no scan
    monkeypatch.setattr(X, "slstm_scan", counted)
    X.slstm_apply(p, _t(x[:, :1]), cfg, state=ts, decode=True)
    assert len(calls) == 1


@pytest.mark.parametrize("d", [32, 96, 1024])
def test_slstm_skeleton_matches_reference(d):
    """The feed-forward width: 4/3 d, rounded up to a multiple of 128 from
    d 96 on (1408 at xlstm-350m's d 1024)."""
    cfg, jcfg = _cfgs(d_model=d)
    got, ref = X.slstm_skel(cfg), jx.slstm_skel(jcfg)
    assert {k: (v.shape, v.init, v.scale) for k, v in got.items()} == {
        k: (v.shape, v.init, v.scale) for k, v in ref.items()}
    if d == 1024:
        assert got["ff_up"].shape == (1024, 1408)


# ------------------------------ the model ------------------------------


def _carried(jmodel, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_prefill_and_decode_logits_match_reference():
    compute_dtype = "float32"
    cfg, jcfg = _cfgs(compute_dtype=compute_dtype)
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 3)
    rng = np.random.default_rng(4)
    b, s = 2, 12
    toks = rng.integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    jc = jm.init_cache_fn(b, 32, jnp.float32)
    c = m.init_cache_fn(b, 32, torch.bfloat16, "cpu")
    assert all(t.dtype == torch.float32 for t in param.tree_leaves(c))  # whatever dtype
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
    for name in ("mlstm", "slstm"):
        for key in c[name]:
            assert _rel(c[name][key], jc[name][key]) <= tol, (name, key)
    # the whole forward's logits at every position, and the loss
    jfull, _, _ = jT.xlstm_forward(jp, jnp.asarray(toks), jcfg)
    got, _, _ = T.xlstm_forward(p, _t(toks), cfg)
    assert _rel(got, jfull) <= tol
    jloss, _ = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    loss, _ = m.loss_fn(p, {"tokens": _t(toks)})
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))


def _tensors(tree, dtype=None):
    return param.tree_map(lambda a: _t(np.asarray(a, np.float32)).to(dtype or torch.float32),
                          tree)


def test_bfloat16_stack_matches_reference_block_by_block():
    """Every block of the bf16 smoke model, a prefill of 12 then a decode
    step, each given the reference's input (rounded to bf16, as it is) and
    state: outputs and new states within 3e-2; the parameter-free pre-norm
    and the logits of the reference's last hidden too."""
    cfg, jcfg = _cfgs(compute_dtype="bfloat16")
    jm = jbuild(jcfg)
    jp, p = _carried(jm, 3)
    b, s = 2, 12
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    jc = jm.init_cache_fn(b, 32, jnp.float32)
    bf = torch.bfloat16
    for decode, tk in ((False, toks[:, :s]), (True, toks[:, s:])):
        jh = jnp.take(jp["embed"]["table"], jnp.asarray(tk), axis=0).astype(jnp.bfloat16)
        for i in range(cfg.n_layers // 2):
            for name, jfn, fn in (("mlstm", jx.mlstm_apply, X.mlstm_apply),
                                  ("slstm", jx.slstm_apply, X.slstm_apply)):
                jpl = jax.tree.map(lambda t: t[i], jp[f"{name}_layers"])
                pl = param.tree_map(lambda t: t[i], p[f"{name}_layers"])
                jst = jax.tree.map(lambda t: t[i], jc[name])
                jn = jT.rmsnorm_like(jh, jcfg)
                n = T.rmsnorm_like(_tensors(jh, bf), cfg)
                assert _rel(n, jn.astype(jnp.float32)) <= 3e-2
                jy, jnew = jfn(jpl, jn, jcfg, state=jst, decode=decode)
                y, new = fn(pl, _tensors(jn, bf), cfg, state=_tensors(jst), decode=decode)
                assert y.dtype == bf and _rel(y, jy.astype(jnp.float32)) <= 3e-2, (name, i)
                for key in new:
                    assert _rel(new[key], jnew[key]) <= 3e-2, (name, i, key)
                jc[name] = jax.tree.map(lambda c, u: c.at[i].set(u), jc[name], jnew)
                jh = jh + jy
    from repro.models.layers import rmsnorm as jrms
    from repro.models.layers import unembed as junembed
    from repro_torch.models.layers import rmsnorm, unembed

    ref = junembed(jp["unembed"], jrms(jp["final_norm"], jh, jcfg.rms_eps))
    got = unembed(p["unembed"], rmsnorm(p["final_norm"], _tensors(jh, bf), cfg.rms_eps))
    assert _rel(got, ref) <= 3e-2


@pytest.mark.parametrize("s", [8, 299])
def test_decode_after_a_prefill_of_s_equals_the_prefill_of_s_plus_one(s):
    """tests/models/test_arch_smoke.py::test_decode_matches_full_forward
    for xlstm, ported, and at s 299 across the mLSTM's padded chunk."""
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
    cfg, jcfg = _cfgs()
    jc = jbuild(jcfg).init_cache_fn(3, 16, jnp.bfloat16)
    c = build(cfg).init_cache_fn(3, 16, torch.bfloat16, "cpu")
    jl = jax.tree.leaves(jc)
    tl = param.tree_leaves(c)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert t.dtype == torch.float32 and str(a.dtype) == "float32"
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
