"""repro_torch's MLA (multi-head latent attention) against repro's, on the CPU.

The same seeded numpy inputs go through the reference's jnp
``mla_apply`` and the port's on CPU tensors; weights are drawn by the
reference's ``init_params`` and carried across by ``params_from_numpy``.
Outputs and cache leaves are held to 1e-5 of the largest reference value
at float32 (sums in another order), 3e-2 at bfloat16 (a few bf16
roundings in other places); ``slot_pos`` is held equal. The prefill's
attention is the port's ``flash_attention`` at D = nope + rope against
Dv (on a CPU tensor its plain twin; on the card ``flash_attention_fwd``),
the decode step the reference's absorbed one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models.param import ParamDef as JParamDef
from repro.models.param import init_params as jinit
from repro_torch.configs import registry as reg
from repro_torch.models import attention as attn
from repro_torch.models import param

ARCH = "deepseek-v3-671b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _setup(seed, dtype="float32"):
    cfg = reg.smoke_config(ARCH).scaled(compute_dtype=dtype)
    jcfg = jreg.smoke_config(ARCH).scaled(compute_dtype=dtype)
    jp = jinit(jattn.mla_skel(jcfg), jax.random.PRNGKey(seed))
    # q_norm and kv_norm away from their init of ones, so the norms' weights count
    rng = np.random.default_rng(seed)
    for key in ("q_norm", "kv_norm"):
        jp[key] = jnp.asarray(1.0 + 0.3 * rng.standard_normal(jp[key].shape), jnp.float32)
    return cfg, jcfg, jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _positions(b, s, pos0=0):
    return np.broadcast_to(np.arange(pos0, pos0 + s, dtype=np.int32), (b, s)).copy()


def test_mla_skel_and_cache_match_reference():
    """Full width: the same leaves, shapes, axes and init (``q_norm`` and
    ``kv_norm`` ones); the empty cache's leaves, shapes and values."""
    cfg, jcfg = reg.get_config(ARCH), jreg.get_config(ARCH)
    leaves = param.tree_leaves(attn.mla_skel(cfg))
    jleaves = jax.tree.leaves(jattn.mla_skel(jcfg), is_leaf=lambda x: isinstance(x, JParamDef))
    assert [(d.shape, d.logical_axes, d.init) for d in leaves] == [
        (d.shape, d.logical_axes, d.init) for d in jleaves]
    assert attn.mla_skel(cfg)["q_norm"].init == "ones" == attn.mla_skel(cfg)["kv_norm"].init
    scfg, sjcfg = reg.smoke_config(ARCH), jreg.smoke_config(ARCH)
    c = attn.make_mla_cache(scfg, 3, 20, torch.float32, "cpu")
    jc = jattn.make_mla_cache(sjcfg, 3, 20, jnp.float32)
    assert sorted(c) == sorted(jc)
    for key in c:
        np.testing.assert_array_equal(c[key].numpy(), np.asarray(jc[key]))
    assert c["slot_pos"].dtype == torch.int32 and c["c_kv"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latent_norm_is_rmsnorm(dtype):
    """MLA's latent norm, the reference's ``_rms`` (x in its dtype times the
    float32 rsqrt cast to it, then the weight), is the port's ``rmsnorm``
    with the weight as its scale."""
    from repro_torch.models.layers import rmsnorm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    w = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    ref = jattn._rms(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w))
    got = rmsnorm({"scale": _t(w)}, _t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_len", [32, 10], ids=["cache", "cache shorter than prompt"])
def test_mla_prefill_then_decode_matches_reference(dtype, max_len):
    """A prefill of 12 into a cache of ``max_len`` (10: the last 10 kept,
    as the reference keeps them, and each decode step then written to
    slot pos % 10), then 4 absorbed decode steps: every
    output and the c_kv / k_rope leaves to 1e-5 (float32) or 3e-2 (bf16),
    slot_pos equal, after each call."""
    cfg, jcfg, jp, p = _setup(2, dtype)
    b, s = 2, 12
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s + 4, cfg.d_model)).astype(np.float32)
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    jc = jattn.make_mla_cache(jcfg, b, max_len, jnp.float32)
    c = attn.make_mla_cache(cfg, b, max_len, torch.float32, "cpu")
    pos = _positions(b, s)
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x[:, :s], jdt), jcfg, positions=jnp.asarray(pos),
                             cache=jc)
    y, c = attn.mla_apply(p, _t(x[:, :s]).to(dt), cfg, positions=_t(pos), cache=c)
    assert y.dtype == dt and tuple(y.shape) == jy.shape
    assert _rel(y, jy) <= tol

    def same_cache():
        np.testing.assert_array_equal(c["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
        for key in ("c_kv", "k_rope"):
            assert _rel(c[key], jc[key]) <= tol, key

    same_cache()
    for i in range(4):
        step = _positions(b, 1, s + i)  # past a short cache: slot pos % size, as the reference
        jy, jc = jattn.mla_apply(jp, jnp.asarray(x[:, s + i:s + i + 1], jdt), jcfg,
                                 positions=jnp.asarray(step), cache=jc, decode=True)
        y, c = attn.mla_apply(p, _t(x[:, s + i:s + i + 1]).to(dt), cfg, positions=_t(step),
                              cache=c, decode=True)
        assert y.dtype == dt and _rel(y, jy) <= tol, i
        same_cache()


def test_mla_without_a_cache_matches_reference():
    """The cacheless forward (loss_fn's and the MTP block's)."""
    cfg, jcfg, jp, p = _setup(4)
    x = np.random.default_rng(5).standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    pos = _positions(3, 9)
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    y, c = attn.mla_apply(p, _t(x), cfg, positions=_t(pos))
    assert jc is None and c is None
    assert _rel(y, jy) <= 1e-5


def test_mla_prefill_runs_flash_attention_at_d_against_dv(monkeypatch):
    """The prefill's attention is one ``flash_attention`` call, causal, no
    window, on q and k of D = nope + rope (the one rope key head broadcast
    to every head) against v of Dv; on the card that is one
    ``flash_attention_fwd`` at (B·H, S, D) x (B·H, S, Dv). A decode step
    calls it never (the absorbed products)."""
    cfg, jcfg, jp, p = _setup(6)
    calls = []
    route = attn.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw["causal"],
                      kw.get("window")))
        return route(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention", counted)
    m = cfg.mla
    b, s = 2, 7
    x = torch.randn(b, s + 1, cfg.d_model, generator=torch.Generator().manual_seed(7))
    c = attn.make_mla_cache(cfg, b, 16, torch.float32, "cpu")
    attn.mla_apply(p, x[:, :s], cfg, positions=_t(_positions(b, s)), cache=c)
    d = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert calls == [((b, s, cfg.n_heads, d), (b, s, cfg.n_heads, d),
                      (b, s, cfg.n_heads, m.v_head_dim), True, None)]
    attn.mla_apply(p, x[:, s:], cfg, positions=_t(_positions(b, 1, s)), cache=c, decode=True)
    assert len(calls) == 1
