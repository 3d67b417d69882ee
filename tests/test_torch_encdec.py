"""repro_torch's encoder-decoder (audio, whisper) against repro's, on the CPU.

The same seeded numpy inputs go through the reference's jnp functions and
the port's on CPU tensors; weights are drawn by the reference's
``init_params`` and carried across by ``params_from_numpy``. Tolerances
are relative to the largest reference value: cross-attention 2e-6 at
float32 (sums in another order) and 8e-3 at bfloat16 (then one rounding
of the output, 2^-8), ``cross_kv`` 1e-6 (one product); the encoder's
output 1e-5 (two layers of products in another order); the smoke model's
logits 1e-4 at float32 and 3e-2 at bfloat16 (a few bf16 roundings, taken
in other orders), as tests/test_torch_models.py holds the other families.
Cache leaves: ``slot_pos`` exactly, k, v 1e-5. The served tokens are the
reference engine's, token for token (float32).

At bfloat16 the model is held block by block (3e-2), each port block
given the reference's input, cross K/V and caches, as
tests/test_torch_ssm.py holds zamba2: at its random init the smoke model
amplifies bf16 roundings taken in other places past 3e-2 at the logits
(the reference's bf16 logits lie 0.10-0.45 of the largest from its own
float32 ones, and its eager blocks part from its compiled decode step by
0.063 at one decoder layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import transformer as jT
from repro.models.build import build as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as reg
from repro_torch.data.pipeline import frames_for
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import param
from repro_torch.models import transformer as T
from repro_torch.models.build import build
from repro_torch.serve import Request, ServeEngine

ARCH = "whisper-medium"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(compute_dtype="float32", **overrides):
    cfg = reg.smoke_config(ARCH).scaled(compute_dtype=compute_dtype, **overrides)
    jcfg = jreg.smoke_config(ARCH).scaled(compute_dtype=compute_dtype, **overrides)
    return cfg, jcfg, build(cfg), jbuild(jcfg)


def _carried(jmodel, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, seed, b, s, frames=None):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "frames": rng.standard_normal((b, frames or cfg.enc_frames, cfg.d_model))
            .astype(np.float32)}


def _tol(compute_dtype):
    return 1e-4 if compute_dtype == "float32" else 3e-2


# ------------------------------ layers ------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("given", ["kv tuple", "encoder output"])
def test_cross_attn_apply_matches_reference(dtype, given):
    """Queries of 5 positions against 11 encoder positions (a ragged key
    block of the smoke config's 16 is cut to 11, as the reference cuts
    it), k, v given precomputed or projected from the encoder output."""
    cfg, jcfg, _, _ = _pair()
    rng = np.random.default_rng(3)
    skel = jattn.cross_attn_skel(jcfg)
    assert sorted(attn.cross_attn_skel(cfg)) == sorted(skel)
    assert all(attn.cross_attn_skel(cfg)[k].shape == d.shape for k, d in skel.items())
    p = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in skel.items()}
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    if given == "kv tuple":
        jkv = jattn.cross_kv(jp, jnp.asarray(enc), jdt)
        kv = attn.cross_kv(tp, _t(enc), dt)
        for a, b in zip(kv, jkv):
            assert a.dtype == dt and a.shape == b.shape
            assert _rel(a, b.astype(jnp.float32)) <= (1e-6 if dtype == "float32" else 8e-3)
    else:
        jkv, kv = jnp.asarray(enc, jdt), _t(enc).to(dt)
    ref = jattn.cross_attn_apply(jp, jnp.asarray(x, jdt), jkv, jcfg)
    got = attn.cross_attn_apply(tp, _t(x).to(dt), kv, cfg)
    assert got.dtype == dt and got.shape == ref.shape
    assert _rel(got, ref.astype(jnp.float32)) <= (2e-6 if dtype == "float32" else 8e-3)


def test_cross_attn_apply_promotes_a_float32_encoder_output_as_jax_does():
    """A float32 encoder output under bf16 compute: JAX's einsum promotes
    the projections to float32, and so does the port."""
    cfg, jcfg, _, _ = _pair("bfloat16")
    rng = np.random.default_rng(4)
    skel = jattn.cross_attn_skel(jcfg)
    p = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in skel.items()}
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    ref = jattn.cross_attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x, jnp.bfloat16), jnp.asarray(enc), jcfg)
    got = attn.cross_attn_apply({k: _t(v) for k, v in p.items()}, _t(x).to(torch.bfloat16),
                                _t(enc), cfg)
    assert got.dtype == torch.bfloat16
    assert _rel(got, ref.astype(jnp.float32)) <= 8e-3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encoder_forward_matches_reference(compute_dtype):
    cfg, jcfg, m, jm = _pair(compute_dtype)
    jp, p = _carried(jm, 1)
    frames = _batch(cfg, 2, 2, 4)["frames"]
    ref = jT.encoder_forward(jp, jnp.asarray(frames), jcfg)
    got = T.encoder_forward(p, _t(frames), cfg)
    assert got.dtype == getattr(torch, compute_dtype) and got.shape == ref.shape
    assert _rel(got, ref.astype(jnp.float32)) <= (1e-5 if compute_dtype == "float32" else 3e-2)


# ------------------------------ the model ------------------------------


def test_prefill_logits_and_every_cache_leaf_match_reference():
    """``encdec_forward`` prefill: logits at every position, each layer's
    self-attention k, v and slot_pos, and the cross K/V (the reference
    returns them as new arrays; the port writes them into its buffers)."""
    compute_dtype = "float32"
    cfg, jcfg, m, jm = _pair(compute_dtype)
    jp, p = _carried(jm, 3)
    batch = _batch(cfg, 4, 2, 10)
    jc = jm.init_cache_fn(2, 32, jnp.float32)
    c = m.init_cache_fn(2, 32, torch.float32, "cpu")
    assert sorted(c["dec"]) == sorted(jc["dec"]) == ["cross_k", "cross_v", "self"]
    for got, ref in zip(param.tree_leaves(c), jax.tree.leaves(jc)):
        assert tuple(got.shape) == ref.shape and not bool(got.any() if got.dtype != torch.int32
                                                          else (got != -1).any())
    jenc = jT.encoder_forward(jp, jnp.asarray(batch["frames"]), jcfg)
    jl, jc, _ = jT.encdec_forward(jp, jnp.asarray(batch["tokens"]), jcfg, enc_out=jenc, caches=jc)
    l, c, _ = T.encdec_forward(p, _t(batch["tokens"]), cfg,
                               enc_out=T.encoder_forward(p, _t(batch["frames"]), cfg), caches=c)
    tol = _tol(compute_dtype)
    assert l.dtype == torch.float32 and l.shape == jl.shape and _rel(l, jl) <= tol
    np.testing.assert_array_equal(c["dec"]["self"]["slot_pos"].numpy(),
                                  np.asarray(jc["dec"]["self"]["slot_pos"]))
    leaf_tol = 1e-5
    for key in ("k", "v"):
        assert _rel(c["dec"]["self"][key], jc["dec"]["self"][key]) <= leaf_tol
    for key in ("cross_k", "cross_v"):
        assert jc["dec"][key].dtype == jnp.dtype(compute_dtype)
        assert c["dec"][key].dtype == torch.float32
        assert _rel(c["dec"][key], jc["dec"][key].astype(jnp.float32)) <= leaf_tol


def test_decode_steps_match_reference():
    """Prefill of 10, then three decode steps from the same caches, the
    logits of each against the reference's (float32 caches, as the
    ServeEngine makes them)."""
    compute_dtype = "float32"
    cfg, jcfg, m, jm = _pair(compute_dtype)
    jp, p = _carried(jm, 5)
    batch = _batch(cfg, 6, 2, 13)
    pre = {"tokens": batch["tokens"][:, :10], "frames": batch["frames"]}
    jl, jc = jm.prefill_fn(jp, {k: jnp.asarray(v) for k, v in pre.items()},
                           jm.init_cache_fn(2, 32, jnp.float32))
    l, c = m.prefill_fn(p, {k: _t(v) for k, v in pre.items()},
                        m.init_cache_fn(2, 32, torch.float32, "cpu"))
    tol = _tol(compute_dtype)
    assert _rel(l, jl) <= tol
    for i in range(3):
        tok = batch["tokens"][:, 10 + i:11 + i]
        jd, jc = jm.decode_fn(jp, jnp.asarray(tok), jnp.asarray(10 + i, jnp.int32), jc)
        d, c = m.decode_fn(p, _t(tok), 10 + i, c)
        assert d.shape == jd.shape and _rel(d, jd) <= tol


def _to_port_caches(jc, c):
    """The reference's caches copied into the port's buffers (float32
    holds the reference's bf16 cross K/V exactly)."""
    for dst, src in zip(param.tree_leaves(c), jax.tree.leaves(jc)):
        dst.copy_(torch.from_numpy(np.array(src.astype(jnp.float32) if src.dtype == jnp.bfloat16
                                            else src)))
    return c


def test_bf16_decode_reads_the_cross_kv_in_the_compute_dtype(monkeypatch):
    """Divergence 16: at bf16 compute the reference's prefill returns the
    cross K/V in bf16 (new arrays) and its decode reads them so. The port
    writes them into its float32 buffers in place (exact) and casts them
    back on read: a decode step from the reference's caches gives every
    layer's cross-attention bf16 k, v equal bit for bit to the reference's,
    and its own prefill's values back bit for bit. Read as float32
    instead, the plain attention would round its weights p to float32, not
    bf16 as the reference does."""
    cfg, jcfg, m, jm = _pair("bfloat16")
    jp, p = _carried(jm, 7)
    batch = _batch(cfg, 8, 2, 9)
    pre = {"tokens": batch["tokens"][:, :8], "frames": batch["frames"]}
    _, jc = jm.prefill_fn(jp, {k: jnp.asarray(v) for k, v in pre.items()},
                          jm.init_cache_fn(2, 32, jnp.float32))
    assert jc["dec"]["cross_k"].dtype == jnp.bfloat16
    c = _to_port_caches(jc, m.init_cache_fn(2, 32, torch.float32, "cpu"))
    assert c["dec"]["cross_k"].dtype == torch.float32
    seen = []
    route, kv_route = attn.cross_attn_apply, attn.cross_kv

    def spy(p_l, x, enc_kv, cfg_):
        seen.append(enc_kv)
        return route(p_l, x, enc_kv, cfg_)

    written = []

    def kv_spy(p_l, enc, dtype):
        written.append(kv_route(p_l, enc, dtype))
        return written[-1]

    monkeypatch.setattr(attn, "cross_attn_apply", spy)
    monkeypatch.setattr(attn, "cross_kv", kv_spy)
    m.decode_fn(p, _t(batch["tokens"][:, 8:9]), 8, c)
    assert len(seen) == cfg.n_layers
    for i, (k, v) in enumerate(seen):
        assert k.dtype == v.dtype == torch.bfloat16
        for got, key in ((k, "cross_k"), (v, "cross_v")):
            want = np.asarray(jc["dec"][key][i].astype(jnp.float32))
            np.testing.assert_array_equal(got.float().numpy(), want)
    # the port's own prefill, then a decode step: the values written come back
    seen.clear()
    _, c = m.prefill_fn(p, {k: _t(v) for k, v in pre.items()},
                        m.init_cache_fn(2, 32, torch.float32, "cpu"))
    assert len(written) == cfg.n_layers and all(k.dtype == torch.bfloat16 for k, _ in written)
    seen.clear()
    m.decode_fn(p, _t(batch["tokens"][:, 8:9]), 8, c)
    for (k, v), (wk, wv) in zip(seen, written):
        assert k.dtype == torch.bfloat16 and torch.equal(k, wk) and torch.equal(v, wv)


def _reference_encoder_block(p, x, cfg, positions):
    """The reference's encoder block (``encoder_forward``'s scanned body)."""
    from repro.models.layers import mlp as jmlp
    from repro.models.layers import rmsnorm as jrms

    a, _ = jattn.gqa_apply(p["attn"], jrms(p["ln1"], x, cfg.rms_eps), cfg, positions=positions,
                           causal=False)
    x = x + a
    return x + jmlp(p["mlp"], jrms(p["ln2"], x, cfg.rms_eps), "gelu")


def _reference_decoder_block(p, x, cfg, positions, c_self, kx, vx, decode):
    """The reference's decoder block (``encdec_forward``'s scanned body)."""
    from repro.models.layers import mlp as jmlp
    from repro.models.layers import rmsnorm as jrms

    a, c_new = jattn.gqa_apply(p["attn"], jrms(p["ln1"], x, cfg.rms_eps), cfg,
                               positions=positions, cache=c_self, decode=decode)
    x = x + a
    x = x + jattn.cross_attn_apply(p["xattn"], jrms(p["lnx"], x, cfg.rms_eps), (kx, vx), cfg)
    return x + jmlp(p["mlp"], jrms(p["ln2"], x, cfg.rms_eps), "gelu"), c_new


def test_bfloat16_encdec_matches_reference_block_by_block():
    """Every encoder block, and every decoder block of a prefill of 10 and
    then of a decode step, at bf16, each port block given the reference's
    input (bf16, as it is), cross K/V and self-attention cache: outputs,
    cross K/V and caches within 3e-2; the encoder's norm and the logits
    of the reference's last hidden too."""
    from repro.models.layers import embed as jembed
    from repro.models.layers import rmsnorm as jrms
    from repro.models.layers import unembed as junembed
    from repro_torch.models.layers import rmsnorm, unembed

    cfg, jcfg, m, jm = _pair("bfloat16")
    jp, p = _carried(jm, 3)
    bf = torch.bfloat16
    batch = _batch(cfg, 4, 2, 11)

    def port(x):
        """A reference array as a tensor of its dtype."""
        return _t(np.asarray(x.astype(jnp.float32))).to(bf if x.dtype == jnp.bfloat16
                                                        else torch.float32)

    jx = jnp.asarray(batch["frames"]).astype(jnp.bfloat16)
    t = cfg.enc_frames
    jpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None], (2, t))
    for i in range(cfg.n_enc_layers):
        jpl = jax.tree.map(lambda w: w[i], jp["enc_layers"])
        pl = param.tree_map(lambda w: w[i], p["enc_layers"])
        jy = _reference_encoder_block(jpl, jx, jcfg, jpos)
        y = T.encoder_block_apply(pl, port(jx), cfg, positions=_t(np.asarray(jpos)))
        assert y.dtype == bf and _rel(y, jy.astype(jnp.float32)) <= 3e-2, i
        jx = jy
    jenc = jrms(jp["enc_norm"], jx, jcfg.rms_eps)
    assert _rel(rmsnorm(p["enc_norm"], port(jx), cfg.rms_eps), jenc.astype(jnp.float32)) <= 3e-2

    jc = jm.init_cache_fn(2, 32, jnp.float32)["dec"]
    for decode, lo, hi in ((False, 0, 10), (True, 10, 11)):
        tk = batch["tokens"][:, lo:hi]
        jx = jembed(jp["embed"], jnp.asarray(tk), jnp.bfloat16)
        jpos = jnp.broadcast_to(jnp.arange(lo, hi, dtype=jnp.int32)[None], tk.shape)
        for i in range(cfg.n_layers):
            jpl = jax.tree.map(lambda w: w[i], jp["dec_layers"])
            pl = param.tree_map(lambda w: w[i], p["dec_layers"])
            jcl = jax.tree.map(lambda w: w[i], jc)
            if decode:
                jkx, jvx = jcl["cross_k"], jcl["cross_v"]
            else:
                jkx, jvx = jattn.cross_kv(jpl["xattn"], jenc, jnp.bfloat16)
                kx, vx = attn.cross_kv(pl["xattn"], port(jenc), bf)
                assert kx.dtype == bf and _rel(kx, jkx.astype(jnp.float32)) <= 3e-2, i
                assert _rel(vx, jvx.astype(jnp.float32)) <= 3e-2, i
            c_self = param.tree_map(lambda a: _t(np.asarray(a)), jcl["self"])
            jy, jnew = _reference_decoder_block(jpl, jx, jcfg, jpos, jcl["self"], jkx, jvx,
                                                decode)
            y = T.encdec_block_apply(pl, port(jx), (port(jkx), port(jvx)), cfg,
                                     positions=_t(np.asarray(jpos)), cache=c_self,
                                     decode=decode, pos=lo)
            assert y.dtype == bf and _rel(y, jy.astype(jnp.float32)) <= 3e-2, (decode, i)
            np.testing.assert_array_equal(c_self["slot_pos"].numpy(),
                                          np.asarray(jnew["slot_pos"]))
            for key in ("k", "v"):
                assert _rel(c_self[key], jnew[key]) <= 3e-2, (decode, i, key)
            new = {"self": jnew, "cross_k": jkx.astype(jnp.float32),
                   "cross_v": jvx.astype(jnp.float32)}
            jc = jax.tree.map(lambda c_, u: c_.at[i].set(u.astype(c_.dtype)), jc, new)
            jx = jy
        ref = junembed(jp["unembed"], jrms(jp["final_norm"], jx, jcfg.rms_eps))
        got = unembed(p["unembed"], rmsnorm(p["final_norm"], port(jx), cfg.rms_eps))
        assert _rel(got, ref) <= 3e-2


def test_decode_matches_full_forward():
    """tests/models/test_arch_smoke.py::test_decode_matches_full_forward for
    whisper, ported: prefill + decode logits == the prefill of s + 1."""
    cfg = reg.smoke_config(ARCH)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    b, s = 2, 8
    batch = {k: _t(v) for k, v in _batch(cfg, 2, b, s + 1).items()}
    logits_full, _ = model.prefill_fn(params, batch,
                                      model.init_cache_fn(b, 32, torch.float32, "cpu"))
    pre = dict(batch, tokens=batch["tokens"][:, :s])
    _, caches = model.prefill_fn(params, pre, model.init_cache_fn(b, 32, torch.float32, "cpu"))
    logits_dec, _ = model.decode_fn(params, batch["tokens"][:, s:s + 1], s, caches)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_model_loss_prefill_and_decode_fns_match_reference(compute_dtype):
    cfg, jcfg, m, jm = _pair(compute_dtype)
    jp, p = _carried(jm, 9)
    batch = _batch(cfg, 10, 2, 12)
    jloss, jmetrics = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = m.loss_fn(p, {k: _t(v) for k, v in batch.items()})
    tol = _tol(compute_dtype)
    assert sorted(metrics) == sorted(jmetrics)
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    assert m.n_params == jm.n_params


def test_every_decode_step_runs_flash_attention_once_a_layer(monkeypatch):
    """Divergence 17, as the model calls it: a prefill runs the model's
    ``flash_attention`` n_enc + 2 n_layers times (encoder, decoder self-,
    cross-attention), a decode step n_layers times (its cross-attention,
    as the reference's decode runs it); on the card each is a
    ``flash_attention_fwd`` launch (tests/test_torch_kernels_cuda.py)."""
    cfg = reg.smoke_config(ARCH).scaled(n_layers=3, n_enc_layers=2)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    calls = []
    route = attn.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return route(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention", counted)
    batch = {k: _t(v) for k, v in _batch(cfg, 1, 2, 6).items()}
    logits, caches = model.prefill_fn(params, batch,
                                      model.init_cache_fn(2, 16, torch.float32, "cpu"))
    t = cfg.enc_frames
    assert calls == [(t, t, False)] * 2 + [(6, 6, True), (6, t, False)] * 3
    calls.clear()
    model.decode_fn(params, torch.argmax(logits, -1).to(torch.int32)[:, None], 6, caches)
    assert calls == [(1, t, False)] * 3


def test_frames_of_another_length_than_the_config_serve_as_in_the_reference():
    """The reference's prefill returns cross K/V of any number of encoder
    frames; the port's prefill replaces the cache's cross buffers when the
    frames are longer or shorter than ``cfg.enc_frames`` (here 8): 12 and
    5 frames give the reference's logits, prefill and decode."""
    cfg, jcfg, m, jm = _pair()
    jp, p = _carried(jm, 11)
    for frames in (12, 5):
        batch = _batch(cfg, 12, 2, 7, frames=frames)
        pre = {"tokens": batch["tokens"][:, :6], "frames": batch["frames"]}
        jl, jc = jm.prefill_fn(jp, {k: jnp.asarray(v) for k, v in pre.items()},
                               jm.init_cache_fn(2, 16, jnp.float32))
        c = m.init_cache_fn(2, 16, torch.float32, "cpu")
        l, c2 = m.prefill_fn(p, {k: _t(v) for k, v in pre.items()}, c)
        assert c2 is c and c["dec"]["cross_k"].shape[2] == frames
        assert _rel(l, jl) <= 1e-4
        jd, _ = jm.decode_fn(jp, jnp.asarray(batch["tokens"][:, 6:]), jnp.asarray(6, jnp.int32),
                             jc)
        d, _ = m.decode_fn(p, _t(batch["tokens"][:, 6:]), 6, c)
        assert _rel(d, jd) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_buffers_hold_the_compute_dtype_at_least(dtype):
    """``encdec_init_cache``: the self-attention caches in the dtype asked
    for, the cross K/V in the wider of it and the compute dtype, so a
    prefill's write of them is exact."""
    for compute in ("float32", "bfloat16"):
        cfg = reg.smoke_config(ARCH).scaled(compute_dtype=compute)
        c = T.encdec_init_cache(cfg, 2, 16, dtype, "cpu")
        assert c["dec"]["self"]["k"].dtype == dtype
        assert c["dec"]["cross_k"].dtype == torch.promote_types(dtype, getattr(torch, compute))
        assert tuple(c["dec"]["cross_v"].shape) == (cfg.n_layers, 2, cfg.enc_frames,
                                                    cfg.n_heads, cfg.resolved_head_dim)


def test_whisper_builds_at_full_width():
    """whisper-medium's 0.811 B parameters, the reference's count."""
    model, jmodel = build(reg.get_config(ARCH)), jbuild(jreg.get_config(ARCH))
    assert model.n_params == jmodel.n_params
    assert round(model.n_params / 1e9, 3) == 0.811


# ------------------------------ serving ------------------------------


def test_serve_queue_with_frames_gives_the_reference_tokens():
    """Mixed prompt lengths over several lanes, every lane batch carrying
    the same frames as extras, through both engines on the same weights:
    token for token."""
    jcfg, cfg = jreg.smoke_config(ARCH), reg.smoke_config(ARCH)
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 0)
    jeng = JServeEngine(jm, jp, batch=3, max_len=64)
    eng = ServeEngine(m, p, batch=3, max_len=64)
    frames = frames_for(cfg, 3, 0, device="cpu")
    rng = np.random.default_rng(7)
    lengths = [3, 5, 8, 12, 17, 30, 6, 9]
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lengths]
    ref = jeng.serve_queue([JRequest(prompt=q, max_new=2 + i % 4) for i, q in enumerate(prompts)],
                           extras={"frames": jnp.asarray(frames.numpy())})
    got = eng.serve_queue([Request(prompt=q, max_new=2 + i % 4) for i, q in enumerate(prompts)],
                          extras={"frames": frames})
    assert [r.out for r in got] == [r.out for r in ref]
    assert all(r.done and len(r.out) == r.max_new for r in got)


def test_launcher_serves_whisper_smoke_config_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                              "--batch", "2", "--max-new", "4"])
    cfg = reg.smoke_config(ARCH)
    assert len(done) == 3 and all(r.done and len(r.out) == 4 for r in done)
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out and f"arch={cfg.name} device=cpu" in out


def test_launcher_gives_the_reference_launchers_first_tokens():
    """The launcher's defaults (8 requests of 16 tokens, batch 4, frames
    from ``frames_for``) on the reference's weights: its tokens are the
    reference engine's on the reference launcher's queue and frames."""
    from repro.data.pipeline import frames_for as jframes_for

    jcfg, cfg = jreg.smoke_config(ARCH), reg.smoke_config(ARCH)
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (16,)).astype(np.int32) for _ in range(8)]
    jf = jframes_for(jcfg, 4, 0)
    f = frames_for(cfg, 4, 0, device="cpu")
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    ref = JServeEngine(jm, jp, batch=4, max_len=128).serve_queue(
        [JRequest(prompt=q, max_new=4) for q in prompts], extras={"frames": jf})
    got = ServeEngine(m, p, batch=4, max_len=128).serve_queue(
        [Request(prompt=q, max_new=4) for q in prompts], extras={"frames": f})
    assert [r.out for r in got] == [r.out for r in ref]
