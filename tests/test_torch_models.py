"""repro_torch.models, configs and data against repro's, on the CPU.

The same seeded numpy inputs go through the reference's jnp functions and
the port's on CPU tensors; weights are drawn by the reference's
``init_params`` and carried across by ``params_from_numpy``. Tolerances
are relative to the largest reference value: 1e-6 for the layers at
float32; for attention 2e-6 at float32 (sums in another order) and 8e-3
at bfloat16 (then one rounding of the output, 2^-8), and the reference
kernel test's atol 2e-5 for the card route's operands; 1e-4 for the smoke
models' logits at float32 and 3e-2 at bfloat16 (a few bf16 roundings,
taken in other orders). Configs, input specs and the data
pipeline are held equal. The reference's ``tests/models/test_arch_smoke.py``
cases of the dense and vlm families are ported one for one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as jdata
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import param as jparam
from repro.models import transformer as jT
from repro.models.build import build as jbuild
from repro_torch.configs import registry as reg
from repro_torch.data import pipeline as data
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import param
from repro_torch.models import transformer as T
from repro_torch.models.build import PENDING, build

SERVED = ["llama3.2-3b", "starcoder2-3b", "glm4-9b", "internvl2-76b"]
MOE = ["mixtral-8x22b", "deepseek-v3-671b"]
DENSE_AND_VLM = [a for a in reg.ALL_IDS if reg.get_config(a).family in ("dense", "vlm")]
PORTED = [a for a in reg.ALL_IDS if reg.get_config(a).family not in PENDING]
#: each ported family's skeleton function in the port and in the reference
SKELETONS = {"dense": (T.lm_skel, jT.lm_skel), "vlm": (T.lm_skel, jT.lm_skel),
             "moe": (T.lm_skel, jT.lm_skel),
             "hybrid": (T.hybrid_skel, jT.hybrid_skel), "ssm": (T.xlstm_skel, jT.xlstm_skel),
             "audio": (T.encdec_skel, jT.encdec_skel),
             "spectral": (T.spectral_skel, jT.spectral_skel)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _carried(jmodel, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------ layers ------------------------------


def test_rmsnorm_matches_reference(rng):
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = layers.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_reference(rng, theta):
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, 47, dtype=np.int32), (2, 40))
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(x), _t(pos.copy()), theta)
    assert _rel(got, ref) <= 1e-6
    np.testing.assert_allclose(layers.rope_freqs(16, theta).numpy(),
                               np.asarray(jlayers.rope_freqs(16, theta)), rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(rng, act):
    skel = jlayers.mlp_skel(24, 48, act)
    p = {k: rng.standard_normal(d.shape).astype(np.float32) / 5 for k, d in skel.items()}
    x = rng.standard_normal((2, 6, 24)).astype(np.float32)
    ref = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    got = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    assert sorted(layers.mlp_skel(24, 48, act)) == sorted(skel)
    assert _rel(got, ref) <= 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(rng, masked):
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    ref = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    got = layers.softmax_xent(_t(logits), _t(labels), None if mask is None else _t(mask))
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


def test_embed_and_unembed_match_reference(rng):
    table = rng.standard_normal((50, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 50)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 9)).astype(np.int32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jdt)
        got = layers.embed({"table": _t(table)}, _t(toks), dt)
        assert got.dtype == dt and _rel(got, ref.astype(jnp.float32)) == 0.0
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    ref = jlayers.unembed({"kernel": jnp.asarray(kernel)}, jnp.asarray(x))
    got = layers.unembed({"kernel": _t(kernel)}, _t(x))
    assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-6


# ----------------------------- attention -----------------------------

# (b, s, h, kv, d, causal, window, block_q, block_k)
FLASH_CASES = [
    (2, 32, 4, 4, 8, True, None, 16, 16),     # MHA
    (2, 40, 4, 2, 8, True, None, 16, 16),     # GQA g = 2, ragged tail
    (1, 37, 8, 2, 16, True, None, 16, 8),     # GQA g = 4, ragged q and k tails
    (2, 64, 4, 2, 8, True, 8, 16, 16),        # sliding window
    (1, 50, 8, 2, 8, True, 12, 32, 16),       # window, g = 4, ragged
    (2, 24, 4, 4, 8, False, None, 16, 16),    # bidirectional, ragged k
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(case, dtype):
    b, s, h, kv, d, causal, window, bq, bk = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jattn.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                                window=window, block_q=bq, block_k=bk)
    got = attn.flash_attention(*(_t(x).to(dt) for x in (q, k, v)), causal=causal,
                               window=window, block_q=bq, block_k=bk)
    assert got.dtype == dt and got.shape == ref.shape
    # float32: sums in another order; bfloat16: the same, then one rounding
    # of the output to bf16 (an ulp is 2^-8 relative)
    assert _rel(got, ref.astype(jnp.float32)) <= (2e-6 if dtype == "float32" else 8e-3)


def test_flash_attention_q_offset_matches_reference(rng):
    q = rng.standard_normal((1, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 48, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 48, 2, 8)).astype(np.float32)
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=32,
                                block_q=16, block_k=16)
    got = attn.flash_attention(_t(q), _t(k), _t(v), q_offset=32, block_q=16, block_k=16)
    assert _rel(got, ref) <= 2e-6


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("prescaled", [False, True], ids=["kernel scale", "card route"])
def test_flash_plain_on_the_gqa_layout_agrees_with_model_flash(rng, g, prescaled):
    """tests/kernels/test_flash_attention.py::test_flash_agrees_with_model_flash,
    ported: the kernel's operands in the GQA layout (``gqa_to_heads``),
    through its plain version, give the model's function within 2e-5; both
    with the kernel's own scale and as the card route calls it (q scaled
    first, scale 1)."""
    b, s, kv, d = 2, 64, 2, 16
    h = kv * g
    q = jnp.asarray(rng.standard_normal((b, s, h, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, s, kv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, s, kv, d)), jnp.float32)
    xla = jattn.flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    tq = _t(q) / np.sqrt(d) if prescaled else _t(q)
    qk, kk, vk = attn.gqa_to_heads(tq, _t(k), _t(v))
    assert qk.shape == kk.shape == vk.shape == (b * h, s, d)
    plain = fa.flash_attention_plain(qk, kk, vk, causal=True, block_q=16, block_k=16,
                                     scale=1.0 if prescaled else None)
    np.testing.assert_allclose(attn.gqa_from_heads(plain, b).numpy(), np.asarray(xla),
                               atol=2e-5)


def _ref_cache(cfg, b, max_len):
    return jattn.make_cache(cfg, b, max_len, jnp.float32)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_cache_insert_and_decode_attention_slot_for_slot(window, qdtype):
    """A prefill of 12 then 10 decode steps into a dense cache of 32 and an
    SWA ring of 8: every insert's k, v and slot_pos equal the reference's,
    and each decode step's attention (a bf16 query against the float32
    cache too) agrees with it."""
    cfg = reg.smoke_config("llama3.2-3b").scaled(sliding_window=window)
    jcfg = jreg.smoke_config("llama3.2-3b").scaled(sliding_window=window)
    b, kv, dh, h = 2, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    rng = np.random.default_rng(5)
    jc = _ref_cache(jcfg, b, 32)
    c = attn.make_cache(cfg, b, 32, torch.float32, "cpu")
    assert c["k"].shape == jc["k"].shape and c["k"].shape[1] == (window or 32)
    jdt, dt = getattr(jnp, qdtype), getattr(torch, qdtype)
    s0 = 12
    for step in range(11):
        n = s0 if step == 0 else 1
        pos = 0 if step == 0 else s0 + step - 1
        kn = rng.standard_normal((b, n, kv, dh)).astype(np.float32)
        vn = rng.standard_normal((b, n, kv, dh)).astype(np.float32)
        jc = jattn._cache_insert(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
        c = attn._cache_insert(c, _t(kn), _t(vn), pos)
        for key in ("k", "v", "slot_pos"):
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(jc[key]))
        if step:
            q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
            ref = jattn.decode_attention(jnp.asarray(q, jdt), jc["k"], jc["v"], jc["slot_pos"],
                                         jnp.asarray(pos))
            got = attn.decode_attention(_t(q).to(dt), c["k"], c["v"], c["slot_pos"], pos)
            assert got.dtype == dt
            assert _rel(got, ref.astype(jnp.float32)) <= (1e-6 if qdtype == "float32" else 8e-3)


# ------------------------------ models ------------------------------


def _batch(cfg, rng, b, s):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(arch, compute_dtype):
    cfg = reg.smoke_config(arch).scaled(compute_dtype=compute_dtype)
    jcfg = jreg.smoke_config(arch).scaled(compute_dtype=compute_dtype)
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 3)
    rng = np.random.default_rng(4)
    b, s = 2, 12
    batch = _batch(cfg, rng, b, s + 2)
    pre = {k: (v[:, :s] if k == "tokens" else v) for k, v in batch.items()}
    jc = jm.init_cache_fn(b, 32, jnp.float32)
    c = m.init_cache_fn(b, 32, torch.float32, "cpu")
    jl, jc = jm.prefill_fn(jp, {k: jnp.asarray(v) for k, v in pre.items()}, jc)
    l, c = m.prefill_fn(p, {k: _t(v) for k, v in pre.items()}, c)
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    assert l.shape == jl.shape and l.dtype == torch.float32
    assert _rel(l, jl) <= tol
    for i in range(2):  # two decode steps from the same caches
        tok = batch["tokens"][:, s + i:s + i + 1]
        jd, jc = jm.decode_fn(jp, jnp.asarray(tok), jnp.asarray(s + i, jnp.int32), jc)
        d, c = m.decode_fn(p, _t(tok), s + i, c)
        assert _rel(d, jd) <= tol
    # the whole forward's logits at every position (what loss_fn reads)
    full = {k: v for k, v in batch.items()}
    jfull, _, _ = jT.lm_forward(jp, jnp.asarray(full["tokens"]), jcfg,
                                prefix_embeds=jnp.asarray(full["patches"]) if "patches" in full
                                else None)
    got, _, _ = T.lm_forward(p, _t(full["tokens"]), cfg,
                             prefix_embeds=_t(full["patches"]) if "patches" in full else None)
    assert _rel(got, jfull) <= tol
    jloss, _ = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in full.items()})
    loss, _ = m.loss_fn(p, {k: _t(v) for k, v in full.items()})
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))


@pytest.mark.parametrize("arch", MOE)
def test_moe_models_match_reference_at_float32(arch):
    """The moe family's smoke models (mixtral: GQA, a sliding window of 8,
    3 moe layers; deepseek: MLA, 1 dense and 2 moe layers, the MTP head):
    ``loss_fn``'s loss and every metric (xent, aux, mtp), the whole
    forward's logits, ``prefill_fn``'s and two ``decode_fn`` steps' logits
    to 1e-4 of their largest reference value."""
    cfg, jcfg = reg.smoke_config(arch), jreg.smoke_config(arch)
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 14)).astype(np.int32)
    jloss, jmetrics = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    loss, metrics = m.loss_fn(p, {"tokens": _t(toks)})
    assert sorted(metrics) == sorted(jmetrics) == sorted(
        ["xent", "aux", "loss"] + (["mtp"] if cfg.mtp else []))
    for key in jmetrics:
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= 1e-4 * abs(
            float(jmetrics[key])), key
    assert float(loss) == float(metrics["loss"])
    jfull, _, jaux = jT.lm_forward(jp, jnp.asarray(toks), jcfg)
    full, _, aux = T.lm_forward(p, _t(toks), cfg)
    assert _rel(full, jfull) <= 1e-4 and abs(float(aux) - float(jaux)) <= 1e-6 * float(jaux)
    s = 12
    jc, c = jm.init_cache_fn(2, 32, jnp.float32), m.init_cache_fn(2, 32, torch.float32, "cpu")
    assert sorted(c) == sorted(jc)
    jl, jc = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc)
    l, c = m.prefill_fn(p, {"tokens": _t(toks[:, :s])}, c)
    assert _rel(l, jl) <= 1e-4
    for i in range(2):
        tok = toks[:, s + i:s + i + 1]
        jd, jc = jm.decode_fn(jp, jnp.asarray(tok), jnp.asarray(s + i, jnp.int32), jc)
        d, c = m.decode_fn(p, _t(tok), s + i, c)
        assert _rel(d, jd) <= 1e-4
        for name in jc:
            for key in jc[name]:
                assert _rel(c[name][key], jc[name][key]) <= 1e-4, (name, key)


def _ref_blocks(jcfg, jp, name, x, positions, caches, decode):
    """The reference's blocks of stack ``name`` one at a time (eager):
    [(layer params, input, input cache, output, output cache)]."""
    out = []
    for i in range(jp[name]["ln1"]["scale"].shape[0]):
        jpl = jax.tree.map(lambda t: t[i], jp[name])
        jcl = jax.tree.map(lambda t: t[i], caches[name]) if caches is not None else None
        y, jcn, _ = jT.decoder_block_apply(jpl, x, jcfg, positions=positions, cache=jcl,
                                           decode=decode)
        out.append((i, x, jcl, y, jcn))
        x = y
    return out, x


@pytest.mark.parametrize("arch", MOE)
def test_moe_models_match_reference_at_bf16_block_by_block(arch):
    """At bfloat16 the loss and every metric agree to 3e-2; the logits are
    held block by block, each port block (attention, then the moe FFN or
    the MLP) given the reference's bf16 input and cache, in a prefill of 12
    and two decode steps, its output and new cache to 3e-2, and the final
    norm and unembedding on the reference's last hidden state. The whole
    forward is not held to 3e-2: at their random init these smoke models
    amplify one bf16 rounding through their near one-hot attention (and a
    router's choice of experts), so two bf16 evaluations that round in
    other places part further; the reference's jitted forward and its
    eager one part by 0.45 of the largest logit on mixtral's (seed 3)."""
    cfg = reg.smoke_config(arch).scaled(compute_dtype="bfloat16")
    jcfg = jreg.smoke_config(arch).scaled(compute_dtype="bfloat16")
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 3)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 14)).astype(np.int32)
    _, jmetrics = jm.loss_fn(jp, {"tokens": jnp.asarray(toks)})
    _, metrics = m.loss_fn(p, {"tokens": _t(toks)})
    for key in jmetrics:
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= 3e-2 * abs(
            float(jmetrics[key])), key
    s = 12
    jc = jm.init_cache_fn(2, 32, jnp.float32)
    names = [n for n in ("dense_layers", "moe_layers") if n in jp]
    for step in range(3):
        n_tok, pos0 = (s, 0) if step == 0 else (1, s + step - 1)
        tok = toks[:, pos0:pos0 + n_tok]
        positions = np.broadcast_to(np.arange(pos0, pos0 + n_tok, dtype=np.int32),
                                    (2, n_tok)).copy()
        x = jlayers.embed(jp["embed"], jnp.asarray(tok), jnp.bfloat16)
        new = {}
        for name in names:
            blocks, x = _ref_blocks(jcfg, jp, name, x, jnp.asarray(positions), jc, step > 0)
            new[name] = jax.tree.map(lambda *ls: jnp.stack(ls), *[b[4] for b in blocks])
            for i, jx, jcl, jy, jcn in blocks:
                c_l = {k: _t(v) for k, v in jcl.items()}
                y, c_new, _ = T.decoder_block_apply(
                    param.tree_map(lambda t: t[i], p[name]), _t(jx.astype(jnp.float32)).to(
                        torch.bfloat16), cfg, positions=_t(positions), cache=c_l,
                    decode=step > 0, pos=pos0)
                assert y.dtype == torch.bfloat16
                assert _rel(y, jy) <= 3e-2, (step, name, i)
                for key in jcn:
                    assert _rel(c_new[key], jcn[key]) <= 3e-2, (step, name, i, key)
        jc = new
        jlogits = jT._logits(jp, jlayers.rmsnorm(jp["final_norm"], x, jcfg.rms_eps), jcfg)
        logits = T._logits(p, layers.rmsnorm(p["final_norm"], _t(x.astype(jnp.float32)).to(
            torch.bfloat16), cfg.rms_eps), cfg)
        assert _rel(logits, jlogits) <= 3e-2


@pytest.mark.parametrize("s", [16, 21])
def test_ring_decode_after_a_prefill_past_the_window_keeps_the_reference_slots(s):
    """Observation (the reference's behaviour, ported as is): a prefill of
    s > window tokens writes its last ``window`` k, v into ring slots
    0..window-1, and the next decode writes slot s % window, which holds
    an entry still inside the window unless s % window == 0. So on smoke
    mixtral (window 8) the decode after a prefill of 21 is not the prefill
    of 22's last logits (the port and the reference both ~1 of the largest
    logit off), while after 16 it is; the port's decode logits equal the
    reference's either way (1e-4)."""
    cfg, jcfg = reg.smoke_config("mixtral-8x22b"), jreg.smoke_config("mixtral-8x22b")
    assert cfg.sliding_window == 8
    jm, m = jbuild(jcfg), build(cfg)
    jp, p = _carried(jm, 0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)).astype(np.int32)

    def decode_vs_prefill(model, params, cast, cache, dt):
        _, caches = model.prefill_fn(params, {"tokens": cast(toks[:, :s])},
                                     model.init_cache_fn(2, 32, dt, *cache))
        dec, _ = model.decode_fn(params, cast(toks[:, s:s + 1]), s if cast is _t else
                                 jnp.asarray(s, jnp.int32), caches)
        full, _ = model.prefill_fn(params, {"tokens": cast(toks[:, :s + 1])},
                                   model.init_cache_fn(2, 32, dt, *cache))
        return dec, full

    jdec, jfull = decode_vs_prefill(jm, jp, jnp.asarray, (), jnp.float32)
    dec, full = decode_vs_prefill(m, p, _t, ("cpu",), torch.float32)
    assert _rel(dec, jdec) <= 1e-4 and _rel(full, jfull) <= 1e-4
    gap, jgap = _rel(dec, full.numpy()), _rel(jdec, jfull)
    if s % cfg.sliding_window:
        assert gap > 0.3 and jgap > 0.3 and abs(gap - jgap) <= 1e-3 * jgap
    else:
        assert gap <= 2e-3 and jgap <= 2e-3


@pytest.mark.parametrize("arch", [a for a in PORTED if a != "fourier_lm"])
def test_prefill_then_decode(arch):
    """tests/models/test_arch_smoke.py::test_prefill_then_decode, ported
    (the dense, vlm, hybrid, ssm and audio families; fourier_lm has no
    decode step, as in the reference)."""
    cfg = reg.smoke_config(arch)
    model = build(cfg)
    rng = np.random.default_rng(1)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    b, s = 2, 8
    batch = {k: _t(v) for k, v in _batch(cfg, rng, b, s).items()}
    caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    logits, caches = model.prefill_fn(params, batch, caches)
    assert logits.shape == (b, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), arch
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    logits2, caches = model.decode_fn(params, tok, s, caches)
    assert logits2.shape == (b, cfg.vocab)
    assert bool(torch.isfinite(logits2).all()), arch


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b", "xlstm-350m"])
def test_decode_matches_full_forward(arch):
    """tests/models/test_arch_smoke.py::test_decode_matches_full_forward,
    ported: prefill + decode logits == full-sequence forward logits."""
    cfg = reg.smoke_config(arch)
    model = build(cfg)
    rng = np.random.default_rng(2)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    b, s = 2, 8
    batch = {k: _t(v) for k, v in _batch(cfg, rng, b, s + 1).items()}
    logits_full, _ = model.prefill_fn(params, batch,
                                      model.init_cache_fn(b, 32, torch.float32, "cpu"))
    pre = dict(batch, tokens=batch["tokens"][:, :s])
    caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    _, caches = model.prefill_fn(params, pre, caches)
    logits_dec, _ = model.decode_fn(params, batch["tokens"][:, s:s + 1], s, caches)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=2e-3, atol=2e-3)


def test_full_configs_have_exact_assignment_numbers():
    """tests/models/test_arch_smoke.py's check of the assigned numbers."""
    cfg = reg.get_config("deepseek-v3-671b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads) == (61, 7168, 128)
    assert cfg.moe.n_experts == 256 and cfg.moe.top_k == 8
    assert cfg.mla.kv_lora_rank == 512 and cfg.mtp
    cfg = reg.get_config("mixtral-8x22b")
    assert cfg.moe.n_experts == 8 and cfg.moe.top_k == 2 and cfg.sliding_window == 4096
    cfg = reg.get_config("glm4-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.d_ff) == (40, 4096, 2, 13696)
    cfg = reg.get_config("zamba2-2.7b")
    assert cfg.ssm.d_state == 64 and cfg.n_layers == 54
    cfg = reg.get_config("internvl2-76b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) == (80, 8192, 64, 8)
    cfg = reg.get_config("whisper-medium")
    assert (cfg.d_model, cfg.vocab) == (1024, 51865)
    cfg = reg.get_config("llama3.2-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab) == (
        28, 3072, 24, 8, 128256)


def test_build_serves_every_family():
    """No family is left to port: ``PENDING`` is empty and ``build`` gives
    every config a Model with a loss and a prefill (and a decode step
    wherever the reference has one)."""
    assert PENDING == {}
    for arch in reg.ALL_IDS:
        model, jmodel = build(reg.smoke_config(arch)), jbuild(jreg.smoke_config(arch))
        assert (model.decode_fn is None) == (jmodel.decode_fn is None), arch


@pytest.mark.parametrize("arch", MOE)
def test_moe_family_builds_at_full_width_with_the_reference_counts(arch):
    """mixtral-8x22b's 140.63 B and deepseek-v3-671b's 671.71 B parameters,
    counted on the skeleton (no allocation), equal the reference's; the
    abstract tree is meta tensors."""
    model, jmodel = build(reg.get_config(arch)), jbuild(jreg.get_config(arch))
    assert model.n_params == jmodel.n_params
    assert round(model.n_params / 1e9, 2) == {"mixtral-8x22b": 140.63,
                                              "deepseek-v3-671b": 671.71}[arch]
    assert all(t.device.type == "meta" for t in param.tree_leaves(model.abstract()))


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b"])
def test_recurrent_state_families_build_at_full_width(arch):
    """``build`` serves the ssm and hybrid families (``PENDING`` names
    neither) with the reference's parameter count: 0.427 B and 2.593 B."""
    assert "ssm" not in PENDING and "hybrid" not in PENDING
    model, jmodel = build(reg.get_config(arch)), jbuild(jreg.get_config(arch))
    assert model.n_params == jmodel.n_params
    assert round(model.n_params / 1e9, 3) == {"xlstm-350m": 0.427, "zamba2-2.7b": 2.593}[arch]


# ------------------------- configs and params -------------------------


def test_registry_matches_reference():
    assert reg.ARCH_IDS == jreg.ARCH_IDS and reg.ALL_IDS == jreg.ALL_IDS
    assert reg.SHAPES == jreg.SHAPES


@pytest.mark.parametrize("arch", jreg.ALL_IDS)
def test_configs_match_reference_field_for_field(arch):
    for get in ("get_config", "smoke_config"):
        got = dataclasses.asdict(getattr(reg, get)(arch))
        ref = dataclasses.asdict(getattr(jreg, get)(arch))
        assert got == ref, get
    for shape in jreg.SHAPES:
        cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
        assert reg.shape_skips(cfg, shape) == jreg.shape_skips(jcfg, shape)
        got = reg.input_specs(cfg, shape, seq=4096 if shape == "long_500k" else None)
        ref = jreg.input_specs(jcfg, shape, seq=4096 if shape == "long_500k" else None)
        assert sorted(got) == sorted(ref)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(ref[key].shape)
            assert str(spec.dtype).split(".")[-1] == str(ref[key].dtype)


@pytest.mark.parametrize("arch", PORTED)
def test_skeletons_match_reference(arch):
    """Full width, no allocation: the same leaves, shapes, logical axes,
    init and counts as the reference's skeleton (meta tensors for the
    abstract tree)."""
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    fn, jfn = SKELETONS[cfg.family]
    skel, jskel = fn(cfg), jfn(jcfg)
    leaves = param.tree_leaves(skel)
    jleaves = jax.tree.leaves(jskel, is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    assert [(d.shape, d.logical_axes, d.init, d.scale) for d in leaves] == [
        (d.shape, d.logical_axes, d.init, d.scale) for d in jleaves]
    assert param.param_count(skel) == jparam.param_count(jskel)
    assert param.param_bytes(skel) == jparam.param_bytes(jskel)
    abstract = param.tree_leaves(param.abstract_params(skel, torch.bfloat16))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in abstract)
    assert [tuple(t.shape) for t in abstract] == [d.shape for d in jleaves]


def test_llama_width_and_init_quirk():
    """llama3.2-3b's 3.21 B parameters; ``init_params`` keeps the
    reference's ``fan_in = shape[0]``, so a stacked layer weight has std
    1/sqrt(n_layers) (smoke config: 2 layers), the table 1/sqrt(vocab)."""
    assert round(build(reg.get_config("llama3.2-3b")).n_params / 1e9, 2) == 3.21
    cfg = reg.smoke_config("llama3.2-3b").scaled(d_model=256, d_ff=512, n_heads=8, head_dim=32)
    model = build(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    layer = p["dense_layers"]
    for name in ("wq", "wk", "wv", "wo"):
        std = float(layer["attn"][name].std())
        assert abs(std - 1 / np.sqrt(cfg.n_layers)) < 0.02 * std, name
    assert abs(float(p["embed"]["table"].std()) - 1 / np.sqrt(cfg.vocab)) < 0.02 / np.sqrt(cfg.vocab)
    assert torch.equal(layer["ln1"]["scale"], torch.ones(cfg.n_layers, cfg.d_model))
    again = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(param.tree_leaves(p), param.tree_leaves(again)))
    half = model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in param.tree_leaves(half))


def test_params_from_numpy_carries_every_leaf():
    jm = jbuild(jreg.smoke_config("internvl2-76b"))
    jp = jm.init(jax.random.PRNGKey(0))
    p = param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl = jax.tree.leaves(jp)
    pl = param.tree_leaves(p)
    assert len(jl) == len(pl)
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(jl, pl))
    half = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    ph = param.params_from_numpy(half, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in param.tree_leaves(ph))
    assert all(np.array_equal(np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32)),
                              b.float().numpy())
               for a, b in zip(jl, param.tree_leaves(ph)))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    cfg = reg.smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        attn.make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        param.params_from_numpy({"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data.patches_for(cfg, 1, 0)


# ------------------------------- data -------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-76b", "fourier_lm",
                                  "whisper-medium"])
def test_data_pipeline_matches_reference(arch):
    cfg = reg.smoke_config(arch)
    jcfg = jreg.smoke_config(arch)
    for step in (0, 3):
        got = data.make_batch(cfg, 2, 24, step, seed=1, device="cpu")
        ref = jdata.make_batch(jcfg, 2, 24, step, seed=1)
        assert sorted(got) == sorted(ref)
        for key, val in got.items():
            assert val.device.type == "cpu"
            np.testing.assert_array_equal(val.numpy(), np.asarray(ref[key]))
