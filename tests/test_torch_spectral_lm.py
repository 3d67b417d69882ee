"""repro_torch's spectral LM (fourier_lm) against repro's, on the CPU.

fourier_lm is an FNet-style masked LM whose token mixing is Re(FFT2) over
(seq, d_model), the paper's 2D FFT engine inside an LM. The reference's
"auto" variant plans through ``repro.xfft``, which does not import on
every jax, so both sides run under an explicit variant (``stockham``; and
``fused``, the reference's Pallas kernel in interpret mode against the
port's plain twin of its CUDA kernel), and the port's "auto" (the
planner on a CPU key) is held against the reference's ``stockham``.
Weights are drawn by the reference's ``init_params`` and carried across
by ``params_from_numpy``.

``fourier_mixing`` has no 1/N scale, so each block adds O(sqrt(S·D)) to
the residual stream; tolerances are relative to the largest reference
value: logits 1e-5 at float32 (FFT sums in another order; 4e-7 seen),
the loss 1e-5 of itself. At bfloat16 the whole model is held to 3e-2
(a few bf16 roundings, taken in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jT
from repro.models.build import build as jbuild
from repro_torch.configs import registry as reg
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import param
from repro_torch.models import transformer as T
from repro_torch.models.build import build

ARCH = "fourier_lm"


def _rel(got, ref) -> float:
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(variant, ref_variant=None, compute_dtype="float32"):
    cfg = reg.smoke_config(ARCH).scaled(fft_variant=variant, compute_dtype=compute_dtype)
    jcfg = jreg.smoke_config(ARCH).scaled(fft_variant=ref_variant or variant,
                                          compute_dtype=compute_dtype)
    return cfg, jcfg, build(cfg), jbuild(jcfg)


def _carried(jmodel, seed):
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jp, param.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("variant,ref_variant", [("stockham", None), ("fused", None),
                                                 ("auto", "stockham")])
@pytest.mark.parametrize("s", [16, 64])
def test_spectral_forward_matches_reference(variant, ref_variant, s):
    """Logits at every position, (2, S) tokens through both smoke models
    (2 blocks, d_model 32)."""
    cfg, jcfg, m, jm = _pair(variant, ref_variant)
    jp, p = _carried(jm, 0)
    toks = _tokens(1, 2, s)
    ref, jcaches, _ = jT.spectral_forward(jp, jnp.asarray(toks), jcfg)
    got, caches, aux = T.spectral_forward(p, torch.from_numpy(toks), cfg)
    assert caches is None and jcaches is None and float(aux) == 0.0
    assert got.dtype == torch.float32 and got.shape == ref.shape == (2, s, cfg.vocab)
    assert _rel(got, ref) <= 1e-5


def test_spectral_forward_matches_reference_at_bfloat16():
    cfg, jcfg, m, jm = _pair("stockham", compute_dtype="bfloat16")
    jp, p = _carried(jm, 2)
    toks = _tokens(3, 2, 32)
    ref, _, _ = jT.spectral_forward(jp, jnp.asarray(toks), jcfg)
    got, _, _ = T.spectral_forward(p, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and _rel(got, ref) <= 3e-2


@pytest.mark.parametrize("variant,ref_variant", [("stockham", None), ("auto", "stockham")])
def test_masked_loss_matches_reference(variant, ref_variant):
    """``Model.loss_fn`` on ``make_batch``'s MLM batch (tokens with 15%
    masked to id 0, the original tokens as targets, ``mlm_mask``): the
    masked cross entropy, and without a mask (targets the tokens)."""
    cfg, jcfg, m, jm = _pair(variant, ref_variant)
    jp, p = _carried(jm, 4)
    batch = make_batch(cfg, 2, 32, 5, device="cpu")
    assert sorted(batch) == ["mlm_mask", "targets", "tokens"] and float(batch["mlm_mask"].sum()) > 0
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jloss, jmetrics = jm.loss_fn(jp, jbatch)
    loss, metrics = m.loss_fn(p, batch)
    assert sorted(metrics) == sorted(jmetrics)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    plain = {"tokens": batch["tokens"]}
    jloss, _ = jm.loss_fn(jp, {"tokens": jbatch["tokens"]})
    loss, _ = m.loss_fn(p, plain)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_prefill_fn_gives_the_last_positions_logits():
    cfg, jcfg, m, jm = _pair("stockham")
    jp, p = _carried(jm, 6)
    toks = _tokens(7, 3, 16)
    ref, jcaches = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, None)
    got, caches = m.prefill_fn(p, {"tokens": torch.from_numpy(toks)}, None)
    assert caches is None and jcaches is None
    assert got.shape == (3, cfg.vocab) and _rel(got, ref) <= 1e-5


def test_fourier_lm_has_no_decode_step_and_the_launcher_exits():
    """A bidirectional mixer has no causal decode: ``decode_fn`` and
    ``init_cache_fn`` are None, as in the reference, and the launcher
    exits naming the arch."""
    model, jmodel = build(reg.smoke_config(ARCH)), jbuild(jreg.smoke_config(ARCH))
    assert model.decode_fn is None and model.init_cache_fn is None
    assert jmodel.decode_fn is None and jmodel.init_cache_fn is None
    with pytest.raises(SystemExit, match="fourier_lm has no decode step"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_fourier_lm_builds_at_full_width():
    """fourier_lm's 58.7 M parameters (12 blocks, d_model 512, d_ff 2048,
    vocab 32768), the reference's count and skeleton."""
    model, jmodel = build(reg.get_config(ARCH)), jbuild(jreg.get_config(ARCH))
    assert model.n_params == jmodel.n_params == 58_733_056
    assert reg.get_config(ARCH).fft_variant == "auto"


@pytest.mark.parametrize("variant", ["stockham", "fused", "auto"])
@pytest.mark.parametrize("s", [12, 24])
def test_a_sequence_not_a_power_of_two_raises_as_in_the_reference(variant, s):
    """The forward pads nothing (``seq_pad_to_pow2`` is the caller's, as in
    the reference): a sequence of 12 or 24 raises ``ValueError`` naming a
    power of two, as the reference's forward does under the same variant
    (its "auto" runs as ``stockham`` here)."""
    cfg, jcfg, m, jm = _pair(variant, "stockham" if variant == "auto" else None)
    jp, p = _carried(jm, 0)
    toks = _tokens(1, 2, s)
    with pytest.raises(ValueError, match="power"):
        jT.spectral_forward(jp, jnp.asarray(toks), jcfg)
    with pytest.raises(ValueError, match="power of two"):
        T.spectral_forward(p, torch.from_numpy(toks), cfg)


def test_mixing_runs_once_a_block(monkeypatch):
    """Each block mixes once, through ``fourier_mixing`` under the
    config's variant, on its pre-normed (B, S, D) input."""
    from repro_torch.models import transformer

    cfg = reg.smoke_config(ARCH).scaled(n_layers=3)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []
    route = transformer.fourier_mixing

    def counted(h, variant):
        seen.append((tuple(h.shape), variant))
        return route(h, variant=variant)

    monkeypatch.setattr(transformer, "fourier_mixing", counted)
    model.loss_fn(params, make_batch(cfg, 2, 16, 0, device="cpu"))
    assert seen == [((2, 16, cfg.d_model), "auto")] * 3
