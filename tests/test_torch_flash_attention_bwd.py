"""flash_attention_bwd's plain version, the two autograd Functions, the
guard on kernel entries without a backward, and remat, on the CPU.

* ``flash_attention_bwd_plain`` (P recomputed from the forward's
  logsumexp, the reference's key blocks) against float64 autograd of
  ``mha_reference``: causal, a window, non-causal Sq != Sk (cross), D 192
  -> Dv 128 (MLA), Dv 160 (zamba2), and rows that see no key (there
  against float64 autograd of the plain forward, which divides by the
  padded key count as the TPU kernel does). Float32 sums over D and the
  keys in another order: 2e-5 of the largest float64 gradient.
* The model's route (``gqa_to_heads``, q scaled first, the
  ``FlashAttention`` Function at scale 1, back to (B, S, H, Dv)) against
  ``jax.grad`` of the reference's jnp ``flash_attention``
  (``src/repro/models/attention.py:29``) at float32, GQA summing dK and dV
  over each group: 2e-5 likewise.
* ``torch.autograd.gradcheck`` of ``FlashAttention`` in float64 (the plain
  versions keep float64), and of the mixing Function ``ReFFT2`` (whose
  engines compute in complex64: the map is linear, so a step of 0.1 keeps
  rounding under the tolerance); its backward is the mixing of the
  cotangent, bit for bit.
* ``refuse_grad`` and the ladder's re-raise of ``NoBackward`` (the card's
  side is in ``tests/test_torch_kernels_cuda.py``).
* Remat on and off (``"full"`` and ``"dots"``): equal gradients, bit for
  bit, and each block's forward run twice under remat.
* ``csrc/flash_attention_bwd.cu`` compiled with g++ against
  ``tools/cuda_emu`` (stand-ins for its TF32 ``mma.sync``, which read each
  operand's top 19 bits as the tensor core does, ``ldmatrix``, warp
  shuffles and ``cp.async``, whose copies land only at their wait) and run
  through its C entry against the plain version at 2e-5: every width
  instance, partial tiles one past the resident and the streamed tile,
  windows, cross shapes, D 40 against Dv 33, rows that see no key with a
  padded key count at widths 32 and 256. Skips without g++.
"""

import ctypes
import importlib.util
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch import obs, resilience
from repro_torch.configs import registry as reg
from repro_torch.core import spectral
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels._launch import BACKWARD_ITEM, NoBackward, refuse_grad
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.build import build
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.plan.plan import FFTPlan, ProblemKey
from repro_torch.resilience import ladder

TOL = 2e-5
EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"

# (bh, sq, sk, d, dv, causal, window, block_q, block_k)
CASES = {
    "causal": (3, 40, 40, 16, 16, True, None, 16, 16),
    "window": (2, 48, 48, 16, 16, True, 12, 16, 16),
    "cross": (2, 24, 37, 16, 16, False, None, 16, 16),
    "mla 192->128": (2, 20, 20, 192, 128, True, None, 16, 16),
    "dv 160": (2, 20, 20, 160, 160, True, None, 16, 16),
}


def _operands(seed, bh, sq, sk, d, dv, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(bh, sq, d, generator=g, dtype=torch.float64)
    k = torch.randn(bh, sk, d, generator=g, dtype=torch.float64)
    v = torch.randn(bh, sk, dv, generator=g, dtype=torch.float64)
    do = torch.randn(bh, sq, dv, generator=g, dtype=torch.float64)
    return tuple(x.to(dtype) for x in (q, k, v, do))


def _rel(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _float64_grads(fn, q, k, v, do):
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), do.double())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_float64_autograd(case):
    bh, sq, sk, d, dv, causal, window, bq, bk = CASES[case]
    q, k, v, do = _operands(1, bh, sq, sk, d, dv)
    opts = {"causal": causal, "window": window, "block_q": bq, "block_k": bk}
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **opts)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    ref = _float64_grads(lambda q, k, v: fa.mha_reference(q, k, v, causal=causal, window=window),
                         q, k, v, do)
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


def test_plain_backward_on_rows_that_see_no_key():
    """A window of 3 over 10 keys leaves queries past 11 with no key; keys
    padded to 12 (block 4): those rows took mean(v) * Sk / 12 and pass
    dO / 12 to every real key's dV, nothing to dQ or dK."""
    q, k, v, do = _operands(2, 2, 16, 10, 8, 8)
    opts = {"causal": False, "window": 3, "block_q": 4, "block_k": 4}
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **opts)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    ref = _float64_grads(lambda q, k, v: fa.flash_attention_plain(q, k, v, **opts), q, k, v, do)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= TOL
    blind = fa.flash_attention_plain(q, k, v, causal=False, window=3, block_q=4, block_k=4)[:, 12:]
    assert torch.allclose(blind, v.sum(dim=1, keepdim=True).expand_as(blind) / 12, atol=1e-6)


# (b, sq, sk, h, kv, d, dv, causal, window)
MODEL_CASES = {
    "gqa causal": (2, 24, 24, 6, 2, 16, 16, True, None),
    "gqa window": (2, 40, 40, 4, 2, 16, 16, True, 9),
    "cross": (2, 12, 30, 4, 4, 16, 16, False, None),
    "mla": (1, 20, 20, 4, 4, 24, 16, True, None),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_function_route_matches_jax_grad_of_the_reference(case):
    b, sq, sk, h, kv, d, dv, causal, window = MODEL_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, dv)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, dv)).astype(np.float32)
    blocks = {"block_q": 8, "block_k": 8}

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, window=window, **blocks)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    qs = tq * (1.0 / math.sqrt(d))
    out = fa.flash_attention(*attn.gqa_to_heads(qs, tk, tv), causal=causal, window=window,
                             scale=1.0, **blocks)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out = attn.gqa_from_heads(out, b)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, a, r in zip("qkv", got, ref):
        assert a.shape == r.shape
        assert _rel(a, torch.from_numpy(np.array(r))) <= TOL, name


@pytest.mark.parametrize("causal,window,sq,sk,block_k", [
    (True, None, 9, 9, 4), (True, 3, 10, 10, 4), (False, None, 6, 11, 4),
    (False, 2, 12, 5, 2),  # rows that see no key, keys padded from 5 to 6
])
def test_flash_function_gradcheck(causal, window, sq, sk, block_k):
    q, k, v, _ = _operands(4, 2, sq, sk, 4, 3, dtype=torch.float64)
    inputs = tuple(x.requires_grad_() for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttention.apply(q, k, v, causal, window, 4, block_k, None),
        inputs)


@pytest.mark.parametrize("fn,variant", [("fourier_mixing", "auto"), ("fourier_mixing", "stockham"),
                                        ("fourier_mixing_rfft", "stockham")])
def test_mixing_function_gradcheck_and_symmetric_backward(rng, fn, variant):
    mix = getattr(spectral, fn)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16))).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: mix(x, variant=variant), (x,), eps=0.1,
                                    atol=1e-4, rtol=1e-3)
    xf = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    y = mix(xf, variant=variant)
    assert type(y.grad_fn).__name__ == "ReFFT2Backward"
    (dx,) = torch.autograd.grad(y, xf, g)
    assert torch.equal(dx, mix(g, variant=variant))


def test_refuse_grad_raises_only_where_a_gradient_would_be_lost():
    x = torch.ones(3)
    w = torch.ones(3, requires_grad=True)
    refuse_grad("fft_fused", x)  # nothing requires grad
    with torch.no_grad():
        refuse_grad("fft_fused", w)
    for name in ("fft_fused", "rfft2_fused", "butterfly_stage"):
        with pytest.raises(NoBackward, match="divergence 19") as raised:
            refuse_grad(name, x, w)
        assert "kernels.slstm_scan.slstm_scan" in str(raised.value)
    # the sLSTM scan has its backward (SlstmScan): no item names it
    assert "slstm_scan" not in BACKWARD_ITEM

    class Inside(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            refuse_grad("flash_attention_fwd", t)  # a Function's forward runs without grad
            return t * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    assert Inside.apply(w).grad_fn is not None


def test_the_ladder_reraises_no_backward_without_a_failover():
    resilience.reset()
    key = ProblemKey(kind="fft2d", backend="cpu", device_kind="cpu", shape=(4, 8, 8),
                     dtype="complex64", backends=("torch",))
    tried = []

    def runner(v):
        tried.append(v)
        raise NoBackward("fft2_fused on the card has no backward")

    try:
        with obs.capture() as trace, pytest.raises(NoBackward):
            ladder.run_plan(FFTPlan(key=key, variant="radix4"), runner)
        assert tried == ["radix4"] and not trace.select("resilience.failover")
    finally:
        resilience.reset()


# ------------------------------------ remat ------------------------------------


def _grads(model, params, batch):
    views = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = model.loss_fn(views, batch)
    return torch.autograd.grad(loss, tree_leaves(views), allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("arch,block", [("llama3.2-3b", "decoder_block_apply"),
                                        ("whisper-medium", "encdec_block_apply"),
                                        ("fourier_lm", "spectral_block_apply"),
                                        ("xlstm-350m", "xlstm_pair_apply")])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_on_and_off_give_equal_gradients(monkeypatch, arch, block, policy):
    kw = {"fft_variant": "stockham"} if arch == "fourier_lm" else {}
    cfg = reg.smoke_config(arch).scaled(**kw)
    params = build(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            (rng.standard_normal((2, cfg.enc_frames, cfg.d_model)) * 0.5).astype(np.float32))
    calls = []
    inner = getattr(T, block)
    monkeypatch.setattr(T, block, lambda *a, **k: calls.append(1) or inner(*a, **k))
    plain = _grads(build(cfg), params, batch)
    runs = len(calls)
    calls.clear()
    remat = _grads(build(cfg.scaled(remat=True, remat_policy=policy)), params, batch)
    assert len(calls) == 2 * runs > 0  # each block's forward again in the backward
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    calls.clear()
    with torch.no_grad():  # no grad: the blocks run once
        build(cfg.scaled(remat=True, remat_policy=policy)).loss_fn(params, batch)
    assert len(calls) == runs


# ------------------------- the CUDA source, emulated -------------------------


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    so = emulate.compile_library(tmp_path_factory.mktemp("flash_bwd_emu"),
                                 ("flash_attention_bwd.cu",))
    fn = so.repro_flash_attention_bwd
    fn.argtypes = list(_build._SIGNATURES["repro_flash_attention_bwd"])
    fn.restype = ctypes.c_int
    return so


EMU_CASES = {
    # width 32, partial tiles, causal
    "causal d 16": (2, 70, 70, 16, 16, True, None, 256, 512),
    # width 64, non-causal cross Sq != Sk
    "cross d 40": (1, 37, 100, 40, 33, False, None, 256, 512),
    # width 128 at llama's head width, a window
    "window d 128": (1, 130, 130, 128, 128, True, 20, 256, 512),
    # width 256, MLA's D 192 -> Dv 128 and zamba2's Dv 160
    "mla 192->128": (1, 50, 50, 192, 128, True, None, 256, 512),
    "dv 160": (1, 40, 40, 160, 160, True, None, 256, 512),
    # rows that see no key; keys padded from 30 to 32
    "no key": (2, 40, 30, 8, 8, False, 5, 16, 16),
    # Sq and Sk one past a resident tile (64 rows) and a streamed one (32)
    "one past a tile": (1, 65, 65, 16, 16, True, None, 256, 512),
    "one past a streamed tile": (1, 33, 97, 24, 24, False, None, 256, 512),
    # D 40 and Dv 33 (padded to 40), causal, partial tiles
    "d 40 dv 33": (1, 70, 70, 40, 33, True, None, 256, 512),
    # width 256 with a window and rows that see no key: keys padded 24 -> 32
    "window no key 256": (1, 40, 24, 136, 200, False, 6, 16, 16),
}


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_cuda_backward_matches_plain(emu_lib, case):
    bh, sq, sk, d, dv, causal, window, bq, bk = EMU_CASES[case]
    q, k, v, do = _operands(5, bh, sq, sk, d, dv)
    opts = {"causal": causal, "window": window, "block_q": bq, "block_k": bk}
    o, lse = (x.contiguous() for x in fa.flash_attention_plain(q, k, v, return_lse=True, **opts))
    ref = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    outs = [torch.full_like(x, float("nan")) for x in (q, k, v)]
    delta = torch.full((bh, sq), float("nan"))
    rc = emu_lib.repro_flash_attention_bwd(
        *(x.data_ptr() for x in (q, k, v, o, do, lse, delta, *outs)),
        bh, sq, sk, d, dv, int(causal), int(window is not None), fa._c_window(window, sq, sk), 0,
        1 / math.sqrt(d), fa._blocks(sq, sk, bq, bk)[3], fa.bwd_width(d, dv), fa.BWD_THREADS,
        *fa.flash_bwd_smem_bytes(d, dv), 0, None)
    assert rc == 0
    for name, a, b in zip("qkv", outs, ref):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
    assert torch.allclose(delta, (do * o).sum(-1), rtol=1e-5, atol=1e-5)


def test_emulated_entry_refuses_a_wrong_census(emu_lib):
    """The entry launches nothing unless the width instance, the threads
    (4 warps) and both passes' shared memory are the census's."""
    q = torch.zeros(1, 8, 16)
    lse = torch.zeros(1, 8)
    ptrs = [x.data_ptr() for x in (q, q, q, q, q, lse, lse, q, q, q)]
    smem = fa.flash_bwd_smem_bytes(16, 16)

    def call(width, threads, smem_dq, smem_dkdv):
        return emu_lib.repro_flash_attention_bwd(*ptrs, 1, 8, 8, 16, 16, 1, 0, 0, 0, 0.25, 8,
                                                 width, threads, smem_dq, smem_dkdv, 0, None)

    assert call(64, fa.BWD_THREADS, *smem) != 0  # width 32
    assert call(32, 256, *smem) != 0  # 16 x 16 threads
    assert call(32, fa.BWD_THREADS, smem[0] + 4, smem[1]) != 0
    assert call(32, fa.BWD_THREADS, smem[0], smem[0]) != 0  # no room for lse and delta
    assert call(32, fa.BWD_THREADS, *smem) == 0


@pytest.mark.parametrize("d,dv", [(16, 16), (64, 64), (128, 128), (192, 128), (160, 160),
                                  (256, 256)])
def test_backward_census_fits_one_block(d, dv):
    dq, dkdv = fa.flash_bwd_smem_bytes(d, dv)
    assert max(dq, dkdv) <= 232448  # an H100 block's dynamic shared memory
    assert fa.bwd_tile(d, dv) == (64, 16 if max(d, dv) > 128 else 32)
    assert fa.bwd_width(d, dv) >= max(d, dv)


# ------------------------------ a query offset ------------------------------

# (bh, sq, sk, d, dv, causal, window, block_q, block_k, q_offset)
OFFSET_CASES = {
    "causal second half": (2, 32, 64, 16, 16, True, None, 16, 16, 32),
    "window second half, width 128": (1, 40, 80, 128, 128, True, 24, 16, 16, 40),
    "non-causal cross": (1, 20, 37, 40, 33, False, None, 16, 16, 17),
    "past every key": (2, 16, 24, 16, 8, True, None, 16, 16, 40),
    "window, rows that see no key": (1, 24, 20, 8, 8, False, 6, 16, 8, 10),
    "width 256 window": (1, 24, 48, 192, 128, True, 12, 16, 16, 24),
}


@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_plain_backward_with_a_query_offset_matches_float64_autograd(case):
    """At ``q_offset`` the plain backward is float64 autograd of the plain
    forward at that offset (which divides a row that sees no key by the
    padded key count, as the TPU kernel does), and the FlashAttention
    Function carries the offset to it."""
    bh, sq, sk, d, dv, causal, window, bq, bk, off = OFFSET_CASES[case]
    q, k, v, do = _operands(4, bh, sq, sk, d, dv)
    opts = {"causal": causal, "window": window, "block_q": bq, "block_k": bk, "q_offset": off}
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **opts)
    got = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    ref = _float64_grads(lambda q, k, v: fa.flash_attention_plain(q, k, v, **opts), q, k, v, do)
    for name, a, b in zip("qkv", got, ref):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **opts)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    for a, b in zip(torch.autograd.grad(out, (tq, tk, tv), do), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_emulated_cuda_backward_with_a_query_offset_matches_plain(emu_lib, case):
    """The dQ pass's per-row key ranges and the dK/dV pass's first and last
    query rows that see a key, c - q_offset and c + window - 1 - q_offset,
    run on the CPU: within 2e-5 of the plain backward."""
    bh, sq, sk, d, dv, causal, window, bq, bk, off = OFFSET_CASES[case]
    q, k, v, do = _operands(6, bh, sq, sk, d, dv)
    opts = {"causal": causal, "window": window, "block_q": bq, "block_k": bk, "q_offset": off}
    o, lse = (x.contiguous() for x in fa.flash_attention_plain(q, k, v, return_lse=True, **opts))
    ref = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    outs = [torch.full_like(x, float("nan")) for x in (q, k, v)]
    delta = torch.full((bh, sq), float("nan"))
    rc = emu_lib.repro_flash_attention_bwd(
        *(x.data_ptr() for x in (q, k, v, o, do, lse, delta, *outs)),
        bh, sq, sk, d, dv, int(causal), int(window is not None),
        fa._c_window(window, sq, sk, off), off, 1 / math.sqrt(d), fa._blocks(sq, sk, bq, bk)[3],
        fa.bwd_width(d, dv), fa.BWD_THREADS, *fa.flash_bwd_smem_bytes(d, dv), 0, None)
    assert rc == 0
    for name, a, b in zip("qkv", outs, ref):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
