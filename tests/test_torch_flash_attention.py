"""repro_torch's flash attention against repro's Pallas kernel and oracle.

The same seeded numpy inputs go through the Pallas ``flash_attention_fwd``
in interpret mode, the reference's ``mha_reference`` and the port on CPU
tensors (which runs the plain online-softmax version), held to atol 2e-5,
the reference's own tolerance (tests/kernels/test_flash_attention.py).
The CUDA kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.

The card kernel's numerical design is tested here in numpy: its products
run on the tensor cores in TF32, each float32 operand split into a TF32
``big`` part and a TF32 ``small`` remainder and each product taken as
three TF32 products. An emulation of that arithmetic on the float32 bits,
walking the kernel's key tiles in its key order, meets the 2e-5 gate
against the Pallas kernel, with ``big`` rounded to nearest as ``cvt.rna``
does and with ``big`` truncated as the kernel takes it; a single TF32
product does not. The emulation lives only in this file.
"""

import ctypes
import importlib.util
import math
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels._launch import LAUNCHES, reset_launches

ATOL = 2e-5

# (bh, sq, sk, d, dv, causal, window, block_q, block_k): the reference's
# cases (tests/kernels/test_flash_attention.py) with dv = d, and one with
# dv != d as MLA has (qk 192, v 128).
CASES = [
    (2, 64, 64, 32, 32, True, None, 16, 16),
    (3, 128, 128, 16, 16, True, 32, 32, 32),    # sliding window
    (1, 48, 96, 8, 8, False, None, 16, 32),     # cross-attention, ragged
    (2, 100, 100, 16, 16, True, None, 32, 32),  # non-divisible seq
    (1, 256, 256, 64, 64, True, None, 64, 128),
    (2, 80, 80, 24, 16, True, 40, 16, 32),      # dv != d, window, ragged
]


def _inputs(seed, bh, sq, sk, d, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, dv)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_matches_pallas_and_oracle(case):
    bh, sq, sk, d, dv, causal, window, bq, bk = case
    q, k, v = _inputs(sum(case[:5]), bh, sq, sk, d, dv)
    ref = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=bq, block_k=bk,
                                  interpret=True)
    oracle = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention_fwd(tq, tk, tv, causal=causal, window=window,
                                 block_q=bq, block_k=bk)
    assert got.shape == (bh, sq, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)
    port_oracle = fa.mha_reference(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(port_oracle.numpy(), np.asarray(oracle), atol=ATOL)


def test_flash_matches_pallas_on_rows_that_see_no_key():
    """Queries past Sk + window - 1 see no key. The Pallas kernel then
    returns sum(v) / (Sk padded to block_k); the plain version walks the
    same blocks and returns the same."""
    q, k, v = _inputs(7, 2, 40, 12, 8, 8)
    ref = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=False, window=6, block_q=16, block_k=8,
                                  interpret=True)
    got = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=False, window=6, block_q=16, block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(got.numpy()[:, 17:], np.broadcast_to(
        v.sum(axis=1, keepdims=True) / 16, (2, 23, 8)), atol=ATOL)


def test_flash_checks_its_input():
    q = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(2, 8, 5), torch.zeros(2, 8, 4))  # D differs
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(2, 0, 4), torch.zeros(2, 0, 4))  # no keys
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(2, 8, 4), torch.zeros(2, 6, 4))  # Sk differs
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.int(), torch.zeros(2, 8, 4), torch.zeros(2, 8, 4))


@pytest.mark.parametrize("factor", [1.0, 0.25])
def test_scale_argument_scales_the_scores(factor):
    """``scale`` replaces the default 1/sqrt(D): q pre-multiplied by
    ``factor`` / sqrt(D) with scale 1 gives the default at ``factor`` 1, and
    the oracle on the scaled q otherwise (the model's card route passes a
    q scaled in its own dtype, and 1)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 2, 48, 48, 16, 16))
    d = q.shape[-1]
    got = fa.flash_attention_fwd(q * (factor / np.sqrt(d)), k, v, causal=True,
                                 block_q=16, block_k=16, scale=1.0)
    ref = fa.mha_reference(q * factor, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
    if factor == 1.0:
        default = fa.flash_attention_fwd(q, k, v, causal=True, block_q=16, block_k=16)
        np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-6)


def test_plain_path_launches_nothing():
    reset_launches()
    q = torch.ones(1, 8, 4)
    fa.flash_attention_fwd(q, q, q)
    assert set(LAUNCHES.values()) == {0}


def test_smem_census_fits_one_block_up_to_the_head_limit():
    assert fa.flash_smem_bytes(fa.MAX_HEAD_DIM, fa.MAX_HEAD_DIM) <= 232_448
    assert fa.flash_smem_bytes(fa.MAX_HEAD_DIM, 128) <= 232_448  # the widest query tile
    # Q tile (128 rows, 64 where Dv > 128) and 32-key K and V tiles, rows
    # padded to a multiple of 8 plus 4 floats.
    assert fa.flash_smem_bytes(128, 128) == 4 * ((128 + 32) * 132 + 32 * 132) == 101_376
    assert fa.flash_smem_bytes(256, 256) == 4 * ((64 + 32) * 260 + 32 * 260) == 133_120
    assert fa.flash_smem_bytes(256, 128) == 4 * ((128 + 32) * 260 + 32 * 132) == 183_296
    assert fa.flash_smem_bytes(100, 72) == 4 * ((128 + 32) * 108 + 32 * 76)
    assert [fa._acc_columns(dv) for dv in (1, 8, 9, 16, 17, 128, 129, 256)] == [
        1, 1, 2, 2, 4, 16, 32, 32]


def test_smem_census_lets_two_blocks_share_an_sm_at_head_128():
    """The kernel's occupancy target: at D = Dv = 128, two blocks of 4 warps
    (each with the 1 KiB the card reserves per block) fit one SM's 228 KiB."""
    assert fa.THREADS == 128
    assert 2 * (fa.flash_smem_bytes(128, 128) + 1024) <= 233_472
    assert [fa.query_tile(dv) for dv in (1, 128, 129, 256)] == [128, 128, 64, 64]


# --- the card kernel's arithmetic, emulated -------------------------------

def _tf32(x):
    """TF32 rounding as ``cvt.rna.tf32.f32`` does it: add half of the 14th
    bit's unit to the float32 bits (ties away from zero) and clear the low
    13 bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_truncate(x):
    """TF32 by truncation: the low 13 bits of the float32 value cleared.
    The kernel takes ``big`` so, and the mma reads any operand so."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


ROUNDINGS = {"rna": _tf32, "truncate": _tf32_truncate}


def _split_matmul(a, b, tf32=_tf32):
    """a @ b as three TF32 products, small*big and big*small first,
    big*big last, summed in float32 (each product of two TF32 values is
    exact in float32); ``tf32`` makes big from x and small from x - big."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _tf32_matmul(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _kernel_attention(q, k, v, *, causal, window, block_k, matmul):
    """The card kernel's online softmax in numpy: key tiles of 32, within
    each 8-key slice the keys in the PV product's order
    (k-column t is key 2t, t + 4 is key 2t + 1), NEG_INF masks, l floored
    at 1e-20, and rows that see no key divided by Sk padded to block_k.
    Every tile is visited: the kernel's skips change no row that sees a
    key."""
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    tile = fa.TILE_K
    nt = -(-sk // tile)
    k = np.pad(k, ((0, 0), (0, nt * tile - sk), (0, 0)))
    v = np.pad(v, ((0, 0), (0, nt * tile - sk), (0, 0)))
    order = np.concatenate([8 * j + np.r_[0:8:2, 1:8:2] for j in range(tile // 8)])
    qpos = np.arange(sq)[:, None]
    scale = np.float32(1.0 / np.sqrt(d))
    acc = np.zeros((bh, sq, dv), np.float32)
    m = np.full((bh, sq, 1), fa.NEG_INF, np.float32)
    l = np.zeros((bh, sq, 1), np.float32)
    for k0 in range(0, nt * tile, tile):
        kb, vb = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = matmul(q, kb.transpose(0, 2, 1)) * scale
        kpos = k0 + np.arange(tile)[None, :]
        keep = kpos < sk
        if causal:
            keep = keep & (kpos <= qpos)
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = np.where(keep, s, np.float32(fa.NEG_INF))
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        p = np.exp(s - m_new)
        corr = np.exp(m - m_new)
        l = l * corr + p.sum(axis=-1, keepdims=True)
        acc = acc * corr + matmul(p[..., order], vb[:, order])
        m = m_new
    sk_pad = -(-sk // min(block_k, sk)) * min(block_k, sk)
    l = np.where(m == np.float32(fa.NEG_INF), np.float32(sk_pad), l)
    return acc / np.maximum(l, np.float32(1e-20))


# D = 128, Sq = Sk = 512, causal: the head width of the models the card
# path serves, at a length where one TF32 product's error shows.
WIDE = (2, 512, 512, 128, 128, True, None, 256, 512)


def _pallas(q, k, v, causal, window, bq, bk):
    return np.asarray(jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal, window=window, block_q=bq,
                                              block_k=bk, interpret=True))


@pytest.mark.parametrize("rounding", sorted(ROUNDINGS))
@pytest.mark.parametrize("case", CASES + [WIDE], ids=str)
def test_split_tf32_attention_matches_pallas(case, rounding):
    bh, sq, sk, d, dv, causal, window, bq, bk = case
    q, k, v = _inputs(sum(case[:5]), bh, sq, sk, d, dv)
    ref = _pallas(q, k, v, causal, window, bq, bk)
    got = _kernel_attention(q, k, v, causal=causal, window=window, block_k=bk,
                            matmul=lambda a, b: _split_matmul(a, b, ROUNDINGS[rounding]))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= ATOL


def test_one_tf32_product_misses_the_gate():
    """Without the split, TF32's 11 significant bits leave the result some
    1e-4 from float32: over the kernel's 2e-5 gate (max|d| / max|ref|)."""
    bh, sq, sk, d, dv, causal, window, bq, bk = WIDE
    q, k, v = _inputs(sum(WIDE[:5]), bh, sq, sk, d, dv)
    ref = _pallas(q, k, v, causal, window, bq, bk)
    one = _kernel_attention(q, k, v, causal=causal, window=window, block_k=bk,
                            matmul=_tf32_matmul)
    split = _kernel_attention(q, k, v, causal=causal, window=window, block_k=bk,
                              matmul=_split_matmul)
    rel = lambda x: np.abs(x - ref).max() / np.abs(ref).max()  # noqa: E731
    assert rel(one) > ATOL
    assert rel(split) <= ATOL / 20


# --- a query offset (context-parallel attention's slice of the queries) ---

# (bh, sq, sk, d, dv, causal, window, block_q, block_k, q_offset)
OFFSET_CASES = {
    "causal, second half": (2, 32, 64, 16, 16, True, None, 16, 16, 32),
    "window, second half": (2, 48, 96, 16, 16, True, 24, 16, 32, 48),
    "non-causal": (1, 20, 40, 8, 8, False, None, 16, 16, 20),
    "past every key": (2, 16, 24, 16, 8, True, None, 16, 16, 40),
    "window, rows that see no key": (1, 24, 20, 8, 8, False, 6, 16, 8, 10),
}


@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_plain_with_a_query_offset_is_the_whole_attention_s_rows(case):
    """Rows [off, off + Sq) of the attention over every position are the
    plain version's at ``q_offset=off`` on those rows' queries, and the
    oracle's at that offset; where queries [0, Sk) cover the offset the
    Pallas kernel on the whole gives the same rows."""
    bh, sq, sk, d, dv, causal, window, bq, bk, off = OFFSET_CASES[case]
    q, k, v = (torch.from_numpy(x) for x in _inputs(11, bh, off + sq, sk, d, dv))
    opts = dict(causal=causal, window=window, block_q=bq, block_k=bk)
    whole = fa.flash_attention_fwd(q, k, v, **opts)
    got = fa.flash_attention_fwd(q[:, off:].contiguous(), k, v, q_offset=off, **opts)
    assert got.shape == (bh, sq, dv)
    np.testing.assert_allclose(got.numpy(), whole[:, off:].numpy(), atol=1e-6)
    oracle = fa.mha_reference(q[:, off:], k, v, causal=causal, window=window, q_offset=off)
    seen = fa._mask(off + torch.arange(sq)[:, None], torch.arange(sk)[None], sk, causal,
                    window).expand(sq, sk).any(dim=-1)
    np.testing.assert_allclose(got[:, seen].numpy(), oracle[:, seen].numpy(), atol=ATOL)
    ref = jfa.flash_attention_fwd(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                  interpret=True, **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, off:], atol=ATOL)


def test_query_offset_is_checked():
    q = torch.zeros(1, 8, 4)
    for bad in (-1, 1.5, True):
        with pytest.raises(ValueError, match="q_offset"):
            fa.flash_attention_fwd(q, q, q, q_offset=bad)
    with pytest.raises(NotImplementedError, match="q_offset"):
        fa.flash_attention_fwd(q, q, q, q_offset=2 ** 31)
    assert fa._c_window(10 ** 9, 8, 8, 100) == 100 + 8 + 8 + 1
    assert fa._c_window(-50, 8, 8, 100) == -8


# --- csrc/flash_attention.cu through tools/cuda_emu ----------------------

EMU = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


@pytest.fixture(scope="module")
def emu_fwd(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    spec = importlib.util.spec_from_file_location("cuda_emulate", EMU)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    so = emulate.compile_library(tmp_path_factory.mktemp("flash_fwd_emu"),
                                 ("flash_attention.cu",))
    fn = so.repro_flash_attention_fwd
    fn.argtypes = list(_build._SIGNATURES["repro_flash_attention_fwd"])
    fn.restype = ctypes.c_int
    return so


def _emu_forward(lib, q, k, v, *, causal, window, block_q, block_k, q_offset):
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    out = torch.full((bh, sq, dv), float("nan"))
    lse = torch.full((bh, sq), float("nan"))
    rc = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, sq, sk,
        d, dv, int(causal), int(window is not None), fa._c_window(window, sq, sk, q_offset),
        q_offset, 1 / math.sqrt(d), fa._blocks(sq, sk, block_q, block_k)[3],
        fa._acc_columns(dv), fa.THREADS, fa.flash_smem_bytes(d, dv), 0, None)
    assert rc == 0
    return out, lse


@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_emulated_cuda_forward_with_a_query_offset_matches_plain(emu_fwd, case):
    """The kernel's tile range, per-row key ranges and the every-row-sees-
    a-key test at a query offset, run on the CPU (each product split into
    three TF32 products, emulated): within 2e-5 of the plain version, the
    logsumexp too."""
    bh, sq, sk, d, dv, causal, window, bq, bk, off = OFFSET_CASES[case]
    q, k, v = (torch.from_numpy(x) for x in _inputs(12, bh, sq, sk, d, dv))
    opts = dict(causal=causal, window=window, block_q=bq, block_k=bk, q_offset=off)
    out, lse = _emu_forward(emu_fwd, q, k, v, **opts)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, return_lse=True, **opts)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5, atol=1e-5)


def test_emulated_cuda_forward_without_an_offset_matches_plain(emu_fwd):
    """Offset 0 over two query tiles (128 rows each) and a window: the
    kernel as the model runs it."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(13, 1, 160, 160, 16, 16))
    opts = dict(causal=True, window=40, block_q=64, block_k=64, q_offset=0)
    out, _ = _emu_forward(emu_fwd, q, k, v, **opts)
    np.testing.assert_allclose(out.numpy(), fa.flash_attention_plain(q, k, v, **opts).numpy(),
                               atol=ATOL)
