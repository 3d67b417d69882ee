"""repro_torch's flash attention against repro's Pallas kernel and oracle.

The same seeded numpy inputs go through the Pallas ``flash_attention_fwd``
in interpret mode, the reference's ``mha_reference`` and the port on CPU
tensors (which runs the plain online-softmax version), held to atol 2e-5,
the reference's own tolerance (tests/kernels/test_flash_attention.py).
The CUDA kernel itself is tested on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
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


def test_plain_path_launches_nothing():
    reset_launches()
    q = torch.ones(1, 8, 4)
    fa.flash_attention_fwd(q, q, q)
    assert set(LAUNCHES.values()) == {0}


def test_smem_census_fits_one_block_up_to_the_head_limit():
    assert fa.flash_smem_bytes(fa.MAX_HEAD_DIM, fa.MAX_HEAD_DIM) <= 232_448
    assert fa.flash_smem_bytes(128, 128) == 4 * (128 * 129 + 64 * 128 + 64 * 65 + 192)
    assert [fa._acc_columns(dv) for dv in (1, 16, 17, 128, 192, 256)] == [1, 1, 2, 8, 16, 16]
