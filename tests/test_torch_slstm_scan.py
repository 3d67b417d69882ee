"""repro_torch's sLSTM scan against repro's Pallas kernel and step oracle.

The reference's ``slstm_skel`` parameters (seeded ``init_params``) are
carried across with ``slstm_weights_from_jax``; the same numpy gate
pre-activations go through the Pallas ``slstm_scan`` in interpret mode, a
loop of the reference's ``models.xlstm._slstm_step`` and the port on CPU
tensors (which runs the plain step loop), held to atol 2e-5, the
reference's own tolerance (tests/kernels/test_slstm_scan.py). The CUDA
kernel itself is tested on the card by tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_scan import hbm_traffic_estimate as j_traffic
from repro.kernels.slstm_scan import slstm_scan as j_slstm_scan
from repro.models import xlstm as X
from repro.models.config import ModelConfig
from repro.models.param import init_params
from repro_torch.kernels._launch import LAUNCHES, reset_launches
from repro_torch.kernels.slstm_scan import (
    hbm_traffic_estimate,
    slstm_scan,
    slstm_state,
    slstm_step,
    slstm_weights_from_jax,
)

ATOL = 2e-5


def _cfg(d):
    return ModelConfig(name="t", family="ssm", n_layers=1, d_model=d, n_heads=4,
                       n_kv_heads=4, d_ff=0, vocab=10)


def _params(d):
    p = init_params(X.slstm_skel(_cfg(d)), jax.random.PRNGKey(0))
    return {name: np.asarray(a) for name, a in p.items()}


@pytest.mark.parametrize("m0", [-1e30, float("-inf")], ids=["m0=-1e30", "m0=-inf"])
@pytest.mark.parametrize("b,l,d,chunk", [(1, 8, 32, 4), (2, 32, 64, 8), (3, 64, 128, 16)])
def test_scan_matches_pallas_and_step_loop(b, l, d, chunk, m0):
    p = _params(d)
    x = (np.random.default_rng(d).standard_normal((b, l, d)) * 0.5).astype(np.float32)
    xg = np.einsum("bld,dk->blk", x, p["wx"]).astype(np.float32)
    z = np.zeros((b, d), np.float32)
    m = np.full((b, d), m0, np.float32)
    ref_hs, ref_state = j_slstm_scan(
        jnp.asarray(xg), jnp.asarray(p["wr"]), jnp.asarray(p["bias"]), z, z, z, m,
        chunk=chunk, interpret=True)
    st = X.slstm_state(_cfg(d), b)
    step_hs = []
    for t in range(l):
        st = X._slstm_step(p, st, jnp.asarray(xg[:, t]), d)
        step_hs.append(np.asarray(st["h"]))

    w = slstm_weights_from_jax(p, device="cpu")
    t0 = torch.from_numpy(z)
    hs, state = slstm_scan(torch.from_numpy(xg), w["wr"], w["bias"], t0, t0, t0,
                           torch.from_numpy(m), chunk=chunk)
    assert hs.shape == (b, l, d) and not torch.isnan(hs).any()
    np.testing.assert_allclose(hs.numpy(), np.asarray(ref_hs), atol=ATOL)
    np.testing.assert_allclose(hs.numpy(), np.stack(step_hs, 1), atol=ATOL)
    for got, ref, name in zip(state, ref_state, "cnhm"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(st[name]), atol=ATOL, err_msg=name)


def test_step_and_state_match_the_reference_model():
    d, b = 64, 3
    p = _params(d)
    xt = np.random.default_rng(1).standard_normal((b, 4 * d)).astype(np.float32)
    ref0 = X.slstm_state(_cfg(d), b)
    got0 = slstm_state(b, d, device="cpu")
    for name in "cnhm":
        np.testing.assert_array_equal(got0[name].numpy(), np.asarray(ref0[name]))
    ref = X._slstm_step(p, X._slstm_step(p, ref0, jnp.asarray(xt), d), jnp.asarray(xt), d)
    w = slstm_weights_from_jax(p, device="cpu")
    got = slstm_step(w, slstm_step(w, got0, torch.from_numpy(xt), d),
                     torch.from_numpy(xt), d)
    for name in "cnhm":
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=ATOL)


def test_weights_carry_across_exactly():
    p = _params(32)
    w = slstm_weights_from_jax(p, device="cpu")
    assert sorted(w) == ["bias", "wr", "wx"]
    for name, t in w.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), p[name])
    assert tuple(w["wr"].shape) == (4, 8, 32) and tuple(w["wx"].shape) == (32, 128)


def test_scan_checks_its_input():
    z = torch.zeros(2, 32)
    xg = torch.zeros(2, 8, 128)
    wr = torch.zeros(4, 8, 32)
    bias = torch.zeros(128)
    with pytest.raises(ValueError, match="not divisible"):
        slstm_scan(xg, wr, bias, z, z, z, z, chunk=3)
    with pytest.raises(ValueError):
        slstm_scan(xg, torch.zeros(4, 8, 16), bias, z, z, z, z)
    with pytest.raises(ValueError):
        slstm_scan(xg, wr, bias, z, z, z, torch.zeros(3, 32))
    with pytest.raises(TypeError):
        slstm_scan(xg, wr, bias.long(), z, z, z, z)


def test_plain_path_launches_nothing():
    reset_launches()
    z = torch.zeros(1, 32)
    slstm_scan(torch.zeros(1, 4, 128), torch.zeros(4, 8, 32), torch.zeros(128), z, z, z,
               torch.full((1, 32), float("-inf")))
    assert set(LAUNCHES.values()) == {0}


def test_traffic_estimate_matches_reference():
    for args in [(32, 32768, 1024, True), (32, 32768, 1024, False), (8, 4096, 1024, True)]:
        assert hbm_traffic_estimate(*args) == j_traffic(*args)
