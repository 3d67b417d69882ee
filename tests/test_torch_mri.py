"""repro_torch.mri on CPU tensors, held to numpy in float64.

``repro.mri`` does not import on this jax (``repro/mri/__init__.py`` imports
``repro.xfft``, which needs ``jax.experimental.enable_x64``), so the port is
held to numpy float64 oracles on the inputs and assertions of
``tests/mri/`` (N 64, 4 coils): the reference's gates, with its
tolerances. The numpy-only fixtures (``shepp_logan``, ``birdcage_maps``,
``uniform_mask``, ``variable_density_mask``, ``acceleration``) are held bit
for bit to the reference's own files, loaded by path, since their package
does not import; nothing in ``repro`` is patched.

Tolerances, relative to the largest value of the oracle unless stated:
operators against numpy float64 2e-5 (float32 transforms of 64x64 frames);
adjointness |<Au, v> - <u, Aᴴv>| <= 1e-4 |<Au, v>| in single and 1e-12 in
double; unitarity and zero-motion 1e-5 absolute (the reference's); CG-SENSE
against a numpy float64 CG of the same iterations 1e-3 (float32 rounding
carried through ten iterations); the reconstruction gates are the
reference's margins.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import mri, obs, xfft

ROOT = Path(__file__).resolve().parents[1]
N = 64
COILS = 4
SHIFTS = np.array([[0.0, 0.0], [3.0, -2.0]], np.float32)
T = torch.from_numpy


def _reference_module(name):
    """``src/repro/mri/<name>.py`` loaded by path: its package's
    ``__init__`` imports ``repro.xfft``, which this jax cannot import."""
    spec = importlib.util.spec_from_file_location(f"_reference_mri_{name}",
                                                  ROOT / "src" / "repro" / "mri" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref_phantom = _reference_module("phantom")
ref_masks = _reference_module("masks")


@pytest.fixture(scope="module")
def phantom():
    return mri.shepp_logan(N)


@pytest.fixture(scope="module")
def smaps():
    return mri.birdcage_maps(COILS, N)


# ------------------------------ numpy oracles ------------------------------

AXES = (-2, -1)


def np_fwd(x):
    return np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(x, axes=AXES), norm="ortho"),
                           axes=AXES)


def np_inv(k):
    return np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(k, axes=AXES), norm="ortho"),
                           axes=AXES)


def np_sense_forward(image, smaps, mask=None):
    k = np_fwd(smaps.astype(np.complex128) * image[..., None, :, :])
    return k if mask is None else k * mask


def np_sense_adjoint(k, smaps, mask=None):
    k = k if mask is None else k * mask
    return np.sum(np.conj(smaps.astype(np.complex128)) * np_inv(k), axis=-3)


def np_shift(x, shifts):
    """Fourier shift of (H, W) ``x`` by each (dy, dx) of ``shifts``."""
    h, w = x.shape[-2:]
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    dy, dx = shifts[:, 0, None, None], shifts[:, 1, None, None]
    return np.fft.ifft2(np.fft.fft2(x) * np.exp(-2j * np.pi * (fy * dy + fx * dx)))


def np_cg(normal_op, b, iters):
    """The reference's cg_normal in numpy float64, with its residual trace."""
    x = np.zeros_like(b)
    r, p = b, b
    dot = lambda a, c: np.real(np.sum(np.conj(a) * c, axis=AXES))  # noqa: E731
    rs = dot(r, r)
    bnorm = np.sqrt(np.maximum(rs, 1e-30))
    trace = []
    for _ in range(iters):
        q = normal_op(p)
        alpha = rs / np.maximum(dot(p, q), 1e-30)
        x = x + alpha[..., None, None] * p
        r = r - alpha[..., None, None] * q
        rs_new = dot(r, r)
        trace.append(float(np.max(np.sqrt(np.maximum(rs_new, 0.0)) / bnorm)))
        p = r + (rs_new / np.maximum(rs, 1e-30))[..., None, None] * p
        rs = rs_new
    return x, trace


def _close(got, want, tol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err <= tol, err


def _crand(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


# ------------------------------ the fixtures ------------------------------


@pytest.mark.parametrize("n", [8, 33, 64, 256])
def test_phantom_and_maps_are_the_references_bit_for_bit(n):
    assert np.array_equal(mri.shepp_logan(n), ref_phantom.shepp_logan(n))
    for coils in (1, 4, 16):
        got, want = mri.birdcage_maps(coils, n), ref_phantom.birdcage_maps(coils, n)
        assert got.dtype == want.dtype == np.complex64 and np.array_equal(got, want)


@pytest.mark.parametrize("shape,accel,calib,seed", [((64, 64), 2, 16, 0), ((64, 48), 4, 8, 7),
                                                    ((128, 64), 4, 0, 0), ((64, 64), 8, 12, 3),
                                                    ((256, 256), 4, 24, 11)])
def test_masks_are_the_references_bit_for_bit(shape, accel, calib, seed):
    u = mri.uniform_mask(shape, accel, calib)
    assert u.dtype == np.float32 and np.array_equal(u, ref_masks.uniform_mask(shape, accel, calib))
    v = mri.variable_density_mask(shape, accel, calib, seed)
    assert np.array_equal(v, ref_masks.variable_density_mask(shape, accel, calib, seed))
    assert mri.acceleration(v) == ref_masks.acceleration(v)


def test_mask_contracts():
    m = mri.uniform_mask((64, 48), 4, calib=8)
    rows = (m != 0).any(axis=1)
    np.testing.assert_array_equal(m[rows], 1.0)
    assert rows[::4].all() and rows[28:36].all() and not rows[1] and not rows[2]
    a = mri.variable_density_mask((64, 64), 4, seed=7)
    assert np.array_equal(a, mri.variable_density_mask((64, 64), 4, seed=7))
    assert (a != mri.variable_density_mask((64, 64), 4, seed=8)).any()
    c = (mri.variable_density_mask((128, 64), 4, calib=0, seed=0) != 0).any(axis=1)
    assert c[32:96].mean() > np.concatenate([c[:32], c[96:]]).mean()
    assert (mri.variable_density_mask((64, 64), 8, calib=12, seed=3)[26:38] == 1.0).all()
    assert mri.acceleration(mri.uniform_mask((64, 64), 4, calib=0)) == pytest.approx(4.0)
    with pytest.raises(ValueError, match="no samples"):
        mri.acceleration(np.zeros((8, 8)))
    with pytest.raises(ValueError, match="shape"):
        mri.uniform_mask((64,), 2)
    with pytest.raises(ValueError, match="acceleration"):
        mri.uniform_mask((64, 64), 0)
    with pytest.raises(ValueError, match="calibration"):
        mri.uniform_mask((64, 64), 2, calib=100)


@pytest.mark.parametrize("make", [
    lambda: mri.uniform_mask((64, 64), 4, calib=16),
    lambda: mri.variable_density_mask((64, 64), 4, calib=16, seed=7),
    lambda: mri.uniform_mask((64, 64), 2, calib=0) != 0,
], ids=["uniform", "variable_density", "bool"])
def test_mask_helpers_take_a_tensor_mask(phantom, smaps, make):
    """ROADMAP queue 3, F2: ``acceleration``, ``estimate_sensitivities(mask=)``
    and ``shot_masks`` take a tensor mask and give what the numpy mask
    gives, bit for bit (the card's case is in test_torch_kernels_cuda.py)."""
    mask = make()
    assert mri.acceleration(T(mask)) == mri.acceleration(mask)
    np.testing.assert_array_equal(mri.shot_masks(T(mask), 3), mri.shot_masks(mask, 3))
    k = T(np_sense_forward(phantom, smaps))
    if mask.dtype == bool:  # no calibration rows: both refuse the block
        with pytest.raises(ValueError, match="calibration block"):
            mri.estimate_sensitivities(k, calib=16, mask=mask)
        with pytest.raises(ValueError, match="calibration block"):
            mri.estimate_sensitivities(k, calib=16, mask=T(mask))
    else:
        assert torch.equal(mri.estimate_sensitivities(k, calib=16, mask=T(mask)),
                           mri.estimate_sensitivities(k, calib=16, mask=mask))
    with pytest.raises(ValueError, match="no samples"):
        mri.acceleration(torch.zeros(8, 8))


# ------------------------------- operators -------------------------------


def test_operators_match_numpy_float64(rng, phantom, smaps):
    mask = mri.uniform_mask((N, N), 2)
    batch = np.stack([phantom, phantom[::-1].copy()])
    k = mri.sense_forward(T(batch), T(smaps), mask)
    assert k.shape == (2, COILS, N, N) and k.dtype == torch.complex64
    _close(k.numpy(), np_sense_forward(batch, smaps, mask))
    v = _crand(rng, (2, COILS, N, N))
    img = mri.sense_adjoint(T(v), T(smaps), mask)
    assert img.shape == (2, N, N)
    _close(img.numpy(), np_sense_adjoint(v, smaps, mask))
    single = mri.sense_forward(T(batch[1]), T(smaps))
    np.testing.assert_allclose(mri.sense_forward(T(batch), T(smaps))[1].numpy(),
                               single.numpy(), atol=1e-5)
    rss = mri.rss_combine(T(v))
    _close(rss.numpy(), np.sqrt(np.sum(np.abs(v.astype(np.complex128)) ** 2, axis=-3)))


def test_unitarity_with_normalised_maps(phantom, smaps):
    x = phantom.astype(np.complex64)
    back = mri.sense_adjoint(mri.sense_forward(T(x), T(smaps)), T(smaps))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    np.testing.assert_allclose(mri.rss_combine(T(smaps)).numpy(), 1.0, atol=1e-5)


def test_adjointness_single(rng, smaps):
    mask = mri.uniform_mask((N, N), 2)
    u, v = _crand(rng, (N, N)), _crand(rng, smaps.shape)
    au = mri.sense_forward(T(u), T(smaps), mask).numpy()
    ahv = mri.sense_adjoint(T(v), T(smaps), mask).numpy()
    lhs, rhs = np.vdot(au, v), np.vdot(u, ahv)
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_adjointness_double(rng):
    """At double precision the centered transforms keep complex128 end to
    end (the reference_x64 engine), so the identity holds to 1e-12."""
    smaps = mri.birdcage_maps(4, 32).astype(np.complex128)
    mask = mri.uniform_mask((32, 32), 2)
    u = _crand(rng, (32, 32), np.complex128)
    v = _crand(rng, smaps.shape, np.complex128)
    with xfft.config(precision="double"):
        au = mri.sense_forward(T(u), T(smaps), mask)
        ahv = mri.sense_adjoint(T(v), T(smaps), mask)
        with obs.capture() as trace:
            mri.sense_forward(T(u), T(smaps), mask)
    assert au.dtype == ahv.dtype == torch.complex128
    assert [e["variant"] for e in trace.select("plan.resolve")] == ["reference_x64"]
    lhs, rhs = np.vdot(au.numpy(), v), np.vdot(u, ahv.numpy())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    _close(au.numpy(), np_sense_forward(u, smaps, mask), 1e-12)


def test_apply_mask_bool_and_float(rng, smaps):
    k = _crand(rng, smaps.shape)
    m = mri.uniform_mask(smaps.shape[-2:], 2)
    masked = mri.apply_mask(T(k), m)
    assert torch.equal(mri.apply_mask(T(k), m.astype(bool)), masked)
    assert masked.dtype == torch.complex64
    assert bool((masked[:, T(m) == 0] == 0).all())


def test_shape_validation():
    z = torch.zeros
    with pytest.raises(ValueError, match="image"):
        mri.sense_forward(z(8), z(4, 8, 8))
    with pytest.raises(ValueError, match="smaps"):
        mri.sense_forward(z(8, 8), z(8, 8))
    with pytest.raises(ValueError, match="does not match"):
        mri.sense_forward(z(8, 8), z(4, 8, 16))
    with pytest.raises(ValueError, match="kspace"):
        mri.sense_adjoint(z(8, 8), z(4, 8, 8))
    with pytest.raises(ValueError, match="does not match"):
        mri.sense_adjoint(z(4, 8, 8), z(2, 8, 8))


def test_numpy_input_goes_to_the_card(phantom, smaps):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mri.sense_forward(phantom, smaps)
    k = mri.sense_forward(T(phantom), smaps)              # numpy joins the tensor's device
    assert k.device == torch.device("cpu")


# --------------------------- sensitivity estimate ---------------------------


def test_estimated_maps_close_to_truth_and_to_numpy(phantom, smaps):
    k = np_sense_forward(phantom, smaps).astype(np.complex64)
    est = mri.estimate_sensitivities(T(k), calib=24)
    assert est.shape == smaps.shape
    support = phantom > 0.1
    err = np.abs(est.numpy() - smaps)[:, support]
    assert err.mean() < 0.06, err.mean()
    np.testing.assert_allclose(mri.rss_combine(est).numpy()[support], 1.0, atol=0.05)
    window = np.zeros(N)
    window[(N - 24) // 2:(N + 24) // 2] = np.hanning(26)[1:-1].astype(np.float32)
    low = np_inv(k.astype(np.complex128) * np.outer(window, window))
    want = low / (np.sqrt(np.sum(np.abs(low) ** 2, axis=0)) + 1e-6)
    # a ratio of low-resolution images: on the object, where the maps are
    # used, float32 rounding; off it the ratio of two near-zero images is not
    # held (the reference's own test holds only the support too)
    _close(est.numpy()[:, support], want[:, support], 1e-4)


def test_estimate_rejects_unsampled_calibration(phantom, smaps):
    k = T(np_sense_forward(phantom, smaps).astype(np.complex64))
    with pytest.raises(ValueError, match="calibration block"):
        mri.estimate_sensitivities(k, calib=16, mask=mri.uniform_mask((N, N), 4, calib=0))
    mri.estimate_sensitivities(k, calib=16, mask=mri.uniform_mask((N, N), 4, calib=16))


# ------------------------------ reconstruction ------------------------------


def _undersampled(phantom, smaps, mask):
    k = mri.sense_forward(T(phantom), T(smaps), mask)
    return k, mri.nrmse(mri.recon_zero_filled(k, T(smaps), mask), T(phantom))


@pytest.mark.parametrize("mask_fn,margin", [(lambda: mri.uniform_mask((N, N), 2), 0.25),
                                            (lambda: mri.uniform_mask((N, N), 4), 0.5),
                                            (lambda: mri.variable_density_mask((N, N), 4,
                                                                               seed=0), 0.6)],
                         ids=["uniform-R2", "uniform-R4", "variable-density-R4"])
def test_cg_beats_zero_filled(phantom, smaps, mask_fn, margin):
    mask = mask_fn()
    k, zf = _undersampled(phantom, smaps, mask)
    cg = mri.nrmse(mri.recon_cg_sense(k, T(smaps), mask, iters=10), T(phantom))
    assert cg < margin * zf, (cg, zf)


def test_cg_sense_matches_numpy_float64_cg(phantom, smaps):
    """The same ten iterations in numpy float64 on the same data: the image
    and the residual trace the port emits."""
    mask = mri.uniform_mask((N, N), 4)
    k, _ = _undersampled(phantom, smaps, mask)
    with obs.capture() as trace:
        got = mri.recon_cg_sense(k, T(smaps), mask, iters=10)
    kn = k.numpy().astype(np.complex128)
    want, residuals = np_cg(
        lambda x: np_sense_adjoint(np_sense_forward(x, smaps, mask), smaps, mask),
        np_sense_adjoint(kn, smaps, mask), 10)
    _close(got.numpy(), want, 1e-3)
    events = trace.select("mri.cg.iter")
    np.testing.assert_allclose([e["residual"] for e in events], residuals, rtol=0.05)
    assert [e["iter"] for e in events] == list(range(10))
    assert all((e["model"], e["shape"], e["coils"]) == ("sense", (N, N), COILS)
               for e in events)


def test_convergence_trace_from_event_stream(phantom, smaps):
    mask = mri.uniform_mask((N, N), 4)
    k, _ = _undersampled(phantom, smaps, mask)
    obs.reset_counters()
    with obs.capture() as trace:
        mri.recon_cg_sense(k, T(smaps), mask, iters=10)
    res = [e["residual"] for e in trace.select("mri.cg.iter")]
    assert len(res) == 10 and obs.counters()["mri.cg.iter"] == 10
    assert all(res[i + 1] <= 1.2 * res[i] for i in range(len(res) - 1)), res
    assert res[-1] < 0.1 * res[0], res
    # 1 + 2 * iters planned centered transforms, one problem key each way
    plans = trace.select("plan.resolve")
    assert len(plans) == 1 + 2 * 10 and {e["kind"] for e in plans} == {"fft2d"}
    assert len({e["key"] for e in plans}) == 2


def test_tol_stops_early(phantom, smaps):
    mask = mri.uniform_mask((N, N), 2)
    k, _ = _undersampled(phantom, smaps, mask)
    with obs.capture() as trace:
        mri.recon_cg_sense(k, T(smaps), mask, iters=20, tol=1e-2)
    assert len(trace.select("mri.cg.iter")) < 20


def test_batched_cg_matches_per_item(phantom, smaps):
    m1 = mri.uniform_mask((N, N), 2)
    m2 = mri.variable_density_mask((N, N), 4, seed=5)
    k1 = mri.sense_forward(T(phantom), T(smaps), m1)
    k2 = mri.sense_forward(T(phantom[::-1].copy()), T(smaps), m2)
    masks = np.stack([m1, m2])[:, None]
    batched = mri.recon_cg_sense(torch.stack([k1, k2]), T(smaps), mask=masks, iters=6)
    np.testing.assert_allclose(batched[0].numpy(),
                               mri.recon_cg_sense(k1, T(smaps), m1, iters=6).numpy(), atol=2e-4)
    np.testing.assert_allclose(batched[1].numpy(),
                               mri.recon_cg_sense(k2, T(smaps), m2, iters=6).numpy(), atol=2e-4)


def test_estimated_maps_close_the_loop(phantom, smaps):
    mask = mri.variable_density_mask((N, N), 2, seed=1)
    k = mri.sense_forward(T(phantom), T(smaps), mask)
    est = mri.estimate_sensitivities(k, calib=16, mask=mask)
    zf = mri.nrmse(mri.recon_zero_filled(k, est, mask), T(phantom))
    cg = mri.nrmse(mri.recon_cg_sense(k, est, mask, iters=10, lam=1e-3), T(phantom))
    assert cg < 0.75 * zf, (cg, zf)


def test_cg_under_double_matches_numpy_float64(phantom, smaps):
    mask = mri.uniform_mask((32, 32), 2)
    ph, sm = mri.shepp_logan(32).astype(np.float64), mri.birdcage_maps(4, 32).astype(np.complex128)
    k = np_sense_forward(ph, sm, mask)
    with xfft.config(precision="double"):
        got = mri.recon_cg_sense(T(k), T(sm), mask, iters=5)
    assert got.dtype == torch.complex128
    want, _ = np_cg(lambda x: np_sense_adjoint(np_sense_forward(x, sm, mask), sm, mask),
                    np_sense_adjoint(k, sm, mask), 5)
    _close(got.numpy(), want, 1e-10)


def test_validation_and_nrmse():
    z = torch.zeros(4, 8, 8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="lam"):
        mri.recon_cg_sense(z, z, lam=-1.0)
    with pytest.raises(ValueError, match="iters"):
        mri.recon_cg_sense(z, z, iters=0)
    ref = torch.ones(8, 8)
    assert mri.nrmse(ref, ref) == 0.0
    assert mri.nrmse(1.5 * ref, ref) == pytest.approx(0.5, abs=1e-6)


# ------------------------------ motion correction ------------------------------


def _corrupted(phantom, smaps, n_shots=2, accel=2):
    mask = mri.uniform_mask(phantom.shape, accel)
    masks = mri.shot_masks(mask, n_shots)
    k = mri.moco_forward(T(phantom), T(smaps), masks, SHIFTS[:n_shots])
    return mask, masks, k


def test_shot_masks_partition():
    mask = mri.uniform_mask((N, N), 2)
    shots = mri.shot_masks(mask, 3)
    assert shots.shape == (3, N, N) and shots.dtype == np.float32
    np.testing.assert_array_equal(shots.sum(axis=0), mask)
    assert (shots.astype(bool).sum(axis=0) <= 1).all()
    with pytest.raises(ValueError, match="n_shots"):
        mri.shot_masks(mask, 0)
    with pytest.raises(ValueError, match="too few"):
        mri.shot_masks(mask, 64)


def test_moco_operators_match_numpy_float64(rng, phantom, smaps):
    mask, masks, k = _corrupted(phantom, smaps)
    moved = np_shift(phantom.astype(np.complex128), SHIFTS.astype(np.float64))
    want = np.sum(np_sense_forward(moved, smaps) * masks[:, None], axis=0)
    _close(k.numpy(), want)
    v = _crand(rng, smaps.shape)
    per_shot = np_sense_adjoint(v[None] * masks[:, None], smaps)
    back = np.sum(np_shift_each(per_shot, -SHIFTS.astype(np.float64)), axis=0)
    _close(mri.moco_adjoint(T(v), T(smaps), masks, SHIFTS).numpy(), back)


def np_shift_each(frames, shifts):
    h, w = frames.shape[-2:]
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    ramp = np.exp(-2j * np.pi * (fy * shifts[:, 0, None, None] + fx * shifts[:, 1, None, None]))
    return np.fft.ifft2(np.fft.fft2(frames) * ramp)


def test_moco_adjointness(rng, phantom, smaps):
    _, masks, _ = _corrupted(phantom, smaps)
    u, v = _crand(rng, (N, N)), _crand(rng, smaps.shape)
    au = mri.moco_forward(T(u), T(smaps), masks, SHIFTS).numpy()
    ahv = mri.moco_adjoint(T(v), T(smaps), masks, SHIFTS).numpy()
    lhs, rhs = np.vdot(au, v), np.vdot(u, ahv)
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_zero_motion_reduces_to_sense(phantom, smaps):
    mask, masks, _ = _corrupted(phantom, smaps)
    k_moco = mri.moco_forward(T(phantom), T(smaps), masks, np.zeros((2, 2), np.float32))
    k_sense = mri.sense_forward(T(phantom), T(smaps), mask)
    np.testing.assert_allclose(k_moco.numpy(), k_sense.numpy(), atol=1e-5)


def test_moco_recon_beats_motion_blind(phantom, smaps):
    mask, masks, k = _corrupted(phantom, smaps)
    blind = mri.nrmse(mri.recon_cg_sense(k, T(smaps), mask, iters=8), T(phantom))
    with obs.capture() as trace:
        moco = mri.nrmse(mri.recon_cg_moco(k, T(smaps), masks, SHIFTS, iters=8), T(phantom))
    assert moco < 0.5 * blind, (moco, blind)
    assert {e["model"] for e in trace.select("mri.cg.iter")} == {"moco"}
    assert trace.first("mri.cg.iter")["shots"] == 2


def test_estimated_shifts_close_the_loop(phantom, smaps):
    _, masks, k = _corrupted(phantom, smaps)
    est = mri.estimate_shot_shifts(k, T(smaps), masks)
    assert est.dtype == torch.float32
    np.testing.assert_allclose(est[0].numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(est.numpy(), SHIFTS, atol=0.5)
    with_truth = mri.nrmse(mri.recon_cg_moco(k, T(smaps), masks, SHIFTS, iters=8), T(phantom))
    with_est = mri.nrmse(mri.recon_cg_moco(k, T(smaps), masks, est, iters=8), T(phantom))
    assert with_est < 1.25 * with_truth + 1e-3, (with_est, with_truth)


def test_moco_shape_validation(phantom, smaps):
    _, masks, k = _corrupted(phantom, smaps)
    with pytest.raises(ValueError, match="shifts"):
        mri.moco_forward(T(phantom), T(smaps), masks, np.zeros((3, 2)))
    with pytest.raises(ValueError, match="shot masks"):
        mri.moco_adjoint(k, T(smaps), masks[0], SHIFTS)
    with pytest.raises(ValueError, match="ref_shot"):
        mri.estimate_shot_shifts(k, T(smaps), masks, ref_shot=5)


def test_public_names_are_the_references():
    text = (ROOT / "src" / "repro" / "mri" / "__init__.py").read_text()
    names = text[text.index("__all__ = ["):].split("]")[0]
    assert sorted(mri.__all__) == sorted(n.strip().strip('",') for n in names.split("\n")[1:]
                                         if n.strip())
