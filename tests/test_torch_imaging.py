"""repro_torch.imaging on CPU tensors, held to numpy in float64.

``repro.imaging`` does not import on this jax (its modules import
``repro.xfft``, which needs ``jax.experimental.enable_x64``), so the port
is held to numpy float64 oracles on the fixtures and assertions of
``tests/imaging/``: one parametrised case per reference test where that
is possible, with the reference's tolerances. The fixtures are re-written
here, since ``tests/imaging/_helpers.py`` imports the reference. Beside
those: the log-polar sampler against ``jax.scipy.ndimage.map_coordinates``
(the reference's sampler), ``band_limited_frame`` bit for bit against its
definition, the planner's ``oaconv2d`` tile rule, and the transforms of
every operator resolved through the port's ``resolve_call``.
"""

import math
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.imaging.tiled as tiled
import repro_torch.xfft._transforms as _transforms
from repro_torch import xfft
from repro_torch.imaging import (
    apply_shift,
    band_limited_frame,
    fft2_psd,
    fftconv2,
    image_to_kspace,
    kspace_to_image,
    matched_filter2,
    oaconvolve2,
    psd_decompose,
    register_phase_correlation,
)
from repro_torch.imaging.registration import (
    _bilinear,
    _logpolar_resample,
    hermitian_full,
    register_logpolar,
)
from repro_torch.kernels.ops import fft2_fits_budget
from repro_torch.plan import resolve_call
from repro_torch.plan.autotune import estimate_plan, oaconv_tile_candidates
from repro_torch.plan.cache import PlanCache
from repro_torch.plan.plan import ProblemKey, problem_key

T = torch.from_numpy
CPU = torch.device("cpu")


# ------------------------------ fixtures ------------------------------


@pytest.fixture
def natural_image():
    """A frame with the statistics that produce the cross artifact: a
    strong non-periodic ramp (opposite borders mismatch) plus texture."""
    rng = np.random.default_rng(7)
    i, j = np.mgrid[0:64, 0:128]
    return (0.05 * i + 0.03 * j + 0.2 * rng.standard_normal((64, 128))).astype(np.float32)


def smooth_image(n, seed, bandwidth=0.05):
    return band_limited_frame(n, seed=seed, bandwidth=bandwidth)


def complex_frame(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def conv2_full_oracle(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Full linear 2D convolution via numpy's (size-exact) FFT, float64."""
    fh = image.shape[-2] + kernel.shape[-2] - 1
    fw = image.shape[-1] + kernel.shape[-1] - 1
    if np.iscomplexobj(image) or np.iscomplexobj(kernel):
        return np.fft.ifft2(np.fft.fft2(image, s=(fh, fw)) * np.fft.fft2(kernel, s=(fh, fw)))
    return np.fft.irfft2(
        np.fft.rfft2(image, s=(fh, fw)) * np.fft.rfft2(kernel, s=(fh, fw)), s=(fh, fw)
    )


def crop_oracle(full: np.ndarray, h: int, w: int, kh: int, kw: int, mode: str):
    """Crop a full conv oracle to scipy's mode conventions."""
    if mode == "full":
        return full
    if mode == "same":
        top, left = (kh - 1) // 2, (kw - 1) // 2
        return full[..., top:top + h, left:left + w]
    return full[..., kh - 1:h, kw - 1:w]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------ synthetic ------------------------------


def _band_limited_definition(n, seed, bandwidth):
    """The reference's generator in numpy, its frequency grid the float32
    division k / n that ``repro.xfft.fftfreq(n, dtype=float32)`` computes."""
    rng = np.random.default_rng(seed)
    spectrum = np.fft.fft2(rng.standard_normal((n, n)))
    k = np.concatenate([np.arange(0, (n - 1) // 2 + 1), np.arange(-(n // 2), 0)])
    freqs = (k.astype(np.float32) / np.float32(n)).astype(np.float64)
    spectrum *= np.exp(-(freqs[:, None] ** 2 + freqs[None, :] ** 2) / (2 * bandwidth**2))
    frame = np.real(np.fft.ifft2(spectrum))
    return (frame / np.abs(frame).max()).astype(np.float32)


@pytest.mark.parametrize("n,seed,bandwidth", [(32, 7, 0.05), (64, 3, 0.05), (128, 3, 0.1),
                                              (48, 1, 0.15), (100, 2, 0.05)])
def test_band_limited_frame_is_its_definition_bit_for_bit(n, seed, bandwidth):
    got = band_limited_frame(n, seed=seed, bandwidth=bandwidth)
    assert got.dtype == np.float32 and got.shape == (n, n)
    np.testing.assert_array_equal(got, _band_limited_definition(n, seed, bandwidth))


# ------------------------------ kspace ------------------------------


def test_round_trip_is_identity(rng):
    x = complex_frame(rng, (32, 64))
    np.testing.assert_allclose(_np(kspace_to_image(image_to_kspace(T(x)))), x, atol=1e-4)


def test_dc_lands_at_array_centre():
    k = _np(image_to_kspace(torch.ones(16, 16))).__abs__()
    assert np.unravel_index(k.argmax(), k.shape) == (8, 8)
    assert k.sum() == pytest.approx(k[8, 8])  # a constant is pure DC


def test_ortho_norm_preserves_energy(rng):
    x = complex_frame(rng, (32, 32))
    k = _np(image_to_kspace(T(x)))
    assert np.linalg.norm(k) == pytest.approx(np.linalg.norm(x), rel=1e-4)


@pytest.mark.parametrize("norm", ["ortho", None, "forward"])
def test_matches_numpy_centered_convention(rng, norm):
    """The moco-workshop spelling, verbatim in numpy float64, is the oracle."""
    x = complex_frame(rng, (16, 32))
    x64 = x.astype(np.complex128)
    want = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(x64), norm=norm))
    np.testing.assert_allclose(_np(image_to_kspace(T(x), norm=norm)), want,
                               atol=1e-5 * np.abs(want).max())
    want_inv = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(x64), norm=norm))
    np.testing.assert_allclose(_np(kspace_to_image(T(x), norm=norm)), want_inv,
                               atol=1e-5 * np.abs(want_inv).max())


def test_real_input_upcasts_to_complex64(rng):
    x = rng.standard_normal((16, 16)).astype(np.float32)
    k = image_to_kspace(T(x))
    assert k.dtype == torch.complex64
    want = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(x.astype(np.float64)), norm="ortho"))
    np.testing.assert_allclose(_np(k), want, atol=1e-5 * np.abs(want).max())


def test_batched_leading_axes(rng):
    frames = complex_frame(rng, (3, 2, 16, 16))  # e.g. (coil, frame, H, W)
    k = _np(image_to_kspace(T(frames)))
    assert k.shape == frames.shape
    np.testing.assert_allclose(k[1, 0], _np(image_to_kspace(T(frames[1, 0]))), atol=1e-5)


def test_alternate_axes(rng):
    x = complex_frame(rng, (16, 4, 32))
    k = _np(image_to_kspace(T(x), axes=(0, 2)))
    want = np.stack([_np(image_to_kspace(T(x[:, c, :].copy()))) for c in range(4)], axis=1)
    np.testing.assert_allclose(k, want, atol=1e-5)


# ------------------------------ psd ------------------------------


def cross_energy_ratio(spectrum: np.ndarray) -> float:
    """Energy on the spectrum's axis lines (the cross artifact's home)
    relative to total AC energy."""
    power = np.abs(spectrum) ** 2
    total = power.sum() - power[..., 0, 0]
    cross = power[..., 0, 1:].sum() + power[..., 1:, 0].sum()
    return float(cross / total)


def smooth_spectrum_oracle(x: np.ndarray) -> np.ndarray:
    """Moisan's smooth component's spectrum in numpy float64."""
    x = x.astype(np.complex128)
    h, w = x.shape[-2:]
    b1 = np.fft.fft(x[..., -1, :] - x[..., 0, :])
    b2 = np.fft.fft(x[..., :, -1] - x[..., :, 0])
    q, r = np.arange(h), np.arange(w)
    vhat = (b1[..., None, :] * (1 - np.exp(2j * np.pi * q / h))[:, None]
            + b2[..., :, None] * (1 - np.exp(2j * np.pi * r / w))[None, :])
    denom = 2 * np.cos(2 * np.pi * q / h)[:, None] + 2 * np.cos(2 * np.pi * r / w)[None, :] - 4
    denom[0, 0] = 1.0
    shat = vhat / denom
    shat[..., 0, 0] = 0.0
    return shat


def test_decomposition_is_exact(natural_image):
    periodic, smooth = psd_decompose(T(natural_image))
    np.testing.assert_allclose(_np(periodic) + _np(smooth), natural_image, atol=1e-4)


def test_decomposition_matches_numpy_float64(natural_image):
    shat = smooth_spectrum_oracle(natural_image)
    smooth = np.fft.ifft2(shat).real
    _, got = psd_decompose(T(natural_image))
    np.testing.assert_allclose(_np(got), smooth, atol=1e-4)  # the reference's psd limit
    want = np.fft.fft2(natural_image.astype(np.float64)) - shat
    np.testing.assert_allclose(_np(fft2_psd(T(natural_image))), want,
                               atol=1e-5 * np.abs(want).max())


def test_periodic_component_borders_match(natural_image):
    periodic = _np(psd_decompose(T(natural_image))[0])
    orig = np.abs(natural_image[0] - natural_image[-1]).mean()
    assert np.abs(periodic[0] - periodic[-1]).mean() < 0.1 * orig
    orig = np.abs(natural_image[:, 0] - natural_image[:, -1]).mean()
    assert np.abs(periodic[:, 0] - periodic[:, -1]).mean() < 0.1 * orig


def test_in_spectrum_solve_matches_explicit_decomposition(natural_image):
    """fft2_psd equals fft2 of the explicitly decomposed periodic component."""
    periodic, _ = psd_decompose(T(natural_image))
    want = np.fft.fft2(_np(periodic).astype(np.float64))
    np.testing.assert_allclose(_np(fft2_psd(T(natural_image))), want,
                               atol=2e-3 * np.abs(want).max())


def test_no_cross_artifact_on_natural_image(natural_image):
    plain = cross_energy_ratio(np.fft.fft2(natural_image))
    psd = cross_energy_ratio(_np(fft2_psd(T(natural_image))))
    assert psd < 0.05 * plain, (psd, plain)


def test_matching_borders_give_zero_smooth_part():
    i, j = np.mgrid[0:32, 0:32]
    tile = (np.sin(2 * np.pi * 3 * i / 31) * np.cos(2 * np.pi * 5 * j / 31)).astype(np.float32)
    np.testing.assert_allclose(tile[0], tile[-1], atol=1e-6)
    _, smooth = psd_decompose(T(tile))
    assert np.abs(_np(smooth)).max() < 1e-4


def test_batched_and_moved_axes(natural_image):
    batch = np.stack([natural_image, natural_image[::-1]])
    periodic, _ = psd_decompose(T(batch))
    assert tuple(periodic.shape) == batch.shape
    p0 = _np(psd_decompose(T(batch[1].copy()))[0])
    np.testing.assert_allclose(_np(periodic)[1], p0, atol=1e-4)
    moved = np.moveaxis(batch, 0, -1).copy()  # channels last via axes=
    pm, _ = psd_decompose(T(moved), axes=(0, 1))
    np.testing.assert_allclose(np.moveaxis(_np(pm), -1, 0), _np(periodic), atol=1e-4)


def test_out_of_bounds_axes_rejected(natural_image):
    with pytest.raises(ValueError, match="out of bounds"):
        psd_decompose(T(natural_image), axes=(0, 5))
    with pytest.raises(ValueError, match="twice"):
        fft2_psd(T(natural_image), axes=(0, 0))


def test_fft2_psd_norm_conventions(natural_image):
    base = _np(fft2_psd(T(natural_image)))
    n = natural_image.size
    np.testing.assert_allclose(_np(fft2_psd(T(natural_image), norm="ortho")),
                               base / np.sqrt(n), atol=1e-3)
    np.testing.assert_allclose(_np(fft2_psd(T(natural_image), norm="forward")), base / n,
                               atol=1e-4)
    with pytest.raises(ValueError, match="norm"):
        fft2_psd(T(natural_image), norm="unitary")


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_real_path_matches_complex_path(natural_image, norm):
    got = _np(fft2_psd(T(natural_image), norm=norm))
    want = _np(fft2_psd(T(natural_image.astype(np.complex64)), norm=norm))
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_real_decompose_matches_complex_and_stays_real(natural_image):
    p_r, s_r = (_np(a) for a in psd_decompose(T(natural_image)))
    assert p_r.dtype == np.float32 and s_r.dtype == np.float32
    p_c, s_c = (_np(a) for a in psd_decompose(T(natural_image.astype(np.complex64))))
    np.testing.assert_allclose(p_r, p_c.real, atol=1e-4)
    np.testing.assert_allclose(s_r, s_c.real, atol=1e-4)


def test_complex_input_supported(rng):
    z = complex_frame(rng, (32, 32))
    periodic, smooth = psd_decompose(T(z))
    np.testing.assert_allclose(_np(periodic) + _np(smooth), z, atol=1e-4)


# ------------------------------ registration ------------------------------


def rotate_scale(img: np.ndarray, angle: float, scale: float) -> np.ndarray:
    """Warp ``img`` so it looks like ``img`` rotated by ``angle``
    (counter-clockwise, y-up) and magnified by ``scale`` about the centre,
    with the reference's sampler."""
    from jax.scipy.ndimage import map_coordinates

    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dy, dx = yy - h / 2, xx - w / 2
    ca, sa = math.cos(angle), math.sin(angle)
    src_c = (ca * dx - sa * dy) / scale + w / 2        # inverse mapping
    src_r = (sa * dx + ca * dy) / scale + h / 2
    return np.array(map_coordinates(img, [src_r, src_c], order=1, mode="constant"))


@pytest.mark.parametrize("shift", [(0, 0), (5, 9), (-7, 3), (31, -17), (1, -1)])
def test_whole_pixel_shifts_recovered(shift):
    ref = smooth_image(64, seed=3)
    mov = apply_shift(T(ref), torch.tensor(shift, dtype=torch.float32))
    np.testing.assert_allclose(_np(mov), np.roll(ref, shift, axis=(0, 1)), atol=1e-4)
    got = _np(register_phase_correlation(T(ref), mov))
    np.testing.assert_array_equal(got, [-shift[0], -shift[1]])


def test_registration_round_trip_realigns():
    ref = smooth_image(64, seed=4)
    mov = apply_shift(T(ref), (11.0, -6.0))
    back = _np(apply_shift(mov, register_phase_correlation(T(ref), mov)))
    np.testing.assert_allclose(back, ref, atol=1e-4)


def _fourier_shift_oracle(x: np.ndarray, shift) -> np.ndarray:
    h, w = x.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    ramp = np.exp(-2j * np.pi * (fy * shift[0] + fx * shift[1]))
    return np.real(np.fft.ifft2(np.fft.fft2(x.astype(np.float64)) * ramp))


@pytest.mark.parametrize("shift", [(2.5, -1.25), (-3.75, 4.5), (0.25, 0.75), (7.5, -0.5)])
def test_subpixel_shifts_recovered(shift):
    """Quarter-pixel displacements on a band-limited frame; the shifted
    frame itself is held to the numpy float64 Fourier shift."""
    ref = smooth_image(64, seed=5)
    mov = apply_shift(T(ref), torch.tensor(shift, dtype=torch.float32))
    np.testing.assert_allclose(_np(mov), _fourier_shift_oracle(ref, shift), atol=1e-5)
    got = _np(register_phase_correlation(T(ref), mov, upsample_factor=8))
    np.testing.assert_allclose(got, [-shift[0], -shift[1]], atol=1 / 8 + 1e-6)


def test_subpixel_precision_scales_with_upsampling():
    ref = smooth_image(64, seed=6)
    mov = apply_shift(T(ref), (1.3, -2.6))
    got = _np(register_phase_correlation(T(ref), mov, upsample_factor=20))
    np.testing.assert_allclose(got, [-1.3, 2.6], atol=0.06)


def test_batched_registration_one_call():
    ref = smooth_image(32, seed=7)
    shifts = [(1.0, 2.0), (3.0, -4.0), (-5.0, 0.0)]
    movs = torch.stack([apply_shift(T(ref), s) for s in shifts])
    refs = T(ref).expand(movs.shape)
    got = _np(register_phase_correlation(refs, movs))
    np.testing.assert_array_equal(got, [[-a, -b] for a, b in shifts])


def test_complex_frames_register():
    ref = T((smooth_image(32, seed=9) + 1j * smooth_image(32, seed=10)).astype(np.complex64))
    mov = apply_shift(ref, (4.0, -3.0))
    np.testing.assert_array_equal(_np(register_phase_correlation(ref, mov)), [-4.0, 3.0])
    np.testing.assert_array_equal(
        _np(register_phase_correlation(ref, mov, upsample_factor=10)), [-4.0, 3.0])


def test_apply_shift_integer_matches_roll():
    x = np.random.default_rng(11).standard_normal((16, 32)).astype(np.float32)
    got = _np(apply_shift(T(x), (3.0, -5.0)))
    np.testing.assert_allclose(got, np.roll(x, (3, -5), axis=(0, 1)), atol=1e-4)


def test_apply_shift_batched_per_frame_shifts():
    x = np.random.default_rng(12).standard_normal((2, 16, 16)).astype(np.float32)
    shifts = np.asarray([[1.0, 2.0], [-3.0, 4.0]], np.float32)
    got = _np(apply_shift(T(x), T(shifts)))
    for k in range(2):
        want = np.roll(x[k], tuple(shifts[k].astype(int)), axis=(0, 1))
        np.testing.assert_allclose(got[k], want, atol=1e-4)


def test_shape_mismatch_rejected():
    with pytest.raises(ValueError, match="share a shape"):
        register_phase_correlation(torch.zeros(8, 8), torch.zeros(8, 16))
    with pytest.raises(ValueError, match="dy, dx"):
        apply_shift(torch.zeros(8, 8), (1.0, 2.0, 3.0))


@pytest.mark.parametrize("h,w", [(8, 8), (16, 32), (32, 16)])
def test_hermitian_full_rebuilds_the_full_spectrum(rng, h, w):
    x = rng.standard_normal((3, h, w))
    got = _np(hermitian_full(T(np.fft.rfft2(x)), w))
    np.testing.assert_allclose(got, np.fft.fft2(x), atol=1e-9 * np.abs(np.fft.fft2(x)).max())


def test_bilinear_sampler_is_jax_map_coordinates():
    """The port's sampler against the reference's, on points inside the
    frame, on its edges, and with one to four neighbours outside it (where
    each outside neighbour contributes zero)."""
    from jax.scipy.ndimage import map_coordinates

    rng = np.random.default_rng(13)
    img = rng.standard_normal((12, 20)).astype(np.float32)
    rows = rng.uniform(-1.5, 13.5, (40, 30)).astype(np.float32)
    cols = rng.uniform(-1.5, 21.5, (40, 30)).astype(np.float32)
    rows[0, :6] = [-1.0, -0.5, 0.0, 11.0, 11.5, 12.0]
    cols[0, :6] = [-0.25, 19.0, 19.75, 0.0, 20.0, -1.0]
    want = np.asarray(map_coordinates(img, [rows, cols], order=1, mode="constant"))
    got = _np(_bilinear(T(img), T(rows), T(cols)))
    outside = (rows < 0) | (rows > 11) | (cols < 0) | (cols > 19)
    assert outside.sum() > 100 and (~outside).sum() > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_logpolar_resample_matches_the_reference_sampler():
    from jax.scipy.ndimage import map_coordinates

    mag = np.abs(np.random.default_rng(14).standard_normal((32, 64))).astype(np.float32)
    h, w = mag.shape
    rmax = min(h, w) / 2.0 - 1.0
    theta = np.arange(h, dtype=np.float32) * np.float32(math.pi / h)
    logr = np.exp(np.arange(w, dtype=np.float32) * np.float32(math.log(rmax) / (w - 1)))
    rows = np.float32(h / 2.0) + logr[None, :] * np.sin(theta)[:, None]
    cols = np.float32(w / 2.0) + logr[None, :] * np.cos(theta)[:, None]
    want = np.asarray(map_coordinates(mag, [rows, cols], order=1, mode="constant"))
    np.testing.assert_allclose(_np(_logpolar_resample(T(mag))), want, rtol=0,
                               atol=1e-5 * want.max())


@pytest.mark.parametrize("angle,scale", [(0.2, 1.0), (-0.2, 1.0), (0.0, 1.1), (0.0, 0.9),
                                         (0.3, 1.15)])
def test_logpolar_recovers_rotation_and_scale(angle, scale):
    ref = smooth_image(128, seed=3, bandwidth=0.1)
    mov = rotate_scale(ref, angle, scale)
    got_angle, got_scale = register_logpolar(T(ref), T(mov))
    assert got_angle == pytest.approx(angle, abs=0.02)
    assert got_scale == pytest.approx(scale, rel=0.02)


def test_logpolar_ignores_translation():
    ref = smooth_image(128, seed=4, bandwidth=0.1)
    mov = apply_shift(T(rotate_scale(ref, 0.25, 1.0)), (9.0, -5.0))
    got_angle, got_scale = register_logpolar(T(ref), mov)
    assert got_angle == pytest.approx(0.25, abs=0.03)
    assert got_scale == pytest.approx(1.0, rel=0.02)


def test_logpolar_identity_is_zero_motion():
    ref = smooth_image(64, seed=5, bandwidth=0.15)
    angle, scale = register_logpolar(T(ref), T(ref.copy()))
    assert angle == pytest.approx(0.0, abs=1e-3)
    assert scale == pytest.approx(1.0, rel=1e-3)


def test_logpolar_input_contract():
    with pytest.raises(ValueError, match="single"):
        register_logpolar(torch.zeros(2, 8, 8), torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="share a shape"):
        register_logpolar(torch.zeros(8, 8), torch.zeros(16, 16))


# ------------------------------ tiled ------------------------------


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_oaconvolve2_matches_oracle_all_modes(rng, mode):
    image = rng.standard_normal((48, 80)).astype(np.float32)
    kernel = rng.standard_normal((7, 5)).astype(np.float32)
    oracle = crop_oracle(conv2_full_oracle(image.astype(np.float64), kernel), 48, 80, 7, 5,
                         mode)
    np.testing.assert_allclose(_np(oaconvolve2(T(image), T(kernel), mode=mode, tile=(16, 16))),
                               oracle, atol=1e-3)
    np.testing.assert_allclose(_np(fftconv2(T(image), T(kernel), mode=mode)), oracle, atol=1e-3)


def test_oaconvolve2_matches_fftconv2_plan_picked_tile(rng):
    image = rng.standard_normal((64, 64)).astype(np.float32)
    kernel = rng.standard_normal((9, 9)).astype(np.float32)
    np.testing.assert_allclose(_np(oaconvolve2(T(image), T(kernel))),
                               _np(fftconv2(T(image), T(kernel), mode="same")), atol=1e-3)


def test_even_kernel_same_mode_offsets(rng):
    image = rng.standard_normal((32, 32)).astype(np.float32)
    kernel = rng.standard_normal((4, 6)).astype(np.float32)
    oracle = crop_oracle(conv2_full_oracle(image, kernel), 32, 32, 4, 6, "same")
    np.testing.assert_allclose(_np(oaconvolve2(T(image), T(kernel), tile=(16, 16))), oracle,
                               atol=1e-3)


def test_complex_operands(rng):
    image = complex_frame(rng, (32, 48))
    kernel = complex_frame(rng, (5, 4))
    got = _np(oaconvolve2(T(image), T(kernel), mode="full", tile=(16, 16)))
    np.testing.assert_allclose(got, conv2_full_oracle(image, kernel), atol=1e-3)


def test_batched_images_and_per_item_kernels(rng):
    images = rng.standard_normal((3, 24, 24)).astype(np.float32)
    kernels = rng.standard_normal((3, 5, 5)).astype(np.float32)
    got = _np(oaconvolve2(T(images), T(kernels), mode="same", tile=(16, 16)))
    for b in range(3):
        oracle = crop_oracle(conv2_full_oracle(images[b], kernels[b]), 24, 24, 5, 5, "same")
        np.testing.assert_allclose(got[b], oracle, atol=1e-3)


def test_oversized_input_matches_fftconv_acceptance(rng):
    """An input far over the largest whole-frame transform the census
    admits (real 128x256) still matches the one-shot spectral convolution
    to fp32 tolerance."""
    h = w = 1024
    assert fft2_fits_budget(128, 256, real=True)
    assert not fft2_fits_budget(256, 256, real=True)
    image = rng.standard_normal((h, w)).astype(np.float32)
    kernel = rng.standard_normal((17, 17)).astype(np.float32)
    got = _np(oaconvolve2(T(image), T(kernel), mode="same"))
    oracle = crop_oracle(conv2_full_oracle(image, kernel), h, w, 17, 17, "same")
    np.testing.assert_allclose(got, oracle, atol=2e-3 * np.abs(oracle).max())


def test_matched_filter_locates_template(rng):
    scene = 0.1 * rng.standard_normal((96, 96)).astype(np.float32)
    template = np.zeros((8, 8), np.float32)
    template[3:5, :] = 1.0
    template[:, 3:5] = 1.0
    scene[40:48, 60:68] += template
    corr = _np(matched_filter2(T(scene), T(template), tile=(32, 32)))
    peak = np.unravel_index(corr.argmax(), corr.shape)
    assert abs(peak[0] - 43.5) <= 1 and abs(peak[1] - 63.5) <= 1


def test_matched_filter_complex_template_is_conjugated(rng):
    scene = complex_frame(rng, (40, 40))
    template = complex_frame(rng, (6, 5))
    got = _np(matched_filter2(T(scene), T(template), mode="full", tile=(16, 16)))
    want = conv2_full_oracle(scene, np.conj(template[::-1, ::-1]))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_single_tile_falls_back_to_one_transform(rng):
    image = rng.standard_normal((8, 8)).astype(np.float32)
    kernel = rng.standard_normal((3, 3)).astype(np.float32)
    got = _np(oaconvolve2(T(image), T(kernel), mode="full", tile=(64, 64)))
    np.testing.assert_allclose(got, conv2_full_oracle(image, kernel), atol=1e-4)


def test_bad_arguments_rejected(rng):
    image = T(rng.standard_normal((16, 16)).astype(np.float32))
    kernel = T(rng.standard_normal((5, 5)).astype(np.float32))
    with pytest.raises(ValueError, match="smaller than kernel"):
        oaconvolve2(image, kernel, tile=(4, 16))
    with pytest.raises(ValueError, match="mode"):
        oaconvolve2(image, kernel, mode="reflect", tile=(16, 16))
    with pytest.raises(ValueError, match="valid-mode"):
        fftconv2(kernel, image, mode="valid")  # kernel bigger than image
    with pytest.raises(ValueError, match="image and"):
        oaconvolve2(image, torch.tensor(1.0))


# ------------------------------ the oaconv2d kind ------------------------------


def _pow2_between(lo, hi):
    return [t for t in (1 << p for p in range(1, 16)) if lo <= t <= hi]


def _next_pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


@pytest.mark.parametrize("shape,dtype", [
    ((1024, 1024, 31, 31), "float32"), ((4096, 4096, 64, 64), "float32"),
    ((48, 80, 7, 5), "float32"), ((32, 48, 5, 4), "complex64"),
    ((512, 512, 31, 31), "complex64"), ((16, 16, 1, 1), "float32"),
])
def test_oaconv_tile_candidates_rule(shape, dtype):
    """Per axis: the powers of two from next_pow2(K) to next_pow2(D+K-1);
    jointly: those pairs that run as one whole-frame block."""
    h, w, kh, kw = shape
    real = dtype == "float32"
    key = problem_key("oaconv2d", shape, CPU, dtype=dtype)
    want = [(th, tw)
            for th in _pow2_between(_next_pow2(kh), _next_pow2(h + kh - 1))
            for tw in _pow2_between(_next_pow2(kw), _next_pow2(w + kw - 1))
            if fft2_fits_budget(th, tw, real=real)]
    got = oaconv_tile_candidates(key)
    assert got == want and got
    assert max(th * tw for th, tw in got) <= (128 * 256 if real else 128 * 128)


def test_oaconv_tile_candidates_fall_back_to_the_full_frame():
    """A kernel so large that even its own power-of-two cover is over the
    census: the single padded full-frame transform."""
    key = problem_key("oaconv2d", (300, 300, 200, 200), CPU, dtype="complex64")
    assert oaconv_tile_candidates(key) == [(512, 512)]
    with pytest.raises(ValueError, match="oaconv2d keys"):
        oaconv_tile_candidates(problem_key("oaconv2d", (300, 300), CPU))


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_oaconv2d_plan_carries_a_census_legal_tile(backend, dtype):
    shape = (1024, 1024, 31, 31)
    if backend == "cpu":
        plan = resolve_call("oaconv2d", shape, CPU, dtype=dtype, cache=PlanCache())
    else:  # the card's model, keyed as on an H100 without one
        plan = estimate_plan(ProblemKey(kind="oaconv2d", backend="cuda",
                                        device_kind="NVIDIA H100 80GB HBM3", shape=shape,
                                        dtype=dtype))
    assert plan.tile in oaconv_tile_candidates(plan.key)
    assert fft2_fits_budget(*plan.tile, real=dtype == "float32")
    assert plan.mode == "estimate" and plan.est_time_s > 0
    if backend == "cuda":
        assert plan.variant in ("fused", "fused_r4")


def test_oaconvolve2_is_the_same_for_every_legal_tile(rng):
    image = rng.standard_normal((40, 56)).astype(np.float32)
    kernel = rng.standard_normal((6, 9)).astype(np.float32)
    oracle = crop_oracle(conv2_full_oracle(image, kernel), 40, 56, 6, 9, "same")
    tiles = oaconv_tile_candidates(problem_key("oaconv2d", (40, 56, 6, 9), CPU,
                                               dtype="float32"))
    assert len(tiles) > 4
    for tile in tiles:
        got = _np(oaconvolve2(T(image), T(kernel), tile=tile))
        np.testing.assert_allclose(got, oracle, atol=1e-4 * np.abs(oracle).max(),
                                   err_msg=str(tile))


# ------------------------------ dispatch ------------------------------


@pytest.fixture
def plan_calls(monkeypatch):
    """Record every planner resolution made by the xfft front door and the
    tile picker; error on any DeprecationWarning."""
    calls = []

    def spy(kind, shape, *args, **kwargs):
        calls.append(kind)
        return resolve_call(kind, shape, *args, **kwargs)

    monkeypatch.setattr(_transforms, "resolve_call", spy)
    monkeypatch.setattr(tiled, "resolve_call", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        yield calls


@pytest.fixture
def frame(rng):
    return T(rng.standard_normal((32, 32)).astype(np.float32))


def test_psd_resolves_through_plan(plan_calls, frame):
    psd_decompose(frame)
    assert "rfft1d" in plan_calls and "rfft2d" in plan_calls
    assert "fft1d" not in plan_calls and "fft2d" not in plan_calls
    plan_calls.clear()
    fft2_psd(frame)
    assert plan_calls.count("rfft1d") == 2 and "rfft2d" in plan_calls
    assert "fft2d" not in plan_calls
    plan_calls.clear()
    fft2_psd(frame.to(torch.complex64))
    assert plan_calls.count("fft1d") == 2 and "fft2d" in plan_calls


def test_registration_resolves_through_plan(plan_calls, frame):
    register_phase_correlation(frame, frame.flip(0), upsample_factor=4)
    assert plan_calls.count("rfft2d") == 3  # two forward + one inverse
    plan_calls.clear()
    apply_shift(frame, (1.0, 2.0))
    assert plan_calls.count("rfft2d") == 2


def test_kspace_resolves_through_plan(plan_calls, frame):
    kspace_to_image(image_to_kspace(frame))
    assert plan_calls.count("fft2d") == 2


def test_convolution_resolves_through_plan(plan_calls, rng, frame):
    kernel = T(rng.standard_normal((5, 5)).astype(np.float32))
    oaconvolve2(frame, kernel)
    assert plan_calls[0] == "oaconv2d"       # the tile itself is planned
    assert "rfft2d" in plan_calls            # the tile stack's transforms follow
    plan_calls.clear()
    oaconvolve2(frame, kernel, tile=(16, 16))
    assert plan_calls == ["rfft2d", "rfft2d", "rfft2d"]  # one batched call a direction
    plan_calls.clear()
    fftconv2(frame, kernel)
    assert plan_calls.count("rfft2d") == 3
    plan_calls.clear()
    matched_filter2(frame, kernel, tile=(16, 16))
    assert "rfft2d" in plan_calls and "oaconv2d" not in plan_calls  # tile pinned


def test_forced_dispatch_reaches_imaging_ops(rng, monkeypatch):
    """A scoped variant override reroutes the transforms INSIDE the imaging
    ops: their FFTs go through resolve_call, not around it."""
    import importlib

    # repro_torch.core re-exports the function rfft over its module's name.
    core_rfft = importlib.import_module("repro_torch.core.rfft")

    kernel_calls = []
    real_kernel = core_rfft.rfft2_kernel

    def spy(x, **kw):
        kernel_calls.append(tuple(x.shape))
        return real_kernel(x, **kw)

    monkeypatch.setattr(core_rfft, "rfft2_kernel", spy)
    frame = T(rng.standard_normal((16, 16)).astype(np.float32))
    assert resolve_call("rfft2d", (16, 16), CPU, dtype="float32").variant not in (
        "fused", "fused_r4")
    apply_shift(frame, (1.0, 0.0))
    assert kernel_calls == []                # ESTIMATE on the CPU: the schedules
    with xfft.config(variant="fused_r4"):
        apply_shift(frame, (1.0, 0.0))
    assert len(kernel_calls) == 1            # forced, exactly once, in scope
    apply_shift(frame, (1.0, 0.0))
    assert len(kernel_calls) == 1            # nothing leaked past the scope


def test_numpy_input_goes_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    x = rng.standard_normal((16, 16)).astype(np.float32)
    calls = [lambda: image_to_kspace(x), lambda: psd_decompose(x), lambda: fft2_psd(x),
             lambda: register_phase_correlation(x, x), lambda: apply_shift(x, (1.0, 0.0)),
             lambda: oaconvolve2(x, x[:3, :3]), lambda: fftconv2(x, x[:3, :3]),
             lambda: matched_filter2(x, x[:3, :3])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------ properties ------------------------------


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=-31, max_value=31), st.integers(min_value=-31, max_value=31),
       st.integers(min_value=0, max_value=50))
def test_integer_shifts_recover_exactly(dy, dx, seed):
    ref = smooth_image(64, seed=seed)
    mov = apply_shift(T(ref), (float(dy), float(dx)))
    np.testing.assert_array_equal(_np(register_phase_correlation(T(ref), mov)), [-dy, -dx])


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=-15, max_value=15), st.integers(min_value=-15, max_value=15),
       st.integers(min_value=0, max_value=50))
def test_half_pixel_shifts_recover_with_upsampling(ty, tx, seed):
    dy, dx = ty / 2.0, tx / 2.0
    ref = smooth_image(64, seed=seed)
    mov = apply_shift(T(ref), (dy, dx))
    got = _np(register_phase_correlation(T(ref), mov, upsample_factor=4))
    np.testing.assert_allclose(got, [-dy, -dx], atol=0.25 + 1e-6)


geometry = st.tuples(
    st.integers(min_value=8, max_value=48),    # image H
    st.integers(min_value=8, max_value=48),    # image W
    st.integers(min_value=1, max_value=7),     # kernel KH
    st.integers(min_value=1, max_value=7),     # kernel KW
    st.integers(min_value=3, max_value=6),     # log2 tile H
    st.integers(min_value=3, max_value=6),     # log2 tile W
    st.sampled_from(["full", "same", "valid"]),
    st.integers(min_value=0, max_value=2**31 - 1),  # seed
)


@settings(max_examples=40, deadline=None)
@given(geometry)
def test_oaconvolve2_matches_oracle_on_random_geometry(params):
    h, w, kh, kw, lth, ltw, mode, seed = params
    th, tw = 1 << lth, 1 << ltw
    if th < kh or tw < kw:
        th, tw = max(th, 1 << (kh - 1).bit_length()), max(tw, 1 << (kw - 1).bit_length())
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((h, w)).astype(np.float32)
    kernel = rng.standard_normal((kh, kw)).astype(np.float32)
    oracle = crop_oracle(conv2_full_oracle(image, kernel), h, w, kh, kw, mode)
    got = _np(oaconvolve2(T(image), T(kernel), mode=mode, tile=(th, tw)))
    assert got.shape == oracle.shape
    np.testing.assert_allclose(got, oracle, atol=2e-4 * max(np.abs(oracle).max(), 1.0))


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=8, max_value=32), st.integers(min_value=1, max_value=5),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_planner_tile_agrees_with_pinned_tiles(n, k, seed):
    """Whatever tile the planner picks, the numbers match a pinned tile."""
    rng = np.random.default_rng(seed)
    image = T(rng.standard_normal((n, n)).astype(np.float32))
    kernel = T(rng.standard_normal((k, k)).astype(np.float32))
    auto = _np(oaconvolve2(image, kernel, mode="same"))
    pinned = _np(oaconvolve2(image, kernel, mode="same", tile=(8, 8)))
    np.testing.assert_allclose(auto, pinned, atol=2e-4 * max(np.abs(pinned).max(), 1.0))
