"""repro_torch.core.spectral against repro.core.spectral, on CPU tensors.

Each public function runs in both packages on the same inputs, made from
a seed with numpy, under the same explicit variant (``stockham``,
``radix4``, and ``rfft`` for the mixing layer); the port's ``"auto"``
(planned through ``repro_torch.xfft``) is held to the reference's
``stockham`` result. The cases mirror ``tests/core/test_spectral.py``.
Limits: max|port - ref| <= 1e-5 * max|ref| + 2e-5 for the linear outputs,
and 1e-4 in log10 units for ``log_mel``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spectral as ref_spectral
from repro_torch.core import spectral

TOL = 1e-5
ATOL = 2e-5
LOG_ATOL = 1e-4
VARIANTS = ["stockham", "radix4", "auto"]


def _close(got, want, tol=TOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)) + atol, err


def _ref_variant(variant):
    return "stockham" if variant == "auto" else variant


def _both(name, *arrays, variant, **kw):
    """The port's and the reference's ``name`` on the same inputs. The
    reference's ``fourier_mixing(variant="rfft")`` plans its transforms
    (``"auto"``), which reaches ``repro.xfft``; its explicit-variant
    equivalent is ``fourier_mixing_rfft(variant="stockham")``."""
    got = getattr(spectral, name)(*(torch.from_numpy(a) for a in arrays), variant=variant, **kw)
    if name == "fourier_mixing" and variant == "rfft":
        name, variant = "fourier_mixing_rfft", "stockham"
    fn = jax.jit(functools.partial(getattr(ref_spectral, name), variant=_ref_variant(variant),
                                   **kw))
    return got, np.asarray(fn(*(jnp.asarray(a) for a in arrays)))


def _direct_causal_conv(x, k):
    ref = np.zeros(x.shape, np.float64)
    for t in range(x.shape[1]):
        for s in range(min(t + 1, k.shape[0])):
            ref[:, t] += k[s] * x[:, t - s]
    return ref


@pytest.mark.parametrize("variant", VARIANTS + ["rfft"])
def test_fourier_mixing_matches_fnet_definition(rng, variant):
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    got, want = _both("fourier_mixing", x, variant=variant)
    _close(got, want)
    _close(got, np.fft.fft2(x.astype(np.float64)).real)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(1, 8, 16), (2, 32, 64), (3, 16, 128)])
def test_rfft_matches_numpy(rng, shape, variant):
    x = rng.standard_normal(shape).astype(np.float32)
    got, want = _both("rfft_last_axis", x, variant=variant)
    _close(got, want)
    _close(got, np.fft.rfft(x.astype(np.float64)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 64, 64)])
def test_rfft_mixing_matches_full(rng, shape, variant):
    """The real-input specialisation equals the full complex mixing."""
    x = rng.standard_normal(shape).astype(np.float32)
    got, want = _both("fourier_mixing_rfft", x, variant=variant)
    _close(got, want)
    full = spectral.fourier_mixing(torch.from_numpy(x), variant="stockham")
    _close(got, full)


@pytest.mark.parametrize("fn", ["fourier_mixing", "fourier_mixing_rfft"])
def test_mixing_differentiable(rng, fn):
    """The reference checks that jax.grad of sum(mixing(x)^2) is finite. Here
    the CPU plain path's autograd is held to finite differences with
    ``torch.autograd.gradcheck`` on float64 input. The port's engines still
    compute in complex64 (the double-precision engine is not ported), so
    gradcheck's default step of 1e-6 would measure float32 rounding; the
    mixing layer is linear in x, so a central difference is exact at any
    step, and a step of 0.1 keeps rounding under the tolerance. The
    gradient of the reference's loss is then held to its closed form
    2·M(M(x)), M = Re∘FFT2 being symmetric, in numpy float64."""
    f = getattr(spectral, fn)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16))).requires_grad_(True)
    assert torch.autograd.gradcheck(f, (x,), eps=0.1, atol=1e-4, rtol=1e-3)
    (grad,) = torch.autograd.grad((f(x) ** 2).sum(), x)
    assert bool(torch.isfinite(grad).all())
    xn = x.detach().numpy()
    _close(grad, 2 * np.fft.fft2(np.fft.fft2(xn).real).real, tol=1e-5, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fftconv_matches_direct(rng, variant):
    length, d = 64, 4
    x = rng.standard_normal((2, length, d)).astype(np.float32)
    k = rng.standard_normal((length, d)).astype(np.float32)
    got, want = _both("fftconv", x, k, variant=variant)
    _close(got, want)
    _close(got, _direct_causal_conv(x.astype(np.float64), k.astype(np.float64)), tol=1e-5,
           atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fftconv_short_kernel(rng, variant):
    x = rng.standard_normal((1, 32, 2)).astype(np.float32)
    k = rng.standard_normal((4, 2)).astype(np.float32)
    got, want = _both("fftconv", x, k, variant=variant)
    _close(got, want)
    _close(got, _direct_causal_conv(x.astype(np.float64), k.astype(np.float64)))


@pytest.mark.parametrize("variant", ["stockham", "radix4"])
def test_fftconv_complex_operands(rng, variant):
    x = (rng.standard_normal((2, 32, 3)) + 1j * rng.standard_normal((2, 32, 3))
         ).astype(np.complex64)
    k = rng.standard_normal((32, 3)).astype(np.float32)
    got, want = _both("fftconv", x, k, variant=variant)
    _close(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fftconv_is_causal(rng, variant):
    """Changing the future must not change the past."""
    x1 = rng.standard_normal((1, 32, 2)).astype(np.float32)
    x2 = x1.copy()
    x2[:, 20:] += 1.0
    k = torch.from_numpy(rng.standard_normal((32, 2)).astype(np.float32))
    y1 = spectral.fftconv(torch.from_numpy(x1), k, variant=variant)
    y2 = spectral.fftconv(torch.from_numpy(x2), k, variant=variant)
    _close(y1[:, :20], y2[:, :20].numpy(), tol=0.0, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("real", [True, False])
def test_correlate2_matches_reference(rng, variant, real):
    scene = rng.standard_normal((3, 16, 32)).astype(np.float32)
    template = rng.standard_normal((3, 16, 32)).astype(np.float32)
    if not real:
        scene = (scene + 1j * scene[::-1]).astype(np.complex64)
    got, want = _both("correlate2", scene, template, variant=variant)
    _close(got, want)
    s64, t64 = scene.astype(np.complex128), template.astype(np.float64)
    _close(got, np.fft.ifft2(np.fft.fft2(s64) * np.conj(np.fft.fft2(t64))).real)


@pytest.mark.parametrize("variant", VARIANTS)
def test_stft_pure_tone_peak(variant):
    sr, f0 = 16000.0, 1000.0
    t = np.arange(8192) / sr
    audio = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    got, want = _both("stft", audio, variant=variant, frame=512, hop=256)
    _close(got, want)
    peak_bin = got.abs().mean(dim=0).argmax()
    assert abs(int(peak_bin) - round(f0 * 512 / sr)) <= 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_log_mel_shape_and_finite(rng, variant):
    a = rng.standard_normal((2, 4096)).astype(np.float32)
    got, want = _both("log_mel", a, variant=variant, n_mels=80)
    assert tuple(got.shape) == (2, 15, 80)
    assert bool(torch.isfinite(got).all())
    _close(got, want, tol=0.0, atol=LOG_ATOL)


def test_helpers_match_the_reference():
    for n in (1, 2, 3, 31, 64, 65, 1054):
        assert spectral._next_pow2(n) == ref_spectral._next_pow2(n)
    np.testing.assert_array_equal(spectral._hann(512), ref_spectral._hann(512))
    np.testing.assert_array_equal(spectral._mel_filterbank(257, 80),
                                  ref_spectral._mel_filterbank(257, 80))


def test_numpy_input_goes_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    for call in (lambda: spectral.fourier_mixing(x), lambda: spectral.stft(x[0, 0].repeat(32)),
                 lambda: spectral.fftconv(x, x[0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
