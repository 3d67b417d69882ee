"""repro_torch.xfft, the slice as a whole, on CPU tensors.

The eight transforms are held to the JAX package's engine entries under
the same variant the port's planner chose (or a forced fused variant), at
a frame inside one Hopper block (64x64, the whole-frame 2D kernels) and
one outside it (256x256, the row / turn / column composition); and to
numpy.fft for all three norms, non-default axes and n/s resizing.
Tolerance max|port - ref| <= 1e-5 * max|ref|; round trips 1e-4.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import xfft
from repro_torch.plan import resolve_call

jfft1d = importlib.import_module("repro.core.fft1d")
jfft2d = importlib.import_module("repro.core.fft2d")
jrfft = importlib.import_module("repro.core.rfft")

TOL = 1e-5
CPU = torch.device("cpu")


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


def _ref(fn, x, variant):
    return np.asarray(jax.jit(functools.partial(fn, variant=variant))(jnp.asarray(x)))


def _crandn(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _variant(forced, kind, shape, direction="fwd", dtype="complex64"):
    if forced is not None:
        return forced
    return resolve_call(kind, shape, CPU, dtype=dtype, direction=direction).variant


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 256, 256)])
@pytest.mark.parametrize("forced", [None, "fused", "fused_r4"])
def test_complex_transforms_match_reference(shape, forced):
    x = _crandn(np.random.default_rng(shape[-1]), shape)
    t = torch.from_numpy(x)
    with xfft.config(variant=forced or "auto"):
        y2 = xfft.fft2(t)
        b2 = xfft.ifft2(y2)
        y1 = xfft.fft(t)
        b1 = xfft.ifft(y1)
    _close(y2.numpy(), _ref(jfft2d.fft2_impl, x, _variant(forced, "fft2d", shape)))
    _close(b2.numpy(), _ref(jfft2d.ifft2_impl, y2.numpy(),
                            _variant(forced, "fft2d", shape, "inv")))
    _close(y1.numpy(), _ref(jfft1d.fft_impl, x, _variant(forced, "fft1d", shape)))
    _close(b1.numpy(), _ref(jfft1d.ifft_impl, y1.numpy(),
                            _variant(forced, "fft1d", shape, "inv")))
    _close(b2.numpy(), x, 1e-4)


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 256, 256)])
@pytest.mark.parametrize("forced", [None, "fused", "fused_r4"])
def test_real_transforms_match_reference(shape, forced):
    x = np.random.default_rng(shape[-1] + 1).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    with xfft.config(variant=forced or "auto"):
        y2 = xfft.rfft2(t)
        b2 = xfft.irfft2(y2)
        y1 = xfft.rfft(t)
        b1 = xfft.irfft(y1)
    f32 = "float32"
    _close(y2.numpy(), _ref(jrfft.rfft2_impl, x, _variant(forced, "rfft2d", shape, dtype=f32)))
    _close(b2.numpy(), _ref(jrfft.irfft2_impl, y2.numpy(),
                            _variant(forced, "rfft2d", shape, "inv", f32)))
    _close(y1.numpy(), _ref(jrfft.rfft_impl, x, _variant(forced, "rfft1d", shape, dtype=f32)))
    _close(b1.numpy(), _ref(jrfft.irfft_impl, y1.numpy(),
                            _variant(forced, "rfft1d", shape, "inv", f32)))
    assert np.max(np.abs(b2.numpy() - x)) <= 1e-4
    assert np.max(np.abs(b1.numpy() - x)) <= 1e-4


TRANSFORMS = {
    "fft": (xfft.fft, np.fft.fft, False),
    "ifft": (xfft.ifft, np.fft.ifft, False),
    "fft2": (xfft.fft2, np.fft.fft2, False),
    "ifft2": (xfft.ifft2, np.fft.ifft2, False),
    "rfft": (xfft.rfft, np.fft.rfft, True),
    "irfft": (xfft.irfft, np.fft.irfft, None),
    "rfft2": (xfft.rfft2, np.fft.rfft2, True),
    "irfft2": (xfft.irfft2, np.fft.irfft2, None),
}


def _input(real, shape, seed=0):
    rng = np.random.default_rng(seed)
    if real:
        return rng.standard_normal(shape).astype(np.float32)
    return _crandn(rng, shape)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_norms_match_numpy(name, norm):
    fn, ref, real = TRANSFORMS[name]
    shape = (3, 16, 33) if real is None else (3, 16, 32)  # inverse real: half spectra
    x = _input(bool(real), shape)
    got = fn(torch.from_numpy(x), norm=norm)
    _close(got.numpy(), ref(x.astype(np.complex128) if real is False else x, norm=norm))


@pytest.mark.parametrize("name,kwargs,npkw", [
    ("fft", {"axis": 0}, {"axis": 0}),
    ("ifft", {"axis": 1, "n": 32}, {"axis": 1, "n": 32}),
    ("fft", {"n": 8}, {"n": 8}),
    ("rfft", {"axis": 1, "n": 64}, {"axis": 1, "n": 64}),
    ("irfft", {"axis": 0, "n": 8}, {"axis": 0, "n": 8}),
    ("fft2", {"axes": (0, 2)}, {"axes": (0, 2)}),
    ("ifft2", {"axes": (2, 1), "s": (8, 32)}, {"axes": (2, 1), "s": (8, 32)}),
    ("rfft2", {"axes": (1, 0)}, {"axes": (1, 0)}),
    ("rfft2", {"s": (8, 64)}, {"s": (8, 64)}),
    ("irfft2", {"axes": (0, 1)}, {"axes": (0, 1)}),
    ("irfft2", {"s": (32, 16)}, {"s": (32, 16)}),
])
def test_axes_and_resizing_match_numpy(name, kwargs, npkw):
    fn, ref, real = TRANSFORMS[name]
    shape = (4, 16, 17) if real is None and "s" not in kwargs else (4, 16, 32)
    if name == "irfft2" and npkw.get("axes") == (0, 1):
        shape = (4, 3, 16)  # half spectrum along axis 1: 2*(3-1) = 4
    x = _input(bool(real), shape, seed=1)
    got = fn(torch.from_numpy(x), **kwargs)
    _close(got.numpy(), ref(x.astype(np.complex128) if real is False else x, **npkw))


def test_fftn_and_rfftn_match_numpy():
    x = _crandn(np.random.default_rng(2), (4, 8, 16))
    t = torch.from_numpy(x)
    for axes in (None, (1,), (0, 2), (2, 0, 1)):
        _close(xfft.fftn(t, axes=axes).numpy(), np.fft.fftn(x, axes=axes))
        _close(xfft.ifftn(t, axes=axes).numpy(), np.fft.ifftn(x, axes=axes))
    r = x.real.copy()
    for axes in ((1,), (0, 2)):
        half = xfft.rfftn(torch.from_numpy(r), axes=axes)
        _close(half.numpy(), np.fft.rfftn(r, axes=axes))
        _close(xfft.irfftn(half, axes=axes).numpy(), np.fft.irfftn(half.numpy(), axes=axes))
    half = xfft.rfftn(torch.from_numpy(r))  # three axes: rfft, then two fft passes
    _close(half.numpy(), np.fft.rfftn(r))
    _close(xfft.irfftn(half).numpy(), np.fft.irfftn(half.numpy()))


def test_shifts_and_freqs_match_numpy():
    x = np.arange(5 * 6, dtype=np.float32).reshape(5, 6)
    t = torch.from_numpy(x)
    for axes in (None, 0, (1,)):
        assert np.array_equal(xfft.fftshift(t, axes).numpy(), np.fft.fftshift(x, axes))
        assert np.array_equal(xfft.ifftshift(t, axes).numpy(), np.fft.ifftshift(x, axes))
    assert np.array_equal(xfft.ifftshift2(xfft.fftshift2(t)).numpy(), x)
    for n in (1, 7, 8):
        np.testing.assert_allclose(xfft.fftfreq(n, 0.5, device="cpu").numpy(),
                                   np.fft.fftfreq(n, 0.5), rtol=1e-6)
        np.testing.assert_allclose(xfft.rfftfreq(n, device="cpu").numpy(),
                                   np.fft.rfftfreq(n), rtol=1e-6)


def test_output_stays_on_the_input_device_and_in_single_precision():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 8)))  # float64
    y = xfft.fft2(x)
    assert y.device == CPU and y.dtype == torch.complex64
    assert xfft.irfft2(xfft.rfft2(x)).dtype == torch.float32


def test_errors_name_axis_and_size():
    with pytest.raises(ValueError, match="axis 1 has length 12"):
        xfft.fft2(torch.zeros(4, 12, dtype=torch.complex64))
    with pytest.raises(ValueError, match="norm"):
        xfft.fft(torch.zeros(8, dtype=torch.complex64), norm="both")
    with pytest.raises(TypeError):
        xfft.rfft(torch.zeros(8, dtype=torch.complex64))
