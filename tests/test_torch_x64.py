"""Double precision: the reference_x64 engine and xfft's double scope.

The reference's double engine is ``jnp.fft`` under ``enable_x64``, which
this jax cannot run (``repro.xfft`` does not import), so the oracle is
numpy in float64, at the reference's gate (``benchmarks/accuracy.py``):
max|port - numpy| <= 1e-10 * max|numpy| on the eight transforms, over 1D
lengths 64 and 1024 and 2D (4, 64, 64) frames, under the three norms.
The planner picks ``reference_x64`` for a double key and never for a single
one, on a CPU key and on a key that names the card. Single-precision
results are unchanged: the sha256 of every transform's output under every
single-precision engine, on a fixed seeded input, is the one the tree
before the double engine gave (computed there on the CPU, torch 2.13).
"""

import hashlib

import numpy as np
import pytest
import torch

from repro_torch import xfft
from repro_torch.core.fft1d import fft_impl, ifft_impl
from repro_torch.core.fft2d import fft2_impl
from repro_torch.core.rfft import irfft_impl, rfft_impl
from repro_torch.engines import get_engine, iter_engines
from repro_torch.imaging import apply_shift, image_to_kspace, kspace_to_image
from repro_torch.plan import PlanCache, ProblemKey, resolve_call
from repro_torch.plan.autotune import variant_candidates

TOL = 1e-10
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"
NORMS = ("backward", "ortho", "forward")
SHAPES_1D = ((3, 64), (3, 1024))
SHAPE_2D = (4, 64, 64)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _data(shape, complex_, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if complex_ else x


# name -> (input is complex, numpy oracle, input shape from the frame shape)
TRANSFORMS = {
    "fft": (True, np.fft.fft, lambda s: s),
    "ifft": (True, np.fft.ifft, lambda s: s),
    "rfft": (False, np.fft.rfft, lambda s: s),
    "irfft": (True, np.fft.irfft, lambda s: s[:-1] + (s[-1] // 2 + 1,)),
    "fft2": (True, np.fft.fft2, lambda s: s),
    "ifft2": (True, np.fft.ifft2, lambda s: s),
    "rfft2": (False, np.fft.rfft2, lambda s: s),
    "irfft2": (True, np.fft.irfft2, lambda s: s[:-1] + (s[-1] // 2 + 1,)),
}
CASES = [(name, shape) for name in ("fft", "ifft", "rfft", "irfft") for shape in SHAPES_1D]
CASES += [(name, SHAPE_2D) for name in ("fft2", "ifft2", "rfft2", "irfft2")]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,shape", CASES, ids=[f"{n}-{'x'.join(map(str, s))}"
                                                   for n, s in CASES])
def test_double_transforms_match_numpy_float64(name, shape, norm):
    complex_, oracle, in_shape = TRANSFORMS[name]
    x = _data(in_shape(shape), complex_)
    with xfft.config(precision="double"):
        got = getattr(xfft, name)(torch.from_numpy(x), norm=norm)
    if name in ("irfft", "irfft2"):
        want = oracle(x, shape[-1], norm=norm) if name == "irfft" else \
            oracle(x, shape[-2:], norm=norm)
        assert got.dtype == torch.float64
    else:
        want = oracle(x, norm=norm)
        assert got.dtype == torch.complex128
    assert got.device == CPU
    _close(got.numpy(), want)


def test_double_scope_casts_single_input_up_and_freqs_follow():
    x32 = _data((2, 64), False).astype(np.float32)
    with xfft.config(precision="double"):
        half = xfft.rfft(torch.from_numpy(x32))
        assert half.dtype == torch.complex128
        _close(half.numpy(), np.fft.rfft(x32.astype(np.float64)))
        spec = xfft.fftn(torch.from_numpy(x32.astype(np.complex64)), axes=(0, 1))
        _close(spec.numpy(), np.fft.fftn(x32.astype(np.complex128)))
        assert xfft.fftfreq(8, device="cpu").dtype == torch.float64
        assert xfft.rfftfreq(8, device="cpu").dtype == torch.float64
        _close(xfft.fftfreq(8, 0.1, device="cpu").numpy(), np.fft.fftfreq(8, 0.1), 1e-15)
    assert xfft.fftfreq(8, device="cpu").dtype == torch.float32
    assert xfft.fft(torch.from_numpy(x32)).dtype == torch.complex64


@pytest.mark.parametrize("variant", ["looped", "stockham", "radix4"])
@pytest.mark.parametrize("n", [64, 1024])
def test_every_plain_schedule_runs_in_double(variant, n):
    """The dtype flows through every plain schedule: the looped engine's
    twiddle ROM, the radix-2 Stockham panel and the radix-4 register passes
    (their W_16 constants and ROM in float64)."""
    z = _data((3, n), True)
    r = _data((3, n), False, seed=1)
    c128 = torch.complex128
    got = fft_impl(torch.from_numpy(z), variant=variant, dtype=c128)
    assert got.dtype == c128
    _close(got.numpy(), np.fft.fft(z))
    _close(ifft_impl(torch.from_numpy(z), variant=variant, dtype=c128).numpy(), np.fft.ifft(z))
    half = rfft_impl(torch.from_numpy(r), variant=variant, dtype=c128)
    _close(half.numpy(), np.fft.rfft(r))
    back = irfft_impl(half, variant=variant, dtype=c128)
    assert back.dtype == torch.float64
    _close(back.numpy(), r)
    frames = _data((2, 16, n // 16), True)
    _close(fft2_impl(torch.from_numpy(frames), variant=variant, dtype=c128).numpy(),
           np.fft.fft2(frames))


def test_fused_kernels_refuse_double():
    with pytest.raises(ValueError, match="single-precision CUDA kernels"):
        fft_impl(torch.zeros(2, 8, dtype=torch.complex128), variant="fused_r4",
                 dtype=torch.complex128)


# ------------------------------- planning -------------------------------


@pytest.mark.parametrize("kind,shape,dtype", [("fft1d", (3, 1024), "complex64"),
                                              ("fft2d", SHAPE_2D, "complex64"),
                                              ("rfft1d", (3, 64), "float32"),
                                              ("rfft2d", SHAPE_2D, "float32")])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_planner_picks_reference_x64_for_double_only(kind, shape, dtype, direction):
    with xfft.config(precision="double"):
        plan = resolve_call(kind, shape, CPU, dtype=dtype, direction=direction,
                            cache=PlanCache())
    assert plan.variant == "reference_x64" and plan.precision == "double"
    assert plan.key.dtype == {"complex64": "complex128", "float32": "float64"}[dtype]
    single = resolve_call(kind, shape, CPU, dtype=dtype, direction=direction,
                          cache=PlanCache())
    assert single.variant != "reference_x64"
    for precision, want in (("double", ("reference_x64",)), ("single", ("fused", "fused_r4"))):
        key = ProblemKey(kind=kind, backend="cuda", device_kind=H100, shape=shape,
                         dtype=dtype, direction=direction, precision=precision)
        assert variant_candidates(key) == want   # on the card: no plain schedule for single
    assert "reference_x64" not in [s.name for s in iter_engines(precision="single")]


def test_engine_declares_the_reference_capabilities():
    spec = get_engine("reference_x64")
    assert (spec.precisions, spec.dtypes, spec.reliable, spec.backend) == \
        (("double",), ("complex128", "float64"), True, "x64")
    assert spec.kinds == ("fft1d", "fft2d", "fft2d_stream", "rfft1d", "rfft2d")
    assert get_engine("stockham").reliable and not get_engine("fused_r4").reliable


def test_forcing_an_engine_checks_its_precision():
    with pytest.raises(ValueError, match="cannot serve precision 'double'"):
        xfft.config(precision="double", variant="stockham")
    with pytest.raises(ValueError, match="cannot serve precision 'single'"):
        xfft.config(variant="reference_x64")
    with pytest.raises(ValueError, match="unsupported precision"):
        xfft.config(precision="half")
    with xfft.config(precision="complex128", variant="reference_x64"):
        assert xfft.fft2(torch.zeros(2, 8, 8)).dtype == torch.complex128


def test_kspace_and_apply_shift_keep_complex128():
    img = _data((2, 3, 32, 32), True)
    real = img.real.copy()
    with xfft.config(precision="double"):
        k = image_to_kspace(torch.from_numpy(img))
        kr = image_to_kspace(torch.from_numpy(real))
        moved = apply_shift(torch.from_numpy(img), torch.tensor([1.0, -2.0]))
    assert k.dtype == kr.dtype == moved.dtype == torch.complex128
    axes = (-2, -1)
    want = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(img, axes=axes), norm="ortho"),
                           axes=axes)
    _close(k.numpy(), want)
    with xfft.config(precision="double"):
        _close(kspace_to_image(k).numpy(), img)
    _close(moved.numpy(), np.roll(img, (1, -2), axis=(-2, -1)), 1e-6)  # float32 ramp
    assert image_to_kspace(torch.from_numpy(real)).dtype == torch.complex64


# --------------------- single precision, bit for bit ---------------------


SINGLE_SHA256 = {
    "looped/fft": "89ba0c3798b4c425f0180dc37673b9c93fe2d093aededd55db9c5b81a710b4db",
    "looped/ifft": "b71911c951d833b75e6e28d86d227a48fe98979a75531c26bf1350ac1a298c9f",
    "looped/rfft": "a6e429ce8fce51d41c6e3e0928d59f8dbe1c9bfdf02a52b73283e789dfe3c462",
    "looped/irfft": "5255af71adec0e788554851736ccf5f6982472b0c683623ff56aa5c3becf6748",
    "looped/fft2": "734f55b68c6c707bc64b95a355d041b0588f9557bfce720711160773dd42d0f0",
    "looped/ifft2": "eeadc6a08455c1622a204317a8a98b9bb70f37b0b1f0c549fd846bcf81ae9303",
    "looped/rfft2": "5c349359aca4ef1e0b49cb06599019fdbea1ee2a9af10a09a166ed67ba92c33f",
    "looped/irfft2": "4ad916e8d5477cc1d48cc9b0cc307198aa614a6ee1dde131ec47fddafe056bab",
    "stockham/fft": "2a94e3b0a7bb5c9b732a1a46fd04b0f3b3722e53bfedba771bd2b2bc3fc69e7a",
    "stockham/ifft": "2e54f9d83a9b1febe4f97157ed0118be70387980d23de7fba7680f2616b48f97",
    "stockham/rfft": "ab9ac5afe64d62beb4566b042720abd9c38031d77c5a5147f73a6875a163a652",
    "stockham/irfft": "78b00ee404f28a2fee597deef842d1f802025dcace385f705583556f3c530275",
    "stockham/fft2": "ba41aa1b41f1ff4d3659b53f5e564e9782e85f568dd506dec9933f5acbda3d6e",
    "stockham/ifft2": "e32128c7629a80d9ddad9a35b2c98795b861790b28d1c0488ee23a9457f4f4ac",
    "stockham/rfft2": "74deea0f8b93b1df0bc0ba355a11cae7882c5fa75b89e4bbd21dff98cad7001f",
    "stockham/irfft2": "22e0a22b53f47cc1af57710d0e51375513cd9358df95ab8c15320f796c92a1ab",
    "radix4/fft": "84371a8a72e9613e3227550c38498c70e7608e17aea36f3766b9f6b761339d87",
    "radix4/ifft": "e79b97fee64148ae013908560398ee7c520ef49412dd2f8f9875961cacc2d941",
    "radix4/rfft": "c7a6db3357c81307be2563839a38f9fa28215651c51c2426c5c8b87e9874ace9",
    "radix4/irfft": "87c43098ea44dbc361ca7992621075b4c645674c23dac4ad4c7c5f335fca2efb",
    "radix4/fft2": "4b91fcc4cd22a52ebd32afeb8d6968f8b9441eddd2d519c0186f84aea9342f75",
    "radix4/ifft2": "e55ba99119ff4a922b3f159277705e1c3e2258dde7e61abc9d00487caebaa740",
    "radix4/rfft2": "901d92297b38c69bc4df818a154169839b02900a8b120665207cf976f0328b7d",
    "radix4/irfft2": "8350e059f198bc3c2dc2c525f34fde9f7e55d2d26d5387c51d1376c80c344145",
    "fused/fft": "2a94e3b0a7bb5c9b732a1a46fd04b0f3b3722e53bfedba771bd2b2bc3fc69e7a",
    "fused/ifft": "2e54f9d83a9b1febe4f97157ed0118be70387980d23de7fba7680f2616b48f97",
    "fused/rfft": "89366a8209a4f4a0931c60e35b5c3cb7a26bd51b76d0cbda9bd89f174d70f0f5",
    "fused/irfft": "9ac63bf3573966d6f7aa20d57031523fc057f5cd82b5c2f059363f6883b41e59",
    "fused/fft2": "ba41aa1b41f1ff4d3659b53f5e564e9782e85f568dd506dec9933f5acbda3d6e",
    "fused/ifft2": "e32128c7629a80d9ddad9a35b2c98795b861790b28d1c0488ee23a9457f4f4ac",
    "fused/rfft2": "308705aa7be10495d3f71e63d882bf00cbc9b903bf0efeae2dd9a3c52c019e1d",
    "fused/irfft2": "c84a760e0503e50052b4b55c2e7a79220e181d1d8659f0ea786a447f68d60bb3",
    "fused_r4/fft": "84371a8a72e9613e3227550c38498c70e7608e17aea36f3766b9f6b761339d87",
    "fused_r4/ifft": "e79b97fee64148ae013908560398ee7c520ef49412dd2f8f9875961cacc2d941",
    "fused_r4/rfft": "9b3154a07c5f1e87a9b56e77cc4273f537eaa1f4a5eda624b28ee286e8022706",
    "fused_r4/irfft": "31eab79b3531bde4b659d007f75dbb9136ce0a258c75ae4560c07bac128936f7",
    "fused_r4/fft2": "4b91fcc4cd22a52ebd32afeb8d6968f8b9441eddd2d519c0186f84aea9342f75",
    "fused_r4/ifft2": "e55ba99119ff4a922b3f159277705e1c3e2258dde7e61abc9d00487caebaa740",
    "fused_r4/rfft2": "fe6961877e5456a37699cc9665fabf3273eb87becc007c31f05c8cdbb9457349",
    "fused_r4/irfft2": "fb72b030b940ac13b0aa12e677727dfa68cd0bd71a720788bbf83cc9e79266a5",
}


def _single_inputs():
    rng = np.random.default_rng(24)
    c1 = (rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64))).astype(np.complex64)
    r1 = rng.standard_normal((3, 64)).astype(np.float32)
    c2 = (rng.standard_normal((2, 16, 32)) + 1j * rng.standard_normal((2, 16, 32))
          ).astype(np.complex64)
    r2 = rng.standard_normal((2, 16, 32)).astype(np.float32)
    h1 = (rng.standard_normal((3, 33)) + 1j * rng.standard_normal((3, 33))).astype(np.complex64)
    h2 = (rng.standard_normal((2, 16, 17)) + 1j * rng.standard_normal((2, 16, 17))
          ).astype(np.complex64)
    return {"fft": c1, "ifft": c1, "rfft": r1, "irfft": h1,
            "fft2": c2, "ifft2": c2, "rfft2": r2, "irfft2": h2}


@pytest.mark.parametrize("case", sorted(SINGLE_SHA256))
def test_single_precision_is_unchanged_bit_for_bit(case):
    variant, name = case.split("/")
    with xfft.config(variant=variant):
        y = getattr(xfft, name)(torch.from_numpy(_single_inputs()[name]))
    assert y.dtype in (torch.complex64, torch.float32)
    assert hashlib.sha256(y.contiguous().numpy().tobytes()).hexdigest() == SINGLE_SHA256[case]
