"""The rest of the front-door surface: ``rfftn``/``irfftn`` over three axes
and more, ``xfft.config(observe=, flight_recorder=)``, the package exports
and the deprecated ``repro_torch.core`` entry points.

``rfftn``/``irfftn`` are held to numpy in float64 on the inputs and
assertions of the reference's ``tests/xfft/test_rfftn.py``: the
reference's ``repro.xfft`` does not import on this jax
(``jax.experimental.enable_x64`` is gone), so numpy is the oracle, at the
reference's tolerances (rtol 2e-3, atol 1e-2). The flight-recorder scope
mirrors ``tests/obs/test_telemetry.py:102-124``; the exports are compared
with the reference's ``__all__``.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.engines as jengines
import repro.plan as jplan
from repro_torch import core, engines, obs, plan, xfft
from repro_torch.core import _deprecation
from repro_torch.obs import FlightRecorder
from repro_torch.plan import NORMS

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    plan.reset_default_cache()
    yield
    plan.reset_default_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _real(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _close(got, want, scale=1.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-2 * scale)


# ------------------------- rfftn / irfftn (N axes) -------------------------


@pytest.mark.parametrize("norm", NORMS)
def test_rfftn_matches_numpy_3d(rng, norm):
    x = _real(rng, (8, 16, 32))
    _close(xfft.rfftn(x, norm=norm), np.fft.rfftn(x.numpy().astype(np.float64), norm=norm))


@pytest.mark.parametrize("norm", NORMS)
def test_irfftn_round_trips(rng, norm):
    x = _real(rng, (4, 8, 16))
    back = xfft.irfftn(xfft.rfftn(x, norm=norm), norm=norm)
    _close(back, x.numpy())


def test_rfftn_1d_and_2d_delegate_to_dedicated_kinds(rng):
    x = _real(rng, (16, 32))
    _close(xfft.rfftn(x, axes=(-1,)), np.fft.rfft(x.numpy()))
    _close(xfft.rfftn(x), np.fft.rfftn(x.numpy()))
    _close(xfft.irfftn(torch.from_numpy(np.fft.rfftn(x.numpy()).astype(np.complex64))),
           x.numpy())


def test_rfftn_s_crops_and_pads(rng):
    x = _real(rng, (8, 8, 8))
    want = np.fft.rfftn(x.numpy(), s=(4, 16, 8), axes=(0, 1, 2))
    _close(xfft.rfftn(x, s=(4, 16, 8)), want)


def test_irfftn_recovers_odd_less_shapes(rng):
    x = _real(rng, (4, 8, 16))
    spec = torch.from_numpy(np.fft.rfftn(x.numpy()).astype(np.complex64))
    _close(xfft.irfftn(spec, s=x.shape), x.numpy())


def test_rfftn_rejects_complex_input(rng):
    z = (rng.standard_normal((8, 8, 8)) + 1j * rng.standard_normal((8, 8, 8))
         ).astype(np.complex64)
    with pytest.raises(TypeError, match="real input"):
        xfft.rfftn(torch.from_numpy(z))


def test_rfftn_uses_real_kinds_not_complex_fftn(rng, monkeypatch):
    """The innermost pass is the two-for-one real transform, and no full
    complex fftn runs."""
    from repro_torch.xfft import _transforms

    kinds = []
    real_resolve_call = _transforms.resolve_call

    def spy(kind, shape, *args, **kwargs):
        kinds.append(kind)
        return real_resolve_call(kind, shape, *args, **kwargs)

    monkeypatch.setattr(_transforms, "resolve_call", spy)
    xfft.rfftn(_real(rng, (4, 8, 16)))
    assert kinds[0] == "rfft1d"
    assert set(kinds) == {"rfft1d", "fft1d"}


@pytest.mark.parametrize("axes", [(0, 1, 2), (1, 2, 3), (0, 2, 3), (-1, 0, 1, 2)])
def test_rfftn_over_more_axes_at_float64(rng, axes):
    x = rng.standard_normal((4, 8, 16, 32))
    with xfft.config(precision="double"):
        half = xfft.rfftn(torch.from_numpy(x), axes=axes)
        back = xfft.irfftn(half, s=[x.shape[a] for a in axes], axes=axes)
    want = np.fft.rfftn(x, axes=axes)
    assert half.dtype == torch.complex128
    assert np.abs(half.numpy() - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(back.numpy() - x).max() <= 1e-10 * np.abs(x).max()


# ------------------------------ xfft.config ------------------------------


def test_config_flight_recorder_scoping(tmp_path):
    outer = obs.flight_recorder()
    mine = FlightRecorder(capacity=8, dump_dir=str(tmp_path))
    with xfft.config(flight_recorder=mine):
        assert obs.flight_recorder() is mine
        obs.emit("telemetry.unit.scoped")
        assert any(e.name == "telemetry.unit.scoped" for e in mine.events())
        with xfft.config(flight_recorder=False):
            assert obs.flight_recorder() is None
            obs.emit("telemetry.unit.off")
        assert obs.flight_recorder() is mine
        assert not any(e.name == "telemetry.unit.off" for e in mine.events())
    assert obs.flight_recorder() is outer


def test_config_flight_recorder_capacity_and_validation():
    outer = obs.flight_recorder()
    with xfft.config(flight_recorder=32):
        assert obs.flight_recorder().capacity == 32
    with xfft.config(flight_recorder=True):
        assert obs.flight_recorder().capacity == 4096
    with pytest.raises(ValueError, match="flight_recorder"):
        xfft.config(flight_recorder="yes")
    assert obs.flight_recorder() is outer
    with xfft.config(variant="stockham"):  # not given: the recorder stays
        assert obs.flight_recorder() is outer


def test_config_observe_streams_into_a_trace():
    trace = obs.Trace()
    x = torch.from_numpy(np.ones((4, 8), np.complex64))
    with xfft.config(observe=trace):
        assert xfft.get_config().observe is trace
        xfft.fft(x)
        with xfft.config(variant="stockham"):  # inherits without pushing twice
            xfft.fft(x)
    assert [e["outcome"] for e in trace.select("plan.resolve")] == ["miss", "forced"]
    assert len(trace.select("engine.apply")) == 2  # one a call: recorded once
    xfft.fft(x)
    assert len(trace.select("plan.resolve")) == 2  # out of scope: nothing more
    with xfft.config(observe=True):
        assert obs.profiling()
    with pytest.raises(ValueError, match="observe"):
        xfft.config(observe="yes")


# -------------------------------- exports --------------------------------


def test_packages_export_what_the_reference_exports():
    assert set(core.__all__) == set(jcore.__all__)
    for name in core.__all__:
        assert callable(getattr(core, name)), name
    assert set(jplan.__all__) <= set(plan.__all__)  # chunk_candidates came with item 11
    assert plan.chunk_candidates is importlib.import_module(
        "repro_torch.plan.autotune").chunk_candidates
    assert set(jengines.__all__) <= set(engines.__all__)
    assert plan.PRECISIONS == jplan.PRECISIONS == ("single", "double")
    assert set(plan.PLAN_VARIANTS) == set(jplan.PLAN_VARIANTS) - {"unrolled"}
    assert plan.oaconv_tile_candidates is importlib.import_module(
        "repro_torch.plan.autotune").oaconv_tile_candidates
    assert core.fft2_stream is importlib.import_module("repro_torch.core.fft2d").fft2_stream
    with pytest.raises(AttributeError):
        core.no_such_name  # noqa: B018


# ------------------------------- the shims -------------------------------

SHIMS = {  # name: (input maker, numpy reference)
    "fft": (lambda r: r.standard_normal((3, 16)) + 1j * r.standard_normal((3, 16)), np.fft.fft),
    "ifft": (lambda r: r.standard_normal((3, 16)) + 1j * r.standard_normal((3, 16)),
             np.fft.ifft),
    "fft2": (lambda r: r.standard_normal((2, 8, 16)) + 1j * r.standard_normal((2, 8, 16)),
             np.fft.fft2),
    "ifft2": (lambda r: r.standard_normal((2, 8, 16)) + 1j * r.standard_normal((2, 8, 16)),
              np.fft.ifft2),
    "rfft": (lambda r: r.standard_normal((3, 16)), np.fft.rfft),
    "irfft": (lambda r: np.fft.rfft(r.standard_normal((3, 16))), np.fft.irfft),
    "rfft2": (lambda r: r.standard_normal((2, 8, 16)), np.fft.rfft2),
    "irfft2": (lambda r: np.fft.rfft2(r.standard_normal((2, 8, 16))), np.fft.irfft2),
}


@pytest.mark.parametrize("name", list(SHIMS))
def test_deprecated_core_entry_points_warn_once_and_call_xfft(name):
    make, ref = SHIMS[name]
    x = make(np.random.default_rng(1))
    t = torch.from_numpy(x.astype(np.complex64 if np.iscomplexobj(x) else np.float32))
    _deprecation.reset_warnings()
    shim = getattr(core, name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = shim(t)
        second = shim(t, variant="radix4")
    deprecations = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(deprecations) == 1
    assert f"repro_torch.xfft.{name}" in str(deprecations[0].message)
    assert deprecations[0].filename == __file__  # points at the caller
    for got in (first, second):
        _close(got, ref(x), scale=float(np.abs(ref(x)).max()) * 1e-3)
        np.testing.assert_array_equal(first.numpy(), getattr(xfft, name)(t).numpy())
    with xfft.config(variant="radix4"):
        np.testing.assert_array_equal(second.numpy(), getattr(xfft, name)(t).numpy())
