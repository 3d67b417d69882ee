"""repro_torch.serve's services on CPU tensors, held to numpy.

``SpectrumService.serve`` and ``ImagingService.serve`` of the reference fail
on this jax (``src/repro/xfft/_transforms.py:37``; its imaging and recon test
files do not import), so the port's services are held to numpy on the inputs
and assertions of ``tests/serve/test_spectrum.py``,
``test_imaging_service.py`` and ``test_recon_lane.py``, ported one for one
(frames as CPU tensors, where the reference passes numpy arrays that run on
its default device; the port sends numpy input to the card). Tolerances are
the reference tests' own (atol 1e-3 on spectra and convolutions, 2e-3 on a
full-mode convolution, 0.13 px on a subpixel shift, atol 1e-5 of a recon
against the direct call), plus, on spectra and convolutions, max|Δ| <=
1e-5 · max|ref| against numpy in float64 (float32 transforms of frames up
to 64²).

Also here: where a lane's frames live (the device in the lane key, the
classifier reading no data, results as views of the lane's batched
output), precision in the lane, and the planner's device argument
(ROADMAP queue 3, divergence 5).
"""

import inspect
import time

import numpy as np
import pytest
import torch

from repro_torch import mri, obs, resilience, xfft
from repro_torch.imaging import apply_shift
from repro_torch.imaging.synthetic import band_limited_frame
from repro_torch.plan import PlanCache, plan_fft, problem_key, resolve, resolve_call
from repro_torch.serve import (
    ConvolutionRequest,
    ImagingService,
    ReconRequest,
    RegistrationRequest,
    SpectrumRequest,
    SpectrumService,
)
from repro_torch.serve.loop import reset_lane_keys

T = torch.from_numpy
N = 32
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_serve_state():
    """As the reference's ``tests/serve/conftest.py``: a clean breaker and
    lane registry around each test."""
    resilience.reset()
    resilience.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_lane_keys()
    yield
    resilience.reset()
    resilience.configure(threshold=1, cooldown_s=30.0, clock=time.monotonic)
    reset_lane_keys()


def _smooth(n, seed):
    return T(band_limited_frame(n, seed))


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------- tests/serve/test_spectrum.py ---------------------


def test_serves_mixed_real_and_complex_groups(rng):
    reqs = [
        SpectrumRequest(frame=T(rng.standard_normal((16, 16)).astype(np.float32)))
        for _ in range(3)
    ]
    reqs.append(
        SpectrumRequest(
            frame=T((rng.standard_normal((8, 8))
                     + 1j * rng.standard_normal((8, 8))).astype(np.complex64))
        )
    )
    svc = SpectrumService()
    out = svc.serve(reqs)
    assert out is reqs and all(r.done for r in reqs)
    for r in reqs[:3]:
        assert r.spectrum.shape == (16, 9)
        want = np.fft.rfft2(r.frame.numpy().astype(np.float64))
        np.testing.assert_allclose(r.spectrum.numpy(), want, atol=1e-3)
        assert _rel(r.spectrum, want) <= TOL
    assert reqs[3].spectrum.shape == (8, 8)
    want = np.fft.fft2(reqs[3].frame.numpy().astype(np.complex128))
    np.testing.assert_allclose(reqs[3].spectrum.numpy(), want, atol=1e-3)
    assert _rel(reqs[3].spectrum, want) <= TOL


def test_one_plan_per_group_is_memoized(rng):
    svc = SpectrumService()
    reqs = [
        SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))
        for _ in range(4)
    ]
    svc.serve(reqs)
    assert len(svc.plans) == 1
    svc.serve(
        [SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))
         for _ in range(7)]
    )
    assert len(svc.plans) == 1


def test_scoped_config_override_reaches_serving(rng):
    svc = SpectrumService()
    frame = T(rng.standard_normal((8, 8)).astype(np.float32))
    svc.serve([SpectrumRequest(frame=frame)])
    (default_plan,) = svc.plans.values()
    with xfft.config(variant="looped"):
        svc.serve([SpectrumRequest(frame=frame)])
    assert len(svc.plans) == 2
    forced = [p for p in svc.plans.values() if p is not default_plan]
    assert forced[0].variant == "looped"
    svc.serve([SpectrumRequest(frame=frame)])
    assert len(svc.plans) == 2


def test_rejects_bad_inputs(rng):
    svc = SpectrumService()
    with pytest.raises(ValueError):
        svc.serve([SpectrumRequest(frame=T(rng.standard_normal((4, 4, 4))))])
    with pytest.raises(ValueError):
        SpectrumService(plan_mode="exhaustive")


# ------------------ tests/serve/test_imaging_service.py ------------------


def test_mixed_queue_all_served(rng):
    ref = _smooth(32, 1)
    reqs = [
        RegistrationRequest(ref=ref, mov=apply_shift(ref, (3.0, -2.0))),
        RegistrationRequest(ref=ref, mov=apply_shift(ref, (-5.0, 7.0))),
        ConvolutionRequest(
            image=T(rng.standard_normal((40, 40)).astype(np.float32)),
            kernel=T(rng.standard_normal((5, 5)).astype(np.float32)),
        ),
        SpectrumRequest(frame=T(rng.standard_normal((16, 16)).astype(np.float32))),
    ]
    out = ImagingService().serve(reqs)
    assert out is reqs and all(r.done for r in reqs)
    np.testing.assert_array_equal(reqs[0].shift.numpy(), [-3.0, 2.0])
    np.testing.assert_array_equal(reqs[1].shift.numpy(), [5.0, -7.0])
    conv = reqs[2]
    image, kernel = conv.image.numpy().astype(np.float64), conv.kernel.numpy().astype(np.float64)
    fh = np.fft.irfft2(
        np.fft.rfft2(image, s=(44, 44)) * np.fft.rfft2(kernel, s=(44, 44)), s=(44, 44),
    )
    np.testing.assert_allclose(conv.out.numpy(), fh[2:42, 2:42], atol=1e-3)
    assert _rel(conv.out, fh[2:42, 2:42]) <= TOL
    np.testing.assert_allclose(
        reqs[3].spectrum.numpy(), np.fft.rfft2(reqs[3].frame.numpy()), atol=1e-3
    )


def test_one_plan_per_group(rng):
    svc = ImagingService()
    ref = _smooth(16, 2)

    def queue():
        return [
            RegistrationRequest(ref=ref, mov=ref) for _ in range(4)
        ] + [
            ConvolutionRequest(
                image=T(rng.standard_normal((24, 24)).astype(np.float32)),
                kernel=T(rng.standard_normal((3, 3)).astype(np.float32)),
            )
            for _ in range(3)
        ]

    svc.serve(queue())
    assert len(svc.plans) == 2
    svc.serve(queue())
    assert len(svc.plans) == 2
    assert sorted(p.key.kind for p in svc.plans.values()) == ["oaconv2d", "rfft2d"]
    reg_plan = next(p for p in svc.plans.values() if p.key.kind == "rfft2d")
    assert reg_plan.key.shape == (4, 16, 16)


def test_convolution_group_uses_planned_tile(rng):
    svc = ImagingService()
    req = ConvolutionRequest(
        image=T(rng.standard_normal((64, 64)).astype(np.float32)),
        kernel=T(rng.standard_normal((9, 9)).astype(np.float32)),
        mode="full",
    )
    svc.serve([req])
    (plan,) = svc.plans.values()
    assert plan.key.kind == "oaconv2d" and plan.tile is not None
    image, kernel = req.image.numpy().astype(np.float64), req.kernel.numpy().astype(np.float64)
    fh = np.fft.irfft2(
        np.fft.rfft2(image, s=(72, 72)) * np.fft.rfft2(kernel, s=(72, 72)), s=(72, 72),
    )
    np.testing.assert_allclose(req.out.numpy(), fh, atol=2e-3)
    assert _rel(req.out, fh) <= TOL


def test_upsample_groups_separately(rng):
    svc = ImagingService()
    ref = _smooth(32, 3)
    mov = apply_shift(ref, (1.5, -0.5))
    coarse = RegistrationRequest(ref=ref, mov=mov)
    fine = RegistrationRequest(ref=ref, mov=mov, upsample=8)
    svc.serve([coarse, fine])
    np.testing.assert_allclose(fine.shift.numpy(), [-1.5, 0.5], atol=0.13)
    assert np.abs(coarse.shift.numpy() - fine.shift.numpy()).max() <= 0.5


def test_unknown_request_type_rejected():
    with pytest.raises(TypeError, match="expected"):
        ImagingService().serve([object()])


def test_bad_frames_rejected():
    with pytest.raises(ValueError, match="matching"):
        ImagingService().serve(
            [RegistrationRequest(ref=torch.zeros(8, 8), mov=torch.zeros(8, 4))]
        )
    with pytest.raises(ValueError, match="2D"):
        ImagingService().serve(
            [ConvolutionRequest(image=torch.zeros(2, 8, 8), kernel=torch.zeros(3, 3))]
        )


def test_invalid_request_fails_before_any_work(rng):
    good = SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))
    bad = RegistrationRequest(ref=torch.zeros(2, 8, 8), mov=torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="matching"):
        ImagingService().serve([good, bad])
    assert not good.done and good.spectrum is None

    reg = RegistrationRequest(ref=torch.zeros(8, 8), mov=torch.zeros(8, 8))
    bad_mode = ConvolutionRequest(
        image=torch.zeros(8, 8), kernel=torch.zeros(3, 3), mode="reflect"
    )
    with pytest.raises(ValueError, match="mode"):
        ImagingService().serve([reg, bad_mode])
    assert not reg.done and reg.shift is None

    too_big = ConvolutionRequest(
        image=torch.zeros(4, 4), kernel=torch.zeros(8, 8), mode="valid"
    )
    with pytest.raises(ValueError, match="kernel <= image"):
        ImagingService().serve([too_big])


# -------------------- tests/serve/test_recon_lane.py --------------------


def _fixture(accel=2, n=N, coils=4, calib=8):
    x = T(mri.shepp_logan(n))
    smaps = T(mri.birdcage_maps(coils, n))
    mask = T(mri.uniform_mask((n, n), accel, calib=calib))
    k = mri.sense_forward(x, smaps, mask)
    return x, smaps, mask, k


def test_recon_lane_coalesces_into_one_batched_solve():
    x, smaps, mask, k = _fixture()
    svc = ImagingService()
    reqs = [ReconRequest(kspace=k, smaps=smaps, mask=mask) for _ in range(3)]
    with obs.capture() as trace:
        svc.serve(reqs)
    assert all(r.done for r in reqs)
    zf = mri.nrmse(mri.recon_zero_filled(k, smaps, mask), x)
    for r in reqs:
        assert r.image.shape == (N, N)
        assert mri.nrmse(r.image, x) < 0.5 * zf
    batches = trace.select("serve.batch")
    assert [(e["service"], e["batch"]) for e in batches] == [("recon", 3)]
    assert len(svc.plans) == 1
    (plan,) = svc.plans.values()
    assert plan.key.kind == "fft2d" and plan.key.shape == (3, 4, N, N)


def test_recon_result_matches_direct_call():
    x, smaps, mask, k = _fixture()
    req = ReconRequest(kspace=k, smaps=smaps, mask=mask, iters=6, lam=1e-3)
    ImagingService().serve([req])
    direct = mri.recon_cg_sense(k, smaps, mask, iters=6, lam=1e-3)
    np.testing.assert_allclose(req.image.numpy(), direct.numpy(), atol=1e-5)


def test_recon_lanes_split_by_problem_geometry():
    _, smaps, mask2, k2 = _fixture(accel=2)
    _, _, mask4, k4 = _fixture(accel=8, calib=0)
    svc = ImagingService()
    reqs = [
        ReconRequest(kspace=k2, smaps=smaps, mask=mask2),
        ReconRequest(kspace=k4, smaps=smaps, mask=mask4),
        ReconRequest(kspace=k2, smaps=smaps, mask=mask2, iters=5),
    ]
    with obs.capture() as trace:
        svc.serve(reqs)
    assert all(r.done for r in reqs)
    recon_batches = [e for e in trace.select("serve.batch") if e["service"] == "recon"]
    assert sorted(e["batch"] for e in recon_batches) == [1, 1, 1]
    assert len({(e["accel"], e["iters"]) for e in recon_batches}) == 3


def test_mixed_queue_recon_plus_spectrum(rng):
    x, smaps, mask, k = _fixture()
    recon = ReconRequest(kspace=k, smaps=smaps, mask=mask)
    spec = SpectrumRequest(frame=T(rng.standard_normal((16, 16)).astype(np.float32)))
    ImagingService().serve([recon, spec])
    assert recon.done and spec.done


def test_second_serve_of_warm_key_re_decides_nothing():
    x, smaps, mask, k = _fixture()
    svc = ImagingService(plan_mode="measure", cache=PlanCache())

    def queue():
        return [ReconRequest(kspace=k, smaps=smaps, mask=mask) for _ in range(2)]

    svc.serve(queue())
    with obs.capture() as trace:
        svc.serve(queue())
    assert trace.select("plan.measure") == []
    resolves = trace.select("plan.resolve")
    assert resolves and {e["outcome"] for e in resolves} == {"hit"}


def test_recon_request_validation_is_all_or_nothing(rng):
    _, smaps, mask, k = _fixture()
    good = SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))
    bad = ReconRequest(kspace=k, smaps=smaps[:2], mask=mask)
    with pytest.raises(ValueError, match="matching"):
        ImagingService().serve([good, bad])
    assert not good.done and good.spectrum is None
    with pytest.raises(ValueError, match="mask"):
        ImagingService().serve([ReconRequest(kspace=k, smaps=smaps, mask=mask[:16])])
    with pytest.raises(ValueError, match="iters"):
        ImagingService().serve([ReconRequest(kspace=k, smaps=smaps, mask=mask, iters=0)])
    with pytest.raises(ValueError, match="lam"):
        ImagingService().serve([ReconRequest(kspace=k, smaps=smaps, mask=mask, lam=-0.1)])


# ------------------------- where a lane's frames live -------------------------


def test_lane_key_carries_the_device_and_results_are_views_of_the_batch(rng):
    svc = SpectrumService()
    reqs = [SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))
            for _ in range(3)]
    lane = svc._classify(reqs[0])
    assert lane.signature == ((8, 8), True, "cpu")
    assert lane.label() == "spectrum[(8, 8),True,cpu]"
    svc.serve(reqs)
    (plan,) = svc.plans.values()
    assert plan.key.backend == "cpu" and plan.key.kind == "rfft2d"
    storage = {r.spectrum.untyped_storage().data_ptr() for r in reqs}
    assert len(storage) == 1, "each spectrum is a view of the lane's batched output"
    assert all(r.spectrum.device.type == "cpu" for r in reqs)


@pytest.mark.parametrize("make", [
    lambda: SpectrumRequest(frame=torch.empty(8, 8, device="meta")),
    lambda: RegistrationRequest(ref=torch.empty(8, 8, device="meta"),
                                mov=torch.empty(8, 8, device="meta"), upsample=4),
    lambda: ConvolutionRequest(image=torch.empty(8, 8, device="meta"),
                               kernel=torch.empty(3, 3, dtype=torch.complex64,
                                                  device="meta")),
], ids=["spectrum", "registration", "convolution"])
def test_classifier_reads_no_data(make):
    """The classifier reads shapes and dtypes only: a tensor with no data
    (``meta``) classifies, where ``np.asarray`` would raise."""
    lane = ImagingService()._classify(make())
    assert lane.signature[-1] == "meta"


def test_numpy_input_lanes_on_the_card():
    """Numpy frames go to the card, as the front door sends them: without
    CUDA the call fails at intake, before any lane runs, and a numpy frame
    never shares a lane with a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    cpu = SpectrumRequest(frame=torch.zeros(8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpectrumService().serve([cpu, SpectrumRequest(frame=np.zeros((8, 8), np.float32))])
    assert not cpu.done and cpu.spectrum is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImagingService().serve([ReconRequest(kspace=np.zeros((2, 8, 8), np.complex64),
                                             smaps=np.zeros((2, 8, 8), np.complex64),
                                             mask=np.ones((8, 8), np.float32))])


def test_lane_under_double_precision_runs_reference_x64(rng):
    frame = rng.standard_normal((16, 16))
    svc = ImagingService()
    x, smaps, mask, k = _fixture(n=16, coils=2, calib=4)
    reqs = [SpectrumRequest(frame=T(frame)), ReconRequest(kspace=k, smaps=smaps, mask=mask)]
    with xfft.config(precision="double"):
        lane = svc._classify(reqs[1])
        svc.serve(reqs)
    assert lane.signature[5] == "double"
    assert reqs[0].spectrum.dtype == torch.complex128
    assert _rel(reqs[0].spectrum, np.fft.rfft2(frame)) <= 1e-12
    assert {p.variant for p in svc.plans.values()} == {"reference_x64"}
    assert reqs[1].image.dtype == torch.complex128


def test_services_plan_the_batched_kinds_not_the_stream(rng):
    """The services plan ``rfft2d``/``fft2d``, never ``fft2d_stream``, so the
    loop thread never reaches the stream's per-device side streams."""
    svc = ImagingService()
    ref = _smooth(16, 4)
    svc.serve([SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32))),
               RegistrationRequest(ref=ref, mov=ref)]
              + [ReconRequest(kspace=k, smaps=s, mask=m)
                 for _, s, m, k in [_fixture(n=16, coils=2, calib=4)]])
    assert {p.key.kind for p in svc.plans.values()} == {"rfft2d", "fft2d"}


# ----------------- ROADMAP queue 3, divergence 5: device third -----------------


@pytest.mark.parametrize("fn", [problem_key, resolve_call, resolve, plan_fft],
                         ids=lambda f: f.__name__)
def test_planner_takes_device_third(fn):
    assert list(inspect.signature(fn).parameters)[:3] == ["kind", "shape", "device"]


def test_reference_call_of_problem_key_raises_and_the_service_passes_its_device(rng):
    """``problem_key(kind, shape, dtype)``, the reference's call, keeps raising
    in the port: the dtype lands in the device slot. The port's serve layer
    passes the lane's device, and its key equals the reference's for the
    same CPU problem."""
    from repro.plan.plan import problem_key as ref_problem_key

    with pytest.raises(RuntimeError):
        problem_key("rfft2d", (8, 8), "float32")
    assert (problem_key("rfft2d", (8, 8), "cpu", "float32").cache_key()
            == ref_problem_key("rfft2d", (8, 8), "float32").cache_key())
    svc = SpectrumService()
    svc.serve([SpectrumRequest(frame=T(rng.standard_normal((8, 8)).astype(np.float32)))])
    ((config, cache_key),) = svc.plans
    assert cache_key == ref_problem_key("rfft2d", (8, 8), "float32").cache_key()
