"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where CUDA is absent. This file imports
torch and repro_torch only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance max|kernel - plain| <= 2e-5 * max|plain|: for the FFT kernels
CUDA ``sincospif`` against the host's cos/sin, and FMA contraction over up
to 14 stages (18 in the two passes and the cluster kernel); for flash attention float32 sums
over D and the keys taken in another order. The sLSTM scan's 1e-4 allows for rounding carried
through every serial step of the recurrence.
"""

import math
import time

import numpy as np
import pytest
import torch

from repro_torch import xfft
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import fft_radix2 as k
from repro_torch.kernels import fft_staged
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels._launch import launch
from repro_torch.kernels.slstm_scan import (
    ROUTES,
    slstm_grid,
    slstm_scan,
    slstm_scan_bwd,
    slstm_scan_bwd_plain,
    slstm_scan_plain,
    slstm_scan_saving,
    slstm_weights_from_jax,
)

TOL = 2e-5
TOL_SLSTM = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2, 4])
def test_cuda_kernels_match_plain_versions(cuda, radix):
    """Each kernel against its plain version, with odd batches so the
    masked edge of the last block is exercised. fft_fused (forward and
    inverse) and rfft_fused take every one-block length, at a batch of 7
    and of one row (blocks of fewer than 16 threads, and of exactly 16,
    take their own recombination path at radix 4), and are also held to
    torch.fft; irfft_fused takes every one-block length at a batch of 7."""
    g = torch.Generator(device=cuda).manual_seed(radix)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=cuda),
                             torch.randn(*shape, generator=g, device=cuda))

    k.reset_launches()
    for n in (2 ** p for p in range(1, 15)):
        for batch in (7, 1):
            x = crandn(batch, n)
            for inverse in (False, True):
                got = k.fft_fused(x, radix=radix, inverse=inverse)
                assert _rel(got, k.fft_fused_plain(x, radix=radix, inverse=inverse)) <= TOL, n
                ref = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
                assert _rel(got, ref) <= TOL, (n, inverse)
            r = torch.randn(batch, n, generator=g, device=cuda)
            got = k.rfft_fused(r, radix=radix)
            assert _rel(got, k.rfft_fused_plain(r, radix=radix)) <= TOL, n
            assert _rel(got, torch.fft.rfft(r)) <= TOL, n
    for n in (2 ** p for p in range(1, 15)):
        y = crandn(7, n // 2 + 1)
        got = k.irfft_fused(y, radix=radix)
        assert _rel(got, k.irfft_fused_plain(y, radix=radix)) <= TOL, n
    for hw in ((2, 2), (8, 64), (128, 128)):
        x = crandn(5, *hw)
        assert _rel(k.fft2_fused(x, radix=radix), k.fft2_fused_plain(x, radix=radix)) <= TOL
    for hw in ((2, 2), (2, 8), (8, 2), (64, 32), (128, 128), (128, 256), (256, 128)):
        r = torch.randn(5, *hw, generator=g, device=cuda)
        assert _rel(k.rfft2_fused(r, radix=radix), k.rfft2_fused_plain(r, radix=radix)) <= TOL
        y = crandn(5, hw[0], hw[1] // 2 + 1)
        assert _rel(k.irfft2_fused(y, radix=radix),
                    k.irfft2_fused_plain(y, radix=radix)) <= TOL
    assert k.LAUNCHES == {"fft_fused": 56, "rfft_fused": 28, "irfft_fused": 14, "fft2_fused": 3,
                          "rfft2_fused": 7, "irfft2_fused": 7, "butterfly_stage": 0,
                          "flash_attention_fwd": 0, "flash_attention_bwd": 0, "slstm_scan": 0,
                          "slstm_scan_bwd": 0, "fft_two_pass": 0, "fft_cluster": 0,
                          "fft2_columns": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2])
def test_cuda_fft_two_pass_matches_plain(cuda, radix):
    """Rows over one block take the two-pass kernels at radix 2 (both
    passes on register passes): two launches per complex call, three per
    real one; odd batches, forward and inverse, every row length (every
    column and row instance)."""
    g = torch.Generator(device=cuda).manual_seed(10 + radix)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=cuda),
                             torch.randn(*shape, generator=g, device=cuda))

    k.reset_launches()
    lengths = (2 ** 15, 2 ** 16, 2 ** 17, 2 ** 18)
    for n in lengths:
        x = crandn(3, n)
        for inverse in (False, True):
            got = k.fft_fused(x, radix=radix, inverse=inverse)
            ref = k.fft_two_pass_plain(x, radix=radix, inverse=inverse)
            assert _rel(got, ref) <= TOL, (n, inverse)
        r = torch.randn(3, n, generator=g, device=cuda)
        assert _rel(k.rfft_fused(r, radix=radix), k.rfft_two_pass_plain(r, radix=radix)) <= TOL
        y = crandn(3, n // 2 + 1)
        assert _rel(k.irfft_fused(y, radix=radix), k.irfft_two_pass_plain(y, radix=radix)) <= TOL
    assert k.LAUNCHES["fft_two_pass"] == len(lengths) * (2 * 2 + 3 + 3)
    assert k.LAUNCHES["fft_fused"] == k.LAUNCHES["rfft_fused"] == k.LAUNCHES["irfft_fused"] == 0
    assert k.LAUNCHES["fft_cluster"] == 0


LONG_ROWS = tuple(2 ** p for p in range(19, 25))


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2, 4])
def test_cuda_long_rows_match_plain_and_library(cuda, radix):
    """Rows of 2^18 < N <= 2^24 take the two-pass kernels at both radices
    (the instances n1, n2 = 1024, 2048, 4096 at 1024 threads): 2 launches a
    complex call and 3 a real one, nothing else, on every N = 2^19 ...
    2^24 and every kind, within 2e-5 of the plain version and of
    torch.fft."""
    g = torch.Generator(device=cuda).manual_seed(20 + radix)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=cuda),
                             torch.randn(*shape, generator=g, device=cuda))

    def launched(trips, fn, *args, **kw):
        before = dict(k.LAUNCHES)
        out = fn(*args, **kw)
        delta = {name: k.LAUNCHES[name] - before[name] for name in k.LAUNCHES}
        assert delta == {name: trips * int(name == "fft_two_pass") for name in k.LAUNCHES}, delta
        return out

    for n in LONG_ROWS:
        b = 3 if n <= 2 ** 21 else 2
        x = crandn(b, n)
        for inverse in (False, True):
            got = launched(2, k.fft_fused, x, radix=radix, inverse=inverse)
            assert _rel(got, k.fft_two_pass_plain(x, inverse=inverse)) <= TOL, (n, inverse)
            ref = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
            assert _rel(got, ref) <= TOL, (n, inverse)
        del x, got, ref
        r = torch.randn(b, n, generator=g, device=cuda)
        got = launched(3, k.rfft_fused, r, radix=radix)
        assert _rel(got, k.rfft_two_pass_plain(r)) <= TOL, n
        assert _rel(got, torch.fft.rfft(r)) <= TOL, n
        y = crandn(b, n // 2 + 1)
        y[:, 0].imag.zero_()  # a Hermitian spectrum for torch.fft (see the cluster's test)
        y[:, -1].imag.zero_()
        got = launched(3, k.irfft_fused, y, radix=radix)
        assert _rel(got, k.irfft_two_pass_plain(y)) <= TOL, n
        assert _rel(got, torch.fft.irfft(y)) <= TOL, n
        del r, y, got
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_xfft_long_rows_land_on_the_two_passes(cuda):
    """xfft on CUDA tensors with a transform dim past 2^18 plans the fused
    engines and launches the two passes (and fft2_columns where a frame has
    columns it serves), with no failover, fault or degrade event."""
    from repro_torch import obs

    g = torch.Generator(device=cuda).manual_seed(26)
    x = torch.complex(torch.randn(4, 2 ** 20, generator=g, device=cuda),
                      torch.randn(4, 2 ** 20, generator=g, device=cuda))
    wide = torch.complex(torch.randn(2, 8, 2 ** 19, generator=g, device=cuda),
                         torch.randn(2, 8, 2 ** 19, generator=g, device=cuda))
    tall = torch.randn(2 ** 19, 8, generator=g, device=cuda)
    calls = [("fft", lambda: xfft.fft(x), lambda: torch.fft.fft(x), False),
             ("rfft", lambda: xfft.rfft(x.real), lambda: torch.fft.rfft(x.real), False),
             ("irfft", lambda: xfft.irfft(xfft.rfft(x.real)), lambda: x.real, False),
             ("fft2", lambda: xfft.fft2(wide), lambda: torch.fft.fft2(wide), True),
             ("rfft2", lambda: xfft.rfft2(tall), lambda: torch.fft.rfft2(tall), False),
             ("irfft2", lambda: xfft.irfft2(xfft.rfft2(tall)), lambda: tall, False)]
    with obs.capture() as trace:
        for name, fn, ref, columns in calls:
            k.reset_launches()
            got = fn()
            assert k.LAUNCHES["fft_two_pass"] >= 2, (name, dict(k.LAUNCHES))
            assert (k.LAUNCHES["fft2_columns"] > 0) == columns, (name, dict(k.LAUNCHES))
            assert k.LAUNCHES["fft_cluster"] == 0, name
            assert _rel(got, ref()) <= (1e-4 if name.startswith("irfft") else TOL), name
    for event in ("resilience.failover", "resilience.fault", "plan.degrade"):
        assert not trace.select(event), (event, trace.select(event))
    plans = {e.fields.get("variant") for e in trace.select("plan.resolve")}
    assert plans and plans <= {"fused", "fused_r4"}, plans


@pytest.mark.cuda
def test_cuda_fft_cluster_matches_plain(cuda):
    """Rows over one block take the cluster kernel at radix 4: one launch
    per call of every kind, on every N = 2^15 ... 2^18, forward and
    inverse, batches 7 and 1 (and 131 at 2^16); also held to torch.fft."""
    g = torch.Generator(device=cuda).manual_seed(12)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=cuda),
                             torch.randn(*shape, generator=g, device=cuda))

    def one_launch(fn, *args, **kw):
        before = dict(k.LAUNCHES)
        out = fn(*args, **kw)
        delta = {name: k.LAUNCHES[name] - before[name] for name in k.LAUNCHES}
        assert delta == {name: int(name == "fft_cluster") for name in k.LAUNCHES}, delta
        return out

    for n in (2 ** p for p in range(15, 19)):
        # At 2^16 also a large odd batch: there the library comparison of
        # irfft below once failed on a raw, non-Hermitian spectrum.
        for batch in (7, 1, 131) if n == 2 ** 16 else (7, 1):
            x = crandn(batch, n)
            for inverse in (False, True):
                got = one_launch(k.fft_fused, x, radix=4, inverse=inverse)
                assert _rel(got, k.fft_cluster_plain(x, inverse=inverse)) <= TOL, (n, inverse)
                ref = torch.fft.ifft(x) if inverse else torch.fft.fft(x)
                assert _rel(got, ref) <= TOL, (n, inverse)
            r = torch.randn(batch, n, generator=g, device=cuda)
            got = one_launch(k.rfft_fused, r, radix=4)
            assert _rel(got, k.rfft_cluster_plain(r)) <= TOL, n
            assert _rel(got, torch.fft.rfft(r)) <= TOL, n
            y = crandn(batch, n // 2 + 1)
            got = one_launch(k.irfft_fused, y, radix=4)
            assert _rel(got, k.irfft_cluster_plain(y)) <= TOL, n
            # The kernel drops the imaginary parts of the DC and Nyquist bins,
            # as the reference does; torch.fft.irfft on the card leaves what
            # it does with them undefined, so it sees a Hermitian spectrum.
            y_h = y.clone()
            y_h[:, 0].imag.zero_()
            y_h[:, -1].imag.zero_()
            assert _rel(got, torch.fft.irfft(y_h)) <= TOL, n


@pytest.mark.cuda
def test_cuda_frame_register_passes_match_plain(cuda):
    """The radix-4 fft2_fused (forward and inverse) and rfft2_fused run the
    register-pass kernels on every frame the census admits (91 complex, 105
    real), three frames a call, each within 2e-5 of its plain version and of
    torch.fft; irfft2_fused on rfft2_fused's output matches its plain
    version and returns the input (1e-4, a round trip). Each call launches
    its kernel once and nothing else."""
    g = torch.Generator(device=cuda).manual_seed(20)

    def one_launch(name, fn, *args, **kw):
        before = dict(k.LAUNCHES)
        out = fn(*args, **kw)
        delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES}
        assert delta == {kn: int(kn == name) for kn in k.LAUNCHES}, delta
        return out

    frames = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)]
    complex_frames = [hw for hw in frames if k.fft2_fits_smem(*hw)]
    real_frames = [hw for hw in frames if k.rfft2_fits_smem(*hw)]
    assert (len(complex_frames), len(real_frames)) == (91, 105)
    for hw in complex_frames:
        x = torch.complex(torch.randn(3, *hw, generator=g, device=cuda),
                          torch.randn(3, *hw, generator=g, device=cuda))
        for inverse in (False, True):
            got = one_launch("fft2_fused", k.fft2_fused, x, radix=4, inverse=inverse)
            assert _rel(got, k.fft2_fused_plain(x, radix=4, inverse=inverse)) <= TOL, hw
            ref = torch.fft.ifft2(x) if inverse else torch.fft.fft2(x)
            assert _rel(got, ref) <= TOL, (hw, inverse)
    for hw in real_frames:
        r = torch.randn(3, *hw, generator=g, device=cuda)
        got = one_launch("rfft2_fused", k.rfft2_fused, r, radix=4)
        assert _rel(got, k.rfft2_fused_plain(r, radix=4)) <= TOL, hw
        assert _rel(got, torch.fft.rfft2(r)) <= TOL, hw
        back = one_launch("irfft2_fused", k.irfft2_fused, got, radix=4)
        assert _rel(back, k.irfft2_fused_plain(got, radix=4)) <= TOL, hw
        assert _rel(back, r) <= 1e-4, hw


@pytest.mark.cuda
def test_cuda_frame_register_passes_r2_match_plain(cuda):
    """The radix-2 fft2_fused (forward and inverse), rfft2_fused and
    irfft2_fused run the register-pass kernels at radix 2 on every frame
    the census admits (91 complex, 105 real), three frames a call, each
    within 2e-5 of its plain version and of torch.fft (irfft2_fused on the
    rfft2's spectrum, held to the frame too); one launch a call and nothing
    else."""
    g = torch.Generator(device=cuda).manual_seed(40)

    def one_launch(name, fn, *args, **kw):
        before = dict(k.LAUNCHES)
        out = fn(*args, **kw)
        delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES}
        assert delta == {kn: int(kn == name) for kn in k.LAUNCHES}, delta
        return out

    frames = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)]
    complex_frames = [hw for hw in frames if k.fft2_fits_smem(*hw)]
    real_frames = [hw for hw in frames if k.rfft2_fits_smem(*hw)]
    assert (len(complex_frames), len(real_frames)) == (91, 105)
    for hw in complex_frames:
        x = torch.complex(torch.randn(3, *hw, generator=g, device=cuda),
                          torch.randn(3, *hw, generator=g, device=cuda))
        for inverse in (False, True):
            got = one_launch("fft2_fused", k.fft2_fused, x, radix=2, inverse=inverse)
            assert _rel(got, k.fft2_fused_plain(x, radix=2, inverse=inverse)) <= TOL, hw
            ref = torch.fft.ifft2(x) if inverse else torch.fft.fft2(x)
            assert _rel(got, ref) <= TOL, (hw, inverse)
    for hw in real_frames:
        r = torch.randn(3, *hw, generator=g, device=cuda)
        got = one_launch("rfft2_fused", k.rfft2_fused, r, radix=2)
        assert _rel(got, k.rfft2_fused_plain(r, radix=2)) <= TOL, hw
        assert _rel(got, torch.fft.rfft2(r)) <= TOL, hw
        back = one_launch("irfft2_fused", k.irfft2_fused, got, radix=2)
        assert _rel(back, k.irfft2_fused_plain(got, radix=2)) <= TOL, hw
        assert _rel(back, r) <= 1e-4, hw


def _hermitian_edges(y, cols):
    """y with the imaginary parts the inverse drops removed: of a row's DC
    and Nyquist bins, or (``cols``) the anti-Hermitian parts of a frame's DC
    and Nyquist columns. torch.fft on the card leaves what it does with them
    undefined, so it sees this projection."""
    y = y.clone()
    for c in (0, -1):
        if cols:
            a = y[..., c]
            mirror = (-torch.arange(a.shape[-1], device=y.device)) % a.shape[-1]
            y[..., c] = 0.5 * (a + a.conj()[..., mirror])
        else:
            y[..., c].imag.zero_()
    return y


@pytest.mark.cuda
def test_cuda_irfft_register_passes_match_plain(cuda):
    """The radix-4 irfft_fused on every one-block row (n = 2 ... 2^14,
    batches 7 and 1) and irfft2_fused at both radices on every admitted
    frame (105, three a call) run the register-pass kernels on half spectra
    that are not Hermitian: one launch a call and nothing else, within 2e-5
    of the twins, and of torch.fft.irfft / irfft2 on the projected input."""
    g = torch.Generator(device=cuda).manual_seed(21)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=cuda),
                             torch.randn(*shape, generator=g, device=cuda))

    def one_launch(name, fn, *args, **kw):
        before = dict(k.LAUNCHES)
        out = fn(*args, **kw)
        delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES}
        assert delta == {kn: int(kn == name) for kn in k.LAUNCHES}, delta
        return out

    for n in (2 ** p for p in range(1, 15)):
        for batch in (7, 1):
            y = crandn(batch, n // 2 + 1)
            got = one_launch("irfft_fused", k.irfft_fused, y, radix=4)
            assert _rel(got, k.irfft_fused_plain(y, radix=4)) <= TOL, n
            assert _rel(got, torch.fft.irfft(_hermitian_edges(y, False))) <= TOL, n
    frames = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)]
    real_frames = [hw for hw in frames if k.rfft2_fits_smem(*hw)]
    assert len(real_frames) == 105
    for h, w in real_frames:
        y = crandn(3, h, w // 2 + 1)
        ref = torch.fft.irfft2(_hermitian_edges(y, True))
        for radix in (4, 2):
            got = one_launch("irfft2_fused", k.irfft2_fused, y, radix=radix)
            assert _rel(got, k.irfft2_fused_plain(y, radix=radix)) <= TOL, (h, w, radix)
            assert _rel(got, ref) <= TOL, (h, w, radix)


@pytest.mark.cuda
def test_cuda_radix2_register_passes_match_plain(cuda):
    """The radix-2 fft_fused (forward and inverse), rfft_fused and
    irfft_fused (on half spectra that are not Hermitian) on every one-block
    row, n = 2 ... 2^14, run their register-pass kernels: one launch a call,
    within 2e-5 of the plain versions, on a batch of twice the row tile less
    one, so that the last tile is masked wherever a tile holds more than one
    row."""
    g = torch.Generator(device=cuda).manual_seed(39)
    for n in (2 ** p for p in range(1, 15)):
        for real, inverse in ((False, False), (True, False), (True, True)):
            tile = k.pick_row_tile(1 << 30, n // 2 if real else n)
            batch = 2 * tile - 1 if tile > 1 else 3
            before = dict(k.LAUNCHES)
            if inverse:
                y = torch.complex(torch.randn(batch, n // 2 + 1, generator=g, device=cuda),
                                  torch.randn(batch, n // 2 + 1, generator=g, device=cuda))
                got = [(k.irfft_fused(y, radix=2), k.irfft_fused_plain(y, radix=2))]
            elif real:
                x = torch.randn(batch, n, generator=g, device=cuda)
                got = [(k.rfft_fused(x, radix=2), k.rfft_fused_plain(x, radix=2))]
            else:
                x = torch.complex(torch.randn(batch, n, generator=g, device=cuda),
                                  torch.randn(batch, n, generator=g, device=cuda))
                got = [(k.fft_fused(x, radix=2, inverse=inv),
                        k.fft_fused_plain(x, radix=2, inverse=inv)) for inv in (False, True)]
            name = "irfft_fused" if inverse else "rfft_fused" if real else "fft_fused"
            delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES}
            assert delta == {kn: len(got) * int(kn == name) for kn in k.LAUNCHES}, delta
            for kernel, plain in got:
                assert _rel(kernel, plain) <= TOL, (name, n, batch)


@pytest.mark.cuda
def test_cuda_every_cluster_instance_has_an_active_cluster(cuda):
    """cudaOccupancyMaxActiveClusters is at least 1 for every instance the
    census launches."""
    for p in range(14, 19):
        for kind in k.CLUSTER_KINDS:
            if p == 14 and kind == "fft":
                continue  # a complex row of 2^14 fits one block
            assert k.cluster_occupancy(2 ** p, kind) >= 1, (p, kind)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_strided_tensor(cuda):
    x = torch.zeros(8, 16, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        k.fft_fused(x.t())


@pytest.mark.cuda
def test_cuda_xfft_plans_onto_the_kernels(cuda):
    """A front-door call on the card launches the kernel its plan names and
    agrees with the plain version of the same plan."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 64, 64, generator=g, device=cuda)
    k.reset_launches()
    with xfft.config(variant="fused_r4"):
        y = xfft.fft2(x)
        half = xfft.rfft2(x)
        back = xfft.irfft2(half)
    assert k.LAUNCHES["fft2_fused"] == 1
    assert k.LAUNCHES["rfft2_fused"] == 1 and k.LAUNCHES["irfft2_fused"] == 1
    assert k.LAUNCHES["fft_fused"] == 0
    with xfft.config(variant="fused_r4"):
        ref = xfft.fft2(x.cpu())
    assert _rel(y.cpu(), ref) <= TOL
    assert float((back - x).abs().max()) <= 1e-4 * float(x.abs().max())
    big = torch.randn(2, 256, 256, generator=g, device=cuda)  # over one block
    k.reset_launches()
    back = xfft.irfft2(xfft.rfft2(big))
    assert k.LAUNCHES["rfft_fused"] == 1 and k.LAUNCHES["irfft_fused"] == 1
    assert k.LAUNCHES["fft2_columns"] == 2 and k.LAUNCHES["fft_fused"] == 0
    assert k.LAUNCHES["rfft2_fused"] == 0
    assert float((back - big).abs().max()) <= 1e-4 * float(big.abs().max())


@pytest.mark.cuda
def test_cuda_tensor_never_plans_onto_plain_code(cuda):
    """Tiny transforms plan onto a kernel; rows longer than the fused
    envelope (2^24) raise unless the caller scopes the plain schedules."""
    k.reset_launches()
    xfft.fft(torch.ones(1, 4, dtype=torch.complex64, device=cuda))
    assert k.LAUNCHES["fft_fused"] == 1
    long = torch.ones(1, 2 ** 25, dtype=torch.complex64, device=cuda)
    with pytest.raises(NotImplementedError, match="2\\^24"):
        xfft.fft(long)
    with xfft.config(backend="torch"):
        assert float(xfft.fft(long)[:, 0].real.min()) == 2.0 ** 25


@pytest.mark.cuda
def test_cuda_butterfly_stage_matches_plain_and_fft_staged_launches_each_stage(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    k.reset_launches()
    stages = 0
    for n in (2, 64, 2048):
        re = torch.randn(7, n, generator=g, device=cuda)
        im = torch.randn(7, n, generator=g, device=cuda)
        for stage in range(int(math.log2(n))):
            got = bf.butterfly_stage(re, im, stage=stage)
            ref = bf.butterfly_stage_plain(re, im, stage=stage)
            assert _rel(got[0], ref[0]) <= TOL and _rel(got[1], ref[1]) <= TOL
            stages += 1
    assert k.LAUNCHES["butterfly_stage"] == stages
    x = torch.complex(torch.randn(5, 1024, generator=g, device=cuda),
                      torch.randn(5, 1024, generator=g, device=cuda))
    k.reset_launches()
    y = fft_staged(x)
    assert k.LAUNCHES["butterfly_stage"] == 10
    assert _rel(y, torch.fft.fft(x)) <= TOL
    with pytest.raises(ValueError):
        bf.butterfly_stage(re.t(), im.t(), stage=0)  # strided planes


# (bh, sq, sk, d, dv, causal, window, block_q, block_k)
FLASH_CASES = [
    (2, 64, 64, 32, 32, True, None, 16, 16),
    (3, 128, 128, 16, 16, True, 32, 32, 32),
    (1, 48, 96, 8, 8, False, None, 16, 32),
    (2, 100, 100, 16, 16, True, None, 32, 32),
    (1, 256, 256, 64, 64, True, None, 64, 128),
    (2, 80, 80, 24, 16, True, 40, 16, 32),
    (2, 200, 130, 192, 128, True, 70, 256, 512),  # MLA widths, window, ragged
    (1, 129, 300, 256, 256, False, None, 256, 512),  # the head-size limit
    (2, 40, 12, 8, 8, False, 6, 16, 8),  # rows 17.. see no key
    (2, 150, 170, 100, 72, True, None, 64, 64),  # D, Dv not multiples of 8: zero padding
    (1, 70, 90, 37, 19, False, 50, 32, 64),  # D, Dv odd: 4-byte copies, window
    (2, 100, 77, 64, 256, True, None, 256, 512),  # Dv 256: 32-key tiles, ragged Sk
    (2, 300, 333, 128, 128, True, 100, 128, 128),  # Sk not a multiple of 64, window
    (300, 70, 70, 32, 32, True, None, 64, 64),  # BH over 132 SMs: blocks queue
    # whisper-medium (16 heads of 64, batch 4, 1500 encoder frames, blocks
    # 512 / min(1024, Sk)): the encoder's self-attention, a 16-token
    # prefill's cross-attention and a decode step's
    (64, 1500, 1500, 64, 64, False, None, 512, 1024),
    (64, 16, 1500, 64, 64, False, None, 512, 1024),
    (64, 1, 1500, 64, 64, False, None, 512, 1024),
]
WHISPER_FLASH_CASES = FLASH_CASES[-3:]


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    k.reset_launches()
    for bh, sq, sk, d, dv, causal, window, bq, bk in FLASH_CASES:
        q = torch.randn(bh, sq, d, generator=g, device=cuda)
        kk = torch.randn(bh, sk, d, generator=g, device=cuda)
        v = torch.randn(bh, sk, dv, generator=g, device=cuda)
        opts = dict(causal=causal, window=window, block_q=bq, block_k=bk)
        got = fa.flash_attention_fwd(q, kk, v, **opts)
        ref = fa.flash_attention_plain(q, kk, v, **opts)
        assert got.shape == (bh, sq, dv)
        assert _rel(got, ref) <= TOL, (bh, sq, sk, d, dv, causal, window)
    assert k.LAUNCHES["flash_attention_fwd"] == len(FLASH_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WHISPER_FLASH_CASES, ids=str)
def test_cuda_flash_attention_at_whisper_shapes_matches_float64(cuda, case):
    """D 64 against 1500 keys (not a multiple of the kernel's 32-key tile,
    nor of the reference's 1024-key block): the kernel and its plain version
    each within 2e-5 of ``mha_reference`` in float64, one launch. Its output
    accumulator chained through the tensor core over all 188 key slices
    drifted to 1.8e-5 of float64 here; it now adds each slice's sum on the
    CUDA cores."""
    bh, sq, sk, d, dv, causal, window, bq, bk = case
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn(bh, sq, d, generator=g, device=cuda)
    kk = torch.randn(bh, sk, d, generator=g, device=cuda)
    v = torch.randn(bh, sk, dv, generator=g, device=cuda)
    opts = dict(causal=causal, window=window, block_q=bq, block_k=bk)
    k.reset_launches()
    got = fa.flash_attention_fwd(q, kk, v, **opts)
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention_fwd"] == 1 and got.shape == (bh, sq, dv)
    exact = fa.mha_reference(q.double(), kk.double(), v.double(), causal=causal, window=window)
    assert _rel(got.double(), exact) <= TOL
    assert _rel(fa.flash_attention_plain(q, kk, v, **opts).double(), exact) <= TOL


@pytest.mark.cuda
def test_cuda_flash_attention_raises_on_what_the_kernel_refuses(cuda):
    q = torch.zeros(1, 8, 320, device=cuda)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 128, device=cuda)
    out = torch.empty_like(q)
    k.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):  # nv = 1 covers only dv <= 8
        launch("repro_flash_attention_fwd", "flash_attention_fwd", q, q.data_ptr(),
               q.data_ptr(), q.data_ptr(), out.data_ptr(), None, 1, 8, 8, 128, 128, 1, 0, 0,
               0, 1.0, 8, 1, fa.THREADS, fa.flash_smem_bytes(128, 128))
    assert k.LAUNCHES["flash_attention_fwd"] == 0


@pytest.mark.cuda
def test_cuda_flash_attention_takes_rows_off_16_byte_alignment(cuda):
    """Tensors that start 4 bytes past an aligned address take the kernel's
    4-byte copies; the result is the same function."""
    g = torch.Generator(device=cuda).manual_seed(8)

    def shifted(*shape):
        return torch.randn(math.prod(shape) + 1, generator=g, device=cuda)[1:].view(*shape)

    q, kk, v = shifted(3, 96, 64), shifted(3, 120, 64), shifted(3, 120, 32)
    assert q.data_ptr() % 16 != 0
    opts = dict(causal=True, window=50, block_q=64, block_k=64)
    got = fa.flash_attention_fwd(q, kk, v, **opts)
    assert _rel(got, fa.flash_attention_plain(q, kk, v, **opts)) <= TOL


@pytest.mark.cuda
def test_cuda_flash_attention_shares_an_sm_between_two_blocks_at_head_128(cuda):
    assert fa.flash_blocks_per_sm(128, 128, cuda.index or 0) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [(3, 64, 128), (2, 32, 1024), (1, 16, 2048), (1, 8, 36),
                                   (1, 8, 4096), (8, 16, 2048)])
def test_cuda_slstm_scan_matches_plain(cuda, b, l, d):
    """The cooperative grid against the plain step loop; D 4096 takes the
    global route (wr's slice read every step), the others keep it in
    shared memory; (8, 16, 2048) has more of h a step than the threads'
    fixed load slots hold."""
    rng = np.random.default_rng(d)
    p = {"wx": rng.standard_normal((d, 4 * d)) / math.sqrt(d),
         "wr": rng.standard_normal((4, d // 4, d)) * 0.25,
         "bias": rng.standard_normal(4 * d) * 0.1}
    w = slstm_weights_from_jax(p, device=cuda)
    x = torch.from_numpy(rng.standard_normal((b, l, d)) * 0.5).float().to(cuda)
    xg = x @ w["wx"]
    z = torch.zeros(b, d, device=cuda)
    m0 = torch.full((b, d), float("-inf"), device=cuda)
    k.reset_launches()
    hs, state = slstm_scan(xg, w["wr"], w["bias"], z, z, z, m0, chunk=l)
    assert k.LAUNCHES["slstm_scan"] == 1
    ref_hs, ref_state = slstm_scan_plain(xg, w["wr"], w["bias"], z, z, z, m0)
    assert not torch.isnan(hs).any()
    assert _rel(hs, ref_hs) <= TOL_SLSTM
    for got, ref in zip(state, ref_state):
        assert _rel(got, ref) <= TOL_SLSTM


@pytest.mark.cuda
def test_cuda_slstm_scan_refuses_a_grid_the_card_cannot_hold(cuda):
    """4096 CTAs of one unit each (48 KB of shared memory a CTA) cannot all
    be resident: the cooperative launch is refused
    (cudaErrorCooperativeLaunchTooLarge, 720, or cudaErrorInvalidConfiguration,
    9; the entry's own check of the geometry would give 1), it does not hang,
    and no launch is counted."""
    b, l, d = 1, 2, 4096
    xg = torch.zeros(b, l, 4 * d, device=cuda)
    wr = torch.zeros(4, d // 4, d, device=cuda)
    bias = torch.zeros(4 * d, device=cuda)
    z = torch.zeros(b, d, device=cuda)
    hs = torch.empty(b, l, d, device=cuda)
    final = [torch.empty(b, d, device=cuda) for _ in range(4)]
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    grid = slstm_grid(d, b, d)  # one unit a CTA
    assert grid.ctas == d
    k.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error (9|720) "):
        launch("repro_slstm_scan", "slstm_scan", xg, xg.data_ptr(), wr.data_ptr(),
               bias.data_ptr(), *(z.data_ptr() for _ in range(4)), hs.data_ptr(),
               *(x.data_ptr() for x in final), *(None,) * 4, count.data_ptr(), b, l, d,
               grid.ctas, grid.units, grid.threads, grid.rows, ROUTES.index(grid.route),
               grid.smem_bytes)
    torch.cuda.synchronize()
    assert k.LAUNCHES["slstm_scan"] == 0


def _slstm_operands(cuda, b, l, d, seed, wr_std):
    """Seeded (xg, wr, bias, c0, n0, h0, m0) on the card, m0 = -inf, and
    cotangents of hs and the final (c, n, h, m)."""
    rng = np.random.default_rng(seed)
    p = {"wx": rng.standard_normal((d, 4 * d)) / math.sqrt(d),
         "wr": rng.standard_normal((4, d // 4, d)) * wr_std,
         "bias": rng.standard_normal(4 * d) * 0.1}
    w = slstm_weights_from_jax(p, device=cuda)
    x = torch.from_numpy(rng.standard_normal((b, l, d)) * 0.5).float().to(cuda)
    z = torch.zeros(b, d, device=cuda)
    ins = (x @ w["wx"], w["wr"], w["bias"], z, z.clone(), z.clone(),
           torch.full((b, d), float("-inf"), device=cuda))
    cots = [torch.from_numpy(rng.standard_normal(shape)).float().to(cuda)
            for shape in ((b, l, d), *((b, d),) * 4)]
    return ins, cots


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [(3, 64, 128), (2, 32, 1024), (4, 16, 2048), (1, 8, 36),
                                   (1, 8, 4096), (8, 16, 1024)])
def test_cuda_slstm_scan_bwd_matches_plain(cuda, b, l, d):
    """The saving forward's gates and states against the plain forward's,
    and the reverse scan on them against its plain version: D 2048 keeps
    its rows of wr in float32, D 4096 reads them every step (the global
    route), D 36 has CTAs whose units straddle two heads. Weights at the
    model's stacked init scale (0.5 / sqrt(12)), which keeps the backward
    from amplifying a rounding over L steps."""
    ins, cots = _slstm_operands(cuda, b, l, d, seed=d + b, wr_std=0.5 / math.sqrt(12))
    k.reset_launches()
    hs, final, saved = slstm_scan_saving(*ins)
    dxg, grads = slstm_scan_bwd(saved, ins[1], ins[3], ins[4], ins[6], cots[0], tuple(cots[1:]))
    torch.cuda.synchronize()
    assert {n: c for n, c in k.LAUNCHES.items() if c} == {"slstm_scan": 1, "slstm_scan_bwd": 1}
    ref_hs, _, ref_saved = slstm_scan_saving(*(x.cpu() for x in ins))
    assert _rel(hs, ref_hs.to(cuda)) <= TOL_SLSTM
    for got, ref in zip(saved, ref_saved):
        assert _rel(got, ref.to(cuda)) <= TOL_SLSTM
    ref_dxg, ref_grads = slstm_scan_bwd_plain(saved, ins[1], ins[3], ins[4], ins[6], cots[0],
                                              tuple(cots[1:]))
    assert bool(torch.isfinite(dxg).all())
    assert _rel(dxg, ref_dxg) <= TOL_SLSTM
    for got, ref in zip(grads[2:3], ref_grads[2:3]):  # dc0, dn0, dm0 are 0 at m0 = -inf
        assert _rel(got, ref) <= TOL_SLSTM
    for got in (grads[0], grads[1], grads[3]):
        assert not got.any()


@pytest.mark.cuda
def test_cuda_slstm_scan_under_grad_runs_the_function_and_matches_the_cpu(cuda):
    """Under grad slstm_scan goes through SlstmScan: one forward and one
    backward launch, every input's gradient within 1e-4 of the CPU's
    autograd of the plain step loop."""
    b, l, d = 2, 24, 128
    ins, cots = _slstm_operands(cuda, b, l, d, seed=7, wr_std=0.5 / math.sqrt(12))
    ins = tuple(x.clone().requires_grad_() for x in ins[:3]) + ins[3:]
    k.reset_launches()
    hs, final = slstm_scan(*ins, chunk=l)
    assert type(hs.grad_fn).__name__ == "SlstmScanBackward"
    grads = torch.autograd.grad((hs, *final), ins[:3], cots)
    torch.cuda.synchronize()
    assert {n: c for n, c in k.LAUNCHES.items() if c} == {"slstm_scan": 1, "slstm_scan_bwd": 1}
    cpu = tuple(x.detach().cpu().requires_grad_(i < 3) for i, x in enumerate(ins))
    ref_hs, ref_final = slstm_scan_plain(*cpu)
    ref = torch.autograd.grad((ref_hs, *ref_final), cpu[:3], [c.cpu() for c in cots])
    for got, want in zip(grads, ref):
        assert _rel(got.cpu(), want) <= TOL_SLSTM


def _launched(before, *names):
    """Launches of ``names`` since the ``before`` snapshot of the counts."""
    return {n: k.LAUNCHES[n] - before[n] for n in names}


def _imaging_frames(cuda, *shape, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(*shape, generator=g)
    return x, x.to(cuda)


@pytest.mark.cuda
def test_cuda_kspace_matches_plain(cuda):
    from repro_torch.imaging import image_to_kspace, kspace_to_image

    x, xd = _imaging_frames(cuda, 4, 2, 64, 64)
    z, zd = torch.complex(x, x.flip(-1)), torch.complex(xd, xd.flip(-1))
    before = dict(k.LAUNCHES)
    got = image_to_kspace(zd)
    back = kspace_to_image(got)
    assert _launched(before, "fft2_fused")["fft2_fused"] == 2
    assert _rel(got.cpu(), image_to_kspace(z)) <= TOL
    assert _rel(back.cpu(), z) <= 1e-4


@pytest.mark.cuda
def test_cuda_psd_matches_plain(cuda):
    from repro_torch.imaging import fft2_psd, psd_decompose

    x, xd = _imaging_frames(cuda, 3, 64, 128, seed=1)
    before = dict(k.LAUNCHES)
    periodic, smooth = psd_decompose(xd)
    spec = fft2_psd(xd)
    n = _launched(before, "rfft_fused", "rfft2_fused", "irfft2_fused")
    assert n["rfft_fused"] >= 4 and n["rfft2_fused"] == 1 and n["irfft2_fused"] == 1
    p_ref, s_ref = psd_decompose(x)
    assert _rel(periodic.cpu(), p_ref) <= TOL and _rel(smooth.cpu(), s_ref) <= TOL
    assert _rel(spec.cpu(), fft2_psd(x)) <= TOL


@pytest.mark.cuda
def test_cuda_registration_matches_plain(cuda):
    from repro_torch.imaging import apply_shift, band_limited_frame, register_phase_correlation

    ref = torch.from_numpy(band_limited_frame(64, seed=3)).expand(4, 64, 64).contiguous()
    shifts = torch.tensor([[5.0, 9.0], [-7.0, 3.0], [2.5, -1.25], [0.25, 0.75]])
    before = dict(k.LAUNCHES)
    mov = apply_shift(ref.to(cuda), shifts.to(cuda))
    got = register_phase_correlation(ref.to(cuda), mov, upsample_factor=10)
    n = _launched(before, "rfft2_fused", "irfft2_fused")
    assert n["rfft2_fused"] == 3 and n["irfft2_fused"] == 2
    assert _rel(mov.cpu(), apply_shift(ref, shifts)) <= TOL
    assert float((got.cpu() + shifts).abs().max()) <= 1 / 10 + 0.05
    cref = torch.complex(ref[:2], ref[:2].flip(-1)).to(cuda)
    before = dict(k.LAUNCHES)
    got = register_phase_correlation(cref, apply_shift(cref, shifts[:2].to(cuda)))
    assert _launched(before, "fft2_fused")["fft2_fused"] == 5
    assert torch.equal(got.cpu(), -shifts[:2])


@pytest.mark.cuda
def test_cuda_tiled_matches_plain(cuda):
    from repro_torch.imaging import fftconv2, matched_filter2, oaconvolve2
    from repro_torch.plan import resolve_call

    x, xd = _imaging_frames(cuda, 2, 300, 200, seed=2)
    kern, kernd = _imaging_frames(cuda, 9, 7, seed=3)
    plan = resolve_call("oaconv2d", (300, 200, 9, 7), cuda, dtype="float32")
    assert k.rfft2_fits_smem(*plan.tile)
    before = dict(k.LAUNCHES)
    got = oaconvolve2(xd, kernd)
    n = _launched(before, "rfft2_fused", "irfft2_fused", "rfft_fused", "fft_fused")
    assert n["rfft2_fused"] == 2 and n["irfft2_fused"] == 1
    assert n["rfft_fused"] == 0 and n["fft_fused"] == 0  # the tiles fit one block
    want = fftconv2(x, kern, mode="same")
    assert _rel(got.cpu(), want) <= 1e-4
    assert _rel(got.cpu(), oaconvolve2(x, kern, tile=plan.tile)) <= TOL
    corr = matched_filter2(xd, kernd, tile=plan.tile)
    assert _rel(corr.cpu(), matched_filter2(x, kern, tile=plan.tile)) <= TOL


@pytest.mark.cuda
def test_cuda_spectral_matches_plain(cuda):
    from repro_torch.core import spectral

    x, xd = _imaging_frames(cuda, 2, 256, 64, seed=4)
    a, ad = _imaging_frames(cuda, 2, 8192, seed=5)
    before = dict(k.LAUNCHES)
    mix = spectral.fourier_mixing(xd)
    mix_r = spectral.fourier_mixing(xd, variant="rfft")
    conv = spectral.fftconv(xd, xd[0])
    mel = spectral.log_mel(ad)
    n = _launched(before, "fft2_fused", "rfft_fused", "fft_fused", "irfft_fused")
    assert all(v >= 1 for v in n.values()), n
    assert _rel(mix.cpu(), spectral.fourier_mixing(x)) <= TOL
    assert _rel(mix_r.cpu(), spectral.fourier_mixing(x)) <= TOL
    assert _rel(conv.cpu(), spectral.fftconv(x, x[0])) <= TOL
    assert float((mel.cpu() - spectral.log_mel(a)).abs().max()) <= 1e-4


def _mri_fixture(coils=8, n=256):
    from repro_torch import mri

    return torch.from_numpy(mri.shepp_logan(n)), torch.from_numpy(mri.birdcage_maps(coils, n))


@pytest.mark.cuda
def test_cuda_mri_sense_and_cg_match_plain(cuda):
    """256x256 coil stacks are over one block: every centered transform is
    the composed route, fft_fused rows and one fft2_columns launch, and a
    CG iteration is two transforms; the CG result stays within 1e-4 of the
    CPU's plain schedules after 4 iterations."""
    from repro_torch import mri

    ph, sm = _mri_fixture()
    mask = mri.uniform_mask((256, 256), 4, calib=24)
    before = dict(k.LAUNCHES)
    kd = mri.sense_forward(ph.numpy(), sm.numpy(), mask)    # numpy goes to the card
    assert kd.device.type == "cuda"
    x = mri.recon_cg_sense(kd, sm.to(cuda), mask, iters=4)
    n = _launched(before, "fft_fused", "fft2_columns", "fft2_fused")
    assert n == {"fft_fused": 1 + 1 + 2 * 4, "fft2_columns": 1 + 1 + 2 * 4, "fft2_fused": 0}
    kc = mri.sense_forward(ph, sm, mask)
    assert _rel(kd.cpu(), kc) <= TOL
    assert _rel(x.cpu(), mri.recon_cg_sense(kc, sm, mask, iters=4)) <= 1e-4


@pytest.mark.cuda
def test_cuda_mri_double_plans_reference_x64(cuda):
    from repro_torch import mri
    from repro_torch.plan import resolve_call

    _, sm = _mri_fixture()
    g = torch.Generator(device=cuda).manual_seed(7)
    u = torch.randn(256, 256, dtype=torch.complex128, generator=g, device=cuda)
    v = torch.randn(8, 256, 256, dtype=torch.complex128, generator=g, device=cuda)
    smaps = sm.to(cuda, torch.complex128)
    mask = mri.uniform_mask((256, 256), 4, calib=24)
    before = dict(k.LAUNCHES)
    with xfft.config(precision="double"):
        assert resolve_call("fft2d", (8, 256, 256), cuda).variant == "reference_x64"
        au = mri.sense_forward(u, smaps, mask)
        ahv = mri.sense_adjoint(v, smaps, mask)
    assert k.LAUNCHES == before                              # no single-precision kernel
    assert au.dtype == ahv.dtype == torch.complex128
    lhs, rhs = torch.vdot(au.flatten(), v.flatten()), torch.vdot(u.flatten(), ahv.flatten())
    assert float((lhs - rhs).abs()) <= 1e-12 * float(lhs.abs())


@pytest.mark.cuda
def test_cuda_moco_matches_plain_and_finds_the_shift(cuda):
    from repro_torch import mri

    ph, sm = _mri_fixture()
    shots = mri.shot_masks(mri.uniform_mask((256, 256), 4, calib=24), 2)
    shifts = torch.tensor([[0.0, 0.0], [3.0, -2.0]])
    before = dict(k.LAUNCHES)
    km = mri.moco_forward(ph.to(cuda), sm.to(cuda), shots, shifts.to(cuda))
    est = mri.estimate_shot_shifts(km, sm.to(cuda), shots)
    n = _launched(before, "fft_fused", "rfft_fused", "irfft_fused", "fft2_fused")
    assert n["rfft_fused"] >= 1 and n["irfft_fused"] >= 1 and n["fft2_fused"] == 0
    kc = mri.moco_forward(ph, sm, shots, shifts)
    assert _rel(km.cpu(), kc) <= TOL
    assert float((est.cpu() - shifts).abs().max()) <= 0.5
    x = mri.recon_cg_moco(km, sm.to(cuda), shots, shifts.to(cuda), iters=3)
    assert _rel(x.cpu(), mri.recon_cg_moco(kc, sm, shots, shifts, iters=3)) <= 1e-4


def _radices(monkeypatch, name):
    """Record the radix of every call of the fused wrapper ``name`` made
    through ``repro_torch.kernels.ops``."""
    from repro_torch.kernels import ops

    seen, fn = [], getattr(ops, name)

    def tapped(*args, radix=2, **kw):
        seen.append(radix)
        return fn(*args, radix=radix, **kw)

    monkeypatch.setattr(ops, name, tapped)
    return seen


@pytest.fixture
def clean_breaker():
    from repro_torch import resilience

    resilience.reset()
    yield resilience
    resilience.reset()
    resilience.configure(cooldown_s=30.0, clock=time.monotonic)


class _Clock:
    """A settable clock: ``clock.now += 31.0`` drives a cooldown."""

    now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.cuda
def test_cuda_failover_fused_r4_to_fused(cuda, clean_breaker, monkeypatch):
    """An injected engine.apply error on fused_r4 for a (512, 128, 128)
    fft2: the ladder lands on fused, a radix-2 fft2_fused, within 2e-5 of
    torch.fft; the breaker opens, the next resolve reports quarantined
    and the cache keeps fused_r4; after the cooldown a half-open probe
    runs fused_r4 and closes the breaker."""
    from repro_torch import obs
    from repro_torch.plan import PlanCache, resolve_call
    from repro_torch.resilience import FaultPlan, FaultSpec

    from repro_torch.plan import cache as cache_mod

    clock = _Clock()
    clean_breaker.configure(cooldown_s=30.0, clock=clock)
    x = torch.randn(512, 128, 128, dtype=torch.complex64, device=cuda)
    want = torch.fft.fft2(x)
    cache = PlanCache()
    monkeypatch.setattr(cache_mod, "_DEFAULT", cache)
    first = resolve_call("fft2d", x.shape, cuda)
    assert first.variant == "fused_r4"
    radices = _radices(monkeypatch, "fft2_fused")
    fault = FaultPlan(FaultSpec("engine.apply", match={"engine": "fused_r4"}, times=1))
    with obs.capture() as trace, xfft.config(faults=fault):
        got = xfft.fft2(x)
        assert radices == [2] and _rel(got, want) <= TOL
        again = xfft.fft2(x)
        assert radices == [2, 2] and _rel(again, want) <= TOL
        clock.now += 31.0
        probe = xfft.fft2(x)
        assert radices == [2, 2, 4] and _rel(probe, want) <= TOL
    (failover,) = trace.select("resilience.failover")
    assert (failover["engine"], failover["next"], failover["quarantined"]) == (
        "fused_r4", "fused", True)
    assert [e["outcome"] for e in trace.select("plan.resolve")] == ["hit", "quarantined", "hit"]
    assert [e["state"] for e in trace.select("resilience.breaker")] == [
        "open", "half_open", "closed"]
    assert cache.get(first.key).variant == "fused_r4"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft2", "rfft2", "irfft2"])
def test_cuda_census_seam_runs_the_composed_route(cuda, name):
    """A vmem fault at kernel.fused on (512, 128, 128): one 1D kernel pass
    on the rows and one fft2_columns launch instead of one whole-frame
    launch, a kernel.failover event, and the result within 2e-5 of
    torch.fft."""
    from repro_torch import obs
    from repro_torch.resilience import FaultPlan, FaultSpec

    real = torch.randn(512, 128, 128, device=cuda)
    x = torch.fft.rfft2(real) if name == "irfft2" else (
        real if name == "rfft2" else real.to(torch.complex64))
    before = dict(k.LAUNCHES)
    with obs.capture() as trace, xfft.config(faults=FaultPlan(FaultSpec("kernel.fused",
                                                                        mode="vmem"))):
        got = getattr(xfft, name)(x)
    n = {kn: c - before[kn] for kn, c in k.LAUNCHES.items() if c != before[kn]}
    row = {"fft2": "fft_fused", "rfft2": "rfft_fused", "irfft2": "irfft_fused"}[name]
    assert n == {row: 1, "fft2_columns": 1}, n
    (event,) = trace.select("kernel.failover")
    assert event["shape"] == (128, 128) and event["frames"] == 512
    assert _rel(got, getattr(torch.fft, name)(x)) <= TOL


@pytest.mark.cuda
def test_cuda_measure_times_the_kernels_with_cuda_events(cuda):
    from repro_torch.plan import PlanCache, plan_fft

    timings = {}
    plan = plan_fft("fft1d", (8192, 2048), cuda, mode="measure", cache=PlanCache(),
                    timings_out=timings)
    assert plan.mode == "measure" and plan.measured_us > 0
    assert set(timings) == {"fused", "fused_r4"} and plan.measured_us == min(timings.values())
    double = {}
    plan_fft("fft2d", (16, 256, 256), cuda, mode="measure", cache=PlanCache(),
             precision="double", timings_out=double)
    assert set(double) == {"reference_x64"}


@pytest.mark.cuda
def test_cuda_measure_inside_graph_capture_degrades(cuda):
    from repro_torch import obs
    from repro_torch.plan import PlanCache, resolve_call

    x = torch.ones(16, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with obs.capture() as trace:
        with torch.cuda.graph(graph):
            y = x * 2.0
            plan = resolve_call("fft2d", (64, 128, 128), cuda, cache=PlanCache(),
                                mode="measure")
    graph.replay()
    assert float(y.sum()) == 32.0
    assert plan.mode == "estimate" and plan.degrade_reason == "trace_not_clean"
    assert trace.select("plan.measure") == []
    assert [e["reason"] for e in trace.select("plan.degrade")] == ["trace_not_clean"]


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2, 4])
def test_cuda_fft2_columns_matches_plain(cuda, radix):
    """fft2_columns against its plain version on panels of 64, 16, 8 and 4
    columns, partial last panels and one-pass columns, in place and into a
    new buffer (which leaves the input as it was), forward and inverse."""
    g = torch.Generator(device=cuda).manual_seed(11 + radix)
    for shape in ((3, 64, 129), (2, 256, 256), (2, 512, 257), (1, 1024, 513), (1, 2048, 40),
                  (1, 4096, 9), (4, 8, 1000), (2, 2, 3)):
        x = torch.complex(torch.randn(*shape, generator=g, device=cuda),
                          torch.randn(*shape, generator=g, device=cuda))
        for inverse in (False, True):
            want = k.fft2_columns_plain(x, radix=radix, inverse=inverse)
            keep = x.clone()
            got = k.fft2_columns(x, radix=radix, inverse=inverse)
            assert torch.equal(x, keep) and _rel(got, want) <= TOL, (shape, inverse)
            ref = torch.fft.ifft(x, dim=1) if inverse else torch.fft.fft(x, dim=1)
            assert _rel(got, ref) <= TOL, (shape, inverse)
            same = k.fft2_columns(keep, radix=radix, inverse=inverse, out=keep)
            torch.cuda.synchronize()
            assert same is keep and _rel(keep, want) <= TOL, (shape, inverse)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft2", "rfft2", "irfft2"])
def test_cuda_composed_route_is_one_row_pass_and_one_column_pass(cuda, name):
    """Frames over one block (256x512, 512x256, 1024x1024 and 2048x128) at
    both radices: exactly one row kernel and one fft2_columns launch a call,
    within 2e-5 of torch.fft."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(5)
    row = {"fft2": "fft_fused", "rfft2": "rfft_fused", "irfft2": "irfft_fused"}[name]
    for shape in ((2, 256, 512), (2, 512, 256), (1, 1024, 1024), (2, 2048, 128)):
        real = torch.randn(*shape, generator=g, device=cuda)
        x = torch.fft.rfft2(real) if name == "irfft2" else (
            real if name == "rfft2" else real.to(torch.complex64))
        for radix in (2, 4):
            before = dict(k.LAUNCHES)
            got = getattr(ops, f"{name}_kernel")(x, radix=radix)
            n = {kn: c - before[kn] for kn, c in k.LAUNCHES.items() if c != before[kn]}
            assert n == {row: 1, "fft2_columns": 1}, (shape, radix, n)
            assert _rel(got, getattr(torch.fft, name)(x)) <= TOL, (shape, radix)


@pytest.mark.cuda
def test_cuda_health_guard_inside_graph_capture(cuda):
    """Under check_health="nan" a call captured in a CUDA graph runs its
    kernel rung: the guard reads nothing while the stream captures, so no
    rung is charged a failure, and the replay matches torch.fft."""
    from repro_torch import obs, resilience

    resilience.reset()
    x = torch.randn(512, 128, 128, device=cuda).to(torch.complex64)
    with xfft.config(check_health="nan"):
        xfft.fft2(x)  # builds, plans and opts the kernel into its shared memory
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with obs.capture() as trace:
            with torch.cuda.graph(graph):
                y = xfft.fft2(x)
    graph.replay()
    torch.cuda.synchronize()
    assert trace.select("resilience.failover") == []
    assert _rel(y, torch.fft.fft2(x)) <= TOL
    resilience.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2, 4])
def test_cuda_fft_fused_writes_out(cuda, radix):
    """fft_fused(out=) writes a slice of a larger buffer and nothing around
    it, one block and over one block, and refuses an out that does not
    match."""
    g = torch.Generator(device=cuda).manual_seed(27 + radix)
    for n in (1024, 2 ** 16):
        x = torch.complex(torch.randn(6, n, generator=g, device=cuda),
                          torch.randn(6, n, generator=g, device=cuda))
        big = torch.zeros(10, n, dtype=torch.complex64, device=cuda)
        got = k.fft_fused(x, radix=radix, out=big[2:8])
        torch.cuda.synchronize()
        assert got.data_ptr() == big[2:8].data_ptr()
        assert _rel(big[2:8], k.fft_fused(x, radix=radix)) == 0.0
        assert _rel(big[2:8], torch.fft.fft(x)) <= TOL
        assert not big[:2].any() and not big[8:].any()
    with pytest.raises(ValueError, match="out must match"):
        k.fft_fused(x, radix=radix, out=torch.empty(6, n, dtype=torch.complex64))


def _stream_launches(monkeypatch):
    """Record the CUDA stream of every kernel launch: (kernel, stream)."""
    seen = []
    launch_fn = k._launch

    def spy(entry, name, x, *args):
        seen.append((name, torch.cuda.current_stream(x.device).cuda_stream))
        return launch_fn(entry, name, x, *args)

    monkeypatch.setattr(k, "_launch", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("shape", [(64, 512, 512), (16, 1024, 1024)])
def test_cuda_stream_runs_two_engines_on_two_streams(cuda, monkeypatch, shape, unroll):
    """fft2_stream under fused_r4: ceil(T/u) fft_fused launches on one CUDA
    stream and as many fft2_columns launches on another, neither the
    caller's; the output within 2e-5 of torch.fft.fft2 and equal to the
    batched composed route's passes."""
    from repro_torch.core.fft2d import fft2_stream

    x = torch.randn(*shape, device=cuda).to(torch.complex64)
    fft2_stream(x, variant="fused_r4", unroll=unroll)  # build, create the streams
    seen = _stream_launches(monkeypatch)
    k.reset_launches()
    y = fft2_stream(x, variant="fused_r4", unroll=unroll)
    torch.cuda.synchronize()
    steps = -(-shape[0] // unroll)
    assert k.LAUNCHES["fft_fused"] == steps and k.LAUNCHES["fft2_columns"] == steps
    rows = {s for name, s in seen if name == "fft_fused"}
    cols = {s for name, s in seen if name == "fft2_columns"}
    caller = torch.cuda.current_stream(cuda).cuda_stream
    assert len(rows) == 1 and len(cols) == 1 and rows != cols and caller not in rows | cols
    assert _rel(y, torch.fft.fft2(x)) <= TOL


@pytest.mark.cuda
def test_cuda_stream_plans_the_kernels_and_serves_4d_batches(cuda):
    """An unscoped stream on the card plans fused_r4 and its unroll; a
    (T, B, H, W) batch and a stream of one frame run; the plain schedules on
    the card give the same spectra."""
    from repro_torch.core.fft2d import fft2_stream
    from repro_torch.plan.api import resolve

    for shape in ((16, 4, 256, 256), (1, 512, 512), (8, 128, 128)):
        x = torch.randn(*shape, device=cuda).to(torch.complex64)
        plan = resolve("fft2d_stream", shape, cuda)
        assert plan.variant == "fused_r4"
        assert plan.unroll == (2 if shape[-1] * shape[-2] <= 128 * 128 and shape[0] > 1 else 1)
        y = fft2_stream(x)
        assert _rel(y, torch.fft.fft2(x)) <= TOL
        assert _rel(y, fft2_stream(x, variant="radix4", unroll=1)) <= TOL


@pytest.mark.cuda
def test_cuda_stream_captures_in_a_graph_and_replays(cuda):
    """The two-stream pipeline captured in a CUDAGraph (both streams forked
    from and joined back into the capture stream) replays to the eager
    call's output, with no failover and no degrade."""
    from repro_torch import obs, resilience
    from repro_torch.core.fft2d import fft2_stream
    from repro_torch.plan import FFTPlan, execute, problem_key

    resilience.reset()
    x = torch.randn(16, 512, 512, device=cuda).to(torch.complex64)
    plan = FFTPlan(key=problem_key("fft2d_stream", tuple(x.shape), cuda), variant="fused_r4",
                   unroll=2)
    eager = execute(plan, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fft2_stream(x, variant="fused_r4", unroll=2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with obs.capture() as trace, xfft.config(check_health="nan"):
        with torch.cuda.graph(graph):
            y = execute(plan, x)
    graph.replay()
    torch.cuda.synchronize()
    assert trace.select("resilience.failover") == [] and trace.select("plan.degrade") == []
    assert torch.equal(y, eager)
    x.copy_(torch.randn_like(x))
    graph.replay()
    torch.cuda.synchronize()
    assert _rel(y, torch.fft.fft2(x)) <= TOL
    resilience.reset()


@pytest.mark.cuda
def test_cuda_mask_helpers_take_a_card_mask(cuda):
    """ROADMAP queue 3, F2: ``acceleration``, ``estimate_sensitivities(mask=)``
    and ``shot_masks`` take a mask on the card and give what the numpy mask
    gives."""
    from repro_torch import mri

    n = 64
    mask = mri.uniform_mask((n, n), 4, calib=16)
    card = torch.from_numpy(mask).to(cuda)
    assert mri.acceleration(card) == mri.acceleration(mask)
    np.testing.assert_array_equal(mri.shot_masks(card, 3), mri.shot_masks(mask, 3))
    x = torch.from_numpy(mri.shepp_logan(n)).to(cuda)
    smaps = torch.from_numpy(mri.birdcage_maps(4, n)).to(cuda)
    k = mri.sense_forward(x, smaps)
    assert torch.equal(mri.estimate_sensitivities(k, calib=16, mask=card),
                       mri.estimate_sensitivities(k, calib=16, mask=mask))
    with pytest.raises(ValueError, match="calibration block"):
        mri.estimate_sensitivities(k, calib=32, mask=card)


@pytest.mark.cuda
def test_cuda_spectrum_service_returns_card_tensors(cuda):
    """SpectrumService on card tensors: one lane a realness and shape, the
    lanes' kernels launched, each spectrum a card tensor within 2e-5 of
    torch.fft; numpy frames are sent to the card and lane apart."""
    from repro_torch.serve import SpectrumRequest, SpectrumService

    g = torch.Generator(device=cuda).manual_seed(28)
    real = [torch.randn(128, 128, generator=g, device=cuda) for _ in range(5)]
    cplx = [torch.randn(128, 128, generator=g, device=cuda).to(torch.complex64) * (1 + 1j)
            for _ in range(3)]
    big = [torch.randn(512, 512, generator=g, device=cuda).to(torch.complex64)
           for _ in range(2)]
    host = np.random.default_rng(0).standard_normal((128, 128)).astype(np.float32)
    reqs = [SpectrumRequest(frame=f) for f in real + cplx + big] + [SpectrumRequest(frame=host)]
    before = dict(k.LAUNCHES)
    SpectrumService().serve(reqs)
    launched = {n: k.LAUNCHES[n] - before[n] for n in k.LAUNCHES if k.LAUNCHES[n] != before[n]}
    assert launched.get("rfft2_fused") == 2 and launched.get("fft2_fused") == 1, launched
    assert launched.get("fft_fused") == 1 and launched.get("fft2_columns") == 1, launched
    for r in reqs:
        assert r.done and r.spectrum.is_cuda
        frame = torch.as_tensor(r.frame).to(cuda)
        want = torch.fft.rfft2(frame) if not frame.is_complex() else torch.fft.fft2(frame)
        assert _rel(r.spectrum, want) <= TOL


@pytest.mark.cuda
def test_cuda_started_loop_tickets_complete_on_the_card(cuda):
    """A started loop serves submitters on other threads; each ticket is done
    only once the card has finished its batch, and stop() drains."""
    import threading

    from repro_torch.serve import BatchPolicy, SpectrumRequest, SpectrumService

    svc = SpectrumService(batch=BatchPolicy(max_batch=8, max_wait_s=0.002))
    frames = [torch.randn(128, 128, device=cuda) for _ in range(32)]
    tickets, lock = [], threading.Lock()

    def submit(part):
        for f in part:
            t = svc.loop.submit(SpectrumRequest(frame=f))
            with lock:
                tickets.append((t, f))

    svc.loop.start()
    try:
        threads = [threading.Thread(target=submit, args=(frames[i::4],)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for t, f in tickets:
            r = t.result(timeout=30.0)
            assert r.spectrum.is_cuda
            assert _rel(r.spectrum, torch.fft.rfft2(f)) <= TOL
    finally:
        svc.loop.stop()
    assert svc.loop.queue.depth() == 0 and len(tickets) == 32


@pytest.mark.cuda
def test_cuda_imaging_service_recon_lane_with_card_masks(cuda):
    """An ImagingService recon lane whose masks live on the card classifies
    (F2), runs one batched CG-SENSE solve on the card and matches the
    direct call."""
    from repro_torch import mri, obs
    from repro_torch.serve import ImagingService, ReconRequest

    n, coils = 64, 4
    x = torch.from_numpy(mri.shepp_logan(n)).to(cuda)
    smaps = torch.from_numpy(mri.birdcage_maps(coils, n)).to(cuda)
    mask = torch.from_numpy(mri.uniform_mask((n, n), 2, calib=8)).to(cuda)
    kspace = mri.sense_forward(x, smaps, mask)
    reqs = [ReconRequest(kspace=kspace, smaps=smaps, mask=mask) for _ in range(2)]
    with obs.capture() as trace:
        ImagingService().serve(reqs)
    assert [(e["service"], e["batch"]) for e in trace.select("serve.batch")] == [("recon", 2)]
    direct = mri.recon_cg_sense(kspace, smaps, mask)
    for r in reqs:
        assert r.image.is_cuda and _rel(r.image, direct) <= 1e-5


@pytest.mark.cuda
def test_cuda_pencil_on_one_nccl_rank(cuda, tmp_path):
    """The pencil on a world-1 NCCL group, plain and overlapped (chunks 2),
    as planned (``fused_r4``): within 2e-5 of ``torch.fft.fft2``, one
    ``fft_fused`` launch for the rows and one ``fft2_columns`` launch a
    slab, one ``all_to_all_single`` a slab."""
    import datetime

    import torch.distributed as dist

    from repro_torch.compat import make_mesh
    from repro_torch.core import distributed as pencil

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((1,), ("data",))
        x = torch.randn(2, 1024, 1024, device=cuda)
        want = torch.fft.fft2(x)
        for fn, kw, chunks in ((pencil.fft2_pencil, {}, 1),
                               (pencil.fft2_pencil_overlapped, {"chunks": 2}, 2)):
            before = dict(k.LAUNCHES)
            pencil.reset_collectives()
            y = fn(x, mesh, variant="auto", **kw).to_local()
            torch.cuda.synchronize()
            launched = {n: k.LAUNCHES[n] - before[n] for n in k.LAUNCHES
                        if k.LAUNCHES[n] != before[n]}
            assert launched == {"fft_fused": 1, "fft2_columns": chunks}
            assert pencil.COLLECTIVES["all_to_all_single"] == chunks
            assert y.is_cuda and _rel(y, want) <= TOL
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_pencil_key_plans_the_kernels(cuda):
    """Divergence 11: an unscoped CUDA pencil key plans ``fused_r4``, at any
    device count; scoped to the plain schedules it plans one of them."""
    from repro_torch.plan import estimate_plan, problem_key

    for shape, d in (((4, 4096, 4096), 1), ((8192, 8192), 4), ((64, 32), 8)):
        assert estimate_plan(problem_key("fft2d_pencil", shape, cuda, n_devices=d)).variant \
            == "fused_r4"
        scoped = problem_key("fft2d_pencil", shape, cuda, n_devices=d, backends=("torch",))
        assert estimate_plan(scoped).variant in ("looped", "stockham", "radix4")


def _smoke_lm(cuda, arch="llama3.2-3b"):
    from repro_torch.configs import smoke_config
    from repro_torch.models.build import build
    from repro_torch.models.param import tree_map

    cfg = smoke_config(arch)  # float32 compute
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    return cfg, model, params, tree_map(lambda t: t.cpu(), params)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-76b"])
def test_cuda_lm_prefill_launches_flash_once_per_layer(cuda, arch):
    """Divergence 13: on the card every prefill layer's attention launches
    ``flash_attention_fwd`` once and a decode step none; the logits agree
    with the CPU's plain twins on the same weights to 1e-4 of their
    largest value (float32 compute)."""
    from repro_torch.kernels._launch import LAUNCHES

    cfg, model, params, cpu_params = _smoke_lm(cuda, arch)
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s = 2, 12
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g, device=cuda,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(b, cfg.n_patches, cfg.d_model, generator=g, device=cuda)
    caches = model.init_cache_fn(b, 32, torch.float32, cuda)
    cpu_caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    before = LAUNCHES["flash_attention_fwd"]
    logits, caches = model.prefill_fn(params, batch, caches)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] - before == cfg.n_layers
    ref, cpu_caches = model.prefill_fn(cpu_params, {k: v.cpu() for k, v in batch.items()},
                                       cpu_caches)
    assert _rel(logits.cpu(), ref) <= 1e-4
    tok = torch.argmax(ref, -1).to(torch.int32)[:, None]
    before = LAUNCHES["flash_attention_fwd"]
    d, _ = model.decode_fn(params, tok.to(cuda), s, caches)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before
    d_ref, _ = model.decode_fn(cpu_params, tok, s, cpu_caches)
    assert _rel(d.cpu(), d_ref) <= 1e-4


@pytest.mark.cuda
def test_cuda_serve_engine_gives_the_cpu_tokens(cuda):
    """``ServeEngine`` runs where its parameters lie: the card's tokens are
    the CPU's on the same weights and queue (float32 compute)."""
    import numpy as np

    from repro_torch.serve import Request, ServeEngine

    cfg, model, params, cpu_params = _smoke_lm(cuda)
    rng = np.random.default_rng(3)
    lengths = [3, 5, 8, 12, 17, 30, 6]

    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lengths]

    def queue():
        return [Request(prompt=p, max_new=4) for p in prompts]

    card = ServeEngine(model, params, batch=3, max_len=64)
    host = ServeEngine(model, cpu_params, batch=3, max_len=64)
    assert card.device.type == "cuda" and host.device.type == "cpu"
    got, want = card.serve_queue(queue()), host.serve_queue(queue())
    assert [r.out for r in got] == [r.out for r in want]


#: (bh, sq, sk, d, dv, causal, window, q_offset): a context-parallel rank's
#: slice of the queries against every key.
OFFSET_CASES = [
    (8, 256, 512, 128, 128, True, None, 256),    # the second of two causal ranks
    (4, 200, 640, 64, 64, True, 96, 440),         # a window, ragged tiles
    (4, 96, 160, 192, 128, True, None, 64),       # MLA's widths (64-row tiles, width 256)
    (2, 64, 100, 32, 32, False, 20, 70),          # rows that see no key
    (2, 64, 48, 16, 16, True, None, 100),         # past every key
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_cuda_flash_attention_with_a_query_offset_raises(cuda, case):
    """Divergence 13's offset clause, closed: both kernels take a query
    offset (row r at position q_offset + r). The forward (with its
    logsumexp) and the backward, one launch each, within 2e-5 of their
    plain versions on the same operands; from float64 the forward within
    2e-5, the gradients within 2e-5 or 2x the plain backward's distance;
    the model's
    ``flash_attention`` at that offset launches the forward once."""
    from repro_torch.models import attention as attn

    bh, sq, sk, d, dv, causal, window, off = case
    g = torch.Generator(device=cuda).manual_seed(sq + off)
    q = torch.randn(bh, sq, d, generator=g, device=cuda) / math.sqrt(d)
    kk = torch.randn(bh, sk, d, generator=g, device=cuda)
    v = torch.randn(bh, sk, dv, generator=g, device=cuda)
    do = torch.randn(bh, sq, dv, generator=g, device=cuda)
    opts = dict(causal=causal, window=window, block_q=64, block_k=64, scale=1.0, q_offset=off)
    k.reset_launches()
    o, lse = fa.flash_attention_fwd(q, kk, v, return_lse=True, **opts)
    grads = fa.flash_attention_bwd(q, kk, v, o, do, lse, **opts)
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention_fwd"] == 1 and k.LAUNCHES["flash_attention_bwd"] == 1
    o_plain, lse_plain = fa.flash_attention_plain(q, kk, v, return_lse=True, **opts)
    assert _rel(o, o_plain) <= TOL
    assert float((lse - lse_plain).abs().max()) <= 1e-5 * float(lse_plain.abs().max())
    plain = fa.flash_attention_bwd_plain(q, kk, v, o, do, lse, **opts)
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, kk, v))
    o64 = fa.flash_attention_plain(q64, k64, v64, **opts)
    exact = torch.autograd.grad(o64, (q64, k64, v64), do.double())
    assert _rel(o.double(), o64) <= TOL
    for name, a, p, e in zip("qkv", grads, plain, exact):
        assert _rel(a, p) <= TOL, (name, _rel(a, p))
        assert _rel(a.double(), e) <= max(TOL, 2 * _rel(p.double(), e)), name
    b = 2
    qm = torch.randn(b, sq, bh // b, d, generator=g, device=cuda)
    km = torch.randn(b, sk, bh // b, d, generator=g, device=cuda)
    vm = torch.randn(b, sk, bh // b, dv, generator=g, device=cuda)
    k.reset_launches()
    got = attn.flash_attention(qm, km, vm, causal=causal, window=window, q_offset=off,
                               block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention_fwd"] == 1
    want = attn.flash_attention(qm.cpu(), km.cpu(), vm.cpu(), causal=causal, window=window,
                                q_offset=off, block_q=64, block_k=64)
    assert _rel(got.cpu(), want) <= TOL


#: Each recurrent-state family's kernel and its launches a prefill at full
#: width: xlstm-350m's 12 sLSTM layers, zamba2-2.7b's 9 shared-block
#: invocations.
RECURRENT = {"xlstm-350m": ("slstm_scan", 12), "zamba2-2.7b": ("flash_attention_fwd", 9)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_cuda_recurrent_lm_launches_its_kernel_at_full_width(cuda, arch):
    """At full width (bf16 compute, float32 weights from a seeded card
    generator) a prefill launches its family's kernel once a layer that
    has one (12 ``slstm_scan``, 9 ``flash_attention_fwd`` at (2·32, 16,
    160)) and nothing else; a decode step launches nothing."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models.build import build

    name, per_prefill = RECURRENT[arch]
    cfg = get_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s = 2, 16
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g, device=cuda, dtype=torch.int32)
    caches = model.init_cache_fn(b, 32, torch.float32, cuda)
    torch.cuda.synchronize()
    reset_launches()
    logits, caches = model.prefill_fn(params, {"tokens": toks}, caches)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {name: per_prefill}
    assert logits.shape == (b, cfg.vocab) and bool(torch.isfinite(logits).all())
    reset_launches()
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    d, _ = model.decode_fn(params, tok, s, caches)
    torch.cuda.synchronize()
    assert not any(LAUNCHES.values())
    assert bool(torch.isfinite(d).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_cuda_recurrent_lm_smoke_matches_the_cpu(cuda, arch):
    """The smoke model on the card against its plain twins on the CPU on the
    same weights (float32 compute): prefill of 13 (zamba2: a padded SSD
    chunk), then two decode steps, logits to 1e-4 of their largest value;
    the prefill launches the kernel once an sLSTM layer (xlstm) or a
    shared-block invocation (zamba2). xlstm is cut to one mLSTM / sLSTM
    pair: at 4 layers its init amplifies the scan's rounding (1e-4 of the
    plain version, a state in float64 products) past 1e-4 at the logits."""
    from repro_torch.kernels._launch import LAUNCHES

    cfg, model, params, cpu_params = _smoke_lm(cuda, arch)
    if arch == "xlstm-350m":
        from repro_torch.models.build import build

        cfg = cfg.scaled(n_layers=2)
        model = build(cfg)
    name, _ = RECURRENT[arch]
    launches = cfg.n_layers // 2 if arch == "xlstm-350m" else cfg.n_layers // cfg.shared_attn_every
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s = 2, 13
    toks = torch.randint(0, cfg.vocab, (b, s + 2), generator=g, device=cuda, dtype=torch.int32)
    caches = model.init_cache_fn(b, 32, torch.float32, cuda)
    cpu_caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    before = LAUNCHES[name]
    logits, caches = model.prefill_fn(params, {"tokens": toks[:, :s]}, caches)
    torch.cuda.synchronize()
    assert LAUNCHES[name] - before == launches
    ref, cpu_caches = model.prefill_fn(cpu_params, {"tokens": toks[:, :s].cpu()}, cpu_caches)
    assert _rel(logits.cpu(), ref) <= 1e-4
    for i in range(2):
        tok = toks[:, s + i:s + i + 1]
        d, caches = model.decode_fn(params, tok, s + i, caches)
        d_ref, cpu_caches = model.decode_fn(cpu_params, tok.cpu(), s + i, cpu_caches)
        assert _rel(d.cpu(), d_ref) <= 1e-4


@pytest.mark.cuda
def test_cuda_whisper_smoke_launches_flash_in_prefill_and_decode(cuda):
    """Divergence 17: a whisper prefill launches ``flash_attention_fwd``
    n_enc + 2 n_layers times (encoder, decoder self- and cross-attention)
    and each decode step n_layers times (cross-attention, as the
    reference's decode runs it), nothing else; the logits agree with the
    CPU's plain twins on the same weights to 1e-4 of their largest value
    (float32 compute)."""
    from repro_torch.kernels._launch import LAUNCHES, reset_launches

    cfg, model, params, cpu_params = _smoke_lm(cuda, "whisper-medium")
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s = 2, 12
    toks = torch.randint(0, cfg.vocab, (b, s + 2), generator=g, device=cuda, dtype=torch.int32)
    frames = torch.randn(b, cfg.enc_frames, cfg.d_model, generator=g, device=cuda)
    caches = model.init_cache_fn(b, 32, torch.float32, cuda)
    cpu_caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    torch.cuda.synchronize()
    reset_launches()
    logits, caches = model.prefill_fn(params, {"tokens": toks[:, :s], "frames": frames}, caches)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "flash_attention_fwd": cfg.n_enc_layers + 2 * cfg.n_layers}
    ref, cpu_caches = model.prefill_fn(cpu_params, {"tokens": toks[:, :s].cpu(),
                                                    "frames": frames.cpu()}, cpu_caches)
    assert _rel(logits.cpu(), ref) <= 1e-4
    for i in range(2):
        reset_launches()
        d, caches = model.decode_fn(params, toks[:, s + i:s + i + 1], s + i, caches)
        torch.cuda.synchronize()
        assert {n: c for n, c in LAUNCHES.items() if c} == {"flash_attention_fwd": cfg.n_layers}
        d_ref, cpu_caches = model.decode_fn(cpu_params, toks[:, s + i:s + i + 1].cpu(), s + i,
                                            cpu_caches)
        assert _rel(d.cpu(), d_ref) <= 1e-4


@pytest.mark.cuda
def test_cuda_whisper_serves_the_cpu_tokens_with_frames(cuda):
    """``ServeEngine`` with frames as extras: the card's tokens are the
    CPU's on the same weights, queue and frames (float32 compute)."""
    import numpy as np

    from repro_torch.data.pipeline import frames_for
    from repro_torch.serve import Request, ServeEngine

    cfg, model, params, cpu_params = _smoke_lm(cuda, "whisper-medium")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (3, 5, 8, 12, 17)]
    frames = frames_for(cfg, 3, 0, device=cuda)

    def queue():
        return [Request(prompt=q, max_new=4) for q in prompts]

    got = ServeEngine(model, params, batch=3, max_len=64).serve_queue(
        queue(), extras={"frames": frames})
    want = ServeEngine(model, cpu_params, batch=3, max_len=64).serve_queue(
        queue(), extras={"frames": frames.cpu()})
    assert [r.out for r in got] == [r.out for r in want]


def _mixing_launches(cfg, s):
    """The FFT kernels one planned fft2 of a (B, S, d_model) frame stack
    launches at radix 4, from the census: ``fft2_fused`` where the frame
    fits one block, else the composed route's row ``fft_fused`` and one
    ``fft2_columns`` (the turn route's row kernel where H > 4096)."""
    from repro_torch.kernels.fft_radix2 import fft2_columns_serves
    from repro_torch.kernels.ops import fft2_fits_budget

    if fft2_fits_budget(s, cfg.d_model):
        return {"fft2_fused": 1}
    if fft2_columns_serves(s):
        return {"fft_fused": 1, "fft2_columns": 1}
    return {"fft_fused": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["smoke", "full"])
def test_cuda_fourier_lm_mixes_on_the_fft_kernels(cuda, width):
    """fourier_lm under "auto": every block's Re(FFT2) plans onto the FFT
    kernels (the smoke model's (16, 32) frames: ``fft2_fused`` once a
    block; full width, (2048, 512) frames: the composed route, ``fft_fused``
    and ``fft2_columns`` once a block), no flash attention; the logits
    agree with the CPU's (plain schedules) on the same weights to 1e-4 of
    their largest value at float32 compute (the smoke model; at full width
    the card's launches and finite logits)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models.build import build
    from repro_torch.models.param import tree_map

    cfg = smoke_config("fourier_lm") if width == "smoke" else get_config("fourier_lm")
    b, s = (2, 16) if width == "smoke" else (2, 2048)
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=g, device=cuda, dtype=torch.int32)
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        loss, _ = model.loss_fn(params, {"tokens": toks})
        torch.cuda.synchronize()
        per_call = {n: cfg.n_layers * c for n, c in _mixing_launches(cfg, s).items()}
        assert {n: c for n, c in LAUNCHES.items() if c} == per_call
        assert bool(torch.isfinite(loss))
        if width == "smoke":
            reset_launches()
            last, _ = model.prefill_fn(params, {"tokens": toks}, None)
            assert {n: c for n, c in LAUNCHES.items() if c} == per_call
            cpu = tree_map(lambda t: t.cpu(), params)
            ref, _ = model.prefill_fn(cpu, {"tokens": toks.cpu()}, None)
            assert _rel(last.cpu(), ref) <= 1e-4
            ref_loss, _ = model.loss_fn(cpu, {"tokens": toks.cpu()})
            assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))


@pytest.mark.cuda
def test_cuda_flash_attention_at_the_mla_shape_matches_float64(cuda):
    """deepseek-v3's MLA prefill: 4 sequences of 128 heads, q and k of
    D = 128 + 64 against v of Dv = 128, causal, the config's blocks (512,
    1024): the kernel within 2e-5 of its plain version and of
    ``mha_reference`` in float64, one launch."""
    bh, s, d, dv = 512, 64, 192, 128
    g = torch.Generator(device=cuda).manual_seed(19)
    q = torch.randn(bh, s, d, generator=g, device=cuda)
    kk = torch.randn(bh, s, d, generator=g, device=cuda)
    v = torch.randn(bh, s, dv, generator=g, device=cuda)
    opts = dict(causal=True, block_q=512, block_k=1024)
    k.reset_launches()
    got = fa.flash_attention_fwd(q, kk, v, **opts)
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention_fwd"] == 1 and got.shape == (bh, s, dv)
    assert _rel(got, fa.flash_attention_plain(q, kk, v, **opts)) <= TOL
    exact = fa.mha_reference(q.double(), kk.double(), v.double(), causal=True)
    assert _rel(got.double(), exact) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_cuda_moe_smoke_launches_flash_once_a_layer(cuda, arch):
    """The moe family's smoke models on the card against the CPU's plain
    twins on the same weights (float32 compute): a prefill of 12 (past
    mixtral's window of 8: the kernel's window mask, the ring's kept
    slots) launches ``flash_attention_fwd`` once a layer and nothing else,
    two decode steps launch nothing; deepseek's ``loss_fn`` once a layer
    and once more for the MTP block. Logits and the loss to 1e-4 of their
    largest value."""
    from repro_torch.kernels._launch import LAUNCHES, reset_launches

    cfg, model, params, cpu_params = _smoke_lm(cuda, arch)
    g = torch.Generator(device=cuda).manual_seed(1)
    b, s = 2, 12
    toks = torch.randint(0, cfg.vocab, (b, s + 2), generator=g, device=cuda, dtype=torch.int32)
    caches = model.init_cache_fn(b, 32, torch.float32, cuda)
    cpu_caches = model.init_cache_fn(b, 32, torch.float32, "cpu")
    torch.cuda.synchronize()
    reset_launches()
    logits, caches = model.prefill_fn(params, {"tokens": toks[:, :s]}, caches)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"flash_attention_fwd": cfg.n_layers}
    ref, cpu_caches = model.prefill_fn(cpu_params, {"tokens": toks[:, :s].cpu()}, cpu_caches)
    assert _rel(logits.cpu(), ref) <= 1e-4
    for i in range(2):
        reset_launches()
        d, caches = model.decode_fn(params, toks[:, s + i:s + i + 1], s + i, caches)
        torch.cuda.synchronize()
        assert not any(LAUNCHES.values())
        d_ref, cpu_caches = model.decode_fn(cpu_params, toks[:, s + i:s + i + 1].cpu(), s + i,
                                            cpu_caches)
        assert _rel(d.cpu(), d_ref) <= 1e-4
    reset_launches()
    with torch.no_grad():
        loss, metrics = model.loss_fn(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "flash_attention_fwd": cfg.n_layers + int(cfg.mtp)}
    ref_loss, ref_metrics = model.loss_fn(cpu_params, {"tokens": toks.cpu()})
    for key in ref_metrics:
        assert abs(float(metrics[key]) - float(ref_metrics[key])) <= 1e-4 * abs(
            float(ref_metrics[key])), key


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_cuda_moe_apply_matches_the_cpu(cuda, arch):
    """``moe_apply`` (grouped_local, 16 experts top-4, capacity factor 1.25,
    so the prefill drops assignments) on the card: the router's expert ids
    equal the CPU's, the output and aux within 1e-5 of the CPU's, at
    float32, and two runs bit-equal (the combine sums each token's choices
    in a fixed order)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    from repro_torch.models.param import init_params, tree_map

    cfg = smoke_config(arch).scaled(d_model=256)
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=4, d_ff_expert=128,
                                             capacity_factor=1.25))
    p = init_params(moe.moe_skel(cfg), torch.Generator(device=cuda).manual_seed(2))
    cpu_p = tree_map(lambda t: t.cpu(), p)
    x = torch.randn(3, 64, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    _, ids, _ = moe._router(p, x, cfg.moe)
    _, cpu_ids, _ = moe._router(cpu_p, x.cpu(), cfg.moe)
    assert torch.equal(ids.cpu(), cpu_ids)
    stats = {}
    y, aux = moe.moe_apply(p, x, cfg, stats=stats)
    again, _ = moe.moe_apply(p, x, cfg)
    ref, ref_aux = moe.moe_apply(cpu_p, x.cpu(), cfg)
    assert int(stats["kept"]) < stats["assignments"]
    assert _rel(y.cpu(), ref) <= 1e-5 and abs(float(aux) - float(ref_aux)) <= 1e-5
    assert torch.equal(y, again)


# (bh, sq, sk, d, dv, causal, window, block_q, block_k)
FLASH_BWD_CASES = [
    (48, 1024, 1024, 128, 128, True, None, 512, 1024),  # llama3.2-3b's training lane
    (48, 256, 256, 128, 128, True, None, 512, 1024),  # llama's head width, causal
    (8, 200, 200, 32, 32, True, None, 512, 1024),  # width 32
    (8, 190, 190, 64, 64, True, 50, 512, 1024),  # width 64, a window
    (4, 97, 97, 256, 256, True, None, 512, 1024),  # width 256 at D = Dv = 256
    (8, 300, 300, 128, 128, True, 100, 512, 1024),  # a window, partial tiles
    (16, 16, 150, 64, 64, False, None, 512, 1024),  # cross-attention, Sq != Sk
    (8, 130, 130, 192, 128, True, None, 512, 1024),  # MLA's D 192 -> Dv 128
    (8, 100, 100, 160, 160, True, None, 512, 1024),  # zamba2's Dv 160
    (4, 70, 45, 37, 19, False, 8, 16, 16),  # odd widths; rows that see no key, Sk padded
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_cuda_flash_attention_bwd_matches_plain(cuda, case):
    """flash_attention_bwd against its plain version on the same operands,
    the logsumexp from the card's forward: one launch a call, dq, dk, dv
    within 2e-5 of the plain version's largest value, and the same bits on
    a second call (no atomics)."""
    bh, sq, sk, d, dv, causal, window, bq, bk = case
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn(bh, sq, d, generator=g, device=cuda) / math.sqrt(d)
    kk = torch.randn(bh, sk, d, generator=g, device=cuda)
    v = torch.randn(bh, sk, dv, generator=g, device=cuda)
    do = torch.randn(bh, sq, dv, generator=g, device=cuda)
    opts = dict(causal=causal, window=window, block_q=bq, block_k=bk, scale=1.0)
    o, lse = fa.flash_attention_fwd(q, kk, v, return_lse=True, **opts)
    k.reset_launches()
    got = fa.flash_attention_bwd(q, kk, v, o, do, lse, **opts)
    again = fa.flash_attention_bwd(q, kk, v, o, do, lse, **opts)
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention_bwd"] == 2
    ref = fa.flash_attention_bwd_plain(q, kk, v, o, do, lse, **opts)
    for name, a, b, c in zip("qkv", got, ref, again):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))
        assert torch.equal(a, c), name
    o_ref, lse_ref = fa.flash_attention_plain(q, kk, v, return_lse=True, **opts)
    assert float((lse - lse_ref).abs().max()) <= 1e-5 * float(lse_ref.abs().max())


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_float64_gap_at_llamas_lane(cuda):
    """At llama3.2-3b's training lane (48, 1024, 128) causal, the kernel's
    gradients sit within 2x the plain version's distance from float64
    autograd of ``mha_reference`` (on the same operands, lse from the
    card's forward)."""
    bh, s, d = 48, 1024, 128
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn(bh, s, d, generator=g, device=cuda) / math.sqrt(d)
    kk, v, do = (torch.randn(bh, s, d, generator=g, device=cuda) for _ in range(3))
    opts = dict(causal=True, window=None, block_q=512, block_k=1024, scale=1.0)
    o, lse = fa.flash_attention_fwd(q, kk, v, return_lse=True, **opts)
    got = fa.flash_attention_bwd(q, kk, v, o, do, lse, **opts)
    plain = fa.flash_attention_bwd_plain(q, kk, v, o, do, lse, **opts)
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, kk, v))
    out = fa.mha_reference(q64 * math.sqrt(d), k64, v64, causal=True)
    exact = torch.autograd.grad(out, (q64, k64, v64), do.double())
    for name, a, p, e in zip("qkv", got, plain, exact):
        assert _rel(a.double(), e) <= 2 * _rel(p.double(), e), (name, _rel(a.double(), e),
                                                                _rel(p.double(), e))


@pytest.mark.cuda
def test_cuda_flash_function_launches_forward_and_backward(cuda):
    """Under grad the model route's Function launches the forward (with the
    logsumexp) and the backward once each; without grad the forward only."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, kk, v = (torch.randn(8, 64, 32, generator=g, device=cuda).requires_grad_()
                for _ in range(3))
    k.reset_launches()
    out = fa.flash_attention(q, kk, v, causal=True)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention_fwd"] == 1 and k.LAUNCHES["flash_attention_bwd"] == 1
    ref = [x.detach().cpu().requires_grad_() for x in (q, kk, v)]
    r = fa.flash_attention(*ref, causal=True)
    (r * r).sum().backward()
    for a, b in zip((q, kk, v), ref):
        assert _rel(a.grad.cpu(), b.grad) <= 1e-4
    k.reset_launches()
    with torch.no_grad():
        fa.flash_attention(q, kk, v, causal=True)
    assert k.LAUNCHES["flash_attention_fwd"] == 1 and k.LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.cuda
def test_cuda_kernel_entries_without_a_backward_raise_under_grad(cuda):
    """Divergence 19: an input that requires grad, with grad enabled, makes
    every kernel entry without a backward raise NoBackward before it
    launches; the front door re-raises it without a failover."""
    from repro_torch import obs
    from repro_torch.kernels._launch import NoBackward

    z = torch.randn(4, 64, dtype=torch.complex64, device=cuda, requires_grad=True)
    r = torch.randn(4, 64, device=cuda, requires_grad=True)
    f = torch.randn(2, 16, 16, dtype=torch.complex64, device=cuda, requires_grad=True)
    calls = [
        lambda: k.fft_fused(z, radix=4), lambda: k.rfft_fused(r, radix=4),
        lambda: k.fft2_fused(f, radix=4), lambda: k.fft2_columns(f, radix=4),
        lambda: bf.butterfly_stage(r, r, stage=0),
        lambda: fa.flash_attention_fwd(r[None], r[None], r[None]),
    ]
    k.reset_launches()
    for call in calls:
        with pytest.raises(NoBackward):
            call()
    with obs.capture() as trace, pytest.raises(NoBackward):
        xfft.fft2(f)
    assert not trace.select("resilience.failover")
    assert not any(k.LAUNCHES.values())
    with torch.no_grad():
        k.fft_fused(z, radix=4)
    assert k.LAUNCHES["fft_fused"] == 1
    # the sLSTM scan has a backward: under grad it runs SlstmScan
    hs, _ = slstm_scan(torch.randn(1, 4, 64, device=cuda, requires_grad=True),
                       torch.randn(4, 4, 16, device=cuda), torch.zeros(64, device=cuda),
                       *(torch.zeros(1, 16, device=cuda) for _ in range(3)),
                       torch.full((1, 16), float("-inf"), device=cuda), chunk=4)
    assert hs.grad_fn is not None and k.LAUNCHES["slstm_scan"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_cuda_lm_gradients_run_on_the_kernels_and_match_the_cpu(cuda, remat):
    """llama's smoke model at float32: loss_fn's gradients on the card
    launch flash_attention_fwd once a layer (twice under remat) and
    flash_attention_bwd once a layer, and agree with the CPU's autograd of
    the plain route on the same weights to 1e-4 of each leaf's largest."""
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models.build import build
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.train.loop import value_and_grad

    cfg, model, params, cpu_params = _smoke_lm(cuda)
    model = build(cfg.scaled(remat=remat))
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24), generator=g, device=cuda,
                                     dtype=torch.int32)}
    torch.cuda.synchronize()
    reset_launches()
    loss, _, grads = value_and_grad(model.loss_fn, params, batch)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "flash_attention_fwd": cfg.n_layers * (2 if remat else 1),
        "flash_attention_bwd": cfg.n_layers}
    ref_loss, _, ref = value_and_grad(model.loss_fn, cpu_params,
                                       {"tokens": batch["tokens"].cpu()})
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert _rel(a.cpu(), b) <= 1e-4


@pytest.mark.cuda
def test_cuda_fourier_lm_gradients_run_on_the_fft_kernels(cuda):
    """fourier_lm's smoke model under "auto": the mixing's backward plans the
    same FFT kernels as its forward (one fft2 a block each way), and the
    gradients agree with the CPU's to 1e-4 of each leaf's largest."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models.build import build
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.train.loop import value_and_grad

    cfg = smoke_config("fourier_lm")
    model = build(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g, device=cuda, dtype=torch.int32)
    torch.cuda.synchronize()
    reset_launches()
    _, _, grads = value_and_grad(model.loss_fn, params, {"tokens": toks})
    torch.cuda.synchronize()
    per_call = {n: 2 * cfg.n_layers * c for n, c in _mixing_launches(cfg, 16).items()}
    assert {n: c for n, c in LAUNCHES.items() if c} == per_call
    _, _, ref = value_and_grad(model.loss_fn, tree_map(lambda t: t.cpu(), params),
                                {"tokens": toks.cpu()})
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert _rel(a.cpu(), b) <= 1e-4


@pytest.mark.cuda
def test_cuda_xlstm_loss_backward_runs_the_scan_backward(cuda):
    """xlstm's smoke loss_fn at float32: on the card each sLSTM layer's
    prefill launches slstm_scan once and its backward slstm_scan_bwd once,
    and the loss and every gradient agree with the CPU's autograd of the
    plain scan on the same weights to 1e-4 of each leaf's largest value."""
    from repro_torch.kernels._launch import LAUNCHES, reset_launches
    from repro_torch.models.param import tree_leaves
    from repro_torch.train.loop import value_and_grad

    cfg, model, params, cpu_params = _smoke_lm(cuda, "xlstm-350m")
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g, device=cuda, dtype=torch.int32)
    torch.cuda.synchronize()
    reset_launches()
    loss, _, grads = value_and_grad(model.loss_fn, params, {"tokens": toks})
    torch.cuda.synchronize()
    pairs = cfg.n_layers // cfg.slstm_every
    assert {n: c for n, c in LAUNCHES.items() if c} == {"slstm_scan": pairs,
                                                          "slstm_scan_bwd": pairs}
    ref_loss, _, ref = value_and_grad(model.loss_fn, cpu_params, {"tokens": toks.cpu()})
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert _rel(a.cpu(), b) <= 1e-4
