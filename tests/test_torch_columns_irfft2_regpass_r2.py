"""The radix-2 ``irfft2_fused`` and ``fft2_columns`` on register passes.

``csrc/rfft2_fused.cu`` (``irfft2_regs_kernel<LOG_H, LOG_M, 2>``) and
``csrc/fft2_columns.cu`` (``fft2_columns_regs_kernel<2>``) run on the card
only; ``test_torch_real_regpass_r2.py`` and ``test_torch_fft2_columns.py``
run both sources through ``tools/cuda_emu``. Here, on the CPU:

* ``irfft2_fused_plain`` at radix 2, now in the kernel's own order (the DC
  and Nyquist columns packed into slot 0 as A + iB before the column
  passes), is held to the Pallas kernel in interpret mode and to numpy at
  max|port - ref| <= 1e-5 * max|ref|, on half spectra that are not
  Hermitian;
* both kernels' schedules, each pass on ``_regpass_panel_r2``, are
  ``torch.equal`` to the plain versions, whose passes run
  ``_stockham_panel``;
* the wrappers hand the padded census to the C entries at radix 2, the
  stage-at-a-time panel is gone from ``csrc``, and the planner prices the
  radix-2 frames and columns by the register passes, as radix 4's.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fft_radix2 as jref
from repro_torch.kernels import fft_radix2 as k
from repro_torch.plan import autotune

TOL = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
IRFFT2_FRAMES = [(2, 8, 5), (2, 16, 33), (1, 128, 65), (1, 4, 257)]
HEIGHTS = [2 ** p for p in range(1, 13)]  # every column length fft2_columns serves


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, np.max(np.abs(ref)))


def _half_spectra(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _shape_id(shape):
    return "x".join(map(str, shape))


# ------------------------------- irfft2_fused -------------------------------


@pytest.mark.parametrize("shape", IRFFT2_FRAMES, ids=_shape_id)
def test_irfft2_plain_matches_pallas_and_numpy(shape):
    """Half spectra that are not Hermitian: the kernel's order drops the
    anti-Hermitian parts of the DC and Nyquist columns by its pack, where
    the Pallas kernel transforms those columns apart and drops the imaginary
    parts after; both are numpy's irfft2."""
    f, h, half = shape
    y = _half_spectra(shape, h * 1000 + half)
    ref = np.asarray(jref.irfft2_fused(jnp.asarray(y.real), jnp.asarray(y.imag), radix=2,
                                       interpret=True))
    got = k.irfft2_fused_plain(torch.from_numpy(y), radix=2).numpy()
    _close(got, ref)
    _close(got, np.fft.irfft2(y.astype(np.complex128), s=(h, 2 * (half - 1))))


@pytest.mark.parametrize("shape", IRFFT2_FRAMES + [(1, 256, 33)], ids=_shape_id)
def test_irfft2_register_passes_are_the_plain_version_bit_for_bit(shape):
    """The kernel's schedule (pack, column passes, untangle in the first row
    pass, row passes) on the radix-2 register passes, against the plain
    version on the stage panel: the same butterflies and twiddles in the
    same order, so the same bits; the tall frame's too."""
    y = torch.from_numpy(_half_spectra(shape, 7 * shape[1] + shape[2]))
    got = k._irfft2_regpass(y, k._regpass_panel_r2)
    assert torch.equal(got, k.irfft2_fused_plain(y, radix=2))


def test_irfft2_plain_is_the_radix_4_order_on_the_radix_2_panel():
    """Both radices run one schedule (``_irfft2_regpass``); only the panel
    differs, and the results agree to float32 rounding."""
    y = torch.from_numpy(_half_spectra((2, 64, 33), 5))
    r2, r4 = (k.irfft2_fused_plain(y, radix=radix) for radix in (2, 4))
    assert torch.equal(r4, k._irfft2_regpass(y, k._regpass_panel))
    _close(r2.numpy(), r4.numpy())


# ------------------------------- fft2_columns -------------------------------


@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("inverse", [False, True])
def test_columns_register_passes_are_the_plain_version_bit_for_bit(h, inverse):
    """The column panel at every height the kernel serves on the radix-2
    register passes (one pass of radix H up to 16, then passes of 16),
    against fft2_columns_plain at radix 2, forward and inverse."""
    x = torch.from_numpy(_half_spectra((2, h, 3), h + inverse))
    cols = x.transpose(-1, -2).reshape(2 * 3, h)
    twin = k._fft_plain(cols, k._regpass_panel_r2, inverse)
    twin = twin.reshape(2, 3, h).transpose(-1, -2)
    got = k.fft2_columns_plain(x, radix=2, inverse=inverse)
    assert torch.equal(got, twin)
    ref = (np.fft.ifft if inverse else np.fft.fft)(x.numpy().astype(np.complex128), axis=1)
    _close(got.numpy(), ref)


# ------------------------------ the C entries -------------------------------


def test_wrappers_hand_the_padded_census_to_the_entries(monkeypatch):
    """Off the CPU (a meta tensor takes the card route up to the launch) the
    radix-2 wrappers call their C entries with the register-pass census:
    16 values a thread, the frame or panel and the ROM padded."""
    calls = []
    monkeypatch.setattr(k, "_launch", lambda entry, name, x, *args: calls.append((entry, args)))
    meta = torch.device("meta")
    k.irfft2_fused(torch.empty(3, 256, 33, dtype=torch.complex64, device=meta), radix=2)
    k.fft2_columns(torch.empty(2, 512, 257, dtype=torch.complex64, device=meta), radix=2)
    g = k.fft2_columns_geometry(512, 257)
    assert calls == [
        ("repro_irfft2_fused", (0, 0, 3, 256, 64, 2, 512, k.rfft2_smem_bytes(256, 64))),
        ("repro_fft2_columns", (0, 0, 2, 512, 257, 2, g.cols, g.threads, g.smem, 0, 1.0)),
    ]
    assert k.rfft2_smem_bytes(256, 64) >= (k.smem_slot(256 * 32) + k.smem_slot(128)) * 8
    assert g.smem == (k.smem_slot(g.cols * 512) + k.smem_slot(256)) * 8


def test_the_stage_panel_is_gone_from_the_sources():
    """No kernel runs the stage-at-a-time panel any more: its device
    functions, and the two kernels that ran it, are deleted."""
    names = ("stockham_panel", "radix2_stage", "struct Lines", "irfft2_fused_kernel",
             "fft2_columns_kernel")
    for src in sorted(CSRC.glob("*.cu*")):
        text = src.read_text()
        assert not [n for n in names if n in text], src.name


# ------------------------------- the planner --------------------------------


@pytest.mark.parametrize("h", HEIGHTS)
def test_columns_are_priced_by_the_register_passes(h):
    """fft2_columns: one round trip and the panel's exchanges at either
    radix, as a one-block row of H values."""
    want = (1, k.regpass_exchanges(h))
    assert autotune._column_cost(h, 2) == autotune._column_cost(h, 4) == want


def test_inverse_real_frames_are_priced_as_at_radix_4():
    """Every admitted real frame's inverse: the same frame passes at both
    radices (columns first, the pack and the untangle in the first passes'
    reads: no exchange of their own)."""
    frames = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 15)
              if k.rfft2_fits_smem(1 << a, 1 << b)]
    assert len(frames) == 105
    for h, w in frames:
        want = k.frame_passes(h, w, real=True, inverse=True).exchanges
        assert autotune._frame_passes(h, w, 2, True, True) == want, (h, w)
    assert k.frame_passes(128, 128, real=True, inverse=True) == ((16, 4), (16, 8), 3, 5)
