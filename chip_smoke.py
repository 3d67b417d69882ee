#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (first use builds them) and report the build seconds and the
             card (``nvidia-smi`` name and power limit, also on a line of
             its own);
2. kernel  — each kernel against its plain PyTorch version on the same
             inputs on the card, at the shapes the main path gives it, held
             to max|kernel - plain| / max|plain| <= 2e-5 (CUDA ``sincospif``
             against the host's cos/sin, and FMA contraction over up to 11
             stages); with the kernel's, the plain version's and the
             ``torch.fft`` yardstick's median times and the HBM bound;
3. request — requests through ``repro_torch.xfft`` as the streaming service
             of ``examples/serve_fft2d.py`` answers them (drifting-chirp
             frames plus noise, one request per batch). The launch counts
             are set to 0 just before and read just after; each request
             must raise the counts of the kernels it should use, agree with
             ``torch.fft`` to 2e-5 relative (round trips to 1e-4), and find
             the same dominant bins.

Then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is not 0 and the last line is not printed. Without CUDA the script
exits 2 and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL_KERNEL = 2e-5
TOL_REQUEST = 2e-5
TOL_ROUND_TRIP = 1e-4

PEAK_FLOPS_FP32 = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_bandwidth(card: str) -> float:
    """Bytes/s of the card's HBM: H100 SXM 3.35 TB/s, H100 PCIe 2.0 TB/s
    (NVIDIA data sheets)."""
    return 2.0e12 if "PCIe" in card else 3.35e12


def rel_err(got, ref) -> float:
    import torch

    got = got.to(torch.complex128) if got.is_complex() else got.double()
    ref = ref.to(torch.complex128) if ref.is_complex() else ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def max_abs(got, ref) -> float:
    return float((got - ref).abs().max())


def time_ms(fn, reps: int = 10, batches: int = 5) -> float:
    """Median over ``batches`` of the CUDA-event time of ``reps`` calls,
    per call (the calls queue back to back, so the card stays busy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    return statistics.median(samples)


def frame_source(step: int, batch: int, h: int, w: int, seed: int = 0):
    """The synthetic camera of examples/serve_fft2d.py: a drifting 2-D chirp
    plus noise, frame shape (h, w)."""
    import numpy as np

    rng = np.random.default_rng(seed ^ step)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    base = np.sin(2 * np.pi * (3 + step % 5) * xx) * np.cos(2 * np.pi * 2 * yy)
    noise = rng.standard_normal((batch, h, w)).astype(np.float32) * 0.1
    return base[None] + noise


def peaks(spec, full: bool = True):
    """Dominant non-DC bin of each frame (the service's detection).

    A real frame's full spectrum is Hermitian: bin (ky, kx) and its mirror
    (-ky, -kx) have the same magnitude, so argmax picks between the two on
    rounding alone. A full spectrum's peak is reported as the smaller flat
    index of the pair. A half spectrum (rfft2) holds such pairs only in its
    first and last columns, where the chirp frames have no peak.
    """
    h, w = spec.shape[-2], spec.shape[-1]
    mags = spec.abs().reshape(spec.shape[0], -1).clone()
    mags[:, 0] = 0
    p = mags.argmax(dim=1)
    if not full:
        return p
    mirror = ((-(p // w)) % h) * w + (-(p % w)) % w
    return p.minimum(mirror)


KERNELS = {
    "fft_fused": ("src/repro_torch/kernels/csrc/fft_fused.cu",
                  "src/repro/kernels/fft_radix2.py:279"),
    "rfft_fused": ("src/repro_torch/kernels/csrc/fft_fused.cu",
                   "src/repro/kernels/fft_radix2.py:319"),
    "irfft_fused": ("src/repro_torch/kernels/csrc/fft_fused.cu",
                    "src/repro/kernels/fft_radix2.py:358"),
    "fft2_fused": ("src/repro_torch/kernels/csrc/fft2_fused.cu",
                   "src/repro/kernels/fft_radix2.py:411"),
    "rfft2_fused": ("src/repro_torch/kernels/csrc/rfft2_fused.cu",
                    "src/repro/kernels/fft_radix2.py:452"),
    "irfft2_fused": ("src/repro_torch/kernels/csrc/rfft2_fused.cu",
                     "src/repro/kernels/fft_radix2.py:486"),
}


def kernel_phase(torch, k, card: str):
    """Each kernel against its plain version; returns the per-kernel rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                             torch.randn(*shape, generator=gen, device=dev))

    b, n = 8192, 2048
    cases = {
        "fft_fused": (crandn(b, n), k.fft_fused, k.fft_fused_plain,
                      lambda x: torch.fft.fft(x), 16 * b * n, 5.0 * b * n * 11),
        "rfft_fused": (torch.randn(b, n, generator=gen, device=dev), k.rfft_fused,
                       k.rfft_fused_plain, lambda x: torch.fft.rfft(x),
                       4 * b * n + 8 * b * (n // 2 + 1), 2.5 * b * n * 11),
        "irfft_fused": (crandn(b, n // 2 + 1), k.irfft_fused, k.irfft_fused_plain,
                        lambda x: torch.fft.irfft(x), 8 * b * (n // 2 + 1) + 4 * b * n,
                        2.5 * b * n * 11),
        "fft2_fused": (crandn(512, 128, 128), k.fft2_fused, k.fft2_fused_plain,
                       lambda x: torch.fft.fft2(x), 16 * 512 * 128 * 128,
                       5.0 * 512 * 128 * 128 * 14),
        "rfft2_fused": (torch.randn(512, 128, 128, generator=gen, device=dev), k.rfft2_fused,
                        k.rfft2_fused_plain, lambda x: torch.fft.rfft2(x),
                        4 * 512 * 128 * 128 + 8 * 512 * 128 * 65, 2.5 * 512 * 128 * 128 * 14),
        "irfft2_fused": (crandn(512, 128, 65), k.irfft2_fused, k.irfft2_fused_plain,
                         lambda x: torch.fft.irfft2(x),
                         8 * 512 * 128 * 65 + 4 * 512 * 128 * 128, 2.5 * 512 * 128 * 128 * 14),
    }
    bw = hbm_bandwidth(card)
    rows = {}
    for name, (x, kernel, plain, library, nbytes, flops) in cases.items():
        by_radix = {}
        for radix in (2, 4):
            got = kernel(x, radix=radix)
            ref = plain(x, radix=radix)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            by_radix[str(radix)] = {
                "rel_err": err,
                "max_abs_err": max_abs(got, ref),
                "ms": time_ms(lambda: kernel(x, radix=radix)),
                "plain_ms": time_ms(lambda: plain(x, radix=radix), reps=2, batches=3),
            }
            if not err <= TOL_KERNEL:
                raise AssertionError(f"{name} radix {radix}: rel err {err} > {TOL_KERNEL}")
            emit({"phase": "kernel", "kernel": name, "radix": radix,
                  "shape": list(x.shape), **by_radix[str(radix)]})
        bytes_ms = nbytes / bw * 1e3
        ops_ms = flops / PEAK_FLOPS_FP32 * 1e3
        r4 = by_radix["4"]
        rows[name] = {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": 0,
            "max_abs_err": max(v["max_abs_err"] for v in by_radix.values()),
            "rel_err": max(v["rel_err"] for v in by_radix.values()),
            "ms": r4["ms"],
            "plain_ms": r4["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(lambda: library(x)),
            "shape": list(x.shape),
            "by_radix": by_radix,
        }
        del x
        torch.cuda.empty_cache()
    return rows


def request_phase(torch, k, xfft, resolve_call):
    """Requests through xfft; returns the launch counts of the whole run."""
    dev = torch.device("cuda")

    def engine(kind, shape, direction="fwd", dtype="complex64"):
        return resolve_call(kind, tuple(shape), dev, dtype=dtype, direction=direction).variant

    def request(name, fn, expect, plan):
        before = dict(k.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {kn: k.LAUNCHES[kn] - before[kn] for kn in k.LAUNCHES}
        for kn in expect:
            if delta[kn] < 1:
                raise AssertionError(f"request {name}: {kn} was not launched ({delta})")
        return out, {"phase": "request", "name": name, "engine": plan, "launches": delta,
                     "ms": ms}

    def check(line, err, tol, what="rel_err"):
        line[what] = err
        if not err <= tol:
            raise AssertionError(f"request {line['name']}: {what} {err} > {tol}")

    def check_peaks(line, got, ref, full=True):
        agree = bool(torch.equal(peaks(got, full), peaks(ref, full)))
        line["peaks_agree"] = agree
        if not agree:
            raise AssertionError(f"request {line['name']}: dominant bins disagree")

    k.reset_launches()
    # 128x128 serving frames: the whole frame in one block, complex and real.
    frames = torch.from_numpy(frame_source(0, 512, 128, 128)).to(dev)
    spec, line = request("fft2 (512,128,128)", lambda: xfft.fft2(frames), ["fft2_fused"],
                         engine("fft2d", frames.shape))
    ref = torch.fft.fft2(frames)
    check(line, rel_err(spec, ref), TOL_REQUEST)
    check_peaks(line, spec, ref)
    emit(line)
    back, line = request("ifft2 (512,128,128)", lambda: xfft.ifft2(spec), ["fft2_fused"],
                         engine("fft2d", spec.shape, "inv"))
    check(line, rel_err(back, torch.fft.ifft2(spec)), TOL_REQUEST)
    check(line, max_abs(back.real, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    out, line = request("fft2 norm=ortho (512,128,128)",
                        lambda: xfft.fft2(frames, norm="ortho"), ["fft2_fused"],
                        engine("fft2d", frames.shape))
    check(line, rel_err(out, torch.fft.fft2(frames, norm="ortho")), TOL_REQUEST)
    emit(line)
    turned = frames.permute(1, 2, 0)  # (128, 128, 512), transform axes (0, 1)
    out, line = request("fft2 axes=(0,1) (128,128,512)",
                        lambda: xfft.fft2(turned, axes=(0, 1)), ["fft2_fused"],
                        engine("fft2d", frames.shape))
    check(line, rel_err(out, torch.fft.fft2(turned, dim=(0, 1))), TOL_REQUEST)
    emit(line)
    half, line = request("rfft2 (512,128,128)", lambda: xfft.rfft2(frames), ["rfft2_fused"],
                         engine("rfft2d", frames.shape, dtype="float32"))
    ref = torch.fft.rfft2(frames)
    check(line, rel_err(half, ref), TOL_REQUEST)
    check_peaks(line, half, ref, full=False)
    emit(line)
    back, line = request("irfft2 (512,128,128)", lambda: xfft.irfft2(half), ["irfft2_fused"],
                         engine("rfft2d", frames.shape, "inv", "float32"))
    check(line, rel_err(back, torch.fft.irfft2(half)), TOL_REQUEST)
    check(line, max_abs(back, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, spec, back, out, turned, half, ref

    # 1024x1024 holograms: two fft_fused passes with an HBM corner turn.
    frames = torch.from_numpy(frame_source(1, 16, 1024, 1024)).to(dev)
    spec, line = request("fft2 (16,1024,1024)", lambda: xfft.fft2(frames), ["fft_fused"],
                         engine("fft2d", frames.shape))
    ref = torch.fft.fft2(frames)
    check(line, rel_err(spec, ref), TOL_REQUEST)
    check_peaks(line, spec, ref)
    emit(line)
    back, line = request("ifft2 (16,1024,1024)", lambda: xfft.ifft2(spec), ["fft_fused"],
                         engine("fft2d", spec.shape, "inv"))
    check(line, rel_err(back, torch.fft.ifft2(spec)), TOL_REQUEST)
    check(line, max_abs(back.real, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, spec, back, ref

    # 512x512 CT frames, real input: over one block, so rows, an HBM
    # corner turn and columns.
    frames = torch.from_numpy(frame_source(2, 32, 512, 512)).to(dev)
    half, line = request("rfft2 (32,512,512)", lambda: xfft.rfft2(frames),
                         ["rfft_fused", "fft_fused"],
                         engine("rfft2d", frames.shape, dtype="float32"))
    ref = torch.fft.rfft2(frames)
    check(line, rel_err(half, ref), TOL_REQUEST)
    check_peaks(line, half, ref, full=False)
    emit(line)
    back, line = request("irfft2 (32,512,512)", lambda: xfft.irfft2(half),
                         ["fft_fused", "irfft_fused"],
                         engine("rfft2d", frames.shape, "inv", "float32"))
    check(line, rel_err(back, torch.fft.irfft2(half)), TOL_REQUEST)
    check(line, max_abs(back, frames) / float(frames.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    del frames, half, back, ref

    # 1D rows: 64 chirp frames of 512x512 laid out as 8192 rows of 2048.
    rows = torch.from_numpy(frame_source(3, 64, 512, 512)).to(dev).reshape(8192, 2048)
    crow = torch.complex(rows, rows.flip(0))
    out, line = request("fft (8192,2048)", lambda: xfft.fft(crow), ["fft_fused"],
                        engine("fft1d", crow.shape))
    check(line, rel_err(out, torch.fft.fft(crow)), TOL_REQUEST)
    emit(line)
    half, line = request("rfft (8192,2048)", lambda: xfft.rfft(rows), ["rfft_fused"],
                         engine("rfft1d", rows.shape, dtype="float32"))
    check(line, rel_err(half, torch.fft.rfft(rows)), TOL_REQUEST)
    emit(line)
    back, line = request("irfft (8192,1025)", lambda: xfft.irfft(half), ["irfft_fused"],
                         engine("rfft1d", rows.shape, "inv", "float32"))
    check(line, rel_err(back, torch.fft.irfft(half)), TOL_REQUEST)
    check(line, max_abs(back, rows) / float(rows.abs().max()), TOL_ROUND_TRIP,
          "round_trip_err")
    emit(line)
    return dict(k.LAUNCHES)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch import xfft
    from repro_torch.kernels import _build
    from repro_torch.kernels import fft_radix2 as k
    from repro_torch.plan.api import resolve_call

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card, "ptxas": ptxas})
    print(card, flush=True)

    rows = kernel_phase(torch, k, card)
    launches = request_phase(torch, k, xfft, resolve_call)
    for name, row in rows.items():
        row["launches"] = launches[name]
        if row["launches"] < 1:
            raise AssertionError(f"{name} was never launched on the main path")
    emit({"kernels": list(rows.values()), "card": card})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
