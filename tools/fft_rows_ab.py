"""The radix-2 FFT kernels and their radix-4 neighbours from two source trees, in turns, on one NVIDIA card.

    git archive HEAD src | tar -x -C build/parent      # the parent's tree
    python3 tools/fft_rows_ab.py build/parent          # against this checkout
    python3 tools/fft_rows_ab.py build/parent OTHER_ROOT

Runs the trees in turns (other, this, this, other), one process each, so
that each builds its own kernels (``repro_torch.kernels._build``, keyed by
a hash of the sources). In each process, on seeded Gaussian inputs at
chip_smoke.py's shapes, each kernel's distance from its plain version
(max|a - b| / max|b|) and its median CUDA-event time over 5 runs of 10
launches, beside the ``torch.fft`` call that computes the same:

* rows (8192, 2048), radix 2 and 4: ``fft_fused`` forward and inverse,
  ``rfft_fused``, and ``irfft_fused`` on their half spectra (8192, 1025);
* rows over one block, radix 2 (``fft_two_pass``): fft and ifft on
  TWO_PASS_COMPLEX (64, 2^18), rfft and irfft on TWO_PASS_REAL (256, 2^16);
* frames (512, 128, 128): ``fft2_fused``, ``rfft2_fused`` and
  ``irfft2_fused`` (on (512, 128, 65)) at radix 2 and 4; ``rfft2_fused``
  and ``irfft2_fused`` also on tall frames (1024, 256, 64) and their half
  spectra (1024, 256, 33); ``irfft2_fused`` also on 64x64 half spectra
  (8192, 64, 33), which like the tall ones the radix-2 kernel serves with
  its runtime geometry; ``fft2_columns`` at radix 2 and 4 on the CT
  frames (32, 512, 512) and on fourier_lm's mixing columns (8, 2048, 512).

One JSON line a process, after the card's name and power limit. Needs
CUDA; exits 2 without. chip_smoke.py checks every length and reads
ptxas's registers and spills.

    python3 tools/fft_rows_ab.py --once                # this checkout, one process
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels import fft_radix2 as k

_build.library()
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def ms(fn, reps=10, batches=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def crandn(*shape):
    return torch.complex(torch.randn(*shape, generator=g, device=dev),
                         torch.randn(*shape, generator=g, device=dev))


def case(fn, plain, library, arg):
    got = fn(arg)
    out = {"ms": ms(lambda: fn(arg)), "kernel_vs_plain": rel(got, plain(arg)),
           "library_ms": ms(lambda: library(arg))}
    del got
    torch.cuda.empty_cache()
    return out


b, n = 8192, 2048
x = crandn(b, n)
r = torch.randn(b, n, generator=g, device=dev)
half = crandn(b, n // 2 + 1)
res = {"library_ms": {"fft": ms(lambda: torch.fft.fft(x)), "rfft": ms(lambda: torch.fft.rfft(r)),
                      "irfft": ms(lambda: torch.fft.irfft(half))}}
for radix in (2, 4):
    one = {}
    for what, fn, plain, arg in (
            ("fft", lambda a: k.fft_fused(a, radix=radix),
             lambda a: k.fft_fused_plain(a, radix=radix), x),
            ("ifft", lambda a: k.fft_fused(a, radix=radix, inverse=True),
             lambda a: k.fft_fused_plain(a, radix=radix, inverse=True), x),
            ("rfft", lambda a: k.rfft_fused(a, radix=radix),
             lambda a: k.rfft_fused_plain(a, radix=radix), r),
            ("irfft", lambda a: k.irfft_fused(a, radix=radix),
             lambda a: k.irfft_fused_plain(a, radix=radix), half)):
        one[what] = {"ms": ms(lambda: fn(arg)), "kernel_vs_plain": rel(fn(arg), plain(arg))}
    res[f"radix {radix}"] = one
del x, r, half
bc, nc = 64, 2 ** 18
br, nr = 256, 2 ** 16
x = crandn(bc, nc)
two = {
    "fft": case(lambda a: k.fft_fused(a, radix=2), k.fft_two_pass_plain, torch.fft.fft, x),
    "ifft": case(lambda a: k.fft_fused(a, radix=2, inverse=True),
                 lambda a: k.fft_two_pass_plain(a, inverse=True), torch.fft.ifft, x),
}
del x
two["rfft"] = case(lambda a: k.rfft_fused(a, radix=2), k.rfft_two_pass_plain, torch.fft.rfft,
                   torch.randn(br, nr, generator=g, device=dev))
two["irfft"] = case(lambda a: k.irfft_fused(a, radix=2), k.irfft_two_pass_plain,
                    torch.fft.irfft, crandn(br, nr // 2 + 1))
res["two pass radix 2"] = {"shapes": [[bc, nc], [br, nr]], **two}
f = crandn(512, 128, 128)
frames = {f"fft2_fused r{radix}": case(lambda a: k.fft2_fused(a, radix=radix),
                                       lambda a: k.fft2_fused_plain(a, radix=radix),
                                       torch.fft.fft2, f) for radix in (2, 4)}
del f
r = torch.randn(512, 128, 128, generator=g, device=dev)
for radix in (2, 4):
    frames[f"rfft2_fused r{radix}"] = case(lambda a: k.rfft2_fused(a, radix=radix),
                                           lambda a: k.rfft2_fused_plain(a, radix=radix),
                                           torch.fft.rfft2, r)
r = torch.randn(1024, 256, 64, generator=g, device=dev)
for radix in (2, 4):
    frames[f"rfft2_fused r{radix} (1024, 256, 64)"] = case(
        lambda a: k.rfft2_fused(a, radix=radix), lambda a: k.rfft2_fused_plain(a, radix=radix),
        torch.fft.rfft2, r)
del r
for shape in ((512, 128, 65), (1024, 256, 33), (8192, 64, 33)):
    y = crandn(*shape)
    for radix in (2, 4):
        frames[f"irfft2_fused r{radix} {shape}"] = case(
            lambda a: k.irfft2_fused(a, radix=radix),
            lambda a: k.irfft2_fused_plain(a, radix=radix), torch.fft.irfft2, y)
    del y
for shape in ((32, 512, 512), (8, 2048, 512)):
    c = crandn(*shape)
    for radix in (2, 4):
        frames[f"fft2_columns r{radix} {shape}"] = case(
            lambda a: k.fft2_columns(a, radix=radix),
            lambda a: k.fft2_columns_plain(a, radix=radix),
            lambda a: torch.fft.fft(a, dim=-2), c)
    del c
res["frames (512, 128, 128)"] = frames
print(json.dumps({"root": sys.argv[1], "shape": [b, n], **res}))
"""


def main() -> int:
    args = sys.argv[1:]
    once = args == ["--once"]
    if not once and len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    other = None if once else str(Path(args[0]).resolve())
    this = str(Path(args[1]).resolve()) if len(args) == 2 else str(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("fft_rows_ab: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in (this,) if once else (other, this, this, other):
        run = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
