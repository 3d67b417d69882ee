"""Run the register-pass FFT kernels of ``src/repro_torch/kernels/csrc`` on
the CPU, against their plain versions, where there is no nvcc and no card.

The ``.cu`` sources compile with g++ as plain C++ against the stand-in
``cuda_runtime.h`` beside this file (one ``std::thread`` per CUDA thread,
``std::barrier`` for ``__syncthreads``); ``extern __shared__`` and ``<<<>>>``
are rewritten on the way. The library goes to ``build/cuda_emu`` and is
called through ctypes with the census's own launch geometry. This checks the
indexing, barriers and shared-memory bounds, not ptxas or timing: watch the
chip's build log all the same. ``compile_library`` builds any of the
``.cu`` sources so; ``tests/test_torch_slstm_emu.py`` runs ``slstm_scan.cu``
through it, and ``tests/test_torch_fft2_columns.py`` ``fft2_columns.cu``.

    PYTHONPATH=src python tools/cuda_emu/emulate.py 8x8 128x128 16384x2
    PYTHONPATH=src python tools/cuda_emu/emulate.py --all     # every admitted frame
    PYTHONPATH=src python tools/cuda_emu/emulate.py --rows    # fft_fused / rfft_fused / irfft_fused, n = 2 ... 2^14, radix 4 and 2
    PYTHONPATH=src python tools/cuda_emu/emulate.py --two-pass  # fft_two_pass, n = 2^15 ... 2^20
    PYTHONPATH=src python tools/cuda_emu/emulate.py --radix 2 128x128  # the frames at radix 2

Prints each frame's largest error relative to max|twin| and to numpy, and
exits 1 if a launch fails or an error vs the twin passes ``--tol``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fft_radix2 as k

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
SOURCES = ("fft2_fused.cu", "rfft2_fused.cu", "fft_fused.cu", "fft_two_pass.cu")
TWO_PASS_ENTRIES = ("repro_two_pass_columns", "repro_two_pass_rows", "repro_two_pass_recombine",
                    "repro_two_pass_untangle")


def compile_library(out: Path, sources, defines=()) -> ctypes.CDLL:
    """Compile ``sources`` (file names in ``csrc``) with g++ against the
    stand-in headers, with ``-D`` of each of ``defines``, into
    ``out/libemu.so`` and load it."""
    out.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    objs = []
    for name in sources:
        s = (CSRC / name).read_text()
        s = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                   r"\1* \2 = reinterpret_cast<\1*>(emu::g_smem);", s)
        s = re.sub(r"(\w[\w:<>]*)<<<(.*?)>>>\(", r"emu::launch(\1, \2, ", s, flags=re.S)
        (out / (name + ".cpp")).write_text(s)
        objs.append(str(out / (name + ".cpp")))
    lib = out / "libemu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{HERE}",
                    f"-I{out}", "-Wno-unknown-pragmas", *(f"-D{x}" for x in defines), "-o",
                    str(lib), *objs], check=True)
    return ctypes.CDLL(str(lib))


def build(out: Path) -> ctypes.CDLL:
    so = compile_library(out, SOURCES)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (so.repro_fft2_fused, so.repro_fft_fused):
        fn.argtypes = [P, P, I, I, I, I, I, I, I, F, I, P]
    for fn in (so.repro_rfft2_fused, so.repro_irfft2_fused, so.repro_rfft_fused,
               so.repro_irfft_fused):
        fn.argtypes = [P, P, I, I, I, I, I, I, I, P]
    for name in TWO_PASS_ENTRIES:
        getattr(so, name).argtypes = list(_build._SIGNATURES[name])
    return so


def rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def frames(lib, h, w, rng, radix=4):
    """(errors vs twin, lines) of fft2 / ifft2 / rfft2 / irfft2 on two (h, w)
    frames at ``radix``; irfft2 on a half spectrum that is not Hermitian,
    whose DC and Nyquist imaginary parts the kernel must drop as numpy
    does."""
    errs, out = [], []
    if k.fft2_fits_smem(h, w):
        x = (rng.standard_normal((2, h, w)) + 1j * rng.standard_normal((2, h, w))).astype(np.complex64)
        for inverse in (False, True):
            y = np.full_like(x, np.nan)
            rc = lib.repro_fft2_fused(x.ctypes.data, y.ctypes.data, 2, h, w, radix,
                                      k.block_threads(h * w), k.fft2_smem_bytes(h, w), int(inverse),
                                      1.0 / (h * w) if inverse else 1.0, 0, None)
            assert rc == 0, f"fft2 {h}x{w}: rc {rc}"
            twin = k.fft2_fused_plain(torch.from_numpy(x), radix=radix, inverse=inverse).numpy()
            ref = (np.fft.ifft2 if inverse else np.fft.fft2)(x.astype(np.complex128))
            errs.append(rel(y, twin))
            out.append(f"{'ifft2' if inverse else 'fft2'} {errs[-1]:.1e} np {rel(y, ref):.1e}")
    if k.rfft2_fits_smem(h, w):
        r = rng.standard_normal((2, h, w)).astype(np.float32)
        y = np.full((2, h, w // 2 + 1), np.nan, np.complex64)
        rc = lib.repro_rfft2_fused(r.ctypes.data, y.ctypes.data, 2, h, w, radix,
                                   k.block_threads(h * (w // 2)), k.rfft2_smem_bytes(h, w), 0, None)
        assert rc == 0, f"rfft2 {h}x{w}: rc {rc}"
        twin = k.rfft2_fused_plain(torch.from_numpy(r), radix=radix).numpy()
        errs.append(rel(y, twin))
        out.append(f"rfft2 {errs[-1]:.1e} np {rel(y, np.fft.rfft2(r.astype(np.float64))):.1e}")
        z = (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)).astype(np.complex64)
        back = np.full((2, h, w), np.nan, np.float32)
        rc = lib.repro_irfft2_fused(z.ctypes.data, back.ctypes.data, 2, h, w, radix,
                                    k.block_threads(h * (w // 2)), k.rfft2_smem_bytes(h, w), 0,
                                    None)
        assert rc == 0, f"irfft2 {h}x{w}: rc {rc}"
        twin = k.irfft2_fused_plain(torch.from_numpy(z), radix=radix).numpy()
        errs.append(rel(back, twin))
        ref = np.fft.irfft2(z.astype(np.complex128), s=(h, w))
        out.append(f"irfft2 {errs[-1]:.1e} np {rel(back, ref):.1e}")
    return errs, out


def rows(lib, n, b, rng, radix=4):
    """Errors vs twin of fft / ifft / rfft / irfft on (b, n) rows at ``radix``
    (irfft on a half spectrum that is not Hermitian), each launched with the
    census's row tile: a batch of 3 leaves the last tile's fourth row masked
    where a tile holds four rows or more."""
    errs = []
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    t = k.pick_row_tile(b, n)
    for inv in (0, 1):
        y = np.full_like(x, np.nan)
        assert lib.repro_fft_fused(x.ctypes.data, y.ctypes.data, b, n, radix, t,
                                   k.block_threads(t * n), k.fft_smem_bytes(n, t), inv,
                                   1.0 / n if inv else 1.0, 0, None) == 0
        errs.append(rel(y, k.fft_fused_plain(torch.from_numpy(x), radix=radix,
                                             inverse=bool(inv)).numpy()))
    r = rng.standard_normal((b, n)).astype(np.float32)
    t = k.pick_row_tile(b, n // 2)
    y = np.full((b, n // 2 + 1), np.nan, np.complex64)
    assert lib.repro_rfft_fused(r.ctypes.data, y.ctypes.data, b, n, radix, t,
                                k.block_threads(t * n // 2), k.rfft_smem_bytes(n, t), 0, None) == 0
    errs.append(rel(y, k.rfft_fused_plain(torch.from_numpy(r), radix=radix).numpy()))
    z = (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)).astype(np.complex64)
    back = np.full((b, n), np.nan, np.float32)
    assert lib.repro_irfft_fused(z.ctypes.data, back.ctypes.data, b, n, radix, t,
                                 k.block_threads(t * n // 2), k.irfft_smem_bytes(n, t), 0,
                                 None) == 0
    errs.append(rel(back, k.irfft_fused_plain(torch.from_numpy(z), radix=radix).numpy()))
    return errs


def _two_pass(lib, x, y, b, m, conj, scale):
    """The column and the row pass on b rows of m complex values, x -> y
    (which may be x), through a scratch, as ``fft_radix2._two_pass``."""
    g = k.two_pass_geometry(m)
    scratch = np.full((b, m), np.nan, np.complex64)
    assert lib.repro_two_pass_columns(x.ctypes.data, scratch.ctypes.data, b, g.n1, g.n2, g.cols,
                                      g.col_threads, g.col_smem, conj, 0, None) == 0
    assert lib.repro_two_pass_rows(scratch.ctypes.data, y.ctypes.data, b, g.n1, g.n2, g.rows,
                                   g.row_threads, g.row_smem, conj, scale, 0, None) == 0


def two_pass(lib, n, b, rng):
    """Errors vs the plain versions of fft / ifft / rfft / irfft on (b, n)
    rows over one block, each through the C entries the wrappers launch at
    the census's geometry: the two passes (and the recombination after them,
    or the untangling before them, into the output itself); irfft on a half
    spectrum that is not Hermitian."""
    errs = []
    x = (rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    for inv in (0, 1):
        y = np.full_like(x, np.nan)
        _two_pass(lib, x, y, b, n, inv, 1.0 / n if inv else 1.0)
        errs.append(rel(y, k.fft_two_pass_plain(torch.from_numpy(x), inverse=bool(inv)).numpy()))
    m = n // 2
    r = rng.standard_normal((b, n)).astype(np.float32)
    z = np.full((b, m), np.nan, np.complex64)
    _two_pass(lib, r, z, b, m, 0, 1.0)
    y = np.full((b, m + 1), np.nan, np.complex64)
    assert lib.repro_two_pass_recombine(z.ctypes.data, y.ctypes.data, b, m, 0, None) == 0
    errs.append(rel(y, k.rfft_two_pass_plain(torch.from_numpy(r)).numpy()))
    h = (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)).astype(np.complex64)
    back = np.full((b, n), np.nan, np.float32)
    assert lib.repro_two_pass_untangle(h.ctypes.data, back.ctypes.data, b, m, 0, None) == 0
    _two_pass(lib, back, back, b, m, 1, 1.0 / m)
    errs.append(rel(back, k.irfft_two_pass_plain(torch.from_numpy(h)).numpy()))
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", nargs="*", help="HxW frames (default 8x8 16x64 128x128)")
    ap.add_argument("--all", action="store_true", help="every frame either census admits")
    ap.add_argument("--rows", action="store_true",
                    help="the 1D kernels, n = 2 ... 2^14, batches 3 and 1, radix 4 and 2")
    ap.add_argument("--two-pass", action="store_true",
                    help="fft_two_pass, n = 2^15 ... 2^18 on batches 3 and 1, then 2^19 "
                         "and 2^20 on one row (the 1024-thread instances of n1, n2 = 1024)")
    ap.add_argument("--radix", type=int, default=4, choices=(2, 4), help="the frames' radix")
    ap.add_argument("--tol", type=float, default=2e-5, help="largest error vs the twin")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "cuda_emu")
    args = ap.parse_args(argv)
    lib = build(args.out)
    worst = 0.0
    if args.rows:
        for radix in (4, 2):
            for n in (2 ** p for p in range(1, 15)):
                for b in (3, 1):
                    errs = rows(lib, n, b, np.random.default_rng(n + b), radix)
                    worst = np.max([worst, *errs])
                    print(f"rows radix {radix} n={n} b={b}: " + " ".join(f"{e:.1e}" for e in errs),
                          flush=True)
    if args.two_pass:
        for n in (2 ** p for p in range(15, 21)):
            for b in ((3, 1) if n <= 2 ** 18 else (1,)):
                errs = two_pass(lib, n, b, np.random.default_rng(n + b))
                worst = np.max([worst, *errs])
                print(f"two-pass n={n} b={b}: " + " ".join(f"{e:.1e}" for e in errs), flush=True)
    if args.all:
        shapes = [(1 << a, 1 << b) for a in range(1, 15) for b in range(1, 16)
                  if k.fft2_fits_smem(1 << a, 1 << b) or k.rfft2_fits_smem(1 << a, 1 << b)]
    else:
        shapes = [tuple(int(v) for v in f.split("x")) for f in args.frames]
        if not shapes and not (args.rows or args.two_pass):
            shapes = [(8, 8), (16, 64), (128, 128)]
    for h, w in shapes:
        errs, out = frames(lib, h, w, np.random.default_rng(h * 1000 + w), args.radix)
        worst = np.max([worst, *errs])
        print(f"{h}x{w}: " + " | ".join(out), flush=True)
    # np.max keeps a NaN (an output the kernel never wrote), which fails the tolerance
    print(f"worst vs twin {worst:.2e} (tol {args.tol:g})")
    return 0 if worst <= args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
