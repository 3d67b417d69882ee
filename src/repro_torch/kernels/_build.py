"""Build and load the port's CUDA kernels (``kernels/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The build runs
at first use and is keyed by a hash of the sources and flags, so a fresh
checkout builds once and every later process loads the same file. Each
``.cu`` file compiles in its own ``nvcc`` process, all started together.
Nothing here runs at import time: the CPU tests import every module and
never reach this code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

__all__ = ["build", "build_log", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
#: ``build/repro_torch_kernels/`` at the root of the checkout (git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong

#: C entry points and their argument types (every pointer and the stream
#: as ``c_void_p``, so ctypes never cuts them to 32 bits).
_SIGNATURES = {
    "repro_fft_fused": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "repro_rfft_fused": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_irfft_fused": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_two_pass_columns": (_P, _P, *(_I,) * 7, _I, _P),
    "repro_two_pass_rows": (_P, _P, *(_I,) * 7, _F, _I, _P),
    "repro_two_pass_recombine": (_P, _P, _I, _I, _I, _P),
    "repro_two_pass_untangle": (_P, _P, _I, _I, _I, _P),
    "repro_fft_cluster": (_P, _P, *(_I,) * 8, _F, _I, _P),
    "repro_fft_cluster_occupancy": (*(_I,) * 7,),
    "repro_fft2_fused": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "repro_rfft2_fused": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_irfft2_fused": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_fft2_columns": (_P, _P, *(_I,) * 8, _F, _I, _P),
    "repro_butterfly_stage": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_flash_attention_fwd": (_P, _P, _P, _P, _P, *(_I,) * 8, _LL, _F, *(_I,) * 5, _P),
    "repro_flash_attention_bwd": (*(_P,) * 10, *(_I,) * 8, _LL, _F, *(_I,) * 6, _P),
    "repro_flash_attention_occupancy": (_I, _I, _I),
    "repro_slstm_scan": (*(_P,) * 17, *(_I,) * 10, _P),
    "repro_slstm_occupancy": (_I, _I, _I, _I),
    "repro_slstm_scan_bwd": (*(_P,) * 19, *(_I,) * 10, _P),
    "repro_slstm_bwd_occupancy": (_I, _I, _I, _I),
    "repro_slstm_barriers": (_P, _I, _I, _I, _I, _P),
}

_LIB: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` printed for the current library (registers,
    shared memory and spills of each kernel); empty before a build."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build() -> Path:
    """Compile the sources unless a library of the same hash exists.

    Every ``.cu`` compiles in parallel; the objects are linked into a
    temporary file that is renamed into place, so concurrent builders
    never load a half-written library. Raises ``RuntimeError`` with the
    compiler's output when a source does not compile.
    """
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        try:
            for src in _sources():
                if src.suffix != ".cu":
                    continue
                obj = Path(tmp) / (src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            logs, failed = [], []
            for src, _, proc in procs:
                out, _ = proc.communicate()
                logs.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with every C
    entry's ``argtypes`` and ``restype`` declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
