"""Host time a call of the port's front door, of two kernel wrappers and of
an LM decode step, on one NVIDIA card: what the launch path costs the host
when no cost counter is in force.

    python3 tools/host_overhead.py
    python3 tools/host_overhead.py --src /path/to/other/tree/src --label parent

``--src`` imports ``repro_torch`` from another checkout's ``src`` (by
default this one's), so two trees compare on one card in one call: run
them in turn, A B B A, and read each pair of lines side by side. The
script uses only entry points that both trees share.

Each case is timed as host wall time of ``--calls`` back-to-back calls,
enqueued and not waited for, divided by the calls; ``--batches`` such
batches (the card synchronized between them) give the median and the
least, in µs a call (ms for the decode steps). The cases:

- ``fft_fused``: the row kernel's wrapper on (64, 1024) complex64;
- ``xfft.fft``: the front door on the same rows (planner, resilience
  ladder, then the same kernel);
- ``xfft.fft2``: the front door on (8, 256, 256) complex64;
- ``flash_fwd``: ``flash_attention_fwd`` at whisper-medium's decode
  cross-attention, (64, 1, 64) queries over 1500 keys;
- ``decode``: one decode step of whisper-medium (24 flash calls a step)
  and of llama3.2-3b (no kernel in its decode step), at full width, batch
  4 after a prompt of 16, random weights from a seed.

Prints the card's name and power limit first, then one JSON line. Needs
CUDA; exits 2 without.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_per_call(torch, fn, calls: int, batches: int) -> dict:
    """Median and least host wall time a call of ``fn`` over ``batches``
    batches of ``calls`` enqueued calls, in µs."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {"median_us": statistics.median(per), "min_us": min(per)}


def decode_case(torch, np, arch: str, dev, calls: int, batches: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import frames_for
    from repro_torch.models.build import build
    from repro_torch.models.param import init_params

    cfg = get_config(arch)
    model = build(cfg)
    params = init_params(model.skeleton, torch.Generator(device=dev).manual_seed(0))
    b, s = 4, 16
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
             .to(dev)}
    if cfg.family == "audio":
        batch["frames"] = frames_for(cfg, b, 0, device=dev)
    with torch.no_grad():
        caches = model.init_cache_fn(b, 2 * s, torch.float32, dev)
        logits, caches = model.prefill_fn(params, batch, caches)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        got = host_per_call(torch, lambda: model.decode_fn(params, tok, s, caches), calls,
                            batches)
    del params, caches
    torch.cuda.empty_cache()
    return {"median_ms": got["median_us"] / 1e3, "min_ms": got["min_us"] / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--batches", type=int, default=9)
    ap.add_argument("--decode-calls", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("host_overhead: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch import xfft
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.fft_radix2 import fft_fused

    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                             torch.randn(*shape, generator=gen, device=dev))

    rows, frames = crandn(64, 1024), crandn(8, 256, 256)
    q = torch.randn(64, 1, 64, generator=gen, device=dev)
    k = torch.randn(64, 1500, 64, generator=gen, device=dev)
    v = torch.randn(64, 1500, 64, generator=gen, device=dev)
    n, r = args.calls, args.batches
    line = {"label": args.label, "src": args.src, "calls": n, "batches": r}
    with torch.no_grad():
        line["fft_fused"] = host_per_call(torch, lambda: fft_fused(rows, radix=4), n, r)
        line["xfft.fft"] = host_per_call(torch, lambda: xfft.fft(rows), n, r)
        line["xfft.fft2"] = host_per_call(torch, lambda: xfft.fft2(frames), n, r)
        line["flash_fwd"] = host_per_call(
            torch, lambda: fa.flash_attention_fwd(q, k, v, causal=False), n, r)
    for arch in ("whisper-medium", "llama3.2-3b"):
        line[f"decode {arch}"] = decode_case(torch, np, arch, dev, args.decode_calls, r)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
