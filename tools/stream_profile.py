"""Where an eager ``fft2_stream`` call spends its host and card time, on one
NVIDIA card: the two-stream pipeline against the same steps on one stream.

    python3 tools/stream_profile.py --shapes 8x128x128,16x1024x1024 --unrolls 1,2

For each shape (complex64 frames, ``T x H x W``) and unroll it prints one
JSON line with, for the two-stream call (``fused_r4``) and for the same
steps on the caller's stream alone (``one_stream``):

- ``host_us_per_step``: host wall time of 20 back-to-back calls, each
  enqueued and not waited for, over their steps; ``top``: the 12
  functions with the most own host time under ``cProfile`` (µs a step);
- ``card``: a ``torch.profiler`` trace of 5 back-to-back calls, each
  kernel's start, duration and CUDA stream read from its Chrome trace:
  kernels a stream, their busy µs, the union of busy time over the
  window from the first kernel's start to the last one's end, and the
  idle share of that window.

Prints the card's name and power limit first. Needs CUDA; exits 2 without.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import one_stream  # noqa: E402  (the same one-stream yardstick)


def host(torch, fn, steps: int, calls: int = 20):
    """Host µs a step of ``calls`` enqueued calls, and cProfile's top own times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_step = (time.perf_counter() - t0) / (calls * steps) * 1e6
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:12]
    top = [{"fn": f"{Path(f).name}:{line}:{name}", "calls_per_step": nc / (calls * steps),
            "own_us_per_step": tt / (calls * steps) * 1e6}
           for (f, line, name), (_, nc, tt, _, _) in rows]
    return per_step, top


def card(torch, fn, calls: int = 5):
    """Kernels a stream, busy µs and the idle share of the window, from a
    torch.profiler trace of ``calls`` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        return {"kernels": 0, "note": "the trace holds no kernel"}
    streams = {}
    for start, end, stream in kernels:
        row = streams.setdefault(str(stream), {"kernels": 0, "busy_us": 0.0})
        row["kernels"] += 1
        row["busy_us"] += end - start
    busy, cur_start, cur_end = 0.0, kernels[0][0], kernels[0][1]
    for start, end, _ in kernels[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end, _ in kernels) - kernels[0][0]
    return {"streams": streams, "busy_us_per_call": busy / calls,
            "window_us_per_call": window / calls, "idle_share": 1.0 - busy / window}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="8x128x128,16x1024x1024")
    ap.add_argument("--unrolls", default="1,2")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stream_profile: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core.fft2d import fft2_stream
    from repro_torch.kernels import _build, ops

    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for spec in args.shapes.split(","):
        shape = tuple(int(d) for d in spec.split("x"))
        z = torch.randn(*shape, device="cuda").to(torch.complex64)
        for unroll in (int(u) for u in args.unrolls.split(",")):
            steps = -(-shape[0] // unroll)
            line = {"shape": list(shape), "unroll": unroll, "steps": steps}
            for name, fn in (("two_streams", lambda: fft2_stream(z, variant="fused_r4",
                                                                 unroll=unroll)),
                             ("one_stream", lambda: one_stream(ops, z, unroll, 4))):
                per_step, top = host(torch, fn, steps)
                line[name] = {"host_us_per_step": per_step, "top": top, "card": card(torch, fn)}
            print(json.dumps(line), flush=True)
        del z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
