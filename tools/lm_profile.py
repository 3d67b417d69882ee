"""Where the port's LM serving spends its host and card time: one lane
batch's prefill and one decode step at an architecture's full width
(``--arch``, default llama3.2-3b; any family ``build`` serves: dense, vlm,
ssm, hybrid, audio; bf16 compute over float32 weights, random from a
seeded generator), on one NVIDIA card. whisper's prefill takes
``frames_for``'s frame embeddings (its encoder runs in every prefill);
fourier_lm, which has no decode step, gives its forward (``prefill_fn``,
every block's mixing on the FFT kernels) under ``forward`` instead, its
sequence a power of two.

    python3 tools/lm_profile.py --batch 4 --prompt-lens 16,1024
    python3 tools/lm_profile.py --arch xlstm-350m --batch 4 --prompt-lens 16,1024
    python3 tools/lm_profile.py --arch whisper-medium --batch 4 --prompt-lens 16,128
    python3 tools/lm_profile.py --arch fourier_lm --batch 8 --prompt-lens 2048
    python3 tools/lm_profile.py --arch mixtral-8x22b --layers 2 --batch 4 --prompt-lens 16,1024
    python3 tools/lm_profile.py --arch deepseek-v3-671b --layers 2 --dense 1 --bf16-experts \
        --batch 4 --prompt-lens 16,1024

``--train`` profiles one training step instead (``make_train_step`` of
the model's ``loss_fn`` on ``make_batch``'s batch of ``--batch`` x each
prompt length, AdamW state beside the weights, remat as configured) under
``train_step``:

    python3 tools/lm_profile.py --train --batch 2 --prompt-lens 1024
    python3 tools/lm_profile.py --train --arch fourier_lm --batch 8 --prompt-lens 2048

``--layers`` cuts the config in depth (the moe family: ``--dense`` of them
dense, the config's own count if not given; ``--bf16-experts`` draws and
holds the routed experts in bf16, as chip_smoke's lm moe phase does for
deepseek-v3).

For each prompt length one JSON line with, for ``prefill`` (``prefill_fn``
on the batch's prompts) and ``decode`` (``decode_fn`` at the next
position, after that prefill), or ``forward``:

- ``host_ms``: host wall time a call takes to return, enqueued and not
  waited for, over 5 back-to-back calls; ``top``: the 12 functions with
  the most own host time under ``cProfile`` (µs a call);
- ``card``: a ``torch.profiler`` trace of 3 back-to-back calls (the
  kernels, their busy µs, the union of busy time over the window from the
  first kernel's start to the last one's end, and the idle share of that
  window), read as ``tools/stream_profile.py`` reads its traces;
- ``card_top``: the 8 kernel names with the most card µs in one traced
  call (summed over their launches), with their launch counts;
- ``wall_ms``: one call waited for (``torch.cuda.synchronize``);
- ``ops``: card µs of one traced call by aten operation, from the
  profiler's ``key_averages``: the 14 with the most card time (the moe
  block's ``sort``, its scatter ``index_put_`` and grouped products
  ``bmm``, MLA's absorbed decode products ``einsum``, the weight casts
  ``_to_copy``, ...), each with its calls. (``record_function`` ranges
  around the model's blocks were tried: their device time did not add up,
  the ranges reading more card time than the whole call.)

Prints the card's name and power limit first. Needs CUDA; exits 2 without.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from stream_profile import card, host  # noqa: E402  (the same trace reading)


def card_top(torch, fn, top: int = 8):
    """Card µs and launches by kernel name over one traced call of ``fn``."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            row = by_name.setdefault(e["name"][:120], {"us": 0.0, "launches": 0})
            row["us"] += e["dur"]
            row["launches"] += 1
    rows = sorted(by_name.items(), key=lambda kv: kv[1]["us"], reverse=True)[:top]
    return [{"kernel": name, **row} for name, row in rows]


def card_ops(torch, fn, top: int = 14):
    """Card µs and calls of one traced call of ``fn`` by aten operation
    (``key_averages``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)

    aten = sorted((e for e in prof.key_averages() if e.key.startswith("aten::")),
                  key=device_us, reverse=True)[:top]
    return [{"op": e.key, "us": device_us(e), "calls": e.count} for e in aten]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-lens", default="16,1024")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dense", type=int, default=None)
    ap.add_argument("--bf16-experts", action="store_true")
    ap.add_argument("--train", action="store_true", help="profile a training step")
    args = ap.parse_args()
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_profile: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import frames_for, make_batch
    from repro_torch.kernels import _build
    from repro_torch.models import moe
    from repro_torch.models.build import build
    from repro_torch.models.param import init_params

    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    if args.dense is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, n_dense_layers=args.dense))
    model = build(cfg)
    skel = moe.with_expert_dtype(model.skeleton, torch.bfloat16) if args.bf16_experts \
        else model.skeleton
    params = init_params(skel, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    for s in (int(n) for n in args.prompt_lens.split(",")):
        b = args.batch
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
        batch = {"tokens": toks}
        if cfg.family == "audio":
            batch["frames"] = frames_for(cfg, b, 0, device=dev)
        if args.train:
            from repro_torch.optim import adamw_init
            from repro_torch.train.loop import TrainState, make_train_step

            caches = None
            state = TrainState(params, adamw_init(params))
            step, train_batch = make_train_step(model.loss_fn), make_batch(cfg, b, s, 0,
                                                                            device=dev)
            calls = {"train_step": lambda: step(state, train_batch)}
        elif model.decode_fn is None:
            caches = None
            calls = {"forward": lambda: model.prefill_fn(params, batch, None)}
        else:
            caches = model.init_cache_fn(b, 2 * s, torch.float32, dev)
            logits, caches = model.prefill_fn(params, batch, caches)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            calls = {
                "prefill": lambda: model.prefill_fn(params, batch, caches),
                "decode": lambda: model.decode_fn(params, tok, s, caches),
            }
        line = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "prompt_len": s,
                "compute_dtype": cfg.compute_dtype}
        for name, fn in calls.items():
            host_us, top = host(torch, fn, 1, calls=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            line[name] = {"host_ms": host_us / 1e3, "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "card": card(torch, fn, calls=3), "card_top": card_top(torch, fn),
                          "ops": card_ops(torch, fn),
                          "top": [dict(row, own_us_per_call=row.pop("own_us_per_step"),
                                       calls_per_call=row.pop("calls_per_step")) for row in top]}
        print(json.dumps(line), flush=True)
        del caches, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
