"""Serving launcher: batched greedy decoding over the ServeEngine.

Port of ``repro.launch.serve``, with ``--device`` (default ``cuda``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --batch 4 --prompt-len 16 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Every family ``build`` serves goes through the same path (dense, vlm,
ssm, hybrid, audio: whisper's lane batches carry ``frames_for`` frame
embeddings for the encoder). A model with no decode step (the spectral
fourier_lm) exits. Weights are random, drawn on the device from a
generator seeded 0.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.data.pipeline import frames_for, patches_for
    from repro_torch.models.build import build
    from repro_torch.serve.engine import Request, ServeEngine

    device = torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    if model.decode_fn is None:
        raise SystemExit(f"{cfg.name} has no decode step (encoder-style arch)")
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(
        model, params, batch=args.batch, max_len=args.max_len, dtype=torch.float32
    )
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = frames_for(cfg, args.batch, 0, device=device)
    if cfg.family == "vlm":
        extras["patches"] = patches_for(cfg, args.batch, 0, device=device)

    rng = np.random.default_rng(0)
    queue = [
        Request(prompt=rng.integers(0, cfg.vocab, (args.prompt_len,)).astype(np.int32),
                max_new=args.max_new)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    done = engine.serve_queue(queue, extras=extras or None)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/max(dt,1e-9):.1f} tok/s) arch={cfg.name} device={device}")
    print("[serve] sample output:", done[0].out[:8])
    return done


if __name__ == "__main__":
    main()
