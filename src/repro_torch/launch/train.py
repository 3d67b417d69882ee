"""Training launcher.

Port of ``repro.launch.train``, with ``--device`` (default ``cuda``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 3 --batch 2 --seq 1024 --ckpt ''
  PYTHONPATH=src python -m repro_torch.launch.train --arch fourier_lm --steps 200 \\
      --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 4

Weights are random, drawn on the device from a generator seeded 0;
batches come from ``repro_torch.data.make_batch``. ``--ckpt`` names the
checkpoint directory (default ``repro_torch_ckpt`` in the temporary
directory; an empty name trains without checkpoints). The reference's
``--distributed`` (``jax.distributed.initialize()`` and a GSPMD mesh over
every process) has no counterpart until the sharding slice: it raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's summary lines, and
    return ``{"cfg", "model", "loop", "losses", "seconds"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fourier_lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
                    help="checkpoint directory ('' for none)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host data parallelism (not ported yet)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.distributed:
        raise NotImplementedError(
            "--distributed: the reference's GSPMD mesh over every process has no "
            "counterpart yet (ROADMAP queue 1, item 12 (h), sharding)"
        )

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.build import build
    from repro_torch.train.loop import TrainLoop

    device = torch.device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    print(f"[train] arch={cfg.name} params={model.n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={device}")

    def batch_fn(step: int):
        return make_batch(cfg, args.batch, args.seq, step, device=device)

    loop = TrainLoop(
        model,
        ckpt_dir=args.ckpt,
        batch_fn=batch_fn,
        save_every=args.save_every,
        accum=args.accum,
        peak_lr=args.peak_lr,
        compress=args.compress,
    )
    t0 = time.perf_counter()
    losses = loop.run(torch.Generator(device=device).manual_seed(0), args.steps)
    dt = time.perf_counter() - t0
    steps = sorted(losses)
    if steps:
        first = np.mean([losses[s] for s in steps[: max(len(steps)//10, 1)]])
        last = np.mean([losses[s] for s in steps[-max(len(steps)//10, 1):]])
        print(f"[train] {len(steps)} steps in {dt:.1f}s "
              f"({dt/max(len(steps),1):.2f}s/step) loss {first:.3f} -> {last:.3f}")
    if loop.monitor.flags:
        print(f"[train] straggler flags: {loop.monitor.flags[:5]}")
    return {"cfg": cfg, "model": model, "loop": loop, "losses": losses, "seconds": dt}


if __name__ == "__main__":
    main()
