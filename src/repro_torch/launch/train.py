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
directory; an empty name trains without checkpoints).

``--distributed`` is data parallelism over the processes ``torchrun``
starts (one a card)::

  torchrun --nproc_per_node 4 -m repro_torch.launch.train --distributed \
      --arch fourier_lm --batch 8 --seq 2048 --steps 3 --ckpt ''

``init_process_group`` reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` from the environment, on NCCL (gloo for ``--device cpu``,
or ``--dist-backend gloo`` for ranks that share a card). A ``("data",)``
mesh spans the world; each rank takes its slice of the global batch as
``sharding.batch_specs`` places it (``tokens`` over ``data``), the
parameters are replicated, and the gradients are summed over the group,
weighted as ``train.loop.make_train_step`` says (one all-reduce a leaf,
or ``compressed_mean``'s under ``--compress``): every rank steps as one
process on the whole batch would. Rank 0 writes the checkpoints. The
reference's rules would shard the ``embed`` axis over ``data`` (FSDP);
the port replicates the parameters (ROADMAP, divergence 21).
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
                    help="data parallelism over the processes torchrun starts")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.build import build
    from repro_torch.train.loop import TrainLoop

    device = torch.device(args.device)
    mesh = group = None
    rank = 0
    if args.distributed:
        mesh, device = _init_distributed(args, device)
        group = mesh.get_group("data")
        rank = torch.distributed.get_rank()
    try:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        model = build(cfg)
        say = print if rank == 0 else (lambda *a, **k: None)
        world = mesh.size() if mesh is not None else 1
        say(f"[train] arch={cfg.name} params={model.n_params/1e6:.1f}M "
            f"batch={args.batch} seq={args.seq} device={device} world={world}")

        def batch_fn(step: int):
            batch = make_batch(cfg, args.batch, args.seq, step, device=device)
            return batch if mesh is None else _local_batch(cfg, batch, mesh, args.accum)

        loop = TrainLoop(
            model,
            ckpt_dir=args.ckpt,
            batch_fn=batch_fn,
            save_every=args.save_every,
            accum=args.accum,
            peak_lr=args.peak_lr,
            compress=args.compress,
            group=group,
        )
        t0 = time.perf_counter()
        losses = loop.run(torch.Generator(device=device).manual_seed(0), args.steps)
        dt = time.perf_counter() - t0
        steps = sorted(losses)
        if steps:
            first = np.mean([losses[s] for s in steps[: max(len(steps)//10, 1)]])
            last = np.mean([losses[s] for s in steps[-max(len(steps)//10, 1):]])
            say(f"[train] {len(steps)} steps in {dt:.1f}s "
                f"({dt/max(len(steps),1):.2f}s/step) loss {first:.3f} -> {last:.3f}")
        if loop.monitor.flags:
            say(f"[train] straggler flags: {loop.monitor.flags[:5]}")
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()
    return {"cfg": cfg, "model": model, "loop": loop, "losses": losses, "seconds": dt,
            "rank": rank, "world": world}


def _init_distributed(args, device):
    """The default process group from torchrun's environment and a
    ``("data",)`` mesh over it; the rank's device (``cuda:LOCAL_RANK``,
    modulo the cards, when several ranks share one under gloo)."""
    import torch
    import torch.distributed as dist

    from repro_torch.compat import make_mesh

    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if v not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed reads {', '.join(missing)} from the environment, "
                           "as torchrun sets them (torchrun --nproc_per_node N -m "
                           "repro_torch.launch.train --distributed ...)")
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: CUDA is not available; pass --device cpu")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://")
    return make_mesh((dist.get_world_size(),), ("data",), device_type=device.type), device


def _local_batch(cfg, batch: dict, mesh, accum: int) -> dict:
    """This rank's slice of the global batch, along the batch dim of every
    leaf whose ``batch_specs`` spec names the data axis (behind the leading
    [accum] dim when accum > 1); other leaves whole."""
    from repro_torch.compat import axis_index, axis_size
    from repro_torch.sharding.rules import batch_specs

    specs = batch_specs(cfg, "train", multi_pod=False)
    n, i = axis_size("data", mesh), axis_index("data", mesh)
    out = {}
    for key, x in batch.items():
        spec = specs.get(key)
        axes = spec[0] if spec is not None else None
        if axes is None or "data" not in ((axes,) if isinstance(axes, str) else axes):
            out[key] = x
            continue
        dim = 1 if accum > 1 else 0
        if x.shape[dim] % n:
            raise ValueError(f"--distributed: the global batch {x.shape[dim]} does not divide "
                             f"over {n} ranks")
        step = x.shape[dim] // n
        out[key] = x.narrow(dim, i * step, step)
    return out


if __name__ == "__main__":
    main()
