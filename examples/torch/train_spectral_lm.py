"""Train the paper's own architecture: fourier_lm, an FNet-style masked LM
whose token-mixing layer IS the area-efficient 2D FFT engine (on the card
the planned FFT kernels, forward and backward).

Port of ``examples/train_spectral_lm.py``, with ``--device`` (default
``cuda``). Defaults train a small model for a quick run; --full trains the
~100M configuration (12L x 512 x 32768 vocab).

  PYTHONPATH=src python examples/torch/train_spectral_lm.py --steps 120
  PYTHONPATH=src python examples/torch/train_spectral_lm.py --full --steps 300
  PYTHONPATH=src python examples/torch/train_spectral_lm.py --device cpu --steps 40
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models.build import build
from repro_torch.train.loop import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config (12L x 512 x 32768 vocab)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "fourier_lm_ckpt"))
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config("fourier_lm")
    if not args.full:
        cfg = cfg.scaled(n_layers=4, d_model=128, d_ff=512, vocab=2048,
                         remat=False, compute_dtype="float32")
    model = build(cfg)
    print(f"[spectral-lm] params={model.n_params/1e6:.1f}M "
          f"(mixing = Re(FFT2), variant={cfg.fft_variant}) device={device}")

    loop = TrainLoop(
        model,
        ckpt_dir=args.ckpt,
        batch_fn=lambda s: make_batch(cfg, args.batch, args.seq, s, device=device),
        save_every=max(args.steps // 4, 10),
        peak_lr=args.peak_lr,
    )
    t0 = time.time()
    losses = loop.run(torch.Generator(device=device).manual_seed(0), args.steps)
    dt = time.time() - t0
    steps = sorted(losses)
    k = max(len(steps) // 10, 1)
    first = float(np.mean([losses[s] for s in steps[:k]]))
    last = float(np.mean([losses[s] for s in steps[-k:]]))
    print(f"[spectral-lm] {len(steps)} steps in {dt:.1f}s; "
          f"masked-LM loss {first:.3f} -> {last:.3f}")
    if last >= first:
        raise SystemExit("loss did not decrease")
    print("[spectral-lm] OK — the paper's engine trains as an LM mixing layer")


if __name__ == "__main__":
    main()
