"""How far an LM at its random init amplifies a rounding-sized change.

    PYTHONPATH=src python tools/lm_sensitivity.py --arch xlstm-350m --layers 2,24
    PYTHONPATH=src python tools/lm_sensitivity.py --arch zamba2-2.7b --layers 6 --device cpu
    python tools/lm_sensitivity.py --arch whisper-medium --layers 2,24 --device cuda
    python tools/lm_sensitivity.py --arch mixtral-8x22b --layers 1,2 --device cuda
    python tools/lm_sensitivity.py --arch deepseek-v3-671b --layers 2 --dense 1 \
        --experts 32 --device cuda

For each depth: the architecture's full-width config cut to that many
layers (whisper: that many encoder and decoder layers, on ``frames_for``'s
frames; the moe family: ``--dense`` of them dense, the config's own count
if not given, and ``--experts`` routed experts, top-k kept), at float32
compute, weights from a generator seeded 0, 2 prompts
of 16 tokens; the embedding table (whisper: the frames) multiplied by
(1 + eps N(0, 1)) for each ``--eps``; one JSON line with the change of the
last position's logits relative to their largest value. A change of 1e-7 is a float32
rounding: where it moves the logits by more than a gate, two evaluations
that round in different places (two products of other shapes, a kernel
and its plain version) cannot be held to that gate at that depth.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--layers", default="2,24")
    ap.add_argument("--eps", default="1e-7,1e-6")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dense", type=int, default=None)
    ap.add_argument("--experts", type=int, default=None)
    args = ap.parse_args()
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import frames_for
    from repro_torch.models import transformer as T
    from repro_torch.models.build import build

    dev = torch.device(args.device)
    for layers in (int(n) for n in args.layers.split(",")):
        cfg = get_config(args.arch).scaled(n_layers=layers, compute_dtype="float32")
        if cfg.family == "audio":
            cfg = cfg.scaled(n_enc_layers=layers)
        if cfg.moe is not None:
            moe = cfg.moe
            if args.dense is not None:
                moe = dataclasses.replace(moe, n_dense_layers=args.dense)
            if args.experts is not None:
                moe = dataclasses.replace(moe, n_experts=args.experts)
            cfg = cfg.scaled(moe=moe)
        params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
                                .astype(np.int32)).to(dev)
        if cfg.family == "audio":
            # the perturbed input is the frames, the encoder's embeddings
            frames = frames_for(cfg, 2, 0, device=dev)

            def forward(x):
                return T.encdec_forward(params, toks, cfg, frames=x)[0][:, -1]
        else:
            frames = params["embed"]["table"].clone()
            lm = {"ssm": T.xlstm_forward, "hybrid": T.hybrid_forward}.get(cfg.family,
                                                                        T.lm_forward)

            def forward(x):
                params["embed"]["table"] = x
                return lm(params, toks, cfg)[0][:, -1]
        base = forward(frames)
        noise = torch.randn(frames.shape, generator=torch.Generator(device=dev).manual_seed(9),
                            device=dev)
        line = {"arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
                "device": str(dev), "change": {}}
        if cfg.moe is not None:
            line.update(dense_layers=min(cfg.moe.n_dense_layers, layers),
                        experts=cfg.moe.n_experts, top_k=cfg.moe.top_k)
        for eps in (float(e) for e in args.eps.split(",")):
            out = forward(frames * (1 + eps * noise))
            line["change"][str(eps)] = float((out - base).abs().max() / base.abs().max())
        print(json.dumps(line), flush=True)
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
