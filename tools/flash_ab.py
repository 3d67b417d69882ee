"""flash_attention_fwd from two source trees, in turns, on one NVIDIA card.

    git archive HEAD src | tar -x -C build/parent      # the parent's tree
    python3 tools/flash_ab.py build/parent             # against this checkout
    python3 tools/flash_ab.py build/parent OTHER_ROOT

Runs the trees in turns (other, this, this, other), one process each, so
that each builds its own kernels (``repro_torch.kernels._build``, keyed by
a hash of the sources). In each process, for each shape below, three
seeded Gaussian (q, k, v) in float32 (scale 1/sqrt(D), the reference's
blocks 512 / 1024): the kernel's distance from its plain version and from
``mha_reference`` in float64, and the plain version's from float64, each
max|a - b| / max|b|; and the kernel's median CUDA-event time over 5 runs
of 10 launches. One JSON line a process, after the card's name and power
limit. Needs CUDA; exits 2 without.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: name: (BH, Sq, Sk, D, causal): llama3.2-3b's 24 heads over 4096 tokens and
#: its 4 × 1024 lane, zamba2-2.7b's shared block (D 160), whisper-medium's
#: encoder, a 16-token prefill's cross-attention and a decode step's.
SHAPES = {
    "llama": (24, 4096, 4096, 128, True),
    "llama_lane_1024": (96, 1024, 1024, 128, True),
    "zamba2": (128, 1024, 1024, 160, True),
    "whisper_encoder": (64, 1500, 1500, 64, False),
    "whisper_cross_16": (64, 16, 1500, 64, False),
    "whisper_decode": (64, 1, 1500, 64, False),
}

CHILD = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
_build.library()
dev = torch.device("cuda")


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def ms(fn, reps=10, batches=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


res = {}
for name, (bh, sq, sk, d, causal) in json.loads(sys.argv[2]).items():
    errs = []
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(bh, n, d, generator=g, device=dev) for n in (sq, sk, sk))
        opts = dict(causal=causal, block_q=512, block_k=1024)
        got = fa.flash_attention_fwd(q, k, v, **opts)
        plain = fa.flash_attention_plain(q, k, v, **opts)
        exact = fa.mha_reference(q.double(), k.double(), v.double(), causal=causal)
        errs.append({"kernel_vs_plain": rel(got, plain),
                     "kernel_vs_float64": rel(got.double(), exact),
                     "plain_vs_float64": rel(plain.double(), exact)})
        del exact
    res[name] = {"ms": ms(lambda: fa.flash_attention_fwd(q, k, v, **opts)),
                 **{key: max(e[key] for e in errs) for key in errs[0]}}
print(json.dumps({"root": sys.argv[1], "shapes": res}))
"""


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    this = str(Path(sys.argv[2]).resolve()) if len(sys.argv) == 3 else str(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in (other, this, this, other):
        run = subprocess.run([sys.executable, "-c", CHILD, root, json.dumps(SHAPES)],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
