"""flash_attention_fwd or _bwd from two source trees, in turns, on one NVIDIA card.

    git archive HEAD src | tar -x -C build/parent      # the parent's tree
    python3 tools/flash_ab.py build/parent             # against this checkout
    python3 tools/flash_ab.py build/parent OTHER_ROOT
    python3 tools/flash_ab.py --backward build/parent  # the backward kernel

Runs the trees in turns (other, this, this, other), one process each, so
that each builds its own kernels (``repro_torch.kernels._build``, keyed by
a hash of the sources). In each process, for each shape below, three
seeded Gaussian (q, k, v) in float32 (scale 1/sqrt(D), the reference's
blocks 512 / 1024): the kernel's distance from its plain version and from
``mha_reference`` in float64, and the plain version's from float64, each
max|a - b| / max|b|; and the kernel's median CUDA-event time over 5 runs
of 10 launches. One JSON line a process, after the card's name and power
limit. Needs CUDA; exits 2 without.

With ``--backward``, ``flash_attention_bwd`` at llama3.2-3b's training lane
and chip_smoke.py's TRAIN_BWD_CASES (q scaled first, scale 1, the
logsumexp from the tree's own forward, Gaussian cotangent): its distance
from its plain version and both from float64 autograd of
``mha_reference``, its median time over 5 runs of 10 launches beside the
backward of ``scaled_dot_product_attention`` on the same operands (a
window as a boolean mask), each of its kernels' mean device time over 10
calls from ``torch.profiler`` (the two passes' split), and ptxas's
registers and spills of the tree's backward kernels.
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

#: name: (BH, Sq, Sk, D, Dv, causal, window): llama3.2-3b's training lane
#: (2 x 1024 tokens, 24 heads) and chip_smoke.py's TRAIN_BWD_CASES.
BWD_SHAPES = {
    "llama train lane": (48, 1024, 1024, 128, 128, True, None),
    "window": (32, 1024, 1024, 128, 128, True, 256),
    "cross": (64, 128, 1500, 64, 64, False, None),
    "mla 192->128": (32, 512, 512, 192, 128, True, None),
    "dv 160": (32, 512, 512, 160, 160, True, None),
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

CHILD_BWD = r"""
import json, math, re, statistics, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
import torch.nn.functional as F
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
_build.library()
dev = torch.device("cuda")


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


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


def sdpa_ms(q, k, v, do, causal, window):
    kw = {"is_causal": causal}
    if window is not None:
        qpos = torch.arange(q.shape[1], device=dev)[:, None]
        kpos = torch.arange(k.shape[1], device=dev)[None, :]
        kw = {"attn_mask": (kpos > qpos - window) & ((kpos <= qpos) if causal else True)}
    qq, kk, vv = (x.detach()[None].requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, scale=1.0, **kw)
    return ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do[None], retain_graph=True))


ptxas, name = {}, None
for line in _build.build_log().splitlines():
    if "Compiling entry function" in line:
        m = re.search(r"(flash_bwd\w*?kernel)(I\w+?E)?E", line)
        name = m[1] + "".join("," + x for x in re.findall(r"Li(\d+)E", m[2] or "")) if m else None
    elif name and "spill stores" in line:
        ptxas[name] = {"spill_bytes": int(re.search(r"(\d+) bytes spill stores", line)[1])}
    elif name and "registers" in line:
        ptxas[name]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
        name = None
res = {}
for name, (bh, sq, sk, d, dv, causal, window) in json.loads(sys.argv[2]).items():
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(bh, sq, d, generator=g, device=dev) / math.sqrt(d)
    k = torch.randn(bh, sk, d, generator=g, device=dev)
    v = torch.randn(bh, sk, dv, generator=g, device=dev)
    do = torch.randn(bh, sq, dv, generator=g, device=dev)
    opts = dict(causal=causal, window=window, block_q=512, block_k=1024, scale=1.0)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **opts)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **opts)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    out = fa.mha_reference(q64 * math.sqrt(d), k64, v64, causal=causal, window=window)
    exact = torch.autograd.grad(out, (q64, k64, v64), do.double())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fa.flash_attention_bwd(q, k, v, o, do, lse, **opts)
        torch.cuda.synchronize()
    passes = {e.key: e.device_time_total / 1e3 / 10 for e in prof.key_averages()
              if "flash_bwd" in e.key}
    res[name] = {"ms": ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, **opts)),
                 "passes_ms": {re.sub(r"repro::\(anonymous namespace\)::", "", k): v
                               for k, v in passes.items()},
                 "sdpa_bwd_ms": sdpa_ms(q, k, v, do, causal, window),
                 "kernel_vs_plain": max(rel(a, b) for a, b in zip(got, plain)),
                 "kernel_vs_float64": max(rel(a, b) for a, b in zip(got, exact)),
                 "plain_vs_float64": max(rel(a, b) for a, b in zip(plain, exact))}
    del exact, out, q64, k64, v64
print(json.dumps({"root": sys.argv[1], "ptxas": ptxas, "shapes": res}))
"""


def main() -> int:
    args = sys.argv[1:]
    backward = "--backward" in args
    args = [a for a in args if a != "--backward"]
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    other = str(Path(args[0]).resolve())
    this = str(Path(args[1]).resolve()) if len(args) == 2 else str(ROOT)
    child, shapes = (CHILD_BWD, BWD_SHAPES) if backward else (CHILD, SHAPES)
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in (other, this, this, other):
        run = subprocess.run([sys.executable, "-c", child, root, json.dumps(shapes)],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
