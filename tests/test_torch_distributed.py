"""The multi-device pencil FFT and the ``fft2d_pencil`` kind on the CPU.

``repro_torch.core.distributed`` is held to ``repro.core.distributed`` on
8 devices. The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the rest of the
suite keeps seeing one device), each call under ``jax.jit`` (eager
``shard_map`` dispatches op by op, ten times slower); the port runs in one
``gloo`` group of 8 ranks, one process each, on CPU tensors. Both read the same numpy inputs,
made from a seed, on (64, 32), (3, 64, 64) and (128, 256):
``fft2_pencil`` under ``looped``, ``stockham`` and ``radix4`` (each rank's
local block against device r's shard), and ``fft2_pencil_overlapped`` at
chunks 2 and 4 (every rank's replicated whole against the reference's),
within 1e-5 of the largest value, the reference test's own tolerance; and
everything within 1e-5 of numpy, ``fused``/``fused_r4`` (the kernels'
plain versions on a CPU tensor) and groups of 2 and 4 ranks too. Each
group's ranks start concurrently with the reference, each initialises its
group on a ``FileStore`` under the test's directory with a 60 s timeout,
and the whole run has a deadline: a hung rank fails the tests.

The planner on CPU keys is held to ``repro.plan``: ``chunk_candidates`` on
a grid, ESTIMATE's variant and chunks (on this grid no key's chunk pick
moves with the port's ``NVLINK_BW``, all are 1 in both packages, so the
chunk rule is also pinned to the port's own formula on CUDA keys, where
the collective term is the port's), MEASURE's degrade, ``execute``; and
divergence 11: a CPU key never plans ``fused`` for the kind, a CUDA key
(built without a card) plans ``fused_r4``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.plan import autotune as jautotune
from repro.plan import plan as jplan
from repro_torch import obs
from repro_torch.plan import (
    FFTPlan,
    PlanCache,
    ProblemKey,
    chunk_candidates,
    estimate_plan,
    execute,
    plan_fft,
    problem_key,
    reset_default_cache,
    resolve_call,
    variant_candidates,
)
from repro_torch.plan import autotune

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"
TOL = 1e-5
DEADLINE_S = 180.0
#: name -> (shape, complex): the inputs, made with numpy from a seed.
INPUTS = {"64x32": ((64, 32), False), "3x64x64": ((3, 64, 64), True),
          "128x256": ((128, 256), False)}
VARIANTS = ("looped", "stockham", "radix4")
FUSED = ("fused", "fused_r4")
CHUNKS = (2, 4)
GROUPS = (2, 4)

REFERENCE = r"""
import functools, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.distributed import fft2_pencil, fft2_pencil_overlapped

tmp, variants, chunks = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
mesh = make_mesh((8,), ("data",))
out = {}
for name, x in np.load(os.path.join(tmp, "inputs.npz")).items():
    part = x.shape[-1] // 8
    for v in variants:
        y = jax.jit(functools.partial(fft2_pencil, mesh=mesh, variant=v))(jnp.asarray(x))
        for s in y.addressable_shards:
            out[f"{name}|{v}|{(s.index[-1].start or 0) // part}"] = np.asarray(s.data)
    for c in chunks:
        y = jax.jit(functools.partial(fft2_pencil_overlapped, mesh=mesh, variant="looped",
                                      chunks=c))(jnp.asarray(x))
        whole = np.asarray(y)
        out[f"{name}|overlapped{c}"] = whole
        out[f"{name}|overlapped{c}|replicated"] = np.array(all(
            np.array_equal(np.asarray(s.data), whole) for s in y.addressable_shards))
np.savez(os.path.join(tmp, "reference.npz"), **out)
"""

RANK = r"""
import json, os, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist

torch.set_num_threads(1)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
variants, chunks = json.loads(sys.argv[4]), json.loads(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                        rank=rank, world_size=world, timeout=timedelta(seconds=60))
try:
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.compat import axis_size, get_abstract_mesh, make_mesh, set_mesh
    from repro_torch.core.distributed import (COLLECTIVES, fft2_pencil,
                                              fft2_pencil_overlapped, pencil_sharding,
                                              reset_collectives)
    from repro_torch.plan import execute, plan_fft

    mesh = make_mesh((world,), ("data",), device_type="cpu")
    out, flags = {}, {}
    with set_mesh(mesh):
        flags["axis_size"] = axis_size("data") == world and get_abstract_mesh() is mesh
    flags["ambient_cleared"] = get_abstract_mesh() is None
    flags["sharding"] = (pencil_sharding(mesh, "data", "rows", 3) == [Shard(1)]
                         and pencil_sharding(mesh, "data", "cols") == [Shard(1)])
    for name, x in np.load(os.path.join(tmp, "inputs.npz")).items():
        g = torch.from_numpy(x)
        placed = distribute_tensor(g, mesh, pencil_sharding(mesh, "data", "rows", x.ndim))
        for v in variants:
            reset_collectives()
            y = fft2_pencil(g, mesh, variant=v)
            out[f"{name}|{v}"] = y.to_local().numpy()
            flags[f"{name}|{v}|layout"] = (
                isinstance(y, DTensor) and tuple(y.shape) == x.shape
                and list(y.placements) == [Shard(x.ndim - 1)]
                and COLLECTIVES == {"all_to_all_single": 1, "all_gather_into_tensor": 0})
            flags[f"{name}|{v}|dtensor input"] = bool(torch.equal(
                fft2_pencil(placed, mesh, variant=v).to_local(), y.to_local()))
        for c in chunks:
            reset_collectives()
            y = fft2_pencil_overlapped(placed, mesh, variant="looped", chunks=c)
            out[f"{name}|overlapped{c}"] = y.to_local().numpy()
            flags[f"{name}|overlapped{c}|layout"] = (
                list(y.placements) == [Replicate()]
                and COLLECTIVES == {"all_to_all_single": c, "all_gather_into_tensor": 1})
        y = fft2_pencil_overlapped(g, mesh, variant="auto", chunks="auto")
        out[f"{name}|auto"] = y.to_local().numpy()
        plan = plan_fft("fft2d_pencil", x.shape, "cpu", n_devices=world)
        out[f"{name}|execute"] = execute(plan, g, mesh=mesh).to_local().numpy()
        flags[f"{name}|plan"] = [plan.variant, plan.chunks]
    errors = {}
    for what, call in (("rows", lambda: fft2_pencil(torch.zeros(world // 2, 32), mesh)),
                       ("slabs", lambda: fft2_pencil_overlapped(
                           torch.zeros(64, 32), mesh, chunks=32 // world * 2)),
                       ("placement", lambda: fft2_pencil(distribute_tensor(
                           torch.zeros(64, 32), mesh, [Shard(1)]), mesh))):
        try:
            call()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    flags["errors"] = errors
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(flags, f)
finally:
    dist.destroy_process_group()
"""


def _inputs() -> dict:
    rng = np.random.default_rng(29)
    out = {}
    for name, (shape, cplx) in INPUTS.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if cplx:
            x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        out[name] = x
    return out


def start(args, tmp: Path, label: str):
    """One process of the run, its output in ``tmp/label.log``."""
    log = open(tmp / f"{label}.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", *args], stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=str(ROOT))
    log.close()
    return proc


def join(procs: dict, tmp: Path, deadline: float) -> None:
    """Wait for every process until ``deadline`` (time.monotonic); kill all
    and fail on a hung or failed one, with its log."""
    for label, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.wait()
            pytest.fail(f"{label} did not finish within the deadline: "
                        f"{(tmp / f'{label}.log').read_text()[-3000:]}")
        if rc != 0:
            for p in procs.values():
                p.kill()
                p.wait()
            pytest.fail(f"{label} exited {rc}: {(tmp / f'{label}.log').read_text()[-3000:]}")


def group(tmp: Path, world: int, variants, chunks) -> dict:
    """Start one gloo group of ``world`` ranks in ``tmp``."""
    tmp.mkdir(parents=True, exist_ok=True)
    return {f"rank {r} of {world}": start([RANK, str(r), str(world), str(tmp),
                                           json.dumps(list(variants)), json.dumps(list(chunks))],
                                          tmp, f"rank{r}")
            for r in range(world)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on 8 devices and the port's groups of 8, 2 and 4
    ranks, all started together; their outputs by name."""
    tmp = tmp_path_factory.mktemp("pencil")
    inputs = _inputs()
    dirs = {w: tmp / f"world{w}" for w in (8, *GROUPS)}
    for d in dirs.values():
        d.mkdir()
        np.savez(d / "inputs.npz", **inputs)
    deadline = time.monotonic() + DEADLINE_S
    procs = {"reference": start([REFERENCE, str(dirs[8]), json.dumps(VARIANTS),
                                 json.dumps(CHUNKS)], tmp, "reference")}
    procs.update(group(dirs[8], 8, VARIANTS + FUSED, CHUNKS))
    for w in GROUPS:
        procs.update({f"{k} (group {w})": p
                      for k, p in group(dirs[w], w, ("radix4",), (2,)).items()})
    join(procs, tmp, deadline)
    ranks = {w: [(dict(np.load(dirs[w] / f"rank{r}.npz")),
                  json.loads((dirs[w] / f"rank{r}.json").read_text())) for r in range(w)]
             for w in dirs}
    return {"inputs": inputs, "reference": dict(np.load(dirs[8] / "reference.npz")),
            "ranks": ranks}


def _close(got, want, tol=TOL):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.complex128) - want).max()) / scale
    assert err <= tol, err


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_local_blocks_match_the_reference_shards(runs, name, variant):
    """Rank r's local block is device r's shard: columns [r W/8, (r+1) W/8)."""
    for r, (out, flags) in enumerate(runs["ranks"][8]):
        _close(out[f"{name}|{variant}"], runs["reference"][f"{name}|{variant}|{r}"])
        assert flags[f"{name}|{variant}|layout"] and flags[f"{name}|{variant}|dtensor input"]


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_overlapped_is_the_replicated_whole(runs, name, chunks):
    """Every rank holds the reference's replicated whole, in natural column
    order (the slabs' chunk-major gather reordered); one exchange a slab
    and one gather."""
    ref = runs["reference"]
    assert bool(ref[f"{name}|overlapped{chunks}|replicated"])
    for out, flags in runs["ranks"][8]:
        _close(out[f"{name}|overlapped{chunks}"], ref[f"{name}|overlapped{chunks}"])
        assert flags[f"{name}|overlapped{chunks}|layout"]


@pytest.mark.parametrize("variant", VARIANTS + FUSED)
@pytest.mark.parametrize("name", list(INPUTS))
def test_gathered_blocks_match_numpy(runs, name, variant):
    x = runs["inputs"][name]
    got = np.concatenate([out[f"{name}|{variant}"] for out, _ in runs["ranks"][8]], axis=-1)
    _close(got, np.fft.fft2(x.astype(np.complex128)))


@pytest.mark.parametrize("world", GROUPS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_smaller_groups_match_numpy(runs, name, world):
    x = runs["inputs"][name]
    want = np.fft.fft2(x.astype(np.complex128))
    got = np.concatenate([out[f"{name}|radix4"] for out, _ in runs["ranks"][world]], axis=-1)
    _close(got, want)
    for out, _ in runs["ranks"][world]:
        _close(out[f"{name}|overlapped2"], want)


@pytest.mark.parametrize("name", list(INPUTS))
def test_auto_and_execute_run_the_plan(runs, name):
    """``variant="auto"``/``chunks="auto"`` and ``execute(plan, x, mesh=)``
    run the port's ESTIMATE plan, which a CPU key makes on the schedules."""
    want = np.fft.fft2(runs["inputs"][name].astype(np.complex128))
    for out, flags in runs["ranks"][8]:
        _close(out[f"{name}|auto"], want)
        _close(out[f"{name}|execute"], want)
        variant, chunks = flags[f"{name}|plan"]
        assert variant in VARIANTS and chunks == 1


def test_mesh_helpers_and_placements(runs):
    for _, flags in runs["ranks"][8]:
        assert flags["axis_size"] and flags["ambient_cleared"] and flags["sharding"]


@pytest.mark.parametrize("what,match", [("rows", "multiples of the 8 ranks"),
                                        ("slabs", "chunks=8 must divide W=32"),
                                        ("placement", "want")])
def test_illegal_layouts_raise(runs, what, match):
    """H % d, (W / chunks) % d and a wrongly placed DTensor raise, as the
    reference's shard_map and reshape do."""
    for _, flags in runs["ranks"][8]:
        assert flags["errors"][what] is not None and match in flags["errors"][what]


def test_chunk_candidates_match_the_reference():
    for w in (1, 2, 8, 32, 96, 256, 4096, 8192):
        for d in (1, 2, 3, 4, 8, 16):
            assert chunk_candidates(w, d) == jautotune.chunk_candidates(w, d), (w, d)
            assert chunk_candidates(w, d, limit=4) == jautotune.chunk_candidates(w, d, limit=4)


PLAN_SHAPES = ((64, 32), (3, 64, 64), (128, 256), (1024, 1024), (16, 1024, 1024),
               (4, 4096, 4096), (8192, 8192))


@pytest.mark.parametrize("d", (1, 2, 4, 8))
def test_estimate_matches_the_reference_on_cpu_keys(d):
    reset_default_cache()
    for shape in PLAN_SHAPES:
        ref = jautotune.estimate_plan(jplan.problem_key("fft2d_pencil", shape, n_devices=d))
        got = estimate_plan(problem_key("fft2d_pencil", shape, CPU, n_devices=d))
        assert (got.variant, got.chunks, got.mode) == (ref.variant, ref.chunks, ref.mode), shape


def test_chunk_rule_on_cuda_keys_is_the_port_formula():
    """The reference's rule with the port's NVLink rate: c closest to
    collective / compute (stockham's model of the frame), ties to more."""
    from repro_torch.launch.roofline import NVLINK_BW

    for shape, d in (((8192, 8192), 4), ((64, 4096), 8), ((2, 256, 256), 2)):
        key = ProblemKey(kind="fft2d_pencil", backend="cuda", device_kind=H100, shape=shape,
                         dtype="complex64", n_devices=d)
        frame = ProblemKey(kind="fft2d", backend="cuda", device_kind=H100, shape=shape,
                           dtype="complex64", n_devices=d)
        ideal = max(1.0, 8.0 * np.prod(shape) / (d * NVLINK_BW)
                    / autotune.estimate_variant_time(frame, "stockham"))
        cands = chunk_candidates(shape[-1], d)
        want = min(cands, key=lambda c: (abs(c - ideal), -c))
        assert autotune._estimate_chunks(key) == want
        assert estimate_plan(key).chunks == want


def test_collective_term_enters_every_model():
    """Each element crosses the mesh once, over n_devices: at the port's
    NVLink rate that term is a floor of every engine's ESTIMATE time at
    d > 1, and absent at d = 1."""
    from repro_torch.launch.roofline import NVLINK_BW

    shape = (4, 4096, 4096)
    for d in (1, 4):
        for backend, variants in (("cpu", VARIANTS), ("cuda", FUSED)):
            key = ProblemKey(kind="fft2d_pencil", backend=backend,
                             device_kind=H100 if backend == "cuda" else "cpu", shape=shape,
                             dtype="complex64", n_devices=d)
            coll = autotune._collective_bytes(key)
            assert coll == (8.0 * np.prod(shape) / d if d > 1 else 0.0)
            for v in variants:
                assert autotune.estimate_variant_time(key, v) >= coll / NVLINK_BW


def test_measure_degrades_to_estimate_for_the_pencil():
    reset_default_cache()
    with obs.capture() as trace:
        with_cfg = resolve_call("fft2d_pencil", (64, 32), CPU, n_devices=8, cache=PlanCache(),
                                mode="measure")
        planned = plan_fft("fft2d_pencil", (64, 32), CPU, mode="measure", n_devices=8,
                           cache=PlanCache())
    for plan in (with_cfg, planned):
        assert plan.mode == "estimate" and plan.degrade_reason == "estimate_only_kind"
    assert [e["reason"] for e in trace.select("plan.degrade")] == ["estimate_only_kind"] * 2
    assert trace.select("plan.measure") == []


def test_execute_needs_a_mesh():
    plan = FFTPlan(key=problem_key("fft2d_pencil", (64, 32), CPU, n_devices=8),
                   variant="stockham", chunks=2)
    with pytest.raises(ValueError, match="needs mesh="):
        execute(plan, torch.zeros(64, 32))


@pytest.mark.parametrize("shape,d", [((64, 32), 8), ((4, 4096, 4096), 1), ((8192, 8192), 4)])
def test_divergence_11_fused_engines_serve_cuda_pencil_keys_only(shape, d):
    """The schedules serve the kind everywhere (as the reference's jnp
    engines do); the kernels serve it on CUDA keys only, at any d, and an
    unscoped CUDA key plans ``fused_r4``."""
    cpu = ProblemKey(kind="fft2d_pencil", backend="cpu", device_kind="cpu", shape=shape,
                     dtype="complex64", n_devices=d)
    assert variant_candidates(cpu) == VARIANTS
    assert estimate_plan(cpu).variant in VARIANTS
    cuda = ProblemKey(kind="fft2d_pencil", backend="cuda", device_kind=H100, shape=shape,
                      dtype="complex64", n_devices=d)
    assert variant_candidates(cuda) == FUSED
    assert estimate_plan(cuda).variant == "fused_r4"
    scoped = ProblemKey(kind="fft2d_pencil", backend="cuda", device_kind=H100, shape=shape,
                        dtype="complex64", n_devices=d, backends=("torch",))
    assert variant_candidates(scoped) == VARIANTS
    # The kernels still take part in no other multi-device plan.
    frame = ProblemKey(kind="fft2d", backend="cuda", device_kind=H100, shape=shape,
                       dtype="complex64", n_devices=2, backends=("cuda",))
    with pytest.raises(ValueError, match="no registered engine"):
        variant_candidates(frame)


def test_fused_working_set_is_the_row_envelope():
    """A frame that fits one block as an fft2d key is still gated on its
    rows as a pencil, and a pencil whose rows exceed 2^24 values is over
    the envelope."""
    from repro_torch.engines import get_engine
    from repro_torch.kernels import fft_radix2 as census
    from repro_torch.kernels.ops import smem_budget_bytes

    spec = get_engine("fused_r4")
    key = ProblemKey(kind="fft2d_pencil", backend="cuda", device_kind=H100, shape=(64, 64),
                     dtype="complex64")
    assert spec.working_set(key) == census.row_smem_bytes(64, radix=4)
    too_long = ProblemKey(kind="fft2d_pencil", backend="cuda", device_kind=H100,
                          shape=(2 ** 25, 64), dtype="complex64", n_devices=8)
    assert spec.working_set(too_long) > smem_budget_bytes()
    with pytest.raises(NotImplementedError, match="no CUDA kernel serves"):
        variant_candidates(too_long)
