"""``repro_torch.checkpoint`` against ``repro.checkpoint`` on the CPU.

The two packages share one on-disk format (``manifest.json`` and
``arrays.npz``, leaves in jax's flatten order), so a checkpoint written by
either restores in the other bit for bit; the manifests of one tree are
equal. The elastic restore is held on a plain tree of tensors, not on the
reference's language model (that stack is ROADMAP queue 1, item 12): a
tree of DTensors saved from a ``gloo`` group of 4 ranks restores onto a
group of 2 with new placements and equal values. Each group's ranks are
processes of their own on a ``FileStore`` under the test's directory,
with a 60 s group timeout and a deadline.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint
from repro_torch.checkpoint import store

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120.0


def _tree(rng):
    return {
        "w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
        "layers": [
            {"spec": torch.from_numpy((rng.standard_normal(8) + 1j * rng.standard_normal(8))
                                      .astype(np.complex64)),
             "b": torch.arange(5, dtype=torch.int32)},
            (torch.ones(2, 2, dtype=torch.float64), None),
        ],
        "a": {"z": torch.tensor(3.5), "count": torch.tensor([7], dtype=torch.int32)},
    }


def _leaves(tree):
    return [leaf for _, leaf in store._flatten(tree)]


def _same(a, b) -> bool:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_round_trip_of_a_nested_tree(tmp_path):
    tree = _tree(np.random.default_rng(0))
    final = checkpoint.save(str(tmp_path), 3, tree, extra={"epoch": 1})
    assert final == str(tmp_path / "step_3") and checkpoint.latest_step(str(tmp_path)) == 3
    like = _tree(np.random.default_rng(1))
    got = checkpoint.restore(str(tmp_path), 3, like)
    assert list(got) == list(tree) and isinstance(got["layers"][1], tuple)
    assert got["layers"][1][1] is None
    assert all(_same(a, b) for a, b in zip(_leaves(got), _leaves(tree)))
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest["extra"] == {"epoch": 1} and manifest["step"] == 3
    assert manifest["paths"] == ["a/count", "a/z", "layers/0/b", "layers/0/spec",
                                 "layers/1/0", "w"]


def test_leaf_count_mismatch_raises(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="1 leaves, expected 2"):
        checkpoint.restore(str(tmp_path), 1, {"a": torch.zeros(2), "b": torch.zeros(2)})


def _numpy_tree(rng):
    return {"k": (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4)))
            .astype(np.complex64),
            "m": [rng.standard_normal(6).astype(np.float32), np.arange(4, dtype=np.int32)],
            "b": {"x": rng.standard_normal((2, 2)).astype(np.float32)}}


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree = _numpy_tree(np.random.default_rng(2))
    jckpt.save(str(tmp_path), 5, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    like = {"k": torch.zeros(3, 4, dtype=torch.complex64),
            "m": [torch.zeros(6), torch.zeros(4, dtype=torch.int32)],
            "b": {"x": torch.zeros(2, 2)}}
    got = checkpoint.restore(str(tmp_path), 5, like)
    assert all(_same(a, b) for a, b in zip(_leaves(got), _leaves(tree)))


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    rng = np.random.default_rng(3)
    tree = {name: torch.from_numpy(a) if isinstance(a, np.ndarray) else
            [torch.from_numpy(v) for v in a] if isinstance(a, list) else
            {k: torch.from_numpy(v) for k, v in a.items()}
            for name, a in _numpy_tree(rng).items()}
    checkpoint.save(str(tmp_path / "port"), 9, tree, extra={"note": "port"})
    ref_dir = tmp_path / "ref"
    jckpt.save(str(ref_dir), 9, {k: (v.numpy() if isinstance(v, torch.Tensor) else
                                     [t.numpy() for t in v] if isinstance(v, list) else
                                     {kk: t.numpy() for kk, t in v.items()})
                                 for k, v in tree.items()}, extra={"note": "port"})
    assert json.loads((tmp_path / "port" / "step_9" / "manifest.json").read_text()) == \
        json.loads((ref_dir / "step_9" / "manifest.json").read_text())
    like = {"k": jnp.zeros((3, 4), jnp.complex64),
            "m": [jnp.zeros(6, jnp.float32), jnp.zeros(4, jnp.int32)],
            "b": {"x": jnp.zeros((2, 2), jnp.float32)}}
    got = jckpt.restore(str(tmp_path / "port"), 9, like)
    assert jckpt.latest_step(str(tmp_path / "port")) == 9
    assert all(_same(np.asarray(a), b) for a, b in zip(_leaves(got), _leaves(tree)))


def test_a_tmp_directory_is_never_the_latest_step(tmp_path):
    checkpoint.save(str(tmp_path), 2, {"a": torch.zeros(1)})
    (tmp_path / "step_7.tmp").mkdir()
    (tmp_path / "step_7.tmp" / "manifest.json").write_text("{}")
    (tmp_path / "step_9").mkdir()  # renamed but without a manifest: incomplete
    assert checkpoint.latest_step(str(tmp_path)) == 2
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None
    # a stale tmp of the same step is replaced by the next save
    (tmp_path / "step_4.tmp").mkdir()
    checkpoint.save(str(tmp_path), 4, {"a": torch.ones(1)})
    assert not (tmp_path / "step_4.tmp").exists() and checkpoint.latest_step(str(tmp_path)) == 4


def test_async_checkpointer_writes_in_the_background(tmp_path, monkeypatch):
    started, release = threading.Event(), threading.Event()
    write = store._write

    def slow_write(*args):
        started.set()
        assert release.wait(30)
        return write(*args)

    monkeypatch.setattr(store, "_write", slow_write)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path))
    tree = {"p": torch.arange(6, dtype=torch.float32)}
    ck.save_async(11, tree)
    tree["p"].add_(100.0)  # the host copy was taken before save_async returned
    assert started.wait(30)
    assert ck.last_saved is None and checkpoint.latest_step(str(tmp_path)) is None
    release.set()
    ck.wait()
    assert ck.last_saved == 11 and ck._thread is None
    got = checkpoint.restore(str(tmp_path), 11, {"p": torch.zeros(6)})
    assert torch.equal(got["p"], torch.arange(6, dtype=torch.float32))


ELASTIC = r"""
import json, os, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist

torch.set_num_threads(1)
rank, world, tmp, phase = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store_{phase}"), world),
                        rank=rank, world_size=world, timeout=timedelta(seconds=60))
try:
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.checkpoint import latest_step, restore_resharded, save
    from repro_torch.compat import make_mesh, set_mesh

    mesh = make_mesh((world,), ("data",), device_type="cpu")
    rng = np.random.default_rng(4)
    full = {"emb": torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)),
            "blocks": [torch.from_numpy((rng.standard_normal((4, 16))
                                         + 1j * rng.standard_normal((4, 16)))
                                        .astype(np.complex64)),
                       torch.from_numpy(rng.standard_normal(6).astype(np.float32))],
            "step": torch.tensor(42)}
    if phase == "save":
        placements = {"emb": [Shard(0)], "blocks": [[Shard(1)], [Replicate()]], "step": None}
        tree = {"emb": distribute_tensor(full["emb"], mesh, [Shard(0)]),
                "blocks": [distribute_tensor(full["blocks"][0], mesh, [Shard(1)]),
                           distribute_tensor(full["blocks"][1], mesh, [Replicate()])],
                "step": full["step"]}
        save(os.path.join(tmp, "ckpt"), 42, tree)
        result = {"latest": latest_step(os.path.join(tmp, "ckpt"))}
    else:
        like = {"emb": torch.zeros(8, 12), "blocks": [torch.zeros(4, 16, dtype=torch.complex64),
                                                      torch.zeros(6)],
                "step": torch.tensor(0)}
        placements = {"emb": [Shard(1)], "blocks": [[Shard(0)], [Shard(0)]], "step": None}
        with set_mesh(mesh):
            got = restore_resharded(os.path.join(tmp, "ckpt"), 42, like, placements)
        leaves = [got["emb"], got["blocks"][0], got["blocks"][1]]
        wants = [full["emb"], full["blocks"][0], full["blocks"][1]]
        result = {
            "dtensors": all(isinstance(t, DTensor) and t.device_mesh.size(0) == world
                            for t in leaves),
            "placements": [str(t.placements) for t in leaves],
            "local_shapes": [list(t.to_local().shape) for t in leaves],
            "equal": all(torch.equal(t.full_tensor(), w) for t, w in zip(leaves, wants)),
            "dtype": str(got["blocks"][0].dtype),
            "plain": isinstance(got["step"], torch.Tensor) and not isinstance(got["step"], DTensor)
                     and int(got["step"]) == 42,
        }
    with open(os.path.join(tmp, f"{phase}{rank}.json"), "w") as f:
        json.dump(result, f)
finally:
    dist.destroy_process_group()
"""


def _group(tmp: Path, world: int, phase: str):
    procs = []
    for r in range(world):
        log = open(tmp / f"{phase}{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", ELASTIC, str(r), str(world), str(tmp), phase],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")))
        log.close()
    deadline = time.monotonic() + DEADLINE_S
    for r, p in enumerate(procs):
        try:
            rc = p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail(f"{phase} rank {r} of {world}: exit {rc}: "
                        f"{(tmp / f'{phase}{r}.log').read_text()[-3000:]}")
    return [json.loads((tmp / f"{phase}{r}.json").read_text()) for r in range(world)]


def test_elastic_restore_from_four_ranks_onto_two(tmp_path):
    """Saved from 4 ranks (rows, columns and replicated placements; rank 0
    writes the full tensors), restored onto 2 ranks under other
    placements: equal values, complex dtype kept, a None placement left a
    plain tensor."""
    saved = _group(tmp_path, 4, "save")
    assert [s["latest"] for s in saved] == [42] * 4
    restored = _group(tmp_path, 2, "restore")
    for r, got in enumerate(restored):
        assert got["dtensors"] and got["equal"] and got["plain"], got
        assert got["dtype"] == "torch.complex64"
        assert got["placements"] == ["(Shard(dim=1),)", "(Shard(dim=0),)", "(Shard(dim=0),)"]
        assert got["local_shapes"] == [[8, 6], [2, 16], [3]]
