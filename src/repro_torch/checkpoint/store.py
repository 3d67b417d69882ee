"""Fault-tolerant checkpointing: npz + manifest, atomic rename, background
writes, and elastic restore (re-placement onto a different mesh).

Port of ``repro.checkpoint.store``, in its on-disk format, so a checkpoint
written by either package restores in the other:

  <dir>/step_<N>.tmp/ ... -> atomic rename -> <dir>/step_<N>/
      manifest.json       {step, paths, shapes, dtypes, extra}
      arrays.npz          {a<i>: array}, leaves in jax's flatten order

A tree is nested dicts (flattened in sorted key order, as jax does), lists
and tuples; ``None`` is an empty subtree; every other node is a leaf (a
tensor, a numpy array or a scalar). A partly written checkpoint is never
picked up: ``latest_step`` sees renamed directories only.

A tree that holds a ``DTensor`` is saved collectively: every rank calls
``save``, each DTensor leaf is gathered to its full tensor, and global
rank 0 alone writes; every rank returns once the checkpoint exists.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_resharded", "save"]


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in jax's flatten order; a path joins dict keys
    and sequence indices with "/", as the reference's manifest does."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _flatten(v, path + (str(i),))]
    if tree is None:
        return []
    return [("/".join(path), tree)]


def _rebuild(like, fn: Callable, other=None):
    """``like``'s structure with each leaf replaced by ``fn(leaf, node)``,
    called in :func:`_flatten`'s order, ``node`` being the node at the same
    place in ``other`` (a tree of ``like``'s structure whose leaves may be
    anything, e.g. placements)."""
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], fn, None if other is None else other[k])
                for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, fn, None if other is None else other[i]) for i, v in enumerate(like)]
        return tuple(out) if isinstance(like, tuple) else out
    if like is None:
        return None
    return fn(like, other)


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (later writes to the leaf do not
    reach it): a DTensor's full tensor (a collective over its mesh), a
    tensor's values, dtype kept (complex too)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).resolve_conj().numpy()
    return np.array(leaf)


def _host_tree(tree) -> Tuple[List[str], List[np.ndarray], bool]:
    """(paths, host arrays, whether the tree holds a DTensor)."""
    pairs = _flatten(tree)
    arrays = [_to_host(leaf) for _, leaf in pairs]
    return [p for p, _ in pairs], arrays, any(_is_dtensor(leaf) for _, leaf in pairs)


def _writes(shared: bool) -> bool:
    """Whether this process writes: a tree holding a DTensor is written by
    global rank 0 alone."""
    import torch.distributed as dist

    return not shared or dist.get_rank() == 0


def _write(ckpt_dir: str, step: int, paths: List[str], arrays: List[np.ndarray],
           extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    named = {f"a{i}": a for i, a in enumerate(arrays)}
    np.savez(os.path.join(tmp, "arrays.npz"), **named)
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a in named.values()],
        "dtypes": [str(a.dtype) for a in named.values()],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write. Returns the final directory. Collective
    (every rank calls it) when ``tree`` holds a DTensor."""
    paths, arrays, shared = _host_tree(tree)
    if _writes(shared):
        _write(ckpt_dir, step, paths, arrays, extra)
    if shared:
        import torch.distributed as dist

        dist.barrier()
    return os.path.join(ckpt_dir, f"step_{step}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _as_like(array: np.ndarray, like) -> torch.Tensor:
    """``array`` as a tensor of ``like``'s dtype on ``like``'s device (a
    DTensor's local device); a non-tensor ``like`` keeps the array's dtype
    on the CPU."""
    out = torch.from_numpy(np.array(array, order="C"))
    if isinstance(like, torch.Tensor):
        return out.to(dtype=like.dtype, device=like.device)
    return out


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (values replaced), as tensors."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(len(data.files))]
    n_like = len(_flatten(like))
    if len(arrays) != n_like:
        raise ValueError(f"checkpoint has {len(arrays)} leaves, expected {n_like}")
    it = iter(arrays)
    return _rebuild(like, lambda leaf, _: _as_like(next(it), leaf))


def restore_resharded(ckpt_dir: str, step: int, like: Any, placements: Any, mesh=None) -> Any:
    """Elastic restore: place each restored leaf with ``distribute_tensor``
    on a NEW mesh under its placements, which is how a run resumes on a
    grown or shrunk group. ``placements`` has ``like``'s structure, each
    leaf a sequence of ``torch.distributed.tensor`` placements (one per
    mesh axis) or None (the leaf stays a plain tensor). ``mesh`` defaults
    to the ambient mesh of ``repro_torch.compat.set_mesh``. Every rank of
    the mesh calls it."""
    from torch.distributed.tensor import distribute_tensor

    if mesh is None:
        from repro_torch.compat import get_abstract_mesh

        mesh = get_abstract_mesh()
        if mesh is None:
            raise ValueError("restore_resharded needs mesh= or an ambient set_mesh()")
    tree = restore(ckpt_dir, step, like)
    device = torch.device(mesh.device_type)

    def place(leaf, spec):
        if spec is None:
            return leaf
        return distribute_tensor(leaf.to(device), mesh, list(spec))

    return _rebuild(tree, place, placements)


class AsyncCheckpointer:
    """Background-thread writer so the train loop never blocks on disk.
    The leaves are copied to host memory (DTensors gathered, on every
    rank) before the call returns; the write runs in the background."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        paths, arrays, shared = _host_tree(tree)
        if not _writes(shared):
            self.last_saved = step
            return

        def _work():
            _write(self.ckpt_dir, step, paths, arrays, extra)
            self.last_saved = step

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
