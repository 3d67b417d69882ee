"""Mesh helpers for the multi-device paths, on ``torch.distributed``.

Port of the mesh half of ``repro.compat``. The reference backfills the
modern ``jax.make_mesh`` / ``jax.set_mesh`` / ``jax.lax.axis_size``
spellings on older jaxlibs; here the same names build and carry a
``torch.distributed.device_mesh.DeviceMesh``:

  make_mesh(shape, names)   -> ``init_device_mesh`` over the initialised
                               default process group
  axis_size(name)           -> the size of a named mesh axis
  set_mesh(mesh)            -> an ambient mesh for a ``with`` block (a
                               ``contextvars`` variable, so each thread and
                               task sees its own)
  get_abstract_mesh()       -> that ambient mesh, or None

``shard_map`` and ``pcast`` are not here: only the language models'
attention and mixture-of-experts layers call them (ROADMAP queue 1, item
12), and the pencil FFT runs one process per rank, with its collectives
explicit (``repro_torch.core.distributed``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

__all__ = ["axis_size", "get_abstract_mesh", "make_mesh", "set_mesh"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    default process group, which the caller initialises first
    (``torch.distributed.init_process_group`` with its store, rank and
    world size): without one, ``init_device_mesh`` would read
    ``MASTER_ADDR`` and the like from the environment. ``device_type``
    ``"cuda"`` (the default) raises without CUDA; ``"cpu"`` is the caller
    asking for the CPU, as the tests do."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group(backend, store=..., rank=..., "
            "world_size=...) first"
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh builds a mesh of CUDA devices unless given a device_type, and CUDA "
            "is not available; pass device_type='cpu' for a mesh of CPU ranks"
        )
    return init_device_mesh(device_type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def axis_size(axis_name: str, mesh=None) -> int:
    """Ranks along the mesh axis ``axis_name`` of ``mesh`` (default: the
    ambient mesh of :func:`set_mesh`)."""
    mesh = mesh if mesh is not None else get_abstract_mesh()
    if mesh is None:
        raise ValueError(f"axis_size({axis_name!r}) needs a mesh: pass mesh= or set_mesh()")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r}; its axes are {names}")
    return mesh.size(names.index(axis_name))


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_abstract_mesh() -> Optional[object]:
    """The ambient mesh of the innermost :func:`set_mesh`, or None."""
    return _MESH.get()
