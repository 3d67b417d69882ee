"""Mesh helpers and ``shard_map`` for the multi-device paths, on
``torch.distributed``.

Port of ``repro.compat``. The reference backfills the modern
``jax.make_mesh`` / ``jax.set_mesh`` / ``jax.shard_map`` spellings on
older jaxlibs; here the same names build and carry a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, one process a rank:

  make_mesh(shape, names)   -> ``init_device_mesh`` over the initialised
                               default process group
  axis_size(name)           -> the size of a named mesh axis (or the
                               product over a tuple of axes)
  set_mesh(mesh)            -> an ambient mesh for a ``with`` block (a
                               ``contextvars`` variable, so each thread and
                               task sees its own)
  get_abstract_mesh()       -> that ambient mesh, or None
  shard_map(f, mesh=, in_specs=, out_specs=, axis_names=)
                            -> ``f`` on this rank's block of each argument
  axis_index, all_to_all, all_gather, pmean
                            -> the collectives ``f`` calls by axis name
  pcast(x, axes, to=)       -> the identity, as the reference's 0.4.x shim

A ``PartitionSpec`` has one entry a dim: None, a mesh-axis name, or a
tuple of names (their ranks in row-major order of the tuple, as JAX
orders a multi-axis dim). A group over several axes is one
``new_group`` for each combination of the other axes' coordinates, made
on every rank in the same order at first use and kept on the mesh.

Gradients follow ``shard_map``'s transpose. An argument whose spec names
an axis is cut to this rank's slice; the slice's cotangent is gathered
back, so the whole argument gets the whole gradient. An argument under
``P()`` (or replicated over some of the manual axes) gets the sum of the
ranks' partial gradients over those axes. An output whose spec names an
axis is gathered; each rank takes back its own slice of the cotangent,
which the caller's replicated loss makes the same on every rank (a
reduce-scatter of a sum would hand back world x the gradient). ``pmean``'s
output is the same on every rank, so its backward is the cotangent over
the axis size, with no collective. ``all_to_all`` is a permutation and its
own transpose.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Optional, Sequence

import torch

__all__ = [
    "COLLECTIVES",
    "P",
    "PartitionSpec",
    "all_gather",
    "all_to_all",
    "axis_index",
    "axis_size",
    "get_abstract_mesh",
    "make_mesh",
    "pcast",
    "pmean",
    "reset_collectives",
    "set_mesh",
    "shard_map",
    "to_placements",
]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)
#: (mesh, manual axes) inside a ``shard_map`` body.
_MANUAL: contextvars.ContextVar = contextvars.ContextVar("repro_torch_manual", default=None)

#: Collectives by name since the last :func:`reset_collectives`, counted
#: where they are issued (forward and backward alike).
COLLECTIVES = {"all_to_all": 0, "all_gather": 0, "all_reduce": 0}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def _entry(e):
    """A spec entry as JAX keeps it: a tuple of one name is that name."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return e[0] if len(e) == 1 else (e or None)
    return e


class PartitionSpec:
    """``jax.sharding.PartitionSpec``: one entry a dim, each None, a mesh
    axis name or a tuple of names (a tuple of one name is kept as the name,
    as JAX keeps it); iterates, indexes and compares as the tuple of its
    entries."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (PartitionSpec, tuple)):
            return self._entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


def _names(entry) -> tuple:
    """A spec entry's mesh axes as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


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


def _mesh_for(mesh=None):
    """``mesh``, else the ``shard_map`` body's, else the ambient one."""
    if mesh is not None:
        return mesh
    manual = _MANUAL.get()
    if manual is not None:
        return manual[0]
    mesh = get_abstract_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh=, or call inside set_mesh() or shard_map")
    return mesh


def axis_size(axis_name, mesh=None) -> int:
    """Ranks along the mesh axis ``axis_name`` (a name, or a tuple of names:
    the product) of ``mesh`` (default: the ``shard_map`` body's or the
    ambient mesh of :func:`set_mesh`)."""
    mesh = _mesh_for(mesh)
    names = mesh.mesh_dim_names or ()
    size = 1
    for name in _names(axis_name):
        if name not in names:
            raise ValueError(f"mesh has no axis {name!r}; its axes are {names}")
        size *= mesh.size(names.index(name))
    return size


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


def pcast(x, axes, *, to):
    """Varying-axis cast: the identity, as the reference's shim on 0.4.x
    (nothing here tracks which values vary over an axis)."""
    return x


# ------------------------------ axis groups ------------------------------


class _AxisGroup:
    """The process group of this rank over mesh axes ``axes``: ``group``,
    ``size``, this rank's ``index`` (row-major over ``axes`` in their
    order, as JAX numbers a multi-axis dim) and ``order[i]``, the group
    rank of the member at index i."""

    def __init__(self, mesh, axes: tuple):
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names or ())
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh has no axis {a!r}; its axes are {names}")
        dims = [names.index(a) for a in axes]
        grid = mesh.mesh.detach().cpu()
        # move the group's axes last, in the given order: each row is one group
        others = [d for d in range(grid.dim()) if d not in dims]
        rows = grid.permute(*others, *dims).reshape(-1, math.prod(grid.shape[d] for d in dims))
        me = dist.get_rank()
        self.size = rows.shape[1]
        self.group = None
        if len(axes) == 1:
            self.group = mesh.get_group(axes[0])
        for row in rows.tolist():
            # every rank makes every group, in the same order
            group = dist.new_group(sorted(row)) if len(axes) > 1 else None
            if me in row:
                self.members = row
                self.index = row.index(me)
                if group is not None:
                    self.group = group
        ranked = sorted(self.members)
        self.order = [ranked.index(r) for r in self.members]


def _axis_group(axis_name, mesh=None) -> _AxisGroup:
    mesh = _mesh_for(mesh)
    axes = _names(axis_name)
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if axes not in cache:
        cache[axes] = _AxisGroup(mesh, axes)
    return cache[axes]


def axis_index(axis_name, mesh=None) -> int:
    """This rank's index along ``axis_name`` (a name, or a tuple of names:
    row-major over them), as ``jax.lax.axis_index``."""
    return _axis_group(axis_name, mesh).index


def _all_gather_dim(x, g: _AxisGroup, dim: int):
    """``x`` of every member concatenated along ``dim`` in index order."""
    import torch.distributed as dist

    COLLECTIVES["all_gather"] += 1
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty(g.size * xm.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xm.reshape(-1), group=g.group)
    parts = out.view(g.size, *xm.shape)  # by group rank
    if g.order != sorted(g.order):
        parts = parts[torch.tensor(g.order, device=out.device)]
    return parts.reshape(g.size * xm.shape[0], *xm.shape[1:]).movedim(0, dim)


def _all_reduce(x, g: _AxisGroup):
    import torch.distributed as dist

    COLLECTIVES["all_reduce"] += 1
    x = x.contiguous().clone()
    dist.all_reduce(x, group=g.group)
    return x


def _slice(x, g: _AxisGroup, dim: int):
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.index * n, n)


class _Shard(torch.autograd.Function):
    """This rank's slice along ``dim``; backward gathers the slices'
    cotangents."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _slice(x, g, dim)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather_dim(ct, ctx.g, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every member's block along ``dim`` (an output's spec, or
    ``all_gather``); backward takes this rank's slice of the (replicated)
    cotangent."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _all_gather_dim(x, g, dim)

    @staticmethod
    def backward(ctx, ct):
        return _slice(ct, ctx.g, ctx.dim).contiguous(), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; backward sums the cotangent over the group (an
    argument replicated over manual axes)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.g), None


def _a2a(x, g: _AxisGroup):
    """Chunk i of ``x``'s leading dim (size ``g.size``) to the member at
    index i; row j of the result from the member at index j."""
    import torch.distributed as dist

    COLLECTIVES["all_to_all"] += 1
    perm = None if g.order == sorted(g.order) else torch.tensor(g.order, device=x.device)
    send = x.contiguous()
    if perm is not None:  # rows by group rank
        send = torch.empty_like(send).index_copy_(0, perm, send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g.group)
    return recv[perm] if perm is not None else recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _a2a(x, g)

    @staticmethod
    def backward(ctx, ct):
        return _a2a(ct, ctx.g), None


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, *, tiled: bool = False):
    """``jax.lax.all_to_all`` with ``tiled=False`` and ``split_axis ==
    concat_axis``: slice i of ``split_axis`` (whose size is the axis size)
    goes to index i, and slice j of the result comes from index j."""
    if tiled or split_axis != concat_axis:
        raise NotImplementedError("all_to_all takes split_axis == concat_axis, tiled=False")
    g = _axis_group(axis_name)
    if x.shape[split_axis] != g.size:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} must be the axis "
                         f"size {g.size}")
    y = _AllToAll.apply(x.movedim(split_axis, 0), g)
    return y.movedim(0, split_axis)


def all_gather(x, axis_name, *, axis: int = 0, tiled: bool = False):
    """``jax.lax.all_gather``: every index's ``x`` stacked along a new dim
    ``axis`` (``tiled``: concatenated along ``axis``), in index order. The
    result is the same on every rank of the axis, so its cotangent is too,
    and the backward hands each rank its own slice (no sum)."""
    g = _axis_group(axis_name)
    if not tiled:
        x = x.unsqueeze(axis)
    return _Gather.apply(x, g, axis)


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.n = g.size
        return _all_reduce(x, g) / g.size

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n, None


def pmean(x, axis_name):
    """The mean of ``x`` over the axis (or tuple of axes) on every rank."""
    return _Pmean.apply(x, _axis_group(axis_name))


# ------------------------------ shard_map ------------------------------


def _walk(tree, specs, fn):
    """``fn(leaf, spec)`` over ``tree``, where ``specs`` is a tree of the
    same structure or a prefix of it (one spec for a whole subtree)."""
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, dict):
            return {k: _walk(v, specs, fn) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_walk(v, specs, fn) for v in tree)
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"shard_map: {len(tree)} values for {len(specs)} specs")
        return type(tree)(_walk(v, s, fn) for v, s in zip(tree, specs))
    raise ValueError(f"shard_map: a spec tree {specs!r} where the value is a leaf")


def to_placements(spec, mesh) -> list:
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh axis
    (``Shard(dim)`` where a dim names the axis, else ``Replicate()``). A
    dim over several axes is sharded over each in turn, which is JAX's
    row-major order when the axes come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for a in _names(entry):
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}; the mesh's are {names}")
            out[names.index(a)] = Shard(dim)
    return out


def _local(x, spec, mesh, manual: tuple):
    if not isinstance(x, torch.Tensor):
        return x
    named = [a for e in spec for a in _names(e)]
    for a in named:
        if a not in manual:
            raise ValueError(f"shard_map: spec {spec!r} names {a!r}, not a manual axis "
                             f"{manual}")
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        if list(x.placements) != to_placements(spec, mesh):
            raise ValueError(f"shard_map: a DTensor placed {x.placements} for spec {spec!r}")
        return x.to_local()
    replicated = tuple(a for a in manual if a not in named)
    if replicated and x.requires_grad:
        x = _SumGrad.apply(x, _axis_group(replicated, mesh))
    for dim, entry in enumerate(spec):
        if _names(entry):
            g = _axis_group(_names(entry), mesh)
            if x.shape[dim] % g.size:
                raise ValueError(f"shard_map: dim {dim} of {tuple(x.shape)} does not divide "
                                 f"over {entry!r} ({g.size} ranks)")
            x = _Shard.apply(x, g, dim)
    return x


def _gather(y, spec, mesh):
    if not isinstance(y, torch.Tensor):
        return y
    for dim, entry in enumerate(spec):
        if _names(entry):
            y = _Gather.apply(y, _axis_group(_names(entry), mesh), dim)
    return y


def shard_map(f=None, *, mesh, in_specs, out_specs, axis_names=None):
    """``jax.shard_map``: ``f`` runs on every rank on its block of each
    argument, under ``axis_names`` (default: every mesh axis) as manual
    axes, and its outputs are gathered along the axes ``out_specs`` name.
    ``in_specs`` has one spec (or spec tree) an argument. A tensor whose
    spec names axes is cut to this rank's slice along those dims; one
    under ``P()`` is passed whole; a ``DTensor`` placed as its spec says
    is passed as its local shard, with no gather. Every rank of the mesh
    calls it."""
    if f is None:
        return functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, axis_names=axis_names)
    manual = tuple(mesh.mesh_dim_names) if axis_names is None else tuple(
        a for a in mesh.mesh_dim_names if a in set(axis_names))

    @functools.wraps(f)
    def run(*args):
        specs = (in_specs,) if isinstance(in_specs, PartitionSpec) else tuple(in_specs)
        local = _walk(args, specs, lambda x, s: _local(x, s, mesh, manual))
        token = _MANUAL.set((mesh, manual))
        try:
            out = f(*local)
        finally:
            _MANUAL.reset(token)
        return _walk(out, out_specs, lambda y, s: _gather(y, s, mesh))

    return run
