"""Pencil-decomposed multi-device 2D FFT on ``torch.distributed``.

Port of ``repro.core.distributed``. The paper's two 1D engines and their
ping-pong RAM become, over the ranks of one mesh axis (one process a rank):

  local row FFTs  ->  all_to_all "corner turn"  ->  local column FFTs

The ``all_to_all_single`` is the distributed analogue of the RAM1/RAM2
hand-off: it is the only communication between the two engines, and the
chunked variant overlaps it with the column butterflies, as the hardware
overlaps engine 1's writes with engine 2's reads.

Layouts (for a mesh axis of d ranks):
  input   x:  rows sharded    -- global (..., H, W), per rank (..., H/d, W)
  output  y:  columns sharded -- global (..., H, W), per rank (..., H, W/d)

On each rank the passes run where its tensors lie. Under ``fused`` /
``fused_r4`` they are the card's kernels (``repro_torch.kernels.ops``:
``stream_rows``, ``fft_fused`` on the rank's rows, and ``stream_columns``,
``fft2_columns`` in place on the turned block, the turn route for columns
over 4096 values), their plain versions on a CPU tensor; under the plain
schedules they are ``repro_torch.core.fft1d.fft_impl``, as in the
reference. The pack into the send buffer and the unpack after the
exchange are plain tensor copies, as the reference's are XLA ops outside
any Pallas kernel. ``COLLECTIVES`` counts each collective where it is
issued.
"""

from __future__ import annotations

from typing import Dict, List, Literal, Union

import torch

from repro_torch.core.fft1d import _check_pow2, _check_variant, fft_impl
from repro_torch.kernels import ops

__all__ = [
    "COLLECTIVES",
    "fft2_pencil",
    "fft2_pencil_overlapped",
    "pencil_sharding",
    "reset_collectives",
]

#: Collectives issued by the pencil since the last :func:`reset_collectives`.
COLLECTIVES: Dict[str, int] = {"all_to_all_single": 0, "all_gather_into_tensor": 0}

_FUSED = ("fused", "fused_r4")


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def pencil_sharding(mesh, axis: str, stage: Literal["rows", "cols"], ndim: int = 2) -> List:
    """DTensor placements of the pencil layouts of an ``ndim``-dim array on
    ``mesh``: ``Shard(ndim - 2)`` (rows) or ``Shard(ndim - 1)`` (columns)
    along ``axis``, ``Replicate()`` along every other mesh axis; batch
    dims are replicated."""
    from torch.distributed.tensor import Replicate, Shard

    if stage not in ("rows", "cols"):
        raise ValueError(f"stage must be 'rows' or 'cols', got {stage!r}")
    _axis_index(mesh, axis)
    dim = ndim - 2 if stage == "rows" else ndim - 1
    return [Shard(dim) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def _axis_index(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    return names.index(axis)


def _local_rows(x, mesh, axis: str, d: int, rank: int):
    """(global shape, this rank's (F, H/d, W) complex64 rows). ``x`` is a
    DTensor placed by ``pencil_sharding(..., "rows")``, or a tensor (or
    array) holding the global array, the same on every rank, which is
    sliced to the rank's rows, as ``shard_map`` does with an unsharded
    input."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        want = pencil_sharding(mesh, axis, "rows", x.dim())
        if x.device_mesh != mesh or list(x.placements) != want:
            raise ValueError(f"fft2_pencil: input placed {tuple(x.placements)} on another mesh "
                             f"or layout; want {tuple(want)} on this mesh")
        shape = tuple(x.shape)
        local = x.to_local()
    else:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=mesh.device_type)
        shape = tuple(x.shape)
        local = None
    if len(shape) < 2:
        raise ValueError(f"fft2_pencil expects (..., H, W), got shape {shape}")
    h, w = shape[-2], shape[-1]
    _check_pow2(h, axis=len(shape) - 2)
    _check_pow2(w, axis=len(shape) - 1)
    if h % d or w % d:
        raise ValueError(f"fft2_pencil: H={h} and W={w} must be multiples of the {d} ranks "
                         f"of mesh axis {axis!r}")
    if local is None:
        local = x[..., rank * (h // d):(rank + 1) * (h // d), :]
    if local.device.type != mesh.device_type:
        raise ValueError(f"fft2_pencil: input on {local.device}, mesh of "
                         f"{mesh.device_type!r} devices")
    rows = ops._launchable(local, torch.complex64)  # real input is cast, as the reference does
    return shape, rows.reshape(-1, h // d, w)


def _rows(block: torch.Tensor, variant: str) -> torch.Tensor:
    """Engine 1: the row FFTs of the rank's (F, H/d, W) block, a new tensor."""
    if variant in _FUSED:
        out = torch.empty_like(block)
        ops.stream_rows(block, out, radix=4 if variant == "fused_r4" else 2)
        return out
    return fft_impl(block, axis=-1, variant=variant)


def _columns(turned: torch.Tensor, variant: str) -> None:
    """Engine 2: the column FFTs of the rank's contiguous (F, H, W/d)
    block, in place."""
    if variant in _FUSED:
        ops.stream_columns(turned, radix=4 if variant == "fused_r4" else 2)
    else:
        turned.copy_(fft_impl(turned, axis=-2, variant=variant))


def _corner_turn(block: torch.Tensor, group, d: int, out: torch.Tensor, async_op: bool = False):
    """Start the all_to_all transpose of (F, H/d, Wc) row pencils into the
    (F, H, Wc/d) column pencils ``out``: one ``all_to_all_single`` on the
    axis's group. The send buffer is (d, F, H/d, Wc/d), chunk j going to
    rank j; source j's chunk lands at index j of the receive buffer, as
    ``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` does.
    With one frame, or one rank, the receive buffer is ``out`` itself, and
    with one rank and one slab the send buffer is the rows themselves.
    Returns a finisher that waits for the exchange and unpacks into
    ``out``; it holds the send buffer until then, so the caching allocator
    does not hand it out while the collective's stream reads it."""
    import torch.distributed as dist

    f, h, wc = block.shape
    send = block.reshape(f, h, d, wc // d).permute(2, 0, 1, 3).contiguous()
    direct = f == 1 or d == 1
    recv = out.view(d, f, h, wc // d) if direct else torch.empty_like(send)
    COLLECTIVES["all_to_all_single"] += 1
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish() -> None:
        nonlocal send
        if work is not None:
            work.wait()
        send = None
        if not direct:
            out.view(f, d, h, wc // d).copy_(recv.permute(1, 0, 2, 3))

    return finish


def _setup(x, mesh, axis: str, variant: str, chunks=1):
    """(group, d, global shape, rows block, variant, chunks) of one call,
    ``"auto"`` resolved through the port's planner."""
    idx = _axis_index(mesh, axis)
    d = mesh.size(idx)
    shape, block = _local_rows(x, mesh, axis, d, mesh.get_local_rank(axis))
    if variant == "auto" or chunks == "auto":
        from repro_torch.plan.api import resolve  # lazy: plan imports core

        plan = resolve("fft2d_pencil", shape, block.device, n_devices=d)
        variant = plan.variant if variant == "auto" else variant
        chunks = plan.chunks if chunks == "auto" else chunks
    _check_variant(variant)
    return mesh.get_group(axis), d, shape, block, variant, int(chunks)


def _dtensor(local: torch.Tensor, mesh, placements, shape):
    """``local`` as the DTensor of global ``shape``: no collective runs."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def fft2_pencil(x, mesh, axis: str = "data", variant: str = "looped"):
    """Distributed 2D FFT of the global (..., H, W) ``x``, rows sharded
    along ``axis``: a DTensor placed ``pencil_sharding(mesh, axis,
    "rows")``, or the global array held the same on every rank.

    Returns a DTensor of the global (..., H, W) placed ``Shard(ndim - 1)``
    along ``axis``: rank r's local block holds columns [r W/d, (r+1) W/d).
    ``variant="auto"`` resolves ``problem_key("fft2d_pencil", shape,
    device, n_devices=d)`` through ``repro_torch.plan``. One
    ``all_to_all_single``; every rank of the axis must call it.
    """
    group, d, shape, block, variant, _ = _setup(x, mesh, axis, variant)
    f, h_loc, w = block.shape
    out = block.new_empty(f, h_loc * d, w // d)
    rows = _rows(block, variant)                     # engine 1 (local)
    _corner_turn(rows, group, d, out)()              # RAM hand-off
    _columns(out, variant)                           # engine 2 (local)
    local = out.reshape(*shape[:-2], h_loc * d, w // d)
    return _dtensor(local, mesh, pencil_sharding(mesh, axis, "cols", len(shape)), shape)


def fft2_pencil_overlapped(x, mesh, axis: str = "data", variant: str = "looped",
                           chunks: Union[int, Literal["auto"]] = "auto"):
    """Chunked pencil FFT overlapping the corner turn with column compute.

    W is split into ``chunks`` slabs; slab i's ``all_to_all_single`` is
    issued (``async_op=True``) before slab i-1's column pass runs, and each
    slab's handle is waited on before its columns, so on the card the
    exchange of slab i runs on the collective's stream while slab i-1's
    columns run on the compute stream: the ping-pong idea applied to the
    collective. ``chunks`` must divide W with W/chunks a multiple of the
    axis's d ranks (``repro_torch.plan.autotune.chunk_candidates``).

    As in the reference, the result is the replicated global (..., H, W)
    (a DTensor placed ``Replicate()``): one ``all_gather_into_tensor`` of
    the ranks' (chunks, ..., H, W/(chunks d)) blocks after the last slab,
    reordered so that global column c W/chunks + r W/(chunks d) + j comes
    from rank r. ``variant="auto"`` and ``chunks="auto"`` take the plan's.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    group, d, shape, block, variant, chunks = _setup(x, mesh, axis, variant, chunks)
    f, h_loc, w = block.shape
    h = h_loc * d
    if chunks < 1 or w % chunks or (w // chunks) % d:
        raise ValueError(f"fft2_pencil_overlapped: chunks={chunks} must divide W={w} into "
                         f"slabs whose width is a multiple of the {d} ranks "
                         "(see repro_torch.plan.autotune.chunk_candidates)")
    slab, part = w // chunks, w // chunks // d
    rows = _rows(block, variant)
    local = block.new_empty(chunks, f, h, part)
    pending = None
    for c in range(chunks + 1):
        started = (_corner_turn(rows[..., c * slab:(c + 1) * slab], group, d, local[c],
                                async_op=True) if c < chunks else None)
        if pending is not None:
            pending()                       # slab c-1's exchange, then its columns
            _columns(local[c - 1], variant)
        pending = started
    gathered = local.new_empty(d * chunks, f, h, part)
    COLLECTIVES["all_gather_into_tensor"] += 1
    dist.all_gather_into_tensor(gathered, local, group=group)
    full = gathered.view(d, chunks, f, h, part).permute(2, 3, 1, 0, 4).reshape(*shape[:-2], h, w)
    return _dtensor(full, mesh, [Replicate()] * mesh.ndim, shape)
