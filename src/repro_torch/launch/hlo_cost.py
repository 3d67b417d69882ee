"""Flop and byte counting of one eager step, and the collectives' loop view.

Port of ``repro.launch.hlo_cost``. The reference re-costs XLA's compiled
module with loop multiplication. The port has no compiled module: it
counts the step as it runs, op by op, in a ``TorchDispatchMode``
(:class:`CostCounter`), on ``meta`` tensors in the dry-run (nothing is
allocated) or on the card's tensors (the same count, which is how the
dry-run is held to a real step). The rules are the reference's:

  product        2 × |result| × contracted size (mm, bmm, and the addmm /
                 baddbmm forms plus |result| for their add)
  elementwise    |result| flops (ops tagged pointwise, softmax and its
                 backward; copies and casts move bytes only)
  bytes          every op that is not a view: |result| bytes × 2 (one
                 read, one write); an allocation alone (``empty``) costs
                 nothing
  views, metadata  nothing
  kernels        the kernel entries charge their ``cost(...)`` (a
                 ``kernels._launch.Cost`` of flops and bytes;
                 ``kernels._launch.charge``), as XLA costs a custom call

Eager order already multiplies the loops XLA keeps as ``while`` bodies:
every layer runs, and remat's recompute runs again under
``torch.utils.checkpoint``. The counter also follows the live bytes of
the storages the step creates (weakrefs on each storage, as
``torch.distributed._tools.mem_tracker`` does), whose peak is the step's
temp figure, and keeps a per-op table (:meth:`CostCounter.table`), the
counterpart of the reference's ``--save-hlo`` text.

:func:`top_collectives` is the reference's per-collective view,
trips × traffic, sorted, over ``repro_torch.launch.hlo_analysis``'s
records.
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels._launch import COUNTERS, Cost

__all__ = ["CostCounter", "loop_aware_cost", "top_collectives"]

#: Devices whose storages count toward the live bytes: the dry-run's and the card's.
_TRACKED = ("meta", "cuda")
#: Ops that allocate without writing: no bytes.
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
#: Data movement tagged pointwise: bytes, no flops.
_MOVES = {"clone", "copy", "_to_copy", "copy_", "fill", "fill_", "zero_", "zeros_like",
          "ones_like", "full_like"}
#: Ops that return views without alias information.
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh_copy"}
#: Elementwise ops XLA reports as transcendentals.
_TRANSCENDENTAL = {"exp", "exp_", "log", "log1p", "expm1", "sin", "cos", "tanh", "sigmoid",
                   "rsqrt", "sqrt", "pow", "erf", "silu", "gelu", "softplus",
                   "log_sigmoid_forward", "_softmax", "_log_softmax"}
#: Elementwise without the pointwise tag: |result| flops.
_ELEMENTWISE = {"_softmax", "_log_softmax", "_softmax_backward_data",
                "_log_softmax_backward_data"}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _product_flops(name: str, args, out) -> float | None:
    """2 |result| K of the product ops, plus |result| for the add of the
    addmm forms (None for any other op)."""
    if name not in ("mm", "addmm", "bmm", "baddbmm"):
        return None
    add = name in ("addmm", "baddbmm")
    a = args[1] if add else args[0]
    return 2.0 * out.numel() * a.shape[-1] + (out.numel() if add else 0)


class CostCounter(TorchDispatchMode):
    """Flops, bytes and live memory of everything run inside it.

    ``flops`` / ``bytes``: totals (ops and kernel charges);
    ``transcendentals``: elements of the exp, log, trigonometric and root
    ops among them; ``kernels``:
    {name: {"calls", "flops", "bytes"}} of the charges; ``ops``: {aten op:
    {"count", "flops", "bytes"}}; ``peak_bytes``: the most bytes the step's
    own storages held at once (storages on a meta or CUDA device; the
    inputs it was handed are not its own). Entered, it is in force for the
    kernel entries' charges (``kernels._launch.COUNTERS``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.ops: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    def __enter__(self):
        super().__enter__()
        COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        COUNTERS.remove(self)
        return super().__exit__(*exc)

    # ---- kernel charges (kernels._launch.charge) ----
    def charge_kernel(self, name: str, cost: Cost) -> None:
        row = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += cost.flops
        row["bytes"] += cost.bytes
        self.flops += cost.flops
        self.bytes += cost.bytes

    # ---- live storages ----
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            if t.device.type not in _TRACKED:
                continue
            storage = t.untyped_storage()
            key = id(storage)
            if key in self._live:
                continue
            self._live[key] = storage.nbytes()
            self.live_bytes += storage.nbytes()
            weakref.finalize(storage, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        returns = func._schema.returns
        alias = returns[0].alias_info if returns else None
        if (alias is not None and not alias.is_write) or name in _VIEWS:
            return out  # a view or metadata: costs nothing
        flops = _product_flops(name, args, out)
        if flops is None:
            pointwise = torch.Tag.pointwise in func.tags and name not in _MOVES
            flops = float(_numel(out)) if pointwise or name in _ELEMENTWISE else 0.0
        nbytes = 0.0 if name in _ALLOCATIONS else 2.0 * _nbytes(out)
        if name in _TRANSCENDENTAL:
            self.transcendentals += _numel(out)
        if alias is None:
            self._track(out)
        row = self.ops.setdefault(str(func), {"count": 0, "flops": 0.0, "bytes": 0.0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        return out

    def table(self, limit: int | None = None) -> str:
        """The per-op and per-kernel table, most flops first, as text."""
        rows = [(f"kernel {k}", v["calls"], v["flops"], v["bytes"])
                for k, v in self.kernels.items()]
        rows += [(k, v["count"], v["flops"], v["bytes"]) for k, v in self.ops.items()]
        rows.sort(key=lambda r: (-r[2], -r[3]))
        lines = [f"{'op':<48} {'count':>8} {'flops':>12} {'bytes':>12}"]
        lines += [f"{n:<48} {c:>8} {f:>12.4e} {b:>12.4e}" for n, c, f, b in rows[:limit]]
        lines.append(f"{'total':<48} {'':>8} {self.flops:>12.4e} {self.bytes:>12.4e}")
        lines.append(f"peak live bytes {self.peak_bytes}")
        return "\n".join(lines)


def loop_aware_cost(counter: CostCounter, collectives: list) -> dict:
    """The reference's keys: flops and bytes of the counted step, the
    collectives' traffic and count with each multiplied by its trips."""
    from repro_torch.launch.hlo_analysis import traffic

    return {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "collective_traffic_bytes": float(sum(c.trips * traffic(c) for c in collectives)),
        "collective_count": float(sum(c.trips for c in collectives)),
    }


def top_collectives(collectives: list, n: int = 15) -> List[dict]:
    """Per-collective traffic × trips, sorted descending — the 'where is
    it going' view, in the reference's row shape."""
    from repro_torch.launch.hlo_analysis import traffic

    rows = [{"kind": c.kind, "result": c.site[:60], "trips": c.trips,
             "traffic_total": traffic(c) * c.trips} for c in collectives]
    rows.sort(key=lambda r: -r["traffic_total"])
    return rows[:n]
