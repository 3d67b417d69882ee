"""Module-less parameter system: models are (skeleton, pure functions).

Port of ``repro.models.param``. A *skeleton* is a tree (nested dicts) of
``ParamDef`` describing every weight: shape, dtype, init and **logical
axes** (names like "embed", "heads", "mlp"). From a skeleton we derive:

  * ``init_params``       — concrete tensors, drawn from a caller's
                            ``torch.Generator`` on the device they go to
  * ``abstract_params``   — ``meta`` tensors (shapes and dtypes, no storage)
  * ``params_from_numpy`` — a reference parameter tree of numpy leaves
                            carried across as tensors, same keys and shapes
  * ``partition_specs``   — a ``PartitionSpec`` per leaf, via per-config
                            sharding rules (``repro_torch.sharding.rules``)

The init is the reference's, quirk included: ``fan_in = shape[0]``, which
for a stacked layer weight is the layer count (ROADMAP, observations).
The draws are torch's, not JAX's: parity with the reference goes through
``params_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "ParamDef",
    "abstract_params",
    "default_device",
    "init_params",
    "param_bytes",
    "param_count",
    "params_from_numpy",
    "partition_specs",
    "stack_defs",
    "stack_skeleton",
    "tree_leaves",
    "tree_map",
]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: Any = torch.float32
    init: str = "normal"  # "normal" | "zeros" | "ones" | "scaled"
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"rank mismatch: shape {self.shape} vs axes {self.logical_axes}"
            )


def default_device() -> torch.device:
    """The card: where the LM stack runs unless the caller names a device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.models runs on torch.device('cuda') unless a device is "
            "given, and CUDA is not available; pass device='cpu' to compute on the CPU"
        )
    return torch.device("cuda")


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


# ------------------------------ trees ------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (dict keys
    in sorted order, as ``jax.tree`` walks them); ``rest`` are trees of the
    same structure whose leaves are passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_like(tree, leaves):
    """``leaves`` (in tree order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def unstack(stacked, n: int) -> list:
    """The ``n`` layers of stacked weights, one tree each, every leaf
    unbound once along its leading layer axis. Under autograd the stacked
    gradient is then assembled in one pass at the end of the backward;
    indexing each layer's slice instead has autograd zero-fill a gradient
    of the whole stack for every layer and add them up (on llama3.2-3b's
    training step 60% of the card's time)."""
    unbound = [t.unbind(0) for t in tree_leaves(stacked)]
    return [tree_like(stacked, [u[i] for u in unbound]) for i in range(n)]


# ------------------------------ params ------------------------------


#: Elements of a narrower-than-float32 leaf drawn in float32 at once.
DRAW_CHUNK = 1 << 26


def init_params(skeleton, generator: torch.Generator, dtype=None, device=None):
    """Materialise a skeleton into tensors on ``device`` (default: the
    generator's), drawn from ``generator`` leaf by leaf in tree order, each
    in float32 and cast to its dtype (``dtype``, else the leaf's own). A
    leaf of a narrower dtype is drawn DRAW_CHUNK elements at a time, so
    no float32 copy of it is ever whole."""
    device = torch.device(device) if device is not None else generator.device

    def one(d: ParamDef):
        dt = dtype or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[0] if d.shape else 1
        std = d.scale * (1.0 / math.sqrt(max(fan_in, 1)))
        if torch.empty((), dtype=dt).element_size() >= 4:
            x = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=device)
            return (x * std).to(dt)
        out = torch.empty(d.shape, dtype=dt, device=device)
        flat = out.view(-1)
        for lo in range(0, flat.numel(), DRAW_CHUNK):
            n = min(DRAW_CHUNK, flat.numel() - lo)
            x = torch.randn(n, generator=generator, dtype=torch.float32, device=device)
            flat[lo:lo + n] = x * std
        return out

    return tree_map(one, skeleton)


def abstract_params(skeleton, dtype=None):
    """``meta`` tensor tree: shapes and dtypes, no storage."""
    return tree_map(
        lambda d: torch.empty(d.shape, dtype=dtype or d.dtype, device="meta"), skeleton
    )


def _from_numpy(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """A reference parameter tree with numpy leaves (``jax.tree.map(
    np.asarray, params)``) as tensors on ``device`` (default: the card),
    same keys, shapes and dtypes."""
    device = _device(device)
    return tree_map(lambda x: _from_numpy(x, device), tree)


def partition_specs(skeleton, rules: dict[str, Any]):
    """logical axes -> ``PartitionSpec`` using a {logical_name: mesh_axes}
    map. Unknown logical names are replicated. ``rules`` values may be
    None, a mesh-axis name, or a tuple of mesh-axis names; a mesh axis
    appears at most once in a spec (the first use wins)."""
    from repro_torch.compat import P

    def one(d: ParamDef):
        spec = []
        used: set[str] = set()
        for a in d.logical_axes:
            r = rules.get(a) if a is not None else None
            axes = (r,) if isinstance(r, str) else tuple(r or ())
            axes = tuple(ax for ax in axes if ax not in used)
            used.update(axes)
            if not axes:
                spec.append(None)
            elif len(axes) == 1:
                spec.append(axes[0])
            else:
                spec.append(axes)
        return P(*spec)

    return tree_map(one, skeleton)


def param_count(skeleton) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(skeleton)))


def param_bytes(skeleton) -> int:
    return int(sum(
        math.prod(d.shape) * torch.empty((), dtype=d.dtype).element_size()
        for d in tree_leaves(skeleton)
    ))


def stack_defs(d: ParamDef, n: int, axis_name: str = "layers") -> ParamDef:
    """Add a leading stacked-layer dimension (one tensor over all layers)."""
    return dataclasses.replace(
        d,
        shape=(n, *d.shape),
        logical_axes=(axis_name, *d.logical_axes),
    )


def stack_skeleton(skel, n: int, axis_name: str = "layers"):
    return tree_map(lambda d: stack_defs(d, n, axis_name), skel)
