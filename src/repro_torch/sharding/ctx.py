"""Activation-sharding context.

Port of ``repro.sharding.ctx``. The reference pins GSPMD's choices with
``with_sharding_constraint`` annotations on its large activations;
eager PyTorch has no partitioner to pin, and a constraint changes no
value, so :func:`shard` resolves the reference's spec (with the same
fallbacks and the same errors) and returns its input unchanged. The
context matters where it picks a code path: :func:`cp_axis_for` sends
``gqa_apply`` to context-parallel attention.

The context is a no-op unless enabled.

Axis tokens used by ``shard(x, *tokens)``:
  "dp"   — batch sharded over the data(+pod) axes
  "tp"   — sharded over the model axis (skipped if the dim doesn't divide)
  "dp+tp"— batch sharded over data AND model axes; falls back to "dp" when
           the dim doesn't divide
  None   — unconstrained dim
"""

from __future__ import annotations

import contextlib
import contextvars

from repro_torch.compat import P

__all__ = ["activation_sharding", "cp_axis_for", "enabled", "shard", "shard_spec",
           "shard_weight", "tp_size"]

_CTX = contextvars.ContextVar("repro_torch_act_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(*, dp: tuple, dp_sizes: tuple, tp: str | None, tp_size: int,
                        cp: str | None = None, cp_size: int = 1):
    """``cp`` names a mesh axis available for context-parallel attention
    (sequence-sharded Q) when neither head-TP nor 2-D batch can use it."""
    token = _CTX.set({
        "dp": tuple(dp),
        "dp_sizes": tuple(dp_sizes),
        "tp": tp,
        "tp_size": tp_size if tp else 1,
        "cp": cp,
        "cp_size": cp_size if cp else 1,
    })
    try:
        yield
    finally:
        _CTX.reset(token)


def enabled() -> bool:
    return _CTX.get() is not None


def tp_size() -> int:
    """Model-axis size (1 when the context is disabled)."""
    c = _CTX.get()
    return c["tp_size"] if c else 1


def cp_axis_for(batch: int, seq: int) -> str | None:
    """Context-parallel axis to use for attention over (batch, seq) — only
    when the batch cannot spread over it and the sequence divides."""
    c = _CTX.get()
    if c is None or not c.get("cp"):
        return None
    total = 1  # dp product excluding the cp axis itself
    for a, s in zip(c["dp"], c["dp_sizes"]):
        if a != c["cp"]:
            total *= s
    if batch % (total * c["cp_size"]) == 0:
        return None  # 2-D batch already fills the axis
    if batch % total != 0 or seq % c["cp_size"] != 0:
        return None
    return c["cp"]


def _largest_prefix(dim: int, axes: tuple, sizes: tuple):
    """Longest prefix of ``axes`` whose total size divides ``dim``."""
    best = None
    prod = 1
    for ax, sz in zip(axes, sizes):
        prod *= sz
        if dim % prod == 0:
            best = axes[: axes.index(ax) + 1]
        else:
            break
    return best


def shard_spec(x, *tokens):
    """The spec :func:`shard` resolves for ``x`` (None when the context is
    disabled). Axis products that don't divide a dim fall back to the
    largest usable prefix."""
    c = _CTX.get()
    if c is None:
        return None
    if len(tokens) != x.dim():
        raise ValueError(f"{len(tokens)} tokens for rank-{x.dim()} array")
    dp, dp_sizes = c["dp"], c["dp_sizes"]
    tp, tp_sz = c["tp"], c["tp_size"]
    spec = []
    for i, t in enumerate(tokens):
        dim = x.shape[i]
        if t is None:
            spec.append(None)
        elif t == "dp":
            spec.append(_largest_prefix(dim, dp, dp_sizes))
        elif t == "tp":
            spec.append(tp if (tp and dim % tp_sz == 0) else None)
        elif t == "dp+tp":
            axes = dp + ((tp,) if tp else ())
            sizes = dp_sizes + ((tp_sz,) if tp else ())
            spec.append(_largest_prefix(dim, axes, sizes))
        else:
            raise ValueError(f"unknown axis token {t!r}")
    return P(*spec)


def shard(x, *tokens):
    """The reference's sharding constraint along ``tokens`` (one per dim of
    x): resolved and checked as there, and ``x`` returned unchanged (a
    constraint changes no value)."""
    shard_spec(x, *tokens)
    return x


def shard_weight(w, *tokens):
    """Compute-view of a weight: same token language."""
    return shard(w, *tokens)
