"""int8 gradient compression with error feedback.

Port of ``repro.optim.compression``: the data-parallel mean is taken on
int8-quantised tensors (per-tensor absmax scale), and the quantisation
residual is fed back into the next step's gradient, so that the bias
vanishes over time (error-feedback SGD, Seide et al. / Karimireddy et
al.). The reference's ``axis_name`` (a ``pmean`` over a mesh axis) is a
``torch.distributed`` process group here, over which the dequantised
tensors are averaged with one all-reduce each; with no group the mean is
the identity, as with ``axis_name=None``.
"""

from __future__ import annotations

import torch

from repro_torch.models.param import tree_leaves, tree_like, tree_map

__all__ = ["compress_int8", "compressed_mean", "decompress_int8", "init_error_state"]


def compress_int8(g: torch.Tensor):
    """(q, scale): g / scale rounded half to even and clipped to [-127,
    127] as int8, scale = max|g| / 127 in float32, at least 1e-12."""
    scale = torch.clamp(torch.max(torch.abs(g)).to(torch.float32) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_mean(grads, error_state, group=None):
    """Quantise (grad + error), average over ``group`` (a
    ``torch.distributed`` process group; None: no average), and return
    (mean_grads in each gradient's dtype, new float32 error state)."""

    def one(g, e):
        g_fb = g.to(torch.float32) + e
        q, scale = compress_int8(g_fb)
        deq = decompress_int8(q, scale)
        new_e = g_fb - deq
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(deq, group=group)
            deq = deq / dist.get_world_size(group)
        return deq.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error_state))]
    return tree_like(grads, (m for m, _ in out)), tree_like(grads, (e for _, e in out))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
