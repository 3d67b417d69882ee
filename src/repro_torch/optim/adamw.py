"""AdamW + global-norm clipping + cosine schedule, on trees of tensors.

Port of ``repro.optim.adamw``: plain functions on (nested) dicts of
tensors, as the reference's are on pytrees. Moments are kept in float32
(or ``dtype``), the step is an int32 tensor, bias correction is
``1 - b ** step``, and each parameter is updated in float32 and cast back
to its dtype, all as in the reference, on the device the parameters lie
on (no value leaves it).

One difference, the PyTorch idiom: :func:`adamw_update` writes the new
parameters and moments into the tensors it is given and returns them,
where the reference returns new arrays (ROADMAP, divergence 20). At
llama3.2-3b's width the float32 parameters and the two moments take 38.5
GB; a second copy of them beside the gradients would not fit one 80 GB
card. A caller that needs the old state clones it first.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.param import tree_leaves, tree_map

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "cosine_schedule"]


def adamw_init(params, dtype=torch.float32):
    """Zero moments of ``dtype`` beside every parameter, and step 0 (an
    int32 tensor on the parameters' device). ``dtype=torch.bfloat16``
    halves the optimizer's memory."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=dtype)  # noqa: E731
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def cosine_schedule(step, *, peak_lr=3e-4, warmup=100, total=10_000, floor=0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` of it
    at ``total``; a float32 tensor of ``step``'s shape."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)


def global_norm_scale(grads, max_norm=1.0):
    """(the factor that brings ``grads`` to a global norm of at most
    ``max_norm``, the norm before), as float32 tensors. The norm sums
    every leaf's squares in float32, in tree order."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm=1.0):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before): a new tree. A train step passes the factor of
    :func:`global_norm_scale` to :func:`adamw_update` instead, which
    scales one leaf at a time (no second tree of gradients)."""
    scale, gn = global_norm_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state,
    *,
    lr=None,
    b1=0.9,
    b2=0.95,
    eps=1e-8,
    weight_decay=0.1,
    peak_lr=3e-4,
    warmup=100,
    total=10_000,
    grad_scale=None,
):
    """One AdamW step. Writes the new parameters into ``params`` and the
    new moments into ``state["mu"]`` / ``state["nu"]``, leaf by leaf (at
    most two float32 temporaries of one leaf at a time), and returns
    ``(params, {"mu", "nu", "step": step + 1})``. ``lr`` defaults to
    :func:`cosine_schedule` at the new step. ``grad_scale`` (the factor
    of :func:`global_norm_scale`) multiplies each gradient in its own
    dtype first, the same bits as stepping on
    :func:`clip_by_global_norm`'s tree."""
    step = state["step"] + 1
    lr_t = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup, total=total) if lr is None else lr
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        if grad_scale is not None:
            g = g * grad_scale.to(g.dtype)
        g32 = g.to(torch.float32)
        mu.mul_(b1).add_((1 - b1) * g32)
        nu.mul_(b2).add_((1 - b2) * torch.square(g32))
        del g, g32
        denom = torch.sqrt(nu / bc2).add_(eps)
        update = (mu / bc1).div_(denom)
        del denom
        p32 = p.to(torch.float32)
        update.add_(weight_decay * p32)
        if p.dtype == torch.float32:
            p.sub_(update.mul_(lr_t))
        else:
            p.copy_(p32 - lr_t * update)
        return p

    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}
