"""Shared neural layers (pure functions over ParamDef skeletons).

Port of ``repro.models.layers``. Weights are stored in their own dtype and
cast to the activations' dtype at each use, as the reference casts them
(``p["up"].astype(dt)``); every cast the reference leaves to JAX's type
promotion is written out. The reference's activation-sharding annotations
are no-ops on one device and are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamDef

__all__ = [
    "apply_rope",
    "embed",
    "embedding_skel",
    "mlp",
    "mlp_skel",
    "rmsnorm",
    "rmsnorm_skel",
    "rope_freqs",
    "softmax_xent",
    "unembed",
    "unembed_skel",
]


# ----------------------------- norms -----------------------------

def rmsnorm_skel(d: int) -> dict:
    return {"scale": ParamDef((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


# --------------------------- embeddings ---------------------------

def embedding_skel(vocab: int, d: int) -> dict:
    return {"table": ParamDef((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(p, tokens, compute_dtype):
    return p["table"][tokens].to(compute_dtype)


def unembed_skel(vocab: int, d: int) -> dict:
    return {"kernel": ParamDef((d, vocab), ("embed", "vocab"))}


def unembed(p, x):
    # logits in f32 for a stable softmax/loss
    return torch.matmul(x, p["kernel"].to(x.dtype)).float()


# ------------------------------ MLP ------------------------------

def mlp_skel(d: int, d_ff: int, act: str = "swiglu") -> dict:
    skel = {
        "up": ParamDef((d, d_ff), ("embed", "mlp")),
        "down": ParamDef((d_ff, d), ("mlp", "embed")),
    }
    if act == "swiglu":
        skel["gate"] = ParamDef((d, d_ff), ("embed", "mlp"))
    return skel


def mlp(p, x, act: str = "swiglu"):
    dt = x.dtype
    up = torch.matmul(x, p["up"].to(dt))
    if act == "swiglu":
        gate = torch.matmul(x, p["gate"].to(dt))
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    return torch.matmul(h, p["down"].to(dt))


# ------------------------------ RoPE ------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh) with rotary over Dh, halves split (not
    interleaved); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (Dh/2,)
    ang = positions[..., :, None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------- loss utils ---------------------------

def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross entropy. logits (..., V) f32, labels int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
