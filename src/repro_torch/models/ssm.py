"""Mamba2 (State-Space Duality) block: chunked parallel scan + recurrent decode.

Port of ``repro.models.ssm``. The prefill path is the SSD chunk
decomposition: an intra-chunk quadratic, attention-like term plus an
inter-chunk state recurrence. The decode path is the O(1) recurrent update
on a (H, P, N) state. The reference has no Pallas kernel here; these are
plain tensor ops on either device.

The three-operand einsums of the reference are written as products of two
operands, each a batched matmul over the same (B, chunks, H) batch, so no
intermediate is larger than the reference's (B, chunks, Q, Q, H) decay.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.param import ParamDef, _device

__all__ = ["mamba2_apply", "mamba2_skel", "mamba2_state"]

#: Where the intra-chunk mask sends the upper triangle, before the exp.
MASKED = -1e9


def mamba2_skel(cfg: ModelConfig) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return {
        "in_proj": ParamDef(
            (d, 2 * d_in + 2 * s.d_state + nh), ("embed", "ssm_in")
        ),
        "conv_w": ParamDef((s.d_conv, conv_dim), (None, "ssm_in"), scale=0.5),
        "conv_b": ParamDef((conv_dim,), ("ssm_in",), init="zeros"),
        # zeros: a = −exp(a_log) = −1 on every head at init
        "a_log": ParamDef((nh,), ("heads",), init="zeros"),
        "dt_bias": ParamDef((nh,), ("heads",), init="zeros"),
        "d_skip": ParamDef((nh,), ("heads",), init="ones"),
        "norm": ParamDef((d_in,), ("mlp",), init="ones"),
        "out_proj": ParamDef((d_in, d), ("mlp", "embed")),
    }


def mamba2_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    device = _device(device)
    return {
        "ssd": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def _split_proj(z, d_in: int, d_state: int, nh: int):
    zx = z[..., :d_in]
    xbc = z[..., d_in:2 * d_in + 2 * d_state]
    dt = z[..., 2 * d_in + 2 * d_state:]
    return zx, xbc, dt


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv over time. xbc: (B, L, C); w: (K, C). Returns
    (silu(conv + b), the last K − 1 inputs)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    l = xbc.shape[1]
    out = sum(xp[:, i:i + l] * w[i].to(xbc.dtype) for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return F.silu(out + b.to(xbc.dtype)), new_state


def _gated_rmsnorm(y, z, w, eps: float = 1e-5):
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps).to(y.dtype)) * w.to(y.dtype)


def _ssd_chunked(x, dt, a, b_mat, c_mat, d_skip, chunk: int, init_state=None):
    """SSD parallel form.

    x: (B, L, H, P); dt: (B, L, H) (after softplus); a: (H,) negative;
    b_mat, c_mat: (B, L, N). Returns (y (B, L, H, P), final state
    (B, H, P, N)). Chunk tensors are laid out head-major, (B, nc, H, Q, ·),
    so each product is one batched matmul.
    """
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc = l // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)

    da_cum = torch.cumsum(dtc * a, dim=2).transpose(2, 3)        # (B, nc, H, Q) ≤ 0
    x_dt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)          # (B, nc, H, Q, P)

    # Intra-chunk (masked decay kernel):
    # y[i] += sum_{j<=i} C_i·B_j e^{cum_i - cum_j} x_dt[j]
    seg = da_cum[..., :, None] - da_cum[..., None, :]             # (B, nc, H, i, j)
    # mask BEFORE exp: the (positive) upper triangle would overflow
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(tril, seg, MASKED)).to(x.dtype)
    cb = torch.matmul(cc, bc.transpose(-1, -2))                   # (B, nc, i, j)
    y_diag = torch.matmul(cb[:, :, None] * decay, x_dt)           # (B, nc, H, i, P)
    del seg, decay

    # Chunk summary states: S_c = sum_j e^{cum_last - cum_j} B_j x_dt[j]
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum).to(x.dtype)  # (B, nc, H, Q)
    states = torch.matmul((x_dt * decay_to_end[..., None]).transpose(-1, -2),
                          bc[:, :, None])                         # (B, nc, H, P, N)

    # Inter-chunk recurrence (sequential over the nc chunks).
    chunk_decay = torch.exp(da_cum[..., -1]).to(x.dtype)         # (B, nc, H)
    s = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
         if init_state is None else init_state.to(x.dtype))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                         # (B, nc, H, P, N)

    # Off-diagonal: y[i] += C_i e^{cum_i} S_{c-1}
    decay_from_start = torch.exp(da_cum).to(x.dtype)             # (B, nc, H, Q)
    y_off = torch.matmul(cc[:, :, None], s_prevs.transpose(-1, -2)) * decay_from_start[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, l, h, p)
    return y + x * d_skip[:, None], s


def mamba2_apply(p: dict, x, cfg: ModelConfig, *, state: dict | None = None,
                 decode: bool = False):
    """Returns (y, new_state). x: (B, L, D) (L == 1 when decode)."""
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    dt_ = x.dtype
    z = torch.matmul(x, p["in_proj"].to(dt_))
    zx, xbc_raw, dt_raw = _split_proj(z, d_in, s.d_state, nh)

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"], conv_state)
    xi = xbc[..., :d_in]
    b_mat = xbc[..., d_in:d_in + s.d_state]
    c_mat = xbc[..., d_in + s.d_state:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())            # (B, L, H)
    a = -torch.exp(p["a_log"].float())                                # (H,) negative
    xh = xi.reshape(*xi.shape[:-1], nh, s.head_dim)

    if decode:
        if state is None:
            raise ValueError("mamba2_apply: decode needs a state")
        # h' = h·exp(dt·a) + dt·B⊗x ; y = C·h' + D·x   (one step)
        dtb = dt[:, 0]                                                # (B, H)
        dec = torch.exp(dtb * a)                                      # (B, H)
        x0 = xh[:, 0].float()
        xb = x0[..., None] * b_mat[:, 0].float()[:, None, None, :]    # (B, H, P, N)
        h_new = state["ssd"] * dec[..., None, None] + xb * dtb[..., None, None]
        y = torch.einsum("bhpn,bn->bhp", h_new, c_mat[:, 0].float())
        y = y + x0 * p["d_skip"].float()[:, None]
        y = y.reshape(x.shape[0], 1, d_in).to(dt_)
        new_state = {"ssd": h_new, "conv": new_conv.to(state["conv"].dtype)}
    else:
        l0 = xh.shape[1]
        chunk = min(s.chunk, l0)
        pad = (-l0) % chunk
        xh_p, b_p, c_p, dt_p = xh, b_mat, c_mat, dt
        if pad:
            # state-neutral padding: dt = 0 ⇒ decay 1 and no state injection
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            b_p, c_p, dt_p = (F.pad(t, (0, 0, 0, pad)) for t in (b_mat, c_mat, dt))
        init = state["ssd"] if state is not None else None
        y4, s_final = _ssd_chunked(
            xh_p.float(), dt_p, a, b_p.float(), c_p.float(), p["d_skip"].float(),
            chunk, init_state=init,
        )
        y = y4[:, :l0].to(dt_).reshape(x.shape[0], -1, d_in)
        conv_dtype = torch.float32 if state is None else state["conv"].dtype
        new_state = {"ssd": s_final.float(), "conv": new_conv.to(conv_dtype)}

    y = _gated_rmsnorm(y, zx, p["norm"], cfg.rms_eps)
    return torch.matmul(y, p["out_proj"].to(dt_)), new_state
