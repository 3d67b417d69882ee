"""xLSTM blocks: mLSTM (matrix memory, parallelisable) and sLSTM (scalar
memory, strictly recurrent), after Beck et al. 2024 (arXiv:2405.04517).

Port of ``repro.models.xlstm``. mLSTM has two equivalent forms:

* chunked — intra-chunk quadratic form plus an inter-chunk (C, n, m)
  carry, for prefill (:func:`_mlstm_chunked`; :func:`_mlstm_parallel` is
  the whole-sequence quadratic form it decomposes);
* recurrent — the O(1) (C, n, m) state update, for decode.

sLSTM is strictly sequential over time (exponential gating with the
m-stabiliser, block-diagonal recurrent weights over 4 heads). Its prefill
runs the hand-written ``repro_torch.kernels.slstm_scan.slstm_scan`` on the
gate pre-activations ``xg = x @ wx``: on a CUDA tensor the kernel, on a
CPU tensor its plain version, where the reference's model runs a
``lax.scan`` of ``_slstm_step`` (ROADMAP, divergence 15). Under grad the
card's scan runs as ``SlstmScan``, whose backward is the hand-written
reverse scan ``slstm_scan_bwd``. Its decode is one
:func:`~repro_torch.kernels.slstm_scan.slstm_step`.

Both blocks return new state tensors; the stack writes them into its
cache. States are float32 whatever the compute dtype; the stabiliser ``m``
starts at −inf.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import slstm_scan, slstm_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamDef, _device

__all__ = [
    "NEG_INF",
    "mlstm_apply",
    "mlstm_skel",
    "mlstm_state",
    "slstm_apply",
    "slstm_skel",
    "slstm_state",
]

NEG_INF = -1.0e30

#: The mLSTM prefill's time tile (the reference's ``min(256, L)``).
MLSTM_CHUNK = 256


# ------------------------------- mLSTM -------------------------------

def mlstm_skel(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in = 2 * d                      # up-projection factor 2
    h = cfg.n_heads
    dh = d_in // h
    return {
        "up": ParamDef((d, 2 * d_in), ("embed", "mlp")),       # x_in, z gate
        "wq": ParamDef((d_in, h, dh), ("mlp", "heads", "head_dim")),
        "wk": ParamDef((d_in, h, dh), ("mlp", "heads", "head_dim")),
        "wv": ParamDef((d_in, h, dh), ("mlp", "heads", "head_dim")),
        "wi": ParamDef((d_in, h), ("mlp", "heads"), scale=0.1),
        "wf": ParamDef((d_in, h), ("mlp", "heads"), scale=0.1),
        # init="ones" ignores scale: the forget bias starts at 1.0, as the
        # reference's does
        "fb": ParamDef((h,), ("heads",), init="ones", scale=3.0),
        "norm": ParamDef((d_in,), ("mlp",), init="ones"),
        "down": ParamDef((d_in, d), ("mlp", "embed")),
    }


def mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    d_in = 2 * cfg.d_model
    h = cfg.n_heads
    dh = d_in // h
    device = _device(device)
    return {
        "c": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),  # k ⊗ v memory
        "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
        "m": torch.full((batch, h), float("-inf"), dtype=dtype, device=device),
    }


def _tril(n: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


def _mlstm_parallel(q, k, v, log_i, log_f):
    """Stabilised parallel mLSTM. q, k, v: (B, L, H, Dh); gates (B, L, H) logs."""
    _, l, _, dh = q.shape
    lf_cum = torch.cumsum(log_f, dim=1)                         # (B, L, H)
    # log D[t, s] = lf_cum[t] − lf_cum[s] + log_i[s] for s ≤ t
    ld = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + log_i[:, None, :, :]
    ld = torch.where(_tril(l, q.device)[None, :, :, None], ld, NEG_INF)
    m = ld.amax(dim=2)                                          # (B, L, H)
    d_mat = torch.exp(ld - m[:, :, None, :])
    qk = torch.einsum("blhd,bshd->blsh", q, k) / math.sqrt(dh)
    c = qk * d_mat
    n = torch.maximum(torch.abs(c.sum(dim=2)), torch.exp(-m))
    return torch.einsum("blsh,bshd->blhd", c, v) / n[..., None]


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state0: dict):
    """Chunkwise mLSTM: intra-chunk quadratic form plus the inter-chunk
    (C, n, m) carry, one chunk at a time (the reference's ``lax.scan``).

    Peak score memory is (B, Q, Q, H) a chunk. q, k, v: (B, L, H, Dh)
    float32; gates (B, L, H) in log space. Returns (y, state)."""
    b, l, h, dh = q.shape
    q = q / math.sqrt(dh)
    mask = _tril(chunk, q.device)[None, :, :, None]
    c_prev, n_prev, m_prev = state0["c"], state0["n"], state0["m"]
    ys = []
    for t0 in range(0, l, chunk):
        qc, kc, vc = (x[:, t0:t0 + chunk] for x in (q, k, v))
        lic, lfc = log_i[:, t0:t0 + chunk], log_f[:, t0:t0 + chunk]
        lf_cum = torch.cumsum(lfc, dim=1)                       # (B, Q, H)
        ld = lf_cum[:, :, None, :] - lf_cum[:, None, :, :] + lic[:, None, :, :]
        ld = torch.where(mask, ld, NEG_INF)
        local_max = ld.amax(dim=2)                              # (B, Q, H)
        m_t = torch.maximum(local_max, lf_cum + m_prev[:, None, :])
        inter = torch.exp(lf_cum + m_prev[:, None, :] - m_t)    # (B, Q, H)
        num = torch.einsum("bqhd,bhdv->bqhv", qc, c_prev) * inter[..., None]
        den = torch.einsum("bqhd,bhd->bqh", qc, n_prev) * inter
        d_mat = torch.exp(ld - m_t[:, :, None, :])
        cm = torch.einsum("bqhd,bshd->bqsh", qc, kc) * d_mat
        num = num + torch.einsum("bqsh,bshv->bqhv", cm, vc)
        den = torch.maximum(torch.abs(den + cm.sum(dim=2)), torch.exp(-m_t))
        ys.append(num / den[..., None])
        # end-of-chunk state
        lf_tot = lf_cum[:, -1]                                  # (B, H)
        tail = lf_tot[:, None, :] - lf_cum + lic                # (B, Q, H)
        m_next = torch.maximum(m_prev + lf_tot, tail.amax(dim=1))
        b_scale = torch.exp(tail - m_next[:, None, :])
        c_carry = torch.exp(m_prev + lf_tot - m_next)
        kb = kc * b_scale[..., None]
        c_prev = c_prev * c_carry[..., None, None] + torch.einsum("bshd,bshv->bhdv", kb, vc)
        n_prev = n_prev * c_carry[..., None] + kb.sum(dim=1)
        m_prev = m_next
    return torch.cat(ys, dim=1), {"c": c_prev, "n": n_prev, "m": m_prev}


def _mlstm_recurrent_step(state, q, k, v, log_i, log_f):
    """One decode step. q, k, v: (B, H, Dh); gates (B, H) logs. Returns
    (h, state)."""
    dh = q.shape[-1]
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_sc = torch.exp(log_i - m_new)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    c = state["c"] * f_sc[..., None, None] + i_sc[..., None, None] * (
        k[..., :, None] * v[..., None, :]
    )
    n = state["n"] * f_sc[..., None] + i_sc[..., None] * k
    qs = q / math.sqrt(dh)
    num = torch.einsum("bhd,bhdv->bhv", qs, c)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n)), torch.exp(-m_new))
    return num / den[..., None], {"c": c, "n": n, "m": m_new}


def _heads(x, w):
    """einsum("blk,khd->blhd", x, w) as one matmul."""
    k, h, d = w.shape
    return torch.matmul(x, w.reshape(k, h * d)).reshape(*x.shape[:-1], h, d)


def _norm_scale(y, w, eps: float):
    """The blocks' learned RMS norm in y's dtype, the statistic in float32."""
    dt = y.dtype
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps).to(dt)) * w.to(dt)


def mlstm_apply(p, x, cfg: ModelConfig, *, state=None, decode=False):
    """Returns (y, new_state). x: (B, L, D). ``new_state`` is None for a
    prefill given no state, as in the reference."""
    d_in = 2 * cfg.d_model
    dt = x.dtype
    up = torch.matmul(x, p["up"].to(dt))
    x_in, z = up[..., :d_in], up[..., d_in:]
    q = _heads(x_in, p["wq"].to(dt)).float()
    k = _heads(x_in, p["wk"].to(dt)).float()
    v = _heads(x_in, p["wv"].to(dt)).float()
    x32 = x_in.float()
    log_i = torch.matmul(x32, p["wi"].float())
    log_f = F.logsigmoid(torch.matmul(x32, p["wf"].float()) + p["fb"].float())

    if decode:
        if state is None:
            raise ValueError("mlstm_apply: decode needs a state")
        y1, new_state = _mlstm_recurrent_step(
            state, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0]
        )
        y = y1[:, None]  # (B, 1, H, Dh)
    else:
        l0 = q.shape[1]
        chunk = min(MLSTM_CHUNK, l0)
        pad = (-l0) % chunk
        if pad:
            # state-neutral padding: log_f = 0 (decay 1), log_i = NEG_INF (no write)
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            log_f = F.pad(log_f, (0, 0, 0, pad))
            log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_INF)
        s0 = state if state is not None else mlstm_state(cfg, x.shape[0], device=x.device)
        y, new_state = _mlstm_chunked(q, k, v, log_i, log_f, chunk, s0)
        y = y[:, :l0]
        if state is None:
            new_state = None

    y = y.reshape(x.shape[0], -1, d_in).to(dt)
    # gated output norm + down-projection
    y = _norm_scale(y * F.silu(z), p["norm"], cfg.rms_eps)
    return torch.matmul(y, p["down"].to(dt)), new_state


# ------------------------------- sLSTM -------------------------------

_SLSTM_HEADS = 4


def _round128(n: int) -> int:
    return (n + 127) // 128 * 128


def slstm_skel(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    hd = d // _SLSTM_HEADS
    # xLSTM's 4/3 feed-forward factor, rounded up to a multiple of 128 at
    # the widths the reference shards (1408 at d 1024)
    ff = _round128((4 * d) // 3) if d >= 96 else (4 * d) // 3
    return {
        "wx": ParamDef((d, 4 * d), ("embed", None)),           # i, f, z, o from input
        "wr": ParamDef((_SLSTM_HEADS, hd, 4 * hd), (None, None, None), scale=0.5),
        "bias": ParamDef((4 * d,), (None,), init="zeros"),
        "norm": ParamDef((d,), ("embed",), init="ones"),
        "ff_up": ParamDef((d, ff), ("embed", "mlp")),
        "ff_down": ParamDef((ff, d), ("mlp", "embed")),
    }


def slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    d = cfg.d_model
    device = _device(device)
    return {
        "c": torch.zeros((batch, d), dtype=dtype, device=device),
        "n": torch.zeros((batch, d), dtype=dtype, device=device),
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "m": torch.full((batch, d), float("-inf"), dtype=dtype, device=device),
    }


def slstm_apply(p, x, cfg: ModelConfig, *, state=None, decode=False):
    """Returns (y, new_state). Sequential over L in both modes: a prefill
    is one ``slstm_scan``, a decode step one ``slstm_step``."""
    d = cfg.d_model
    dt = x.dtype
    xg = torch.matmul(x.float(), p["wx"].float())
    s0 = state if state is not None else slstm_state(cfg, x.shape[0], device=x.device)
    w = {"wr": p["wr"].float(), "bias": p["bias"].float()}

    if decode:
        s_new = slstm_step(w, s0, xg[:, 0], d)
        hs = s_new["h"][:, None]
    else:
        # chunk=L: the wrapper's time tile must divide L; on the card it
        # changes nothing (the kernel holds the state for all L steps)
        hs, final = slstm_scan(xg, w["wr"], w["bias"], s0["c"], s0["n"], s0["h"], s0["m"],
                               chunk=xg.shape[1])
        s_new = dict(zip("cnhm", final))

    y = _norm_scale(hs.to(dt), p["norm"], cfg.rms_eps)
    h = F.gelu(torch.matmul(y, p["ff_up"].to(dt)), approximate="tanh")  # jax.nn.gelu
    out = torch.matmul(h, p["ff_down"].to(dt))
    return out, (s_new if (state is not None or decode) else None)
