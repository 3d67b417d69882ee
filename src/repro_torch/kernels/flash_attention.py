"""Forward flash attention on the card, its plain version and its oracle.

Port of ``repro.kernels.flash_attention``. Scores are kept on chip: per
(batch-head, query tile) the online-softmax state (acc, m, l) is carried
over the key tiles, so device memory sees q, k and v once and the output
once, never the (Sq, Sk) score matrix.

Layout as in the reference: q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv),
float32; grouped-query callers repeat k and v to the query heads first.
Masks: causal (key <= query) and a sliding window (key > query - window),
applied as ``NEG_INF = -1e30``, never ``-inf``; l is floored at 1e-20.
Query row r sits at position ``q_offset + r`` (default 0), as in the
reference model's ``flash_attention``: a context-parallel rank attends its
slice of the queries against every key.

* :func:`flash_attention_fwd` — a CPU tensor runs the plain version; a CUDA
  tensor launches ``csrc/flash_attention.cu`` or raises. That kernel runs
  its products on the tensor cores (``mma.sync`` TF32), each float32
  product split into three TF32 products so that the result stays float32
  to about 1e-7. ``block_q`` and ``block_k`` are the reference's tile
  sizes: the plain version walks exactly those blocks, and the card kernel
  walks its own tiles (128 query rows, 64 where Dv > 128, by 32 keys),
  which changes a result only by rounding (the note in the CUDA source
  says why, and which rows take the padded key count from ``block_k``).
* :func:`flash_attention_plain` — the reference kernel's recurrence in
  torch, block for block.
* :func:`mha_reference` — the naive oracle.

The backward has no TPU counterpart (the reference differentiates its
model's jnp attention by XLA):

* :func:`flash_attention_bwd` — (dq, dk, dv) from q, k, v, the output, its
  cotangent and each query row's logsumexp, which the forward writes when
  asked (``return_lse=True``; serving never asks, so it pays nothing). The
  forward holds m and l at its end, so the logsumexp costs one float a
  row there; recomputing it in the backward would take one more pass
  over every score (2 D flops a pair, a fifth of the backward's work). A
  CPU tensor runs :func:`flash_attention_bwd_plain`; a CUDA tensor launches
  ``csrc/flash_attention_bwd.cu`` (a dQ pass and a dK/dV pass, every
  product split-TF32 on the tensor cores as the forward's, no atomics: the
  same bits every run) or raises.
* :func:`flash_attention` — the differentiable entry: under grad an
  ``autograd.Function`` whose forward is :func:`flash_attention_fwd` and
  whose backward is :func:`flash_attention_bwd`, else the forward alone.

:func:`fwd_cost` and :func:`bwd_cost` give each kernel's work (flops,
bytes) on given shapes: the card's bound, and what a meta tensor's call
charges a cost counter (a meta tensor takes the card route and launches
nothing; ``kernels._launch``).

Called under grad with an input that requires grad, outside that
Function, the card's forward raises (:class:`NoBackward`) rather than
return a tensor with no ``grad_fn`` (ROADMAP, divergence 19).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels._launch import Cost, charge, launch, refuse_grad

__all__ = [
    "MAX_HEAD_DIM",
    "NEG_INF",
    "FlashAttention",
    "attention_pairs",
    "bwd_cost",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "flash_blocks_per_sm",
    "flash_bwd_smem_bytes",
    "flash_smem_bytes",
    "fwd_cost",
    "mha_reference",
]

NEG_INF = -1.0e30

#: Largest D and Dv the CUDA kernel takes (its tiles' shared memory).
MAX_HEAD_DIM = 256

#: Keys per tile, and threads per block (4 warps), of the CUDA kernel.
TILE_K = 32
THREADS = 128


def query_tile(dv: int) -> int:
    """Query rows per block of the CUDA kernel: each of the 4 warps takes
    two 16-row m-tiles (128 rows), or one where Dv > 128 (64 rows: the
    output accumulator of two would not fit in registers)."""
    return 64 if dv > 128 else 128


def _row_floats(width: int) -> int:
    """A shared row: the width padded with zeros to a multiple of 8 (the
    mma's k and n steps), plus 4 floats (aligned 16-byte copies, fragment
    reads in distinct banks)."""
    return -(-width // 8) * 8 + 4


def flash_smem_bytes(d: int, dv: int) -> int:
    """Dynamic shared memory of one CUDA block: the Q tile, one K tile and
    one V tile, in padded rows."""
    return 4 * ((query_tile(dv) + TILE_K) * _row_floats(d) + TILE_K * _row_floats(dv))


def flash_blocks_per_sm(d: int, dv: int, device: int = 0) -> int:
    """Blocks of the CUDA kernel that one SM of ``device`` holds at once at
    (D, Dv), from CUDA's occupancy calculator (builds the kernels at first
    use; launches nothing)."""
    from repro_torch.kernels._build import library  # lazy: builds at first use

    blocks = library().repro_flash_attention_occupancy(dv, flash_smem_bytes(d, dv), device)
    if blocks < 0:
        raise RuntimeError(f"flash_blocks_per_sm: CUDA error {-blocks}")
    return blocks


def _acc_columns(dv: int) -> int:
    """Output accumulator n-tiles of 8 columns per warp: the smallest of 1,
    2, 4, 8, 16, 32 covering Dv."""
    nv = 1
    while 8 * nv < dv:
        nv *= 2
    return nv


def _blocks(sq: int, sk: int, block_q: int, block_k: int):
    """The reference's tiles (at most the sequence) and padded lengths."""
    block_q = max(1, min(block_q, sq))
    block_k = max(1, min(block_k, sk))
    return block_q, block_k, -(-sq // block_q) * block_q, -(-sk // block_k) * block_k


def _check(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"flash_attention_fwd: {name} must be a torch.Tensor")
        if x.dim() != 3:
            raise ValueError(f"flash_attention_fwd: {name} must be 3-D, got {tuple(x.shape)}")
        if not x.is_floating_point():
            raise TypeError(f"flash_attention_fwd: {name} must be floating point, got {x.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention_fwd: q, k and v lie on different devices")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention_fwd runs on cpu, cuda or meta tensors, got {q.device}")
    bh, _, d = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[2] != d or v.shape[1] != k.shape[1]:
        raise ValueError(
            "flash_attention_fwd: want q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[1] < 1:
        raise ValueError("flash_attention_fwd: no keys (Sk = 0)")


def _mask(qpos, kpos, sk: int, causal: bool, window: Optional[int]):
    keep = kpos < sk
    if causal:
        keep = keep & (kpos <= qpos)
    if window is not None:
        keep = keep & (kpos > qpos - window)
    return keep


def attention_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                    q_offset: int = 0) -> int:
    """(query, key) pairs the masks keep: the work flash attention must do
    (query row r at position q_offset + r)."""
    import numpy as np

    qpos = np.arange(q_offset, q_offset + sq, dtype=np.int64)
    lo = np.zeros_like(qpos) if window is None else np.maximum(0, qpos - window + 1)
    hi = np.minimum(qpos, sk - 1) if causal else np.full_like(qpos, sk - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def fwd_cost(bh: int, sq: int, sk: int, d: int, dv: int, *, causal: bool = True,
             window: Optional[int] = None, q_offset: int = 0,
             lse: bool = False) -> Cost:
    """The flops and bytes of :func:`flash_attention_fwd`: 2 (D + Dv) a kept pair
    (the scores and the output product); q, k, v read once and the float32
    output (and the logsumexp, where asked) written once."""
    pairs = attention_pairs(sq, sk, causal, window, q_offset)
    nbytes = 4 * (bh * sq * d + bh * sk * d + bh * sk * dv + bh * sq * dv + (bh * sq if lse else 0))
    return Cost(bh * pairs * 2.0 * (d + dv), float(nbytes))


def bwd_cost(bh: int, sq: int, sk: int, d: int, dv: int, *, causal: bool = True,
             window: Optional[int] = None, q_offset: int = 0) -> Cost:
    """The flops and bytes of :func:`flash_attention_bwd`: a kept pair's scores
    again (2 D), dP and dV (2 Dv each), dQ and dK (2 D each); q, k, v, the
    output and its cotangent and the logsumexp read once, each gradient
    written once."""
    pairs = attention_pairs(sq, sk, causal, window, q_offset)
    nbytes = 4 * (2 * bh * sq * d + 2 * bh * sk * d + 2 * bh * sk * dv + 2 * bh * sq * dv
                  + bh * sq)
    return Cost(bh * pairs * (6.0 * d + 4.0 * dv), float(nbytes))


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 256,
    block_k: int = 512,
    scale: Optional[float] = None,
    return_lse: bool = False,
    q_offset: int = 0,
):
    """The reference kernel's online softmax over its padded key blocks, all
    query rows at once (a query block only pads, and padded rows are cut).
    Scores are ``q k^T * scale``, by default 1/sqrt(D) as in the reference.
    Runs in float32 (float64 for float64 input, for ``gradcheck``); with
    ``return_lse`` also returns each row's logsumexp m + log l, (BH, Sq)."""
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    _, block_k, sq_pad, sk_pad = _blocks(sq, sk, block_q, block_k)
    dt = _work_dtype(q)
    q = torch.nn.functional.pad(q.to(dt), (0, 0, 0, sq_pad - sq))
    k = torch.nn.functional.pad(k.to(dt), (0, 0, 0, sk_pad - sk))
    v = torch.nn.functional.pad(v.to(dt), (0, 0, 0, sk_pad - sk))
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qpos = q_offset + torch.arange(sq_pad, device=q.device).reshape(sq_pad, 1)
    acc = torch.zeros(bh, sq_pad, dv, dtype=dt, device=q.device)
    m = torch.full((bh, sq_pad, 1), NEG_INF, dtype=dt, device=q.device)
    l = torch.zeros(bh, sq_pad, 1, dtype=dt, device=q.device)
    for k0 in range(0, sk_pad, block_k):
        kb = k[:, k0:k0 + block_k]
        vb = v[:, k0:k0 + block_k]
        s = torch.matmul(q, kb.transpose(-1, -2)) * scale
        kpos = k0 + torch.arange(block_k, device=q.device).reshape(1, block_k)
        s = torch.where(_mask(qpos, kpos, sk, causal, window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vb)
        m = m_new
    denom = torch.clamp(l, min=1e-20)
    out = (acc / denom)[:, :sq]
    if return_lse:
        return out, (m + torch.log(denom))[:, :sq, 0]
    return out


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 for float64 input, else float32: the plain versions' type."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def mha_reference(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0):
    """Naive oracle: softmax(q k^T / sqrt(D), masked) v on the whole score
    matrix, (BH, Sq, D) x (BH, Sk, D) x (BH, Sk, Dv)."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(d)
    qpos = q_offset + torch.arange(sq, device=q.device).reshape(sq, 1)
    kpos = torch.arange(sk, device=q.device).reshape(1, sk)
    s = torch.where(_mask(qpos, kpos, sk, causal, window)[None], s, NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 256,
    block_k: int = 512,
    scale: Optional[float] = None,
    return_lse: bool = False,
    q_offset: int = 0,
):
    """q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv) -> (BH, Sq, Dv) float32,
    and with ``return_lse`` each row's logsumexp (BH, Sq) float32 too.

    Scores are ``q k^T * scale``, by default 1/sqrt(D) as in the reference
    (a caller that scaled q already passes 1); query row r sits at position
    ``q_offset + r``. A meta tensor takes the card route, launches nothing
    and charges :func:`fwd_cost`. On a CUDA tensor D and Dv may be at most 256
    (``NotImplementedError`` above that) and BH at most 65535; under grad,
    an input that requires grad raises :class:`NoBackward` (call
    :func:`flash_attention`).
    """
    _check(q, k, v)
    _check_offset(q_offset, q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, block_q=block_q,
                                     block_k=block_k, scale=scale, return_lse=return_lse,
                                     q_offset=q_offset)
    refuse_grad("flash_attention_fwd", q, k, v)
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention_fwd on the card takes D, Dv <= {MAX_HEAD_DIM}, got {d}, {dv}"
        )
    if bh > 65535:
        raise NotImplementedError(f"flash_attention_fwd on the card takes BH <= 65535, got {bh}")
    q, k, v = (x.to(torch.float32).contiguous() for x in (q, k, v))
    out = torch.empty(bh, sq, dv, dtype=torch.float32, device=q.device)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device) if return_lse else None
    if bh and sq:
        charge("flash_attention_fwd", fwd_cost, bh, sq, sk, d, dv, causal=causal, window=window,
               q_offset=q_offset, lse=return_lse)
        sk_pad = _blocks(sq, sk, block_q, block_k)[3]
        launch("repro_flash_attention_fwd", "flash_attention_fwd", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(),
               None if lse is None else lse.data_ptr(), bh, sq, sk, d, dv, int(causal),
               int(window is not None), _c_window(window, sq, sk, q_offset), q_offset,
               1.0 / math.sqrt(d) if scale is None else scale, sk_pad, _acc_columns(dv),
               THREADS, flash_smem_bytes(d, dv))
    return (out, lse) if return_lse else out


def _c_window(window: Optional[int], sq: int, sk: int, q_offset: int = 0) -> int:
    """The window as the kernels take it: any window beyond these limits
    (the last query position and one key past it, or -Sk) masks as the
    limit does, and the clamp keeps it a C int."""
    return 0 if window is None else max(-sk, min(int(window), q_offset + sq + sk + 1))


#: The largest C int: the kernels keep key positions, and the window, in it.
_INT_MAX = 2 ** 31 - 1


def _check_offset(q_offset, sq: int, sk: int) -> None:
    if isinstance(q_offset, bool) or not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash attention: q_offset must be an int >= 0, got {q_offset!r}")
    if q_offset + sq + sk + 1 > _INT_MAX:
        raise NotImplementedError(
            f"flash attention takes q_offset + Sq + Sk < 2^31 - 1, got {q_offset} + {sq} + {sk}")


# ------------------------------ backward ------------------------------

#: Threads per block of the backward's kernels (4 warps).
BWD_THREADS = 128


def bwd_width(d: int, dv: int) -> int:
    """The backward kernels' width instance: the smallest of 32, 64, 128
    and 256 covering D and Dv (their register accumulators' columns)."""
    return next(w for w in (32, 64, 128, 256) if max(d, dv) <= w)


def bwd_tile(d: int, dv: int) -> Tuple[int, int]:
    """Rows of the backward's tiles: (resident, streamed). A block keeps 64
    rows resident (16 a warp: queries in the dQ pass, keys in the dK/dV
    pass) and streams the other side past them 32 rows at a time, or 16 at
    width 256 (where the dK/dV pass is two kernels, dV's and dK's)."""
    return 64, (16 if bwd_width(d, dv) > 128 else 32)


def flash_bwd_smem_bytes(d: int, dv: int) -> Tuple[int, int]:
    """Dynamic shared memory of the dQ pass's and the dK/dV pass's blocks:
    the resident and the streamed tiles of both widths in padded rows, and
    in the dK/dV pass the streamed queries' lse and delta."""
    res, st = bwd_tile(d, dv)
    tiles = 4 * (res + st) * (_row_floats(d) + _row_floats(dv))
    return tiles, tiles + 4 * 2 * st


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 256,
    block_k: int = 512,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward over the reference's key blocks, all query rows at once:
    P recomputed from ``lse``, delta = rowsum(dO o O), dV = P^T dO, dS = P o
    (dO V^T - delta), dQ = scale dS K, dK = scale dS^T Q. A row that sees no
    key took the mean of the ``sk_pad`` padded values in the forward: P is
    1/sk_pad on every real key and dS is 0. Float32 (float64 for float64
    input)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    _, block_k, _, sk_pad = _blocks(sq, sk, block_q, block_k)
    dt = _work_dtype(q)
    q, k, v, o, do, lse = (x.to(dt) for x in (q, k, v, o, do, lse))
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    delta = (do * o).sum(dim=-1, keepdim=True)
    qpos = q_offset + torch.arange(sq, device=q.device).reshape(sq, 1)
    blind = ~_mask(qpos, torch.arange(sk, device=q.device).reshape(1, sk), sk, causal,
                   window).any(dim=-1, keepdim=True)
    dq = torch.zeros_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0 in range(0, sk, block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        kpos = k0 + torch.arange(kb.shape[1], device=q.device).reshape(1, -1)
        keep = _mask(qpos, kpos, sk, causal, window)
        s = torch.matmul(q, kb.transpose(-1, -2)) * scale
        p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
        p = torch.where(blind, 1.0 / sk_pad, p)
        dp = torch.matmul(do, vb.transpose(-1, -2))
        ds = torch.where(keep, p * (dp - delta), 0.0)
        dv[:, k0:k0 + block_k] = torch.matmul(p.transpose(-1, -2), do)
        dk[:, k0:k0 + block_k] = torch.matmul(ds.transpose(-1, -2), q) * scale
        dq += torch.matmul(ds, kb) * scale
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 256,
    block_k: int = 512,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_fwd` at (q, k, v), given its
    output ``o`` (BH, Sq, Dv), the cotangent ``do`` of that output and the
    logsumexp ``lse`` (BH, Sq) it returned; the same options as the
    forward. Float32 gradients of q's, k's and v's shapes. A CPU tensor runs
    the plain version; a CUDA tensor launches ``csrc/flash_attention_bwd.cu``
    (one launch: the dQ pass, then the dK/dV pass) or raises; a meta
    tensor gives the kernel's outputs and charges :func:`bwd_cost`."""
    _check(q, k, v)
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    for name, x, shape in (("o", o, (bh, sq, dv)), ("do", do, (bh, sq, dv)),
                           ("lse", lse, (bh, sq))):
        if tuple(x.shape) != shape or x.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be {shape} on {q.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    _check_offset(q_offset, sq, sk)
    opts = {"causal": causal, "window": window, "block_q": block_q, "block_k": block_k,
            "scale": scale, "q_offset": q_offset}
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, **opts)
    refuse_grad("flash_attention_bwd", q, k, v, o, do, lse)
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_attention_bwd on the card takes D, Dv <= {MAX_HEAD_DIM}, got {d}, {dv}"
        )
    q, k, v, o, do, lse = (x.to(torch.float32).contiguous() for x in (q, k, v, o, do, lse))
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if bh and sq:
        delta = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
        charge("flash_attention_bwd", bwd_cost, bh, sq, sk, d, dv, causal=causal, window=window,
               q_offset=q_offset)
        sk_pad = _blocks(sq, sk, block_q, block_k)[3]
        launch("repro_flash_attention_bwd", "flash_attention_bwd", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), bh, sq, sk, d,
               dv, int(causal), int(window is not None), _c_window(window, sq, sk, q_offset),
               q_offset, 1.0 / math.sqrt(d) if scale is None else scale, sk_pad,
               bwd_width(d, dv),
               BWD_THREADS, *flash_bwd_smem_bytes(d, dv))
    else:
        dk.zero_()
        dvv.zero_()
    return dq, dk, dvv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention_fwd` with :func:`flash_attention_bwd` as its
    backward, at the (BH, S, D) layout. Saves q, k, v, the output and the
    logsumexp; the gradients come back in q's, k's and v's dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k, scale, q_offset=0):
        ctx.opts = {"causal": causal, "window": window, "block_q": block_q,
                    "block_k": block_k, "scale": scale, "q_offset": q_offset}
        out, lse = flash_attention_fwd(q, k, v, return_lse=True, **ctx.opts)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, **ctx.opts)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None,
                None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 256,
    block_k: int = 512,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Differentiable :func:`flash_attention_fwd`: under grad, with an input
    that requires it, :class:`FlashAttention` (the backward on
    :func:`flash_attention_bwd`); else the forward alone, which writes no
    logsumexp."""
    opts = (causal, window, block_q, block_k, scale, q_offset)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, *opts)
    return flash_attention_fwd(q, k, v, causal=causal, window=window, block_q=block_q,
                               block_k=block_k, scale=scale, q_offset=q_offset)
