"""Forward flash attention on the card, its plain version and its oracle.

Port of ``repro.kernels.flash_attention``. Scores are kept on chip: per
(batch-head, query tile) the online-softmax state (acc, m, l) is carried
over the key tiles, so device memory sees q, k and v once and the output
once, never the (Sq, Sk) score matrix.

Layout as in the reference: q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv),
float32; grouped-query callers repeat k and v to the query heads first.
Masks: causal (key <= query) and a sliding window (key > query - window),
applied as ``NEG_INF = -1e30``, never ``-inf``; l is floored at 1e-20.

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
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._launch import launch

__all__ = [
    "MAX_HEAD_DIM",
    "NEG_INF",
    "flash_attention_fwd",
    "flash_attention_plain",
    "flash_blocks_per_sm",
    "flash_smem_bytes",
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_fwd runs on cpu or cuda tensors, got {q.device}")
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
) -> torch.Tensor:
    """The reference kernel's online softmax over its padded key blocks, all
    query rows at once (a query block only pads, and padded rows are cut).
    Scores are ``q k^T * scale``, by default 1/sqrt(D) as in the reference."""
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    _, block_k, sq_pad, sk_pad = _blocks(sq, sk, block_q, block_k)
    q = torch.nn.functional.pad(q.float(), (0, 0, 0, sq_pad - sq))
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, sk_pad - sk))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, sk_pad - sk))
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qpos = torch.arange(sq_pad, device=q.device).reshape(sq_pad, 1)
    acc = torch.zeros(bh, sq_pad, dv, dtype=torch.float32, device=q.device)
    m = torch.full((bh, sq_pad, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(bh, sq_pad, 1, dtype=torch.float32, device=q.device)
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
    return (acc / torch.clamp(l, min=1e-20))[:, :sq]


def mha_reference(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Naive oracle: softmax(q k^T / sqrt(D), masked) v on the whole score
    matrix, (BH, Sq, D) x (BH, Sk, D) x (BH, Sk, Dv)."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device).reshape(sq, 1)
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
) -> torch.Tensor:
    """q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv) -> (BH, Sq, Dv) float32.

    Scores are ``q k^T * scale``, by default 1/sqrt(D) as in the reference
    (a caller that scaled q already passes 1). On a CUDA tensor D and Dv may
    be at most 256 (``NotImplementedError`` above that) and BH at most
    65535.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k, scale=scale)
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
    if bh and sq:
        sk_pad = _blocks(sq, sk, block_q, block_k)[3]
        # Any window beyond these limits masks as the limit does; the clamp
        # keeps it a C int.
        w = 0 if window is None else max(-sk, min(int(window), sq + sk + 1))
        launch("repro_flash_attention_fwd", "flash_attention_fwd", q, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk, d, dv, int(causal),
               int(window is not None), w, 1.0 / math.sqrt(d) if scale is None else scale,
               sk_pad, _acc_columns(dv),
               THREADS, flash_smem_bytes(d, dv))
    return out
