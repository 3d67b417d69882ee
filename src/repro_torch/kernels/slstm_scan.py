"""The sLSTM scan on the card, its plain version and the weights' carry-across.

Port of ``repro.kernels.slstm_scan``, with the port's own copy of the
reference's per-step oracle (``repro.models.xlstm._slstm_step`` and
``slstm_state``). The recurrence keeps its (c, n, h, m) state on chip for
the whole sequence, so device memory sees the gate pre-activations xg once
and the hidden outputs hs once.

ABI as in the reference: xg (B, L, 4D) float32 gate pre-activations
(``x @ wx``, a dense product the caller computes outside the kernel),
wr (4, D/4, D) block-diagonal recurrent weights over 4 heads, bias (4D,),
initial state (B, D) x 4. Returns hs (B, L, D) and the final state.

* :func:`slstm_scan` — a CPU tensor runs the plain version; a CUDA tensor
  launches ``csrc/slstm_scan.cu`` or raises: one cooperative grid of at
  most one CTA an SM, each owning a block of units with their slice of wr
  (:func:`slstm_grid` is its geometry).
* :func:`slstm_scan_plain` — a loop of :func:`slstm_step` over L.
* :func:`slstm_weights_from_jax` — the reference's ``slstm_skel``
  parameters (numpy arrays) as the port's tensors: the weight
  carry-across of the sLSTM layer.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels._launch import launch, refuse_grad

__all__ = [
    "SLSTM_HEADS",
    "SlstmGrid",
    "hbm_traffic_estimate",
    "slstm_barriers",
    "slstm_blocks_per_sm",
    "slstm_card_grid",
    "slstm_grid",
    "slstm_scan",
    "slstm_scan_plain",
    "slstm_state",
    "slstm_step",
    "slstm_weights_from_jax",
]

SLSTM_HEADS = 4

#: Largest D the CUDA kernel takes.
MAX_D = 4096
#: Threads of a CTA, and the shared memory a block may use (227 KB).
THREADS = 256
SMEM_LIMIT = 232448
#: Where a CTA keeps its slice of wr, in the order of ``csrc/slstm_scan.cu``'s
#: ``Route``: read from device memory every step, or held in shared memory
#: in float32 or, converted once, in double.
ROUTES = ("global", "smem_f32", "smem_f64")


class SlstmGrid(NamedTuple):
    """The CUDA kernel's geometry: ``ctas`` CTAs of ``threads`` threads,
    each owning ``units`` consecutive units (the last CTA the rest) with all
    four gates; the batch runs in ``groups`` groups of at most ``rows``
    rows, each over all L steps; ``route`` is one of :data:`ROUTES`;
    ``smem_bytes`` is the CTA's shared memory."""

    ctas: int
    units: int
    threads: int
    rows: int
    groups: int
    route: str
    smem_bytes: int


def _smem_floats(hd: int, units: int, rows: int, route: int) -> int:
    """Shared memory of a CTA in floats, as ``csrc/slstm_scan.cu``'s
    ``smem_floats`` lays it out: the wr slice (``route`` floats an element,
    an index of :data:`ROUTES`), h of ``rows`` rows, the gate products' two
    halves over K (doubles), gate inputs, bias, and c, n, m; rows of wr and
    h are ``hd`` rounded up to 4 elements, plus 4."""
    ws = -(-hd // 4) * 4 + 4
    return 4 * route * units * ws + 4 * rows * ws + 23 * rows * units + 4 * units


def slstm_grid(d: int, batch: int, sms: int, *, smem_limit: int = SMEM_LIMIT) -> SlstmGrid:
    """The kernel's geometry on a card of ``sms`` SMs.

    At most one CTA an SM: each CTA reads all of h every step, so a second
    CTA on an SM would read it again and add no work it could not do.
    ``units`` = ceil(D / sms), ``ctas`` = ceil(D / units). The slice of wr
    stays in shared memory in double where it fits beside one batch row's
    buffers, else in float32, else the global route; ``rows`` is then the
    most batch rows that fit, spread evenly over the groups. ``threads`` is
    always :data:`THREADS`: 8 warps share the loads of h and run the
    products as 8 x 8 tiles over half of K each.
    """
    if d < SLSTM_HEADS or d % SLSTM_HEADS or batch < 1 or sms < 1:
        raise ValueError(f"slstm_grid: d={d}, batch={batch}, sms={sms}")
    hd = d // SLSTM_HEADS
    units = -(-d // sms)
    ctas = -(-d // units)
    route = max(r for r in range(len(ROUTES))
                if r == 0 or 4 * _smem_floats(hd, units, 1, r) <= smem_limit)
    fixed = _smem_floats(hd, units, 0, route)
    per_row = _smem_floats(hd, units, 1, route) - fixed
    most = (smem_limit // 4 - fixed) // per_row
    if most < 1:
        raise NotImplementedError(f"slstm_scan: one batch row of D={d} does not fit a CTA")
    groups = -(-batch // most)
    rows = -(-batch // groups)
    return SlstmGrid(ctas, units, THREADS, rows, groups, ROUTES[route],
                     4 * _smem_floats(hd, units, rows, route))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(threads: int, smem_bytes: int, route: str, device: int) -> int:
    from repro_torch.kernels._build import library  # lazy: builds at first use

    blocks = library().repro_slstm_occupancy(threads, smem_bytes, ROUTES.index(route), device)
    if blocks < 0:
        raise RuntimeError(f"slstm_scan: CUDA error {-blocks} in the occupancy calculator")
    return blocks


def slstm_card_grid(d: int, batch: int, device: torch.device) -> SlstmGrid:
    """:func:`slstm_grid` on the SM count of ``device`` (a CUDA device),
    checked against the occupancy calculator: the card must hold one CTA an
    SM."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    grid = slstm_grid(d, batch, torch.cuda.get_device_properties(index).multi_processor_count)
    if slstm_blocks_per_sm(grid, index) < 1:
        raise RuntimeError(f"slstm_scan: an SM cannot hold one CTA of {grid}")
    return grid


def slstm_blocks_per_sm(grid: SlstmGrid, device: int = 0) -> int:
    """CTAs of ``grid`` that one SM of ``device`` holds at once, from CUDA's
    occupancy calculator (builds the kernels at first use)."""
    return _blocks_per_sm(grid.threads, grid.smem_bytes, grid.route, device)


def slstm_barriers(batch: int, d: int, steps: int, *, device="cuda") -> None:
    """Launch ``steps`` grid barriers and nothing else on the kernel's grid
    for (batch, D): the floor of its time a step, for timing. Counts no
    launch of ``slstm_scan``."""
    from repro_torch.kernels._build import library  # lazy: builds at first use

    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    grid = slstm_card_grid(d, batch, device)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = library().repro_slstm_barriers(count.data_ptr(), grid.ctas, grid.threads, steps,
                                        device.index, stream)
    if rc != 0:
        raise RuntimeError(f"slstm_barriers: CUDA error {rc} at launch")


State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def slstm_state(batch: int, d: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """The zero state with the stabiliser m at -inf, as the reference's."""
    z = torch.zeros(batch, d, dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, d), float("-inf"), dtype=torch.float32, device=device)}


def slstm_step(p: Mapping[str, torch.Tensor], s: Mapping[str, torch.Tensor],
               x_t: torch.Tensor, d: int) -> Dict[str, torch.Tensor]:
    """One sLSTM time step (exponential gating, m-stabilised); ``p`` holds
    ``wr`` and ``bias``. Head k's product is gate block k (head-major)."""
    hd = d // SLSTM_HEADS
    hprev = s["h"].reshape(-1, SLSTM_HEADS, hd)
    rec = torch.einsum("bhk,hkj->bhj", hprev, p["wr"]).reshape(-1, 4 * d)
    gates = x_t + rec + p["bias"]
    it, ft, zt, ot = torch.split(gates, d, dim=-1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + s["m"], it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(log_f + s["m"] - m_new)
    c = f_sc * s["c"] + i_sc * torch.tanh(zt)
    n = f_sc * s["n"] + i_sc
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_scan_plain(xg, wr, bias, c0, n0, h0, m0) -> Tuple[torch.Tensor, State]:
    """Plain version of :func:`slstm_scan`: :func:`slstm_step` over L."""
    d = xg.shape[-1] // 4
    p = {"wr": wr.float(), "bias": bias.float()}
    s = {"c": c0.float(), "n": n0.float(), "h": h0.float(), "m": m0.float()}
    hs = []
    for t in range(xg.shape[1]):
        s = slstm_step(p, s, xg[:, t].float(), d)
        hs.append(s["h"])
    return torch.stack(hs, dim=1), (s["c"], s["n"], s["h"], s["m"])


def _check(xg, wr, bias, states) -> None:
    tensors = {"xg": xg, "wr": wr, "bias": bias, "c0": states[0], "n0": states[1],
               "h0": states[2], "m0": states[3]}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"slstm_scan: {name} must be a torch.Tensor")
        if not x.is_floating_point():
            raise TypeError(f"slstm_scan: {name} must be floating point, got {x.dtype}")
        if x.device != xg.device:
            raise ValueError("slstm_scan: the inputs lie on different devices")
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"slstm_scan runs on cpu or cuda tensors, got {xg.device}")
    if xg.dim() != 3 or xg.shape[2] % (4 * SLSTM_HEADS):
        raise ValueError(f"slstm_scan: xg must be (B, L, 4D) with 4 | D, got {tuple(xg.shape)}")
    b, _, d4 = xg.shape
    d = d4 // 4
    hd = d // SLSTM_HEADS
    if tuple(wr.shape) != (SLSTM_HEADS, hd, d):
        raise ValueError(f"slstm_scan: wr must be {(SLSTM_HEADS, hd, d)}, got {tuple(wr.shape)}")
    if tuple(bias.shape) != (d4,):
        raise ValueError(f"slstm_scan: bias must be ({d4},), got {tuple(bias.shape)}")
    for x in states:
        if tuple(x.shape) != (b, d):
            raise ValueError(f"slstm_scan: each state must be {(b, d)}, got {tuple(x.shape)}")


def slstm_scan(xg, wr, bias, c0, n0, h0, m0, *, chunk: int = 256) -> Tuple[torch.Tensor, State]:
    """xg (B, L, 4D) -> (hs (B, L, D), (c, n, h, m) final), float32.

    ``chunk`` is the reference's time tile and must divide L; the card
    kernel holds the state for the whole sequence, so it changes nothing
    there. On a CUDA tensor D may be at most 4096.
    """
    _check(xg, wr, bias, (c0, n0, h0, m0))
    b, l, d4 = xg.shape
    d = d4 // 4
    chunk = min(chunk, l)
    if chunk < 1 or l % chunk:
        raise ValueError(f"L={l} not divisible by chunk={chunk}")
    if xg.device.type == "cpu":
        return slstm_scan_plain(xg, wr, bias, c0, n0, h0, m0)
    refuse_grad("slstm_scan", xg, wr, bias, c0, n0, h0, m0)
    if d > MAX_D:
        raise NotImplementedError(f"slstm_scan on the card takes D <= {MAX_D}, got {d}")
    xg, wr, bias, c0, n0, h0, m0 = (x.to(torch.float32).contiguous()
                                    for x in (xg, wr, bias, c0, n0, h0, m0))
    hs = torch.empty(b, l, d, dtype=torch.float32, device=xg.device)
    final = tuple(torch.empty(b, d, dtype=torch.float32, device=xg.device) for _ in range(4))
    if b:
        grid = slstm_card_grid(d, b, xg.device)
        count = torch.zeros(1, dtype=torch.int64, device=xg.device)
        launch("repro_slstm_scan", "slstm_scan", xg, xg.data_ptr(), wr.data_ptr(),
               bias.data_ptr(), c0.data_ptr(), n0.data_ptr(), h0.data_ptr(), m0.data_ptr(),
               hs.data_ptr(), *(x.data_ptr() for x in final), count.data_ptr(), b, l, d,
               grid.ctas, grid.units, grid.threads, grid.rows, ROUTES.index(grid.route),
               grid.smem_bytes)
    return hs, final


def slstm_weights_from_jax(p: Mapping[str, object], *, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's ``slstm_skel`` parameters (numpy arrays, or anything
    ``np.asarray`` reads) as float32 tensors on ``device``: ``wx`` (D, 4D)
    for the caller's ``xg = x @ wx``, ``wr`` (4, D/4, D) and ``bias`` (4D,)."""
    return {name: torch.from_numpy(np.asarray(p[name], dtype=np.float32).copy()).to(device)
            for name in ("wx", "wr", "bias")}


def hbm_traffic_estimate(b: int, l: int, d: int, kernel: bool) -> int:
    """Kernel: read xg + write hs once. XLA loop: + per-step carry r/w."""
    base = b * l * 4 * d * 4 + b * l * d * 4
    if kernel:
        return base
    per_step_carry = 4 * b * d * 4 * 2  # (c,n,h,m) written+read per step
    return base + l * per_step_carry
