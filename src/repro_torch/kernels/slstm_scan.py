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
  (:func:`slstm_grid` is its geometry). Under grad, with an input that
  requires it, a CUDA tensor goes through :class:`SlstmScan`.
* :func:`slstm_scan_plain` — a loop of :func:`slstm_step` over L.
* :class:`SlstmScan` — the autograd Function: its forward
  (:func:`slstm_scan_saving`) also writes each step's gate pre-activations
  and c, n, m; its backward runs the reverse recurrence in
  :func:`slstm_scan_bwd` (``csrc/slstm_scan_bwd.cu`` on the card, on the
  forward's grid; :func:`slstm_bwd_grid`) and forms dwr and dbias from
  its dxg. :func:`slstm_scan_bwd_plain` is the reverse recurrence step by
  step in torch.
* :func:`scan_cost`, :func:`scan_bwd_cost` — each kernel's work (a
  ``Cost`` of flops and bytes): the card's bound, and what a meta tensor's call charges a cost
  counter (a meta tensor takes the card route up to the launch and
  launches nothing; ``kernels._launch``).
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

from repro_torch.kernels._launch import Cost, charge, launch, refuse_grad

__all__ = [
    "SLSTM_HEADS",
    "SlstmGrid",
    "SlstmScan",
    "hbm_traffic_estimate",
    "scan_bwd_cost",
    "scan_cost",
    "slstm_barriers",
    "slstm_blocks_per_sm",
    "slstm_bwd_blocks_per_sm",
    "slstm_bwd_card_grid",
    "slstm_bwd_grid",
    "slstm_card_grid",
    "slstm_grid",
    "slstm_scan",
    "slstm_scan_bwd",
    "slstm_scan_bwd_plain",
    "slstm_scan_plain",
    "slstm_scan_saving",
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
    units, ctas = _shard(d, batch, sms)
    hd = d // SLSTM_HEADS
    return _fit(ctas, units, batch, smem_limit, lambda rows, route: _smem_floats(hd, units, rows, route))


def _shard(d: int, batch: int, sms: int) -> Tuple[int, int]:
    """(units, ctas): ceil(D / sms) units a CTA, the CTAs that cover D."""
    if d < SLSTM_HEADS or d % SLSTM_HEADS or batch < 1 or sms < 1:
        raise ValueError(f"slstm_grid: d={d}, batch={batch}, sms={sms}")
    units = -(-d // sms)
    return units, -(-d // units)


def _fit(ctas: int, units: int, batch: int, smem_limit: int, floats) -> SlstmGrid:
    """The grid whose route is the widest of :data:`ROUTES` that holds one
    batch row, with as many rows as fit, spread evenly over the groups;
    ``floats(rows, route)`` is a CTA's shared memory in floats."""
    route = max(r for r in range(len(ROUTES)) if r == 0 or 4 * floats(1, r) <= smem_limit)
    fixed = floats(0, route)
    most = (smem_limit // 4 - fixed) // (floats(1, route) - fixed)
    if most < 1:
        raise NotImplementedError(f"slstm_scan: one batch row of {units} units does not fit a CTA")
    groups = -(-batch // most)
    rows = -(-batch // groups)
    return SlstmGrid(ctas, units, THREADS, rows, groups, ROUTES[route], 4 * floats(rows, route))


#: Parts of K each tile of the backward's transposed product is cut into
#: (``csrc/slstm_scan_bwd.cu``'s ``kSplits``, one a warp).
BWD_SPLITS = THREADS // 32


def _heads_spanned(d: int, units: int) -> int:
    """The most heads the units of one CTA belong to: the blocks of gate
    gradients it reads a step."""
    hd = d // SLSTM_HEADS
    return max((min(u0 + units, d) - 1) // hd - u0 // hd + 1 for u0 in range(0, d, units))


def _bwd_smem_floats(d: int, units: int, rows: int, route: int, span: int) -> int:
    """Shared memory of a backward CTA in floats, as
    ``csrc/slstm_scan_bwd.cu``'s ``bwd_smem_floats`` lays it out: its rows
    of wr (``route`` floats an element), the gate gradients of ``span``
    heads and ``rows`` rows (rows of D + 4 floats), the products' parts
    (doubles) and the carries dc, dn, dm."""
    ws = d + 4
    return (route * units * ws + span * rows * ws + 2 * BWD_SPLITS * rows * units
            + 3 * rows * units)


def slstm_bwd_grid(d: int, batch: int, sms: int, *, smem_limit: int = SMEM_LIMIT) -> SlstmGrid:
    """The backward kernel's geometry on a card of ``sms`` SMs: the
    forward's CTAs and units (:func:`slstm_grid`), since a CTA's transposed
    product yields the units it owns in the elementwise step; its units'
    rows of wr (D each) in shared memory in double where they fit beside
    one batch row's buffers, else in float32, else the global route, and
    as many batch rows as fit."""
    units, ctas = _shard(d, batch, sms)
    span = _heads_spanned(d, units)
    return _fit(ctas, units, batch, smem_limit,
                lambda rows, route: _bwd_smem_floats(d, units, rows, route, span))


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(entry: str, threads: int, smem_bytes: int, route: str, device: int) -> int:
    from repro_torch.kernels._build import library  # lazy: builds at first use

    blocks = getattr(library(), entry)(threads, smem_bytes, ROUTES.index(route), device)
    if blocks < 0:
        raise RuntimeError(f"{entry}: CUDA error {-blocks} in the occupancy calculator")
    return blocks


def _card_grid(geometry, blocks_per_sm, d: int, batch: int, device) -> SlstmGrid:
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    grid = geometry(d, batch, torch.cuda.get_device_properties(index).multi_processor_count)
    if blocks_per_sm(grid, index) < 1:
        raise RuntimeError(f"slstm_scan: an SM cannot hold one CTA of {grid}")
    return grid


def slstm_card_grid(d: int, batch: int, device: torch.device) -> SlstmGrid:
    """:func:`slstm_grid` on the SM count of ``device`` (a CUDA device),
    checked against the occupancy calculator: the card must hold one CTA an
    SM."""
    return _card_grid(slstm_grid, slstm_blocks_per_sm, d, batch, device)


def slstm_bwd_card_grid(d: int, batch: int, device: torch.device) -> SlstmGrid:
    """:func:`slstm_bwd_grid` on the SM count of ``device``, checked as
    :func:`slstm_card_grid` checks the forward's."""
    return _card_grid(slstm_bwd_grid, slstm_bwd_blocks_per_sm, d, batch, device)


def slstm_blocks_per_sm(grid: SlstmGrid, device: int = 0) -> int:
    """CTAs of ``grid`` that one SM of ``device`` holds at once, from CUDA's
    occupancy calculator (builds the kernels at first use)."""
    return _blocks_per_sm("repro_slstm_occupancy", grid.threads, grid.smem_bytes, grid.route,
                          device)


def slstm_bwd_blocks_per_sm(grid: SlstmGrid, device: int = 0) -> int:
    """:func:`slstm_blocks_per_sm` of the backward kernel."""
    return _blocks_per_sm("repro_slstm_bwd_occupancy", grid.threads, grid.smem_bytes,
                          grid.route, device)


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
    return _cell(_gates(p, s["h"], x_t, d), s, d)


def _gates(p: Mapping[str, torch.Tensor], h: torch.Tensor, x_t: torch.Tensor,
           d: int) -> torch.Tensor:
    """A step's gate pre-activations (B, 4D): x_t + the recurrent product
    of h + the bias."""
    hd = d // SLSTM_HEADS
    rec = torch.einsum("bhk,hkj->bhj", h.reshape(-1, SLSTM_HEADS, hd), p["wr"]).reshape(-1, 4 * d)
    return x_t + rec + p["bias"]


def _cell(gates: torch.Tensor, s: Mapping[str, torch.Tensor], d: int) -> Dict[str, torch.Tensor]:
    """The state after a step from its gate pre-activations."""
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
    return _scan_plain(xg, wr, bias, (c0, n0, h0, m0), torch.float32)


def _scan_saving_plain(xg, wr, bias, c0, n0, h0, m0):
    """Plain version of :func:`slstm_scan_saving`, in float32 or, for
    float64 inputs, in float64: the loop of :func:`slstm_scan_plain`,
    keeping each step's gates and state."""
    keep = []
    hs, final = _scan_plain(xg, wr, bias, (c0, n0, h0, m0),
                            torch.promote_types(xg.dtype, torch.float32), keep)
    return hs, final, tuple(torch.stack(x, dim=1) for x in zip(*keep))


def _scan_plain(xg, wr, bias, states, dt, keep=None) -> Tuple[torch.Tensor, State]:
    """:func:`slstm_step` over L in ``dt``: (hs, final state). Each step's
    (gates, c, n, m) is appended to ``keep`` where it is a list."""
    d = xg.shape[-1] // 4
    p = {"wr": wr.to(dt), "bias": bias.to(dt)}
    s = dict(zip("cnhm", (x.to(dt) for x in states)))
    hs = []
    for t in range(xg.shape[1]):
        gates = _gates(p, s["h"], xg[:, t].to(dt), d)
        s = _cell(gates, s, d)
        hs.append(s["h"])
        if keep is not None:
            keep.append((gates, s["c"], s["n"], s["m"]))
    return torch.stack(hs, dim=1), (s["c"], s["n"], s["h"], s["m"])


def slstm_scan_bwd_plain(saved, wr, c0, n0, m0, dhs, dfinal) -> Tuple[torch.Tensor, State]:
    """Plain version of :func:`slstm_scan_bwd`: the reverse recurrence step
    by step, as autograd runs :func:`slstm_step`'s backward, in the dtype
    of ``saved``'s tensors. ``saved`` is (gates, cs, ns, ms) as
    :func:`slstm_scan_saving` returns them; ``dfinal`` the cotangents of
    the final (c, n, h, m). Returns dxg (B, L, 4D) and the gradients of
    the initial (c, n, h, m)."""
    gates, cs, ns, ms = saved
    b, l, d4 = gates.shape
    d = d4 // 4
    dt = gates.dtype
    wr = wr.to(dt)
    dc, dn, rec, dm = (x.to(dt) for x in dfinal)
    dxg = torch.empty_like(gates)
    for t in reversed(range(l)):
        ig, fg, zg, og = torch.split(gates[:, t], d, dim=-1)
        c, n = cs[:, t], ns[:, t]
        cp, np_, mp = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t else (
            c0.to(dt), n0.to(dt), m0.to(dt))
        dh = dhs[:, t].to(dt) + rec
        # the forward's values
        a = F.logsigmoid(fg) + mp
        m = torch.maximum(a, ig)
        i_sc = torch.exp(ig - m)
        f_sc = torch.exp(a - m)
        tz = torch.tanh(zg)
        so = torch.sigmoid(og)
        ncl = torch.clamp(n, min=1e-6)
        # h = (so c) / max(n, 1e-6)
        q = dh / ncl
        dso = q * c
        dc = dc + q * so
        dn = dn + torch.where(n >= 1e-6, -dh * ((so * c / ncl) / ncl), 0.0)
        # c = f_sc cp + i_sc tanh(z), n = f_sc np + i_sc
        e_i = (dc * tz + dn) * i_sc
        e_f = (dc * cp + dn * np_) * f_sc
        # m = max(a, i): the whole gradient to the larger, half each on a tie
        dm = dm - e_i - e_f
        half = 0.5 * dm
        zero = torch.zeros_like(dm)
        da = e_f + torch.where(a > ig, dm, torch.where(a == ig, half, zero))
        di = e_i + torch.where(ig > a, dm, torch.where(a == ig, half, zero))
        dg = torch.cat([di, da * torch.sigmoid(-fg), dc * i_sc * (1 - tz * tz),
                        dso * (1 - so) * so], dim=-1)
        dxg[:, t] = dg
        rec = torch.einsum("bhj,hkj->bhk", dg.reshape(b, SLSTM_HEADS, d), wr).reshape(b, d)
        dc, dn, dm = dc * f_sc, dn * f_sc, da
    return dxg, (dc, dn, rec, dm)


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
    if xg.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"slstm_scan runs on cpu, cuda or meta tensors, got {xg.device}")
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
    there. On a CUDA tensor D may be at most 4096; under grad, with an
    input that requires it, the call goes through :class:`SlstmScan`.
    """
    _check(xg, wr, bias, (c0, n0, h0, m0))
    l = xg.shape[1]
    chunk = min(chunk, l)
    if chunk < 1 or l % chunk:
        raise ValueError(f"L={l} not divisible by chunk={chunk}")
    if xg.device.type == "cpu":
        return slstm_scan_plain(xg, wr, bias, c0, n0, h0, m0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (xg, wr, bias, c0, n0, h0, m0)):
        hs, *final = SlstmScan.apply(xg, wr, bias, c0, n0, h0, m0)
        return hs, tuple(final)
    return _scan_card(xg, wr, bias, (c0, n0, h0, m0), save=False)[:2]


def slstm_scan_saving(xg, wr, bias, c0, n0, h0, m0):
    """:func:`slstm_scan` that also returns what :func:`slstm_scan_bwd`
    reads: (hs, final state, (gates, cs, ns, ms)), with each step's gate
    pre-activations, bias included (B, L, 4D), and c, n, m after it (B, L,
    D) each. A CPU tensor runs the plain version (float64 stays float64);
    a CUDA tensor launches the saving instance of ``csrc/slstm_scan.cu``
    (counted as ``slstm_scan``) or raises."""
    _check(xg, wr, bias, (c0, n0, h0, m0))
    if xg.device.type == "cpu":
        return _scan_saving_plain(xg, wr, bias, c0, n0, h0, m0)
    return _scan_card(xg, wr, bias, (c0, n0, h0, m0), save=True)


def _scan_card(xg, wr, bias, states, *, save: bool):
    refuse_grad("slstm_scan", xg, wr, bias, *states)
    b, l, d4 = xg.shape
    d = d4 // 4
    if d > MAX_D:
        raise NotImplementedError(f"slstm_scan on the card takes D <= {MAX_D}, got {d}")
    xg, wr, bias, *states = (x.to(torch.float32).contiguous() for x in (xg, wr, bias, *states))
    new = functools.partial(torch.empty, dtype=torch.float32, device=xg.device)
    hs = new(b, l, d)
    final = tuple(new(b, d) for _ in range(4))
    saved = (new(b, l, d4), new(b, l, d), new(b, l, d), new(b, l, d)) if save else ()
    if b:
        charge("slstm_scan", scan_cost, b, l, d, save=save)
        count = torch.zeros(1, dtype=torch.int64, device=xg.device)
    if b and not xg.is_meta:
        grid = slstm_card_grid(d, b, xg.device)
        launch("repro_slstm_scan", "slstm_scan", xg,
               *(x.data_ptr() for x in (xg, wr, bias, *states, hs, *final)),
               *((x.data_ptr() for x in saved) if save else (None,) * 4), count.data_ptr(),
               b, l, d, grid.ctas, grid.units, grid.threads, grid.rows,
               ROUTES.index(grid.route), grid.smem_bytes)
    return hs, final, saved


def slstm_scan_bwd(saved, wr, c0, n0, m0, dhs, dfinal) -> Tuple[torch.Tensor, State]:
    """The reverse recurrence of :func:`slstm_scan`: dxg (B, L, 4D) and the
    gradients of the initial (c, n, h, m), given ``saved`` = (gates, cs,
    ns, ms) from :func:`slstm_scan_saving`, wr, the initial c, n, m, the
    cotangent ``dhs`` (B, L, D) of hs and ``dfinal``, those of the final
    (c, n, h, m). dwr and dbias follow from dxg (:class:`SlstmScan`). A CPU
    tensor runs :func:`slstm_scan_bwd_plain`; a CUDA tensor launches
    ``csrc/slstm_scan_bwd.cu`` or raises."""
    gates = saved[0]
    if gates.dim() != 3 or gates.shape[2] % (4 * SLSTM_HEADS):
        raise ValueError(f"slstm_scan_bwd: gates must be (B, L, 4D), got {tuple(gates.shape)}")
    b, l, d4 = gates.shape
    d = d4 // 4
    shapes = {"gates": (b, l, d4), "cs": (b, l, d), "ns": (b, l, d), "ms": (b, l, d),
              "wr": (SLSTM_HEADS, d // SLSTM_HEADS, d), "c0": (b, d), "n0": (b, d),
              "m0": (b, d), "dhs": (b, l, d), "dcf": (b, d), "dnf": (b, d), "dhf": (b, d),
              "dmf": (b, d)}
    tensors = (*saved, wr, c0, n0, m0, dhs, *dfinal)
    for (name, shape), x in zip(shapes.items(), tensors):
        if tuple(x.shape) != shape or x.device != gates.device:
            raise ValueError(f"slstm_scan_bwd: {name} must be {shape} on {gates.device}, "
                             f"got {tuple(x.shape)} on {x.device}")
    if gates.device.type == "cpu":
        return slstm_scan_bwd_plain(saved, wr, c0, n0, m0, dhs, dfinal)
    refuse_grad("slstm_scan_bwd", *tensors)
    if d > MAX_D:
        raise NotImplementedError(f"slstm_scan_bwd on the card takes D <= {MAX_D}, got {d}")
    tensors = tuple(x.to(torch.float32).contiguous() for x in tensors)
    dxg = torch.empty(b, l, d4, dtype=torch.float32, device=gates.device)
    grads = tuple(torch.empty(b, d, dtype=torch.float32, device=gates.device) for _ in range(4))
    if b:
        charge("slstm_scan_bwd", scan_bwd_cost, b, l, d)
        count = torch.zeros(1, dtype=torch.int64, device=gates.device)
    if b and not gates.is_meta:
        grid = slstm_bwd_card_grid(d, b, gates.device)
        launch("repro_slstm_scan_bwd", "slstm_scan_bwd", gates,
               *(x.data_ptr() for x in (*tensors, dxg, *grads, count)), b, l, d, grid.ctas,
               grid.units, grid.threads, grid.rows, ROUTES.index(grid.route), grid.smem_bytes)
    return dxg, grads


def scan_cost(b: int, l: int, d: int, *, save: bool = False) -> Cost:
    """The flops and bytes of :func:`slstm_scan` on (B, L, 4D): the recurrent
    product, 2 D^2 a step and batch row; xg, wr, bias and the four initial
    states read once, hs and the four final states written once (and, for
    the saving instance, the gates and c, n, m of every step)."""
    nbytes = 4 * (b * l * 4 * d + d * d + 4 * d + 4 * b * d + b * l * d + 4 * b * d
                  + (b * l * 4 * d + 3 * b * l * d if save else 0))
    return Cost(2.0 * b * l * d * d, float(nbytes))


def scan_bwd_cost(b: int, l: int, d: int) -> Cost:
    """The flops and bytes of :func:`slstm_scan_bwd`: the transposed product, 2
    D^2 a step and batch row; the saved gates and c, n, m, dhs, wr, the
    three initial states and four final-state cotangents read once, dxg and
    the four initial-state gradients written once."""
    saved = b * l * 4 * d + 3 * b * l * d
    nbytes = 4 * (saved + b * l * d + d * d + 7 * b * d + b * l * 4 * d + 4 * b * d)
    return Cost(2.0 * b * l * d * d, float(nbytes))


def _dwr(hs, h0, dxg):
    """dwr[k] = sum over (b, t) of h_{t-1}[head k]^T dg_t[block k], with
    h_{-1} = h0: one batched product over the heads."""
    b, l, d = hs.shape
    hd = d // SLSTM_HEADS
    hprev = torch.cat([h0[:, None].to(hs.dtype), hs[:, :-1]], dim=1)
    hprev = hprev.reshape(b * l, SLSTM_HEADS, hd).permute(1, 2, 0)
    return torch.bmm(hprev, dxg.reshape(b * l, SLSTM_HEADS, d).transpose(0, 1))


class SlstmScan(torch.autograd.Function):
    """:func:`slstm_scan` with its backward: the forward is
    :func:`slstm_scan_saving`, the backward :func:`slstm_scan_bwd` (the
    serial reverse recurrence), then dwr by :func:`_dwr` and dbias as the
    sum of dxg over (B, L), which lie off the serial chain. Saves the
    gates and states the forward wrote and hs; accepts cotangents on hs
    and on the four final states; the gradients come back in the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, xg, wr, bias, c0, n0, h0, m0):
        hs, final, saved = slstm_scan_saving(xg, wr, bias, c0, n0, h0, m0)
        ctx.save_for_backward(wr, c0, n0, h0, m0, hs, *saved)
        ctx.dtypes = tuple(x.dtype for x in (xg, wr, bias, c0, n0, h0, m0))
        return (hs, *final)

    @staticmethod
    def backward(ctx, dhs, dcf, dnf, dhf, dmf):
        wr, c0, n0, h0, m0, hs, *saved = ctx.saved_tensors
        dxg, (dc0, dn0, dh0, dm0) = slstm_scan_bwd(saved, wr, c0, n0, m0, dhs,
                                                   (dcf, dnf, dhf, dmf))
        need = ctx.needs_input_grad
        grads = (dxg, _dwr(hs, h0, dxg) if need[1] else None,
                 dxg.sum(dim=(0, 1)) if need[2] else None, dc0, dn0, dh0, dm0)
        return tuple(None if g is None or not n else g.to(dt)
                     for g, n, dt in zip(grads, need, ctx.dtypes))


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
