"""FFTW-style planning modes: analytic ESTIMATE and timed MEASURE.

Port of ``repro.plan.autotune``. Candidates come from the
``repro_torch.engines`` registry, filtered by capability and by the
quarantine breaker (``repro_torch.resilience``). Each candidate's
ESTIMATE time is a roofline over the paper's analytic counts
(``butterfly_counts``: (N/2)·log2 N butterflies per transform) plus the
engine's cost hints; MEASURE times every candidate on the key's device
and keeps the fastest (CUDA events on the card, see :func:`measure_plan`).

On a ``"cuda"`` key the candidates are the CUDA kernels only, unless the
caller scoped ``backend="torch"``: a tensor on the card never plans onto
plain tensor code by itself. Where no kernel serves the key (a row longer
than 2^24 values, the two-pass kernels' envelope), planning raises. A
double-precision key is served by the ``reference_x64`` engine (backend
``"x64"``), on the card too: it is the only engine registered for double,
as in the reference, so planning it is the plan and not a fallback. The
kernels are modelled from what the CUDA code does. HBM: each element is
read once and written once per round trip — one round trip for a row or
a 2D frame that fits a block, and for a row of 2^14 < N <= 2^18 at radix
4 (the cluster kernel of ``csrc/fft_cluster.cu`` holds it in the shared
memory of C CTAs); at radix 2, and at both radices past 2^18, two for a
complex row over one block (the two-pass kernels) and three for a real
one (plus its recombination or untangling), so that the two engines tie
there and ESTIMATE ranks ``fused_r4`` first; a composed 2D frame is its
row pass's round trips plus one
for the column pass (``csrc/fft2_columns.cu`` reads the columns where the
row pass wrote them, in one panel a block, whose passes and exchanges are
those of its column panel: a one-block row of H values), and where the
columns are longer than that kernel serves (H > 4096) the column rows'
trips plus one for the two corner turns through HBM. Shared memory: every
pass reads and writes the block's values once. Every one-block row
(``fft_fused``, ``rfft_fused``, ``irfft_fused``), the whole frames of
``fft2_fused``, ``rfft2_fused`` and ``irfft2_fused``, and the column
panels of ``fft2_columns`` run the register passes of
``csrc/stockham_regs.cuh`` at either radix: four radix-2 layers a pass, or
two radix-4 ones, the first loaded from HBM and the last stored to HBM,
so their exchanges through shared memory are their passes less one, plus
one where a real row's recombination reads the half spectrum back from
shared memory; the model times both radices alike there, and ESTIMATE
ranks the radix-4 engine, of fewer operations, first
(:func:`fastest_variant`). The cluster kernel runs that
panel over lines of Q = m/A values (A = 16, 32 or 64 lines a row), so its
exchanges are the panel's over Q values, plus the load's regrouping of
each CTA's runs into lines and the one read across the cluster
(``cluster_exchanges``).
The streaming kind (``fft2d_stream``) always runs the composed route, rows
then ``fft2_columns``, frame by frame on two CUDA streams, and its
``unroll`` (frames a step) comes from :func:`_estimate_unroll`, the
reference's rule. The pencil kind (``fft2d_pencil``) runs that route on
each rank's 1/d of the frame, plus the trips of its exchange (the
``all_to_all_single`` reads and writes each element once; at d > 1 the
pack into the send buffer, and with several frames the unpack, one more
each), and its corner turn crosses the mesh once: every model, fused or
not, takes ``max`` with that collective term, each element's bytes over
``n_devices`` at ``NVLINK_BW``, as the reference does at ``ICI_LINK_BW``.
Its ``chunks`` (the overlapped variant's slabs) come from
:func:`_estimate_chunks`, the reference's rule. The kernel's time is the
larger of the two plus the engine's ``stage_overhead_s`` per pass, so the
radix-4 kernels, with fewer passes and round trips, win wherever both fit,
as the kernels' times on the card show (``chip_smoke.py``). The schedules
and the CPU keep the reference's model: a fused kernel on a CPU tensor runs
its plain version, modelled like its schedule plus call overheads.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.fft1d import butterfly_counts
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, SMEM_BW, Roofline
from repro_torch.plan.plan import FFTPlan, ProblemKey
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.breaker import quarantine

__all__ = [
    "MEASURE_CANDIDATE_BUDGET_S",
    "MeasureTimeout",
    "chunk_candidates",
    "estimate_plan",
    "estimate_variant_time",
    "fastest_variant",
    "measure_plan",
    "oaconv_tile_candidates",
    "variant_candidates",
]

# Real FLOPs per butterfly: one complex multiply (6) + two complex add/sub (4).
_FLOPS_PER_BUTTERFLY = 10.0

# Fixed cost of a kernel launch, and of a plain version's extra bookkeeping.
_KERNEL_LAUNCH_S = 2.0e-6
_PLAIN_OVERHEAD_S = 20.0e-6

# The host sits far off the card's roofline; only the ranking matters.
_BACKEND_SLOWDOWN = {"cpu": 40.0}

_REAL_KINDS = ("rfft1d", "rfft2d")
#: 2D kinds that never run a frame in one block.
_COMPOSED_KINDS = ("fft2d_stream", "fft2d_pencil")


#: Engine backends a CUDA key plans onto when no backend is scoped: the
#: hand-written kernels, and the double-precision engine (which serves
#: double keys only).
_CARD_BACKENDS = ("cuda", "x64")


def variant_candidates(key: ProblemKey) -> Tuple[str, ...]:
    """Engines the planner may consider for ``key``: the registry filtered
    by kind × precision × backend scope × device count × shared-memory fit.
    A ``"cuda"`` key with no backend scope considers the CUDA kernels only
    (and, at double precision, ``reference_x64``), and raises
    ``NotImplementedError`` when none fits.

    Engines quarantined for this problem key (``repro_torch.resilience``
    circuit breaker open after a failure) are excluded, so the planner
    routes around a benched engine until its cooldown admits a probe.
    When quarantine would empty the list, the ``reliable``-marked rungs
    come back, and failing those every candidate, as in the reference.
    On a CUDA key with no backend scope the candidates are the kernels
    alone, none of them ``reliable``: quarantining both brings both back,
    and the degradation ladder's rungs stay kernels.
    """
    from repro_torch.engines import iter_engines  # lazy: engines is the leaf layer

    on_card = key.backend == "cuda" and not key.backends
    specs = tuple(s for s in iter_engines()
                  if s.supports(key) and (s.backend in _CARD_BACKENDS or not on_card))
    if not specs and on_card:
        raise NotImplementedError(
            f"no CUDA kernel serves {key.kind!r} at shape {key.shape}: its rows exceed "
            "the fused kernels' envelope (2^24 values, past which the two-pass "
            "kernels' twiddle exponents are no longer exact in float32); scope "
            "xfft.config(backend='torch') to run the plain schedules on the card"
        )
    if not specs:
        scope = f" under backend scope {key.backends}" if key.backends else ""
        raise ValueError(
            f"no registered engine supports kind {key.kind!r} at precision "
            f"{key.precision!r}{scope}; registered engines: "
            f"{tuple(s.name for s in iter_engines())}"
        )
    breaker = quarantine()
    healthy = tuple(s.name for s in specs if not breaker.excluded(s.name, key))
    if healthy:
        return healthy
    reliable = tuple(s.name for s in specs if s.reliable)
    return reliable or tuple(s.name for s in specs)


def _transform_geometry(key: ProblemKey) -> Tuple[int, int]:
    """(n, n_transforms): modelled 1D length and 1D transforms per call."""
    shape = key.shape
    if key.kind in ("fft1d", "rfft1d"):
        batch = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
        return shape[-1], max(batch, 1)
    h, w = shape[-2], shape[-1]
    lead = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
    n = int(2 ** round((math.log2(w) + math.log2(h)) / 2))
    return n, max(lead, 1) * (h + w)


def _stage_passes(stages: int, radix: int) -> int:
    if radix <= 2:
        return stages
    return max(1, math.ceil(stages / math.log2(radix)))


def _row_cost(n: int, radix: int, real: bool, inverse: bool = False) -> Tuple[int, int]:
    """(HBM round trips, shared-memory passes) of the 1D kernels on a row of
    n: one block (the register passes' exchanges, the same at both
    radices); over one block at radix 4 up to 2^18 the cluster kernel (one
    round trip, its exchanges); at radix 2, and past 2^18 at both radices,
    the two-pass kernels on the (n1, n2) view of the row (at N/2 complex
    values when ``real``, plus one elementwise round trip): the register
    passes' exchanges of each pass, whose first pass loads from HBM and
    last stores to HBM."""
    from repro_torch.kernels.fft_radix2 import (  # lazy
        cluster_exchanges,
        fft_fits_fused,
        fft_fits_smem,
        fft_split,
        regpass_exchanges,
    )

    m = n // 2 if real else n
    if fft_fits_smem(n, real=real):
        return 1, regpass_exchanges(n, real=real, inverse=inverse, radix=radix)
    if radix == 4 and fft_fits_fused(n):
        return 1, cluster_exchanges(m)
    n1, n2 = fft_split(m)
    return 3 if real else 2, regpass_exchanges(n1) + regpass_exchanges(n2)


def _frame_passes(h: int, w: int, radix: int, real: bool, inverse: bool) -> int:
    """Shared-memory passes of the whole-frame kernels on an (H, W) frame:
    the register passes' exchanges (``frame_passes``), which ``fft2_fused``,
    ``rfft2_fused`` and ``irfft2_fused`` run at both radices."""
    from repro_torch.kernels.fft_radix2 import frame_passes  # lazy

    return frame_passes(h, w, real=real, inverse=inverse).exchanges


def _column_cost(h: int, radix: int) -> Tuple[int, int]:
    """(HBM round trips, shared-memory passes) of the composed route's
    column pass on columns of H: ``fft2_columns`` where it serves H (one
    trip; its column panel the register passes at both radices), else the
    row kernels on the turned frame."""
    from repro_torch.kernels.fft_radix2 import fft2_columns_serves, regpass_exchanges  # lazy

    if fft2_columns_serves(h):
        return 1, regpass_exchanges(h, radix=radix)
    return _row_cost(h, radix, False)


def _fused_cuda_time(key: ProblemKey, radix: int, pass_s: float) -> float:
    """Modelled time of the fused kernels on the card: max(HBM, shared
    memory) over every launch the call makes, plus ``pass_s`` per
    shared-memory pass. The stream never runs a frame in one block, and
    launches its row and column kernels once a step."""
    from repro_torch.kernels.fft_radix2 import fft2_columns_serves  # lazy
    from repro_torch.kernels.ops import fft2_fits_budget

    elem_bytes = 16.0 if key.precision == "double" else 8.0
    elems = float(np.prod(key.shape, dtype=np.int64))
    real = key.kind in _REAL_KINDS
    inverse = key.direction == "inv"
    if key.kind in ("fft1d", "rfft1d"):
        trips, passes = _row_cost(key.shape[-1], radix, real, inverse)
    else:
        h, w = key.shape[-2], key.shape[-1]
        if key.kind not in _COMPOSED_KINDS and fft2_fits_budget(h, w, real=real):
            trips = 1
            passes = _frame_passes(h, w, radix, real, inverse)
        else:
            row_trips, row_passes = _row_cost(w, radix, real, inverse)
            # fft2_columns: one trip and its panel's passes; longer columns
            # add the two corner turns.
            col_trips, col_passes = _column_cost(h, radix)
            trips = row_trips + col_trips + (0 if fft2_columns_serves(h) else 1)
            passes = row_passes + col_passes
    if real:
        elems *= 0.5
    if key.kind == "fft2d_pencil":
        trips += _pencil_copies(key)
        elems /= key.n_devices
    hbm = 2.0 * elem_bytes * elems * trips / HBM_BW
    smem = 2.0 * elem_bytes * elems * passes / SMEM_BW
    launches = trips
    if key.kind == "fft2d_stream":
        launches *= math.ceil(key.shape[0] / _estimate_unroll(key))
    return (max(hbm, smem, _collective_bytes(key) / NVLINK_BW)
            + launches * _KERNEL_LAUNCH_S + passes * pass_s)


def _pencil_copies(key: ProblemKey) -> int:
    """HBM round trips of a pencil rank beside its passes: the exchange;
    at d > 1 the pack into the send buffer, and with several frames the
    unpack (one frame receives in place; d = 1 packs and unpacks views)."""
    lead = int(np.prod(key.shape[:-2], dtype=np.int64)) if len(key.shape) > 2 else 1
    d = key.n_devices
    return 1 + (d > 1) + (d > 1 and lead > 1)


def _collective_bytes(key: ProblemKey) -> float:
    """Bytes a device sends across the mesh in one call: the pencil's
    corner turn moves each element once, divided over ``n_devices``
    (the reference's term); 0 for every other kind and for one device."""
    if key.kind != "fft2d_pencil" or key.n_devices <= 1:
        return 0.0
    elem_bytes = 16.0 if key.precision == "double" else 8.0
    return elem_bytes * float(np.prod(key.shape, dtype=np.int64)) / key.n_devices


def estimate_variant_time(key: ProblemKey, variant: str) -> float:
    """Modelled execution time (seconds) of one call under ``variant``."""
    from repro_torch.engines import get_engine  # lazy: engines is the leaf layer

    spec = get_engine(variant)
    if spec.fused and key.backend == "cuda":
        return (_fused_cuda_time(key, spec.radix, spec.cost.stage_overhead_s)
                + spec.cost.entry_overhead_s)
    n, n_transforms = _transform_geometry(key)
    counts = butterfly_counts(n, proposed=True)
    stages = counts["stages"]
    passes = _stage_passes(stages, spec.radix)
    flops = _FLOPS_PER_BUTTERFLY * counts["butterfly_units"] * stages * n_transforms
    flops *= spec.cost.flop_scale
    elem_bytes = 16.0 if key.precision == "double" else 8.0
    traffic = spec.cost.traffic_factor * elem_bytes * n * passes * n_transforms
    if key.kind in _REAL_KINDS:
        flops *= 0.5
        traffic *= 0.5
    rl = Roofline(
        flops_per_device=flops / key.n_devices,
        bytes_per_device=traffic / key.n_devices,
        collective_bytes_per_device=_collective_bytes(key),
    )
    t = rl.step_time_s * _BACKEND_SLOWDOWN.get(key.backend, 1.0)
    if spec.fused:
        t += _KERNEL_LAUNCH_S + _PLAIN_OVERHEAD_S
    t += passes * spec.cost.stage_overhead_s
    return t + spec.cost.entry_overhead_s


def fastest_variant(key: ProblemKey, variants) -> Tuple[str, float]:
    """The variant ESTIMATE ranks first among ``variants``, and its modelled
    time: the least modelled time; on equal time, the engine of fewer
    butterfly operations (``flop_scale``). The one-block rows run the same
    register passes at both radices, so their model ties the radix-2 and
    radix-4 kernels, and the radix-4 one, which does 0.85 of the work, is
    ranked first."""
    from repro_torch.engines import get_engine  # lazy: engines is the leaf layer

    times = {v: estimate_variant_time(key, v) for v in variants}
    best = min(times, key=lambda v: (times[v], get_engine(v).cost.flop_scale))
    return best, times[best]


def chunk_candidates(w: int, n_devices: int, limit: int = 16) -> List[int]:
    """Legal corner-turn slab counts: c | W and d | (W/c)."""
    out = [c for c in range(1, limit + 1)
           if w % c == 0 and (w // c) % max(n_devices, 1) == 0]
    return out or [1]


def _estimate_chunks(key: ProblemKey) -> int:
    """The slab count that best overlaps the all_to_all with the column
    FFTs: enough slabs that slab i's exchange hides behind slab i-1's
    butterflies, c ~ collective / compute (the ``stockham`` model of the
    2D frame), clamped to the legal counts; ties favour more slabs. The
    reference's rule, with the mesh's ``NVLINK_BW``."""
    cands = chunk_candidates(key.shape[-1], key.n_devices)
    if len(cands) == 1:
        return cands[0]
    compute_s = estimate_variant_time(
        ProblemKey(kind="fft2d", backend=key.backend, device_kind=key.device_kind,
                   shape=key.shape, dtype=key.dtype, n_devices=key.n_devices,
                   precision=key.precision),
        "stockham",
    )
    collective_s = 8.0 * float(np.prod(key.shape, dtype=np.int64)) / (
        key.n_devices * NVLINK_BW)
    ideal = max(1.0, collective_s / max(compute_s, 1e-12))
    return min(cands, key=lambda c: (abs(c - ideal), -c))


def _estimate_unroll(key: ProblemKey) -> int:
    """Frames a step of the stream (the reference's scan unroll): 2 for
    short frames of at most 128 x 128 values when the stream holds two
    frames or more, else 1; every other kind 1."""
    if key.kind != "fft2d_stream" or len(key.shape) < 3:
        return 1
    if key.shape[0] >= 2 and key.shape[-2] * key.shape[-1] <= 128 * 128:
        return 2
    return 1


def oaconv_tile_candidates(key: ProblemKey) -> List[Tuple[int, int]]:
    """Legal FFT tiles for an overlap-save ``oaconv2d`` problem.

    ``key.shape`` ends ``(H, W, KH, KW)``: image dims, then kernel dims.
    Per axis, a tile is a power of two at least the kernel extent (else
    the overlap-save step ``T - K + 1`` vanishes) and at most the padded
    full-frame transform; jointly, the pair must run as one whole-frame
    block, within the shared-memory census of ``fft2_fused`` /
    ``rfft2_fused`` (``repro_torch.kernels.ops.fft2_fits_budget``: real
    tiles up to 128x256 or 256x128, complex up to 128x128). When even the
    smallest legal tile is over the census (enormous kernels), the single
    padded full-frame transform is the fallback: the 2D entries compose it
    from row and column passes.
    """
    if len(key.shape) < 4:
        raise ValueError(f"oaconv2d keys on (..., H, W, KH, KW); got shape {key.shape}")
    from repro_torch.core.spectral import _next_pow2  # lazy: spectral builds on xfft
    from repro_torch.kernels.ops import fft2_fits_budget

    h, w, kh, kw = key.shape[-4:]
    real = not key.dtype.startswith("complex")

    def axis_cands(dim: int, k: int) -> List[int]:
        lo, hi = _next_pow2(k), _next_pow2(dim + k - 1)
        return [1 << p for p in range(lo.bit_length() - 1, hi.bit_length())]

    pairs = [(th, tw) for th in axis_cands(h, kh) for tw in axis_cands(w, kw)
             if fft2_fits_budget(th, tw, real=real)]
    return pairs or [(_next_pow2(h + kh - 1), _next_pow2(w + kw - 1))]


def _estimate_oaconv_plan(key: ProblemKey) -> FFTPlan:
    """Pick the overlap-save FFT tile with the best modelled time.

    Modelled cost of a tile = (tiles needed to cover the full-size output)
    x (forward + inverse transform of one tile under that tile's best
    engine). Small tiles waste work on the K-1 overlap; big tiles waste it
    on zero padding, and past the census leave the whole-frame kernels for
    the composed passes.
    """
    h, w, kh, kw = key.shape[-4:]
    sub_kind = "fft2d" if key.dtype.startswith("complex") else "rfft2d"
    best: Optional[Tuple[float, str, Tuple[int, int]]] = None
    for th, tw in oaconv_tile_candidates(key):
        sub = ProblemKey(kind=sub_kind, backend=key.backend, device_kind=key.device_kind,
                         shape=(th, tw), dtype=key.dtype, n_devices=key.n_devices,
                         precision=key.precision, backends=key.backends)
        variant, t = fastest_variant(sub, variant_candidates(sub))
        n_tiles = (math.ceil((h + kh - 1) / max(th - kh + 1, 1))
                   * math.ceil((w + kw - 1) / max(tw - kw + 1, 1)))
        total = 2.0 * t * n_tiles  # forward + inverse per tile
        if best is None or total < best[0]:
            best = (total, variant, (th, tw))
    total, variant, tile = best
    return FFTPlan(key=key, variant=variant, mode="estimate", est_time_s=total, tile=tile)


def estimate_plan(key: ProblemKey) -> FFTPlan:
    """Analytic (FFTW ``ESTIMATE``) plan: no device work. An ``oaconv2d``
    key plans its overlap-save tile (``FFTPlan.tile``), a pencil key its
    corner turn's slabs (``FFTPlan.chunks``)."""
    if key.kind == "oaconv2d":
        return _estimate_oaconv_plan(key)
    variant, t = fastest_variant(key, variant_candidates(key))
    return FFTPlan(key=key, variant=variant, unroll=_estimate_unroll(key),
                   chunks=_estimate_chunks(key) if key.kind == "fft2d_pencil" else 1,
                   mode="estimate", est_time_s=t)


# ------------------------------- MEASURE ---------------------------------

#: Per-candidate wall-clock budget (seconds) for a MEASURE sweep. A
#: candidate whose warmup+timing loop exceeds it is skipped and recorded
#: in the ``plan.measure`` span; a sweep where EVERY candidate blows the
#: budget degrades to ESTIMATE with reason ``measure_timeout``. The check
#: runs between calls (a call in flight cannot be preempted from Python),
#: so the guard bounds sweeps that are slow, not ones that never return.
MEASURE_CANDIDATE_BUDGET_S = 30.0

#: Kinds MEASURE times, each through its engines' op (the stream also at
#: each unroll of :data:`STREAM_UNROLLS` on the builtin engines).
_MEASURED_KINDS = ("fft1d", "fft2d", "fft2d_stream", "rfft1d", "rfft2d")
STREAM_UNROLLS = (1, 2)


class MeasureTimeout(Exception):
    """A MEASURE candidate exceeded its wall-clock budget (sweep guard)."""


def _time_us(
    fn: Callable,
    x,
    warmup: int = 1,
    iters: int = 5,
    budget_s: Optional[float] = None,
) -> float:
    """Median time per call in microseconds (the warmup calls discarded).

    On a CUDA tensor each timed call sits between one pair of CUDA events
    recorded on the current stream and is waited for before the next; on
    the CPU each call is timed with ``time.perf_counter``. ``budget_s``
    bounds the candidate's TOTAL wall clock (warmup included): past it,
    :class:`MeasureTimeout` aborts the candidate between calls so one
    pathologically slow schedule cannot hang the whole sweep.
    """
    import torch

    start = time.perf_counter()
    cuda = isinstance(x, torch.Tensor) and x.is_cuda

    def checkpoint():
        if budget_s is not None and time.perf_counter() - start > budget_s:
            raise MeasureTimeout(f"candidate exceeded its {budget_s:.1f}s measure budget")

    for _ in range(max(warmup, 1)):
        fn(x)
        if cuda:
            torch.cuda.synchronize(x.device)
        checkpoint()
    samples = []
    for _ in range(max(iters, 1)):
        if cuda:
            stream = torch.cuda.current_stream(x.device)
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record(stream)
            fn(x)
            end.record(stream)
            end.synchronize()
            samples.append(begin.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(x)
            samples.append((time.perf_counter() - t0) * 1e6)
        checkpoint()
    samples.sort()
    return samples[len(samples) // 2]


def _measure_input(key: ProblemKey, seed: int = 0):
    """A representative input for ``key``, made with numpy from ``seed`` as
    the reference makes it and moved once to the key's device: real for
    rfft kinds, complex else, at the key's precision (a double sweep must
    move double-width bytes); inverse real kinds get the half spectrum
    their runner consumes."""
    import torch

    double = key.precision == "double"
    rdt = np.float64 if double else np.float32
    cdt = np.complex128 if double else np.complex64
    rng = np.random.default_rng(seed)
    if key.kind in _REAL_KINDS:
        x = rng.standard_normal(key.shape).astype(rdt)
        if key.direction == "inv":
            x = np.fft.rfft2(x).astype(cdt) if key.kind == "rfft2d" \
                else np.fft.rfft(x).astype(cdt)
    else:
        x = (rng.standard_normal(key.shape) + 1j * rng.standard_normal(key.shape)).astype(cdt)
    return torch.from_numpy(x).to(torch.device(key.backend))


def _candidate_runners(key: ProblemKey) -> Dict[Tuple[str, int], Callable]:
    """(variant, unroll) -> the engine's op for this problem kind (no
    compilation step: the op runs as it is). The stream's builtin engines
    run at each unroll of :data:`STREAM_UNROLLS`; a registry engine runs its
    own stream op once, as in the reference."""
    from repro_torch.engines import get_engine  # lazy: engines is the leaf layer

    if key.kind not in _MEASURED_KINDS:
        raise ValueError(
            f"MEASURE planning is unavailable for kind {key.kind!r} (pencil problems need "
            "a live mesh; oaconv2d tile choice is analytic); use mode='estimate' instead"
        )
    if key.kind == "fft2d_stream":
        from repro_torch.core.fft1d import BUILTIN_VARIANTS
        from repro_torch.core.fft2d import fft2_stream  # lazy: core imports plan lazily

        runners = {}
        for v in variant_candidates(key):
            for u in STREAM_UNROLLS if v in BUILTIN_VARIANTS else (1,):
                runners[(v, u)] = (functools.partial(fft2_stream, variant=v, unroll=u)
                                   if v in BUILTIN_VARIANTS else get_engine(v).op(key.kind))
        return runners
    return {(v, 1): get_engine(v).op(key.kind, key.direction) for v in variant_candidates(key)}


def measure_plan(
    key: ProblemKey,
    warmup: int = 1,
    iters: int = 5,
    timings_out: Optional[Dict[str, float]] = None,
    budget_s: Optional[float] = None,
) -> FFTPlan:
    """Timed candidate sweep (FFTW ``MEASURE``): run every candidate engine.

    ``timings_out`` (optional dict) receives per-candidate medians in µs,
    keyed by the engine's name. On a CUDA key the kernel library is
    built before the sweep, so no candidate's budget pays for ``nvcc``.

    Each candidate gets ``budget_s`` of wall clock (default
    :data:`MEASURE_CANDIDATE_BUDGET_S`); candidates that exceed it — or
    raise — are skipped and recorded in the ``plan.measure`` span rather
    than hanging or killing the sweep. A sweep with no surviving
    candidate returns the ESTIMATE plan with ``degrade_reason``
    ``"measure_timeout"`` (all timed out) or ``"measure_failed"``.
    """
    if budget_s is None:
        budget_s = MEASURE_CANDIDATE_BUDGET_S
    return _measure_plan_impl(key, warmup, iters, timings_out, budget_s)


def _measure_plan_impl(
    key: ProblemKey,
    warmup: int,
    iters: int,
    timings_out: Optional[Dict[str, float]],
    budget_s: float,
) -> FFTPlan:
    from repro_torch.engines import get_engine  # lazy: engines is the leaf layer

    runners = _candidate_runners(key)
    if key.backend == "cuda" and any(get_engine(v).backend == "cuda" for v, _ in runners):
        from repro_torch.kernels._build import library  # lazy: builds at first use

        library()
    x = _measure_input(key)
    best: Optional[Tuple[Tuple[str, int], float]] = None
    timings: Dict[str, float] = {}
    skipped: Dict[str, str] = {}
    # One span for the whole sweep (it is the expensive planner action),
    # with every candidate's median attached to the emitted event.
    with obs.span(
        "plan.measure",
        kind=key.kind,
        shape=key.shape,
        dtype=key.dtype,
        direction=key.direction,
        precision=key.precision,
    ) as out:
        for (variant, unroll), fn in runners.items():
            label = variant if unroll == 1 else f"{variant}/unroll={unroll}"

            def run(arr, _fn=fn, _variant=variant):
                # plan.measure fault seam fires per timed call, so an
                # injected latency accrues against the candidate budget
                # exactly like a genuinely slow schedule would.
                _faults.maybe_fail("plan.measure", engine=_variant, kind=key.kind)
                return _fn(arr)

            try:
                us = _time_us(run, x, warmup=warmup, iters=iters, budget_s=budget_s)
            except MeasureTimeout:
                skipped[label] = "timeout"
                continue
            except Exception as e:  # noqa: BLE001 — one bad candidate
                skipped[label] = f"error: {e!r}"
                continue
            timings[label] = us
            # Per-candidate event: the calibration ledger's measured
            # prediction for engines the sweep timed but did NOT choose
            # (the chosen one also rides plan.resolve's measured_us).
            obs.emit(
                "plan.measure.candidate",
                engine=variant,
                unroll=unroll,
                label=label,
                kind=key.kind,
                shape=key.shape,
                precision=key.precision,
                median_us=us,
            )
            if timings_out is not None:
                timings_out[label] = us
            if best is None or us < best[1]:
                best = ((variant, unroll), us)
        out["candidates"] = len(timings) + len(skipped)
        out["timings"] = dict(timings)
        if skipped:
            out["skipped"] = dict(skipped)
        if best is None:
            # Nothing survived: fall back to the analytic plan, with the
            # reason recorded on the plan AND in the degrade vocabulary.
            reason = (
                "measure_timeout"
                if any(r == "timeout" for r in skipped.values())
                else "measure_failed"
            )
            out["chosen"] = None
            out["degrade_reason"] = reason
            obs.emit(
                "plan.degrade", kind=key.kind, shape=key.shape,
                direction=key.direction, reason=reason,
            )
            obs.count(f"plan.degrade.{reason}")
            return dataclasses.replace(estimate_plan(key), degrade_reason=reason)
        (variant, unroll), us = best
        out["chosen"] = variant
        out["chosen_us"] = us
    return FFTPlan(
        key=key,
        variant=variant,
        unroll=unroll,
        chunks=1,
        mode="measure",
        est_time_s=estimate_variant_time(key, variant),
        measured_us=us,
    )
