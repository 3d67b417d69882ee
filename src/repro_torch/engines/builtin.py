"""The built-in engines, registered with their capability envelopes.

Port of ``repro.engines.builtin``. The schedules of ``repro_torch.core``
(``looped``, ``stockham``, ``radix4``) run under backend ``"torch"`` on any
device, and ``unrolled`` is an alias of ``looped`` (one eager stage loop
serves both; the alias lets the reference's wisdom files load); ``fused``/``fused_r4`` run the
CUDA kernels under backend ``"cuda"`` (their plain versions on a CPU
tensor), for power-of-two dims, single device (but see the pencil below),
and only while one row of the longest transform dim is in the 1D kernels'
envelope — the 2D kinds' composition runs the 1D kernels on each pass, so
a row must be served for any fused plan. That envelope is the reference's
(2^18 values) on a CPU key, so that it plans exactly as the reference
does, and the wrappers' own on a CUDA key (2^24 values,
``fft_fits_card``: rows of 2^18 < N <= 2^24 take the two-pass kernels,
where the reference plans its jnp schedules; ROADMAP queue 3, divergence
1). The shared-memory numbers come from the kernels' census
(``repro_torch.kernels.fft_radix2``). ``fused_r4`` runs rows of 2^14 < N
<= 2^18 on thread-block clusters, so on a CUDA key it also needs the card
to hold one cluster of each instance the key launches
(``cluster_occupancy``); where it cannot, the key plans ``fused``, whose
radix-2 rows take the two-pass kernels. Past 2^18 both engines run the
two-pass kernels.

Every engine serves the streaming kind ``fft2d_stream``
(``repro_torch.core.fft2d.fft2_stream``, forward only). The reference's
fused kernels do not serve it; here ``fused``/``fused_r4`` serve it on
CUDA keys only, where the stream runs their row and column kernels on two
CUDA streams. A CPU key therefore plans the stream exactly as the
reference does, on the schedules, and an unscoped CUDA key on the kernels
(ROADMAP queue 3, divergence 6).

Every engine but ``reference_x64`` also serves the multi-device pencil
kind ``fft2d_pencil`` (``repro_torch.core.distributed``), whose op is
``None``: the pencil runs at the plan level (``repro_torch.plan.execute``)
with a mesh, as in the reference. The schedules serve it on every device.
The reference's fused kernels do not; here ``fused``/``fused_r4`` serve it
on CUDA keys only, whatever ``n_devices`` is, since each rank's passes are
one card's row and column kernels (divergence 11). Their shared-memory
gate for it is one row of each transform dim, never the whole frame: a
rank never runs the frame in one block.
"""

from __future__ import annotations

import functools

from repro_torch.engines.registry import CostHints, EngineSpec, register_alias, register_engine

#: Kinds the single-device engines execute (oaconv2d plans a tile and
#: runs the 2D kinds).
_KINDS = ("fft1d", "fft2d", "fft2d_stream", "rfft1d", "rfft2d")
#: The builtin engines' kinds: those, and the pencil, planned here and run
#: at the plan level.
_BUILTIN_KINDS = _KINDS + ("fft2d_pencil",)
#: Kinds whose transform dims are the last two.
_2D_KINDS = ("fft2d", "fft2d_stream", "fft2d_pencil", "rfft2d")


def _core_ops(name: str, **kw):
    """Op factory shared by the builtin engines and ``reference_x64``: the
    ``repro_torch.core`` entries under a concrete variant (and ``kw``, the
    double engine's ``dtype``)."""

    def factory(kind: str, direction: str):
        inv = direction == "inv"
        if kind == "fft1d":
            from repro_torch.core.fft1d import fft_impl, ifft_impl

            return functools.partial(ifft_impl if inv else fft_impl, variant=name, **kw)
        if kind == "fft2d":
            from repro_torch.core.fft2d import fft2_impl, ifft2_impl

            return functools.partial(ifft2_impl if inv else fft2_impl, variant=name, **kw)
        if kind == "rfft1d":
            from repro_torch.core.rfft import irfft_impl, rfft_impl

            return functools.partial(irfft_impl if inv else rfft_impl, variant=name, **kw)
        if kind == "rfft2d":
            from repro_torch.core.rfft import irfft2_impl, rfft2_impl

            return functools.partial(irfft2_impl if inv else rfft2_impl, variant=name, **kw)
        if kind == "fft2d_stream" and not inv:
            from repro_torch.core.fft2d import fft2_stream

            return functools.partial(fft2_stream, variant=name, unroll=1, **kw)
        # fft2d_pencil needs a mesh: it runs at the plan level
        # (repro_torch.plan.execute), not here.
        return None

    return factory


def _dims(key):
    if key.kind in _2D_KINDS:
        return key.shape[-2:] if len(key.shape) >= 2 else None
    return key.shape[-1:]


def _fused_predicate(key) -> bool:
    """Fused kernels need power-of-two transform dims, and serve the stream
    (divergence 6) and the pencil (divergence 11) on CUDA keys only; they
    take part in a multi-device plan as the pencil's per-rank passes only."""
    if key.kind in ("fft2d_stream", "fft2d_pencil") and key.backend != "cuda":
        return False
    if key.n_devices != 1 and key.kind != "fft2d_pencil":
        return False
    dims = _dims(key)
    return dims is not None and all(d >= 2 and (d & (d - 1)) == 0 for d in dims)


def _fused_working_set(key, radix: int = 2):
    """Largest block the fused path launches for ``key`` (bytes of shared
    memory): the whole frame where a 2D frame fits one block, else one row
    of each transform dim, in the kernels that row takes at ``radix`` (one
    block; for 2^14 < N <= 2^18 the two passes at radix 2, one CTA of the
    cluster at radix 4; past 2^18 the two passes). A dim past the key's
    envelope reports a size over the budget: on a CPU key the reference's
    (``fft_fits_fused``, 2^18 values), on a CUDA key the wrappers'
    (``fft_fits_card``, 2^24 values). A pencil (``fft2d_pencil``) always
    takes the rows: no rank runs its frame in one block."""
    from repro_torch.kernels import fft_radix2 as census

    dims = _dims(key)
    if dims is None:
        return None
    fits = census.fft_fits_card if key.backend == "cuda" else census.fft_fits_fused

    def row(n, real=False):
        return census.row_smem_bytes(n, real=real, radix=radix, fits=fits)

    if key.kind == "rfft1d":
        return row(dims[-1], real=True)
    if key.kind == "rfft2d":
        h, w = dims
        if census.rfft2_fits_smem(h, w):
            return census.rfft2_smem_bytes(h, w)
        return max(row(w, real=True), row(h))
    if key.kind == "fft2d" and census.fft2_fits_smem(*dims):
        return census.fft2_smem_bytes(*dims)
    return max(row(d) for d in dims)


def _cluster_rows(key):
    """(m, kind) of each row of ``key`` that the radix-4 fused path runs on
    the cluster kernel (``csrc/fft_cluster.cu``): rows of 2^14 < N <= 2^18,
    a real row at its m = N/2 packed values."""
    from repro_torch.kernels import fft_radix2 as census

    dims = _dims(key)
    real = key.kind in ("rfft1d", "rfft2d")
    if key.kind == "fft2d" and census.fft2_fits_smem(*dims):
        return []
    if key.kind == "rfft2d" and census.rfft2_fits_smem(*dims):
        return []
    rows = []
    for i, n in enumerate(dims):
        row_real = real and i == len(dims) - 1
        if census.fft_fits_fused(n) and not census.fft_fits_smem(n, real=row_real):
            kind = ("irfft" if key.direction == "inv" else "rfft") if row_real else "fft"
            rows.append((n // 2 if row_real else n, kind))
    return rows


def _clusters_run(key) -> bool:
    """False where the card reports that it cannot hold one cluster of an
    instance ``key`` would launch (``cudaOccupancyMaxActiveClusters`` is 0,
    as on a MIG slice): the planner then takes the radix-2 ``fused``
    engine, before any launch. A CPU key, or no card in sight, asks
    nothing."""
    if key.backend != "cuda":
        return True
    from repro_torch.kernels import fft_radix2 as census

    return all(census.cluster_occupancy(m, kind) != 0 for m, kind in _cluster_rows(key))


def _fused_r4_predicate(key) -> bool:
    return _fused_predicate(key) and _clusters_run(key)


def _register_builtin_engines() -> None:
    schedules = (
        ("looped", CostHints(traffic_factor=6.0, stage_overhead_s=3.0e-6,
                             entry_overhead_s=5.0e-6), 2),
        ("stockham", CostHints(traffic_factor=4.0, stage_overhead_s=0.8e-6), 2),
        ("radix4", CostHints(traffic_factor=4.0, stage_overhead_s=0.8e-6,
                             flop_scale=0.85), 4),
    )
    for name, cost, radix in schedules:
        register_engine(EngineSpec(
            name=name, backend="torch", kinds=_BUILTIN_KINDS, radix=radix, cost=cost,
            reliable=(name == "stockham"), ops=_core_ops(name),
        ), _protect=True)
    register_alias("unrolled", "looped")
    for name, radix, flop_scale, predicate in (("fused", 2, 1.0, _fused_predicate),
                                               ("fused_r4", 4, 0.85, _fused_r4_predicate)):
        register_engine(EngineSpec(
            name=name,
            backend="cuda",
            kinds=_BUILTIN_KINDS,
            radix=radix,
            fused=True,
            # multi-device keys: the predicate admits the pencil's alone
            working_set=functools.partial(_fused_working_set, radix=radix),
            predicate=predicate,
            cost=CostHints(traffic_factor=4.0, stage_overhead_s=0.8e-6,
                           flop_scale=flop_scale),
            ops=_core_ops(name),
        ), _protect=True)


_register_builtin_engines()
