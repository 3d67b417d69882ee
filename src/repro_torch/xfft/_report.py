"""Live plan-cache + counter introspection: ``xfft.report()``.

Port of ``repro.xfft._report``. FFTW answers "what did the planner learn?" with ``fftw_export_wisdom``;
this module is that answer for the repo. :func:`report_data` assembles a
structured snapshot of the wisdom cache the active scope resolves
against — per-key engine choice, planning mode, tuned times, hit counts,
the kept/dropped accounting of every wisdom-file load — plus every
process-wide ``repro_torch.obs`` counter; :func:`report` renders it for
humans. Neither touches a device or mutates any state: reporting a
service must never replan it.
"""

from __future__ import annotations

from repro_torch import obs

__all__ = ["report", "report_data"]


def report_data(cache=None) -> dict:
    """Structured snapshot of the active scope's plan cache + obs counters.

    ``cache`` (a :class:`repro_torch.plan.PlanCache`) overrides the scope's
    cache — the active ``config(cache_dir=...)`` wisdom cache when set,
    the process-wide default cache otherwise.
    """
    # Lazy imports: report is a diagnostic surface; the obs/record layer
    # must stay importable without the planner.
    from repro_torch.plan.api import _cache_for_dir
    from repro_torch.plan.cache import default_cache
    from repro_torch.resilience.breaker import quarantine
    from repro_torch.serve.loop import services_for_key
    from repro_torch.xfft._config import get_config

    cfg = get_config()
    if cache is None:
        cache = _cache_for_dir(cfg.cache_dir) if cfg.cache_dir else default_cache()
    entries = []
    for key_str, plan in cache.entries():
        k = plan.key
        entries.append({
            "key": key_str,
            "kind": k.kind,
            "direction": k.direction,
            "shape": list(k.shape),
            "dtype": k.dtype,
            "precision": k.precision,
            "backend": k.backend,
            "device_kind": k.device_kind,
            "variant": plan.variant,
            "mode": plan.mode,
            "est_time_s": plan.est_time_s,
            "measured_us": plan.measured_us,
            "tile": None if plan.tile is None else list(plan.tile),
            "degrade_reason": plan.degrade_reason,
            "hits": cache.hit_count(key_str),
        })
    qrows = []
    by_service: dict = {}
    for row in quarantine().table():
        services = services_for_key(row["key"])
        row = dict(row, services=list(services))
        qrows.append(row)
        for svc in services or ("unassigned",):
            by_service.setdefault(svc, []).append(row)
    return {
        "config": {
            "variant": cfg.variant,
            "mode": cfg.mode,
            "precision": cfg.precision,
            "backends": list(cfg.backends),
            "cache_dir": cfg.cache_dir,
        },
        "cache": {
            "path": cache.path,
            "entries": entries,
            "hits": cache.hits,
            "misses": cache.misses,
            "load": (
                None if cache.load_report is None
                else cache.load_report.to_dict()
            ),
            "readonly_path": getattr(cache, "readonly_path", None),
        },
        # Live circuit-breaker state (repro_torch.resilience): one row per
        # non-closed (engine, problem-key) breaker — which engines are
        # benched, for which problems, and how long until a half-open
        # probe is admitted. Empty when nothing has failed. Each row is
        # tagged with the serve lanes that plan under its key (the
        # serve-loop lane registry), and `quarantine_by_service` regroups
        # the table per service — "which of MY lanes are degraded" for an
        # operator of one service, not just engine × key.
        "resilience": {
            "quarantine": qrows,
            "quarantine_by_service": by_service,
        },
        # Always-on telemetry (repro_torch.obs.telemetry): flight-recorder
        # retention + dump accounting, the planner calibration ledger's
        # mispricing table (observed engine.apply time vs the planner's
        # prediction), and every registered latency histogram (serve
        # lanes + engines).
        "telemetry": {
            "flight_recorder": (
                None if obs.flight_recorder() is None
                else obs.flight_recorder().stats()
            ),
            "calibration": obs.calibration_ledger().table(),
            "histograms": {
                name: h.to_dict() for name, h in obs.histograms().items()
            },
        },
        "counters": obs.counters(),
    }


def _fmt_time(entry: dict) -> str:
    if entry["measured_us"] is not None:
        return f"measured={entry['measured_us']:.1f}us"
    return f"est={entry['est_time_s'] * 1e6:.1f}us"


def report(cache=None) -> str:
    """Human-readable plan-cache + counter report for the active scope.

    One line per wisdom entry (problem identity -> chosen engine, planning
    mode, tuned time, hit count, degrade reason when a MEASURE request
    fell back to ESTIMATE), the load accounting of any wisdom file, and
    every live obs counter.
    """
    d = report_data(cache)
    cfg, c = d["config"], d["cache"]
    scope = f"mode={cfg['mode']} precision={cfg['precision']}"
    if cfg["variant"]:
        scope += f" variant={cfg['variant']}"
    if cfg["backends"]:
        scope += f" backends={','.join(cfg['backends'])}"
    lines = [
        f"repro_torch.xfft report ({scope})",
        f"plan cache: path={c['path'] or 'memory'}  entries={len(c['entries'])}"
        f"  hits={c['hits']}  misses={c['misses']}",
    ]
    for e in c["entries"]:
        shape = "x".join(str(s) for s in e["shape"])
        problem = f"{e['kind']} {e['direction']} {shape} {e['dtype']}"
        line = (
            f"  {problem:<40} -> {e['variant']:<12} {e['mode']:<8} "
            f"{_fmt_time(e):<20} hits={e['hits']}"
        )
        if e["degrade_reason"]:
            line += f"  degraded[{e['degrade_reason']}]"
        if e["tile"]:
            line += f"  tile={e['tile'][0]}x{e['tile'][1]}"
        lines.append(line)
    if c["load"] is not None:
        ld = c["load"]
        lines.append(
            f"wisdom load: kept={ld['kept']} stale_schema={ld['stale_schema']}"
            f" malformed={ld['malformed']} key_mismatch={ld['key_mismatch']}"
            + (f" file_error={ld['file_error']}" if ld["file_error"] else "")
        )
    if c.get("readonly_path"):
        lines.append(
            f"wisdom save: path {c['readonly_path']} unwritable -> "
            "degraded to in-memory caching"
        )
    by_service = d["resilience"]["quarantine_by_service"]
    if by_service:
        lines.append("quarantine (by service lane):")
        for svc in sorted(by_service):
            for q in by_service[svc]:
                line = (
                    f"  {svc:<12} {q['engine']:<12} {q['state']:<9} "
                    f"failures={q['failures']}"
                )
                if q["state"] == "open":
                    line += f" cooldown={q['cooldown_remaining_s']:.1f}s"
                line += f"  {q['key']}"
                lines.append(line)
    tel = d["telemetry"]
    fr = tel["flight_recorder"]
    if fr is None:
        lines.append("flight recorder: off")
    else:
        lines.append(
            f"flight recorder: retained={fr['retained']}/{fr['capacity']}"
            f"  recorded={fr['recorded_total']}  dumps={len(fr['dumps'])}"
            + (f" (+{fr['dropped_dumps']} dropped)" if fr["dropped_dumps"] else "")
        )
        for dump in fr["dumps"]:
            lines.append(
                f"  dump[{dump['trigger']}] {dump['events']} events -> "
                f"{dump['path']}"
            )
    if tel["histograms"]:
        lines.append("latency histograms (us):")
        for name, h in tel["histograms"].items():
            lines.append(
                f"  {name:<40} n={h['count']:<7} p50={h['p50_us']:<9} "
                f"p95={h['p95_us']:<9} p99={h['p99_us']}"
            )
    if tel["calibration"]:
        lines.append("planner calibration (observed vs predicted, worst first):")
        for r in tel["calibration"]:
            shape = "x".join(str(s) for s in r["shape"])
            problem = f"{r['engine']} {r['kind']} {shape} {r['precision']}"
            ratio = f"{r['ratio']:.2f}x" if r["ratio"] is not None else "-"
            observed = (
                f"{r['observed_p50_us']}us" if r["observed_p50_us"] is not None
                else "-"
            )
            lines.append(
                f"  {problem:<44} predicted={r['predicted_us']}us"
                f"[{r['predicted_source']}] observed_p50={observed} "
                f"ratio={ratio} n={r['observed_n']}"
            )
    counters = d["counters"]
    if counters:
        lines.append("counters:")
        width = max(len(name) for name in counters)
        lines.extend(
            f"  {name:<{width}}  {value}" for name, value in counters.items()
        )
    return "\n".join(lines)
