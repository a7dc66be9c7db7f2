"""``pjtpu top`` — the fleet-wide operations console.

Before this module every operational surface was its own island:
``serve_stats.json`` per store, ``pjtpu fleet status`` per coordinator,
per-worker heartbeats, ``repair_status.json`` per graph directory. One
incident means four file formats and no joined picture. ``top`` reads
them all — every one an ATOMICALLY-published snapshot, so a reader
never blocks a producer and a SIGKILLed producer's last view stays
readable — and joins them into a single document:

- **serve**: per graph directory, throughput (windowed queries/sec from
  the live snapshot's rate counters), streaming-histogram p50/p99 with
  their error bounds, hit/stale/error counters, and the SLO burn
  verdict;
- **fleet**: the coordinator's lease table (pending/leased/committed,
  requeues, outstanding leases with deadlines), per-worker heartbeats
  (stage, batches done, ETA) and live-metrics snapshots (lease
  claim-to-commit latency, solver batch walls, retry rates);
- **repairs**: each graph's ``repair_status.json`` (state, dirty parts,
  remaining sources).

Every joined snapshot carries its AGE (seconds since its own publish
stamp) and a ``stale`` flag once the age exceeds ``stale_after_s`` —
the heartbeat-freshness idiom: a fresh file is a live process, a stale
one is hung or dead, and the console says which rather than presenting
dead numbers as current.

``gather_ops`` returns the JSON document (``pjtpu top --once --json``
emits it verbatim for scripts/CI); ``render_ops`` formats the ASCII
console view the live-refresh loop repaints.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


def _age(ts: float | None, now: float) -> float | None:
    if ts is None:
        return None
    return round(now - float(ts), 3)


def _flag_stale(entry: dict, ts: float | None, now: float,
                stale_after_s: float) -> None:
    age = _age(ts, now)
    entry["age_s"] = age
    entry["stale"] = age is None or age > stale_after_s


def _read_json(path: Path) -> dict | None:
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def _summarize_live(live: dict | None) -> dict:
    """Compact the registry snapshot embedded in serve_stats.json /
    a worker metrics file: windowed rates, key histograms (estimate +
    error bound), SLO verdicts."""
    if not live:
        return {}
    out: dict = {}
    counters = live.get("counters") or {}
    rates = {}
    for name, c in counters.items():
        rate_keys = sorted(k for k in c if k.startswith("rate_"))
        if rate_keys:
            rates[name] = {k: c[k] for k in rate_keys}
            rates[name]["total"] = c.get("total")
    if rates:
        out["rates"] = rates
    from paralleljohnson_tpu_torch.observe.live import tail_exemplars_from_dict
    hists = {}
    for name, h in (live.get("histograms") or {}).items():
        hists[name] = {
            k: h.get(k)
            for k in ("count", "mean", "p50_ms", "p50_err_ms",
                      "p99_ms", "p99_err_ms", "max")
            if k in h
        }
        # Tail exemplars: the trace ids behind the slowest
        # buckets, so the p99 number links straight to a request tree.
        tail = tail_exemplars_from_dict(h.get("hist"))
        if tail:
            hists[name]["tail_exemplars"] = [
                {"trace_id": e, "ms": round(v, 3)} for e, v in tail]
    if hists:
        out["histograms"] = hists
    slos = {}
    for name, s in (live.get("slos") or {}).items():
        slos[name] = {
            "burning": s.get("burning"),
            "burn_rate": s.get("burn_rate"),
            "bad_total": s.get("bad_total"),
            "events_total": s.get("events_total"),
            "latency": s.get("latency"),
        }
    if slos:
        out["slos"] = slos
    if live.get("gauges"):
        out["gauges"] = live["gauges"]
    return out


def _gather_serve(root: Path, now: float, stale_after_s: float) -> list[dict]:
    from paralleljohnson_tpu_torch.incremental.status import read_repair_status
    from paralleljohnson_tpu_torch.serve.engine import SERVE_STATS_FILENAME

    entries = []
    for d in sorted({root, *root.glob("graph_*")}):
        stats = _read_json(d / SERVE_STATS_FILENAME)
        repair = read_repair_status(d)
        if stats is None and repair is None:
            continue
        entry: dict = {"dir": str(d)}
        if stats is not None:
            engine = stats.get("engine") or {}
            store = stats.get("store") or {}
            live_summary = _summarize_live(stats.get("live"))
            shed_rate = ((live_summary.get("rates") or {})
                         .get("pjtpu_shed_answers") or {}).get("rate_60s")
            entry["serve"] = {
                "pid": stats.get("pid"),
                "queries_total": engine.get("queries_total"),
                "errors": engine.get("errors"),
                "stale_answers": engine.get("stale_answers"),
                # Traffic-front-end overload columns: how
                # much of the answer stream is certified-degraded, and
                # what admission turned away.
                "shed_answers": engine.get("shed_answers"),
                "shed_rate_60s": shed_rate,
                "rejected": engine.get("rejected"),
                "deadline_drops": engine.get("deadline_drops"),
                "open_connections": engine.get("open_connections"),
                # Lookup-path dispatch: which path answered
                # and how wide the aggregated batches ran.
                "device_lookups": engine.get("device_lookups"),
                "host_lookups": engine.get("host_lookups"),
                "batch_width_p50": engine.get("batch_width_p50"),
                "batch_width_p99": engine.get("batch_width_p99"),
                "hits_by_tier": engine.get("hits_by_tier"),
                # Certified approximate tier: how much of
                # the answer stream is flagged approximate, how much
                # of that the hopset tier served, and the attached
                # hopset's provenance knobs.
                "approx_answers": engine.get("approx_answers"),
                "hopset_answers": engine.get("hopset_answers"),
                "hopset": stats.get("hopset"),
                "p50_ms": engine.get("p50_ms"),
                "p50_err_ms": engine.get("p50_err_ms"),
                "p99_ms": engine.get("p99_ms"),
                "p99_err_ms": engine.get("p99_err_ms"),
                "hit_rate": store.get("hit_rate"),
                "digest": store.get("digest"),
                "live": live_summary,
            }
            _flag_stale(entry["serve"], stats.get("ts"), now, stale_after_s)
        if repair is not None:
            remaining = repair.get("remaining")
            entry["repair"] = {
                "status": repair.get("status"),
                "new_digest": repair.get("new_digest"),
                "dirty_parts": repair.get("dirty_parts"),
                "parts_total": repair.get("parts_total"),
                "affected": (
                    "all" if repair.get("affected") == "all"
                    else len(repair.get("affected") or [])
                ),
                "remaining": (
                    "all" if remaining == "all"
                    else len(remaining or [])
                ),
                "reason": repair.get("reason"),
            }
            _flag_stale(entry["repair"], repair.get("ts"), now, stale_after_s)
        entries.append(entry)
    return entries


def _gather_fleet(coord_dir: Path, now: float, stale_after_s: float) -> dict:
    from paralleljohnson_tpu_torch.distributed.coordinator import (
        Coordinator,
        CoordinatorError,
    )

    try:
        coord = Coordinator(coord_dir)
    except CoordinatorError as e:
        return {"dir": str(coord_dir), "error": str(e)}
    status = coord.status(now=now)
    workers: dict[str, dict] = {}
    hb_dir = coord_dir / "heartbeats"
    if hb_dir.is_dir():
        for p in sorted(hb_dir.glob("*.json")):
            hb = _read_json(p) or {}
            w: dict = {
                "pid": hb.get("pid"),
                "stage": hb.get("stage"),
                "lease": hb.get("lease"),
                "lease_range": hb.get("lease_range"),
                "batches_done": hb.get("batches_done"),
                "sources_done": hb.get("sources_done"),
                "sources_total": hb.get("sources_total"),
                "eta_s": hb.get("eta_s"),
                "leases_committed": hb.get("leases_committed"),
                "last_event": hb.get("last_event"),
            }
            _flag_stale(w, hb.get("ts"), now, stale_after_s)
            workers[p.stem] = w
    metrics_dir = coord_dir / "metrics"
    if metrics_dir.is_dir():
        for p in sorted(metrics_dir.glob("*.json")):
            snap = _read_json(p)
            if snap is None:
                continue
            w = workers.setdefault(p.stem, {})
            live = {"pid": snap.get("pid"),
                    **_summarize_live(snap)}
            _flag_stale(live, snap.get("ts"), now, stale_after_s)
            w["metrics"] = live
    return {
        "dir": str(coord_dir),
        "graph_spec": status.get("graph_spec"),
        "leases": status.get("leases"),
        "leases_total": status.get("leases_total"),
        "requeues": status.get("requeues"),
        "extensions": status.get("extensions"),
        "outstanding": status.get("outstanding"),
        "committed_by": status.get("committed_by"),
        "done": status.get("done"),
        "workers": workers,
    }


def _gather_serve_fleet(fleet_dir: Path, now: float,
                        stale_after_s: float) -> dict:
    """Merged serve-fleet view: membership records under
    ``<fleet>/serve/replicas/`` + the published ``routing.json``, joined
    into one service-level document. Per-replica counters sum; the
    per-replica latency histograms MERGE (same log-bucket geometry by
    construction), so the fleet p50/p99 carry
    the same one-bucket error bound as any single replica's. Dead/stale
    replicas stay in the document, flagged, but never contribute to the
    merge. Absent/torn files degrade — never a crash."""
    from paralleljohnson_tpu_torch.observe.live import LogHistogram
    from paralleljohnson_tpu_torch.serve import fleet as fleet_mod

    doc: dict = {"dir": str(fleet_dir), "routing": None,
                 "replicas": {}, "merged": None}
    routing = _read_json(fleet_mod.routing_path(fleet_dir))
    if routing is not None:
        doc["routing"] = {
            "epoch": routing.get("epoch"),
            "vnodes": routing.get("vnodes"),
            "replicas": sorted(routing.get("replicas") or {}),
        }
        _flag_stale(doc["routing"], routing.get("ts"), now, stale_after_s)
    records = fleet_mod.read_replicas(
        fleet_dir, stale_after_s=stale_after_s, now=now
    )
    counter_keys = ("queries_total", "exact_answers", "approx_answers",
                    "hopset_answers", "errors", "stale_answers",
                    "shed_answers", "rejected", "deadline_drops",
                    "client_limited", "open_connections")
    merged_hist = None
    merge_error = None
    counters: dict = {}
    slo_bad = 0.0
    slo_events = 0.0
    burning = False
    objective = None
    alive = 0
    for rec in records:
        rid = rec.get("replica_id") or "?"
        stats = rec.get("stats") or {}
        live = rec.get("live") or {}
        entry = {
            "host": rec.get("host"),
            "port": rec.get("port"),
            "pid": rec.get("pid"),
            "torn": bool(rec.get("torn")),
            "age_s": rec.get("age_s"),
            "stale": bool(rec.get("stale", True)),
            "queries_total": stats.get("queries_total"),
            "p50_ms": stats.get("p50_ms"),
            "p99_ms": stats.get("p99_ms"),
            "p99_err_ms": stats.get("p99_err_ms"),
            "shed_answers": stats.get("shed_answers"),
            "rejected": stats.get("rejected"),
            "client_limited": stats.get("client_limited"),
            "open_connections": stats.get("open_connections"),
        }
        doc["replicas"][rid] = entry
        if entry["stale"]:
            continue  # flagged corpse: shown, never merged
        alive += 1
        for k in counter_keys:
            v = stats.get(k)
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        serve_slo = (live.get("slos") or {}).get("serve") or {}
        if serve_slo:
            slo_bad += float(serve_slo.get("bad_total") or 0.0)
            slo_events += float(serve_slo.get("events_total") or 0.0)
            burning = burning or bool(serve_slo.get("burning"))
            objective = objective or serve_slo.get("objective")
        hist_doc = (((live.get("histograms") or {})
                     .get("pjtpu_query_latency_ms") or {}).get("hist"))
        if hist_doc and merge_error is None:
            try:
                h = LogHistogram.from_dict(hist_doc)
                merged_hist = (h if merged_hist is None
                               else merged_hist.merge(h))
            except (ValueError, TypeError, KeyError) as e:
                # Geometry guard: mismatched bucketings must never
                # silently corrupt the merged percentiles — degrade to
                # per-replica data with the reason on the document.
                merge_error = str(e)
                merged_hist = None
    merged: dict = {"replicas_live": alive,
                    "replicas_total": len(records),
                    "counters": counters}
    if merge_error is not None:
        merged["histogram_merge_error"] = merge_error
    elif merged_hist is not None and merged_hist.count:
        merged.update({
            k: round(v, 4)
            for k, v in merged_hist.percentiles((50, 99)).items()
        })
        tail = merged_hist.tail_exemplars()
        if tail:
            merged["tail_exemplars"] = [
                {"trace_id": e, "ms": round(v, 3)} for e, v in tail]
    slo: dict = {"burning": burning, "bad_total": slo_bad,
                 "events_total": slo_events}
    if slo_events > 0:
        slo["availability"] = round(1.0 - slo_bad / slo_events, 6)
    if objective:
        slo["objective"] = objective
        target = objective.get("latency_ms")
        pct = objective.get("latency_pct", 99.0)
        if (target is not None and merge_error is None
                and merged_hist is not None and merged_hist.count):
            pr = merged_hist.percentile(pct)
            slo["latency"] = {
                "pct": pct,
                "observed_ms": round(pr["value"], 4),
                "max_error_ms": round(pr["max_error"], 4),
                "target_ms": target,
                # The honest tri-state: a bucket bound that
                # straddles the target says so instead of picking a side.
                "met": (True if pr["upper"] <= target
                        else False if pr["lower"] > target
                        else "within-error-bound"),
            }
    # One service-level verdict: a burning replica or a missed merged
    # latency target degrades the whole fleet's word.
    lat_met = (slo.get("latency") or {}).get("met")
    merged["verdict"] = ("burning" if burning
                         else "degraded" if lat_met is False
                         else "no-replicas" if alive == 0
                         else "ok")
    merged["slo"] = slo
    doc["merged"] = merged
    return doc


def gather_ops(
    *,
    serve_store: str | Path | None = None,
    coordinator_dir: str | Path | None = None,
    serve_fleet: str | Path | None = None,
    stale_after_s: float = 15.0,
    now: float | None = None,
) -> dict:
    """One joined operations document (the ``--once --json`` payload).
    Any source may be absent — the document reports what exists and
    flags by age what stopped publishing."""
    now = time.time() if now is None else now
    doc: dict = {
        "ts": now,
        "stale_after_s": float(stale_after_s),
        "serve": [],
        "serve_fleet": None,
        "fleet": None,
        "repairs": [],
    }
    if serve_store is not None:
        root = Path(serve_store)
        entries = _gather_serve(root, now, stale_after_s)
        doc["serve"] = [e for e in entries if "serve" in e]
        doc["repairs"] = [
            {"dir": e["dir"], **e["repair"]}
            for e in entries if "repair" in e
        ]
    if serve_fleet is not None:
        doc["serve_fleet"] = _gather_serve_fleet(Path(serve_fleet), now,
                                                 stale_after_s)
    if coordinator_dir is not None:
        doc["fleet"] = _gather_fleet(Path(coordinator_dir), now,
                                     stale_after_s)
    return doc


# -- rendering ----------------------------------------------------------------


def _fmt(v, nd: int = 2) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "y" if v else "n"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _staleness(entry: dict) -> str:
    if entry.get("stale"):
        return (f"STALE ({_fmt(entry.get('age_s'), 1)}s old)"
                if entry.get("age_s") is not None else "STALE (no snapshot)")
    return f"fresh {_fmt(entry.get('age_s'), 1)}s"


def _render_serve(lines: list[str], entries: list[dict]) -> None:
    for e in entries:
        s = e["serve"]
        lines.append(f"SERVE {e['dir']}  [{_staleness(s)}]")
        live = s.get("live") or {}
        qrate = ((live.get("rates") or {}).get("pjtpu_queries") or {})
        rate_60 = qrate.get("rate_60s")
        lines.append(
            f"  queries {_fmt(s.get('queries_total'))} "
            f"({_fmt(rate_60)}/s 1m)   "
            f"p50 {_fmt(s.get('p50_ms'))}±{_fmt(s.get('p50_err_ms'))} ms   "
            f"p99 {_fmt(s.get('p99_ms'))}±{_fmt(s.get('p99_err_ms'))} ms   "
            f"hit {_fmt(s.get('hit_rate'))}   "
            f"stale-answers {_fmt(s.get('stale_answers'))}   "
            f"errors {_fmt(s.get('errors'))}"
        )
        # Overload line only when the front end saw any of it — a plain
        # JSONL-loop serve keeps the old two-line layout.
        if any(s.get(k) for k in ("shed_answers", "rejected",
                                  "deadline_drops", "open_connections")):
            lines.append(
                f"  shed {_fmt(s.get('shed_answers'))} "
                f"({_fmt(s.get('shed_rate_60s'))}/s 1m)   "
                f"rejected {_fmt(s.get('rejected'))}   "
                f"deadline-drops {_fmt(s.get('deadline_drops'))}   "
                f"conns {_fmt(s.get('open_connections'))}"
            )
        # Approximate-tier line only when a hopset is attached or an
        # approximate answer was actually served — exact-
        # only engines keep the compact layout.
        if s.get("hopset") or s.get("approx_answers"):
            h = s.get("hopset") or {}
            lines.append(
                f"  approx {_fmt(s.get('approx_answers'))} "
                f"(hopset {_fmt(s.get('hopset_answers'))})   "
                f"hopset eps {_fmt(h.get('epsilon'))} "
                f"beta {_fmt(h.get('beta'), 0)} "
                f"k {_fmt(h.get('k'), 0)} "
                f"edges {_fmt(h.get('edges'), 0)}"
                + ("" if h.get("converged") is None
                   else f" converged {_fmt(h.get('converged'))}")
            )
        # Lookup-path line only once a path counter moved (older
        # snapshots and idle engines keep the compact layout).
        if s.get("device_lookups") or s.get("host_lookups"):
            lines.append(
                f"  lookups device {_fmt(s.get('device_lookups'))} / "
                f"host {_fmt(s.get('host_lookups'))}   "
                f"batch-width p50 {_fmt(s.get('batch_width_p50'))} "
                f"p99 {_fmt(s.get('batch_width_p99'))}"
            )
        # Tail exemplar line: trace ids behind the slowest
        # latency buckets — feed them to `scripts/trace_summary.py
        # --request ID` for the full span tree.
        tail = (((live.get("histograms") or {})
                 .get("pjtpu_query_latency_ms") or {}).get("tail_exemplars"))
        if tail:
            lines.append(
                "  tail traces " + "  ".join(
                    f"{t['trace_id']}@{_fmt(t['ms'])}ms" for t in tail))
        for name, slo in (live.get("slos") or {}).items():
            lat = slo.get("latency") or {}
            verdict = "BURNING" if slo.get("burning") else "ok"
            lines.append(
                f"  SLO {name}: {verdict} (burn {_fmt(slo.get('burn_rate'))}"
                f", bad {_fmt(slo.get('bad_total'), 0)}/"
                f"{_fmt(slo.get('events_total'), 0)})"
                + (f"   p{_fmt(lat.get('pct'), 0)} "
                   f"{_fmt(lat.get('observed_ms'))} ms "
                   f"(±{_fmt(lat.get('max_error_ms'))}) "
                   f"vs target {_fmt(lat.get('target_ms'))} ms -> "
                   f"{lat.get('met')}" if lat else "")
            )


def _render_serve_fleet(lines: list[str], doc: dict) -> None:
    merged = doc.get("merged") or {}
    slo = merged.get("slo") or {}
    lat = slo.get("latency") or {}
    counters = merged.get("counters") or {}
    lines.append(
        f"SERVE-FLEET {doc.get('dir')}  "
        f"[{_fmt(merged.get('replicas_live'), 0)}/"
        f"{_fmt(merged.get('replicas_total'), 0)} live]  "
        f"verdict {merged.get('verdict', '-').upper()}"
    )
    routing = doc.get("routing")
    if routing:
        lines.append(
            f"  routing epoch {_fmt(routing.get('epoch'), 0)} "
            f"vnodes {_fmt(routing.get('vnodes'), 0)} over "
            f"{len(routing.get('replicas') or [])} replicas "
            f"[{_staleness(routing)}]"
        )
    if merged.get("histogram_merge_error"):
        lines.append(
            f"  merged percentiles unavailable "
            f"(geometry guard): {merged['histogram_merge_error']}"
        )
    else:
        lines.append(
            f"  merged queries {_fmt(counters.get('queries_total'))}   "
            f"p50 {_fmt(merged.get('p50_ms'))}"
            f"±{_fmt(merged.get('p50_err_ms'))} ms   "
            f"p99 {_fmt(merged.get('p99_ms'))}"
            f"±{_fmt(merged.get('p99_err_ms'))} ms   "
            f"shed {_fmt(counters.get('shed_answers'))}   "
            f"rejected {_fmt(counters.get('rejected'))}   "
            f"client-limited {_fmt(counters.get('client_limited'))}"
        )
        tail = merged.get("tail_exemplars") or []
        if tail:
            lines.append(
                "  tail traces " + "  ".join(
                    f"{t['trace_id']}@{_fmt(t['ms'])}ms" for t in tail))
    if slo:
        lines.append(
            f"  SLO fleet: {'BURNING' if slo.get('burning') else 'ok'} "
            f"(bad {_fmt(slo.get('bad_total'), 0)}/"
            f"{_fmt(slo.get('events_total'), 0)}"
            + (f", availability {_fmt(slo.get('availability'), 4)}"
               if slo.get("availability") is not None else "")
            + ")"
            + (f"   p{_fmt(lat.get('pct'), 0)} "
               f"{_fmt(lat.get('observed_ms'))} ms "
               f"(±{_fmt(lat.get('max_error_ms'))}) vs target "
               f"{_fmt(lat.get('target_ms'))} ms -> {lat.get('met')}"
               if lat else "")
        )
    for rid, r in (doc.get("replicas") or {}).items():
        addr = f"{r.get('host')}:{r.get('port')}" if r.get("port") else "-"
        flag = ("TORN" if r.get("torn")
                else _staleness(r))
        lines.append(
            f"  {rid:<14} {addr:<22} [{flag}]  "
            f"queries {_fmt(r.get('queries_total'))}   "
            f"p99 {_fmt(r.get('p99_ms'))}"
            f"±{_fmt(r.get('p99_err_ms'))} ms   "
            f"conns {_fmt(r.get('open_connections'))}"
        )


def _render_fleet(lines: list[str], fleet: dict) -> None:
    lines.append(f"FLEET {fleet.get('dir')}")
    if "error" in fleet:
        lines.append(f"  error: {fleet['error']}")
        return
    by_state = fleet.get("leases") or {}
    lines.append(
        f"  {fleet.get('graph_spec')}   leases "
        f"{_fmt(by_state.get('committed'), 0)} committed / "
        f"{_fmt(by_state.get('leased'), 0)} leased / "
        f"{_fmt(by_state.get('pending'), 0)} pending of "
        f"{_fmt(fleet.get('leases_total'), 0)}   "
        f"requeues {_fmt(fleet.get('requeues'), 0)}   "
        f"extensions {_fmt(fleet.get('extensions'), 0)}"
        + ("   DONE" if fleet.get("done") else "")
    )
    for lease in fleet.get("outstanding") or []:
        lines.append(
            f"  lease {lease.get('lease')} {lease.get('range')} "
            f"owner {lease.get('owner')} deadline in "
            f"{_fmt(lease.get('deadline_in_s'), 1)}s"
        )
    workers = fleet.get("workers") or {}
    if workers:
        lines.append(
            f"  {'worker':<12} {'state':<22} {'stage':<12} "
            f"{'done/total':<12} {'eta':<8} {'lease-p50':<12} committed"
        )
    for name, w in workers.items():
        m = (w.get("metrics") or {})
        lease_hist = ((m.get("histograms") or {})
                      .get("pjtpu_lease_wall_ms") or {})
        done = (f"{_fmt(w.get('sources_done'), 0)}/"
                f"{_fmt(w.get('sources_total'), 0)}")
        lines.append(
            f"  {name:<12} {_staleness(w):<22} "
            f"{_fmt(w.get('stage')):<12} {done:<12} "
            f"{_fmt(w.get('eta_s'), 1):<8} "
            f"{_fmt(lease_hist.get('p50_ms'), 1):<12} "
            f"{_fmt(w.get('leases_committed'), 0)}"
        )


def _render_repairs(lines: list[str], repairs: list[dict]) -> None:
    for r in repairs:
        lines.append(
            f"REPAIR {r.get('dir')}  [{_staleness(r)}]\n"
            f"  {r.get('status')} -> {r.get('new_digest')}   dirty parts "
            f"{_fmt(r.get('dirty_parts'), 0)}/{_fmt(r.get('parts_total'), 0)}"
            f"   affected {r.get('affected')}   remaining "
            f"{r.get('remaining')}"
            + (f"   reason: {r.get('reason')}" if r.get("reason") else "")
        )


def render_ops(doc: dict) -> str:
    """ASCII console view of one gathered document."""
    t = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(doc.get("ts")))
    lines = [
        f"pjtpu top — {t} (snapshots stale after "
        f"{_fmt(doc.get('stale_after_s'), 0)}s)"
    ]
    if doc.get("serve"):
        _render_serve(lines, doc["serve"])
    if doc.get("serve_fleet"):
        _render_serve_fleet(lines, doc["serve_fleet"])
    if doc.get("fleet"):
        _render_fleet(lines, doc["fleet"])
    if doc.get("repairs"):
        _render_repairs(lines, doc["repairs"])
    if len(lines) == 1:
        lines.append(
            "nothing to show — point --serve-store at a checkpoint/store "
            "directory, --fleet-dir at a serve-fleet directory, and/or "
            "--coordinator-dir at a fleet directory"
        )
    return "\n".join(lines)
