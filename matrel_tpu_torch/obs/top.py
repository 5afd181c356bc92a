"""``python -m matrel_tpu_torch top`` — the live operator console
(the live half of ``obs/``).

The serve plane has made second-to-second decisions (brownout rungs,
typed sheds, breaker trips, IVM patches) with
nobody able to WATCH: every surface so far replays a log after the
fact. ``top`` renders the live view — per-tenant QPS, latency
p50/p95/p99, goodput, shed rate, SLO burn rates and active alerts,
plus the plane-wide rung / breaker / cache state — from either:

- ``--url`` (or ``--port``): poll a session's live metrics endpoint
  (``config.obs_metrics_port``; obs/export.py) — the operator tier;
- ``--log``: tail an event log and reconstruct the same view from the
  most recent ``overload``/``alert`` records — works post-hoc or
  against a host whose endpoint is off.

``--once`` renders a single frame and exits (scripting / tests);
otherwise it refreshes every ``--interval`` seconds until interrupted.
Plain ANSI, no curses — it must work over the dumbest SSH pipe a
production incident offers.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import List, Optional

from matrel_tpu_torch.obs.events import read_events, resolve_path
from matrel_tpu_torch.obs.metrics import percentile


def snapshot_from_url(url: str, timeout: float = 3.0) -> dict:
    """GET the endpoint's JSON snapshot. ``url`` is the exporter base
    (http://127.0.0.1:<port>); /json is appended."""
    base = url.rstrip("/")
    with urllib.request.urlopen(base + "/json",
                                timeout=timeout) as resp:
        snap = json.loads(resp.read().decode())
    snap["_source"] = base
    return snap


#: Log-mode trailing window (seconds of log time) the per-tenant
#: rates are computed over.
LOG_WINDOW_S = 60.0

#: Log-mode read bound: each refresh frame parses at most this much
#: of the file's tail — a live console over a multi-GB host log must
#: cost O(tail) per frame, not O(history). Alert last-states are
#: scoped to the same window (a console is a live view; `history`
#: owns the full replay).
LOG_TAIL_BYTES = 16 << 20


def snapshot_from_log(path: Optional[str] = None,
                      window_s: float = LOG_WINDOW_S,
                      tail_bytes: int = LOG_TAIL_BYTES) -> dict:
    """Reconstruct an endpoint-shaped snapshot from an event log's
    tail: the LAST ``overload`` record carries the instantaneous
    control-plane state (rung, depths, breaker set, and — when the
    SLO plane is active — its full snapshot), the trailing window of
    ``overload`` records gives per-tenant rates, and ``alert``
    records give last-known alert states. Timestamps are the LOG's
    own — a replay renders what the host saw, not what the reader's
    clock says."""
    p = resolve_path(path)
    events = read_events(p, tail_bytes=tail_bytes)
    ov = [e for e in events if e.get("kind") == "overload"]
    snap: dict = {"_source": p, "ts": (events[-1].get("ts")
                                       if events else None),
                  "slo": None, "brownout": None, "breakers": None,
                  "serve": None, "metrics": None,
                  "plan_cache": None, "result_cache": None,
                  "ivm": None, "drift": None}
    if ov:
        last = ov[-1]
        snap["slo"] = last.get("slo")
        # every overload record carries rung/rung_label at top level;
        # the nested "brownout" controller snapshot only exists when a
        # LoadController is configured — fall back so the header shows
        # the rung either way
        snap["brownout"] = (last.get("brownout")
                            or {"rung": last.get("rung"),
                                "rung_label": last.get("rung_label")})
        snap["breakers"] = last.get("breakers")
        snap["serve"] = {"queue_depth": last.get("queue_depth"),
                         "tenant_depths": last.get("tenant_depths"),
                         "deadline_misses": None, "inflight": None}
        # trailing-window per-tenant rates from the overload stream
        t_hi = last.get("ts") or 0.0
        recent = [e for e in ov
                  if (e.get("ts") or 0.0) >= t_hi - window_s]
        span = max(t_hi - (recent[0].get("ts") or t_hi), 1e-3) \
            if recent else 1e-3
        tenants: dict = {}
        for e in recent:
            for t, n in (e.get("admitted") or {}).items():
                row = tenants.setdefault(
                    t, {"admitted": 0, "sheds": 0, "waits": []})
                row["admitted"] += int(n)
            for t, n in (e.get("sheds") or {}).items():
                row = tenants.setdefault(
                    t, {"admitted": 0, "sheds": 0, "waits": []})
                row["sheds"] += int(n)
            for t, ws in (e.get("tenant_waits_ms") or {}).items():
                row = tenants.setdefault(
                    t, {"admitted": 0, "sheds": 0, "waits": []})
                row["waits"].extend(
                    float(w) for w in ws
                    if isinstance(w, (int, float)))
        snap["_log_tenants"] = {
            t: {"qps": round(row["admitted"] / span, 2),
                "shed_rate": (round(row["sheds"]
                                    / (row["admitted"] + row["sheds"]),
                                    4)
                              if row["admitted"] + row["sheds"]
                              else None),
                "p50": percentile(row["waits"], 0.50),
                "p95": percentile(row["waits"], 0.95),
                "p99": percentile(row["waits"], 0.99)}
            for t, row in tenants.items()}
        snap["_log_window_s"] = round(span, 1)
    # alert states: last transition wins per (tenant, objective)
    states: dict = {}
    for e in events:
        if e.get("kind") == "alert":
            states[(str(e.get("tenant")),
                    str(e.get("objective")))] = e
    snap["_log_alerts"] = [
        {"tenant": t, "objective": o, "state": e.get("state"),
         "burn_fast": e.get("burn_fast")}
        for (t, o), e in sorted(states.items())]
    # reconcile: alert transitions AFTER the last overload record are
    # newer truth than the snapshot it carried (the worker stops
    # emitting overload cycles once the queue drains, but the idle
    # tick keeps emitting alert clears) — without this the header
    # could show FIRING for an alert the log already cleared
    slo = snap.get("slo")
    if slo and states and ov:
        t_snap = ov[-1].get("ts") or 0.0
        for (t, o), e in states.items():
            st = ((slo.get("tenants") or {}).get(t, {})
                  .get("objectives") or {}).get(o)
            if st is not None and (e.get("ts") or 0.0) >= t_snap:
                st["state"] = ("firing" if e.get("state") == "firing"
                               else "ok")
                if e.get("burn_fast") is not None:
                    st["burn_fast"] = e["burn_fast"]
        slo["alerts_active"] = sum(
            1 for d in (slo.get("tenants") or {}).values()
            for st in (d.get("objectives") or {}).values()
            if st.get("state") == "firing")
    return snap


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _f(v, nd=1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _tenant_rows(snap: dict) -> List[dict]:
    """Normalise either source into the table's rows. The SLO plane's
    snapshot is the richest source (sketch latencies, burns, states);
    the log fallback carries queue-wait percentiles instead."""
    rows: List[dict] = []
    slo = snap.get("slo")
    if slo and slo.get("tenants"):
        for t, d in sorted(slo["tenants"].items()):
            lat = d.get("latency_ms") or {}
            qps = d.get("qps")
            shed = d.get("shed_rate")
            burns = [(o, st) for o, st in sorted(
                (d.get("objectives") or {}).items())]
            worst = max((st.get("burn_fast") or 0.0)
                        for _, st in burns) if burns else None
            firing = [o for o, st in burns
                      if st.get("state") == "firing"]
            rows.append({
                "tenant": t, "qps": qps,
                "goodput": (round(qps * (1.0 - shed), 2)
                            if qps is not None and shed is not None
                            else qps),
                "p50": lat.get("p50"), "p95": lat.get("p95"),
                "p99": lat.get("p99"),
                "shed_rate": shed, "burn_fast": worst,
                "slo": (" ".join(f"FIRING:{o}" for o in firing)
                        or "ok")})
        return rows
    for t, d in sorted((snap.get("_log_tenants") or {}).items()):
        firing = [a["objective"]
                  for a in snap.get("_log_alerts") or ()
                  if a["tenant"] == t and a["state"] == "firing"]
        rows.append({
            "tenant": t or "(default)", "qps": d.get("qps"),
            "goodput": None,
            "p50": d.get("p50"), "p95": d.get("p95"),
            "p99": d.get("p99"), "shed_rate": d.get("shed_rate"),
            "burn_fast": None,
            "slo": (" ".join(f"FIRING:{o}" for o in firing)
                    or ("ok" if snap.get("_log_alerts") is not None
                        else "-"))})
    return rows


def render(snap: dict) -> str:
    """One frame of the console."""
    lines = []
    br = snap.get("brownout") or {}
    bk = snap.get("breakers") or {}
    slo = snap.get("slo") or {}
    alerts = (slo.get("alerts_active")
              if slo else sum(1 for a in snap.get("_log_alerts") or ()
                              if a["state"] == "firing"))
    open_breakers = bk.get("open") or ()
    lines.append(
        f"matrel_tpu_torch top — {snap.get('_source', '?')}"
        + (f"   ts {snap['ts']}" if snap.get("ts") else ""))
    lines.append(
        f"rung: {br.get('rung_label', br.get('rung', 'off'))}   "
        f"breakers open: {len(open_breakers)}"
        + (f" ({', '.join(open_breakers)})" if open_breakers else "")
        + f"   active alerts: {alerts if alerts is not None else '-'}")
    sv = snap.get("serve") or {}
    pc = snap.get("plan_cache") or {}
    rc = snap.get("result_cache") or {}
    ivm = snap.get("ivm") or {}
    dr = snap.get("drift") or {}
    lines.append(
        f"queue depth: {_f(sv.get('queue_depth'))}   "
        f"inflight: {_f(sv.get('inflight'))}   "
        f"plan cache: {_f(pc.get('plans'))} plans   "
        f"result cache: {_f(rc.get('entries'))} entries"
        + (f"   ivm gen: {ivm.get('generation')}" if ivm else "")
        + (f"   DRIFT flags: {dr.get('flag_count')}"
           if dr.get("flag_count") else ""))
    fl = snap.get("fleet") or {}
    if fl.get("slices"):
        d = fl.get("directory") or {}
        pl = fl.get("placed") or {}
        lines.append(
            f"fleet: {len(fl['slices'])} slice(s) "
            f"({sum(1 for s in fl['slices'] if s.get('alive'))} "
            f"alive)   placed: slice={pl.get('slice', 0)} "
            f"span={pl.get('span', 0)}   dir hits: {d.get('hits', 0)}"
            f" ({d.get('remote_hits', 0)} remote)   "
            f"migrations: {fl.get('migrations', 0)}   "
            f"failovers: {fl.get('failovers', 0)}")
        for s in fl["slices"]:
            rc = s.get("result_cache") or {}
            slo = s.get("slo") or {}
            lines.append(
                f"  slice {s['id']}: "
                f"{'up' if s.get('alive') else 'DEAD'}   "
                f"dev {_f(s.get('devices'), 0)}   "
                f"queued {_f(s.get('queued'), 0)}   "
                f"submitted {_f(s.get('submitted'), 0)}   "
                f"rc {_f(rc.get('entries'), 0)} entries"
                + (f"   alerts {slo.get('alerts_active')}"
                   if slo else ""))
    rows = _tenant_rows(snap)
    if rows:
        header = (f"{'tenant':<14}{'qps':>8}{'goodput':>9}"
                  f"{'p50':>8}{'p95':>8}{'p99':>9}{'shed%':>8}"
                  f"{'burn':>7}  slo")
        lines += ["", header, "-" * len(header)]
        for r in rows:
            shed = (r["shed_rate"] * 100.0
                    if r["shed_rate"] is not None else None)
            lines.append(
                f"{r['tenant']:<14}{_f(r['qps']):>8}"
                f"{_f(r['goodput']):>9}{_f(r['p50']):>8}"
                f"{_f(r['p95']):>8}{_f(r['p99']):>9}"
                f"{_f(shed):>8}{_f(r['burn_fast']):>7}  {r['slo']}")
    la = snap.get("_log_alerts")
    if la:
        lines.append("")
        lines.append("alerts (last transition per objective):")
        for a in la:
            lines.append(
                f"  {a['tenant']}:{a['objective']} {a['state']}"
                + (f" (burn {_f(a['burn_fast'])})"
                   if a.get("burn_fast") is not None else ""))
    return "\n".join(lines)


def main(args) -> int:
    """CLI backend for ``python -m matrel_tpu_torch top``."""
    url = args.url
    if not url and args.port:
        url = f"http://127.0.0.1:{args.port}"
    iterations = 1 if args.once else (args.iterations or 0)
    i = 0
    try:
        while True:
            if url:
                try:
                    snap = snapshot_from_url(url)
                except (OSError, ValueError) as ex:
                    print(f"top: endpoint {url} unreachable: {ex}")
                    return 1
            else:
                snap = snapshot_from_log(args.log)
            frame = render(snap)
            if not args.once and i > 0:
                # ANSI home+clear between frames; the first frame (and
                # --once) prints plainly so piping stays clean
                print("\x1b[2J\x1b[H", end="")
            print(frame, flush=True)
            i += 1
            if iterations and i >= iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
