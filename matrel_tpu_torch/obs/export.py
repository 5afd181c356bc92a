"""In-process live metrics endpoint — the counterpart of
``matrel_tpu/obs/export.py``.

A stdlib-only HTTP server on a daemon thread (``config.obs_metrics_port``;
loopback only) serving

- ``/metrics`` — Prometheus text exposition: every registry counter /
  gauge, every timing histogram as a summary (sketch quantiles +
  ``_sum``/``_count``), per-(tenant, objective) SLO burn rates and
  alert states, the brownout rung, breaker states, plan/result-cache
  and IVM counters, and the drift-flag count;
- ``/json`` (also ``/`` and ``/snapshot``) — the same state as one
  JSON document, including full sketch summaries.

The OFF contract is structural: ``obs_metrics_port == 0`` (the default)
constructs NO exporter, NO server socket and NO thread (poisoned
``__init__`` + thread-census test). A nonzero port that cannot bind
raises at session construction — an operator who asked for an endpoint
must not silently run without one.

Serving a snapshot only READS: the registry under its own lock, the
SLO/brownout/breaker snapshots under theirs — a scrape never blocks a
query beyond those per-structure locks, and never touches the device.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from matrel_tpu_torch.obs.metrics import REGISTRY


def from_config(session) -> Optional["MetricsExporter"]:
    """None for the default config (port 0): the OFF path constructs
    nothing. Otherwise a STARTED exporter bound to the configured
    port."""
    port = int(getattr(session.config, "obs_metrics_port", 0))
    if port == 0:
        return None
    exporter = MetricsExporter(session, port)
    exporter.start()
    return exporter


class MetricsExporter:
    """One session's metrics endpoint: a ``ThreadingHTTPServer`` on
    127.0.0.1 driven by one daemon thread.

    Lifecycle: the server holds its session by WEAK reference (a
    strong one would make the listening thread a GC root pinning the
    session — catalog, caches, device arrays — for process lifetime),
    and a ``weakref.finalize`` on the session stops the server when
    the session is collected, freeing the port. The deterministic
    teardown paths are ``stop()`` and ``session.serve_close()``
    (which calls it); a daemon thread never wedges interpreter exit
    either way."""

    def __init__(self, session, port: int):
        self._server = ThreadingHTTPServer(
            ("127.0.0.1", int(port)), _Handler)
        self._server.daemon_threads = True
        self._server.matrel_session_ref = weakref.ref(session)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._finalizer = None
        self._session_for_start = session   # dropped by start()

    def start(self) -> None:
        if self._thread is not None:
            return
        # the GC fallback: a dropped session must not leak its bound
        # port (EADDRINUSE on the next same-config session) — the
        # finalizer holds the SERVER, never the session
        self._finalizer = weakref.finalize(
            self._session_for_start, _stop_server, self._server)
        self._session_for_start = None
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="matrel-metrics",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        if self._finalizer is not None:
            self._finalizer.detach()
        _stop_server(self._server)
        self._thread.join(timeout)
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"


def _stop_server(server) -> None:
    """Shut one exporter server down (stop() and the GC finalizer
    share it). ``shutdown`` needs the serve_forever loop running —
    both callers only fire after start()."""
    try:
        server.shutdown()
        server.server_close()
    except OSError:
        pass  # already closed — the goal state


class _Handler(BaseHTTPRequestHandler):
    # one scrape per poll interval; default request logging would spam
    # the operator's terminal at scrape rate
    def log_message(self, fmt, *args):  # noqa: D102 — stdlib override
        pass

    def do_GET(self):  # noqa: N802 — stdlib contract
        sess = self.server.matrel_session_ref()
        if sess is None:
            self.send_error(503, "owning session was collected")
            return
        try:
            if self.path.split("?", 1)[0] == "/metrics":
                body = render_prometheus(snapshot(sess)).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?", 1)[0] in ("/", "/json",
                                                "/snapshot"):
                body = json.dumps(snapshot(sess)).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown path (try /metrics "
                                     "or /json)")
                return
        except Exception as ex:  # noqa: BLE001 — a scrape must never
            # crash the serving session; the scraper sees the 500
            self.send_error(500, f"snapshot failed: {ex!r}"[:200])
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


# ---------------------------------------------------------------------------
# Snapshot assembly — the one state-gathering path both formats share
# ---------------------------------------------------------------------------


def snapshot(session) -> dict:
    """The live telemetry snapshot: registry metrics (sketch-backed
    histogram summaries included), SLO states, brownout rung, breaker
    states, plan/result-cache and IVM counters, serve-queue depths,
    drift flags and the fleet. Sections whose subsystem is off are None — the JSON
    shape tells the consumer what is configured."""
    sess = session
    snap = {
        "ts": round(time.time(), 3),
        "metrics": REGISTRY.snapshot(),
        "slo": (sess._slo.snapshot()
                if getattr(sess, "_slo", None) is not None else None),
        "brownout": (sess._brownout.snapshot()
                     if getattr(sess, "_brownout", None) is not None
                     else None),
        "breakers": (sess._breakers.snapshot()
                     if getattr(sess, "_breakers", None) is not None
                     else None),
        "plan_cache": sess.plan_cache_info(),
        "result_cache": (sess._result_cache.info()
                         if sess._rc_enabled() else None),
        "ivm": ({"generation": sess._delta_gen}
                if getattr(sess, "_delta_gen", 0) else None),
        "drift": _drift_flags(sess),
    }
    serve = getattr(sess, "_serve", None)
    if serve is not None:
        snap["serve"] = {
            "queue_depth": serve._q.qsize(),
            "tenant_depths": serve._q.tenant_depths(),
            "inflight": serve.inflight_depth,
            "deadline_misses": serve.deadline_misses,
            "stale_served": serve.stale_served,
            "queue_counters": serve._q.counters(),
        }
    else:
        snap["serve"] = None
    fleet = getattr(sess, "_fleet", None)
    # the fleet tier: per-slice state (queue depths, result caches,
    # SLO, brownout), the directory and the placement census
    snap["fleet"] = fleet.info() if fleet is not None else None
    return snap


#: Drift-view read bound: the endpoint audits the log's trailing
#: window, never its whole history — a scrape must cost O(tail).
_DRIFT_TAIL_BYTES = 8 << 20

#: One-slot per-path cache keyed by (size, mtime_ns): a poller
#: scraping every few hundred ms between log appends pays the parse
#: once, not per poll.
_drift_cache: dict = {}


def _drift_flags(session) -> Optional[dict]:
    """Rank-order drift flags over the TRAILING WINDOW of the
    session's event log — the on-line face of ``history --drift``
    (which still audits the full history offline). None when obs is
    off (no log is being written, so there is nothing current to
    audit). Cached on the log file's stat signature so repeated
    scrapes of an idle log parse nothing."""
    if not session._obs_enabled():
        return None
    try:
        from matrel_tpu_torch.obs import drift
        from matrel_tpu_torch.obs.events import read_events, resolve_path
        path = resolve_path(session.config.obs_event_log)
        st = os.stat(path)
        sig = (st.st_size, st.st_mtime_ns)
        hit = _drift_cache.get(path)
        if hit is not None and hit[0] == sig:
            return hit[1]
        events = read_events(path, tail_bytes=_DRIFT_TAIL_BYTES)
        samples = list(drift.iter_samples(events))
        flags = drift.rank_flags(samples)
        out = {"samples": len(samples), "flag_count": len(flags),
               "window_bytes": _DRIFT_TAIL_BYTES,
               "flags": flags[:16]}
        _drift_cache[path] = (sig, out)
        return out
    except Exception:  # noqa: BLE001 — an unreadable log must not
        # break the scrape that would have surfaced it; the None says
        # "no drift view" and the log reader already warned
        return None


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _name(metric: str) -> str:
    return "matrel_" + _NAME_RE.sub("_", metric)


def _esc(label: str) -> str:
    return (str(label).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _num(v) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def render_prometheus(snap: dict) -> str:
    """Prometheus text format (version 0.0.4) over a snapshot().
    Counters/gauges one sample each; histograms as summaries (sketch
    quantiles + _sum/_count); SLO, brownout, breaker, cache and drift
    state as labelled gauges. Parses clean under the strict
    line-grammar check the traffic harness applies on every poll."""
    out = []
    typed = set()

    def emit(name, value, labels=None, mtype=None):
        if mtype and name not in typed:
            out.append(f"# TYPE {name} {mtype}")
            typed.add(name)
        lbl = ""
        if labels:
            lbl = ("{" + ",".join(
                f'{k}="{_esc(v)}"' for k, v in labels.items()) + "}")
        out.append(f"{name}{lbl} {_num(value)}")

    m = snap.get("metrics") or {}
    for k in sorted(m.get("counters") or {}):
        emit(_name(k), m["counters"][k], mtype="counter")
    for k in sorted(m.get("gauges") or {}):
        emit(_name(k), m["gauges"][k], mtype="gauge")
    for k in sorted(m.get("histograms") or {}):
        h = m["histograms"][k]
        n = _name(k)
        emit(n, h.get("p50"), {"quantile": "0.5"}, mtype="summary")
        emit(n, h.get("p95"), {"quantile": "0.95"})
        emit(n, h.get("p99"), {"quantile": "0.99"})
        emit(n + "_sum", h.get("total"))
        emit(n + "_count", h.get("count"))
    slo = snap.get("slo")
    if slo:
        for tenant, row in sorted((slo.get("tenants") or {}).items()):
            for obj, st in sorted((row.get("objectives")
                                   or {}).items()):
                lbl = {"tenant": tenant, "objective": obj}
                emit("matrel_slo_burn_rate", st.get("burn_fast"),
                     {**lbl, "window": "fast"}, mtype="gauge")
                emit("matrel_slo_burn_rate", st.get("burn_slow"),
                     {**lbl, "window": "slow"})
                emit("matrel_slo_attainment", st.get("attainment"),
                     lbl, mtype="gauge")
                emit("matrel_slo_alert_firing",
                     1 if st.get("state") == "firing" else 0, lbl,
                     mtype="gauge")
            lat = row.get("latency_ms") or {}
            for q, field in (("0.5", "p50"), ("0.95", "p95"),
                             ("0.99", "p99")):
                emit("matrel_slo_latency_ms", lat.get(field),
                     {"tenant": tenant, "quantile": q},
                     mtype="summary")
            emit("matrel_slo_tenant_qps", row.get("qps"),
                 {"tenant": tenant}, mtype="gauge")
        emit("matrel_slo_alerts_active", slo.get("alerts_active"),
             mtype="gauge")
        emit("matrel_slo_alerts_fired_total",
             slo.get("alerts_fired"), mtype="counter")
        emit("matrel_slo_alerts_cleared_total",
             slo.get("alerts_cleared"), mtype="counter")
    br = snap.get("brownout")
    if br:
        emit("matrel_brownout_rung", br.get("rung"), mtype="gauge")
        emit("matrel_brownout_queue_depth", br.get("queue_depth"),
             mtype="gauge")
        emit("matrel_brownout_wait_p95_ms", br.get("wait_p95_ms"),
             mtype="gauge")
    bk = snap.get("breakers")
    if bk:
        emit("matrel_breakers_open", len(bk.get("open") or ()),
             mtype="gauge")
        emit("matrel_breakers_half_open",
             len(bk.get("half_open") or ()), mtype="gauge")
    pc = snap.get("plan_cache")
    if pc:
        emit("matrel_plan_cache_plans", pc.get("plans"), mtype="gauge")
        emit("matrel_plan_cache_evicted", pc.get("evicted"),
             mtype="gauge")
    rc = snap.get("result_cache")
    if rc:
        for k in ("entries", "bytes", "hits", "misses", "evicted",
                  "invalidated", "patched", "rekeyed"):
            if k in rc:
                emit(f"matrel_result_cache_{k}", rc[k], mtype="gauge")
    ivm = snap.get("ivm")
    if ivm:
        emit("matrel_ivm_generation", ivm.get("generation"),
             mtype="gauge")
    sv = snap.get("serve")
    if sv:
        emit("matrel_serve_queue_depth", sv.get("queue_depth"),
             mtype="gauge")
        for tenant, depth in sorted(
                (sv.get("tenant_depths") or {}).items()):
            emit("matrel_serve_tenant_queue_depth", depth,
                 {"tenant": tenant or "(default)"}, mtype="gauge")
        emit("matrel_serve_inflight", sv.get("inflight"),
             mtype="gauge")
    dr = snap.get("drift")
    if dr:
        emit("matrel_drift_flags", dr.get("flag_count"), mtype="gauge")
    return "\n".join(out) + "\n"
