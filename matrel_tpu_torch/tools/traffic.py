"""Open-loop traffic harness — the overload control plane's proving ground;
the port of the JAX package's ``tools/traffic.py``.

A closed-loop replay never drives the engine at its design point: the next
query waits for the last one. This harness drives ``session.submit``
OPEN-loop: a seeded Poisson (or bursty, Markov-modulated) arrival process
over a declarative tenant x workload mix submits on schedule whether or
not the engine kept up, which is the only way queue growth, typed
shedding, weighted fairness and brownout actually happen.

Three phases, one JSON line:

  1. closed-loop calibration: one submit-wait client per tenant over the
     workload pool measures capacity C (the goodput denominator);
  2. overload: ``MATREL_TRAFFIC_RATE_X`` x C arrivals (default 2x) for
     ``MATREL_TRAFFIC_SECONDS`` across 3 weighted tenants (gold:4 /
     silver:2 / bronze:1, equal arrival shares) with per-query
     deadlines — the brownout controller must ENTER;
  3. cool-down tail at a fraction of C — the controller must EXIT (the
     hysteresis proof), then a bounded drain.

Acceptance (the record's ``ok``, ``traffic_overload_harness``):

  - goodput >= ``MATREL_TRAFFIC_GOODPUT_MIN`` (default 0.8) of the
    measured closed-loop capacity at ~2x sustained overload;
  - every rejected query fails TYPED (zero untyped errors) and zero wrong
    answers (every completed result checked against its numpy oracle, at
    the fast-tier tolerance — brownout rung 1 may legitimately downshift
    default-SLA queries);
  - admitted-and-met p99 latency stays bounded by the declared deadline;
  - the highest-weight tenant's miss rate (sheds + deadline misses over
    arrivals) is STRICTLY lower than the lowest-weight tenant's;
  - brownout provably enters AND exits;
  - the plan-template plateau over the dashboard class holds;
  - the Jain fairness index over weight-normalised per-tenant goodput is
    reported (1.0 = perfectly weight-proportional service).

``--slo`` runs the SAME three phases under declared per-tenant objectives
with the live metrics endpoint on (``traffic_slo_harness``): the violated
(lowest-weight) tenant's fast-window burn-rate alert must FIRE during
saturation and every alert must CLEAR after the load drops, with the
Prometheus endpoint strict-parsing clean on every poll and zero wrong
answers.

``--slices`` drives the same machinery through a multi-slice fleet with a
mid-stream ``kill_slice`` (``traffic_fleet_harness``; see
:func:`main_slices`).

Latency is measured to future RESOLUTION. The workload mix is a dense
scaled-matmul class, triangle counting (``workloads/triangles.py``), an
S x S pair over ``synthesize_structure("row_band", 256, 64)`` (14 of its
16 tiles are stored, so at the default ``spgemm_density_threshold`` it
does not take the SpGEMM registry, in both packages: on the card it runs
through B1's f32 body) and a dashboard class of six structurally
identical Gram queries. MATREL_TRAFFIC_SEED varies the
arrival schedule; any fixed seed is reproducible.

It runs on the card unless ``--device cpu`` is given; on the card the
record carries the card's name and power limit beside its rates and
latencies.

    python -m matrel_tpu_torch.tools.traffic [--slo | --slices]
                                             [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time

import numpy as np

#: The declarative tenant mix: weight drives admission fairness, share
#: drives the arrival split (equal — fairness must come from the queue,
#: not the generator).
TENANTS = ({"name": "gold", "weight": 4.0, "share": 1 / 3},
           {"name": "silver", "weight": 2.0, "share": 1 / 3},
           {"name": "bronze", "weight": 1.0, "share": 1 / 3})

#: Oracle tolerance: brownout rung 1 may run default-SLA queries at the
#: bf16 fast tier, so "wrong answer" means wrong beyond the fast tier's
#: bound on these small contractions — checked in MAX norm (elementwise
#: allclose punishes the near-zero entries of a random gaussian
#: contraction for bf16 input rounding that is tiny relative to the
#: result's scale).
TOL = 2e-2


def oracle_ok(got, oracle) -> bool:
    got = np.asarray(got, dtype=np.float64)
    oracle = np.asarray(oracle, dtype=np.float64)
    if got.shape != oracle.shape:
        return False
    scale = max(float(np.max(np.abs(oracle))), 1.0)
    return float(np.max(np.abs(got - oracle))) <= TOL * scale


def _env_f(name, default):
    return float(os.environ.get(name, default))


def _card(device) -> dict:
    """The card's name and power limit (empty off the card)."""
    if device.type != "cuda":
        return {}
    from matrel_tpu_torch.tools.soak import card_line
    return card_line()


def build_pool(sess, rng, register=False):
    """The workload pool: (name, expr, numpy oracle) triples. Small by
    design — a bounded pool keeps the MultiPlan composition space finite
    so steady state is plan-cache-hitting and the harness measures
    ADMISSION, not compilation.

    ``register=True`` (--slices mode) binds the dense tables into the
    session catalog so the fleet can replicate them per slice and key
    the queries into its directory; the sparse / structured operands
    stay unregistered — those queries PIN to the full-mesh span path, so
    the fleet drill exercises both routings."""
    from matrel_tpu_torch.ops import kernel_registry as kr
    from matrel_tpu_torch.workloads.triangles import triangle_count_expr
    n = int(_env_f("MATREL_TRAFFIC_N", 48))
    an = rng.standard_normal((n, n + 16)).astype(np.float32)
    bn = rng.standard_normal((n + 16, n // 2)).astype(np.float32)
    A, B = sess.from_numpy(an), sess.from_numpy(bn)
    if register:
        sess.register("traffic_A", A)
        sess.register("traffic_B", B)
    # dense scaled-matmul class (two variants: distinct plans)
    pool = [
        ("matmul_s2", A.expr().multiply(B.expr()).multiply_scalar(2.0),
         (an @ bn) * 2.0),
        ("matmul_s3", A.expr().multiply(B.expr()).multiply_scalar(3.0),
         (an @ bn) * 3.0),
    ]
    # triangle counting: the full relational stack — trace(A^3) with the
    # diagonal aggregate pushed down
    adj = (rng.random((32, 32)) < 0.3).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.T
    Adj = sess.from_numpy(adj)
    tri = np.array([[np.trace(adj @ adj @ adj)]], dtype=np.float64)
    pool.append(("triangles", triangle_count_expr(Adj), tri))
    # S x S over a synthesized structure class (the kernel registry's
    # shared generator — the sparse serving class)
    S1 = kr.synthesize_structure("row_band", 256, 64, sess.mesh,
                                 seed=0)
    S2 = kr.synthesize_structure("row_band", 256, 64, sess.mesh,
                                 seed=1)
    pool.append(("spgemm_band", S1.expr().multiply(S2.expr()),
                 S1.to_numpy() @ S2.to_numpy()))
    # dashboard-session class (serve/mqo.py): the same scaled Gram shape
    # over DISTINCT small tables. With cse_enable on, the first compiles
    # and inserts a plan template; every sibling rebinds into it
    # (template_hits), so the compile count plateaus at one.
    dn = 24
    for i in range(6):
        d = rng.standard_normal((dn, dn)).astype(np.float32)
        D = sess.from_numpy(d)
        if register:
            sess.register(f"traffic_dash{i}", D)
        pool.append((f"dash_{i}",
                     D.expr().t().multiply(D.expr())
                     .multiply_scalar(0.5),
                     (d.astype(np.float64).T @ d.astype(np.float64))
                     * 0.5))
    return pool


def arrival_schedule(rng, rate_qps, seconds, process):
    """Seeded arrival offsets (seconds from phase start). "poisson" =
    exponential inter-arrivals; "bursty" = Markov-modulated on/off
    (0.5 s phases at 3x / 0.2x the mean rate — same mean load, burstier
    queue dynamics)."""
    out = []
    t = 0.0
    if process == "bursty":
        phase_len, hot = 0.5, True
        phase_end = phase_len
        while t < seconds:
            r = rate_qps * (3.0 if hot else 0.2)
            t += float(rng.exponential(1.0 / max(r, 1e-9)))
            while t > phase_end:
                hot = not hot
                phase_end += phase_len
            if t < seconds:
                out.append(t)
    else:
        while t < seconds:
            t += float(rng.exponential(1.0 / max(rate_qps, 1e-9)))
            if t < seconds:
                out.append(t)
    return out


def _pctile(sorted_vals, q):
    if not sorted_vals:
        return None
    return sorted_vals[min(int(q * len(sorted_vals)),
                           len(sorted_vals) - 1)]


#: Open-loop submit-tick granularity (seconds): arrivals due inside a tick
#: submit back-to-back. A per-arrival sleep at thousands of arrivals/s
#: burns the client's share of the GIL on scheduler churn — time the
#: SERVER needs (client and server share one process here).
TICK_S = 0.005


def drive_phase(sess, pool, schedule, tenants, rng, deadline_ms,
                outcomes, rung_samples, rung_times=None):
    """Submit one phase's arrivals on schedule (open loop: no waiting on
    completions). Tenant / workload assignments are PRE-DRAWN so the hot
    loop is submit-only; the brownout rung is sampled once per tick (and
    with ``rung_times`` given, each sample's (seconds into the phase,
    rung) appended there). Outcomes append into ``outcomes`` as dicts."""
    from matrel_tpu_torch.resilience import errors as rerrors
    names = [t["name"] for t in tenants]
    shares = np.array([t["share"] for t in tenants])
    n = len(schedule)
    tenant_ix = rng.choice(len(names), size=max(n, 1),
                           p=shares / shares.sum())
    pool_ix = rng.integers(0, len(pool), size=max(n, 1))
    ctl = sess._brownout
    t0 = time.perf_counter()
    i = 0
    while i < n:
        now = time.perf_counter() - t0
        if schedule[i] > now:
            time.sleep(min(schedule[i] - now, TICK_S))
            now = time.perf_counter() - t0
        if ctl is not None:
            rung = ctl.rung()
            rung_samples.append(rung)
            if rung_times is not None:
                rung_times.append((now, rung))
        while i < n and schedule[i] <= now:
            tenant = names[int(tenant_ix[i])]
            name, expr, oracle = pool[int(pool_ix[i])]
            rec = {"tenant": tenant, "workload": name,
                   "t": schedule[i], "status": None,
                   "latency_ms": None, "oracle": oracle}
            i += 1
            t_sub = time.perf_counter()
            try:
                fut = sess.submit(expr, tenant=tenant,
                                  deadline_ms=deadline_ms)
            except rerrors.AdmissionShed:
                rec["status"] = "shed"
                outcomes.append(rec)
                continue
            except rerrors.CircuitOpen:
                rec["status"] = "circuit"
                outcomes.append(rec)
                continue

            def _done(f, rec=rec, t_sub=t_sub):
                rec["latency_ms"] = (time.perf_counter() - t_sub) * 1e3
                ex = f.exception()
                if ex is None:
                    rec["status"] = "ok"
                    rec["result"] = f.result()
                elif isinstance(ex, rerrors.DeadlineExceeded):
                    rec["status"] = "deadline"
                elif isinstance(ex, rerrors.AdmissionShed):
                    rec["status"] = "shed"
                elif isinstance(ex, rerrors.CircuitOpen):
                    rec["status"] = "circuit"
                elif isinstance(ex, rerrors.ResilienceError):
                    rec["status"] = "typed"
                else:
                    rec["status"] = "untyped:" + type(ex).__name__
                outcomes.append(rec)

            fut.add_done_callback(_done)
    return time.perf_counter() - t0


def measure_capacity(sess, pool, tenants, cal_n,
                     windows: int = 3) -> float:
    """Closed-loop capacity: one submit-wait client PER TENANT running
    concurrently (each tenant always has exactly one query in the
    system), through the SAME serve path the open-loop phase drives.
    Returns the MINIMUM of ``windows`` runs: window-to-window spread on a
    shared host is scheduling noise, and the goodput criterion is a
    congestion-collapse detector — it compares against the slowest
    capacity the host actually demonstrated. (--slo mode passes
    windows=1: its acceptance is alert behaviour, not goodput, and
    capacity only sets the offered rate.)"""

    def window() -> float:
        per = max(cal_n // len(tenants), 8)
        done = []

        def client(tname, base):
            for i in range(per):
                sess.submit(pool[(base + i) % len(pool)][1],
                            tenant=tname).result(timeout=120)
            done.append(per)

        threads = [threading.Thread(target=client,
                                    args=(t["name"], j), daemon=True)
                   for j, t in enumerate(tenants)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        sess.serve_drain(timeout=60)
        return sum(done) / max(time.perf_counter() - t0, 1e-9)

    return min(window() for _ in range(windows))


# ---------------------------------------------------------------------------
# --slo mode support: endpoint polling + strict Prometheus parsing
# ---------------------------------------------------------------------------

#: Strict text-exposition line grammar (version 0.0.4): metric name,
#: optional {labels}, one float (NaN/inf included). Anything else —
#: including a malformed # comment — fails the poll.
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})?\s"
    r"[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|NaN|[Ii]nf)$")


def prometheus_parse_ok(text: str) -> bool:
    saw_sample = False
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if not re.match(r"^# (TYPE|HELP) [a-zA-Z_:]", line):
                return False
            continue
        if not _PROM_SAMPLE.match(line):
            return False
        saw_sample = True
    return saw_sample


class PrometheusPoller:
    """Background scraper for --slo mode: GETs /metrics (loopback) on an
    interval, strict-parses every response, and tallies failures — the
    'endpoint parses clean THROUGHOUT' half of the acceptance."""

    def __init__(self, port, interval_s=0.4):
        self.url = f"http://127.0.0.1:{port}/metrics"
        self.interval_s = interval_s
        self.polls = 0
        self.parse_failures = 0
        self.errors = 0
        self.last_error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="traffic-prom-poll",
                                        daemon=True)

    def _run(self):
        import urllib.request
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(self.url,
                                            timeout=5) as resp:
                    text = resp.read().decode()
                self.polls += 1
                if not prometheus_parse_ok(text):
                    self.parse_failures += 1
                    self.last_error = "parse failure: " + text[:200]
            except Exception as ex:  # noqa: BLE001 — tallied, the
                # record's ok goes false on any scrape error
                self.errors += 1
                self.last_error = repr(ex)[:200]
            self._stop.wait(self.interval_s)

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _brownout_times(phases):
    """(entered_at_s, exited_at_s): seconds from the first phase's start
    to the first sampled rung >= 1, and to the first rung 0 after it
    (None where it was not sampled). ``phases`` is [(offset_s,
    rung_times)]."""
    trail = [(off + t, r) for off, times in phases for t, r in times]
    entered = next((t for t, r in trail if r >= 1), None)
    exited = (None if entered is None else
              next((t for t, r in trail if t > entered and r == 0), None))
    return entered, exited


def main(slo: bool = False, device="cuda") -> int:
    """The default overload run, or ``slo=True`` for --slo mode; prints
    the record and returns the exit code."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.resilience import faults
    from matrel_tpu_torch.session import MatrelSession

    mesh = mesh_lib.make_mesh((2, 4), device=device)
    seed = int(os.environ.get("MATREL_TRAFFIC_SEED", "0"))
    seconds = _env_f("MATREL_TRAFFIC_SECONDS", 8.0)
    tail_s = _env_f("MATREL_TRAFFIC_TAIL_SECONDS", 4.0)
    rate_x = _env_f("MATREL_TRAFFIC_RATE_X", 2.0)
    cal_n = int(_env_f("MATREL_TRAFFIC_CAL", 300))
    goodput_min = _env_f("MATREL_TRAFFIC_GOODPUT_MIN", 0.8)
    deadline_ms = _env_f("MATREL_TRAFFIC_DEADLINE_MS", 500.0)
    process = os.environ.get("MATREL_TRAFFIC_PROCESS", "poisson")
    faults.reset()
    weights = ",".join(f"{t['name']}:{t['weight']:g}" for t in TENANTS)
    # --slo mode: declare per-tenant availability objectives sized so ~2x
    # overload BURNS them (budget 10%, fire at 3x sustainable
    # consumption), shrink the burn windows to fit the phases, turn the
    # live metrics endpoint + obs event log on, and prove: the violated
    # (lowest-weight) tenant's fast-window alert FIRES during saturation,
    # every alert CLEARS after the load drops, and the Prometheus
    # endpoint parses clean on every poll throughout.
    slo_fast_s = _env_f("MATREL_TRAFFIC_SLO_FAST_S", 1.5)
    slo_kw: dict = {}
    if slo:
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        slo_port = s.getsockname()[1]
        s.close()
        slo_kw = dict(
            obs_level="on",
            obs_metrics_port=slo_port,
            slo_targets=(f"gold:avail=0.9,p95_ms={deadline_ms:g};"
                         f"silver:avail=0.9;bronze:avail=0.9"),
            slo_fast_window_s=slo_fast_s,
            slo_slow_window_s=max(4 * slo_fast_s, seconds + tail_s),
            slo_burn_threshold=3.0,
            slo_burn_exit=1.0,
        )
    # env (MATREL_*) overrides flow over the base config
    cfg = MatrelConfig.from_env(MatrelConfig(
        **slo_kw,
        serve_tenant_weights=weights,
        serve_tenant_queue_max=16,
        serve_queue_max=48,
        # single-query admission: the harness proves the ADMISSION plane
        # — weighted-fair ORDER, quota sheds, brownout, breakers — not
        # batching throughput; MATREL_SERVE_MAX_BATCH widens it
        serve_max_batch=1,
        plan_cache_max_plans=256,
        # plan-template reuse on (serve/mqo.py): the dashboard-session
        # pool class must plateau its compile count
        cse_enable=True,
        brownout_enable=True,
        brownout_window=16,
        brownout_dwell=4,
        brownout_wait_high_ms=max(deadline_ms / 8.0, 20.0),
        brownout_wait_low_ms=max(deadline_ms / 40.0, 4.0),
        brownout_depth_high=24,
        brownout_depth_low=4,
        brownout_miss_high=0.25,
        brownout_miss_low=0.02,
        breaker_threshold=3,
        breaker_cooldown_ms=250.0,
        # The bf16 "fast" tier runs on the card's tensor cores, where the
        # rung-1 downshift is the rate trade it exists for (the JAX tool
        # turns it on on a TPU for the same reason). The CPU has no bf16
        # unit, so there "fast" degrades to f32 (the precision layer's
        # documented semantics) and every control-plane mechanism still
        # exercises.
        precision_enable_bf16=(mesh.device.type == "cuda"),
    ))
    t_session_start = time.time()
    sess = MatrelSession(mesh=mesh, config=cfg)
    poller = None
    try:
        rng = np.random.default_rng(seed)
        pool = build_pool(sess, rng)
        if slo:
            poller = PrometheusPoller(sess._exporter.port)
            poller.start()

        # -- phase 0: prewarm the MultiPlan composition space -----------
        # the worker coalesces up to serve_max_batch queries into one
        # MultiPlan; over a bounded pool that is a bounded set of
        # compositions (both tiers: brownout downshifts default queries
        # onto stamped "fast" variants). Compiling them HERE keeps the
        # measured window measuring admission, not one-time compile cost.
        from itertools import combinations
        from matrel_tpu_torch.resilience.brownout import downshift_stamp
        t_warm = time.perf_counter()
        exprs = [e for _n, e, _o in pool]
        fast = [e.with_attrs(brownout=downshift_stamp()) for e in exprs]
        for k in range(1, int(cfg.serve_max_batch) + 1):
            for combo in combinations(range(len(pool)), k):
                sess.run_many([exprs[i] for i in combo])
                sess.run_many([fast[i] for i in combo], precision="fast")
        warmup_s = time.perf_counter() - t_warm

        # -- phase 1: closed-loop capacity calibration ------------------
        for _name, expr, _o in pool:
            sess.submit(expr).result(timeout=60)
        capacity_pre = measure_capacity(sess, pool, TENANTS, cal_n,
                                        windows=(1 if slo else 3))

        # -- phase 2: open-loop overload --------------------------------
        outcomes: list = []
        rung_samples: list = []
        over_times: list = []
        tail_times: list = []
        rate = rate_x * capacity_pre
        sched = arrival_schedule(rng, rate, seconds, process)
        t_overload_wall = time.time()
        t_overload = time.perf_counter()
        wall = drive_phase(sess, pool, sched, TENANTS, rng, deadline_ms,
                           outcomes, rung_samples, over_times)
        t_overload_end_wall = time.time()
        overload_n = len(outcomes) + 0   # marker index: overload arrivals
        overload_sched = len(sched)
        max_rung_mid = (sess._brownout.snapshot()["max_rung_seen"]
                        if sess._brownout else 0)

        # -- phase 3: cool-down tail (the brownout EXIT proof) ----------
        tail_outcomes: list = []
        tail_sched = arrival_schedule(rng, 0.15 * capacity_pre, tail_s,
                                      "poisson")
        t_tail = time.perf_counter()
        drive_phase(sess, pool, tail_sched, TENANTS, rng,
                    deadline_ms * 4, tail_outcomes, rung_samples,
                    tail_times)
        try:
            sess.serve_drain(timeout=60.0)
        except Exception as ex:  # noqa: BLE001 — tallied as a failure
            print(f"# DRAIN FAILED: {ex!r}", file=sys.stderr)
        time.sleep(0.2)          # let the last done-callbacks land
        if slo:
            # let the fast burn window slide past the last bad event so
            # the CLEAR transition provably happens (the worker's idle
            # tick evaluates the monitors while the queue is empty);
            # goodput is not this mode's acceptance, so the post capacity
            # window is skipped and the denominator is the pre number
            time.sleep(slo_fast_s + 1.0)
            capacity_post = capacity_pre
        else:
            # post-phase capacity window: the goodput denominator is the
            # MIN of the bracketing measurements, so host slowdown cannot
            # masquerade as congestion collapse (or mask a real one)
            capacity_post = measure_capacity(sess, pool, TENANTS, cal_n)
        capacity_qps = min(capacity_pre, capacity_post)
        snap = sess._brownout.snapshot() if sess._brownout else {}
        brownout_entered = snap.get("max_rung_seen", 0) >= 1
        brownout_exited = brownout_entered and snap.get("rung", 0) == 0
        entered_at, exited_at = _brownout_times(
            [(0.0, over_times), (t_tail - t_overload, tail_times)])

        # -- tally --------------------------------------------------------
        wrong = untyped = 0
        per_tenant: dict = {t["name"]: {
            "weight": t["weight"], "arrivals": 0, "ok": 0, "sheds": 0,
            "deadline_misses": 0, "circuit": 0, "latencies": []}
            for t in TENANTS}
        for rec in outcomes:
            row = per_tenant[rec["tenant"]]
            row["arrivals"] += 1
            st = rec["status"]
            if st == "ok":
                row["ok"] += 1
                if rec["latency_ms"] is not None:
                    row["latencies"].append(rec["latency_ms"])
                if not oracle_ok(rec.pop("result").to_numpy(),
                                 rec["oracle"]):
                    wrong += 1
            elif st == "shed":
                row["sheds"] += 1
            elif st == "deadline":
                row["deadline_misses"] += 1
            elif st == "circuit":
                row["circuit"] += 1
            elif st is None or st.startswith("untyped"):
                untyped += 1
        for rec in tail_outcomes:         # tail: correctness checked only
            if rec["status"] == "ok":
                if not oracle_ok(rec.pop("result").to_numpy(),
                                 rec["oracle"]):
                    wrong += 1
            elif (rec["status"] is None
                  or str(rec["status"]).startswith("untyped")):
                untyped += 1

        tenant_rows: dict = {}
        p99_within_deadline = True
        for name, row in per_tenant.items():
            lat = sorted(row["latencies"])
            arr = row["arrivals"]
            missed = row["sheds"] + row["deadline_misses"] + row["circuit"]
            p99 = _pctile(lat, 0.99)
            if p99 is not None and p99 > deadline_ms * 1.05:
                p99_within_deadline = False
            tenant_rows[name] = {
                "weight": row["weight"],
                "arrivals": arr,
                "ok": row["ok"],
                "sheds": row["sheds"],
                "deadline_misses": row["deadline_misses"],
                "circuit_open": row["circuit"],
                "miss_rate": round(missed / arr, 4) if arr else None,
                "goodput_qps": round(row["ok"] / max(wall, 1e-9), 2),
                "p50_ms": _pctile(lat, 0.50),
                "p95_ms": _pctile(lat, 0.95),
                "p99_ms": p99,
            }
        total_ok = sum(r["ok"] for r in tenant_rows.values())
        goodput_qps = total_ok / max(wall, 1e-9)
        goodput_ratio = goodput_qps / max(capacity_qps, 1e-9)
        # Jain fairness over weight-normalised goodput: (Σx)²/(n·Σx²)
        xs = [r["goodput_qps"] / r["weight"] for r in tenant_rows.values()]
        jain = (sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs))
                if any(xs) else 0.0)
        rung_census: dict = {}
        for r in rung_samples:
            rung_census[str(r)] = rung_census.get(str(r), 0) + 1
        miss_hi = tenant_rows["gold"]["miss_rate"] or 0.0
        miss_lo = tenant_rows["bronze"]["miss_rate"] or 0.0
        # compile-count plateau over the dashboard class: 6 dash_* pool
        # entries (+ their brownout-stamped "fast" twins) share one
        # structure each way, so at most 2 of the 12 first contacts pay
        # optimize/trace — every other lands as a template rebind. >= 5
        # hits proves the plateau held under the open-loop stream.
        mqo = sess.mqo_info()
        mqo_plateau = int(mqo.get("template_hits", 0)) >= 5
        card = _card(mesh.device)

        if slo:
            # -- slo-mode verdict: alert fired during saturation, cleared
            # after, endpoint clean throughout, zero wrong answers -------
            poller.stop()
            from matrel_tpu_torch.obs.events import read_events, \
                resolve_path
            plane = sess._slo.snapshot()
            al = [e for e in read_events(resolve_path(cfg.obs_event_log),
                                         kinds=("alert",))
                  if (e.get("ts") or 0) >= t_session_start]
            fired = [e for e in al if e.get("state") == "firing"]
            # the violated tenant: bronze is weight-lowest — quota sheds,
            # rung-3 brownout sheds and deadline misses all land on it
            # first; its alert must fire DURING the overload phase (one
            # fast window of detection latency allowed)
            bronze_fired_in_window = any(
                e.get("tenant") == "bronze"
                and e.get("objective") == "avail"
                and (t_overload_wall - 1.0 <= (e.get("ts") or 0)
                     <= t_overload_end_wall + slo_fast_s + 1.0)
                for e in fired)
            last_state: dict = {}
            for e in al:
                last_state[(str(e.get("tenant")),
                            str(e.get("objective")))] = e.get("state")
            uncleared = sorted(f"{t}:{o}"
                               for (t, o), st in last_state.items()
                               if st == "firing")
            # seconds from the overload phase's start to the violated
            # tenant's first firing and to the last clear
            fired_at = min(((e.get("ts") or 0) - t_overload_wall
                            for e in fired if e.get("tenant") == "bronze"),
                           default=None)
            cleared_at = max(((e.get("ts") or 0) - t_overload_wall
                              for e in al if e.get("state") == "clear"),
                             default=None)
            prom_ok = (poller.polls > 0 and poller.parse_failures == 0
                       and poller.errors == 0)
            record = {
                "metric": "traffic_slo_harness",
                "seed": seed,
                "process": process,
                "backend": mesh.device.type,
                **card,
                "slo_targets": cfg.slo_targets,
                "windows_s": [cfg.slo_fast_window_s,
                              cfg.slo_slow_window_s],
                "burn_threshold": cfg.slo_burn_threshold,
                "burn_exit": cfg.slo_burn_exit,
                "capacity_qps_closed_loop": round(capacity_qps, 2),
                "offered_qps": round(rate, 2),
                "arrivals": overload_sched,
                "alert_events": len(al),
                "alerts_fired": len(fired),
                "alerts_cleared": sum(1 for e in al
                                      if e.get("state") == "clear"),
                "fired_objectives": sorted(
                    {f"{e.get('tenant')}:{e.get('objective')}"
                     for e in fired}),
                "violated_tenant_fired_in_window":
                    bronze_fired_in_window,
                "violated_fired_at_s": fired_at,
                "last_clear_at_s": cleared_at,
                "uncleared": uncleared,
                "alerts_active_final": plane["alerts_active"],
                "tenants": {t: {"miss_rate": r["miss_rate"],
                                "arrivals": r["arrivals"],
                                "sheds": r["sheds"]}
                            for t, r in tenant_rows.items()},
                "prometheus": {"polls": poller.polls,
                               "parse_failures": poller.parse_failures,
                               "errors": poller.errors,
                               "last_error": poller.last_error,
                               "ok": prom_ok},
                "brownout": {"entered": brownout_entered,
                             "exited": brownout_exited,
                             "max_rung": snap.get("max_rung_seen", 0),
                             "entered_at_s": entered_at,
                             "exited_at_s": exited_at},
                "wrong_answers": wrong,
                "untyped_errors": untyped,
            }
            record["ok"] = bool(
                bronze_fired_in_window
                and fired
                and not uncleared
                and plane["alerts_active"] == 0
                and prom_ok
                and wrong == 0
                and untyped == 0)
            print(json.dumps(record))
            return 0 if record["ok"] else 1

        record = {
            "metric": "traffic_overload_harness",
            "seed": seed,
            "process": process,
            "backend": mesh.device.type,
            **card,
            "warmup_s": round(warmup_s, 2),
            "capacity_qps_closed_loop": round(capacity_qps, 2),
            "capacity_qps_pre": round(capacity_pre, 2),
            "capacity_qps_post": round(capacity_post, 2),
            "offered_rate_x": rate_x,
            "offered_qps": round(rate, 2),
            "overload_seconds": round(wall, 2),
            "arrivals": overload_sched,
            "submitted": overload_n,
            "tenants": tenant_rows,
            "goodput_qps": round(goodput_qps, 2),
            "goodput_ratio": round(goodput_ratio, 3),
            "fairness_jain": round(jain, 4),
            "wrong_answers": wrong,
            "untyped_errors": untyped,
            "deadline_ms": deadline_ms,
            "p99_within_deadline": p99_within_deadline,
            "brownout": {"entered": brownout_entered,
                         "exited": brownout_exited,
                         "entered_at_s": entered_at,
                         "exited_at_s": exited_at,
                         "max_rung": snap.get("max_rung_seen", 0),
                         "max_rung_overload": max_rung_mid,
                         "final_rung": snap.get("rung"),
                         "rung_census": rung_census},
            "breakers": (sess._breakers.snapshot()
                         if sess._breakers else None),
            "queue": sess._serve._q.counters() if sess._serve else {},
            "mqo": {"templates": mqo.get("templates", 0),
                    "template_hits": mqo.get("template_hits", 0),
                    "template_inserts": mqo.get("template_inserts", 0),
                    "plateau": mqo_plateau},
        }
        record["ok"] = bool(
            wrong == 0
            and untyped == 0
            and goodput_ratio >= goodput_min
            and p99_within_deadline
            and miss_hi < miss_lo
            and brownout_entered
            and brownout_exited
            and mqo_plateau
            and 0.0 < jain <= 1.0)
        print(json.dumps(record))
        return 0 if record["ok"] else 1
    finally:
        if poller is not None:
            poller.stop()
        sess.serve_close(timeout=60)


def main_slices(device="cuda") -> int:
    """--slices mode: the SAME open-loop machinery driven through a
    MULTI-SLICE fleet, with a mid-stream slice kill. The acceptance is the
    fleet plane's, not the overload plane's:

      - both slices serve traffic before the kill (placement spreads the
        stream) and the directory answers repeats from wherever
        placement lands them (>= 1 directory hit);
      - pool entries over unregistered operands PIN to the span path —
        both routings exercise under open-loop fire;
      - slice 0 is killed at the phase midpoint: the stream completes
        with ZERO wrong answers (every completed result checked against
        its numpy oracle) and only TYPED failures, queued entries
        re-admitted with deadlines / tenants intact.

    Prints one ``traffic_fleet_harness`` JSON line."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.resilience import faults
    from matrel_tpu_torch.session import MatrelSession

    mesh = mesh_lib.make_mesh((2, 4), device=device)
    seed = int(os.environ.get("MATREL_TRAFFIC_SEED", "0"))
    seconds = _env_f("MATREL_TRAFFIC_SECONDS", 8.0)
    rate_x = _env_f("MATREL_TRAFFIC_RATE_X", 2.0)
    cal_n = int(_env_f("MATREL_TRAFFIC_CAL", 300))
    deadline_ms = _env_f("MATREL_TRAFFIC_DEADLINE_MS", 500.0)
    n_slices = int(_env_f("MATREL_TRAFFIC_SLICES", 2))
    process = os.environ.get("MATREL_TRAFFIC_PROCESS", "poisson")
    faults.reset()
    cfg = MatrelConfig.from_env(MatrelConfig(
        fleet_slices=n_slices,
        result_cache_max_bytes=1 << 28,
        serve_max_batch=1,       # the admission discipline of main()
        serve_queue_max=96,
        plan_cache_max_plans=256,
    ))
    sess = MatrelSession(mesh=mesh, config=cfg)
    try:
        rng = np.random.default_rng(seed)
        pool = build_pool(sess, rng, register=True)
        # prewarm: builds the fleet (replicating the registered tables),
        # compiles each pool entry once per routing
        for _name, expr, _o in pool:
            sess.submit(expr).result(timeout=120)
        sess.serve_drain(timeout=60)
        capacity = measure_capacity(sess, pool, TENANTS, cal_n,
                                    windows=1)
        rate = rate_x * capacity
        outcomes: list = []
        rungs: list = []
        half = max(seconds / 2.0, 0.5)
        wall = drive_phase(sess, pool,
                           arrival_schedule(rng, rate, half, process),
                           TENANTS, rng, deadline_ms, outcomes, rungs)
        placed_before = {sl["id"]: sl["submitted"]
                         for sl in sess.fleet_info()["slices"]}
        requeued = sess._fleet.kill_slice(0, reason="traffic_drill")
        wall += drive_phase(sess, pool,
                            arrival_schedule(rng, rate, half, process),
                            TENANTS, rng, deadline_ms, outcomes, rungs)
        try:
            sess.serve_drain(timeout=60.0)
        except Exception as ex:  # noqa: BLE001 — tallied below, typed
            print(f"# DRAIN FAILED: {ex!r}", file=sys.stderr)
        time.sleep(0.2)          # let the last done-callbacks land
        ok_n = wrong = untyped = sheds = deadlines = typed = 0
        for rec in outcomes:
            st = rec["status"]
            if st == "ok":
                if oracle_ok(rec.pop("result").to_numpy(),
                             rec["oracle"]):
                    ok_n += 1
                else:
                    wrong += 1
            elif st == "shed":
                sheds += 1
            elif st == "deadline":
                deadlines += 1
            elif st in ("circuit", "typed"):
                typed += 1
            elif st is None or str(st).startswith("untyped"):
                untyped += 1
        info = sess.fleet_info()
    finally:
        sess.serve_close(timeout=60)
    record = {
        "metric": "traffic_fleet_harness",
        "seed": seed,
        "process": process,
        "backend": mesh.device.type,
        **_card(mesh.device),
        "slices": n_slices,
        "capacity_qps_closed_loop": round(capacity, 2),
        "offered_qps": round(rate, 2),
        "overload_seconds": round(wall, 2),
        "submitted": len(outcomes),
        "ok": None,           # verdict filled below
        "completed": ok_n,
        "wrong_answers": wrong,
        "untyped_errors": untyped,
        "sheds": sheds,
        "deadline_misses": deadlines,
        "other_typed": typed,
        "goodput_qps": round(ok_n / max(wall, 1e-9), 2),
        "placed": info["placed"],
        "pinned": info["pinned"],
        "directory": info["directory"],
        "failovers": info["failovers"],
        "requeued_on_kill": requeued,
        "slices_served_before_kill": sorted(
            sid for sid, n in placed_before.items() if n > 0),
        "slice_state": [{"id": sl["id"], "alive": sl["alive"],
                         "submitted": sl["submitted"]}
                        for sl in info["slices"]],
    }
    record["ok"] = bool(
        wrong == 0
        and untyped == 0
        and ok_n > 0
        and info["failovers"] == 1
        and len(record["slices_served_before_kill"]) >= 2
        and info["directory"]["hits"] >= 1
        and info["placed"]["slice"] > 0
        and info["placed"]["span"] > 0)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.traffic",
        description="open-loop traffic harness of the PyTorch port")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--slo", action="store_true",
                      help="the alerting loop under declared objectives")
    mode.add_argument("--slices", action="store_true",
                      help="a multi-slice fleet with a mid-stream kill")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.slices:
        return main_slices(args.device)
    return main(slo=args.slo, device=args.device)


if __name__ == "__main__":
    sys.exit(cli())
