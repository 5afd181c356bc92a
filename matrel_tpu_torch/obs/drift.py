"""Cost-model drift auditor — the counterpart of ``matrel_tpu/obs/drift.py``.

Joins each matmul decision's estimated weighted bytes/FLOPs
(``planner.matmul_decisions`` — in every query and ``analyze`` event)
against measured per-op milliseconds (``explain(analyze=True)``'s
per-op tree, and single-matmul queries' ``execute_ms``), maintains
per-(strategy, shape-class, backend) calibration ratios in a JSON
table, and flags strategy pairs whose ESTIMATED rank-order disagrees
with MEASURED rank-order.

The ``backend`` of every sample is the port's own device type — the
query and analyze records say ``"cuda"`` on the card and ``"cpu"`` in
the tests, never ``"tpu"`` — so an H100 row never calibrates, or is
read by, a TPU row. The table format is the JAX package's: either
package reads and merges the other's table.

Shape classes are power-of-two buckets of max(n, k, m) — the autotune
table's granularity, so a calibration ratio and an autotune row
describe the same population.

A ``query`` record whose ``execute_clock`` is ``"host"`` (a CUDA
query: the span times the launch, never the kernel — no span syncs the
device) is not a measurement of the product and is not sampled; the
CPU's synchronous runs and every ``analyze`` record are.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Dict, List

_log = logging.getLogger("matrel_tpu_torch.obs")

#: Table schema version (bump on reader-visible change, like events.py).
TABLE_SCHEMA = 1

#: Default table name — lives beside .matrel_autotune.json by the same
#: cwd-relative convention.
DEFAULT_TABLE = ".matrel_drift.json"

#: Measured must be at least this multiple SLOWER than a higher-
#: estimate alternative before the rank-order flag fires: estimates
#: are models and measurements are noisy; a bare inversion inside the
#: noise band would flag every near-tie.
RANK_FLAG_MARGIN = 1.25

#: Bounded per-key ratio memory in the persisted table (the metrics
#: registry's reservoir discipline: aggregatable, never unbounded).
_RECENT_MAX = 32


def table_path(config=None) -> str:
    """Config value → concrete path ('' → the default name)."""
    if config is None:
        from matrel_tpu_torch.config import default_config
        config = default_config()
    return config.drift_table_path or DEFAULT_TABLE


def shape_class(dims) -> str:
    """Power-of-two bucket of max(n, k, m) — '<=1024' style classes so
    a 900×1000×1024 and a 1024³ multiply calibrate together (the
    autotune table's side-bucket granularity)."""
    top = max(int(d) for d in dims) if dims else 1
    return f"<={1 << max(0, math.ceil(math.log2(max(top, 1))))}"


def _strategy_key(d: dict) -> str:
    """Decision record → calibration strategy name. Pure-strategy
    matmuls use the stamped strategy; sparse/COO dispatches (which
    bypass the byte model) audit under their dispatch name so SpGEMM's
    est_saved_flops drift is visible without polluting strategy rows.

    A stamped precision tier joins the key (``rmm@bf16x3``): tiered
    passes retire MACs at a different tensor-core rate, so a bf16 ms_per_gflop
    blended into the f32 row — or a bf16 sample ranked against an f32
    one — would poison both the calibration and the rank-order flags.
    Untier records keep the historical bare-strategy key, so existing
    persisted tables merge unchanged. SpGEMM dispatches with a
    registry kernel stamp calibrate PER KERNEL (``spgemm:<kernel_id>``
    rows): the specialized variants retire the same estimated
    FLOPs/bytes at deliberately different rates, so one blended
    ``dispatch:spgemm`` row would mask exactly the per-kernel drift
    the registry's cost model needs audited; un-stamped spgemm
    records (pre-registry logs) keep the historical key.

    A fused-region anchor calibrates under ``fused:<region_sig>`` (the
    ``spgemm:<kernel_id>`` precedent): the region's measured ms covers
    the anchor PLUS its absorbed members, so blending it into the bare
    strategy row would drift every per-strategy flag by the epilogue's
    cost — and a miscalibrated fused estimate must be visible as a
    fused row, not as a poisoned strategy row."""
    if d.get("fused_region"):
        key = f"fused:{d['fused_region']}"
    elif d.get("dispatch") == "spgemm" and d.get("kernel_id"):
        key = f"spgemm:{d['kernel_id']}"
    elif d.get("dispatch"):
        key = f"dispatch:{d['dispatch']}"
    else:
        key = d.get("strategy", "?")
    tier = d.get("precision_tier")
    if tier:
        key += f"@{tier}"
    return key


def _est_bytes(d: dict):
    """The quantity the planner's ranking actually minimised for this
    decision: weighted cost on a non-uniform mesh, raw ICI bytes
    otherwise. None for dispatch records (no byte model)."""
    w = d.get("est_weighted_cost")
    if isinstance(w, (int, float)):
        return float(w)
    b = d.get("est_ici_bytes")
    return float(b) if isinstance(b, (int, float)) else None


def iter_samples(events: List[dict]):
    """(strategy, shape_class, backend, flops, est_bytes, measured_ms,
    source) samples from an event log.

    Two measurement sources, in decreasing fidelity:
    - ``analyze`` records: per-op EXCLUSIVE milliseconds joined to the
      decision by uid — the matmul's own time.
    - single-matmul ``query`` records: execute_ms attributed to the one
      matmul (includes pipeline overhead; still rank-usable within a
      backend). Batched roots and rc hits are excluded — their
      execute_ms is amortised/zero by construction.
    """
    for e in events:
        kind = e.get("kind")
        backend = e.get("backend") or "?"
        if kind == "analyze":
            per_op = {p.get("uid"): p for p in (e.get("per_op") or ())
                      if isinstance(p, dict)}
            # fused regions report ONE row at the region root with the
            # member uids listed (the ghost-row fix): an anchor matmul
            # absorbed into a region joins its decision to the region
            # row by MEMBERSHIP, so the fused:<sig> calibration row
            # gets the region's measured ms
            member_row = {}
            for p in per_op.values():
                for u in p.get("members") or ():
                    member_row[u] = p
            for d in e.get("matmuls") or ():
                op = per_op.get(d.get("uid"))
                if op is None and d.get("fused_region"):
                    op = member_row.get(d.get("uid"))
                if op is None or not isinstance(op.get("ms"),
                                                (int, float)):
                    continue
                yield _sample(d, float(op["ms"]), backend, "analyze")
        elif kind == "query":
            mm = e.get("matmuls") or ()
            ms = e.get("execute_ms")
            if (len(mm) == 1 and e.get("cache") != "rc_hit"
                    and not e.get("batch")
                    and e.get("execute_clock") != "host"
                    and isinstance(ms, (int, float)) and ms > 0):
                yield _sample(mm[0], float(ms), backend, "query")
        elif kind == "bench" and e.get("metric") == "reshard_sweep":
            # reshard_sweep bench rows: both lowerings of each src->dst
            # move, measured with their modelled bytes — the
            # ``reshard:<kind>`` ms/MiB calibration rows, and the
            # population rank_flags compares so a reshard model whose
            # preferred lowering measures >= RANK_FLAG_MARGIN slower
            # raises a DRIFT flag like any miscalibrated strategy
            for row in e.get("rows") or ():
                if not isinstance(row, dict):
                    continue
                n = row.get("n")
                for variant, bytes_key, ms_key in (
                        (f"reshard:{row.get('kind', 'staged')}",
                         "staged_bytes", "staged_ms"),
                        ("reshard:oneshot", "naive_bytes", "naive_ms")):
                    b, ms = row.get(bytes_key), row.get(ms_key)
                    if not (isinstance(b, (int, float)) and b > 0
                            and isinstance(ms, (int, float)) and ms > 0):
                        continue
                    yield {"strategy": variant,
                           "class": shape_class([n] if n else ()),
                           "backend": backend, "tier": "",
                           "flops": 0.0, "est_bytes": float(b),
                           "ms": float(ms), "source": "bench"}
        elif kind == "spill":
            # live spill events (session._emit_spill_event): each
            # demotion/promotion records its priced transfer legs with
            # measured ms — the ``spill:<leg>`` ms/MiB calibration rows
            # the coefficient seam (coeffs.spill_leg_row) serves back
            # to the next pricing decision, closing the same loop the
            # reshard rows ride
            dims = e.get("dims") or ()
            for leg in e.get("legs") or ():
                if not isinstance(leg, dict):
                    continue
                name = leg.get("leg")
                b, ms = leg.get("bytes"), leg.get("ms")
                if not (name and isinstance(b, (int, float)) and b > 0
                        and isinstance(ms, (int, float)) and ms > 0):
                    continue
                yield {"strategy": f"spill:{name}",
                       "class": shape_class(dims),
                       "backend": backend, "tier": "",
                       "flops": 0.0, "est_bytes": float(b),
                       "ms": float(ms), "source": "spill"}
        elif kind == "bench" and e.get("metric") == "spill_sweep":
            # spill_sweep bench rows: per-leg transfer timings at
            # controlled sizes — the seeded calibration a fresh table
            # starts from (the reshard_sweep precedent)
            for row in e.get("rows") or ():
                if not isinstance(row, dict):
                    continue
                name, n = row.get("leg"), row.get("n")
                b, ms = row.get("bytes"), row.get("ms")
                if not (name and isinstance(b, (int, float)) and b > 0
                        and isinstance(ms, (int, float)) and ms > 0):
                    continue
                yield {"strategy": f"spill:{name}",
                       "class": shape_class([n] if n else ()),
                       "backend": backend, "tier": "",
                       "flops": 0.0, "est_bytes": float(b),
                       "ms": float(ms), "source": "bench"}


def _sample(d: dict, ms: float, backend: str, source: str) -> dict:
    return {"strategy": _strategy_key(d),
            "class": shape_class(d.get("dims") or ()),
            "backend": backend,
            # the tier is ALSO a population dimension of its own:
            # rank_flags groups on it, so a bf16 sample is never
            # rank-compared against an f32 one (their ms/byte ratios
            # differ by the tensor-core-rate gap, not by model drift)
            "tier": d.get("precision_tier") or "",
            "flops": float(d.get("flops") or 0.0),
            "est_bytes": _est_bytes(d),
            "ms": ms,
            "source": source}


def _median(vals: List[float]):
    if not vals:
        return None
    s = sorted(vals)
    return s[len(s) // 2]


def calibrate(samples: List[dict]) -> Dict[str, dict]:
    """Per-(strategy, shape-class, backend) calibration rows:

    - ``ms_per_gflop``: median measured ms per estimated GFLOP — the
      compute-side calibration (a strategy whose ratio drifts up is
      losing compute efficiency the FLOPs model can't see).
    - ``ms_per_est_mib``: median measured ms per estimated MiB moved —
      the comm-side calibration (None when the model estimated zero
      bytes, e.g. replicated-operand bmm). Divergence ACROSS strategies
      in one class is the drift signal: the model prices their bytes on
      one scale, so honest estimates give similar ratios.
    """
    acc: Dict[str, dict] = {}
    for s in samples:
        key = f"{s['strategy']}|{s['class']}|{s['backend']}"
        row = acc.setdefault(key, {"strategy": s["strategy"],
                                   "class": s["class"],
                                   "backend": s["backend"],
                                   "count": 0, "_gf": [], "_mib": [],
                                   "_ms": []})
        row["count"] += 1
        row["_ms"].append(s["ms"])
        if s["flops"] > 0:
            row["_gf"].append(s["ms"] / (s["flops"] / 1e9))
        eb = s["est_bytes"]
        if eb is not None and eb > 0:
            row["_mib"].append(s["ms"] / (eb / 2 ** 20))
    for row in acc.values():
        row["ms_median"] = round(_median(row.pop("_ms")), 4)
        gf = _median(row.pop("_gf"))
        mib = _median(row.pop("_mib"))
        row["ms_per_gflop"] = round(gf, 5) if gf is not None else None
        row["ms_per_est_mib"] = (round(mib, 5) if mib is not None
                                 else None)
    return acc


def rank_flags(samples: List[dict]) -> List[dict]:
    """Strategy pairs whose estimated and measured rank-orders
    DISAGREE within one (shape-class, backend) population: the model
    estimated strictly fewer bytes for A than B, but A measured at
    least RANK_FLAG_MARGIN× slower."""
    groups: Dict[tuple, Dict[str, dict]] = {}
    for s in samples:
        if s["est_bytes"] is None:
            continue            # dispatch records have no byte ranking
        if s["strategy"].startswith("spill:"):
            # transfer legs are PRICED, never RANKED: the tier a value
            # ages to is fixed by adjacency, so "the model preferred
            # d2h over rmm" is not a choice anything makes — a disk
            # leg's honest 25x ms/MiB would flag as drift forever
            continue
        # tier joins the population key: rank-order is only meaningful
        # between strategies executing at the SAME precision tier
        g = groups.setdefault(
            (s["class"], s["backend"], s.get("tier") or ""), {})
        row = g.setdefault(s["strategy"], {"_ms": [], "_est": []})
        row["_ms"].append(s["ms"])
        row["_est"].append(s["est_bytes"])
    flags: List[dict] = []
    for (cls, backend, _tier), g in sorted(groups.items()):
        if len(g) < 2:
            continue
        meds = {name: (_median(row["_est"]), _median(row["_ms"]),
                       len(row["_ms"]))
                for name, row in g.items()}
        names = sorted(meds)
        for a in names:
            for b in names:
                if a == b:
                    continue
                est_a, ms_a, n_a = meds[a]
                est_b, ms_b, n_b = meds[b]
                if (est_a < est_b and ms_b > 0
                        and ms_a >= RANK_FLAG_MARGIN * ms_b):
                    flags.append({
                        "class": cls, "backend": backend,
                        "model_prefers": a, "measured_prefers": b,
                        "est_bytes": [est_a, est_b],
                        "measured_ms": [round(ms_a, 4),
                                        round(ms_b, 4)],
                        "samples": [n_a, n_b],
                        "slowdown": round(ms_a / ms_b, 2),
                    })
    return flags


# ---------------------------------------------------------------------------
# Persistence — the calibration table next to the autotune tables
# ---------------------------------------------------------------------------


def load_table(path: str) -> dict:
    """Persisted table or a fresh empty one. Corrupt/absent/foreign-
    schema files read as empty (the autotune load_table contract); a
    CORRUPT file additionally warns — the robust-reader discipline:
    never crash the session over an auxiliary
    artifact, never silently eat one either."""
    try:
        with open(path) as f:
            t = json.load(f)
    except OSError:
        t = None              # absent: the normal first-run case
    except ValueError as e:
        _log.warning("drift table %s is corrupt (%s); rebuilding "
                     "from empty", path, e)
        t = None
    else:
        if (not isinstance(t, dict)
                or t.get("schema") != TABLE_SCHEMA
                or not isinstance(t.get("entries"), dict)):
            _log.warning("drift table %s has unexpected shape/schema; "
                         "rebuilding from empty", path)
            t = None
    if t is None:
        return {"schema": TABLE_SCHEMA, "entries": {}}
    return t


def update_table(path: str, calib: Dict[str, dict]) -> dict:
    """Merge one log's calibration rows into the persisted table
    (count-weighted blend of the ratios, bounded recent-ratio memory)
    and rewrite it atomically. Always writes — an empty log still
    stamps ``updated``, so the table stays a parseable artifact either
    way."""
    table = load_table(path)
    entries = table["entries"]
    for key, row in calib.items():
        old = entries.get(key)
        new = {k: row[k] for k in ("strategy", "class", "backend",
                                   "count", "ms_median",
                                   "ms_per_gflop", "ms_per_est_mib")}
        if old is not None:
            n_old = int(old.get("count") or 0)
            n_new = row["count"]
            for f in ("ms_per_gflop", "ms_per_est_mib"):
                ov, nv = old.get(f), row[f]
                if ov is not None and nv is not None:
                    new[f] = round((ov * n_old + nv * n_new)
                                   / max(n_old + n_new, 1), 5)
                elif nv is None:
                    new[f] = ov
            new["count"] = n_old + n_new
            recent = list(old.get("recent") or [])
        else:
            recent = []
        if row["ms_per_gflop"] is not None:
            recent.append(row["ms_per_gflop"])
        new["recent"] = recent[-_RECENT_MAX:]
        entries[key] = new
    table["updated"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1)
    os.replace(tmp, path)
    return table


# ---------------------------------------------------------------------------
# Report — `history --drift`
# ---------------------------------------------------------------------------


def report(events: List[dict],
           table_path_str: Optional[str] = None,
           persist: bool = True) -> str:
    """The drift-audit text: calibration rows, rank-order flags, and
    (when ``persist``) the table merge."""
    return audit(events, table_path_str, persist)[0]


def audit(events: List[dict],
          table_path_str: Optional[str] = None,
          persist: bool = True):
    """(report text, rank-order flags) — the machine-checkable face of
    the drift audit: ``history --drift --check`` exits nonzero when
    any flag fired, so a CI gate reads cost-model drift instead of a
    human reading the table."""
    samples = list(iter_samples(events))
    calib = calibrate(samples)
    flags = rank_flags(samples)
    lines = [f"drift audit: {len(samples)} sample(s) "
             f"({sum(1 for s in samples if s['source'] == 'analyze')} "
             f"analyze, "
             f"{sum(1 for s in samples if s['source'] == 'query')} "
             f"query) -> {len(calib)} calibration row(s)"]
    if calib:
        header = (f"{'strategy':<18}{'class':<10}{'backend':<9}"
                  f"{'n':>4}{'med ms':>10}{'ms/GFLOP':>12}"
                  f"{'ms/est MiB':>12}")
        lines += ["", header, "-" * len(header)]
        for key in sorted(calib):
            r = calib[key]
            lines.append(
                f"{r['strategy']:<18}{r['class']:<10}"
                f"{r['backend']:<9}{r['count']:>4}"
                f"{r['ms_median']:>10.3f}"
                + (f"{r['ms_per_gflop']:>12.4f}"
                   if r["ms_per_gflop"] is not None else f"{'-':>12}")
                + (f"{r['ms_per_est_mib']:>12.4f}"
                   if r["ms_per_est_mib"] is not None
                   else f"{'-':>12}"))
    if flags:
        lines.append("")
        for fl in flags:
            lines.append(
                f"DRIFT {fl['class']} {fl['backend']}: model prefers "
                f"{fl['model_prefers']} "
                f"(est {fl['est_bytes'][0]:.3g} < "
                f"{fl['est_bytes'][1]:.3g} bytes) but it measured "
                f"{fl['slowdown']}x slower than "
                f"{fl['measured_prefers']} "
                f"({fl['measured_ms'][0]} vs {fl['measured_ms'][1]} "
                f"ms; n={fl['samples']})")
    else:
        lines.append("rank-order: estimates agree with measurement "
                     "(no flags)")
    if persist:
        path = table_path_str or table_path()
        try:
            table = update_table(path, calib)
            lines.append(f"calibration table: {path} "
                         f"({len(table['entries'])} entries)")
        except OSError as e:     # auditing must not fail on a bad disk
            lines.append(f"calibration table NOT persisted: {e}")
    return "\n".join(lines), flags
