"""Measured per-op plan analysis — ``session.explain(expr, analyze=True)``;
the counterpart of ``matrel_tpu/obs/analyze.py``.

How it measures: the compiled plan's optimized tree is lowered a second
time with the executor's ``op_hook`` installed and run once — each
physical node is bracketed by a device sync (``torch.cuda.synchronize``
on a CUDA plan; the CPU runs synchronously) and wall-clocked EXCLUSIVE
of its children. A fused region (``ir/fusion.py``) is one node, timed
at its root. Per-op times with a sync between every node do not sum to
the normal run — the syncs serialise what the device would overlap and
add their own gaps — so one warm run of the plan as the session runs it
(fused regions included) is measured too and printed alongside; neither
number corrects the other. Strictly off the hot path: nothing here runs,
and no sync happens, unless analysis was explicitly requested.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def backend_of(plan) -> str:
    """The device type the plan's tensors live on ("cuda" / "cpu") —
    read from a leaf tensor, else from the plan's mesh."""
    for l in plan.leaf_order:
        data = getattr(l.attrs.get("matrix"), "data", None)
        if isinstance(data, torch.Tensor):
            return data.device.type
    return plan.mesh.device.type


def measure_per_op(plan) -> Tuple[Dict[int, Tuple[str, float]], float]:
    """Run the plan's physical tree once, timing every node.

    Returns ``(per_op, total_s)`` where ``per_op`` maps node uid →
    (label, seconds) EXCLUSIVE of children (the executor's op_hook
    subtracts time spent in child frames), so the per-op values sum to
    roughly the total instead of multiplying it by tree depth. Shared
    DAG nodes run (and are timed) once, as in the normal run's memo."""
    from matrel_tpu_torch import executor as executor_lib

    per_op: Dict[int, Tuple[str, float]] = {}

    def hook(node, label, seconds):
        per_op[node.uid] = (label, seconds)

    roots = (plan.optimized if isinstance(plan.optimized, tuple)
             else (plan.optimized,))
    low = executor_lib._lowerer(roots, plan.mesh, plan.config,
                                op_hook=hook)
    fn = low.lower_multi(roots, plan.leaf_order)
    args = executor_lib._leaf_values(plan.leaf_order, None, plan.mesh)
    dev = plan.mesh.device
    _sync(dev)
    t0 = time.perf_counter()
    fn(*args)
    _sync(dev)
    return per_op, time.perf_counter() - t0


def measure_fused(plan) -> float:
    """Seconds of ONE synced run of the plan as the session runs it,
    warmed first (the kernels' lazy build and the plan-level memos are
    then paid)."""
    dev = plan.mesh.device
    plan.run()
    _sync(dev)
    t0 = time.perf_counter()
    plan.run()
    _sync(dev)
    return time.perf_counter() - t0


def _fmt_bytes(b) -> str:
    if b is None:
        return "?"
    b = float(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024.0 or unit == "GiB":
            return f"{b:.1f}{unit}"
        b /= 1024.0
    return f"{b:.1f}GiB"


def _fusion_stamps(plan) -> Dict[int, dict]:
    """uid -> stamp attrs for every fused-region root in the plan's
    optimized tree(s) (ir/fusion.py) — empty with fusion off."""
    from matrel_tpu_torch.ir import fusion as fusion_lib
    roots = (plan.optimized if isinstance(plan.optimized, tuple)
             else (plan.optimized,))
    out: Dict[int, dict] = {}
    for r in roots:
        for node in fusion_lib.collect_stamps(r):
            out[node.uid] = node.attrs
    return out


def render(plan, per_op: Dict[int, Tuple[str, float]],
           fused_s: float) -> str:
    """Physical tree annotated with measured per-op milliseconds and,
    per matmul, the planner's choice + its estimated bytes/FLOPs —
    measured-vs-estimated on one screen. Fused regions report their
    EXCLUSIVE ms on the region-root row, members marked "(in fused
    region)"."""
    from matrel_tpu_torch import executor as executor_lib
    decisions = {d["uid"]: d
                 for d in executor_lib.plan_matmul_decisions(plan)
                 if "uid" in d}
    stamps = _fusion_stamps(plan)
    member_uids = {u for a in stamps.values()
                   for u in (a.get("fused_members") or ())}
    lines = ["== Analyzed physical plan (per-op measured, synced) =="]
    printed = set()

    def walk(n, indent):
        pad = "  " * indent
        extra = ""
        if n.kind == "matmul":
            extra = f" strategy={n.attrs.get('strategy', 'xla')}"
            if "strategy_source" in n.attrs:
                extra += f"[{n.attrs['strategy_source']}]"
        elif n.kind == "elemwise":
            extra = f" op={n.attrs['op']}"
        elif n.kind == "scalar":
            extra = f" op={n.attrs['op']} v={n.attrs['value']}"
        elif n.kind == "agg":
            extra = f" {n.attrs['agg']}/{n.attrs['axis']}"
        elif n.kind in ("join_rows", "join_cols") \
                and "replicate" in n.attrs:
            extra = f" replicate={n.attrs['replicate']}"
        timed = per_op.get(n.uid)
        if n.uid in printed:
            lines.append(f"{pad}{n.kind}{extra} shape={n.shape} "
                         f"(shared — timed above)")
            return
        printed.add(n.uid)
        if n.uid in stamps:
            a = stamps[n.uid]
            extra += (f" fused={a.get('fused_region')} "
                      f"members={len(a.get('fused_members') or ()) + 1}")
        ms = f" [{timed[1] * 1e3:.3f} ms]" if timed else ""
        if not timed and n.uid in member_uids:
            ms = " (in fused region — ms attributed to region root)"
        line = f"{pad}{n.kind}{extra} shape={n.shape}{ms}"
        d = decisions.get(n.uid)
        if d is not None:
            if d.get("precision_tier"):
                line += (f" tier={d['precision_tier']}"
                         f"x{d.get('est_passes', '?')}")
            if d.get("est_ici_bytes") is not None:
                line += (f" est_ici={_fmt_bytes(d['est_ici_bytes'])}"
                         f" flops={d['flops']:.3g}")
            elif d.get("dispatch"):
                line += f" dispatch={d['dispatch']} flops={d['flops']:.3g}"
                if d.get("est_saved_flops") is not None:
                    line += (
                        f" est_saved_flops={d['est_saved_flops']:.3g}"
                        f" est_saved_hbm="
                        f"{_fmt_bytes(d.get('est_saved_hbm_bytes'))}")
        lines.append(line)
        for c in n.children:
            walk(c, indent + 1)

    roots = (plan.optimized if isinstance(plan.optimized, tuple)
             else (plan.optimized,))
    for r in roots:
        walk(r, 0)
    per_op_total = sum(s for _, s in per_op.values())
    lines.append(f"== Per-op total (synced between ops): "
                 f"{per_op_total * 1e3:.3f} ms; plan as run: "
                 f"{fused_s * 1e3:.3f} ms ==")
    return "\n".join(lines)


def analyze_record(plan, per_op: Dict[int, Tuple[str, float]],
                   fused_s: float) -> dict:
    """The ``analyze`` event-log record: the measured per-op tree joined
    (by uid) to the plan's decision records — the drift auditor's
    highest-fidelity sample source. ``backend`` is the device type of
    the plan's tensors. Fused-region rows carry ``fused_region`` +
    ``members`` so the auditor joins an absorbed anchor's decision to
    the region's measured ms by membership."""
    from matrel_tpu_torch import executor as executor_lib
    stamps = _fusion_stamps(plan)
    rows = []
    for uid, (label, seconds) in sorted(per_op.items()):
        row = {"uid": uid, "label": label,
               "ms": round(seconds * 1e3, 4)}
        a = stamps.get(uid)
        if a is not None:
            row["fused_region"] = a.get("fused_region")
            row["members"] = sorted(a.get("fused_members") or ())
        rows.append(row)
    return {
        "backend": backend_of(plan),
        "fused_ms": round(fused_s * 1e3, 3),
        "per_op": rows,
        "matmuls": executor_lib.plan_matmul_decisions(plan),
    }
