"""Axis-traffic pass: MV106 (slow-axis collective smell).

On a topology-weighted mesh (non-uniform per-axis inverse-bandwidth
weights, ``config.axis_cost_weights`` — a hierarchical fabric),
a plan whose dominant collective rides the EXPENSIVE axis while an
admissible alternative moves far fewer weighted bytes is almost always
a stale or hand-stamped plan: the planner itself minimises the weighted
bill (choose_strategy_ex), so a fresh annotation cannot produce the
smell outside the tiebreak band. The classic instance is a
reduce-scatter over the cross-slice axis when a broadcast that stays
in-slice is available — exactly the plan bug a flat byte model
ships silently, caught here statically before anything lowers
(the arXiv:2112.01075 discipline, extended to the fabric dimension).
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.analysis.strategy_pass import _dispatch_kind
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.parallel import planner

#: An alternative must move at least this factor fewer weighted bytes
#: before MV106 fires — the planner's own tiebreak band (10%), consumer
#: hints and root-context differences can legitimately leave a stamped
#: pick somewhat off the verifier's argmin; a 2× gap cannot be any of
#: those.
MV106_MARGIN = 2.0

#: Strategies MV106 compares — the real distributed recipes. xla is
#: excluded (the library picks its own decomposition; the model's rmm proxy
#: is a pricing stand-in, not a recipe to second-guess), spgemm is a
#: dispatch, not a choice.
_CANDIDATES = ("bmm_right", "bmm_left", "cpmm", "rmm", "summa")


def _root_exposures(root) -> dict:
    """uid -> (scale, transposed) of each matmul's exposure to the
    plan-ROOT canonical-output reshard, mirroring the planner's own
    threading (annotate_strategies walks _child_root_scale the same
    way) so MV106 prices alternatives in the context the planner did.
    Shared DAG nodes keep their maximum exposure (conservative: the
    bigger root charge makes alternatives look worse, never better)."""
    out: dict = {}

    def walk(n, scale: float, swap: bool):
        if n.kind == "matmul":
            prev = out.get(n.uid, (0.0, False))
            if scale >= prev[0]:
                out[n.uid] = (scale, swap)
        nxt_swap = swap != (n.kind == "transpose")
        for i, c in enumerate(n.children):
            walk(c, planner._child_root_scale(n, i, scale), nxt_swap)

    walk(root, 1.0, False)
    return out


def check_axis_traffic(root, mesh, config) -> Iterator[Diagnostic]:
    """MV106: on a non-uniform mesh, warn when a stamped strategy's
    dominant collective rides the expensive axis while an admissible
    alternative moves ≥ MV106_MARGIN× fewer weighted bytes (both priced
    with the same α steps and root-reshard context the planner uses).
    Uniform meshes have no slow axis — the pass is free there."""
    # the JAX package's MeshTopology: uniform when the two axis
    # weights agree (no slice detection on this side — the configured
    # weights are the topology)
    wts = mesh_lib.axis_weights(mesh, config)
    if wts[0] == wts[1]:
        return
    wx, wy = wts
    slow = 0 if wx > wy else 1
    slow_name = mesh.axis_names[slow]
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    exposures = _root_exposures(root)
    lmemo: dict = {}
    dmemo: dict = {}
    seen = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul" or "strategy" not in n.attrs:
            return
        strat = n.attrs["strategy"]
        if strat not in _CANDIDATES:
            return               # xla/spgemm/unknown: MV101's domain
        if n.attrs.get("strategy_source") == "measured":
            # an autotune wall-clock winner legitimately disagrees with
            # the byte model — that is the POINT of measuring (the
            # probes time the real fabric, weights and all); flagging
            # it would warn on every fresh annotation of an
            # autotune-enabled weighted session
            return
        if n.attrs.get("cost_model") == "measured":
            # same exemption, coefficient-ranked decisions
            # (parallel/coeffs.py): a drift-
            # calibrated ms ranking legitimately disagrees with the
            # raw byte model — measured reality overriding the closed
            # forms is the closed loop WORKING, not a smell this pass
            # (which re-prices by exactly those closed forms) can judge
            return
        if _dispatch_kind(n, config) is not None:
            return               # fast-path dispatch: no collectives run
        a, b = n.children
        nn, kk = a.shape
        mm = b.shape[1]
        la = planner.infer_layout(a, mesh, lmemo, config)
        lb = planner.infer_layout(b, mesh, lmemo, config)
        da, db = a.density, b.density
        ax = planner.comm_cost_axes(strat, nn, kk, mm, da, db, gx, gy,
                                    a_layout=la, b_layout=lb,
                                    weights=wts)
        if ax[slow] <= 0.0 or ax[slow] <= ax[1 - slow]:
            return               # dominant traffic already off the slow axis
        scale, swap = exposures.get(n.uid, (0.0, False))
        al = config.comm_alpha_bytes

        def priced(s: str) -> float:
            return (planner.comm_cost(s, nn, kk, mm, da, db, gx, gy,
                                      a_layout=la, b_layout=lb,
                                      alpha_bytes=al, weights=wts)
                    + planner._root_reshard_cost(s, nn, mm, gx, gy, swap,
                                                 weights=wts) * scale)

        stamped_cost = priced(strat)
        pn, pk = padding.padded_shape((nn, kk), mesh)
        _, pm = padding.padded_shape((kk, mm), mesh)
        dt = planner.infer_dtype(n, config, dmemo)
        isz = dt.itemsize if dt is not None else 4
        a_bytes = planner._bytes((nn, kk), da)
        b_bytes = planner._bytes((kk, mm), db)
        thr = config.broadcast_threshold_bytes
        best_alt, best_cost = None, None
        for s in _CANDIDATES:
            if s == strat:
                continue
            if s == "bmm_right" and b_bytes > thr:
                continue
            if s == "bmm_left" and a_bytes > thr:
                continue
            if s == "summa" and (gx != gy or gx <= 1):
                continue
            if not planner.admissible(s, pn, pk, pm, gx, gy,
                                      itemsize=isz,
                                      hbm_budget_bytes=
                                      config.hbm_budget_bytes):
                continue
            c = priced(s)
            if best_cost is None or c < best_cost:
                best_alt, best_cost = s, c
        if (best_cost is not None
                and best_cost * MV106_MARGIN <= stamped_cost):
            yield Diagnostic(
                code="MV106", severity="warning", node=node_addr(n),
                message=f"stamped {strat!r} moves most of its bytes "
                        f"over the expensive {slow_name!r} axis "
                        f"(weight {wts[slow]:g}; ~{ax[slow]:.3g} B vs "
                        f"{ax[1 - slow]:.3g} B) while admissible "
                        f"{best_alt!r} costs {best_cost:.3g} weighted "
                        f"vs {stamped_cost:.3g} — the slow-axis "
                        "collective smell",
                fix_hint="re-plan on this mesh (annotate_strategies "
                         "prices axis weights) or calibrate "
                         "config.axis_cost_weights if the fabric "
                         "really is flat")

    yield from walk(root)
