"""Query placement — the counterpart of ``matrel_tpu/serve/placement.py``.

Every mechanism here answers one question per query: run it WHOLE on one
serving slice (data parallel over the query stream, no cross-slice
traffic, fewer devices), or SPAN it across the full mesh (every device
on one program, the dominant collective crossing the slice boundary)?
The decision is a closed-form byte/FLOP model weighted by the topology
weights, so crossing the slice cut only happens when the byte model says
it pays::

    est_span_ms  = cg * GF / P_total + cm * MiB_dominant * w_dcn
    est_slice_ms = cg * GF / P_slice + cm * MiB_dominant * w_ici

where ``GF`` is the query's estimated GFLOPs (``ir/delta.estimate_flops``,
the IVM pricing walk), ``MiB_dominant`` the dominant collective's bytes
(largest operand + output), ``w_ici`` the min topology axis weight,
``w_dcn`` the effective cross-slice weight (:func:`effective_dcn_weight`)
and ``cg``/``cm`` the ms/GFLOP and ms/MiB coefficients: the drift table's
measured rows for the query's (shape class, backend, tier) when
``config.fleet_placement_calibration`` is on and a row exists (stamped
``"measured"``), else the analytic constants (``"analytic"``).

The fleet that places queries between slices is not ported; on one card
:func:`decide` has one slice, and its callers are ``save_state`` (the
session-independent :func:`fleet_key` names restored result-cache
entries) and the verifier's placement pass (MV114), which re-checks a
stamped decision against the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

#: Analytic fallback coefficients — re-exported from the coefficient
#: seam (``parallel/coeffs.py``): ~1 TFLOP/s
#: effective per device and ~50 GB/s effective collective bandwidth.
#: A drift-calibrated row replaces both the moment one exists; these
#: only ever decide the span/slice trade, never numerics.
from matrel_tpu_torch.parallel.coeffs import (ANALYTIC_MS_PER_GFLOP,
                                              ANALYTIC_MS_PER_MIB)

#: Precision-SLA -> calibration-tier suffix for coefficient lookup
#: (the drift table keys tiered rows ``strategy@tier``). Default/exact
#: SLAs calibrate against untier rows (empty suffix — the historical
#: key format).
SLA_TIER = {"fast": "bf16x1", "high": "bf16x3", "bfloat16": "bf16x1",
            "bf16x3": "bf16x3", "int32": "int32", "int8": "int8"}


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """One query's routing verdict.

    mode: ``"slice"`` (whole query on ``slice_id``) or ``"span"``
      (one program over the full mesh, DCN included).
    slice_id: target slice for ``"slice"`` mode; the least-loaded
      live slice (round-robin tie-break) — also recorded for
      ``"span"`` as the slice that WOULD have been chosen.
    est_slice_ms / est_span_ms: the two closed-form estimates.
    coeff_source: ``"measured"`` (drift-calibrated coefficients) or
      ``"analytic"`` (closed-form constants) — the provenance stamp.
    reason: why this mode won — ``"cost"`` (the model), ``"pinned"``
      (un-rebindable leaves force the full-mesh session), or
      ``"solo"`` (single-slice fleet: nothing to place between).
    weights: the (wx, wy) topology weights the estimates used.
    dcn_axis: index of the axis the span estimate billed as DCN (the
      max-weight axis) — what MV114 re-checks.
    """

    mode: str
    slice_id: int
    est_slice_ms: float
    est_span_ms: float
    coeff_source: str
    reason: str
    weights: Tuple[float, float]
    dcn_axis: int

    def stamp(self) -> dict:
        """The plan-attr stamp a span-placed query carries
        (``expr.with_attrs(placement=...)``) — what MV114 verifies
        against the mesh it finds the plan on. KEY-STABLE fields
        only: the stamp lands in expr attrs, which feed the plan and
        result-cache structural keys, so anything that drifts between
        submissions of the same query (the cost estimates, the
        measured/analytic coefficient provenance — both change
        whenever the drift table gains rows) would shatter every
        span-placed query's cache keys on a long-lived host (the
        brownout-rung plan-key-shatter class). The estimates
        and ``coeff_source`` ride the ``placement`` obs event
        instead."""
        return {"mode": self.mode,
                "weights": list(self.weights),
                "dcn_axis": self.dcn_axis,
                "dcn_weight": effective_dcn_weight(self.weights)}


# ---------------------------------------------------------------------------
# Fleet structural keys — catalog-name-based, stable across slices
# ---------------------------------------------------------------------------


def fleet_key(e, names_by_id: Dict[int, str],
              prefix: str = "") -> Optional[str]:
    """The fleet directory's cross-slice structural key: the session
    plan key's exact interior walk with each leaf keyed by its CATALOG
    NAME instead of its ``id()`` — two slices holding replicas of the
    same named tables produce the SAME key for the same query, which
    is what lets one global directory map keys to owning slices.
    ``None`` when any leaf is unnamed (an ad-hoc matrix the fleet
    cannot rebind): the query still places, it just never enters the
    directory."""
    from matrel_tpu_torch.session import _plan_key_spans

    def tok(n):
        name = names_by_id.get(id(n.attrs["matrix"]))
        if name is None:
            return None
        return f"{n.kind}:@{name}:{n.attrs['matrix'].shape}"

    try:
        parts, _pins, _spans = _plan_key_spans(e, leaf_token=tok)
    except KeyError:
        return None
    return prefix + "|".join(parts)


# ---------------------------------------------------------------------------
# Drift-calibrated coefficients
# ---------------------------------------------------------------------------


def placement_coefficients(path: str) -> Dict[Tuple[str, str, str],
                                              dict]:
    """The per-(shape-class, backend, tier) coefficient blend the
    placement model consults ahead of its closed forms, served from
    the one coefficient seam
    (``parallel/coeffs.class_coefficients``): the planner shares it,
    and both read the same memoised view of the drift table. Rows:
    ``{"ms_per_gflop", "ms_per_mib", "count", "source": "measured"}``;
    absent keys mean "cold class" and the caller falls back to the
    analytic model."""
    from matrel_tpu_torch.parallel import coeffs
    return coeffs.class_coefficients(path)


def reset_coefficient_cache() -> None:
    """Test hook: drop the seam's stat-signature memo (kept under the
    historical name — tests and operators call it here)."""
    from matrel_tpu_torch.parallel import coeffs
    coeffs.reset_coefficient_cache()


# ---------------------------------------------------------------------------
# The decision
# ---------------------------------------------------------------------------


def pick_slice(slice_loads, rr_tick: int = 0) -> int:
    """The slice a slice-placed query would land on: least-loaded
    (``slice_loads`` maps slice_id -> queue depth for LIVE slices
    only), ties broken round-robin on ``rr_tick`` so an idle fleet
    still spreads a stream. ONE helper shared by :func:`decide` and
    the fleet's directory fast path, so a hit's replica preference
    agrees with where placement would have routed the miss."""
    ids = sorted(slice_loads)
    if not ids:
        raise ValueError("placement needs at least one live slice")
    min_load = min(slice_loads[i] for i in ids)
    tied = [i for i in ids if slice_loads[i] == min_load]
    return tied[rr_tick % len(tied)]


def effective_dcn_weight(weights: Tuple[float, float]) -> float:
    """The weight a span-placed query's dominant collective is billed
    at for crossing the slice cut: the max topology axis weight when
    the mesh is weighted (calibrated OR detected — anything but the
    homogeneous (1.0, 1.0) default, matching the config contract
    that any non-default ``axis_cost_weights`` overrides detection,
    fast-DCN calibrations <= 1.0 included), else the DCN default —
    the fleet partition IS a boundary even when nothing detected one
    (virtual slices), and an unpriced cut would make spanning always
    win. ONE helper shared by ``decide`` and MV114, so the verifier
    re-checks exactly what the placer billed."""
    from matrel_tpu_torch.core.mesh import DCN_AXIS_WEIGHT
    w = tuple(float(x) for x in weights)
    return max(w) if w != (1.0, 1.0) else float(DCN_AXIS_WEIGHT)


def query_footprint(e, config=None) -> Tuple[float, float, tuple]:
    """(flops, dominant_bytes, dims) of one query: estimated FLOPs via
    the IVM pricing walk (one estimate feeding both patch pricing and
    placement — the engine keeps one FLOP model), dominant collective
    bytes as largest-leaf + output bytes (the gather/reduce a
    distributed execution cannot avoid), and the root dims the shape
    class buckets on."""
    from matrel_tpu_torch.ir.delta import estimate_flops
    flops = float(estimate_flops(e, config))
    itemsize = 4.0
    biggest = 0.0

    def walk(n):
        nonlocal biggest
        if not n.children:
            biggest = max(biggest,
                          float(n.shape[0]) * float(n.shape[1]))
            return
        for c in n.children:
            walk(c)

    walk(e)
    out_elems = float(e.shape[0]) * float(e.shape[1])
    dominant = (biggest + out_elems) * itemsize
    return flops, dominant, tuple(e.shape)


def decide(e, config, weights: Tuple[float, float],
           total_devices: int, slice_devices: int,
           slice_loads, backend: str = "cpu",
           sla: str = "default",
           eligible: bool = True,
           rr_tick: int = 0) -> PlacementDecision:
    """Place one query: pick the least-loaded live slice (``
    slice_loads`` maps slice_id -> queue depth for LIVE slices only;
    ties break round-robin on ``rr_tick`` so an idle fleet still
    spreads a stream), then compare the two closed forms under the
    topology weights. ``eligible=False`` (un-rebindable leaves) pins
    the query to the full-mesh session — span by necessity, recorded
    as such."""
    target = pick_slice(slice_loads, rr_tick)
    w_dcn = effective_dcn_weight(weights)
    w_ici = min(weights)
    dcn_axis = 0 if weights[0] >= weights[1] else 1
    flops, dom_bytes, dims = query_footprint(e, config)
    cg, cm = ANALYTIC_MS_PER_GFLOP, ANALYTIC_MS_PER_MIB
    source = "analytic"
    if getattr(config, "fleet_placement_calibration", False):
        from matrel_tpu_torch.obs import drift
        coeffs = placement_coefficients(drift.table_path(config))
        row = coeffs.get((drift.shape_class(dims), backend,
                          SLA_TIER.get(sla, "")))
        if row is not None:
            if row["ms_per_gflop"] is not None:
                cg = float(row["ms_per_gflop"])
            if row["ms_per_mib"] is not None:
                cm = float(row["ms_per_mib"])
            source = "measured"
    gf = flops / 1e9
    mib = dom_bytes / (1 << 20)
    est_span = cg * gf / max(total_devices, 1) + cm * mib * w_dcn
    est_slice = cg * gf / max(slice_devices, 1) + cm * mib * w_ici
    if not eligible:
        mode, reason = "span", "pinned"
    elif len(slice_loads) < 2 and slice_devices >= total_devices:
        mode, reason = "slice", "solo"
    elif est_span < est_slice * float(
            getattr(config, "fleet_span_margin", 1.0)):
        mode, reason = "span", "cost"
    else:
        mode, reason = "slice", "cost"
    return PlacementDecision(mode=mode, slice_id=target,
                             est_slice_ms=est_slice,
                             est_span_ms=est_span,
                             coeff_source=source, reason=reason,
                             weights=(float(weights[0]),
                                      float(weights[1])),
                             dcn_axis=dcn_axis)
