"""Static plan verifier — the counterpart of ``matrel_tpu/analysis/``:
pre-execution invariant analysis of physical plans.

The planner's job is picking a correct and feasible physical plan before
anything runs on the device. The verifier re-checks its outputs — strategy
admissibility, layout-claim truthfulness, the zero-padding rule, the
SpGEMM no-densify guarantee, per-device memory feasibility and the
stamps the serve, obs and durability planes write — by reading the
annotated tree only: no device work, no sync. The passes and their
diagnostic codes are the JAX package's, node for node; where a pass
reads an executor predicate it reads the port's own (the port's B1-B8
kernels take the Pallas kernels' places).

Usage:

    from matrel_tpu_torch import analysis
    diags = analysis.verify_plan(annotated_expr, mesh, config)

``verify_plan`` expects a PLANNED tree (post
``planner.annotate_strategies``); the executor runs it automatically
under ``config.verify_plans`` ("warn" logs, "error" raises
:class:`VerificationError` before lowering), ``session.verify(expr)``
runs it on demand, and ``session.explain`` renders the findings.

Pass registry (each: ``fn(root, mesh, config) -> Iterator[Diagnostic]``;
codes documented in :mod:`matrel_tpu_torch.analysis.diagnostics`):

  strategy   MV101  stamped strategy admissible on this mesh
  spgemm     MV104  SpGEMM stamp <-> dispatch predicate agreement
  spgemm_kernel MV110 stamped kernel id in-registry + admissible for
                    the stamped structure class (both directions)
  layout     MV102  infer_layout claims pinned by the lowering
  padding    MV103  zero-padding invariant restored after breakers
  hbm        MV105  per-device working set fits hbm_budget_bytes
  topology   MV106  dominant collective off the slow (DCN) mesh axis
  result_cache MV107 result-cache stamp agrees with the cached entry
  precision  MV108  stamped precision tier satisfies the query SLA
  reshard    MV109  staged reshard peaks fit reshard_peak_budget_bytes
  fusion     MV111  fused-region stamps cover exactly the regions the
                    executor lowers (both directions); tier/remask
                    preserved; fusion off stamps nothing
  brownout   MV112  brownout stamps agree with the rung that claims
                    them (tier downshift matches the compile SLA,
                    staleness only at rung >= 2, no stamps with the
                    controller off)
  delta      MV113  delta-patched result-cache provenance is coherent
                    (rule in ir/delta.DELTA_RULES, generation >= 1,
                    finite composed bound); the DYNAMIC half
                    (delta_pass.verify_patched_entries) proves every
                    surviving patched entry against fresh execution
                    within that bound
  provenance MV115  answer-lineage stamps cohere with the mechanism
                    stamps both directions (provenance ⇔ result_cache
                    key hashes, ivm_patched ⇔ delta, fleet_replica
                    backed by fleet; unknown paths/schemas warn); the
                    DYNAMIC half (provenance_pass.verify_ledger)
                    audits a live ledger's records
  cse        MV116  cross-query CSE stamps agree with the hoisted
                    result they ride (layout/dtype, uses >= 2); the
                    DYNAMIC half (cse_pass.verify_cse_executions)
                    proves recent CSE-substituted batch roots equal
                    their unshared executions
  spill      MV117  spill-thaw provenance stamps cohere with the tier
                    hierarchy (legs are what spill_plan stages from
                    the claimed tier, fits verdict matches the live
                    peak budget, cost provenance classifiable)
"""

from __future__ import annotations

import logging
from typing import List, Optional

from matrel_tpu_torch.analysis.brownout_pass import check_brownout_stamps
from matrel_tpu_torch.analysis.cse_pass import check_cse_stamps
from matrel_tpu_torch.analysis.delta_pass import check_delta_stamps
from matrel_tpu_torch.analysis.diagnostics import (  # noqa: F401 (re-export)
    Diagnostic, VerificationError)
from matrel_tpu_torch.analysis.fusion_pass import check_fusion_stamps
from matrel_tpu_torch.analysis.hbm_pass import check_hbm_feasibility
from matrel_tpu_torch.analysis.layout_pass import check_layout_claims
from matrel_tpu_torch.analysis.padding_pass import check_padding_flow
from matrel_tpu_torch.analysis.placement_pass import check_placement_stamps
from matrel_tpu_torch.analysis.precision_pass import check_precision_stamps
from matrel_tpu_torch.analysis.provenance_pass import check_provenance_stamps
from matrel_tpu_torch.analysis.reshard_pass import check_reshard_peaks
from matrel_tpu_torch.analysis.result_cache_pass import check_result_cache_stamps
from matrel_tpu_torch.analysis.spill_pass import check_spill_stamps
from matrel_tpu_torch.analysis.strategy_pass import (check_spgemm_dispatch,
                                               check_spgemm_kernel,
                                               check_strategy_stamps)
from matrel_tpu_torch.analysis.topology_pass import check_axis_traffic
from matrel_tpu_torch.config import MatrelConfig, default_config

log = logging.getLogger("matrel_tpu_torch.analysis")

#: (name, pass_fn) in report order. Passes are independent reads of the
#: same annotated tree; each walks the DAG once, so a full verify is
#: O(passes x nodes) with no tracing and no device work.
PASSES = (
    ("strategy", check_strategy_stamps),
    ("spgemm", check_spgemm_dispatch),
    ("spgemm_kernel", check_spgemm_kernel),
    ("layout", check_layout_claims),
    ("padding", check_padding_flow),
    ("hbm", check_hbm_feasibility),
    ("topology", check_axis_traffic),
    ("result_cache", check_result_cache_stamps),
    ("precision", check_precision_stamps),
    ("reshard", check_reshard_peaks),
    ("fusion", check_fusion_stamps),
    ("brownout", check_brownout_stamps),
    ("delta", check_delta_stamps),
    ("placement", check_placement_stamps),
    ("provenance", check_provenance_stamps),
    ("cse", check_cse_stamps),
    ("spill", check_spill_stamps),
)


def verify_plan(root, mesh, config: Optional[MatrelConfig] = None,
                passes=None) -> List[Diagnostic]:
    """Run every verifier pass over an ANNOTATED plan; returns the
    (possibly empty) diagnostic list, errors first. Never raises on a
    bad plan — escalation is the caller's policy (see
    :func:`enforce`)."""
    cfg = config or default_config()
    out: List[Diagnostic] = []
    for _name, fn in (PASSES if passes is None else passes):
        out.extend(fn(root, mesh, cfg))
    out.sort(key=lambda d: (d.severity != "error", d.code))
    return out


def enforce(diagnostics: List[Diagnostic],
            mode: str, context: str = "plan") -> None:
    """Apply a ``config.verify_plans`` policy to a diagnostic list:
    "warn" logs each finding; "error" additionally raises
    :class:`VerificationError` when any error-severity diagnostic is
    present (warnings alone never fail a query). "off" or an empty
    list is a no-op."""
    if mode == "off" or not diagnostics:
        return
    for d in diagnostics:
        log.warning("verify(%s): %s", context, d.render())
    if mode == "error" and any(d.severity == "error"
                               for d in diagnostics):
        raise VerificationError(diagnostics)


def render(diagnostics: List[Diagnostic]) -> str:
    """The EXPLAIN section body: one line per finding, or the explicit
    all-clear (so a clean report is distinguishable from a skipped
    verify)."""
    if not diagnostics:
        return "clean (0 diagnostics)"
    return "\n".join(d.render() for d in diagnostics)
