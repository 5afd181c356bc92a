"""Reshard peak-memory feasibility (MV109).

MV105 proves a strategy's RESIDENT working set fits the device; this
pass proves the MOVES do. A layout change lowered one-shot can
materialise a full gather of the array as a transient — the footprint
that makes near-HBM-limit operands unmovable — and the staged reshard
planner (parallel/reshard.py; arXiv:2112.01075) exists to bound it.
MV109 checks, for every stamped dense matmul (and the plan root's
canonical re-lay), that the staged ReshardPlan the lowering will run
has a peak per-device footprint within ``reshard_peak_budget_bytes``;
a move with NO bounded decomposition is an error before anything
lowers. Hand-stamped ``attrs["reshard"]`` records (the cached/foreign-
plan surface, MV105's re-check discipline) are additionally recompiled
and flagged when they understate the real peak or exceed the verifying
config's budget.

The move derivation is ``reshard.staged_matmul_moves`` — the SAME
helper the executor stages with and matmul_decisions records from, so
the verifier can never disagree with the lowering about which moves
run. Budget 0 disables the derived checks (the legacy one-shot path
has no staged plans to prove); stamped records are still validated
against their own recompilation.
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.parallel import reshard as reshard_lib


def _check_stamp(n, gx: int, gy: int, wts, budget: float
                 ) -> Iterator[Diagnostic]:
    """Validate a hand-stamped attrs['reshard'] record by recompiling
    the move it claims."""
    stamp = n.attrs.get("reshard")
    if not isinstance(stamp, dict):
        return
    nbytes = stamp.get("nbytes")
    if not isinstance(nbytes, (int, float)) or nbytes <= 0:
        # a missing/zero size would recompile as a 0-byte move whose
        # peak is trivially fine — the exact bypass the re-check
        # exists to prevent: flag it like bad vocabulary
        yield Diagnostic(
            code="MV109", severity="error", node=node_addr(n),
            message=f"stamped reshard record {stamp!r} carries no "
                    "positive 'nbytes' — its peak cannot be verified",
            fix_hint="stamp ReshardPlan.to_dict() output (parallel/"
                     "reshard.py), which always records the move's "
                     "full padded-array bytes")
        return
    try:
        plan = reshard_lib.compile_reshard(
            str(stamp.get("src")), str(stamp.get("dst")),
            float(nbytes), gx, gy, wts, peak_budget=budget)
    except (ValueError, TypeError):
        yield Diagnostic(
            code="MV109", severity="error", node=node_addr(n),
            message=f"stamped reshard record {stamp!r} names endpoints "
                    "outside the plan compiler's vocabulary",
            fix_hint="stamp ReshardPlan.to_dict() output (parallel/"
                     "reshard.py), or drop the stamp and let the "
                     "lowering derive its own moves")
        return
    claimed = stamp.get("peak_bytes")
    if isinstance(claimed, (int, float)) \
            and claimed + 1.0 < plan.peak_bytes:
        yield Diagnostic(
            code="MV109", severity="error", node=node_addr(n),
            message=f"stamped reshard peak {claimed / 2**20:.2f} MiB "
                    f"understates the move's real bounded-decomposition "
                    f"peak {plan.peak_bytes / 2**20:.2f} MiB "
                    f"({stamp.get('src')}->{stamp.get('dst')}, "
                    f"{gx}x{gy} grid)",
            fix_hint="re-stamp from compile_reshard under this config "
                     "— an understated peak would admit a move the "
                     "chip cannot hold")
    if budget > 0 and not plan.fits(budget):
        yield Diagnostic(
            code="MV109", severity="error", node=node_addr(n),
            message=f"stamped reshard {stamp.get('src')}->"
                    f"{stamp.get('dst')} has no decomposition under "
                    f"{budget / 2**20:.2f} MiB peak: the bounded plan "
                    f"still peaks at {plan.peak_bytes / 2**20:.2f} MiB "
                    "per device",
            fix_hint="raise reshard_peak_budget_bytes (replication "
                     "moves cannot peak below the replicated array), "
                     "or re-plan so the consumer reads the existing "
                     "layout")


def check_reshard_peaks(root, mesh, config) -> Iterator[Diagnostic]:
    """MV109 over an annotated plan: every staged reshard's peak fits
    the budget, and every hand-stamped reshard record survives
    recompilation."""
    budget = float(config.reshard_peak_budget_bytes)
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    wts = mesh_lib.axis_weights(mesh, config)
    seen = set()
    lmemo: dict = {}
    dmemo: dict = {}

    def _over_peak(n, what: str, plan) -> Diagnostic:
        return Diagnostic(
            code="MV109", severity="error", node=node_addr(n),
            message=f"{what} {plan.src}->{plan.dst} has no "
                    f"decomposition under the {budget / 2**20:.2f} "
                    f"MiB reshard peak budget (best staged plan peaks "
                    f"at {plan.peak_bytes / 2**20:.2f} MiB per "
                    f"device, steps {list(plan.step_kinds)})",
            fix_hint="raise reshard_peak_budget_bytes, or re-plan "
                     "toward a strategy that consumes the operand's "
                     "existing layout")

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul":
            return
        yield from _check_stamp(n, gx, gy, wts, budget)
        if budget <= 0:
            return
        for i, plan in reshard_lib.staged_matmul_moves(
                n, mesh, config, lmemo, dmemo):
            if not plan.fits(budget):
                yield _over_peak(n, f"operand {i} re-lay", plan)

    yield from walk(root)
    if budget > 0:
        # the plan ROOT's canonical re-lay stages too (executor.
        # _stage_root_relay — same shared derivation), so its peak is
        # proven like any operand move
        rplan = reshard_lib.root_relay_plan(root, mesh, config, lmemo,
                                            dmemo)
        if rplan is not None and not rplan.fits(budget):
            yield _over_peak(root, "root canonical re-lay", rplan)
