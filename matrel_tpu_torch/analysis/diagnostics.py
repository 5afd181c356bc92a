"""Typed diagnostics for the static plan verifier — the counterpart of
``matrel_tpu/analysis/diagnostics.py``.

One vocabulary shared by every pass (analysis/__init__.py registry):
a pass walks an ANNOTATED plan (post ``planner.annotate_strategies``)
and yields :class:`Diagnostic` records — it never mutates the tree and
never raises on a bad plan. Escalation is the caller's policy
(``config.verify_plans``): the executor raises
:class:`VerificationError` at "error", logs at "warn";
``session.verify``/``explain`` just hand the records back.

Code space (stable — tests and suppressions key on them):

  MV101  stamped strategy inadmissible / unknown       (error)
  MV102  layout claim not pinned by the lowering       (warning)
  MV103  zero-padding invariant broken without re-mask (error)
  MV104  SpGEMM stamp inconsistent with the dispatch   (error)
  MV105  per-device HBM working set over budget        (error)
  MV106  dominant collective rides the slow mesh axis  (warning)
  MV107  result-cache stamp disagrees with the cache   (warning)
  MV108  precision tier violates the query's accuracy
         SLA, or int tier on unprovable operands       (error)
  MV109  staged reshard peak over reshard_peak_budget_
         bytes, or a stamped reshard record that
         understates its recompiled peak               (error)
  MV110  SpGEMM kernel stamp unknown / inadmissible for
         the stamped structure class                   (error)
  MV112  brownout stamp disagrees with the rung that
         claims it (tier/staleness/controller-off)     (warning)
"""

from __future__ import annotations

import dataclasses
from typing import List

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, addressed to a plan node.

    code: stable "MVxxx" identifier (module docstring catalogue).
    severity: "error" (the lowering would run something the plan
      misdescribes, or could not run at all) or "warning" (the plan
      executes correctly but was COSTED on a false premise).
    node: human-readable node address — ``kind#uid shape`` — enough to
      find the node in ``pretty()`` output; plans are DAGs, so a uid is
      the only stable name.
    message: what invariant failed, with the observed values.
    fix_hint: the action that clears it (the reference's analyzer
      errors carry the same "did you mean" affordance).
    """

    code: str
    severity: str
    node: str
    message: str
    fix_hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def render(self) -> str:
        line = f"{self.code} [{self.severity}] {self.node}: {self.message}"
        if self.fix_hint:
            line += f" (fix: {self.fix_hint})"
        return line

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def dtype_name(dtype) -> str:
    """A leaf's dtype as the stamps spell it (numpy's name: "float32",
    "bfloat16"): torch dtypes lose their ``torch.`` prefix."""
    if dtype is None:
        return "float32"
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def node_addr(node) -> str:
    """The ``kind#uid shape`` address diagnostics carry."""
    return f"{node.kind}#{node.uid} {node.shape}"


class VerificationError(RuntimeError):
    """Raised by the compile path at ``verify_plans="error"`` when any
    error-severity diagnostic fires — BEFORE tracing, so nothing
    reaches the chip. Carries the full diagnostic list (not just the
    errors) so the failure message shows the whole picture."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == "error"]
        lines = "\n  ".join(d.render() for d in self.diagnostics)
        super().__init__(
            f"plan verification failed with {len(errors)} error(s) "
            f"({len(self.diagnostics)} diagnostic(s) total):\n  {lines}")
