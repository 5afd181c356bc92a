"""MV112 — brownout stamps must agree with the rung that claims them.

When the adaptive brownout controller (``resilience/brownout.py``)
downshifts a default-SLA query, the serve worker
STAMPS the expr root (``attrs["brownout"] = {rung, sla[,
staleness_ms]}``) before compiling it under the downshifted precision
config — the stamp is the plan's own record of WHY it runs at reduced
fidelity, and it rides the plan key so a browned-out plan never shares
a cache slot with a full-fidelity one. This pass proves the stamp and
the plan still agree:

- the stamped rung must be a real brownout rung (1..3);
- a tier-downshift claim (``sla``) must match the precision SLA the
  plan actually compiles under — a stamp claiming "fast" on a plan
  compiled at "default" means the caller got full-price latency
  labelled as browned-out (or, worse, the reverse: a silently
  downgraded result with no rung to justify it);
- a ``staleness_ms`` claim requires rung >= 2 (STALE_RUNG) — stale
  serving below the rung that authorizes it is a contract violation;
- any stamp at all under a config with brownout OFF is a replayed /
  hand-built plan claiming a controller that does not exist.

Warning severity, the MV102/MV106/MV107 class: the lowering runs the
stamped tier correctly either way — what is wrong is the plan's
description of WHY. Fresh annotations are provably quiet: default
queries carry no stamp, and the worker stamps exactly the rung/sla it
compiles under.

Coverage note: the stamp rides expr attrs, and a rewrite rule that
RECONSTRUCTS the root node (e.g. a bare matmul root the chain pass
rebuilds) drops them with it — the pass verifies surviving stamps, it
cannot resurrect dropped ones. That is the conservative direction
(a dropped stamp makes no claim to be wrong about), and the
plan/result-cache ISOLATION is unaffected either way: cache keys are
computed over the pre-optimize expression, where the stamp always
lives.
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.resilience.brownout import (MAX_RUNG, STALE_RUNG,
                                                  TIER_RUNG)

_FIX = ("let the serve worker stamp brownout downshifts (the stamp "
        "records the rung/sla the plan compiles under) — do not "
        "hand-stamp or replay browned-out plans across configs")


def check_brownout_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        stamp = n.attrs.get("brownout") if n.attrs else None
        if isinstance(stamp, dict):
            yield from _check_stamp(n, stamp, config)

    yield from walk(root)


def _check_stamp(n, stamp: dict, config) -> Iterator[Diagnostic]:
    rung = stamp.get("rung")
    if not isinstance(rung, int) or not (TIER_RUNG <= rung <= MAX_RUNG):
        yield Diagnostic(
            code="MV112", severity="warning", node=node_addr(n),
            message=(f"brownout stamp carries rung {rung!r} — not a "
                     f"brownout rung ({TIER_RUNG}..{MAX_RUNG})"),
            fix_hint=_FIX)
        return
    if not getattr(config, "brownout_enable", False):
        yield Diagnostic(
            code="MV112", severity="warning", node=node_addr(n),
            message=("brownout stamp on a plan whose config has "
                     "brownout OFF — a replayed/hand-built plan "
                     "claims a controller that does not exist"),
            fix_hint=_FIX)
    claimed = stamp.get("sla")
    actual = getattr(config, "precision_sla", "default")
    if claimed is not None and claimed != actual:
        yield Diagnostic(
            code="MV112", severity="warning", node=node_addr(n),
            message=(f"brownout rung {rung} claims a downshift to "
                     f"{claimed!r} but the plan compiles under "
                     f"precision SLA {actual!r} — the stamp and the "
                     f"tier the lowering runs disagree"),
            fix_hint=_FIX)
    stale_claim = stamp.get("stale_ok") or (
        stamp.get("staleness_ms") is not None)
    if stale_claim and rung < STALE_RUNG:
        yield Diagnostic(
            code="MV112", severity="warning", node=node_addr(n),
            message=(f"brownout stamp declares a staleness tolerance "
                     f"at rung {rung} — stale serving is authorized "
                     f"only at rung >= {STALE_RUNG}"),
            fix_hint=_FIX)
