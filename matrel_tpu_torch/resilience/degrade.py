"""Plan-degradation ladder — what a RETRY is allowed to change; the
counterpart of ``matrel_tpu/resilience/degrade.py``.

Each retry attempt climbs one rung of a CUMULATIVE ladder toward the
most conservative plan the engine has — every rung is
semantics-preserving (same answer within the plan's tolerance, slower),
which is what makes escalation safe to do blindly:

    rung 0  the stamped plan as compiled (no degradation)
    rung 1  drop measured autotune winners (cost model decides)
    rung 2  + force the ``xla`` strategy for every matmul
    rung 3  + no hand-written kernels: ``use_pallas=False`` (every
            CUDA kernel wrapper runs its plain PyTorch version),
            SpGEMM dispatch off (``spgemm_density_threshold=0``), the
            kernel registry pinned to ``xla_gather`` and fusion off —
            the composite paths, by design
    rung 4  + bypass the result cache for this attempt (a poisoned
            entry cannot answer the retry)

Only a TRANSIENT failure climbs (``resilience/errors.is_transient``):
a kernel that fails to build or launch raises a deterministic error
and is never laddered around. Rungs 1–3 act through the compile config
(:func:`apply_rung`), so the degraded attempt recompiles under a
``degr:<rung>|``-prefixed plan key — a degraded plan never shares the
default cache slot. The session stamps ``plan.meta["degrade"]`` and
emits one ``degrade`` obs event per escalation.
"""

from __future__ import annotations

from typing import Tuple

#: Highest rung (also the result-cache bypass rung).
MAX_RUNG = 4

#: Rung at (and above) which the session bypasses the result cache.
RC_BYPASS_RUNG = 4

#: rung -> short label (plan.meta / obs events / docs).
RUNG_LABELS = {
    0: "none",
    1: "no-autotune",
    2: "xla-strategy",
    3: "no-kernels",
    4: "no-result-cache",
}


def rung_label(rung: int) -> str:
    return RUNG_LABELS.get(rung, f"rung-{rung}")


def rung_meta(rung: int) -> dict:
    """The rung's stamp record — one shape everywhere it rides
    (``plan.meta["degrade"]``, the ``degrade`` obs event, the answer
    ledger's lineage records)."""
    return {"rung": rung, "label": rung_label(rung)}


def apply_rung(config, rung: int):
    """The compile config of one degraded attempt — CUMULATIVE: rung N
    includes every restriction below it. Rung 0 returns the config
    object UNCHANGED (identity, not a copy — the bit-identity
    contract). Rung 4's result-cache bypass is the session's job (the
    cache is session state, not compile config); at the config level
    it equals rung 3."""
    if rung <= 0:
        return config
    kw = {"autotune": False}
    if rung >= 2:
        kw["strategy_override"] = "xla"
    if rung >= 3:
        kw["use_pallas"] = False
        kw["pallas_interpret"] = False
        kw["spgemm_density_threshold"] = 0.0
        # ALSO force the kernel registry to its composite entry: a
        # base config carrying spgemm_kernel_override (a forced
        # specialized kernel) would
        # otherwise survive every rung, so the very kernel the ladder
        # exists to escape kept being re-stamped on the degraded
        # attempt. Zeroing the threshold kills the expr-level
        # dispatch; the override pin covers direct ops-level callers
        # and makes the escape independent of admissibility gating.
        kw["spgemm_kernel_override"] = "xla_gather"
        # force staged execution: a base config running whole-plan
        # fusion would otherwise re-stamp the very fused region the
        # retry exists to escape (the kernel-override rationale, one
        # rung, same direction — toward the per-op path the engine
        # has always trusted)
        kw["fusion_enable"] = False
    return config.replace(**kw)


def key_prefix(rung: int) -> str:
    """Plan-cache key prefix for a degraded compile (the axisw/prec
    prefix idiom) — '' at rung 0 keeps the historical key format."""
    return "" if rung <= 0 else f"degr:{min(rung, MAX_RUNG)}|"


def next_rung(rung: int) -> Tuple[int, bool]:
    """(new rung, escalated?) — one step up the ladder, saturating."""
    if rung >= MAX_RUNG:
        return rung, False
    return rung + 1, True
