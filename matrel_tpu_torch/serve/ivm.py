"""DeltaPlane — incremental view maintenance over the result cache,
the counterpart of ``matrel_tpu/serve/ivm.py``.

``session.register_delta(name, delta)`` routes here: every cached entry
depending on the rebound matrix is PATCHED in place through the delta
algebra (``ir/delta.py``) when a rule applies and the pricing says the
patch beats recompute; ineligible or priced-out entries fall back to
exactly the transitive kill, so answers never go wrong.

The plane owns:
  * generation bookkeeping — the ``delta:<gen>|`` key prefix
    (``session._rc_key_prefix``), with surviving entries that do not
    depend on the rebound matrix RENAMED across the generation;
  * delta propagation order — dependents patch smallest-expression
    first, each patched entry's (old, new) pair entering the ``known``
    map downstream patches consume as a leaf;
  * patch-vs-recompute pricing — the FLOP estimate decides, a measured
    autotune ``ivm|`` winner overrides it;
  * steady-state plan reuse — a patch plan whose delta signature and
    sibling set repeat is RE-RUN with rebound factor/dense/result
    leaves (``CompiledPlan.run(bindings=...)``) instead of recompiled.
    After its first run a kept plan's rebound leaves are released
    (:func:`_release_rebound`): their matrices become shape-only
    stand-ins on the ``meta`` device, so the plan never keeps a past
    generation's device tensors alive — only the tensors of the tick
    that binds them.

Entry mutation happens only through the result cache's patch/apply seam
(``apply_patch`` / ``rekey`` / ``drop``). The session builds a
DeltaPlane lazily on the first ``register_delta``. With a brownout
controller the entries a delta kills move to the stale graveyard
(rung 2 may serve them); each applied patch appends one link to the
provenance ledger's chain (``obs_provenance``); every delta emits one
``delta`` obs event.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from matrel_tpu_torch.ir import delta as delta_lib
from matrel_tpu_torch.serve.result_cache import CacheEntry, result_nbytes

log = logging.getLogger("matrel_tpu_torch.ivm")


@dataclasses.dataclass
class PatchProgram:
    """One compiled patch plan, reusable across delta generations for
    the same entry when the delta signature (and the sibling entries
    the plan reads) repeat — the steady-state path of a constant-batch
    stream."""

    plan: object                              # executor.CompiledPlan
    binds: Tuple[Tuple[int, tuple], ...]      # (leaf uid, ivm_role)
    signature: tuple                          # (delta sig, entry core key)
    known_keys: Tuple[str, ...]
    rule: str
    rules: Dict[str, int]
    est_patch_flops: float
    est_full_flops: float
    err_bound: float
    #: False when the plan bakes a sparse payload of this generation
    #: (the S×S form): such a plan is never re-run with new bindings
    rebindable: bool = True


class DeltaPlane:
    """Per-session IVM orchestrator (see module docstring)."""

    def __init__(self, session):
        delta_lib._CONSTRUCTED["count"] += 1
        self.sess = session
        self._programs: Dict[int, PatchProgram] = {}
        self._ivm_ids = itertools.count(1)
        self.stats = {"patch_compiles": 0, "patch_reuses": 0,
                      "measured_overrides": 0}

    # -- entry point --------------------------------------------------------

    def apply(self, name: str, old, delta: delta_lib.MatrixDelta) -> dict:
        from matrel_tpu_torch.resilience.retry import now as _now
        sess = self.sess
        cfg = sess.config
        mesh = sess.mesh
        t0 = _now()
        new = delta.apply_to(old, mesh, cfg)
        gen_old = sess._delta_gen
        gen = gen_old + 1
        old_prefix = delta_lib.delta_prefix(gen_old)
        new_prefix = delta_lib.delta_prefix(gen)
        rc = sess._result_cache
        keep_stale = sess._brownout is not None
        deps = frozenset({id(old)})
        snapshot = rc.items_snapshot()
        dependents = [(k, e) for k, e in snapshot if e.dep_ids & deps]
        others = [(k, e) for k, e in snapshot
                  if not (e.dep_ids & deps)]
        # smallest expression first: interior entries (A·A) patch
        # before the composites (trace(A·A·A)) that read their deltas
        dependents.sort(key=lambda kv: _expr_size(kv[1].expr))
        # known-sibling values are NAMESPACED BY TIER PREFIX: a
        # default-SLA patch must never consume a fast-tier sibling's
        # (old, new) pair — that would inject bf16-tier error into a
        # result whose composed bound was built from f32 units (the
        # prec:-prefix isolation contract, applied to propagation)
        known_by_prec: Dict[str, Dict[str, tuple]] = {}
        counters = {"patched": 0, "killed": 0, "priced_out": 0,
                    "reused_plans": 0}
        rules_census: Dict[str, int] = {}
        saved_total = 0.0
        for key, ent in dependents:
            ok = False
            if cfg.delta_patch_mode != "off" and ent.expr is not None:
                try:
                    ok, saved = self._patch_entry(
                        key, ent, old, new, delta, gen, new_prefix,
                        known_by_prec.setdefault(ent.prec, {}),
                        rules_census, counters)
                    saved_total += saved
                except Exception:
                    # a failing patch must degrade to the kill, never
                    # fail the register — the correctness floor
                    log.warning("ivm: patch failed for %s; falling "
                                "back to invalidation",
                                ent.key_hash, exc_info=True)
                    ok = False
            if not ok:
                rc.drop(key, keep_stale=keep_stale,
                        stale_max=cfg.result_cache_max_entries,
                        stale_max_bytes=cfg.result_cache_max_bytes)
                counters["killed"] += 1
        # survivors rename across the generation so they keep hitting
        # (generation 0 had the historical empty prefix)
        for key, _ent in others:
            if key.startswith(old_prefix):
                rc.rekey(key, new_prefix + key[len(old_prefix):])
        rc.rebuild_stale(
            lambda k: (new_prefix + k[len(old_prefix):]
                       if k.startswith(old_prefix) else k), deps)
        # the catalog rebind itself — DIRECT, not register(): the
        # dependent entries were just maintained or killed above;
        # register()'s blanket invalidation would kill the patches
        sess.catalog[name] = new
        sess._delta_gen = gen
        # reconcile the patch-plan cache against the LIVE entry set:
        # entries killed above, evicted under byte pressure, or
        # invalidated by a plain register() since the last delta leave
        # orphaned PatchPrograms whose plans pin old-generation device
        # arrays — unbounded over a long session (an unbounded-growth
        # class), so they drop the moment their entry is gone
        live = {e.ivm_id for _k, e in rc.items_snapshot()
                if e.ivm_id is not None}
        self._programs = {i: p for i, p in self._programs.items()
                          if i in live}
        record = {
            "name": name, "gen": gen, "delta_kind": delta.kind,
            "delta_rank": delta.rank, "delta_nnz": delta.nnz,
            "examined": len(dependents),
            "patched": counters["patched"],
            "killed": counters["killed"],
            "priced_out": counters["priced_out"],
            "reused_plans": counters["reused_plans"],
            "rekeyed": len(others),
            "rules": rules_census,
            "est_saved_flops": round(saved_total, 1),
            "ms": round((_now() - t0) * 1e3, 3),
        }
        sess._emit_delta_event(record)
        return record

    # -- one entry ----------------------------------------------------------

    def _patch_entry(self, key: str, ent: CacheEntry, old, new,
                     delta, gen: int, new_prefix: str,
                     known: Dict[str, tuple],
                     rules_census: Dict[str, int],
                     counters: dict) -> Tuple[bool, float]:
        from matrel_tpu_torch import executor as executor_lib
        sess = self.sess
        cfg = sess.config
        mesh = sess.mesh
        ck = delta_lib.core_key(ent.expr, frozenset({id(old)}))
        prog = (self._programs.get(ent.ivm_id)
                if ent.ivm_id is not None else None)
        out_bm = None
        meta: Optional[PatchProgram] = None
        if prog is not None \
                and prog.signature == (delta.signature(), ck) \
                and all(k in known for k in prog.known_keys):
            # steady state: same entry, same-shaped delta, siblings
            # available — rebind the dynamic leaves and re-run
            try:
                bindings = self._bindings(prog, ent, old, new, delta,
                                          known)
                out_bm = self._wrap(prog.plan.run(bindings=bindings))
                meta = prog
                self.stats["patch_reuses"] += 1
                counters["reused_plans"] += 1
            except (KeyError, ValueError):
                out_bm = None       # shape/sibling drift: recompile
        if out_bm is None:
            spec = delta_lib.derive_patch(ent.expr, old, new, delta,
                                          ent.result, mesh, cfg, known)
            if spec is None:
                return False, 0.0
            if not self._decide(spec, ent, cfg, mesh):
                counters["priced_out"] += 1
                return False, 0.0
            if spec.refine is not None:
                res = spec.refine(ent.result, new, delta)
                out_bm = self._wrap(res)
                meta = PatchProgram(
                    plan=None, binds=(), signature=(None,),
                    known_keys=(), rule=spec.rule, rules=spec.rules,
                    est_patch_flops=spec.est_patch_flops,
                    est_full_flops=spec.est_full_flops,
                    err_bound=spec.err_bound)
            else:
                stamp = {"rule": spec.rule, "gen": gen,
                         "est_saved_flops": spec.est_saved_flops}
                plan = executor_lib.compile_expr(
                    spec.expr.with_attrs(ivm_patch=stamp), mesh, cfg)
                # provenance for obs/explain: plan_matmul_decisions
                # threads this onto every decision record as
                # delta_est_saved_flops (the root stamp may not
                # survive the optimizer's rebuild — meta always does)
                plan.meta["ivm"] = dict(stamp)
                out_bm = self._wrap(plan.run())
                _release_rebound(plan)
                self.stats["patch_compiles"] += 1
                meta = PatchProgram(
                    plan=plan,
                    binds=tuple(
                        (l.uid, tuple(l.attrs["ivm_role"]))
                        for l in plan.leaf_order
                        if "ivm_role" in l.attrs),
                    signature=(delta.signature(), ck),
                    known_keys=spec.known_keys,
                    rule=spec.rule, rules=spec.rules,
                    est_patch_flops=spec.est_patch_flops,
                    est_full_flops=spec.est_full_flops,
                    err_bound=spec.err_bound,
                    rebindable=spec.rebindable)
        for r, n in meta.rules.items():
            rules_census[r] = rules_census.get(r, 0) + n
        rules_census[meta.rule] = rules_census.get(meta.rule, 0)
        # re-key under the new binding: the substituted expression is
        # structurally what a re-run query over the new catalog value
        # computes, so the patched entry answers it with a plain hit
        from matrel_tpu_torch import session as session_lib
        from matrel_tpu_torch.ir import expr as expr_mod
        from matrel_tpu_torch.parallel import planner
        sub_expr = delta_lib.substitute(ent.expr, old, new)
        structural, pins = session_lib._plan_key(sub_expr)
        new_key = new_prefix + ent.prec + structural
        ivm_id = ent.ivm_id if ent.ivm_id is not None \
            else next(self._ivm_ids)
        new_ent = dataclasses.replace(
            ent,
            key_hash=hashlib.sha1(new_key.encode()).hexdigest()[:16],
            result=out_bm,
            pins=tuple(pins),
            dep_ids=(ent.dep_ids - {id(old)}) | {id(new)},
            layout=planner._layout_of(expr_mod.leaf(out_bm), mesh),
            dtype=session_lib._dtype_name(out_bm.dtype),
            nbytes=result_nbytes(out_bm),
            expr=sub_expr,
            err_bound=ent.err_bound + meta.err_bound,
            delta_gen=gen,
            delta_rule=meta.rule,
            ivm_id=ivm_id)
        ok = sess._result_cache.apply_patch(
            key, new_key, new_ent, cfg.result_cache_max_bytes,
            cfg.result_cache_max_entries)
        if not ok:
            self._programs.pop(ivm_id, None)
            return False, 0.0
        if sess._prov is not None:
            # one lineage link per applied patch (the chain and the
            # composed bound live on the ledger, the stamp on the entry)
            sess._prov.stamp_patched(new_ent, gen, meta.rule,
                                     meta.err_bound)
        if meta.plan is not None and meta.rebindable:
            # a plan over baked sparse payloads (the S×S form) would
            # answer the next same-signature delta with this one's
            # payloads: only rebindable plans are kept for reuse
            self._programs[ivm_id] = meta
        else:
            self._programs.pop(ivm_id, None)
        counters["patched"] += 1
        known[ck] = (ent.result, out_bm)
        return True, meta.est_full_flops - meta.est_patch_flops

    # -- helpers ------------------------------------------------------------

    def _wrap(self, res):
        """Refine hooks may hand back host arrays or tensors; patch
        plans hand BlockMatrices. One canonical form enters the cache: a
        host array is uploaded, a tensor stays on its device."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        if isinstance(res, BlockMatrix):
            return res
        if not isinstance(res, torch.Tensor):
            arr = np.asarray(res)
            if arr.ndim == 1:
                arr = arr.reshape(-1, 1)
            return BlockMatrix.from_numpy(arr, mesh=self.sess.mesh,
                                          config=self.sess.config)
        return _tensor_block(res.detach(), self.sess.mesh,
                             self.sess.config)

    def _bindings(self, prog: PatchProgram, ent: CacheEntry, old, new,
                  delta, known: Dict[str, tuple]) -> dict:
        cfg = self.sess.config
        mesh = self.sess.mesh
        fac = delta.factors(mesh, cfg)
        fixed = {
            delta_lib.ROLE_TARGET_OLD: old,
            delta_lib.ROLE_TARGET_NEW: new,
            delta_lib.ROLE_OLD_RESULT: ent.result,
        }
        out = {}
        for uid, role in prog.binds:
            head = role[0]
            if head == "factor_u":
                if fac is None:
                    raise ValueError("delta lost its factored form")
                bm = fac[0]
            elif head == "factor_v":
                if fac is None:
                    raise ValueError("delta lost its factored form")
                bm = fac[1]
            elif head == "delta_dense":
                bm = delta.materialize(mesh, cfg)
            elif head == "known_old":
                bm = known[role[1]][0]
            elif head == "known_new":
                bm = known[role[1]][1]
            else:
                bm = fixed[tuple(role)]
            out[uid] = bm
        return out

    def _decide(self, spec: delta_lib.PatchSpec, ent: CacheEntry,
                cfg, mesh) -> bool:
        """Patch-vs-recompute: the flop estimate decides, a measured
        autotune ``ivm|`` winner overrides it (the fuse| precedent).
        Measurement itself happens lazily through the bench/soak
        harnesses (autotune.lookup_or_measure_ivm with runners) — the
        hot register path only ever LOOKS UP."""
        if cfg.delta_patch_mode == "force":
            return True
        # ties favor the patch: at equal flops the patched entry still
        # amortizes compiles (the recompute arm recompiles every
        # generation — rebinding changes every plan key) and keeps the
        # cache warm
        est_win = spec.est_saved_flops >= 0.0
        if cfg.autotune:
            from matrel_tpu_torch.parallel import autotune
            side = max(ent.result.shape[0], ent.result.shape[1],
                       *spec_shape(spec))
            winner = autotune.lookup_or_measure_ivm(
                spec.rule, side, mesh, cfg)
            if winner in ("patch", "recompute"):
                self.stats["measured_overrides"] += 1
                return winner == "patch"
        return est_win


def _release_rebound(plan) -> None:
    """Swap the matrix of every rebound (``ivm_role``) leaf of a kept
    patch plan for a shape-only stand-in on the ``meta`` device: every
    later run binds all of them, so the plan must not keep the first
    generation's tensors alive. Leaves without a role (operands the
    delta does not touch) keep their matrices."""
    for leaf in plan.leaf_order:
        if "ivm_role" not in leaf.attrs:
            continue
        m = leaf.attrs["matrix"]
        data = getattr(m, "data", None)
        if isinstance(data, torch.Tensor) and data.device.type != "meta":
            leaf.attrs["matrix"] = dataclasses.replace(
                m, data=torch.empty(data.shape, dtype=data.dtype,
                                    device="meta"))


def spec_shape(spec: delta_lib.PatchSpec) -> tuple:
    e = spec.expr
    return tuple(e.shape) if e is not None else (1, 1)


def _expr_size(e) -> int:
    if e is None:
        return 0
    seen = set()

    def walk(n) -> int:
        if n.uid in seen:
            return 0
        seen.add(n.uid)
        return 1 + sum(walk(c) for c in n.children)

    return walk(e)


def _tensor_block(t: torch.Tensor, mesh, cfg):
    """A refine hook's tensor as a BlockMatrix on the tensor's own
    device, with ``BlockMatrix.from_numpy``'s dtype, padding, spec and
    integer metadata."""
    from matrel_tpu_torch.core import padding
    from matrel_tpu_torch.core.blockmatrix import (BlockMatrix,
                                                   as_torch_dtype)
    from matrel_tpu_torch.core.mesh import P
    if t.dim() == 1:
        t = t.reshape(-1, 1)
    if t.dim() != 2:
        raise ValueError(f"BlockMatrix is 2D; got shape {tuple(t.shape)}")
    integral = not (t.dtype.is_floating_point or t.dtype.is_complex)
    int_abs_max = ((float(t.abs().max()) if t.numel() else 0.0)
                   if integral else None)
    shape = tuple(t.shape)
    ps = padding.padded_shape(shape, mesh)
    spec = P(*padding.canonical_spec(ps, mesh))
    data = torch.zeros(ps, dtype=as_torch_dtype(cfg.default_dtype),
                       device=t.device)
    data[: shape[0], : shape[1]] = t
    return BlockMatrix(data=BlockMatrix._place(data, mesh, spec),
                       shape=shape, mesh=mesh, spec=spec,
                       block_size=cfg.block_size, integral=integral,
                       int_abs_max=int_abs_max)
