"""Whole-plan fusion — the counterpart of ``matrel_tpu/ir/fusion.py``:
region segmentation over annotated plans.

Segments an annotated plan into FUSABLE REGIONS — connected subgraphs
of elementwise chains, scalar ops and reductions, each optionally
anchored on ONE producer matmul/SpGEMM whose epilogue the region
becomes — and stamps each region on its root node, so that

* the executor (``executor.Lowerer``) lowers the whole region as one
  evaluation, with the member chain above the anchor handed to the
  producing contraction through its epilogue slot (the SpGEMM's
  per-structure hook in ``ops/kernel_registry.py`` over B4–B7's tile
  stack, ``ops/spmm.apply``'s slot over B1's output,
  ``strategies.run_matmul``'s slot, or the finished output of the COO
  SpMV stack over B2),
* ``executor.compile_region_units`` emits one unit program (one Python
  callable over tensors) per region against ``compile_staged_units``'
  one per physical op,
* ``planner.matmul_decisions`` records the chosen boundary
  (``fused_region``, member census, ``est_saved_dispatches`` /
  ``est_saved_hbm_bytes``).

An epilogue is an arbitrary closure over member lowerings, so it runs
as torch ops over the kernel's output, never inside a CUDA body (the
JAX package likewise applies it in XLA, outside the ``pallas_call``).

With ``config.autotune`` on, ``parallel/autotune.lookup_or_measure_fusion``
measures fused-vs-staged per region shape class (the ``fuse|`` key
family) and a measured "staged" winner suppresses the stamp.

``config.fusion_enable`` (default False) gates everything here: off,
``segment`` returns ``[]`` without constructing a single
:class:`FusedRegion` (``_CONSTRUCTED`` is the test hook pinning that),
``annotate_fusion`` returns the tree untouched, and the engine is
identical to the per-op path.

Region grammar (the JAX package's docs/FUSION.md):

* FUSABLE kinds: ``elemwise``, ``scalar``, ``agg``, ``select_value``,
  ``select_index`` — the zero-padding-aware pointwise/reduction
  lowerings. Layout ops (``transpose``, ``vec``), joins and solves are
  boundaries.
* A region ROOT is a fusable node that no fusable parent absorbs
  (parent not fusable, or the node has ≠ 1 consumers).
* A member absorbs a CHILD when the child is fusable and has exactly
  one consumer in the plan (shared DAG nodes are boundaries — the
  executor memoises their value once).
* At most ONE matmul anchor per region: a single-consumer matmul child
  of a member is absorbed as the region's producer; the member chain
  ABOVE it becomes the kernel epilogue, fusable single-consumer
  children BELOW it (operand prologues, e.g. PageRank's ``w·r``) join
  the region program. Nothing is absorbed past a second matmul.
* A region needs ≥ 2 members — a lone fusable op has nothing to fuse.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core import padding
from matrel_tpu_torch.ir.expr import MatExpr

#: Node kinds a region may absorb as members.
FUSABLE_KINDS = ("elemwise", "scalar", "agg", "select_value",
                 "select_index")

#: Node kinds that may anchor a region as its producer contraction.
ANCHOR_KINDS = ("matmul",)

#: Test/obs hook: how many FusedRegion objects were ever constructed.
#: The bit-identity contract says ZERO with ``fusion_enable`` off —
#: the default compile path must not even build region objects
#: (the kernel_registry._LOOKUPS idiom; test-enforced).
_CONSTRUCTED = {"count": 0}


@dataclasses.dataclass(frozen=True)
class FusedRegion:
    """One fusable region of an annotated plan.

    ``root_uid`` is the region's output node; ``member_uids`` every
    member EXCLUDING the root (the root's own uid changes when the
    stamp is applied, so it is implicit); ``anchor_uid`` the producer
    matmul absorbed into the region (or None for matmul-free
    elementwise/reduction chains). ``sig`` is the canonical census
    signature used by autotune ``fuse|`` keys (and the JAX package's
    drift rows, ``fused:<sig>``) — '|'-free by construction (it embeds
    in '|'-separated table keys)."""

    root_uid: int
    member_uids: Tuple[int, ...]
    anchor_uid: Optional[int]
    sig: str
    census: Dict[str, int]
    n_remask: int
    saved_dispatches: int
    saved_hbm_bytes: float

    def __post_init__(self):
        _CONSTRUCTED["count"] += 1


def op_label(n: MatExpr) -> str:
    """Census label for one member: the kind, qualified by the
    sub-operation where one kind covers several (``elemwise.mul``,
    ``scalar.add``, ``agg.sum``; ``mm`` for the anchor)."""
    if n.kind == "matmul":
        return "mm"
    if n.kind == "elemwise":
        return f"elemwise.{n.attrs['op']}"
    if n.kind == "scalar":
        return f"scalar.{n.attrs['op']}"
    if n.kind == "agg":
        return f"agg.{n.attrs['agg']}"
    return n.kind


def region_sig(census: Dict[str, int]) -> str:
    """Canonical '|'-free signature of a census (sorted, stable across
    sessions — the autotune key / drift row identity)."""
    return "+".join(f"{k}x{v}" for k, v in sorted(census.items()))


def _fusable(n: MatExpr) -> bool:
    return n.kind in FUSABLE_KINDS


def remasks_padding(n: MatExpr) -> bool:
    """Does this member's lowering RE-MASK the zero-padding invariant
    (the executor's ``_mask_to_logical`` breakers)? The stamped count
    is what the JAX package's verifier (MV111) re-derives: a fused
    region must restore the invariant exactly where the staged path
    would."""
    if n.kind == "scalar":
        op, v = n.attrs["op"], n.attrs["value"]
        return (op == "add" and v != 0.0) or (op == "pow" and v <= 0)
    if n.kind == "elemwise":
        if n.attrs["op"] == "div":
            return True
        broadcast = n.children[0].shape != n.children[1].shape
        return broadcast and n.attrs["op"] != "mul"
    if n.kind == "select_value":
        return n.attrs["fill"] != 0.0
    if n.kind == "agg":
        return True          # aggregates mask the padded region
    return False


def consumer_counts(roots) -> Dict[int, int]:
    """uid -> number of consuming edges across every root tree (each
    plan output counts as one consumer of its root). Shared DAG nodes
    (count > 1) are region boundaries."""
    counts: Dict[int, int] = {}
    seen: set = set()

    def walk(n: MatExpr):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            counts[c.uid] = counts.get(c.uid, 0) + 1
            walk(c)

    for r in roots:
        counts[r.uid] = counts.get(r.uid, 0) + 1
        walk(r)
    return counts


def _is_region_root(n: MatExpr, counts: Dict[int, int],
                    parent_kinds: Dict[int, List[str]]) -> bool:
    """A fusable node roots a region unless exactly one fusable parent
    will absorb it (single consumer + fusable parent)."""
    if not _fusable(n):
        return False
    if counts.get(n.uid, 0) != 1:
        return True
    pk = parent_kinds.get(n.uid) or []
    return not (len(pk) == 1 and pk[0] in FUSABLE_KINDS)


def _gather(root: MatExpr, counts: Dict[int, int]):
    """(members incl. root, anchor or None) for the region rooted at
    ``root`` — the ONE derivation the executor's lowering and the
    unit-program seam read (through the stamp)."""
    members: Dict[int, MatExpr] = {root.uid: root}
    anchor: Optional[MatExpr] = None
    stack = [root]
    while stack:
        n = stack.pop()
        for c in n.children:
            if c.uid in members:
                continue
            if _fusable(c) and counts.get(c.uid, 0) == 1:
                members[c.uid] = c
                stack.append(c)
            elif (c.kind in ANCHOR_KINDS and anchor is None
                    and counts.get(c.uid, 0) == 1):
                anchor = c
                members[c.uid] = c
                stack.append(c)      # operand prologues may join too
    return members, anchor


def segment(root: MatExpr, config: Optional[MatrelConfig] = None,
            mesh=None) -> List[FusedRegion]:
    """The fusable regions of ONE annotated root, in deterministic
    (post-order) root order. ``[]`` — and zero FusedRegion
    constructions — when ``config.fusion_enable`` is off."""
    cfg = config or default_config()
    if not cfg.fusion_enable:
        return []
    counts = consumer_counts((root,))
    parent_kinds: Dict[int, List[str]] = {}
    order: List[MatExpr] = []
    seen: set = set()

    def walk(n: MatExpr):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            parent_kinds.setdefault(c.uid, []).append(n.kind)
            walk(c)
        order.append(n)

    walk(root)
    regions: List[FusedRegion] = []
    claimed: set = set()
    # root-most first: a nested fusable root inside another region's
    # member set can only arise via sharing, which _gather refuses, but
    # claim tracking keeps the regions provably disjoint regardless
    for n in reversed(order):
        if n.uid in claimed or not _is_region_root(n, counts,
                                                   parent_kinds):
            continue
        members, anchor = _gather(n, counts)
        if len(members) < 2:
            continue
        if any(u in claimed for u in members):
            continue
        claimed.update(members)
        census: Dict[str, int] = {}
        n_remask = 0
        saved_bytes = 0.0
        for m in members.values():
            lbl = op_label(m)
            census[lbl] = census.get(lbl, 0) + 1
            if remasks_padding(m):
                n_remask += 1
            if m.uid != n.uid and mesh is not None:
                # each absorbed member's intermediate no longer makes
                # an HBM round-trip: one write + one read of its
                # padded f32 array
                pn, pm = padding.padded_shape(m.shape, mesh)
                saved_bytes += 2.0 * pn * pm * 4
        regions.append(FusedRegion(
            root_uid=n.uid,
            member_uids=tuple(sorted(u for u in members
                                     if u != n.uid)),
            anchor_uid=anchor.uid if anchor is not None else None,
            sig=region_sig(census),
            census=census,
            n_remask=n_remask,
            saved_dispatches=len(members) - 1,
            saved_hbm_bytes=saved_bytes,
        ))
    return regions


def annotate_fusion(root: MatExpr, mesh,
                    config: Optional[MatrelConfig] = None) -> MatExpr:
    """Stamp every fusable region on its root node (``fused_region``,
    ``fused_members``, ``fused_anchor``, ``fused_census``,
    ``fused_tier``, ``fused_remask``, ``fused_saved_dispatches``,
    ``fused_saved_hbm_bytes``) — run AFTER ``annotate_strategies`` so
    anchors already carry their strategy/tier stamps. Identity (the
    same tree object) when fusion is off or nothing fuses.

    With ``config.autotune`` on, the boundary is a MEASURED decision:
    a ``fuse|<sig>|…`` table row whose winner is "staged" suppresses
    the stamp (the lookup_or_measure contract — the closed loop
    overrules the model)."""
    cfg = config or default_config()
    if not cfg.fusion_enable:
        return root
    regions = segment(root, cfg, mesh=mesh)
    if not regions:
        return root
    if cfg.autotune:
        from matrel_tpu_torch.parallel import autotune
        kept = []
        for r in regions:
            best = autotune.lookup_or_measure_fusion(r, root, mesh, cfg)
            if best != "staged":
                kept.append(r)
        regions = kept
        if not regions:
            return root
    by_root = {r.root_uid: r for r in regions}
    uidmap: Dict[int, int] = {}
    memo: Dict[int, MatExpr] = {}

    def rebuild(n: MatExpr) -> MatExpr:
        if n.uid in memo:
            return memo[n.uid]
        new_children = tuple(rebuild(c) for c in n.children)
        out = n
        if any(nc is not oc for nc, oc in zip(new_children, n.children)):
            out = n.with_children(new_children)
        r = by_root.get(n.uid)
        if r is not None:
            tier = None
            if r.anchor_uid is not None:
                anchor = _find_uid(n, r.anchor_uid)
                if anchor is not None:
                    tier = anchor.attrs.get("precision_tier")
            out = out.with_attrs(
                fused_region=r.sig,
                # member uids remapped through any nested restamp (a
                # region root BELOW one of this region's members gets
                # a fresh uid when its own stamp lands)
                fused_members=tuple(sorted(uidmap.get(u, u)
                                           for u in r.member_uids)),
                fused_anchor=uidmap.get(r.anchor_uid, r.anchor_uid),
                fused_census=dict(r.census),
                fused_tier=tier,
                fused_remask=r.n_remask,
                fused_saved_dispatches=r.saved_dispatches,
                fused_saved_hbm_bytes=r.saved_hbm_bytes,
            )
        if out is not n:
            uidmap[n.uid] = out.uid
        memo[n.uid] = out
        return out

    return rebuild(root)


def _find_uid(root: MatExpr, uid: int) -> Optional[MatExpr]:
    stack = [root]
    seen: set = set()
    while stack:
        n = stack.pop()
        if n.uid == uid:
            return n
        if n.uid in seen:
            continue
        seen.add(n.uid)
        stack.extend(n.children)
    return None


def region_nodes(root: MatExpr) -> Dict[int, MatExpr]:
    """uid -> node for a stamped region root's member set (root
    included) — the executor's region evaluator and the unit programs
    read the stamp through this one resolver."""
    member_uids = set(root.attrs.get("fused_members") or ())
    out = {root.uid: root}
    stack = [root]
    while stack:
        n = stack.pop()
        for c in n.children:
            if c.uid in member_uids and c.uid not in out:
                out[c.uid] = c
                stack.append(c)
    return out


def collect_stamps(root: MatExpr) -> List[MatExpr]:
    """Every node carrying a ``fused_region`` stamp under ``root``
    (dedup by uid, post-order)."""
    out: List[MatExpr] = []
    seen: set = set()

    def walk(n: MatExpr):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        if "fused_region" in n.attrs:
            out.append(n)

    walk(root)
    return out


def epilogue_elementwise_chain(root: MatExpr, members: Dict[int, MatExpr],
                               anchor_uid: int) -> bool:
    """Is the member chain ABOVE the anchor exclusively zero-preserving,
    shape-polymorphic pointwise ops (scalar mul / pow>0)? Then the
    kernel epilogue hook may apply it TILE-WISE (before the SpGEMM
    scatter — nnzb·bs² elements instead of n·m); anything else takes
    the dense post-scatter application (``kernel_registry``'s
    "dense" epilogue mode)."""
    on_chain: set = set()

    def walk(n: MatExpr) -> bool:
        """True when ``anchor_uid`` is reachable from n through
        members; collect the nodes on such paths."""
        if n.uid == anchor_uid:
            return True
        if n.uid not in members:
            return False
        hit = False
        for c in n.children:
            if walk(c):
                hit = True
        if hit:
            on_chain.add(n.uid)
        return hit

    walk(root)
    for uid in on_chain:
        m = members[uid]
        if m.kind != "scalar":
            return False
        op, v = m.attrs["op"], m.attrs["value"]
        if not (op == "mul" or (op == "pow" and v > 0)):
            return False
    return True
