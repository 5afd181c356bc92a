"""lockcheck — static lock-order analyzer for the port's serve / fleet
concurrency plane (the LK1xx rule family); the port of the JAX package's
``tools/lockcheck.py``, the static half of the race drill
(:mod:`.race_drill`). It derives the INTERPROCEDURAL lock-nesting graph
and proves order / hold-span properties over it.

lockcheck inventories every lock the lockdep seam
(``utils/lockdep.py``'s ``make_lock`` / ``make_rlock``) constructs,
resolves ``with`` blocks to those locks through the call graph, and
flags:

  LK101  lock-order cycle: two locks observed nesting in both orders
         across any pair of code paths — a schedule exists that
         deadlocks (the static half of lockdep's inversion check)
  LK102  blocking call while holding a lock: a device sync
         (``torch.cuda.synchronize``, ``Event.synchronize``,
         ``block_until_ready``), a device-to-host read (``.item()``,
         ``.cpu()``, ``.tolist()``, ``.to_numpy``), a host-side
         ``torch.distributed`` exchange (collectives, ``barrier``,
         ``*_object``: a lock held across a gloo exchange hangs every
         rank that needs it), ``Future.result``, ``Thread.join`` /
         queue joins, ``time.sleep`` — directly or through any
         transitive callee (the drain-wedge class). Locks constructed
         with ``dispatch_ok=True`` (the fleet's dispatch-to-completion
         arbitration) are sanctioned and exempt.
  LK103  shared attribute written from two or more declared thread
         roots (serve worker, drain sync, fleet router, replication
         daemon, done-callbacks, metrics exporter, re-plan warm — the
         THREAD_ROOTS table) with no common lock guarding every write
         site
  LK104  double-acquisition of a non-reentrant Lock on any path
         (directly nested ``with``, or a call whose transitive
         acquisition set re-takes a plain Lock already held)

Usage (a static pass over the source: no device is touched):
    python -m matrel_tpu_torch.tools.lockcheck           # scan matrel_tpu_torch/, rc 1 on findings
    python -m matrel_tpu_torch.tools.lockcheck --list-rules
    python -m matrel_tpu_torch.tools.lockcheck --graph   # dump the nesting graph

Suppression: append ``# lockcheck: disable=LK102 <why>`` to the line
the finding anchors on (comma-separated codes; justification prose
mandatory by convention). The repo-wide run over the port
(tests/test_torch_lockcheck.py) stays green only through deliberate,
reviewable suppressions.

Soundness notes (deliberate approximations, documented for the
reviewer): acquisition via bare ``.acquire()`` calls is not modeled
(the package idiom is ``with``); calls are resolved for ``self.m()``,
same-module ``f()`` and lexically-nested functions — foreign-object
calls (``pipe.readmit_entry()``) resolve only through the ALIASES
table, so the graph under-approximates across objects it cannot
type; a ``with obj.attr:`` whose attribute is not unique package-wide
and not aliased becomes an AMBIGUOUS hold — counted for LK102 hold
spans, excluded from LK101/LK104 edges (a wrong edge would fabricate
deadlocks).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_PATHS = ("matrel_tpu_torch",)

_SUPPRESS_RE = re.compile(r"#\s*lockcheck:\s*disable=([A-Za-z0-9_,\s]+)")

#: Declared thread entry points (the LK103 root table): qualnames per
#: root, or "*" for every function in the module. An attribute
#: written from >= 2 distinct roots with no common guard is a data
#: race candidate. Fixture tests pass their own table.
THREAD_ROOTS: Dict[str, Sequence[Tuple[str, str]]] = {
    "serve_worker": (("matrel_tpu_torch/serve/pipeline.py",
                      "ServePipeline._run"),),
    "drain_sync": (("matrel_tpu_torch/serve/pipeline.py", "_sync"),),
    "router": (("matrel_tpu_torch/serve/fleet.py",
                "FleetController._run_router"),),
    "replication": (("matrel_tpu_torch/serve/fleet.py",
                     "FleetController._maybe_replicate.<locals>._run"),
                    ("matrel_tpu_torch/serve/fleet.py",
                     "FleetController._replicate_entry")),
    "finalizer": (("matrel_tpu_torch/serve/fleet.py",
                   "FleetController._track_insert.<locals>._done"),),
    "exporter": (("matrel_tpu_torch/obs/export.py", "*"),),
    "replan_warm": (("matrel_tpu_torch/serve/replan.py",
                     "ReplanController._spawn_warm.<locals>.warm"),),
}

#: Foreign-receiver lock resolution: (module relpath, dotted source
#: text) -> declared lock name. The one place cross-object knowledge
#: is stated instead of inferred (the THREAD_ROOTS discipline).
ALIASES: Dict[Tuple[str, str], str] = {
    ("matrel_tpu_torch/serve/fleet.py", "pipe._lock"): "serve.pipeline",
    # the session's _exec_lock is the fleet's (FleetController hands it
    # to the parent and every slice); RankGroups has an _exec_lock of its
    # own, so the bare attribute is not unique package-wide
    ("matrel_tpu_torch/session.py", "self._exec_lock"): "fleet.exec",
}

#: LK102 blocking vocabulary: dotted-tail -> label. ``.join`` is
#: special-cased in ``_is_blocking`` (str.join excluded by arg shape),
#: and so are the torch.distributed exchanges (:data:`_DIST_TAILS`).
#: The JAX package's words stay (the port's ``BlockMatrix`` keeps
#: ``block_until_ready`` and ``to_numpy``); the rest are their torch
#: counterparts: a device sync, or a read that waits for the card.
_BLOCKING_TAILS = {
    "block_until_ready": "device sync",
    "synchronize": "device sync",
    "item": "device-to-host read",
    "cpu": "device-to-host read",
    "tolist": "device-to-host read",
    "result": "Future.result",
    "sleep": "time.sleep",
    "to_numpy": "host transfer",
}

#: Host-side torch.distributed exchanges: every rank of the group waits
#: in them for the others. Matched on a ``dist.`` / ``torch.distributed.``
#: receiver; ``barrier`` and the object exchanges (``*_object``,
#: ``*_object_list``) on any receiver.
_DIST_TAILS = frozenset((
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
    "all_to_all", "all_to_all_single", "send", "recv", "barrier",
    "monitored_barrier", "all_gather_object", "broadcast_object_list",
    "gather_object", "scatter_object_list", "send_object_list",
    "recv_object_list"))


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class LockDecl:
    """One inventoried lock (named apart from ``threading.Lock`` so the
    analyzer's own source never reads as a lock construction). ``lid`` is
    the declared seam name
    (make_lock("fleet.directory")) or the derived ``Class.attr`` /
    ``module:var`` id for bare constructions (fixtures)."""
    lid: str
    reentrant: bool
    dispatch_ok: bool
    module: str
    line: int
    ambiguous: bool = False


_AMBIGUOUS = LockDecl("?", reentrant=True, dispatch_ok=False,
                      module="?", line=0, ambiguous=True)


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return (base + "." if base else ".") + node.attr
    return ""


def _lock_ctor(call: ast.Call) -> Optional[Tuple[bool, Optional[str],
                                                 bool]]:
    """(reentrant, declared_name, dispatch_ok) when ``call`` builds a
    lock through the seam or bare threading — else None."""
    tail = _dotted(call.func).rsplit(".", 1)[-1]
    if tail in ("make_lock", "make_rlock"):
        name = None
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            name = call.args[0].value
        ok = any(k.arg == "dispatch_ok"
                 and isinstance(k.value, ast.Constant)
                 and bool(k.value.value) for k in call.keywords)
        return (tail == "make_rlock", name, ok)
    if _dotted(call.func) in ("threading.Lock", "threading.RLock",
                              "Lock", "RLock"):
        return (tail == "RLock", None, False)
    return None


def _is_blocking(call: ast.Call) -> Optional[str]:
    """LK102 vocabulary match (label) or None."""
    dotted = _dotted(call.func)
    tail = dotted.rsplit(".", 1)[-1]
    if tail in _DIST_TAILS:
        recv = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        if (recv in ("dist", "torch.distributed")
                or recv.endswith(".distributed")
                or tail in ("barrier", "monitored_barrier")
                or tail.endswith(("_object", "_object_list"))):
            return "torch.distributed exchange"
    if tail in _BLOCKING_TAILS:
        # plain attribute access `fut.result` (no call) never gets
        # here; `.result()` with args is still Future.result(timeout)
        return _BLOCKING_TAILS[tail]
    if tail == "join":
        # exclude str.join: a str-literal receiver, or a single
        # positional argument that is an iterable display /
        # comprehension / string (the separator.join(parts) shape) —
        # Thread/queue joins take nothing, a numeric timeout, or
        # timeout=
        func = call.func
        if isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Constant):
            return None
        if _dotted(func).endswith("path.join") or len(call.args) > 1:
            return None     # os.path.join — not a thread/queue join
        if len(call.args) == 1 and not call.keywords:
            a = call.args[0]
            if isinstance(a, (ast.List, ast.Tuple, ast.GeneratorExp,
                              ast.ListComp, ast.SetComp)):
                return None
            if isinstance(a, ast.Constant) \
                    and not isinstance(a.value, (int, float)):
                return None
        return "join"
    return None


@dataclasses.dataclass
class FuncInfo:
    module: str
    qual: str
    cls: Optional[str]
    node: ast.AST
    # populated by the scan:
    acquires: List[Tuple[LockDecl, int]] = dataclasses.field(
        default_factory=list)
    calls: List[Tuple[str, Tuple[str, ...], int]] = dataclasses.field(
        default_factory=list)       # (callee_key_or_"", held lids, line)
    blocking: List[Tuple[str, Tuple[str, ...], int]] = \
        dataclasses.field(default_factory=list)  # (label, held, line)
    writes: List[Tuple[str, Tuple[str, ...], int]] = \
        dataclasses.field(default_factory=list)  # (attr, held, line)
    edges: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)       # (held lid, acquired lid, line)
    double: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)       # (lid, line) direct re-acquire


class Analyzer:
    """Whole-package pass: inventory -> per-function scan -> call-
    graph fixpoint -> LK101..LK104 findings."""

    def __init__(self, files: Dict[str, ast.Module],
                 thread_roots=None, aliases=None):
        self.files = files
        self.thread_roots = (THREAD_ROOTS if thread_roots is None
                             else thread_roots)
        self.aliases = ALIASES if aliases is None else aliases
        self.locks: Dict[str, LockDecl] = {}        # lid -> LockDecl
        self.by_class_attr: Dict[Tuple[str, str], str] = {}
        self.by_attr: Dict[str, Set[str]] = {}
        self.by_module_var: Dict[Tuple[str, str], str] = {}
        # conditions: (class, attr) / attr -> underlying lock lid
        self.cond_by_class_attr: Dict[Tuple[str, str], str] = {}
        self.cond_by_attr: Dict[str, Set[str]] = {}
        self.funcs: Dict[Tuple[str, str], FuncInfo] = {}
        self.findings: List[Finding] = []

    # -- pass 1: lock + function inventory -----------------------------------

    def _inventory(self) -> None:
        for mod, tree in self.files.items():
            for cls, fn, node in _iter_funcs(tree):
                self.funcs[(mod, fn)] = FuncInfo(mod, fn, cls, node)
            for cls_name, target, call, line in _iter_lock_decls(tree):
                ctor = _lock_ctor(call)
                if ctor is not None:
                    reentrant, name, ok = ctor
                    lid = name or (f"{cls_name}.{target}" if cls_name
                                   else f"{mod}:{target}")
                    lk = LockDecl(lid, reentrant, ok, mod, line)
                    self.locks.setdefault(lid, lk)
                    if cls_name:
                        self.by_class_attr[(cls_name, target)] = lid
                        self.by_attr.setdefault(target, set()).add(lid)
                    else:
                        self.by_module_var[(mod, target)] = lid
                        self.by_attr.setdefault(target, set()).add(lid)
                    continue
                if _dotted(call.func).rsplit(".", 1)[-1] == "Condition" \
                        and call.args:
                    under = self._resolve_expr(call.args[0], mod,
                                               cls_name)
                    if under is not None and not under.ambiguous:
                        if cls_name:
                            self.cond_by_class_attr[
                                (cls_name, target)] = under.lid
                        self.cond_by_attr.setdefault(
                            target, set()).add(under.lid)

    # -- lock-expression resolution ------------------------------------------

    def _resolve_expr(self, expr: ast.AST, mod: str,
                      cls: Optional[str]) -> Optional[LockDecl]:
        """``with EXPR:`` -> LockDecl, _AMBIGUOUS, or None (not a lock)."""
        dotted = _dotted(expr)
        if not dotted:
            return None
        alias = self.aliases.get((mod, dotted))
        if alias is not None:
            return self.locks.get(alias, _AMBIGUOUS)
        if isinstance(expr, ast.Name):
            lid = self.by_module_var.get((mod, expr.id))
            return self.locks[lid] if lid else None
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and cls is not None:
            lid = self.by_class_attr.get((cls, attr))
            if lid:
                return self.locks[lid]
            cid = self.cond_by_class_attr.get((cls, attr))
            if cid:
                return self.locks[cid]
        # foreign receiver (or self in an unindexed class): unique-
        # attribute resolution across the package, else ambiguous —
        # but ONLY for lock-looking attributes; `with self._q.
        # all_tasks_done:` resolves through the condition index
        cands = self.by_attr.get(attr, set())
        if len(cands) == 1:
            return self.locks[next(iter(cands))]
        ccands = self.cond_by_attr.get(attr, set())
        if len(ccands) == 1:
            return self.locks[next(iter(ccands))]
        if cands or ccands or attr.endswith("lock") \
                or attr.startswith("_lock"):
            return _AMBIGUOUS
        return None

    # -- pass 2: per-function scan -------------------------------------------

    def _scan_all(self) -> None:
        for info in self.funcs.values():
            held: List[LockDecl] = []
            for st in info.node.body:
                self._scan(st, held, info)

    def _scan(self, node: ast.AST, held: List[LockDecl],
              info: FuncInfo) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return      # deferred execution: scanned as its own node
        if isinstance(node, ast.With):
            pushed = 0
            for item in node.items:
                self._scan(item.context_expr, held, info)
                lk = self._resolve_expr(item.context_expr, info.module,
                                        info.cls)
                if lk is None:
                    continue
                line = item.context_expr.lineno
                if not lk.ambiguous:
                    info.acquires.append((lk, line))
                    for h in held:
                        if h.ambiguous or h.lid == lk.lid:
                            continue
                        info.edges.append((h.lid, lk.lid, line))
                    if not lk.reentrant and any(
                            h.lid == lk.lid for h in held):
                        info.double.append((lk.lid, line))
                held.append(lk)
                pushed += 1
            for st in node.body:
                self._scan(st, held, info)
            del held[len(held) - pushed:]
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    t = t.value
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" \
                        and info.cls is not None \
                        and not info.qual.endswith("__init__"):
                    info.writes.append(
                        (t.attr, tuple(h.lid for h in held),
                         node.lineno))
        if isinstance(node, ast.Call):
            callee = self._resolve_call(node, info)
            info.calls.append((callee,
                               tuple(h.lid for h in held),
                               node.lineno))
            label = _is_blocking(node)
            if label is not None:
                info.blocking.append(
                    (label, tuple(h.lid for h in held), node.lineno))
        for child in ast.iter_child_nodes(node):
            self._scan(child, held, info)

    def _resolve_call(self, call: ast.Call, info: FuncInfo) -> str:
        """Callee key "module|qual" or "" when unresolvable."""
        func = call.func
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self" and info.cls is not None:
            key = (info.module, f"{info.cls}.{func.attr}")
            if key in self.funcs:
                return f"{key[0]}|{key[1]}"
        elif isinstance(func, ast.Name):
            # lexically nested first (the closure-call idiom), then
            # module level
            parts = info.qual.split(".<locals>.")
            for depth in range(len(parts), 0, -1):
                nested = ".<locals>.".join(
                    parts[:depth] + [func.id])
                if (info.module, nested) in self.funcs:
                    return f"{info.module}|{nested}"
            if (info.module, func.id) in self.funcs:
                return f"{info.module}|{func.id}"
        return ""

    # -- pass 3: fixpoints ----------------------------------------------------

    def _fixpoints(self):
        acq: Dict[Tuple[str, str], Set[str]] = {}
        blk: Dict[Tuple[str, str], Optional[Tuple[str, int]]] = {}
        for key, info in self.funcs.items():
            acq[key] = {lk.lid for lk, _ in info.acquires}
            blk[key] = (info.blocking[0][:1] + (info.blocking[0][2],)
                        if info.blocking else None)
        changed = True
        while changed:
            changed = False
            for key, info in self.funcs.items():
                for callee, _, _ in info.calls:
                    if not callee:
                        continue
                    ck = tuple(callee.split("|", 1))
                    extra = acq.get(ck, set()) - acq[key]
                    if extra:
                        acq[key] |= extra
                        changed = True
                    if blk[key] is None and blk.get(ck) is not None:
                        blk[key] = blk[ck]
                        changed = True
        return acq, blk

    # -- pass 4: findings -----------------------------------------------------

    def run(self) -> List[Finding]:
        self._inventory()
        self._scan_all()
        acq_star, blk_star = self._fixpoints()

        # assemble the full edge set: direct nesting + held-across-call
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for key, info in self.funcs.items():
            for a, b, line in info.edges:
                edges.setdefault((a, b), (info.module, line))
            for callee, held, line in info.calls:
                if not callee or not held:
                    continue
                ck = tuple(callee.split("|", 1))
                for b in sorted(acq_star.get(ck, ())):
                    for a in held:
                        if a != b and not a.startswith("?"):
                            edges.setdefault((a, b),
                                             (info.module, line))
        self.edge_index = edges

        # LK101: cycles
        for cycle in _cycles({e for e in edges}):
            sites = sorted((edges[(a, b)], (a, b))
                           for a, b in zip(cycle, cycle[1:] + cycle[:1])
                           if (a, b) in edges)
            (mod, line), _ = sites[0]
            path = " -> ".join(cycle + [cycle[0]])
            self.findings.append(Finding(
                mod, line, "LK101",
                f"lock-order cycle {path}: these locks nest in both "
                f"orders across the code paths meeting here — a "
                f"thread interleaving exists that deadlocks; pick ONE "
                f"global order or break the nesting"))

        # LK102: blocking while holding (direct + via calls)
        for key, info in self.funcs.items():
            for label, held, line in info.blocking:
                eff = self._unsanctioned(held)
                if eff:
                    self.findings.append(Finding(
                        info.module, line, "LK102",
                        f"blocking call ({label}) while holding "
                        f"{_fmt(eff)} — the drain-wedge class: any "
                        f"thread needing the lock stalls behind "
                        f"device/host waits; move the wait outside "
                        f"the hold span"))
            for callee, held, line in info.calls:
                eff = self._unsanctioned(held)
                if not callee or not eff:
                    continue
                ck = tuple(callee.split("|", 1))
                b = blk_star.get(ck)
                if b is not None:
                    self.findings.append(Finding(
                        info.module, line, "LK102",
                        f"call into {ck[1]}() while holding "
                        f"{_fmt(eff)} — it blocks ({b[0]}, "
                        f"{ck[0]}:{b[1]}) with the lock still held; "
                        f"move the blocking work outside the hold "
                        f"span"))

        # LK104: double acquisition of a non-reentrant lock
        for key, info in self.funcs.items():
            for lid, line in info.double:
                self.findings.append(Finding(
                    info.module, line, "LK104",
                    f"non-reentrant lock {lid!r} re-acquired while "
                    f"already held — self-deadlock; make it an RLock "
                    f"(make_rlock) or hoist the outer hold"))
            for callee, held, line in info.calls:
                if not callee:
                    continue
                ck = tuple(callee.split("|", 1))
                for lid in held:
                    lk = self.locks.get(lid)
                    if (lk is not None and not lk.reentrant
                            and lid in acq_star.get(ck, ())):
                        self.findings.append(Finding(
                            info.module, line, "LK104",
                            f"call into {ck[1]}() re-acquires the "
                            f"non-reentrant lock {lid!r} already "
                            f"held here — self-deadlock on this "
                            f"path"))

        # LK103: shared writes from >= 2 thread roots, no common guard
        self._lk103()
        return sorted(self.findings,
                      key=lambda f: (f.path, f.line, f.rule))

    def _unsanctioned(self, held: Tuple[str, ...]) -> List[str]:
        out = []
        for lid in held:
            lk = self.locks.get(lid)
            if lk is not None and lk.dispatch_ok:
                continue
            out.append(lid)
        return out

    def _lk103(self) -> None:
        reach: Dict[Tuple[str, str], Set[str]] = {}
        for root, seeds in self.thread_roots.items():
            frontier = []
            for mod, qual in seeds:
                if qual == "*":
                    frontier.extend(k for k in self.funcs
                                    if k[0] == mod)
                elif (mod, qual) in self.funcs:
                    frontier.append((mod, qual))
            seen = set(frontier)
            while frontier:
                key = frontier.pop()
                reach.setdefault(key, set()).add(root)
                for callee, _, _ in self.funcs[key].calls:
                    if callee:
                        ck = tuple(callee.split("|", 1))
                        if ck in self.funcs and ck not in seen:
                            seen.add(ck)
                            frontier.append(ck)
        # (class, attr) -> [(roots, guards, module, line)]
        sites: Dict[Tuple[str, str], list] = {}
        for key, info in self.funcs.items():
            roots = reach.get(key)
            if not roots or info.cls is None:
                continue
            for attr, held, line in info.writes:
                sites.setdefault((info.cls, attr), []).append(
                    (roots, set(held), info.module, line))
        for (cls, attr), ws in sorted(sites.items()):
            roots = set().union(*(w[0] for w in ws))
            if len(roots) < 2:
                continue
            common = set.intersection(*(w[1] for w in ws))
            if common:
                continue
            mod, line = ws[0][2], ws[0][3]
            self.findings.append(Finding(
                mod, line, "LK103",
                f"{cls}.{attr} written from {len(roots)} thread "
                f"roots ({', '.join(sorted(roots))}) with no common "
                f"guard across the write sites — a lost-update race; "
                f"guard every write with one lock (or confine the "
                f"attribute to one thread)"))


def _fmt(lids: Sequence[str]) -> str:
    return ", ".join(repr(x) for x in lids)


def _iter_funcs(tree: ast.Module) -> Iterator[
        Tuple[Optional[str], str, ast.AST]]:
    """(class, qualname, node) for every function incl. nested ones.
    Nested functions inherit the enclosing class for ``self``
    resolution (closures over methods — the replication daemon)."""

    def walk(node, cls, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, child.name, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                qual = (f"{prefix}.{child.name}" if prefix
                        else child.name)
                yield cls, qual, child
                yield from walk(child, cls, f"{qual}.<locals>")
            else:
                yield from walk(child, cls, prefix)

    yield from walk(tree, None, "")


def _iter_lock_decls(tree: ast.Module) -> Iterator[
        Tuple[Optional[str], str, ast.Call, int]]:
    """(class_or_None, attr_or_var, ctor_call, line) for every
    ``self.X = <ctor>`` / module-level ``V = <ctor>`` assignment."""
    for cls, qual, fnode in _iter_funcs(tree):
        for node in ast.walk(fnode):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call):
                t = node.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" and cls is not None:
                    yield cls, t.attr, node.value, node.lineno
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            yield (None, node.targets[0].id, node.value, node.lineno)


def _cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    """Elementary cycles, canonicalized + deduplicated (rotation-
    invariant), smallest first — Tarjan SCCs then one simple cycle
    per strongly-connected component pair."""
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    out = []
    seen = set()
    for a, b in sorted(edges):
        # a cycle through edge (a, b) exists iff b reaches a
        stack, visited, parent = [b], {b}, {}
        found = False
        while stack and not found:
            n = stack.pop()
            for m in sorted(adj.get(n, ())):
                if m == a:
                    parent[m] = n
                    found = True
                    break
                if m not in visited:
                    visited.add(m)
                    parent[m] = n
                    stack.append(m)
        if not found:
            continue
        # edge a->b, then b ~> a along the parent chain (recorded
        # child -> parent while searching forward from b)
        rev = []
        n = parent.get(a)
        while n is not None and n != b:
            rev.append(n)
            n = parent.get(n)
        cyc = [a, b] + rev[::-1]
        # canonical rotation for dedup
        i = cyc.index(min(cyc))
        canon = tuple(cyc[i:] + cyc[:i])
        if canon not in seen:
            seen.add(canon)
            out.append(list(canon))
    return sorted(out, key=lambda c: (len(c), c))


# -- file plumbing -------------------------------------------------------------

def _rel(path: str, root: str) -> str:
    try:
        return os.path.relpath(path, root)
    except ValueError:
        return path


def iter_python_files(paths: Sequence[str],
                      root: str = REPO) -> Iterator[str]:
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            yield full
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def _suppressed_codes(line: str) -> set:
    m = _SUPPRESS_RE.search(line)
    if not m:
        return set()
    return {tok for tok in re.split(r"[\s,]+", m.group(1))
            if re.fullmatch(r"LK\d+", tok)}


def analyze_paths(paths: Sequence[str] = DEFAULT_PATHS,
                  root: str = REPO, thread_roots=None, aliases=None,
                  ) -> List[Finding]:
    """Analyze a file set and return unsuppressed findings. The
    fixture-test entry point: tests point ``root`` at a tmp mini-
    package with their own roots/aliases tables."""
    files: Dict[str, ast.Module] = {}
    sources: Dict[str, List[str]] = {}
    findings: List[Finding] = []
    for f in iter_python_files(paths, root):
        rel = _rel(f, root)
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        try:
            files[rel] = ast.parse(src, filename=f)
        except SyntaxError as e:
            findings.append(Finding(rel, e.lineno or 0, "LK100",
                                    f"file does not parse: {e.msg}"))
            continue
        sources[rel] = src.splitlines()
    ana = Analyzer(files, thread_roots=thread_roots, aliases=aliases)
    for f in ana.run():
        lines = sources.get(f.path, ())
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        if f.rule in _suppressed_codes(line):
            continue
        findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def analyzer_for(paths: Sequence[str] = DEFAULT_PATHS,
                 root: str = REPO, thread_roots=None,
                 aliases=None) -> Analyzer:
    """The raw analyzer (post-run) — graph/inventory introspection
    for --graph and the lockcheck tests."""
    files = {}
    for f in iter_python_files(paths, root):
        with open(f, encoding="utf-8") as fh:
            try:
                files[_rel(f, root)] = ast.parse(fh.read(),
                                                 filename=f)
            except SyntaxError:
                continue
    ana = Analyzer(files, thread_roots=thread_roots, aliases=aliases)
    ana.run()
    return ana


_RULES = (
    ("LK101", "lock-order cycle in the interprocedural nesting graph"),
    ("LK102", "blocking call (device sync / device-to-host read / "
              "torch.distributed exchange / join / sleep) while holding "
              "a lock"),
    ("LK103", "shared attribute written from >= 2 thread roots with "
              "no common guard"),
    ("LK104", "double-acquisition of a non-reentrant Lock"),
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--list-rules" in argv:
        for rid, desc in _RULES:
            print(f"{rid}  {desc}")
        return 0
    paths = [a for a in argv if not a.startswith("-")] or list(
        DEFAULT_PATHS)
    if "--graph" in argv:
        ana = analyzer_for(paths)
        print(f"locks ({len(ana.locks)}):")
        for lid, lk in sorted(ana.locks.items()):
            print(f"  {lid}  {'RLock' if lk.reentrant else 'Lock'}"
                  f"{'  dispatch_ok' if lk.dispatch_ok else ''}"
                  f"  {lk.module}:{lk.line}")
        print(f"nesting edges ({len(ana.edge_index)}):")
        for (a, b), (mod, line) in sorted(ana.edge_index.items()):
            print(f"  {a} -> {b}  ({mod}:{line})")
        return 0
    findings = analyze_paths(paths)
    for f in findings:
        print(f.render())
    print(f"lockcheck: {len(findings)} finding(s) in scan set "
          f"{tuple(paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
