"""MV107 — result-cache consumption stamps must match the cache.

A plan that consumes a materialized-result-cache entry carries the
substitution stamp the session wrote (``attrs["result_cache"]``: the
layout and dtype the cache RECORDED at insertion, plus the entry's key
hash). The planner credited the reuse on exactly that recorded
layout/dtype — so a stamp that no longer agrees with the leaf's ACTUAL
matrix means the plan was costed (and will be reported by obs) on a
premise the cache no longer backs. The classic shape is a stamp kept
alive across an invalidation: a catalog rebind dropped the entry, and
a replayed or hand-built plan still claims it.

Warning severity, the MV102/MV106 class: the lowering reads the REAL
matrix on the leaf, so execution is numerically correct either way —
what is wrong is the plan's description of itself.
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import (Diagnostic, dtype_name,
                                                   node_addr)

_FIX = ("re-run the query through the session so substitution "
        "re-stamps against the live cache entry")


def check_result_cache_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind == "leaf" and isinstance(
                n.attrs.get("result_cache"), dict):
            yield from _check_leaf(n, mesh)

    yield from walk(root)


def _check_leaf(n, mesh) -> Iterator[Diagnostic]:
    from matrel_tpu_torch.parallel import planner
    rec = n.attrs["result_cache"]
    m = n.attrs.get("matrix")
    actual_dtype = dtype_name(getattr(m, "dtype", None))
    actual_layout = planner._layout_of(n, mesh)
    stamped_layout = rec.get("layout")
    stamped_dtype = rec.get("dtype")
    if stamped_layout is not None and stamped_layout != actual_layout:
        yield Diagnostic(
            code="MV107", severity="warning", node=node_addr(n),
            message=(
                f"result-cache stamp claims layout {stamped_layout!r} "
                f"but the leaf's matrix lies {actual_layout!r} — the "
                f"planner credited a reuse the cache no longer backs "
                f"(stale stamp after invalidation?)"),
            fix_hint=_FIX)
    if stamped_dtype is not None and stamped_dtype != actual_dtype:
        yield Diagnostic(
            code="MV107", severity="warning", node=node_addr(n),
            message=(
                f"result-cache stamp claims dtype {stamped_dtype!r} "
                f"but the leaf's matrix carries {actual_dtype!r} — "
                f"autotune consults and HBM gates keyed on the wrong "
                f"itemsize"),
            fix_hint=_FIX)
