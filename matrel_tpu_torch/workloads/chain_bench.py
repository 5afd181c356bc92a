"""Matrix-chain workload — the counterpart of
``matrel_tpu/workloads/chain_bench.py`` (BASELINE row 2: A·B·C, skewed).

Builds a skewed chain through the IR so the DP reorders it, compiles
it, and reports which parenthesisation the optimizer chose.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.executor import CompiledPlan, compile_expr
from matrel_tpu_torch.ir import chain as chain_lib
from matrel_tpu_torch.ir.expr import MatExpr, matmul


def build_chain(mats: Sequence[BlockMatrix]) -> MatExpr:
    e = mats[0].expr()
    for m in mats[1:]:
        e = matmul(e, m.expr())
    return e


def parenthesisation(e: MatExpr) -> str:
    """Render the matmul tree structure, e.g. '((A·B)·C)'."""
    names = {}

    def walk(n: MatExpr) -> str:
        if n.kind == "matmul":
            return f"({walk(n.children[0])}·{walk(n.children[1])})"
        if n.kind == "leaf":
            if n.uid not in names:
                names[n.uid] = chr(ord("A") + len(names))
            return names[n.uid]
        return f"{n.kind}[{walk(n.children[0]) if n.children else ''}]"

    return walk(e)


def compile_chain(mats: Sequence[BlockMatrix],
                  config: Optional[MatrelConfig] = None
                  ) -> Tuple[CompiledPlan, str, float]:
    """Compile a chain; returns (plan, chosen parenthesisation, est
    cost)."""
    cfg = config or default_config()
    plan = compile_expr(build_chain(mats), mats[0].mesh, cfg)
    return (plan, parenthesisation(plan.optimized),
            chain_lib.chain_cost(plan.optimized))


def skewed_abc(mesh, n: int = 10_000, mid: int = 100, seed: int = 0,
               dtype="float32") -> List[BlockMatrix]:
    """The BASELINE row-2 shape: A(n×mid)·B(mid×n)·C(n×mid) — the
    left-assoc order is far worse than the DP's pick."""
    A = BlockMatrix.random((n, mid), mesh=mesh, seed=seed, dtype=dtype)
    B = BlockMatrix.random((mid, n), mesh=mesh, seed=seed + 1, dtype=dtype)
    C = BlockMatrix.random((n, mid), mesh=mesh, seed=seed + 2, dtype=dtype)
    return [A, B, C]
