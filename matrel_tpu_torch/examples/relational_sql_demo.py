"""Relational queries over matrices: the σ/γ/⋈ surface plus SQL — the
MatRel-paper pattern 'join two matrices, filter entries, aggregate'; the
port of the JAX package's ``examples/relational_sql_demo.py``.

Run: python -m matrel_tpu_torch.examples.relational_sql_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: The JAX demo's tables: two 64² f32 matrices (seed 1).
SIDE = 64


def run(device=None, emit=print, side: int = SIDE) -> dict:
    """The demo on ``device``; returns the numbers it prints."""
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.relational import ops as R
    sess = MatrelSession(device=device)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((side, side)).astype(np.float32)
    b = rng.standard_normal((side, side)).astype(np.float32)
    A, B = sess.from_numpy(a), sess.from_numpy(b)
    sess.register("A", A)
    sess.register("B", B)

    # DSL: join on index, keep positive entries, count per row
    joined = R.join_on_index(A, B, lambda x, y: x * y)
    pos = R.select_entries(joined, lambda v: v > 0)
    counts = R.aggregate(pos, "count", "row").compute(sess).to_numpy()
    top_rows = np.argsort(-counts.ravel())[:5]
    emit(f"rows with most positive A⊙B entries: {top_rows}")

    # the same style of query through SQL
    e = sess.sql("SELECT rowsum(select(elemmult(A, B), 'v > 0'))")
    pos_mass = sess.compute(e).to_numpy().ravel()
    emit(f"per-row positive mass (first 5): {pos_mass[:5]}")

    # aggregation pushdown in action: rowSum(A·B) runs as A·rowSum(B)
    expr = A.multiply(B).row_sum()
    explain = expr.explain()
    emit(explain)

    # streaming value join: structured predicate + merge keep the
    # (|A|, |B|) pair matrix VIRTUAL — the aggregate runs sort-based
    j = R.join_on_values(A, B, merge="mul", predicate="lt")
    per_entry = R.aggregate(j, "sum", "row").compute(sess).to_numpy()
    emit(f"Σ merge over matches, first 5 A-entries: "
         f"{per_entry.ravel()[:5]}")

    # ...and the same through SQL, with FROM validation and WHERE sugar
    q = sess.sql("SELECT rowsum(joinvalue(A, B, 'mul', 'lt')) FROM A, B")
    agrees = bool(np.allclose(sess.compute(q).to_numpy(), per_entry,
                              atol=1e-4))
    emit(f"SQL agrees: {agrees}")
    w = sess.sql("SELECT A .* B FROM A, B WHERE v > 1")
    nonzeros = int((sess.compute(w).to_numpy() != 0).sum())
    emit(f"elemmul + WHERE nonzeros: {nonzeros}")
    return {"counts": counts, "top_rows": top_rows, "pos_mass": pos_mass,
            "explain": explain, "per_entry": per_entry,
            "sql_agrees": agrees, "where_nonzeros": nonzeros}


def main(argv=None) -> int:
    args = parse_args(argv, "relational_sql_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
