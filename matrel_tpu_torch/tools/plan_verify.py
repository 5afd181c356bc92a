"""Verifier self-check over the plan-snapshot corpus — the port of the
JAX package's ``tools/plan_verify.py``.

:mod:`.plan_snapshot` pins WHAT the planner chooses for a fixed corpus;
this tool pins that every one of those choices is INTERNALLY CONSISTENT:
it replans the same corpus on the virtual (2, 4) grid and runs the port's
static verifier (``matrel_tpu_torch/analysis/``, MV101-MV117) over each
annotated plan, requiring zero diagnostics.

    python -m matrel_tpu_torch.tools.plan_verify [--device cpu]

Exit codes: 0 = every corpus plan verifies clean; 1 = diagnostics fired
(each printed); 2 = the corpus itself failed to plan.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.plan_verify",
        description="run the static verifier over the corpus plans")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    from matrel_tpu_torch import analysis
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.ir import rules
    from matrel_tpu_torch.parallel import planner
    from matrel_tpu_torch.tools import plan_snapshot

    mesh = mesh_lib.make_mesh(plan_snapshot.GRID, device=args.device)
    grid = mesh_lib.mesh_grid_shape(mesh)
    total = 0
    try:
        corpus = plan_snapshot.corpus(mesh)
    except Exception as ex:  # noqa: BLE001 — reported as exit code 2
        print(f"corpus construction failed: {ex!r}")
        return 2
    for name, e in corpus:
        try:
            opt = planner.annotate_strategies(
                rules.optimize(e, grid=grid, mesh=mesh), mesh)
        except Exception as ex:  # noqa: BLE001 — reported as exit code 2
            print(f"PLAN FAILED: {name}: {ex!r}")
            return 2
        diags = analysis.verify_plan(opt, mesh)
        for d in diags:
            print(f"DIAGNOSTIC: {name}: {d.render()}")
        total += len(diags)
    n = len(corpus)
    print(f"verified {n} corpus plans: {total} diagnostic(s)")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
