"""The closed autotune loop: measured strategy choice and its
provenance; the port of the JAX package's ``examples/autotune_demo.py``.

With ``MatrelConfig(autotune=True)`` the planner times every admissible
matmul strategy once per recurring shape class on the device (the median
of three marginal estimates; a winner within ``autotune.TIE_REL`` of the
runner-up is recorded as a tie, so noise never becomes a winner),
persists the table as JSON, and lets the measured winner override the
byte model. EXPLAIN shows why each multiply got its strategy:
``strategy=cpmm[measured|model|override|default]``.

Family: the matmul strategies, on the virtual (2, 4) grid. On one card's
1 × 1 mesh every strategy is the same local product and the planner never
asks (``parallel/autotune.py``), so the loop runs on the grid the JAX
demo simulates with 8 CPU devices, its strategies lowered on the card.
The first session measures and persists to a temporary table; a second
session, with the process caches cleared, inherits the table and makes
zero new measurements.

Run: python -m matrel_tpu_torch.examples.autotune_demo [--device cpu]
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: The JAX demo's grid and operand side (seed 0).
GRID, SIDE = (2, 4), 256


@contextlib.contextmanager
def counted_measurements():
    """Every strategy ``autotune.measure_strategy`` times while the
    block runs, in order."""
    from matrel_tpu_torch.parallel import autotune
    seen, real = [], autotune.measure_strategy

    def counted(strategy, *args, **kw):
        seen.append(strategy)
        return real(strategy, *args, **kw)

    autotune.measure_strategy = counted
    try:
        yield seen
    finally:
        autotune.measure_strategy = real


def _strategy_line(text: str) -> str:
    return next(ln for ln in text.splitlines() if "strategy=" in ln).strip()


def run(device=None, emit=print, side: int = SIDE) -> dict:
    """The demo on ``device``; returns the lines and counts it prints."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.parallel import autotune
    rng = np.random.default_rng(0)
    mesh = mesh_lib.make_mesh(GRID, device=device)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        table_path = os.path.join(d, "autotune_table.json")
        cfg = MatrelConfig(autotune=True, autotune_table_path=table_path)
        autotune.clear_caches()

        def product(sess):
            a = sess.from_numpy(rng.standard_normal((side, side))
                                .astype(np.float32))
            b = sess.from_numpy(rng.standard_normal((side, side))
                                .astype(np.float32))
            return a.expr().multiply(b.expr())

        # first compile: the loop measures every admissible strategy for
        # this shape class and persists the result
        sess = MatrelSession(mesh=mesh, config=cfg)
        with counted_measurements() as first:
            out["first_line"] = _strategy_line(sess.explain(product(sess)))
        emit(f"first session:  {out['first_line']}")
        table = autotune.load_table(table_path)
        for key, entry in table.items():
            times = {s: f"{t * 1e3:.3f} ms"
                     for s, t in sorted(entry["times"].items(),
                                        key=lambda kv: kv[1])}
            emit(f"measured {key}: best={entry['best']} {times}")
        out["table"] = table
        out["first_measurements"] = len(first)

        # a fresh session (cleared process caches = a new process)
        # inherits the persisted measurement — no re-measure
        autotune.clear_caches()
        sess2 = MatrelSession(mesh=mesh, config=cfg)
        with counted_measurements() as second:
            line = _strategy_line(sess2.explain(product(sess2)))
        emit(f"second session: {line}")
        emit(f"measurements: {len(first)} in the first session, "
             f"{len(second)} in the second")
        out["second_line"] = line
        out["second_measurements"] = len(second)
        # provenance is either [measured] (a strategy won by more than
        # TIE_REL) or [model] (the measurements tied — the model decides)
        assert "[measured]" in line or "[model]" in line, line
        assert not second, f"the second session measured {second}"
    autotune.clear_caches()
    return out


def main(argv=None) -> int:
    args = parse_args(argv, "autotune_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
