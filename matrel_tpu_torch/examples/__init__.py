"""Worked examples of the port — the counterparts of the JAX package's
``examples/*.py``, one module each, printing what the JAX demo prints in
the same order:

- :mod:`.graph_demo`: degrees, two-hop mass and PageRank over a COO graph
  (B2 on the card);
- :mod:`.linreg_demo`: the Xᵀ·X plan and ``linreg.fit``'s error;
- :mod:`.chain_optimizer_demo`: the skewed chain, left-associated against
  DP-reordered;
- :mod:`.relational_sql_demo`: σ / γ / ⋈ and the SQL forms;
- :mod:`.analytics_demo`: triangles and thresholded cosine pairs;
- :mod:`.layout_aware_planning_demo`: the three layout effects on the
  virtual (2, 4) grid;
- :mod:`.autotune_demo`: the closed autotune loop;
- :mod:`.distributed_sparse_demo`: both scale-out plans on a gloo rank
  world (B1 and B2 on each rank on the card).

Each has ``run(device=None, emit=print, ...) -> dict`` (the printed numbers)
and ``main(argv=None) -> int``; ``python -m
matrel_tpu_torch.examples.<name> [--device cpu]`` runs it on the card
unless asked for the CPU, and raises without a card.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]], prog: str, doc: str,
               extra: Optional[Callable] = None) -> argparse.Namespace:
    """The examples' shared command line: ``--device`` (default cuda),
    plus whatever ``extra(parser)`` adds."""
    ap = argparse.ArgumentParser(
        prog=f"python -m matrel_tpu_torch.examples.{prog}",
        description=(doc or "").strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    if extra is not None:
        extra(ap)
    return ap.parse_args(argv)

