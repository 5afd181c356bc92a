"""Failure detection / recovery — the counterpart of
``matrel_tpu/utils/resilience.py`` (the task-retry / lineage analogue).

``run_resilient(body, cm, ...)`` is a driver loop that checkpoints every
``checkpoint_interval`` steps and, on a transient failure, re-enters from
the last durable checkpoint (restart-and-resume). What counts as
transient is ``resilience/errors.is_transient``'s one taxonomy: an
injected transient fault or a CUDA out-of-memory error. Everything else
re-raises at once.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.resilience.errors import is_transient
from matrel_tpu_torch.utils.checkpoint import CheckpointManager

log = logging.getLogger("matrel_tpu_torch.resilience")


def run_resilient(
    body: Callable[[int, Dict[str, BlockMatrix], Dict[str, Any]],
                   Tuple[Dict[str, BlockMatrix], Dict[str, Any]]],
    cm: CheckpointManager,
    mesh,
    init_matrices: Mapping[str, BlockMatrix],
    init_state: Optional[Dict[str, Any]] = None,
    num_steps: int = 1,
    checkpoint_interval: int = 10,
    max_restarts: int = 3,
) -> Tuple[Dict[str, BlockMatrix], Dict[str, Any]]:
    """Run ``body(step, matrices, state)`` for ``num_steps`` steps with
    checkpointing and restart-on-failure from the last durable step."""
    restarts = 0
    restored = cm.restore(mesh)
    if restored is not None:
        start, matrices, _, state = restored
        start += 1
        log.info("resuming from checkpoint step %d", start - 1)
    else:
        start, matrices, state = 0, dict(init_matrices), dict(init_state or {})

    step = start
    while step < num_steps:
        try:
            matrices, state = body(step, matrices, state)
            if (step + 1) % checkpoint_interval == 0 or step == num_steps - 1:
                cm.save(step, matrices=matrices, state=state)
            step += 1
        except Exception as e:  # noqa: BLE001 — gate below
            if not is_transient(e) or restarts >= max_restarts:
                raise
            restarts += 1
            log.warning("step %d failed (%s); restart %d/%d from checkpoint",
                        step, type(e).__name__, restarts, max_restarts)
            restored = cm.restore(mesh)
            if restored is None:
                step, matrices, state = (0, dict(init_matrices),
                                         dict(init_state or {}))
            else:
                s, matrices, _, state = restored
                step = s + 1
    return matrices, state
