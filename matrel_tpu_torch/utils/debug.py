"""Numerical guards — the counterpart of ``matrel_tpu/utils/debug.py``.

What can go wrong numerically (NaN/Inf from ill-conditioned solves,
division, overflow in bf16) is guarded here:

  - ``checked(fn)``: run ``fn`` under a dispatch mode that checks the
    floating outputs of EVERY op it runs, so a NaN or Inf produced
    anywhere inside it — also one a later op masks away — raises
    ``FloatingPointError`` naming the op and the line that called it
    (the JAX package's ``checkify`` float checks; torch has no
    ``checkify``, and checking only the return value would miss the
    masked ones).
  - ``assert_finite(bm)``: eager finiteness check for a BlockMatrix or
    tensor, cheap enough for test/debug paths.

Each checked op reads its outputs back to the host, so ``checked`` is a
debugging tool: on the card it synchronises after every op.
"""

from __future__ import annotations

import functools
import os
import traceback
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from matrel_tpu_torch.core.blockmatrix import BlockMatrix

#: Ops whose outputs are uninitialised memory by contract: their bits
#: are whatever the allocator held, so a NaN pattern there is no fault.
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided"})

_TORCH_DIR = os.path.dirname(torch.__file__)
_THIS_FILE = os.path.abspath(__file__)


def _caller() -> str:
    """The innermost frame of the caller's code (not torch's, not this
    module's) — where the faulting op was called."""
    for fr in reversed(traceback.extract_stack()):
        fn = os.path.abspath(fr.filename)
        if fn != _THIS_FILE and not fn.startswith(_TORCH_DIR):
            return f"{fr.filename}:{fr.lineno} in {fr.name}"
    return "<unknown>"


class _FiniteCheckMode(TorchDispatchMode):
    """Raise on the first op whose floating output holds NaN or Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel()):
                bad = int((~torch.isfinite(t)).sum())
                if bad:
                    raise FloatingPointError(
                        f"{bad} non-finite value(s) produced by {func} "
                        f"(shape {tuple(t.shape)}) at {_caller()}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped so that a NaN or Inf produced by any op inside it
    raises ``FloatingPointError`` naming the op and its call site."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with _FiniteCheckMode():
            return fn(*args, **kw)

    return wrapper


def assert_finite(m, name: str = "array") -> None:
    """Raise ``FloatingPointError`` when a BlockMatrix's (or tensor's)
    data holds a NaN or Inf."""
    x = m.data if isinstance(m, BlockMatrix) else m
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        raise FloatingPointError(
            f"{name}: {bad} non-finite entries (shape {tuple(x.shape)})")
