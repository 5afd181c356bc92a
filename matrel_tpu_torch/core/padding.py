"""Padding + canonical spec rules — the counterpart of
``matrel_tpu/core/padding.py``.

Logical dims are padded up to a multiple of the (virtual) grid's device
count; size-1 dims stay 1. Invariant kept by the executor: every padded
tensor is exactly zero outside its logical region, so matmul, add and
elementwise multiply compose without masks; ops that break it re-mask.
"""

from __future__ import annotations

import math
from typing import Tuple

from matrel_tpu_torch.core.mesh import Mesh, P, mesh_grid_shape


def pad_dim(d: int, total_devices: int) -> int:
    if d <= 1:
        return max(d, 1)
    return int(math.ceil(d / total_devices) * total_devices)


def padded_shape(shape: Tuple[int, int], mesh: Mesh) -> Tuple[int, int]:
    gx, gy = mesh_grid_shape(mesh)
    total = gx * gy
    return pad_dim(shape[0], total), pad_dim(shape[1], total)


def canonical_spec(pshape: Tuple[int, int], mesh: Mesh) -> P:
    """2D spec where divisible, replicated where not (size-1 dims)."""
    x, y = mesh.axis_names
    gx, gy = mesh_grid_shape(mesh)
    row = x if pshape[0] % gx == 0 and pshape[0] >= gx and gx > 1 else None
    col = y if pshape[1] % gy == 0 and pshape[1] >= gy and gy > 1 else None
    return P(row, col)


def valid_mask(shape: Tuple[int, int], block_shape: Tuple[int, int],
               device, offset: Tuple[int, int] = (0, 0)):
    """Boolean mask of the logical region ``shape`` over a block of
    ``block_shape`` whose first entry sits at global (row, col)
    ``offset``: the whole padded matrix at (0, 0), or one rank's block
    of it on a rank mesh."""
    import torch
    r = torch.arange(offset[0], offset[0] + block_shape[0],
                     device=device)[:, None] < shape[0]
    c = torch.arange(offset[1], offset[1] + block_shape[1],
                     device=device)[None, :] < shape[1]
    return r & c
