"""Device plus virtual grid — the counterpart of ``matrel_tpu/core/mesh.py``.

The JAX package lays a 2D ``jax.sharding.Mesh`` over the TPU chips and
its partitioners are ``PartitionSpec``s. This package runs on ONE card,
so execution is always 1x1: every array lives whole on ``mesh.device``.
The mesh still carries a (gx, gy) grid — the VIRTUAL grid the planner
prices strategies and pads dimensions on — so plan stamps can be held
against the reference on the same grid (``tests/plan_snapshots.json``
plans on (2, 4)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch


class PartitionSpec(tuple):
    """Stand-in for ``jax.sharding.PartitionSpec``: one entry per matrix
    dim — None (replicated), a mesh-axis name, or a tuple of names. A
    leaf's spec is metadata the planner's layout model reads; nothing
    is sharded on one card."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for (the default) and none is present."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The torch device a session runs on: "cuda" unless the caller asks
    for another. A CUDA request without a card raises — the package
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "matrel_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One execution device and the virtual (gx, gy) planning grid."""

    device: torch.device
    grid: Tuple[int, int] = (1, 1)
    axis_names: Tuple[str, str] = ("x", "y")

    @property
    def size(self) -> int:
        return self.grid[0] * self.grid[1]


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("x", "y"),
              device: Union[str, torch.device, None] = None) -> Mesh:
    """Build the mesh: ``shape=None`` is the 1x1 grid of one card (the
    JAX package derives a near-square grid from its device count; here
    the device count is one)."""
    gx, gy = (1, 1) if shape is None else (int(shape[0]), int(shape[1]))
    if gx < 1 or gy < 1:
        raise ValueError(f"mesh grid must be positive, got {shape}")
    return Mesh(resolve_device(device), (gx, gy), tuple(axis_names))


def mesh_grid_shape(mesh: Mesh) -> Tuple[int, int]:
    return mesh.grid


def axis_weights(mesh: Mesh, config=None) -> Tuple[float, float]:
    """Per-axis inverse-bandwidth weights the comm model bills: the
    configured ``axis_cost_weights``. (The JAX package also detects TPU
    slice boundaries; one card has none.)"""
    from matrel_tpu_torch.config import default_config
    cfg = config or default_config()
    return tuple(cfg.axis_cost_weights)
