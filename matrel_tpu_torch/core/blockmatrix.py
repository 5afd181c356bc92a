"""BlockMatrix — the counterpart of ``matrel_tpu/core/blockmatrix.py``.

One padded ``torch.Tensor`` on the mesh's device plus the metadata the
optimizer reads: logical shape, the spec, an nnz estimate, the block
size, and the integrality facts the precision-tier chooser uses. Padding
is exactly zero.

On one card (the virtual grid) ``data`` is the whole padded matrix and
the spec is layout metadata the planner reads. On a rank mesh ``data``
is this rank's block under ``spec`` (``parallel/collectives.py``): the
constructors make the whole matrix from the seed or the array on every
rank and keep the rank's block, :meth:`to_numpy` gathers, and
:meth:`with_spec` moves the blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.core.mesh import Mesh, P

_DTYPES = {
    "float32": torch.float32, "f32": torch.float32,
    "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """torch dtype from a torch dtype, a name, or a numpy dtype (the
    ml_dtypes ``bfloat16`` numpy dtype the JAX package hands out
    included, matched by name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def tensor_from_numpy(arr: np.ndarray, dtype: Any,
                      device: torch.device) -> torch.Tensor:
    """Host array → tensor of ``dtype`` on ``device``. bfloat16 numpy
    arrays (ml_dtypes) travel as their raw 16-bit pattern, so the bits
    arrive unchanged."""
    arr = np.array(arr, order="C")         # a writable host copy
    want = as_torch_dtype(dtype)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=want)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → host numpy. bfloat16 has no numpy dtype without
    ml_dtypes, so it comes back as (exactly upcast) float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


@dataclasses.dataclass
class BlockMatrix:
    """A padded dense matrix on one device (see the JAX package's
    BlockMatrix for the field contracts)."""

    data: torch.Tensor
    shape: Tuple[int, int]
    mesh: Mesh
    spec: P
    nnz: Optional[int] = None
    block_size: int = 512
    integral: bool = False
    int_abs_max: Optional[float] = None

    # -- basic properties ---------------------------------------------------

    @property
    def padded_shape(self) -> Tuple[int, int]:
        if self.mesh.ranked:
            return padding.padded_shape(self.shape, self.mesh)
        return tuple(self.data.shape)  # type: ignore[return-value]

    def as_shard(self):
        """This rank's block as a ``collectives.Shard`` (rank mesh)."""
        from matrel_tpu_torch.parallel import collectives as coll
        return coll.Shard(self.data, coll.layout_of(self.spec, self.mesh),
                          self.padded_shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def sparsity(self) -> float:
        """Fraction of nonzeros (density). 1.0 when unknown/dense."""
        if self.nnz is None:
            return 1.0
        n = self.shape[0] * self.shape[1]
        return self.nnz / n if n else 0.0

    @property
    def is_padded(self) -> bool:
        return self.padded_shape != self.shape

    # -- construction -------------------------------------------------------

    @staticmethod
    def _place(full: torch.Tensor, mesh: Mesh, spec: P) -> torch.Tensor:
        """The tensor a matrix holds of its whole padded value ``full``:
        all of it on one card, the rank's block under ``spec`` on a rank
        mesh."""
        if not mesh.ranked:
            return full
        from matrel_tpu_torch.parallel import collectives as coll
        return coll.local_of(full, coll.layout_of(spec, mesh),
                             mesh).contiguous()

    @staticmethod
    def _layout(shape, mesh, spec, dtype, config):
        """(config, mesh, torch dtype, padded shape, spec) of a new
        matrix: the defaults a constructor fills in."""
        cfg = config or default_config()
        mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dtype = as_torch_dtype(dtype or cfg.default_dtype)
        ps = padding.padded_shape(tuple(shape), mesh)
        if spec is None:
            spec = padding.canonical_spec(ps, mesh)
        return cfg, mesh, dtype, ps, spec

    @classmethod
    def from_numpy(cls, arr: np.ndarray, mesh: Optional[Mesh] = None,
                   spec: Optional[P] = None, dtype: Any = None,
                   config: Optional[MatrelConfig] = None,
                   nnz: Optional[int] = None,
                   integral: Optional[bool] = None) -> "BlockMatrix":
        cfg = config or default_config()
        arr = np.asarray(arr)
        if integral is None:
            integral = bool(np.issubdtype(arr.dtype, np.integer)
                            or arr.dtype == np.bool_)
        int_abs_max = (float(np.abs(arr).max()) if integral and arr.size
                       else (0.0 if integral else None))
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        if arr.ndim != 2:
            raise ValueError(f"BlockMatrix is 2D; got shape {arr.shape}")
        mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dtype = as_torch_dtype(dtype or cfg.default_dtype)
        shape = tuple(arr.shape)
        ps = padding.padded_shape(shape, mesh)
        if spec is None:
            spec = padding.canonical_spec(ps, mesh)
        data = torch.zeros(ps, dtype=dtype, device=mesh.device)
        data[: shape[0], : shape[1]] = tensor_from_numpy(arr, dtype,
                                                         mesh.device)
        return cls(data=cls._place(data, mesh, P(*spec)), shape=shape,
                   mesh=mesh, spec=P(*spec),
                   nnz=nnz, block_size=cfg.block_size,
                   integral=bool(integral), int_abs_max=int_abs_max)

    @classmethod
    def from_array(cls, data: torch.Tensor, shape: Tuple[int, int],
                   mesh: Mesh, spec: P, nnz: Optional[int] = None,
                   block_size: Optional[int] = None) -> "BlockMatrix":
        return cls(data=data, shape=tuple(shape), mesh=mesh, spec=spec,
                   nnz=nnz,
                   block_size=block_size or default_config().block_size)

    @classmethod
    def random(cls, shape: Tuple[int, int], mesh: Optional[Mesh] = None,
               spec: Optional[P] = None, dtype: Any = None, seed: int = 0,
               config: Optional[MatrelConfig] = None) -> "BlockMatrix":
        """Uniform [0,1) random matrix, generated on the device from a
        seeded ``torch.Generator`` (no host copy). Its values differ
        from the JAX package's for the same seed; on a rank mesh every
        rank makes the same matrix and keeps its block."""
        cfg = config or default_config()
        mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dtype = as_torch_dtype(dtype or cfg.default_dtype)
        ps = padding.padded_shape(tuple(shape), mesh)
        if spec is None:
            spec = padding.canonical_spec(ps, mesh)
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        vals = torch.rand(ps, generator=gen, device=mesh.device,
                          dtype=torch.float32)
        vals[shape[0]:, :] = 0
        vals[:, shape[1]:] = 0
        return cls(data=cls._place(vals.to(dtype), mesh, spec),
                   shape=tuple(shape), mesh=mesh,
                   spec=spec, nnz=None, block_size=cfg.block_size)

    @classmethod
    def zeros(cls, shape, mesh=None, spec=None, dtype=None,
              config=None) -> "BlockMatrix":
        cfg, mesh, dtype, ps, spec = cls._layout(shape, mesh, spec, dtype,
                                                 config)
        full = torch.zeros(ps, dtype=dtype, device=mesh.device)
        return cls(data=cls._place(full, mesh, spec),
                   shape=tuple(shape), mesh=mesh, spec=spec, nnz=0,
                   block_size=cfg.block_size)

    @classmethod
    def eye(cls, n: int, mesh=None, spec=None, dtype=None,
            config=None) -> "BlockMatrix":
        cfg, mesh, dtype, ps, spec = cls._layout((n, n), mesh, spec, dtype,
                                                 config)
        data = torch.zeros(ps, dtype=dtype, device=mesh.device)
        data[:n, :n].fill_diagonal_(1)
        return cls(data=cls._place(data, mesh, spec), shape=(n, n),
                   mesh=mesh, spec=spec, nnz=n,
                   block_size=cfg.block_size)

    @classmethod
    def from_block_fn(cls, shape: Tuple[int, int],
                      fn: Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor],
                      mesh=None, spec=None, dtype=None, config=None,
                      nnz: Optional[int] = None) -> "BlockMatrix":
        """Entries from ``fn(row_idx, col_idx)`` on the device: ``fn``
        gets broadcastable int64 index grids over the padded shape and
        returns values (the padding is zeroed afterwards). The grids are
        int32, as ``jnp.arange`` gives them, so integer arithmetic in
        ``fn`` wraps as in the JAX package."""
        cfg, mesh, dtype, ps, spec = cls._layout(shape, mesh, spec, dtype,
                                                 config)
        r = torch.arange(ps[0], dtype=torch.int32, device=mesh.device)[:, None]
        c = torch.arange(ps[1], dtype=torch.int32, device=mesh.device)[None, :]
        vals = torch.as_tensor(fn(r, c), device=mesh.device).to(dtype)
        vals = torch.where((r < shape[0]) & (c < shape[1]), vals,
                           torch.zeros((), dtype=dtype, device=mesh.device))
        return cls(data=cls._place(vals.contiguous(), mesh, spec),
                   shape=tuple(shape), mesh=mesh,
                   spec=spec, nnz=nnz, block_size=cfg.block_size)

    # -- materialisation ----------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Copy to host, dropping padding (bfloat16 comes back as
        float32). On a rank mesh every rank calls it: the blocks are
        gathered first."""
        full = self.data
        if self.mesh.ranked:
            from matrel_tpu_torch.parallel import collectives as coll
            # a collective: in its turn against the serve workers
            with self.mesh.ranks.held():
                full = coll.gather_full(self.as_shard(), self.mesh)
        return tensor_to_numpy(full[: self.shape[0], : self.shape[1]])

    def block_until_ready(self) -> "BlockMatrix":
        """Wait until the device has computed ``data``."""
        if self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)
        return self

    # -- layout metadata ----------------------------------------------------

    def with_spec(self, spec: P) -> "BlockMatrix":
        """The same matrix under another spec. On one card the tensor
        stays whole; only the layout metadata the planner reads
        changes. On a rank mesh the blocks move (every rank calls it)."""
        spec = P(*spec)
        if spec == self.spec:
            return self
        data = self.data
        if self.mesh.ranked:
            from matrel_tpu_torch.parallel import collectives as coll
            with self.mesh.ranks.held():
                data = coll.relay(self.as_shard(), spec, self.mesh).local
        return dataclasses.replace(self, data=data, spec=spec)

    def valid_mask(self) -> torch.Tensor:
        """Boolean mask of the logical (non-padding) region over ``data``
        (the padded shape; this rank's block on a rank mesh)."""
        r0, c0 = 0, 0
        if self.mesh.ranked:
            from matrel_tpu_torch.parallel import collectives as coll
            r0, _, c0, _ = coll.block_rect(self.as_shard(), self.mesh)
        return padding.valid_mask(self.shape, tuple(self.data.shape),
                                  self.data.device, (r0, c0))

    # -- lazy DSL (builds IR; mirrors the reference's Dataset implicits) ----

    def expr(self):
        from matrel_tpu_torch.ir.expr import leaf
        return leaf(self)

    def t(self):
        return self.expr().t()

    def multiply(self, other):
        return self.expr().multiply(other)

    def matmul(self, other):
        return self.expr().multiply(other)

    def add(self, other):
        return self.expr().add(other)

    def subtract(self, other):
        return self.expr().subtract(other)

    def elem_multiply(self, other):
        return self.expr().elem_multiply(other)

    def divide(self, other):
        return self.expr().divide(other)

    def add_scalar(self, s):
        return self.expr().add_scalar(s)

    def multiply_scalar(self, s):
        return self.expr().multiply_scalar(s)

    def power(self, p):
        return self.expr().power(p)

    def row_sum(self):
        return self.expr().row_sum()

    def col_sum(self):
        return self.expr().col_sum()

    def sum(self):
        return self.expr().sum()

    def trace(self):
        return self.expr().trace()

    def norm(self, kind: str = "fro"):
        return self.expr().norm(kind)

    def inverse(self):
        return self.expr().inverse()

    def solve(self, b, assume: str = "general"):
        return self.expr().solve(b, assume=assume)

    def vec(self):
        return self.expr().vec()

    def rank_one_update(self, u, v):
        return self.expr().rank_one_update(u, v)

    def select_value(self, predicate, **kw):
        return self.expr().select_value(predicate, **kw)

    def select_index(self, *, rows=None, cols=None):
        return self.expr().select_index(rows=rows, cols=cols)

    def join_on_index(self, other, merge):
        return self.expr().join_on_index(other, merge)

    def __matmul__(self, other):
        return self.multiply(other)

    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other):
        return self.subtract(other)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return self.multiply_scalar(other)
        return self.elem_multiply(other)

    def __repr__(self) -> str:
        return (f"BlockMatrix(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, nnz={self.nnz}, "
                f"device={self.mesh.device}, grid={self.mesh.grid}"
                + (", ranked" if self.mesh.ranked else "") + ")")
