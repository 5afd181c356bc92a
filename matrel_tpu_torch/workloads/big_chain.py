"""North-star workload: the 65k×65k chain A·B·C — the counterpart of
``matrel_tpu/workloads/big_chain.py`` (BASELINE.json's metric, second
half).

At n = 65,536 one operand is 8 GiB in bf16, and the chain's interior
A·B another 8 GiB. The chain is evaluated by streaming:

    out_panel_i = (A_i · B) · C         for row panels A_i

with no n×n array ever held: the operands' tiles or column slabs are
made on demand by deterministic generators, and only a scalar reduction
of the product (Frobenius² or sum) comes back. Memory is O(panel × n).

The products are XLA ``dot_general``s in the JAX package (no Pallas
kernel), so here they are cuBLAS GEMMs through ``torch.mm``, each over
the whole contraction the JAX body gives it: bf16 in, f32 accumulation
on the tensor cores, and the first product of the slab schedule rounded
once to bf16 as the JAX body's ``s.astype(dtype)`` does. (The tensor
cores' f32 accumulation drifts toward zero over a long contraction: at
n = 65,536 the slab schedule's Frobenius² sits 1.9e-4 below the
tile-assembly schedule's, whose GEMMs are 8192 long; ``PERF.md``.)

The generators are elementwise ops in the JAX package's order, one
eager op each: no fused multiply-add, so the f32 values are bit for bit
those of the JAX package's CPU run (``cheap_gen``; ``default_gen``'s
``sin`` may differ by one ulp).

``streaming_chain_sharded`` divides the row panels over the ranks of a
rank mesh: each rank runs the single-card panel bodies on its own
panels (the generators make operands location-free, so no input moves),
then one ``all_reduce`` of the scalar.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.parallel import strategies

Tensor = torch.Tensor
Device = Union[str, torch.device, None]

Gen = Callable[[int, int], Tensor]
# Gen(bi, bj) -> tile of shape (tile, tile): block (bi, bj) of the operand.


def _f32(x: float) -> float:
    """A Python float rounded to f32, as a traced int32 × float product
    is in the JAX package."""
    return float(np.float32(x))


def _coords(r0: int, c0: int, shape: Tuple[int, int], dev
            ) -> Tuple[Tensor, Tensor]:
    """(rows, 1) and (1, cols) f32 global coordinates of a rectangle:
    the iota plus its origin, exact integers below 2^24."""
    rg = torch.arange(shape[0], dtype=torch.float32, device=dev)[:, None]
    cg = torch.arange(shape[1], dtype=torch.float32, device=dev)[None, :]
    return rg.add_(r0), cg.add_(c0)


def default_gen(seed: int, tile: int, dtype=torch.bfloat16,
                scale: Optional[float] = None, device: Device = None
                ) -> Gen:
    """Deterministic tile generator: sin of an iota mix, scaled by
    ``scale`` (0.01). Carries a ``.slab(r0, c0, shape)`` fast path that
    makes any rectangle in global coordinates, and ``.device``."""
    s = scale if scale is not None else 0.01
    dev = mesh_lib.resolve_device(device)

    def finish(v: Tensor) -> Tensor:
        return v.sin_().mul_(s).to(dtype)

    def gen(bi: int, bj: int) -> Tensor:
        r, c = _coords(0, 0, (tile, tile), dev)
        v = (r * 0.1) + (c * 0.37)
        v.add_(_f32(np.float32(bi) * np.float32(1.7)))
        v.add_(_f32(np.float32(bj) * np.float32(0.3)))
        return finish(v.add_(seed))

    def slab(r0: int, c0: int, shape: Tuple[int, int]) -> Tensor:
        rg, cg = _coords(r0, c0, shape, dev)
        r, bi = rg % tile, rg // tile
        c, bj = cg % tile, cg // tile
        v = (r * 0.1) + (c * 0.37)
        v.add_(bi * 1.7).add_(bj * 0.3)
        return finish(v.add_(seed))

    gen.slab = slab
    gen.device = dev
    return gen


def cheap_gen(seed: int, tile: int, dtype=torch.bfloat16,
              scale: Optional[float] = None, device: Device = None) -> Gen:
    """Generator with a ~4-op body (the fractional part of an iota mix
    instead of sin): values uniform-ish in [-scale, scale], fully
    deterministic. Carries ``.slab`` and ``.device`` as
    :func:`default_gen`. One full-size f32 temporary: the coordinate
    vectors broadcast once, every later step runs in place."""
    s = scale if scale is not None else 0.01
    dev = mesh_lib.resolve_device(device)
    offset = (seed + 1) * 0.5545497

    def _vals(rg: Tensor, cg: Tensor) -> Tensor:
        x = (rg * 0.6180339887) + (cg * 0.7548776662)
        # x - floor(x), exact in f32 as the JAX body's is
        x.add_(offset).remainder_(1.0)
        return x.mul_(2.0).sub_(1.0).mul_(s).to(dtype)

    def gen(bi: int, bj: int) -> Tensor:
        return _vals(*_coords(bi * tile, bj * tile, (tile, tile), dev))

    def slab(r0: int, c0: int, shape: Tuple[int, int]) -> Tensor:
        return _vals(*_coords(r0, c0, shape, dev))

    gen.slab = slab
    gen.device = dev
    return gen


def _check_dims(n: int, tile: int, panel: int) -> None:
    if n % tile or n % panel or panel % tile:
        raise ValueError("n must divide by tile and panel; panel by tile")


def _reduced(o: Tensor, reduce: str) -> Tensor:
    """The f32 reduction of one product block (``o`` is consumed)."""
    return (o.square_() if reduce == "fro" else o).sum()


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """a·b in f32: one cuBLAS GEMM over the whole contraction on CUDA
    (bf16 in, f32 accumulate on the tensor cores; f32 with TF32 off);
    on the CPU bf16 operands are widened first, the same function."""
    strategies._highest_precision()
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _dot_into(a: Tensor, b: Tensor, out: Tensor) -> None:
    """out ← a·b accumulated in f32 and rounded once to out's dtype; on
    CUDA straight into ``out`` (a column slab of a row-major panel is a
    matrix with a leading dimension, which cuBLAS writes in place)."""
    if a.is_cuda:
        strategies._highest_precision()
        torch.mm(a, b, out=out)
    else:
        out.copy_(_dot(a, b))


def streaming_chain(n: int, gen_a: Gen, gen_b: Gen, gen_c: Gen,
                    tile: int = 8192, panel: int = 16384,
                    dtype=torch.bfloat16, reduce: str = "fro") -> Tensor:
    """reduce(A·B·C) for n×n operands produced tile by tile (the
    tile-assembly schedule). Per output row panel i:

        T_i = Σ_k A[i, k] · B_k      (a (panel, n) f32 carry)
        O_i = Σ_k T_i[:, k] · C_k    (T_i rounded to ``dtype`` first)
        acc += reduction(O_i)

    Returns a 0-d f32 tensor (Frobenius² by default, or "sum") on the
    generators' device; no n×n array is ever held."""
    _check_dims(n, tile, panel)
    acc = None
    for i in range(n // panel):
        r = _assembly_panel(i, n, gen_a, gen_b, gen_c, tile, panel, dtype,
                            reduce)
        acc = r if acc is None else acc + r
    return acc


def _assembly_panel(i: int, n: int, gen_a: Gen, gen_b: Gen, gen_c: Gen,
                    tile: int, panel: int, dtype, reduce: str) -> Tensor:
    """reduce(O_i) of row panel i under the tile-assembly schedule (see
    :func:`streaming_chain`)."""
    kt, pt = n // tile, panel // tile

    def row_block(gen: Gen, k: int) -> Tensor:
        """Row block k, (tile, n), from kt generated tiles."""
        return torch.cat([gen(k, j).to(dtype) for j in range(kt)], dim=1)

    def col_panel(gen: Gen, k: int) -> Tensor:
        """(panel, tile) column slab: tiles (i·pt + ti, k) stacked."""
        return torch.cat([gen(i * pt + ti, k).to(dtype)
                          for ti in range(pt)], dim=0)

    # T_i contracted k-block by k-block, so each row block of B is
    # generated once per panel
    part = None
    for k in range(kt):
        p = _dot(col_panel(gen_a, k), row_block(gen_b, k))
        part = p if part is None else part.add_(p)
        del p                      # before the next product exists
    t_i = part.to(dtype)
    del part
    o_i = None
    for k in range(kt):
        p = _dot(t_i[:, k * tile:(k + 1) * tile], row_block(gen_c, k))
        o_i = p if o_i is None else o_i.add_(p)
        del p
    del t_i
    r = _reduced(o_i, reduce)
    del o_i                        # before the next panel's carry
    return r


def streaming_chain_slab(n: int, gen_a: Gen, gen_b: Gen, gen_c: Gen,
                         tile: int = 8192, panel: int = 16384,
                         dtype=torch.bfloat16, reduce: str = "fro"
                         ) -> Tensor:
    """Slab-scheduled reduce(A·B·C): the north-star schedule. Every
    output slab is one GEMM over the full n-long contraction, so the
    f32 accumulation stays inside cuBLAS; operand column slabs
    (n, tile) come from the generators' ``.slab`` path:

        T_i[:, j] = A_i · B[:, j]     (one GEMM a slab, rounded to dtype)
        acc      += reduce(T_i · C[:, j])

    The reduction accumulates in a 0-d f32 tensor on the device: the
    loop never waits for the card. Needs ``.slab``-capable generators
    (:func:`default_gen` / :func:`cheap_gen`)."""
    _check_slab(n, tile, panel, gen_a, gen_b, gen_c)
    acc = None
    for i in range(n // panel):
        part = _slab_panel(i, n, gen_a, gen_b, gen_c, tile, panel, dtype,
                           reduce)
        acc = part if acc is None else acc + part
    return acc


def _check_slab(n: int, tile: int, panel: int, *gens: Gen) -> None:
    _check_dims(n, tile, panel)
    for g in gens:
        if not hasattr(g, "slab"):
            raise ValueError("the slab schedule needs .slab-capable "
                             "generators (default_gen / cheap_gen)")


def _slab_panel(i: int, n: int, gen_a: Gen, gen_b: Gen, gen_c: Gen,
                tile: int, panel: int, dtype, reduce: str) -> Tensor:
    """reduce((A_i·B)·C) of row panel i under the slab schedule (see
    :func:`streaming_chain_slab`), a 0-d f32 tensor on the device."""
    kt = n // tile
    a_i = gen_a.slab(i * panel, 0, (panel, n)).to(dtype)
    t_i = torch.empty((panel, n), dtype=dtype, device=a_i.device)
    for j in range(kt):
        b_j = gen_b.slab(0, j * tile, (n, tile)).to(dtype)
        _dot_into(a_i, b_j, t_i[:, j * tile:(j + 1) * tile])
        del b_j
    del a_i
    part = torch.zeros((), dtype=torch.float32, device=t_i.device)
    for j in range(kt):
        c_j = gen_c.slab(0, j * tile, (n, tile)).to(dtype)
        part += _reduced(_dot(t_i, c_j), reduce)
        del c_j
    return part


def streaming_chain_sharded(n: int, gen_a: Gen, gen_b: Gen, gen_c: Gen,
                            mesh, tile: int = 8192, panel: int = 16384,
                            dtype=torch.bfloat16, reduce: str = "fro"
                            ) -> Tensor:
    """Rank-sharded streaming chain: row panels divided over ALL ranks of
    a rank mesh (rank r takes panels [r·per, (r + 1)·per)), each running
    the slab schedule's panel body (the tile-assembly body for
    generators without ``.slab``) on its own panels, then one
    ``all_reduce`` of the f32 scalar. Every rank gets the result; the
    generators make their tiles on the rank's device."""
    from matrel_tpu_torch.parallel import collectives as coll
    _check_dims(n, tile, panel)
    npan, p = n // panel, mesh.size
    if npan % p:
        raise ValueError(f"panels ({npan}) must divide over ranks ({p})")
    per = npan // p
    slab = all(hasattr(g, "slab") for g in (gen_a, gen_b, gen_c))
    body = _slab_panel if slab else _assembly_panel
    acc = None
    for i in range(mesh.ranks.rank * per, (mesh.ranks.rank + 1) * per):
        part = body(i, n, gen_a, gen_b, gen_c, tile, panel, dtype, reduce)
        acc = part if acc is None else acc + part
    return coll.all_reduce(acc.reshape(1), mesh)[0]


def north_star_flops(n: int) -> float:
    """A·B then ·C: 2n³ + 2n³."""
    return 4.0 * n ** 3
