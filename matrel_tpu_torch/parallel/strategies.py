"""Physical matmul strategies — the counterpart of
``matrel_tpu/parallel/strategies.py``.

The JAX package runs each strategy (bmm_left/bmm_right/cpmm/rmm/summa/
xla) as a ``shard_map`` collective recipe over the TPU mesh. Here:

* on a rank mesh (``core/mesh.init_distributed``) each strategy is the
  same recipe written as explicit collectives on the axis groups
  (``parallel/collectives.py``): its operands are re-laid to the layouts
  its ``in_specs`` name (:data:`RECIPE_LAYOUTS`), then its body runs —
  BMM nothing more, CPMM one reduce-scatter over y, RMM nothing more
  (its gathers are the re-lay), SUMMA Cannon's skew and a g−1 step ring
  of isend/irecv pairs, XLA the local product of whole operands;
* on one card (the virtual grid) every strategy is the same local
  product: the stamp is kept, the computation is one matmul.

Numerics follow the JAX package's ``Precision.HIGHEST``: float32
products run in IEEE f32 with TF32 off, bf16 operands accumulate in
f32 (``_acc_dtype``; on a CUDA device on the tensor cores, as the MXU
runs them), integers accumulate in at least int32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.resilience import faults as faults_lib

STRATEGIES = ("bmm_left", "bmm_right", "cpmm", "rmm", "summa", "xla")

_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _acc_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    # accumulate bf16 inputs in f32
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return torch.float32
    # integer inputs accumulate at least int32 (an int8 accumulator
    # would wrap on the first k>1 contraction)
    if a.dtype in _INTS and b.dtype in _INTS:
        return torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                   torch.int32)
    return torch.promote_types(a.dtype, b.dtype)


def _highest_precision() -> None:
    """Full-f32 products: the counterpart of ``Precision.HIGHEST``. TF32
    keeps about three decimal digits, a different algorithm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS may otherwise reduce a split-K bf16 GEMM in bf16, which
    # breaks the f32-accumulate contract
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One local product accumulated at ``_acc_dtype``.

    bf16 × bf16 on a CUDA device runs on the tensor cores with an f32
    result (bf16 in, f32 accumulate: the MXU's contract), the
    contraction in chunks summed in f32 (:func:`_tensor_core_dot`). On
    the CPU the bf16 operands are widened to f32 first, which computes
    the same function: a bf16×bf16 product is exact in f32. Integer
    products on a CUDA device (where torch has no integer GEMM) run in
    float64, exact while every partial sum stays below 2^53 — the int
    tiers' overflow proof bounds them by 2^31.
    """
    acc = _acc_dtype(a, b)
    if acc in _INTS:
        if a.is_cuda:
            return torch.matmul(a.double(), b.double()).round().to(acc)
        return torch.matmul(a.to(acc), b.to(acc))
    _highest_precision()
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return _tensor_core_dot(a, b)
    return torch.matmul(a.to(acc), b.to(acc))


#: Contraction length of one tensor-core product in ``local_dot``. The
#: bf16 MMA's f32 accumulation drifts toward zero over a long contraction
#: (each k-step's add truncates): row 3's Gram over 250,000-row panels
#: came out 2.9e-4 low and not positive definite in one GEMM on an H100,
#: against 3.8e-6 with chunks of 2048 summed in f32 (PERF.md).
TC_CHUNK = 2048
#: Most bytes of f32 chunk products held at once.
TC_PARTIAL_BYTES = 256 << 20


def _tensor_core_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (m, K) × (K, n) → f32 on the tensor cores: the contraction in
    chunks of ``TC_CHUNK``, each a batch entry of one ``bmm`` over views
    of the operands, summed in f32."""
    m, k = a.shape
    n = b.shape[1]
    chunks = k // TC_CHUNK
    if chunks < 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    group = max(1, TC_PARTIAL_BYTES // max(4 * m * n, 1))
    out = None
    for c0 in range(0, chunks, group):
        g = min(group, chunks - c0)
        s, e = c0 * TC_CHUNK, (c0 + g) * TC_CHUNK
        ac = a[:, s:e].reshape(m, g, TC_CHUNK).transpose(0, 1)
        bc = b[s:e].reshape(g, TC_CHUNK, n)
        p = torch.bmm(ac, bc, out_dtype=torch.float32).sum(0)
        out = p if out is None else out.add_(p)
    head = chunks * TC_CHUNK
    if head < k:
        out.add_(torch.mm(a[:, head:], b[head:], out_dtype=torch.float32))
    return out


#: ``config.matmul_precision`` below "highest" keeps its TPU meaning:
#: the bf16 passes of XLA's DEFAULT / HIGH dot precision.
_PRECISION_TIER = {"default": "bf16x1", "high": "bf16x3"}


def _dot_for(cfg: MatrelConfig, a: torch.Tensor, b: torch.Tensor
             ) -> Callable:
    """The local product a strategy runs: ``local_dot``, or the bf16
    passes of ``config.matmul_precision`` below "highest" for f32
    operands."""
    tier = _PRECISION_TIER.get(cfg.matmul_precision)
    if tier is not None and a.dtype == b.dtype == torch.float32:
        from matrel_tpu_torch.ops.precision import tiered_matmul
        return lambda p, q: tiered_matmul(tier, p, q, local_dot)
    return local_dot


# -- recipes on a rank mesh -------------------------------------------------------

#: (layout of A, layout of B, layout of the output) of each recipe, in
#: the ``collectives.STATES`` vocabulary: the JAX package's in_specs and
#: out_specs.
RECIPE_LAYOUTS = {
    "bmm_right": ("row", "rep", "row"),
    "bmm_left": ("rep", "col", "col"),
    "cpmm": ("2d", "rowy", "2d"),
    "rmm": ("rowx", "coly", "2d"),
    "summa": ("2d", "2d", "2d"),
    "xla": ("rep", "rep", None),
}


def _recipe_body(strategy: str, a: torch.Tensor, b: torch.Tensor, mesh,
                 dot: Callable) -> torch.Tensor:
    """The recipe's body on this rank's re-laid operand blocks: the
    collectives after the re-lay."""
    from matrel_tpu_torch.parallel import collectives as coll
    if strategy == "cpmm":
        # reduce-scatter partial C over the contraction axis; scatter
        # the columns
        return coll.reduce_scatter(dot(a, b), mesh, "y", dim=1)
    if strategy != "summa" or mesh.grid[0] == 1:
        return dot(a, b)
    # Cannon's skew: rotate A left by its row index i along y and B up
    # by its column index j along x, so step t multiplies A[i, i+j+t]
    # with B[i+j+t, j]. Every rank runs the same g-1 shifts and keeps a
    # shifted block only while t < i (resp. t < j): the collectives stay
    # uniform across the mesh.
    g = mesh.grid[0]
    i, j = mesh.ranks.coords
    for t in range(g - 1):
        sa, sb = coll.shift(a, mesh, "y"), coll.shift(b, mesh, "x")
        a, b = (sa if t < i else a), (sb if t < j else b)
    acc = dot(a, b)
    for _ in range(g - 1):
        a, b = coll.shift(a, mesh, "y"), coll.shift(b, mesh, "x")
        acc = acc + dot(a, b)
    return acc


def run_ranked(strategy: str, a, b, mesh, dot: Callable):
    """One stamped product on a rank mesh: ``a`` and ``b`` are Shards
    (or whole tensors, read as replicated); returns the output Shard in
    the recipe's layout. SUMMA on a non-square grid runs CPMM, as in the
    JAX package."""
    from matrel_tpu_torch.core import padding
    from matrel_tpu_torch.parallel import collectives as coll
    from matrel_tpu_torch.parallel.planner import admissible
    if strategy == "summa" and mesh.grid[0] != mesh.grid[1]:
        strategy = "cpmm"
    a = a if isinstance(a, coll.Shard) else coll.Shard(a, coll.STATES["rep"],
                                                       tuple(a.shape))
    b = b if isinstance(b, coll.Shard) else coll.Shard(b, coll.STATES["rep"],
                                                       tuple(b.shape))
    (pn, pk), pm = a.pshape, b.pshape[1]
    if not admissible(strategy, pn, pk, pm, *mesh.grid):
        raise ValueError(f"strategy {strategy!r} cannot cut a {pn}x{pk} · "
                         f"{pk}x{pm} product on a {mesh.grid} grid")
    la, lb, lo = RECIPE_LAYOUTS[strategy]
    a, b = coll.relay(a, la, mesh), coll.relay(b, lb, mesh)
    with coll.phase("exec"):
        out = _recipe_body(strategy, a.local, b.local, mesh, dot)
    if lo is None:          # xla: whole product, canonical blocks kept
        return coll.shard_from_full(
            out, padding.canonical_spec(tuple(out.shape), mesh), mesh)
    return coll.Shard(out, coll.STATES[lo], (pn, pm))


def run_matmul(strategy: str, a, b, mesh,
               config: Optional[MatrelConfig] = None,
               epilogue=None):
    """The stamped strategy's product. On one device, one local product
    of two tensors; on a rank mesh, the strategy's recipe
    (:func:`run_ranked`) over Shards, returning a Shard. ``epilogue`` is
    applied to the output (the JAX package's fused-region slot: the
    ``keep_input_dtype`` storage cast and a fused region's epilogue;
    on a rank mesh it gets the output Shard, this rank's block with its
    layout)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    # fault site "strategy" (resilience/faults.py): one attribute read
    # when injection is off
    faults_lib.check("strategy", config)
    cfg = config or default_config()
    if getattr(mesh, "ranked", False):
        from matrel_tpu_torch.parallel import collectives as coll
        la = a.local if isinstance(a, coll.Shard) else a
        lb = b.local if isinstance(b, coll.Shard) else b
        out = run_ranked(strategy, a, b, mesh, _dot_for(cfg, la, lb))
        return out if epilogue is None else epilogue(out)
    out = _dot_for(cfg, a, b)(a, b)
    return out if epilogue is None else epilogue(out)
