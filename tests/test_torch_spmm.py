"""PyTorch port: block-sparse × dense SpMM (matrel_tpu_torch/ops/spmm.py
and ops/pallas_spmm.py) held against the JAX package on the CPU.

The JAX side runs its Pallas kernel B1 in interpret mode
(``spmm(S, D, cfg, interpret=True)``, as tests/test_sparse.py does) on
a 1x1 mesh; the port runs the kernel route's plain PyTorch version (CPU
tensors). Both get the same numpy inputs through
``matrel_tpu_torch.convert``. Tolerances: f32 at rtol=atol=1e-4 (the
reference's own bound, test_sparse.py); bf16 compared in f32 at
rtol=atol=2e-2 (one bf16 rounding of an f32 accumulation each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.blockmatrix import BlockMatrix as JBlockMatrix
from matrel_tpu.core.sparse import BlockSparseMatrix as JBlockSparse
from matrel_tpu.executor import compile_expr as j_compile_expr
from matrel_tpu.ir import expr as JE
from matrel_tpu.ops import spmm as j_spmm

from matrel_tpu_torch import convert
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.executor import compile_expr
from matrel_tpu_torch.ir import expr as E
from matrel_tpu_torch.ops import pallas_spmm, spmm as t_spmm
from matrel_tpu_torch.ops import tile_body


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(device="cpu")


def block_sparse_np(rng, n, k, bs, density, empty_rows=()):
    """Block-sparse numpy matrix (ragged edges allowed) with the given
    block rows left empty."""
    gr, gc = -(-n // bs), -(-k // bs)
    a = np.zeros((gr * bs, gc * bs), np.float32)
    nblocks = max(1, int(gr * gc * density))
    for f in rng.choice(gr * gc, size=nblocks, replace=False):
        bi, bj = f // gc, f % gc
        if bi not in empty_rows:
            a[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = \
                rng.standard_normal((bs, bs))
    return a[:n, :k]


def both(a, d, bs, jm, tm, dtype=np.float32):
    S = JBlockSparse.from_numpy(a, block_size=bs, mesh=jm, dtype=dtype)
    D = JBlockMatrix.from_numpy(d, mesh=jm, dtype=dtype)
    return S, D, convert.from_reference(S, tm), convert.from_reference(D, tm)


@pytest.mark.parametrize("bs,n,k,m", [(4, 18, 14, 5), (8, 40, 24, 16),
                                      (16, 64, 48, 20), (8, 40, 24, 1)])
def test_f32_matches_jax_interpret(jmesh, tmesh, bs, n, k, m):
    rng = np.random.default_rng(bs)
    a = block_sparse_np(rng, n, k, bs, 0.4)
    d = rng.standard_normal((k, m)).astype(np.float32)
    S, D, tS, tD = both(a, d, bs, jmesh, tmesh)
    want = j_spmm.spmm(S, D, JConfig(use_pallas=False),
                       interpret=True).to_numpy()
    got = t_spmm.spmm(tS, tD).to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, a @ d, rtol=1e-4, atol=1e-4)


def test_bf16_matches_jax_interpret(jmesh, tmesh):
    rng = np.random.default_rng(7)
    a = block_sparse_np(rng, 32, 32, 8, 0.5)
    d = rng.standard_normal((32, 16)).astype(np.float32)
    S, D, tS, tD = both(a, d, 8, jmesh, tmesh, dtype=jnp.bfloat16)
    assert tS.dtype == torch.bfloat16 and tD.dtype == torch.bfloat16
    want = np.asarray(j_spmm.spmm(S, D, JConfig(use_pallas=False),
                                  interpret=True).to_numpy(), np.float32)
    got = t_spmm.spmm(tS, tD)
    assert got.dtype == torch.bfloat16          # output in payload dtype
    np.testing.assert_allclose(got.to_numpy(), want, rtol=2e-2, atol=2e-2)


def test_empty_block_rows_are_zero(jmesh, tmesh):
    rng = np.random.default_rng(11)
    a = block_sparse_np(rng, 48, 32, 8, 0.6, empty_rows=(1, 4))
    d = rng.standard_normal((32, 9)).astype(np.float32)
    S, D, tS, tD = both(a, d, 8, jmesh, tmesh)
    want = j_spmm.spmm(S, D, JConfig(use_pallas=False),
                       interpret=True).to_numpy()
    got = t_spmm.spmm(tS, tD).to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not got[8:16].any() and not got[32:40].any()


def test_dense_times_sparse_transpose_path(jmesh, tmesh):
    """A·S lowers as (Sᵀ·Aᵀ)ᵀ in both executors."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((5, 24)).astype(np.float32)
    s_np = block_sparse_np(rng, 24, 16, 8, 0.5)
    S = JBlockSparse.from_numpy(s_np, block_size=8, mesh=jmesh)
    A = JBlockMatrix.from_numpy(a, mesh=jmesh)
    tS = convert.from_reference(S, tmesh)
    tA = convert.from_reference(A, tmesh)
    want = j_compile_expr(JE.matmul(A.expr(), S.expr()), jmesh,
                          JConfig(pallas_interpret=True)).run().to_numpy()
    got = compile_expr(E.matmul(tA.expr(), tS.expr()), tmesh,
                       MatrelConfig()).run().to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, a @ s_np, rtol=1e-4, atol=1e-4)
    assert tS._transposed_memo is not None     # transposed once, memoised


def test_reassigned_blocks_raise_on_kernel_route(tmesh):
    rng = np.random.default_rng(3)
    a = block_sparse_np(rng, 16, 16, 8, 0.5)
    d = rng.standard_normal((16, 8)).astype(np.float32)
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    S = BlockSparseMatrix.from_numpy(a, block_size=8, mesh=tmesh)
    D = BlockMatrix.from_numpy(d, mesh=tmesh)
    t_spmm.spmm(S, D)
    S.blocks = torch.zeros_like(S.blocks)
    with pytest.raises(ValueError, match="reassigned"):
        t_spmm.spmm(S, D)
    # a runner built after the reassignment bakes the NEW stack
    D2 = BlockMatrix.from_numpy(rng.standard_normal((16, 5)).astype(
        np.float32), mesh=tmesh)
    assert not t_spmm.spmm(S, D2).to_numpy().any()
    # the plain route (use_pallas=False) honours the reassignment
    S.blocks = 2.0 * torch.ones_like(S.blocks)
    out = t_spmm.spmm(S, D, MatrelConfig(use_pallas=False)).to_numpy()
    np.testing.assert_allclose(out, S.to_numpy() @ d, rtol=1e-4, atol=1e-4)


def test_runner_cache_purged_with_matrix(tmesh):
    import gc
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    rng = np.random.default_rng(4)
    S = BlockSparseMatrix.from_numpy(block_sparse_np(rng, 16, 16, 8, 0.5),
                                     block_size=8, mesh=tmesh)
    D = BlockMatrix.from_numpy(rng.standard_normal((16, 4)), mesh=tmesh)
    t_spmm.spmm(S, D)
    sid = id(S)
    assert any(k[0] == sid for k in t_spmm._RUNNER_CACHE)
    del S
    gc.collect()
    assert not any(k[0] == sid for k in t_spmm._RUNNER_CACHE)


def test_kernel_wrapper_cpu_uses_plain_version(tmesh):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; malformed operands are refused before any launch."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    rng = np.random.default_rng(9)
    a = block_sparse_np(rng, 24, 16, 8, 0.5)
    S = BlockSparseMatrix.from_numpy(a, block_size=8, mesh=tmesh)
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    d = torch.as_tensor(rng.standard_normal((16, 3)).astype(np.float32))
    before = pallas_spmm.LAUNCHES
    out = pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d, 24)
    assert pallas_spmm.LAUNCHES == before
    np.testing.assert_allclose(out.numpy(), a @ d.numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(TypeError):
        pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d.double(), 24)
    with pytest.raises(ValueError):
        pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d.T, 24)


# -- the bf16 tile body, chosen by shape before the launch --------------------

#: (bs, pm, aligned, body): BASELINE row 4 and the other shapes the wgmma
#: body is held to on the card take it; the ragged bf16 shapes, a D whose
#: rows are not a multiple of 16 bytes and a misaligned operand do not.
BODY_CASES = [
    (512, 512, True, "wgmma"),     # BASELINE row 4
    (64, 200, True, "wgmma"),
    (128, 136, True, "wgmma"),
    (512, 520, True, "wgmma"),
    (4, 512, True, "wmma"),
    (8, 512, True, "wmma"),
    (16, 512, True, "wmma"),
    (24, 512, True, "wmma"),
    (192, 512, True, "wmma"),
    (512, 77, True, "wmma"),
    (512, 512, False, "wmma"),
]


@pytest.mark.parametrize("bs,pm,aligned,want", BODY_CASES)
def test_bf16_body_by_shape(bs, pm, aligned, want):
    assert tile_body.bf16_body(bs, pm, aligned) == want


@pytest.mark.parametrize("bs,pm,aligned,want",
                         [c for c in BODY_CASES if c[2]])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_spmm_body_of_operands(bs, pm, aligned, want, dtype):
    """The wrapper's choice reads the operands: bf16 follows the shape
    rule, f32 never asks for a bf16 body."""
    blocks = torch.zeros((1, bs, bs), dtype=dtype)
    d = torch.zeros((bs, pm), dtype=dtype)
    out = torch.zeros((bs, pm), dtype=dtype)
    got = pallas_spmm.body(blocks, d, out)
    assert got == (want if dtype == torch.bfloat16
                   else tile_body.f32_body(pm))
    if dtype == torch.float32:
        assert got == "f32"                     # every pm here is wide


def test_spmm_misaligned_or_empty_operand_takes_wmma():
    blocks = torch.zeros((1, 512, 512), dtype=torch.bfloat16)
    out = torch.zeros((512, 512), dtype=torch.bfloat16)
    flat = torch.zeros(512 * 512 + 1, dtype=torch.bfloat16)
    d = flat[1:].view(512, 512)                 # 2 bytes off a 16-byte line
    assert d.is_contiguous() and d.data_ptr() % 16 != 0
    assert pallas_spmm.body(blocks, d, out) == "wmma"
    empty = torch.zeros((0, 512, 512), dtype=torch.bfloat16)
    assert pallas_spmm.body(empty, d[:, :], out) == "wmma"


def test_cpu_route_counts_no_body_launch(tmesh):
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    rng = np.random.default_rng(10)
    a = block_sparse_np(rng, 128, 128, 64, 0.5)
    S = BlockSparseMatrix.from_numpy(a, block_size=64, mesh=tmesh,
                                     dtype="bfloat16")
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    d = torch.ones((128, 8), dtype=torch.bfloat16)
    before = dict(pallas_spmm.BODY_LAUNCHES)
    pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d, 128)
    assert pallas_spmm.BODY_LAUNCHES == before


# -- the f32 bodies: the narrow row walk up to F32_NARROW_MAX columns ----------

W = tile_body.F32_NARROW_MAX

#: (pm, body): one column (block-sparse PageRank), the widest narrow D
#: and the first wide one.
F32_BODY_CASES = [(1, "f32_narrow"), (W, "f32_narrow"), (W + 1, "f32")]


def test_f32_narrow_max_within_the_kernel():
    """The C side takes the narrow body up to 16 columns."""
    assert 1 <= W <= 16
    assert tile_body.CODES["f32_narrow"] == 3
    assert len(set(tile_body.CODES.values())) == len(tile_body.CODES)


@pytest.mark.parametrize("pm,want", F32_BODY_CASES)
def test_f32_body_by_width(pm, want):
    assert tile_body.f32_body(pm) == want


@pytest.mark.parametrize("pm,want", F32_BODY_CASES)
@pytest.mark.parametrize("bs", [4, 24, 512])
def test_spmm_f32_body_of_operands(bs, pm, want):
    """B1's f32 launches follow the width rule whatever the block size
    or alignment; the S×S kernels, which have no narrow body, never take
    it, even for tiles as narrow as D."""
    from matrel_tpu_torch.ops import pallas_spgemm
    blocks = torch.zeros((1, bs, bs))
    flat = torch.zeros(bs * pm + 1)
    for d in (flat[:-1].view(bs, pm), flat[1:].view(bs, pm)):
        assert pallas_spmm.body(blocks, d, torch.zeros((bs, pm))) == want
    assert pallas_spgemm.body(blocks, blocks, blocks) == "f32"


def spmm_cpu(a, d, bs, tmesh, out_rows):
    """The kernel wrapper on CPU tensors (its plain version) over the
    block-sparse form of ``a``."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    S = BlockSparseMatrix.from_numpy(a, block_size=bs, mesh=tmesh)
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    return pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols,
                                        torch.as_tensor(d), out_rows)


@pytest.mark.parametrize("bs,n,k,pm", [(6, 45, 29, 1), (4, 37, 22, 3),
                                       (24, 100, 70, W), (5, 31, 17, 2)])
def test_narrow_plain_within_one_ulp_of_f64(tmesh, bs, n, k, pm):
    """At pm <= F32_NARROW_MAX the plain version (and so the narrow body
    it is held bit-equal to on the card) sums in f64 and rounds once:
    within one f32 ulp of the float64 product rounded to f32, on ragged
    block sizes, empty block rows, output rows past the tile grid and a
    D shorter than it."""
    rng = np.random.default_rng(bs * 100 + pm)
    gr = -(-n // bs)
    a = block_sparse_np(rng, n, k, bs, 0.5, empty_rows=(1, gr - 2))
    d = rng.standard_normal((k, pm)).astype(np.float32)
    out_rows = n + 2 * bs + 3                   # rows past the tile grid
    got = spmm_cpu(a, d, bs, tmesh, out_rows).numpy()
    assert got.dtype == np.float32 and got.shape == (out_rows, pm)
    want = np.zeros((out_rows, pm), np.float64)
    want[:n] = a.astype(np.float64) @ d.astype(np.float64)
    want32 = want.astype(np.float32)
    ulp = np.spacing(np.abs(want32))
    assert (np.abs(got.astype(np.float64) - want32) <= ulp).all()
    assert not got[n:].any()
    assert not got[bs:2 * bs].any() and not got[(gr - 2) * bs:(gr - 1) * bs].any()


def test_wide_plain_still_sums_in_f32(tmesh):
    """Past F32_NARROW_MAX the plain version keeps its f32 sum: one f32
    matmul of the same operands, bit for bit."""
    rng = np.random.default_rng(12)
    bs, pm = 8, W + 1
    a = block_sparse_np(rng, 16, 8, bs, 1.0)
    d = rng.standard_normal((8, pm)).astype(np.float32)
    got = spmm_cpu(a, d, bs, tmesh, 16)
    want = torch.bmm(torch.as_tensor(a).view(2, 8, 8),
                     torch.as_tensor(d).expand(2, 8, pm)).reshape(16, pm)
    assert torch.equal(got, want)
