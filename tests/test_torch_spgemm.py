"""PyTorch port: the S×S SpGEMM products (matrel_tpu_torch/ops/spgemm.py
and the kernel routes of ops/pallas_spgemm.py) and the S×S path through
``MatrelSession.compute``, held against the JAX package on the CPU.

The JAX side runs its registry kernels B4–B7 in Pallas interpret mode
(``MatrelConfig(pallas_interpret=True)``, as tests/test_kernel_registry.py
does) on a 1x1 mesh; the port runs each kernel wrapper's plain version
(CPU tensors), which reads the same host tables. Inputs are made with
numpy or by the JAX package's generators from a seed and reach the port
through ``matrel_tpu_torch.convert``. Tolerances: f32 at rtol = atol =
1e-4 and bf16 at 5e-2 (the JAX tests' own bounds).
"""

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.core.sparse import BlockSparseMatrix as JBlockSparse
from matrel_tpu.ops import kernel_registry as jkr
from matrel_tpu.ops import spgemm as jsg
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import (MatrelConfig, MatrelSession, NotPortedError,
                              convert)
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ops import kernel_registry as kr
from matrel_tpu_torch.ops import pallas_spgemm as ps
from matrel_tpu_torch.ops import spgemm as sg
from matrel_tpu_torch.ops import tile_body

JCFG = JConfig(pallas_interpret=True)
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps these tests from crowding
    the timing-sensitive tests other workers run beside them."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(device="cpu")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("structure", ["row_band", "clustered_tile",
                                       "powerlaw_coo", "generic"])
def test_spgemm_tiles_per_kernel_match_jax_interpret(jmesh, tmesh,
                                                     structure):
    JA = jkr.synthesize_structure(structure, 96, 8, jmesh, seed=5)
    JB = jkr.synthesize_structure(structure, 96, 8, jmesh, seed=6)
    TA, TB = (convert.from_reference(m, tmesh) for m in (JA, JB))
    ref = JA.to_numpy().astype(np.float64) @ JB.to_numpy()
    for kid in kr.kernel_ids():
        jt, jr, jc = jsg.spgemm_tiles(JA, JB, JCFG, kernel=kid)
        tt, tr, tc = sg.spgemm_tiles(TA, TB, MatrelConfig(), kernel=kid)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
        assert tt.dtype == torch.float32
        _close(tt, jt, torch.float32)
        got = sg.spgemm(TA, TB, MatrelConfig(), kernel=kid).to_numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("structure,kernels", [
    ("clustered_tile", ("xla_gather", "pallas_generic", "pallas_cluster")),
    ("powerlaw_coo", ("pallas_powerlaw", "pallas_band")),
])
def test_bf16_tiles_match_jax_interpret(jmesh, tmesh, structure, kernels):
    JA = jkr.synthesize_structure(structure, 128, 16, jmesh, seed=7,
                                  dtype="bfloat16")
    JB = jkr.synthesize_structure(structure, 128, 16, jmesh, seed=8,
                                  dtype="bfloat16")
    TA, TB = (convert.from_reference(m, tmesh) for m in (JA, JB))
    for kid in kernels:
        jt, _, _ = jsg.spgemm_tiles(JA, JB, JCFG, kernel=kid)
        tt, _, _ = sg.spgemm_tiles(TA, TB, MatrelConfig(), kernel=kid)
        assert tt.dtype == torch.bfloat16
        _close(tt, jt, torch.bfloat16)


def _ragged_np(rng, n, k, bs, density):
    gr, gc = -(-n // bs), -(-k // bs)
    a = np.zeros((gr * bs, gc * bs), np.float32)
    for f in rng.choice(gr * gc, size=max(1, int(gr * gc * density)),
                        replace=False):
        bi, bj = f // gc, f % gc
        a[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = \
            rng.standard_normal((bs, bs))
    return a[:n, :k]


@pytest.mark.parametrize("kernel", ["pallas_generic", "pallas_cluster"])
def test_apply_dense_ragged_matches_jax(jmesh, tmesh, kernel):
    """Ragged n % bs != 0 from ``random`` (whole tiles filled, so the
    edge tiles carry overhang that _edge_masked must scrub) times a
    ragged from_numpy operand."""
    n, k, m, bs = 100, 90, 77, 16
    JA = JBlockSparse.random((n, k), 0.3, block_size=bs, mesh=jmesh, seed=1)
    JB = JBlockSparse.from_numpy(_ragged_np(np.random.default_rng(2), k, m,
                                            bs, 0.4), block_size=bs,
                                 mesh=jmesh)
    TA, TB = (convert.from_reference(x, tmesh) for x in (JA, JB))
    want = np.asarray(jsg.apply_dense(JA, JB, JCFG, kernel=kernel))
    got = sg.apply_dense(TA, TB, MatrelConfig(), kernel=kernel)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy()[:n, :m],
                               JA.to_numpy() @ JB.to_numpy(), rtol=1e-4,
                               atol=1e-4)


def test_empty_intersection_is_one_zero_tile(jmesh, tmesh):
    a = np.zeros((32, 32), np.float32)
    a[:8, :8] = 1.0                    # A only in block column 0
    b = np.zeros((32, 32), np.float32)
    b[8:16, :] = 2.0                   # B only in block row 1
    JA, JB = (JBlockSparse.from_numpy(x, block_size=8, mesh=jmesh)
              for x in (a, b))
    TA, TB = (convert.from_reference(x, tmesh) for x in (JA, JB))
    tiles, rows, cols = sg.spgemm_tiles(TA, TB)
    assert tuple(tiles.shape) == (1, 8, 8) and not tiles.any()
    assert rows.tolist() == [0] and cols.tolist() == [0]
    launches = (ps.LAUNCHES_PAIRS, ps.LAUNCHES_GROUPED)
    got = sg.apply_dense(TA, TB)
    assert (ps.LAUNCHES_PAIRS, ps.LAUNCHES_GROUPED) == launches
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsg.apply_dense(JA, JB, JCFG)))
    assert not got.any()


def test_kernel_routes_count_no_cpu_launches(tmesh):
    A = kr.synthesize_structure("powerlaw_coo", 128, 8, tmesh, seed=2)
    before = (ps.LAUNCHES_PAIRS, ps.LAUNCHES_GROUPED, ps.LAUNCHES_BAND,
              ps.LAUNCHES_POWERLAW)
    for kid in kr.kernel_ids():
        sg.spgemm_tiles(A, A, kernel=kid)
    assert (ps.LAUNCHES_PAIRS, ps.LAUNCHES_GROUPED, ps.LAUNCHES_BAND,
            ps.LAUNCHES_POWERLAW) == before


def _coo_pair(seed, n, nnz):
    rng = np.random.default_rng(seed)
    edges = [(rng.integers(0, n, nnz), rng.integers(0, n, nnz),
              rng.standard_normal(nnz).astype(np.float32))
             for _ in range(2)]
    J = [JCOO.from_edges(r, c, v, shape=(n, n)) for r, c, v in edges]
    T = [convert.from_reference(x, None) for x in J]
    dense = []
    for r, c, v in edges:
        d = np.zeros((n, n), np.float64)
        np.add.at(d, (r, c), v)
        dense.append(d)
    return J, T, dense


@pytest.mark.parametrize("form,bs", [("bs x bs", 8), ("coo x bs", 8),
                                     ("bs x coo", 8), ("coo x coo", 8),
                                     ("coo x coo", 4)])
def test_compute_matches_jax_session(jmesh, tmesh, form, bs):
    n = 256
    (JC1, JC2), (TC1, TC2), (d1, d2) = _coo_pair(11, n, 60)
    JS = jkr.synthesize_structure("generic", n, bs, jmesh, seed=12)
    TS = convert.from_reference(JS, tmesh)
    dS = JS.to_numpy().astype(np.float64)
    operands = {"bs x bs": ((JS, TS, dS), (JS, TS, dS)),
                "coo x bs": ((JC1, TC1, d1), (JS, TS, dS)),
                "bs x coo": ((JS, TS, dS), (JC2, TC2, d2)),
                "coo x coo": ((JC1, TC1, d1), (JC2, TC2, d2))}[form]
    (ja, ta, da), (jb, tb, db) = operands
    js = JSession(mesh=jmesh, config=JConfig(pallas_interpret=True,
                                             block_size=bs))
    ts = MatrelSession(config=MatrelConfig(block_size=bs), device="cpu")
    je, te = ja.multiply(jb.expr()), ta.multiply(tb.expr())
    jplan, tplan = js.compile(je), ts.compile(te)
    keys = ("strategy", "spgemm_kernel", "spgemm_structure",
            "spgemm_kernel_source")
    assert tplan.optimized.attrs["strategy"] == "spgemm"
    assert ({k: tplan.optimized.attrs.get(k) for k in keys}
            == {k: jplan.optimized.attrs.get(k) for k in keys})
    got = ts.compute(te).to_numpy()
    np.testing.assert_allclose(got, js.compute(je).to_numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, da @ db, rtol=1e-4, atol=1e-4)


def test_mismatched_block_sizes_take_the_densify_path(jmesh, tmesh):
    A = kr.synthesize_structure("generic", 128, 8, tmesh, seed=3)
    B = kr.synthesize_structure("generic", 128, 16, tmesh, seed=4)
    s = MatrelSession(device="cpu")
    plan = s.compile(A.multiply(B))
    assert plan.optimized.attrs["strategy"] != "spgemm"
    np.testing.assert_allclose(s.compute(A.multiply(B)).to_numpy(),
                               A.to_numpy() @ B.to_numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="block sizes"):
        sg.spgemm_tiles(A, B)
    # the fused epilogue slot runs over the dense output of the
    # generic class (its registered "dense" hook)
    np.testing.assert_array_equal(
        sg.apply_dense(A, A, epilogue=lambda x: x * 2.0).numpy(),
        sg.apply_dense(A, A).numpy() * 2.0)


def test_bf16_session_keeps_the_payload_dtype(jmesh, tmesh):
    JA = jkr.synthesize_structure("clustered_tile", 256, 16, jmesh, seed=9,
                                  dtype="bfloat16")
    TA = convert.from_reference(JA, tmesh)
    js = JSession(mesh=jmesh, config=JCFG)
    ts = MatrelSession(device="cpu")
    out = ts.compute(TA.multiply(TA))
    assert out.data.dtype == torch.bfloat16
    assert ts.compile(TA.multiply(TA)).optimized.attrs["spgemm_kernel"] \
        == "pallas_cluster"
    _close(out.data, js.compute(JA.multiply(JA)).data, torch.bfloat16)


# -- the bf16 tile body of B4–B7, chosen by shape before the launch ----------


@pytest.mark.parametrize("bs,want", [
    (512, "wgmma"),     # the S×S 1% random bf16 deployment (bench.py)
    (64, "wgmma"), (128, "wgmma"), (256, "wgmma"),
    (4, "wmma"), (8, "wmma"), (16, "wmma"), (24, "wmma"), (192, "wmma"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_spgemm_body_by_shape(bs, want, dtype):
    """B4–B7 take the wgmma body at bs a power of two >= 64 (output
    columns = bs); f32 never asks for a bf16 body."""
    a = torch.zeros((2, bs, bs), dtype=dtype)
    b = torch.zeros((3, bs, bs), dtype=dtype)
    out = torch.zeros((1, bs, bs), dtype=dtype)
    got = ps.body(a, b, out)
    assert got == (want if dtype == torch.bfloat16 else "f32")
    if dtype == torch.bfloat16:
        assert tile_body.bf16_body(bs, bs, True) == want


def test_spgemm_misaligned_stack_takes_wmma():
    flat = torch.zeros(2 * 512 * 512 + 1, dtype=torch.bfloat16)
    a = flat[1:].view(2, 512, 512)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    b = torch.zeros((2, 512, 512), dtype=torch.bfloat16)
    out = torch.zeros((1, 512, 512), dtype=torch.bfloat16)
    assert ps.body(a, b, out) == "wmma"
    assert ps.body(b, a, out) == "wmma"
    assert ps.body(b, b, out) == "wgmma"


def test_spgemm_cpu_route_counts_no_body_launch(tmesh):
    A = kr.synthesize_structure("powerlaw_coo", 128, 64, tmesh, seed=2)
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    A = BlockSparseMatrix(blocks=A.blocks.to(torch.bfloat16),
                          block_rows=A.block_rows, block_cols=A.block_cols,
                          shape=A.shape, block_size=A.block_size, mesh=tmesh)
    before = dict(ps.BODY_LAUNCHES)
    for kid in kr.kernel_ids():
        sg.spgemm_tiles(A, A, kernel=kid)
    assert ps.BODY_LAUNCHES == before
