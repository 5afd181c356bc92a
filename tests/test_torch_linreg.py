"""PyTorch port: normal-equations linear regression
(matrel_tpu_torch/workloads/linreg.py), the ``solve``/``inverse``
lowerings and ``compile_exprs`` (matrel_tpu_torch/executor.py), held
against the JAX package and numpy on the CPU.

θ agrees with the JAX package to 1e-4 relative (‖Δθ‖/‖θ‖) on X with
cond(XᵀX) below ~10: at "highest" both solve in f32 from f32 Grams; at
"high" the port's right-hand side takes three bf16 passes where the
JAX package on the CPU computes in f32 (~2^-16 relative, times the
conditioning). Solves on logical shapes match numpy to 1e-4.
``hash_panel_fn`` reproduces ``bench_all.py``'s generator bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core.blockmatrix import BlockMatrix as JBlockMatrix
from matrel_tpu.workloads import linreg as jlinreg

from matrel_tpu_torch import MatrelConfig, MatrelSession, make_mesh
from matrel_tpu_torch.executor import compile_expr, compile_exprs
from matrel_tpu_torch.ir.expr import matmul, transpose
from matrel_tpu_torch.workloads import linreg as tlinreg

THETA_REL = 1e-4


@pytest.fixture(scope="module")
def sess():
    return MatrelSession(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _data(seed, n=300, k=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    theta = np.linspace(1.0, 2.0, k).astype(np.float32)[:, None]
    y = (x @ theta + 0.01 * rng.standard_normal((n, 1))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("l2", (0.0, 100.0))
def test_fit_matches_jax(sess, mesh8, l2):
    x, y = _data(0)
    want = jlinreg.fit(JBlockMatrix.from_numpy(x, mesh=mesh8),
                       JBlockMatrix.from_numpy(y, mesh=mesh8), l2=l2)
    got = tlinreg.fit(sess.from_numpy(x), sess.from_numpy(y), l2=l2)
    assert got.shape == (8, 1) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= THETA_REL


@pytest.mark.parametrize("precision", ("highest", "high"))
def test_fit_fused_matches_jax(sess, mesh8, precision):
    x, y = _data(1, n=256)
    want = jlinreg.fit_fused(JBlockMatrix.from_numpy(x, mesh=mesh8),
                             JBlockMatrix.from_numpy(y, mesh=mesh8),
                             config=JConfig(matmul_precision=precision))
    got = tlinreg.fit_fused(sess.from_numpy(x), sess.from_numpy(y),
                            config=MatrelConfig(matmul_precision=precision))
    assert _rel(got.numpy(), want) <= THETA_REL


@pytest.mark.parametrize("precision", ("highest", "high"))
def test_fit_streaming_matches_jax(mesh8, precision):
    k, panel, n_panels = 16, 256, 4
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((n_panels, panel, k)).astype(np.float32)
    theta = np.linspace(-2.0, 2.0, k).astype(np.float32)[:, None]
    ys = (xs @ theta).astype(np.float32)
    xj, yj = jnp.asarray(xs), jnp.asarray(ys)
    want = jlinreg.fit_streaming(n_panels * panel, k,
                                 lambda p: (xj[p], yj[p]), panel_rows=panel,
                                 mesh=mesh8, precision=precision)
    got = tlinreg.fit_streaming(
        n_panels * panel, k,
        lambda p: (torch.from_numpy(xs[p]), torch.from_numpy(ys[p])),
        panel_rows=panel, precision=precision)
    assert got.shape == (k, 1)
    assert _rel(got.numpy(), want) <= THETA_REL
    assert _rel(got.numpy(), theta) <= 1e-3
    with pytest.raises(ValueError, match="precision"):
        tlinreg.fit_streaming(256, k, None, precision="fast")


def test_predict_matches_jax(sess, mesh8):
    x, y = _data(3, n=50)
    th = np.linspace(0.5, 1.5, 8).astype(np.float32)[:, None]
    want = jlinreg.predict(JBlockMatrix.from_numpy(x, mesh=mesh8),
                           jnp.asarray(th))
    got = tlinreg.predict(sess.from_numpy(x), torch.from_numpy(th))
    assert got.shape == (50, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _jax_hash_panel(panel, k):
    """bench_all.py bench_linreg's panel_fn, verbatim."""
    def panel_fn(p):
        r = jnp.arange(panel, dtype=jnp.int32)[:, None]
        c = jnp.arange(k, dtype=jnp.int32)[None, :]
        s = r * 1664525 + c * 1013904223 + p * 69069 + 12345
        s = s * 1664525 + 1013904223          # one more LCG round to mix
        xp = (s >> 8).astype(jnp.float32) * (2.0 ** -23)
        yp = xp @ jnp.ones((k, 1), jnp.float32)
        return xp, yp
    return panel_fn


def test_hash_panel_fn_is_bench_all_bit_for_bit():
    panel, k = 700, 64
    jfn = jax.jit(_jax_hash_panel(panel, k))
    tfn = tlinreg.hash_panel_fn(panel, k, device="cpu")
    for p in (0, 1, 17, 39):
        xj, yj = jfn(jnp.int32(p))
        xt, yt = tfn(p)
        assert xt.dtype == torch.float32 and xt.shape == (panel, k)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert float(xt.min()) < -0.99 and float(xt.max()) > 0.99
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-4)


def test_fit_streaming_on_hash_panels_matches_jax(mesh8):
    panel, k, n = 2048, 16, 4 * 2048
    want = jlinreg.fit_streaming(n, k, _jax_hash_panel(panel, k),
                                 panel_rows=panel, mesh=mesh8)
    got = tlinreg.fit_streaming(n, k, tlinreg.hash_panel_fn(panel, k, "cpu"),
                                panel_rows=panel)
    assert _rel(got.numpy(), want) <= THETA_REL
    assert _rel(got.numpy(), np.ones(k)) <= 1e-3


@pytest.mark.parametrize("grid", ((1, 1), (2, 4)))
@pytest.mark.parametrize("assume", ("general", "pos"))
def test_solve_through_compile_expr(grid, assume):
    """solve(A, B) on the logical shape; on the (2, 4) grid the operands
    are zero-padded to multiples of 8 and must be sliced first."""
    mesh = make_mesh(grid, device="cpu")
    s = MatrelSession(mesh=mesh)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((10, 10)).astype(np.float32)
    a = q @ q.T + 10 * np.eye(10, dtype=np.float32)
    b = rng.standard_normal((10, 3)).astype(np.float32)
    e = s.from_numpy(a).expr().solve(s.from_numpy(b), assume=assume)
    out = s.compute(e)
    assert out.shape == (10, 3)
    np.testing.assert_allclose(out.to_numpy(),
                               np.linalg.solve(a.astype(np.float64), b),
                               rtol=1e-4, atol=1e-4)
    pad = out.data[10:, :]
    assert pad.numel() == 0 or not pad.any()


@pytest.mark.parametrize("grid", ((1, 1), (2, 4)))
def test_inverse_and_r7_through_compile_expr(grid):
    mesh = make_mesh(grid, device="cpu")
    s = MatrelSession(mesh=mesh)
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((9, 9)) + 9 * np.eye(9)).astype(np.float32)
    b = rng.standard_normal((9, 2)).astype(np.float32)
    A, B = s.from_numpy(a), s.from_numpy(b)
    inv = s.compute(A.expr().inverse())
    np.testing.assert_allclose(inv.to_numpy(),
                               np.linalg.inv(a.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)
    # R7 rewrites A⁻¹·B into solve(A, B)
    plan = compile_expr(A.expr().inverse().multiply(B), mesh)
    assert plan.optimized.kind == "solve"
    np.testing.assert_allclose(plan.run().to_numpy(),
                               np.linalg.solve(a.astype(np.float64), b),
                               rtol=1e-4, atol=1e-4)


def test_solve_pos_on_non_spd_gives_nan(sess):
    a = np.diag([1.0, -2.0, 3.0]).astype(np.float32)
    b = np.ones((3, 1), np.float32)
    e = sess.from_numpy(a).expr().solve(sess.from_numpy(b), assume="pos")
    assert np.isnan(sess.compute(e).to_numpy()).all()
    e = sess.from_numpy(a).expr().solve(sess.from_numpy(b))
    np.testing.assert_allclose(sess.compute(e).to_numpy()[:, 0],
                               [1.0, -0.5, 1.0 / 3.0], rtol=1e-6)


def test_compile_exprs_shares_leaves(sess):
    x, y = _data(6, n=40, k=5)
    X, Y = sess.from_numpy(x), sess.from_numpy(y)
    xe = X.expr()
    plan = compile_exprs((matmul(transpose(xe), xe),
                          matmul(transpose(xe), Y.expr())))
    assert len(plan.optimized) == 2
    assert len(plan.leaf_order) == 2          # X once, y once
    gram, rhs = plan.run()
    np.testing.assert_allclose(gram.to_numpy(), x.T @ x, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(rhs.to_numpy(), x.T @ y, rtol=1e-5, atol=1e-4)
    # rebinding y reruns the shared plan on new data
    y2 = 2 * y
    uid = [l.uid for l in plan.leaf_order
           if l.attrs["matrix"] is Y][0]
    _, rhs2 = plan.run({uid: sess.from_numpy(y2)})
    np.testing.assert_allclose(rhs2.to_numpy(), x.T @ y2, rtol=1e-5,
                               atol=1e-4)
