"""PyTorch port: the iterative solvers (matrel_tpu_torch/workloads/cg.py
and eigen.py) held against the JAX package on the CPU.

- CG: x0 = 0 in both packages, so the iterates agree up to f32 rounding:
  x to 1e-4 relative (‖Δx‖/‖x‖) and the iteration count within ±1 (the
  stopping test compares an f32 ‖r‖ against tol·‖b‖, which rounding can
  move by one iteration). The linear-operator form is run with a dense
  closure and with the routed SpMV (B8's plain version here, the JAX
  package's Pallas kernels in interpret mode) at passes=3.
- Power iteration: the JAX start vector comes from ``jax.random``, the
  port's from a ``torch.Generator``, so only the converged pair is
  compared: λ to 1e-4 relative and |cos(v_port, v_jax)| ≥ 1 − 1e-4, on
  matrices whose dominant eigenvalue is separated by a clear gap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.core.blockmatrix import BlockMatrix as JBlockMatrix
from matrel_tpu.core.coo import COOMatrix as JCOOMatrix
from matrel_tpu.ops import spmv_routed as jrouted
from matrel_tpu.workloads import cg as jcg
from matrel_tpu.workloads import eigen as jeigen

from matrel_tpu_torch import MatrelSession
from matrel_tpu_torch.core.coo import COOMatrix as TCOOMatrix
from matrel_tpu_torch.ops import spmv_routed as trouted
from matrel_tpu_torch.workloads import cg as tcg
from matrel_tpu_torch.workloads import eigen as teigen

X_REL = 1e-4
LAM_REL = 1e-4
COS_MIN = 1 - 1e-4


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


def _spd(rng, n):
    q = rng.standard_normal((n, n)).astype(np.float32)
    return q @ q.T + n * np.eye(n, dtype=np.float32)


def test_cg_solve_matches_jax(sess, mesh8):
    rng = np.random.default_rng(0)
    a = _spd(rng, 24)
    b = rng.standard_normal(24).astype(np.float32)
    xj, itj = jcg.cg_solve(JBlockMatrix.from_numpy(a, mesh=mesh8), b,
                           tol=1e-6)
    xt, itt = tcg.cg_solve(sess.from_numpy(a), b, tol=1e-6)
    assert xt.shape == (24,) and 0 < itt < 1000
    assert abs(itt - itj) <= 1
    assert _rel(xt.numpy(), xj) <= X_REL
    assert _rel(xt.numpy(), np.linalg.solve(a.astype(np.float64), b)) <= 1e-4


def test_cg_solve_linop_dense_closure_matches_jax():
    rng = np.random.default_rng(1)
    a = _spd(rng, 40)
    b = rng.standard_normal(40).astype(np.float32)
    aj = jnp.asarray(a)
    at = torch.from_numpy(a)
    xj, itj = jcg.cg_solve_linop(lambda v: aj @ v, jnp.asarray(b), tol=1e-6)
    xt, itt = tcg.cg_solve_linop(lambda v: at @ v, torch.from_numpy(b),
                                 tol=1e-6)
    assert abs(itt - int(itj)) <= 1
    assert _rel(xt.numpy(), xj) <= X_REL


def _laplacian_edges(rng, n, p):
    adj = (rng.random((n, n)) < p).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    lap = np.diag(adj.sum(1)) - adj + np.eye(n, dtype=np.float32)
    r, c = np.nonzero(lap)
    return lap, r, c, lap[r, c].astype(np.float32)


def test_cg_solve_linop_routed_closure_matches_jax():
    """An SPD graph Laplacian + I applied through the routed SpMV in both
    packages, passes=3 (f32-faithful)."""
    rng = np.random.default_rng(2)
    n = 600
    lap, r, c, v = _laplacian_edges(rng, n, 0.01)
    kw = dict(max_padding=10.0, max_cap=8192)
    jp = jrouted.build_routed_plan(r, c, v, n, n, **kw)
    tp = trouted.build_routed_plan(r, c, v, n, n, **kw)
    b = rng.standard_normal(n).astype(np.float32)
    xj, itj = jcg.cg_solve_linop(
        lambda x: jrouted.routed_spmv(jp, x, passes=3, interpret=True),
        jnp.asarray(b), tol=1e-6)
    xt, itt = tcg.cg_solve_linop(
        lambda x: trouted.routed_spmv(tp, x, passes=3, device="cpu"),
        torch.from_numpy(b), tol=1e-6)
    assert abs(itt - int(itj)) <= 1
    assert _rel(xt.numpy(), xj) <= X_REL
    assert _rel(xt.numpy(), np.linalg.solve(lap.astype(np.float64), b)) \
        <= 1e-4


def test_cg_least_squares_matches_jax(sess, mesh8):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 8)).astype(np.float32)
    y = (x @ np.linspace(-1, 1, 8).astype(np.float32)
         + 0.01 * rng.standard_normal(96).astype(np.float32))
    for l2 in (0.0, 5.0):
        tj, itj = jcg.cg_least_squares(JBlockMatrix.from_numpy(x, mesh=mesh8),
                                       y, l2=l2, tol=1e-7)
        tt, itt = tcg.cg_least_squares(sess.from_numpy(x), y, l2=l2,
                                       tol=1e-7)
        assert tt.shape == (8,) and abs(itt - itj) <= 1
        assert _rel(tt.numpy(), tj) <= X_REL


def test_cg_rejects_nonsquare(sess):
    A = sess.from_numpy(np.ones((4, 6), np.float32))
    with pytest.raises(ValueError):
        tcg.cg_solve(A, np.zeros(4))


def _gapped_symmetric(rng, n, top=(10.0, 5.0)):
    """Q·diag(λ)·Qᵀ with λ = top, then values in (-3, 3): the dominant
    eigenvalue leads the next by a factor of two."""
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([top, rng.uniform(-3, 3, n - len(top))])
    return ((q * lam) @ q.T).astype(np.float32)


def _cos(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return abs(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))


def test_power_iteration_matches_jax(sess, mesh8):
    a = _gapped_symmetric(np.random.default_rng(4), 24)
    lj, vj = jeigen.power_iteration(JBlockMatrix.from_numpy(a, mesh=mesh8),
                                    rounds=100)
    lt, vt = teigen.power_iteration(sess.from_numpy(a), rounds=100)
    assert vt.shape == (24,)
    assert lt == pytest.approx(lj, rel=LAM_REL)
    assert lt == pytest.approx(10.0, rel=LAM_REL)
    assert _cos(vt.numpy(), vj) >= COS_MIN


def test_power_iteration_of_expression_and_nonsquare(sess):
    a = _gapped_symmetric(np.random.default_rng(5), 12)
    A = sess.from_numpy(a)
    lam, _ = teigen.power_iteration(A.expr().multiply_scalar(2.0), rounds=100)
    assert lam == pytest.approx(20.0, rel=LAM_REL)
    with pytest.raises(ValueError):
        teigen.power_iteration(sess.from_numpy(np.ones((4, 6), np.float32)))


def test_spectral_norm_matches_jax(sess, mesh8):
    rng = np.random.default_rng(6)
    u, _ = np.linalg.qr(rng.standard_normal((20, 12)))
    w, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    s = np.concatenate([[8.0, 4.0], rng.uniform(0.1, 3.0, 10)])
    a = ((u * s) @ w.T).astype(np.float32)
    want = jeigen.spectral_norm(JBlockMatrix.from_numpy(a, mesh=mesh8),
                                rounds=100)
    got = teigen.spectral_norm(sess.from_numpy(a), rounds=100)
    assert got == pytest.approx(want, rel=LAM_REL)
    assert got == pytest.approx(8.0, rel=LAM_REL)


def _sparse_gapped(n=64):
    """A symmetric sparse matrix with a dominant eigenvalue of 6·(1+…):
    a ring (eigenvalues in [-2, 2]) plus a heavy diagonal entry pair."""
    rows = np.concatenate([np.arange(n), (np.arange(n) + 1) % n, [0, 1]])
    cols = np.concatenate([(np.arange(n) + 1) % n, np.arange(n), [0, 1]])
    vals = np.concatenate([np.ones(2 * n), [6.0, 3.0]]).astype(np.float32)
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (rows, cols), vals)
    return a, rows, cols, vals


@pytest.mark.parametrize("refused", (False, True))
def test_power_iteration_coo_matches_jax(monkeypatch, refused):
    n = 64
    a, rows, cols, vals = _sparse_gapped(n)
    if refused:          # the heavy-tail fallback: no plan, dense path
        monkeypatch.setattr(JCOOMatrix, "_get_plan", lambda self: None)
        monkeypatch.setattr(TCOOMatrix, "_get_plan", lambda self: None)
    jm = JCOOMatrix.from_edges(rows, cols, vals, shape=(n, n))
    tm = TCOOMatrix.from_edges(rows, cols, vals, shape=(n, n))
    lj, vj = jeigen.power_iteration_coo(jm, rounds=200)
    lt, vt = teigen.power_iteration_coo(tm, rounds=200, device="cpu")
    assert vt.shape == (n,)
    assert lt == pytest.approx(lj, rel=LAM_REL)
    assert abs(lt) == pytest.approx(teigen.eig_numpy_oracle(a), rel=LAM_REL)
    assert _cos(vt.numpy(), vj) >= COS_MIN
