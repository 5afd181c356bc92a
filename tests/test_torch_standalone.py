"""PyTorch port: the package stands alone and refuses what it has not
ported.

- With ``jax`` and ``matrel_tpu`` blocked in ``sys.modules`` (in a
  subprocess), ``import matrel_tpu_torch`` and a CPU ``compute`` work.
- No module of the port, nor ``chip_smoke.py``, imports ``jax`` or the
  JAX package (checked on the syntax tree, lazy imports included).
- The default device is CUDA: without a card the session raises unless
  the caller asked for the CPU.
- The routed SpMV, the CG / power-iteration / linreg workloads,
  ``solve`` queries, the north-star chain (``workloads/big_chain.py``),
  the native chain DP (``utils/native.py``), ``run_many``, ``vec`` and
  ``rank1``, and the relational surface (``relational/``, the COO
  σ/γ/⋈ methods, ``sql.py``, ``io.py`` with its native readers, the
  triangle and similarity workloads) run on the CPU with the JAX
  package blocked.
- Whole-plan fusion (``ir/fusion.py``, the unit programs) and
  staged-reshard planning (``parallel/reshard.py``) run on the CPU with
  the JAX package blocked.
- The serving plane (the result cache, ``submit`` with tenants and
  deadlines, cross-query CSE, ``register_delta`` over the streaming
  dashboard) runs on the CPU with the JAX package blocked.
- The observability plane (the event log, spans, the flight recorder,
  EXPLAIN ANALYZE, ``session.why``, the drift table and learned
  coefficients, the loopback metrics endpoint, lockdep) and the
  resilience ladder (injected faults climbing the degradation rungs,
  the breaker, brownout) run on the CPU with the JAX package blocked.
- A rank process of a gloo rank mesh (``core/mesh.init_distributed``)
  runs a recipe, a sharded matvec and a staged reshard with the JAX
  package blocked.
- The durable half of serving (the spill tiers, ``save_state`` /
  ``restore``, ``save_catalog`` / ``load_catalog``, ``run_resilient``)
  and the static verifier (``verify_plans``, ``session.verify``) run on
  the CPU with the JAX package blocked.
- The randomized soak, the chaos drill and the race drill
  (``matrel_tpu_torch/tools/``) run on the CPU with the JAX package
  blocked.
- The operator drills of ``tools/`` (plan_snapshot, plan_verify,
  topology_flip, flight_drill, provenance_drill, the traffic harness's
  pool and arrival schedule, lockcheck) run on the CPU with the JAX
  package blocked.
- Node kinds outside ``LOWERED_KINDS`` and the knobs of unported planes
  (the fleet, the JAX-only execution knobs) raise ``NotPortedError``.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from matrel_tpu_torch import (BlockSparseMatrix, DeviceUnavailableError,
                              MatrelConfig, MatrelSession, NotPortedError)

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_imports_and_computes_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        import matrel_tpu_torch
        from matrel_tpu_torch import BlockSparseMatrix, MatrelSession
        s = MatrelSession(device="cpu")
        rng = np.random.default_rng(0)
        a = rng.standard_normal((20, 6)).astype(np.float32)
        b = rng.standard_normal((6, 9)).astype(np.float32)
        c = rng.standard_normal((9, 4)).astype(np.float32)
        A, B, C = (s.from_numpy(x) for x in (a, b, c))
        out = s.compute(A.multiply(B).multiply(C)).to_numpy()
        assert np.allclose(out, a @ b @ c, rtol=1e-4, atol=1e-4)
        sp = np.zeros((16, 20), np.float32)
        sp[8:16, 0:8] = 1.0
        S = BlockSparseMatrix.from_numpy(sp, block_size=8, mesh=s.mesh)
        out = s.compute(S.multiply(A)).to_numpy()
        assert np.allclose(out, sp @ a, rtol=1e-4, atol=1e-4)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone ok" in proc.stdout


def test_coo_and_pagerank_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch.core.coo import COOMatrix
        from matrel_tpu_torch.workloads import pagerank
        from matrel_tpu_torch import MatrelSession
        rng = np.random.default_rng(0)
        n, m = 400, 3000
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        r = pagerank.pagerank_edges(src, dst, n, rounds=12, impl="onehot",
                                    device="cpu").numpy()
        a = np.zeros((n, n))
        np.add.at(a, (src, dst), 1.0)
        ref = pagerank.pagerank_numpy_oracle(a, rounds=12).ravel()
        assert np.abs(r - ref).max() / np.abs(ref).max() < 1e-5
        assert abs(r.sum() - 1.0) < 1e-3
        A = COOMatrix.from_edges(src, dst, shape=(n, n))
        s = MatrelSession(device="cpu")
        x = rng.standard_normal((n, 1)).astype(np.float32)
        y = s.compute(A.multiply(s.from_numpy(x))).to_numpy()
        assert np.allclose(y, a @ x, rtol=1e-5, atol=1e-5)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone coo ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone coo ok" in proc.stdout


def test_spgemm_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch import MatrelSession
        from matrel_tpu_torch.core.coo import COOMatrix
        from matrel_tpu_torch.ops import kernel_registry as kr
        from matrel_tpu_torch.ops import pallas_spgemm, spgemm
        s = MatrelSession(device="cpu")
        A = kr.synthesize_structure("powerlaw_coo", 256, 16, s.mesh, seed=1)
        a = A.to_numpy().astype(np.float64)
        plan = s.compile(A.multiply(A))
        assert plan.optimized.attrs["spgemm_kernel"] == "pallas_powerlaw"
        out = s.compute(A.multiply(A)).to_numpy()
        assert np.allclose(out, a @ a, rtol=1e-4, atol=1e-4)
        rng = np.random.default_rng(0)
        C = COOMatrix.from_edges(rng.integers(0, 256, 50),
                                 rng.integers(0, 256, 50), shape=(256, 256))
        c = np.zeros((256, 256))
        np.add.at(c, (C.rows, C.cols), C.vals)
        out = s.compute(C.multiply(A.expr())).to_numpy()
        assert np.allclose(out, c @ a, rtol=1e-4, atol=1e-4)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone spgemm ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone spgemm ok" in proc.stdout


def test_fusion_and_reshard_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch import MatrelConfig, MatrelSession, executor
        from matrel_tpu_torch.core.mesh import make_mesh
        from matrel_tpu_torch.ir import fusion
        from matrel_tpu_torch.ops import kernel_registry as kr
        rng = np.random.default_rng(0)
        mesh = make_mesh((2, 4), device="cpu")
        on = MatrelConfig(fusion_enable=True)
        s = MatrelSession(mesh=mesh, config=on)
        x = rng.standard_normal((32, 16)).astype(np.float32)
        X = s.from_numpy(x)
        e = X.expr().t().multiply(X.expr()).multiply_scalar(0.5) \\
            .row_sum()
        plan = s.compile(e)
        assert len(fusion.collect_stamps(plan.optimized)) == 1
        out = s.compute(e).to_numpy()
        assert np.allclose(out, (x.T @ x * 0.5).sum(1, keepdims=True),
                           rtol=1e-4, atol=1e-4)
        ru = executor.compile_region_units(e, mesh, on)
        su = executor.compile_staged_units(e, mesh, on)
        assert ru.dispatches < su.dispatches
        assert np.array_equal(ru.run().numpy(), su.run().numpy())
        A = kr.synthesize_structure("row_band", 128, 8,
                                    make_mesh(device="cpu"), seed=1)
        q = A.multiply(A).multiply_scalar(0.5).power(2.0)
        cfg8 = MatrelConfig(block_size=8, spgemm_density_threshold=0.6)
        fused = MatrelSession(config=cfg8.replace(fusion_enable=True),
                              device="cpu").compute(q).to_numpy()
        staged = MatrelSession(config=cfg8, device="cpu").compute(q)
        assert np.array_equal(fused, staged.to_numpy())
        bud = MatrelSession(mesh=mesh, config=MatrelConfig(
            reshard_peak_budget_bytes=1 << 20))
        Y = bud.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
        assert np.array_equal(bud.compute(Y.multiply(X)).to_numpy(),
                              MatrelSession(mesh=mesh).compute(
                                  Y.multiply(X)).to_numpy())
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone fusion ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone fusion ok" in proc.stdout


def test_serving_plane_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch import MatrelConfig, MatrelSession
        from matrel_tpu_torch.resilience import DeadlineExceeded
        from matrel_tpu_torch.workloads.streaming import StreamingGraph
        rng = np.random.default_rng(0)
        s = MatrelSession(config=MatrelConfig(
            result_cache_max_bytes=1 << 24, cse_enable=True,
            serve_tenant_weights="a:3,b:1"), device="cpu")
        x = rng.standard_normal((32, 16)).astype(np.float32)
        X = s.from_numpy(x)
        g = X.expr().t().multiply(X.expr())
        outs = s.run_many([g.multiply_scalar(2.0), g.row_sum()])
        assert s.mqo_info()["cse_hoisted"] == 1
        assert np.allclose(outs[0].to_numpy(), 2 * x.T @ x, rtol=1e-4,
                           atol=1e-4)
        futs = [s.submit(g.multiply_scalar(2.0), tenant=t)
                for t in ("a", "b")]
        assert all(f.result(timeout=60) is outs[0] for f in futs)
        late = s.submit(g, deadline_ms=0.001)
        try:
            late.result(timeout=60)
            raise AssertionError("a 0.001 ms deadline was met")
        except DeadlineExceeded:
            pass
        s.serve_close(timeout=60)
        d = StreamingGraph(s, n=48, batch_edges=4, window=2, feature_k=4)
        d.run_all()
        for _ in range(2):
            assert d.step_delta()["patched"] >= 1
            got, want = d.run_all(), d.oracle()
            for k in ("degrees", "common_neighbors", "triangles6"):
                assert np.array_equal(got[k], want[k]), k
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone serving ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone serving ok" in proc.stdout


def test_durable_state_and_verifier_without_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch import MatrelConfig, MatrelSession
        from matrel_tpu_torch.utils.checkpoint import CheckpointManager
        from matrel_tpu_torch.utils.resilience import run_resilient
        root = sys.argv[1]
        rng = np.random.default_rng(0)
        cfg = MatrelConfig(result_cache_max_bytes=20000, spill_enable=True,
                           spill_host_max_bytes=1, spill_disk_hits=0,
                           state_dir=root, verify_plans="error",
                           coeff_planner_enable=True,
                           coeff_replan_enable=True,
                           drift_table_path=root + "/drift.json")
        s = MatrelSession(config=cfg, device="cpu")
        a, b = (rng.standard_normal((64, 64)).astype(np.float32)
                for _ in range(2))
        s.register("a", s.from_numpy(a))
        s.register("b", s.from_numpy(b))
        qa = s.table("a").expr().multiply(s.table("b").expr())
        qb = s.table("b").expr().multiply(s.table("a").expr())
        r = s.run(qa).to_numpy()
        s.run(qb)
        assert s.result_cache_info()["spill"]["disk_entries"] == 1
        assert np.array_equal(s.run(qa).to_numpy(), r)
        assert s.verify(qa) == []
        assert "== Verifier ==" in s.explain(qa)
        assert s.save_state()["rc_entries"] == 2
        s2 = MatrelSession(config=cfg, device="cpu")
        assert s2.restore()["restored"]
        q2 = s2.table("a").expr().multiply(s2.table("b").expr())
        assert np.array_equal(s2.run(q2).to_numpy(), r)
        assert s2.result_cache_info()["spill"]["thawed_restored"] == 1
        s2.save_catalog(root + "/cat")
        assert MatrelSession(device="cpu").load_catalog(
            root + "/cat") == ["a", "b"]
        cm = CheckpointManager(root + "/ckpt")
        _m, st = run_resilient(lambda i, m, st: (m, dict(st, last=i)),
                               cm, s.mesh, {"a": s.table("a")},
                               num_steps=3, checkpoint_interval=2)
        assert st["last"] == 2 and cm.latest_step() == 2
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone durable ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone durable ok" in proc.stdout


def test_fleet_and_tools_without_jax(tmp_path):
    """The fleet on the virtual (2, 4) grid, its event log read by the
    history, trace, top and why CLIs, the bridge and ``utils/debug``,
    with the JAX package blocked."""
    code = textwrap.dedent("""
        import argparse, contextlib, io, sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        import torch
        from matrel_tpu_torch import MatrelConfig, MatrelSession
        from matrel_tpu_torch.__main__ import main as cli
        from matrel_tpu_torch.bridge import BridgeClient, BridgeServer
        from matrel_tpu_torch.utils.debug import assert_finite, checked
        log = sys.argv[1] + "/events.jsonl"
        s = MatrelSession(config=MatrelConfig(
            fleet_slices=2, mesh_shape=(2, 4), obs_level="on",
            obs_event_log=log, obs_provenance=8,
            result_cache_max_bytes=1 << 24), device="cpu")
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal((32, 32)).astype(np.float32)
                for _ in range(2))
        s.register("a", s.from_numpy(a))
        s.register("b", s.from_numpy(b))
        q = s.table("a").expr().multiply(s.table("b").expr())
        r = s.submit(q).result(timeout=60).to_numpy()
        assert np.allclose(r, a @ b, rtol=1e-4, atol=1e-4)
        assert np.array_equal(s.submit(q).result(timeout=60).to_numpy(), r)
        info = s.fleet_info()
        assert info["source"] == "virtual"
        assert info["directory"]["hits"] == 1
        s.serve_close(timeout=60)
        for argv in (["history", "--log", log, "--summary"],
                     ["trace", "--export", "chrome", "--log", log,
                      "--out", "-"],
                     ["top", "--once", "--log", log],
                     ["why", "--log", log]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    cli(argv)
                except SystemExit as ex:
                    assert not ex.code, (argv, ex.code)
            assert buf.getvalue(), argv
        srv = BridgeServer(MatrelSession(device="cpu"))
        srv.serve_background()
        c = BridgeClient("127.0.0.1", srv.port)
        c.call("upload", name="A", data=[[1.0, 2.0], [3.0, 4.0]])
        assert c.call("sql", query="transpose(A)")["data"] == [
            [1.0, 3.0], [2.0, 4.0]]
        c.call("shutdown")
        c.close()
        srv.server_close()
        assert_finite(torch.ones(3))
        try:
            checked(lambda x: torch.log(x))(-torch.ones(2))
        except FloatingPointError:
            pass
        else:
            raise AssertionError("checked let a NaN through")
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone fleet ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone fleet ok" in proc.stdout


def test_obs_and_resilience_planes_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys, json, urllib.request
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch import MatrelConfig, MatrelSession
        from matrel_tpu_torch.obs import drift
        from matrel_tpu_torch.obs.events import read_events
        from matrel_tpu_torch.parallel import coeffs
        from matrel_tpu_torch.utils import lockdep, profiling
        log = {str(tmp_path / "ev.jsonl")!r}
        table = {str(tmp_path / "drift.json")!r}
        s = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=log, obs_flight_recorder=32,
            obs_provenance=16, lockdep_enable=True,
            fault_inject="execute:transient:p=1.0:max=3",
            retry_max_attempts=3, retry_backoff_ms=0.0,
            breaker_threshold=2, brownout_enable=True,
            drift_table_path=table, coeff_planner_enable=True,
            mesh_shape=(2, 2), obs_metrics_port=0), device="cpu")
        rng = np.random.default_rng(0)
        a = rng.standard_normal((32, 32)).astype(np.float32)
        A = s.from_numpy(a)
        out = s.compute(A.multiply(A)).to_numpy()
        assert np.allclose(out, a @ a, rtol=1e-4, atol=1e-4)
        assert s.why(last=1)[0]["degrade"]["rung"] == 3
        text = s.explain(A.multiply(A).multiply(A), analyze=True)
        assert "== Analyzed physical plan" in text
        ev = read_events(log)
        kinds = {{e["kind"] for e in ev}}
        assert {{"query", "span", "fault", "retry", "degrade",
                 "analyze", "provenance"}} <= kinds, kinds
        drift.update_table(table, drift.calibrate(
            list(drift.iter_samples(ev))))
        assert coeffs.epoch(table) != coeffs.COLD_EPOCH
        f = s.submit(A.multiply(A))
        assert np.allclose(f.result(timeout=60).to_numpy(), a @ a,
                           rtol=1e-4, atol=1e-4)
        s.serve_close(timeout=60)
        assert lockdep.diagnostics() == [] and lockdep.is_acyclic()
        lockdep.disable()
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone obs ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone obs ok" in proc.stdout


def test_solvers_and_routed_spmv_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        import torch
        from matrel_tpu_torch import MatrelSession
        from matrel_tpu_torch.ops import spmv_routed
        from matrel_tpu_torch.workloads import cg, eigen, linreg
        rng = np.random.default_rng(0)
        n, m = 20000, 3000
        rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
        vals = rng.standard_normal(m).astype(np.float32)
        plan = spmv_routed.build_routed_plan(rows, cols, vals, n, n,
                                             max_padding=10.0)
        x = rng.standard_normal(n).astype(np.float32)
        y = spmv_routed.routed_spmv(plan, x, passes=3, device="cpu").numpy()
        want = np.zeros(n)
        np.add.at(want, rows, vals.astype(np.float64) * x[cols])
        assert np.abs(y - want).max() <= 1e-6 * np.abs(want).max()
        s = MatrelSession(device="cpu")
        q = rng.standard_normal((12, 12)).astype(np.float32)
        a = q @ q.T + 12 * np.eye(12, dtype=np.float32)
        b = rng.standard_normal(12).astype(np.float32)
        xs, it = cg.cg_solve(s.from_numpy(a), b, tol=1e-6)
        assert np.allclose(xs.numpy(), np.linalg.solve(a, b), atol=1e-4)
        lam, _ = eigen.power_iteration(s.from_numpy(a), rounds=300)
        assert abs(lam - np.linalg.eigvalsh(a).max()) < 1e-3 * lam
        X = rng.standard_normal((200, 6)).astype(np.float32)
        t = linreg.fit(s.from_numpy(X), s.from_numpy(X @ np.ones((6, 1),
                                                                 np.float32)))
        assert np.allclose(t.numpy(), 1.0, atol=1e-4)
        e = s.from_numpy(a).expr().solve(s.from_numpy(b[:, None]),
                                         assume="pos")
        assert np.allclose(s.compute(e).to_numpy()[:, 0],
                           np.linalg.solve(a, b), atol=1e-4)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone solvers ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone solvers ok" in proc.stdout


def test_big_chain_and_core_surface_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        import torch
        from matrel_tpu_torch import MatrelSession
        from matrel_tpu_torch.ir import chain
        from matrel_tpu_torch.utils import native
        from matrel_tpu_torch.workloads import big_chain
        gens = [big_chain.cheap_gen(s, 8, torch.float32, 0.05, device="cpu")
                for s in (1, 2, 3)]
        slab = float(big_chain.streaming_chain_slab(
            64, *gens, tile=8, panel=16, dtype=torch.float32))
        A, B, C = (g.slab(0, 0, (64, 64)).double().numpy() for g in gens)
        want = float(((A @ B @ C) ** 2).sum())
        assert abs(slab - want) <= 1e-4 * want, (slab, want)
        assert native.chain_dp([10, 1000, 10, 1000], [1.0] * 3) is not None
        s = MatrelSession(device="cpu")
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal(sh).astype(np.float32)
                for sh in ((20, 6), (6, 9)))
        X, Y = s.from_numpy(a), s.from_numpy(b)
        outs = s.run_many([X.multiply(Y), X.expr().vec(), X.multiply(Y)])
        assert np.allclose(outs[0].to_numpy(), a @ b, rtol=1e-4, atol=1e-4)
        assert np.array_equal(outs[1].to_numpy()[:, 0], a.T.reshape(-1))
        assert outs[2] is outs[0] and s.plan_cache_info()["plans"] == 1
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone big chain ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone big chain ok" in proc.stdout


def test_relational_sql_and_io_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        from matrel_tpu_torch import MatrelSession, io
        from matrel_tpu_torch.core.coo import COOMatrix
        from matrel_tpu_torch.relational import ops as R
        from matrel_tpu_torch.workloads import similarity, triangles
        s = MatrelSession(device="cpu")
        rng = np.random.default_rng(0)
        a = np.round(rng.standard_normal((12, 8)) * 4) / 4
        a = a.astype(np.float32)
        A = s.from_numpy(a)
        got = s.compute(R.aggregate(R.join_on_values(A, A, "mul", "lt"),
                                    "sum", "row")).to_numpy()[:, 0]
        va = a.T.reshape(-1).astype(np.float64)
        want = np.where(va[:, None] < va[None, :],
                        va[:, None] * va[None, :], 0).sum(1)
        assert np.allclose(got, want, rtol=1e-5, atol=1e-5)
        s.register("A", A)
        q = "SELECT rowsum(select(A, 'v > 0')) FROM A"
        got = s.compute(s.sql(q)).to_numpy()
        assert np.allclose(got, np.where(a > 0, a, 0).sum(1, keepdims=True))
        s.compute(s.sql(q))
        assert s.plan_cache_info()["plans"] == 2
        assert "join_rows replicate=" in s.explain_sql(
            "joinrows(A, A, 'mul')")
        C = COOMatrix.from_edges([0, 1, 2], [1, 2, 0], [1.0, -2.0, 3.0],
                                 shape=(3, 3))
        sel = C.select_value(lambda v: v > 0)
        y = sel.matvec(np.ones(3, np.float32), device="cpu").numpy()
        assert np.allclose(y, [1.0, 0.0, 3.0])
        p = {str(tmp_path / "m.mtx")!r}
        with open(p, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\\n"
                    "2 2 2\\n1 2 5.0\\n2 1 -1.0\\n")
        m = io.load_mtx(p, mesh=s.mesh, block_size=2)
        assert np.array_equal(m.to_numpy(), [[0, 5], [-1, 0]])
        g = np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32)
        assert triangles.triangle_count(s.from_numpy(g), s) == 4.0
        x = rng.standard_normal((5, 3)).astype(np.float32)
        sim = similarity.cosine_similarity(s.from_numpy(x), s)
        assert np.allclose(np.diag(sim), 1.0, atol=1e-5)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone relational ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone relational ok" in proc.stdout


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO))
     for p in (REPO / "matrel_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(REPO / path)
           if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_rank_processes_without_jax(tmp_path):
    """Two gloo CPU ranks, each its own interpreter with the JAX package
    blocked: a rank mesh, a CPMM product, a sharded COO matvec and a
    staged reshard run, and neither rank loads jax or matrel_tpu."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        import numpy as np
        import torch
        from matrel_tpu_torch import MatrelConfig, MatrelSession
        from matrel_tpu_torch.core import mesh as mesh_lib
        from matrel_tpu_torch.core.coo import COOMatrix
        from matrel_tpu_torch.parallel import collectives as coll, reshard
        rank, store = int(sys.argv[1]), sys.argv[2]
        mesh = mesh_lib.init_distributed("gloo", "file://" + store, 2, rank,
                                         grid=(1, 2), device="cpu",
                                         timeout_s=60)
        rng = np.random.default_rng(0)
        a = rng.standard_normal((10, 12)).astype(np.float32)
        b = rng.standard_normal((12, 6)).astype(np.float32)
        s = MatrelSession(mesh=mesh, config=MatrelConfig(
            strategy_override="cpmm"))
        out = s.compute(s.from_numpy(a).multiply(s.from_numpy(b)))
        assert np.allclose(out.to_numpy(), a @ b, rtol=1e-4, atol=1e-4)
        M = COOMatrix.from_edges([0, 1, 5], [2, 3, 4], [1.0, 2.0, 3.0],
                                 shape=(6, 6))
        x = np.arange(6, dtype=np.float32)
        assert np.allclose(M.shard(mesh).matvec(x).numpy(),
                           M.to_dense() @ x)
        full = torch.arange(24.0).reshape(4, 6)
        plan = reshard.compile_reshard("row", "col", 96.0, 1, 2)
        moved = reshard.apply_staged(coll.shard_from_full(full, "row", mesh),
                                     plan, mesh)
        assert torch.equal(coll.gather_full(moved, mesh), full)
        mesh_lib.shutdown_distributed()
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("rank ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store],
                              cwd=str(REPO), env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "rank ok" in out


def test_soak_and_drills_without_jax(tmp_path):
    """The soak (a fuzz, spmv, routed, sparse-kernel and precision
    battery), the chaos drill and the race drill of ``tools/`` run on the
    CPU with the JAX package blocked, and find nothing."""
    code = textwrap.dedent("""
        import os, sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        os.environ["MATREL_OBS_EVENT_LOG"] = sys.argv[1] + "/events.jsonl"
        os.environ["MATREL_SOAKLOG_PATH"] = sys.argv[1] + "/soak.jsonl"
        os.environ["MATREL_RACE_SEEDS"] = "1"
        from matrel_tpu_torch.tools import chaos_drill, race_drill, soak
        for battery in ("fuzz", "spmv", "routed", "sparse_kernels",
                        "precision"):
            assert soak.main([battery, "--seeds", "2",
                              "--device", "cpu"]) == 0, battery
        assert chaos_drill.main(["--device", "cpu"]) == 0
        assert race_drill.main(["--device", "cpu"]) == 0
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone tools ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone tools ok" in proc.stdout


def test_operator_tools_without_jax(tmp_path):
    """The operator drills run on the CPU with the JAX package blocked
    and pass: the plan corpus against the committed snapshot, the
    verifier, the topology flip, the flight-recorder and provenance
    drills, the traffic pool's answers, and lockcheck over the port."""
    code = textwrap.dedent("""
        import os, sys
        for name in ("jax", "jaxlib", "matrel_tpu"):
            sys.modules[name] = None          # import raises ImportError
        d = sys.argv[1]
        os.environ["MATREL_OBS_EVENT_LOG"] = d + "/events.jsonl"
        os.environ["MATREL_OBS_FLIGHT_RECORDER_PATH"] = d + "/flight.json"
        os.environ["MATREL_DRIFT_TABLE_PATH"] = d + "/drift.json"
        import numpy as np
        from matrel_tpu_torch import MatrelSession
        from matrel_tpu_torch.core.mesh import make_mesh
        from matrel_tpu_torch.tools import (flight_drill, lockcheck,
                                            plan_snapshot, plan_verify,
                                            provenance_drill, topology_flip,
                                            traffic)
        cpu = ["--device", "cpu"]
        for tool in (plan_snapshot, plan_verify, topology_flip,
                     flight_drill, provenance_drill):
            assert tool.main(cpu) == 0, tool.__name__
        assert lockcheck.main([]) == 0
        rng = np.random.default_rng(0)
        assert traffic.arrival_schedule(rng, 100.0, 1.0, "bursty")
        s = MatrelSession(mesh=make_mesh((2, 4), device="cpu"))
        for name, e, want in traffic.build_pool(s, rng):
            assert traffic.oracle_ok(s.run(e).to_numpy(), want), name
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "matrel_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("standalone operator tools ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "standalone operator tools ok" in proc.stdout


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        MatrelSession()
    with pytest.raises(DeviceUnavailableError):
        MatrelSession.builder().device("cuda").get_or_create()
    assert MatrelSession(device="cpu").device.type == "cpu"


def test_unported_planes_and_kinds_raise():
    # every knob is live now: the verifier's, re-planner's and spill
    # hierarchy's, the fleet's and the three execution knobs with their
    # torch meaning (config.py)
    assert MatrelConfig(verify_plans="warn").verify_plans == "warn"
    assert MatrelConfig(donate_intermediates=False).donate_intermediates \
        is False
    assert MatrelConfig().replace(
        plan_cache_max_bytes=1).plan_cache_max_bytes == 1
    s = MatrelSession(device="cpu")
    rng = np.random.default_rng(1)
    A = s.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    b = s.from_numpy(rng.standard_normal((4, 1)).astype(np.float32))
    # every node kind of the JAX package lowers now (select_value was
    # the unported example here until the relational slice); a kind
    # outside LOWERED_KINDS still raises
    from matrel_tpu_torch.ir.expr import MatExpr
    with pytest.raises(NotPortedError, match="not_a_kind"):
        s.compute(MatExpr("not_a_kind", (A.expr(),), (4, 4), None))
    assert MatrelConfig(coeff_planner_enable=True,
                        coeff_replan_enable=True).coeff_replan_enable
    assert MatrelConfig(pallas_interpret=True).pallas_interpret is True
    from matrel_tpu_torch.ops import spgemm
    sp = np.eye(16, dtype=np.float32)
    S = BlockSparseMatrix.from_numpy(sp, block_size=8, mesh=s.mesh)
    assert MatrelConfig().replace(fleet_slices=2).fleet_slices == 2
    with pytest.raises(ValueError, match="state_dir"):
        s.save_state()
    # the fused SpGEMM epilogue slot is ported (ir/fusion.py)
    assert torch.equal(spgemm.apply_dense(S, S, epilogue=lambda x: -x),
                       -spgemm.apply_dense(S, S))
