"""PyTorch port: ``utils/checkpoint.py`` and ``utils/resilience.py`` held
against the JAX package on the CPU.

``tests/test_utils.py``'s checkpoint and ``run_resilient`` cases run in
both packages on the same seeded arrays (the JAX package on its (2, 4)
CPU mesh, the port on the virtual (2, 4) grid, ``device="cpu"``) and must
agree; keep-k GC and the typed ``CheckpointCorruption``; checkpoints
crossing between the packages (a JAX-written step, bfloat16 leaf
included, restored by the port; a port-written f32 / int32 step restored
by the JAX package); a port-written bfloat16 step restored bit-equal;
the session's ``save_catalog`` / ``load_catalog`` with a block-sparse
table; fleet directory hints one package's ``save_state`` exports and
the other's ``restore`` seeds; and ``run_resilient`` through a transient fault injected at the
``checkpoint`` site.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
from matrel_tpu.session import MatrelSession as JSession
from matrel_tpu.utils import resilience as j_res
from matrel_tpu.utils.checkpoint import CheckpointManager as JCM

from matrel_tpu_torch.config import MatrelConfig as TConfig
from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.core.sparse import BlockSparseMatrix as TBSM
from matrel_tpu_torch.resilience import faults
from matrel_tpu_torch.resilience.errors import (CheckpointCorruption,
                                                InjectedFault)
from matrel_tpu_torch.session import MatrelSession as TSession
from matrel_tpu_torch.utils import resilience as t_res
from matrel_tpu_torch.utils.checkpoint import CheckpointManager as TCM


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh((2, 4), device="cpu")


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    yield
    faults.reset()


def _pair(mesh8, tmesh8):
    return ((JBM, JCM, j_res, mesh8), (TBM, TCM, t_res, tmesh8))


# ---------------------------------------------------------------------------
# tests/test_utils.py's cases, in both packages
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip(self, mesh8, tmesh8, tmp_path):
        a = np.random.default_rng(0).standard_normal(
            (12, 10)).astype(np.float32)
        got = []
        for i, (BM, CM, _res, mesh) in enumerate(_pair(mesh8, tmesh8)):
            bm = BM.from_numpy(a, mesh=mesh, nnz=37)
            cm = CM(str(tmp_path / str(i)))
            cm.save(3, matrices={"A": bm}, state={"alpha": 0.85})
            step, mats, arrs, state = cm.restore(mesh)
            m = mats["A"]
            assert m.shape == (12, 10) and m.nnz == 37
            assert tuple(m.spec) == tuple(bm.spec)
            np.testing.assert_allclose(m.to_numpy(), a, rtol=1e-6)
            got.append((step, state, tuple(m.spec), m.to_numpy()))
        assert got[0][:3] == got[1][:3]
        assert np.array_equal(got[0][3], got[1][3])

    def test_gc_keeps_last_k(self, mesh8, tmesh8, tmp_path):
        a = np.random.default_rng(1).standard_normal(
            (8, 8)).astype(np.float32)
        for i, (BM, CM, _res, mesh) in enumerate(_pair(mesh8, tmesh8)):
            cm = CM(str(tmp_path / str(i)), keep=2)
            for s in (1, 2, 3, 4):
                cm.save(s, matrices={"A": BM.from_numpy(a, mesh=mesh)})
            assert cm._steps() == [3, 4]
            assert cm.latest_step() == 4 and cm.next_step() == 5
            assert sorted(os.listdir(str(tmp_path / str(i)))) == [
                "step_000000003", "step_000000004"]

    def test_restore_empty_returns_none(self, mesh8, tmesh8, tmp_path):
        for i, (_BM, CM, _res, mesh) in enumerate(_pair(mesh8, tmesh8)):
            assert CM(str(tmp_path / str(i))).restore(mesh) is None


class TestResilience:
    def test_loop_completes_and_checkpoints(self, mesh8, tmesh8,
                                            tmp_path):
        a = np.random.default_rng(2).standard_normal(
            (8, 8)).astype(np.float32)
        for i, (BM, CM, res, mesh) in enumerate(_pair(mesh8, tmesh8)):
            cm = CM(str(tmp_path / str(i)))

            def body(step, mats, state):
                return mats, dict(state, last=step)

            _mats, state = res.run_resilient(
                body, cm, mesh, {"A": BM.from_numpy(a, mesh=mesh)},
                num_steps=5, checkpoint_interval=2)
            assert state["last"] == 4 and cm.latest_step() == 4
            assert cm._steps() == [3, 4]

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_restart_from_checkpoint_after_failure(self, mesh8, tmesh8,
                                                   tmp_path, pkg):
        BM, CM, res, mesh = _pair(mesh8, tmesh8)[pkg == "torch"]
        a = np.ones((8, 8), dtype=np.float32)
        cm = CM(str(tmp_path))
        calls = {"failed": False}

        class FakeDeviceError(Exception):
            pass

        # each package's transient runtime error, matched by name
        FakeDeviceError.__name__ = ("XlaRuntimeError" if pkg == "jax"
                                    else "OutOfMemoryError")

        def body(step, mats, state):
            if step == 3 and not calls["failed"]:
                calls["failed"] = True
                raise FakeDeviceError("device lost")
            new = BM.from_numpy(mats["A"].to_numpy() + 1.0, mesh=mesh)
            return {"A": new}, dict(state, last=step)

        mats, state = res.run_resilient(
            body, cm, mesh, {"A": BM.from_numpy(a, mesh=mesh)},
            num_steps=5, checkpoint_interval=2)
        assert calls["failed"] and state["last"] == 4
        np.testing.assert_allclose(mats["A"].to_numpy(), a + 5.0)

    def test_nonretryable_raises(self, mesh8, tmesh8, tmp_path):
        for i, (BM, CM, res, mesh) in enumerate(_pair(mesh8, tmesh8)):
            bm = BM.from_numpy(np.ones((8, 8), np.float32), mesh=mesh)

            def body(step, mats, state):
                raise ValueError("programming error")

            with pytest.raises(ValueError):
                res.run_resilient(body, CM(str(tmp_path / str(i))), mesh,
                                  {"A": bm}, num_steps=2)

    def test_checkpoint_site_fault_restarts_equal(self, tmesh8, tmp_path):
        """A transient fault injected at the checkpoint site (the third
        check: the save after step 9) restarts from step 4's checkpoint
        and ends equal to an unfaulted run."""
        a = np.random.default_rng(3).standard_normal(
            (8, 8)).astype(np.float32)

        def body(step, mats, state):
            new = TBM.from_numpy(mats["A"].to_numpy() * 0.5 + step,
                                 mesh=tmesh8)
            return {"A": new}, dict(state, last=step,
                                    runs=state.get("runs", 0) + 1)

        def run(sub, spec):
            cfg = TConfig(fault_inject=spec)
            cm = TCM(str(tmp_path / sub), config=cfg)
            return t_res.run_resilient(
                body, cm, tmesh8, {"A": TBM.from_numpy(a, mesh=tmesh8)},
                num_steps=12, checkpoint_interval=5)

        clean, cstate = run("clean", "")
        faulted, fstate = run("faulted", "checkpoint:transient:n=3")
        assert np.array_equal(faulted["A"].to_numpy(),
                              clean["A"].to_numpy())
        assert fstate["last"] == cstate["last"] == 11
        assert cstate["runs"] == 12 and fstate["runs"] == 12
        # a fatal injection is not retried
        with pytest.raises(InjectedFault):
            run("fatal", "checkpoint:fatal:n=2")


# ---------------------------------------------------------------------------
# typed corruption
# ---------------------------------------------------------------------------


class TestCorruption:
    def _saved(self, tmesh8, tmp_path):
        cm = TCM(str(tmp_path))
        bm = TBM.from_numpy(np.arange(64, dtype=np.float32).reshape(8, 8),
                            mesh=tmesh8)
        cm.save(0, matrices={"A": bm}, state={"k": 1})
        return cm, os.path.join(str(tmp_path), "step_000000000")

    def test_flipped_artifact_raises_typed(self, tmesh8, tmp_path):
        cm, d = self._saved(tmesh8, tmp_path)
        with open(os.path.join(d, "A.npy"), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            f.write(b"\x7f")
        with pytest.raises(CheckpointCorruption, match="checksum"):
            cm.restore(tmesh8)

    def test_missing_artifact_and_bad_meta_raise_typed(self, tmesh8,
                                                       tmp_path):
        cm, d = self._saved(tmesh8, tmp_path)
        os.remove(os.path.join(d, "A.npy"))
        with pytest.raises(CheckpointCorruption, match="missing"):
            cm.restore(tmesh8)
        with open(os.path.join(d, "meta.json"), "w") as f:
            f.write("{not json")
        with pytest.raises(CheckpointCorruption, match="metadata"):
            cm.restore(tmesh8)

    def test_bad_entry_names_refused(self, tmesh8, tmp_path):
        bm = TBM.from_numpy(np.ones((2, 2), np.float32), mesh=tmesh8)
        for name in ("a/b", "..", ""):
            with pytest.raises(ValueError, match="filename"):
                TCM(str(tmp_path)).save(0, matrices={name: bm})


# ---------------------------------------------------------------------------
# checkpoints crossing between the packages
# ---------------------------------------------------------------------------


class TestCrossPackage:
    def test_jax_written_step_restores_in_port(self, mesh8, tmesh8,
                                               tmp_path):
        rng = np.random.default_rng(4)
        f32 = rng.standard_normal((13, 9)).astype(np.float32)
        i32 = rng.integers(-9, 9, size=(16, 8)).astype(np.int32)
        bf = f32.astype(ml_dtypes.bfloat16)
        jm = {"F": JBM.from_numpy(f32, mesh=mesh8, nnz=11),
              "I": JBM.from_numpy(i32, mesh=mesh8, dtype="int32"),
              "B": JBM.from_numpy(bf, mesh=mesh8, dtype="bfloat16")}
        JCM(str(tmp_path)).save(7, matrices=jm, state={"who": "jax"})
        step, mats, _arrs, state = TCM(str(tmp_path)).restore(tmesh8)
        assert step == 7 and state == {"who": "jax"}
        for name, m in jm.items():
            got = mats[name]
            assert got.shape == m.shape and got.nnz == m.nnz
            assert tuple(got.spec) == tuple(m.spec)
            want = np.asarray(m.data)
            if name == "B":
                assert got.dtype == torch.bfloat16
                assert np.array_equal(
                    got.data.view(torch.int16).numpy(),
                    want.view(np.int16))
            else:
                assert np.array_equal(got.data.numpy(), want)

    def test_port_written_step_restores_in_jax(self, mesh8, tmesh8,
                                               tmp_path):
        rng = np.random.default_rng(5)
        f32 = rng.standard_normal((13, 9)).astype(np.float32)
        i32 = rng.integers(-9, 9, size=(16, 8)).astype(np.int32)
        tm = {"F": TBM.from_numpy(f32, mesh=tmesh8, nnz=5),
              "I": TBM.from_numpy(i32, mesh=tmesh8, dtype="int32")}
        TCM(str(tmp_path)).save(2, matrices=tm, state={"who": "torch"})
        meta = json.load(open(os.path.join(str(tmp_path),
                                           "step_000000002", "meta.json")))
        assert meta["matrices"]["F"]["dtype"] == "float32"
        assert meta["matrices"]["I"]["dtype"] == "int32"
        step, mats, _arrs, state = JCM(str(tmp_path)).restore(mesh8)
        assert step == 2 and state == {"who": "torch"}
        for name, m in tm.items():
            got = mats[name]
            assert got.shape == m.shape and got.nnz == m.nnz
            assert tuple(got.spec) == tuple(m.spec)
            assert np.asarray(got.data).dtype == m.data.numpy().dtype
            assert np.array_equal(np.asarray(got.data), m.data.numpy())

    def test_port_bf16_step_restores_bit_equal(self, tmesh8, tmp_path):
        a = np.random.default_rng(6).standard_normal(
            (10, 12)).astype(np.float32)
        bm = TBM.from_numpy(a, mesh=tmesh8, dtype="bfloat16")
        S = TBSM.from_numpy(np.kron(np.eye(2), np.ones((4, 4))) * a[:8, :8],
                            block_size=4, mesh=tmesh8, dtype="bfloat16")
        cm = TCM(str(tmp_path))
        cm.save(0, matrices={"B": bm}, sparse={"S": S},
                arrays={"v": torch.arange(5, dtype=torch.bfloat16)})
        raw = np.load(os.path.join(str(tmp_path), "step_000000000",
                                   "B.npy"))
        assert raw.dtype == np.dtype("V2")
        _step, mats, arrs, _state = cm.restore(tmesh8)
        got = mats["B"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.data.view(torch.int16),
                           bm.data.view(torch.int16))
        assert torch.equal(arrs["v"], torch.arange(5, dtype=torch.bfloat16))
        S2 = cm.restore_sparse(tmesh8)["S"]
        assert S2.blocks.dtype == torch.bfloat16
        assert torch.equal(S2.blocks.view(torch.int16),
                           S.blocks.view(torch.int16))
        assert torch.equal(S2.block_rows, S.block_rows)
        assert torch.equal(S2.block_cols, S.block_cols)
        assert S2.shape == S.shape and S2.block_size == S.block_size


    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_fleet_directory_hints_cross_packages(self, mesh8, tmesh8,
                                                  tmp_path, writer):
        """A fleet session's ``save_state`` exports its directory's
        name-keyed demand hints; the other package's ``restore`` seeds
        them into its own fleet directory, and its first fresh insert
        of the key merges the saved demand in."""
        rng = np.random.default_rng(8)
        arrs = {nm: rng.standard_normal((32, 32)).astype(np.float32)
                for nm in ("A", "B")}
        sides = {"jax": (JSession, JConfig, mesh8),
                 "torch": (TSession, TConfig, tmesh8)}
        reader = "torch" if writer == "jax" else "jax"

        def fleet_session(side, sub):
            sess_cls, cfg_cls, mesh = sides[side]
            sess = sess_cls(mesh=mesh, config=cfg_cls(
                fleet_slices=2, result_cache_max_bytes=1 << 26,
                state_dir=str(tmp_path / sub)))
            for nm, a in arrs.items():
                sess.register(nm, sess.from_numpy(a))
            return sess

        def query(sess):
            return sess.table("A").expr().multiply(sess.table("B").expr())

        w = fleet_session(writer, "w")
        for _ in range(3):               # one insert, two directory hits
            w.submit(query(w)).result(timeout=60)
            w.serve_drain(timeout=60)
        saved = w._fleet.export_directory()
        summary = w.save_state()
        w.serve_close(timeout=60)
        assert len(saved) == 1 and sum(saved[0]["hits"].values()) == 2
        r = fleet_session(reader, "r")
        out = r.restore(str(tmp_path / "w"))
        assert out["fleet"] == 1
        assert r._fleet.directory.info()["seed_hints"] == 1
        assert r._fleet.export_directory() == [
            {"key": saved[0]["key"], "hits": saved[0]["hits"]}]
        r.submit(query(r)).result(timeout=60)
        r.serve_drain(timeout=60)
        rec = r._fleet.directory.lookup(saved[0]["key"])
        assert rec is not None
        assert {str(k): v for k, v in rec.hits.items()} == saved[0]["hits"]
        assert r._fleet.directory.info()["seed_hints"] == 0
        r.serve_close(timeout=60)
        assert summary["catalog"] == 2


# ---------------------------------------------------------------------------
# the session's catalog face
# ---------------------------------------------------------------------------


class TestCatalog:
    def test_save_load_catalog_matches_jax(self, mesh8, tmesh8, tmp_path):
        rng = np.random.default_rng(7)
        a = rng.standard_normal((24, 16)).astype(np.float32)
        b = rng.standard_normal((16, 8)).astype(np.float32)
        outs = []
        for i, (S, C, mesh) in enumerate(((JSession, JConfig, mesh8),
                                          (TSession, TConfig, tmesh8))):
            s1 = S(mesh=mesh, config=C(result_cache_max_bytes=64 << 20))
            s1.register("A", s1.from_numpy(a))
            s1.register("B", s1.from_numpy(b))
            d = str(tmp_path / str(i))
            path = s1.save_catalog(d)
            assert path.endswith("step_000000000")
            assert s1.save_catalog(d).endswith("step_000000001")
            s2 = S(mesh=mesh, config=C(result_cache_max_bytes=64 << 20))
            q = s2.from_numpy(a).expr().multiply(s2.from_numpy(b).expr())
            s2.register("A", s2.from_numpy(np.zeros_like(a)))
            first = s2.run(s2.table("A").expr().multiply(
                s2.from_numpy(b).expr()))
            assert not first.to_numpy().any()
            assert s2.load_catalog(d) == ["A", "B"]
            got = s2.run(s2.table("A").expr().multiply(
                s2.table("B").expr())).to_numpy()
            outs.append((got, s2.run(q).to_numpy()))
            assert S(mesh=mesh, config=C()).load_catalog(
                str(tmp_path / "empty")) == []
        for o in outs:
            np.testing.assert_allclose(o[0], a @ b, rtol=3e-4, atol=3e-4)
        assert np.array_equal(outs[1][0], outs[1][1])

    def test_block_sparse_table_round_trips(self, tmesh8, tmp_path):
        rng = np.random.default_rng(8)
        dense = rng.standard_normal((32, 32)).astype(np.float32)
        dense[8:24] = 0.0
        s1 = TSession(mesh=tmesh8, config=TConfig())
        S = TBSM.from_numpy(dense, block_size=8, mesh=tmesh8)
        D = s1.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
        s1.register("S", S)
        s1.register("D", D)
        want = s1.run(S.expr().multiply(D.expr())).data.clone()
        s1.save_catalog(str(tmp_path))
        s2 = TSession(mesh=tmesh8, config=TConfig())
        assert s2.load_catalog(str(tmp_path)) == ["D", "S"]
        assert isinstance(s2.table("S"), TBSM)
        got = s2.run(s2.table("S").expr().multiply(s2.table("D").expr()))
        assert torch.equal(got.data, want)
        from matrel_tpu_torch.core.coo import COOMatrix
        s2.register("E", COOMatrix.from_edges(np.array([0]), np.array([1]),
                                              shape=(4, 4)))
        with pytest.raises(TypeError, match="COO"):
            s2.save_catalog(str(tmp_path / "coo"))
