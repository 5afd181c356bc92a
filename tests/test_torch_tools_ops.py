"""PyTorch port: the operator drills of ``matrel_tpu_torch/tools/`` held
against the JAX package's tools on the CPU (each loaded with
``importlib``, as ``tests/test_torch_planner.py`` loads its corpus).

- ``plan_snapshot``: the port's native corpus draws the JAX corpus's
  leaves bit for bit, and its signatures equal ``tests/plan_snapshots.json``
  and the JAX ``build_snapshots()`` case for case; ``main`` reports
  10/10 and ``--update`` writes only to an ``--out`` path.
- ``plan_verify``: zero diagnostics, exit code 0, as the JAX tool.
- ``topology_flip``: the picks, axis bytes and MV106 verdicts equal.
- ``flight_drill`` and ``provenance_drill`` print ``ok: true`` and equal
  the JAX drills' records path for path.
- Every tool's ``main`` asks for the card by default and raises without
  one.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from matrel_tpu_torch.core.mesh import DeviceUnavailableError, make_mesh
from matrel_tpu_torch.tools import (flight_drill, plan_snapshot,
                                    plan_verify, provenance_drill,
                                    topology_flip)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("linreg_normal_equations", "chain_skewed", "chain_layout_flip",
         "chain_interior_credit", "join_under_matmul",
         "replicated_operand_matmul", "coo_spmv_matvec",
         "block_sparse_matmul", "gram_AtA", "rank1_pushdown")


def _load(name, rel):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def snapshots():
    j_tool = _load("jax_plan_snapshot", "tools/plan_snapshot.py")
    with open(plan_snapshot.SNAPSHOT_PATH) as f:
        want = json.load(f)
    return (want, j_tool.build_snapshots(),
            plan_snapshot.build_snapshots("cpu"), j_tool)


def test_corpus_draws_the_jax_leaves(snapshots, mesh8):
    """The same rng draws in the same order: every dense leaf, the COO
    edge lists and the block-sparse tiles equal the JAX corpus's."""
    j_tool = snapshots[3]
    j_corpus = dict(j_tool.corpus(mesh8))
    t_corpus = dict(plan_snapshot.corpus(make_mesh((2, 4), device="cpu")))
    assert list(t_corpus) == list(j_corpus) == list(CASES)

    def leaves(e, out):
        if "matrix" in e.attrs:
            m = e.attrs["matrix"]
            out.append(np.asarray(m.to_numpy() if hasattr(m, "to_numpy")
                                  else m.to_dense()))
        for c in e.children:
            leaves(c, out)
        return out

    for name in CASES:
        lt, lj = leaves(t_corpus[name], []), leaves(j_corpus[name], [])
        assert len(lt) == len(lj) > 0, name
        for a, b in zip(lt, lj):
            assert a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("name", CASES)
def test_signature_equals_snapshot_and_jax(snapshots, name):
    want, jax_sigs, port_sigs, _ = snapshots
    assert port_sigs[name] == want[name]
    assert port_sigs[name] == jax_sigs[name]


def test_plan_snapshot_main(tmp_path, capsys):
    assert plan_snapshot.main(["--device", "cpu"]) == 0
    assert "10/10 plans match" in capsys.readouterr().out
    out = tmp_path / "snaps.json"
    assert plan_snapshot.main(["--update", "--out", str(out),
                               "--device", "cpu"]) == 0
    with open(plan_snapshot.SNAPSHOT_PATH) as f:
        assert json.load(out.open()) == json.load(f)
    for argv in (["--update"], ["--update", "--out",
                                plan_snapshot.SNAPSHOT_PATH]):
        with pytest.raises(SystemExit):
            plan_snapshot.main(argv + ["--device", "cpu"])


def test_plan_verify_zero_diagnostics(capsys):
    j_tool = _load("jax_plan_verify", "tools/plan_verify.py")
    assert j_tool.main() == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert plan_verify.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want == "verified 10 corpus plans: 0 diagnostic(s)"


def test_topology_flip_equals_jax(capsys):
    j_tool = _load("jax_topology_flip", "tools/topology_flip.py")
    assert j_tool.main() == 0
    want = _record(capsys.readouterr().out)
    assert topology_flip.main(["--device", "cpu"]) == 0
    got = _record(capsys.readouterr().out)
    assert got == want
    assert (got["unweighted"], got["weighted"]) == ("rmm", "bmm_right")
    assert got["mv106_flagged"] and got["clean_plan_quiet"]


def _redirect(monkeypatch, d):
    d.mkdir()
    monkeypatch.setenv("MATREL_OBS_EVENT_LOG", str(d / "events.jsonl"))
    monkeypatch.setenv("MATREL_OBS_FLIGHT_RECORDER_PATH",
                       str(d / "flight.json"))
    monkeypatch.setenv("MATREL_DRIFT_TABLE_PATH", str(d / "drift.json"))


def test_flight_drill_equals_jax(tmp_path, monkeypatch, capsys):
    j_tool = _load("jax_flight_drill", "tools/flight_drill.py")
    _redirect(monkeypatch, tmp_path / "jax")
    assert j_tool.main() == 0
    want = _record(capsys.readouterr().out)
    _redirect(monkeypatch, tmp_path / "torch")
    assert flight_drill.main(["--device", "cpu"]) == 0
    got = _record(capsys.readouterr().out)
    assert got["ok"] is True and got["device"] == "cpu"
    for k in ("batch_ok", "compile_failure_dumped", "flight_records",
              "chrome_events", "parent_linked", "span_names", "drift_rows"):
        assert got[k] == want[k], k
    for k in ("flight_path", "drift_table", "log"):
        assert got[k].startswith(str(tmp_path / "torch")), k


def test_provenance_drill_equals_jax(tmp_path, monkeypatch, capsys):
    j_tool = _load("jax_provenance_drill", "tools/provenance_drill.py")
    _redirect(monkeypatch, tmp_path / "jax")
    assert j_tool.main() == 0
    want = _record(capsys.readouterr().out)
    _redirect(monkeypatch, tmp_path / "torch")
    assert provenance_drill.main(["--device", "cpu"]) == 0
    got = _record(capsys.readouterr().out)
    assert got["ok"] is True
    for k in ("serve_paths", "fleet_paths", "degrade_paths",
              "degrade_rungs", "missing_paths", "mv115_findings", "audit"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("tool", ["plan_snapshot", "plan_verify",
                                  "topology_flip", "flight_drill",
                                  "provenance_drill"])
def test_default_device_needs_a_card(tool, monkeypatch):
    mod = {"plan_snapshot": plan_snapshot, "plan_verify": plan_verify,
           "topology_flip": topology_flip, "flight_drill": flight_drill,
           "provenance_drill": provenance_drill}[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        mod.main([])
