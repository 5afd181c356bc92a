"""PyTorch port: the randomized soak (``matrel_tpu_torch/tools/soak.py``)
and the chaos drill (``matrel_tpu_torch/tools/chaos_drill.py``) on the
CPU, where every kernel wrapper runs its plain PyTorch version.

- Every battery runs at one or two seeds and reports no failure.
- A kernel's plain version patched to return a wrong value makes its
  battery report a failure (B1 through the precision battery's
  block-sparse products, B2 through spmv, B4 through sparse_kernels, B8
  through routed): the batteries are not vacuous.
- ``main`` exits with the failure count and writes its tally line to
  ``$MATREL_SOAKLOG_PATH``; with its default ``--device cuda`` and no
  card it raises, and runs nothing on the CPU.
- The chaos drill runs on the CPU, prints its one JSON line, and every
  instrumented site was both checked and fired; the race drill runs
  every schedule clean, lockdep armed.
"""

import json

import pytest
import torch

from matrel_tpu_torch.core.mesh import DeviceUnavailableError
from matrel_tpu_torch.ops import (csr_view, pallas_spgemm, pallas_spmm,
                                  spmv_routed)
from matrel_tpu_torch.resilience import faults
from matrel_tpu_torch.tools import chaos_drill, race_drill, soak

BASE = 10_000


@pytest.fixture(autouse=True)
def _event_log(tmp_path, monkeypatch):
    """Event logs and the soak tally under the test's own directory."""
    monkeypatch.setenv("MATREL_OBS_EVENT_LOG", str(tmp_path / "events.jsonl"))
    monkeypatch.setenv("MATREL_SOAKLOG_PATH", str(tmp_path / "soak.jsonl"))
    yield
    faults.reset()


#: seeds a battery runs here: two, or one where a trial is seconds
SEEDS = {"durable": 1, "fleet": 1, "stream": 1, "cse": 1, "coeffs": 1,
         "race": 1, "sharded": 2}


@pytest.mark.parametrize("battery", soak.BATTERIES)
def test_battery_clean_on_cpu(battery, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # sharded's gloo ranks
    fails, wall = soak.run_battery(battery, SEEDS.get(battery, 2), BASE,
                                   3e-3, "cpu")
    assert fails == [], fails
    assert wall > 0


def _wrong(fn):
    """``fn`` with 1.0 added to its answer."""
    def wrapped(*a, **k):
        return fn(*a, **k) + 1.0
    return wrapped


#: (kernel, module, plain version of its CPU route, battery, trials)
MUTANTS = [
    ("B1", pallas_spmm, "spmm_blocksparse_plain", "precision", 1),
    ("B2", csr_view, "csr_walk_plain", "spmv", 2),
    ("B4", pallas_spgemm, "spgemm_pairs_plain", "sparse_kernels", 1),
    ("B8", spmv_routed, "csr_scatter_plain", "routed", 2),
]


@pytest.mark.parametrize("kernel,module,plain,battery,trials", MUTANTS,
                         ids=[m[0] for m in MUTANTS])
def test_wrong_kernel_fails_its_battery(monkeypatch, kernel, module, plain,
                                        battery, trials):
    monkeypatch.setattr(module, plain, _wrong(getattr(module, plain)))
    fails, _ = soak.run_battery(battery, trials, BASE, 3e-3, "cpu")
    assert fails, f"{battery} did not see a wrong {kernel}"
    assert all("AssertionError" in str(f) for f in fails), fails


def test_main_exits_with_failure_count_and_logs(tmp_path, monkeypatch,
                                                capsys):
    log = tmp_path / "soak.jsonl"
    assert soak.main(["spmv", "--seeds", "2", "--device", "cpu"]) == 0
    monkeypatch.setattr(csr_view, "csr_walk_plain",
                        _wrong(csr_view.csr_walk_plain))
    rc = soak.main(["spmv", "--seeds", "3", "--device", "cpu"])
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["failures"] for r in recs] == [0, rc] and rc > 0
    for r in recs:
        assert r["event"] == "soak" and r["battery"] == "spmv"
        assert r["device"] == "cpu" and r["backend"] == "cpu"
        assert r["tpu"] is False and r["base"] == BASE
    assert recs[1]["seeds"] == 3 and len(recs[1]["fail_heads"]) == rc
    assert f"SOAK COMPLETE: {rc} failures" in capsys.readouterr().out


def test_failure_count_capped_at_125(monkeypatch):
    monkeypatch.setitem(soak.SOAKS, "spmv",
                        lambda n, base, tol, device: [("x",)] * 300)
    assert soak.main(["spmv", "--seeds", "1", "--device", "cpu"]) == 125


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setitem(soak.SOAKS, "spmv",
                        lambda *a: ran.append(a) or [])
    with pytest.raises(DeviceUnavailableError):
        soak.main(["spmv", "--seeds", "1"])
    with pytest.raises(DeviceUnavailableError):
        chaos_drill.main([])
    assert ran == []


def test_battery_trial_counts_follow_the_jax_soak():
    assert [soak.trials_of(b, 100) for b in soak.BATTERIES] == [
        100, 25, 100, 20, 50, 20, 25, 20, 20, 20, 10, 5, 10, 50, 50, 20,
        25, 50]
    assert [soak.trials_of(b, 1) for b in soak.BATTERIES] == [
        1, 5, 1, 5, 5, 4, 5, 5, 4, 4, 8, 3, 3, 5, 5, 4, 6, 5]
    assert soak.tol_of("deep", 3e-3) == 6e-3
    assert (soak.tol_of("spmv", 3e-3), soak.tol_of("routed", 3e-3),
            soak.tol_of("ckpt", 3e-3)) == (2e-4, 5e-4, 1e-6)


def test_chaos_drill_on_cpu(capsys):
    assert chaos_drill.main(["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["metric"] == "chaos_drill"
    assert rec["device"] == "cpu" and rec["queries"] >= 50
    assert rec["wrong_answers"] == 0 and rec["untyped_failures"] == 0
    assert rec["sites_checked"] == sorted(faults.SITES)
    assert rec["sites_fired"] == sorted(faults.SITES)
    assert rec["poison_isolated"] and rec["deadline_typed"]
    assert rec["checkpoint_ok"] and rec["retries"] > 0


def test_chaos_drill_seed_reproduces(monkeypatch):
    """MATREL_CHAOS_SEED picks the schedule; two runs of one seed fail
    the same queries the same way. (How many calls a site sees depends
    on how the serve worker batches the submissions, which the host's
    load moves.)"""
    monkeypatch.setenv("MATREL_CHAOS_SEED", "3")
    a, b = chaos_drill.drill("cpu"), chaos_drill.drill("cpu")
    assert a["ok"] and b["ok"] and a["seed"] == b["seed"] == 3
    assert a["sites_fired"] == b["sites_fired"] == sorted(faults.SITES)
    assert a["failure_heads"] == b["failure_heads"]


def test_race_drill_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("MATREL_RACE_SEEDS", "1")
    monkeypatch.setenv("MATREL_RACE_QUERIES", "6")
    assert race_drill.main(["--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["metric"] == "race_drill"
    assert rec["trials"] == len(race_drill.SCHEDULES)
    assert rec["wrong"] == 0 and rec["untyped"] == 0
    assert rec["inversions"] == 0 and rec["acyclic"]
    assert rec["resolved"] > 0
