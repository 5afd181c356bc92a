"""PyTorch port: the chunked-B2 overlap experiment
(``matrel_tpu_torch/tools/pagerank_overlap.py``) and the batch of every
port tool (``matrel_tpu_torch/tools/batch.py``) on the CPU.

- The experiment's graph is the JAX tool's generator (seed 0, ``src``
  then ``dst``), scaled to 20,000 nodes and 100,000 edges. The port's
  ``compact_apply_chunked`` at k ∈ {2, 4, 8} equals the JAX package's
  (``matrel_tpu/ops/pallas_spmv.py``, Pallas in interpret mode) within
  1e-5 of max|y| (the SpMV tests' bound) and the port's ``compact_apply``
  bit for bit. The JAX tool cannot run (its ``measure`` is called without
  ``x0``), so records are not compared; the port's record carries the
  JAX tool's keys and a verdict that follows the 10% stop rule.
- ``batch --dry`` runs every step to rc 0, each record parseable, writes
  nothing under the checkout (``git status --porcelain`` before and
  after); its wall seconds are printed, not asserted (they move with
  whatever else the host runs); a step made to fail, or to outlive its
  timeout, makes the batch exit non-zero; ``--wait`` gives up after
  ``MAX_PROBES`` probes (set here; the tool never gives up) when there
  is no card.
"""

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.ops import pallas_spmv as jpc
from matrel_tpu.ops import spmv as jspmv

from matrel_tpu_torch.ops import pallas_spmv as tpc
from matrel_tpu_torch.ops import spmv as tspmv
from matrel_tpu_torch.tools import batch, pagerank_overlap as overlap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, EDGES = 20_000, 100_000
JAX_KEYS = {"metric", "baseline_ms", "chunked_ms", "best_chunks",
            "gain_pct", "verdict"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small products: one intra-op thread keeps this file from crowding
    the tests other workers run beside it."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(scope="module")
def small_graph():
    src, dst = overlap.graph(N, EDGES)
    rng = np.random.default_rng(0)     # the JAX tool's draws, scaled
    assert np.array_equal(src, rng.integers(0, N, EDGES, dtype=np.int32))
    assert np.array_equal(dst, rng.integers(0, N, EDGES, dtype=np.int32))
    jp = jspmv.build_spmv_plan(dst, src, None, n_rows=N, n_cols=N)
    tp = tspmv.build_spmv_plan(dst, src, None, n_rows=N, n_cols=N)
    return jp, tp


@pytest.mark.parametrize("chunks", overlap.CHUNKS)
def test_chunked_products_match_jax_and_are_bit_equal(small_graph, chunks):
    jp, tp = small_graph
    x = np.ones(N, np.float32) / N
    static = (jp.n_rows, jp.n_cols, jp.block, jspmv.LO)
    want = np.asarray(jpc.compact_apply_chunked(
        static, jpc.compact_tables(jp), jp.overflow, jnp.asarray(x),
        chunks=chunks, interpret=True))
    xt = torch.as_tensor(x)
    got = tpc.compact_apply_chunked(tp, xt, chunks=chunks)
    assert torch.equal(got, tpc.compact_apply(tp, xt))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert overlap.stripes(tp, chunks) == chunks


def test_record_has_the_jax_keys_and_follows_the_stop_rule(capsys):
    assert overlap.main(["--device", "cpu", "--n", str(N), "--edges",
                         str(EDGES)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JAX_KEYS <= set(rec)
    assert rec["metric"] == "pagerank_overlap_experiment"
    assert set(rec["chunked_ms"]) == {"2", "4", "8"}
    assert rec["bit_equal"] == {"2": True, "4": True, "8": True}
    assert rec["launches_per_matvec"] == {"2": 0, "4": 0, "8": 0}  # plain
    assert rec["chunked_ms"][str(rec["best_chunks"])] == min(
        rec["chunked_ms"].values())
    assert rec["verdict"].startswith(
        "IMPROVED" if rec["gain_pct"] >= 10 else "NEGATIVE")
    assert rec["device"] == "cpu" and rec["fill"] in ("native", "numpy")
    assert rec["timing"] == "host_clock"


@pytest.mark.parametrize("chunked_s,verdict", [
    (0.85e-3, "IMPROVED"), (0.9e-3, "IMPROVED"), (0.95e-3, "NEGATIVE"),
    (1.2e-3, "NEGATIVE")])
def test_stop_rule(small_graph, monkeypatch, chunked_s, verdict):
    _, tp = small_graph
    times = iter([1e-3] + [chunked_s] * 3)
    monkeypatch.setattr(overlap, "measure", lambda *a, **k: next(times))
    rec = overlap.experiment(tp, torch.device("cpu"))
    assert rec["verdict"].startswith(verdict)
    assert rec["gain_pct"] == round((1 - chunked_s / 1e-3) * 100, 1)


def test_experiment_refuses_a_wrong_chunked_product(small_graph,
                                                    monkeypatch):
    _, tp = small_graph
    real = tpc.compact_apply_chunked
    monkeypatch.setattr(tpc, "compact_apply_chunked",
                        lambda *a, **k: real(*a, **k) + 1.0)
    with pytest.raises(AssertionError, match="bit-equal"):
        overlap.experiment(tp, torch.device("cpu"), chunks=(2,))


def _git_status():
    return subprocess.run(["git", "status", "--porcelain"], cwd=REPO,
                          capture_output=True, text=True,
                          check=True).stdout


def test_dry_batch_runs_every_step(tmp_path):
    before = _git_status()
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "matrel_tpu_torch.tools.batch", "--dry",
         "--dry-dir", str(tmp_path / "dry")], cwd=REPO, capture_output=True,
        text=True, timeout=400)
    wall = time.monotonic() - t0
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    rows = [json.loads(ln) for ln in r.stdout.splitlines()]
    steps = [row for row in rows if "tool" in row]
    want = [s.name for s in batch.steps("cpu", dry=True)]
    assert sorted(row["tool"] for row in steps) == sorted(want)
    assert len(want) == 23 and len(set(want)) == 23
    for row in steps:
        assert row["rc"] == 0, row
        assert row["record"], row
        if isinstance(row["record"], dict) and "ok" in row["record"]:
            assert row["record"]["ok"] is True, row
    assert rows[-1]["batch"] == "done" and rows[-1]["failed"] == []
    assert _git_status() == before
    print(f"batch --dry: {wall:.1f} s wall")


@pytest.mark.parametrize("out, want", [
    ('x\n{"ok": true}\ntail\n', {"ok": True}),
    ("== Collectives ==\n{}\nlast words\n", "last words"),
    ('{"a": 1}\n== Collectives ==\n{}\n', {"a": 1}),
    ("{not json\nend\n", "end"),
    ("", None)])
def test_step_record(out, want):
    """A step's record: its last JSON object line with a key (an
    explain's bare ``{}`` is none), else its last line."""
    assert batch._record(out) == want


def test_a_failing_step_fails_the_batch(tmp_path, monkeypatch, capsys):
    fail = batch.Step("fails", ["-c", "import sys; print('{\"ok\": false}')"
                                      "; sys.exit(3)"], 60.0)
    slow = batch.Step("hangs", ["-c", "import time; time.sleep(60)"], 1.0)
    good = batch.Step("passes", ["-c", "print('fine')"], 60.0)
    monkeypatch.setattr(batch, "steps", lambda device, dry: [fail, slow,
                                                             good])
    assert batch.main(["--dry", "--dry-dir", str(tmp_path)]) == 1
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    by = {row["tool"]: row for row in rows if "tool" in row}
    assert by["fails"]["rc"] == 3 and by["fails"]["record"] == {"ok": False}
    assert by["hangs"]["rc"] == 124
    assert by["passes"]["rc"] == 0 and by["passes"]["record"] == "fine"
    assert rows[-1]["failed"] == ["fails", "hangs"]
    for name in by:
        assert (tmp_path / name / "output.log").exists()


def test_wait_gives_up_without_a_card(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert batch.probe(str(tmp_path), timeout_s=120) is False
    monkeypatch.setattr(batch, "probe", lambda workdir, timeout_s=300: False)
    monkeypatch.setattr(batch, "PROBE_INTERVAL_S", 0.0)
    monkeypatch.setattr(batch, "MAX_PROBES", 2)
    assert batch.main(["--dry", "--dry-dir", str(tmp_path), "--wait"]) == 3
    out = capsys.readouterr().out
    assert '"probes": 2' in out and "gave up waiting" in out
