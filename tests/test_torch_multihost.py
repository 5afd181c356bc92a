"""PyTorch port: the multi-process check
(``matrel_tpu_torch/tools/multihost_check.py``) on the CPU — two gloo
ranks, each its own process, through ``core/mesh.init_distributed``.

One spawn of the tool, as ``tests/test_multihost.py`` spawns the JAX
package's: every worker checks the JAX worker's items in its order
against numpy and prints the same ``[pN] … matches oracle`` lines, and
the tool prints ``MULTIHOST CHECK: OK``. The tool's own ``--timeout``
fires before this test's cap and kills its workers, so a hung rank
cannot outlive the test.
"""

import os
import re
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = ("matrel_tpu_torch", "tools", "multihost_check.py")


def _run(args, outer_timeout):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "matrel_tpu_torch.tools.multihost_check"]
        + args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO, env=env, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=outer_timeout)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"multihost check hung:\n{out}")
    return proc.returncode, out


def _messages(path):
    """The ``[pN] …`` messages a worker template prints, in order."""
    src = open(path).read()
    return re.findall(r'print\(f"\[p\{pid\}\] ([^"]*)"', src)


def test_worker_prints_the_jax_workers_lines():
    want = _messages(os.path.join(REPO, "tools", "multihost_check.py"))
    got = _messages(os.path.join(REPO, *TOOL))
    # the bring-up line names ranks, not devices; the rest is verbatim
    assert got[0].startswith("mesh ") and want[0].startswith("mesh ")
    assert got[1:] == want[1:]


def test_two_rank_check_on_the_cpu():
    rc, out = _run(["--nproc", "2", "--device", "cpu", "--timeout", "120"],
                   outer_timeout=240)
    assert rc == 0, out
    assert "MULTIHOST CHECK: OK" in out
    lines = out.splitlines()
    items = ["cpmm matches oracle", "rmm matches oracle",
             "xla matches oracle", "sharded one-hot SpMV matches oracle",
             "sharded compact-table SpMV matches oracle",
             "sharded tile-stack SpMM matches oracle",
             "streaming value-joins (sorted + chunked) match oracle",
             "symmetric gram matches oracle",
             "align row-join matches oracle", "DONE"]
    for pid in range(2):
        mine = [ln[len(f"[p{pid}] "):] for ln in lines
                if ln.startswith(f"[p{pid}] ")]
        assert mine[0] == "mesh {'x': 1, 'y': 2} over 2 ranks (gloo on cpu)"
        assert mine[1:] == items, out


def test_nccl_without_a_card_a_rank_fails():
    rc, out = _run(["--nproc", "2", "--device", "cpu", "--backend", "nccl",
                    "--timeout", "60"], outer_timeout=120)
    assert rc == 1
    assert "MULTIHOST CHECK: FAILED" in out


def test_default_device_needs_a_card(monkeypatch):
    import torch
    from matrel_tpu_torch.core.mesh import DeviceUnavailableError
    from matrel_tpu_torch.tools import multihost_check
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        multihost_check.main(["--nproc", "2"])
