"""PyTorch port: the package stands alone and refuses what it has not
ported.

- With ``jax`` and ``matrel_tpu`` blocked in ``sys.modules`` (in a
  subprocess), ``import matrel_tpu_torch`` and a CPU ``compute`` work.
- No module of the port, nor ``chip_smoke.py``, imports ``jax`` or the
  JAX package (checked on the syntax tree, lazy imports included).
- The default device is CUDA: without a card the session raises unless
  the caller asked for the CPU.
- Unported node kinds, the S×S dispatch and knobs of unported planes
  raise ``NotPortedError``.
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


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        MatrelSession()
    with pytest.raises(DeviceUnavailableError):
        MatrelSession.builder().device("cuda").get_or_create()
    assert MatrelSession(device="cpu").device.type == "cpu"


def test_unported_planes_and_kinds_raise():
    with pytest.raises(NotPortedError, match="obs_level"):
        MatrelConfig(obs_level="on")
    with pytest.raises(NotPortedError, match="result_cache_max_bytes"):
        MatrelConfig().replace(result_cache_max_bytes=1 << 20)
    s = MatrelSession(device="cpu")
    rng = np.random.default_rng(1)
    A = s.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    b = s.from_numpy(rng.standard_normal((4, 1)).astype(np.float32))
    with pytest.raises(NotPortedError, match="solve"):
        s.compute(A.expr().solve(b))
    sp = np.eye(16, dtype=np.float32)
    S = BlockSparseMatrix.from_numpy(sp, block_size=8, mesh=s.mesh)
    with pytest.raises(NotPortedError, match="S×S"):
        s.compute(S.multiply(S))
