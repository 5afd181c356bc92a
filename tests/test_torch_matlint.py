"""PyTorch port: the port's own AST linter
(``matrel_tpu_torch/tools/matlint.py``) held against the JAX package's
``tools/matlint.py``.

- Every fixture of ``tests/test_matlint.py`` that lints a source runs
  through both linters: the JAX linter at the fixture's ``matrel_tpu/…``
  (or ``tools/…``) relpath, the port's at its ``matrel_tpu_torch/…``
  counterpart. On the shared rules (ML004–ML007, ML011–ML019, and ML000
  for a file that does not parse) both give the same codes at the same
  lines; then the fixture's own assertions run on the JAX result.
- ML001, ML002, ML003, ML008, ML009 and ML010 fire on their torch hazards
  and stay quiet on the sanctioned idioms (the CPU branch, the
  executor's dispatch, the collectives seam, ``.to(torch.float32)``,
  the build seam, the executor and ``utils/``).
- Suppressions silence a code on its line only; every suppression in the
  port states a reason.
- The repo-wide run over the default scan set (``matrel_tpu_torch/`` and
  ``chip_smoke.py``) is clean, ``main`` exits 0 there, and every rule is
  in the module docstring's catalogue.
- The per-query device move ML008 found in ``relational/value_join.py``
  is gone: the "always" match range is built on x's device. So are the
  per-query host reads ML001 found there (the non-NaN count of the
  sorted values, now kept on the device) and in the block-sparse plain
  version (the largest column block): both run with every host read of
  a tensor made to raise, and agree with numpy.
"""

import ast
import importlib.util
import os
import re
import sys
import textwrap

import numpy as np
import pytest
import torch

from matrel_tpu_torch.tools import matlint as t_matlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = {"ML000", "ML004", "ML005", "ML006", "ML007", "ML011", "ML012",
          "ML013", "ML014", "ML015", "ML016", "ML017", "ML018", "ML019"}


def _load(name, rel):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_tests():
    """(class, method) of every test of tests/test_matlint.py that lints
    a source through its ``_lint`` helper."""
    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_matlint.py")).read())
    out = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test_")
                    and any(isinstance(n, ast.Name) and n.id == "_lint"
                            for n in ast.walk(fn))):
                out.append(f"{cls.name}.{fn.name}")
    return out


FIXTURES = _fixture_tests()


def port_relpath(relpath: str) -> str:
    """The port's counterpart of a JAX-repo relpath: the package, and the
    root tools/ and examples/ that the package now holds."""
    for jax_prefix, port_prefix in (
            ("matrel_tpu/", "matrel_tpu_torch/"),
            ("tools/", "matrel_tpu_torch/tools/"),
            ("examples/", "matrel_tpu_torch/examples/")):
        if relpath.startswith(jax_prefix):
            return port_prefix + relpath[len(jax_prefix):]
    return relpath


@pytest.fixture(scope="module")
def jax_tests():
    return _load("jax_test_matlint", "tests/test_matlint.py")


def _shared(findings):
    return sorted((f.rule, f.line) for f in findings if f.rule in SHARED)


def test_fixture_list_is_whole():
    assert len(FIXTURES) >= 100
    classes = {f.split(".")[0] for f in FIXTURES}
    for code in ("ML004", "ML005", "ML006", "ML007", "ML011", "ML012",
                 "ML013", "ML014", "ML015", "ML016", "ML017", "ML018",
                 "ML019"):
        assert any(c.startswith(f"Test{code}") for c in classes), code


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_same_findings(jax_tests, name, tmp_path, monkeypatch):
    """The JAX fixture's source through both linters: equal shared-rule
    codes and lines; then the fixture's own assertions."""
    j_matlint = jax_tests.matlint
    seen = []

    def both(tmp, source, relpath):
        f = tmp / "fixture.py"
        f.write_text(textwrap.dedent(source))
        got_j = j_matlint.lint_file(str(f), relpath=relpath)
        got_t = t_matlint.lint_file(str(f), relpath=port_relpath(relpath))
        assert _shared(got_t) == _shared(got_j), (relpath, got_t, got_j)
        seen.append(_shared(got_j))
        return got_j

    monkeypatch.setattr(jax_tests, "_lint", both)
    cls_name, meth = name.split(".")
    getattr(getattr(jax_tests, cls_name)(), meth)(tmp_path)
    assert seen, "the fixture linted nothing"


def _lint(tmp_path, source, relpath):
    f = tmp_path / "fixture.py"
    f.write_text(textwrap.dedent(source))
    return t_matlint.lint_file(str(f), relpath=relpath)


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()", "torch.cuda.synchronize(x.device)",
    "ev.synchronize()", "x.item()", "x.cpu()", "x.tolist()",
    "x.numpy()", "out.block_until_ready()"])
def test_ml001_fires_on_device_syncs(tmp_path, call):
    src = f"""
        import torch
        def lower(x, ev, out):
            y = x + 1
            {call}
            return y
    """
    for rel in ("matrel_tpu_torch/executor.py",
                "matrel_tpu_torch/ops/custom.py",
                "matrel_tpu_torch/relational/ops.py"):
        assert _rules(_lint(tmp_path, src, rel)) == ["ML001"], rel


def test_ml001_quiet_on_the_cpu_branch_and_out_of_scope(tmp_path):
    src = """
        import torch
        def walk(view, x):
            if x.device.type == "cpu":
                a, b = view.row_ptr[[0, 1]].tolist()
                return x.cpu().numpy()
            if not x.is_cuda:
                return x.item()
            return x
    """
    assert _lint(tmp_path, src, "matrel_tpu_torch/ops/pallas_spmv.py") == []
    hot = """
        def walk(x):
            if x.device.type == "cuda":
                return x.item()
            return x
    """
    assert _rules(_lint(tmp_path, hot, "matrel_tpu_torch/ops/m.py")) \
        == ["ML001"]
    sync = "import torch\ntorch.cuda.synchronize()\n"
    for rel in ("matrel_tpu_torch/obs/analyze.py",
                "matrel_tpu_torch/session.py", "chip_smoke.py",
                "matrel_tpu_torch/tools/soak.py"):
        assert _lint(tmp_path, sync, rel) == [], rel


@pytest.mark.parametrize("expr", [
    "int((x > 0).sum())", "float(x.max())", "bool(mask.any())",
    "int(torch.count_nonzero(x))", "float(x.abs().sum())",
    "int(block_cols.max())"])
def test_ml001_fires_on_a_cast_of_a_reduction(tmp_path, expr):
    src = f"""
        import torch
        def lower(x, mask, block_cols):
            n = {expr}
            return x[:n]
    """
    got = _lint(tmp_path, src, "matrel_tpu_torch/ops/custom.py")
    assert [(f.rule, f.line) for f in got] == [("ML001", 4)], expr


def test_ml001_quiet_on_host_reductions_and_plain_casts(tmp_path):
    src = """
        import math
        import numpy as np
        def lower(x, a, k):
            n = int(np.sum(a)) + int(np.count_nonzero(a)) + int(x.shape[0])
            m = float(math.fsum(k)) + int(k) + bool(a.size)
            if x.device.type == "cpu":
                n += int(x.sum())
            return n, m
    """
    assert _lint(tmp_path, src, "matrel_tpu_torch/ops/custom.py") == []


@pytest.mark.parametrize("line", [
    "    n_valid = nb - int(xp.isnan(sv).sum())",
    "    head = sv[:sv.shape[0] - int(torch.isnan(sv).sum())]"])
def test_ml001_catches_value_joins_former_host_reads(tmp_path, line):
    """The two per-query reads of the non-NaN count that
    relational/value_join.py made (match_range and _range_eq_count),
    as fixtures at that module's relpath."""
    src = ("import numpy as np\nimport torch\n"
           "def search(sv, nb, xp):\n" + line + "\n    return 0\n")
    got = _lint(tmp_path, src, "matrel_tpu_torch/relational/value_join.py")
    assert [(f.rule, f.line) for f in got] == [("ML001", 4)]


def _no_host_reads(monkeypatch):
    def read(*a, **kw):
        raise AssertionError("host read of a tensor on the query path")
    for name in ("__int__", "__float__", "__bool__", "__index__", "item",
                 "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, read)


@pytest.mark.parametrize("pred", ["eq", "lt", "le", "gt", "ge"])
def test_value_join_searches_with_no_host_read(monkeypatch, pred):
    """match_range and _range_eq_count keep the non-NaN count on the
    device and agree with the numpy path (a search of the non-NaN
    prefix), NaN and ±inf on both sides."""
    from matrel_tpu_torch.relational import value_join
    inf, nan = float("inf"), float("nan")
    sv = torch.tensor([-inf, -1.0, 0.0, 0.0, 2.0, inf, inf, nan, nan])
    x = torch.tensor([-inf, -2.0, 0.0, 1.0, 2.0, inf, nan])
    lo_np, hi_np = value_join.match_range(sv.numpy(), x.numpy(), pred)
    v = torch.tensor([0.0, inf, nan, 2.0, -inf, 5.0, 0.0])
    want = [int(((sv[:7] == v[i]) & (torch.arange(9)[:7] >= lo_np[i])
                 & (torch.arange(9)[:7] < hi_np[i])).sum())
            for i in range(7)]
    _no_host_reads(monkeypatch)
    lo, hi = value_join.match_range(sv, x, pred)
    cnt = value_join._range_eq_count(sv, v, lo, hi)
    monkeypatch.undo()
    np.testing.assert_array_equal(lo.numpy(), lo_np)
    np.testing.assert_array_equal(hi.numpy(), hi_np)
    assert cnt.tolist() == [0 if np.isnan(v[i].item()) else want[i]
                            for i in range(7)]


def test_spmm_plain_reads_no_column_on_the_host(monkeypatch):
    """The block-sparse plain version (the "xla" strategy's body on the
    card) picks the zero tiles past D's end on the device; a tile whose
    column block lies past D reads zeros, as before."""
    from matrel_tpu_torch.ops import pallas_spmm
    rng = np.random.default_rng(3)
    bs, pm = 8, 3
    blocks = torch.as_tensor(rng.standard_normal((4, bs, bs)),
                             dtype=torch.float32)
    rows = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
    cols = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    d = torch.as_tensor(rng.standard_normal((13, pm)), dtype=torch.float32)
    dense_d = np.zeros((4 * bs, pm))
    dense_d[:13] = d.numpy()
    want = np.zeros((3 * bs, pm))
    for t in range(4):
        r, c = int(rows[t]), int(cols[t])
        want[r * bs:(r + 1) * bs] += (blocks[t].double().numpy()
                                      @ dense_d[c * bs:(c + 1) * bs])
    _no_host_reads(monkeypatch)
    got = pallas_spmm.spmm_blocksparse_plain(blocks, rows, cols, d, 3 * bs)
    monkeypatch.undo()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ml002_densify_in_ops(tmp_path):
    for call in ("S.to_dense()", "t.to_sparse().to_dense()",
                 "m.todense()", "torch.Tensor.to_dense(t)"):
        src = f"def f(S, t, m):\n    return {call}\n"
        assert _rules(_lint(tmp_path, src, "matrel_tpu_torch/ops/s.py")) \
            == ["ML002"], call
        assert _lint(tmp_path, src, "matrel_tpu_torch/executor.py") == []


@pytest.mark.parametrize("call", [
    "dist.all_reduce(t)", "dist.all_gather(out, t, group=g)",
    "torch.distributed.broadcast(t, 0)", "dist.barrier()",
    "dist.broadcast_object_list(box, src=0)",
    "dist.all_gather_object(out, obj)", "dist.reduce_scatter(o, ts)"])
def test_ml003_collective_outside_the_seam(tmp_path, call):
    src = f"""
        import torch
        import torch.distributed as dist
        def f(t, g, out, box, obj, o, ts):
            {call}
    """
    for rel in ("matrel_tpu_torch/serve/ranklog.py",
                "matrel_tpu_torch/parallel/strategies.py",
                "matrel_tpu_torch/tools/soak.py", "chip_smoke.py"):
        assert _rules(_lint(tmp_path, src, rel)) == ["ML003"], rel
    assert _lint(tmp_path, src,
                 "matrel_tpu_torch/parallel/collectives.py") == []


def test_ml003_quiet_on_groups_ranks_and_the_seam_api(tmp_path):
    src = """
        import torch.distributed as dist
        from matrel_tpu_torch.parallel import collectives as coll
        def f(mesh, t):
            if dist.is_initialized() and dist.get_rank() == 0:
                g = dist.new_group(ranks=[0, 1])
            coll.barrier(mesh)
            return coll.all_gather(t, mesh, None)
    """
    assert _lint(tmp_path, src, "matrel_tpu_torch/serve/m.py") == []


@pytest.mark.parametrize("call", [
    "x.cuda()", "x.to(dev)", "x.to(device)", "x.to(mesh.device)",
    "x.to(y.device)", "x.to('cuda')", "x.to('cuda:1')", "x.to('cpu')",
    "x.to(torch.device('cuda', 0))", "x.to(device=dev)",
    "x.to(dtype=torch.float32, device=dev)"])
def test_ml008_fires_on_device_moves(tmp_path, call):
    src = f"""
        import torch
        def f(x, y, dev, device, mesh):
            return {call}
    """
    for rel in ("matrel_tpu_torch/executor.py",
                "matrel_tpu_torch/ops/spmv.py",
                "matrel_tpu_torch/serve/spill.py",
                "matrel_tpu_torch/workloads/cg.py"):
        assert _rules(_lint(tmp_path, src, rel)) == ["ML008"], rel
    for rel in ("matrel_tpu_torch/parallel/reshard.py",
                "matrel_tpu_torch/core/blockmatrix.py",
                "matrel_tpu_torch/utils/checkpoint.py",
                "matrel_tpu_torch/tools/soak.py"):
        assert _lint(tmp_path, src, rel) == [], rel


def test_ml008_dtype_only_to_is_not_a_move(tmp_path):
    src = """
        import torch
        def f(x, y, common):
            a = x.to(torch.float32)
            b = x.to(y.dtype)
            c = x.to(dtype=torch.bfloat16)
            d = x.to(common)
            e = torch.as_tensor(x, device=y.device)
            return a, b, c, d, e
    """
    assert _lint(tmp_path, src, "matrel_tpu_torch/executor.py") == []


@pytest.mark.parametrize("src", [
    "import ctypes\nlib = ctypes.CDLL('libx.so')\n",
    "import ctypes\nlib = ctypes.cdll.LoadLibrary('libx.so')\n",
    "from torch.utils import cpp_extension\nm = cpp_extension.load("
    "name='m', sources=['m.cu'])\n",
    "import torch.utils.cpp_extension\nm = torch.utils.cpp_extension."
    "load_inline('m', '')\n",
    "import subprocess\nsubprocess.run(['nvcc', '-o', 'x.so', 'x.cu'])\n",
    "import subprocess\np = subprocess.Popen(['/usr/local/cuda/bin/nvcc',"
    " 'x.cu'])\n",
    "import triton\n@triton.jit\ndef k(x):\n    pass\n",
    "import triton\n@triton.jit(do_not_specialize=['n'])\ndef k(n):\n"
    "    pass\n"])
def test_ml009_kernel_builds_outside_the_seam(tmp_path, src):
    for rel in ("matrel_tpu_torch/ops/new_kernel.py",
                "matrel_tpu_torch/workloads/pagerank.py"):
        assert _rules(_lint(tmp_path, src, rel)) == ["ML009"], rel
    assert _lint(tmp_path, src, "matrel_tpu_torch/utils/cuda_build.py") \
        == []
    assert _lint(tmp_path, src, "chip_smoke.py") == []


def test_ml009_seam_callers_are_clean(tmp_path):
    src = """
        import subprocess
        from matrel_tpu_torch.utils import cuda_build
        def _library():
            return cuda_build.load("spmv_compact.cu")
        def other():
            subprocess.run(["g++", "-O3", "x.cc"])
    """
    assert _lint(tmp_path, src, "matrel_tpu_torch/ops/pallas_spmv.py") \
        == []


@pytest.mark.parametrize("src", [
    "import torch\nf = torch.compile(g)\n",
    "import torch\nf = torch.jit.script(g)\n",
    "import torch\nf = torch.jit.trace(g, (x,))\n",
    "import torch\ngraph = torch.cuda.CUDAGraph()\n",
    "import torch\nwith torch.cuda.graph(graph):\n    pass\n",
    "import torch\n@torch.compile\ndef f(x):\n    return x\n",
    "import torch\n@torch.jit.script\ndef f(x):\n    return x\n",
    "from torch import jit\nf = jit.script(g)\n"])
def test_ml010_compiled_programs_outside_the_executor(tmp_path, src):
    for rel in ("matrel_tpu_torch/ops/spmv.py",
                "matrel_tpu_torch/workloads/linreg.py",
                "matrel_tpu_torch/session.py"):
        assert _rules(_lint(tmp_path, src, rel)) == ["ML010"], rel
    for rel in ("matrel_tpu_torch/executor.py",
                "matrel_tpu_torch/utils/profiling.py",
                "matrel_tpu_torch/tools/soak.py", "chip_smoke.py"):
        assert _lint(tmp_path, src, rel) == [], rel


def test_ml010_quiet_on_builtin_compile(tmp_path):
    src = "code = compile('1 + 1', '<s>', 'eval')\n"
    assert _lint(tmp_path, src, "matrel_tpu_torch/sql.py") == []


def test_ml007_covers_the_smoke_script(tmp_path):
    src = """
        def phase():
            try:
                run()
            except Exception:
                pass
    """
    assert _rules(_lint(tmp_path, src, "chip_smoke.py")) == ["ML007"]
    assert _lint(tmp_path, src, "matrel_tpu_torch/tools/soak.py") == []


def test_suppression_is_per_code_and_per_line(tmp_path):
    src = """
        import torch
        def lower(x):
            torch.cuda.synchronize()  # matlint: disable=ML001 analyze-mode hook
            a = x.item()  # matlint: disable=ML008 wrong code
            return x.cuda()  # matlint: disable=ML001,ML008 both, with a reason
    """
    got = _lint(tmp_path, src, "matrel_tpu_torch/executor.py")
    assert [(f.rule, f.line) for f in got] == [("ML001", 5)]


def test_every_suppression_in_the_port_states_a_reason():
    pat = re.compile(r"#\s*matlint:\s*disable=([A-Z0-9,]+)(.*)$")
    sites = 0
    for path in t_matlint.iter_python_files(t_matlint.DEFAULT_PATHS):
        if path.endswith(os.path.join("tools", "matlint.py")):
            continue
        for i, line in enumerate(open(path, encoding="utf-8"), 1):
            m = pat.search(line)
            if m:
                sites += 1
                assert len(m.group(2).strip()) >= 10, (path, i, line)
    assert sites >= 40


def test_repo_wide_run_is_clean(capsys):
    assert t_matlint.DEFAULT_PATHS == ("matrel_tpu_torch", "chip_smoke.py")
    rc = t_matlint.main([])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.splitlines() == [
        "matlint: 0 finding(s) in scan set ('matrel_tpu_torch', "
        "'chip_smoke.py')"]


def test_catalogue_lists_every_rule(capsys):
    ids = [r.id for r in t_matlint.RULES]
    assert ids == [f"ML{i:03d}" for i in range(1, 20)]
    doc = t_matlint.__doc__
    for rid in ids:
        assert re.search(rf"^  {rid}  \S", doc, re.M), rid
    assert t_matlint.main(["--list-rules"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 19


def test_value_join_always_range_is_built_on_the_device(monkeypatch):
    """ML008's per-query finding, fixed: the "always" range is made on
    x's device, with no copy of a host array."""
    from matrel_tpu_torch.relational import value_join

    def no_move(*a, **kw):
        raise AssertionError("Tensor.to called on the query path")

    sv = torch.tensor([0.5, 1.0, float("nan")])
    x = torch.tensor([[0.1, 2.0], [1.0, float("nan")]])
    monkeypatch.setattr(torch.Tensor, "to", no_move)
    lo, hi = value_join.match_range(sv, x, "always")
    monkeypatch.undo()
    assert lo.device == x.device and lo.dtype == torch.int64
    assert lo.tolist() == [[0, 0], [0, 0]] and hi.tolist() == [[3, 3],
                                                                [3, 3]]
    lo_np, hi_np = value_join.match_range(sv.numpy(), x.numpy(), "always")
    np.testing.assert_array_equal(hi_np, np.full((2, 2), 3))
