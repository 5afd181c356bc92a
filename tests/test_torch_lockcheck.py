"""PyTorch port: the static lock-order analyzer
(``matrel_tpu_torch/tools/lockcheck.py``) held against the JAX package's
``tools/lockcheck.py``.

- Every fixture of ``tests/test_lockcheck.py`` that analyzes a source
  runs through both analyzers: the same rule codes at the same anchor
  lines (the fixture's own assertions then run on the JAX result, as in
  that file).
- The port's blocking vocabulary: a ``torch.cuda.synchronize()``, an
  ``Event.synchronize()``, ``.item()`` / ``.cpu()`` / ``.tolist()`` and the
  host-side ``torch.distributed`` exchanges under a lock fire LK102;
  ``dict.items()``, ``dist.is_initialized()`` and a non-distributed
  ``gather`` do not.
- The repo-wide run over ``matrel_tpu_torch/`` is clean, the inventory
  covers the lockdep seam with the fleet's sanctioned locks, and the
  session's execution lock resolves to ``fleet.exec``.
- The spill tier's promote (the LK102 finding this analyzer raised)
  thaws an entry with ``serve.spill`` free.
"""

import importlib.util
import os
import sys
import textwrap
import threading

import numpy as np
import pytest

from matrel_tpu_torch.tools import lockcheck as t_lockcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_tests():
    """(class, method) of every test of tests/test_lockcheck.py that
    analyzes a source through its ``_analyze`` helper."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_lockcheck.py")).read())
    out = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test_")
                    and any(isinstance(n, ast.Name) and n.id == "_analyze"
                            for n in ast.walk(fn))):
                out.append(f"{cls.name}.{fn.name}")
    return out


FIXTURES = _fixture_tests()


@pytest.fixture(scope="module")
def jax_tests():
    return _load("jax_test_lockcheck", "tests/test_lockcheck.py")


def _anchors(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


def test_fixture_list_is_whole():
    # every LK rule's fixtures, the clean cases and the suppression
    assert len(FIXTURES) == 15
    assert {f.split(".")[0] for f in FIXTURES} == {
        "TestLK101Cycle", "TestLK102Blocking", "TestLK103SharedWrites",
        "TestLK104DoubleAcquire"}


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_same_findings(jax_tests, name, tmp_path, monkeypatch):
    """The JAX fixture's sources through both analyzers: equal rule codes
    and anchor lines; then the fixture's own assertions."""
    j_lockcheck = jax_tests.lockcheck
    seen = []

    def both(tmp, sources, thread_roots=None):
        for rel, src in sources.items():
            f = tmp / rel
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(textwrap.dedent(src))
        kw = dict(root=str(tmp), thread_roots=thread_roots or {},
                  aliases={})
        got_j = j_lockcheck.analyze_paths(sorted(sources), **kw)
        got_t = t_lockcheck.analyze_paths(sorted(sources), **kw)
        assert _anchors(got_t) == _anchors(got_j), (got_t, got_j)
        seen.append(_anchors(got_j))
        return got_j

    monkeypatch.setattr(jax_tests, "_analyze", both)
    cls_name, meth = name.split(".")
    getattr(getattr(jax_tests, cls_name)(), meth)(tmp_path)
    assert seen, "the fixture analyzed nothing"


def _port(tmp_path, src, roots=None):
    f = tmp_path / "pkg" / "m.py"
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(src))
    return t_lockcheck.analyze_paths(["pkg/m.py"], root=str(tmp_path),
                                     thread_roots=roots or {}, aliases={})


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()",
    "torch.cuda.synchronize(x.device)",
    "ev.synchronize()",
    "x.item()",
    "x.cpu()",
    "x.tolist()",
    "dist.all_gather_object(out, x)",
    "dist.broadcast_object_list(out, src=0)",
    "dist.all_reduce(x, group=g)",
    "torch.distributed.all_gather(out, x)",
    "dist.barrier()",
    "group.barrier()",
    "log.gather_object(x)",
])
def test_port_blocking_vocabulary_fires(tmp_path, call):
    got = _port(tmp_path, f"""
        import threading
        import torch
        import torch.distributed as dist
        L = threading.Lock()
        def f(x, ev, out, g, group, log):
            with L:
                {call}
    """)
    assert [f.rule for f in got] == ["LK102"], got


@pytest.mark.parametrize("call", [
    "d.items()",
    "dist.is_initialized()",
    "dist.get_rank()",
    "np.gather(x)",
    "x.to(dev)",
    "torch.cuda.current_stream()",
])
def test_port_vocabulary_quiet(tmp_path, call):
    assert _port(tmp_path, f"""
        import threading
        import numpy as np
        import torch
        import torch.distributed as dist
        L = threading.Lock()
        def f(x, d, dev):
            with L:
                return {call}
    """) == []


def test_collective_under_lock_through_a_call(tmp_path):
    # the gloo-hang shape: a lock held across a method that exchanges
    got = _port(tmp_path, """
        import threading
        import torch.distributed as dist
        class Log:
            def __init__(self):
                self._lock = threading.Lock()
            def _exchange(self, rec):
                out = [None] * 2
                dist.all_gather_object(out, rec)
                return out
            def publish(self, rec):
                with self._lock:
                    return self._exchange(rec)
    """)
    assert [f.rule for f in got] == ["LK102"]
    assert "_exchange" in got[0].message


def test_repo_wide_run_is_clean():
    assert t_lockcheck.analyze_paths() == []
    assert t_lockcheck.main([]) == 0


def test_inventory_and_aliases():
    ana = t_lockcheck.analyzer_for()
    assert ana.locks["fleet.exec"].dispatch_ok
    assert ana.locks["fleet.registration"].dispatch_ok
    assert not ana.locks["fleet.directory"].dispatch_ok
    assert "serve.pipeline" in ana.locks and "serve.ranklog" in ana.locks
    # the analyzer's own record type is not inventoried as a lock
    assert not [lid for lid, lk in ana.locks.items()
                if lk.module.endswith("tools/lockcheck.py")]
    # session._arbitrated_run holds the fleet's sanctioned lock
    held = [lid for (mod, qual), info in ana.funcs.items()
            if qual == "MatrelSession._arbitrated_run"
            for lk, _ in info.acquires for lid in (lk.lid,)]
    assert held == ["fleet.exec"]


def test_thread_roots_exist():
    ana = t_lockcheck.analyzer_for()
    for root, seeds in t_lockcheck.THREAD_ROOTS.items():
        for mod, qual in seeds:
            if qual == "*":
                assert any(k[0] == mod for k in ana.funcs), (root, mod)
            else:
                assert (mod, qual) in ana.funcs, (root, mod, qual)


def test_rules_documented_and_listed(capsys):
    for rid, _ in t_lockcheck._RULES:
        assert rid in t_lockcheck.__doc__
    assert t_lockcheck.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.count("LK1") == 4


def test_spill_promote_thaws_outside_the_lock(tmp_path, monkeypatch):
    """The h2d leg of a promote runs with serve.spill free: another
    thread takes the lock while the thaw is under way."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.serve import spill

    n = 64
    entry = n * n * 4
    sess = MatrelSession(mesh=make_mesh((2, 4), device="cpu"),
                         config=MatrelConfig(
                             spill_enable=True,
                             result_cache_max_bytes=int(1.5 * entry),
                             result_cache_max_entries=8,
                             spill_host_max_bytes=8 * entry,
                             spill_disk_hits=0, state_dir=str(tmp_path)))
    rng = np.random.default_rng(0)
    arrs = {k: rng.standard_normal((n, n)).astype(np.float32)
            for k in "ab"}
    for k, a in arrs.items():
        sess.register(k, sess.from_numpy(a))

    def gram(k):
        m = sess.catalog[k]
        return sess.run(m.expr().t().multiply(m.expr())).to_numpy()

    gram("a")
    gram("b")                      # evicts a's result into the host tier
    mgr = sess._spill
    assert mgr.info()["host_entries"] >= 1
    free = []
    orig = spill.SpillManager._to_device

    def probe(self, arr, meta):
        got = []

        def other():
            ok = self._lock.acquire(timeout=5)
            got.append(ok)
            if ok:
                self._lock.release()

        t = threading.Thread(target=other)
        t.start()
        t.join()
        free.append(got[0])
        return orig(self, arr, meta)

    monkeypatch.setattr(spill.SpillManager, "_to_device", probe)
    np.testing.assert_allclose(gram("a"), arrs["a"].T @ arrs["a"],
                               rtol=1e-5, atol=1e-4)
    assert free == [True]
    assert mgr.info()["promoted"] >= 1


def test_spill_promotes_under_concurrent_load(tmp_path, monkeypatch):
    """Many threads cycle four Gram results through a one-entry cache
    and the host tier (short switch interval): every answer right, and
    the promote counter, now bumped outside the thaw's lock span, loses
    no update."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.serve import spill

    n = 32
    entry = n * n * 4
    sess = MatrelSession(mesh=make_mesh((2, 4), device="cpu"),
                         config=MatrelConfig(
                             spill_enable=True,
                             result_cache_max_bytes=int(1.5 * entry),
                             result_cache_max_entries=8,
                             spill_host_max_bytes=16 * entry,
                             spill_disk_hits=0, state_dir=str(tmp_path)))
    rng = np.random.default_rng(1)
    arrs = {k: rng.standard_normal((n, n)).astype(np.float32)
            for k in "abcd"}
    for k, a in arrs.items():
        sess.register(k, sess.from_numpy(a))
    thawed = []
    orig = spill.SpillManager._thaw

    def counting(self, key, te, src_tier):
        ent = orig(self, key, te, src_tier)
        if ent is not None:
            thawed.append(key)             # list.append is atomic
        return ent

    monkeypatch.setattr(spill.SpillManager, "_thaw", counting)
    errors = []

    def client(seed):
        order = np.random.default_rng(seed).permutation(list("abcd") * 5)
        try:
            for k in order:
                m = sess.catalog[k]
                got = sess.run(m.expr().t().multiply(m.expr())).to_numpy()
                np.testing.assert_allclose(got, arrs[k].T @ arrs[k],
                                           rtol=1e-5, atol=1e-4)
        except Exception as ex:  # noqa: BLE001 — asserted below
            errors.append(ex)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not [t for t in threads if t.is_alive()]
    assert not errors, errors[:3]
    assert thawed and sess._spill.info()["promoted"] == len(thawed)
