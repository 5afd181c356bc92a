"""PyTorch port: the operator tools held against the JAX package on the CPU.

One event log — written by a fleet session of either package (obs on,
provenance on, tenants, a directory hit, an EXPLAIN ANALYZE) — is read by
both packages' tools, whose output must agree byte for byte: ``history``
(the per-query table with ``--last``, ``--summary`` with its fleet
roll-up, ``--drift`` without persisting, ``--coeffs``), ``trace --export
chrome``, ``top --once --log`` (its header names the package, so that one
token is normalised) and ``why``. ``events.emit_tool_event`` writes the
JAX package's record.

The bridge: the same RPCs against both packages' servers on localhost
(integer-valued data, so results are exact), responses equal but for
``create_random``'s values (each package's own generator) and the
``explain`` text (each package's plan). The CLI: ``python -m
matrel_tpu_torch info|sql|pagerank|history`` in subprocesses with
``--device cpu``, against the JAX package's answers in process; without
``--device`` the CLI asks for the card and refuses here, and ``bench``
refuses typed. ``utils/debug.py``: ``checked`` raises on a NaN or Inf any
op inside the function produces (also one masked before the return), and
``assert_finite`` raises the JAX package's message.
"""

import argparse
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 60.0
PKGS = ("matrel_tpu", "matrel_tpu_torch")


def _mods(root):
    import importlib
    return {n: importlib.import_module(f"{root}.{n}") for n in (
        "config", "session", "obs.events", "obs.history", "obs.trace",
        "obs.top", "obs.provenance", "obs.drift")}


def _session(root, log, jmesh):
    m = _mods(root)
    cfg = m["config"].MatrelConfig(
        fleet_slices=2, result_cache_max_bytes=1 << 26, obs_level="on",
        obs_event_log=log, obs_provenance=32,
        serve_tenant_weights="a:2,b:1")
    if root == "matrel_tpu":
        return m["session"].MatrelSession(mesh=jmesh, config=cfg)
    return m["session"].MatrelSession(config=cfg, device="cpu")


def _workload(root, log, jmesh):
    """A small fleet serving run that writes every record kind the
    tools read: query, serve, placement, fleet, provenance, overload,
    span and analyze records. The provenance ids restart at "p1" (a
    process-wide counter: a test run before this one in the same process
    would otherwise have taken the ids ``why --key p1`` reads)."""
    import itertools
    _mods(root)["obs.provenance"]._prov_seq = itertools.count(1)
    sess = _session(root, log, jmesh)
    rng = np.random.default_rng(3)
    for nm in ("A", "B"):
        sess.register(nm, sess.from_numpy(
            rng.standard_normal((32, 32)).astype(np.float32)))
    q = sess.table("A").expr().multiply(sess.table("B").expr())
    futs = [sess.submit(q, tenant="a"),
            sess.submit(q.multiply_scalar(2.0), tenant="b")]
    for f in futs:
        f.result(timeout=WAIT_S)
    sess.serve_drain(timeout=WAIT_S)
    sess.submit(q, tenant="b").result(timeout=WAIT_S)   # directory hit
    sess.run(q.t())
    sess.explain(q, analyze=True)
    sess._fleet.kill_slice(1)
    sess.submit(q.multiply_scalar(3.0), tenant="a").result(timeout=WAIT_S)
    sess.serve_close(timeout=WAIT_S)


@pytest.fixture(scope="module")
def jmesh():
    import jax
    from matrel_tpu.core import mesh as jmesh_lib
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module", params=PKGS)
def event_log(request, jmesh, tmp_path_factory):
    log = str(tmp_path_factory.mktemp(f"log_{request.param}")
              / "events.jsonl")
    _workload(request.param, log, jmesh)
    return log


def _out(fn, *a):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


def _both(fn_name, mod, args):
    """Run ``<pkg>.<mod>.<fn_name>(args)`` in both packages; their (exit
    code, stdout) pairs."""
    return [_out(getattr(_mods(root)[mod], fn_name), args)
            for root in PKGS]


def _hist_args(log, **kw):
    base = dict(log=log, last=None, summary=False, drift=False,
                drift_table=None, coeffs=False, no_save=True, check=False)
    base.update(kw)
    return argparse.Namespace(**base)


class TestEventLogTools:
    @pytest.mark.parametrize("kw", [
        {}, {"last": 3}, {"summary": True}, {"summary": True, "check": True},
        {"drift": True}, {"drift": True, "check": True}, {"coeffs": True},
    ], ids=["queries", "last", "summary", "summary-check", "drift",
            "drift-check", "coeffs"])
    def test_history_byte_equal(self, event_log, kw):
        (jrc, jout), (trc, tout) = _both("main", "obs.history",
                                         _hist_args(event_log, **kw))
        assert tout == jout and trc == jrc
        assert tout.startswith("# ")
        if kw.get("summary"):
            assert "fleet:" in tout

    def test_history_drift_persists_the_same_table(self, event_log,
                                                   tmp_path):
        tables = []
        for root in PKGS:
            path = str(tmp_path / f"{root}.json")
            _out(_mods(root)["obs.history"].main, _hist_args(
                event_log, drift=True, no_save=False, drift_table=path))
            with open(path) as f:
                tab = json.load(f)
            tab.pop("updated")
            tables.append(tab)
        assert tables[0] == tables[1]

    def test_trace_chrome_byte_equal(self, event_log, tmp_path):
        outs = []
        for root in PKGS:
            args = argparse.Namespace(export="chrome", log=event_log,
                                      out="-", last=None)
            outs.append(_out(_mods(root)["obs.trace"].main, args))
        assert outs[0] == outs[1]
        doc = json.loads(outs[1][1])
        assert doc["traceEvents"]
        files = []
        for root in PKGS:
            out = str(tmp_path / f"{root}.chrome.json")
            rc, text = _out(_mods(root)["obs.trace"].main,
                            argparse.Namespace(export="chrome",
                                               log=event_log, out=out,
                                               last=2))
            files.append((rc, text.replace(out, "<out>"),
                          Path(out).read_bytes()))
        assert files[0] == files[1]
        bad = argparse.Namespace(export="svg", log=event_log, out="-",
                                 last=None)
        assert _both("main", "obs.trace", bad)[1][0] == 2

    def test_top_once_log_byte_equal(self, event_log):
        args = argparse.Namespace(url=None, port=None, log=event_log,
                                  interval=0.0, once=True, iterations=None)
        (jrc, jout), (trc, tout) = _both("main", "obs.top", args)
        assert trc == jrc == 0
        assert tout.replace("matrel_tpu_torch top", "matrel_tpu top") \
            == jout
        assert tout.startswith("matrel_tpu_torch top — ")

    def test_top_unreachable_endpoint_exits_1(self):
        args = argparse.Namespace(url="http://127.0.0.1:9", port=None,
                                  log=None, interval=0.0, once=True,
                                  iterations=None)
        (jrc, jout), (trc, tout) = _both("main", "obs.top", args)
        assert jrc == trc == 1
        assert jout.split(":")[0] == tout.split(":")[0] == "top"

    @pytest.mark.parametrize("kw", [{}, {"last": 2}, {"key": "p1"}])
    def test_why_byte_equal(self, event_log, kw):
        base = dict(log=event_log, last=10, key=None, audit=False,
                    sample=8, check=False, device="cpu")
        base.update(kw)
        (jrc, jout), (trc, tout) = _both("main", "obs.provenance",
                                         argparse.Namespace(**base))
        assert (trc, tout) == (jrc, jout)
        assert "path=" in tout

    def test_why_audit_replays_clean(self):
        args = argparse.Namespace(log=None, last=10, key=None, audit=True,
                                  sample=8, check=True, device="cpu")
        rc, out = _out(_mods("matrel_tpu_torch")["obs.provenance"].main,
                       args)
        assert rc == 0 and out.rstrip().endswith("-> OK")

    def test_emit_tool_event(self, tmp_path, monkeypatch):
        recs = []
        for root in PKGS:
            ev = _mods(root)["obs.events"]
            monkeypatch.delenv("MATREL_OBS_EVENT_LOG", raising=False)
            anchor = tmp_path / root
            anchor.mkdir()
            full = ev.emit_tool_event("bench", {"metric": 1.5},
                                      anchor_dir=str(anchor))
            got = ev.read_events(str(anchor / ev.DEFAULT_EVENT_LOG))
            env_log = str(tmp_path / f"{root}.env.jsonl")
            monkeypatch.setenv("MATREL_OBS_EVENT_LOG", env_log)
            ev.emit_tool_event("soak", {"ok": True}, anchor_dir=str(anchor))
            env = ev.read_events(env_log)
            strip = lambda rs: [{k: v for k, v in r.items() if k != "ts"}
                                for r in rs]
            recs.append((strip([full]), strip(got), strip(env)))
        assert recs[0] == recs[1]
        assert recs[1][1][0]["kind"] == "bench"

    def test_drift_report_matches(self, event_log):
        outs = []
        for root in PKGS:
            m = _mods(root)
            events = m["obs.events"].read_events(event_log)
            text, flags = m["obs.drift"].audit(events, persist=False)
            outs.append((text, flags,
                         m["obs.drift"].report(events, persist=False)))
        assert outs[0] == outs[1]
        assert outs[1][0] == outs[1][2]


# -- the bridge ----------------------------------------------------------------


RPCS = [
    ("upload", {"name": "A", "data": [[1.0, 2.0], [3.0, 4.0]]}),
    ("upload", {"name": "X", "shape": [2, 2], "data": [2.0, 0.0, 0.0, 2.0]}),
    ("sql", {"query": "transpose(A)", "store": "B"}),
    ("fetch", {"name": "B"}),
    ("sql", {"query": "trace(X)"}),
    ("sql", {"query": "A * X"}),
    ("sql", {"query": "max(A)"}),
    ("sql", {"query": "diagmin(A)"}),
    ("sql", {"query": "Nope * X"}),
    ("create_random", {"name": "R", "shape": [8, 8], "seed": 1}),
    ("tables", {}),
    ("frobnicate", {}),
]


def _bridge_transcript(root, jmesh):
    import importlib
    bridge = importlib.import_module(f"{root}.bridge")
    sess_mod = importlib.import_module(f"{root}.session")
    sess = (sess_mod.MatrelSession(mesh=jmesh) if root == "matrel_tpu"
            else sess_mod.MatrelSession(device="cpu"))
    srv = bridge.BridgeServer(sess)
    srv.serve_background()
    client = bridge.BridgeClient("127.0.0.1", srv.port)
    out = []
    try:
        for method, params in RPCS:
            try:
                out.append(("ok", client.call(method, **params)))
            except RuntimeError as ex:
                out.append(("error", str(ex)))
        plan = client.call("explain", query="rowsum(A * A)")["plan"]
        fetched = client.call("fetch", name="R")
        out.append(("bye", client.call("shutdown")))
    finally:
        client.close()
        srv.server_close()
    return out, plan, fetched


def test_bridge_protocol_matches(jmesh):
    (jout, jplan, jr), (tout, tplan, tr) = (
        _bridge_transcript(root, jmesh) for root in PKGS)
    assert tout == jout
    assert tout[3] == ("ok", {"data": [[1.0, 3.0], [2.0, 4.0]],
                              "shape": [2, 2]})
    assert tout[8][0] == "error" and tout[11][0] == "error"
    assert "unknown method" in tout[11][1]
    assert tout[-1] == ("bye", "bye")
    for plan in (jplan, tplan):
        assert "Optimized plan" in plan and "strategy=" in plan
    # create_random: the same shape; values from each package's generator
    assert tr["shape"] == jr["shape"] == [8, 8]
    vals = np.asarray(tr["data"])
    assert ((vals >= 0) & (vals < 1)).all()


# -- the CLI --------------------------------------------------------------------


def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MATREL_OBS_EVENT_LOG", None)
    proc = subprocess.run([sys.executable, "-m", "matrel_tpu_torch", *argv],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_cli_info_sql_pagerank_history(tmp_path, jmesh, event_log):
    from matrel_tpu.config import default_config
    from matrel_tpu.session import MatrelSession as JSession
    from matrel_tpu.workloads.pagerank import pagerank_edges
    info = json.loads(_cli(tmp_path, "info", "--device", "cpu"))
    jcfg = default_config()
    assert info["device"] == "cpu" and info["grid"] == {"x": 1, "y": 1}
    assert info["torch"] == torch.__version__
    assert info["config"] == {k: getattr(jcfg, k) for k in info["config"]}
    # sql over a .npy table, printed as the JAX package's CLI prints it
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(tmp_path / "a.npy", a)
    got = _cli(tmp_path, "sql", "transpose(A) * A", "--table",
               f"A={tmp_path / 'a.npy'}", "--device", "cpu")
    js = JSession(mesh=jmesh)
    js.register("A", js.from_numpy(a))
    want = js.compute(js.sql("transpose(A) * A")).to_numpy()
    with np.printoptions(precision=5, suppress=True, threshold=200):
        assert got == f"{np.asarray(want)}\n"
    # pagerank over a CSV edge list: the JAX package's ranks and order
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    with open(tmp_path / "edges.csv", "w") as f:
        f.writelines(f"{s},{d}\n" for s, d in zip(src, dst))
    pr = json.loads(_cli(tmp_path, "pagerank", str(tmp_path / "edges.csv"),
                         "--device", "cpu", "--top", "10"))
    n = int(max(src.max(), dst.max())) + 1
    want = np.asarray(pagerank_edges(src, dst, n, rounds=30, alpha=0.85))
    assert pr["nodes"] == n and pr["edges"] == 200 and pr["rounds"] == 30
    got_r = np.array([t["rank"] for t in pr["top"]])
    np.testing.assert_allclose(got_r, np.sort(want)[::-1][:10], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pr["rank_sum"], want.sum(), rtol=1e-5)
    # history reads the log as the JAX package's does
    got = _cli(tmp_path, "history", "--log", event_log, "--summary")
    (_rc, want), _ = _both("main", "obs.history",
                           _hist_args(event_log, summary=True))
    assert got == want


def test_cli_defaults_to_the_card_and_bench_refuses():
    from matrel_tpu_torch.__main__ import main
    from matrel_tpu_torch.config import NotPortedError
    from matrel_tpu_torch.core.mesh import DeviceUnavailableError
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            main(["info"])
    with pytest.raises(NotPortedError, match="benchmark"):
        main(["bench"])


# -- utils/debug.py -------------------------------------------------------------


class TestDebugGuards:
    def test_checked_raises_on_nan_as_jax_does(self):
        import jax.numpy as jnp
        from matrel_tpu.utils.debug import checked as jchecked
        from matrel_tpu_torch.utils.debug import checked
        jf = jchecked(lambda x: jnp.log(x) * 2.0)
        tf = checked(lambda x: torch.log(x) * 2.0)
        np.testing.assert_allclose(tf(torch.ones(4)).numpy(),
                                   np.asarray(jf(jnp.ones((4,)))))
        with pytest.raises(Exception, match="nan|NaN"):
            jf(-jnp.ones((4,)))
        with pytest.raises(FloatingPointError, match=r"aten\.log"):
            tf(-torch.ones(4))

    def test_checked_names_the_op_and_line_of_a_masked_inf(self):
        from matrel_tpu_torch.utils.debug import checked

        def masked(x):
            y = 1.0 / x
            return torch.where(torch.isinf(y), torch.zeros_like(y), y)

        x = torch.tensor([0.0, 2.0])
        assert torch.isfinite(masked(x)).all()       # return is finite
        with pytest.raises(FloatingPointError) as ei:
            checked(masked)(x)
        msg = str(ei.value)
        assert "reciprocal" in msg or "div" in msg
        assert "test_torch_tools.py" in msg and "in masked" in msg

    def test_checked_session_compute_and_uninitialised_allocs(self):
        from matrel_tpu_torch.session import MatrelSession
        from matrel_tpu_torch.utils.debug import checked
        s = MatrelSession(device="cpu")
        a = np.random.default_rng(0).standard_normal(
            (16, 16)).astype(np.float32)
        A = s.from_numpy(a)
        out = checked(lambda: s.compute(A.expr().multiply(A.expr())))()
        np.testing.assert_allclose(out.to_numpy(), a @ a, rtol=1e-5,
                                   atol=1e-5)
        # an empty() allocation is uninitialised by contract, not a NaN
        assert checked(lambda: torch.empty(64).fill_(1.0).sum())() == 64

    def test_assert_finite_matches_jax(self, jmesh):
        from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
        from matrel_tpu.utils.debug import assert_finite as jaf
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
        from matrel_tpu_torch.core.mesh import make_mesh
        from matrel_tpu_torch.utils.debug import assert_finite
        tm = make_mesh(device="cpu")
        good = np.ones((4, 4), np.float32)
        bad = np.array([[1.0, np.inf], [np.nan, 1.0]], np.float32)
        jaf(JBM.from_numpy(good, mesh=jmesh))
        assert_finite(TBM.from_numpy(good, mesh=tm))
        msgs = []
        for fn, m in ((jaf, JBM.from_numpy(bad, mesh=jmesh)),
                      (assert_finite, TBM.from_numpy(bad, mesh=tm))):
            with pytest.raises(FloatingPointError) as ei:
                fn(m, "bad")
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1] and msgs[1].startswith("bad: 2 ")
        with pytest.raises(FloatingPointError):
            assert_finite(torch.tensor([1.0, float("nan")]))
