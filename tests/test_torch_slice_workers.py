"""PyTorch port: the pieces a fleet slice's own worker stands on, on the
CPU without a rank world — the decision log's store, the admission
queue's load, the fleet's load model, a pipeline filed by the router
(``admit_routed``), its failover surface (``abandon``) and its health
probe (``wedged``), and one worker a control group. The rank worlds of
``tests/test_torch_serve_ranks.py`` drive them together against the JAX
package."""

import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                PipelineClosed)
from matrel_tpu_torch.resilience.retry import Deadline
from matrel_tpu_torch.serve import admission, ranklog
from matrel_tpu_torch.serve.fleet import FleetController
from matrel_tpu_torch.serve.pipeline import SEQ, ServePipeline
from matrel_tpu_torch.session import MatrelSession


def _session(**kw):
    sess = MatrelSession(mesh=mesh_lib.make_mesh(device="cpu"),
                         config=MatrelConfig(**kw))
    a = np.arange(16, dtype=np.float32).reshape(4, 4)
    sess.register("A", sess.from_numpy(a))
    return sess, a


def _entry(sess, seq, dl=None, tenant=""):
    fut = Future()
    fut.ready_event = None
    e = sess.table("A").expr().multiply_scalar(float(seq + 1))
    return (e, fut, time.perf_counter(), "default", dl, tenant, None, seq,
            ranklog.rank_key(e))


def test_entry_store_drop_and_lowest():
    store = ranklog.EntryStore(0)
    for s in (5, 3, 4):
        store.put((s, Future()))
    assert [e[0] for e in store.lowest(2)] == [3, 4]
    store.drop([3, 9])
    assert store.unfinished_tasks == 2
    assert [e[0] for e in store.lowest(5)] == [4, 5]
    store.done(2)
    store.join(timeout=1.0)


def test_admission_queue_load_idle_then_busy():
    q = admission.AdmissionQueue(MatrelConfig())
    for i in range(2):
        q.put((None, Future(), 0.0, "default", None, "", None), "")
    assert q.load() == (2, False)
    q.get_nowait()
    assert q.load() == (1, True)
    q.task_done()
    assert q.load() == (1, False)


@pytest.mark.parametrize("depth,since,batch,want", [
    ((0, False), 1, 8, 0),      # an idle worker takes it at once
    ((0, True), 1, 8, 1),       # a busy one leaves it queued
    ((10, False), 0, 8, 2),     # an idle worker takes a batch
    ((0, False), 2, 1, 1),      # one a batch: the second waits
])
def test_fleet_load_as_of_the_last_record(depth, since, batch, want):
    fake = types.SimpleNamespace(
        _depth={0: depth}, _since={0: since},
        config=MatrelConfig(serve_max_batch=batch))
    assert FleetController._load(fake, 0) == want
    assert FleetController._load(fake, 0, {0: since + 1}) >= want


def test_decision_log_of_one_rank():
    dlog = ranklog.DecisionLog(mesh_lib.make_mesh(device="cpu"))
    assert dlog.lead and dlog.world == 1 and dlog.group is None
    assert dlog.broadcast("x", src=3) == "x"
    assert dlog.gather("y") == ["y"]
    assert dlog.info()["exchanges"] == 0


def test_admit_routed_serves_and_defers_a_shed():
    """A pipeline the router files entries into (here of one rank): the
    answers go through the route's hooks, and a bound's shed rides the
    next cycle typed instead of raising at the call."""
    sess, a = _session(serve_tenant_queue_max=1, serve_max_batch=1)
    pipe = ServePipeline(sess)
    seen = []
    route = types.SimpleNamespace(
        wrap=lambda out: ("wrapped", out),
        info=lambda batch, outs: [None] * len(batch),
        served=lambda batch, info, late: seen.extend(
            it[SEQ] for it in batch))
    pipe.attach_route(route)
    assert pipe._q.deferring
    gate = threading.Event()
    run = sess.run_many
    sess.run_many = lambda *x, **k: (gate.wait(10), run(*x, **k))[1]
    first, second = _entry(sess, 0, tenant="t"), _entry(sess, 1, tenant="t")
    pipe.admit_routed(first)
    for _ in range(200):            # the worker has taken the first
        if pipe.load()[1]:
            break
        time.sleep(0.01)
    pipe.admit_routed(second)
    third = _entry(sess, 2, tenant="t")
    pipe.admit_routed(third)        # the tenant's queue is at its bound
    gate.set()
    tag, out = first[1].result(timeout=30)
    assert tag == "wrapped"
    np.testing.assert_allclose(out.to_numpy(), a)
    with pytest.raises(AdmissionShed):
        third[1].result(timeout=30)
    assert second[1].result(timeout=30)[0] == "wrapped"
    assert seen == [0, 1]
    pipe.close(timeout=30)
    with pytest.raises(PipelineClosed):
        pipe.admit_routed(_entry(sess, 3))


def test_abandon_takes_what_waits_with_its_deadline_verdict():
    sess, _a = _session()
    pipe = ServePipeline(sess)
    pipe.attach_route(types.SimpleNamespace())
    late = Deadline(1.0)
    waiting = [_entry(sess, 0), _entry(sess, 1, dl=late)]
    for it in waiting:
        pipe._q.put(it, "")
    time.sleep(0.01)
    taken = pipe.abandon()
    assert [it[SEQ] for it, _v in taken] == [0, 1]
    assert taken[0][1] is None
    assert taken[1][1][0] == "deadline" and taken[1][1][1] == 1.0
    assert pipe.closed and pipe._stop.is_set() and not pipe._await_stop
    assert pipe.load() == (0, False)
    pipe.drain(timeout=1.0)


def test_wedged_probe():
    sess, _a = _session()
    pipe = ServePipeline(sess)
    assert not pipe.wedged()               # no worker yet
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    pipe._worker = dead
    pipe._q.put(_entry(sess, 0), "")
    assert pipe.wedged()                   # died with an entry waiting
    pipe._stop.set()
    assert not pipe.wedged()               # a stop was asked


def test_one_worker_a_control_group():
    root = object.__new__(mesh_lib.RankGroups)
    root._parent = None
    root._workers_lock = threading.Lock()
    root._workers = []
    world, slice0 = object(), object()

    def worker(group):
        return types.SimpleNamespace(control=group, closed=False)

    router, pipe0 = worker(world), worker(slice0)
    root.register_worker(router)
    root.register_worker(pipe0)             # another group: allowed
    with pytest.raises(RuntimeError):
        root.register_worker(worker(world))
    router.closed = True                    # a closed worker leaves
    root.register_worker(worker(world))
    root.unregister_worker(pipe0)
    assert [w.control for w in root._workers] == [world]
