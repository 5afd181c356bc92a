"""The decision log: how the serve plane agrees across the ranks of a
rank mesh. The JAX package decides every admission cycle in one
controller thread; a rank mesh has one worker a rank, each with its own
queue and clock, and two workers that decide differently start
collectives the other rank does not join (wrong answers, or a gloo
timeout). So on a rank mesh:

- **The SPMD contract.** Every rank submits the same queries in the
  same order. Each pipeline numbers its submissions; an entry carries
  its sequence number and a rank-invariant digest of its plan key
  (:func:`rank_key`: leaves numbered by first appearance, not by id).
- **The lead decides.** The first rank of the worker's mesh (rank 0
  of the world, or a fleet slice's first rank) is the lead. Only its
  worker pulls from the admission queue and makes the cycle's
  decisions (which sequence numbers, sheds, deadline and breaker
  verdicts on its clock, the brownout sample and rung, stale serves,
  the SLA groups, a failed group's retry); it broadcasts them as one
  record (:meth:`DecisionLog.publish`).
- **The others follow.** A follower's worker only applies records: it
  waits, up to :data:`RANK_WAIT_S`, for the named sequence numbers to
  reach its :class:`EntryStore`, then fails, sheds, serves and runs the
  same futures and ``run_many`` groups in the same order.
- **Agreement before any collective.** Every rank then reports what it
  holds for the record (:meth:`DecisionLog.gather`): each entry's
  presence and plan-key digest, its result-cache hit pattern and, for a
  stale serve, the stale entry. One difference fails every future of
  the cycle on every rank with the typed ``RankDivergence`` before a
  single data collective starts; a sequence number that arrives after
  its cycle failed fails on arrival.
- **Each group's outcome is agreed too**: after ``run_many`` the ranks
  gather ok / error; a failure reaches every rank as the same typed
  error (the first failing rank's, rebuilt from
  :func:`error_record`), with the failing ranks' transient verdict, so
  a retry or a bisection is the same on every rank. After a success the
  lead, once every rank has finished, judges the late deadlines and
  latencies on its clock and broadcasts them.

One process (a session off a rank mesh) runs the same cycle on a
:class:`DecisionLog` of one rank: its worker is the lead, a record is
applied where it is made, and nothing is exchanged.

The records travel on ``mesh.ranks.control``, a gloo group of the
mesh's ranks that ``core/mesh`` makes for this alone (the world's in
``init_distributed``, each fleet slice's in ``_rank_slice``), so control
traffic never interleaves with a data collective (under NCCL too), and
the slices of a fleet agree each among its own ranks at the same time.
Counters the plane reports — deadline misses, stale serves, sheds, SLO
outcomes, breaker and brownout state, serve events — follow from the
records, so they are equal on every rank of the log.
"""

from __future__ import annotations

import hashlib
import importlib
import pickle
import threading
import time
from typing import Dict, List, Optional

from matrel_tpu_torch.utils import lockdep

#: How long a follower waits for a sequence number the lead's record
#: names before the cycle fails typed (seconds).
RANK_WAIT_S = 30.0


def rank_key(e) -> str:
    """A digest of ``e``'s structural plan key that is the same on every
    rank: leaves are numbered by first appearance (with their shape,
    spec and dtype) instead of by ``id()``."""
    from matrel_tpu_torch.session import _plan_key_spans
    seen: Dict[int, int] = {}

    def leaf(n) -> str:
        m = n.attrs["matrix"]
        k = seen.setdefault(id(m), len(seen))
        return (f"{n.kind}#{k}:{tuple(m.shape)}:{getattr(m, 'spec', '')}"
                f":{getattr(m, 'dtype', '')}")

    parts, _pins, _spans = _plan_key_spans(e, leaf_token=leaf)
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


class DecisionLog:
    """The lead / follower exchange of one serve worker over its mesh's
    control group: the world's for a session's pipeline and the fleet's
    router, a slice's own for that slice's pipeline. ``lead`` is True on
    the mesh's first rank (``members[0]``); off a rank mesh the log has
    one rank, the lead, and exchanges nothing. ``control_ms`` sums the
    host time spent in the exchanges (what a cycle pays for
    agreeing)."""

    def __init__(self, mesh):
        ranks = mesh.ranks if mesh.ranked else None
        self.group = ranks.control if ranks is not None else None
        self.lead_rank = ranks.members[0] if ranks is not None else 0
        self.lead = ranks is None or ranks.global_rank == self.lead_rank
        self.world = ranks.world_size if ranks is not None else 1
        self.cycles = 0
        self.exchanges = 0
        self.control_ms = 0.0

    def publish(self, rec=None):
        """The lead's record for the next cycle, on every rank (the lead
        passes it, a follower None)."""
        self.cycles += 1
        return self.broadcast(rec)

    def broadcast(self, obj=None, src: Optional[int] = None):
        """The lead's ``obj`` on every rank (global rank ``src``'s when
        given)."""
        if self.world == 1:
            return obj
        import torch.distributed as dist
        t0 = time.perf_counter()  # matlint: disable=ML006 control-exchange ms — DecisionLog.info() reports it (control_ms)
        box = [obj]
        dist.broadcast_object_list(  # matlint: disable=ML003 the decision log's control exchange on its own gloo group, counted by DecisionLog.exchanges — not a data collective of a plan
            box, src=self.lead_rank if src is None else src,
            group=self.group)
        self._count(t0)
        return box[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order (the lead's first)."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        t0 = time.perf_counter()  # matlint: disable=ML006 control-exchange ms — DecisionLog.info() reports it (control_ms)
        out: List = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)  # matlint: disable=ML003 the decision log's control exchange on its own gloo group, counted by DecisionLog.exchanges — not a data collective of a plan
        self._count(t0)
        return out

    def _count(self, t0: float) -> None:
        self.exchanges += 1
        self.control_ms += (time.perf_counter() - t0) * 1e3  # matlint: disable=ML006 control-exchange ms — DecisionLog.info() reports it (control_ms)

    def info(self) -> dict:
        return {"lead": self.lead, "cycles": self.cycles,
                "exchanges": self.exchanges,
                "control_ms": round(self.control_ms, 3)}


class EntryStore:
    """Submitted entries by sequence number (``entry[seq_index]``; the
    future is ``entry[1]``), with the ``all_tasks_done`` /
    ``unfinished_tasks`` surface a drain reads: a follower pipeline's
    queue (the lead's is its admission queue), and the fleet router's
    items on every rank."""

    def __init__(self, seq_index: int):
        self._seq = seq_index
        self._lock = lockdep.make_lock("serve.ranklog")
        self.all_tasks_done = threading.Condition(self._lock)
        self.unfinished_tasks = 0
        self._by_seq: Dict[int, tuple] = {}
        #: sequence numbers a cycle failed before they arrived here
        self._dead: Dict[int, BaseException] = {}

    def put(self, entry) -> None:
        seq = entry[self._seq]
        with self._lock:
            ex = self._dead.pop(seq, None)
            if ex is None:
                self._by_seq[seq] = entry
                self.unfinished_tasks += 1
                self.all_tasks_done.notify_all()
                return
        fut = entry[1]
        if fut.set_running_or_notify_cancel():
            fut.set_exception(ex)

    def wait_any(self, timeout: float) -> bool:
        """Is an entry waiting (within ``timeout`` seconds)?"""
        with self._lock:
            if not self._by_seq:
                self.all_tasks_done.wait(timeout)
            return bool(self._by_seq)

    def count(self, pred=None) -> int:
        """How many waiting entries satisfy ``pred`` (all: None)."""
        with self._lock:
            return sum(1 for e in self._by_seq.values()
                       if pred is None or pred(e))

    def lowest(self, n: int) -> list:
        """Up to ``n`` waiting entries, lowest sequence numbers first
        (left in place)."""
        with self._lock:
            return [self._by_seq[s] for s in sorted(self._by_seq)[:n]]

    def take(self, seqs, bound_s: float) -> Dict[int, tuple]:
        """Remove and return the named entries, waiting up to
        ``bound_s`` for those not here yet; the missing ones are simply
        absent from the result."""
        t_end = time.monotonic() + bound_s  # matlint: disable=ML006 wait deadline, not a measurement (the retry.py exemption's arithmetic)
        with self._lock:
            while True:
                missing = [s for s in seqs if s not in self._by_seq]
                rem = t_end - time.monotonic()  # matlint: disable=ML006 wait deadline, not a measurement
                if not missing or rem <= 0:
                    break
                self.all_tasks_done.wait(min(rem, 0.05))
            return {s: self._by_seq.pop(s) for s in seqs
                    if s in self._by_seq}

    def drop(self, seqs) -> None:
        """Remove the named entries without resolving them (a fleet
        failover re-admitted them elsewhere); they count as done."""
        with self._lock:
            n = sum(self._by_seq.pop(s, None) is not None for s in seqs)
        self.done(n)

    def mark_dead(self, seq: int, ex: BaseException) -> None:
        """Fail ``seq`` when it arrives (its cycle already failed)."""
        with self._lock:
            self._dead[seq] = ex

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait until every entry put here is done; ``DrainTimeout``
        past ``timeout`` seconds."""
        from matrel_tpu_torch.resilience.errors import DrainTimeout
        t_end = None if timeout is None else time.monotonic() + timeout  # matlint: disable=ML006 drain deadline, not a measurement
        with self._lock:
            while self.unfinished_tasks:
                rem = None if t_end is None else t_end - time.monotonic()  # matlint: disable=ML006 drain deadline, not a measurement
                if rem is not None and rem <= 0:
                    raise DrainTimeout(timeout, self.unfinished_tasks)
                self.all_tasks_done.wait(rem)

    def done(self, n: int) -> None:
        with self._lock:
            self.unfinished_tasks -= n
            if self.unfinished_tasks <= 0:
                self.all_tasks_done.notify_all()


def divergence(facts: list, seqs) -> Optional[str]:
    """The first difference between the ranks' reports for one record
    (None when they agree). ``facts[r]`` maps each sequence number to
    rank r's ``(present, key digest, cache pattern, stale ghost)``."""
    lead = facts[0]
    for s in seqs:
        want = lead.get(s)
        for r, got in enumerate(facts):
            mine = got.get(s)
            if mine is None or not mine[0]:
                return f"rank {r} never received sequence number {s}"
            if mine[1] != want[1]:
                return (f"sequence number {s}: rank {r}'s plan key "
                        f"{mine[1]} differs from the lead's {want[1]}")
            if mine[2] != want[2]:
                return (f"sequence number {s}: rank {r}'s result-cache "
                        f"state differs from the lead's")
            if mine[3] != want[3]:
                return (f"sequence number {s}: rank {r} holds no stale "
                        f"entry for the lead's stale serve")
    return None


def error_record(ex: BaseException) -> dict:
    """What a rank whose batch failed tells the others: the error's
    class, arguments and state, its text, and whether it is transient,
    so every rank can raise the same typed error
    (:func:`rebuild_error`)."""
    from matrel_tpu_torch.resilience.errors import is_transient
    cls = type(ex)
    rec = {"cls": (cls.__module__, cls.__qualname__), "args": ex.args,
           "state": dict(vars(ex)),
           "text": f"{cls.__name__}: {ex}"[:500],
           "transient": is_transient(ex)}
    try:
        pickle.dumps((rec["args"], rec["state"]))
    except Exception:      # an unpicklable argument: the text only
        rec["args"] = rec["state"] = None
    return rec


def rebuild_error(rec: dict) -> BaseException:
    """The error :func:`error_record` describes, as an instance of its
    own class (built without its ``__init__``, whose signature need not
    match ``args``); a ``RuntimeError`` with its text when the class
    cannot be imported here or its state did not travel."""
    mod, qual = rec["cls"]
    try:
        cls = importlib.import_module(mod)
        for part in qual.split("."):
            cls = getattr(cls, part)
        if rec["args"] is None or not (isinstance(cls, type) and
                                       issubclass(cls, BaseException)):
            raise TypeError(qual)
        ex = cls.__new__(cls)
        ex.args = rec["args"]
        ex.__dict__.update(rec["state"])
        return ex
    except (ImportError, AttributeError, TypeError, ValueError):
        return RuntimeError(rec["text"])
