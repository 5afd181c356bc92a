"""The lock-construction seam plus an optional runtime lock-order
sanitizer — the counterpart of ``matrel_tpu/utils/lockdep.py``.

Every named lock of the port's serve, obs and resilience planes (and
the session's ``"session.compile"``) is built through :func:`make_lock`
/ :func:`make_rlock`. The seam buys two things:

1. **A named lock inventory.** Each lock declares a stable dotted name
   (``"serve.pipeline"``, ``"obs.metrics_registry"``) — the same names
   the JAX package's locks carry, so the order graphs of both packages
   speak one vocabulary.
2. **A swap point.** With ``config.lockdep_enable`` the constructors
   return :class:`_InstrumentedLock` wrappers that record per-thread
   acquisition stacks into one global lock-ORDER graph and raise or
   record typed diagnostics:

   - :class:`LockOrderInversion` — acquiring B while holding A after
     the reverse order was ever observed (a cycle in the order graph:
     two threads interleaving those paths can deadlock), and the
     always-fatal special case of re-acquiring a non-reentrant lock
     the same thread already holds (self-deadlock).
   - :class:`HeldAcrossDispatch` — a sanctioned dispatch/blocking
     point (:func:`note_dispatch` call sites: the session's plan
     dispatch, the serve worker's batch sync) entered while holding a
     lock not sanctioned for it (a drain that waits on the device
     while a serve lock blocks the worker would wedge).

   Diagnostics flow through the emit hook (:func:`set_emit`) as
   ``lockdep`` obs events — the session wires its ``_obs_emit`` funnel
   in, so they land in the JSONL event log and the flight-recorder ring.

The default path (``lockdep_enable`` off) returns the raw ``threading``
primitives and constructs ZERO lockdep objects (poisoned-``__init__``
test-enforced in ``tests/test_torch_lockdep.py``); ``note_dispatch`` is
a single module-global flag check when disabled.

The order graph is keyed by lock NAME (the lock-class granularity of
kernel lockdep), so two instances of one named lock share a node;
nesting a name under itself is excluded from the cycle check (it would
self-loop falsely) — the per-INSTANCE self-deadlock check covers that
hole. Module-level locks are built at import time, so they are only
instrumented when :func:`enable` runs before their module first
imports.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "make_lock", "make_rlock", "enable", "disable", "enabled",
    "reset", "set_emit", "note_dispatch", "order_graph",
    "diagnostics", "is_acyclic", "LockOrderInversion",
    "HeldAcrossDispatch",
]


class LockOrderInversion(RuntimeError):
    """Two locks were observed nesting in BOTH orders (or a
    non-reentrant lock was re-acquired by its holder): a schedule
    exists that deadlocks. Carries the diagnostic record."""

    def __init__(self, record: dict):
        self.record = record
        super().__init__(record.get("msg", "lock-order inversion"))


class HeldAcrossDispatch(RuntimeError):
    """A sanctioned dispatch/blocking point ran while holding an
    unsanctioned lock (a drain that syncs the device while a serve
    lock blocks the worker). Carries the diagnostic record."""

    def __init__(self, record: dict):
        self.record = record
        super().__init__(record.get("msg", "lock held across dispatch"))


# -- global sanitizer state (built lazily by enable(); the default
#    path never touches anything below beyond the _ENABLED check) ----

_ENABLED = False
_RAISE = False
_EMIT: Optional[Callable[[dict], None]] = None
# one guard for the shared graph/diagnostic stores — a RAW lock by
# necessity (the sanitizer cannot instrument itself)
_STATE_LOCK = threading.Lock()
#: observed nesting edges: (held_name, acquired_name) -> first-seen
#: {"site": ..., "held_site": ...} sample
_EDGES: Dict[Tuple[str, str], dict] = {}
_DIAGS: List[dict] = []
_TLS = threading.local()


def _held_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _site(depth: int = 3) -> str:
    """Lightweight ``file:line`` of the acquiring frame (skipping the
    wrapper's own frames) — cheap enough for the enabled path, never
    touched on the default path."""
    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"
    except ValueError:
        return "?"


def _record(diag: dict, exc_type) -> None:
    """Store + emit one diagnostic; raise it when configured (the
    self-deadlock case forces the raise regardless — see caller)."""
    with _STATE_LOCK:
        _DIAGS.append(diag)
    emit = _EMIT
    if emit is not None:
        try:
            emit(dict(diag))
        except Exception:  # matlint: disable=ML007 diagnostics must never take a query down with a failing sink; the record is already in diagnostics()
            pass
    if _RAISE or diag.get("fatal"):
        raise exc_type(diag)


class _InstrumentedLock:
    """A named wrapper over one ``threading`` lock: bookkeeps the
    per-thread held stack, grows the global order graph on every
    acquisition, and mirrors enough of the lock protocol
    (``_release_save``/``_acquire_restore``/``_is_owned``) that
    ``threading.Condition`` built over it keeps the bookkeeping
    exact across ``wait()``."""

    __slots__ = ("name", "reentrant", "dispatch_ok", "_inner",
                 "_owner", "_count")

    def __init__(self, name: str, reentrant: bool,
                 dispatch_ok: bool = False):
        self.name = name
        self.reentrant = reentrant
        self.dispatch_ok = dispatch_ok
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())
        self._owner: Optional[int] = None   # thread ident (under GIL)
        self._count = 0

    # -- order bookkeeping ---------------------------------------------------

    def _check_before_acquire(self) -> None:
        me = threading.get_ident()
        held = _held_stack()
        if self._owner == me:
            if self.reentrant:
                return  # re-entry: no new edges, no new held entry
            _record({"kind": "lockdep", "diag": "self_deadlock",
                     "lock": self.name, "site": _site(),
                     "thread": threading.current_thread().name,
                     "fatal": True,
                     "msg": f"non-reentrant lock {self.name!r} "
                            f"re-acquired by its holder"},
                    LockOrderInversion)
            return  # unreachable (fatal always raises); defensive
        inversion = None
        with _STATE_LOCK:
            for ent in held:
                a = ent["name"]
                if a == self.name:
                    continue  # name-granularity self-loop (see module doc)
                edge = (a, self.name)
                if edge not in _EDGES:
                    _EDGES[edge] = {"site": _site(),
                                    "held_site": ent["site"]}
                if inversion is None and _path_exists(self.name, a):
                    inversion = {
                        "kind": "lockdep", "diag": "inversion",
                        "lock": self.name, "held": a,
                        "site": _site(), "held_site": ent["site"],
                        "thread": threading.current_thread().name,
                        "msg": f"acquiring {self.name!r} while "
                               f"holding {a!r} after the reverse "
                               f"order was observed",
                    }
        if inversion is not None:
            _record(inversion, LockOrderInversion)

    def _note_acquired(self) -> None:
        me = threading.get_ident()
        if self._owner == me and self.reentrant:
            self._count += 1
            return
        self._owner = me
        self._count = 1
        _held_stack().append({"name": self.name, "lock": self,
                              "site": _site()})

    def _note_released(self) -> None:
        if self._count > 1:
            self._count -= 1
            return
        self._owner = None
        self._count = 0
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i]["lock"] is self:
                del st[i]
                break

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            self._check_before_acquire()
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # Condition-protocol mirrors: Condition(wrapped_lock) picks these
    # up by attribute probe; routing them through the bookkeeping
    # keeps the held stack exact across wait()'s release/re-acquire.
    def _release_save(self):
        me = threading.get_ident()
        count = self._count if self._owner == me else 1
        self._owner = None
        self._count = 0
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i]["lock"] is self:
                del st[i]
                break
        if self.reentrant:
            inner_state = self._inner._release_save()
            return (count, inner_state)
        self._inner.release()
        return (count, None)

    def _acquire_restore(self, state) -> None:
        count, inner_state = state
        if self.reentrant:
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        self._owner = threading.get_ident()
        self._count = count
        _held_stack().append({"name": self.name, "lock": self,
                              "site": _site()})

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __repr__(self) -> str:
        return (f"<lockdep {'RLock' if self.reentrant else 'Lock'} "
                f"{self.name!r} owner={self._owner}>")


def _path_exists(src: str, dst: str) -> bool:
    """DFS over _EDGES (caller holds _STATE_LOCK): would edge
    dst->...->src already order dst before src?"""
    if src == dst:
        return True
    seen = {src}
    stack = [src]
    while stack:
        node = stack.pop()
        for (a, b) in _EDGES:
            if a == node and b not in seen:
                if b == dst:
                    return True
                seen.add(b)
                stack.append(b)
    return False


# -- the seam ----------------------------------------------------------------

def make_lock(name: str, dispatch_ok: bool = False):
    """The one sanctioned ``threading.Lock`` constructor.
    ``name`` is the lock's stable inventory id;
    ``dispatch_ok`` declares that holding this lock across a
    sanctioned dispatch point is by design (the fleet's
    dispatch-to-completion arbitration)."""
    if not _ENABLED:
        return threading.Lock()
    return _InstrumentedLock(name, reentrant=False,
                             dispatch_ok=dispatch_ok)


def make_rlock(name: str, dispatch_ok: bool = False):
    """The one sanctioned ``threading.RLock`` constructor."""
    if not _ENABLED:
        return threading.RLock()
    return _InstrumentedLock(name, reentrant=True,
                             dispatch_ok=dispatch_ok)


def note_dispatch(what: str) -> None:
    """Sanctioned dispatch/blocking point: with the sanitizer on,
    diagnose any held un-sanctioned lock (HeldAcrossDispatch). A single flag check when off."""
    if not _ENABLED:
        return
    for ent in _held_stack():
        lk = ent["lock"]
        if not lk.dispatch_ok:
            _record({"kind": "lockdep", "diag": "held_across_dispatch",
                     "lock": lk.name, "dispatch": what,
                     "site": _site(2), "held_site": ent["site"],
                     "thread": threading.current_thread().name,
                     "msg": f"{what}: dispatching while holding "
                            f"{lk.name!r}"},
                    HeldAcrossDispatch)


# -- control surface ---------------------------------------------------------

def enable(raise_on_violation: bool = False,
           emit: Optional[Callable[[dict], None]] = None) -> None:
    """Switch the constructors to instrumented wrappers. Locks built
    BEFORE this call stay raw (module-level locks in already-imported
    modules — see the module docstring); the session calls this ahead
    of constructing any of its own locks."""
    global _ENABLED, _RAISE, _EMIT
    _ENABLED = True
    _RAISE = bool(raise_on_violation)
    if emit is not None:
        _EMIT = emit


def disable() -> None:
    global _ENABLED, _RAISE, _EMIT
    _ENABLED = False
    _RAISE = False
    _EMIT = None


def enabled() -> bool:
    return _ENABLED


def set_emit(emit: Optional[Callable[[dict], None]]) -> None:
    """Install the diagnostic sink (the session passes a closure over
    its ``_obs_emit`` funnel, so records reach the event log and the
    flight ring). Last writer wins — one global sanitizer."""
    global _EMIT
    _EMIT = emit


def reset() -> None:
    """Clear the order graph and diagnostics (NOT the enabled flag) —
    drill/fixture isolation between seeded trials."""
    with _STATE_LOCK:
        _EDGES.clear()
        _DIAGS.clear()


def order_graph() -> Dict[Tuple[str, str], dict]:
    """Snapshot of the observed nesting edges."""
    with _STATE_LOCK:
        return dict(_EDGES)


def diagnostics() -> List[dict]:
    """Snapshot of every recorded diagnostic."""
    with _STATE_LOCK:
        return [dict(d) for d in _DIAGS]


def is_acyclic() -> bool:
    """True iff the observed order graph has no cycle (no deadlock-
    capable schedule was ever recorded)."""
    with _STATE_LOCK:
        edges = list(_EDGES)
    adj: Dict[str, list] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}

    def visit(n: str) -> bool:
        color[n] = GRAY
        for m in adj.get(n, ()):
            c = color.get(m, WHITE)
            if c == GRAY:
                return False
            if c == WHITE and not visit(m):
                return False
        color[n] = BLACK
        return True

    return all(visit(n) for n in adj if color.get(n, WHITE) == WHITE)
