"""Device plus grid — the counterpart of ``matrel_tpu/core/mesh.py``.

The JAX package lays a 2D ``jax.sharding.Mesh`` over the TPU chips and
its partitioners are ``PartitionSpec``s. This package has two meshes:

* the VIRTUAL grid (:func:`make_mesh`): one card, every array whole on
  ``mesh.device``; the (gx, gy) grid is the one the planner prices
  strategies and pads dimensions on, so plan stamps can be held against
  the reference on the same grid (``tests/plan_snapshots.json`` plans on
  (2, 4));
* the RANK mesh (:func:`init_distributed`): one ``torch.distributed``
  process a grid cell, laid out row-major as the JAX package lays its
  devices (rank ``i·gy + j`` is cell (i, j)), with the process groups of
  the two axes taken from a ``DeviceMesh``. ``mesh.ranks`` holds them;
  values live as local shards (``parallel/collectives.py``) and every
  rank runs the same program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional, Tuple, Union

import torch


class PartitionSpec(tuple):
    """Stand-in for ``jax.sharding.PartitionSpec``: one entry per matrix
    dim — None (replicated), a mesh-axis name, or a tuple of names. A
    leaf's spec is metadata the planner's layout model reads; nothing
    is sharded on one card."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for (the default) and none is present."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The torch device a session runs on: "cuda" unless the caller asks
    for another. A CUDA request without a card raises — the package
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "matrel_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class RankGroups:
    """The ``torch.distributed`` side of a rank mesh: this process's rank
    and its (i, j) cell, the backend, the process groups of the x and y
    axes (``x`` joins the ranks of one column j, ``y`` those of one row
    i, as ``shard_map`` axes do) and the collectives that stage CUDA
    tensors through host memory (gloo refuses some of them; see
    ``parallel/collectives.host_staged``). Compared by identity.

    ``members`` are the global ranks of the mesh's cells, row-major: the
    whole world for a mesh of :func:`init_distributed`, a contiguous run
    of it for a serving slice (:func:`slice_meshes`). ``rank`` and
    ``coords`` are this process's place among them (None when the
    process holds no cell of the slice).

    Each mesh also owns its serve plane's agreement group: ``control``,
    a gloo group of the mesh's ranks that carries nothing but the
    decision records of ``serve/ranklog.py`` (so control traffic never
    interleaves with a data collective, under NCCL as well); a serving
    slice's is its own, so each slice's worker agrees among its ranks
    only. The world mesh owns :meth:`held`, the drain-and-hold every
    collective entry point takes while a serve worker is live."""

    def __init__(self, device_mesh, backend: str, grid: Tuple[int, int],
                 members=None, groups=None, parent=None):
        import torch.distributed as dist
        self.device_mesh = device_mesh
        self.backend = backend
        me = dist.get_rank()
        self.members = (list(members) if members is not None
                        else list(range(dist.get_world_size())))
        self.world_size = len(self.members)
        self.global_rank = me
        self.rank = (self.members.index(me) if me in self.members
                     else None)
        self.coords = (divmod(self.rank, grid[1])
                       if self.rank is not None else None)
        self.groups = groups if groups is not None else {
            "x": device_mesh.get_group("x"),
            "y": device_mesh.get_group("y"),
            None: dist.group.WORLD}
        #: collective names routed through host memory for CUDA tensors
        self.host_staged: frozenset = frozenset()
        self._parent = parent.root if parent is not None else None
        self.control = None
        if parent is None:
            self._exec_lock = threading.RLock()  # matlint: disable=ML017 the rank mesh's execution lock, built with the mesh before any session can arm lockdep
            self._holder: Optional[int] = None
            self._workers_lock = threading.Lock()  # matlint: disable=ML017 the rank mesh's worker registry lock, built with the mesh before any session can arm lockdep
            self._workers: list = []

    @property
    def root(self) -> "RankGroups":
        """The world's RankGroups (this one on the world mesh): the
        control group, the execution lock and the live serve workers
        live there."""
        return self._parent if self._parent is not None else self

    @property
    def member(self) -> bool:
        """Does this process hold a cell of the mesh?"""
        return self.rank is not None

    def group(self, axis: Optional[str]):
        """Process group of mesh axis "x" / "y", or the mesh's world
        (None)."""
        return self.groups[axis]

    def global_of(self, local: int) -> int:
        """The global rank of the mesh's ``local``-th cell."""
        return self.members[local]

    # -- drain and hold (serve/ranklog.py) ---------------------------------

    def register_worker(self, worker) -> None:
        """A live serve worker (an object with ``drain()``,
        ``owns_thread()``, ``closed`` and ``control``, the group its
        decision records travel on) that :meth:`held` drains first. One
        a control group: two workers on one group would interleave their
        records differently on different ranks. The fleet's router (the
        world's group) and each slice's pipeline (the slice's) are
        workers of disjoint groups."""
        root = self.root
        with root._workers_lock:
            root._workers = [w for w in root._workers
                             if w is not worker and not w.closed]
            if any(w.control is worker.control for w in root._workers):
                raise RuntimeError(
                    "a rank mesh serves one session's submissions at a "
                    "time: serve_close() the other session first")
            root._workers.append(worker)

    def unregister_worker(self, worker) -> None:
        root = self.root
        with root._workers_lock:
            root._workers = [w for w in root._workers if w is not worker]

    @contextlib.contextmanager
    def held(self):
        """Run a collective entry point in its turn: drain every live
        serve worker of the world (so every rank has applied the same
        decision records), then hold the execution lock the workers
        take around each cycle. Re-entrant; a worker's own thread (and
        anything it calls) passes straight through."""
        root = self.root
        if root._holder == threading.get_ident():
            yield
            return
        with root._workers_lock:
            workers = list(root._workers)
        for w in workers:
            if not w.owns_thread():
                w.drain()
        with self.cycle():
            yield

    @contextlib.contextmanager
    def cycle(self):
        """The execution lock as a serve worker takes it around one
        decision cycle (no drain: the worker IS the drained party)."""
        root = self.root
        me = threading.get_ident()
        with root._exec_lock:
            outer, root._holder = root._holder, me
            try:
                yield
            finally:
                root._holder = outer


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One execution device and the (gx, gy) grid: virtual on one card,
    or a grid of ranks when ``ranks`` is set (see the module
    docstring)."""

    device: torch.device
    grid: Tuple[int, int] = (1, 1)
    axis_names: Tuple[str, str] = ("x", "y")
    ranks: Optional[RankGroups] = dataclasses.field(default=None,
                                                    repr=False)

    @property
    def size(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def ranked(self) -> bool:
        """Is this a rank mesh (values held as per-rank shards)?"""
        return self.ranks is not None


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("x", "y"),
              device: Union[str, torch.device, None] = None) -> Mesh:
    """Build the mesh: ``shape=None`` is the 1x1 grid of one card (the
    JAX package derives a near-square grid from its device count; here
    the device count is one)."""
    gx, gy = (1, 1) if shape is None else (int(shape[0]), int(shape[1]))
    if gx < 1 or gy < 1:
        raise ValueError(f"mesh grid must be positive, got {shape}")
    return Mesh(resolve_device(device), (gx, gy), tuple(axis_names))


def mesh_grid_shape(mesh: Mesh) -> Tuple[int, int]:
    return mesh.grid


def near_square_factors(n: int) -> Tuple[int, int]:
    """Factor n into (a, b) with a·b == n and a ≤ b, a as large as
    possible (the JAX package's default grid for n devices)."""
    a = int(math.isqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int, grid: Optional[Tuple[int, int]] = None,
                     device: Union[str, torch.device, None] = None,
                     axis_names: Tuple[str, str] = ("x", "y"),
                     timeout_s: float = 600.0) -> Mesh:
    """Join the process group and build the rank mesh — the counterpart
    of ``matrel_tpu/core/mesh.py``'s ``init_distributed`` + ``make_mesh``.

    ``backend`` is named by the caller and never switched: "nccl" needs a
    card per rank (fewer cards than ranks raise; its device is
    ``cuda:rank`` unless ``device`` says otherwise), "gloo" runs on
    ``device`` (the card by default, several ranks may share it; "cpu"
    when asked). ``init_method`` is the rendezvous
    (``tcp://localhost:<port>`` or ``file://<path>``); ``grid`` defaults
    to the near-square factors of ``world_size``. Every rank calls this
    with the same arguments but its own ``rank``."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    gx, gy = grid if grid is not None else near_square_factors(world_size)
    if gx * gy != world_size:
        raise ValueError(f"grid {grid} does not hold {world_size} ranks")
    if backend == "nccl":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_cards < world_size:
            raise DeviceUnavailableError(
                f"nccl needs one card a rank: {world_size} ranks, "
                f"{n_cards} cards (name backend='gloo' to share a card)")
        dev = resolve_device(device if device is not None
                             else f"cuda:{rank}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          (gx, gy), mesh_dim_names=tuple(axis_names))
    ranks = RankGroups(dm, backend, (gx, gy))
    # the decision log's own group, made on every rank in this order
    ranks.control = dist.new_group(backend="gloo")
    mesh = Mesh(dev, (gx, gy), tuple(axis_names), ranks)
    if backend == "gloo" and dev.type == "cuda":
        from matrel_tpu_torch.parallel import collectives
        ranks.host_staged = collectives.probe_host_staging(mesh)
    return mesh


def shutdown_distributed() -> None:
    """Leave the process group (every rank calls it). A barrier first:
    a rank that tore its connections down while a peer still read the
    last collective (a broadcast's sender returns before its receivers)
    would fail that peer."""
    import gc
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()  # matlint: disable=ML003 teardown barrier of shutdown_distributed — no data moves, nothing to tally
        dist.destroy_process_group()
    # let the groups still referenced (the topology memo keys on meshes;
    # sessions and their serve workers form cycles) go now: destroyed in
    # the interpreter's teardown they can abort the process
    _resolve_topology_cached.cache_clear()
    gc.collect()


#: Default relative inverse bandwidth of a mesh axis whose hops cross a
#: slice boundary, against an in-slice axis (the JAX package's value: a
#: byte over the cross-slice axis costs ~8 in-slice bytes of time).
#: ``config.axis_cost_weights`` calibrates the ratio of a given fabric;
#: placement (``serve/placement.py``) bills an unmeasured cut at this.
DCN_AXIS_WEIGHT = 8.0


# -- mesh topology ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One cell (i, j) of a mesh's (gx, gy) grid — what the JAX
    package's device is to its mesh. On one card every cell runs on the
    mesh's device; a cell carries no slice index (nothing here detects a
    slice boundary)."""

    row: int
    col: int
    gy: int = 1

    @property
    def id(self) -> int:
        """Row-major index, as the JAX package numbers its devices."""
        return self.row * self.gy + self.col


def mesh_cells(mesh) -> list:
    """The mesh's cells as rows of a 2D list: a port mesh's
    :class:`GridCell` grid, or the ``devices`` array of a stand-in that
    carries one (the tests' fake multi-slice mesh)."""
    devs = getattr(mesh, "devices", None)
    if devs is not None:
        return [list(row) for row in devs]
    gx, gy = mesh.grid
    return [[GridCell(i, j, gy) for j in range(gy)] for i in range(gx)]


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Per-axis interconnect description of a 2D mesh (the JAX
    package's). ``axis_weights[i]`` is the relative inverse bandwidth of
    mesh axis i: the comm model bills a collective leg over axis i at
    bytes × axis_weights[i]; (1.0, 1.0) is the homogeneous mesh.
    ``source`` says where the weights came from: "config" (an explicit
    ``config.axis_cost_weights``), "detected" (slice boundaries found
    through the cells' ``slice_index``) or "default"."""

    axis_weights: Tuple[float, float] = (1.0, 1.0)
    source: str = "default"

    @property
    def uniform(self) -> bool:
        return self.axis_weights[0] == self.axis_weights[1]


def detect_slice_axes(mesh) -> Tuple[bool, bool]:
    """Which mesh axes cross a slice boundary, from the cells'
    ``slice_index``: an axis crosses when two cells adjacent along it
    belong to different slices. Cells without a slice index (every
    port mesh) detect as (False, False)."""
    ids = [[getattr(d, "slice_index", None) for d in row]
           for row in mesh_cells(mesh)]
    flat = [s for row in ids for s in row]
    if any(s is None for s in flat) or len(set(flat)) <= 1:
        return False, False
    gx = len(ids)
    gy = len(ids[0]) if gx else 0
    x_cross = any(ids[i][j] != ids[i + 1][j]
                  for i in range(gx - 1) for j in range(gy))
    y_cross = any(ids[i][j] != ids[i][j + 1]
                  for i in range(gx) for j in range(gy - 1))
    return x_cross, y_cross


def _resolve_topology(mesh, weights: Tuple[float, float]) -> MeshTopology:
    if weights != (1.0, 1.0):
        return MeshTopology(weights, "config")
    try:
        crossings = detect_slice_axes(mesh)
    except Exception:         # exotic stand-ins must not break planning
        crossings = (False, False)
    if any(crossings):
        return MeshTopology(
            tuple(DCN_AXIS_WEIGHT if c else 1.0 for c in crossings),
            "detected")
    return MeshTopology((1.0, 1.0), "default")


_resolve_topology_cached = functools.lru_cache(maxsize=64)(
    _resolve_topology)


def mesh_topology(mesh, config=None) -> MeshTopology:
    """The topology governing cost models on this mesh: an explicit
    ``config.axis_cost_weights`` other than (1.0, 1.0) wins, else
    slice-boundary detection weights each crossing axis
    ``DCN_AXIS_WEIGHT``, else the homogeneous default. Never raises;
    memoised per (mesh, configured weights)."""
    from matrel_tpu_torch.config import default_config
    cfg = config or default_config()
    w = tuple(cfg.axis_cost_weights)
    try:
        return _resolve_topology_cached(mesh, w)
    except TypeError:         # unhashable mesh stand-ins (tests)
        return _resolve_topology(mesh, w)


def axis_weights(mesh, config=None) -> Tuple[float, float]:
    """``mesh_topology(mesh, config).axis_weights`` — the (wx, wy) every
    weighted costing path bills."""
    return mesh_topology(mesh, config).axis_weights


# -- slice views (the serving fleet: serve/fleet.py) ---------------------------


def slice_device_groups(mesh, n: int):
    """Partition a mesh's cells into ``n`` serving-slice groups:
    ``(groups, source)``, the cells row-major as the JAX package takes
    its devices.

    - ``"detected"``: the cells carry ``slice_index`` values whose
      distinct count is ``n`` (only a stand-in mesh does);
    - ``"virtual"``: the cells split into ``n`` equal contiguous runs;
    - ``"shared"``: fewer cells than would split evenly (the 1x1 grid
      of one card): every group is the whole cell set, and the slices
      share the card while keeping their own queues, workers and
      caches."""
    if n < 1:
        raise ValueError(f"slice count must be >= 1, got {n!r}")
    devs = [d for row in mesh_cells(mesh) for d in row]
    by_slice: dict = {}
    for d in devs:
        by_slice.setdefault(getattr(d, "slice_index", None), []).append(d)
    if None not in by_slice and len(by_slice) == n:
        return [by_slice[k] for k in sorted(by_slice)], "detected"
    if len(devs) >= n and len(devs) % n == 0:
        c = len(devs) // n
        return [devs[i * c:(i + 1) * c] for i in range(n)], "virtual"
    return [list(devs) for _ in range(n)], "shared"


def slice_meshes(mesh, n: int):
    """``n`` slice meshes over :func:`slice_device_groups`' partition:
    ``(meshes, source)``. A virtual or detected slice is a near-square
    sub-grid of its group's cell count on the parent's device (same
    axis names); a shared slice is the parent mesh itself."""
    groups, source = slice_device_groups(mesh, n)
    if source == "shared":
        return [mesh for _ in groups], source
    if getattr(mesh, "ranked", False):
        return [_rank_slice(mesh, [c.id for c in g]) for g in groups], \
            source
    return [Mesh(getattr(mesh, "device", None),
                 near_square_factors(len(g)),
                 tuple(getattr(mesh, "axis_names", ("x", "y"))))
            for g in groups], source


def _rank_slice(mesh: Mesh, members) -> Mesh:
    """The slice mesh over a contiguous run ``members`` of a rank mesh's
    world: a near-square grid of those ranks with its own world, x and y
    groups and its own gloo control group (its serve worker's decision
    records). ``new_group`` is collective over the whole world, so every
    rank makes every group of every slice, in this fixed order, whether
    or not it holds a cell of the slice."""
    import torch.distributed as dist
    sx, sy = near_square_factors(len(members))
    at = lambda i, j: members[i * sy + j]
    me = dist.get_rank()
    groups = {None: dist.new_group(ranks=list(members))}
    for axis, lines in (("x", [[at(i, j) for i in range(sx)]
                               for j in range(sy)]),
                        ("y", [[at(i, j) for j in range(sy)]
                               for i in range(sx)])):
        for line in lines:
            g = dist.new_group(ranks=line)
            if me in line:
                groups[axis] = g
    parent = mesh.ranks
    ranks = RankGroups(None, parent.backend, (sx, sy), members=members,
                       groups=groups, parent=parent)
    ranks.control = dist.new_group(ranks=list(members), backend="gloo")
    ranks.host_staged = parent.host_staged
    return Mesh(mesh.device, (sx, sy), mesh.axis_names, ranks)


def _spec(mesh: Mesh, rows, cols) -> P:
    x, y = mesh.axis_names
    name = {"x": x, "y": y, "xy": (x, y)}
    return P(name.get(rows), name.get(cols))


def replicated(mesh: Mesh) -> P:
    """Every rank holds the whole matrix."""
    return P()


def sharding_2d(mesh: Mesh) -> P:
    """Both matrix dims sharded: the 2D block-cyclic analogue."""
    return _spec(mesh, "x", "y")


def sharding_row(mesh: Mesh) -> P:
    """Row-sharded over the whole mesh (both axes on dim 0) — the
    RowPartitioner analogue."""
    return _spec(mesh, "xy", None)


def sharding_col(mesh: Mesh) -> P:
    """Column-sharded over the whole mesh — the ColumnPartitioner
    analogue."""
    return _spec(mesh, None, "xy")
