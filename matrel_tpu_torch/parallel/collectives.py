"""Values on a rank mesh and the collectives that move them — the
counterpart of the ``shard_map`` specs and ``jax.lax`` collectives the
JAX package's recipes are written in.

A value on a rank mesh is a :class:`Shard`: this rank's block of a padded
global matrix plus its LAYOUT, a pair (row axes, column axes) of mesh-axis
ids ("x" for the first axis, "y" for the second). A dim carrying axes
``(a, b)`` is cut into ``|a|·|b|`` blocks and rank (i, j) holds block
``idx_a·|b| + idx_b`` — ``PartitionSpec`` semantics, so the reshard
vocabulary maps onto layouts one to one (:data:`STATES`: ``2d`` =
P(x, y), ``row`` = P((x, y), None), ``col`` = P(None, (x, y)), ``rep`` =
P(), ``rowx`` = P(x, None), ``coly`` = P(None, y), and the recipes'
``rowy`` = P(y, None)).

:func:`relay` moves a Shard to another layout with the least movement
this module knows, decided identically on every rank (collectives must
match): a local slice where every rank already holds its target block,
an ``all_to_all`` between two partitions, else an ``all_gather`` — each
over the smallest group (the y group, the x group, the world) that holds
what every rank needs.

Every collective is counted in :data:`TALLY` by (phase, kind, axis), the
counterpart of the JAX tests' HLO inspection; ``phase`` is "relay" for
input re-lays and "exec" inside a recipe's body (:func:`phase`).

gloo refuses some collectives on CUDA tensors (several ranks sharing one
card talk over gloo: NCCL refuses two ranks on one device). Those go
through :func:`host_staged`, the one helper that copies a collective's
tensors to host memory and back; ``mesh.ranks.host_staged`` names them
(:func:`probe_host_staging` finds them when the mesh is built; a
point-to-point send is always staged, gloo reads its buffer as host
memory).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Layout = Tuple[Tuple[str, ...], Tuple[str, ...]]

#: Named layouts: the reshard vocabulary (``reshard._state_spec``) plus
#: the contraction-side layout CPMM consumes its right operand at.
STATES: Dict[str, Layout] = {
    "2d": (("x",), ("y",)), "row": (("x", "y"), ()),
    "col": ((), ("x", "y")), "rep": ((), ()),
    "rowx": (("x",), ()), "coly": ((), ("y",)),
    "rowy": (("y",), ()),
}

#: Collectives counted: (phase, kind, axis) -> calls. axis is "x", "y"
#: or "world".
TALLY: Counter = Counter()

_PHASE = ["relay"]

#: Collective kinds gloo is asked to run on CUDA tensors by
#: :func:`probe_host_staging` (point-to-point is never asked).
PROBED = ("all_gather", "reduce_scatter", "all_to_all", "all_reduce",
          "broadcast")


def reset_tally() -> None:
    TALLY.clear()


def tally(phase: Optional[str] = None) -> Dict[str, int]:
    """{"kind:axis": calls}, of one phase or of both."""
    out: Counter = Counter()
    for (ph, kind, axis), n in TALLY.items():
        if phase is None or ph == phase:
            out[f"{kind}:{axis}"] += n
    return dict(out)


@contextlib.contextmanager
def phase(name: str):
    """Count the collectives issued inside under ``name``."""
    _PHASE.append(name)
    try:
        yield
    finally:
        _PHASE.pop()


def _count(kind: str, axis: Optional[str]) -> None:
    TALLY[(_PHASE[-1], kind, axis or "world")] += 1


# -- groups and the host-staging helper ----------------------------------------


def group_ranks(mesh, axis: Optional[str], coords=None) -> List[int]:
    """Ranks of the mesh (cell ids, row-major) in the group of ``axis``
    through cell ``coords`` (default: this rank's), in group order;
    ``mesh.ranks.global_of`` maps one to its global rank (the same
    number on a world mesh)."""
    gx, gy = mesh.grid
    i, j = coords if coords is not None else mesh.ranks.coords
    if axis == "x":
        return [ii * gy + j for ii in range(gx)]
    if axis == "y":
        return [i * gy + jj for jj in range(gy)]
    return list(range(gx * gy))


def host_staged(name: str, mesh, call, ins: Sequence[Tensor],
                outs: Sequence[Tensor]) -> None:
    """Run ``call(ins, outs)``, one collective over ``ins`` writing
    ``outs``. Where the backend refuses CUDA tensors for ``name``
    (``mesh.ranks.host_staged``), ``call`` gets host copies and the
    results are copied back to ``outs``."""
    staged = (name in mesh.ranks.host_staged
              and any(t.is_cuda for t in list(ins) + list(outs)))
    with warnings.catch_warnings():
        # torch 2.13 renames *_into_tensor / *_tensor; older cards' torch
        # has only these names
        warnings.simplefilter("ignore", FutureWarning)
        if not staged:
            call(list(ins), list(outs))
            return
        h_in = [t.detach().cpu() for t in ins]
        h_out = [torch.empty(t.shape, dtype=t.dtype) for t in outs]
        call(h_in, h_out)
        for o, h in zip(outs, h_out):
            o.copy_(h)


def _group(mesh, axis):
    return mesh.ranks.group(axis)


def all_gather(t: Tensor, mesh, axis: Optional[str], dim: int = 0,
               kind: str = "all_gather") -> Tensor:
    """The group's shards of ``t`` concatenated along ``dim`` in group
    order (``jax.lax.all_gather(..., tiled=True)``), counted as
    ``kind``."""
    n = len(group_ranks(mesh, axis))
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    host_staged("all_gather", mesh,
                lambda i, o: dist.all_gather_into_tensor(
                    o[0], i[0], group=_group(mesh, axis)), [t], [out])
    _count(kind, axis)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n, 0), dim=dim)


def reduce_scatter(t: Tensor, mesh, axis: Optional[str], dim: int = 0
                   ) -> Tensor:
    """Sum ``t`` over the group and keep this rank's ``dim`` block
    (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""
    n = len(group_ranks(mesh, axis))
    src = t if dim == 0 else t.transpose(0, dim)
    src = src.contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    host_staged("reduce_scatter", mesh,
                lambda i, o: dist.reduce_scatter_tensor(
                    o[0], i[0], group=_group(mesh, axis)), [src], [out])
    _count("reduce_scatter", axis)
    return out if dim == 0 else out.transpose(0, dim)


def all_reduce(t: Tensor, mesh, op=dist.ReduceOp.SUM,
               axis: Optional[str] = None,
               kind: str = "all_reduce") -> Tensor:
    """In-place sum (or ``op``) of ``t`` over the group, counted as
    ``kind``; returns ``t``."""
    def call(i, o):
        if o[0] is not i[0]:
            o[0].copy_(i[0])
        dist.all_reduce(o[0], op=op, group=_group(mesh, axis))

    host_staged("all_reduce", mesh, call, [t], [t])
    _count(kind, axis)
    return t


def broadcast_object(obj, mesh, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled over the mesh's
    world group; ``src`` is a rank of the mesh, mapped to its global
    rank): how every rank agrees on a measured choice."""
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks.global_of(src),
                               group=_group(mesh, None))
    _count("broadcast", None)
    return box[0]


def gather_objects(obj, mesh) -> list:
    """Every rank's ``obj`` (pickled), in rank order, on every rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=_group(mesh, None))
    _count("gather_object", None)
    return out


def barrier(mesh) -> None:
    dist.barrier(group=_group(mesh, None))


def shift(t: Tensor, mesh, axis: str, step: int = -1) -> Tensor:
    """Rotate ``t`` one place along ``axis``: the rank at group position
    c sends to (c + step) mod g and receives from (c - step) mod g
    (``jax.lax.ppermute``), posted as one isend/irecv pair per rank."""
    ranks = group_ranks(mesh, axis)
    g = len(ranks)
    me = ranks.index(mesh.ranks.rank)
    dst, src = (mesh.ranks.global_of(ranks[(me + step) % g]),
                mesh.ranks.global_of(ranks[(me - step) % g]))
    t = t.contiguous()
    out = torch.empty_like(t)

    def call(i, o):
        ops = [dist.P2POp(dist.isend, i[0], dst),
               dist.P2POp(dist.irecv, o[0], src)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    host_staged("p2p", mesh, call, [t], [out])
    _count("p2p", axis)
    return out


def _all_to_all(pieces: List[Tensor], recv_numel: List[int], mesh,
                axis: Optional[str], like: Tensor) -> List[Tensor]:
    """One ``all_to_all_single``: ``pieces[k]`` (flat) goes to group
    member k; returns the flat pieces received, member k's
    ``recv_numel[k]`` elements each."""
    send = (torch.cat([p.reshape(-1) for p in pieces]) if pieces
            else like.new_empty(0))
    recv = like.new_empty(sum(recv_numel))
    in_splits = [p.numel() for p in pieces]

    host_staged("all_to_all", mesh,
                lambda i, o: dist.all_to_all_single(
                    o[0], i[0], output_split_sizes=recv_numel,
                    input_split_sizes=in_splits,
                    group=_group(mesh, axis)), [send], [recv])
    _count("all_to_all", axis)
    return list(recv.split(recv_numel))


def probe_host_staging(mesh) -> frozenset:
    """Which collectives must stage CUDA tensors through host memory on
    this backend: each of :data:`PROBED` is run once on small CUDA
    tensors with known values and kept native only where it runs and
    gives them on every rank (the ranks agree by an all-reduce of host
    flags). Point-to-point is always staged."""
    ranks, dev = mesh.ranks, mesh.device
    p, r = ranks.world_size, ranks.rank
    world = ranks.group(None)

    def ok(name) -> bool:
        v = torch.full((2,), float(r + 1), device=dev)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                if name == "all_gather":
                    o = torch.empty(2 * p, device=dev)
                    dist.all_gather_into_tensor(o, v, group=world)
                    want = torch.arange(1, p + 1, device=dev
                                        ).repeat_interleave(2).float()
                elif name == "reduce_scatter":
                    v = torch.full((p,), float(r + 1), device=dev)
                    o = torch.empty(1, device=dev)
                    dist.reduce_scatter_tensor(o, v, group=world)
                    want = torch.full((1,), p * (p + 1) / 2, device=dev)
                elif name == "all_to_all":
                    v = torch.arange(p, device=dev).float() + 10 * r
                    o = torch.empty(p, device=dev)
                    dist.all_to_all_single(o, v, group=world)
                    want = torch.arange(p, device=dev).float() * 10 + r
                elif name == "all_reduce":
                    o = v.clone()
                    dist.all_reduce(o, group=world)
                    want = torch.full((2,), p * (p + 1) / 2, device=dev)
                else:
                    o = v.clone()
                    dist.broadcast(o, 0, group=world)
                    want = torch.full((2,), 1.0, device=dev)
            good = bool(torch.equal(o, want))
        except (RuntimeError, ValueError):
            good = False
        flag = torch.tensor([1.0 if good else 0.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=world)
        return bool(flag.item() == 1.0)

    return frozenset(["p2p"] + [n for n in PROBED if not ok(n)])


# -- layouts and shards ----------------------------------------------------------


def layout_of(spec, mesh) -> Layout:
    """A state name, a ``PartitionSpec`` (mesh axis names) or a layout →
    layout."""
    from matrel_tpu_torch.core.mesh import P
    if isinstance(spec, str):
        return STATES[spec]
    if not isinstance(spec, P):
        return spec
    ids = dict(zip(mesh.axis_names, ("x", "y")))

    def dim(entry) -> Tuple[str, ...]:
        if entry is None:
            return ()
        names = entry if isinstance(entry, tuple) else (entry,)
        return tuple(ids[n] for n in names)

    entries = tuple(spec) + (None,) * (2 - len(spec))
    return dim(entries[0]), dim(entries[1])


def _block(axes, coords, grid) -> Tuple[int, int]:
    idx, cnt = 0, 1
    for a in axes:
        k = 0 if a == "x" else 1
        idx, cnt = idx * grid[k] + coords[k], cnt * grid[k]
    return idx, cnt


def divisible(layout: Layout, pshape, grid) -> bool:
    """Does ``layout`` cut a ``pshape`` matrix into equal blocks?"""
    return all(pshape[d] % _block(layout[d], (0, 0), grid)[1] == 0
               for d in (0, 1))


def rect(layout: Layout, coords, grid, pshape) -> Tuple[int, int, int, int]:
    """(r0, r1, c0, c1) of the block cell ``coords`` holds."""
    out = []
    for d in (0, 1):
        idx, cnt = _block(layout[d], coords, grid)
        size = pshape[d] // cnt
        out += [idx * size, (idx + 1) * size]
    return tuple(out)


def _cells(grid):
    return [(i, j) for i in range(grid[0]) for j in range(grid[1])]


def _meet(a, b):
    r0, r1 = max(a[0], b[0]), min(a[1], b[1])
    c0, c1 = max(a[2], b[2]), min(a[3], b[3])
    return (r0, r1, c0, c1) if r0 < r1 and c0 < c1 else None


def _area(r) -> int:
    return (r[1] - r[0]) * (r[3] - r[2])


def _within(inner, outer) -> bool:
    return (outer[0] <= inner[0] and inner[1] <= outer[1]
            and outer[2] <= inner[2] and inner[3] <= outer[3])


@dataclasses.dataclass
class Shard:
    """This rank's block ``local`` of a ``pshape`` matrix laid out as
    ``layout``."""

    local: Tensor
    layout: Layout
    pshape: Tuple[int, int]

    def t(self) -> "Shard":
        """The transpose: a local transpose and the layout's dims
        swapped — no data moves."""
        return Shard(self.local.T, (self.layout[1], self.layout[0]),
                     (self.pshape[1], self.pshape[0]))

    def to(self, dtype) -> "Shard":
        """The block cast to ``dtype`` (the same layout)."""
        return Shard(self.local.to(dtype), self.layout, self.pshape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def local_of(full: Tensor, layout: Layout, mesh) -> Tensor:
    """This rank's block of a whole ``full`` matrix."""
    r0, r1, c0, c1 = rect(layout, mesh.ranks.coords, mesh.grid,
                          tuple(full.shape))
    return full[r0:r1, c0:c1]


def shard_from_full(full: Tensor, layout, mesh) -> Shard:
    """Every rank holds ``full``: keep this rank's block of it laid out
    as ``layout`` (anything :func:`layout_of` reads; no collective)."""
    lay = layout_of(layout, mesh)
    return Shard(local_of(full, lay, mesh).contiguous(), lay,
                 tuple(full.shape))


def _move_kind(src: Layout, dst: Layout, pshape, mesh):
    """("slice" | "all_to_all" | "all_gather", axis) of the src→dst move,
    the same on every rank."""
    grid = mesh.grid
    cells = _cells(grid)
    s = {c: rect(src, c, grid, pshape) for c in cells}
    d = {c: rect(dst, c, grid, pshape) for c in cells}
    if all(_within(d[c], s[c]) for c in cells):
        return "slice", None
    partition = (sorted(src[0] + src[1]) == ["x", "y"]
                 and sorted(dst[0] + dst[1]) == ["x", "y"])
    for axis in ("y", "x", None):
        if partition:
            fits = all(
                set(q for q in cells if _meet(s[q], d[c]) is not None)
                | set(q for q in cells if _meet(s[c], d[q]) is not None)
                <= set(divmod(r, grid[1])
                       for r in group_ranks(mesh, axis, c))
                for c in cells)
            if fits:
                return "all_to_all", axis
        else:
            def covered(c):
                held = {s[divmod(r, grid[1])]
                        for r in group_ranks(mesh, axis, c)}
                got = sum(_area(m) for m in (_meet(h, d[c]) for h in held)
                          if m is not None)
                return got == _area(d[c])
            if all(covered(c) for c in cells):
                return "all_gather", axis
    raise AssertionError("the world group holds every block")


def relay(x: Shard, dst, mesh) -> Shard:
    """``x`` re-laid as ``dst`` (a layout or a state name); the entries
    never change. See the module docstring for the moves."""
    dst = layout_of(dst, mesh)
    if x.layout == dst:
        return x
    pshape, grid = x.pshape, mesh.grid
    if not divisible(dst, pshape, grid):
        raise ValueError(f"layout {dst} does not divide {pshape} on a "
                         f"{grid} grid")
    kind, axis = _move_kind(x.layout, dst, pshape, mesh)
    me = mesh.ranks.coords
    mine = rect(x.layout, me, grid, pshape)
    want = rect(dst, me, grid, pshape)
    if kind == "slice":
        loc = x.local[want[0] - mine[0]:want[1] - mine[0],
                      want[2] - mine[2]:want[3] - mine[2]]
        return Shard(loc.contiguous(), dst, pshape)
    members = [divmod(r, grid[1]) for r in group_ranks(mesh, axis)]
    out = x.local.new_empty((want[1] - want[0], want[3] - want[2]))

    def place(piece: Tensor, src_rect):
        m = _meet(src_rect, want)
        out[m[0] - want[0]:m[1] - want[0], m[2] - want[2]:m[3] - want[2]] \
            = piece[m[0] - src_rect[0]:m[1] - src_rect[0],
                    m[2] - src_rect[2]:m[3] - src_rect[2]]

    if kind == "all_to_all":
        pieces, recv = [], []
        for q in members:
            m = _meet(mine, rect(dst, q, grid, pshape))
            pieces.append(x.local.new_empty(0) if m is None else
                          x.local[m[0] - mine[0]:m[1] - mine[0],
                                  m[2] - mine[2]:m[3] - mine[2]])
            m2 = _meet(rect(x.layout, q, grid, pshape), want)
            recv.append(0 if m2 is None else _area(m2))
        got = _all_to_all(pieces, recv, mesh, axis, x.local)
        for q, flat in zip(members, got):
            m = _meet(rect(x.layout, q, grid, pshape), want)
            if m is not None:
                out[m[0] - want[0]:m[1] - want[0],
                    m[2] - want[2]:m[3] - want[2]] = flat.view(
                        m[1] - m[0], m[3] - m[2])
        return Shard(out, dst, pshape)
    gathered = all_gather(x.local, mesh, axis, dim=0).chunk(len(members), 0)
    for q, piece in zip(members, gathered):
        r = rect(x.layout, q, grid, pshape)
        if _meet(r, want) is not None:
            place(piece, r)
    return Shard(out, dst, pshape)


def block_rect(x: Shard, mesh) -> Tuple[int, int, int, int]:
    """(r0, r1, c0, c1): the global offsets and extent of this rank's
    block of ``x``."""
    return rect(x.layout, mesh.ranks.coords, mesh.grid, x.pshape)


def group_axis(axes) -> Optional[str]:
    """The group whose ranks hold the blocks a dim cut over ``axes``
    splits: "x", "y", None for the world (both axes), or "none" when
    ``axes`` is empty (every rank holds the whole dim)."""
    axes = set(axes)
    if not axes:
        return "none"
    if axes == {"x", "y"}:
        return None
    return axes.pop()


def axis_reduce(t: Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> Tensor:
    """``t`` reduced over the ranks that split a dim cut over ``axes``
    (:func:`group_axis`; nothing moves for empty ``axes``), counted as
    ``axis_reduce``. gloo reduces no bool: a bool ``t`` goes as
    uint8."""
    axis = group_axis(axes)
    if axis == "none":
        return t
    if t.dtype == torch.bool:
        return all_reduce(t.to(torch.uint8), mesh, op, axis,
                          "axis_reduce").to(torch.bool)
    return all_reduce(t, mesh, op, axis, "axis_reduce")


def share_gather(t: Tensor, mesh) -> Tensor:
    """Every rank's equal share of a result along dim 0, concatenated in
    rank order on every rank: one all-gather over the world, counted as
    ``share_gather``."""
    return all_gather(t, mesh, None, kind="share_gather")


def gather_full(x: Shard, mesh) -> Tensor:
    """The whole matrix on every rank (``relay`` to "rep")."""
    return relay(x, "rep", mesh).local
