"""Staged-reshard planning — the counterpart of
``matrel_tpu/parallel/reshard.py`` (memory-efficient array
redistribution, arXiv:2112.01075).

``compile_reshard`` decomposes a src→dst layout change on the mesh's
(virtual) grid into an explicit step sequence — per-axis
``all_to_all`` for shard↔shard moves, per-axis ``gather`` stages for
replication, ``slice`` for replication-dropping moves, and the legacy
single-shot move (``oneshot``) where it is both cheapest and feasible —
each step with its per-axis bytes and its peak per-device footprint.
The byte accounting is the planner's own closed-form float arithmetic,
so an unconstrained plan's cost is bit-identical to the closed forms; a
``peak_budget`` forces the bounded decomposition and its honestly
higher staged bill.

The knob is ``config.reshard_peak_budget_bytes``: 0 (the default)
constructs no ReshardPlan at all; > 0 caps the peak per-device bytes
live during any reshard step. The planner prices join re-lays from the
plans (``planner._reshard_to_axis``), ``matmul_decisions`` records the
moves (``moves_record``), and the executor compiles them for every
dense matmul and plan root. On one card :func:`apply_staged` has
nothing to move: every layout state holds the whole tensor; on a rank
mesh it moves the blocks step by step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from matrel_tpu_torch.utils.profiling import annotate

#: Public layout vocabulary a reshard plan moves between — the
#: planner's layout model (planner.LAYOUTS minus "other", which is
#: costed like "2d" per the LAYOUTS contract and normalised here).
RESHARD_LAYOUTS = ("2d", "row", "col", "rep")

#: Internal states a staged plan may pass through: the public vocabulary
#: plus the partially-replicated gather stages ("rowx" = P(x, None) —
#: replicated along y; "coly" = P(None, y)).
_STATES = RESHARD_LAYOUTS + ("rowx", "coly")

#: Step vocabulary (in the JAX package each kind lowers under one
#: ``annotate`` label, ``matrel.reshard:<kind>``):
#:   all_to_all  single-axis shard↔shard redistribution (row↔2d on y,
#:               col↔2d on x) — peak 2 shards, never a full gather
#:   gather      single-axis all-gather raising replication (2d→rowx
#:               on y, rowx→rep on x, …)
#:   slice       replication-dropping move (rep→anything): every device
#:               already holds its target shard; zero bytes on the wire
#:   oneshot     the legacy single-constraint move across BOTH axes
#:               (row↔col) — XLA's own lowering, modelled conservatively
#:               as gather-then-slice (transient full array)
#:   host        one HBM↔host-RAM transfer leg of the spill hierarchy
#:               (docs/DURABILITY.md) — d2h on demotion, h2d on
#:               promotion; the device-side transient is the staging
#:               buffer, so ``peak_bytes`` is the entry's device bytes
#:   disk        one host-RAM↔disk leg (the checkpoint-format artifact
#:               write/read) — zero DEVICE bytes live during the step,
#:               so it never charges the peak-HBM budget
STEP_KINDS = ("all_to_all", "gather", "slice", "oneshot",
              "host", "disk")

#: Tier vocabulary of the result-cache spill hierarchy, ordered top to
#: bottom. ``spill_plan`` stages any demotion/promotion as one step
#: per ADJACENT-tier hop — an HBM↔disk move always stages through host
#: RAM (the arXiv:2112.01075 discipline: never materialise a second
#: device-resident copy to skip a tier).
SPILL_TIERS = ("hbm", "host", "disk")


@dataclasses.dataclass(frozen=True)
class ReshardStep:
    """One move of a staged redistribution. ``bytes_x``/``bytes_y`` are
    the per-device bytes the step moves over each mesh axis (raw,
    pre-weight — the unit ``matmul_decisions``/obs record);
    ``peak_bytes`` is the per-device bytes live DURING the step (source
    shard + destination buffer + any transient gather), the quantity
    ``config.reshard_peak_budget_bytes`` bounds (the JAX package's
    verifier, MV109, proves it)."""

    kind: str
    axis: Optional[str]          # "x" / "y" / None (slice, oneshot)
    src_state: str
    dst_state: str
    bytes_x: float
    bytes_y: float
    peak_bytes: float


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """A compiled src→dst redistribution: the verified step sequence
    plus its exact accounting. ``weighted_cost`` is the per-device
    weighted byte bill (bytes × the topology weight of the axis each
    step rides) the planner prices the move at — bit-identical to the
    legacy closed forms on a uniform mesh when the budget does not
    force staging. ``naive_peak_bytes`` is the modelled peak of the
    legacy ONE-SHOT move for the same pair, the number the staged
    plan's ``peak_bytes`` is the improvement over."""

    src: str
    dst: str
    nbytes: float                # full (padded) array bytes
    grid: Tuple[int, int]
    weights: Tuple[float, float]
    steps: Tuple[ReshardStep, ...]
    weighted_cost: float
    naive_peak_bytes: float

    @property
    def bytes_x(self) -> float:
        return sum(s.bytes_x for s in self.steps)

    @property
    def bytes_y(self) -> float:
        return sum(s.bytes_y for s in self.steps)

    @property
    def peak_bytes(self) -> float:
        return max((s.peak_bytes for s in self.steps), default=0.0)

    @property
    def step_kinds(self) -> Tuple[str, ...]:
        return tuple(s.kind for s in self.steps)

    def fits(self, peak_budget: float) -> bool:
        """Does the plan's peak respect a budget? Budget <= 0 means
        unbounded (always fits)."""
        return peak_budget <= 0 or self.peak_bytes <= peak_budget

    def to_dict(self) -> dict:
        """The stampable/loggable record (``attrs["reshard"]``, obs
        decision records, MV109's hand-stamp surface)."""
        return {"src": self.src, "dst": self.dst,
                "nbytes": self.nbytes,
                "steps": list(self.step_kinds),
                "bytes_by_axis": [self.bytes_x, self.bytes_y],
                "peak_bytes": self.peak_bytes}


def normalize_layout(layout: str) -> Optional[str]:
    """Planner layout string → reshard vocabulary, or None for layouts
    the plan compiler does not own ("other" is costed like "2d" per the
    planner.LAYOUTS contract, so it compiles as "2d")."""
    if layout == "other":
        return "2d"
    return layout if layout in RESHARD_LAYOUTS else None


def _resident(state: str, nbytes: float, gx: int, gy: int) -> float:
    """Per-device resident bytes of a layout state."""
    p = max(gx * gy, 1)
    if state == "rep":
        return nbytes
    if state == "rowx":
        return nbytes / gx
    if state == "coly":
        return nbytes / gy
    return nbytes / p            # 2d / row / col all shard p ways


def _a2a_step(src: str, dst: str, axis: str, nbytes: float,
              gx: int, gy: int) -> ReshardStep:
    """Single-axis all_to_all between p-resident layouts. The byte
    expression is VERBATIM the planner's ``_to_2d_reshard`` /
    ``_reshard_to_axis`` perpendicular-gather closed form, so uniform-
    mesh costs stay bit-identical."""
    p = max(gx * gy, 1)
    g = gy if axis == "y" else gx
    moved = (nbytes / p) * (1 - 1 / g)
    peak = 2.0 * (nbytes / p)    # send shard + receive shard
    return ReshardStep("all_to_all", axis, src, dst,
                       moved if axis == "x" else 0.0,
                       moved if axis == "y" else 0.0, peak)


def _gather_steps(src: str, nbytes: float, gx: int, gy: int,
                  wx: float, wy: float
                  ) -> Tuple[Tuple[ReshardStep, ...], float]:
    """(steps, weighted cost) replicating ``src`` everywhere: one
    gather stage per mesh axis, the stage ORDER (and therefore which
    axis carries the big late stage) chosen exactly the way the
    planner's ``_split_full_mesh`` closed form prices it — the
    expensive axis rides the small FIRST stage, uniform weights keep
    the flat bill's float arithmetic bit-identically (y-first
    attribution)."""
    from matrel_tpu_torch.parallel.planner import _split_full_mesh
    p = gx * gy
    cost, bx, by = _split_full_mesh(nbytes, gx, gy, wx, wy)
    # which order did the split pick? y-first puts the small stage on y
    # (by == src*(gy-1)/p); x-first mirrors it. Uniform weights always
    # attribute y-first (the split's documented convention).
    y_first = by == nbytes * (gy - 1) / p
    if y_first:
        mid = "rowx"
        s1 = ReshardStep("gather", "y", src, mid, 0.0, by,
                         _resident(src, nbytes, gx, gy)
                         + _resident(mid, nbytes, gx, gy))
        s2 = ReshardStep("gather", "x", mid, "rep", bx, 0.0,
                         _resident(mid, nbytes, gx, gy) + nbytes)
    else:
        mid = "coly"
        s1 = ReshardStep("gather", "x", src, mid, bx, 0.0,
                         _resident(src, nbytes, gx, gy)
                         + _resident(mid, nbytes, gx, gy))
        s2 = ReshardStep("gather", "y", mid, "rep", 0.0, by,
                         _resident(mid, nbytes, gx, gy) + nbytes)
    return (s1, s2), cost


def naive_peak_bytes(src: str, dst: str, nbytes: float,
                     gx: int, gy: int) -> float:
    """Modelled peak per-device bytes of the LEGACY one-shot move (a
    single sharding constraint, XLA's own collective choice). Single-
    axis moves lower as an all_to_all (peak 2 shards); any move that
    crosses both mesh axes or raises replication is modelled as
    gather-then-slice — the full array lives as a transient, which is
    exactly the footprint that makes near-HBM operands unmovable and
    the reason this module exists. Conservative on purpose: the budget
    must hold for the worst one-shot lowering, not the luckiest."""
    p = max(gx * gy, 1)
    src_n = normalize_layout(src) or "2d"
    dst_n = normalize_layout(dst) or "2d"
    if src_n == dst_n or p == 1 or src_n == "rep":
        return _resident(dst_n, nbytes, gx, gy)
    single_axis = (frozenset((src_n, dst_n)) in
                   (frozenset(("row", "2d")), frozenset(("col", "2d"))))
    if single_axis:
        return 2.0 * (nbytes / p)
    if dst_n == "rep":
        return _resident(src_n, nbytes, gx, gy) + nbytes
    # cross-axis (row<->col): gather-then-slice transient
    return _resident(src_n, nbytes, gx, gy) + nbytes \
        + _resident(dst_n, nbytes, gx, gy)


def compile_reshard(src: str, dst: str, nbytes: float,
                    gx: int, gy: int,
                    weights: Tuple[float, float] = (1.0, 1.0),
                    peak_budget: float = 0.0) -> ReshardPlan:
    """Compile one src→dst redistribution into its cheapest step
    sequence whose peak fits ``peak_budget`` (<= 0 = unbounded: the
    min-bytes decomposition, cost bit-identical to the legacy closed
    forms). When NO decomposition fits the budget the min-peak plan is
    returned anyway — ``plan.fits(budget)`` is False and MV109 turns
    that into a diagnostic; compile never raises on a hard move.

    The candidate set per pair (docs/RESHARD.md has the derivation):

      same layout        []               (nothing moves)
      rep → L            [slice]          (every device already holds L)
      row↔2d, col↔2d     [all_to_all]     (the single-axis move)
      row↔col            [oneshot]        legacy direct move — fewest
                                          bytes (the ``_split_full_mesh``
                                          bill) but full-gather peak; OR
                         [a2a, a2a]       via 2d — more bytes, peak
                                          2·shard (the bounded plan)
      L → rep            [gather, gather] per-axis stages, order chosen
                                          by the topology weights
    """
    wx, wy = weights
    p = gx * gy
    src_n = normalize_layout(src)
    dst_n = normalize_layout(dst)
    if src_n is None or dst_n is None:
        raise ValueError(
            f"reshard endpoints must be in {RESHARD_LAYOUTS} (or "
            f"'other'), got {src!r} -> {dst!r}")
    nbytes = float(nbytes)

    def plan(steps, cost) -> ReshardPlan:
        return ReshardPlan(src_n, dst_n, nbytes, (gx, gy), (wx, wy),
                           tuple(steps), cost,
                           naive_peak_bytes(src_n, dst_n, nbytes, gx,
                                            gy))

    if src_n == dst_n or p <= 1:
        return plan((), 0.0)
    if src_n == "rep":
        return plan((ReshardStep("slice", None, "rep", dst_n, 0.0, 0.0,
                                 _resident(dst_n, nbytes, gx, gy)),),
                    0.0)
    # single-axis pairs — one all_to_all, no alternative needed
    if frozenset((src_n, dst_n)) == frozenset(("row", "2d")):
        s = _a2a_step(src_n, dst_n, "y", nbytes, gx, gy)
        return plan((s,), s.bytes_y * wy)
    if frozenset((src_n, dst_n)) == frozenset(("col", "2d")):
        s = _a2a_step(src_n, dst_n, "x", nbytes, gx, gy)
        return plan((s,), s.bytes_x * wx)
    if dst_n == "rep":
        steps, cost = _gather_steps(src_n, nbytes, gx, gy, wx, wy)
        return plan(steps, cost)
    # cross-axis: row <-> col
    from matrel_tpu_torch.parallel.planner import _split_full_mesh
    direct_cost, dbx, dby = _split_full_mesh(nbytes / p, gx, gy, wx, wy)
    direct = (ReshardStep("oneshot", None, src_n, dst_n, dbx, dby,
                          naive_peak_bytes(src_n, dst_n, nbytes, gx,
                                           gy)),)
    s1 = _a2a_step(src_n, "2d", "y" if src_n == "row" else "x",
                   nbytes, gx, gy)
    s2 = _a2a_step("2d", dst_n, "y" if dst_n == "row" else "x",
                   nbytes, gx, gy)
    staged = (s1, s2)
    staged_cost = s1.bytes_x * wx + s1.bytes_y * wy \
        + s2.bytes_x * wx + s2.bytes_y * wy
    cands = [(direct, direct_cost), (staged, staged_cost)]
    fitting = [c for c in cands
               if peak_budget <= 0
               or max(s.peak_bytes for s in c[0]) <= peak_budget]
    pool = fitting or cands
    # min weighted cost among fitting candidates; when nothing fits,
    # min PEAK (the closest-to-feasible plan, for MV109 to report)
    if fitting:
        steps, cost = min(pool, key=lambda c: c[1])
    else:
        steps, cost = min(pool,
                          key=lambda c: max(s.peak_bytes for s in c[0]))
    return plan(steps, cost)


def spill_plan(src_tier: str, dst_tier: str, nbytes: float,
               peak_budget: float = 0.0) -> ReshardPlan:
    """Compile one tier demotion/promotion of the result-cache spill
    hierarchy into the step vocabulary — the same ReshardPlan record
    the layout moves use, so MV117 proves spill stamps with the MV109
    machinery and ``plan.fits`` charges the device transient against
    the SAME ``reshard_peak_budget_bytes`` the layout moves respect.

    One step per adjacent-tier hop: ``hbm↔host`` is a ``host`` step
    (peak = the entry's device bytes — the staging buffer),
    ``host↔disk`` is a ``disk`` step (zero device bytes). Step
    ``src_state``/``dst_state`` carry TIER names, not layouts — the
    spill steps never reach ``apply_staged`` (numpy/file IO, not a
    sharding constraint). ``bytes_x`` carries each leg's payload
    bytes (no mesh axis is involved); ``weighted_cost`` is the total
    payload — pricing in milliseconds is the coefficient seam's job
    (``coeffs.spill_cost_ms``), not the topology weights'."""
    if src_tier not in SPILL_TIERS or dst_tier not in SPILL_TIERS:
        raise ValueError(
            f"spill endpoints must be in {SPILL_TIERS}, "
            f"got {src_tier!r} -> {dst_tier!r}")
    nbytes = float(nbytes)
    i, j = SPILL_TIERS.index(src_tier), SPILL_TIERS.index(dst_tier)
    step_dir = 1 if j >= i else -1
    steps = []
    for k in range(i, j, step_dir):
        a, b = SPILL_TIERS[k], SPILL_TIERS[k + step_dir]
        kind = "host" if "hbm" in (a, b) else "disk"
        steps.append(ReshardStep(
            kind, None, a, b, nbytes, 0.0,
            nbytes if kind == "host" else 0.0))
    return ReshardPlan(src_tier, dst_tier, nbytes, (1, 1), (1.0, 1.0),
                       tuple(steps), nbytes * len(steps),
                       naive_peak_bytes=nbytes)


def spill_leg(step: ReshardStep) -> str:
    """A spill step → the coefficient-seam leg token it is priced by
    (``coeffs.SPILL_LEGS``; drift calibrates ``spill:<leg>`` rows):
    direction matters — d2h and h2d ride different DMA paths, disk
    read and write different IO paths."""
    if step.kind == "host":
        return "d2h" if step.src_state == "hbm" else "h2d"
    if step.kind == "disk":
        return "disk_write" if step.dst_state == "disk" else "disk_read"
    raise ValueError(f"not a spill step: {step.kind!r}")


#: Layout each strategy's shard_map in_specs CONSUME an operand at,
#: phrased in the reshard vocabulary, or None where the consumed spec
#: is a partial replication the strategy's own in_spec gather performs
#: (bmm's broadcast side, rmm's per-axis replication) — those are the
#: strategy's working set (MV105's domain), not a reshard. ONE mapping
#: shared by the executor's staged lowering, matmul_decisions' records
#: and MV109, so the three can never disagree about which moves run.
STRATEGY_CONSUMED = {
    "bmm_right": ("row", None),
    "bmm_left": (None, "col"),
    "cpmm": ("2d", None),
    "summa": ("2d", "2d"),
    "rmm": (None, None),
    "xla": (None, None),
    "spgemm": (None, None),
}


def strategy_moves(strategy: str) -> Tuple[Optional[str], Optional[str]]:
    """(dst layout for operand A, for operand B) a strategy's lowering
    re-lays its inputs to — the moves the staged reshard path owns."""
    return STRATEGY_CONSUMED.get(strategy, (None, None))


def staged_matmul_moves(node, mesh, config, layout_memo=None,
                        dtype_memo=None):
    """The operand re-lays a stamped dense matmul's STAGED lowering
    will run under this config, as ``[(operand_index, ReshardPlan)]``
    — ONE derivation shared by the executor (which applies the steps),
    ``planner.matmul_decisions`` (which records them) and MV109 (which
    proves their peaks), so the three can never disagree about which
    moves run. Empty when ``reshard_peak_budget_bytes`` is 0 (the
    default config constructs no plans at all), on a single device,
    for sparse/COO dispatches (their kernels own their layouts), for
    replicated sources (the strategy's in_spec slices those for free),
    and for padded shapes no intermediate state divides evenly."""
    budget = config.reshard_peak_budget_bytes
    if budget <= 0:
        return []
    from matrel_tpu_torch.core import mesh as mesh_lib, padding
    from matrel_tpu_torch.parallel import planner
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    if gx * gy <= 1:
        return []
    moves = strategy_moves(node.attrs.get("strategy"))
    if not any(moves):
        return []
    if any(c.kind in ("sparse_leaf", "coo_leaf") for c in node.children):
        return []
    memo = {} if layout_memo is None else layout_memo
    dmemo = {} if dtype_memo is None else dtype_memo
    wts = mesh_lib.axis_weights(mesh, config)
    out = []
    for i, dst in enumerate(moves):
        if dst is None:
            continue
        child = node.children[i]
        src = normalize_layout(
            planner.infer_layout(child, mesh, memo, config))
        if src is None or src == dst or src == "rep":
            continue
        pshape = padding.padded_shape(child.shape, mesh)
        cdt = planner.infer_dtype(child, config, dmemo)
        itemsize = cdt.itemsize if cdt is not None else 4
        nbytes = float(pshape[0]) * pshape[1] * itemsize
        plan = compile_reshard(src, dst, nbytes, gx, gy, wts,
                               peak_budget=float(budget))
        if not plan.steps or not plan_stageable(plan, pshape):
            continue
        out.append((i, plan))
    return out


def root_relay_plan(root, mesh, config, layout_memo=None,
                    dtype_memo=None) -> Optional[ReshardPlan]:
    """The ReshardPlan of a plan ROOT's canonical re-lay under this
    config (the executor constrains every root output to the canonical
    sharding — ``_root_reshard_cost``'s leg), or None when nothing
    stages: budget 0, single device, an already-canonical/replicated
    root, or a padded shape no state divides. ONE derivation shared by
    ``executor._stage_root_relay`` and MV109, the
    ``staged_matmul_moves`` contract."""
    budget = config.reshard_peak_budget_bytes
    if budget <= 0:
        return None
    from matrel_tpu_torch.core import mesh as mesh_lib, padding
    from matrel_tpu_torch.parallel import planner
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    if gx * gy <= 1:
        return None
    memo = {} if layout_memo is None else layout_memo
    dmemo = {} if dtype_memo is None else dtype_memo
    src = normalize_layout(planner.infer_layout(root, mesh, memo,
                                                config))
    if src in (None, "2d", "rep"):
        return None
    pshape = padding.padded_shape(root.shape, mesh)
    dt = planner.infer_dtype(root, config, dmemo)
    isz = dt.itemsize if dt is not None else 4
    plan = compile_reshard(src, "2d", float(pshape[0]) * pshape[1] * isz,
                           gx, gy, mesh_lib.axis_weights(mesh, config),
                           peak_budget=float(budget))
    if not plan.steps or not plan_stageable(plan, pshape):
        return None
    return plan


def moves_record(moves) -> Optional[dict]:
    """The observability record of a matmul's staged moves (the
    ``rec["reshard"]`` field of planner.matmul_decisions → obs query
    events, explain(analyze=True), the history roll-up): step kinds,
    raw per-axis bytes, and the worst per-device peak."""
    if not moves:
        return None
    return {
        "steps": [k for _i, p in moves for k in p.step_kinds],
        "bytes_by_axis": [sum(p.bytes_x for _i, p in moves),
                          sum(p.bytes_y for _i, p in moves)],
        "peak_bytes": max(p.peak_bytes for _i, p in moves),
        "moves": [{"operand": i, "src": p.src, "dst": p.dst}
                  for i, p in moves],
    }


# ---------------------------------------------------------------------------
# Execution — a local copy on one card, the step's move on a rank mesh
# ---------------------------------------------------------------------------


def _state_spec(state: str, mesh):
    """PartitionSpec of a layout state on ``mesh`` (layout metadata the
    planner reads; nothing is sharded on one card)."""
    from matrel_tpu_torch.core.mesh import P
    x, y = mesh.axis_names
    return {"2d": P(x, y), "row": P((x, y), None),
            "col": P(None, (x, y)), "rep": P(),
            "rowx": P(x, None), "coly": P(None, y)}[state]


def _state_divisible(state: str, pshape, gx: int, gy: int) -> bool:
    p = gx * gy
    if state == "rep":
        return True
    if state == "row":
        return pshape[0] % p == 0
    if state == "col":
        return pshape[1] % p == 0
    if state == "rowx":
        return pshape[0] % gx == 0
    if state == "coly":
        return pshape[1] % gy == 0
    return pshape[0] % gx == 0 and pshape[1] % gy == 0   # 2d


def plan_stageable(plan: ReshardPlan, pshape) -> bool:
    """Can every intermediate state of the plan actually shard this
    padded shape evenly? Size-1 (vector) dims stay unpadded
    (padding.py), so vector moves keep the legacy path."""
    gx, gy = plan.grid
    states = [plan.src] + [s.dst_state for s in plan.steps]
    return all(_state_divisible(st, pshape, gx, gy) for st in states)


def apply_staged(arr, plan: ReshardPlan, mesh):
    """Run a compiled plan's steps over ``arr``. On one card every layout
    state holds the whole tensor, so each step is a local copy and the
    value is ``arr`` itself (the plan is still compiled and recorded:
    stamps, prices and decision records equal the JAX package's). On a
    rank mesh ``arr`` is a ``collectives.Shard`` and each step is its real
    move to the step's state (``collectives.relay``: the all_to_all on
    the step's axis, the gather, or the slice); the entries never
    change. On a rank mesh each step's move runs under its profiler
    range ``matrel.reshard:<kind>`` (``utils/profiling.annotate``)."""
    if not getattr(mesh, "ranked", False):
        return arr
    from matrel_tpu_torch.parallel import collectives as coll
    if not isinstance(arr, coll.Shard):          # a whole value: rep
        arr = coll.Shard(arr, coll.STATES["rep"], tuple(arr.shape))
    for step in plan.steps:
        with annotate(f"matrel.reshard:{step.kind}"):
            arr = coll.relay(arr, step.dst_state, mesh)
    return arr
