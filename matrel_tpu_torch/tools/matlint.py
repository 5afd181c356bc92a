"""matlint — AST linter for the port's own hazard classes (the
source-level half of its static analysis; the plan-level half is
``matrel_tpu_torch/analysis/``). The port of the JAX package's
``tools/matlint.py``: the same ``Finding`` / ``Rule`` / ``lint_file`` /
``lint_paths`` shape, the same codes, the same suppression syntax.

Generic linters cannot know that a ``torch.cuda.synchronize`` inside the
executor's lowering is a query-hot-path sync regression, that a
``to_dense`` inside a sparse dispatch module voids the SpGEMM no-densify
guarantee, or that a ``dist.all_gather`` outside the collectives seam is
an exchange nobody tallies. matlint pins them.

Usage (a static pass over the source: no device is touched):
    python -m matrel_tpu_torch.tools.matlint               # default scan set, rc 1 on findings
    python -m matrel_tpu_torch.tools.matlint path1 path2   # explicit files/dirs
    python -m matrel_tpu_torch.tools.matlint --list-rules  # rule catalogue

Suppression: append ``# matlint: disable=ML001 <why>`` (comma-separated
for several codes) to the line where the flagged call STARTS, with a
justification in the same comment. The repo-wide run
(``tests/test_torch_matlint.py``, ``chip_smoke.py``'s ``path_tools``)
stays clean only through them.

Scopes. The default scan set is ``matrel_tpu_torch/`` and
``chip_smoke.py``. Rules about the library apply to
``matrel_tpu_torch/`` minus ``tools/`` and ``examples/``: those two are
the counterparts of the JAX package's root ``tools/`` and ``examples/``,
which its rules leave alone as harnesses (measurement is their output).
ML007 also covers ``chip_smoke.py``: a phase failure swallowed there
would let a broken port pass its smoke run.

Rule catalogue (each rule's class docstring is the authority). ML004–
ML007 and ML011–ML019 are the JAX rules with the module paths changed;
ML001, ML002, ML003, ML008, ML009 and ML010 keep their hazards with the
torch idiom in place of the JAX one:
  ML001  host-sync call (torch.cuda.synchronize, Event.synchronize,
         .item(), .cpu(), .tolist(), .numpy(), int/float/bool of a
         reduction) in lowering-path modules outside a CPU-only branch
  ML002  to_dense/todense inside a sparse dispatch module
  ML003  torch.distributed collective called outside
         parallel/collectives.py, the seam that tallies and states it
  ML004  direct MatrelConfig() construction inside the package
  ML005  cache dict keyed by sharding-spec-ish values
  ML006  raw wall-clock timing in library code outside obs/
  ML007  bare/broad except that silently swallows and continues
  ML008  device move (.to(<device>), .cuda()) in lowering modules
  ML009  kernel library built or loaded (ctypes.CDLL, cpp_extension,
         an nvcc subprocess, @triton.jit) outside utils/cuda_build.py
  ML010  torch.compile / torch.jit / CUDA graph capture outside the
         executor and utils/
  ML011  unbounded-queue growth idiom: deque()/queue.Queue() without a
         bound in serve/, or threading.Thread without an explicit
         daemon= anywhere in the package
  ML012  ResultCache entry payloads mutated outside the sanctioned
         patch/apply seam in serve/result_cache.py
  ML013  ad-hoc timing accumulation (append/extend onto latency-named
         lists) outside obs/
  ML014  cross-slice result-cache mutation outside the fleet API
         (serve/fleet.py)
  ML015  provenance stamp written outside obs/provenance.py
  ML016  template/CSE cache keyed by identity or spec values instead
         of the canonical structural key
  ML017  bare threading.Lock()/RLock() construction outside the
         utils/lockdep.py seam
  ML018  raw drift-table read (drift.load_table) outside the
         parallel/coeffs.py seam
  ML019  raw file IO in serve/ outside the spill/checkpoint seam
         (serve/spill.py)
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from typing import Iterator, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Default scan set. tests/ is excluded by design: tests legitimately
#: poke every hazard and carry their own review.
DEFAULT_PATHS = ("matrel_tpu_torch", "chip_smoke.py")

#: The package's harness directories: the counterparts of the JAX
#: package's root tools/ and examples/, outside its library rules.
_HARNESS = ("matrel_tpu_torch/tools/", "matrel_tpu_torch/examples/")

_SUPPRESS_RE = re.compile(r"#\s*matlint:\s*disable=([A-Za-z0-9_,\s]+)")


def _in_package(relpath: str) -> bool:
    """The library: ``matrel_tpu_torch/`` minus its harness
    directories."""
    return (relpath.startswith("matrel_tpu_torch/")
            and not relpath.startswith(_HARNESS))


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _rel(path: str) -> str:
    try:
        return os.path.relpath(path, REPO)
    except ValueError:
        return path


def _call_name(func: ast.AST) -> str:
    """Dotted tail of a call target: ``torch.cuda.synchronize`` ->
    "torch.cuda.synchronize", ``x.to_dense`` -> ".to_dense"."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        base = _call_name(func.value)
        return (base + "." if base else ".") + func.attr
    return ""


class Rule:
    """One hazard class. ``applies_to`` scopes the MODULE set (the
    hazard is contextual — the same call is fine elsewhere); ``check``
    yields findings for one parsed file."""

    id: str = "ML000"

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, relpath: str) -> Iterator[Finding]:
        raise NotImplementedError


#: Modules whose code runs on the query hot path — the executor's
#: lowering, the strategy kernels, the ops kernels, the IR/relational
#: lowerings. A host sync here stalls every query.
_LOWERING_MODULES = re.compile(
    r"^matrel_tpu_torch/(executor\.py|ops/|parallel/strategies\.py|"
    r"relational/|ir/)")


def _cpu_branch(test: ast.AST) -> bool:
    """True for an ``if`` test that holds only on the CPU:
    ``<x>.type == "cpu"`` (``x.device.type``, ``dev.type``) or
    ``not <x>.is_cuda``."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return (isinstance(test.operand, ast.Attribute)
                and test.operand.attr == "is_cuda")
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"):
        c = test.comparators[0]
        return isinstance(c, ast.Constant) and c.value == "cpu"
    return False


class HostSyncRule(Rule):
    """ML001: host-synchronising calls in lowering-path modules.

    A device sync (``torch.cuda.synchronize``, ``Event.synchronize``, the
    port's ``BlockMatrix.block_until_ready``) or a read that waits for
    the card (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, or
    ``int`` / ``float`` / ``bool`` of a reduction such as
    ``int((x > 0).sum())``; a reduction called on ``np`` / ``math`` is a
    host one and passes) on the query hot path serialises the host against the stream the whole
    lowering exists to keep full (the obs_level="off" contract: zero
    extra syncs). The vocabulary is lockcheck's LK102 device words. The
    sanctioned idiom is the CPU branch: a call inside ``if <x>.type ==
    "cpu":`` (or ``if not <x>.is_cuda:``) has no device to wait for. The
    remaining legitimate sites — the analyze-mode sync, reads that run
    once per plan or matrix and are memoised — carry inline suppressions
    saying why."""

    id = "ML001"
    _SYNC_TAILS = ("synchronize", "block_until_ready", "item", "cpu",
                   "tolist", "numpy")
    #: ``int`` / ``float`` / ``bool`` of a tensor reduction reads its
    #: value on the host as ``.item()`` does.
    _CASTS = ("int", "float", "bool")
    _REDUCTIONS = frozenset((
        "sum", "nansum", "prod", "mean", "nanmean", "max", "min", "amax",
        "amin", "argmax", "argmin", "any", "all", "count_nonzero", "norm",
        "median", "dot"))
    #: Receivers whose reductions run on host arrays or numbers.
    _HOST_RECEIVERS = ("np", "numpy", "math", "builtins")

    def applies_to(self, relpath: str) -> bool:
        return bool(_LOWERING_MODULES.match(relpath))

    def _cast_of_reduction(self, node: ast.Call) -> str:
        """``int(x.sum())``-like: the cast and the reduction, else ""."""
        if not (isinstance(node.func, ast.Name)
                and node.func.id in self._CASTS and len(node.args) == 1
                and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].func, ast.Attribute)):
            return ""
        recv, _, tail = _call_name(node.args[0].func).rpartition(".")
        if tail not in self._REDUCTIONS or recv in self._HOST_RECEIVERS:
            return ""
        return f"{node.func.id}(….{tail}())"

    def check(self, tree, relpath):
        # (node, inside a CPU-only branch)
        stack: List[tuple] = [(tree, False)]
        while stack:
            node, on_cpu = stack.pop()
            if isinstance(node, ast.Call) and not on_cpu:
                name = _call_name(node.func)
                tail = name.rsplit(".", 1)[-1]
                if tail in self._SYNC_TAILS and isinstance(node.func,
                                                           ast.Attribute):
                    yield Finding(relpath, node.lineno, self.id,
                                  f"host sync `{name}` on a lowering path "
                                  "— stalls every query (obs_level='off' "
                                  "contract)")
                cast = self._cast_of_reduction(node)
                if cast:
                    yield Finding(relpath, node.lineno, self.id,
                                  f"host read `{cast}` of a reduction on a "
                                  "lowering path — waits for the card as "
                                  ".item() does")
            if isinstance(node, ast.If) and _cpu_branch(node.test):
                stack.append((node.test, on_cpu))
                stack.extend((c, True) for c in node.body)
                stack.extend((c, on_cpu) for c in node.orelse)
                continue
            for child in ast.iter_child_nodes(node):
                stack.append((child, on_cpu))


class NoDensifyRule(Rule):
    """ML002: ``to_dense``/``todense`` inside a sparse dispatch module.

    matrel_tpu_torch/ops/ holds the kernels whose whole reason to exist is
    NOT materialising dense forms (the SpGEMM no-densify guarantee; the
    verifier's MV104 pins the dispatch side). A densify call added to one
    of these modules — a scipy ``todense``, a ``COOMatrix.to_dense``, or
    ``Tensor.to_dense`` of a torch sparse tensor — is either a bug or a
    fallback that belongs in the executor's dispatch, where the planner
    can see and price it."""

    id = "ML002"
    _TAILS = ("to_dense", "todense")

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("matrel_tpu_torch/ops/")

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                tail = _call_name(node.func).rsplit(".", 1)[-1]
                if tail in self._TAILS:
                    yield Finding(
                        relpath, node.lineno, self.id,
                        f"`{tail}` inside a sparse dispatch module — "
                        "densify fallbacks belong in the executor "
                        "dispatch where the planner prices them")


#: torch.distributed collectives: every rank of the group takes part.
_COLLECTIVES = frozenset((
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
    "all_to_all", "all_to_all_single", "send", "recv", "isend", "irecv",
    "barrier", "monitored_barrier", "all_gather_object",
    "broadcast_object_list", "gather_object", "scatter_object_list",
    "send_object_list", "recv_object_list"))


class CollectiveSeamRule(Rule):
    """ML003: a ``torch.distributed`` collective called outside
    ``parallel/collectives.py``.

    The JAX package states each collective at its ``shard_map``
    (``out_specs``); the port states it at one seam instead:
    ``parallel/collectives.py`` runs every exchange of a rank mesh, counts
    it in ``TALLY`` by (phase, kind, axis), stages CUDA tensors through
    host memory where gloo needs it, and names the group. A
    ``dist.<collective>`` called elsewhere is an exchange the tally, the
    planner's byte model and review cannot see. Matched on a ``dist`` /
    ``torch.distributed`` receiver; group construction, ranks and
    ``is_initialized`` are not collectives."""

    id = "ML003"
    _SEAM = "matrel_tpu_torch/parallel/collectives.py"

    def applies_to(self, relpath: str) -> bool:
        return relpath != self._SEAM

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            recv, _, tail = _call_name(node.func).rpartition(".")
            if tail in _COLLECTIVES and (
                    recv in ("dist", "torch.distributed")
                    or recv.endswith(".distributed")):
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"torch.distributed `{tail}` outside "
                    "parallel/collectives.py — the collective must be "
                    "stated and tallied at the one seam")



class ConfigFlowRule(Rule):
    """ML004: direct ``MatrelConfig(...)`` construction inside the
    package.

    Library code must consume the config that FLOWS to it (a ``config``
    parameter defaulting through ``default_config()``) — a fresh
    ``MatrelConfig()`` silently discards every session/env override the
    caller set (the round-2 class of bug where a module ran with
    default thresholds while the session was configured otherwise).
    Construction is for entry points: config.py itself, tests, and the
    bench/tool harnesses outside the package."""

    id = "ML004"

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath)
                and relpath != "matrel_tpu_torch/config.py")

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                tail = _call_name(node.func).rsplit(".", 1)[-1]
                if tail == "MatrelConfig":
                    yield Finding(
                        relpath, node.lineno, self.id,
                        "direct MatrelConfig() construction in library "
                        "code — accept a config parameter and default "
                        "through default_config() so session/env "
                        "overrides flow")


class SpecKeyedCacheRule(Rule):
    """ML005: cache/memo dicts keyed by sharding-spec-ish values.

    ``PartitionSpec``/``NamedSharding``/``Mesh`` objects (and ``.spec``
    attributes) make treacherous dict keys: some are unhashable, others
    hash by identity across semantically-equal instances, and a
    library upgrade can flip either property — turning a cache into a
    permanent miss (rebuild storm) or, worse, an identity-aliased hit.
    Key caches by the STABLE tuple you derive from the spec (axis
    names, grid shape, padded dims), the way the autotune table and the
    plan cache do."""

    id = "ML005"
    _NAME_RE = re.compile(r"(cache|memo)", re.IGNORECASE)
    _SPEC_CTORS = ("PartitionSpec", "NamedSharding", "Mesh")
    _SPEC_ATTRS = ("spec", "sharding")

    def applies_to(self, relpath: str) -> bool:
        return _in_package(relpath)

    def _cacheish(self, target: ast.AST) -> bool:
        if isinstance(target, ast.Name):
            return bool(self._NAME_RE.search(target.id))
        if isinstance(target, ast.Attribute):
            return bool(self._NAME_RE.search(target.attr))
        return False

    def _specish(self, key: ast.AST) -> bool:
        for node in ast.walk(key):
            if (isinstance(node, ast.Attribute)
                    and node.attr in self._SPEC_ATTRS):
                return True
            if isinstance(node, ast.Call):
                tail = _call_name(node.func).rsplit(".", 1)[-1]
                if tail in self._SPEC_CTORS:
                    return True
        return False

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            key = None
            target = None
            if isinstance(node, ast.Subscript):
                target, key = node.value, node.slice
            elif isinstance(node, ast.Call):
                tail = _call_name(node.func).rsplit(".", 1)[-1]
                if tail in ("get", "setdefault") and node.args and \
                        isinstance(node.func, ast.Attribute):
                    target, key = node.func.value, node.args[0]
            if key is None or not self._cacheish(target):
                continue
            if self._specish(key):
                yield Finding(
                    relpath, node.lineno, self.id,
                    "cache keyed by a sharding spec / mesh object — "
                    "hashability is version-dependent; key by the "
                    "derived stable tuple instead")


class RawTimingRule(Rule):
    """ML006: raw ``time.perf_counter()``/``time.time()``/
    ``time.monotonic()`` calls in library modules outside
    ``matrel_tpu_torch/obs/`` and ``utils/profiling.py``.

    Timing that matters belongs in the observability layer: a span
    (``obs.trace.span``/``phase``) or a ``StepTimer`` step, so the
    measurement lands in the event log where ``history``, the chrome
    exporter and the drift auditor can read it — a bare perf_counter
    pair produces a number that dies in a local variable (or worse, a
    print). The round-9 conversion moved every hot-path timing onto
    spans; this rule keeps new code from regressing to private
    stopwatches. ``parallel/autotune.py`` is scoped out wholesale —
    it is the measurement subsystem, its wall-clocks ARE its output
    and persist to the autotune table (the ML001 precedent: scope
    encodes where the hazard is contextual). The two remaining
    legitimate exceptions (the analyze-mode op_hook, the serve
    queue-wait timestamps — both of which land their numbers in the
    event log) carry inline suppressions with their justification."""

    id = "ML006"
    _DOTTED = ("time.perf_counter", "time.time", "time.monotonic")
    _BARE = ("perf_counter", "monotonic")

    def applies_to(self, relpath: str) -> bool:
        # resilience/retry.py is scoped out like autotune: deadline /
        # backoff arithmetic IS that module's function (every other
        # resilience module stays in scope), and its outcomes land in
        # the event log as retry/degrade records
        return (_in_package(relpath)
                and not relpath.startswith("matrel_tpu_torch/obs/")
                and relpath not in ("matrel_tpu_torch/utils/profiling.py",
                                    "matrel_tpu_torch/parallel/autotune.py",
                                    "matrel_tpu_torch/resilience/retry.py"))

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if name in self._DOTTED or name in self._BARE:
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"raw `{name}()` timing in library code — route "
                    "through obs.trace.span()/phase() or StepTimer so "
                    "the measurement lands in the event log")


class BroadSwallowRule(Rule):
    """ML007: bare/broad ``except`` that silently swallows and
    continues in library modules.

    ``except Exception: pass`` (or a bare ``except:``/``continue``
    body) erases the failure AND the information needed to classify it
    — exactly the anti-pattern the resilience layer's typed taxonomy
    (matrel_tpu_torch/resilience/errors.py) exists to replace: a swallowed
    transient is a lost retry, a swallowed deterministic error is a
    silent wrong answer waiting to recur. Library code must either
    raise a TYPED error, classify-and-handle, or at minimum log the
    failure it chose to survive. The handful of legitimate
    swallow-and-continue sites (never-fail observability sinks, the
    autotune loop dropping strategies that fail to compile, fallback
    encoders) carry inline suppressions with their justification —
    deliberate, reviewable exceptions, not defaults. Narrow excepts
    (``except OSError:``) are out of scope: naming the exception IS
    the classification."""

    id = "ML007"
    _BROAD_NAMES = ("Exception", "BaseException")

    def applies_to(self, relpath: str) -> bool:
        # and the smoke script: a phase failure it swallowed would let a
        # broken port pass its run on the card
        return _in_package(relpath) or relpath == "chip_smoke.py"

    def _broad(self, etype) -> bool:
        if etype is None:                       # bare except:
            return True
        if isinstance(etype, ast.Name):
            return etype.id in self._BROAD_NAMES
        if isinstance(etype, ast.Attribute):    # e.g. builtins.Exception
            return etype.attr in self._BROAD_NAMES
        return False

    @staticmethod
    def _swallows(body) -> bool:
        """True when the handler body ONLY discards: pass/continue
        statements (an ``...`` Ellipsis expression counts as pass)."""
        for stmt in body:
            if isinstance(stmt, (ast.Pass, ast.Continue)):
                continue
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Constant)
                    and stmt.value.value is Ellipsis):
                continue
            return False
        return True

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if self._broad(node.type) and self._swallows(node.body):
                yield Finding(
                    relpath, node.lineno, self.id,
                    "broad except swallows the failure and continues "
                    "— raise a typed error (resilience/errors.py), "
                    "classify-and-handle, or log what you chose to "
                    "survive")


def _device_like(node: ast.AST) -> bool:
    """An expression that names a device: a ``torch.device(...)`` call, a
    device string ("cuda", "cpu", "cuda:1"), or a name / attribute whose
    identifier is a device's (``dev``, ``device``, ``mesh.device``,
    ``x.device``)."""
    if isinstance(node, ast.Call):
        return _call_name(node.func).rsplit(".", 1)[-1] == "device"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cuda", "cpu")
    ident = (node.id if isinstance(node, ast.Name) else
             node.attr if isinstance(node, ast.Attribute) else "")
    return bool(re.fullmatch(r"(?i)_?(\w+_)?(dev|device)", ident))


class DeviceMoveRule(Rule):
    """ML008: a device move in lowering modules — a copy the planner
    cannot see or price.

    The reshard planner (``parallel/reshard.py``) exists so that every
    layout change lowers through a costed, peak-bounded step sequence: a
    tensor moved between devices inside a lowering module — ``.cuda()``,
    ``.to(<device>)``, ``.to(device=...)`` — is a copy invisible to the
    byte model, to MV109's peak proof and to the decision records (on the
    card, a host round trip). Out of scope by design: ``core/`` (where
    tensors are born and placed), the reshard module itself, and
    ``utils/`` / ``obs/``. A dtype-only ``.to(torch.float32)`` /
    ``.to(x.dtype)`` is not a move. Legitimate sites (host-built tables
    placed once a plan) carry justified inline suppressions."""

    id = "ML008"
    _SCOPE = re.compile(
        r"^matrel_tpu_torch/(executor\.py|session\.py|ops/|relational\.?/|"
        r"serve/|workloads/|ir/|parallel/)")
    _EXEMPT = ("matrel_tpu_torch/parallel/reshard.py",)

    def applies_to(self, relpath: str) -> bool:
        return bool(self._SCOPE.match(relpath)) \
            and relpath not in self._EXEMPT

    @staticmethod
    def _moves(node: ast.Call) -> bool:
        if not isinstance(node.func, ast.Attribute):
            return False
        if node.func.attr == "cuda":
            return True
        if node.func.attr != "to":
            return False
        if any(k.arg == "device" for k in node.keywords):
            return True
        return bool(node.args) and _device_like(node.args[0])

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and self._moves(node):
                yield Finding(
                    relpath, node.lineno, self.id,
                    "device move in a lowering module — a copy the "
                    "planner cannot price; route it through the reshard "
                    "planner (parallel/reshard.py) or place the tensor "
                    "where it is built")


class KernelSeamRule(Rule):
    """ML009: a kernel library built or loaded outside
    ``utils/cuda_build.py`` — the "one seam" rule.

    The JAX package keeps every Pallas kernel in its registry; the port
    keeps every hand-written kernel behind one build seam:
    ``utils/cuda_build.py`` compiles each ``csrc/`` source with ``nvcc``
    for ``sm_90a``, keys the library by the source, its headers and the
    flags (a stale library is never loaded), and loads it once. A
    ``ctypes.CDLL`` / ``cdll.LoadLibrary``, a
    ``torch.utils.cpp_extension.load*``, an ``nvcc`` subprocess or a
    ``@triton.jit`` elsewhere in the package is a kernel that seam cannot
    key, rebuild or check (``chip_smoke.py``'s build checks read its
    logs). Scope: the package; the host C++ libraries of
    ``utils/native.py`` carry justified suppressions."""

    id = "ML009"
    _EXEMPT = ("matrel_tpu_torch/utils/cuda_build.py",)

    def applies_to(self, relpath: str) -> bool:
        return _in_package(relpath) and relpath not in self._EXEMPT

    def _builds(self, node: ast.Call) -> Optional[str]:
        name = _call_name(node.func)
        head, _, tail = name.rpartition(".")
        if name in ("CDLL", "cdll.LoadLibrary") or (
                tail in ("CDLL", "LoadLibrary") and "ctypes" in head):
            return f"`{name}`"
        if tail in ("load", "load_inline") and "cpp_extension" in head:
            return f"`{name}`"
        if head in ("subprocess", "") and tail in (
                "run", "Popen", "call", "check_call", "check_output"):
            for a in node.args[:1]:
                elts = a.elts if isinstance(a, (ast.List, ast.Tuple)) \
                    else [a]
                for e in elts[:1]:
                    if isinstance(e, ast.Constant) \
                            and isinstance(e.value, str) \
                            and e.value.split("/")[-1].startswith("nvcc"):
                        return "an nvcc subprocess"
        return None

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            what = None
            if isinstance(node, ast.Call):
                what = self._builds(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if _call_name(target) in ("triton.jit", "jit") and \
                            "triton" in _call_name(target):
                        yield Finding(relpath, dec.lineno, self.id,
                                      "@triton.jit outside the build seam "
                                      "(utils/cuda_build.py)")
            if what:
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"kernel library built or loaded by {what} outside "
                    "utils/cuda_build.py — a kernel the build seam "
                    "cannot key, rebuild or check")


class CompileSeamRule(Rule):
    """ML010: a compiled or captured program — ``torch.compile``,
    ``torch.jit.script`` / ``trace``, ``torch.cuda.graph`` /
    ``CUDAGraph`` — outside the executor (``executor.py``) and
    ``utils/``.

    The JAX rule pins ``jax.jit`` to the executor's region-emission seam,
    where each program boundary is stamped, measured (the autotune
    ``fuse|`` family), verified (MV111) and escapable (degradation rung
    3). The port's programs are its lowered plans; a compiled or captured
    program authored elsewhere is one the planner cannot see, the
    dispatch accounting cannot count and the fused-vs-staged measurement
    cannot sweep. Scope: the package minus ``executor.py`` and
    ``utils/``; call and decorator forms both count."""

    id = "ML010"
    _EXEMPT = ("matrel_tpu_torch/executor.py",)
    _NAMES = ("torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.cuda.graph", "torch.cuda.CUDAGraph",
              "torch.cuda.make_graphed_callables")

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath) and relpath not in self._EXEMPT
                and not relpath.startswith("matrel_tpu_torch/utils/"))

    def _hit(self, node: ast.AST) -> bool:
        """``torch.compile`` and friends, also through ``from torch
        import jit`` / ``cuda`` (``jit.script``, ``cuda.graph``)."""
        name = _call_name(node)
        return name in self._NAMES or name in {
            n.split(".", 1)[1] for n in self._NAMES[1:]}

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and not isinstance(node.func, ast.Call) \
                    and self._hit(node.func):
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"`{_call_name(node.func)}` outside the executor — a "
                    "compiled program the planner cannot see/measure/"
                    "escape; lower it through matrel_tpu_torch/executor.py")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if not isinstance(dec, ast.Call) and self._hit(dec):
                        yield Finding(
                            relpath, dec.lineno, self.id,
                            f"@{_call_name(dec)} outside the executor — "
                            "a compiled program the planner cannot see/"
                            "measure/escape")


class UnboundedQueueRule(Rule):
    """ML011: unbounded-queue growth idioms in the serve plane.

    The overload control plane (docs/OVERLOAD.md) exists because an
    unbounded queue turns overload into memory exhaustion plus
    unbounded latency — the exact failure the typed AdmissionShed
    contract replaces with refusal. Two idioms are pinned:

    - ``deque()`` / ``queue.Queue()`` (or LifoQueue/PriorityQueue)
      constructed WITHOUT a bound (no maxlen/maxsize argument) inside
      ``matrel_tpu_torch/serve/`` — the modules whose queues sit on the
      admission path. A queue that is bounded by surrounding shed
      logic rather than by its constructor carries a justified inline
      suppression (the AdmissionQueue's per-tenant deques: a maxlen
      deque DROPS silently, and refusal must be typed).
    - ``threading.Thread(...)`` without an explicit ``daemon=``
      anywhere in ``matrel_tpu_torch/``: a non-daemon worker left running
      wedges interpreter shutdown — every sanctioned worker/helper
      thread in the package states its daemon-ness at the call site.
    """

    id = "ML011"
    _QUEUE_TAILS = ("Queue", "LifoQueue", "PriorityQueue")
    _BOUND_KW = ("maxlen", "maxsize")

    def applies_to(self, relpath: str) -> bool:
        return _in_package(relpath)

    @staticmethod
    def _has_bound(node: ast.Call, kw_names, bound_pos: int) -> bool:
        """An explicit bound: the named keyword, or enough positional
        args to reach the bound's slot — ``deque(iterable)`` is NOT
        bounded (the first positional is the iterable; maxlen is the
        second), while ``queue.Queue(n)``'s first positional IS
        maxsize."""
        if any(k.arg in kw_names for k in node.keywords):
            return True
        return len(node.args) >= bound_pos

    def check(self, tree, relpath):
        in_serve = relpath.startswith("matrel_tpu_torch/serve/")
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            tail = _call_name(node.func).rsplit(".", 1)[-1]
            if in_serve and tail == "deque" \
                    and not self._has_bound(node, ("maxlen",), 2):
                yield Finding(
                    relpath, node.lineno, self.id,
                    "unbounded deque() on the serve path — bound it "
                    "(maxlen=) or shed typed past an explicit bound "
                    "(AdmissionShed), with a justified suppression "
                    "when the bound lives in surrounding logic")
            elif in_serve and tail in self._QUEUE_TAILS \
                    and not self._has_bound(node, ("maxsize",), 1):
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"unbounded queue.{tail}() on the serve path — "
                    "pass maxsize (or shed typed past an explicit "
                    "bound)")
            elif tail == "Thread" and not any(
                    k.arg == "daemon" for k in node.keywords):
                yield Finding(
                    relpath, node.lineno, self.id,
                    "threading.Thread without an explicit daemon= — "
                    "a non-daemon worker wedges interpreter "
                    "shutdown; state the thread's lifecycle at the "
                    "call site")


@dataclasses.dataclass(frozen=True)
class ResultCacheSeamRule(Rule):
    """ML012: ResultCache entry payloads mutate ONLY through the
    sanctioned patch/apply seam in serve/result_cache.py.

    The IVM plane (serve/ivm.py; docs/IVM.md) made cached entries
    LONG-LIVED MUTABLE STATE: a patched entry's result/deps/bound
    must change together, under the cache lock, with the byte
    accounting and the provenance stamp kept coherent — so every
    mutation goes through ResultCache.apply_patch / rekey / drop /
    put (the ML009 one-kernel-seam and ML010 one-jit-seam idiom,
    applied to cached state). A module that pokes an entry's fields
    or the cache's internal stores directly produces answers whose
    provenance nobody can verify (MV113 would assert a bound the
    mutation silently voided) and byte accounting that drifts from
    the entries it claims to bound. Pinned, in matrel_tpu_torch/ outside
    serve/result_cache.py:

    - attribute ASSIGNMENT (plain, augmented, or del) to a CacheEntry
      payload field — result, dep_ids, pins, nbytes, key_hash,
      err_bound, delta_gen, delta_rule, prec, ivm_id — on any object
      (``dataclasses.replace`` builds a NEW entry and is fine; the
      seam inserts it);
    - any use of an attribute named ``_entries`` / ``_stale`` (the
      cache's internal stores): subscript stores/deletes, mutating
      method calls (pop/popitem/clear/update/setdefault/move_to_end),
      or reads — outside the owning module even a read races the
      serve worker without the cache lock.
    """

    id = "ML012"
    _ENTRY_FIELDS = ("result", "dep_ids", "pins", "nbytes", "key_hash",
                     "err_bound", "delta_gen", "delta_rule", "prec",
                     "ivm_id")
    _STORES = ("_entries", "_stale")

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath)
                and relpath != "matrel_tpu_torch/serve/result_cache.py")

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and t.attr in self._ENTRY_FIELDS:
                    yield Finding(
                        relpath, node.lineno, self.id,
                        f"direct store to a cache-entry payload field "
                        f".{t.attr} — mutate entries only through the "
                        f"ResultCache patch/apply seam "
                        f"(apply_patch/rekey/drop/put in "
                        f"serve/result_cache.py)")
            if isinstance(node, ast.Attribute) \
                    and node.attr in self._STORES:
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"direct access to the result cache's internal "
                    f".{node.attr} store — the entries mutate only "
                    f"under the cache lock through the sanctioned "
                    f"seam (serve/result_cache.py)")


class TimingAccumulationRule(Rule):
    """ML013: ad-hoc latency accumulation outside the metrics
    registry — ``.append()``/``.extend()`` onto a latency-named list
    in ``matrel_tpu_torch/`` outside ``matrel_tpu_torch/obs/``.

    The live telemetry plane (obs/metrics.py round 15) made quantiles
    a SHARED definition: every timing metric flows through the
    registry's sketch/histogram API (or ``obs.metrics.percentile``),
    so the live endpoint, ``history``'s replay and ``top`` can never
    disagree beyond the sketch's documented relative error — and
    memory stays bounded by construction. A private
    ``latencies.append(ms)`` list is the pre-sketch anti-pattern
    wearing new clothes: unbounded on a long-lived server, invisible
    to the endpoint, and quantiled by whatever ad-hoc rank math its
    author re-derives (the exact drift the history-vs-live fix
    removed). ML006 pins the CLOCK CALLS; this rule pins the
    ACCUMULATION — both ends of a private stopwatch.

    Scope: the package minus ``obs/`` (the registry and its readers
    ARE the sanctioned accumulation) ; harness scripts (bench/tools/
    tests) are out of scope — measurement is their output (the ML006
    autotune precedent). The two legitimate in-scope sites — the
    brownout controller's bounded sliding window (measurement IS that
    subsystem, and its p95 reads through the shared definition) and
    the serve worker's per-cycle overload-event assembly (the values
    land in the event log) — carry justified inline suppressions.

    Matched names: the append target's variable/attribute name (or a
    string subscript key) containing a latency-ish token — ``lat``/
    ``latency``/``latencies``, ``wait``/``waits``, ``duration(s)``,
    ``elapsed``, ``timing(s)`` — or ending in ``_ms``.
    """

    id = "ML013"
    _TIMING_RE = re.compile(
        r"(?i)(?:^|_)(lat|lats|latency|latencies|wait|waits|"
        r"dur|durs|duration|durations|elapsed|timing|timings)(?:$|_)"
        r"|_ms$")

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath)
                and not relpath.startswith("matrel_tpu_torch/obs/"))

    @classmethod
    def _target_name(cls, node: ast.AST) -> str:
        """The accumulation target's human name: ``waits`` for
        ``waits.append``, ``_waits`` for ``self._waits.append``,
        ``latencies`` for ``row["latencies"].append``."""
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value,
                                                           str):
                return sl.value
        return ""

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in ("append", "extend"):
                continue
            name = self._target_name(node.func.value)
            if name and self._TIMING_RE.search(name):
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"ad-hoc timing accumulation `{name}."
                    f"{node.func.attr}(...)` — record through the "
                    "metrics registry's sketch/histogram API "
                    "(obs/metrics.py) so live and offline quantiles "
                    "share one bounded-memory definition")


class FleetSeamRule(Rule):
    """ML014: cross-slice state mutation pinned onto the fleet API
    (serve/fleet.py; docs/FLEET.md).

    The fleet made OTHER sessions' result caches reachable: every
    slice owns one, and the directory/replication protocol depends on
    exactly one module mutating them — a serve/ module that writes
    another slice's cache directly produces entries the directory
    never recorded (unreachable by the hit-anywhere protocol, wrong
    ownership on failover) and bypasses the replication pricing that
    keeps migrations under the HBM budget. Pinned, in
    ``matrel_tpu_torch/serve/`` outside ``fleet.py`` and the cache's own
    module: a call to a MUTATING ResultCache method (put / drop /
    apply_patch / rekey / invalidate_deps / clear / rebuild_stale)
    whose receiver chain reaches ``._result_cache`` through anything
    other than plain ``self`` / ``self.session`` — e.g.
    ``fleet.slices[i].session._result_cache.put(...)``. A session
    mutating ITS OWN cache (the IVM plane, the rebind path) is the
    sanctioned single-slice seam and stays clean."""

    id = "ML014"
    _MUT = ("put", "drop", "apply_patch", "rekey", "invalidate_deps",
            "clear", "rebuild_stale")

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith("matrel_tpu_torch/serve/")
                and relpath not in ("matrel_tpu_torch/serve/fleet.py",
                                    "matrel_tpu_torch/serve/result_cache.py"))

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute) \
                    or f.attr not in self._MUT:
                continue
            chain = []
            cur = f.value
            through_subscript = False
            while True:
                if isinstance(cur, ast.Attribute):
                    chain.append(cur.attr)
                    cur = cur.value
                elif isinstance(cur, ast.Subscript):
                    through_subscript = True
                    cur = cur.value
                elif isinstance(cur, ast.Call):
                    cur = cur.func
                else:
                    break
            if "_result_cache" not in chain:
                continue
            # sanctioned receivers: a session mutating its OWN cache
            # — self._result_cache / self.session._result_cache / the
            # conventional sess/session local alias. Anything reached
            # through a subscript (slices[i]) or a foreign object is
            # another slice's state.
            own_root = (isinstance(cur, ast.Name)
                        and cur.id in ("self", "sess", "session"))
            sanctioned = (own_root and not through_subscript
                          and set(chain) <= {"_result_cache",
                                             "session"})
            if not sanctioned:
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"cross-slice result-cache mutation "
                    f"`...{'.'.join(reversed(chain))}.{f.attr}(...)`"
                    f" outside the fleet API — another slice's cache "
                    f"mutates only through serve/fleet.py (the "
                    f"directory/replication seam, docs/FLEET.md)")


class ProvenanceSeamRule(Rule):
    """ML015: answer-lineage stamps are written ONLY by the ledger's
    sanctioned writers in obs/provenance.py (the ML012/ML014 one-seam
    idiom applied to lineage).

    The answer provenance ledger (docs/OBSERVABILITY.md tier 4) makes
    ``CacheEntry.provenance`` and the substitution leaf's
    ``attrs["provenance"]`` the account of where a served answer came
    from — and MV115 cross-checks that account against the mechanism
    stamps, while ``why --audit`` replays answers against the bounds
    it records. Both are only sound if the stamps have exactly one
    producer: a module hand-writing a provenance dict produces
    lineage the ledger never witnessed (un-audited, un-renderable,
    schema-drifting) — precisely the unverifiable-answer class ML012
    pins for cache payloads. Serve/session modules CALL
    ``stamp_entry`` / ``stamp_patched`` / ``stamp_leaf``; they never
    build the stamp themselves. Pinned, in ``matrel_tpu_torch/`` outside
    ``matrel_tpu_torch/obs/provenance.py``:

    - attribute assignment (plain, augmented, annotated, or del) to a
      ``.provenance`` field on any object;
    - a subscript store ``X["provenance"] = ...`` (the attrs-dict
      route around the attribute check);
    - a ``provenance=`` keyword in a ``with_attrs(...)`` call (the
      immutable-expr route).

    Reads are fine everywhere — the ledger exists to be read.
    """

    id = "ML015"

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath)
                and relpath != "matrel_tpu_torch/obs/provenance.py")

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and t.attr == "provenance":
                    yield Finding(
                        relpath, node.lineno, self.id,
                        "direct store to a .provenance stamp — "
                        "lineage is written only by the ledger's "
                        "stamp_entry/stamp_patched/stamp_leaf "
                        "(obs/provenance.py), so MV115 and the "
                        "audit replay can trust it")
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.slice, ast.Constant) \
                        and t.slice.value == "provenance":
                    yield Finding(
                        relpath, node.lineno, self.id,
                        "subscript store to a ['provenance'] stamp — "
                        "lineage is written only by the ledger's "
                        "stamp writers (obs/provenance.py)")
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "with_attrs":
                for kw in node.keywords:
                    if kw.arg == "provenance":
                        yield Finding(
                            relpath, node.lineno, self.id,
                            "with_attrs(provenance=...) outside the "
                            "ledger — thread lineage onto leaves via "
                            "stamp_leaf (obs/provenance.py)")


class TemplateKeyRule(Rule):
    """ML016: plan-template / CSE caches keyed by identity or spec
    values instead of the canonical structural key (ML005 extended to
    the multi-query-optimization plane, serve/mqo.py).

    A template entry outlives the queries that built it — that is the
    point — so its key must mean the same thing at probe time as it
    did at insert time. ``id()`` is recycled the moment the original
    object dies (a false hit rebinds a STRANGER's matrices into a
    compiled plan); node ``.uid`` values are per-tree counters that
    collide across independently-built expressions; spec/sharding
    objects hash by identity or not at all (the ML005 hazard). The
    only sound key is the leaf-abstracted STRUCTURAL key
    (``mqo.template_key`` / ``session._plan_key``) — derived strings
    whose equality IS plan equivalence. Pinned: subscript stores and
    ``get``/``setdefault`` consults on template-/hoist-named dicts
    whose key expression reaches an ``id(...)`` call or a
    ``.uid``/``.spec``/``.sharding`` attribute. Local first-occurrence
    maps (``classes.setdefault(id(m), ...)`` inside one
    ``template_key`` walk) are fine — they die with the walk, which
    is why the rule scopes by cache NAME, not by module."""

    id = "ML016"
    _NAME_RE = re.compile(r"(template|tpl|hoist)", re.IGNORECASE)
    _UNSTABLE_ATTRS = ("uid", "spec", "sharding")

    def applies_to(self, relpath: str) -> bool:
        return _in_package(relpath)

    def _cacheish(self, target: ast.AST) -> bool:
        if isinstance(target, ast.Name):
            return bool(self._NAME_RE.search(target.id))
        if isinstance(target, ast.Attribute):
            return bool(self._NAME_RE.search(target.attr))
        return False

    def _unstable(self, key: ast.AST) -> Optional[str]:
        for node in ast.walk(key):
            if isinstance(node, ast.Call) \
                    and _call_name(node.func).rsplit(".", 1)[-1] == "id":
                return "id()"
            if isinstance(node, ast.Attribute) \
                    and node.attr in self._UNSTABLE_ATTRS:
                return f".{node.attr}"
        return None

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            key = None
            target = None
            if isinstance(node, ast.Subscript):
                target, key = node.value, node.slice
            elif isinstance(node, ast.Call):
                tail = _call_name(node.func).rsplit(".", 1)[-1]
                if tail in ("get", "setdefault") and node.args and \
                        isinstance(node.func, ast.Attribute):
                    target, key = node.func.value, node.args[0]
            if key is None or not self._cacheish(target):
                continue
            bad = self._unstable(key)
            if bad is not None:
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"template/CSE cache keyed by {bad} — identity "
                    f"and spec values do not survive the entry (a "
                    f"recycled id() falsely rebinds, uids collide "
                    f"across trees); key by the canonical structural "
                    f"key (mqo.template_key / session._plan_key)")


class LockSeamRule(Rule):
    """ML017: bare ``threading.Lock()``/``RLock()`` construction in
    ``matrel_tpu_torch/`` outside the ``utils/lockdep.py`` seam.

    The concurrency sanitizer (docs/CONCURRENCY.md) hangs off ONE
    construction seam: ``lockdep.make_lock(name)`` /
    ``make_rlock(name)`` return raw threading primitives by default
    (zero objects — the structural-zero contract) and instrumented
    wrappers under ``config.lockdep_enable``. A lock built bare is
    invisible to all three layers the seam feeds: it has no inventory
    name (docs/CONCURRENCY.md's lock table and lockcheck's LK1xx
    findings key on them), the runtime order graph never sees its
    acquisitions, and the race drill cannot prove schedules over it —
    the ML009/ML010 one-seam argument applied to locks.
    ``Condition``/``Event``/``Semaphore`` stay legal: they are
    signalling primitives, not mutual-exclusion state, and the
    Conditions in the serve plane deliberately WRAP a seam-built lock.
    The sanitizer's own internal guard in utils/lockdep.py is the one
    necessarily-raw lock (it cannot instrument itself)."""

    id = "ML017"
    _SEAM = ("matrel_tpu_torch/utils/lockdep.py",)

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath)
                and relpath not in self._SEAM)

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if name in ("threading.Lock", "threading.RLock",
                        "Lock", "RLock"):
                kind = name.rsplit(".", 1)[-1]
                yield Finding(
                    relpath, node.lineno, self.id,
                    f"bare threading.{kind}() outside the lockdep "
                    f"seam — construct it via lockdep.make_"
                    f"{'r' if kind == 'RLock' else ''}lock"
                    f"(\"<inventory.name>\") (utils/lockdep.py) so "
                    f"it is named, order-tracked and drill-able")


class CoeffSeamRule(Rule):
    """ML018: raw ``drift.load_table`` consult in planner/serve code
    outside the ``parallel/coeffs.py`` seam.

    The cost-model loop (docs/COST_MODEL.md) hangs off ONE coefficient
    reader: ``parallel/coeffs.py`` parses the drift table once per
    file state (stat-signature memoized), drops non-finite rows, and
    stamps the coefficient EPOCH the session embeds in every plan key
    (``coeffv:``). A planner or serve module that calls
    ``drift.load_table`` directly re-reads and re-parses the raw JSON
    on its own schedule: it can rank by a table state no other
    consumer saw, its decisions carry no epoch (so a re-plan round
    cannot invalidate the plans it influenced), and the NaN/zero-ms
    hardening lives only in the seam — the ML009/ML010 one-seam
    argument applied to learned coefficients. ``obs/`` is out of
    scope (the auditor/controller own the table and its writers);
    the seam itself is exempt."""

    id = "ML018"
    _EXEMPT = ("matrel_tpu_torch/parallel/coeffs.py",)

    def applies_to(self, relpath: str) -> bool:
        return (_in_package(relpath)
                and not relpath.startswith("matrel_tpu_torch/obs/")
                and relpath not in self._EXEMPT)

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if (node.module or "").endswith("obs.drift") and any(
                        a.name == "load_table" for a in node.names):
                    yield Finding(
                        relpath, node.lineno, self.id,
                        "load_table imported from obs.drift outside "
                        "the coefficient seam — consult "
                        "parallel/coeffs.py (strategy_row/"
                        "class_coefficients/epoch) so the read is "
                        "memoized, hardened and epoch-stamped")
            elif isinstance(node, ast.Call):
                # drift-qualified calls only (drift.load_table,
                # drift_lib.load_table): the autotune table has its
                # own same-named reader in parallel/autotune.py and
                # is a different store with its own seam
                name = _call_name(node.func)
                if (name.rsplit(".", 1)[-1] == "load_table"
                        and "drift" in name.rsplit(".", 1)[0]):
                    yield Finding(
                        relpath, node.lineno, self.id,
                        "raw drift.load_table consult outside the "
                        "coefficient seam — consult "
                        "parallel/coeffs.py (strategy_row/"
                        "class_coefficients/epoch) so the read is "
                        "memoized, hardened and epoch-stamped")


class DurableIoSeamRule(Rule):
    """ML019: raw file IO in ``matrel_tpu_torch/serve/`` outside the
    spill/checkpoint seam.

    The durability plane (docs/DURABILITY.md) hangs off ONE writer:
    ``serve/spill.py`` stages every artifact through the checkpoint
    format's atomic tmp+rename with a streamed sha1, and its restore
    path treats any mismatch as a typed miss (SnapshotCorruption —
    recompute, never a wrong answer). A serve module that opens files
    on its own creates durable state save_state() does not know to
    freeze and restore() cannot verify — a restart either loses it
    silently or thaws bytes nothing checksummed. The ML009/ML010
    one-seam idiom applied to durable serving state; the seam itself
    is exempt, and modules outside serve/ (obs exporters, the
    checkpoint manager, tools) keep their own IO discipline."""

    id = "ML019"
    _EXEMPT = ("matrel_tpu_torch/serve/spill.py",)
    #: call tokens whose tail identifies a raw durable-IO primitive
    _IO_TAILS = {"save": ("np", "numpy"), "load": ("np", "numpy"),
                 "dump": ("json",), "dumps": (),
                 "replace": ("os",), "remove": ("os",),
                 "unlink": ("os",)}

    def applies_to(self, relpath: str) -> bool:
        return (relpath.startswith("matrel_tpu_torch/serve/")
                and relpath not in self._EXEMPT)

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            head, _, tail = name.rpartition(".")
            if name == "open":
                yield Finding(
                    relpath, node.lineno, self.id,
                    "raw open() in serve code — durable serving "
                    "state goes through the spill/checkpoint seam "
                    "(serve/spill.py) so artifacts are sha1-stamped, "
                    "atomically renamed and restore-verifiable")
            elif tail in ("save", "load", "dump", "replace",
                          "remove", "unlink"):
                owners = self._IO_TAILS.get(tail, ())
                if head in owners:
                    yield Finding(
                        relpath, node.lineno, self.id,
                        f"raw {name}() in serve code — durable "
                        "serving state goes through the spill/"
                        "checkpoint seam (serve/spill.py) so "
                        "artifacts are sha1-stamped, atomically "
                        "renamed and restore-verifiable")


RULES: Sequence[Rule] = (HostSyncRule(), NoDensifyRule(),
                        CollectiveSeamRule(), ConfigFlowRule(),
                        SpecKeyedCacheRule(), RawTimingRule(),
                        BroadSwallowRule(), DeviceMoveRule(),
                        KernelSeamRule(), CompileSeamRule(),
                        UnboundedQueueRule(), ResultCacheSeamRule(),
                        TimingAccumulationRule(), FleetSeamRule(),
                        ProvenanceSeamRule(), TemplateKeyRule(),
                        LockSeamRule(), CoeffSeamRule(),
                        DurableIoSeamRule())


def _suppressed_codes(line: str) -> set:
    """Codes disabled on this line. Tokens after the code list are
    justification prose (mandatory by convention, ignored by the
    parser): ``# matlint: disable=ML001 analyze-mode op_hook``."""
    m = _SUPPRESS_RE.search(line)
    if not m:
        return set()
    return {tok for tok in re.split(r"[\s,]+", m.group(1))
            if re.fullmatch(r"ML\d+", tok)}


def lint_file(path: str, rules: Sequence[Rule] = RULES,
              relpath: Optional[str] = None) -> List[Finding]:
    """All unsuppressed findings for one file. ``relpath`` overrides
    the repo-relative path used for rule scoping (fixture tests lint
    temp files AS IF they lived at a package path)."""
    rel = relpath if relpath is not None else _rel(path)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 0, "ML000",
                        f"file does not parse: {e.msg}")]
    lines = src.splitlines()
    out: List[Finding] = []
    for rule in rules:
        if not rule.applies_to(rel):
            continue
        for f in rule.check(tree, rel):
            line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
            if f.rule in _suppressed_codes(line):
                continue
            out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(REPO, p)
        if os.path.isfile(full):
            yield full
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str] = DEFAULT_PATHS) -> List[Finding]:
    out: List[Finding] = []
    for f in iter_python_files(paths):
        out.extend(lint_file(f))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--list-rules" in argv:
        for r in RULES:
            doc = (r.__doc__ or "").strip().splitlines()[0]
            print(f"{r.id}  {doc}")
        return 0
    paths = [a for a in argv if not a.startswith("-")] or list(
        DEFAULT_PATHS)
    findings = lint_paths(paths)
    for f in findings:
        print(f.render())
    n = len(findings)
    print(f"matlint: {n} finding(s) in scan set {tuple(paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
