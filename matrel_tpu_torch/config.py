"""Typed configuration for matrel_tpu_torch — the counterpart of
``matrel_tpu/config.py``.

Same frozen-dataclass shape and the same defaults as the JAX package's
``MatrelConfig``. The knobs of the ported planes (planning, rewrites,
execution, precision tiers, the plan cache, serving, observability,
resilience, the learned planner coefficients, re-planning, the spill
hierarchy, the static verifier and the serving fleet) are live, and
so is every other field: each is validated as the JAX package
validates it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional, Tuple


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this package does not run yet
    (an unported node kind, dispatch or configuration plane)."""


@dataclasses.dataclass(frozen=True)
class MatrelConfig:
    """Global knobs for planning and execution (see the JAX package's
    ``MatrelConfig`` docstring for the meaning of each field).

    Live in this package: ``block_size``, ``mesh_shape`` (the VIRTUAL
    grid the planner prices; one card always executes as 1x1),
    ``mesh_axis_names``, ``broadcast_threshold_bytes``,
    ``strategy_override``, ``sparsity_threshold`` (read by neither
    package), ``spgemm_density_threshold``, ``spgemm_kernel_override``
    (validated against :data:`SPGEMM_KERNEL_IDS`), ``comm_alpha_bytes``,
    ``default_dtype``, ``matmul_precision``, ``keep_input_dtype``,
    ``use_pallas`` (here: launch the hand-written CUDA kernels for CUDA
    tensors; False runs their plain PyTorch versions), ``chain_opt``,
    ``rewrite_rules``, ``plan_cache_max_plans``, ``hbm_budget_bytes``,
    ``axis_cost_weights``, ``precision_sla``, ``precision_enable_bf16``,
    ``precision_enable_int``, ``join_pair_cap_entries``,
    ``join_bruteforce_max_pairs``, ``join_chunk_entries``, ``autotune``
    (measured matmul strategies, SpMV variants and SpGEMM kernels:
    ``parallel/autotune.py``), ``autotune_table_path``,
    ``autotune_max_dim``, ``fusion_enable`` (whole-plan fusion:
    ``ir/fusion.py``), ``reshard_peak_budget_bytes`` (staged-reshard
    planning: ``parallel/reshard.py``; on one card every step is a local
    copy, so it changes stamps, prices and decision records, never a
    value), and the serve plane's: ``result_cache_max_bytes`` /
    ``result_cache_max_entries`` (``serve/result_cache.py``),
    ``serve_max_batch``, ``serve_max_inflight``, ``serve_queue_max``,
    ``serve_tenant_weights`` (parsed by :func:`parse_tenant_weights`) and
    ``serve_tenant_queue_max`` (``serve/pipeline.py``,
    ``serve/admission.py``), ``deadline_ms`` and the ``retry_*`` knobs
    (``resilience/retry.py``), ``cse_enable``, ``cse_min_uses``
    and ``cse_template_max`` (``serve/mqo.py``), ``delta_patch_mode``
    and ``delta_rank_max`` (``ir/delta.py``, ``serve/ivm.py``), and the
    observability and resilience planes': ``obs_level``,
    ``obs_event_log``, ``obs_event_log_max_bytes``, ``obs_metrics_port``,
    ``obs_flight_recorder``, ``obs_flight_recorder_path``,
    ``obs_provenance`` (``obs/``), the ``slo_*`` knobs (``obs/slo.py``),
    ``drift_table_path`` (``obs/drift.py``), ``lockdep_enable`` /
    ``lockdep_raise`` (``utils/lockdep.py``), ``fault_inject`` /
    ``fault_inject_seed`` (``resilience/faults.py``), the ``brownout_*``
    knobs (``resilience/brownout.py``), the ``breaker_*`` knobs
    (``resilience/breaker.py``), ``coeff_planner_enable`` /
    ``coeff_min_samples`` (``parallel/coeffs.py``), the durable half's:
    ``coeff_replan_enable`` / ``coeff_replan_interval`` /
    ``coeff_replan_cooldown`` (``serve/replan.py``), ``spill_enable``,
    ``spill_host_max_bytes``, ``spill_disk_hits`` and ``state_dir``
    (``serve/spill.py``; the disk tier and ``save_state`` write under
    ``state_dir``), and ``verify_plans`` ("off" / "warn" / "error":
    ``analysis/``, run at compile time before lowering), and the fleet's
    ``fleet_slices``, ``fleet_span_margin``, ``fleet_directory_max``,
    ``fleet_replicate_hits``, ``fleet_failover`` and
    ``fleet_placement_calibration`` (``serve/fleet.py``). A retry climbs the
    degradation ladder (``resilience/degrade.py``); its rung 3 runs the
    composite paths instead of the hand-written kernels, by design.

    Three execution knobs of the JAX package keep their field and take
    the torch meaning of what they control:

    - ``pallas_interpret``: the JAX package runs its Pallas paths in
      interpret mode off the TPU (and ignores the flag on one). Here a
      kernel wrapper given a CPU tensor always runs its plain PyTorch
      version, which is that mode, and a CUDA tensor always launches
      the kernel: the flag is accepted either way and changes no plan
      and no value.
    - ``donate_intermediates``: the JAX package donates rebound leaf
      buffers in ``CompiledPlan.run(donate=True)`` and
      ``bound_runner(donate=True)``. Here ``bound_runner`` takes the
      same flag as the caller's promise to give up the rebound tensors;
      the runner keeps no reference to them, torch frees an
      intermediate at its last reference and the caching allocator
      reuses the blocks, so both values run the same plan.
    - ``plan_cache_max_bytes``: the byte bound on the hoisted payloads
      cached plans pin. A plan here pins none (its tables live on its
      leaf matrices), so the bound counts zero bytes and only
      ``plan_cache_max_plans`` evicts; it must be >= 0, as a negative
      bound would evict every plan in the JAX package.

    ``matmul_precision`` keeps the TPU meaning of the JAX package:
    "highest" is full IEEE f32 (TF32 off), "high" the 3-pass bf16
    residual split, "default" one bf16 pass with f32 accumulation.
    """

    block_size: int = 512
    mesh_shape: Optional[Tuple[int, int]] = None
    mesh_axis_names: Tuple[str, str] = ("x", "y")
    broadcast_threshold_bytes: int = 64 * 1024 * 1024
    strategy_override: str = "auto"
    sparsity_threshold: float = 0.05
    spgemm_density_threshold: float = 0.25
    spgemm_kernel_override: str = ""
    comm_alpha_bytes: float = 200_000.0
    default_dtype: str = "float32"
    matmul_precision: str = "highest"
    keep_input_dtype: bool = True
    use_pallas: bool = True
    pallas_interpret: bool = False
    chain_opt: bool = True
    rewrite_rules: bool = True
    donate_intermediates: bool = True
    join_pair_cap_entries: int = 1 << 26
    join_bruteforce_max_pairs: int = 1 << 28
    join_chunk_entries: int = 1 << 22
    plan_cache_max_plans: int = 64
    plan_cache_max_bytes: int = 4 << 30
    autotune: bool = False
    autotune_table_path: str = ""
    autotune_max_dim: int = 8192
    result_cache_max_bytes: int = 0
    result_cache_max_entries: int = 256
    serve_max_batch: int = 8
    serve_max_inflight: int = 2
    obs_level: str = "off"
    obs_event_log: str = ""
    obs_metrics_port: int = 0
    slo_targets: str = ""
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 1800.0
    slo_burn_threshold: float = 14.4
    slo_burn_exit: float = 1.0
    obs_flight_recorder: int = 0
    obs_flight_recorder_path: str = ""
    drift_table_path: str = ""
    verify_plans: str = "off"
    hbm_budget_bytes: int = 16 << 30
    reshard_peak_budget_bytes: int = 0
    axis_cost_weights: Tuple[float, float] = (1.0, 1.0)
    fault_inject: str = ""
    fault_inject_seed: int = 0
    retry_max_attempts: int = 0
    retry_backoff_ms: float = 25.0
    retry_backoff_mult: float = 2.0
    retry_jitter: float = 0.5
    deadline_ms: float = 0.0
    serve_queue_max: int = 0
    serve_tenant_weights: str = ""
    serve_tenant_queue_max: int = 0
    brownout_enable: bool = False
    brownout_window: int = 32
    brownout_dwell: int = 8
    brownout_wait_high_ms: float = 200.0
    brownout_wait_low_ms: float = 50.0
    brownout_depth_high: int = 64
    brownout_depth_low: int = 8
    brownout_miss_high: float = 0.25
    brownout_miss_low: float = 0.05
    breaker_threshold: int = 0
    breaker_cooldown_ms: float = 1000.0
    breaker_half_open_probes: int = 1
    precision_sla: str = "default"
    precision_enable_bf16: bool = True
    precision_enable_int: bool = True
    fusion_enable: bool = False
    cse_enable: bool = False
    cse_min_uses: int = 2
    cse_template_max: int = 64
    delta_patch_mode: str = "auto"
    delta_rank_max: int = 512
    fleet_slices: int = 0
    fleet_span_margin: float = 1.0
    fleet_directory_max: int = 4096
    fleet_replicate_hits: int = 3
    fleet_failover: bool = True
    fleet_placement_calibration: bool = True
    obs_provenance: int = 0
    obs_event_log_max_bytes: int = 0
    lockdep_enable: bool = False
    lockdep_raise: bool = False
    coeff_planner_enable: bool = False
    coeff_min_samples: int = 3
    coeff_replan_enable: bool = False
    coeff_replan_interval: int = 32
    coeff_replan_cooldown: int = 2
    spill_enable: bool = False
    spill_host_max_bytes: int = 2 << 30
    spill_disk_hits: int = 1
    state_dir: str = ""

    def __post_init__(self):
        level = self.obs_level.lower()
        if level not in ("off", "on", "analyze"):
            raise ValueError(
                f"obs_level must be one of 'off'/'on'/'analyze', "
                f"got {self.obs_level!r}")
        object.__setattr__(self, "obs_level", level)
        # a misspelled "eror" would silently disable the verifier's
        # raise and ship the very plan it exists to block
        vp = self.verify_plans.lower()
        if vp not in ("off", "warn", "error"):
            raise ValueError(
                f"verify_plans must be one of 'off'/'warn'/'error', "
                f"got {self.verify_plans!r}")
        object.__setattr__(self, "verify_plans", vp)
        if self.plan_cache_max_bytes < 0:
            raise ValueError(
                f"plan_cache_max_bytes must be >= 0, "
                f"got {self.plan_cache_max_bytes!r}")
        if (self.spgemm_kernel_override
                and self.spgemm_kernel_override not in SPGEMM_KERNEL_IDS):
            raise ValueError(
                f"spgemm_kernel_override must be one of "
                f"{SPGEMM_KERNEL_IDS} (or '' to disable), got "
                f"{self.spgemm_kernel_override!r}")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"matmul_precision must be one of 'default'/'high'/"
                f"'highest', got {self.matmul_precision!r}")
        w = tuple(self.axis_cost_weights)
        if len(w) != 2 or not all(
                isinstance(v, (int, float)) and v > 0.0 for v in w):
            raise ValueError(
                "axis_cost_weights must be two positive numbers "
                f"(per mesh axis), got {self.axis_cost_weights!r}")
        object.__setattr__(self, "axis_cost_weights",
                           (float(w[0]), float(w[1])))
        # a negative budget would read as "unbounded" in every fits()
        # check while the caller believes a cap is in force
        if self.reshard_peak_budget_bytes < 0:
            raise ValueError(
                f"reshard_peak_budget_bytes must be >= 0 (0 = legacy "
                f"single-shot reshards), "
                f"got {self.reshard_peak_budget_bytes!r}")
        object.__setattr__(self, "precision_sla",
                           normalize_sla(self.precision_sla))
        # the serve plane's knobs, validated as the JAX package does: a
        # zero admission width or in-flight bound would deadlock the
        # coalescing loop, a negative retry/deadline has no meaning
        if self.result_cache_max_entries < 1:
            raise ValueError(
                f"result_cache_max_entries must be >= 1, "
                f"got {self.result_cache_max_entries!r}")
        if self.serve_max_batch < 1:
            raise ValueError(
                f"serve_max_batch must be >= 1, got {self.serve_max_batch!r}")
        if self.serve_max_inflight < 1:
            raise ValueError(
                f"serve_max_inflight must be >= 1, "
                f"got {self.serve_max_inflight!r}")
        if self.retry_max_attempts < 0:
            raise ValueError(
                f"retry_max_attempts must be >= 0, "
                f"got {self.retry_max_attempts!r}")
        if self.retry_backoff_ms < 0 or self.retry_backoff_mult < 1.0 \
                or not (0.0 <= self.retry_jitter <= 1.0):
            raise ValueError(
                "retry backoff needs retry_backoff_ms >= 0, "
                "retry_backoff_mult >= 1, retry_jitter in [0, 1]; got "
                f"({self.retry_backoff_ms!r}, "
                f"{self.retry_backoff_mult!r}, {self.retry_jitter!r})")
        if self.deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be >= 0 (0 disables), "
                f"got {self.deadline_ms!r}")
        if self.serve_queue_max < 0:
            raise ValueError(
                f"serve_queue_max must be >= 0 (0 = unbounded), "
                f"got {self.serve_queue_max!r}")
        if self.serve_tenant_weights:
            parse_tenant_weights(self.serve_tenant_weights)
        if self.serve_tenant_queue_max < 0:
            raise ValueError(
                f"serve_tenant_queue_max must be >= 0 (0 = no "
                f"per-tenant cap), got {self.serve_tenant_queue_max!r}")
        mode = self.delta_patch_mode.lower()
        if mode not in ("auto", "force", "off"):
            raise ValueError(
                f"delta_patch_mode must be one of 'auto'/'force'/"
                f"'off', got {self.delta_patch_mode!r}")
        object.__setattr__(self, "delta_patch_mode", mode)
        if self.delta_rank_max < 1:
            raise ValueError(
                f"delta_rank_max must be >= 1, "
                f"got {self.delta_rank_max!r}")
        if self.cse_min_uses < 2:
            raise ValueError(
                f"cse_min_uses must be >= 2 (an interior used once "
                f"is not shared), got {self.cse_min_uses!r}")
        if self.cse_template_max < 1:
            raise ValueError(
                f"cse_template_max must be >= 1, "
                f"got {self.cse_template_max!r}")
        # the fleet's knobs, validated as the JAX package does: a
        # negative slice count would read as "off" while the operator
        # believes a fleet serves; a non-positive span margin makes
        # spanning unreachable; a zero directory bound would evict every
        # ownership record at insert
        if self.fleet_slices < 0:
            raise ValueError(
                f"fleet_slices must be >= 0 (0 disables the fleet), "
                f"got {self.fleet_slices!r}")
        if self.fleet_span_margin <= 0:
            raise ValueError(
                f"fleet_span_margin must be > 0, "
                f"got {self.fleet_span_margin!r}")
        if self.fleet_directory_max < 1:
            raise ValueError(
                f"fleet_directory_max must be >= 1, "
                f"got {self.fleet_directory_max!r}")
        if self.fleet_replicate_hits < 0:
            raise ValueError(
                f"fleet_replicate_hits must be >= 0 (0 disables "
                f"hot-entry replication), "
                f"got {self.fleet_replicate_hits!r}")
        self._check_obs_resilience()

    def _check_obs_resilience(self) -> None:
        """The observability and resilience knobs, validated as the JAX
        package does: a malformed fault or SLO spec, an out-of-range
        port, un-separated hysteresis thresholds or a sanitizer raise
        mode with no sanitizer fails here, never silently doing nothing
        while the operator believes it is in force."""
        if not (0 <= self.obs_metrics_port <= 65535):
            raise ValueError(
                f"obs_metrics_port must be a port in [0, 65535] "
                f"(0 disables the endpoint), "
                f"got {self.obs_metrics_port!r}")
        if self.slo_targets:
            parse_slo_targets(self.slo_targets)
        if not (0.0 < self.slo_fast_window_s < self.slo_slow_window_s):
            raise ValueError(
                "slo windows need 0 < slo_fast_window_s < "
                "slo_slow_window_s, got "
                f"({self.slo_fast_window_s!r}, "
                f"{self.slo_slow_window_s!r})")
        if not (0.0 < self.slo_burn_exit < self.slo_burn_threshold):
            raise ValueError(
                "slo burn thresholds need 0 < slo_burn_exit < "
                "slo_burn_threshold (the hysteresis separation), got "
                f"({self.slo_burn_exit!r}, "
                f"{self.slo_burn_threshold!r})")
        if self.obs_flight_recorder < 0:
            raise ValueError(
                f"obs_flight_recorder must be >= 0 (ring capacity; "
                f"0 disables), got {self.obs_flight_recorder!r}")
        if self.fault_inject:
            from matrel_tpu_torch.resilience.faults import parse_spec
            parse_spec(self.fault_inject)
        if self.brownout_window < 1 or self.brownout_dwell < 1:
            raise ValueError(
                "brownout_window and brownout_dwell must be >= 1; got "
                f"({self.brownout_window!r}, {self.brownout_dwell!r})")
        for name, lo, hi in (
                ("wait", self.brownout_wait_low_ms,
                 self.brownout_wait_high_ms),
                ("depth", self.brownout_depth_low,
                 self.brownout_depth_high),
                ("miss", self.brownout_miss_low,
                 self.brownout_miss_high)):
            if not (0 <= lo < hi):
                raise ValueError(
                    f"brownout_{name} thresholds need 0 <= low < high "
                    f"(the hysteresis separation), got ({lo!r}, {hi!r})")
        if not (0.0 <= self.brownout_miss_high <= 1.0):
            raise ValueError(
                f"brownout_miss_high must be a rate in [0, 1], "
                f"got {self.brownout_miss_high!r}")
        if self.breaker_threshold < 0:
            raise ValueError(
                f"breaker_threshold must be >= 0 (0 disables "
                f"breakers), got {self.breaker_threshold!r}")
        if self.breaker_cooldown_ms <= 0 \
                or self.breaker_half_open_probes < 1:
            raise ValueError(
                "breakers need breaker_cooldown_ms > 0 and "
                "breaker_half_open_probes >= 1; got "
                f"({self.breaker_cooldown_ms!r}, "
                f"{self.breaker_half_open_probes!r})")
        if self.obs_provenance < 0:
            raise ValueError(
                f"obs_provenance must be >= 0 (0 disables the "
                f"provenance ledger), got {self.obs_provenance!r}")
        if self.obs_event_log_max_bytes < 0:
            raise ValueError(
                f"obs_event_log_max_bytes must be >= 0 (0 disables "
                f"event-log rotation), "
                f"got {self.obs_event_log_max_bytes!r}")
        if self.lockdep_raise and not self.lockdep_enable:
            raise ValueError(
                "lockdep_raise requires lockdep_enable (a raise mode "
                "with no instrumentation in force would silently "
                "check nothing)")
        if self.coeff_min_samples < 1:
            raise ValueError(
                f"coeff_min_samples must be >= 1, "
                f"got {self.coeff_min_samples!r}")
        if self.coeff_replan_enable and not self.coeff_planner_enable:
            raise ValueError(
                "coeff_replan_enable requires coeff_planner_enable "
                "(re-planning recalibrates coefficients the planner "
                "would otherwise never consult)")
        if self.coeff_replan_interval < 1:
            raise ValueError(
                f"coeff_replan_interval must be >= 1, "
                f"got {self.coeff_replan_interval!r}")
        if self.coeff_replan_cooldown < 0:
            raise ValueError(
                f"coeff_replan_cooldown must be >= 0, "
                f"got {self.coeff_replan_cooldown!r}")
        # a spill hierarchy under a disabled result cache would demote
        # nothing while the operator believes the working set extends
        # past device memory
        if self.spill_enable and self.result_cache_max_bytes <= 0:
            raise ValueError(
                "spill_enable requires result_cache_max_bytes > 0 "
                "(the spill hierarchy extends the result cache — with "
                "the cache off there is nothing to demote)")
        if self.spill_host_max_bytes < 1:
            raise ValueError(
                f"spill_host_max_bytes must be >= 1, "
                f"got {self.spill_host_max_bytes!r}")
        if self.spill_disk_hits < 0:
            raise ValueError(
                f"spill_disk_hits must be >= 0 (0 ages everything "
                f"the host tier evicts), got {self.spill_disk_hits!r}")

    def replace(self, **kw: Any) -> "MatrelConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_env(base: Optional["MatrelConfig"] = None) -> "MatrelConfig":
        """A config from ``MATREL_*`` environment variables over ``base``
        (the JAX package's parsing), validated as at construction."""
        cfg = base or MatrelConfig()
        overrides: dict = {}
        for f in dataclasses.fields(MatrelConfig):
            env_key = "MATREL_" + f.name.upper()
            if env_key not in os.environ:
                continue
            raw = os.environ[env_key]
            if f.type in ("int", int):
                overrides[f.name] = int(raw)
            elif f.type in ("float", float):
                overrides[f.name] = float(raw)
            elif f.type in ("bool", bool):
                overrides[f.name] = raw.lower() in ("1", "true", "yes", "on")
            elif f.name in ("mesh_shape", "axis_cost_weights"):
                conv = int if f.name == "mesh_shape" else float
                overrides[f.name] = tuple(
                    conv(p) for p in raw.replace("x", ",").split(",") if p)
            else:
                overrides[f.name] = raw
        return cfg.replace(**overrides) if overrides else cfg

    @staticmethod
    def from_dict(d: Mapping[str, Any],
                  base: Optional["MatrelConfig"] = None) -> "MatrelConfig":
        """``base`` with the fields of ``d`` replaced; an unknown key
        raises KeyError; the values are validated as at construction."""
        cfg = base or MatrelConfig()
        valid = {f.name for f in dataclasses.fields(MatrelConfig)}
        unknown = set(d) - valid
        if unknown:
            raise KeyError(f"unknown MatrelConfig keys: {sorted(unknown)}")
        return cfg.replace(**dict(d))


#: The SpGEMM kernel-registry vocabulary — what
#: ``spgemm_kernel_override`` validates against at construction
#: (``tests/test_torch_kernel_registry.py`` pins it equal to the ids of
#: ``ops/kernel_registry.REGISTRY``).
SPGEMM_KERNEL_IDS = ("xla_gather", "pallas_generic", "pallas_band",
                     "pallas_cluster", "pallas_powerlaw")

#: The per-query accuracy-SLA vocabulary (docs/PRECISION.md): named
#: levels plus the explicit-dtype spellings that pin one tier.
PRECISION_SLAS = ("default", "exact", "high", "fast",
                  "float32", "bfloat16", "bf16x3", "int32", "int8")


def normalize_sla(sla) -> str:
    """Validate + normalise one precision-SLA value (config field or
    per-query ``precision=`` argument). None → "default"."""
    if sla is None:
        return "default"
    s = str(sla).lower().strip()
    if s in ("bf16", "bfloat16"):
        s = "bfloat16"
    if s == "f32":
        s = "float32"
    if s not in PRECISION_SLAS:
        raise ValueError(
            f"precision SLA must be one of {PRECISION_SLAS} (or 'bf16'/"
            f"'f32' aliases), got {sla!r}")
    return s


def parse_tenant_weights(spec) -> dict:
    """Validate + parse a ``serve_tenant_weights`` spec
    (``"gold:4,silver:2,bronze:1"``) into ``{tenant: float weight}``.
    Empty/None → {} (one implicit tenant, the FIFO). Raises
    ``ValueError`` on empty names, duplicate names, or non-positive
    weights (the JAX package's parser)."""
    if not spec:
        return {}
    out: dict = {}
    for part in (p.strip() for p in str(spec).split(",")):
        if not part:
            continue
        name, sep, w = part.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"serve_tenant_weights entry {part!r} must be "
                f"'name:weight'")
        if name in out:
            raise ValueError(
                f"serve_tenant_weights names tenant {name!r} twice")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(
                f"serve_tenant_weights weight {w!r} (tenant "
                f"{name!r}) is not a number") from None
        if not weight > 0.0:
            raise ValueError(
                f"serve_tenant_weights weight for {name!r} must be "
                f"> 0, got {weight!r}")
        out[name] = weight
    if not out:
        raise ValueError(
            f"serve_tenant_weights {spec!r} names no tenants")
    return out


#: The SLO objective vocabulary: latency targets at named quantiles
#: (milliseconds) plus availability.
SLO_OBJECTIVES = ("avail", "p50_ms", "p90_ms", "p95_ms", "p99_ms")


def parse_slo_targets(spec) -> dict:
    """Validate + parse an ``slo_targets`` spec
    (``"gold:p95_ms=50,avail=0.999;bronze:avail=0.99"``) into
    ``{tenant: {objective: float target}}``. Empty/None → {} (no
    objectives, no monitors). Raises ``ValueError`` on unknown
    objectives, duplicate tenants, availability targets outside (0, 1)
    or non-positive latency targets (the JAX package's parser)."""
    if not spec:
        return {}
    out: dict = {}
    for tpart in (p.strip() for p in str(spec).split(";")):
        if not tpart:
            continue
        tenant, sep, objs = tpart.partition(":")
        tenant = tenant.strip()
        if not sep or not tenant:
            raise ValueError(
                f"slo_targets entry {tpart!r} must be "
                f"'tenant:objective=target[,objective=target...]'")
        if tenant in out:
            raise ValueError(
                f"slo_targets names tenant {tenant!r} twice")
        targets: dict = {}
        for opart in (p.strip() for p in objs.split(",")):
            if not opart:
                continue
            obj, osep, val = opart.partition("=")
            obj = obj.strip()
            if not osep or obj not in SLO_OBJECTIVES:
                raise ValueError(
                    f"slo_targets objective {opart!r} (tenant "
                    f"{tenant!r}) must be one of {SLO_OBJECTIVES} "
                    f"with '=target'")
            if obj in targets:
                raise ValueError(
                    f"slo_targets names objective {obj!r} twice for "
                    f"tenant {tenant!r}")
            try:
                target = float(val)
            except ValueError:
                raise ValueError(
                    f"slo_targets target {val!r} (tenant {tenant!r}, "
                    f"objective {obj!r}) is not a number") from None
            if obj == "avail":
                if not (0.0 < target < 1.0):
                    raise ValueError(
                        f"slo_targets avail target for {tenant!r} "
                        f"must be in (0, 1), got {target!r}")
            elif not target > 0.0:
                raise ValueError(
                    f"slo_targets latency target {obj} for "
                    f"{tenant!r} must be > 0 ms, got {target!r}")
            targets[obj] = target
        if not targets:
            raise ValueError(
                f"slo_targets entry {tpart!r} declares no objectives")
        out[tenant] = targets
    if not out:
        raise ValueError(f"slo_targets {spec!r} names no tenants")
    return out


_default_config = MatrelConfig()


def default_config() -> MatrelConfig:
    return _default_config


def set_default_config(cfg: MatrelConfig) -> None:
    """Replace the process-wide default config (what every call without
    a ``config`` argument reads)."""
    global _default_config
    _default_config = cfg


def pallas_enabled(config: Optional[MatrelConfig] = None) -> bool:
    """Do the hand-written kernels run (the counterpart of the JAX
    package's ``pallas_enabled``)? The port's gate is ``use_pallas``
    alone: a CUDA tensor launches the kernel, a CPU tensor runs the
    kernel's plain version (the JAX package's interpret mode), so no
    backend check applies and ``pallas_interpret`` changes nothing."""
    return (config or default_config()).use_pallas
