"""Deterministic, seeded fault injection at the engine's choke points —
the counterpart of ``matrel_tpu/resilience/faults.py``.

The chaos-engineering half of the resilience layer: a spec string
(``config.fault_inject``) describes WHICH instrumented site faults,
WHAT kind, and WHEN (per-call probability from a seeded stream, or an
exact nth-call trigger) — so a failure schedule is reproducible
bit-for-bit across runs. The port's injector is the JAX package's,
draw for draw: each rule's stream is Python ``random`` seeded by
``(fault_inject_seed, site, rule index, rule text)``, so one spec fires
on the same call indices in both packages
(``tests/test_torch_resilience_ladder.py``).

Spec grammar (semicolon-separated rules)::

    site:kind[:p=0.25][:n=3][:max=5]

    site  ∈ SITES (below) or "all" (every site)
    kind  ∈ {"transient", "fatal"}  — drives errors.classify
    p=F   per-call fire probability, drawn from a per-rule RNG seeded
          by (config.fault_inject_seed, site, rule index)
    n=K   fire exactly on the K-th check of that site (1-based)
    max=M cap total fires for the rule (p-rules default unbounded,
          n-rules fire once by construction)

Exactly one of p=/n= per rule. Parsing is VALIDATED at config
construction — a typo'd site name must fail loudly, not silently
inject nothing.

Instrumented sites (each named after the choke point it lives at)::

    compile      session._compile_entry / _compile_multi_entry
    lower        the executor's per-node annotate() site (fires as
                 each node lowers — every run on the port, which has
                 no trace; the JAX package's fires once per trace)
    strategy     strategies.run_matmul entry (every product)
    execute      the session's plan.run() dispatch (host side,
                 per attempt — the main retryable site)
    rc_probe     session._rc_admit (result-cache consult)
    serve_admit  the serve pipeline's admission worker
    checkpoint   utils/checkpoint.CheckpointManager save / restore

The OFF contract is structural: with ``config.fault_inject == ""``
(the default) :func:`check` returns after one string truthiness test
and NO injector, rule, or RNG object is ever constructed —
``tests/test_torch_resilience_ladder.py`` poisons
``FaultInjector.__init__`` to prove it. Injectors are memoised per (spec, seed) process-wide so the
executor/strategy/checkpoint sites — which see only a config, never a
session — share one deterministic schedule with the session sites.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from matrel_tpu_torch.resilience.errors import InjectedFault
from matrel_tpu_torch.utils import lockdep

#: The instrumented-site vocabulary (see module docstring).
SITES = ("compile", "lower", "strategy", "execute", "rc_probe",
         "serve_admit", "checkpoint")

KINDS = ("transient", "fatal")


class FaultRule:
    """One parsed spec rule with its per-rule seeded stream + counters.

    Counters are per-rule, not per-injector: two rules on one site each
    see every check of that site and fire independently."""

    __slots__ = ("site", "kind", "p", "n", "max_fires", "spec",
                 "calls", "fires", "_rng")

    def __init__(self, site: str, kind: str, p: Optional[float],
                 n: Optional[int], max_fires: Optional[int],
                 spec: str, seed: int, index: int):
        self.site = site
        self.kind = kind
        self.p = p
        self.n = n
        self.max_fires = max_fires if max_fires is not None else (
            1 if n is not None else None)
        self.spec = spec
        self.calls = 0
        self.fires = 0
        # per-rule stream: determinism survives reordering of OTHER
        # rules in the spec (each rule's draws depend only on its own
        # site/index/seed and its own call sequence)
        self._rng = random.Random(f"{seed}|{site}|{index}|{spec}")

    def should_fire(self) -> bool:
        self.calls += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.n is not None:
            fire = self.calls == self.n
        else:
            fire = self._rng.random() < self.p
        if fire:
            self.fires += 1
        return fire


def parse_spec(spec: str) -> List[dict]:
    """Validate + normalise a fault spec into rule dicts. Raises
    ``ValueError`` on any malformed rule (config.__post_init__ calls
    this so a typo fails at construction, the obs_level precedent)."""
    rules: List[dict] = []
    for part in (p.strip() for p in spec.split(";")):
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"fault_inject rule {part!r} needs at least site:kind")
        site, kind = fields[0].strip(), fields[1].strip()
        if site != "all" and site not in SITES:
            raise ValueError(
                f"fault_inject site {site!r} not in {SITES + ('all',)}")
        if kind not in KINDS:
            raise ValueError(
                f"fault_inject kind {kind!r} not in {KINDS}")
        p = n = max_fires = None
        for opt in fields[2:]:
            opt = opt.strip()
            if not opt:
                continue
            k, _, v = opt.partition("=")
            if k == "p":
                p = float(v)
                if not (0.0 < p <= 1.0):
                    raise ValueError(
                        f"fault_inject p={v} must be in (0, 1]")
            elif k == "n":
                n = int(v)
                if n < 1:
                    raise ValueError(
                        f"fault_inject n={v} must be >= 1")
            elif k == "max":
                max_fires = int(v)
                if max_fires < 1:
                    raise ValueError(
                        f"fault_inject max={v} must be >= 1")
            else:
                raise ValueError(
                    f"fault_inject option {opt!r} unknown "
                    f"(p=/n=/max=)")
        if (p is None) == (n is None):
            raise ValueError(
                f"fault_inject rule {part!r} needs exactly one of "
                f"p= or n=")
        sites = SITES if site == "all" else (site,)
        for s in sites:
            rules.append({"site": s, "kind": kind, "p": p, "n": n,
                          "max": max_fires, "spec": part})
    return rules


class FaultInjector:
    """The rules of one (spec, seed) pair with their live counters.
    ``check(site)`` raises :class:`InjectedFault` when a rule fires;
    thread-safe (the serve worker and the caller's thread share one
    schedule)."""

    def __init__(self, spec: str, seed: int):
        self.spec = spec
        self.seed = seed
        self._lock = lockdep.make_lock("resilience.fault_plan")
        self._by_site: Dict[str, List[FaultRule]] = {}
        for i, r in enumerate(parse_spec(spec)):
            rule = FaultRule(r["site"], r["kind"], r["p"], r["n"],
                             r["max"], r["spec"], seed, i)
            self._by_site.setdefault(r["site"], []).append(rule)

    def check(self, site: str) -> None:
        rules = self._by_site.get(site)
        if not rules:
            return
        with self._lock:
            # EVERY rule sees every check of its site before anything
            # raises — one rule firing must not skew a sibling rule's
            # call count (an n=K rule fires on the site's K-th check
            # regardless of what other rules did); the first firing
            # rule in spec order wins the raise
            first = None
            for rule in rules:
                if rule.should_fire() and first is None:
                    first = rule
            if first is not None:
                raise InjectedFault(site, first.kind, first.calls,
                                    rule=first.spec)

    def stats(self) -> Dict[str, dict]:
        """Per-site {calls, fires} — the chaos drill's coverage
        evidence (every instrumented site must actually be checked AND
        must actually have fired under the drill's schedule)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for site, rules in self._by_site.items():
                out[site] = {
                    "calls": max(r.calls for r in rules),
                    "fires": sum(r.fires for r in rules),
                }
        return out


_REGISTRY: Dict[tuple, FaultInjector] = {}
_REGISTRY_LOCK = lockdep.make_lock("resilience.fault_registry")


def injector_for(config) -> Optional[FaultInjector]:
    """The process-shared injector for a config's (spec, seed), or
    None when injection is off. Shared so every site — session-level
    or module-level — advances ONE deterministic schedule."""
    spec = getattr(config, "fault_inject", "") if config is not None \
        else ""
    if not spec:
        return None
    key = (spec, getattr(config, "fault_inject_seed", 0))
    inj = _REGISTRY.get(key)
    if inj is None:
        with _REGISTRY_LOCK:
            inj = _REGISTRY.get(key)
            if inj is None:
                inj = _REGISTRY[key] = FaultInjector(*key)
    return inj


def check(site: str, config) -> None:
    """The one call every instrumented choke point makes. With the
    default config this is a single attribute read + truthiness test —
    no objects, no locks (the zero-overhead-when-off contract)."""
    if config is None or not getattr(config, "fault_inject", ""):
        return
    injector_for(config).check(site)


def reset() -> None:
    """Forget every injector's schedule state (tests: a fresh
    deterministic run needs fresh counters/streams)."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
