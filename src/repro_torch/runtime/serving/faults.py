"""Deterministic fault injection for the serving engine (port of
``repro/runtime/serving/faults.py``, the whole file).

Every injection site fires as a pure function of (fault seed, site,
consult index), the shape of the sampling contract (a draw's key folds
only (request seed, absolute position)): the same :class:`FaultPlan` and
the same traffic replay the identical failure interleaving, and the
surviving requests' streams equal the fault-free run's.  The draw is
``hashlib.blake2b`` over ``"{seed}:{site}:{consult}"`` as in the
reference, so for one plan every consult sequence equals the reference's.

Injection sites (threaded through the engine and the page accountant):

``alloc``    a page allocation / extension is refused
             (``AllocResult(False, reason="fault-injected")``): admission
             backs off, growth preempts
``chunk``    a prompt chunk's dispatch is dropped for this step (the slot
             stalls a step; its cursor does not move)
``decode``   the whole decode step / speculative round is dropped for this
             step (positions do not move: no stream diverges)
``logits``   one RUNNING slot's arena region is filled with NaN before the
             step, so its logits go non-finite and the quarantine departs
             it ``Status.FAILED``
``draft``    a speculative round's proposals are corrupted (self-correcting:
             verification commits the target's own draws, only the
             acceptance rate pays)

Sites at rate 1.0 on ``chunk`` / ``decode`` livelock by construction (the
dispatch never happens); bound such plans with ``max_fires``.  None of
these sites stands for a device failure: a CUDA error, a failed capture or
a kernel that fails to build is raised, never counted here.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Union

#: the injection sites the engine threads through its hot path
SITES = ("alloc", "chunk", "decode", "logits", "draft")


def _u01(seed: int, site: str, consult: int) -> float:
    """Uniform [0, 1) as a pure function of (seed, site, consult index) —
    the fault analogue of the (seed, position) sampling key fold."""
    h = hashlib.blake2b(f"{seed}:{site}:{consult}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One site's firing policy.

    ``rate``       per-consult fire probability in [0, 1]
    ``seed``       per-site seed override (None: the plan's seed)
    ``max_fires``  stop firing after this many hits (None: unbounded) —
                   required to bound rate-1.0 plans on dispatch sites
    """
    rate: float
    seed: Optional[int] = None
    max_fires: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"FaultSpec.rate must be in [0, 1], "
                             f"got {self.rate}")
        if self.max_fires is not None and self.max_fires < 0:
            raise ValueError(f"FaultSpec.max_fires must be >= 0 or None, "
                             f"got {self.max_fires}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded set of per-site fault specs (``EngineConfig.faults``).

    ``sites`` is a tuple of ``(site_name, FaultSpec)`` pairs so the plan
    stays hashable inside the frozen :class:`EngineConfig`; build one with
    :meth:`of` (rates or specs by keyword) or :func:`parse_fault_plan`
    (the ``site:rate[:seed]`` CLI syntax).
    """
    seed: int = 0
    sites: tuple = ()

    def __post_init__(self):
        for name, spec in self.sites:
            if name not in SITES:
                raise ValueError(
                    f"unknown fault site {name!r}; valid sites: "
                    f"{', '.join(SITES)}")
            if not isinstance(spec, FaultSpec):
                raise ValueError(
                    f"site {name!r}: expected a FaultSpec, "
                    f"got {type(spec).__name__}")
        names = [n for n, _ in self.sites]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate fault sites in plan: {names}")

    @classmethod
    def of(cls, seed: int = 0,
           **sites: Union[float, FaultSpec]) -> "FaultPlan":
        """``FaultPlan.of(seed=7, alloc=0.1, logits=FaultSpec(1.0,
        max_fires=1))`` — bare rates become ``FaultSpec(rate)``."""
        pairs = tuple(
            (name, spec if isinstance(spec, FaultSpec) else FaultSpec(spec))
            for name, spec in sites.items())
        return cls(seed=seed, sites=pairs)

    def spec(self, site: str) -> Optional[FaultSpec]:
        for name, s in self.sites:
            if name == site:
                return s
        return None

    def offset(self, delta: int) -> "FaultPlan":
        """A copy with every seed — the plan's and any per-site overrides
        — shifted by ``delta``.  The router gives replica *r* the plan
        ``faults.offset(r * stride)`` so each replica draws an independent
        deterministic fault stream: one replica's storm cannot line up
        with (or perturb) a sibling's, yet every replica's interleaving
        stays individually replayable."""
        if delta == 0:
            return self
        sites = tuple(
            (name, s if s.seed is None
             else dataclasses.replace(s, seed=s.seed + delta))
            for name, s in self.sites)
        return dataclasses.replace(self, seed=self.seed + delta,
                                   sites=sites)


def parse_fault_plan(text: str, seed: int = 0) -> FaultPlan:
    """Parse the serve.py ``--fault-plan`` syntax: comma-separated
    ``site:rate[:seed]`` entries, e.g. ``"alloc:0.05,logits:0.01:7"``."""
    pairs = []
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"fault-plan entry {entry!r}: expected site:rate[:seed]")
        site, rate = parts[0], float(parts[1])
        site_seed = int(parts[2]) if len(parts) == 3 else None
        pairs.append((site, FaultSpec(rate, seed=site_seed)))
    return FaultPlan(seed=seed, sites=tuple(pairs))


class FaultInjector:
    """Stateful consult counters around a pure firing function.

    ``fire(site)`` advances the site's consult counter and reports whether
    the fault fires at that consult — a pure function of (site seed, site,
    consult index), so the engine's deterministic host scheduling makes the
    whole failure interleaving replayable.  ``choose(site, n)`` picks a
    victim index deterministically on a separate counter (the pick never
    perturbs the firing sequence).  ``fired`` counts hits per site for
    stats/health.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._specs = {name: spec for name, spec in plan.sites}
        self._consults = {name: 0 for name in self._specs}
        self._picks = {name: 0 for name in self._specs}
        self.fired = {name: 0 for name in self._specs}

    def active(self, site: str) -> bool:
        spec = self._specs.get(site)
        return spec is not None and spec.rate > 0.0

    def fire(self, site: str) -> bool:
        spec = self._specs.get(site)
        if spec is None:
            return False
        c = self._consults[site]
        self._consults[site] = c + 1
        if spec.max_fires is not None and self.fired[site] >= spec.max_fires:
            return False
        seed = spec.seed if spec.seed is not None else self.plan.seed
        if _u01(seed, site, c) < spec.rate:
            self.fired[site] += 1
            return True
        return False

    def choose(self, site: str, n: int) -> int:
        """Deterministic victim pick in [0, n) for a fired ``site``."""
        if n < 1:
            raise ValueError(f"choose({site!r}, {n}): need n >= 1")
        spec = self._specs.get(site)
        seed = (spec.seed if spec is not None and spec.seed is not None
                else self.plan.seed)
        c = self._picks.get(site, 0)
        self._picks[site] = c + 1
        h = hashlib.blake2b(f"{seed}:{site}#pick:{c}".encode(),
                            digest_size=8)
        return int.from_bytes(h.digest(), "big") % n

    def total_fired(self) -> int:
        return sum(self.fired.values())
