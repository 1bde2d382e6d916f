"""Replica health: a degradation ladder fed by engine counters (port of
``repro/runtime/serving/health.py``, the whole file).

The monitor walks a four-rung ladder

    HEALTHY -> DEGRADED -> SHEDDING -> DRAINING

one rung per engine step toward whatever rung the current signals demand,
and recovers one rung after ``recover_after`` consecutive clean steps, so
a transient spike costs a few degraded steps, not a flap storm.  Each rung
adds one mitigation to the rung below's:

``DEGRADED``   speculative decoding is off (the engine runs queue decode).
               Safe, not just cheap: acceptance verifies against the
               target's own draws, so a draft arena gone stale while
               speculation is off only lowers acceptance when it resumes
``SHEDDING``   the prefill budget shrinks (``shed_prefill_frac``) and new
               admissions are refused (``ServingEngine.submit`` raises
               :class:`~repro_torch.runtime.serving.scheduler.
               AdmissionRejected`)
``DRAINING``   waiting requests fail (``"draining"``); residents run to
               completion, so the engine converges and a router routes
               around the replica

Signals (one :meth:`HealthMonitor.observe` per engine step): page
pressure, preemption and deadline-miss rates over a sliding window, and
consecutive faulted steps (injected, or detected like a NaN quarantine).
Pure host logic; every transition lands in ``transitions``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class HealthState(enum.IntEnum):
    """Ordered rungs: comparisons (``state >= SHEDDING``) gate mitigations."""
    HEALTHY = 0
    DEGRADED = 1
    SHEDDING = 2
    DRAINING = 3


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds for the ladder (``EngineConfig.health``).

    ``window``             steps of history for the preemption / miss rates
    ``pressure_degraded``  arena page utilization that degrades the replica
    ``pressure_shedding``  utilization that starts shedding admissions
    ``preempt_degraded``   preemptions per step (windowed) that degrade
    ``miss_degraded``      deadline misses per step (windowed) that degrade
    ``fault_degraded``     consecutive faulted steps that degrade
    ``fault_shedding``     consecutive faulted steps that shed
    ``fault_draining``     consecutive faulted steps that drain
    ``shed_steps_draining``steps spent at SHEDDING (without recovery) that
                           escalate to DRAINING; None disables the escalation
    ``recover_after``      consecutive clean steps to step down one rung
    ``shed_prefill_frac``  prefill-budget multiplier at >= SHEDDING
    """
    window: int = 16
    pressure_degraded: float = 0.85
    pressure_shedding: float = 0.97
    preempt_degraded: float = 0.25
    miss_degraded: float = 0.25
    fault_degraded: int = 2
    fault_shedding: int = 4
    fault_draining: int = 8
    shed_steps_draining: Optional[int] = 64
    recover_after: int = 8
    shed_prefill_frac: float = 0.5

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"HealthConfig.window must be >= 1, "
                             f"got {self.window}")
        for name in ("pressure_degraded", "pressure_shedding",
                     "shed_prefill_frac"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"HealthConfig.{name} must be in (0, 1], "
                                 f"got {v}")
        if self.pressure_shedding < self.pressure_degraded:
            raise ValueError(
                f"HealthConfig.pressure_shedding "
                f"({self.pressure_shedding}) must be >= pressure_degraded "
                f"({self.pressure_degraded})")
        if not 0 < self.fault_degraded <= self.fault_shedding \
                <= self.fault_draining:
            raise ValueError(
                f"HealthConfig fault thresholds must satisfy 0 < degraded "
                f"<= shedding <= draining, got {self.fault_degraded}/"
                f"{self.fault_shedding}/{self.fault_draining}")
        if self.recover_after < 1:
            raise ValueError(f"HealthConfig.recover_after must be >= 1, "
                             f"got {self.recover_after}")
        if self.shed_steps_draining is not None \
                and self.shed_steps_draining < 1:
            raise ValueError(
                f"HealthConfig.shed_steps_draining must be >= 1 or None, "
                f"got {self.shed_steps_draining}")


class HealthMonitor:
    """The ladder walk.  Device-free, engine-agnostic, unit-testable:
    feed it one :meth:`observe` per step with *cumulative* preemption /
    timeout counters (it diffs internally) and the step's fault flag."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self.state = HealthState.HEALTHY
        self.transitions: list[tuple[int, str, str, str]] = []
        self._preempt_hist: list[int] = []
        self._miss_hist: list[int] = []
        self._last_preempt = 0
        self._last_miss = 0
        self._consec_faults = 0
        self._clean_steps = 0
        self._shed_steps = 0

    # -- signal -> target rung ----------------------------------------------
    def _target(self, pressure: float) -> tuple[HealthState, str]:
        cfg = self.config
        w = max(1, len(self._preempt_hist))
        preempt_rate = sum(self._preempt_hist) / w
        miss_rate = sum(self._miss_hist) / w
        if self._consec_faults >= cfg.fault_draining:
            return HealthState.DRAINING, "consecutive-faults"
        if cfg.shed_steps_draining is not None \
                and self._shed_steps >= cfg.shed_steps_draining:
            return HealthState.DRAINING, "stuck-shedding"
        if self._consec_faults >= cfg.fault_shedding:
            return HealthState.SHEDDING, "consecutive-faults"
        if pressure >= cfg.pressure_shedding:
            return HealthState.SHEDDING, "arena-pressure"
        if self._consec_faults >= cfg.fault_degraded:
            return HealthState.DEGRADED, "consecutive-faults"
        if pressure >= cfg.pressure_degraded:
            return HealthState.DEGRADED, "arena-pressure"
        if preempt_rate >= cfg.preempt_degraded:
            return HealthState.DEGRADED, "preemption-rate"
        if miss_rate >= cfg.miss_degraded:
            return HealthState.DEGRADED, "deadline-misses"
        return HealthState.HEALTHY, "clean"

    # -- the per-step walk ---------------------------------------------------
    def observe(self, *, step: int, pressure: float, preemptions: int,
                timeouts: int, step_fault: bool) -> HealthState:
        """One engine step's signals; returns the (possibly new) state.

        ``preemptions`` / ``timeouts`` are cumulative counters;
        ``step_fault`` flags an injected or detected fault this step."""
        cfg = self.config
        self._preempt_hist.append(preemptions - self._last_preempt)
        self._miss_hist.append(timeouts - self._last_miss)
        self._last_preempt, self._last_miss = preemptions, timeouts
        if len(self._preempt_hist) > cfg.window:
            self._preempt_hist.pop(0)
            self._miss_hist.pop(0)
        self._consec_faults = self._consec_faults + 1 if step_fault else 0

        target, reason = self._target(pressure)
        old = self.state
        if target > self.state:
            # climb one rung per step toward the demanded rung
            self.state = HealthState(self.state + 1)
            self._clean_steps = 0
        elif target < self.state:
            # recover one rung only after a run of clean observations
            self._clean_steps += 1
            if self._clean_steps >= cfg.recover_after:
                self.state = HealthState(self.state - 1)
                self._clean_steps = 0
                reason = "recovered"
        else:
            self._clean_steps = 0
        self._shed_steps = (self._shed_steps + 1
                            if self.state >= HealthState.SHEDDING else 0)
        if self.state != old:
            self.transitions.append((step, old.name, self.state.name,
                                     reason))
        return self.state
