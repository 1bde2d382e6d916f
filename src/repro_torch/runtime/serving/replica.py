"""One engine replica behind the router (port of ``repro/runtime/serving/
replica.py``: ``StepClock`` and ``Replica``).

N independent :class:`~repro_torch.runtime.serving.engine.ServingEngine`
instances, each with its own arena, scheduler, dispatch queue, captured
graphs and health ladder, sit behind
:class:`~repro_torch.runtime.serving.router.Router`.  A :class:`Replica`
is the thin shell the router talks to: the engine plus its placement
signals (page pressure, unfinished load, health rung, prefix residency)
and the evacuation hook for drain with migration.

Every replica is built from the same model object and the same parameter
tensors (never a copy: the weights are on the card once, whatever the
fleet size), and the kernel libraries are built once per process; each
replica captures its own graphs into its own pools.  Every replica
resolves default seeds from the same ``base_seed``, and with the (seed,
absolute position) key contract a stream does not depend on where it is
placed: the router can place a request anywhere, or move it mid-flight,
without changing a token.  In this port all replicas share the one card
(a mesh of replicas waits for ROADMAP 1.11).

:class:`StepClock` is the deterministic replica-local clock: each engine
step advances it one quantum, so TTFT and deadlines are counted in steps
of that replica rather than on the host's wall clock.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.engine import ServingEngine
from repro_torch.runtime.serving.health import HealthState
from repro_torch.runtime.serving.request import Request, RequestState


class StepClock:
    """A clock that moves only when its replica steps.  Injected as the
    engine's ``clock``: submission times, TTFT and deadlines are then in
    steps of this replica, whatever the driving process interleaves."""

    def __init__(self, dt: float = 1.0):
        if dt <= 0:
            raise ValueError(f"StepClock dt must be > 0, got {dt}")
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.dt


class Replica:
    """A router-owned engine: placement signals and lifecycle hooks."""

    def __init__(self, rid: int, model, cfg, params, *,
                 config: EngineConfig, clock=None):
        self.rid = rid
        self._clock = clock
        self.engine = ServingEngine(model, cfg, params, config=config,
                                    clock=clock)

    # -- placement signals ---------------------------------------------------
    @property
    def health(self) -> HealthState:
        return self.engine._health_state

    def pressure(self) -> float:
        """Page pressure: the fraction of the page pool in use."""
        return self.engine.cache_mgr.utilization()

    def unfinished(self) -> int:
        """Requests submitted here and not departed (waiting + resident):
        the load signal that breaks pressure ties before any page is
        taken."""
        sched = self.engine.scheduler
        return len(sched.waiting) + len(sched.running)

    def prefix_len(self, prompt) -> int:
        """The longest prefix of ``prompt`` resident in this replica's
        prefix index (0 with sharing off): the affinity probe."""
        eng = self.engine
        if not eng.prefix_sharing:
            return 0
        m = eng.cache_mgr.lookup(prompt, int(prompt.shape[0]) - 1,
                                 require_snapshot=eng._needs_state_snapshot)
        return m.shared_len if m else 0

    # -- service -------------------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        return self.engine.submit(request)

    def step(self) -> None:
        """One engine step, with ``ServingEngine.run``'s forced retire when
        nothing is resident but readbacks are in flight; advances a
        :class:`StepClock` if one drives this replica."""
        eng = self.engine
        eng.step()
        if not eng.scheduler.running and eng._pending:
            eng._queue.drain()
            eng._drain_pending(limit=0)
        tick = getattr(self._clock, "tick", None)
        if tick is not None:
            tick()

    def settle(self) -> None:
        """Retire every step in flight (the end of a run)."""
        self.engine._queue.drain()
        self.engine._drain_pending(limit=0)

    @property
    def done(self) -> bool:
        return self.engine.scheduler.all_done

    def evacuate(self) -> list:
        """``ServingEngine.evacuate``: every unfinished request departs
        MIGRATED and comes back for re-placement."""
        return self.engine.evacuate()

    def result_state(self, uid) -> Optional[RequestState]:
        return self.engine._results.get(uid)

    def stats_row(self) -> dict:
        """One per-replica stats row (the serve CLI's replica lines)."""
        eng = self.engine
        return {
            "replica": self.rid,
            "health": self.health.name,
            "pressure": round(self.pressure(), 3),
            "requests": eng.stats["requests"],
            "tokens_out": eng.stats["tokens_out"],
            "steps": eng._tick,
            "prefills": eng.stats["prefills"],
            "preempted": eng.scheduler.stats["preempted"],
            "migrated": eng.stats["migrated"],
            "failed": eng.stats["failed"],
        }
