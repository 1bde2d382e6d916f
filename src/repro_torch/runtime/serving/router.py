"""Multi-replica front end: one dispatcher over N engine replicas (port of
``repro/runtime/serving/router.py``: ``RouterConfig``,
``PLACEMENT_POLICIES`` and ``Router``).

A :class:`Router` owns N :class:`~repro_torch.runtime.serving.replica.
Replica` engines, each its own arena, scheduler, dispatch queue and graphs
on the one card, and decides *where* each request runs.  Placement never
decides *what* it generates: every stream is a pure function of (seed,
absolute position), and all replicas share one model object, one set of
parameter tensors and one ``base_seed``, so the router can place, bounce
or migrate a request mid-flight without changing a token.

Placement policies (``RouterConfig.placement``):

``least-pressure``  the replica with the lowest page utilization (ties:
                    fewest unfinished requests, then lowest rid); never a
                    SHEDDING / DRAINING one.
``round-robin``     a fair cursor over the active healthy replicas in
                    join order.
``affinity``        a request's ``session`` pins it to the replica that
                    served the session before; with prefix sharing on, an
                    unpinned request goes where the longest prefix of its
                    prompt is resident.  Falls back to least-pressure.

A replica at or above SHEDDING on its own ladder is excluded from every
candidate set.  An affinity pin may still *try* its replica; if the engine
bounces the request with :class:`AdmissionRejected`,
:meth:`Router.submit` retries exactly once on the best non-affinity
replica and only then re-raises, with the refusing replica's id attached.

Lifecycle rides on :class:`~repro_torch.runtime.elastic.ElasticGroup`:
:meth:`Router.drain` takes a replica out of placement at once and lets its
residents finish in place, or evacuates them (``migrate=True``) onto the
survivors, whose recompute replays each stream from the prompt;
:meth:`Router.join` adds a fresh replica.  Faults stay replica-local:
replica *r* runs the plan seed-offset by ``r * fault_seed_stride``.

All replicas live on the one card: ``mesh=`` (the reference's ``data``
axis shards) raises ``NotImplementedError`` until ROADMAP 1.11.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.runtime.elastic import ElasticGroup, MemberState
from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.health import HealthState
from repro_torch.runtime.serving.replica import Replica
from repro_torch.runtime.serving.request import Request, RequestState
from repro_torch.runtime.serving.scheduler import AdmissionRejected

#: placement policies ``RouterConfig.placement`` accepts
PLACEMENT_POLICIES = ("least-pressure", "round-robin", "affinity")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Construction-time router surface (mirrors ``EngineConfig``).

    ``replicas``           initial fleet size (``join()`` can grow it)
    ``placement``          one of :data:`PLACEMENT_POLICIES`
    ``engine``             the per-replica ``EngineConfig``; replica *r*
                           gets it verbatim except ``faults`` (see below)
    ``retry_rejected``     retry a bounced submit once on a non-affinity
                           replica before re-raising (the fleet-capacity
                           fix; turn off to surface every rejection)
    ``fault_seed_stride``  replica *r* runs ``faults.offset(r * stride)``
                           so fault streams are replica-local; 0 gives
                           every replica the identical plan
    """
    replicas: int = 1
    placement: str = "least-pressure"
    engine: EngineConfig = EngineConfig()
    retry_rejected: bool = True
    fault_seed_stride: int = 1

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"RouterConfig.replicas must be >= 1, "
                             f"got {self.replicas}")
        if self.placement not in PLACEMENT_POLICIES:
            raise ValueError(
                f"RouterConfig.placement must be one of "
                f"{PLACEMENT_POLICIES}, got {self.placement!r}")
        if self.fault_seed_stride < 0:
            raise ValueError(f"RouterConfig.fault_seed_stride must be "
                             f">= 0, got {self.fault_seed_stride}")
        if not isinstance(self.engine, EngineConfig):
            raise ValueError(f"RouterConfig.engine must be an "
                             f"EngineConfig, got "
                             f"{type(self.engine).__name__}")

    def replace(self, **kw) -> "RouterConfig":
        return dataclasses.replace(self, **kw)


class Router:
    """N engine replicas behind one submit/step/run surface.

    ``model``/``cfg``/``params`` are shared by every replica: one model
    object, its kernels built once, and one set of parameter tensors on
    the card (no replica copies a weight); sharing ``base_seed`` makes
    default-seed sampling placement-invariant.

    ``mesh``: the reference assigns replicas ``data``-axis device shards;
    this port keeps every replica on the one card, and a mesh raises
    ``NotImplementedError`` (ROADMAP 1.11).  ``clock_factory(rid)``
    (optional) builds each replica's clock, e.g. ``lambda rid:
    StepClock()`` for step-counted TTFT.  ``replica_factory`` (optional)
    overrides replica construction; tests inject duck-typed fakes here.
    """

    def __init__(self, model=None, cfg=None, params=None, *,
                 config: RouterConfig, mesh=None, clock_factory=None,
                 replica_factory=None):
        if mesh is not None:
            raise NotImplementedError(
                "Router(mesh=...): replicas on a device mesh wait for the "
                "multi-device slice (ROADMAP 1.11); every replica of this "
                "port shares the one card")
        self.config = config
        self._model, self._cfg, self._params = model, cfg, params
        self._clock_factory = clock_factory
        self._replica_factory = replica_factory or Replica
        self.group = ElasticGroup()
        self.replicas: dict[int, Any] = {}
        self._next_rid = 0
        self._owner: dict[Any, int] = {}      # uid -> rid serving it
        self._sessions: dict[Any, int] = {}   # session -> last rid
        self._rr = 0                          # round-robin cursor
        self.stats = {"placed": {}, "rejected": 0, "retries": 0,
                      "migrated": 0, "drains": 0, "joins": 0}
        for _ in range(config.replicas):
            self.join()
        self.stats["joins"] = 0    # the initial fleet is not elasticity

    # -- lifecycle -----------------------------------------------------------
    def _engine_config(self, rid: int) -> EngineConfig:
        ec = self.config.engine
        if ec.faults is not None and self.config.fault_seed_stride:
            ec = ec.replace(faults=ec.faults.offset(
                rid * self.config.fault_seed_stride))
        return ec

    def join(self) -> int:
        """Build a fresh replica and add it to the placement set.  The
        returned rid is already a candidate for the next placement."""
        rid = self._next_rid
        self._next_rid += 1
        clock = self._clock_factory(rid) if self._clock_factory else None
        self.replicas[rid] = self._replica_factory(
            rid, self._model, self._cfg, self._params,
            config=self._engine_config(rid), clock=clock)
        self.group.join(rid)
        self.stats["placed"].setdefault(rid, 0)
        self.stats["joins"] += 1
        return rid

    def drain(self, rid: int, *, migrate: bool = False) -> list:
        """Remove replica ``rid`` from the placement set *now*.

        ``migrate=False``: resident/waiting requests finish in place (the
        replica keeps stepping until empty, then retires).
        ``migrate=True``: they are evacuated and resubmitted to surviving
        replicas immediately; the deterministic recompute replays each
        stream bit-identically from the prompt, so the move costs work
        but never tokens.  Returns the migrated uids (in arrival order).
        """
        if migrate and not self._placeable(exclude=(rid,)):
            raise AdmissionRejected(
                "<drain>", "no replica to migrate to", replica=rid)
        self.group.drain(rid)
        self.stats["drains"] += 1
        moved = []
        if migrate:
            for req in self.replicas[rid].evacuate():
                self._owner.pop(req.uid, None)
                self.submit(req)
                moved.append(req.uid)
            self.stats["migrated"] += len(moved)
        return moved

    # -- placement -----------------------------------------------------------
    def _placeable(self, exclude=()) -> list:
        """Candidates in join order: lifecycle-ACTIVE and below SHEDDING
        on their own health ladder."""
        return [self.replicas[rid] for rid in self.group.active()
                if rid not in exclude
                and self.replicas[rid].health < HealthState.SHEDDING]

    @staticmethod
    def _least_pressure(cands: list):
        return min(cands, key=lambda r: (r.pressure(), r.unfinished(),
                                         r.rid))

    def _affinity(self, request: Request, exclude=()):
        """The session pin, else the longest-prefix holder, else None.

        The pin only checks lifecycle (a DRAINING replica never gets new
        work) — *health* races are left to submit's bounce-and-retry, so
        the pin is honored exactly while the replica sits on the
        HEALTHY/DEGRADED rungs and bounces off it otherwise.  The prefix
        probe, by contrast, already filters to placeable replicas: an
        index hit on a shedding replica is worthless, the fork would
        never be admitted."""
        if request.session is not None:
            rid = self._sessions.get(request.session)
            if rid is not None and rid not in exclude \
                    and self.group.is_active(rid):
                return self.replicas[rid]
        best, best_len = None, 0
        for rep in self._placeable(exclude):
            ln = rep.prefix_len(request.prompt)
            if ln > best_len:
                best, best_len = rep, ln
        return best

    def _place(self, request: Request, exclude=(),
               no_affinity: bool = False):
        if self.config.placement == "affinity" and not no_affinity:
            rep = self._affinity(request, exclude)
            if rep is not None:
                return rep
        cands = self._placeable(exclude)
        if not cands:
            return None
        if self.config.placement == "round-robin" and not no_affinity:
            rep = cands[self._rr % len(cands)]
            self._rr += 1
            return rep
        return self._least_pressure(cands)

    # -- intake --------------------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        """Place and submit.  A replica that bounces the request with
        :class:`AdmissionRejected` triggers exactly one retry on the best
        non-affinity survivor; a second bounce (or an empty candidate
        set) re-raises with the refusing replica's id attached."""
        rep = self._place(request)
        if rep is None:
            raise AdmissionRejected(request.uid, "no-active-replicas")
        try:
            st = rep.submit(request)
        except AdmissionRejected as first:
            self.stats["rejected"] += 1
            if not self.config.retry_rejected:
                raise self._tagged(first, rep.rid) from first
            alt = self._place(request, exclude=(rep.rid,),
                              no_affinity=True)
            if alt is None:
                raise self._tagged(first, rep.rid) from first
            self.stats["retries"] += 1
            try:
                st = alt.submit(request)
            except AdmissionRejected as second:
                raise self._tagged(second, alt.rid) from second
            rep = alt
        self._owner[request.uid] = rep.rid
        if request.session is not None:
            self._sessions[request.session] = rep.rid
        self.stats["placed"][rep.rid] += 1
        return st

    @staticmethod
    def _tagged(e: AdmissionRejected, rid: int) -> AdmissionRejected:
        return AdmissionRejected(e.uid, e.reason, e.attempts, replica=rid)

    # -- service -------------------------------------------------------------
    def step(self) -> None:
        """One round: every non-retired replica steps once.  A drained
        replica that emptied out is settled and retired here, so
        drain(migrate=False) converges without any extra call."""
        for rid in self.group.members():
            rep = self.replicas[rid]
            if not rep.done:
                rep.step()
            elif self.group.state(rid) is MemberState.DRAINING:
                rep.settle()
                self.group.retire(rid)

    @property
    def all_done(self) -> bool:
        return all(self.replicas[rid].done
                   for rid in self.group.members())

    def run(self, *, max_steps: Optional[int] = None) -> dict:
        """Drive the fleet until every submitted request is terminal.
        Returns the merged ``{uid: (gen_tokens,) np.int32}``."""
        steps = 0
        while not self.all_done:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"router did not converge in {max_steps} rounds")
            self.step()
            steps += 1
        for rid in self.group.members():
            self.replicas[rid].settle()
        return self.results()

    # -- results / stats -----------------------------------------------------
    def owner_of(self, uid) -> Optional[int]:
        return self._owner.get(uid)

    def result_states(self) -> dict:
        """{uid: RequestState} from each request's owning replica."""
        out = {}
        for uid, rid in self._owner.items():
            st = self.replicas[rid].result_state(uid)
            if st is not None:
                out[uid] = st
        return out

    def results(self) -> dict:
        return {uid: st.output()
                for uid, st in self.result_states().items()}

    def replica_stats(self) -> list:
        """Per-replica stat rows (serve.py's per-replica line), in join
        order, retired replicas included — their terminal counts are part
        of the run's story."""
        rows = []
        for rid in sorted(self.replicas, key=lambda r: r):
            row = self.replicas[rid].stats_row()
            row["state"] = self.group.state(rid).name
            rows.append(row)
        return rows
