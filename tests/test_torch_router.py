"""Replicas and the router in the port (``runtime/elastic.py``,
``runtime/serving/replica.py``, ``router.py``) against the JAX package on
the CPU, at the reference's tiny f32 regime.

  * host logic: ``ElasticGroup`` membership, epochs and refusals,
    ``RouterConfig`` validation, ``StepClock``, and placement over scripted
    fake replicas (least-pressure, round-robin, affinity, health
    exclusion, the single retry and the re-raise rules, a hypothesis
    layer over drawn fleets): every decision equals the reference
    router's on the same fakes;
  * real engines: fleet streams equal a single engine's and the JAX
    router's under every policy, monolithic and chunked, plain and
    speculative; placement, router stats and the per-replica rows equal
    the reference's; drain in place and with migration, join, the
    per-replica fault-plan offsets, the blast radius of a chaos plan and
    of a deadline storm on one replica (tests/test_faults.py:642-731);
    one set of weights for the whole fleet; ``mesh=`` refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.configs.base import ArchConfig  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.runtime import elastic as telastic  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import faults as tfaults  # noqa: E402

from test_torch_faults import (DFT, T_DFT, _FakeClock,  # noqa: E402
                               _chaos_plan, _plan, _traffic,
                               assert_survivors)
from test_torch_model import bridged  # noqa: E402

TGT = ArchConfig(name="tiny-router", family="dense", n_layers=2,
                 d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
                 head_dim=8, param_dtype="float32", act_dtype="float32",
                 max_seq=64)
MODS = (jserving, tserving)
POLICIES = ("least-pressure", "round-robin", "affinity")


# ---------------------------------------------------------------------------
# ElasticGroup, RouterConfig, StepClock (host logic)
# ---------------------------------------------------------------------------

def _group_walk(mod):
    g = mod.ElasticGroup()
    out = [g.join("a"), g.join("b"), g.join("c"), g.active(), g.drain("b"),
           g.active(), g.members(), g.state("b").name]
    g.retire("b")
    out += [g.members(), g.join("d"), g.active(), g.is_active("b"),
            [(e, m, None if o is None else o.name, n.name)
             for e, m, o, n in g.transitions]]
    return out


def test_elastic_group_matches_reference():
    assert _group_walk(jelastic) == _group_walk(telastic)
    assert _group_walk(telastic)[3] == ("a", "b", "c")


@pytest.mark.parametrize("bad", ["rejoin", "ghost", "redrain", "reretire",
                                 "reuse"])
def test_elastic_group_refusals_match_reference(bad):
    for mod in (jelastic, telastic):
        g = mod.ElasticGroup()
        g.join("a")
        err = KeyError if bad == "ghost" else ValueError
        with pytest.raises(err):
            if bad == "rejoin":
                g.join("a")
            elif bad == "ghost":
                g.drain("ghost")
            else:
                g.drain("a")
                if bad == "redrain":
                    g.drain("a")
                g.retire("a")
                if bad == "reretire":
                    g.retire("a")
                g.join("a")


@pytest.mark.parametrize("kw", [dict(replicas=0), dict(placement="random"),
                                dict(fault_seed_stride=-1),
                                dict(engine="nope")])
def test_router_config_refusals_match_reference(kw):
    for mod in MODS:
        with pytest.raises(ValueError):
            mod.RouterConfig(**kw)
    cfg = tserving.RouterConfig(replicas=2, placement="affinity")
    assert cfg.replace(replicas=4).replicas == 4
    assert tserving.PLACEMENT_POLICIES == jserving.PLACEMENT_POLICIES


def test_step_clock():
    with pytest.raises(ValueError):
        tserving.StepClock(dt=0)
    c = tserving.StepClock(dt=0.5)
    assert c() == 0.0
    c.tick()
    c.tick()
    assert c() == 1.0


def test_router_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="1.11"):
        tserving.Router(config=tserving.RouterConfig(), mesh=object(),
                        replica_factory=lambda *a, **k: None)


# ---------------------------------------------------------------------------
# placement over scripted fakes: the same decisions as the reference
# ---------------------------------------------------------------------------

class _Fake:
    """The replica signal surface the router places against, scripted."""

    def __init__(self, mod, rid, *, health=0, pressure=0.0, load=0,
                 prefix=0, flaky=False):
        self.mod = mod
        self.rid = rid
        self.health = mod.HealthState(health)
        self._pressure = pressure
        self._load = load
        self._prefix = prefix
        self._flaky = flaky
        self.accepted = []

    def pressure(self):
        return self._pressure

    def unfinished(self):
        return self._load + len(self.accepted)

    def prefix_len(self, prompt):
        return self._prefix

    def submit(self, request):
        if self._flaky or self.health >= self.mod.HealthState.SHEDDING:
            raise self.mod.AdmissionRejected(request.uid,
                                             self.health.name.lower())
        self.accepted.append(request)
        return self.mod.RequestState(request)


def _fake_routers(specs, placement, **cfg_kw):
    """A JAX and a port router over the same scripted fakes."""
    out = []
    for mod in MODS:
        fakes = {}

        def factory(rid, model, cfg, params, *, config, clock, mod=mod,
                    fakes=fakes, **kw):
            fakes[rid] = _Fake(mod, rid, **(specs[rid] if rid < len(specs)
                                            else {}))
            return fakes[rid]

        out.append((mod, mod.Router(config=mod.RouterConfig(
            replicas=len(specs), placement=placement, **cfg_kw),
            replica_factory=factory), fakes))
    return out


def _script(routers, script):
    """Run ``script(mod, router, fakes)`` on both routers; it returns a
    list of events (owners, raised rejections); the lists must agree, as
    must the router stats."""
    logs = []
    for mod, router, fakes in routers:
        logs.append((script(mod, router, fakes), repr(router.stats)))
    assert logs[0] == logs[1]
    return logs[1][0]


def _rq(mod, uid, plen=4, session=None):
    return mod.Request(uid=uid, prompt=np.arange(1, plen + 1,
                                                 dtype=np.int32),
                       max_new_tokens=4, session=session)


def _place(mod, router, uid, session=None):
    try:
        router.submit(_rq(mod, uid, session=session))
    except mod.AdmissionRejected as e:
        cause = e.__cause__
        return ("rejected", e.uid, e.reason, e.replica,
                None if cause is None else cause.replica)
    return router.owner_of(uid)


def test_least_pressure_min_then_load_then_rid():
    def script(mod, router, fakes):
        log = [_place(mod, router, 0)]
        fakes[1]._pressure = 0.5
        log.append(_place(mod, router, 1))
        return log
    assert _script(_fake_routers([dict(pressure=0.5), dict(pressure=0.2),
                                  dict(pressure=0.2, load=3)],
                                 "least-pressure"), script) == [1, 2]


def test_unhealthy_and_drained_replicas_get_nothing():
    def script(mod, router, fakes):
        log = [_place(mod, router, i) for i in range(4)]
        router.group.drain(2)
        log.append(_place(mod, router, 9))
        return log
    log = _script(_fake_routers([dict(health=2), dict(health=3),
                                 dict(pressure=0.9)], "least-pressure"),
                  script)
    assert log[:4] == [2, 2, 2, 2]
    assert log[4][:3] == ("rejected", 9, "no-active-replicas")


def test_round_robin_fair_and_skips_unhealthy():
    def script(mod, router, fakes):
        return [_place(mod, router, i) for i in range(9)]
    owners = _script(_fake_routers([{}, {}, {}], "round-robin"), script)
    for c in range(3):
        assert sorted(owners[3 * c:3 * c + 3]) == [0, 1, 2]
    assert _script(_fake_routers([{}, dict(health=2), {}], "round-robin"),
                   script)[:4] == [0, 2, 0, 2]


def test_affinity_pin_probe_and_fallback():
    def script(mod, router, fakes):
        log = [_place(mod, router, 0, "conv")]
        fakes[2]._pressure = 1.0
        log.append(_place(mod, router, 1, "conv"))
        fakes[2]._prefix = 0
        log.append(_place(mod, router, 2))
        fakes[0].health = mod.HealthState.DEGRADED
        fakes[0]._prefix = 8
        log.append(_place(mod, router, 3))
        fakes[0].health = mod.HealthState.SHEDDING
        log.append(_place(mod, router, 4))
        return log
    assert _script(_fake_routers([dict(pressure=0.9), {}, dict(prefix=8)],
                                 "affinity"), script) == [2, 2, 1, 0, 1]


@pytest.mark.parametrize("retry", [True, False])
def test_bounce_retry_and_reraise_rules(retry):
    """A pinned replica that went SHEDDING bounces the submit: retried once
    off the pin (or re-raised with the pin's id when retry is off); with
    the whole fleet shedding, the re-raise names the replica tried."""
    def script(mod, router, fakes):
        log = [_place(mod, router, 0, "conv")]
        pinned = log[0]
        fakes[pinned].health = mod.HealthState.SHEDDING
        log.append(_place(mod, router, 1, "conv"))
        log.append(dict(router._sessions))
        for f in fakes.values():
            f.health = mod.HealthState.SHEDDING
        log.append(_place(mod, router, 2, "conv"))
        return log
    _script(_fake_routers([{}, {}], "affinity", retry_rejected=retry),
            script)


def test_second_bounce_names_the_retry_replica():
    def script(mod, router, fakes):
        return [_place(mod, router, 0)]
    log = _script(_fake_routers([dict(flaky=True), dict(flaky=True)],
                                "least-pressure"), script)
    assert log == [("rejected", 0, "healthy", 1, None)]


def test_placement_hypothesis_layer():
    """Drawn fleets (health, pressure, load, one prefix holder), every
    policy: the port's placements and rejections equal the reference's,
    and nothing lands on a SHEDDING / DRAINING replica."""
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as hst

    fleet = hst.lists(hst.tuples(hst.integers(0, 3), hst.floats(0.0, 1.0),
                                 hst.integers(0, 5)), min_size=1, max_size=6)

    @settings(max_examples=60, deadline=None, database=None,
              suppress_health_check=list(HealthCheck))
    @given(fleet=fleet, holder=hst.integers(0, 5), n_reqs=hst.integers(1, 8),
           sessions=hst.booleans())
    def prop(fleet, holder, n_reqs, sessions):
        holder %= len(fleet)
        specs = [dict(health=h, pressure=p, load=ld,
                      prefix=8 if i == holder else 0)
                 for i, (h, p, ld) in enumerate(fleet)]
        for policy in POLICIES:
            def script(mod, router, fakes):
                return [_place(mod, router, i,
                               f"s{i % 2}" if sessions else None)
                        for i in range(n_reqs)]
            log = _script(_fake_routers(specs, policy), script)
            for rid in log:
                if isinstance(rid, int):
                    assert fleet[rid][0] < 2

    prop()


def test_router_offsets_fault_plans_per_replica():
    seen = {}
    for stride, want in ((10, [5, 15, 25]), (0, [5, 5, 5])):
        seen.clear()

        def factory(rid, model, cfg, params, *, config, clock):
            seen[rid] = config.faults
            return _Fake(tserving, rid)

        tserving.Router(config=tserving.RouterConfig(
            replicas=3, fault_seed_stride=stride,
            engine=tserving.EngineConfig(
                faults=tserving.FaultPlan.of(seed=5, alloc=0.1))),
            replica_factory=factory)
        assert [seen[r].seed for r in range(3)] == want


# ---------------------------------------------------------------------------
# real engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return bridged(TGT)


def _requests(mod, sessions=False):
    """The reference's eight requests (tests/test_replica_determinism.py:
    56): mixed greedy / sampled over distinct prompt lengths."""
    rng = np.random.default_rng(11)
    reqs = []
    for i, n in enumerate((5, 11, 7, 16, 9, 6, 13, 8)):
        sp = (mod.SamplingParams(temperature=1.1, top_k=20, seed=300 + i)
              if i % 2 else mod.GREEDY)
        reqs.append(mod.Request(
            uid=i, prompt=rng.integers(0, 97, n).astype(np.int32),
            max_new_tokens=8, sampling=sp,
            session=f"s{i % 3}" if sessions else None))
    return reqs


def _engine_config(mod, mode, **kw):
    prefill, decode = mode.split("-")
    draft = DFT if mod is jserving else T_DFT
    return mod.EngineConfig(
        max_slots=2, max_seq=64, depth=1, page_size=8,
        prefill_chunks=(4, 8) if prefill == "chunked" else None,
        speculative=(mod.SpecConfig(draft=draft, k=3, adaptive=False)
                     if decode == "spec" else None), **kw)


def _model(mod, models):
    jm, jp, tm, tp = models
    return (jm, TGT, jp) if mod is jserving else (tm, tm.cfg, tp)


def _router(mod, models, mode, policy, n, **kw):
    return mod.Router(*_model(mod, models),
                      config=mod.RouterConfig(
                          replicas=n, placement=policy,
                          engine=_engine_config(mod, mode)), **kw)


_SINGLE: dict = {}


def _single(models, mode):
    """The port's single engine (no router) on the eight requests."""
    if mode not in _SINGLE:
        eng = tserving.ServingEngine(*_model(tserving, models),
                                     config=_engine_config(tserving, mode))
        for r in _requests(tserving):
            eng.submit(r)
        _SINGLE[mode] = eng.run(max_steps=3000)
    return _SINGLE[mode]


def _same(out, ref):
    assert sorted(out) == sorted(ref)
    for uid in ref:
        np.testing.assert_array_equal(out[uid], np.asarray(ref[uid]),
                                      err_msg=f"request {uid}")


ROW_KEYS = ("replica", "health", "pressure", "requests", "tokens_out",
            "prefills", "preempted", "migrated", "failed", "state")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["monolithic-plain", "chunked-plain",
                                  "chunked-spec"])
def test_fleet_streams_equal_single_engine_and_reference(models, mode,
                                                         policy):
    """1, 2 and 4 replicas: the merged streams equal the single engine's;
    under plain decode they also equal the JAX router's, and so do the
    placements, the router stats and the per-replica rows.  Under
    speculation the port's draft has weights of its own, so its fleet is
    held to the single engine (whose streams are plain decode's, the JAX
    engine's: tests/test_torch_speculative.py)."""
    ref = _single(models, mode)
    plain = mode.endswith("plain")
    for n in (1, 2, 4):
        got = []
        for mod in (MODS if plain else (tserving,)):
            router = _router(mod, models, mode, policy, n)
            for r in _requests(mod, sessions=policy == "affinity"):
                router.submit(r)
            out = router.run(max_steps=3000)
            got.append((out, router))
        tout, tr = got[-1]
        _same(tout, ref)
        served = [r for r, v in tr.stats["placed"].items() if v > 0]
        assert len(served) == (min(n, 3) if policy == "affinity" else n)
        if not plain:
            continue
        jout, jr = got[0]
        _same(tout, jout)
        assert tr.stats == jr.stats
        assert {u: tr.owner_of(u) for u in tout} == \
            {u: jr.owner_of(u) for u in jout}
        assert [[row[k] for k in ROW_KEYS + ("steps",)]
                for row in tr.replica_stats()] == \
            [[row[k] for k in ROW_KEYS + ("steps",)]
             for row in jr.replica_stats()]


@pytest.mark.parametrize("mode", ["monolithic-plain", "chunked-plain",
                                  "chunked-spec"])
def test_mid_run_drain_with_migration(models, mode):
    """Drain replica 0 mid-flight with migration: its residents depart
    MIGRATED and replay on replica 1; nothing is lost, every stream equals
    the single engine's, the drained replica retires, every page drains,
    as in the reference."""
    ref = _single(models, mode)
    got = []
    for mod in MODS:
        router = _router(mod, models, mode, "least-pressure", 2)
        for r in _requests(mod):
            router.submit(r)
        for _ in range(4):
            router.step()
        moved = router.drain(0, migrate=True)
        out = router.run(max_steps=3000)
        got.append((moved, out, router))
    (jm, jout, jr), (tm, tout, tr) = got
    assert tm == jm and tm
    assert all(tr.owner_of(u) == 1 for u in tm)
    _same(tout, ref)
    assert tr.stats == jr.stats
    assert all(st.status == tserving.Status.FINISHED
               for st in tr.result_states().values())
    assert tr.group.state(0) is telastic.MemberState.RETIRED
    evac = tr.replicas[0].engine
    assert evac.stats["migrated"] == len(tm) and evac.stats["failed"] == 0
    assert evac.scheduler.stats["migrated"] == len(tm)
    for rep in tr.replicas.values():
        mgr = rep.engine.cache_mgr
        assert mgr.free_pages == mgr.num_pages


def test_drain_in_place_and_join(models):
    """Drain without migration lets residents finish in place (the
    replica then retires inside ``run``); a joined replica takes the next
    least-pressure placement; a second wave under new uids equals the
    first; the stats and owners equal the reference's."""
    mode = "chunked-plain"
    ref = _single(models, mode)
    got = []
    for mod in MODS:
        router = _router(mod, models, mode, "least-pressure", 2)
        wave = _requests(mod)
        for r in wave:
            router.submit(r)
        for _ in range(3):
            router.step()
        router.drain(1)
        rid = router.join()
        assert router.group.active() == (0, rid)
        for r in wave:
            router.submit(mod.Request(uid=100 + r.uid, prompt=r.prompt,
                                      max_new_tokens=r.max_new_tokens,
                                      sampling=r.sampling))
        out = router.run(max_steps=3000)
        got.append((out, router, rid))
    (jout, jr, _), (tout, tr, rid) = got
    assert tr.stats == jr.stats and tr.stats["joins"] == 1
    assert any(tr.owner_of(100 + i) == rid for i in range(8))
    assert tr.group.state(1) is telastic.MemberState.RETIRED
    _same({u: t for u, t in tout.items() if u < 100}, ref)
    _same({u - 100: t for u, t in tout.items() if u >= 100}, ref)
    _same(tout, jout)


def test_drain_refuses_migration_into_an_empty_fleet(models):
    router = _router(tserving, models, "chunked-plain", "least-pressure", 1)
    router.submit(_requests(tserving)[0])
    with pytest.raises(tserving.AdmissionRejected) as ei:
        router.drain(0, migrate=True)
    assert ei.value.replica == 0 and router.group.is_active(0)
    assert len(router.run(max_steps=3000)) == 1


def test_fleet_shares_one_set_of_weights(models):
    """Every replica serves the model object and parameter tensors it was
    given (no copy), on its own arena and scheduler."""
    jm, jp, tm, tp = models
    router = _router(tserving, models, "chunked-plain", "round-robin", 3)
    engines = [rep.engine for rep in router.replicas.values()]
    assert all(e.model is tm and e.params is tp for e in engines)
    assert len({id(e._cache["k"]) for e in engines}) == 3
    assert len({id(e.scheduler) for e in engines}) == 3


# ---------------------------------------------------------------------------
# faults through the router (tests/test_faults.py:621-731)
# ---------------------------------------------------------------------------

def _fleet_run(mod, models, cfg_kw, *, plan=None, n=3,
               policy="least-pressure", clock_factory=None,
               before_run=None):
    prompts, samp = _traffic()
    config = mod.EngineConfig(**cfg_kw, faults=_plan(mod, plan))
    router = mod.Router(*_model(mod, models),
                        config=mod.RouterConfig(replicas=n, placement=policy,
                                                engine=config),
                        clock_factory=clock_factory)
    for i, (p, sp) in enumerate(zip(prompts, samp)):
        router.submit(mod.Request(
            uid=i, prompt=p, max_new_tokens=8,
            sampling=mod.GREEDY if sp is None else mod.SamplingParams(**sp),
            deadline_ms=100.0 if i == 0 and clock_factory else None))
    if before_run is not None:
        before_run(router)
    return router.run(max_steps=3000), router


def _same_fleets(jr, tr, jout, tout):
    _same(tout, jout)
    assert tr.stats == jr.stats
    js, ts = jr.result_states(), tr.result_states()
    assert {u: (s.status.value, s.finish_reason) for u, s in ts.items()} == \
        {u: (s.status.value, s.finish_reason) for u, s in js.items()}
    for rid, rep in tr.replicas.items():
        je, te = jr.replicas[rid].engine, rep.engine
        for key in ("faults", "poisoned", "quarantined", "timed_out",
                    "failed", "tokens_out"):
            assert te.stats.get(key) == je.stats.get(key), (rid, key)


CHUNKED = dict(max_slots=3, max_seq=64, depth=2, page_size=8,
               prefill_chunks=(4, 8))


def test_router_offsets_make_fault_streams_replica_local(models):
    plan = _chaos_plan(3)
    _, tr = _fleet_run(tserving, models, dict(CHUNKED, depth=1), plan=plan)
    seeds = [tr.replicas[r].engine._injector.plan.seed for r in range(3)]
    assert seeds == [3, 4, 5]
    assert tfaults._u01(seeds[0], "alloc", 0) != \
        tfaults._u01(seeds[1], "alloc", 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_router_chaos_blast_radius(models, seed):
    """A seeded chaos plan on every replica (seed-offset per replica): the
    fleet equals the JAX fleet, each survivor equals the fault-free fleet
    run, failures keep a clean prefix, every replica's pages drain, and
    the replicas did not fire in lockstep."""
    clean, _ = _fleet_run(tserving, models, CHUNKED)
    runs = [_fleet_run(mod, models, CHUNKED, plan=_chaos_plan(seed))
            for mod in MODS]
    (jout, jr), (tout, tr) = runs
    _same_fleets(jr, tr, jout, tout)
    for rid, rep in tr.replicas.items():
        owned = {u for u in tout if tr.owner_of(u) == rid}
        assert_survivors({u: tout[u] for u in owned}, rep.engine,
                         {u: clean[u] for u in owned})
    fired = [tr.replicas[r].engine._injector.fired for r in range(3)]
    assert not (fired[0] == fired[1] == fired[2])


def test_router_deadline_storm_stays_on_one_replica(models):
    """One replica's clock jumps far past a resident's deadline: that
    request times out there; the sibling's clock never moved and its
    streams and counters are untouched."""
    cfg = dict(CHUNKED, depth=1)
    clean, _ = _fleet_run(tserving, models, cfg, n=2, policy="round-robin")
    runs = []
    for mod in MODS:
        clocks = {}

        def factory(rid, clocks=clocks):
            clocks[rid] = _FakeClock()
            return clocks[rid]

        def storm(router, clocks=clocks):
            for _ in range(2):
                router.step()
            clocks[router.owner_of(0)].t = 10.0

        runs.append(_fleet_run(mod, models, cfg, n=2, policy="round-robin",
                               clock_factory=factory, before_run=storm))
    (jout, jr), (tout, tr) = runs
    _same_fleets(jr, tr, jout, tout)
    states = tr.result_states()
    assert states[0].status == tserving.Status.TIMED_OUT
    np.testing.assert_array_equal(tout[0], clean[0][:tout[0].size])
    for uid, st in states.items():
        if uid:
            assert st.status == tserving.Status.FINISHED
            np.testing.assert_array_equal(tout[uid], clean[uid])
    storm_rid = tr.owner_of(0)
    for rid, rep in tr.replicas.items():
        if rid != storm_rid:
            assert rep.engine.stats["timed_out"] == 0
            assert rep.engine.stats["failed"] == 0
