"""Fault injection, deadlines and the health ladder in the port
(``runtime/serving/faults.py``, ``health.py``, the scheduler's bounded
admission and ``depart``, the page accountant's ``alloc`` hook, the
engine's fault sites, quarantine and ladder) against the JAX package at
the reference's tiny f32 regime (tests/test_faults.py:31-38), on the CPU
where every step runs eagerly.

  * host logic: ``_u01`` and the injector's ``fire`` / ``choose`` over
    10^4 consults a site, plan validation, parsing and offsets, the
    ladder's walk over random signal traces, backoff and the caps, typed
    rejections, ``depart`` releasing forked prefix pages and the scale
    sidecar, each against the reference's result on the same inputs;
  * the engine: for the same plan and traffic the port's streams,
    statuses, finish reasons and stats (faults fired, poisoned,
    quarantined, timed out, failed, the health transitions, the scheduler
    counters) equal the JAX engine's, over dense fp32 and int8 arenas and
    the ssm family, monolithic, chunked, shared-prefix and speculative;
    and every survivor equals the fault-free run bit for bit, every
    failure keeps a clean prefix of it, and every page drains.

The captured decode graphs' flag and the kernels over a NaN-filled slot
are checked on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ArchConfig  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime.serving import faults as jfaults  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import faults as tfaults  # noqa: E402

from test_torch_model import bridged, port_cfg  # noqa: E402
from test_torch_ssm import TINY_SSM, ssm_bridged  # noqa: E402

TGT = ArchConfig(name="tiny-fault-target", family="dense", n_layers=2,
                 d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
                 head_dim=8, param_dtype="float32", act_dtype="float32",
                 max_seq=64)
DFT = ArchConfig(name="tiny-fault-draft", family="dense", n_layers=1,
                 d_model=16, n_heads=2, n_kv_heads=1, d_ff=32, vocab=97,
                 head_dim=8, param_dtype="float32", act_dtype="float32",
                 max_seq=64)
T_DFT = port_cfg(DFT)
MODS = (jserving, tserving)


# ---------------------------------------------------------------------------
# the injector (host logic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", tfaults.SITES)
def test_fire_and_choose_sequences_match_reference(site):
    """10^4 consults of ``fire`` and of ``choose`` for one site, at a rate
    and cap that make both outcomes common, a per-site seed and the plan's:
    every answer equals the reference's, and so do the fire counts."""
    for seed, spec in ((11, (0.3, None, None)), (4, (0.05, 9, 200))):
        plans = [mod.FaultPlan(seed=seed, sites=((site, mod.FaultSpec(
            *spec)),)) for mod in (jfaults, tfaults)]
        inj = [mod.FaultInjector(plan)
               for mod, plan in zip((jfaults, tfaults), plans)]
        got = [[(i.fire(site), i.choose(site, 1 + c % 7))
                for c in range(10_000)] for i in inj]
        assert got[0] == got[1]
        assert inj[0].fired == inj[1].fired
        assert 0 < inj[1].total_fired() < 10_000
    for c in (0, 1, 977, 10**6):
        assert tfaults._u01(3, site, c) == jfaults._u01(3, site, c)


@pytest.mark.parametrize("bad", [
    dict(spec=(1.5,)), dict(spec=(-0.1,)), dict(spec=(0.5, None, -1)),
    dict(site="bogus"), dict(bare=True), dict(dup=True)])
def test_plan_validation_matches_reference(bad):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError):
            if "spec" in bad:
                mod.FaultSpec(*bad["spec"])
            elif "site" in bad:
                mod.FaultPlan.of(**{bad["site"]: 0.5})
            elif "bare" in bad:
                mod.FaultPlan(sites=(("alloc", 0.5),))
            else:
                mod.FaultPlan(sites=(("alloc", mod.FaultSpec(0.1)),
                                     ("alloc", mod.FaultSpec(0.2))))


def _plan_data(plan):
    return (plan.seed, tuple((n, dataclasses.astuple(s))
                             for n, s in plan.sites))


@pytest.mark.parametrize("text", ["alloc:0.05, logits:0.01:7",
                                  "decode:1,chunk:0:3,draft:0.5", ""])
def test_parse_fault_plan_matches_reference(text):
    plans = [mod.parse_fault_plan(text, seed=3) for mod in (jfaults, tfaults)]
    assert _plan_data(plans[0]) == _plan_data(plans[1])
    for delta in (0, 5):
        assert _plan_data(plans[0].offset(delta)) == \
            _plan_data(plans[1].offset(delta))
    assert plans[1].offset(0) is plans[1]
    hash(plans[1])


@pytest.mark.parametrize("text", ["alloc", "warp:0.5", "alloc:0.5:1:2",
                                  "alloc:x"])
def test_parse_fault_plan_refusals_match_reference(text):
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError):
            mod.parse_fault_plan(text)


def test_injector_rates_and_max_fires():
    for mod in (jfaults, tfaults):
        inj = mod.FaultInjector(mod.FaultPlan.of(
            alloc=0.0, chunk=1.0, decode=mod.FaultSpec(1.0, max_fires=3)))
        assert not any(inj.fire("alloc") for _ in range(100))
        assert all(inj.fire("chunk") for _ in range(100))
        assert sum(inj.fire("decode") for _ in range(100)) == 3
        assert inj.fire("logits") is False
        assert inj.active("chunk") and not inj.active("alloc")
        assert inj.fired == {"alloc": 0, "chunk": 100, "decode": 3}
        with pytest.raises(ValueError):
            inj.choose("alloc", 0)


# ---------------------------------------------------------------------------
# the health ladder (host logic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(window=0), dict(pressure_degraded=1.5), dict(shed_prefill_frac=0),
    dict(pressure_degraded=0.9, pressure_shedding=0.8),
    dict(fault_degraded=4, fault_shedding=2), dict(fault_degraded=0),
    dict(recover_after=0), dict(shed_steps_draining=0)])
def test_health_config_refusals_match_reference(kw):
    for mod in MODS:
        with pytest.raises(ValueError):
            mod.HealthConfig(**kw)


LADDERS = [dict(), dict(fault_degraded=1, fault_shedding=2, fault_draining=3,
                        recover_after=2, shed_steps_draining=None),
           dict(window=4, preempt_degraded=0.5, miss_degraded=0.25,
                recover_after=3, shed_steps_draining=5)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ladder", range(len(LADDERS)))
def test_ladder_walk_matches_reference(seed, ladder):
    """Both monitors through one random trace of 300 steps (bursts of
    faults, pressure spikes, preemptions and misses): the state after every
    step and the transitions (step, from, to, reason) are equal, and the
    walk moves one rung a step."""
    rng = np.random.default_rng(seed)
    mons = [mod.HealthMonitor(mod.HealthConfig(**LADDERS[ladder]))
            for mod in MODS]
    pre = miss = 0
    burst = 0
    last = 0
    for t in range(1, 301):
        if burst == 0 and rng.random() < 0.05:
            burst = int(rng.integers(1, 12))
        fault = burst > 0
        burst = max(0, burst - 1)
        pressure = float(rng.choice([0.1, 0.5, 0.9, 0.99],
                                    p=[0.6, 0.2, 0.15, 0.05]))
        pre += int(rng.random() < 0.1)
        miss += int(rng.random() < 0.08)
        states = [m.observe(step=t, pressure=pressure, preemptions=pre,
                            timeouts=miss, step_fault=fault) for m in mons]
        assert int(states[0]) == int(states[1])
        assert abs(int(states[1]) - last) <= 1
        last = int(states[1])
    assert mons[0].transitions == mons[1].transitions
    assert len(mons[1].transitions) > 2


def test_ladder_climbs_and_recovers_one_rung_at_a_time():
    mon = tserving.HealthMonitor(tserving.HealthConfig(
        fault_degraded=2, fault_shedding=4, fault_draining=6,
        recover_after=3, shed_steps_draining=None))
    walk = [mon.observe(step=t, pressure=0.0, preemptions=0, timeouts=0,
                        step_fault=True) for t in range(1, 8)]
    S = tserving.HealthState
    assert walk == [S.HEALTHY, S.DEGRADED, S.DEGRADED, S.SHEDDING,
                    S.SHEDDING, S.DRAINING, S.DRAINING]
    states = [mon.observe(step=10 + t, pressure=0.0, preemptions=0,
                          timeouts=0, step_fault=False) for t in range(9)]
    assert (states[2], states[5], states[8]) == (S.SHEDDING, S.DEGRADED,
                                                 S.HEALTHY)
    assert mon.transitions[-1][3] == "recovered"


# ---------------------------------------------------------------------------
# the scheduler: backoff, caps, typed rejections, departures (host logic)
# ---------------------------------------------------------------------------

def _req(mod, uid, plen=4, max_new=4):
    return mod.Request(uid=uid, prompt=np.arange(plen, dtype=np.int32) % 97,
                       max_new_tokens=max_new)


def _backoff_trace(mod):
    m = mod.PagedKVCacheManager(num_pages=2, page_size=4)
    s = mod.Scheduler(2, m, admission_attempt_cap=3, admission_backoff_cap=4)
    s.submit(_req(mod, "a"))
    b = s.submit(_req(mod, "b"))
    trace = []
    for tick in (1, 1, 2, 3, 4, 5):
        got = [st.request.uid for st in s.schedule(tick=tick)]
        trace.append((tick, got, b.admission_attempts, b.next_try_tick,
                      b.status.value))
    return trace, b, s


def test_admission_backoff_and_typed_rejection_match_reference():
    (jt, jb, js), (tt, tb, ts) = (_backoff_trace(mod) for mod in MODS)
    assert jt == tt
    assert tt[0][2:4] == (1, 2) and tt[2][2:4] == (2, 4)
    assert tb.finish_reason == "admission-rejected"
    assert isinstance(tb.rejection, tserving.AdmissionRejected)
    assert (tb.rejection.reason, tb.rejection.attempts) == ("no-pages", 3)
    assert str(tb.rejection) == str(jb.rejection)
    assert ts.stats == js.stats
    assert tb.done and tb not in ts.waiting


def test_admission_without_tick_retries_forever():
    for mod in MODS:
        s = mod.Scheduler(2, mod.PagedKVCacheManager(num_pages=2,
                                                     page_size=4))
        s.submit(_req(mod, "a"))
        b = s.submit(_req(mod, "b"))
        for _ in range(50):
            s.schedule()
        assert b.status.value == "waiting" and b.next_try_tick == 0


def _preempt_trace(mod):
    m = mod.PagedKVCacheManager(num_pages=5, page_size=4)
    s = mod.Scheduler(2, m, preempt_cap=1)
    old = s.submit(_req(mod, "old", max_new=9))
    young = s.submit(_req(mod, "young", max_new=9))
    s.schedule()
    trace = []
    for tok in range(3):
        trace.append(s.on_token(young.slot, tok))
    for tok in range(4):
        trace.append(s.on_token(old.slot, tok))
    trace.append(s.on_token(young.slot, 99))
    trace.append(len(s.schedule()))
    for tok in range(4, 8):
        trace.append(s.on_token(old.slot, tok))
    flat = [[(d, st.request.uid) for d, st in x] if isinstance(x, list)
            else x for x in trace]
    return flat, young, s


def test_preempt_cap_departs_failed_keeping_tokens():
    (jt, jy, js), (tt, ty, ts) = (_preempt_trace(mod) for mod in MODS)
    assert jt == tt
    assert (ty.status.value, ty.finish_reason) == ("failed", "recompute-cap")
    assert ty.generated == jy.generated and ty.preemptions == 1
    assert ts.stats == js.stats
    assert ts.stats["preempted"] == 1 and ts.stats["failed"] == 1


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_depart_releases_forked_pages_and_sidecar(fmt):
    """A fork and its donor depart abnormally (FAILED, then TIMED_OUT):
    refcounts, pins, free pages and the scale sidecar move as in the
    reference, and the whole pool comes back."""
    traces = []
    for mod in MODS:
        m = mod.PagedKVCacheManager(num_pages=8, page_size=4, kv_format=fmt,
                                    row_bytes=40)
        s = mod.Scheduler(2, m, chunked=True)
        donor = s.submit(_req(mod, "donor", plen=8, max_new=2))
        fork = s.submit(_req(mod, "fork", plen=8, max_new=2))
        s.schedule()
        m.register_prefix(donor.slot, donor.request.prompt, 8)
        match = m.lookup(fork.request.prompt, 7)
        assert m.fork(fork.slot, match)
        page = match.entries[0].page
        trace = [(m.refcount(page), m.free_pages, m.scale_sidecar_pages)]
        s.depart(donor, mod.Status.FAILED, "nan-logits")
        trace.append((m.refcount(page), m.free_pages, m.scale_sidecar_pages,
                      m.region_pinned(match.src_slot)))
        s.depart(fork, mod.Status.TIMED_OUT, "deadline")
        trace.append((m.refcount(page), m.free_pages, m.scale_sidecar_pages,
                      m.region_pinned(match.src_slot)))
        assert s.depart(fork, mod.Status.FAILED, "x") is None   # terminal
        traces.append((trace, dict(s.stats), fork.status.value))
    assert traces[0] == traces[1]
    assert traces[1][0][-1] == (0, 8, 0, False)
    if fmt == "int8":
        assert traces[1][0][0][2] > 0


def test_depart_from_waiting_leaves_the_queue():
    for mod in MODS:
        s = mod.Scheduler(1, mod.PagedKVCacheManager(8, 4))
        s.submit(_req(mod, "a"))
        b = s.submit(_req(mod, "b"))
        s.schedule()
        assert s.depart(b, mod.Status.TIMED_OUT, "deadline") is None
        assert b.status.value == "timed_out" and b not in s.waiting
        assert s.stats["timed_out"] == 1


def test_alloc_hook_refuses_with_fault_injected():
    for mod in MODS:
        fires = iter([True, False, True])
        m = mod.PagedKVCacheManager(8, 4, fault=lambda site: next(fires))
        res = m.allocate(0, 4)
        assert not res and res.reason == "fault-injected"
        assert m.allocate(0, 4)
        res = m.extend(0, 12)
        assert not res and res.reason == "fault-injected"
        assert m.free_pages == 7


def test_request_and_config_fields():
    """``deadline_ms`` / ``session`` on the request, the robustness fields
    of ``EngineConfig`` with the reference's refusals; ``donate`` has no
    counterpart (the arena is written in place) and stays a TypeError."""
    for mod in MODS:
        with pytest.raises(ValueError):
            mod.Request(uid=0, prompt=[1], max_new_tokens=1, deadline_ms=0)
        r = mod.Request(uid=0, prompt=[1], max_new_tokens=1,
                        deadline_ms=5.0, session="s")
        assert (r.deadline_ms, r.session) == (5.0, "s")
        for kw in (dict(faults="x"), dict(health="x"),
                   dict(admission_reclaim_cap=0),
                   dict(admission_attempt_cap=0), dict(preempt_cap=0),
                   dict(admission_backoff_cap=0)):
            with pytest.raises(ValueError):
                mod.EngineConfig(**kw)
    cfg = tserving.EngineConfig(faults=tserving.FaultPlan.of(alloc=0.1),
                                health=tserving.HealthConfig())
    hash(cfg)
    assert tserving.EngineConfig().admission_reclaim_cap == 8
    with pytest.raises(TypeError):
        tserving.EngineConfig(donate=True)
    assert [s.value for s in tserving.request.TERMINAL] == \
        [s.value for s in jserving.request.TERMINAL]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    return bridged(TGT)


@pytest.fixture(scope="module")
def ssm():
    return ssm_bridged(TINY_SSM)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _traffic(shared=False):
    """The reference's fixed mixed traffic (tests/test_faults.py:224):
    greedy and sampled requests over distinct prompt lengths, a
    page-aligned common head under ``shared``."""
    rng = np.random.default_rng(0)
    lens = (5, 11, 7, 16, 9)
    if shared:
        head = rng.integers(0, 97, 16).astype(np.int32)
        prompts = [np.concatenate([head, rng.integers(0, 97, 4 + i)
                                   .astype(np.int32)])
                   for i in range(len(lens))]
    else:
        prompts = [rng.integers(0, 97, n).astype(np.int32) for n in lens]
    samp = [None, dict(temperature=1.1, top_k=20, seed=11), None,
            dict(temperature=0.9, top_p=0.95, seed=12), None]
    return prompts, samp


def _plan(mod, desc):
    """(seed, {site: (rate, seed, max_fires)}) as ``mod``'s FaultPlan."""
    if desc is None:
        return None
    seed, sites = desc
    return mod.FaultPlan(seed=seed, sites=tuple(
        (name, mod.FaultSpec(*spec)) for name, spec in sites.items()))


def _chaos_plan(seed, *, spec=False, chunked=True):
    """The reference's seeded chaos plan (tests/test_faults.py:523)."""
    rng = np.random.default_rng(seed)
    sites = {"alloc": (float(rng.uniform(0.02, 0.25)), None, None),
             "decode": (float(rng.uniform(0.02, 0.2)), None, None),
             "logits": (float(rng.uniform(0.005, 0.05)), None,
                        int(rng.integers(1, 3)))}
    if chunked:
        sites["chunk"] = (float(rng.uniform(0.02, 0.25)), None, None)
    if spec:
        sites["draft"] = (float(rng.uniform(0.1, 0.5)), None, None)
    return seed, sites


def _copy_into(dst: dict, src: dict) -> None:
    for key, leaf in dst.items():
        if isinstance(leaf, dict):
            _copy_into(leaf, src[key])
        else:
            leaf.copy_(src[key])


def _engine(mod, models, cfg_kw, *, plan=None, health=None, spec=None,
            clock=None, draft_params=None):
    jm, jp, tm, tp = models
    model, params, cfg = ((jm, jp, jm.cfg) if mod is jserving
                          else (tm, tp, tm.cfg))
    config = mod.EngineConfig(
        **cfg_kw, faults=_plan(mod, plan),
        health=mod.HealthConfig(**health) if health is not None else None,
        speculative=(mod.SpecConfig(draft=DFT if mod is jserving else T_DFT,
                                    **spec) if spec else None))
    eng = mod.ServingEngine(model, cfg, params, config=config, clock=clock)
    if draft_params is not None:
        _copy_into(eng._draft_params, draft_params)
    return eng


def _submit(mod, eng, traffic, max_new, deadlines=None):
    prompts, samp = traffic
    for i, (p, sp) in enumerate(zip(prompts, samp)):
        s = mod.GREEDY if sp is None else mod.SamplingParams(**sp)
        eng.submit(mod.Request(uid=i, prompt=p, max_new_tokens=max_new,
                               sampling=s,
                               deadline_ms=(deadlines or {}).get(i)))


STAT_KEYS = ("requests", "tokens_out", "decode_steps", "prefills",
             "prefill_chunks", "sampled_steps", "forks", "timed_out",
             "failed", "migrated", "quarantined", "poisoned", "faults",
             "health", "health_transitions", "deadline_overrun_s",
             "spec_rounds", "spec_draft_steps", "spec_verify_calls")


def assert_same_engines(jeng, teng, jout, tout):
    """The port's engine equals the JAX engine's: streams, statuses,
    finish reasons and rejections, the robustness stats, the ladder's
    transitions and the scheduler's counters."""
    assert sorted(jout) == sorted(tout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], np.asarray(jout[uid]),
                                      err_msg=f"request {uid}")
        js, ts = jeng._results[uid], teng._results[uid]
        assert (ts.status.value, ts.finish_reason) == \
            (js.status.value, js.finish_reason), uid
        assert (ts.rejection is None) == (js.rejection is None)
        if ts.rejection is not None:
            assert (ts.rejection.reason, ts.rejection.attempts) == \
                (js.rejection.reason, js.rejection.attempts)
    for key in STAT_KEYS:
        assert (key in teng.stats) == (key in jeng.stats), key
        if key in teng.stats:
            assert teng.stats[key] == jeng.stats[key], key
    assert teng.scheduler.stats == jeng.scheduler.stats
    if teng.health is not None:
        assert teng.health.transitions == jeng.health.transitions
    if teng.spec is not None:
        assert teng.spec.stats == jeng.spec.stats


def _pair(models, cfg_kw, *, plan=None, health=None, spec=None,
          traffic=None, max_new=8, clocks=None, deadlines=None,
          before_run=None):
    """The JAX engine and the port's on the same config, plan and traffic
    (the port's draft carrying the JAX draft's weights); asserts they
    agree and returns (port streams, port engine)."""
    traffic = traffic or _traffic()
    clocks = clocks or (None, None)
    jeng = _engine(jserving, models, cfg_kw, plan=plan, health=health,
                   spec=spec, clock=clocks[0])
    dp = None
    if spec:
        dp = convert.params_from_numpy(
            jax.tree.map(np.asarray, jeng._draft_params), T_DFT, "cpu")
    teng = _engine(tserving, models, cfg_kw, plan=plan, health=health,
                   spec=spec, clock=clocks[1], draft_params=dp)
    outs = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        _submit(mod, eng, traffic, max_new, deadlines)
        if before_run is not None:
            before_run(mod, eng)
        outs.append(eng.run(max_steps=3000))
    assert_same_engines(jeng, teng, *outs)
    return outs[1], teng


_CLEAN: dict = {}


def _clean(models, cfg_kw, traffic_key=False, max_new=8):
    """The port's fault-free streams for a config (memoised)."""
    key = (id(models), tuple(sorted(cfg_kw.items())), traffic_key, max_new)
    if key not in _CLEAN:
        eng = _engine(tserving, models, cfg_kw)
        _submit(tserving, eng, _traffic(traffic_key), max_new)
        _CLEAN[key] = eng.run(max_steps=3000)
    return _CLEAN[key]


def assert_survivors(out, eng, clean):
    """Every request terminal; a FINISHED one equals the fault-free run,
    any other keeps a clean prefix of it; every page is back."""
    for uid, st in eng._results.items():
        assert st.done, (uid, st.status)
        if st.status == tserving.Status.FINISHED:
            np.testing.assert_array_equal(out[uid], clean[uid])
        else:
            np.testing.assert_array_equal(out[uid],
                                          clean[uid][:out[uid].size])
    assert eng.scheduler.all_done
    assert eng.cache_mgr.free_pages == eng.cache_mgr.num_pages
    assert eng.cache_mgr.scale_sidecar_pages == 0


CHUNKED = dict(max_slots=3, max_seq=64, depth=2, page_size=8,
               prefill_chunks=(4, 8))
MONO = dict(max_slots=3, max_seq=64, depth=2, page_size=8)


def test_deadline_times_out_a_resident_with_partial_output(dense):
    """A fake clock frozen for 4 steps, then 900 ms past request 0's
    deadline: it departs TIMED_OUT from the slot with a clean prefix, the
    overrun recorded, the others untouched."""
    cfg = dict(CHUNKED, depth=1)
    clocks = (_FakeClock(), _FakeClock())

    def four_steps(mod, eng):
        for _ in range(4):
            eng.step()
        assert eng._results[0].status.value in ("prefilling", "running")
        eng._clock.t = 1.0

    out, eng = _pair(dense, cfg, clocks=clocks, deadlines={0: 100.0},
                     before_run=four_steps)
    assert eng._results[0].status == tserving.Status.TIMED_OUT
    assert eng.stats["deadline_overrun_s"][0] == pytest.approx(0.9)
    assert 0 < out[0].size < 8
    assert_survivors(out, eng, _clean(dense, cfg))


def test_deadline_expires_in_the_waiting_queue(dense):
    clocks = (_FakeClock(), _FakeClock())
    prompts = [np.arange(8, dtype=np.int32) * 7 % 97,
               np.arange(8, dtype=np.int32) * 5 % 97]

    def one_step(mod, eng):
        eng.step()
        eng._clock.t = 10.0

    out, eng = _pair(dense, dict(max_slots=1, max_seq=64), clocks=clocks,
                     traffic=(prompts, [None, None]), max_new=6,
                     deadlines={1: 50.0}, before_run=one_step)
    late = eng._results[1]
    assert late.status == tserving.Status.TIMED_OUT and late.slot is None
    assert out[1].size == 0 and out[0].size == 6


@pytest.mark.parametrize("family,fmt,chunks", [
    ("dense", "fp32", None), ("dense", "fp32", (4, 8)),
    ("dense", "int8", None), ("dense", "int8", (4, 8)),
    ("ssm", "fp32", None), ("ssm", "fp32", (4, 8))])
def test_nan_quarantine_on_the_decode_path(dense, ssm, family, fmt, chunks):
    """The ``logits`` site fills one resident slot's region with NaN; the
    lagged flag quarantines it FAILED before a poisoned token commits,
    and every survivor equals the fault-free run."""
    models = dense if family == "dense" else ssm
    cfg = dict(MONO, prefill_chunks=chunks, kv_format=fmt)
    out, eng = _pair(models, cfg, plan=(5, {"logits": (1.0, None, 1)}))
    failed = [u for u, st in eng._results.items()
              if st.status == tserving.Status.FAILED]
    assert len(failed) == 1
    assert eng._results[failed[0]].finish_reason == "nan-logits"
    assert eng.stats["poisoned"] == 1 and eng.stats["quarantined"] == 1
    assert_survivors(out, eng, _clean(models, cfg))


@pytest.mark.parametrize("sampled", [False, True])
def test_nan_first_token_is_quarantined(dense, sampled):
    """A slot filled with NaN while its prompt is still being chunked: the
    final chunk's logits are non-finite, so the first-token check fails
    the request before it commits a token (the greedy argmax path or the
    sampled first draw), with the reference's statuses and stats; the slot
    is scrubbed before its next resident."""
    victim = {}

    def poison_prefilling(mod, eng):
        for _ in range(2):
            eng.step()
        st = min((s for s in eng.scheduler.running.values()
                  if s.status.value == "prefilling"), key=lambda s: s.seq)
        victim[mod] = st.request.uid
        if mod is tserving:
            eng._fill_slot(st.slot, float("nan"), floating_only=True)
        else:
            nan_one = jax.tree.map(
                lambda x: (jax.numpy.full_like(x, jax.numpy.nan)
                           if jax.numpy.issubdtype(x.dtype,
                                                   jax.numpy.inexact)
                           else x), eng._one_cache)
            eng._cache = eng._insert(eng._cache, nan_one,
                                     jax.numpy.int32(st.slot))
        eng._poisoned_slots.add(st.slot)

    prompts, samp = _traffic()
    if sampled:
        samp = [dict(temperature=0.9, top_k=20, seed=3 + i)
                for i in range(len(prompts))]
    cfg = dict(CHUNKED, max_slots=2)
    out, eng = _pair(dense, cfg, traffic=(prompts, samp),
                     before_run=poison_prefilling)
    uid = victim[tserving]
    assert victim[jserving] == uid
    st = eng._results[uid]
    assert (st.status.value, st.finish_reason) == ("failed", "nan-logits")
    assert out[uid].size == 0 and st.ttft_s is None
    assert eng.stats["quarantined"] == 1 and eng.stats["poisoned"] == 0
    clean = _engine(tserving, dense, cfg)
    _submit(tserving, clean, (prompts, samp), 8)
    assert_survivors(out, eng, clean.run(max_steps=3000))


def test_nan_quarantine_on_the_verify_path(dense):
    cfg = dict(max_slots=3, max_seq=64, prefill_chunks=(4, 8))
    out, eng = _pair(dense, cfg, plan=(2, {"logits": (1.0, None, 1)}),
                     spec=dict(k=3, adaptive=False))
    assert eng.stats["quarantined"] >= 1 and eng.stats["spec_rounds"] > 0
    assert sum(st.status == tserving.Status.FAILED
               for st in eng._results.values()) == 1
    assert_survivors(out, eng, _clean(dense, cfg))


def test_draft_corruption_corrects_itself(dense):
    """The ``draft`` site corrupts whole rounds of proposals; every stream
    still equals the fault-free run, and the acceptance bookkeeping (the
    rounds it cost) equals the reference's."""
    cfg = dict(max_slots=3, max_seq=64, prefill_chunks=(4, 8))
    out, eng = _pair(dense, cfg, plan=(9, {"draft": (0.5, None, None)}),
                     spec=dict(k=3, adaptive=False))
    assert eng.stats["faults"]["draft"] > 0
    assert all(st.status == tserving.Status.FINISHED
               for st in eng._results.values())
    assert_survivors(out, eng, _clean(dense, cfg))


@pytest.mark.parametrize("family,chunks", [("dense", None),
                                           ("dense", (4, 8)),
                                           ("ssm", (4, 8))])
def test_dispatch_faults_never_change_a_stream(dense, ssm, family, chunks):
    models = dense if family == "dense" else ssm
    cfg = dict(MONO, prefill_chunks=chunks)
    sites = {"alloc": (0.2, None, None), "decode": (0.15, None, None)}
    if chunks:
        sites["chunk"] = (0.2, None, None)
    out, eng = _pair(models, cfg, plan=(3, sites))
    assert eng._injector.total_fired() > 0
    assert all(st.status == tserving.Status.FINISHED
               for st in eng._results.values())
    assert_survivors(out, eng, _clean(models, cfg))


def test_alloc_exhaustion_rejects_with_a_typed_error(dense):
    out, eng = _pair(dense, dict(max_slots=3, max_seq=64, page_size=8,
                                 admission_attempt_cap=3,
                                 admission_backoff_cap=4),
                     plan=(1, {"alloc": (1.0, None, None)}))
    for uid, st in eng._results.items():
        assert (st.status.value, st.finish_reason) == \
            ("failed", "admission-rejected")
        assert st.rejection.reason == "fault-injected"
        assert out[uid].size == 0
    assert eng.scheduler.stats["rejected"] == 5


def test_submit_sheds_when_unhealthy(dense):
    for mod in MODS:
        eng = _engine(mod, dense, dict(max_slots=2, max_seq=64), health={})
        req = mod.Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                          max_new_tokens=2)
        for state in ("SHEDDING", "DRAINING"):
            eng.health.state = mod.HealthState[state]
            with pytest.raises(mod.AdmissionRejected, match=state.lower()):
                eng.submit(req)
        eng.health.state = mod.HealthState.HEALTHY
        eng.submit(req)
        assert eng.run(max_steps=200)[0].size == 2


def test_draining_fails_waiting_requests(dense):
    prompts = [np.arange(6, dtype=np.int32) * 3 % 97,
               np.arange(6, dtype=np.int32) * 11 % 97]
    out, eng = _pair(dense, dict(max_slots=1, max_seq=64),
                     plan=(0, {"decode": (1.0, None, 6)}),
                     health=dict(fault_degraded=1, fault_shedding=2,
                                 fault_draining=3, shed_steps_draining=None),
                     traffic=(prompts, [None, None]), max_new=4)
    assert (eng._results[1].status.value,
            eng._results[1].finish_reason) == ("failed", "draining")
    assert out[1].size == 0
    assert eng._results[0].status == tserving.Status.FINISHED
    assert out[0].size == 4
    trans = [(f, t) for _, f, t, _ in eng.health.transitions]
    assert ("SHEDDING", "DRAINING") in trans


def test_ladder_turns_speculation_off_and_back_on(dense):
    """Consecutive decode faults walk the ladder to DEGRADED (queue decode,
    the slot vectors written from host state), the faults run out, the
    ladder recovers (rounds again, the queue retired first); the streams
    equal plain decode's and the JAX engine's."""
    cfg = dict(max_slots=3, max_seq=64, prefill_chunks=(4, 8))
    out, eng = _pair(dense, cfg, plan=(4, {"decode": (1.0, None, 4)}),
                     health=dict(fault_degraded=2, fault_shedding=8,
                                 fault_draining=12, recover_after=2,
                                 shed_steps_draining=None),
                     spec=dict(k=3, adaptive=False), max_new=12)
    trans = [(f, t) for _, f, t, _ in eng.health.transitions]
    assert ("HEALTHY", "DEGRADED") in trans
    assert ("DEGRADED", "HEALTHY") in trans
    assert eng.stats["spec_rounds"] > 0
    assert eng.stats["decode_steps"] > eng.stats["spec_rounds"]
    assert_survivors(out, eng, _clean(dense, cfg, max_new=12))


CHAOS = [("monolithic", "dense", "fp32", 0), ("monolithic", "dense", "fp32",
                                              1),
         ("chunked", "dense", "fp32", 0), ("chunked", "dense", "fp32", 1),
         ("shared", "dense", "fp32", 0), ("shared", "dense", "fp32", 1),
         ("chunked", "dense", "int8", 0), ("shared", "dense", "int8", 1),
         ("chunked", "ssm", "fp32", 0), ("shared", "ssm", "fp32", 1)]


def _chaos(models, mode, fmt, seed, spec=False):
    shared = mode == "shared"
    cfg = dict(MONO, kv_format=fmt,
               prefill_chunks=None if mode == "monolithic" else (4, 8),
               prefix_sharing=shared)
    out, eng = _pair(models, cfg,
                     plan=_chaos_plan(seed, spec=spec,
                                      chunked=mode != "monolithic"),
                     spec=dict(k=3, adaptive=False) if spec else None,
                     traffic=_traffic(shared))
    assert_survivors(out, eng, _clean(models, cfg, shared))
    return out, eng


@pytest.mark.parametrize("mode,family,fmt,seed", CHAOS)
def test_chaos_matches_reference(dense, ssm, mode, family, fmt, seed):
    """The reference's seeded chaos plans (alloc, decode, logits, chunk):
    the port's engine equals the JAX engine's, and the survivor contract
    holds."""
    _chaos(dense if family == "dense" else ssm, mode, fmt, seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_speculative_matches_reference(dense, seed):
    _, eng = _chaos(dense, "chunked", "fp32", seed, spec=True)
    assert eng.stats["spec_rounds"] > 0


def test_chaos_replays_exactly(dense):
    a_out, a = _chaos(dense, "chunked", "fp32", 0)
    b_out, b = _chaos(dense, "chunked", "fp32", 0)
    assert a.stats["faults"] == b.stats["faults"]
    assert {u: s.status for u, s in a._results.items()} == \
        {u: s.status for u, s in b._results.items()}
    for uid in a_out:
        np.testing.assert_array_equal(a_out[uid], b_out[uid])


def test_chaos_hypothesis_layer(dense):
    """Drawn chaos seeds and modes: the port equals the reference and the
    survivor contract holds."""
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as hst

    @settings(max_examples=4, deadline=None, database=None,
              suppress_health_check=list(HealthCheck))
    @given(seed=hst.integers(min_value=0, max_value=2 ** 16),
           mode=hst.sampled_from(["monolithic", "chunked", "shared"]))
    def prop(seed, mode):
        _chaos(dense, mode, "fp32", seed)

    prop()
