"""The port's serving engine over the moe family against the JAX package's,
token for token, on the reference's tiny moe regime (2 layers, 4 experts
top 2, capacity_factor 2.0 = E / k, so capacity never binds, f32): both
prefill modes at depth 0 and 2, under preemption, sampled, over an int8
arena, with prefix sharing, under fault plans, behind a router; one greedy
case under a binding capacity (capacity_factor 1.0) where the rows that
are not tokens of a live request (a chunk's pad rows, the decode batch's
parked and dead slots) compete for capacity, so the port must feed them
the reference's contents; the refusal of speculative decoding; the
engine's byte report and the serve CLI, reduced, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

from repro_torch.runtime.serving import graphs  # noqa: E402
from repro_torch.runtime.serving.request import Status  # noqa: E402

from test_torch_chunk_graphs import _staged  # noqa: E402
from test_torch_faults import (CHUNKED, DFT, MONO, T_DFT,  # noqa: E402
                               _chaos_plan, _clean, _pair, _traffic,
                               assert_survivors)
from test_torch_moe import BINDING, TINY_MOE, V, moe_bridged  # noqa: E402
from test_torch_graphs import NoHostRead, _engine  # noqa: E402
from test_torch_prefix_sharing import (STAT_KEYS, _case,  # noqa: E402
                                       _serve, _state)


@pytest.fixture(scope="module")
def models():
    return moe_bridged()


@pytest.fixture(scope="module")
def binding():
    return moe_bridged(BINDING)


def _requests(mod, eng, lens, gens):
    rng = np.random.default_rng(0)
    for i, (n, g) in enumerate(zip(lens, gens)):
        eng.submit(mod.Request(uid=i, prompt=rng.integers(0, V, n),
                               max_new_tokens=g))


def _port_streams(models, lens, gens, **cfg):
    """The port's streams alone (where the JAX engine's equality is held
    by another case)."""
    _, _, tm, tp = models
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(**cfg))
    _requests(tserving, eng, lens, gens)
    return eng.run(max_steps=2000)


def _streams(models, lens, gens, **cfg):
    """The JAX engine and the port's on the same requests: streams and
    scheduler counters equal; returns (port engine, JAX engine, port
    streams, JAX streams)."""
    jm, jp, tm, tp = models
    outs, engs = [], []
    for mod, model, cfg_, params in ((jserving, jm, jm.cfg, jp),
                                     (tserving, tm, tm.cfg, tp)):
        eng = mod.ServingEngine(model, cfg_, params,
                                config=mod.EngineConfig(**cfg))
        _requests(mod, eng, lens, gens)
        outs.append(eng.run(max_steps=2000))
        engs.append(eng)
    want, got = outs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
    jeng, teng = engs
    assert teng.scheduler.stats == {k: jeng.scheduler.stats[k]
                                    for k in teng.scheduler.stats}
    return teng, jeng, got, want


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunks", [None, (4, 8)], ids=["mono", "chunked"])
def test_engine_streams_match_jax(models, depth, chunks):
    """Staggered admission (slots < requests), prompts of 9-21 tokens,
    mixed generation lengths."""
    _streams(models, (9, 21, 13, 17), (8, 6, 10, 7), max_slots=2,
             max_seq=64, depth=depth, prefill_chunks=chunks)


@pytest.mark.parametrize("chunks", [None, (4, 8)], ids=["mono", "chunked"])
def test_engine_preemption_replay_matches_jax(models, chunks):
    """--page-size 4 --pages 14: the youngest request is preempted and
    its rows re-derived by replaying its prompt."""
    eng, *_ = _streams(models, (21, 17, 21, 17, 21), (12,) * 5,
                       max_slots=2, max_seq=64, depth=2, page_size=4,
                       num_pages=14, prefill_chunks=chunks)
    assert eng.scheduler.stats["preempted"] > 0


def test_int8_arena_streams_match_jax(models):
    """The int8 arena (the dense arena's scaled format, which the moe
    family keeps), chunked: streams equal the JAX engine's over the same
    format, and kv_row_bytes its (sharing over int8 below)."""
    eng, jeng, *_ = _streams(models, (9, 21, 13), (8, 6, 10), max_slots=2,
                             max_seq=64, depth=2, prefill_chunks=(4, 8),
                             kv_format="int8")
    assert eng.kv_row_bytes == jeng.kv_row_bytes


def test_capacity_free_streams_do_not_depend_on_batching(models):
    """With capacity free every token's output is its own: the port's
    streams of monolithic and chunked prefill, and of 1 and 3 slots, are
    equal (each mode's equality with the JAX engine is held above)."""
    runs = [_port_streams(models, (9, 21, 13), (8, 6, 10), max_slots=slots,
                          max_seq=64, depth=1, prefill_chunks=chunks)
            for slots, chunks in ((3, None), (3, (4, 8)), (1, (8,)))]
    for other in runs[1:]:
        assert sorted(other) == sorted(runs[0])
        for uid in runs[0]:
            np.testing.assert_array_equal(other[uid], runs[0][uid])


def _margins(tm, tp, prompt, out):
    """The top-2 router margin (probability) of every (token, layer)
    dispatch of a request served alone: where the smallest sits."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    tokens = torch.as_tensor(np.concatenate([prompt, out[:-1]]))[None]
    cfg = tm.cfg
    x = L.embed_lookup(tp["embed"], tokens)
    cache = tm.init_cache(1, tokens.shape[1] + 1)
    pos = torch.arange(tokens.shape[1])[None]
    least = []
    for i in range(cfg.n_layers):
        p = T.layer_params(tp["layers"], i)
        h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
        x = x + T.attention_prefill(p["attn"], cfg, h,
                                    {k: v[i] for k, v in cache.items()}, pos)
        h2 = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
        probs = torch.softmax(h2[0].float() @ p["moe"]["router"], -1)
        top = torch.sort(probs, -1, descending=True).values
        k = cfg.moe.top_k
        least.append(float((top[:, k - 1] - top[:, k]).min()))
        x = x + TM.moe_mlp_apply(p["moe"], cfg, h2)[0]
    return min(least)


def test_binding_capacity_streams_match_jax(models, binding):
    """capacity_factor 1.0, where capacity binds in decode (3 slots, cap
    1 of 4 experts, 6 choices) and in each chunk: the rows that are not a
    live request's tokens are the reference's, so every stream equals the
    JAX engine's.  A decode step's parked and dead slots keep their last
    token and position and take pairs from the slots after them (a dead
    slot's token changed flips streams); a chunk's pad rows (token 0) come
    last in its dispatch, so only their count (the cap) reaches the real
    rows.  Chunked prefill parks a slot while the others decode, and a
    finished slot decodes on masked.  The streams differ from
    the capacity-free regime's on the same weights; the smallest top-2
    router margin is printed, so a divergence can be told from a
    near-tie."""
    lens, gens = (9, 21, 13, 17), (10, 6, 12, 7)
    kw = dict(max_slots=3, max_seq=64, depth=2, prefill_chunks=(4, 8))
    eng, jeng, got, want = _streams(binding, lens, gens, **kw)
    assert TM.capacity(eng.cfg, eng.max_slots) == 1
    free = _port_streams(models, lens, gens, **kw)
    assert any((free[u] != got[u]).any() for u in got)
    jm, jp, tm, tp = binding
    prompt = np.random.default_rng(0).integers(0, V, lens[0])
    print(f"smallest top-2 router margin along request 0: "
          f"{_margins(tm, tp, prompt, got[0]):.3e}")
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]


def _mixed(binding):
    """A port engine under binding capacity stepped until a slot decodes
    beside one mid-chunked-prefill (and an unused one); returns (engine,
    the prefilling request's state)."""
    _, _, tm, tp = binding
    eng = _engine(tserving, tm, tm.cfg, tp)
    for _ in range(50):
        states = {st.status: st for st in eng.scheduler.running.values()}
        if Status.RUNNING in states and Status.PREFILLING in states:
            return eng, states[Status.PREFILLING]
        eng.step()
    raise AssertionError("no prefilling slot beside a decoding one")


def _bytes(eng, scalars=None) -> dict:
    state = {f"cache.{k}": v for k, v in eng._cache.items()}
    state.update(tokens=eng._tokens, pos=eng._pos, active=eng._active)
    if scalars is not None:
        state["scalars"] = scalars
    return {k: v.detach().clone().view(torch.uint8)
            for k, v in state.items()}


def test_captured_steps_make_no_host_read(binding):
    """The functions the decode graphs (greedy and sampled) and a chunk
    graph capture run through the moe layers with no host read (no
    ``.item()``, no ``nonzero``, no boolean-mask index: routing,
    capacity, dispatch and combine are shaped by t, k, E and cap alone),
    live, parked and never-used slots side by side, under binding
    capacity."""
    eng, st = _mixed(binding)
    tokens, scalars = _staged(eng, st)
    with NoHostRead():
        out = eng._chunk_step(tokens, scalars)
        assert out.shape == (1, eng.cfg.vocab)
        assert eng._decode_step().shape == (2, eng.max_slots)
        assert eng._decode_step_sampled().shape == (2, eng.max_slots)


def test_parked_warm_ups_leave_no_trace(binding):
    """The parked warm-ups that precede capture (the decode step with
    every slot parked, a chunk at start = PARKED_POS) leave the arena and
    the slot vectors bit for bit under binding capacity, and the run then
    gives the streams of an engine that ran none."""
    _, _, tm, tp = binding
    eng, st = _mixed(binding)
    tokens, scalars = _staged(eng, st)
    before = _bytes(eng, scalars)
    graphs.parked_warm_up(eng._decode_step, eng._tokens, eng._pos,
                          eng._active)
    graphs.parked_chunk_warm_up(lambda: eng._chunk_step(tokens, scalars),
                                scalars)
    after = _bytes(eng, scalars)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    got = eng.run(max_steps=2000)
    want = _engine(tserving, tm, tm.cfg, tp).run(max_steps=2000)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


@pytest.mark.parametrize("cfg", [MONO, CHUNKED], ids=["mono", "chunked"])
def test_sampled_traffic_matches_jax(models, cfg):
    """The reference's mixed traffic (greedy and sampled requests, top-k
    and top-p): streams, statuses and stats equal the JAX engine's."""
    out, eng = _pair(models, cfg)
    assert eng.stats["sampled_requests"] == 2
    assert all(st.status == tserving.Status.FINISHED
               for st in eng._results.values())


@pytest.mark.parametrize("case,fmt", [("cow", "fp32"),
                                      ("donor-preempted", "fp32"),
                                      ("cow", "int8")])
def test_prefix_sharing_matches_jax(models, case, fmt):
    """The shared-prefix cases of tests/test_torch_prefix_sharing.py over
    the moe model's dense arena: streams equal the JAX engine's and
    sharing off, the fork and page stats equal the reference's, forks
    read the donor's rows through the table (no snapshot: no recurrent
    state), and every donor entry returns to the identity."""
    jm, jp, tm, tp = models
    prompts, gens, kw = _case(case, V)
    kw = dict(kw, kv_format=fmt)
    want, jeng = _serve(jserving, jm, jm.cfg, jp, prompts, gens,
                        prefix_sharing=True, **kw)
    got, eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens,
                      prefix_sharing=True, **kw)
    off, _ = _serve(tserving, tm, tm.cfg, tp, prompts, gens, **kw)
    assert got == want == off
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert eng.stats["forks"] >= 1 and eng.stats["snapshots"] == 0
    assert eng.cache_mgr.stats == {k: jeng.cache_mgr.stats[k]
                                   for k in eng.cache_mgr.stats}
    assert _state(eng.cache_mgr) == _state(jeng.cache_mgr)
    src, ln = eng._share
    assert src.tolist() == list(range(eng.max_slots))
    assert ln.tolist() == [0] * eng.max_slots


@pytest.mark.parametrize("mode,seed", [("chunked", 0), ("shared", 1),
                                       ("monolithic", 1)])
def test_fault_plan_matches_jax(models, mode, seed):
    """The reference's seeded chaos plans (alloc, decode, logits, chunk)
    over the moe model: statuses, fault counts and quarantines equal the
    JAX engine's, and the survivors keep the fault-free streams."""
    shared = mode == "shared"
    cfg = dict(MONO, prefill_chunks=None if mode == "monolithic"
               else (4, 8), prefix_sharing=shared)
    out, eng = _pair(models, cfg,
                     plan=_chaos_plan(seed, chunked=mode != "monolithic"),
                     traffic=_traffic(shared))
    assert sum(eng.stats["faults"].values()) > 0
    assert_survivors(out, eng, _clean(models, cfg, shared))


def test_router_matches_jax_router(models):
    """Two replicas under least-pressure placement: the merged streams,
    placements and router stats equal the JAX router's."""
    jm, jp, tm, tp = models
    got = []
    for mod, model, cfg, params in ((jserving, jm, jm.cfg, jp),
                                    (tserving, tm, tm.cfg, tp)):
        router = mod.Router(model, cfg, params, config=mod.RouterConfig(
            replicas=2, placement="least-pressure",
            engine=mod.EngineConfig(max_slots=2, max_seq=64, depth=1,
                                    page_size=8, prefill_chunks=(4, 8))))
        rng = np.random.default_rng(11)
        for i, n in enumerate((9, 21, 13, 17, 11, 6)):
            sp = (mod.SamplingParams(temperature=1.1, top_k=20, seed=300 + i)
                  if i % 2 else mod.GREEDY)
            router.submit(mod.Request(uid=i, prompt=rng.integers(0, V, n),
                                      max_new_tokens=8, sampling=sp))
        got.append((router.run(max_steps=3000), router))
    (jout, jr), (tout, tr) = got
    assert sorted(tout) == sorted(jout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], np.asarray(jout[uid]))
    assert tr.stats == jr.stats
    assert {u: tr.owner_of(u) for u in tout} == \
        {u: jr.owner_of(u) for u in jout}


def test_speculative_decoding_refused_as_the_reference(models):
    """Speculation is dense-only: both engines refuse a moe target with
    the same ValueError message."""
    jm, jp, tm, tp = models
    msgs = []
    for mod, model, cfg, params, draft in (
            (jserving, jm, jm.cfg, jp, DFT),
            (tserving, tm, tm.cfg, tp, T_DFT)):
        with pytest.raises(ValueError) as exc:
            mod.ServingEngine(model, cfg, params, config=mod.EngineConfig(
                max_seq=32, speculative=mod.SpecConfig(draft=draft)))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert "target family is 'moe'" in msgs[1]


def test_engine_reports_row_bytes(models):
    """kv_row_bytes as the reference reports it (K/V of one row, all
    layers), no state bytes, the arena K/V only."""
    jm, jp, tm, tp = models
    cfg = dict(max_slots=3, max_seq=40)
    jeng = jserving.ServingEngine(jm, TINY_MOE, jp,
                                  config=jserving.EngineConfig(**cfg))
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(**cfg))
    assert eng.stats["kv_row_bytes"] == jeng.stats["kv_row_bytes"] == \
        2 * 2 * 2 * 8 * 4
    assert eng.state_bytes_per_slot == 0
    assert "state_bytes_per_slot" not in eng.stats
    assert eng.arena_bytes == 3 * 40 * eng.kv_row_bytes


@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
def test_serve_cli_qwen2_moe_on_cpu(capsys, mode):
    """The reduced qwen2-moe-a2.7b (4 experts top 2, 2 shared) through the
    CLI: the row bytes, no kernel launch on the CPU."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20", "--gen", "4",
                       "--slots", "2", "--prefill-mode", mode,
                       "--chunk-buckets", "8,16"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "bytes/row" in out and "state bytes/slot" not in out
    assert "'flash_decode': 0" in out
