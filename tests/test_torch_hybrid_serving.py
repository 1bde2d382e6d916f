"""The port's serving engine over the hybrid family (hymba) against the JAX
package's, token for token, on the reference's tiny hybrid regime (3
layers, window 8, one global layer, f32) with prompts past the window: both
prefill modes at depth 0 and 2, under preemption, sampled, with prefix
sharing (forks read the donor's K/V rows through the donor table and
resume the SSD state from a snapshot), under fault plans, behind a router;
the refusals the reference keeps (narrow KV formats, speculative
decoding); the engine's byte report and the serve CLI, reduced, on the
CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

from test_torch_faults import (CHUNKED, DFT, MONO, T_DFT,  # noqa: E402
                               _chaos_plan, _clean, _pair, _traffic,
                               assert_survivors)
from test_torch_hybrid import TINY_HYBRID, V, hybrid_bridged  # noqa: E402
from test_torch_prefix_sharing import (STAT_KEYS, _case,  # noqa: E402
                                       _serve, _state)


@pytest.fixture(scope="module")
def models():
    return hybrid_bridged()


def _streams(models, lens, gens, **cfg):
    """The JAX engine and the port's on the same requests: streams and
    scheduler counters equal; returns the port's engine."""
    jm, jp, tm, tp = models
    outs, engs = [], []
    for mod, model, cfg_, params in ((jserving, jm, TINY_HYBRID, jp),
                                     (tserving, tm, tm.cfg, tp)):
        eng = mod.ServingEngine(model, cfg_, params,
                                config=mod.EngineConfig(**cfg))
        rng = np.random.default_rng(0)
        for i, (n, g) in enumerate(zip(lens, gens)):
            eng.submit(mod.Request(uid=i, prompt=rng.integers(0, V, n),
                                   max_new_tokens=g))
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
    return teng


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunks", [None, (4, 8)], ids=["mono", "chunked"])
def test_engine_streams_match_jax(models, depth, chunks):
    """Staggered admission (slots < requests), prompts of 9-21 tokens
    past the window of 8, mixed generation lengths."""
    _streams(models, (9, 21, 13, 17), (8, 6, 10, 7), max_slots=2,
             max_seq=64, depth=depth, prefill_chunks=chunks)


@pytest.mark.parametrize("chunks", [None, (4, 8)], ids=["mono", "chunked"])
def test_engine_preemption_replay_matches_jax(models, chunks):
    """--page-size 4 --pages 14: the youngest request is preempted and
    its rows and state re-derived by replaying its prompt."""
    eng = _streams(models, (20, 15, 20, 15, 20), (12,) * 5, max_slots=2,
                   max_seq=64, depth=2, page_size=4, num_pages=14,
                   prefill_chunks=chunks)
    assert eng.scheduler.stats["preempted"] > 0


@pytest.mark.parametrize("cfg", [MONO, CHUNKED], ids=["mono", "chunked"])
def test_sampled_traffic_matches_jax(models, cfg):
    """The reference's mixed traffic (greedy and sampled requests, top-k
    and top-p): streams, statuses and stats equal the JAX engine's."""
    out, eng = _pair(models, cfg)
    assert eng.stats["sampled_requests"] == 2
    assert all(st.status == tserving.Status.FINISHED
               for st in eng._results.values())


@pytest.mark.parametrize("case", ["cow", "donor-preempted"])
def test_prefix_sharing_matches_jax(models, case):
    """The shared-prefix cases of tests/test_torch_prefix_sharing.py over
    the mixed arena: streams equal the JAX engine's and sharing off, the
    fork, snapshot and page stats equal the reference's, and every donor
    entry returns to the identity."""
    jm, jp, tm, tp = models
    prompts, gens, kw = _case(case, V)
    want, jeng = _serve(jserving, jm, TINY_HYBRID, jp, prompts, gens,
                        prefix_sharing=True, **kw)
    got, eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens,
                      prefix_sharing=True, **kw)
    off, _ = _serve(tserving, tm, tm.cfg, tp, prompts, gens, **kw)
    assert got == want == off
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert eng.stats["forks"] >= 1 and eng.stats["snapshots"] >= 1
    assert eng.cache_mgr.stats == {k: jeng.cache_mgr.stats[k]
                                   for k in eng.cache_mgr.stats}
    assert _state(eng.cache_mgr) == _state(jeng.cache_mgr)
    # a snapshot holds the state leaves only, not the K/V rows
    nh = TINY_HYBRID.ssm.n_heads(TINY_HYBRID.d_model)
    assert eng.stats["snapshot_bytes"] == TINY_HYBRID.n_layers * 4 * (
        nh * 8 * 8 + 3 * (64 + 16))
    src, ln = eng._share
    assert src.tolist() == list(range(eng.max_slots))
    assert ln.tolist() == [0] * eng.max_slots


@pytest.mark.parametrize("mode,seed", [("chunked", 0), ("shared", 1),
                                       ("monolithic", 1)])
def test_fault_plan_matches_jax(models, mode, seed):
    """The reference's seeded chaos plans (alloc, decode, logits, chunk)
    over the mixed arena: statuses, fault counts and quarantines equal
    the JAX engine's, and the survivors keep the fault-free streams."""
    shared = mode == "shared"
    cfg = dict(MONO, prefill_chunks=None if mode == "monolithic"
               else (4, 8), prefix_sharing=shared)
    out, eng = _pair(models, cfg,
                     plan=_chaos_plan(seed, chunked=mode != "monolithic"),
                     traffic=_traffic(shared))
    assert sum(eng.stats["faults"].values()) > 0
    assert_survivors(out, eng, _clean(models, cfg, shared))


def test_nan_poison_covers_every_leaf_and_is_quarantined(models):
    """The logits site fills one resident's K/V rows, SSD state and conv
    tail with NaN; the flag quarantines it as the JAX engine does, the
    survivors keep their streams, and a scrub zeroes all four leaves."""
    cfg = dict(CHUNKED)
    fills = []

    def watch(mod, eng):
        if mod is not tserving:
            return
        fill = eng._fill_slot

        def spy(slot, value, *, floating_only):
            fill(slot, value, floating_only=floating_only)
            view = eng.model.slot_view(eng._cache, slot)
            fills.append((value == value, {
                k: bool((v.eq(0) if value == value else v.isnan()).all())
                for k, v in view.items()}))
        eng._fill_slot = spy

    out, eng = _pair(models, cfg, plan=(5, {"logits": (1.0, None, 1)}),
                     before_run=watch)
    assert eng.stats["poisoned"] == eng.stats["quarantined"] == 1
    assert [scrub for scrub, _ in fills].count(False) == 1
    for _, leaves in fills:
        assert leaves == dict.fromkeys(("k", "v", "ssm", "conv"), True)
    assert_survivors(out, eng, _clean(models, cfg))


def test_router_matches_jax_router(models):
    """Two replicas under least-pressure placement: the merged streams,
    placements and router stats equal the JAX router's."""
    jm, jp, tm, tp = models
    got = []
    for mod, model, cfg, params in ((jserving, jm, TINY_HYBRID, jp),
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


@pytest.mark.parametrize("what", ["int8", "bf16", "speculative"])
def test_refusals_match_jax(models, what):
    """Narrow KV formats and speculative decoding are refused with
    ValueError by both engines, as the reference refuses them."""
    jm, jp, tm, tp = models
    for mod, model, cfg, params, draft in (
            (jserving, jm, TINY_HYBRID, jp, DFT),
            (tserving, tm, tm.cfg, tp, T_DFT)):
        kw = (dict(speculative=mod.SpecConfig(draft=draft))
              if what == "speculative" else dict(kv_format=what))
        with pytest.raises(ValueError):
            mod.ServingEngine(model, cfg, params,
                              config=mod.EngineConfig(max_seq=32, **kw))


def test_engine_reports_row_and_state_bytes(models):
    """kv_row_bytes as the reference reports it (K/V of one row, all
    layers), and the state bytes of a slot beside it."""
    jm, jp, tm, tp = models
    cfg = dict(max_slots=3, max_seq=40)
    jeng = jserving.ServingEngine(jm, TINY_HYBRID, jp,
                                  config=jserving.EngineConfig(**cfg))
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(**cfg))
    assert eng.stats["kv_row_bytes"] == jeng.stats["kv_row_bytes"] == \
        3 * 2 * 2 * 8 * 4
    nh = TINY_HYBRID.ssm.n_heads(TINY_HYBRID.d_model)
    per_slot = 3 * 4 * (nh * 8 * 8 + 3 * (64 + 16))
    assert eng.stats["state_bytes_per_slot"] == eng.state_bytes_per_slot \
        == per_slot
    assert eng.arena_bytes == 3 * (40 * eng.kv_row_bytes + per_slot)


@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
def test_serve_cli_hymba_on_cpu(capsys, mode):
    """The reduced hymba-1.5b (window 32) through the CLI with 40-token
    prompts: both byte figures, no kernel launch on the CPU."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "hymba-1.5b", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "40", "--gen", "4",
                       "--slots", "2", "--prefill-mode", mode,
                       "--chunk-buckets", "8,16"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "bytes/row" in out and "state bytes/slot" in out
    assert "'ssd': 0" in out
