"""Speculative decoding in the port (``runtime/serving/speculative.py``,
``LM.verify_chunk``, ``Scheduler.on_tokens``, the engine's rounds) against
the JAX package at the reference's tiny regime (tests/test_speculative.py:
24-36, f32), on the CPU where every step runs eagerly.

  * host logic: ``SpecConfig`` validation and ``ladder()``, the
    controller's family and vocab gates and its adaptive-k walk,
    ``accept_tokens`` and ``on_tokens``, each against the reference's
    result on the same inputs;
  * ``LM.verify_chunk`` against the reference's on the same weights: every
    row's logits and the slot's arena rows, at C = 1, 3 and 4, at a start
    inside the slot and at one that overruns max_seq by C - 1 rows (no row
    below start moves, no other slot moves), over fp32, bf16 and int8
    arenas;
  * ``verify_draws`` with device slot / start against the host-int call
    and the reference's;
  * the engine: speculative streams equal the port's plain engine and the
    JAX speculative engine bit for bit (greedy and sampled mixed,
    monolithic and chunked; preemption on an undersized pool; adaptive
    back-off to k = 1; narrow arenas), and with the JAX engine's draft
    weights converted into the port's draft, the round, acceptance and k
    statistics equal the reference's; a non-finite verify quarantines its
    slot only; the refusals (ssm target, vocab mismatch, prefix sharing);
  * the serve CLI's ``--speculative``.

The captured draft and verify graphs run on the card only
(``tests/test_torch_cuda.py``); their steps' host-read guards are in
``tests/test_torch_graphs.py`` and ``tests/test_torch_chunk_graphs.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig, SSMConfig  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime.serving import sampling as jsampling  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models.layers import PARKED_POS  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import sampling as tsampling  # noqa: E402
from repro_torch.runtime.serving.request import Status  # noqa: E402

from test_torch_chunk_graphs import _close_rows  # noqa: E402
from test_torch_model import bridged, port_cfg  # noqa: E402

TGT = ArchConfig(name="tiny-spec-target", family="dense", n_layers=2,
                 d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
                 head_dim=8, param_dtype="float32", act_dtype="float32",
                 max_seq=64)
DFT = ArchConfig(name="tiny-spec-draft", family="dense", n_layers=1,
                 d_model=16, n_heads=2, n_kv_heads=1, d_ff=32, vocab=97,
                 head_dim=8, param_dtype="float32", act_dtype="float32",
                 max_seq=64)
SSM = ArchConfig(name="tiny-spec-ssm", family="ssm", n_layers=2, d_model=32,
                 n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
                 ssm=SSMConfig(d_state=8, headdim=8, chunk=16),
                 param_dtype="float32", act_dtype="float32",
                 subquadratic=True, max_seq=64)
T_TGT, T_DFT, T_SSM = port_cfg(TGT), port_cfg(DFT), port_cfg(SSM)
#: logits against the JAX package (both f32, sums in another order); a
#: narrow arena's quantized rows may differ by a grid step, 2e-3
#: (tests/test_torch_chunk_graphs.py)
LOGIT_TOL = 1e-4
NARROW_TOL = 2e-3


# ---------------------------------------------------------------------------
# config + controller (host logic)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(k=0), dict(k=4, k_max=2),
                                dict(low=0.9, high=0.5), dict(window=0),
                                dict(ema=1.0), dict(ema=0.0),
                                dict(low=-0.1), dict(high=1.5)])
def test_specconfig_refusals_match_reference(kw):
    with pytest.raises(ValueError):
        jserving.SpecConfig(draft=DFT, **kw)
    with pytest.raises(ValueError):
        tserving.SpecConfig(draft=T_DFT, **kw)


@pytest.mark.parametrize("k,k_max", [(1, 1), (3, 8), (4, 4), (5, 16),
                                     (2, 3)])
def test_ladder_matches_reference(k, k_max):
    assert tserving.SpecConfig(draft=T_DFT, k=k, k_max=k_max).ladder() == \
        jserving.SpecConfig(draft=DFT, k=k, k_max=k_max).ladder()


def test_engineconfig_speculative_validation():
    spec = tserving.SpecConfig(draft=T_DFT)
    assert tserving.EngineConfig(speculative=spec).speculative is spec
    assert tserving.EngineConfig().speculative is None
    for mod, s in ((jserving, "draft"), (tserving, "draft")):
        with pytest.raises(ValueError, match="SpecConfig"):
            mod.EngineConfig(speculative=s)
    for mod, d in ((jserving, DFT), (tserving, T_DFT)):
        with pytest.raises(ValueError, match="prefix_sharing"):
            mod.EngineConfig(prefill_chunks=(8, 16), prefix_sharing=True,
                             speculative=mod.SpecConfig(draft=d))
    # donate has no counterpart (the arena is written in place); faults
    # and health are fields now (tests/test_torch_faults.py)
    with pytest.raises(TypeError):
        tserving.EngineConfig(donate=None)
    for name in ("faults", "health"):
        assert getattr(tserving.EngineConfig(**{name: None}), name) is None


@pytest.mark.parametrize("target,draft", [
    ("ssm", "dense"), ("dense", "ssm"), ("dense", "vocab96")],
    ids=["ssm-target", "ssm-draft", "vocab-mismatch"])
def test_controller_refusals_match_reference(target, draft):
    cfgs = {"dense": (TGT, T_TGT), "ssm": (SSM, T_SSM),
            "vocab96": (dataclasses.replace(DFT, name="v96", vocab=96),
                        dataclasses.replace(T_DFT, name="v96", vocab=96))}
    if draft == "dense":
        draft_j, draft_t = DFT, T_DFT
    else:
        draft_j, draft_t = cfgs[draft]
    (tj, tt) = cfgs[target]
    match = "vocab" if draft == "vocab96" else "family"
    with pytest.raises(ValueError, match=match):
        jserving.SpecController(tj, jserving.SpecConfig(draft=draft_j))
    with pytest.raises(ValueError, match=match):
        tserving.SpecController(tt, tserving.SpecConfig(draft=draft_t),
                                device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("adaptive", [True, False])
def test_controller_walk_matches_reference(seed, adaptive):
    """Both controllers through the same random round outcomes (runs of
    rejects and of full accepts, so k walks both ways): k, the stats and
    the acceptance rate equal after every round."""
    kw = dict(k=4, k_max=8, window=2, low=0.4, high=0.85, ema=0.5,
              adaptive=adaptive)
    jc = jserving.SpecController(TGT, jserving.SpecConfig(draft=DFT, **kw))
    tc = tserving.SpecController(T_TGT, tserving.SpecConfig(draft=T_DFT,
                                                            **kw),
                                 device="cpu")
    rng = np.random.default_rng(seed)
    walked = set()
    for r in range(60):
        hot = (r // 10) % 2 == 1
        outcomes = []
        for uid in range(int(rng.integers(0, 4))):
            acc = tc.k if hot and rng.random() < 0.9 else \
                int(rng.integers(0, tc.k + 1))
            outcomes.append((uid, acc, tc.k))
        jc.observe_round(outcomes)
        tc.observe_round(outcomes)
        assert tc.k == jc.k and tc.stats == jc.stats, r
        assert tc.acceptance_rate == jc.acceptance_rate
        walked.add(tc.k)
    if adaptive:
        assert len(walked) > 2 and tc.stats["k_changes"] > 2, walked
    else:
        assert walked == {4} and tc.stats["k_changes"] == 0


def test_draft_memo_and_registry_draft():
    """A registry name builds the reduced config, as in the reference; one
    model per (draft, device, kernels), so a CPU engine and a plain-kernel
    one never share a draft."""
    from repro_torch.kernels import ops
    a = tserving.SpecController(T_TGT, tserving.SpecConfig(draft=T_DFT),
                                device="cpu")
    b = tserving.SpecController(T_TGT, tserving.SpecConfig(draft=T_DFT),
                                device="cpu")
    c = tserving.SpecController(T_TGT, tserving.SpecConfig(draft=T_DFT),
                                device="cpu", kernels=ops.PLAIN)
    assert a.draft_model is b.draft_model
    assert c.draft_model is not a.draft_model and c.draft_model.kops is ops.PLAIN
    assert a.draft_model.device.type == "cpu"
    red = treg.config("llama3.2-3b").reduced()
    ctl = tserving.SpecController(red, tserving.SpecConfig(
        draft="llama3.2-3b"), device="cpu")
    assert ctl.draft_cfg == red
    jctl = jserving.SpecController(
        jreg.config("llama3.2-3b").reduced(),
        jserving.SpecConfig(draft="llama3.2-3b"))
    assert jctl.draft_cfg.vocab == ctl.draft_cfg.vocab
    with pytest.raises(ValueError, match="vocab"):
        tserving.SpecController(treg.config("llama3.2-3b"),
                                tserving.SpecConfig(draft="llama3.2-3b"),
                                device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_tokens_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(1, 9))
        proposed = rng.integers(0, 3, k)
        draws = np.where(rng.random(k) < 0.7, proposed, rng.integers(0, 3, k))
        got = tsampling.accept_tokens(proposed, draws)
        assert got == jsampling.accept_tokens(proposed, draws)
        assert 1 <= len(got[1]) <= k


def _on_tokens_trace(mod, commits, *, pages, eos=None, max_new=6):
    """Drive ``mod``'s scheduler: two requests (prompts of 8 tokens) in a
    pool of ``pages`` pages of 4 rows, then ``commits`` ((slot, tokens),
    ...) through ``on_tokens``; returns what each commit gave and the
    requests' final state."""
    s = mod.Scheduler(2, mod.PagedKVCacheManager(pages, 4))
    for uid in range(2):
        s.submit(mod.Request(uid=uid, prompt=np.arange(8, dtype=np.int32),
                             max_new_tokens=max_new, eos_id=eos))
    states = s.schedule()
    trace = []
    for slot, toks in commits:
        n, deps = s.on_tokens(slot, toks)
        trace.append((n, [(d, st.request.uid) for d, st in deps]))
    final = [(st.status.value, list(st.generated), st.finish_reason,
              st.slot) for st in states]
    return trace, final, dict(s.stats)


@pytest.mark.parametrize("commits,pages,eos", [
    (((0, [7, 8]), (0, [42, 9]), (0, [1, 2])), 64, 42),      # EOS mid-way
    (((0, [1, 2, 3, 4]), (0, [5, 6, 7])), 64, None),          # max_new cap
    (((0, [1, 2, 3, 4, 5]), (1, [1, 2])), 6, None),           # preempts 1
    (((1, [1, 2, 3, 4, 5]), (0, [1]), (1, [9])), 6, None),    # preempts self
    (((1, [3]), (0, [1, 1, 1, 1, 1, 1, 1])), 7, None),
], ids=["eos", "max-new", "preempt-other", "preempt-self", "long"])
def test_on_tokens_matches_reference(commits, pages, eos):
    """``on_tokens`` stops at the first departure (EOS, the max_new cap or
    a preemption of its own slot) and drops the tokens past it, exactly
    as the reference's."""
    want = _on_tokens_trace(jserving, commits, pages=pages, eos=eos)
    got = _on_tokens_trace(tserving, commits, pages=pages, eos=eos)
    assert got[:2] == want[:2]
    assert got[2] == {k: want[2][k] for k in got[2]}


# ---------------------------------------------------------------------------
# LM.verify_chunk and verify_draws against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def target():
    """(jax model, jax params, port model, port params) of TGT on the same
    numpy-made weights."""
    return bridged(TGT)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8"])
def test_verify_chunk_matches_jax(target, fmt, c):
    """A prompt of 9 tokens chunked into slot 1 of a 3-slot, 24-row arena
    (every slot holding stale values), then verify chunks of C tokens at
    start 9 and at start 23, which overruns the slot by C - 1 rows: every
    row's logits within the tolerance of the reference's ``verify_chunk``,
    the slot's rows as ``_close_rows`` says, no row below start moved, and
    slots 0 and 2 bit for bit."""
    jm, jp, tm, tp = target
    S = 24
    tc = tm.init_cache(3, S, kv_format=fmt)
    for k, v in tc.items():
        if v.dtype == torch.float32:
            v.copy_(torch.linspace(-0.5, 0.5, v.numel()).view(v.shape))
    jc = jm.init_cache(3, S, kv_format=fmt)
    jc = {k: jnp.asarray(tc[k].float().numpy()).astype(jc[k].dtype)
          for k in jc}
    rng = np.random.default_rng(c)
    prompt = rng.integers(0, 97, 9).astype(np.int32)
    jlog, jc = jax.jit(jm.prefill_chunk)(jp, jnp.asarray(prompt)[None], jc,
                                         jnp.int32(1), jnp.int32(0),
                                         jnp.int32(8))
    tm.prefill_chunk(tp, torch.from_numpy(prompt).long()[None], tc, 1, 0, 8)
    stale = {s: {k: v.clone() for k, v in tm.slot_view(tc, s).items()}
             for s in (0, 2)}
    tol = LOGIT_TOL if fmt == "fp32" else NARROW_TOL
    fn = jax.jit(jm.verify_chunk)
    for start in (9, S - 1):
        toks = rng.integers(0, 97, c).astype(np.int32)
        below = {k: v[:, 1, :start].clone() for k, v in tc.items()}
        jl, jc = fn(jp, jnp.asarray(toks)[None], jc, jnp.int32(1),
                    jnp.int32(start))
        tl = tm.verify_chunk(tp, torch.from_numpy(toks).long()[None], tc,
                             torch.tensor(1), torch.tensor(start))
        assert tl.shape == (1, c, 97) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=0, err_msg=f"start {start}")
        for k, v in below.items():
            assert torch.equal(tc[k][:, 1, :start].view(torch.uint8),
                               v.view(torch.uint8)), (start, k)
        for k in tc:
            _close_rows(tc[k], jc[k], fmt)
    for s, rows in stale.items():
        for k, v in tm.slot_view(tc, s).items():
            assert torch.equal(v.view(torch.uint8),
                               rows[k].view(torch.uint8)), (s, k)


def test_verify_chunk_host_ints_and_rows(target):
    """Host ints are turned into device scalars (a slot out of range
    raises, as for a chunk); row j of the verify logits equals a decode
    step at pos = start + j over the same arena rows, within the tiny
    regime's tolerance."""
    _, _, tm, tp = target
    cache = tm.init_cache(2, 32)
    prompt = torch.arange(7)[None] % 97
    tm.prefill_chunk(tp, prompt, cache, 0, 0, 6)
    toks = torch.tensor([[5, 9, 11]])
    with pytest.raises(ValueError, match="slot"):
        tm.verify_chunk(tp, toks, cache, 2, 7)
    logits = tm.verify_chunk(tp, toks, cache, 0, 7)
    dcache = tm.init_cache(2, 32)
    tm.prefill_chunk(tp, prompt, dcache, 0, 0, 6)
    for j in range(3):
        row = tm.decode_step(tp, torch.tensor([int(toks[0, j]), 0]), dcache,
                             torch.tensor([7 + j, PARKED_POS]))[0]
        torch.testing.assert_close(logits[0, j], row, atol=LOGIT_TOL,
                                   rtol=0)


def test_verify_chunk_marks_its_launches(target, monkeypatch):
    """``LM.verify_chunk`` runs its layers inside ``ops.verify_pass`` (on
    the card its flash_prefill_chunk launches also count as
    ``flash_prefill_chunk_verify``), a prompt chunk outside it; the mark
    nests and is taken off on an exception."""
    from repro_torch.kernels import flash_prefill_chunk as fpc, ops
    _, _, tm, tp = target
    seen = []
    hidden = tm._chunk_hidden

    def spy(*args, **kw):
        seen.append(fpc._verifying)
        return hidden(*args, **kw)

    monkeypatch.setattr(tm, "_chunk_hidden", spy)
    cache = tm.init_cache(2, 32)
    tm.prefill_chunk(tp, torch.arange(6)[None], cache, 0, 0, 5)
    tm.verify_chunk(tp, torch.tensor([[5, 9]]), cache, 0, 6)
    assert seen == [False, True] and not fpc._verifying
    with ops.verify_pass():
        with ops.verify_pass():
            assert fpc._verifying
        assert fpc._verifying
    with pytest.raises(RuntimeError):
        with ops.verify_pass():
            raise RuntimeError
    assert not fpc._verifying


@pytest.mark.parametrize("slot", [0, 2])
def test_verify_draws_device_scalars_match_jax(slot):
    """Device (0-d) slot / start give the host-int call's draws and the
    reference's, greedy slots the argmax."""
    rng = np.random.default_rng(10 + slot)
    logits = rng.standard_normal((4, 97)).astype(np.float32) * 2
    sp = tsampling.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                  min_p=0.02)
    jsp = jsampling.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                   min_p=0.02)
    tsamp = tsampling.init_slot_state(3, "cpu")
    jsamp = jsampling.init_slot_state(3)
    tsampling.write_slot(tsamp, slot, sp, 77)
    jsamp = jsampling.write_slot(jsamp, slot, jsp, 77)
    t = torch.from_numpy(logits)
    for start in (0, 30):
        host = tsampling.verify_draws(t, slot, start, tsamp)
        dev = tsampling.verify_draws(t, torch.tensor(slot),
                                     torch.tensor(start), tsamp)
        want = jsampling.verify_draws(jnp.asarray(logits), slot, start,
                                      jsamp)
        assert torch.equal(host, dev)
        np.testing.assert_array_equal(dev.numpy(), np.asarray(want))
    greedy = tsampling.verify_draws(t, 1, 5, tsamp)     # slot 1: greedy
    assert torch.equal(greedy, torch.from_numpy(logits.argmax(-1)))


# ---------------------------------------------------------------------------
# the engine against the port's plain engine and the JAX speculative engine
# ---------------------------------------------------------------------------

def _sampling(mod, spec):
    return mod.GREEDY if spec is None else mod.SamplingParams(**spec)


def _run(mod, model, cfg, params, config, prompts, samplings, max_new,
         draft_params=None):
    eng = mod.ServingEngine(model, cfg, params, config=config)
    if draft_params is not None:
        _copy_into(eng._draft_params, draft_params)
    for i, (p, sp) in enumerate(zip(prompts, samplings)):
        eng.submit(mod.Request(uid=i, prompt=p, max_new_tokens=max_new,
                               sampling=_sampling(mod, sp)))
    return eng.run(max_steps=3000), eng


def _copy_into(dst: dict, src: dict) -> None:
    """Overwrite a parameter tree in place (a captured step reads the
    tensors it was captured with)."""
    for key, leaf in dst.items():
        if isinstance(leaf, dict):
            _copy_into(leaf, src[key])
        else:
            leaf.copy_(src[key])


def _port_draft_params(jeng):
    """The JAX engine's draft parameters, converted for the port."""
    tree = jax.tree.map(np.asarray, jeng._draft_params)
    return convert.params_from_numpy(tree, T_DFT, "cpu")


def _spec_triple(target, prompts, samplings, max_new, cfg_kw, spec_kw):
    """(port plain, port speculative, JAX speculative) streams and the two
    speculative engines; the port's draft carries the JAX draft's
    weights."""
    jm, jp, tm, tp = target
    base = tserving.EngineConfig(**cfg_kw)
    plain, _ = _run(tserving, tm, tm.cfg, tp, base, prompts, samplings,
                    max_new)
    jout, jeng = _run(jserving, jm, TGT, jp, jserving.EngineConfig(
        **cfg_kw, speculative=jserving.SpecConfig(draft=DFT, **spec_kw)),
        prompts, samplings, max_new)
    tout, teng = _run(tserving, tm, tm.cfg, tp, base.replace(
        speculative=tserving.SpecConfig(draft=T_DFT, **spec_kw)),
        prompts, samplings, max_new, draft_params=_port_draft_params(jeng))
    for uid in plain:
        np.testing.assert_array_equal(tout[uid], plain[uid],
                                      err_msg=f"plain, request {uid}")
        np.testing.assert_array_equal(tout[uid], np.asarray(jout[uid]),
                                      err_msg=f"jax, request {uid}")
    assert sorted(tout) == sorted(jout) == sorted(plain)
    return teng, jeng


def _same_spec_stats(teng, jeng):
    """The round, acceptance and k statistics equal the reference's."""
    assert teng.spec.stats == jeng.spec.stats
    assert teng.spec.k == jeng.spec.k
    for key in ("spec_rounds", "spec_draft_steps", "spec_verify_calls",
                "decode_steps", "tokens_out", "sampled_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.scheduler.stats == {k: jeng.scheduler.stats[k]
                                    for k in teng.scheduler.stats}


MIXED = [None, dict(temperature=1.3, top_k=20, seed=11),
         dict(temperature=0.9, top_p=0.95, seed=12)]


@pytest.mark.parametrize("chunks", [None, (8, 16)],
                         ids=["monolithic", "chunked"])
def test_spec_streams_mixed_traffic(target, chunks):
    """Greedy and sampled requests in one batch, both prefill modes (the
    reference's test_spec_streams_bit_identical_mixed_traffic): streams
    equal the port's plain engine and the JAX speculative engine; with one
    rung, a greedy and a sampled verify step touched."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 9, 7)]
    teng, jeng = _spec_triple(
        target, prompts, MIXED, 12,
        dict(max_slots=2, max_seq=64, prefill_chunks=chunks),
        dict(k=3, adaptive=False))
    _same_spec_stats(teng, jeng)
    assert teng.stats["spec_rounds"] > 0
    assert jeng.stats["spec_verify_compiles"] == 1
    assert teng.stats["spec_verify_compiles"] == 2      # greedy + sampled
    assert teng._verify_keys == {(3, False), (3, True)}


def test_spec_streams_under_preemption(target):
    """Hot-temperature traffic on an undersized page pool (page 4, 10
    pages; the reference's test under preemption, without donation, which
    the port has no counterpart of): preemption and recompute mid-round
    move no token, and the Gumbel coupling lands most proposals."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 9, 7)]
    hot = dict(temperature=8.0, seed=7)
    teng, jeng = _spec_triple(
        target, prompts, [hot, hot, hot], 20,
        dict(max_slots=2, max_seq=64, page_size=4, num_pages=10),
        dict(k=4, adaptive=False))
    _same_spec_stats(teng, jeng)
    assert teng.scheduler.stats["preempted"] > 0
    assert teng.spec.acceptance_rate > 0.3
    assert teng.spec.stats["rounds"] < 20 * 3


def test_spec_adaptive_backoff(target):
    """Greedy traffic against an uncorrelated draft (acceptance ~0) walks
    k down to 1, and the streams still equal plain decode."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 10)]
    teng, jeng = _spec_triple(target, prompts, [None, None], 16,
                              dict(max_slots=2, max_seq=64),
                              dict(k=4, window=2))
    _same_spec_stats(teng, jeng)
    assert teng.spec.k == 1 and teng.spec.stats["k_changes"] >= 2
    ladder = tserving.SpecConfig(draft=T_DFT, k=4).ladder()
    assert teng.stats["spec_verify_compiles"] <= len(ladder)
    assert {k for k, _ in teng._verify_keys} <= set(ladder)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_spec_streams_narrow_arena(target, fmt):
    """Over a narrow target arena (the draft's stays fp32), chunked,
    greedy and sampled: the speculative streams equal the port's plain
    engine over the same format and the JAX speculative engine."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 11, 8)]
    teng, jeng = _spec_triple(
        target, prompts, MIXED, 10,
        dict(max_slots=2, max_seq=64, prefill_chunks=(4, 8),
             kv_format=fmt),
        dict(k=3, adaptive=False))
    _same_spec_stats(teng, jeng)
    assert teng._draft_cache["k"].dtype == torch.float32
    assert teng._cache["k"].dtype != torch.float32


def test_spec_self_draft_accepts_everything(target):
    """The target as its own draft (same weights): every proposal lands,
    greedy and sampled, so each round commits k tokens a slot."""
    _, _, tm, tp = target
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 9)]
    base = tserving.EngineConfig(max_slots=2, max_seq=64,
                                 prefill_chunks=(4, 8))
    want, _ = _run(tserving, tm, tm.cfg, tp, base, prompts, MIXED[:2], 12)
    got, eng = _run(tserving, tm, tm.cfg, tp, base.replace(
        speculative=tserving.SpecConfig(draft=tm.cfg, k=4, adaptive=False)),
        prompts, MIXED[:2], 12, draft_params=tp)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    assert eng.spec.acceptance_rate == 1.0
    assert eng.stats["spec_rounds"] == 3        # 1 + 4 + 4 + 3 tokens


def test_spec_quarantines_a_non_finite_verify(target):
    """NaN planted in one running slot's target arena rows: its next verify
    is non-finite, so that request departs FAILED with the tokens it had
    and nothing of the round commits; the other slot's stream still equals
    plain decode."""
    _, _, tm, tp = target
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 9)]
    base = tserving.EngineConfig(max_slots=2, max_seq=64)
    want, _ = _run(tserving, tm, tm.cfg, tp, base, prompts, [None, None], 12)
    eng = tserving.ServingEngine(tm, tm.cfg, tp, config=base.replace(
        speculative=tserving.SpecConfig(draft=T_DFT, k=3, adaptive=False)))
    for i, p in enumerate(prompts):
        eng.submit(tserving.Request(uid=i, prompt=p, max_new_tokens=12))
    eng.step()
    victim = eng.scheduler.running[1]
    had = list(victim.generated)
    eng._cache["k"][:, 1] = float("nan")
    out = eng.run(max_steps=3000)
    assert victim.status == Status.FAILED
    assert victim.finish_reason == "nan-logits"
    assert victim.generated == had
    assert eng.stats["quarantined"] == 1 == eng.stats["failed"]
    np.testing.assert_array_equal(out[0], want[0])
    np.testing.assert_array_equal(out[1], want[1][:len(had)])


def test_spec_refusals(target):
    """An ssm target and a vocab mismatch are refused at construction with
    ValueError, as in the reference; a speculative engine builds its draft
    on the target's device and refuses nothing else."""
    _, _, tm, tp = target
    sm = treg.build_model(T_SSM, device="cpu")
    with pytest.raises(ValueError, match="family"):
        tserving.ServingEngine(sm, T_SSM, sm.init(0),
                               config=tserving.EngineConfig(
                                   speculative=tserving.SpecConfig(
                                       draft=T_DFT)))
    with pytest.raises(ValueError, match="vocab"):
        tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.EngineConfig(
            speculative=tserving.SpecConfig(draft=dataclasses.replace(
                T_DFT, name="v96", vocab=96))))
    eng = tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.EngineConfig(
        speculative=tserving.SpecConfig(draft=T_DFT)))
    assert eng.draft_model.device == tm.device
    assert eng.graph is None and eng.draft_graph is None


# ---------------------------------------------------------------------------
# serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "draft=llama3.2-3b:k=3", "draft=llama3.2-3b:k=2:k-max=8:adaptive=0",
    "draft=x:k=4:window=3:draft-seed=5:low=0.1:high=0.9:ema=0.5"])
def test_parse_speculative_matches_reference(text):
    got = dataclasses.asdict(serve.parse_speculative(text))
    want = dataclasses.asdict(jserve.parse_speculative(text))
    assert got == want


@pytest.mark.parametrize("text", ["k=3", "draft=x:k", "draft=x:q=1",
                                  "draft=x:k=0"])
def test_parse_speculative_refusals(text):
    for mod in (serve, jserve):
        with pytest.raises(ValueError):
            mod.parse_speculative(text)


def test_serve_cli_speculative(capsys):
    """``--reduced --speculative draft=llama3.2-3b:k=3 --device cpu``: the
    run completes, prints the speculative line, and its streams equal the
    same command without the flag."""
    argv = ["--arch", "llama3.2-3b", "--device", "cpu", "--requests", "3",
            "--prompt-len", "12", "--gen", "8", "--slots", "2",
            "--temperature", "0.8", "--sampling-mix", "0.5"]
    spec = ["--speculative", "draft=llama3.2-3b:k=3"]
    assert serve.main(argv + spec) == 0
    out = capsys.readouterr().out
    assert "speculative: k=" in out and "3 requests, 24 tokens" in out
    outs = []
    for extra in ([], spec):
        args = serve.parse_args(argv + extra)
        bundle, params = serve.build(args)
        _, o, _ = serve.serve(bundle, params, args)
        outs.append(o)
    assert sorted(outs[0]) == sorted(outs[1])
    for uid in outs[0]:
        np.testing.assert_array_equal(outs[0][uid], outs[1][uid])
