"""Parity of the port's encdec family (whisper-large-v3's backbone: an
encoder over stubbed frame embeddings, a decoder with learned positions,
causal self-attention and cross-attention over the encoder output) with
the JAX package, on a tiny f32 regime (2 + 2 layers, d 32, 4 / 2 heads, hd
8, vocab 97, enc_seq 24 as the reference's reduced config, max_seq 64),
the same numpy-made weights, prompts and frames handed to both packages:
``layernorm`` and ``sinusoidal_positions``, the config and tree,
``encode``, prefill logits with the self and cross leaves, ``decode_step``
with a parked slot, the engines' streams (greedy and sampled) at depth 0
and 2 and under preemption, the four refusals the reference keeps, the NaN
poison over the cross leaves, a 2-replica router and the serve CLI.

The reference's engine cannot decode a sampled encdec request (its
``EncDecLM.decode_step`` lacks the ``share`` keyword that the shared
``decode_and_sample`` passes); the sampled streams are held against the
reference's engine over :class:`SampledEncDecLM`, which adds only that
keyword.

Tolerances (f32): layers at 2e-5 absolute + 2e-5 relative, logits and
arena leaves at 1e-4, token streams identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.encdec import EncDecLM as JEncDecLM  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

from test_torch_faults import DFT, T_DFT, _plan  # noqa: E402
from test_torch_model import port_cfg  # noqa: E402

TINY_ENCDEC = ArchConfig(name="tiny-encdec", family="encdec", n_layers=2,
                         n_enc_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                         d_ff=64, vocab=97, head_dim=8, act="gelu",
                         enc_seq=24, param_dtype="float32",
                         act_dtype="float32", max_seq=64)
V, SE, D = TINY_ENCDEC.vocab, TINY_ENCDEC.enc_seq, TINY_ENCDEC.d_model
TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = 1e-4


def encdec_numpy_params(cfg, seed=0) -> dict:
    """The encdec tree made with numpy from ``seed``: norm scales near 1,
    biases and learned positions N(0, 0.1^2), projections N(0, 1 /
    fan_in), embedding and head N(0, 1 / d)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in convert.expected_shapes(cfg).items():
        if path.endswith("scale"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif path.endswith("bias") or path == "pos_embed":
            a = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = cfg.d_model if path in ("embed", "lm_head") \
                else shape[-2]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        node = tree
        *parents, leaf = path.split(".")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = a.astype(np.float32)
    return tree


class SampledEncDecLM(JEncDecLM):
    """The reference's EncDecLM, its ``decode_step`` taking the ``share``
    keyword (always None here) that the shared ``decode_and_sample``
    passes: without it the reference's engine raises TypeError at its
    first sampled decode step (transformer.py:808), so its sampled encdec
    streams exist only through this adapter.  Nothing else changes."""

    def decode_step(self, params, token_t, cache, pos, share=None):
        assert share is None
        return super().decode_step(params, token_t, cache, pos)


def encdec_bridged(cfg=TINY_ENCDEC, seed=0):
    """(jax model, jax params, port model, port params) on the same
    numpy-made weights."""
    tree = encdec_numpy_params(port_cfg(cfg), seed)
    tcfg = port_cfg(cfg)
    assert type(jreg.build_model(cfg)) is JEncDecLM
    return (SampledEncDecLM(cfg), jax.tree.map(jnp.asarray, tree),
            treg.build_model(tcfg, device="cpu"),
            convert.params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def models():
    return encdec_bridged()


def _frames(rng, n=1):
    return rng.standard_normal((n, SE, D)).astype(np.float32)


def _jcache(tc):
    """The port's flat arena as the reference's {"self", "cross"} pair."""
    j = lambda t: jnp.asarray(t.numpy())                  # noqa: E731
    return {"self": {"k": j(tc["k"]), "v": j(tc["v"])},
            "cross": {"k": j(tc["cross_k"]), "v": j(tc["cross_v"])}}


def _assert_arena(tc, jc, atol=LOGIT_TOL):
    for key, (part, leaf) in {"k": ("self", "k"), "v": ("self", "v"),
                              "cross_k": ("cross", "k"),
                              "cross_v": ("cross", "v")}.items():
        np.testing.assert_allclose(tc[key].numpy(),
                                   np.asarray(jc[part][leaf]), atol=atol,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# layers, config, tree
# ---------------------------------------------------------------------------

def test_layernorm_and_positions_match_jax():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 32))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(32)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)}
    want = JL.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n, d in ((24, 32), (7, 64), (1500, 64)):
        np.testing.assert_allclose(
            TL.sinusoidal_positions(n, d).numpy(),
            np.asarray(JL.sinusoidal_positions(n, d)), atol=5e-5, rtol=0)
    # bf16: one cast at the end, as the reference
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in p.items()}, xb)
    want = JL.layernorm(jax.tree.map(jnp.asarray, p),
                        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_whisper_config_size_and_tree_match_jax():
    """whisper-large-v3: the reference's formula (1.603 B: the decoder's
    positions counted as enc_seq rows, no LayerNorm biases) and its tree
    (1.643 B), both as they are; the reduced config's tree equals the JAX
    init's and the port's own init has it too."""
    jcfg = jreg.config("whisper-large-v3")
    tcfg = treg.config("whisper-large-v3")
    assert (tcfg.n_layers, tcfg.n_enc_layers, tcfg.d_model, tcfg.n_heads,
            tcfg.n_kv_heads, tcfg.hd, tcfg.d_ff, tcfg.vocab,
            tcfg.enc_seq) == (32, 32, 1280, 20, 20, 64, 5120, 51866, 1500)
    assert tcfg.n_params() == jcfg.n_params() == 1_602_909_440
    tree = sum(int(np.prod(s)) for s in
               convert.expected_shapes(tcfg).values())
    assert tree == 1_643_141_120
    # the formula's two shortfalls: the decoder positions (max_seq rows,
    # counted as enc_seq), and the LayerNorms' biases and the encoder's
    # final norm (3 a decoder layer, 2 an encoder layer, 3 more)
    d = tcfg.d_model
    assert tree - tcfg.n_params() == (tcfg.max_seq - tcfg.enc_seq) * d \
        + (3 * tcfg.n_layers + 2 * tcfg.n_enc_layers + 3) * d
    r_j, r_t = jcfg.reduced(), tcfg.reduced()
    assert port_cfg(r_j) == r_t and (r_t.n_enc_layers, r_t.enc_seq) == \
        (2, 24)
    assert r_t.n_params() == r_j.n_params()
    jflat = convert._flatten(jax.eval_shape(
        lambda: jreg.build_model(r_j).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        convert.expected_shapes(r_t)
    model = treg.build_model(r_t, device="cpu")
    assert isinstance(model, EncDecLM)
    own = convert._flatten(model.init(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        convert.expected_shapes(r_t)
    assert {str(v.dtype) for v in own.values()} == {"torch.bfloat16"}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_encode_matches_jax(models):
    jm, jp, tm, tp = models
    frames = _frames(np.random.default_rng(1), 2)
    want = jm.encode(jp, jnp.asarray(frames))
    got = tm.encode(tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_logits_and_leaves_match_jax(models):
    """Prefill into slot 1 of a 2-slot arena through its slot view: the
    logits, the prompt's self rows and all cross rows equal the
    reference's, and slot 0 and the rows past the prompt stay zero."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, V, 13).astype(np.int32)
    frames = _frames(rng)
    jlog, jc = jm.prefill(jp, jnp.asarray(prompt)[None], jm.init_cache(1, 64),
                          frames=jnp.asarray(frames))
    tc = tm.init_cache(2, 64)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        "k": (2, 2, 64, 2, 8), "v": (2, 2, 64, 2, 8),
        "cross_k": (2, 2, SE, 2, 8), "cross_v": (2, 2, SE, 2, 8)}
    tlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None],
                      tm.slot_view(tc, 1), frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL)
    _assert_arena(tm.slot_view(tc, 1), jc)
    assert all(bool(leaf[:, 0].eq(0).all()) for leaf in tc.values())
    assert bool(tc["k"][:, 1, 13:].eq(0).all())


def test_decode_steps_with_a_parked_slot_match_jax(models):
    """Two slots prefilled, then 6 greedy decode steps with slot 1 parked
    at PARKED_POS from the third: its learned position is clamped to the
    table's last row as the reference's gather clamps it, its self rows
    stay untouched (the reference drops the write), and the live slot's
    logits and every leaf equal the reference's."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    lens = (9, 14)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in lens]
    frames = _frames(rng, 2)
    tc = tm.init_cache(2, 40)
    toks = []
    for b, prompt in enumerate(prompts):
        tl = tm.prefill(tp, torch.from_numpy(prompt).long()[None],
                        tm.slot_view(tc, b),
                        frames=torch.from_numpy(frames[b:b + 1]))
        toks.append(int(torch.argmax(tl[0])))
    jc = _jcache(tc)
    pos = np.asarray(lens, np.int32)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.tensor(toks)
    step = jax.jit(jm.decode_step)
    for i in range(6):
        if i == 2:
            pos[1] = TL.PARKED_POS
            parked = tc["k"][:, 1].clone()
        jl, jc = step(jp, jt, jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, tt, tc, torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        assert bool(torch.isfinite(tl).all())
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        assert np.asarray(jt).tolist() == tt.tolist()
        pos[0] += 1
    assert torch.equal(tc["k"][:, 1], parked)
    _assert_arena(tc, jc)


def test_plain_namespace_model_is_the_cpu_path(models):
    """On the CPU the dispatching ops and ``ops.PLAIN`` are one function:
    a model built on either gives identical logits."""
    *_, tm, tp = models
    plain = treg.build_model(tm.cfg, device="cpu", kernels=ops.PLAIN)
    frames = torch.from_numpy(_frames(np.random.default_rng(4)))
    prompt = torch.arange(9)[None] % V
    a = tm.prefill(tp, prompt, tm.init_cache(1, 16), frames=frames)
    b = plain.prefill(tp, prompt, plain.init_cache(1, 16), frames=frames)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _traffic(n_req, lens, sampled=()):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, lens[i % len(lens)]).astype(np.int32)
               for i in range(n_req)]
    frames = _frames(rng, n_req)
    samp = [dict(temperature=0.9, top_k=20, top_p=0.95, seed=40 + i)
            if i in sampled else None for i in range(n_req)]
    return prompts, frames, samp


def _engines(mod, models, cfg, *, replicas=0):
    jm, jp, tm, tp = models
    model, cfg_, params = ((jm, TINY_ENCDEC, jp) if mod is jserving
                           else (tm, tm.cfg, tp))
    if replicas:
        return mod.Router(model, cfg_, params, config=mod.RouterConfig(
            replicas=replicas, placement="least-pressure",
            engine=mod.EngineConfig(**cfg)))
    return mod.ServingEngine(model, cfg_, params,
                             config=mod.EngineConfig(**cfg))


def _submit(mod, eng, traffic, gens):
    prompts, frames, samp = traffic
    for i, (p, g) in enumerate(zip(prompts, gens)):
        sp = mod.GREEDY if samp[i] is None else mod.SamplingParams(**samp[i])
        eng.submit(mod.Request(uid=i, prompt=p, max_new_tokens=g,
                               sampling=sp, extras={"frames": frames[i]}))


def _streams(models, traffic, gens, *, plan=None, **cfg):
    """The JAX engine and the port's on the same requests: streams,
    statuses and scheduler counters equal; returns the port's engine."""
    outs, engs = [], []
    for mod in (jserving, tserving):
        eng = _engines(mod, models, dict(cfg, faults=_plan(mod, plan)))
        _submit(mod, eng, traffic, gens)
        outs.append(eng.run(max_steps=3000))
        engs.append(eng)
    (want, got), (jeng, teng) = outs, engs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
        assert (teng._results[uid].status.value,
                teng._results[uid].finish_reason) == \
            (jeng._results[uid].status.value,
             jeng._results[uid].finish_reason)
    assert teng.scheduler.stats == {k: jeng.scheduler.stats[k]
                                    for k in teng.scheduler.stats}
    for key in ("poisoned", "quarantined", "kv_row_bytes"):
        assert teng.stats[key] == jeng.stats[key], key
    return teng, got


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("sampled", [(), (1, 3)], ids=["greedy", "sampled"])
def test_engine_streams_match_jax(models, depth, sampled):
    """Staggered admission (2 slots, 4 requests), mixed lengths."""
    eng, _ = _streams(models, _traffic(4, (5, 12, 9, 16), sampled),
                      (8, 6, 10, 7), max_slots=2, max_seq=64, depth=depth)
    assert eng.stats["sampled_requests"] == len(sampled)
    # the self rows a row (256 bytes at the reduced width's bf16), the
    # cross rows a slot
    assert eng.kv_row_bytes == 2 * 2 * 2 * 8 * 4
    assert eng.state_bytes_per_slot == 2 * 2 * SE * 2 * 8 * 4


def test_engine_preemption_replays_the_frames(models):
    """--page-size 4 --pages 14: the youngest request is preempted and
    re-prefilled, its encoder run again over its frames."""
    eng, _ = _streams(models, _traffic(5, (20, 15), (1, 3)), (12,) * 5,
                      max_slots=2, max_seq=64, depth=2, page_size=4,
                      num_pages=14)
    assert eng.scheduler.stats["preempted"] > 0


def test_reduced_whisper_kv_row_bytes():
    """The reference's figure: 256 bytes a self row at the reduced width
    (2 layers x K and V x 2 heads x hd 16 x bf16), the cross rows not in
    it."""
    b = treg.build("whisper-large-v3", reduced=True, device="cpu")
    eng = tserving.ServingEngine(b.model, b.cfg, b.model.init(0),
                                 config=tserving.EngineConfig(max_slots=2,
                                                              max_seq=16))
    assert eng.kv_row_bytes == eng.stats["kv_row_bytes"] == 256
    assert eng.state_bytes_per_slot == 2 * 2 * 24 * 2 * 16 * 2
    assert eng.arena_bytes == 2 * (16 * 256 + eng.state_bytes_per_slot)


@pytest.mark.parametrize("what", ["chunked", "sharing", "bf16", "int8",
                                  "speculative"])
def test_refusals_match_jax(models, what):
    """Chunked prefill (hence prefix sharing), every KV format but fp32
    and speculative decoding are refused by both engines with the
    reference's type and message."""
    jm, jp, tm, tp = models
    msgs = []
    for mod, model, cfg, params, draft in (
            (jserving, jm, TINY_ENCDEC, jp, DFT),
            (tserving, tm, tm.cfg, tp, T_DFT)):
        kw = {"chunked": dict(prefill_chunks=(4, 8)),
              "sharing": dict(prefill_chunks=(4, 8), prefix_sharing=True),
              "bf16": dict(kv_format="bf16"),
              "int8": dict(kv_format="int8"),
              "speculative": dict(speculative=mod.SpecConfig(draft=draft)),
              }[what]
        with pytest.raises(ValueError) as err:
            mod.ServingEngine(model, cfg, params,
                              config=mod.EngineConfig(max_seq=32, **kw))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_prefix_sharing_refusal_without_chunks(models):
    """The port's own sharing refusal, past the chunked one: a family
    without the chunk hooks has no prefix sharing."""
    *_, tm, tp = models
    cfg = tserving.EngineConfig(max_seq=32)
    object.__setattr__(cfg, "prefix_sharing", True)
    with pytest.raises(ValueError, match="does not support prefix sharing"):
        tserving.ServingEngine(tm, tm.cfg, tp, config=cfg)
    with pytest.raises(ValueError, match="fp32-only"):
        tm.init_cache(1, 8, kv_format="bf16")


def test_nan_poison_covers_the_cross_leaves_and_is_quarantined(models):
    """The logits site fills one resident's self and cross leaves with
    NaN; the flag quarantines it as the JAX engine does, the survivors
    keep their streams, and a scrub zeroes all four leaves.  A NaN in the
    cross leaves alone makes the slot's logits non-finite."""
    traffic = _traffic(5, (5, 11, 7, 16, 9), (1,))
    cfg = dict(max_slots=3, max_seq=64, depth=2, page_size=8)
    clean = _streams(models, traffic, (8,) * 5, **cfg)[1]
    eng, out = _streams(models, traffic, (8,) * 5,
                        plan=(5, {"logits": (1.0, None, 1)}), **cfg)
    assert eng.stats["poisoned"] == eng.stats["quarantined"] == 1
    for uid, st in eng._results.items():
        if st.status == tserving.Status.FINISHED:
            np.testing.assert_array_equal(out[uid], clean[uid])
        else:
            assert st.finish_reason == "nan-logits"
            np.testing.assert_array_equal(out[uid],
                                          clean[uid][:out[uid].size])
    # the poison and the scrub reach every leaf of the slot
    *_, tm, tp = models
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(**cfg))
    eng._fill_slot(1, float("nan"), floating_only=True)
    assert all(bool(v.isnan().all()) for v in
               tm.slot_view(eng._cache, 1).values())
    eng._fill_slot(1, 0.0, floating_only=False)
    assert all(bool(v.eq(0).all()) for v in eng._cache.values())
    # NaN cross rows alone: the slot's logits go non-finite, the other's
    # do not
    tc = tm.init_cache(2, 16)
    frames = torch.from_numpy(_frames(np.random.default_rng(6), 2))
    for b in range(2):
        tm.prefill(tp, torch.arange(5)[None], tm.slot_view(tc, b),
                   frames=frames[b:b + 1])
    tc["cross_v"][:, 0, 3] = float("nan")
    logits = tm.decode_step(tp, torch.tensor([1, 2]), tc,
                            torch.tensor([5, 5]))
    assert TL.finite_rows(logits).tolist() == [False, True]


def test_router_matches_jax_router(models):
    """Two replicas under least-pressure placement: the merged streams,
    placements and router stats equal the JAX router's."""
    traffic = _traffic(6, (9, 21, 13, 17, 11, 6), (1, 3, 5))
    got = []
    for mod in (jserving, tserving):
        router = _engines(mod, models, dict(max_slots=2, max_seq=64,
                                            depth=1, page_size=8),
                          replicas=2)
        _submit(mod, router, traffic, (8,) * 6)
        got.append((router.run(max_steps=3000), router))
    (jout, jr), (tout, tr) = got
    assert sorted(tout) == sorted(jout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], np.asarray(jout[uid]))
    assert tr.stats == jr.stats
    assert {u: tr.owner_of(u) for u in tout} == \
        {u: jr.owner_of(u) for u in jout}


def test_serve_cli_whisper_on_cpu(capsys):
    """The reduced whisper-large-v3 through the CLI, one engine and two
    replicas: the arena line gives the self bytes a row and the cross
    bytes a slot, and no kernel launches on the CPU."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "whisper-large-v3", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20", "--gen", "6",
                       "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 18 tokens" in out
    assert "256 bytes/row" in out and "6144 state bytes/slot" in out
    assert "'flash_attention': 0" in out and "'flash_decode': 0" in out
    assert serve.main(["--arch", "whisper-large-v3", "--device", "cpu",
                       "--requests", "4", "--prompt-len", "12", "--gen", "4",
                       "--slots", "2", "--replicas", "2"]) == 0
    assert "over 2 replicas" in capsys.readouterr().out
    args = serve.parse_args(["--arch", "whisper-large-v3", "--requests", "3",
                             "--prompt-len", "20"])
    cfg = treg.config("whisper-large-v3").reduced()
    reqs = serve.requests(args, cfg.vocab, cfg=cfg)
    assert [r.extras["frames"].shape for r in reqs] == [(24, 64)] * 3
    assert serve.prefix_extra(cfg) == 0


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_decode_step_makes_no_host_read_and_warms_up_parked(models, sampled):
    """What the captured decode step relies on, on the CPU: the step
    (greedy twin or sampled) makes no host read with live, never-used and
    parked slots side by side (the learned-position clamp and the cross
    rows included), and the parked warm-up leaves every arena leaf and
    the slot vectors bit for bit."""
    from test_torch_graphs import NoHostRead
    from repro_torch.runtime.serving import graphs
    *_, tm, tp = models
    eng = tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.
                                 EngineConfig(max_slots=4, max_seq=64))
    prompts, frames, samp = _traffic(2, (9, 14), (1,) if sampled else ())
    for i in range(2):
        sp = (tserving.GREEDY if samp[i] is None
              else tserving.SamplingParams(**samp[i]))
        eng.submit(tserving.Request(uid=i, prompt=prompts[i],
                                    max_new_tokens=20, sampling=sp,
                                    extras={"frames": frames[i]}))
    for _ in range(3):
        eng.step()
    eng._pos[3] = TL.PARKED_POS
    step = eng._decode_step_sampled if sampled else eng._decode_step
    state = lambda: {k: v.clone() for k, v in               # noqa: E731
                     {**eng._cache, "tokens": eng._tokens, "pos": eng._pos,
                      "active": eng._active}.items()}
    before = state()
    graphs.parked_warm_up(step, eng._tokens, eng._pos, eng._active)
    after = state()
    assert all(torch.equal(before[k], after[k]) for k in before)
    with NoHostRead():
        out = step()
    assert out.shape == (2, 4) and out[1].tolist() == [1] * 4
