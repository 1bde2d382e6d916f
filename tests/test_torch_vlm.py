"""Parity of the port's vlm family (llava-next-34b's backbone: a dense LM
with a patch-embedding prefix) with the JAX package, on the reference's
tiny f32 vlm regime (tests/test_sampling.py:36: 2 layers, d 32, 4 / 2
heads, hd 8, vocab 97, 4 patch rows, max_seq 64), the same numpy-made
weights, prompts and patch embeddings handed to both packages: the config
and tree, ``VLM.prefill`` logits and arena rows, decode after it, the
engines' streams (greedy and sampled, the first draw's key at patch rows +
prompt length) at depth 0 and 2, under preemption and over an int8 arena,
the two refusals the reference keeps, and the serve CLI.

Tolerances (f32): logits and arena rows at 1e-4, token streams
identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models.vlm import VLM  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

from test_torch_faults import DFT, T_DFT  # noqa: E402
from test_torch_model import bridged, port_cfg  # noqa: E402

TINY_VLM = ArchConfig(name="tiny-vlm", family="vlm", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=97, head_dim=8,
                      n_patch_tokens=4, param_dtype="float32",
                      act_dtype="float32", max_seq=64)
V, P, D = TINY_VLM.vocab, TINY_VLM.n_patch_tokens, TINY_VLM.d_model
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return bridged(TINY_VLM)


def _patches(rng, n=1):
    return rng.standard_normal((n, P, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# config, tree, model
# ---------------------------------------------------------------------------

def test_llava_config_size_and_tree_match_jax():
    """llava-next-34b at its published width: 34.389 B parameters by the
    reference's formula and in its init tree (64.05 GiB at bf16); the
    reduced config's tree equals the JAX init's, and the port's own init
    has the same tree."""
    jcfg, tcfg = jreg.config("llava-next-34b"), treg.config("llava-next-34b")
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.hd, tcfg.d_ff, tcfg.vocab, tcfg.n_patch_tokens) == \
        (60, 7168, 56, 8, 128, 20480, 64000, 576)
    assert tcfg.n_params() == jcfg.n_params() == 34_388_917_248
    full = sum(int(np.prod(s)) for s in
               convert.expected_shapes(tcfg).values())
    assert full == tcfg.n_params()
    assert round(2 * full / 2 ** 30, 2) == 64.05
    r_j, r_t = jcfg.reduced(), tcfg.reduced()
    assert port_cfg(r_j) == r_t and r_t.n_patch_tokens == 12
    jflat = convert._flatten(jax.eval_shape(
        lambda: jreg.build_model(r_j).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        convert.expected_shapes(r_t)
    model = treg.build_model(r_t, device="cpu")
    assert isinstance(model, VLM)
    own = convert._flatten(model.init(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        convert.expected_shapes(r_t)


@pytest.mark.parametrize("with_patches", [True, False])
def test_prefill_logits_and_arena_match_jax(models, with_patches):
    """``VLM.prefill`` with the patch prefix (rows [0, P + S) of the arena)
    and without it (the dense LM's prefill), against the reference's."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, V, 11).astype(np.int32)
    patches = _patches(rng)
    kw = dict(patch_embeds=patches) if with_patches else {}
    jlog, jc = jm.prefill(jp, jnp.asarray(prompt)[None], jm.init_cache(1, 64),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    tc = tm.init_cache(1, 64)
    tlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], tc,
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL)
    rows = 11 + (P if with_patches else 0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=LOGIT_TOL)
        assert bool(tc[key][:, :, rows - 1].ne(0).any())
        assert bool(tc[key][:, :, rows:].eq(0).all())


def test_decode_after_prefill_matches_jax(models):
    """Two slots prefilled with their patch prefixes, then 6 greedy decode
    steps at absolute rows P + S: logits within 1e-4, tokens equal."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2)
    lens = (9, 14)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in lens]
    patches = _patches(rng, 2)
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    jtoks, ttoks = [], []
    for b, prompt in enumerate(prompts):
        jl, jone = jm.prefill(jp, jnp.asarray(prompt)[None],
                              jm.init_cache(1, 64),
                              patch_embeds=jnp.asarray(patches[b:b + 1]))
        jc = jax.tree.map(lambda a, o: a.at[:, b:b + 1].set(o), jc, jone)
        tl = tm.prefill(tp, torch.from_numpy(prompt).long()[None],
                        tm.slot_view(tc, b),
                        patch_embeds=torch.from_numpy(patches[b:b + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        jtoks.append(int(jnp.argmax(jl[0])))
        ttoks.append(int(torch.argmax(tl[0])))
    assert jtoks == ttoks
    pos = np.asarray([P + n for n in lens], np.int32)
    jt, tt = jnp.asarray(jtoks, jnp.int32), torch.tensor(ttoks)
    step = jax.jit(jm.decode_step)
    for _ in range(6):
        jl, jc = step(jp, jt, jc, jnp.asarray(pos))
        tl = tm.decode_step(tp, tt, tc, torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
        assert np.asarray(jt).tolist() == tt.tolist()
        pos = pos + 1
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _traffic(n_req, lens, sampled=()):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, lens[i % len(lens)]).astype(np.int32)
               for i in range(n_req)]
    patches = _patches(rng, n_req)
    samp = [dict(temperature=0.9, top_k=20, top_p=0.95, seed=40 + i)
            if i in sampled else None for i in range(n_req)]
    return prompts, patches, samp


def _streams(models, traffic, gens, **cfg):
    """The JAX engine and the port's on the same requests (each with its
    patch embeddings): streams, statuses and scheduler counters equal;
    returns the port's engine and streams."""
    jm, jp, tm, tp = models
    prompts, patches, samp = traffic
    outs, engs = [], []
    for mod, model, cfg_, params in ((jserving, jm, TINY_VLM, jp),
                                     (tserving, tm, tm.cfg, tp)):
        eng = mod.ServingEngine(model, cfg_, params,
                                config=mod.EngineConfig(**cfg))
        for i, (p, g) in enumerate(zip(prompts, gens)):
            sp = mod.GREEDY if samp[i] is None \
                else mod.SamplingParams(**samp[i])
            eng.submit(mod.Request(uid=i, prompt=p, max_new_tokens=g,
                                   sampling=sp,
                                   extras={"patch_embeds": patches[i]}))
        outs.append(eng.run(max_steps=3000))
        engs.append(eng)
    (want, got), (jeng, teng) = outs, engs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
        assert teng._results[uid].status.value == \
            jeng._results[uid].status.value
    assert teng.scheduler.stats == {k: jeng.scheduler.stats[k]
                                    for k in teng.scheduler.stats}
    assert teng.prefix_extra == jeng.prefix_extra == P
    assert teng.stats["kv_row_bytes"] == jeng.stats["kv_row_bytes"]
    return teng, got


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("sampled", [(), (1, 3)], ids=["greedy", "sampled"])
def test_engine_streams_match_jax(models, depth, sampled):
    """Staggered admission (2 slots, 4 requests), mixed lengths; the
    sampled requests' first draws fold (seed, P + prompt length)."""
    eng, _ = _streams(models, _traffic(4, (5, 12, 9, 16), sampled),
                      (8, 6, 10, 7), max_slots=2, max_seq=64, depth=depth)
    assert eng.stats["sampled_requests"] == len(sampled)


def test_engine_preemption_replays_the_patches(models):
    """--page-size 4 --pages 14: the youngest request is preempted and
    re-prefilled with its patch embeddings, as in the reference."""
    eng, _ = _streams(models, _traffic(5, (16, 11), (1, 3)), (12,) * 5,
                      max_slots=2, max_seq=64, depth=2, page_size=4,
                      num_pages=14)
    assert eng.scheduler.stats["preempted"] > 0


def test_engine_int8_arena_matches_jax(models):
    """The patch rows and the text rows both quantized into an int8
    arena with their scales; streams equal the reference's."""
    eng, _ = _streams(models, _traffic(4, (5, 12, 9, 16), (2,)),
                      (8, 6, 10, 7), max_slots=2, max_seq=64, depth=2,
                      kv_format="int8")
    assert eng.kv_format == "int8"
    assert eng.cache_mgr.scale_sidecar_pages == 0


def test_first_draw_key_counts_the_patch_rows(models):
    """A sampled request's first draw is the decode key at P + prompt
    length: the port's first token equals ``sample_first`` there, and
    differs from the draw at the prompt length alone for some seed."""
    from repro_torch.runtime.serving import sampling
    jm, jp, tm, tp = models
    prompts, patches, _ = _traffic(1, (9,))
    logits = tm.prefill(tp, torch.from_numpy(prompts[0]).long()[None],
                        tm.init_cache(1, 64),
                        patch_embeds=torch.from_numpy(patches[:1]))
    moved = 0
    for seed in range(8):
        sp = tserving.SamplingParams(temperature=1.5, seed=seed)
        eng = tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.
                                     EngineConfig(max_slots=1, max_seq=32))
        eng.submit(tserving.Request(uid=0, prompt=prompts[0],
                                    max_new_tokens=1, sampling=sp,
                                    extras={"patch_embeds": patches[0]}))
        first = int(eng.run()[0][0])
        at = [int(sampling.sample_first(logits, seed, q, sp)[0])
              for q in (P + 9, 9)]
        assert first == at[0], seed
        moved += at[0] != at[1]
    assert moved > 0


@pytest.mark.parametrize("what", ["chunked", "speculative"])
def test_refusals_match_jax(models, what):
    """Chunked prefill and speculative decoding with patch rows are
    refused by both engines with the reference's type and message."""
    jm, jp, tm, tp = models
    msgs = []
    for mod, model, cfg, params, draft in (
            (jserving, jm, TINY_VLM, jp, DFT),
            (tserving, tm, tm.cfg, tp, T_DFT)):
        kw = (dict(speculative=mod.SpecConfig(draft=draft))
              if what == "speculative" else dict(prefill_chunks=(4, 8)))
        with pytest.raises(ValueError) as err:
            mod.ServingEngine(model, cfg, params,
                              config=mod.EngineConfig(max_seq=32, **kw))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "prefix_extra (VLM patch tokens) is unsupported" in msgs[1]


def test_submit_counts_the_patch_rows(models):
    """A prompt that fits max_seq alone but not with its patch rows is
    refused at submit, as the reference refuses it."""
    *_, tm, tp = models
    eng = tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.
                                 EngineConfig(max_slots=1, max_seq=16))
    with pytest.raises(ValueError, match="needs 17 rows"):
        eng.submit(tserving.Request(
            uid=0, prompt=np.arange(12), max_new_tokens=1,
            extras={"patch_embeds": np.zeros((P, D), np.float32)}))


def test_serve_cli_llava_on_cpu(capsys):
    """The reduced llava-next-34b (12 patch rows) through the CLI: its
    arena counts the patch rows, and no kernel launches on the CPU."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "llava-next-34b", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20", "--gen", "6",
                       "--slots", "2", "--temperature", "0.8",
                       "--sampling-mix", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 18 tokens" in out
    assert "'flash_attention': 0" in out and "'flash_decode': 0" in out
    args = serve.parse_args(["--arch", "llava-next-34b", "--requests", "3",
                             "--prompt-len", "20", "--gen", "6"])
    cfg = treg.config("llava-next-34b").reduced()
    reqs = serve.requests(args, cfg.vocab, cfg=cfg)
    assert [r.extras["patch_embeds"].shape for r in reqs] == [(12, 64)] * 3
    # the same draws as the reference: prompts first, then the patches
    rng = np.random.default_rng(0)
    for n in serve.prompt_lengths(args):
        rng.integers(0, cfg.vocab, n)
    np.testing.assert_array_equal(
        reqs[2].extras["patch_embeds"],
        rng.standard_normal((3, 12, 64)).astype(np.float32)[2])
    config = serve.engine_config(args, [20, 15, 20],
                                 serve.prefix_extra(cfg))
    assert config.max_seq == 20 + 12 + 6 + 1


def test_vlm_is_a_dense_lm_otherwise():
    """Everything but the prefill's prefix is inherited: the family has
    the dense layer set, and a narrow format's arena."""
    cfg = port_cfg(dataclasses.replace(TINY_VLM, name="tiny-vlm-2"))
    model = treg.build_model(cfg, device="cpu")
    assert model.layers is treg._LAYER_SETS["dense"]
    cache = model.init_cache(2, 16, kv_format="int8")
    assert set(cache) == {"k", "v", "k_scale", "v_scale"}
