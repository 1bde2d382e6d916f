"""Parity of the port's hybrid family (hymba) with the JAX package, module
by module: the window schedule, the config's size and reduced form, the
parameter tree, the three layer functions (prefill, chunk with a carried
state and ``nvalid``, decode rows) and the LM drivers over the mixed arena
(K/V rows beside the SSD state and conv tail), on the reference's tiny
hybrid regime (``repro.configs.base.tiny_family_configs``: 3 layers, d 32,
window 8, one global layer, f32, max_seq 64) with prompts past the window,
the same numpy-made weights and inputs handed to both packages.

Tolerances (f32): layers at 2e-5 absolute + 2e-5 relative (the same f32
sums in another order), LM logits and arena leaves at 1e-4, greedy tokens
identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import tiny_family_configs  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

from test_torch_model import port_cfg  # noqa: E402
from test_torch_ssm import ssm_numpy_params  # noqa: E402

TINY_HYBRID = tiny_family_configs()["hybrid"]
TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = 1e-4
V = TINY_HYBRID.vocab


def hybrid_bridged(cfg=TINY_HYBRID, seed=0):
    """(jax model, jax params, port model, port params) on the same
    numpy-made weights (the mamba leaves drawn as the reference's)."""
    tree = ssm_numpy_params(cfg, seed)
    tcfg = port_cfg(cfg)
    return (jreg.build_model(cfg), jax.tree.map(jnp.asarray, tree),
            treg.build_model(tcfg, device="cpu"),
            convert.params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def tiny():
    return hybrid_bridged()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _nested(flat: dict) -> dict:
    """The port's flat arena (or view) as the reference's {"kv",
    "mamba"} pair, jax arrays."""
    return {"kv": {k: _j(flat[k]) for k in ("k", "v")},
            "mamba": {k: _j(flat[k]) for k in ("ssm", "conv")}}


def _flat(nested: dict) -> dict:
    return {**nested["kv"], **nested["mamba"]}


# ---------------------------------------------------------------------------
# configs, schedule, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "full", "reduced", "two-global"])
def test_window_schedule_matches_jax(which):
    full = jreg.config("hymba-1.5b")
    cfg = {"tiny": TINY_HYBRID, "full": full, "reduced": full.reduced(),
           "two-global": dataclasses.replace(TINY_HYBRID,
                                             n_global_layers=2)}[which]
    want = np.asarray(JH.window_schedule(cfg)).tolist()
    assert TH.window_schedule(port_cfg(cfg)) == want
    assert treg.build_model(port_cfg(cfg), device="cpu").windows == want


def test_hymba_config_size_and_reduced_match_jax():
    jcfg, tcfg = jreg.config("hymba-1.5b"), treg.config("hymba-1.5b")
    assert tcfg.n_params() == jcfg.n_params() == 1_640_820_096
    r_j, r_t = jcfg.reduced(), tcfg.reduced()
    assert port_cfg(r_j) == r_t
    assert r_t.n_params() == r_j.n_params()
    assert (r_t.n_heads, r_t.n_kv_heads, r_t.attn_window,
            r_t.n_global_layers) == (4, 2, 32, 1)


def test_param_tree_matches_jax_init():
    """expected_shapes is the JAX init's tree; at bf16 the mamba branch's
    A_log / dt_bias / D stay float32 in both, and the port's own init
    has the same tree, shapes and dtypes as the converted one."""
    cfg = dataclasses.replace(TINY_HYBRID, param_dtype="bfloat16",
                              act_dtype="bfloat16")
    tcfg = port_cfg(cfg)
    jflat = convert._flatten(jax.eval_shape(
        lambda: jreg.build_model(cfg).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        convert.expected_shapes(tcfg)
    tp = convert.params_from_numpy(ssm_numpy_params(cfg), tcfg, "cpu")
    flat = convert._flatten(tp)
    assert {k: str(v.dtype) for k, v in jflat.items()} == \
        {k: str(v.dtype).replace("torch.", "") for k, v in flat.items()}
    own = convert._flatten(treg.build_model(tcfg, device="cpu").init(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}


def test_arena_layout_seq_axes_and_refusals(tiny):
    """The mixed arena: K/V rows with a sequence axis beside the state and
    conv tail without one, as the reference's ``_seq_axes``; the per-slot
    factors; narrow formats refused by both packages."""
    jm, _, tm, _ = tiny
    nh = TINY_HYBRID.ssm.n_heads(TINY_HYBRID.d_model)
    cache = tm.init_cache(3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (3, 3, 40, 2, 8), "v": (3, 3, 40, 2, 8),
        "ssm": (3, 3 * nh, 8, 8), "conv": (3, 3, 3, 64 + 16)}
    jaxes = _flat(jm._seq_axes())
    assert tm.seq_axes() == {k: jaxes[k] for k in cache}
    assert tm.has_recurrent_state == jm.has_recurrent_state is True
    assert tm.num_slots(cache) == 3
    view = tm.slot_view(cache, 1)
    assert tuple(view["ssm"].shape) == (3, nh, 8, 8)
    for fmt in ("bf16", "int8"):
        with pytest.raises(ValueError, match="full precision"):
            tm.init_cache(1, 8, kv_format=fmt)
        with pytest.raises(ValueError):
            jm.init_cache(1, 8, kv_format=fmt)


# ---------------------------------------------------------------------------
# the layer functions
# ---------------------------------------------------------------------------

def _stored(rng, slots, smax):
    """A random per-layer arena of ``slots`` slots (K/V rows, SSD state,
    conv tail), f32."""
    cfg = TINY_HYBRID
    nh = cfg.ssm.n_heads(cfg.d_model)
    ch = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
    kv = (slots, smax, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.from_numpy(_rand(rng, *kv)),
            "v": torch.from_numpy(_rand(rng, *kv)),
            "ssm": torch.from_numpy(0.5 * _rand(rng, slots * nh, 8, 8)),
            "conv": torch.from_numpy(_rand(rng, slots, 3, ch))}


@pytest.mark.parametrize("layer", [0, 1])
def test_prefill_layer_matches_jax(tiny, layer):
    """Layer 0 (global) and 1 (window 8) over a 21-token prompt: the
    output, the K/V rows [0, 21) and the final state and conv tail."""
    _, jp, tm, tp = tiny
    cfg, tcfg = TINY_HYBRID, tm.cfg
    win = tm.windows[layer]
    rng = np.random.default_rng(20 + layer)
    x = _rand(rng, 1, 21, cfg.d_model)
    pos = np.arange(21)[None]
    view = {k: torch.zeros_like(v) for k, v in _stored(rng, 1, 32).items()}
    jx, jc = JH.hybrid_prefill_layer(
        _layer(jp["layers"], layer), cfg, jnp.asarray(x), _nested(view),
        jnp.asarray(pos), jnp.int32(win))
    tx = TH.hybrid_prefill_layer(_layer(tp["layers"], layer), tcfg,
                                 torch.from_numpy(x), view,
                                 torch.from_numpy(pos), window=win)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    for k, want in _flat(jc).items():
        np.testing.assert_allclose(view[k].numpy(), np.asarray(want), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("start,nvalid", [(0, 8), (12, 8), (12, 5),
                                          (20, 1)])
def test_chunk_layer_matches_jax(tiny, start, nvalid):
    """One 8-row chunk through layer 1 (window 8) into slot 1 of a 2-slot
    layer arena holding stale rows and state: the output, the chunk's K/V
    rows and the carried state (reset at start 0, padding past
    ``nvalid`` kept out) as the reference's emissions; slot 0 untouched."""
    _, jp, tm, tp = tiny
    cfg, tcfg = TINY_HYBRID, tm.cfg
    rng = np.random.default_rng(start + nvalid)
    arena = _stored(rng, 2, 40)
    before = {k: v.clone() for k, v in arena.items()}
    x = _rand(rng, 1, 8, cfg.d_model)
    pos = (start + np.arange(8))[None]
    nh = cfg.ssm.n_heads(cfg.d_model)
    slot_view = {"k": arena["k"][1:], "v": arena["v"][1:],
                 "ssm": arena["ssm"][nh:], "conv": arena["conv"][1:]}
    jx, em = JH.hybrid_layer_chunk(
        _layer(jp["layers"], 1), cfg, jnp.asarray(x), _nested(slot_view),
        jnp.asarray(pos), jnp.int32(start), jnp.int32(nvalid), jnp.int32(8))
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    tx = TH.hybrid_layer_chunk(
        _layer(tp["layers"], 1), tcfg, torch.from_numpy(x), arena, i64(1),
        torch.from_numpy(pos), i64(start), i64(nvalid),
        torch.tensor([start], dtype=torch.int32), window=8)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(
            arena[k][1, start:start + 8].numpy(),
            np.asarray(em["kv"][k]).reshape(8, cfg.n_kv_heads, cfg.hd),
            **TOL, err_msg=k)
    np.testing.assert_allclose(arena["ssm"][nh:].numpy(),
                               np.asarray(em["mamba"]["ssm"]).reshape(
                                   nh, 8, 8), **TOL)
    np.testing.assert_allclose(arena["conv"][1].numpy(),
                               np.asarray(em["mamba"]["conv"])[0], **TOL)
    for k in arena:
        assert torch.equal(arena[k][:1], before[k][:1]), k


def test_decode_rows_matches_jax(tiny):
    """One decode step through layer 2 (window 8) over 3 slots, one parked:
    the output and the live slots' K/V row and state as the reference's
    emissions; the parked slot's every leaf bit for bit."""
    _, jp, tm, tp = tiny
    cfg, tcfg = TINY_HYBRID, tm.cfg
    rng = np.random.default_rng(7)
    arena = _stored(rng, 3, 40)
    before = {k: v.clone() for k, v in arena.items()}
    x = _rand(rng, 3, cfg.d_model)
    pos = np.array([13, TL.PARKED_POS, 30])
    jx, em = JH.hybrid_layer_decode_rows(
        _layer(jp["layers"], 2), cfg, jnp.asarray(x), _nested(arena),
        jnp.asarray(pos, jnp.int32), jnp.int32(8))
    tx = TH.hybrid_layer_decode_rows(_layer(tp["layers"], 2), tcfg,
                                     torch.from_numpy(x), arena,
                                     torch.from_numpy(pos), window=8)
    np.testing.assert_allclose(tx[[0, 2]].numpy(), np.asarray(jx)[[0, 2]],
                               **TOL)
    nh = cfg.ssm.n_heads(cfg.d_model)
    for b in (0, 2):
        for k in ("k", "v"):
            np.testing.assert_allclose(
                arena[k][b, pos[b]].numpy(),
                np.asarray(em["kv"][k]).reshape(3, cfg.n_kv_heads,
                                                cfg.hd)[b], **TOL)
        np.testing.assert_allclose(
            arena["ssm"][b * nh:(b + 1) * nh].numpy(),
            np.asarray(em["mamba"]["ssm"])[b * nh:(b + 1) * nh], **TOL)
        np.testing.assert_allclose(arena["conv"][b].numpy(),
                                   np.asarray(em["mamba"]["conv"])[b], **TOL)
    assert torch.equal(arena["k"][1], before["k"][1])
    assert torch.equal(arena["ssm"][nh:2 * nh], before["ssm"][nh:2 * nh])
    assert torch.equal(arena["conv"][1], before["conv"][1])


# ---------------------------------------------------------------------------
# the LM drivers
# ---------------------------------------------------------------------------

def _assert_arena(tc, jc, atol=LOGIT_TOL):
    for k, want in _flat(jc).items():
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(want),
                                   atol=atol, rtol=0, err_msg=k)


def test_prefill_decode_logits_and_arena(tiny):
    """Monolithic prefill of 21 tokens (past the window) + 12 greedy
    decode steps: logits within 1e-4 at every step, identical tokens,
    the whole arena as the reference's."""
    jm, jp, tm, tp = tiny
    prompt = np.random.default_rng(3).integers(0, V, 21).astype(np.int32)
    jc = jm.init_cache(1, 64)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompt)[None], jc)
    tc = tm.init_cache(1, 64)
    tlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL)
    _assert_arena(tc, jc)
    step = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)
    pos = len(prompt)
    for _ in range(12):
        assert int(jtok[0]) == int(ttok[0])
        jlog, jc = step(jp, jtok, jc, jnp.asarray([pos], jnp.int32))
        tlog = tm.decode_step(tp, ttok, tc, torch.tensor([pos]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)
        pos += 1
    _assert_arena(tc, jc)


def test_prefill_chunk_logits_and_arena(tiny):
    """Chunks of 8 (the last padded) of a 21-token prompt into slot 1 of a
    2-slot arena with stale rows and state: logits and the arena within
    1e-4 of the reference, slot 0 untouched, the last logits and the
    slot's rows and state as monolithic prefill's."""
    jm, jp, tm, tp = tiny
    prompt = np.random.default_rng(4).integers(0, V, 21).astype(np.int32)
    tc = tm.init_cache(2, 64)
    for leaf in tc.values():
        leaf.copy_(torch.from_numpy(
            _rand(np.random.default_rng(5), *leaf.shape)))
    jc = _nested(tc)
    before0 = {k: v.clone() for k, v in tm.slot_view(tc, 0).items()}
    fn = jax.jit(jm.prefill_chunk)
    for start in range(0, 21, 8):
        real = min(8, 21 - start)
        chunk = np.zeros(8, np.int32)
        chunk[:real] = prompt[start:start + real]
        jlog, jc = fn(jp, jnp.asarray(chunk)[None], jc, jnp.int32(1),
                      jnp.int32(start), jnp.int32(real - 1))
        tlog = tm.prefill_chunk(tp, torch.from_numpy(chunk).long()[None], tc,
                                1, start, real - 1)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL)
    _assert_arena(tc, jc)
    for k, v in tm.slot_view(tc, 0).items():
        assert torch.equal(v, before0[k]), k
    mono = tm.init_cache(1, 64)
    mlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], mono)
    np.testing.assert_allclose(tlog.numpy(), mlog.numpy(), atol=LOGIT_TOL)
    own = tm.slot_view(tc, 1)
    for k in ("k", "v"):
        np.testing.assert_allclose(own[k][:, :, :21].numpy(),
                                   mono[k][:, :, :21].numpy(), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(own[k].numpy(), mono[k].numpy(), **TOL)


def test_parked_slot_arena_bit_identical(tiny):
    """Decode steps with slot 1 parked mid-chunked-prefill leave its K/V
    rows, state and conv tail bit for bit; slot 0's move."""
    _, _, tm, tp = tiny
    tc = tm.init_cache(2, 64)
    prompt = torch.arange(12)[None] % V
    tm.prefill_chunk(tp, prompt, tc, 1, 0, 11)
    tm.prefill_chunk(tp, prompt, tc, 0, 0, 11)
    before = {k: v.clone() for k, v in tc.items()}
    for i in range(3):
        tm.decode_step(tp, torch.tensor([5, 6]), tc,
                       torch.tensor([12 + i, TL.PARKED_POS]))
    for k in tc:
        assert torch.equal(tm.slot_view(tc, 1)[k],
                           tm.slot_view(before, 1)[k]), k
        assert not torch.equal(tm.slot_view(tc, 0)[k],
                               tm.slot_view(before, 0)[k]), k


def test_plain_namespace_model_is_the_cpu_path(tiny):
    _, _, tm, tp = tiny
    plain = treg.build_model(tm.cfg, device="cpu", kernels=ops.PLAIN)
    prompt = torch.arange(19)[None] % V
    a = tm.prefill(tp, prompt, tm.init_cache(1, 32))
    b = plain.prefill(tp, prompt, plain.init_cache(1, 32))
    assert torch.equal(a, b)


def test_window_reaches_the_logits(tiny):
    """The schedule is load-bearing: the same weights with every window
    global give other logits past the window, the same within it."""
    _, _, tm, tp = tiny
    wide = treg.build_model(tm.cfg, device="cpu")
    wide.windows = [tm.cfg.max_seq + 1] * tm.cfg.n_layers
    short, long_ = torch.arange(8)[None] % V, torch.arange(21)[None] % V
    for prompt, same in ((short, True), (long_, False)):
        a = tm.prefill(tp, prompt, tm.init_cache(1, 32))
        b = wide.prefill(tp, prompt, wide.init_cache(1, 32))
        assert torch.equal(a, b) is same


def test_fork_chunk_and_decode_with_share_match_jax(tiny):
    """A donor's 16 tokens into slot 2, its state spliced into slot 0,
    the fork's 6-token tail at start 16 with share (2, 16), then a decode
    step over all slots with the share vectors: logits and the fork's
    rows and state as the JAX model's; the donor's slot is only read."""
    jm, jp, tm, tp = tiny
    rng = np.random.default_rng(3)
    head, tail = rng.integers(0, V, 16), rng.integers(0, V, 8)
    tail[6:] = 0
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(head[None], jnp.int32), jc,
                             jnp.int32(2), jnp.int32(0), jnp.int32(15))
    tm.prefill_chunk(tp, torch.from_numpy(head[None]), tc, 2, 0, 15)
    jc = jm.splice_slot_state(jc, jm.extract_slot_state(jc, 2), 0)
    tm.splice_slot_state(tc, tm.extract_slot_state(tc, 2), 0)
    donor = {k: v.clone() for k, v in tm.slot_view(tc, 2).items()}
    jl, jc = jm.prefill_chunk(jp, jnp.asarray(tail[None], jnp.int32), jc,
                              jnp.int32(0), jnp.int32(16), jnp.int32(5),
                              share_src=jnp.int32(2),
                              share_len=jnp.int32(16))
    tl = tm.prefill_chunk(tp, torch.from_numpy(tail[None]), tc, 0, 16, 5,
                          share_src=2, share_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    for key, leaf in tm.slot_view(tc, 2).items():
        assert torch.equal(leaf, donor[key]), key
    tok = np.array([5, 7, 9])
    pos = np.array([22, TL.PARKED_POS, 16])
    src, ln = np.array([2, 1, 2]), np.array([16, 0, 0])
    jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                            jnp.asarray(pos, jnp.int32),
                            share=(jnp.asarray(src, jnp.int32),
                                   jnp.asarray(ln, jnp.int32)))
    tl = tm.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos),
                        share=(torch.from_numpy(src), torch.from_numpy(ln)))
    np.testing.assert_allclose(tl[[0, 2]].numpy(), np.asarray(jl)[[0, 2]],
                               atol=LOGIT_TOL, rtol=0)
    fork, jfork = tm.slot_view(tc, 0), _flat(jc)
    nh = TINY_HYBRID.ssm.n_heads(TINY_HYBRID.d_model)
    np.testing.assert_allclose(fork["k"][:, 0, 16:23].numpy(),
                               np.asarray(jfork["k"])[:, 0, 16:23],
                               atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(fork["ssm"].numpy(),
                               np.asarray(jfork["ssm"])[:, :nh],
                               atol=LOGIT_TOL, rtol=0)


def test_state_snapshot_round_trip_matches_jax(tiny):
    """extract_slot_state gives the reference's state leaves of a slot
    (the SSD state and conv tail, no K/V rows); splice_slot_state writes
    them into another slot's state leaves only."""
    jm, jp, tm, tp = tiny
    toks = np.random.default_rng(4).integers(0, V, (1, 12))
    jc, tc = jm.init_cache(4, 16), tm.init_cache(4, 16)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks, jnp.int32), jc,
                             jnp.int32(1), jnp.int32(0), jnp.int32(11))
    tm.prefill_chunk(tp, torch.from_numpy(toks), tc, 1, 0, 11)
    jsnap = dict(zip(("conv", "ssm"), jm.extract_slot_state(jc, 1)))
    tsnap = tm.extract_slot_state(tc, 1)
    assert len(tsnap) == 2
    for key, t in zip(("ssm", "conv"), tsnap):
        np.testing.assert_allclose(t.numpy(), np.asarray(jsnap[key]),
                                   atol=LOGIT_TOL, rtol=0, err_msg=key)
    before = {k: v.clone() for k, v in tc.items()}
    tm.splice_slot_state(tc, tsnap, 3)
    for k in ("ssm", "conv"):
        assert torch.equal(tm.slot_view(tc, 3)[k], tm.slot_view(tc, 1)[k])
    for k in ("k", "v"):
        assert torch.equal(tc[k], before[k])
    for s in (0, 1, 2):
        for k, v in tm.slot_view(tc, s).items():
            assert torch.equal(v, tm.slot_view(before, s)[k]), (s, k)
