"""Parity of the port's moe family with the JAX package, module by module:
the two published configs' sizes and reduced forms, the parameter tree
(the router f32 under a bf16 config), ``moe_mlp_apply`` (routing, capacity
predication, the experts, the combine, the shared experts, the aux loss)
with capacity free and binding, shared experts on and off and a router
whose equal columns force exact ties, the combine's f32 sum order, the
three layer functions (prefill, chunk at start 0 and > 0 with a padded
chunk, decode rows with a parked slot) and the LM drivers over the dense
arena, on the reference's tiny moe regime (``repro.configs.base.
tiny_family_configs()["moe"]``: 2 layers, d 32, 4 experts top 2,
capacity_factor 2.0 = E / k, so nothing is dropped, f32, max_seq 64), the
same numpy-made weights and inputs handed to both packages.

Tolerances (f32): the MoE MLP and the layers at 2e-5 absolute + 2e-5
relative (the same f32 sums in another order), the aux loss at 1e-6
relative, LM logits and arena rows at 1e-4; expert choices, capacity
drops and greedy tokens identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import tiny_family_configs  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

from test_torch_model import numpy_params, port_cfg  # noqa: E402

TINY_MOE = tiny_family_configs()["moe"]
TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = 1e-4
V = TINY_MOE.vocab


def moe_cfg(cfg=TINY_MOE, **moe_kw):
    """``cfg`` with its MoEConfig fields replaced."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            **moe_kw))


def moe_bridged(cfg=TINY_MOE, seed=0, tree=None):
    """(jax model, jax params, port model, port params) on the same
    numpy-made weights (``tree`` if given)."""
    tree = numpy_params(cfg, seed) if tree is None else tree
    tcfg = port_cfg(cfg)
    return (jreg.build_model(cfg), jax.tree.map(jnp.asarray, tree),
            treg.build_model(tcfg, device="cpu"),
            convert.params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def tiny():
    return moe_bridged()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


# the reference's functions compiled whole, the config static (one XLA
# compile a shape in place of one a primitive)
J_MLP = jax.jit(JM.moe_mlp_apply, static_argnums=1)
J_PREFILL = jax.jit(JM.moe_prefill_layer, static_argnums=1)
J_CHUNK = jax.jit(JM.moe_layer_chunk, static_argnums=1)
J_DECODE = jax.jit(JM.moe_layer_decode_rows, static_argnums=1)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,total,active", [
    ("qwen2-moe-a2.7b", 14_315_636_736, 2_689_026_048),
    ("qwen3-moe-30b-a3b", 30_532_122_624, 3_353_032_704)])
def test_moe_config_sizes_and_reduced_match_jax(name, total, active):
    """n_params, n_active_params and the reduced form (4 experts top 2,
    d_ff_expert 32, shared 64 / at most 2) equal the reference's."""
    jcfg, tcfg = jreg.config(name), treg.config(name)
    assert tcfg.n_params() == jcfg.n_params() == total
    assert tcfg.n_active_params() == jcfg.n_active_params() == active
    r_j, r_t = jcfg.reduced(), tcfg.reduced()
    assert port_cfg(r_j) == r_t
    assert r_t.n_params() == r_j.n_params()
    assert r_t.n_active_params() == r_j.n_active_params()
    me = r_t.moe
    assert (me.n_experts, me.top_k, me.d_ff_expert) == (4, 2, 32)
    assert (me.n_shared_experts, me.d_ff_shared) == (
        (2, 64) if jcfg.moe.n_shared_experts else (0, 0))
    assert treg.config("llama3.2-3b").n_active_params() == \
        jreg.config("llama3.2-3b").n_active_params()


@pytest.mark.parametrize("shared", [0, 2], ids=["routed", "shared"])
def test_param_tree_matches_jax_init(shared):
    """expected_shapes is the JAX init's tree (with and without shared
    experts); at bf16 the router stays float32 in both, and the port's
    own init has the same tree, shapes and dtypes as the converted one."""
    cfg = dataclasses.replace(
        moe_cfg(n_shared_experts=shared, d_ff_shared=48 * bool(shared)),
        param_dtype="bfloat16", act_dtype="bfloat16")
    tcfg = port_cfg(cfg)
    jflat = convert._flatten(jax.eval_shape(
        lambda: jreg.build_model(cfg).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        convert.expected_shapes(tcfg)
    assert ("layers.moe.shared_gate" in jflat) == bool(shared)
    tp = convert.params_from_numpy(numpy_params(cfg), tcfg, "cpu")
    flat = convert._flatten(tp)
    assert {k: str(v.dtype) for k, v in jflat.items()} == \
        {k: str(v.dtype).replace("torch.", "") for k, v in flat.items()}
    assert flat["layers.moe.router"].dtype == torch.float32
    own = convert._flatten(treg.build_model(tcfg, device="cpu").init(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}


def test_moe_arena_is_the_dense_arena_in_every_format(tiny):
    """The moe family keeps the dense arena: K/V rows with a sequence
    axis (and scales for a scaled format), no recurrent state, every KV
    format accepted, as the reference's default cache."""
    jm, _, tm, _ = tiny
    for fmt in ("fp32", "bf16", "int8", "fp8"):
        cache = tm.init_cache(3, 40, kv_format=fmt)
        jc = jm.init_cache(3, 40, kv_format=fmt)
        assert sorted(cache) == sorted(jc)
        for k, leaf in cache.items():
            assert tuple(leaf.shape) == tuple(jc[k].shape), (fmt, k)
    assert tm.has_recurrent_state is False
    assert tm.seq_axes() == {"k": 1, "v": 1}


# ---------------------------------------------------------------------------
# the MoE MLP
# ---------------------------------------------------------------------------

def _mlp_params(cfg, rng, regime):
    """One layer's MoE parameters (numpy): ``regime`` "free" as drawn,
    "binding" with the router skewed towards expert 0 so that it
    overflows, "ties" with router columns 1-3 equal (every token's
    probabilities tie at the top-k boundary)."""
    tree = numpy_params(cfg, 3)
    p = _layer(tree["layers"]["moe"], 0)
    r = p["router"]
    if regime == "binding":
        r[:, 0] += 0.6 * np.abs(rng.standard_normal(r.shape[0])).astype(
            np.float32)
    elif regime == "ties":
        r[:, 2] = r[:, 1]
        r[:, 3] = r[:, 1]
    return p


def _reference_keep(idx, e, cap):
    """The reference's predication (moe.py:140-146) in numpy, on its own
    expert choices: the exclusive count of earlier token-major pairs."""
    flat = idx.reshape(-1)
    seen = np.zeros(e, np.int64)
    keep = np.zeros(flat.size, bool)
    for i, ex in enumerate(flat):
        keep[i] = seen[ex] < cap
        seen[ex] += 1
    return keep


@pytest.mark.parametrize("shared", [0, 2], ids=["routed", "shared"])
@pytest.mark.parametrize("regime", ["free", "binding", "ties"])
def test_moe_mlp_apply_matches_jax(regime, shared):
    """``moe_mlp_apply``'s y and aux against the reference's on 2 x 11
    tokens: capacity free (capacity_factor 2.0 = E / k), binding
    (capacity_factor 1.0 and a router skewed to expert 0: the port's
    ``keep`` must show drops, the same as the reference's), and a router
    with equal columns (exact ties, resolved to the lower expert as
    ``jax.lax.top_k``); shared experts on and off.  The expert choices
    equal the reference's exactly."""
    cf = 1.0 if regime == "binding" else 2.0
    cfg = moe_cfg(capacity_factor=cf, n_shared_experts=shared,
                  d_ff_shared=48 * bool(shared))
    tcfg = port_cfg(cfg)
    rng = np.random.default_rng(5)
    p = _mlp_params(cfg, rng, regime)
    x = _rand(rng, 2, 11, cfg.d_model)
    yj, aj = J_MLP(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x))
    tp = jax.tree.map(torch.from_numpy, p)
    yt, at = TM.moe_mlp_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    # the expert choices and the drops, against the reference's own
    xf = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.dot(jnp.asarray(xf), p["router"]), -1)
    _, jidx = jax.lax.top_k(probs, cfg.moe.top_k)
    gates, idx, _ = TM.route(tp, tcfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    cap = TM.capacity(tcfg, xf.shape[0])
    _, keep = TM.dispatch(idx, cfg.moe.n_experts, cap)
    np.testing.assert_array_equal(
        keep.numpy(), _reference_keep(np.asarray(jidx), cfg.moe.n_experts,
                                      cap))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (regime == "binding"), dropped
    if regime == "ties":
        # experts 1-3 tie exactly for every token, so each token's top-2
        # boundary falls inside the tie and the index order decides it
        pj = np.asarray(probs)
        assert (pj[:, 1] == pj[:, 2]).all() and (pj[:, 2] == pj[:, 3]).all()


def test_topk_tie_order_is_the_lower_expert():
    """Four equal probabilities: the choices are experts 0 and 1 in that
    order, as ``jax.lax.top_k`` gives them."""
    cfg = port_cfg(TINY_MOE)
    p = {"router": torch.zeros((cfg.d_model, 4))}
    xf = torch.ones((3, cfg.d_model))
    gates, idx, _ = TM.route(p, cfg, xf)
    assert idx.tolist() == [[0, 1]] * 3
    _, jidx = jax.lax.top_k(jnp.full((3, 4), 0.25), 2)
    assert np.asarray(jidx).tolist() == idx.tolist()
    assert gates.tolist() == [[0.5, 0.5]] * 3


def test_capacity_matches_reference_formula():
    """cap = max(int(k t capacity_factor / E), 1), t every row of the
    dispatch: qwen2-moe-a2.7b's decode step (4 slots), a 512-row chunk,
    a 1024-row prefill, and the non-binding variant."""
    cfg = treg.config("qwen2-moe-a2.7b")
    assert [TM.capacity(cfg, t) for t in (4, 512, 1024)] == [1, 42, 85]
    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    assert [TM.capacity(free, t) for t in (4, 512, 1024)] == [4, 512, 1024]
    q3 = treg.config("qwen3-moe-30b-a3b")
    assert [TM.capacity(q3, t) for t in (4, 512)] == [1, 40]


# one token's four contributions: summed left to right from 0 they give
# 0.0; reversed 2^-23, pairwise 2^-24
ORDERED = np.array([1.0, 2.0 ** -24, 2.0 ** -24, -1.0], np.float32)


def test_combine_is_a_sequential_sum_in_choice_order():
    """Three tokens, k = 4, every pair kept: each token's output is the
    f32 sum of its 4 weighted expert rows from 0 in choice order, bit for
    bit, as the reference's scatter-add applies them; the row values are
    chosen so that the reversed or the pairwise order gives other bits."""
    t, k, d, e = 3, 4, 2, 4
    cfg = port_cfg(moe_cfg(n_experts=e, top_k=k, capacity_factor=4.0))
    # expert j's output row is ORDERED[j] in every column (up to the
    # token's permutation of experts), gates all 1
    ye = torch.from_numpy(np.repeat(ORDERED[:, None], d, 1))
    idx = torch.tensor([[0, 1, 2, 3], [3, 2, 1, 0], [1, 0, 3, 2]])
    cap = TM.capacity(cfg, t)
    slot, keep = TM.dispatch(idx, e, cap)
    assert bool(keep.all())
    rows = ye.repeat_interleave(cap, 0)
    got = TM.combine(rows, torch.ones((t, k)), slot, keep, torch.float32)
    flat = ORDERED[idx.numpy()]
    want = np.zeros((t,), np.float32)
    for j in range(k):
        want = (want + flat[:, j]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy()[:, 0], want)
    assert got.numpy()[0, 0] == 0.0
    rev = ((flat[0, 3] + flat[0, 2]) + flat[0, 1]) + flat[0, 0]
    pair = (flat[0, 0] + flat[0, 1]) + (flat[0, 2] + flat[0, 3])
    assert rev != want[0] and pair != want[0]
    # the reference's scatter-add on the same contributions
    token_of = jnp.arange(t).repeat(k)
    contrib = jnp.asarray(np.repeat(flat.reshape(-1)[:, None], d, 1))
    jy = jnp.zeros((t, d), jnp.float32).at[token_of].add(contrib)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
# the layer functions
# ---------------------------------------------------------------------------

BINDING = moe_cfg(capacity_factor=1.0)


@pytest.fixture(scope="module")
def binding():
    """The tiny moe weights under capacity_factor 1.0 (binding)."""
    return moe_bridged(BINDING)


def _models(tiny, binding, cf):
    return tiny if cf == 2.0 else binding


def _kv(rng, slots, smax):
    cfg = TINY_MOE
    shape = (slots, smax, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.from_numpy(_rand(rng, *shape)),
            "v": torch.from_numpy(_rand(rng, *shape))}


@pytest.mark.parametrize("cf", [2.0, 1.0], ids=["free", "binding"])
def test_prefill_layer_matches_jax(tiny, binding, cf):
    """Layer 1 over a 13-token prompt: the output and K/V rows [0, 13)."""
    jm, jp, tm, tp = _models(tiny, binding, cf)
    cfg, tcfg = jm.cfg, tm.cfg
    rng = np.random.default_rng(11)
    x = _rand(rng, 1, 13, cfg.d_model)
    pos = np.arange(13)[None]
    view = {k: torch.zeros_like(v) for k, v in _kv(rng, 1, 24).items()}
    jx, jc = J_PREFILL(
        _layer(jp["layers"], 1), cfg, jnp.asarray(x),
        {k: _j(v) for k, v in view.items()}, jnp.asarray(pos))
    tx = TM.moe_prefill_layer(_layer(tp["layers"], 1), tcfg,
                              torch.from_numpy(x), view,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(view[k].numpy(), np.asarray(jc[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("cf", [2.0, 1.0], ids=["free", "binding"])
@pytest.mark.parametrize("start,nvalid", [(0, 8), (12, 8), (12, 5)])
def test_chunk_layer_matches_jax(tiny, binding, cf, start, nvalid):
    """One 8-row chunk through layer 0 into slot 1 of a 2-slot layer
    arena holding stale rows: the output and the chunk's K/V rows as the
    reference's emissions (a padded chunk's pad rows, token embeddings
    here, enter the dispatch as in the reference); slot 0 untouched."""
    jm, jp, tm, tp = _models(tiny, binding, cf)
    cfg, tcfg = jm.cfg, tm.cfg
    rng = np.random.default_rng(start + nvalid)
    arena = _kv(rng, 2, 40)
    before = {k: v.clone() for k, v in arena.items()}
    x = _rand(rng, 1, 8, cfg.d_model)
    pos = (start + np.arange(8))[None]
    jx, em = J_CHUNK(
        _layer(jp["layers"], 0), cfg, jnp.asarray(x),
        {k: _j(v[1:]) for k, v in arena.items()}, jnp.asarray(pos),
        jnp.int32(start), jnp.int32(nvalid))
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    tx = TM.moe_layer_chunk(
        _layer(tp["layers"], 0), tcfg, torch.from_numpy(x), arena, i64(1),
        torch.from_numpy(pos), i64(start), i64(nvalid),
        torch.tensor([start], dtype=torch.int32))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(
            arena[k][1, start:start + 8].numpy(),
            np.asarray(em[k]).reshape(8, cfg.n_kv_heads, cfg.hd), **TOL,
            err_msg=k)
        assert torch.equal(arena[k][:1], before[k][:1]), k


@pytest.mark.parametrize("cf", [2.0, 1.0], ids=["free", "binding"])
def test_decode_rows_matches_jax(tiny, binding, cf):
    """One decode step through layer 1 over 4 slots, slot 1 parked: the
    live slots' outputs and K/V rows as the reference's (under binding
    capacity the parked slot's row competes for capacity in both), the
    parked slot's rows bit for bit."""
    jm, jp, tm, tp = _models(tiny, binding, cf)
    cfg, tcfg = jm.cfg, tm.cfg
    rng = np.random.default_rng(7)
    arena = _kv(rng, 4, 40)
    before = {k: v.clone() for k, v in arena.items()}
    x = _rand(rng, 4, cfg.d_model)
    pos = np.array([13, TL.PARKED_POS, 30, 2])
    jx, em = J_DECODE(
        _layer(jp["layers"], 1), cfg, jnp.asarray(x),
        {k: _j(v) for k, v in arena.items()}, jnp.asarray(pos, jnp.int32))
    tx = TM.moe_layer_decode_rows(_layer(tp["layers"], 1), tcfg,
                                  torch.from_numpy(x), arena,
                                  torch.from_numpy(pos))
    live = [0, 2, 3]
    np.testing.assert_allclose(tx[live].numpy(), np.asarray(jx)[live],
                               **TOL)
    for b in live:
        for k in ("k", "v"):
            np.testing.assert_allclose(
                arena[k][b, pos[b]].numpy(),
                np.asarray(em[k]).reshape(4, cfg.n_kv_heads, cfg.hd)[b],
                **TOL)
    for k in ("k", "v"):
        assert torch.equal(arena[k][1], before[k][1])


# ---------------------------------------------------------------------------
# the LM drivers
# ---------------------------------------------------------------------------

def _assert_arena(tc, jc, atol=LOGIT_TOL):
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("cf", [2.0, 1.0], ids=["free", "binding"])
def test_prefill_decode_logits_and_arena(tiny, binding, cf):
    """Monolithic prefill of 17 tokens + 10 greedy decode steps over 2
    slots (slot 1 parked): logits within 1e-4 at every step, identical
    tokens, the arena as the reference's."""
    jm, jp, tm, tp = _models(tiny, binding, cf)
    prompt = np.random.default_rng(3).integers(0, V, 17).astype(np.int32)
    jc = jm.init_cache(2, 48)
    tc = tm.init_cache(2, 48)
    jlog, jv = jax.jit(jm.prefill)(jp, jnp.asarray(prompt)[None],
                                   {k: v[:, :1] for k, v in jc.items()})
    jc = {k: jc[k].at[:, :1].set(jv[k]) for k in jc}
    tlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None],
                      tm.slot_view(tc, 0))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL)
    _assert_arena(tc, jc)
    step = jax.jit(jm.decode_step)
    jtok = jnp.concatenate([jnp.argmax(jlog, -1).astype(jnp.int32),
                            jnp.asarray([5], jnp.int32)])
    ttok = torch.cat([torch.argmax(tlog, -1), torch.tensor([5])])
    pos = len(prompt)
    for _ in range(10):
        assert int(jtok[0]) == int(ttok[0])
        p = np.array([pos, TL.PARKED_POS])
        jlog, jc = step(jp, jtok, jc, jnp.asarray(p, jnp.int32))
        tlog = tm.decode_step(tp, ttok, tc, torch.from_numpy(p))
        np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0],
                                   atol=LOGIT_TOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)
        pos += 1
    _assert_arena(tc, jc)


@pytest.mark.parametrize("cf", [2.0, 1.0], ids=["free", "binding"])
def test_prefill_chunk_logits_and_arena(tiny, binding, cf):
    """Chunks of 8 (the last padded with token 0) of a 21-token prompt
    into slot 1 of a 2-slot arena with stale rows: logits and the arena
    within 1e-4 of the reference, slot 0 untouched; with capacity free
    the last logits and the slot's rows equal monolithic prefill's."""
    jm, jp, tm, tp = _models(tiny, binding, cf)
    prompt = np.random.default_rng(4).integers(0, V, 21).astype(np.int32)
    tc = tm.init_cache(2, 64)
    for leaf in tc.values():
        leaf.copy_(torch.from_numpy(
            _rand(np.random.default_rng(5), *leaf.shape)))
    jc = {k: _j(v) for k, v in tc.items()}
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
    if cf == 2.0:
        mono = tm.init_cache(1, 64)
        mlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], mono)
        np.testing.assert_allclose(tlog.numpy(), mlog.numpy(),
                                   atol=LOGIT_TOL)
        own = tm.slot_view(tc, 1)
        for k in ("k", "v"):
            np.testing.assert_allclose(own[k][:, :, :21].numpy(),
                                       mono[k][:, :, :21].numpy(), **TOL)


def test_binding_capacity_couples_a_dispatch(binding):
    """Under capacity_factor 1.0 a token's output depends on its
    batch-mates (the reference's caveat): the last token of a 21-token
    prompt differs between one dispatch and chunks of 8, in the port as in
    the reference."""
    jm, jp, tm, tp = binding
    prompt = np.random.default_rng(4).integers(0, V, 21)
    mono = tm.prefill(tp, torch.from_numpy(prompt)[None],
                      tm.init_cache(1, 64))
    tc = tm.init_cache(1, 64)
    for start in range(0, 21, 8):
        piece = torch.from_numpy(prompt[start:start + 8])[None]
        last = tm.prefill_chunk(tp, piece, tc, 0, start, piece.shape[1] - 1)
    assert (mono - last).abs().max().item() > 1e-3


def test_parked_slot_arena_bit_identical(tiny):
    """Decode steps with slot 1 parked mid-chunked-prefill leave its K/V
    rows bit for bit; slot 0's move."""
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


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_narrow_arena_logits_match_jax(tiny, fmt):
    """The moe LM over a narrow arena: chunked prefill and 4 decode steps
    against the reference's over the same format, logits within 1e-4."""
    jm, jp, tm, tp = tiny
    prompt = np.random.default_rng(9).integers(0, V, 12).astype(np.int32)
    jc = jm.init_cache(1, 32, kv_format=fmt)
    tc = tm.init_cache(1, 32, kv_format=fmt)
    chunk, step = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step)
    jlog, jc = chunk(jp, jnp.asarray(prompt)[None], jc, jnp.int32(0),
                     jnp.int32(0), jnp.int32(11))
    tlog = tm.prefill_chunk(tp, torch.from_numpy(prompt).long()[None], tc,
                            0, 0, 11)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL)
    tok = int(np.argmax(np.asarray(jlog)))
    for pos in range(12, 16):
        jlog, jc = step(jp, jnp.asarray([tok], jnp.int32), jc,
                        jnp.asarray([pos], jnp.int32))
        tlog = tm.decode_step(tp, torch.tensor([tok]), tc,
                              torch.tensor([pos]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL)
        tok = int(np.argmax(np.asarray(jlog)))
