"""Prefix sharing in the port (``runtime/serving/cache.py``, the engine's
forks, the donor table of ``flash_decode`` / ``flash_prefill_chunk``, the
SSM snapshots) against the JAX package, on the CPU.

  * the two ``PagedKVCacheManager`` s driven through the same allocate /
    register / lookup / fork / extend / free / reclaim / evict sequence
    (random walks and a hypothesis interleave, with and without a chain
    cap, unscaled and scaled formats) agree after every operation: page
    tables, lengths, refcounts, free lists, pinned and hosting regions,
    results and stats;
  * the engine with ``prefix_sharing=True`` gives the JAX engine's token
    streams and fork stats, and the port's own streams with sharing off,
    for dense fp32, dense int8 and ssm: copy-on-write identity, the donor
    retired first, the donor preempted (3 slots, 14 pages, depth 0) and a
    chain cap outliving its donor; every page drains;
  * the plain donor-table kernels over an arena whose forked rows [0, L)
    are NaN equal the plain kernels over the composed view bit for bit
    (L = 4, 12: not multiples of the 64-key strip), and the JAX package's
    kernels over that view within the f32 tolerance;
  * ``LM.prefill_chunk`` / ``decode_step`` with share entries and
    ``extract_slot_state`` / ``splice_slot_state`` against the JAX model;
  * the captured steps' rules under sharing: no host read in the chunk or
    decode step, the parked warm-up with a share entry leaves everything;
  * a snapshot taken one chunk early (a planted fault) changes the fork's
    stream;
  * ``EngineConfig`` validation, ``tail_plan``, ``reset_share``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime.serving import cache as jcache  # noqa: E402
from repro.runtime.serving import chunking as jchunking  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import cache as tcache  # noqa: E402
from repro_torch.runtime.serving import chunking, graphs  # noqa: E402
from repro_torch.runtime.serving.request import (Request,  # noqa: E402
                                                 RequestState)

from test_torch_graphs import NoHostRead  # noqa: E402
from test_torch_kv_format import _to_torch  # noqa: E402
from test_torch_model import TINY, bridged  # noqa: E402
from test_torch_ssm import TINY_SSM, ssm_bridged  # noqa: E402

#: f32 kernels and logits against the JAX package (sums in another order)
ATOL = 2e-5
LOGIT_TOL = 1e-4


# ---------------------------------------------------------------------------
# the page manager, in lockstep with the reference's
# ---------------------------------------------------------------------------

SLOTS = 6
PROMPTS = [np.arange(16, dtype=np.int32),
           np.concatenate([np.arange(8), 50 + np.arange(8)]).astype(np.int32),
           np.arange(100, 116, dtype=np.int32),
           np.concatenate([np.arange(12), 70 + np.arange(6)]).astype(np.int32)]


def _state(m) -> dict:
    """Everything observable of a manager, as plain data."""
    return dict(
        tables={s: m.page_table(s) for s in sorted(m._table)},
        lengths={s: m.length(s) for s in sorted(m._table)},
        refs=[m.refcount(p) for p in range(m.num_pages)],
        free=list(m._free), free_pages=m.free_pages,
        pinned=[m.region_pinned(s) for s in range(SLOTS)],
        hosted=[m.hosts_registered(s) for s in range(SLOTS)],
        stats=dict(m.stats), sidecar=m.scale_sidecar_pages,
        utilization=m.utilization(),
        resident=[m.resident_kv_bytes(s) for s in range(SLOTS)])


def _res(r):
    """An AllocResult, a PrefixMatch or a plain value as plain data."""
    if isinstance(r, (jcache.AllocResult, tcache.AllocResult)):
        return (bool(r), r.reason, r.taken, r.shared, r.freed, r.retained,
                r.shared_len, r.src_slot)
    if isinstance(r, (jcache.PrefixMatch, tcache.PrefixMatch)):
        return (r.src_slot, r.shared_len, r.pages, r.snapshot)
    return r


def _lockstep(pair, steps, ints):
    """Drive (reference, port) through the same operations, picked by
    ``ints(n)`` (an int in [0, n)), comparing results and states after
    each.  Snapshots are opaque strings; the managers never look inside."""
    ref, port = pair
    for i in range(steps):
        op, slot = ints(7), ints(SLOTS)
        prompt = PROMPTS[ints(len(PROMPTS))]
        occupied = slot in ref._table
        if op == 0 and not occupied:                       # admit + publish
            want = [m.allocate(slot, len(prompt)) for m in pair]
            if want[0]:
                upto = ints(len(prompt) + 1)
                snap = f"snapshot {i}" if ints(2) else None
                want += [m.register_prefix(slot, prompt, upto, snapshot=snap)
                         for m in pair]
        elif op == 1 and occupied:                         # fork
            need = bool(ints(2))
            want = [m.lookup(prompt, ref.length(slot), require_snapshot=need)
                    for m in pair]
            if (want[0] and want[0].src_slot != slot
                    and len(want[0].entries) <= len(ref.page_table(slot))):
                want += [m.fork(slot, w) for m, w in zip(pair, want)]
        elif op == 2 and occupied:                         # decode growth
            n = ref.length(slot) + 1 + ints(4)
            want = [m.extend(slot, n) for m in pair]
        elif op == 3 and occupied:                         # retire/preempt
            want = [m.free(slot) for m in pair]
        elif op == 4:                                      # admission reclaim
            want = [m.reclaim_orphan() for m in pair]
        elif op == 5:
            want = [m.evict_chain(slot) for m in pair]
        elif op == 6 and occupied:                         # publish progress
            upto = ints(len(prompt) + 1)
            want = [m.register_prefix(slot, prompt, upto) for m in pair]
        else:
            continue
        got = [_res(w) for w in want]
        assert got[0::2] == got[1::2], \
            (i, op, got)
        assert _state(ref) == _state(port), (i, op)


def _pair(max_chains, fmt, num_pages=10, page_size=4):
    kw = dict(max_chains=max_chains, kv_format=fmt, row_bytes=96)
    return (jcache.PagedKVCacheManager(num_pages, page_size, **kw),
            tcache.PagedKVCacheManager(num_pages, page_size, **kw))


@pytest.mark.parametrize("max_chains", [None, 1, 2])
@pytest.mark.parametrize("fmt", ["fp32", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manager_random_walk_matches_reference(max_chains, fmt, seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        _lockstep(_pair(max_chains, fmt), 80, lambda n: int(rng.integers(n)))


@pytest.mark.parametrize("max_chains", [None, 2])
@pytest.mark.parametrize("fmt", ["fp32", "fp8"])
def test_hypothesis_interleave_matches_reference(max_chains, fmt):
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(st.lists(st.integers(min_value=0, max_value=10 ** 6),
                        min_size=1, max_size=200))
    @hyp.settings(max_examples=40, deadline=None)
    def run(seq):
        it = iter(seq)
        _lockstep(_pair(max_chains, fmt), len(seq),
                  lambda n: next(it, 0) % n)

    run()


def test_manager_refuses_as_the_reference():
    """Already-allocated and unknown slots raise; a stale match, an empty
    match and a cap of 0 are refused the same way in both."""
    for mod in (jcache, tcache):
        m = mod.PagedKVCacheManager(8, 4)
        assert m.allocate(0, 8)
        with pytest.raises(ValueError):
            m.allocate(0, 4)
        with pytest.raises(ValueError):
            m.extend(5, 4)
        with pytest.raises(ValueError):
            m.register_prefix(5, PROMPTS[0], 8)
        assert m.register_prefix(0, PROMPTS[0], 8) == 2
        match = m.lookup(PROMPTS[0], 16)
        assert match.shared_len == 8 and m.allocate(1, 12)
        m.free(0)                              # the chain's pages pool
        assert not m.fork(1, match)
        assert m.fork(1, mod.PrefixMatch((), 0, 0)).reason == "no-prefix"
        with pytest.raises(ValueError):
            mod.PagedKVCacheManager(8, 4, max_chains=0)


# ---------------------------------------------------------------------------
# the engine against the JAX package's
# ---------------------------------------------------------------------------

FAMILIES = [("dense", "fp32"), ("dense", "int8"), ("ssm", "fp32")]
FAMILY_IDS = [f"{f}-{k}" for f, k in FAMILIES]
ENGINE_CASES = ("cow", "donor-retired", "donor-preempted", "chain-cap")
STAT_KEYS = ("forks", "shared_prompt_tokens", "prefill_rows", "prefix_hits",
             "prefix_deferrals", "prefill_chunks", "tokens_out",
             "decode_steps", "requests")


@pytest.fixture(scope="module")
def models():
    return {"dense": (TINY, bridged(TINY)),
            "ssm": (TINY_SSM, ssm_bridged(TINY_SSM))}


def _shared_prompts(vocab, n, shared, tail, seed):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([head,
                            rng.integers(0, vocab, tail).astype(np.int32)])
            for _ in range(n)]


def _case(name, vocab):
    """(prompts, max_new_tokens, EngineConfig fields) of an engine case
    (tests/test_prefix_sharing.py's, at page size 4)."""
    if name == "chain-cap":
        # 11 pages of 4: request 0 reserves 6 and peaks at 7, so request 1
        # is admitted only after request 0 retires: without the cap its
        # chain would be gone by then
        prompts = _shared_prompts(vocab, 2, 16, 6, 9)
        return prompts, [6, 6], dict(
            max_slots=2, max_seq=64, page_size=4, num_pages=11,
            prefill_chunks=(8, 16), prefix_chain_cap=2)
    n, seed, gens, kw = {
        "cow": (3, 5, [6, 6, 6], {}),
        "donor-retired": (3, 6, [2, 10, 10], {}),
        "donor-preempted": (4, 7, [12] * 4,
                            dict(max_slots=3, num_pages=14, depth=0))}[name]
    prompts = _shared_prompts(vocab, n, 16, 4, seed)
    base = dict(max_slots=n, depth=2, page_size=4, prefill_chunks=(4, 8, 16),
                max_seq=max(len(p) for p in prompts) + max(gens) + 5)
    return prompts, gens, {**base, **kw}


def _serve(mod, model, cfg, params, prompts, gens, **kw):
    eng = mod.ServingEngine(model, cfg, params,
                            config=mod.EngineConfig(**kw))
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(uid=i, prompt=p, max_new_tokens=gens[i]))
    out = eng.run(max_steps=2000)
    return {u: np.asarray(t).tolist() for u, t in out.items()}, eng


@pytest.mark.parametrize("case", ENGINE_CASES)
@pytest.mark.parametrize("family,fmt", FAMILIES, ids=FAMILY_IDS)
def test_engine_streams_and_stats_match_jax(models, family, fmt, case):
    jcfg, (jm, jp, tm, tp) = models[family]
    prompts, gens, kw = _case(case, jcfg.vocab)
    kw = dict(kw, kv_format=fmt)
    want, jeng = _serve(jserving, jm, jcfg, jp, prompts, gens,
                        prefix_sharing=True, **kw)
    got, eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens,
                      prefix_sharing=True, **kw)
    plain = {k: v for k, v in kw.items() if k != "prefix_chain_cap"}
    off, off_eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens, **plain)
    assert got == want
    assert got == off
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert eng.cache_mgr.stats == {k: jeng.cache_mgr.stats[k]
                                   for k in eng.cache_mgr.stats}
    assert eng.scheduler.stats == {k: jeng.scheduler.stats[k]
                                   for k in eng.scheduler.stats}
    m = eng.cache_mgr
    assert _state(m) == _state(jeng.cache_mgr)
    # sharing ingests the shared prefix once
    saved = eng.stats["shared_prompt_tokens"]
    assert eng.stats["forks"] >= 1 and saved >= 16
    if case == "cow":
        assert eng.stats["forks"] == 2 and saved == 2 * 16
        assert m.stats["max_page_ref"] == 3
        assert eng.stats["prefill_rows"] == off_eng.stats["prefill_rows"] \
            - saved
    if case == "donor-preempted":
        assert eng.scheduler.stats["preempted"] >= 1
        assert eng.stats["forks"] >= 3
    if case == "chain-cap":
        assert m.stats["evicted_chains"] == 0
        return                                 # the index keeps its chain
    assert m.free_pages == m.num_pages
    assert not any(m.region_pinned(s) for s in range(eng.max_slots))
    assert m.scale_sidecar_pages == 0
    # every donor entry is back to the identity
    src, ln = eng._share
    assert src.tolist() == list(range(eng.max_slots))
    assert ln.tolist() == [0] * eng.max_slots


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_sharing_off_engine_has_no_donor_table(models, family):
    """An engine with sharing off keeps today's steps: no donor table, the
    chunk scalars (slot, start, last_idx) only."""
    jcfg, (_, _, tm, tp) = models[family]
    prompts, gens, kw = _case("cow", jcfg.vocab)
    _, eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens, **kw)
    assert eng._share is None
    assert all(s.shape == (3,) for _, s in eng._chunk_inputs.values())
    assert eng.stats["forks"] == 0 and eng.stats["snapshots"] == 0


def test_snapshot_one_chunk_early_changes_the_stream(models):
    """The planted fault: each ssm snapshot is the state one chunk before
    the chunk that ends at its page (zeros for the first), so the forks
    resume from the wrong state and their streams move; the true
    snapshots keep them."""
    jcfg, (_, _, tm, tp) = models["ssm"]
    prompts, gens, kw = _case("cow", jcfg.vocab)
    want, _ = _serve(tserving, tm, tm.cfg, tp, prompts, gens, **kw)
    extract = tm.extract_slot_state
    held: dict = {}

    def early(cache, slot):
        now = extract(cache, slot)
        before = held.get(slot, [torch.zeros_like(t) for t in now])
        held[slot] = now
        return before

    tm.extract_slot_state = early
    try:
        bad, eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens,
                          prefix_sharing=True, **kw)
    finally:
        del tm.extract_slot_state
    assert eng.stats["forks"] == 2 and eng.stats["snapshots"] >= 1
    assert bad[0] == want[0]                   # the donor is untouched
    assert bad[1] != want[1] and bad[2] != want[2]
    good, eng = _serve(tserving, tm, tm.cfg, tp, prompts, gens,
                       prefix_sharing=True, **kw)
    assert good == want
    # a snapshot is the slot's whole state: SSD state and conv tail
    s, d = TINY_SSM.ssm, TINY_SSM.d_model
    nh, di = s.n_heads(d), s.d_inner(d)
    assert eng.stats["snapshot_bytes"] == TINY_SSM.n_layers * 4 * (
        nh * s.d_state * s.headdim
        + (s.conv_width - 1) * (di + 2 * s.n_groups * s.d_state))


# ---------------------------------------------------------------------------
# the donor table of the plain kernels
# ---------------------------------------------------------------------------

def _arena(rng, fmt, n, s, kvh, hd):
    """(JAX (k, v, ks, vs), port (k, v, ks, vs)) of one random arena in
    ``fmt`` (scales None unless scaled)."""
    from repro.core import kv_format as jkvf
    k = jnp.asarray(rng.standard_normal((n, s, kvh, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((n, s, kvh, hd)), jnp.float32)
    f = jkvf.get(fmt)
    if f.scaled:
        (k, ks), (v, vs) = jkvf.quantize(f, k), jkvf.quantize(f, v)
    else:
        k, v = k.astype(f.resolve_dtype(jnp.float32)), \
            v.astype(f.resolve_dtype(jnp.float32))
        ks = vs = None
    jx = (k, v, ks, vs)
    return jx, tuple(None if a is None else _to_torch(a) for a in jx)


def _compose(t, own, src, length):
    """``t`` with rows [0, length) of arena row ``own`` taken from row
    ``src`` (the composed view, by hand)."""
    if t is None:
        return None
    out = t.clone()
    out[own, :length] = t[src, :length]
    return out


def _poisoned(t, own, length):
    if t is None:
        return None
    out = t.clone()
    if out.dtype == torch.int8:
        out[own, :length] = 127
    else:
        out[own, :length] = float("nan")
    return out


@pytest.mark.parametrize("share_len", [4, 12])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("kernel", ["decode", "chunk"])
def test_plain_donor_table_reads_the_donor(kernel, fmt, share_len):
    """Slot 1 forked onto slot 2 at L: with its own rows [0, L) (and
    scales) poisoned, the plain kernel with the table equals the plain
    kernel over the composed view bit for bit, and the JAX package's
    kernel (ref mode) over that view within the f32 tolerance."""
    rng = np.random.default_rng(share_len)
    n, s, kvh, h, hd, c = 3, 40, 2, 8, 16, 8
    jx, (k, v, ks, vs) = _arena(rng, fmt, n, s, kvh, hd)
    own, src = 1, 2
    view = [_compose(t, own, src, share_len) for t in (k, v, ks, vs)]
    bad = [_poisoned(t, own, share_len) for t in (k, v, ks, vs)]
    jview = [None if a is None else jnp.asarray(np.asarray(a))
             for a in jx]
    if jview[0] is not None:
        for i, t in enumerate(view):
            if t is not None:
                jview[i] = jx[i].at[own, :share_len].set(
                    jx[i][src, :share_len])
    table = dict(share_src=torch.tensor([0, src, 2]),
                 share_len=torch.tensor([0, share_len, 0]))
    if kernel == "decode":
        q = rng.standard_normal((n, h, hd)).astype(np.float32)
        lens = np.array([17, 30, 40], np.int32)
        got = ops.flash_decode(torch.from_numpy(q), bad[0], bad[1],
                               lengths=torch.from_numpy(lens),
                               k_scale=bad[2], v_scale=bad[3], **table)
        want = ops.flash_decode(torch.from_numpy(q), view[0], view[1],
                                lengths=torch.from_numpy(lens),
                                k_scale=view[2], v_scale=view[3])
        jwant = jops.flash_decode(jnp.asarray(q), jview[0], jview[1],
                                  lengths=jnp.asarray(lens),
                                  k_scale=jview[2], v_scale=jview[3],
                                  mode="ref", bk=16)
    else:
        q = rng.standard_normal((1, c, h, hd)).astype(np.float32)
        pre = np.array([share_len + 4], np.int32)
        slot = torch.tensor([own])
        got = ops.flash_prefill_chunk(
            torch.from_numpy(q), bad[0], bad[1], prefix=torch.from_numpy(pre),
            k_scale=bad[2], v_scale=bad[3], slots=slot,
            share_src=torch.tensor([src]),
            share_len=torch.tensor([share_len]))
        want = ops.flash_prefill_chunk(
            torch.from_numpy(q), view[0], view[1],
            prefix=torch.from_numpy(pre), k_scale=view[2], v_scale=view[3],
            slots=slot)
        sl = slice(own, own + 1)
        jwant = jops.flash_prefill_chunk(
            jnp.asarray(q), jview[0][sl], jview[1][sl],
            prefix=jnp.asarray(pre),
            k_scale=None if jview[2] is None else jview[2][sl],
            v_scale=None if jview[3] is None else jview[3][sl],
            mode="ref", bk=16)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=ATOL,
                               rtol=0)


def test_plain_identity_table_is_no_table():
    """The identity entry (own slot, 0) is today's call, bit for bit."""
    rng = np.random.default_rng(0)
    _, (k, v, _, _) = _arena(rng, "fp32", 3, 40, 2, 16)
    q = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    lens = torch.tensor([5, 40, 1])
    got = ops.flash_decode(q, k, v, lengths=lens,
                           share_src=torch.arange(3),
                           share_len=torch.zeros(3, dtype=torch.int64))
    assert torch.equal(got, ops.flash_decode(q, k, v, lengths=lens))


# ---------------------------------------------------------------------------
# the model drivers against the JAX model
# ---------------------------------------------------------------------------

def _j(t) -> np.ndarray:
    return np.asarray(t)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_prefill_chunk_and_decode_with_share_match_jax(models, family):
    """A donor chunk into slot 2, then the fork's tail chunk into slot 0
    at start 8 with share (2, 8), then one decode step over all slots
    with the share vectors: logits and the fork's rows (or state) as the
    JAX model's; the donor's slot is read only."""
    jcfg, (jm, jp, tm, tp) = models[family]
    rng = np.random.default_rng(3)
    head = rng.integers(0, jcfg.vocab, 8)
    tail = rng.integers(0, jcfg.vocab, 4)
    jc = jm.init_cache(3, 32)
    tc = tm.init_cache(3, 32)
    toks = head[None]
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks, jnp.int32), jc,
                             jnp.int32(2), jnp.int32(0), jnp.int32(7))
    tm.prefill_chunk(tp, torch.from_numpy(toks), tc, 2, 0, 7)
    if family == "ssm":
        # the fork resumes from the donor's state: splice it first
        jc = jm.splice_slot_state(jc, jm.extract_slot_state(jc, 2), 0)
        tm.splice_slot_state(tc, tm.extract_slot_state(tc, 2), 0)
    donor = {k: v.clone() for k, v in tm.slot_view(tc, 2).items()}
    jl, jc = jm.prefill_chunk(jp, jnp.asarray(tail[None], jnp.int32), jc,
                              jnp.int32(0), jnp.int32(8), jnp.int32(3),
                              share_src=jnp.int32(2), share_len=jnp.int32(8))
    tl = tm.prefill_chunk(tp, torch.from_numpy(tail[None]), tc, 0, 8, 3,
                          share_src=2, share_len=8)
    np.testing.assert_allclose(tl.numpy(), _j(jl), atol=LOGIT_TOL, rtol=0)
    for key, leaf in tm.slot_view(tc, 2).items():
        assert torch.equal(leaf, donor[key]), key
    tok = np.array([5, 7, 9])
    pos = np.array([12, 1 << 30, 8])
    src, ln = np.array([2, 1, 2]), np.array([8, 0, 0])
    jl, _ = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                           jnp.asarray(pos, jnp.int32),
                           share=(jnp.asarray(src, jnp.int32),
                                  jnp.asarray(ln, jnp.int32)))
    tl = tm.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(pos),
                        share=(torch.from_numpy(src), torch.from_numpy(ln)))
    np.testing.assert_allclose(tl[[0, 2]].numpy(), _j(jl)[[0, 2]],
                               atol=LOGIT_TOL, rtol=0)


def test_state_snapshot_round_trip_matches_jax(models):
    """extract_slot_state gives the JAX model's leaves (SSD state, conv
    tail) of a slot; splice_slot_state writes them into another slot only;
    the dense family has no recurrent leaves."""
    jcfg, (jm, jp, tm, tp) = models["ssm"]
    assert tm.has_recurrent_state == jm.has_recurrent_state is True
    assert tm.supports_prefix_sharing == jm.supports_prefix_sharing is True
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (1, 8))
    jc = jm.init_cache(4, 16)
    tc = tm.init_cache(4, 16)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks, jnp.int32), jc,
                             jnp.int32(1), jnp.int32(0), jnp.int32(7))
    tm.prefill_chunk(tp, torch.from_numpy(toks), tc, 1, 0, 7)
    jsnap = jm.extract_slot_state(jc, 1)
    tsnap = tm.extract_slot_state(tc, 1)
    assert len(jsnap) == len(tsnap) == 2
    # each in its arena's leaf order: the pytree's sorted keys, the dict's
    jsnap = dict(zip(sorted(jc), jsnap))
    for key, t in zip(tc, tsnap):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(jsnap[key], np.float32),
                                   atol=LOGIT_TOL, rtol=0)
    before = {k: v.clone() for k, v in tc.items()}
    tm.splice_slot_state(tc, tsnap, 3)
    for k, v in tm.slot_view(tc, 3).items():
        assert torch.equal(v, tm.slot_view(tc, 1)[k]), k
    for s in (0, 1, 2):
        for k, v in tm.slot_view(tc, s).items():
            assert torch.equal(v, tm.slot_view(before, s)[k]), (s, k)
    _, (_, _, dm, _) = models["dense"]
    assert dm.has_recurrent_state is False
    assert dm.extract_slot_state(dm.init_cache(2, 8), 0) == []


# ---------------------------------------------------------------------------
# what the captured steps rely on, under sharing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,fmt", FAMILIES, ids=FAMILY_IDS)
def test_shared_steps_make_no_host_read(models, family, fmt):
    """A fork's chunk step (share scalars as device data) and the decode
    step with the donor table make no host read; the parked warm-up of the
    chunk step with a share entry leaves the arena, the slot vectors, the
    donor table and its scalars bit for bit, and the run still gives the
    JAX engine's streams."""
    jcfg, (jm, jp, tm, tp) = models[family]
    prompts, gens, kw = _case("cow", jcfg.vocab)
    kw = dict(kw, kv_format=fmt, prefix_sharing=True)
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(**kw))
    for i, p in enumerate(prompts):
        eng.submit(tserving.Request(uid=i, prompt=p, max_new_tokens=gens[i]))
    for _ in range(40):
        forks = [st for st in eng.scheduler.running.values()
                 if st.share_src is not None and st.chunk_plan is not None
                 and st.chunk_idx < len(st.chunk_plan)]
        if forks:
            break
        eng.step()
    st = forks[0]
    size = st.chunk_plan[st.chunk_idx]
    tokens, scalars, _ = eng._chunk_runner(size)
    eng._stage(scalars, [st.slot, st.prefill_pos, size - 1, st.share_src,
                         st.share_len])
    assert scalars.shape == (5,) and int(scalars[4]) == 16

    def state():
        out = {f"cache.{k}": v for k, v in eng._cache.items()}
        out.update(tokens=eng._tokens, pos=eng._pos, active=eng._active,
                   src=eng._share[0], len=eng._share[1], scalars=scalars)
        return {k: v.detach().clone().view(torch.uint8)
                for k, v in out.items()}

    before = state()
    with NoHostRead():
        graphs.parked_chunk_warm_up(lambda: eng._chunk_step(tokens, scalars),
                                    scalars)
    after = state()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    saved = {k: v.clone() for k, v in eng._cache.items()}
    with NoHostRead():
        eng._chunk_step(tokens, scalars)
        graphs.parked_warm_up(eng._decode_step, eng._tokens, eng._pos,
                              eng._active)
    for k, v in saved.items():           # the chunk runs again in the run
        eng._cache[k].copy_(v)
    out = eng.run(max_steps=2000)
    want, _ = _serve(jserving, jm, jcfg, jp, prompts, gens, **kw)
    assert {u: np.asarray(t).tolist() for u, t in out.items()} == want


# ---------------------------------------------------------------------------
# configuration, chunk plans, request state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    dict(prefix_sharing=True),
    dict(prefix_chain_cap=2),
    dict(prefix_sharing=True, prefill_chunks=(4,), prefix_chain_cap=0),
])
def test_config_validation_matches_reference(fields):
    """Sharing needs chunked prefill, a chain cap needs sharing and is
    >= 1: ValueError in both packages."""
    with pytest.raises(ValueError):
        jserving.EngineConfig(**fields)
    with pytest.raises(ValueError):
        tserving.EngineConfig(**fields)


def test_config_accepts_sharing_and_still_refuses_later_slices():
    cfg = tserving.EngineConfig(prefill_chunks=(8, 4), prefix_sharing=True,
                                prefix_chain_cap=3)
    assert cfg.prefill_chunks == (4, 8) and cfg.prefix_chain_cap == 3
    assert cfg.replace(prefix_chain_cap=None).prefix_sharing
    assert tserving.EngineConfig(speculative=None).speculative is None
    # the robustness fields are ported (tests/test_torch_faults.py); the
    # arena is written in place, so donation has no counterpart
    for name in ("faults", "health", "preempt_cap"):
        assert getattr(tserving.EngineConfig(**{name: None}), name) is None
    assert tserving.EngineConfig(admission_reclaim_cap=2) \
        .admission_reclaim_cap == 2
    with pytest.raises(TypeError):
        tserving.EngineConfig(donate=None)


@pytest.mark.parametrize("plen,shared", [(20, 16), (17, 16), (33, 32),
                                         (100, 48), (5, 0), (513, 512)])
@pytest.mark.parametrize("buckets", [(4, 8, 16), (32, 64, 128, 256, 512)])
def test_tail_plan_matches_reference(plen, shared, buckets):
    assert chunking.tail_plan(plen, shared, buckets) == \
        jchunking.tail_plan(plen, shared, buckets)


@pytest.mark.parametrize("shared", [-1, 20, 21])
def test_tail_plan_refuses_an_empty_tail(shared):
    with pytest.raises(ValueError):
        chunking.tail_plan(20, shared)


def test_reset_share_rewinds_to_the_unforked_plan():
    st = RequestState(Request(uid=0, prompt=np.arange(20),
                              max_new_tokens=2),
                      chunk_plan=[16, 4], base_chunk_plan=[16, 4])
    st.share_src, st.share_len, st.chunk_plan = 3, 16, [4]
    st.reset_share()
    assert (st.share_src, st.share_len, st.chunk_plan) == (None, 0, [16, 4])
