"""The serving engine's captured chunk step and first draw
(``runtime/serving/graphs.py`` ``ChunkGraph`` / ``CapturedStep``) on the
CPU, where nothing is captured: what capture relies on, for the dense
family at every KV format (fp32, bf16, int8, fp8) and the ssm family.

  * the chunk step the graph captures (``ServingEngine._chunk_step``: slot,
    start and last index as device data) makes no host read, with live,
    parked and never-used slots beside the chunk's slot, and writes only
    that slot;
  * its parked warm-up (``graphs.parked_chunk_warm_up``, start =
    PARKED_POS) leaves the arena, the scale leaves, the SSM state and
    conv tail, the slot vectors and the chunk's scalars bit for bit, and
    the run then still matches the JAX package's engine token for token;
  * ``LM.prefill_chunk`` with 0-d device scalars equals the JAX
    ``LM.prefill_chunk`` at the same slot and start, in logits and in the
    slot's rows (or state), and leaves the other slots bit for bit;
  * ``ops.flash_prefill_chunk`` (plain) over the whole arena with a slot
    table equals it over the slot's view bit for bit, and the JAX
    package's ``ops.flash_prefill_chunk`` in ``ref`` mode;
  * the first-draw step makes no host read and equals
    ``sampling.sample_first``;
  * ``EngineConfig.chunk_graph`` on the CPU: the chunks always run
    eagerly (through the same device buffers), and ``ChunkGraph`` refuses
    CPU tensors.

The captured graphs themselves run on the card only
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_format as jkvf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import graphs, sampling  # noqa: E402
from repro_torch.runtime.serving.request import Status  # noqa: E402

from test_torch_graphs import NoHostRead, _engine  # noqa: E402
from test_torch_kv_format import _to_torch  # noqa: E402
from test_torch_model import TINY, bridged  # noqa: E402
from test_torch_ssm import TINY_SSM, ssm_bridged  # noqa: E402

#: (family, KV format): the dense family at every format, the ssm family
#: at its one
CASES = [("dense", "fp32"), ("dense", "bf16"), ("dense", "int8"),
         ("dense", "fp8"), ("ssm", "fp32")]
IDS = [f"{f}-{k}" for f, k in CASES]
#: logits and f32 rows against the JAX package (both f32; sums in another
#: order): the tiny regime's tolerance (tests/test_torch_model.py)
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """{family: (JAX config, (jax model, jax params, port model, port
    params))} on the same numpy-made weights."""
    return {"dense": (TINY, bridged(TINY)),
            "ssm": (TINY_SSM, ssm_bridged(TINY_SSM))}


def _mixed_chunk_engine(models, family, fmt):
    """A port engine stepped until a slot is mid-chunked-prefill beside a
    decoding one (an unused slot too); returns (engine, the prefilling
    request's state)."""
    _, (_, _, tm, tp) = models[family]
    eng = _engine(tserving, tm, tm.cfg, tp, kv_format=fmt)
    for _ in range(50):
        states = {st.status: st for st in eng.scheduler.running.values()}
        if Status.RUNNING in states and Status.PREFILLING in states:
            return eng, states[Status.PREFILLING]
        eng.step()
    raise AssertionError("no prefilling slot beside a decoding one")


def _staged(eng, st):
    """(tokens, scalars) of ``st``'s next chunk, written into the engine's
    static buffers as the engine writes them."""
    size = st.chunk_plan[st.chunk_idx]
    tokens, scalars, _ = eng._chunk_runner(size)
    start = st.prefill_pos
    real = min(size, st.prompt_len - start)
    chunk = np.zeros(size, np.int64)
    chunk[:real] = st.request.prompt[start:start + real]
    eng._stage(tokens, chunk)
    eng._stage(scalars, [st.slot, start, real - 1])
    return tokens, scalars


def _state(eng, scalars) -> dict:
    """Every tensor of the engine's state and the chunk's scalars, as raw
    bytes."""
    state = {f"cache.{k}": v for k, v in eng._cache.items()}
    state.update(tokens=eng._tokens, pos=eng._pos, active=eng._active,
                 scalars=scalars)
    return {k: v.detach().clone().view(torch.uint8)
            for k, v in state.items()}


def _slot_rows(model, cache, slot) -> dict:
    return {k: v.clone() for k, v in model.slot_view(cache, slot).items()}


@pytest.mark.parametrize("family,fmt", CASES, ids=IDS)
def test_chunk_step_makes_no_host_read(models, family, fmt):
    """The function a chunk graph captures runs through with no host read
    beside live, parked and never-used slots, writes only its own slot, and
    returns (1, V) logits."""
    eng, st = _mixed_chunk_engine(models, family, fmt)
    tokens, scalars = _staged(eng, st)
    model = eng.model
    others = {s: _slot_rows(model, eng._cache, s)
              for s in range(eng.max_slots) if s != st.slot}
    mine = _slot_rows(model, eng._cache, st.slot)
    with NoHostRead():
        logits = eng._chunk_step(tokens, scalars)
    assert logits.shape == (1, eng.cfg.vocab)
    assert torch.isfinite(logits).all()
    for s, rows in others.items():
        for k, v in _slot_rows(model, eng._cache, s).items():
            assert torch.equal(v.view(torch.uint8),
                               rows[k].view(torch.uint8)), (s, k)
    after = _slot_rows(model, eng._cache, st.slot)
    assert any(not torch.equal(after[k].view(torch.uint8),
                               mine[k].view(torch.uint8)) for k in mine)


@pytest.mark.parametrize("family,fmt", CASES, ids=IDS)
def test_parked_chunk_warm_up_leaves_no_trace(models, family, fmt):
    """The chunk step run at start = PARKED_POS, its scalars pointing at a
    slot mid-prefill (whose rows or state it must not touch), leaves every
    arena leaf (scales, SSM state and conv tail included), the slot vectors
    and the scalars bit for bit; the run then still matches the JAX
    engine's streams."""
    jcfg, (jm, jp, _, _) = models[family]
    eng, st = _mixed_chunk_engine(models, family, fmt)
    tokens, scalars = _staged(eng, st)
    before = _state(eng, scalars)
    assert ("cache.k_scale" in before) == (fmt in ("int8", "fp8"))
    with NoHostRead():
        graphs.parked_chunk_warm_up(lambda: eng._chunk_step(tokens, scalars),
                                    scalars)
    after = _state(eng, scalars)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    got = eng.run(max_steps=2000)
    want = _engine(jserving, jm, jcfg, jp, kv_format=fmt).run(max_steps=2000)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")


def _close_rows(got: torch.Tensor, want, fmt: str) -> None:
    """A slot's stored rows against the reference's: f32 leaves (values,
    scales, SSM state) within LOGIT_TOL; a narrow format's stored values
    within one step of its grid at their magnitude (int8: one code), since
    K/V differ in the last f32 bits between the two packages, which can
    move a value across a rounding boundary."""
    want = _to_torch(want)
    if fmt == "fp32" or got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=0)
        return
    g, w = got.float(), want.float()
    step = {"bf16": 2.0 ** -7, "fp8": 2.0 ** -3}.get(fmt, 0.0)
    if fmt == "int8":
        assert (g - w).abs().max() <= 1, (g - w).abs().max()
    else:
        assert ((g - w).abs() <= step * w.abs() + 1e-6).all()


@pytest.mark.parametrize("family,fmt", CASES, ids=IDS)
def test_prefill_chunk_device_scalars_match_jax(models, family, fmt):
    """Chunks of 8 (the last padded) into slot 1 of a 3-slot arena whose
    slots hold stale values, slot / start / last index as 0-d device
    tensors: logits within LOGIT_TOL of the JAX ``prefill_chunk`` at the
    same slot and start (narrow formats: 2e-3, the quantized arena the
    chunk attends differing by a grid step where a value rounds the other
    way), the slot's rows (or state) as :func:`_close_rows` says, and
    slots 0 and 2 bit for bit."""
    _, (jm, jp, tm, tp) = models[family]
    prompt = np.random.default_rng(4).integers(0, 97, 13).astype(np.int32)
    tc = tm.init_cache(3, 64, kv_format=fmt)
    for k, v in tc.items():
        if v.dtype == torch.float32:
            v.copy_(torch.linspace(-0.5, 0.5, v.numel()).view(v.shape))
    jc = jm.init_cache(3, 64, kv_format=fmt)
    jc = {k: jnp.asarray(tc[k].float().numpy()).astype(jc[k].dtype)
          for k in jc}
    stale = {s: _slot_rows(tm, tc, s) for s in (0, 2)}
    fn = jax.jit(jm.prefill_chunk)
    tol = LOGIT_TOL if fmt == "fp32" else 2e-3
    for start in range(0, len(prompt), 8):
        real = min(8, len(prompt) - start)
        chunk = np.zeros(8, np.int32)
        chunk[:real] = prompt[start:start + real]
        jlog, jc = fn(jp, jnp.asarray(chunk)[None], jc, jnp.int32(1),
                      jnp.int32(start), jnp.int32(real - 1))
        tlog = tm.prefill_chunk(tp, torch.from_numpy(chunk).long()[None], tc,
                                torch.tensor(1), torch.tensor(start),
                                torch.tensor(real - 1))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol,
                                   rtol=0)
    for k in tc:
        _close_rows(tc[k], jc[k], fmt)
    for s, rows in stale.items():
        for k, v in _slot_rows(tm, tc, s).items():
            assert torch.equal(v.view(torch.uint8),
                               rows[k].view(torch.uint8)), (s, k)


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_chunk_slot_table_equals_slot_view(fmt, window):
    """The plain chunk attention over a 4-slot arena with a slot table
    equals it over each slot's own view bit for bit (one batch per slot,
    and two batches on slots 3 and 1), and the JAX package's ``ref`` mode
    over the same slot within 2e-5."""
    rng = np.random.default_rng(7)
    N, C, H, KVH, S, hd = 4, 8, 8, 2, 40, 16
    k = rng.standard_normal((N, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, S, KVH, hd)).astype(np.float32)
    if fmt in ("int8", "fp8"):
        jk, jks = jkvf.quantize(jkvf.get(fmt), jnp.asarray(k))
        jv, jvs = jkvf.quantize(jkvf.get(fmt), jnp.asarray(v))
    else:
        dt = jnp.bfloat16 if fmt == "bf16" else jnp.float32
        jk, jv, jks, jvs = (jnp.asarray(k).astype(dt),
                            jnp.asarray(v).astype(dt), None, None)
    tk, tv = _to_torch(jk), _to_torch(jv)
    tks = _to_torch(jks) if jks is not None else None
    tvs = _to_torch(jvs) if jvs is not None else None
    q = rng.standard_normal((2, C, H, hd)).astype(np.float32)
    prefix = np.array([9, S - C], np.int32)

    def one(t, s):
        return None if t is None else t[s:s + 1]

    for s in range(N):
        kw = dict(prefix=torch.from_numpy(prefix[:1]), window=window, bk=16)
        got = ops.flash_prefill_chunk(
            torch.from_numpy(q[:1]), tk, tv, slots=torch.tensor([s]),
            k_scale=tks, v_scale=tvs, **kw)
        view = ops.flash_prefill_chunk(
            torch.from_numpy(q[:1]), tk[s:s + 1], tv[s:s + 1],
            k_scale=one(tks, s), v_scale=one(tvs, s), **kw)
        assert torch.equal(got, view), s
        want = jops.flash_prefill_chunk(
            jnp.asarray(q[:1]), jk[s:s + 1], jv[s:s + 1],
            prefix=jnp.asarray(prefix[:1]), window=window,
            k_scale=None if jks is None else jks[s:s + 1],
            v_scale=None if jvs is None else jvs[s:s + 1], mode="ref",
            bk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)
    rows = [3, 1]
    got = ops.flash_prefill_chunk(
        torch.from_numpy(q), tk, tv, prefix=torch.from_numpy(prefix),
        window=window, bk=16, slots=torch.tensor(rows), k_scale=tks,
        v_scale=tvs)
    pick = torch.tensor(rows)
    view = ops.flash_prefill_chunk(
        torch.from_numpy(q), tk[pick], tv[pick],
        prefix=torch.from_numpy(prefix), window=window, bk=16,
        k_scale=None if tks is None else tks[pick],
        v_scale=None if tvs is None else tvs[pick])
    assert torch.equal(got, view)


def test_write_chunk_rows_drops_rows_past_the_arena():
    """Rows past max_seq keep their old values (C rows land mod S on
    distinct rows, never meeting a written one); a chunk at PARKED_POS
    writes nothing; other slots stay bit for bit."""
    arena = torch.arange(3 * 10 * 2, dtype=torch.float32).view(3, 10, 2)
    rows = -torch.ones(4, 2)
    want = arena.clone()
    want[1, 7:10] = -1.0
    with NoHostRead():
        TL.write_chunk_rows(arena, rows, torch.tensor(1), torch.tensor(7))
    assert torch.equal(arena, want)
    before = arena.clone()
    TL.write_chunk_rows(arena, rows, torch.tensor(2),
                        torch.tensor(TL.PARKED_POS))
    assert torch.equal(arena, before)
    with pytest.raises(ValueError, match="does not fit"):
        TL.write_chunk_rows(arena, torch.ones(11, 2), torch.tensor(0),
                            torch.tensor(0))


#: (temperature, top_k, top_p, min_p, seed, q): every filter on, each off
DRAWS = ((0.6, 50, 0.9, 0.05, 3, 21), (1.0, 0, 1.0, 0.0, 11, 9),
         (1.3, 7, 1.0, 0.0, 0, 1), (0.8, 0, 0.5, 0.2, 123, 40))


@pytest.mark.parametrize("family,fmt", CASES, ids=IDS)
def test_first_draw_step_matches_sample_first(models, family, fmt):
    """The first-draw step (what the first-draw graph captures) over its
    static logits row and scalars makes no host read and draws
    ``sampling.sample_first``'s token, bit for bit, at several knob
    sets, beside the row's finite flag (0 once the row holds a NaN)."""
    _, (_, _, tm, tp) = models[family]
    eng = _engine(tserving, tm, tm.cfg, tp, kv_format=fmt)
    assert eng.draw_graph is None and eng._draw_step == eng._first_draw_step
    rng = np.random.default_rng(3)
    for temp, top_k, top_p, min_p, seed, q in DRAWS:
        logits = torch.from_numpy(
            rng.standard_normal((1, tm.cfg.vocab)).astype(np.float32) * 3)
        sp = tserving.SamplingParams(temperature=temp, top_k=top_k,
                                     top_p=top_p, min_p=min_p, seed=seed)
        eng._draw_logits.copy_(logits)
        eng._stage(eng._draw_ints, [seed, q, top_k])
        eng._stage(eng._draw_floats, [temp, top_p, min_p])
        with NoHostRead():
            got = eng._first_draw_step()
        want = sampling.sample_first(logits, seed, q, sp)
        assert got.shape == (2,) and torch.equal(got[:1], want), (sp, q)
        assert int(got[1]) == 1
    eng._draw_logits[0, 5] = float("nan")
    with NoHostRead():
        got = eng._first_draw_step()
    assert int(got[1]) == 0


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_chunk_graph_field_rules(models, family):
    """On the CPU the chunks run eagerly whatever ``chunk_graph`` says (the
    default, True, captures only on the card): no chunk graph, one static
    buffer pair per chunk length; the CLI namespace carries
    ``chunk_graph`` (no flag) into the config; a ChunkGraph refuses CPU
    tensors."""
    _, (_, _, tm, tp) = models[family]
    assert tserving.EngineConfig().chunk_graph is True
    for kw in ({}, {"chunk_graph": False}):
        eng = _engine(tserving, tm, tm.cfg, tp, **kw)
        eng.run(max_steps=2000)
        assert eng.chunk_graphs == {}
        assert sorted(eng._chunk_inputs) == [4, 8]
        assert eng.stats["prefill_shapes"] == len(eng._chunk_inputs)
    args = serve.parse_args(["--arch", "llama3.2-3b"])
    assert args.chunk_graph is True
    args.chunk_graph = False
    assert serve.engine_config(args, [8]).chunk_graph is False
    tokens, scalars, _ = eng._chunk_runner(4)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.ChunkGraph(lambda: eng._chunk_step(tokens, scalars), scalars)


def test_first_chunk_reset_drops_a_previous_occupants_nan(models):
    """A slot whose previous occupant left NaN in its SSM state and conv
    tail: a prompt's first chunk (start 0) resets the carry by a select,
    not a multiply by 0, so the logits and the new state equal those of a
    clean arena bit for bit."""
    _, (_, _, tm, tp) = models["ssm"]
    prompt = torch.arange(8)[None] % 97
    one = (torch.tensor(1), torch.tensor(0), torch.tensor(7))
    clean, dirty = tm.init_cache(2, 64), tm.init_cache(2, 64)
    for leaf in dirty.values():
        leaf.fill_(float("nan"))
    want = tm.prefill_chunk(tp, prompt, clean, *one)
    got = tm.prefill_chunk(tp, prompt, dirty, *one)
    assert torch.equal(got, want)
    for k in clean:
        assert torch.equal(tm.slot_view(dirty, 1)[k],
                           tm.slot_view(clean, 1)[k]), k


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8", "fp8"])
def test_verify_step_makes_no_host_read(models, fmt, sampled):
    """The speculative verify step of one rung (what a verify graph
    captures: ``LM.verify_chunk`` at the device (slot, start), then the
    draws and the finite flag) makes no host read beside parked and
    never-used slots, writes only rows [start, start + k) of its slot and
    returns (k,) draws and a 0-d flag; its parked warm-up (start =
    PARKED_POS) leaves both arenas and its scalars bit for bit."""
    _, (_, _, tm, tp) = models["dense"]
    eng = _engine(tserving, tm, tm.cfg, tp, kv_format=fmt,
                  speculative=tserving.SpecConfig(draft=tm.cfg, k=3))
    for _ in range(50):
        running = [st for st in eng.scheduler.running.values()
                   if st.status == Status.RUNNING]
        if running and any(st.status == Status.PREFILLING
                           for st in eng.scheduler.running.values()):
            break
        eng.step()
    st = running[0]
    if sampled:
        sampling.write_slot(eng._samp, st.slot, tserving.SamplingParams(
            temperature=0.8, top_k=20, top_p=0.9, seed=3), 3)
    start = st.prompt_len + len(st.generated) - 1
    tokens, step = eng._verify_runner(3, sampled)
    eng._stage(tokens, [[st.generated[-1], 5, 7]])
    eng._stage(eng._vscalars, [st.slot, start])
    model = eng.model
    before = {s: _slot_rows(model, eng._cache, s)
              for s in range(eng.max_slots)}
    with NoHostRead():
        draws, ok = step()
    assert draws.shape == (3,) and draws.dtype == torch.int64
    assert ok.shape == () and bool(ok)
    for s, rows in before.items():
        for k, v in _slot_rows(model, eng._cache, s).items():
            if s == st.slot:
                v, rows_k = v[:, :, :start], rows[k][:, :, :start]
            else:
                rows_k = rows[k]
            assert torch.equal(v.view(torch.uint8),
                               rows_k.view(torch.uint8)), (s, k)
    state = {**{f"cache.{k}": v for k, v in eng._cache.items()},
             **{f"draft.{k}": v for k, v in eng._draft_cache.items()},
             "scalars": eng._vscalars}
    snap = {k: v.clone().view(torch.uint8) for k, v in state.items()}
    graphs.parked_chunk_warm_up(step, eng._vscalars)
    for k, v in state.items():
        assert torch.equal(v.view(torch.uint8), snap[k]), k
    assert (3, sampled) in eng._verify_keys and not eng.verify_graphs
    with pytest.raises(ValueError, match="CUDA"):
        graphs.ChunkGraph(step, eng._vscalars, kind="verify")
