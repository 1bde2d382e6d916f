"""The serving engine's captured decode step (``runtime/serving/graphs.py``)
on the CPU, where nothing is captured: what capture relies on.

  * the step the graph captures (``ServingEngine._decode_step``) makes no
    host read, with live, parked (mid-chunked-prefill) and never-used slots
    side by side, in the dense and the ssm family;
  * the parked warm-up that precedes capture leaves the arena, the SSD and
    conv state and the slot vectors as they were, bit for bit, and the run
    that goes on afterwards still matches the JAX package's engine token
    for token;
  * ``EngineConfig.decode_graph`` on the CPU: the step is always eager;
  * the same for the sampled step (``ServingEngine._decode_step_sampled``,
    the second graph): no host read, and its parked warm-up leaves the
    arena, the slot vectors and the five sampling vectors bit for bit;
  * both steps over a narrow KV arena (bf16, int8, fp8): the quantized
    row writes and the scale writes make no host read either, and the
    warm-ups leave the scale leaves bit for bit.

The captured graph itself runs on the card only (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.layers import PARKED_POS  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import graphs  # noqa: E402
from repro_torch.runtime.serving.request import Status  # noqa: E402

from test_torch_model import TINY, bridged  # noqa: E402
from test_torch_ssm import TINY_SSM, ssm_bridged  # noqa: E402

#: ops that copy a device value to the host (a graph cannot hold them)
HOST_READS = ("_local_scalar_dense", "item", "nonzero", "masked_select",
              "unique")


def _bool_index(name, args) -> bool:
    """An index / index_put with a boolean mask: its kernel counts the mask
    on the host (a nonzero below the dispatcher, which the mode never
    sees)."""
    return name.startswith("index") and len(args) > 1 and any(
        isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
        for t in (args[1] if isinstance(args[1], (list, tuple)) else ()))


# live, parked and never-used slots side by side: 4 slots, 3 requests, one
# prompt long enough to stay mid-prefill for many steps at 4 tokens a step
MIXED = dict(max_slots=4, max_seq=64, depth=2, prefill_chunks=(4, 8),
             prefill_budget=4)
LENS, GENS = (5, 30, 6), (10, 6, 10)


class NoHostRead(TorchDispatchMode):
    """Raises on every aten op that reads a tensor's value on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        if any(r in name for r in HOST_READS) or _bool_index(name, args):
            raise AssertionError(f"host read in the captured step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", params=["dense", "ssm"])
def family(request):
    """(JAX config, (jax model, jax params, port model, port params))."""
    if request.param == "dense":
        return TINY, bridged(TINY)
    return TINY_SSM, ssm_bridged(TINY_SSM)


def _engine(mod, model, cfg, params, **kw):
    eng = mod.ServingEngine(model, cfg, params,
                            config=mod.EngineConfig(**{**MIXED, **kw}))
    rng = np.random.default_rng(0)
    for i, (n, g) in enumerate(zip(LENS, GENS)):
        eng.submit(mod.Request(uid=i, prompt=rng.integers(0, cfg.vocab, n),
                               max_new_tokens=g))
    return eng


def _mixed_engine(family):
    """A port engine stepped until decoding, prefilling and unused slots
    coexist (its arena rows / states are then non-zero)."""
    _, (_, _, tm, tp) = family
    eng = _engine(tserving, tm, tm.cfg, tp)
    for _ in range(50):
        states = [st.status for st in eng.scheduler.running.values()]
        if Status.RUNNING in states and Status.PREFILLING in states:
            break
        eng.step()
    pos, active = eng._pos.tolist(), eng._active.tolist()
    assert PARKED_POS in pos and 1 in active, (pos, active)
    assert any(a == 0 and p != PARKED_POS for p, a in zip(pos, active)), \
        (pos, active)
    return eng


def _snapshot(eng) -> dict:
    """Every tensor of the engine's state, as raw bytes."""
    state = {f"cache.{k}": v for k, v in eng._cache.items()}
    state.update(tokens=eng._tokens, pos=eng._pos, active=eng._active)
    return {k: v.detach().clone().view(torch.uint8) for k, v in state.items()}


def test_guard_refuses_host_reads():
    """The guard itself: each kind of host read raises under it."""
    x = torch.arange(6.0)
    reads = (lambda: x.sum().item(), lambda: torch.nonzero(x),
             lambda: x[x > 2], lambda: x.__setitem__(x > 2, 1.0),
             lambda: torch.masked_select(x, x > 2),
             lambda: torch.unique(x), lambda: int(x[0]))
    for read in reads:
        with pytest.raises(AssertionError, match="host read"):
            with NoHostRead():
                read()


def test_decode_step_makes_no_host_read(family):
    """(a) The function the graph captures runs through with no host read,
    live, parked and never-used slots side by side; and it advances only
    the live slots."""
    eng = _mixed_engine(family)
    live = eng._active.clone() == 1
    pos0 = eng._pos.clone()
    with NoHostRead():
        out = eng._decode_step()
    # one readback: the tokens over the per-slot finite flags
    assert out.shape == (2, eng.max_slots) and out.dtype == torch.int64
    assert out[1].tolist() == [1] * eng.max_slots
    assert torch.equal(eng._pos, pos0 + live.long())


def test_parked_warm_up_leaves_no_trace(family):
    """(b) The parked warm-up on a mid-run engine leaves the arena (dense
    rows; ssm state and conv tail), tokens, positions and active flags bit
    for bit as they were, and the run then still matches the JAX engine."""
    jcfg, (jm, jp, _, _) = family
    eng = _mixed_engine(family)
    before = _snapshot(eng)
    graphs.parked_warm_up(eng._decode_step, eng._tokens, eng._pos,
                          eng._active)
    after = _snapshot(eng)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    got = eng.run(max_steps=2000)
    want = _engine(jserving, jm, jcfg, jp).run(max_steps=2000)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")


def test_decode_graph_field_rules(family):
    """(c) On the CPU the step runs eagerly whatever ``decode_graph`` says
    (the default, True, captures only on the card); the CLI's
    ``--no-decode-graph`` clears the field; a DecodeGraph refuses CPU
    tensors."""
    _, (_, _, tm, tp) = family
    assert tserving.EngineConfig().decode_graph is True
    for kw in ({}, {"decode_graph": True}, {"decode_graph": False}):
        eng = _engine(tserving, tm, tm.cfg, tp, **kw)
        assert eng.graph is None and eng._greedy_step == eng._decode_step
    base = ["--arch", "llama3.2-3b"]
    assert serve.parse_args(base).decode_graph is True
    assert serve.parse_args(base + ["--no-decode-graph"]).decode_graph \
        is False
    with pytest.raises(ValueError, match="CUDA"):
        graphs.DecodeGraph(eng._decode_step, eng._tokens, eng._pos,
                           eng._active)


def test_add_launches_adds_to_the_named_counters():
    """A replay's launches reach ``ops.launch_counts()``; other kernels'
    counts stay."""
    before = ops.launch_counts()
    ops.add_launches({"flash_decode": 28, "ssd": 2})
    after = ops.launch_counts()
    ops.add_launches({"flash_decode": -28, "ssd": -2})
    assert after == {**before, "flash_decode": before["flash_decode"] + 28,
                     "ssd": before["ssd"] + 2}
    assert ops.launch_counts() == before


# requests 0 and 2 sample (different knobs), request 1 is greedy
SAMPLED = ({"temperature": 0.8, "top_k": 20, "top_p": 0.9, "min_p": 0.05,
            "seed": 5}, None, {"temperature": 1.2, "top_p": 0.95})


def _sampled_engine(mod, model, cfg, params, **kw):
    eng = mod.ServingEngine(model, cfg, params,
                            config=mod.EngineConfig(**{**MIXED, **kw}))
    rng = np.random.default_rng(0)
    for i, (n, g, sp) in enumerate(zip(LENS, GENS, SAMPLED)):
        eng.submit(mod.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, n), max_new_tokens=g,
            sampling=mod.SamplingParams(**sp) if sp else mod.GREEDY))
    return eng


def _mixed_sampled_engine(family):
    """A port engine stepped until a sampled slot decodes beside a
    prefilling one (and an unused slot)."""
    _, (_, _, tm, tp) = family
    eng = _sampled_engine(tserving, tm, tm.cfg, tp)
    for _ in range(50):
        states = [st.status for st in eng.scheduler.running.values()]
        if Status.RUNNING in states and Status.PREFILLING in states:
            break
        eng.step()
    assert PARKED_POS in eng._pos.tolist() and (eng._samp["temp"] > 0).any()
    return eng


def test_sampled_decode_step_makes_no_host_read(family):
    """The sampled step (decode + masked_logits + Gumbel draw over the five
    slot vectors) runs through with no host read and advances only the live
    slots."""
    eng = _mixed_sampled_engine(family)
    live = eng._active.clone() == 1
    pos0 = eng._pos.clone()
    with NoHostRead():
        out = eng._decode_step_sampled()
    assert out.shape == (2, eng.max_slots) and out.dtype == torch.int64
    assert out[1].tolist() == [1] * eng.max_slots
    assert torch.equal(eng._pos, pos0 + live.long())


def test_sampled_parked_warm_up_leaves_no_trace(family):
    """The sampled step's parked warm-up on a mid-run engine leaves the
    arena, the slot vectors and the sampling vectors bit for bit, and the
    run then still matches the JAX engine's sampled streams."""
    jcfg, (jm, jp, _, _) = family
    eng = _mixed_sampled_engine(family)
    before = _snapshot(eng)
    before.update({f"samp.{k}": v.clone().view(torch.uint8)
                   for k, v in eng._samp.items()})
    graphs.parked_warm_up(eng._decode_step_sampled, eng._tokens, eng._pos,
                          eng._active)
    after = _snapshot(eng)
    after.update({f"samp.{k}": v.clone().view(torch.uint8)
                  for k, v in eng._samp.items()})
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    got = eng.run(max_steps=2000)
    want = _sampled_engine(jserving, jm, jcfg, jp).run(max_steps=2000)
    assert eng.stats["sampled_steps"] > 0
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")


def test_sampled_step_is_eager_on_the_cpu(family):
    """On the CPU no graph is captured: the sampled step is the eager
    method, submitted through the same queue as the greedy one."""
    _, (_, _, tm, tp) = family
    for kw in ({}, {"decode_graph": False}):
        eng = _sampled_engine(tserving, tm, tm.cfg, tp, **kw)
        assert eng.sampled_graph is None
        assert eng._sampled_step == eng._decode_step_sampled


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_narrow_arena_steps_capture_cleanly(fmt):
    """A narrow KV arena in both captured steps: with live, parked and
    never-used slots side by side, the greedy and the sampled step make no
    host read (the quantized row writes and their scale writes included);
    their parked warm-ups leave every arena leaf (the scale leaves
    included), the slot vectors and the sampling vectors bit for bit; the
    run then matches the JAX engine's streams in the same format."""
    jm, jp, tm, tp = bridged(TINY)

    def mixed():
        eng = _sampled_engine(tserving, tm, tm.cfg, tp, kv_format=fmt)
        for _ in range(50):
            states = [st.status for st in eng.scheduler.running.values()]
            if Status.RUNNING in states and Status.PREFILLING in states:
                break
            eng.step()
        assert PARKED_POS in eng._pos.tolist()
        return eng

    eng = mixed()
    assert ("k_scale" in eng._cache) == (fmt != "bf16")
    for step in (eng._decode_step, eng._decode_step_sampled):
        live = eng._active.clone() == 1
        pos0 = eng._pos.clone()
        with NoHostRead():
            step()
        assert torch.equal(eng._pos, pos0 + live.long())
    eng = mixed()
    for step in (eng._decode_step, eng._decode_step_sampled):
        before = _snapshot(eng)
        before.update({f"samp.{k}": v.clone().view(torch.uint8)
                       for k, v in eng._samp.items()})
        graphs.parked_warm_up(step, eng._tokens, eng._pos, eng._active)
        after = _snapshot(eng)
        after.update({f"samp.{k}": v.clone().view(torch.uint8)
                      for k, v in eng._samp.items()})
        for k in before:
            assert torch.equal(before[k], after[k]), k
    got = eng.run(max_steps=2000)
    want = _sampled_engine(jserving, jm, TINY, jp,
                           kv_format=fmt).run(max_steps=2000)
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")


def _spec_engine(fmt="fp32"):
    """A speculative port engine (the target as its own draft) over the
    mixed requests, stepped until a sampled slot runs beside a prefilling
    one and an unused slot; the draft's token and position vectors staged
    as a round stages them (parked for every slot but the running ones)."""
    _, _, tm, tp = bridged(TINY)
    eng = _sampled_engine(tserving, tm, tm.cfg, tp, kv_format=fmt,
                          speculative=tserving.SpecConfig(draft=tm.cfg, k=3))
    for _ in range(50):
        states = {st.status: st for st in eng.scheduler.running.values()}
        if Status.RUNNING in states and Status.PREFILLING in states:
            break
        eng.step()
    running = [st for st in eng.scheduler.running.values()
               if st.status == Status.RUNNING]
    assert running and len(eng.scheduler.running) < eng.max_slots
    tok = np.zeros(eng.max_slots, np.int64)
    pos = np.full(eng.max_slots, PARKED_POS, np.int64)
    for st in running:
        tok[st.slot] = st.generated[-1]
        pos[st.slot] = st.prompt_len + len(st.generated) - 1
    eng._stage(eng._dtok, tok)
    eng._stage(eng._dpos, pos)
    return eng


def _draft_state(eng) -> dict:
    state = {f"draft.{k}": v for k, v in eng._draft_cache.items()}
    state.update({f"cache.{k}": v for k, v in eng._cache.items()})
    state.update({f"samp.{k}": v for k, v in eng._samp.items()})
    state.update(dtok=eng._dtok, dpos=eng._dpos)
    return {k: v.detach().clone().view(torch.uint8)
            for k, v in state.items()}


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_draft_step_makes_no_host_read(fmt, sampled):
    """The speculative draft's micro-step, greedy and sampled (what the
    draft graphs capture), makes no host read with running, parked and
    never-used slots side by side, feeds its proposals back and advances
    every position by one; its parked warm-up leaves both arenas, the
    sampling vectors and the draft's vectors bit for bit; the run then
    still equals the plain engine's streams."""
    eng = _spec_engine(fmt)
    step = eng._draft_step_sampled if sampled else eng._draft_step
    pos0 = eng._dpos.clone()
    with NoHostRead():
        out = step()
    assert out.shape == (eng.max_slots,) and torch.equal(eng._dtok, out)
    assert torch.equal(eng._dpos, pos0 + 1)
    before = _draft_state(eng)
    graphs.parked_warm_up(step, eng._dtok, eng._dpos)
    after = _draft_state(eng)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    got = eng.run(max_steps=2000)
    _, _, tm, tp = bridged(TINY)
    want = _sampled_engine(tserving, tm, tm.cfg, tp,
                           kv_format=fmt).run(max_steps=2000)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"request {uid}")
    assert eng.draft_graph is None and eng.sampled_draft_graph is None
    assert eng._draft_greedy == eng._draft_step
    assert eng._draft_sampled == eng._draft_step_sampled
