"""Parity of the port's ssm family with the JAX package: the plain SSD scan
(against ``ops.ssd`` in interpret and ref mode and the per-step oracle
``ref.ssd``), the Mamba2 layer pieces, the LM drivers and the serving
engine, on the tiny f32 ssm regime (tests/test_serving.py:216) with the
same numpy-made weights and inputs handed to both packages.

Tolerances (f32): the scan and the layer pieces at 2e-5 absolute + 2e-5
relative (two implementations of the same f32 sums in another order),
LM logits at 1e-4 (two layers of them), greedy streams identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig, SSMConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as JS  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TS  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

from test_torch_model import numpy_params, port_cfg  # noqa: E402

TINY_SSM = ArchConfig(name="tiny-ssm", family="ssm", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=97,
                      ssm=SSMConfig(d_state=8, headdim=8, chunk=16),
                      param_dtype="float32", act_dtype="float32",
                      subquadratic=True, max_seq=64)
TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _scan_inputs(seed, bh, s, p, n, decay=0.1):
    rng = np.random.default_rng(seed)
    return (_rand(rng, bh, s, p), -np.abs(_rand(rng, bh, s)) * decay,
            _rand(rng, bh, s, n), _rand(rng, bh, s, n),
            _rand(rng, bh, n, p))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("s", [64, 48, 1, 20])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_plain_matches_jax(mode, s, chunk, with_state):
    """ops.ssd on CPU tensors (the plain scan) against the reference's
    ops.ssd in ``mode`` and the per-step oracle ref.ssd: y and the final
    state, ragged S (every S below but 64 with chunk 64) included."""
    x, la, B, C, st = _scan_inputs(s + chunk, 3, s, 16, 8)
    init = st if with_state else None
    want_y, want_st = jops.ssd(*_j(x, la, B, C), chunk=chunk, mode=mode,
                               initial_state=None if init is None
                               else jnp.asarray(init))
    got_y, got_st = ops.ssd(*_t(x, la, B, C), chunk=chunk,
                            initial_state=None if init is None
                            else torch.from_numpy(init))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), **TOL)
    oy, ost = jax.vmap(jref.ssd)(*_j(x, la, B, C),
                                 jnp.zeros((3, 8, 16)) if init is None
                                 else jnp.asarray(init))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(oy), **TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(ost), **TOL)


@pytest.mark.parametrize("split", [32, 20])
def test_ssd_state_chaining(split):
    """A split run threaded through ``initial_state`` equals the whole run
    (the reference's test_ssd_chunked_state_chaining), also at a split
    that is no multiple of the chunk."""
    x, la, B, C, _ = _scan_inputs(7, 2, 64, 8, 4, decay=0.2)
    x, la, B, C = _t(x, la, B, C)
    y_full, st_full = ops.ssd(x, la, B, C, chunk=16)
    y1, st1 = ops.ssd(x[:, :split], la[:, :split], B[:, :split],
                      C[:, :split], chunk=16)
    y2, st2 = ops.ssd(x[:, split:], la[:, split:], B[:, split:],
                      C[:, split:], chunk=16, initial_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), **TOL)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), **TOL)


def test_ssd_shared_bc_rows_equal_repeated():
    """B/C with one row per group of r consecutive x rows (n_groups <
    n_heads) equal the per-row repeat the reference materialises."""
    x, la, B, C, st = _scan_inputs(3, 6, 20, 8, 4)
    x, la, B, C, st = _t(x, la, B, C, st)
    got = ops.ssd(x, la, B[:2], C[:2], chunk=16, initial_state=st)
    want = ops.ssd(x, la, B[:2].repeat_interleave(3, 0),
                   C[:2].repeat_interleave(3, 0), chunk=16, initial_state=st)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd(x, la, B[:4], C[:4])


def test_ssd_decode_step_matches_scan_and_jax():
    x, la, B, C, st = _scan_inputs(5, 2, 8, 4, 4, decay=0.2)
    y_scan, st_scan = ops.ssd(*_t(x, la, B, C), chunk=4,
                              initial_state=torch.from_numpy(st))
    state, jstate, outs = torch.from_numpy(st), jnp.asarray(st), []
    for t in range(8):
        y_t, state = ops.ssd_decode_step(*_t(x[:, t], la[:, t], B[:, t],
                                             C[:, t]), state)
        jy, jstate = jops.ssd_decode_step(*_j(x[:, t], la[:, t], B[:, t],
                                              C[:, t]), jstate)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy), **TOL)
        outs.append(y_t)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), y_scan.numpy(),
                               **TOL)
    np.testing.assert_allclose(state.numpy(), st_scan.numpy(), **TOL)


# ---------------------------------------------------------------------------
# Mamba2 layer pieces
# ---------------------------------------------------------------------------

def ssm_numpy_params(cfg, seed=0):
    """numpy_params with the ssm leaves drawn like the reference's:
    dt_bias the inverse softplus of dt in [1e-3, 1e-1], A_log small, D
    near 1."""
    tree = numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    m = tree["layers"]["mamba"]
    shape = m["A_log"].shape
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    m["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    m["A_log"] = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    m["D"] = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    m["conv"] = (0.5 * m["conv"]).astype(np.float32)
    return tree


def ssm_bridged(cfg, seed=0):
    """(jax model, jax params, port model, port params) on the same
    numpy-made weights."""
    tree = ssm_numpy_params(cfg, seed)
    jm = jreg.build_model(cfg)
    tcfg = port_cfg(cfg)
    return (jm, jax.tree.map(jnp.asarray, tree),
            treg.build_model(tcfg, device="cpu"),
            convert.params_from_numpy(tree, tcfg, "cpu"))


@pytest.fixture(scope="module")
def tiny():
    return ssm_bridged(TINY_SSM)


def _layer0(tree):
    """Layer 0 of a stacked parameter tree (either package's leaves)."""
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("nvalid", [None, 3, 1])
def test_mamba_apply_matches_jax(tiny, carry, nvalid):
    """mamba_apply's output, state and conv tail, with and without the
    carried (state, conv tail) and the pad mask ``nvalid``."""
    jm, jp, tm, tp = tiny
    cfg, tcfg = TINY_SSM, tm.cfg
    jl, tl = _layer0(jp["layers"]["mamba"]), _layer0(tp["layers"]["mamba"])
    rng = np.random.default_rng(11)
    x = _rand(rng, 1, 8, cfg.d_model)
    nh, w = cfg.ssm.n_heads(cfg.d_model), cfg.ssm.conv_width - 1
    ch = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
    st = 0.5 * _rand(rng, nh, cfg.ssm.d_state, cfg.ssm.headdim)
    tail = _rand(rng, 1, w, ch)
    jkw = dict(return_state=True, nvalid=nvalid)
    tkw = dict(return_state=True, nvalid=nvalid)
    if carry:
        jkw.update(initial_state=jnp.asarray(st), conv_tail=jnp.asarray(tail))
        tkw.update(initial_state=torch.from_numpy(st),
                   conv_tail=torch.from_numpy(tail))
    jy, (jst, jtail) = JS.mamba_apply(jl, cfg, jnp.asarray(x), **jkw)
    ty, (tst, ttail) = TS.mamba_apply(tl, tcfg, torch.from_numpy(x), **tkw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
    np.testing.assert_allclose(ttail.numpy(), np.asarray(jtail), **TOL)
    if not carry and nvalid is None:
        # return_state only adds the state: the output is the same
        assert torch.equal(TS.mamba_apply(tl, tcfg, torch.from_numpy(x)), ty)


def test_mamba_decode_step_matches_jax(tiny):
    jm, jp, tm, tp = tiny
    cfg, tcfg = TINY_SSM, tm.cfg
    jl, tl = _layer0(jp["layers"]["mamba"]), _layer0(tp["layers"]["mamba"])
    rng = np.random.default_rng(12)
    nh = cfg.ssm.n_heads(cfg.d_model)
    ch = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
    cache = {"ssm": 0.5 * _rand(rng, 2 * nh, cfg.ssm.d_state,
                                cfg.ssm.headdim),
             "conv": _rand(rng, 2, cfg.ssm.conv_width - 1, ch)}
    x = _rand(rng, 2, cfg.d_model)
    jy, jc = JS.mamba_decode_step(jl, cfg, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in cache.items()})
    ty, tc = TS.mamba_decode_step(tl, tcfg, torch.from_numpy(x),
                                  {k: torch.from_numpy(v)
                                   for k, v in cache.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in cache:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


def test_causal_conv_with_tail_matches_jax():
    rng = np.random.default_rng(13)
    x, w, tail = _rand(rng, 2, 5, 6), _rand(rng, 4, 6), _rand(rng, 2, 3, 6)
    for t in (None, tail):
        want = JS._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                         None if t is None else jnp.asarray(t))
        got = TS._causal_depthwise_conv(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        None if t is None
                                        else torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the LM drivers
# ---------------------------------------------------------------------------

def test_prefill_decode_logits_and_state(tiny):
    """Monolithic prefill + 6 greedy decode steps: logits within 1e-4 at
    every step, identical tokens, and the arena state."""
    jm, jp, tm, tp = tiny
    prompt = np.random.default_rng(3).integers(0, 97, 11).astype(np.int32)
    jc = jm.init_cache(1, 64)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompt)[None], jc)
    tc = tm.init_cache(1, 64)
    tlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=LOGIT_TOL)
    step = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)
    pos = len(prompt)
    for _ in range(6):
        assert int(jtok[0]) == int(ttok[0])
        jlog, jc = step(jp, jtok, jc, jnp.asarray([pos], jnp.int32))
        tlog = tm.decode_step(tp, ttok, tc, torch.tensor([pos]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)
        pos += 1


def _chunks(prompt, size):
    for start in range(0, len(prompt), size):
        real = min(size, len(prompt) - start)
        chunk = np.zeros(size, np.int32)
        chunk[:real] = prompt[start:start + real]
        yield start, chunk, real


def test_prefill_chunk_logits_and_state(tiny):
    """Chunks of 8 (the last padded) into slot 1 of a 2-slot arena whose
    slot 1 holds a stale state: logits and the slot's state within 1e-4
    of the reference, slot 0 untouched, and the state equal to monolithic
    prefill's."""
    jm, jp, tm, tp = tiny
    prompt = np.random.default_rng(4).integers(0, 97, 13).astype(np.int32)
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    tc["ssm"].fill_(0.25)
    tc["conv"].fill_(-1.0)
    jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
    before0 = {k: v.clone() for k, v in tm.slot_view(tc, 0).items()}
    fn = jax.jit(jm.prefill_chunk)
    for start, chunk, real in _chunks(prompt, 8):
        jlog, jc = fn(jp, jnp.asarray(chunk)[None], jc, jnp.int32(1),
                      jnp.int32(start), jnp.int32(real - 1))
        tlog = tm.prefill_chunk(tp, torch.from_numpy(chunk).long()[None], tc,
                                1, start, real - 1)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=LOGIT_TOL)
        assert torch.equal(tm.slot_view(tc, 0)[k], before0[k])
    mono = tm.init_cache(1, 64)
    mlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], mono)
    np.testing.assert_allclose(tlog.numpy(), mlog.numpy(), atol=LOGIT_TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(tm.slot_view(tc, 1)[k].numpy(),
                                   mono[k].numpy(), **TOL)
    with pytest.raises(ValueError):
        tm.prefill_chunk(tp, torch.zeros((1, 8), dtype=torch.long), tc, 2, 0,
                         7)


def test_parked_slot_state_bit_identical(tiny):
    """Decode steps with slot 1 parked mid-chunked-prefill leave its state
    and conv tail bit for bit; slot 0 moves."""
    _, _, tm, tp = tiny
    tc = tm.init_cache(2, 64)
    prompt = torch.arange(8)[None] % 97
    tm.prefill_chunk(tp, prompt, tc, 1, 0, 7)
    tm.prefill_chunk(tp, prompt, tc, 0, 0, 7)
    before = {k: v.clone() for k, v in tc.items()}
    for i in range(3):
        tm.decode_step(tp, torch.tensor([5, 6]), tc,
                       torch.tensor([8 + i, TL.PARKED_POS]))
    for k in tc:
        assert torch.equal(tm.slot_view(tc, 1)[k],
                           tm.slot_view(before, 1)[k]), k
        assert not torch.equal(tm.slot_view(tc, 0)[k],
                               tm.slot_view(before, 0)[k]), k


def test_plain_namespace_model_is_the_cpu_path(tiny):
    _, _, tm, tp = tiny
    plain = treg.build_model(tm.cfg, device="cpu", kernels=ops.PLAIN)
    prompt = torch.arange(9)[None] % 97
    a = tm.prefill(tp, prompt, tm.init_cache(1, 16))
    b = plain.prefill(tp, prompt, plain.init_cache(1, 16))
    assert torch.equal(a, b)


def test_ssm_cache_layout_and_formats(tiny):
    _, _, tm, _ = tiny
    cache = tm.init_cache(3, 64)
    nh = TINY_SSM.ssm.n_heads(TINY_SSM.d_model)
    assert tuple(cache["ssm"].shape) == (2, 3 * nh, 8, 8)
    assert tuple(cache["conv"].shape) == (2, 3, 3, 64 + 16)
    assert cache["ssm"].dtype == torch.float32
    assert tm.num_slots(cache) == 3 and tm.has_recurrent_state
    view = tm.slot_view(cache, 2)
    assert tuple(view["ssm"].shape) == (2, nh, 8, 8)
    view["ssm"].fill_(1.0)
    assert cache["ssm"][:, 2 * nh:].eq(1).all()
    assert cache["ssm"][:, :2 * nh].eq(0).all()
    with pytest.raises(ValueError, match="full precision"):
        tm.init_cache(1, 8, kv_format="int8")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_bridge_round_trip_keeps_f32_leaves():
    """The ssm tree converts leaf for leaf; at a bf16 param dtype A_log,
    dt_bias and D stay float32, everything else is bf16; the port's own
    init has the same tree, shapes and dtypes."""
    cfg = dataclasses.replace(TINY_SSM, param_dtype="bfloat16",
                              act_dtype="bfloat16")
    tree = ssm_numpy_params(cfg)
    tcfg = port_cfg(cfg)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    flat = convert._flatten(tp)
    for path, arr in convert._flatten(tree).items():
        want_dt = (torch.float32 if path in convert.F32_LEAVES
                   else torch.bfloat16)
        assert flat[path].dtype == want_dt, path
        np.testing.assert_array_equal(
            flat[path].float().numpy(),
            torch.from_numpy(arr).to(want_dt).float().numpy())
    jflat = convert._flatten(jax.eval_shape(
        lambda: jreg.build_model(cfg).init(jax.random.PRNGKey(0))))
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        convert.expected_shapes(tcfg)
    assert {k: str(v.dtype) for k, v in jflat.items()} == \
        {k: str(v.dtype).replace("torch.", "") for k, v in flat.items()}
    own = treg.build_model(tcfg, device="cpu").init(0)
    oflat = convert._flatten(own)
    assert {k: (tuple(v.shape), v.dtype) for k, v in oflat.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}
    with pytest.raises(ValueError, match="mismatch"):
        convert.params_from_numpy({"embed": tree["embed"]}, tcfg, "cpu")


def test_port_init_distributions():
    cfg = port_cfg(TINY_SSM)
    p = treg.build_model(cfg, device="cpu").init(0)["layers"]["mamba"]
    assert torch.equal(p["A_log"], torch.zeros_like(p["A_log"]))
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    assert abs(p["w_z"].std().item() - cfg.d_model ** -0.5) < 0.03


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _serve(models, lens, gens, **cfg):
    jm, jp, tm, tp = models
    outs, stats = [], []
    for mod, model, params in ((jserving, jm, jp), (tserving, tm, tp)):
        eng = mod.ServingEngine(model, TINY_SSM if mod is jserving
                                else tm.cfg, params,
                                config=mod.EngineConfig(**cfg))
        rng = np.random.default_rng(0)
        for i, (n, g) in enumerate(zip(lens, gens)):
            eng.submit(mod.Request(uid=i, prompt=rng.integers(0, 97, n),
                                   max_new_tokens=g))
        outs.append(eng.run(max_steps=2000))
        stats.append(eng.scheduler.stats)
    want, got = outs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
    assert {k: stats[0][k] for k in stats[1]} == stats[1]
    return stats[1]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_engine_streams_match_jax(tiny, depth, chunks):
    """Staggered admission (slots < requests), mixed prompt/gen lengths."""
    _serve(tiny, (5, 9, 7, 12), (8, 6, 10, 7), max_slots=2, max_seq=64,
           depth=depth, prefill_chunks=chunks)


@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_engine_preemption_replay_matches_jax(tiny, chunks):
    """--page-size 4 --pages 14: the youngest request is preempted and its
    state re-derived by replaying the prompt — identically in both."""
    stats = _serve(tiny, (20, 15, 20, 15, 20), (12,) * 5, max_slots=2,
                   max_seq=64, depth=2, page_size=4, num_pages=14,
                   prefill_chunks=chunks)
    assert stats["preempted"] > 0


def test_engine_reports_state_bytes_per_slot(tiny):
    _, _, tm, tp = tiny
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(max_slots=3,
                                                              max_seq=40))
    per_slot = sum(v[:, :v.shape[1] // 3].numel() * v.element_size()
                   for v in eng._cache.values())
    assert eng.stats["state_bytes_per_slot"] == per_slot
    assert "kv_row_bytes" not in eng.stats


@pytest.mark.parametrize("mode", ["monolithic", "chunked"])
def test_serve_cli_mamba2_on_cpu(capsys, mode):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12", "--gen", "4",
                       "--slots", "2", "--prefill-mode", mode,
                       "--chunk-buckets", "4,8"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "state bytes/slot" in out
    assert "'ssd': 0" in out


def test_two_groups_decode_equals_prefill():
    """n_groups = 2 (each B/C group shared by 4 of the 8 heads): a decode
    step after prefilling S - 1 tokens gives the logits and state of
    prefilling all S — the port maps head h to group h // 4 in both (the
    reference's decode step reads group 0 for every head)."""
    cfg = port_cfg(dataclasses.replace(
        TINY_SSM, ssm=SSMConfig(d_state=8, headdim=8, chunk=16, n_groups=2)))
    tm = treg.build_model(cfg, device="cpu")
    tp = tm.init(3)
    prompt = torch.from_numpy(
        np.random.default_rng(9).integers(0, 97, 10))[None]
    full, part = tm.init_cache(1, 16), tm.init_cache(1, 16)
    want = tm.prefill(tp, prompt, full)
    tm.prefill(tp, prompt[:, :-1], part)
    got = tm.decode_step(tp, prompt[:, -1], part, torch.tensor([9]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGIT_TOL)
    for k in full:
        np.testing.assert_allclose(part[k].numpy(), full[k].numpy(), **TOL)
