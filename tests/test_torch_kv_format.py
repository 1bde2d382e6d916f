"""The port's narrow KV formats against the JAX package on the same numpy
inputs:

  * ``core/kv_format.py``: the registry, ``quantize`` / ``dequantize`` /
    ``bytes_per_row`` bit for bit for every format;
  * the fused-dequant branch of ``flash_decode`` and
    ``flash_prefill_chunk`` (int8 and fp8 arenas with their scales): the
    port's plain versions against ``repro.kernels.ops`` in ``ref`` and
    ``interpret`` mode at the reference test's shapes
    (tests/test_kv_format.py:212-240), atol 2e-5;
  * the arena: ``init_kv_cache`` leaves, ``kv_cache_format``, the engine's
    ``kv_row_bytes`` / ``arena_bytes`` and its page accountant's scale
    sidecar, which drains to 0 as the reference's does;
  * the engine: token streams equal ``ServingEngine``'s for bf16, int8 and
    fp8, monolithic and chunked prefill, dispatch depth 0 and 2, greedy
    and half sampled, on the tiny f32 regime; ``tolerance.measure``'s
    report equal to the reference's; a recurrent family refusing int8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kv_format as jkvf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime.serving import tolerance as jtolerance  # noqa: E402
from repro_torch.core import kv_format as tkvf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import tolerance as ttolerance  # noqa: E402

from test_torch_model import TINY, bridged, port_cfg  # noqa: E402
from test_torch_ssm import TINY_SSM, ssm_bridged  # noqa: E402

FORMATS = ("fp32", "bf16", "int8", "fp8")
NARROW = ("bf16", "int8", "fp8")
SCALED = ("int8", "fp8")
ATOL = 2e-5
PARKED = (1 << 30) + 1


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and bits (numpy
    has no fp8 torch can read: fp8 goes through its bytes)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.uint8) if t.dtype != torch.int8 \
        else t.numpy()


# ---------------------------------------------------------------------------
# core/kv_format.py
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert tkvf.names() == jkvf.names() == FORMATS
    for name in FORMATS:
        t, j = tkvf.get(name), jkvf.get(name)
        assert (t.scaled, t.qmax) == (j.scaled, j.qmax), name
        if j.store_dtype is None:
            assert t.store_dtype is None
        else:
            assert str(t.store_dtype) == f"torch.{j.store_dtype}"
    with pytest.raises(ValueError, match="fp32"):
        tkvf.get("int7")


def _rows(seed, shape=(64, 8, 128)):
    """Rows of very different magnitudes, a zero row, a row with one
    nonzero element and ties at the rounding boundary."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 1e3,
                                                 shape[:-1] + (1,))
    x = x.astype(np.float32)
    x = x.reshape(-1, shape[-1])
    x[0] = 0.0
    x[1] = 0.0
    x[1, 3] = -2.5
    x[2] = np.linspace(-127.5, 127.5, shape[-1], dtype=np.float32)
    return x.reshape(shape)


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("shape", [(64, 8, 128), (3, 7, 2, 16)])
def test_quantize_dequantize_bit_for_bit(name, shape):
    x = _rows(len(shape), shape)
    jq, js = jkvf.quantize(jkvf.get(name), jnp.asarray(x))
    tq, ts = tkvf.quantize(tkvf.get(name), torch.from_numpy(x))
    assert tq.dtype == _to_torch(jq).dtype
    np.testing.assert_array_equal(_bits(tq), _bits(_to_torch(jq)))
    if js is None:
        assert ts is None
    else:
        assert ts.dtype == tkvf.SCALE_DTYPE and ts.shape == x.shape[:-1]
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        assert ts.numpy().reshape(-1)[0] == 1.0      # the zero row
    jd = jkvf.dequantize(jkvf.get(name), jq, js)
    td = tkvf.dequantize(tkvf.get(name), tq, ts)
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("kvh,hd", [(2, 16), (2, 8), (8, 128)])
def test_bytes_per_row_matches_reference(name, kvh, hd):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        assert tkvf.bytes_per_row(tkvf.get(name), kvh, hd, tdt) \
            == jkvf.bytes_per_row(jkvf.get(name), kvh, hd, jdt)


# ---------------------------------------------------------------------------
# the fused-dequant branch of flash_decode / flash_prefill_chunk
# ---------------------------------------------------------------------------

def _quantized_kv(rng, name, b, s, kvh, hd):
    """(JAX (kq, ks, vq, vs), port (kq, ks, vq, vs)) of one random arena,
    quantized by the reference."""
    fmt = jkvf.get(name)
    k = jnp.asarray(rng.standard_normal((b, s, kvh, hd)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, s, kvh, hd)), jnp.float32)
    kq, ks = jkvf.quantize(fmt, k)
    vq, vs = jkvf.quantize(fmt, v)
    jx = (kq, ks, vq, vs)
    return jx, tuple(_to_torch(a) for a in jx)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("name", SCALED)
def test_scaled_flash_decode_matches_jax(mode, window, name):
    rng = np.random.default_rng(0)
    B, H, KVH, S, hd = 3, 8, 2, 40, 16
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    (jkq, jks, jvq, jvs), (kq, ks, vq, vs) = _quantized_kv(rng, name, B, S,
                                                           KVH, hd)
    lengths = np.array([1, 17, 40], np.int32)
    want = jops.flash_decode(jnp.asarray(q), jkq, jvq,
                             lengths=jnp.asarray(lengths), window=window,
                             k_scale=jks, v_scale=jvs, mode=mode, bk=16)
    got = ops.flash_decode(torch.from_numpy(q), kq, vq,
                           lengths=torch.from_numpy(lengths), window=window,
                           k_scale=ks, v_scale=vs, bk=16)
    _close(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("name", SCALED)
def test_scaled_flash_decode_parked_and_full(mode, name):
    """A parked slot (length PARKED_POS + 1), a length of 1 and a full
    arena.  Sk is a multiple of bk: past the arena the reference also
    attends its zero strip padding, which the port never reads (ROADMAP
    §3)."""
    rng = np.random.default_rng(1)
    B, H, KVH, S, hd = 3, 8, 2, 48, 16
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    (jkq, jks, jvq, jvs), (kq, ks, vq, vs) = _quantized_kv(rng, name, B, S,
                                                           KVH, hd)
    lengths = np.array([PARKED, 1, S], np.int32)
    want = jops.flash_decode(jnp.asarray(q), jkq, jvq,
                             lengths=jnp.asarray(lengths), k_scale=jks,
                             v_scale=jvs, mode=mode, bk=16)
    got = ops.flash_decode(torch.from_numpy(q), kq, vq,
                           lengths=torch.from_numpy(lengths), k_scale=ks,
                           v_scale=vs, bk=16)
    _close(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("name", SCALED)
def test_scaled_flash_prefill_chunk_matches_jax(mode, window, name):
    rng = np.random.default_rng(2)
    B, C, H, KVH, S, hd = 3, 8, 8, 2, 40, 16
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    (jkq, jks, jvq, jvs), (kq, ks, vq, vs) = _quantized_kv(rng, name, B, S,
                                                           KVH, hd)
    prefix = np.array([0, 17, S - C], np.int32)
    want = jops.flash_prefill_chunk(jnp.asarray(q), jkq, jvq,
                                    prefix=jnp.asarray(prefix),
                                    window=window, k_scale=jks, v_scale=jvs,
                                    mode=mode, bk=16)
    got = ops.flash_prefill_chunk(torch.from_numpy(q), kq, vq,
                                  prefix=torch.from_numpy(prefix),
                                  window=window, k_scale=ks, v_scale=vs,
                                  bk=16)
    _close(got, want)


@pytest.mark.parametrize("name", SCALED)
def test_scaled_chunk_rows_equal_decode_rows(name):
    """The plain versions' pin, per format: chunk row j equals
    flash_decode at length prefix + j + 1 (to f32 rounding: both strip-mine
    the same rows, in other einsum shapes)."""
    rng = np.random.default_rng(3)
    B, C, H, KVH, S, hd = 1, 8, 4, 2, 40, 16
    q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(
        np.float32))
    _, (kq, ks, vq, vs) = _quantized_kv(rng, name, B, S, KVH, hd)
    chunk = ops.flash_prefill_chunk(q, kq, vq, prefix=torch.tensor([9]),
                                    k_scale=ks, v_scale=vs, bk=16)
    ex = lambda t: t.expand(C, *t.shape[1:])                     # noqa
    dec = ops.flash_decode(q[0], ex(kq), ex(vq),
                           lengths=torch.arange(C) + 10, k_scale=ex(ks),
                           v_scale=ex(vs), bk=16)
    torch.testing.assert_close(chunk[0], dec, atol=1e-6, rtol=0)


def test_kernel_wrappers_refuse_mismatched_scales():
    """The CUDA wrappers' operand contract (checked before any launch):
    scales go with an int8 / fp8 arena and only with one."""
    from repro_torch.kernels import _build
    k8 = torch.zeros(2, 5, 2, 16, dtype=torch.int8)
    kb = torch.zeros(2, 5, 2, 16, dtype=torch.bfloat16)
    sc = torch.ones(2, 5, 2)
    assert _build.scales(k8, sc, sc) == 1
    assert _build.scales(kb, None, None) == 0
    for args in ((k8, None, None), (kb, sc, sc), (k8, sc, None),
                 (k8, sc[:, :4], sc[:, :4]), (k8, sc.double(), sc)):
        with pytest.raises(ValueError):
            _build.scales(*args)
    assert _build.kv_codes(torch.zeros(1), k8, k8) == (0, 2)
    assert _build.kv_codes(kb, k8.view(torch.float8_e4m3fn),
                           k8.view(torch.float8_e4m3fn)) == (1, 3)
    with pytest.raises(TypeError):
        _build.kv_codes(kb, torch.zeros(1), torch.zeros(1))


def test_narrow_rows_are_made_tma_ready():
    """An int8 arena under bf16 queries is read in place when TMA can read
    it; rows of 8 bytes (head_dim 8) are copied into 16-byte rows."""
    from repro_torch.kernels import _build
    q = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    k = torch.randint(-5, 5, (3, 2, 40, 2, 16), dtype=torch.int8)[1]
    q2, k2, v2, vec = _build.arena_aligned(1, 2, q, k, k)
    assert vec == 1 and k2 is k and q2 is q
    k8 = torch.randint(-5, 5, (2, 40, 2, 8), dtype=torch.int8)
    _, k3, _, _ = _build.arena_aligned(1, 2, q, k8, k8)
    assert torch.equal(k3, k8) and _build.tma_ok(k3)
    assert k3.stride() == (40 * 2 * 16, 2 * 16, 16, 1)


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FORMATS)
def test_init_kv_cache_matches_reference(name):
    cfg = port_cfg(TINY)
    want = JL.init_kv_cache(TINY, 2, 16, kv_format=name)
    got = TL.init_kv_cache(cfg, 2, 16, device="cpu", kv_format=name)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(want[key], np.float32))
        assert got[key].dtype == _to_torch(want[key]).dtype
    assert TL.kv_cache_format(got) == JL.kv_cache_format(want)
    stacked = TL.init_kv_cache(cfg, 2, 16, device="cpu", kv_format=name,
                               n_layers=3)
    assert all(t.shape[0] == 3 for t in stacked.values())
    assert TL.kv_cache_format(stacked) == TL.kv_cache_format(got)


@pytest.mark.parametrize("name", SCALED)
def test_decode_rows_write_scales_and_skip_parked(name):
    """A decode step writes each slot's quantized row and its scale at pos;
    a parked slot's row and scale stay as they were."""
    bundle_cfg = port_cfg(TINY)
    cache = TL.init_kv_cache(bundle_cfg, 2, 16, device="cpu",
                             kv_format=name)
    rows = torch.randn(2, 2, 8)
    want_q, want_s = tkvf.quantize(tkvf.get(name), rows)
    pos = torch.tensor([5, TL.PARKED_POS])
    for key, r in TL._quantized(cache, rows, rows).items():
        TL.write_rows(cache[key], r, pos)
    assert torch.equal(cache["k"][0, 5].view(torch.uint8),
                       want_q[0].view(torch.uint8))
    assert torch.equal(cache["k_scale"][0, 5], want_s[0])
    assert (cache["k"][1] == 0).all() if name == "int8" else \
        (cache["k"][1].float() == 0).all()
    assert (cache["k_scale"][1] == 1.0).all()


@pytest.fixture(scope="module")
def models():
    return bridged(TINY)


def _engines(models, fmt, **cfg):
    jm, jp, tm, tp = models
    return (jserving.ServingEngine(jm, TINY, jp, config=jserving.EngineConfig(
                kv_format=fmt, **cfg)),
            tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.
                                   EngineConfig(kv_format=fmt, **cfg)))


def _workload(n=6, seed=0):
    rng = np.random.default_rng(seed)
    lens = (8, 12, 16)
    return [rng.integers(0, TINY.vocab, lens[i % 3]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("name", FORMATS)
def test_engine_bytes_and_sidecar_drain_match_reference(models, name):
    """kv_row_bytes, arena_bytes and the stats as the reference reports
    them; stepped in lockstep, the page pools, the scale sidecars and each
    slot's resident bytes hold the same counts, and both drain to every
    page free and 0 sidecar pages."""
    cfg = dict(max_slots=4, max_seq=64, depth=0, page_size=8)
    je, te = _engines(models, name, **cfg)
    assert te.kv_row_bytes == je.kv_row_bytes
    assert te.arena_bytes == je.arena_bytes
    for key in ("kv_format", "kv_row_bytes", "arena_bytes"):
        assert te.stats[key] == je.stats[key], key
    for eng, mod in ((je, jserving), (te, tserving)):
        for i, p in enumerate(_workload()):
            eng.submit(mod.Request(uid=i, prompt=p, max_new_tokens=8))
    seen = 0
    while not je.scheduler.all_done:
        je.step()
        te.step()
        assert te.cache_mgr.free_pages == je.cache_mgr.free_pages
        assert te.cache_mgr.scale_sidecar_pages \
            == je.cache_mgr.scale_sidecar_pages
        for slot in range(4):
            assert te.cache_mgr.resident_kv_bytes(slot) \
                == je.cache_mgr.resident_kv_bytes(slot)
        seen = max(seen, te.cache_mgr.scale_sidecar_pages)
    jout, tout = je.run(), te.run()
    assert sorted(tout) == sorted(jout)
    for eng in (je, te):
        assert eng.cache_mgr.free_pages == eng.cache_mgr.num_pages
        assert eng.cache_mgr.scale_sidecar_pages == 0
    assert te.cache_mgr.stats["scale_sidecar_pages"] == 0
    assert (seen > 0) == (name in SCALED)


def test_int8_row_bytes_at_llama_width():
    """llama3.2-3b (28 layers, 8 KV heads, hd 128): 114688 bytes a row in
    bf16 (the fp32 format at its activation dtype), 59136 in int8."""
    from repro_torch.models import registry
    cfg = registry.config("llama3.2-3b")
    per = {name: tkvf.bytes_per_row(tkvf.get(name), cfg.n_kv_heads, cfg.hd,
                                    cfg.adtype) * cfg.n_layers
           for name in FORMATS}
    assert per == {"fp32": 114688, "bf16": 114688, "int8": 59136,
                   "fp8": 59136}


# ---------------------------------------------------------------------------
# the engine against the JAX ServingEngine
# ---------------------------------------------------------------------------

PLAN = dict(temperature=0.8, top_k=20, top_p=0.9, min_p=0.05, seed=3)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
@pytest.mark.parametrize("name", NARROW)
def test_engine_streams_match_jax(models, name, chunks, depth, sampled):
    """Staggered admission (slots < requests), mixed prompt and generation
    lengths; half the requests sampled where ``sampled``."""
    lens, gens = (5, 9, 7, 12), (8, 6, 10, 7)
    engines = _engines(models, name, max_slots=2, max_seq=64, depth=depth,
                       prefill_chunks=chunks)
    outs = []
    for eng, mod, plan_fn in zip(engines, (jserving, tserving),
                                 (jserve.sampling_plan,
                                  tserve.sampling_plan)):
        plan = plan_fn(len(lens), mix=0.5 if sampled else 0.0, **PLAN)
        rng = np.random.default_rng(0)
        for i, (n, g) in enumerate(zip(lens, gens)):
            eng.submit(mod.Request(uid=i, prompt=rng.integers(0, 97, n),
                                   max_new_tokens=g, sampling=plan[i]))
        outs.append(eng.run(max_steps=2000))
    want, got = outs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
    je, te = engines
    for key in ("sampled_requests", "sampled_steps", "decode_steps",
                "kv_format"):
        assert te.stats[key] == je.stats[key], key
    assert (te.stats["sampled_steps"] > 0) == sampled


@pytest.mark.parametrize("name", SCALED)
def test_engine_preemption_matches_jax(models, name):
    """An undersized pool preempts and recomputes the youngest request; the
    scaled arena's recompute quantizes the same rows again."""
    engines = _engines(models, name, max_slots=2, max_seq=64, depth=2,
                       page_size=4, num_pages=14, prefill_chunks=(4, 8))
    outs = []
    for eng, mod in zip(engines, (jserving, tserving)):
        rng = np.random.default_rng(0)
        for i, n in enumerate((20, 15, 20, 15, 20)):
            eng.submit(mod.Request(uid=i, prompt=rng.integers(0, 97, n),
                                   max_new_tokens=12))
        outs.append(eng.run(max_steps=2000))
    for uid in outs[0]:
        np.testing.assert_array_equal(outs[1][uid], np.asarray(outs[0][uid]))
    assert engines[1].scheduler.stats["preempted"] > 0
    assert engines[1].cache_mgr.scale_sidecar_pages == 0


def test_engine_config_accepts_every_format():
    for name in FORMATS:
        assert tserving.EngineConfig(kv_format=name).kv_format == name
    with pytest.raises(ValueError, match="unknown kv_format"):
        tserving.EngineConfig(kv_format="int7")
    cfg = tserving.EngineConfig(max_slots=3)
    assert cfg.replace(kv_format="int8") == tserving.EngineConfig(
        max_slots=3, kv_format="int8")


# ---------------------------------------------------------------------------
# tolerance
# ---------------------------------------------------------------------------

def test_compare_streams_matches_reference():
    oracle = {0: np.array([1, 2, 3, 4]), 1: np.array([5, 6]),
              2: np.array([7, 8, 9]), "x": np.array([1])}
    cand = {0: np.array([1, 2, 3, 4]), 1: np.array([5, 0]),
            2: np.array([7, 8])}
    want = jtolerance.compare_streams(oracle, cand)
    got = ttolerance.compare_streams(oracle, cand)
    assert (got.requests, got.positions, got.matched, got.match_rate,
            got.first_divergence) == (want.requests, want.positions,
                                      want.matched, want.match_rate,
                                      want.first_divergence)
    assert got.describe() == want.describe()
    assert not got.identical
    assert ttolerance.compare_streams(oracle, oracle).identical


@pytest.mark.parametrize("name", NARROW)
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_tolerance_measure_matches_reference(models, name, chunks):
    jm, jp, tm, tp = models
    prompts = _workload()
    kw = dict(max_slots=4, max_seq=64, depth=0, page_size=8,
              prefill_chunks=chunks)
    want = jtolerance.measure(jm, TINY, jp, prompts, max_new_tokens=8,
                              config=jserving.EngineConfig(**kw),
                              kv_format=name)
    got = ttolerance.measure(tm, tm.cfg, tp, prompts, max_new_tokens=8,
                             config=tserving.EngineConfig(**kw),
                             kv_format=name)
    assert got == ttolerance.TokenMatchReport(
        requests=want.requests, positions=want.positions,
        matched=want.matched, match_rate=want.match_rate,
        first_divergence=want.first_divergence)
    assert got.requests == 6 and got.positions == 48


# ---------------------------------------------------------------------------
# recurrent state stays full precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NARROW)
def test_ssm_refuses_narrow_formats_as_the_reference(name):
    jm, jp, tm, tp = ssm_bridged(TINY_SSM)
    with pytest.raises(ValueError, match="full-precision"):
        jm.init_cache(2, 16, kv_format=name)
    with pytest.raises(ValueError, match="full precision"):
        tm.init_cache(2, 16, kv_format=name)
    with pytest.raises(ValueError):
        tserving.ServingEngine(tm, tm.cfg, tp, config=tserving.EngineConfig(
            max_slots=2, max_seq=32, kv_format=name))
    assert sorted(tm.init_cache(2, 16, kv_format="fp32")) == ["conv", "ssm"]
    with pytest.raises(ValueError, match="unknown kv_format"):
        tm.init_cache(2, 16, kv_format="int7")
