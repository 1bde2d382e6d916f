"""Parity of the port's configs, layers and dense LM driver with the JAX
package on the tiny f32 dense regime (tests/test_serving.py:213): weights
and inputs made with numpy from a seed and handed to both packages (the
port's weights through models/convert.py).  Layers at 2e-5, LM logits at
1e-4, greedy streams identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoEConfig  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSMConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TINY = ArchConfig(name="tiny-dense", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab=97, head_dim=8,
                  param_dtype="float32", act_dtype="float32", max_seq=64)


def port_cfg(cfg) -> TArchConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.ssm is not None:
        kw["ssm"] = TSSMConfig(**dataclasses.asdict(cfg.ssm))
    if cfg.moe is not None:
        kw["moe"] = TMoEConfig(**dataclasses.asdict(cfg.moe))
    return TArchConfig(**kw)


def _value(v):
    """A config field as plain data (nested config dataclasses of the two
    packages are different classes with the same fields)."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def numpy_params(cfg, seed=0) -> dict:
    """The dense LM's parameter tree made with numpy from ``seed``: norm
    scales near 1, projections N(0, fan_in^-1), embedding and head
    N(0, d^-1) — the reference's init distributions, numpy's draws."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in convert.expected_shapes(cfg).items():
        if path.endswith("scale"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
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


def bridged(cfg, seed=0):
    """(jax model, jax params, port model, port params) on the same
    numpy-made weights."""
    tree = numpy_params(cfg, seed)
    jm = jreg.build_model(cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    tcfg = port_cfg(cfg)
    tm = treg.build_model(tcfg, device="cpu")
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    return jm, jp, tm, tp


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(treg.ARCH_NAMES))
def test_dense_configs_equal_reference(name):
    jcfg, tcfg = jreg.config(name), treg.config(name)
    for f in dataclasses.fields(jcfg):
        assert _value(getattr(tcfg, f.name)) == _value(getattr(jcfg, f.name)), \
            f.name
    assert tcfg.hd == jcfg.hd
    assert tcfg.n_params() == jcfg.n_params()
    r_j, r_t = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(r_j):
        assert _value(getattr(r_t, f.name)) == _value(getattr(r_j, f.name)), \
            f.name
    assert r_t.n_params() == r_j.n_params()


def test_llama_full_width_size():
    cfg = treg.config("llama3.2-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab) == (28, 3072, 24, 8, 128, 8192,
                                             128256)
    assert round(cfg.n_params() / 1e9, 2) == 3.61
    assert cfg.adtype == torch.bfloat16 and not cfg.tie_embeddings


def test_hymba_full_width_size():
    """hymba-1.5b: the published width, 1.64 B parameters, and its global
    layers at 0 / 16 / 31 (window max_seq + 1), 1024 elsewhere."""
    from repro_torch.models import hybrid
    cfg = treg.config("hymba-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab) == (32, 1600, 25, 5, 64, 5504,
                                             32001)
    assert (cfg.ssm.d_state, cfg.ssm.n_heads(cfg.d_model)) == (16, 50)
    assert round(cfg.n_params() / 1e9, 2) == 1.64
    win = hybrid.window_schedule(cfg)
    assert [i for i, w in enumerate(win) if w != 1024] == [0, 16, 31]
    assert {win[i] for i in (0, 16, 31)} == {524_289}


def test_every_reference_arch_builds_on_cpu():
    """The port refuses no architecture the reference registers: each
    builds reduced on the CPU with the reference's family driver, and
    its init has the tree ``convert.expected_shapes`` names."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.transformer import LM
    from repro_torch.models.vlm import VLM
    assert treg.ARCH_NAMES == jreg.ARCH_NAMES
    for name in jreg.ARCH_NAMES:
        bundle = treg.build(name, reduced=True, device="cpu")
        want = {"vlm": VLM, "encdec": EncDecLM}.get(bundle.cfg.family, LM)
        assert type(bundle.model) is want, name
        flat = convert._flatten(bundle.model.init(0))
        assert {k: tuple(v.shape) for k, v in flat.items()} == \
            convert.expected_shapes(bundle.cfg), name


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 4, 8)
    scale = _rand(rng, 8)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    pos = np.array([[0, 1, 2, 30, 1000]] * 2, np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("act", ["silu_gated", "relu2", "gelu"])
def test_mlp_matches_jax(act):
    cfg = dataclasses.replace(TINY, act=act)
    rng = np.random.default_rng(1)
    p = {"w_up": _rand(rng, 32, 64) * 0.2, "w_down": _rand(rng, 64, 32) * 0.2}
    if act == "silu_gated":
        p["w_gate"] = _rand(rng, 32, 64) * 0.2
    for shape in ((3, 32), (2, 5, 32)):
        x = _rand(rng, *shape)
        want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, cfg,
                      jnp.asarray(x))
        got = TL.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     port_cfg(cfg), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_qk_norm_projection_matches_jax():
    cfg = dataclasses.replace(TINY, qk_norm=True)
    jm, jp, _, tp = bridged(cfg)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: (v[0] if not isinstance(v, dict) else {"scale": v["scale"][0]})
          for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 6, 32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    want = JL._project_qkv(jl, cfg, jnp.asarray(x), jnp.asarray(pos),
                           JL.RULES)
    got = TL._project_qkv(tl, port_cfg(cfg), torch.from_numpy(x),
                          torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_write_rows_drops_parked_rows():
    arena = torch.zeros(3, 8, 2, 4)
    rows = torch.ones(3, 2, 4)
    TL.write_rows(arena, rows, torch.tensor([5, TL.PARKED_POS, 7]))
    assert arena[0, 5].eq(1).all() and arena[2, 7].eq(1).all()
    assert arena[1].eq(0).all() and arena.sum() == 16


# ---------------------------------------------------------------------------
# LM drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["silu_gated", "relu2"])
def tiny(request):
    cfg = dataclasses.replace(TINY, act=request.param,
                              qk_norm=request.param == "relu2")
    return (cfg, *bridged(cfg))


def test_prefill_decode_logits_and_stream(tiny):
    """Monolithic prefill + 6 greedy decode steps: logits within 1e-4 at
    every step, identical greedy tokens."""
    cfg, jm, jp, tm, tp = tiny
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, 11).astype(np.int32)
    jc = jm.init_cache(1, 64)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompt)[None], jc)
    tc = tm.init_cache(1, 64)
    tlog = tm.prefill(tp, torch.from_numpy(prompt).long()[None], tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4)
    step = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = torch.argmax(tlog, -1)
    pos = len(prompt)
    for _ in range(6):
        assert int(jtok[0]) == int(ttok[0])
        jlog, jc = step(jp, jtok, jc, jnp.asarray([pos], jnp.int32))
        tlog = tm.decode_step(tp, ttok, tc, torch.tensor([pos]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1)
        pos += 1


def test_prefill_chunk_logits(tiny):
    """Two chunks (the last padded) into slot 1 of a 2-slot arena: logits
    and the slot's arena rows within 1e-4 of the reference."""
    cfg, jm, jp, tm, tp = tiny
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, 13).astype(np.int32)
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    fn = jax.jit(jm.prefill_chunk)
    for start, size in ((0, 8), (8, 8)):
        real = min(size, len(prompt) - start)
        chunk = np.zeros(size, np.int32)
        chunk[:real] = prompt[start:start + real]
        jlog, jc = fn(jp, jnp.asarray(chunk)[None], jc, jnp.int32(1),
                      jnp.int32(start), jnp.int32(real - 1))
        tlog = tm.prefill_chunk(tp, torch.from_numpy(chunk).long()[None], tc,
                                1, start, real - 1)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-4)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               atol=1e-4)
    with pytest.raises(ValueError):
        tm.prefill_chunk(tp, torch.zeros((1, 8), dtype=torch.long), tc, 2, 0,
                         7)


def test_parked_slot_decode_leaves_arena_untouched(tiny):
    cfg, _, _, tm, tp = tiny
    tc = tm.init_cache(2, 16)
    tc["k"].fill_(3.0)
    before = tc["k"][:, 1].clone()
    tm.decode_step(tp, torch.tensor([1, 2]), tc,
                   torch.tensor([4, TL.PARKED_POS]))
    assert torch.equal(tc["k"][:, 1], before)
    assert not torch.equal(tc["k"][:, 0, 4], before[:, 4])


def test_plain_namespace_model_is_the_cpu_path(tiny):
    """On the CPU the dispatching ops and ops.PLAIN are the same function:
    a model built on either gives identical logits."""
    cfg, _, _, tm, tp = tiny
    plain = treg.build_model(tm.cfg, device="cpu", kernels=ops.PLAIN)
    prompt = torch.arange(9)[None] % cfg.vocab
    a = tm.prefill(tp, prompt, tm.init_cache(1, 16))
    b = plain.prefill(tp, prompt, plain.init_cache(1, 16))
    assert torch.equal(a, b)


def test_port_init_matches_bridge_layout():
    """The port's own random init has the reference's tree and shapes."""
    cfg = port_cfg(dataclasses.replace(TINY, qk_norm=True))
    tm = treg.build_model(cfg, device="cpu")
    params = tm.init(0)
    flat = convert._flatten(params)
    want = convert.expected_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert all(v.dtype == torch.float32 for v in flat.values())
    # same distributions: projections have std fan_in^-1/2
    wq = params["layers"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02
    assert torch.equal(tm.init(0)["embed"], params["embed"])
