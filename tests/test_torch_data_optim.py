"""The port's data pipeline and optimizer against the JAX package's, on
the CPU.

Batches are numpy Philox draws in both packages, so they are compared bit
for bit (tokens, labels, a padding mask, the pipeline's start offset);
the family extras against the reference's Philox stream at the same key
and step (the reference's own ``family_extras_fn`` cannot make them: see
its test); the prefetcher's order and error path.  AdamW's first steps,
decay on matrices only, clipping, the global norm and the schedules
against the reference's in f32, within 1e-6 relative (the same f32
arithmetic; XLA may fuse a multiply-add where torch rounds twice).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import make_pipeline as jmake_pipeline  # noqa: E402
from repro.data.pipeline import family_extras_fn as jextras  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data import (Prefetcher, SyntheticLMDataset,  # noqa: E402
                              family_extras_fn, make_pipeline)
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402

RTOL = 1e-6


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0.0, 0.25])
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_bit_equal_reference(seed, pad):
    kw = dict(vocab=1000, seq_len=33, global_batch=3, seed=seed,
              pad_fraction=pad)
    ours, ref = SyntheticLMDataset(**kw), JDataset(**kw)
    for step in (0, 1, 7, 123456):
        a, b = ours.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    it = iter(ours)
    np.testing.assert_array_equal(next(it)["tokens"], ref.batch(0)["tokens"])


@pytest.mark.parametrize("start", [0, 3])
def test_pipeline_equals_reference_pipeline(start):
    cfg = treg.config("llama3.2-3b").reduced()
    ours = list(make_pipeline(cfg, ShapeConfig("t", 16, 2, "train"),
                              start_step=start, num_steps=3, device="cpu"))
    ref = list(jmake_pipeline(cfg, JShape("t", 16, 2, "train"),
                              start_step=start, num_steps=3))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for key in a:
            assert isinstance(a[key], torch.Tensor)
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


@pytest.mark.parametrize("name,key,field", [
    ("whisper-large-v3", 7, "frames"),
    ("llava-next-34b", 9, "prefix_embeds")])
def test_family_extras(name, key, field):
    """The port draws N(0, 1) f32 at Philox(key, counter=step); the
    reference passes ``counter=[step]``, which numpy refuses."""
    cfg = treg.config(name).reduced()
    base = SyntheticLMDataset(vocab=cfg.vocab, seq_len=8,
                              global_batch=2).batch(4)
    out = family_extras_fn(cfg)(4, base)
    rows = cfg.enc_seq if field == "frames" else cfg.n_patch_tokens
    want = np.random.Generator(np.random.Philox(key=key, counter=4)) \
        .standard_normal((2, rows, cfg.d_model), dtype=np.float32)
    np.testing.assert_array_equal(out[field], want)
    assert field not in base                 # the batch is copied
    with pytest.raises(ValueError, match="counter"):
        jextras(dataclasses.replace(cfg))(4, base)
    assert family_extras_fn(treg.config("llama3.2-3b")) is None


def test_prefetcher_keeps_order():
    seen = []
    pf = Prefetcher(iter(range(10)), lambda x: seen.append(x) or x * 2,
                    depth=3)
    assert list(pf) == [2 * i for i in range(10)]
    assert seen == list(range(10))


def test_prefetcher_raises_the_worker_error():
    def gen():
        yield 1
        raise KeyError("boom")
    pf = Prefetcher(gen(), lambda x: x, depth=1)
    assert next(pf) == 1
    with pytest.raises(KeyError, match="boom"):
        next(pf)


def test_prefetcher_close_drains():
    pf = Prefetcher(iter(range(100)), lambda x: x, depth=2)
    assert next(pf) == 0
    pf.close()
    pf._thread.join(timeout=10)
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "layers": {"a": (scale * rng.standard_normal((2, 3, 4)))
                       .astype(np.float32),
                       "norm": (1 + 0.1 * rng.standard_normal(4))
                       .astype(np.float32)},
            "b": (scale * rng.standard_normal(7)).astype(np.float32)}


def _torch(t):
    return tree.map_(lambda a: torch.from_numpy(a.copy()), t)


def _close(got, want, rtol=RTOL, atol=0.0):
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    for p, t in tree.items(got):
        np.testing.assert_allclose(t.numpy(), flat["/".join(p)], rtol=rtol,
                                   atol=atol, err_msg="/".join(p))


@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 30.0])
def test_adamw_steps_match_reference(clip, grad_scale):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg = adamw.AdamWConfig(clip_norm=clip)
    jcfg = jadamw.AdamWConfig(clip_norm=clip)
    tp = _torch(params)
    ts = adamw.adamw_init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp)
    for step in range(3):
        grads = _tree(rng, grad_scale)
        lr = 1e-2 * (step + 1)
        jp, js, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                         js, lr, jcfg)
        tp, ts, tm = adamw.adamw_update(tp, _torch(grads), ts,
                                        torch.tensor(lr), cfg)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=RTOL)
        _close(tp, jp, atol=1e-7)
        _close(ts["m"], js["m"], atol=1e-9)
        _close(ts["v"], js["v"], atol=1e-12)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32


def test_adamw_decays_matrices_only():
    """With zero gradients the update is the decay alone: matrices shrink
    by lr * wd * p, vectors stay."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    tp = _torch(params)
    zero = tree.map_(torch.zeros_like, tp)
    tp, _, _ = adamw.adamw_update(tp, zero, adamw.adamw_init(tp),
                                  torch.tensor(0.5))
    np.testing.assert_allclose(tp["w"].numpy(),
                               params["w"] - 0.5 * 0.1 * params["w"],
                               rtol=1e-6)
    np.testing.assert_array_equal(tp["b"].numpy(), params["b"])
    np.testing.assert_array_equal(tp["layers"]["norm"].numpy(),
                                  params["layers"]["norm"])


def test_adamw_keeps_the_param_dtype_and_moments_f32():
    p = {"w": torch.randn(4, 4).to(torch.bfloat16),
         "s": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw.adamw_init(p)
    assert all(t.dtype == torch.float32 for t in tree.leaves(st["m"]))
    g = tree.map_(lambda t: torch.full_like(t, 0.5), p)
    before = p["w"].clone()
    p2, st, _ = adamw.adamw_update(p, g, st, torch.tensor(1e-2))
    assert p2 is p and p["w"].dtype == torch.bfloat16
    assert not torch.equal(p["w"], before)
    assert st["m"]["w"].dtype == torch.float32


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(3)
    g = _tree(rng, 10.0)
    tn = adamw.global_norm(_torch(g))
    jn = jadamw.global_norm(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(tn.item(), float(jn), rtol=RTOL)
    tc, tn2 = adamw.clip_by_global_norm(_torch(g), 1.0)
    jc, jn2 = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    np.testing.assert_allclose(tn2.item(), float(jn2), rtol=RTOL)
    _close(tc, jc)
    np.testing.assert_allclose(adamw.global_norm(tc).item(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("warmup,total", [(10, 100), (3, 6), (0, 5), (5, 5)])
def test_cosine_schedule_matches_reference(warmup, total):
    for step in range(total + 3):
        got = schedule.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                       peak_lr=3e-4, warmup_steps=warmup,
                                       total_steps=total)
        want = jschedule.cosine_schedule(jnp.asarray(step, jnp.int32),
                                         peak_lr=3e-4, warmup_steps=warmup,
                                         total_steps=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL,
                                   err_msg=str(step))


def test_linear_warmup_matches_reference():
    for step in range(12):
        got = schedule.linear_warmup(torch.tensor(step), peak_lr=1e-3,
                                     warmup_steps=8)
        want = jschedule.linear_warmup(jnp.asarray(step), peak_lr=1e-3,
                                       warmup_steps=8)
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
