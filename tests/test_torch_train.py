"""Parity of the port's training path with the JAX package on the CPU.

The same numpy-made weights and inputs go through both packages:

  * the plain attention backward (``ops._Attention`` on CPU tensors: the
    plain forward with its LSE, then ``flash_attention_bwd_plain``)
    against ``jax.vjp`` of the reference's ``flash_attention_ref``, with K/V
    repeated to the query heads inside the differentiated function (G 1 /
    2): causal, non-causal, window 12, Sq < Sk, ragged Sk;
  * ``blockwise_cross_entropy`` with a ragged last block and a mask;
  * ``loss_fn`` and every gradient leaf for dense (plain, qk_norm, relu2),
    moe (with its aux loss), vlm (the patch prefix trimmed), encdec, ssm
    and hybrid (the reference's tiny configs: chunk 16 over a ragged S,
    hybrid window 8 < S; SSD's backward through ``ops._SSD``), against
    ``jax.value_and_grad(model.loss_fn)``; remat none = full = dots; two
    microbatches against the reference's ``grad_accum_chained``;
  * 6 ``Trainer`` steps on reduced llama3.2-3b (the regime of the
    reference's tests/test_checkpoint_trainer.py:87-124, bf16 params),
    started from the reference Trainer's own initial state;
  * the refusals (the ``hier*`` reductions, ``save_tp`` and a mesh:
    ROADMAP 1.11) and the CLI, which trains every family on the CPU.

Tolerances (f32 unless stated): attention gradients 1e-5 absolute +
1e-5 relative, the CE and the losses 1e-5 relative (the same f32 sums in
another order); gradient leaves 2e-5 absolute + 1e-4 relative (a leaf
sums over every token and layer, so its f32 rounding grows with the
sums).  The Trainer regime is bf16: see its test.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import tiny_family_configs  # noqa: E402
from repro.core import chaining as jchaining  # noqa: E402
from repro.data import make_pipeline as jmake_pipeline  # noqa: E402
from repro.kernels import flash_ref  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import chaining, tree  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert, registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.runtime import trainer as TT  # noqa: E402

from test_torch_encdec import TINY_ENCDEC, encdec_bridged  # noqa: E402
from test_torch_model import TINY, bridged, port_cfg  # noqa: E402
from test_torch_hybrid import hybrid_bridged  # noqa: E402
from test_torch_moe import moe_bridged  # noqa: E402
from test_torch_ssm import ssm_bridged  # noqa: E402
from test_torch_vlm import TINY_VLM  # noqa: E402

ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
B, S = 2, 20


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (causal, window, Sq, Sk, H, KVH)
    "causal": (True, None, 40, 40, 4, 2),
    "noncausal": (False, None, 40, 40, 4, 4),
    "window12": (True, 12, 40, 40, 4, 2),
    "sq_lt_sk": (True, None, 24, 40, 2, 2),
    "ragged_sk": (False, None, 24, 37, 4, 2),
    "ragged_causal_g1": (True, None, 37, 37, 3, 3),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_backward_matches_jax_vjp(case):
    causal, window, sq, sk, h, kvh = ATTN_CASES[case]
    g, d, blk = h // kvh, 8, 16
    rng = np.random.default_rng(7)
    q, do = _rand(rng, 2, h, sq, d), _rand(rng, 2, h, sq, d)
    k, v = _rand(rng, 2, kvh, sk, d), _rand(rng, 2, kvh, sk, d)

    def jf(q, k, v):
        return flash_ref.flash_attention_ref(
            q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1), causal,
            window, None, blk)
    jo, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = ops.attention(tq, tk, tv, causal=causal, window=window, bk=blk)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               **ATTN_TOL)
    for name, t, j in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **ATTN_TOL,
                                   err_msg=f"d{name}")


def test_attention_backward_counts_no_launch_on_cpu():
    """The CPU path takes the plain versions in both directions."""
    ops.reset_launch_counts()
    q = torch.randn(1, 2, 9, 8, requires_grad=True)
    out = ops.attention(q, q.detach(), q.detach())
    out.sum().backward()
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    assert q.grad is not None


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_blockwise_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    b, s, d, v, block = 2, 37, 16, 53, 16
    x, w = _rand(rng, b, s, d), _rand(rng, d, v)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if masked else None

    def jf(x, w):
        return JL.blockwise_cross_entropy(
            w, x, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), block=block)
    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                     jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tv = TL.blockwise_cross_entropy(
        tw, tx, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), block=block)
    tg = torch.autograd.grad(tv, (tx, tw))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=LOSS_RTOL)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    # the unblocked CE on the full logits agrees
    full = TL.cross_entropy(tx.detach() @ tw.detach(),
                            torch.from_numpy(labels),
                            None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(full.item(), float(jv), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# loss_fn and its gradients, family by family
# ---------------------------------------------------------------------------

def _dense(**kw):
    return lambda: bridged(dataclasses.replace(TINY, **kw))


def _vlm():
    return bridged(TINY_VLM)


FAMILIES = {
    "dense": _dense(),
    "dense_qk_norm": _dense(qk_norm=True),
    "dense_relu2": _dense(act="relu2"),
    "moe": lambda: moe_bridged(tiny_family_configs()["moe"]),
    "vlm": _vlm,
    "encdec": lambda: encdec_bridged(TINY_ENCDEC),
    "ssm": lambda: ssm_bridged(tiny_family_configs()["ssm"]),
    "hybrid": lambda: hybrid_bridged(tiny_family_configs()["hybrid"]),
}


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _rand(rng, b, cfg.n_patch_tokens,
                                       cfg.d_model)
    if cfg.family == "encdec":
        batch["frames"] = _rand(rng, b, cfg.enc_seq, cfg.d_model)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss(tm, remat="full"):
    return lambda p, bt: tm.loss_fn(p, bt, remat=remat)[0]


def _assert_grads(tgrads, jgrads, tol=GRAD_TOL):
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    flat_t = {"/".join(p): t.detach().numpy()
              for p, t in tree.items(tgrads)}
    assert set(flat_t) == set(flat_j)
    for key in sorted(flat_j):
        np.testing.assert_allclose(flat_t[key], flat_j[key], **tol,
                                   err_msg=key)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax(family):
    jm, jp, tm, tp = FAMILIES[family]()
    batch = _batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb), has_aux=True)(jp)
    tl, tg = chaining.value_and_grad(_port_loss(tm), tp, _tbatch(batch))
    _, tparts = tm.loss_fn(tp, _tbatch(batch))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tparts["ce"].item(), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tparts["aux"].item(), float(jparts["aux"]),
                               rtol=1e-5, atol=1e-7)
    if family == "moe":
        assert tparts["aux"].item() > 0
    _assert_grads(tg, jg)


def test_vlm_loss_trims_the_prefix():
    """The vlm loss reads the text rows only: moving the patch rows moves
    the loss through attention, but labels never line up with them."""
    _, _, tm, tp = _vlm()
    batch = _tbatch(_batch(tm.cfg))
    h, _ = tm.hidden_states(tp, batch["tokens"],
                            prefix_embeds=batch["prefix_embeds"])
    assert h.shape[1] == S + tm.cfg.n_patch_tokens
    loss, _ = tm.loss_fn(tp, batch)
    ce = TL.blockwise_cross_entropy(tm.head(tp), h[:, -S:],
                                    batch["labels"], batch["loss_mask"])
    assert torch.equal(loss, ce)


@pytest.mark.parametrize("family", ["dense", "moe", "encdec", "ssm",
                                    "hybrid"])
def test_remat_policies_agree(family):
    """remat none = full = dots: the recompute runs the same ops on the
    same inputs, so loss and gradients are the same bits."""
    _, _, tm, tp = FAMILIES[family]()
    batch = _tbatch(_batch(tm.cfg))
    outs = {r: chaining.value_and_grad(_port_loss(tm, r), tp, batch)
            for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert torch.equal(outs[r][0], outs["none"][0]), r
        for a, b in zip(tree.leaves(outs[r][1]), tree.leaves(outs["none"][1])):
            assert torch.equal(a, b), r


def test_microbatches_match_grad_accum_chained():
    jm, jp, tm, tp = FAMILIES["dense"]()
    batch = _batch(tm.cfg, b=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jchaining.grad_accum_chained(
        lambda p, mb: jm.loss_fn(p, mb)[0], jp, jb, num_microbatches=2)
    tl, tg = chaining.grad_accum_chained(
        _port_loss(tm), tp, _tbatch(batch), num_microbatches=2)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    _assert_grads(tg, jg)
    assert all(t.dtype == torch.float32 for t in tree.leaves(tg))


# ---------------------------------------------------------------------------
# the Trainer against the reference's
# ---------------------------------------------------------------------------

TRAIN_SHAPE = (32, 4)         # seq, global batch (reference test :95)


@pytest.fixture(scope="module")
def trainer_runs():
    """The reference Trainer and the port's, 6 steps each on reduced
    llama3.2-3b from the reference's initial state."""
    jcfg = JTrainConfig(num_steps=6, log_every=1, peak_lr=1e-3, seed=0)
    jbundle = jreg.build("llama3.2-3b", reduced=True)
    jtr = JTrainer(jbundle.model, make_test_mesh((1, 1), ("data", "model")),
                   jcfg)
    init = jax.tree.map(np.asarray, jtr.init_state())
    jstate = jtr.run(jmake_pipeline(jbundle.cfg, JShape("tiny", *TRAIN_SHAPE,
                                                        "train"),
                                    num_steps=6), start_step=0,
                     state=jtr.init_state())
    bundle = treg.build("llama3.2-3b", reduced=True, device="cpu")
    state = {"params": convert.params_from_numpy(init["params"], bundle.cfg,
                                                 "cpu"),
             "opt": convert.opt_state_from_numpy(init["opt"], bundle.cfg,
                                                 "cpu")}
    tr = TT.Trainer(bundle.model, TT.TrainConfig(num_steps=6, log_every=1,
                                                 peak_lr=1e-3, seed=0))
    tstate = tr.run(make_pipeline(bundle.cfg, ShapeConfig(
        "tiny", *TRAIN_SHAPE, "train"), num_steps=6, device="cpu"),
        start_step=0, state=state)
    return jstate, tstate


def test_trainer_history_matches_reference(trainer_runs):
    """bf16 params and activations: both packages round every matmul
    output to bf16 once, and their f32 sums differ in order, so a bf16
    value sometimes lands on the neighbouring bf16 number (2^-8
    relative).  The loss (a mean of f32 CE terms over 128 tokens) moves by
    far less: 2e-3 relative; the grad norm (a sum over every gradient
    leaf, each a sum of bf16-rounded terms) by 1e-2 relative; the lr is
    f32 arithmetic on the step, 1e-6."""
    jstate, tstate = trainer_runs
    jh, th = jstate["_history"], tstate["_history"]
    assert [h["step"] for h in th] == [h["step"] for h in jh] == list(
        range(6))
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-3)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-2)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    assert th[-1]["loss"] < th[0]["loss"]


def test_trainer_params_match_reference(trainer_runs):
    """Final params after 6 AdamW steps at lr <= 1e-3 from equal bf16
    weights.  AdamW's normalised step is about lr per element whatever
    the gradient's size, and where |g| is near eps a tiny gradient
    difference turns into up to lr of parameter difference; each step
    also rounds the bf16 parameter once.  So the limit is 6 steps' worth
    of lr (6e-3) plus a bf16 ulp of the value (2^-8 relative), absolute
    6e-3 + relative 2^-8; the mean difference must stay far below it."""
    jstate, tstate = trainer_runs
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate["params"])
    tp = convert.to_numpy(tstate["params"])
    flat_j = {"/".join(str(k.key) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    diffs = []
    for path, t in tree.items(tp):
        key = "/".join(path)
        np.testing.assert_allclose(t, flat_j[key], atol=6e-3, rtol=2 ** -8,
                                   err_msg=key)
        diffs.append(np.abs(t - flat_j[key]).mean())
    assert max(diffs) < 1e-3, max(diffs)


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------

def test_every_family_is_trained():
    assert set(TT.TRAINED_FAMILIES) == {
        treg.config(name).family for name in treg.ARCH_NAMES}


@pytest.mark.parametrize("reduction", ["hier", "hier_tree", "hier_ef8"])
def test_multi_device_reductions_refused(reduction):
    bundle = treg.build("llama3.2-3b", reduced=True, device="cpu")
    with pytest.raises(NotImplementedError, match=r"1\.11"):
        TT.Trainer(bundle.model, TT.TrainConfig(num_steps=1,
                                                reduction=reduction))


def test_save_tp_and_reduce_fn_refused():
    _, _, tm, tp = FAMILIES["dense"]()
    batch = _tbatch(_batch(tm.cfg))
    with pytest.raises(NotImplementedError, match=r"1\.11"):
        tm.loss_fn(tp, batch, remat="save_tp")
    with pytest.raises(NotImplementedError, match=r"1\.11"):
        chaining.grad_accum_chained(_port_loss(tm), tp, batch,
                                    num_microbatches=1, reduce_fn=sum)
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(tp, batch, remat="bogus")


@pytest.mark.parametrize("flag", ["--data-axis", "--model-axis"])
def test_cli_refuses_a_mesh(flag):
    with pytest.raises(NotImplementedError, match=r"1\.11"):
        train_cli.main(["--arch", "llama3.2-3b", "--device", "cpu", flag,
                        "2"])


def test_cli_trains_and_restarts_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "llama3.2-3b", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", ck]
    out = {}
    assert train_cli.main(args + ["--steps", "3"], out=out) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: data=1 model=1 (1 devices)"
    assert lines[1] == "starting at step 0"
    assert lines[2].startswith("done: 3 log records; loss ")
    hist = out["state"]["_history"]
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert train_cli.main(args + ["--steps", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "starting at step 3"
    assert lines[2].startswith("done: 2 log records; loss ")


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llava-next-34b",
                                  "whisper-large-v3", "mamba2-2.7b",
                                  "hymba-1.5b"])
def test_cli_trains_every_family_on_cpu(name, capsys):
    assert train_cli.main(["--arch", name, "--device", "cpu", "--steps",
                           "2", "--batch", "2", "--seq", "16",
                           "--log-every", "1"]) == 0
    # a slow step under a loaded host adds a "straggler events" line after it
    done, = (line for line in capsys.readouterr().out.splitlines()
             if line.startswith("done: "))
    first, last = (float(x) for x in done.split("loss ")[1].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_cli_trains_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", "llama3.2-3b", "--steps", "1"])
