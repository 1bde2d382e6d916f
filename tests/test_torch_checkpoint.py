"""The port's checkpoint store against the JAX package's, on the CPU.

The reference's checkpoint tests ported (tests/test_checkpoint_trainer.py:
roundtrip, shape mismatch, atomicity; retention, async write and wait, and
a restart that resumes identically), then the file format across the two
packages: a file written by ``repro.checkpoint.save_pytree`` (bf16, f32
and int32 leaves, zstd and zlib) restored by the port and the reverse, a
port Trainer's checkpoint restored by the reference against its own
Trainer's template, the port's msgpack bytes equal to
``msgpack.packb(..., use_bin_type=True)``, and the paths without
``zstandard`` (monkeypatched away).  Restored values are bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import msgpack  # noqa: E402

from repro.checkpoint import restore_pytree as jrestore  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, _msgpack,  # noqa: E402
                                    latest_step, restore_pytree,
                                    save_pytree)
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainConfig  # noqa: E402

def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.linspace(-1, 1, 5).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _template(st):
    return tree.map_(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), st)


def _equal_trees(a, b):
    la, lb = list(tree.items(a)), list(tree.items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


# ---------------------------------------------------------------------------
# the reference's tests, ported
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    path = str(tmp_path / "s.ckpt")
    st = _state()
    save_pytree(path, st, meta={"step": 7})
    out, meta = restore_pytree(path, _template(st))
    assert meta["step"] == 7
    _equal_trees(out, st)
    assert out["opt"]["step"].dtype == torch.int32
    assert out["params"]["b"].dtype == torch.bfloat16


def test_restore_shape_mismatch_raises_as_the_reference(tmp_path):
    path = str(tmp_path / "s.ckpt")
    save_pytree(path, _state())
    bad = {"params": {"w": torch.empty(4, 4, device="meta"),
                      "b": torch.empty(5, device="meta")},
           "opt": {"step": torch.empty((), dtype=torch.int32,
                                       device="meta")}}
    with pytest.raises(ValueError) as got:
        restore_pytree(path, bad)
    jbad = {"params": {"w": jax.ShapeDtypeStruct((4, 4), jnp.float32),
                       "b": jax.ShapeDtypeStruct((5,), jnp.bfloat16)},
            "opt": {"step": jax.ShapeDtypeStruct((), jnp.int32)}}
    with pytest.raises(ValueError) as want:
        jrestore(path, jbad)
    assert str(got.value) == str(want.value)


def test_restore_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "s.ckpt")
    save_pytree(path, _state())
    tpl = _template(_state())
    tpl["params"]["extra"] = torch.empty(2, device="meta")
    with pytest.raises(KeyError, match="params/extra"):
        restore_pytree(path, tpl)


def test_manager_atomicity_ignores_incomplete(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep=5, async_write=False)
    mgr.save(10, _state())
    # a crashed half-write: directory without _COMPLETE
    os.makedirs(os.path.join(root, "step_20"))
    with open(os.path.join(root, "step_20", "state.ckpt"), "wb") as f:
        f.write(b"garbage")
    assert latest_step(root) == 10
    state, meta, step = mgr.restore_latest(_template(_state()))
    assert step == 10 and meta["step"] == 10
    _equal_trees(state, _state())


def test_manager_retention_keeps_the_latest(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert sorted(os.listdir(root)) == ["step_3", "step_4"]
    assert latest_step(root) == 4


def test_manager_async_write_and_wait(tmp_path):
    """save() copies to host at once: an in-place update after it does not
    reach the file the writer thread writes later."""
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep=3)
    st = _state()
    mgr.save(5, st, meta={"note": "a"})
    st["params"]["w"].add_(100.0)
    mgr.wait()
    out, meta, step = mgr.restore_latest(_template(st))
    assert step == 5 and meta == {"note": "a", "step": 5}
    _equal_trees(out, _state())
    with open(os.path.join(root, "step_5", "_COMPLETE")) as f:
        assert json.loads(f.read())["step"] == 5
    mgr.close()


def _reduced_trainer(tcfg):
    bundle = treg.build("llama3.2-3b", reduced=True, device="cpu")
    return bundle, Trainer(bundle.model, tcfg)


def _pipe(bundle, start, n):
    return make_pipeline(bundle.cfg, ShapeConfig("tiny", 32, 4, "train"),
                         start_step=start, num_steps=n, device="cpu")


def test_restart_resumes_identically(tmp_path):
    """6 steps straight = 3 steps, a checkpoint, a fresh Trainer restoring
    it, 3 more steps: losses and final params bit for bit (the data is
    step-pure, the file exact, the CPU path deterministic)."""
    ck = str(tmp_path / "ck")
    kw = dict(log_every=1, peak_lr=1e-3, seed=0)
    bundle, tr_a = _reduced_trainer(TrainConfig(num_steps=6, **kw))
    st_a = tr_a.run(_pipe(bundle, 0, 6))
    bundle, tr_b = _reduced_trainer(TrainConfig(num_steps=3, ckpt_dir=ck,
                                                ckpt_every=100, **kw))
    tr_b.run(_pipe(bundle, 0, 3))
    bundle, tr_c = _reduced_trainer(TrainConfig(num_steps=6, ckpt_dir=ck,
                                                ckpt_every=100, **kw))
    state, start = tr_c.maybe_restore()
    assert start == 3
    st_c = tr_c.run(_pipe(bundle, 3, 3), start_step=start, state=state)
    a = {h["step"]: h["loss"] for h in st_a["_history"]}
    c = {h["step"]: h["loss"] for h in st_c["_history"]}
    assert [c[s] for s in (3, 4, 5)] == [a[s] for s in (3, 4, 5)]
    _equal_trees(st_c["params"], st_a["params"])
    _equal_trees(st_c["opt"], st_a["opt"])


# ---------------------------------------------------------------------------
# one file format, both packages
# ---------------------------------------------------------------------------

def _numpy_state():
    rng = np.random.default_rng(0)
    return {"params": {"layers": {"wq": rng.standard_normal((2, 3, 4))
                                  .astype(ml_dtypes.bfloat16)},
                       "norm": rng.standard_normal(4).astype(np.float32)},
            "opt": {"m": {"layers": {"wq": rng.standard_normal((2, 3, 4))
                                     .astype(np.float32)}},
                    "step": np.asarray(3, np.int32)}}


def _words(a):
    """A leaf's raw bits (bf16 through its 16-bit words)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes()
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def _codec(codec, monkeypatch, module):
    """Write with ``codec``: zlib with ``module``'s zstandard taken away;
    zstd needs the package."""
    if codec == "zlib":
        monkeypatch.setattr(module, "zstd", None)
    elif module.zstd is None:
        pytest.skip("zstandard is not installed")


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_reference_file_restores_in_the_port(tmp_path, monkeypatch, codec):
    _codec(codec, monkeypatch, jstore)
    path = str(tmp_path / "ref.ckpt")
    ns = _numpy_state()
    jsave(path, jax.tree.map(jnp.asarray, ns), meta={"step": 3})
    with open(path, "rb") as f:
        assert f.read(5) == b"RPK1" + (b"d" if codec == "zlib" else b"z")
    tpl = tree.map_(lambda a: torch.empty(np.shape(a), device="meta"), ns)
    out, meta = restore_pytree(path, tpl)
    assert meta == {"step": 3}
    assert out["params"]["layers"]["wq"].dtype == torch.bfloat16
    assert out["opt"]["step"].dtype == torch.int32
    for (p, got), (_, want) in zip(tree.items(out), tree.items(ns)):
        assert _words(got) == _words(want), p


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_port_file_restores_in_the_reference(tmp_path, monkeypatch, codec):
    _codec(codec, monkeypatch, store)
    path = str(tmp_path / "port.ckpt")
    ns = _numpy_state()
    st = tree.map_(lambda a: torch.from_numpy(
        np.asarray(a).view(np.int16)).view(torch.bfloat16)
        if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(
            np.array(a)), ns)
    save_pytree(path, st, meta={"step": 3})
    with open(path, "rb") as f:
        assert f.read(5) == b"RPK1" + (b"d" if codec == "zlib" else b"z")
    tpl = jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), a.dtype),
                       ns)
    out, meta = jrestore(path, tpl)
    assert meta == {"step": 3}
    for p, want in tree.items(ns):
        got = out
        for k in p:
            got = got[k]
        assert np.asarray(got).dtype == np.asarray(want).dtype, p
        assert np.asarray(got).tobytes() == _words(want), p


def test_port_trainer_checkpoint_restores_in_the_reference(tmp_path):
    """A port Trainer's checkpoint of reduced llama3.2-3b (bf16 params, f32
    moments, int32 step) restores into the reference Trainer's own
    template: every path and shape is the reference's."""
    ck = str(tmp_path / "ck")
    bundle, tr = _reduced_trainer(TrainConfig(num_steps=2, ckpt_dir=ck,
                                              log_every=1))
    st = tr.run(_pipe(bundle, 0, 2))
    jtr = JTrainer(jreg.build("llama3.2-3b", reduced=True).model,
                   make_test_mesh((1, 1), ("data", "model")),
                   JTrainConfig(num_steps=2))
    out, meta = jrestore(os.path.join(ck, "step_2", "state.ckpt"),
                         jtr.abstract_state())
    assert meta["step"] == 2
    flat = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(out)[0]}
    ours = {"/".join(p): t for p, t in
            tree.items({"params": st["params"], "opt": st["opt"]})}
    assert set(flat) == set(ours)
    for key, t in ours.items():
        assert np.asarray(flat[key]).tobytes() == _words(t), key


def test_reference_trainer_state_restores_in_the_port(tmp_path):
    """The reverse: the reference Trainer's initial state, saved by the
    reference, restored by the port's Trainer template."""
    jtr = JTrainer(jreg.build("llama3.2-3b", reduced=True).model,
                   make_test_mesh((1, 1), ("data", "model")),
                   JTrainConfig(num_steps=2))
    js = jtr.init_state()
    path = str(tmp_path / "ref.ckpt")
    jsave(path, js, meta={"step": 0})
    bundle, tr = _reduced_trainer(TrainConfig(num_steps=2))
    out, _ = restore_pytree(path, tr.abstract_state(), device="cpu")
    flat = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(js)[0]}
    for p, t in tree.items(out):
        assert _words(t) == np.asarray(flat["/".join(p)]).tobytes(), p
    assert out["params"]["embed"].dtype == bundle.cfg.pdtype


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

PAYLOADS = {
    "state": {"meta": json.dumps({"step": 7}), "leaves": {
        "opt/step": {"dtype": "int32", "shape": [], "data": b"\x07\0\0\0"},
        "params/w": {"dtype": "float32", "shape": [3, 4],
                     "data": bytes(range(48))}}},
    "wide": {"meta": "x" * 300, "leaves": {
        f"k{i}": {"dtype": "bfloat16", "shape": [i, 70000, 2 ** 33],
                  "data": b"\1" * (i * 40)} for i in range(20)}},
    "ints": {"meta": "", "leaves": {"a": [0, 127, 128, 255, 256, 65535,
                                          65536, 2 ** 32, -1, -33, -200,
                                          -40000, -2 ** 40]}},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_msgpack_bytes_equal_the_library(name):
    obj = PAYLOADS[name]
    assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    back = _msgpack.unpackb(msgpack.packb(obj, use_bin_type=True))
    assert _bytes(back) == obj


def _bytes(obj):
    """A decoded payload with its memoryviews as bytes."""
    if isinstance(obj, dict):
        return {k: _bytes(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_bytes(v) for v in obj]
    return bytes(obj) if isinstance(obj, memoryview) else obj


def test_msgpack_of_a_real_checkpoint(tmp_path):
    """The payload of a saved state decodes with the library to what the
    port encoded."""
    path = str(tmp_path / "s.ckpt")
    save_pytree(path, _state(), meta={"step": 1})
    with open(path, "rb") as f:
        raw = store._decompress(f.read())
    lib = msgpack.unpackb(raw, raw=False)
    assert msgpack.packb(lib, use_bin_type=True) == raw
    assert sorted(lib["leaves"]) == ["opt/step", "params/b", "params/w"]
    assert lib["leaves"]["params/b"]["dtype"] == "bfloat16"


# ---------------------------------------------------------------------------
# without zstandard
# ---------------------------------------------------------------------------

def test_without_zstd_saves_zlib(tmp_path, monkeypatch):
    monkeypatch.setattr(store, "zstd", None)
    path = str(tmp_path / "s.ckpt")
    save_pytree(path, _state())
    with open(path, "rb") as f:
        assert f.read(5) == b"RPK1d"
    out, _ = restore_pytree(path, _template(_state()))
    _equal_trees(out, _state())


def test_without_zstd_a_zstd_file_raises_as_the_reference(tmp_path,
                                                          monkeypatch):
    path = str(tmp_path / "s.ckpt")
    with open(path, "wb") as f:
        f.write(b"RPK1z" + b"\0" * 16)
    monkeypatch.setattr(store, "zstd", None)
    monkeypatch.setattr(jstore, "zstd", None)
    with pytest.raises(RuntimeError) as got:
        restore_pytree(path, _template(_state()))
    with pytest.raises(RuntimeError) as want:
        jrestore(path, {})
    assert str(got.value) == str(want.value)
    assert "zstandard" in str(got.value)


def test_unknown_codec_tag_raises(tmp_path):
    path = str(tmp_path / "s.ckpt")
    with open(path, "wb") as f:
        f.write(b"RPK1q" + b"\0" * 16)
    with pytest.raises(ValueError, match="codec"):
        restore_pytree(path, _template(_state()))
