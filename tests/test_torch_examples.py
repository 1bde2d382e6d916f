"""The port's examples (``repro_torch.examples``), its ``launch.serve``
batch wrapper (``make_engine`` / ``generate``) and its copy of the paper's
cycle model (``core/vu_model.py``) against the JAX package, on the CPU.

  * ``vu_model`` equals ``benchmarks.vu_model`` over a grid of (n, lanes,
    VL bytes, EEW), float for float (the same Python arithmetic).
  * ``generate`` equals the reference's ``generate`` token for token on
    reduced llama3.2-3b, qwen2-moe-a2.7b and mamba2-2.7b with the same
    numpy-made weights, in f32 (the reduced configs' param and activation
    dtypes set to float32, so the argmaxes do not hang on bf16 rounding
    that differs between XLA and PyTorch).
  * Each example runs with ``--device cpu`` (quickstart's training at 20
    steps, ``train_lm`` reduced at 3 steps and restarted from its
    checkpoint), and quickstart's vector-unit values equal the
    reference's.
"""
import dataclasses
import itertools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import vu_model as jvu  # noqa: E402
from repro.core import masking as jmasking  # noqa: E402
from repro.core import reduction as jreduction  # noqa: E402
from repro.core import vrf as jvrf  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import llama3_2_3b  # noqa: E402
from repro_torch.core import vu_model  # noqa: E402
from repro_torch.examples import (quickstart, serve_lm,  # noqa: E402
                                  train_lm, vector_unit_demo)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402

from test_torch_model import bridged  # noqa: E402


def test_vu_model_equals_reference():
    for n, lanes in itertools.product((16, 32, 64, 128, 256),
                                      (2, 4, 8, 16)):
        assert vu_model.matmul_cycles(n, lanes) == \
            jvu.matmul_cycles(n, lanes)
        assert vu_model.matmul_cycles(n, lanes, issue_rate=0.2) == \
            jvu.matmul_cycles(n, lanes, issue_rate=0.2)
    for vlb, lanes, eew in itertools.product((64, 512, 4096), (2, 4, 8, 16),
                                             (1, 2, 4, 8)):
        assert vu_model.reduction_cycles(vlb, lanes, eew) == \
            jvu.reduction_cycles(vlb, lanes, eew)
    for hw, cout, lanes in itertools.product((32, 64, 112), (8, 64),
                                             (2, 4, 16)):
        assert vu_model.conv2d_cycles(hw, hw, 3, cout, 7, lanes) == \
            jvu.conv2d_cycles(hw, hw, 3, cout, 7, lanes)
    assert vu_model.TABLE_II == jvu.TABLE_II
    assert vu_model.PAPER_CLAIMS == jvu.PAPER_CLAIMS


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               act_dtype="float32")


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_generate_equals_reference(arch):
    cfg = _f32(jreg.config(arch).reduced())
    jm, jp, tm, tp = bridged(cfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 24)).astype(np.int32)
    want = jserve.generate(jreg.Bundle(arch, cfg, jm), jp, prompts,
                           gen_tokens=12, depth=2)
    got = serve.generate(registry.Bundle(arch, tm.cfg, tm), tp, prompts,
                         gen_tokens=12, depth=2)
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_make_engine_takes_a_config_or_its_fields():
    cfg = _f32(jreg.config("llama3.2-3b").reduced())
    _, _, tm, tp = bridged(cfg)
    bundle = registry.Bundle("llama3.2-3b", tm.cfg, tm)
    eng = serve.make_engine(bundle, tp, max_slots=2, max_seq=40)
    assert (eng.config.max_slots, eng.config.max_seq) == (2, 40)
    again = serve.make_engine(bundle, tp, config=eng.config, max_slots=3)
    assert (again.config.max_slots, again.config.max_seq) == (3, 40)


def _reference_vector_unit_values() -> dict:
    """The reference quickstart's part 1 (examples/quickstart.py:11-32)."""
    mem = jnp.arange(64, dtype=jnp.uint8)
    lane_view = jvrf.shuffle(mem, eew=2, lanes=4)
    x = jnp.arange(128.0)
    total = jreduction.lane_tree_reduce(x, lanes=16, eew_bytes=8)
    bits = jnp.asarray([True, False] * 32)
    packed = jmasking.pack_bits(bits, 64)
    img = jnp.zeros(64, jnp.uint8).at[:packed.size].set(packed)
    lanes_view = jvrf.shuffle(img, eew=4, lanes=4)
    pred = jmasking.mask_unit(lanes_view, stored_eew=4, lanes=4,
                              num_elems=64)
    return {"element5_lane_bytes": np.asarray(lane_view[1, 2:4]).tolist(),
            "lane_tree_reduce": float(total), "flat_sum": float(x.sum()),
            "ideal_cycles_16": jreduction.ideal_cycles(1024, 16),
            "lane0_predicates": np.asarray(pred[0, :8]).tolist()}


def test_quickstart_vector_unit_values_equal_reference():
    assert quickstart.vector_unit_values(torch.device("cpu")) == \
        _reference_vector_unit_values()


def test_quickstart_runs_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert "lane_tree_reduce == 8128.0" in out and out.endswith("OK\n")


def test_serve_lm_runs_on_the_cpu(capsys):
    assert serve_lm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert all(arch in out for arch in serve_lm.ARCHS)
    assert out.endswith("OK\n")


def test_train_lm_runs_and_restarts_on_the_cpu(tmp_path, capsys,
                                               monkeypatch):
    """At the smoke-test width (f32) in place of the example's ~100M
    parameters, to stay quick on the CPU."""
    monkeypatch.setattr(train_lm, "config", lambda: dataclasses.replace(
        llama3_2_3b.CONFIG.reduced(), param_dtype="float32",
        act_dtype="float32"))
    args = ["--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    assert train_lm.main(args + ["--steps", "3"]) == 0
    first = capsys.readouterr().out
    assert "final loss" in first and "resuming" not in first
    assert train_lm.main(args + ["--steps", "5"]) == 0
    assert "resuming from checkpoint at step 3" in capsys.readouterr().out


def test_vector_unit_demo_runs_on_the_cpu(capsys):
    assert vector_unit_demo.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "reshuffles injected: 1" in out and "tail preserved" in out
    assert vector_unit_demo.reshuffle_demo(torch.device("cpu"))[
        "reshuffles"] == 1


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        vector_unit_demo.main([])
