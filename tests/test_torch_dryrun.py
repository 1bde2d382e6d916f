"""The port's dry run (``launch/dryrun.py``), its shape grid
(``models/registry.py``) and its report (``launch/make_report.py``) on
the CPU.

  * ``model_flops``, ``grid_cells(include_skips=True)`` (32 runnable + 8
    skips, reasons equal) and every cell's non-cache input shapes equal
    the reference's for all 40 cells.  The reference is run in a
    subprocess: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
    devices at import, which would leak into every later JAX test of a
    pytest worker.
  * The same reduced step counts the same integers on meta and on the
    CPU (FLOPs, bytes, transcendentals, dot FLOPs, bytes by op, the
    kernels charged, the peak live bytes) for dense, moe, ssm, hybrid,
    vlm and encdec, in the train (AdamW, remat full), prefill and decode
    kinds.  The configs are the reduced ones in f32: the CPU path upcasts
    bf16 operands where the card's takes an f32-out GEMM (``head_logits``,
    ``head_f32``, ``moe._expert_dot``), so in bf16 the CPU runs other ops
    than meta and the card, which take the same branch.
  * A reduced dense forward's dot FLOPs equal their hand count, exactly.
  * The CLI writes the reference's keys for one traced (full-size
    llama3.2-3b decode_32k, meta tensors) and one skipped cell; every
    flag that needs a mesh raises with "1.11"; ``make_report`` renders
    the records.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from conftest import run_devices_subprocess  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.core import cost as C  # noqa: E402
from repro_torch.kernels.counting import counting_kernels  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import dryrun, make_report  # noqa: E402
from repro_torch.models import convert, registry  # noqa: E402
from repro_torch.runtime.trainer import TrainConfig  # noqa: E402

_REFERENCE = """
import json
from repro.launch import dryrun
from repro.configs.base import SHAPES
from repro.models import registry
out = {"grid": [list(c) for c in registry.grid_cells(include_skips=True)],
       "cells": {}}
for arch in registry.ARCH_NAMES:
    bundle = registry.build(arch)
    for name, shape in SHAPES.items():
        specs = bundle.input_specs(name)
        out["cells"][arch + "/" + name] = {
            "model_flops": dryrun.model_flops(bundle.cfg, shape),
            "inputs": {k: list(v.shape) for k, v in specs.items()
                       if k != "cache"}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = run_devices_subprocess(_REFERENCE, n_devices=1, timeout=600)
    return json.loads(out.strip().splitlines()[-1])


def test_grid_equals_reference(reference):
    got = [list(c) for c in registry.grid_cells(include_skips=True)]
    assert got == reference["grid"]
    assert len(got) == 40 and sum(1 for c in got if c[2]) == 32
    assert [list(c[:2]) for c in registry.grid_cells()] == \
        [c[:2] for c in got if c[2]]


def test_model_flops_and_input_shapes_equal_reference(reference):
    for arch in registry.ARCH_NAMES:
        bundle = registry.build(arch, device="meta")
        for name, shape in SHAPES.items():
            want = reference["cells"][f"{arch}/{name}"]
            assert dryrun.model_flops(bundle.cfg, shape) == \
                want["model_flops"], (arch, name)
            specs = bundle.input_specs(name)
            got = {k: list(v.shape) for k, v in specs.items()
                   if k != "cache"}
            assert got == want["inputs"], (arch, name)
            assert all(t.device.type == "meta"
                       for t in tree.leaves(specs)), (arch, name)


def test_model_flops_llama_training_step():
    """90.80 TFLOP a llama3.2-3b step at B 4 x S 1024, the figure the
    smoke's training phase printed before it read ``model_flops``."""
    cfg = registry.config("llama3.2-3b")
    got = dryrun.model_flops(cfg, ShapeConfig("t", 1024, 4, "train"))
    assert round(got / 1e12, 2) == 90.80


# ---------------------------------------------------------------------------
# the same step counts the same integers on meta and on the CPU
# ---------------------------------------------------------------------------

ARCHS = {"dense": "llama3.2-3b", "moe": "qwen2-moe-a2.7b",
         "ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b",
         "vlm": "llava-next-34b", "encdec": "whisper-large-v3"}
SMALL = {"train": ShapeConfig("t", 16, 2, "train"),
         "prefill": ShapeConfig("p", 16, 2, "prefill"),
         "decode": ShapeConfig("d", 16, 2, "decode")}


def _f32_reduced(arch):
    return dataclasses.replace(registry.config(arch).reduced(),
                               param_dtype="float32", act_dtype="float32")


def _specs(cfg, shape, device):
    fn = {"train": registry.train_batch_specs,
          "prefill": registry.prefill_specs,
          "decode": registry.decode_specs}[shape.kind]
    specs = fn(cfg, shape)
    if device == "meta":
        return specs
    return tree.map_(lambda t: torch.zeros(t.shape, dtype=t.dtype), specs)


def _count(arch, kind, device):
    cfg = _f32_reduced(arch)
    model = registry.build_model(cfg, device=device,
                                 kernels=counting_kernels())
    params = (convert.abstract_params(cfg) if device == "meta"
              else model.init(0))
    fn, inputs = dryrun.step_of(model, kind, _specs(cfg, SMALL[kind],
                                                    device),
                                TrainConfig(remat="full"), params)
    with C.CostMode() as mode:
        mode.track(inputs)
        fn()
    return {**mode.cost.counts(), "kernels": mode.kernels,
            "peak": mode.peak_bytes, "warnings": mode.cost.warnings}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_meta_and_cpu_count_the_same(family, kind):
    meta = _count(ARCHS[family], kind, "meta")
    cpu = _count(ARCHS[family], kind, "cpu")
    assert meta == cpu
    assert meta["flops"] > 0 and not meta["warnings"]
    attn = family != "ssm"
    if kind == "train":
        want = {}
        if attn:
            want.update(flash_attention=2 * cpu["kernels"].get(
                "flash_attention_bwd", 0))
            assert cpu["kernels"]["flash_attention_bwd"] > 0
        if family in ("ssm", "hybrid"):
            want.update(ssd=2 * cpu["kernels"]["ssd_bwd"])
        assert {k: v for k, v in cpu["kernels"].items()
                if k in ("flash_attention", "ssd")} == want


def test_counts_do_not_depend_on_the_first_call():
    """A device's first step builds the RoPE table the later ones reuse;
    ``step_of`` builds it first, so the count is the steady step's."""
    from repro_torch.models import layers
    for key in [k for k in layers._FREQS if k[2] == "meta"]:
        del layers._FREQS[key]
    first = _count(ARCHS["dense"], "prefill", "meta")
    assert first == _count(ARCHS["dense"], "prefill", "meta")


def test_dense_forward_dot_flops_hand_count():
    cfg = _f32_reduced("llama3.2-3b")
    model = registry.build_model(cfg, device="meta",
                                 kernels=counting_kernels())
    b, s = 2, 16
    with torch.no_grad(), C.CostMode() as mode:
        model.prefill(convert.abstract_params(cfg),
                      torch.zeros((b, s), dtype=torch.int64, device="meta"),
                      model.init_cache(b, s))
    d, h, kvh, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    layer = (2 * b * s * d * (h + 2 * kvh) * hd      # q, k, v projections
             + 2 * b * s * h * hd * d                # output projection
             + 3 * 2 * b * s * d * ff                # gate, up, down
             + 4 * b * h * hd * s * (s + 1) // 2)    # the attention kernel
    head = 2 * b * d * cfg.vocab                     # the last row only
    assert mode.cost.dot_flops == cfg.n_layers * layer + head
    assert mode.kernels == {"flash_attention": cfg.n_layers}


# ---------------------------------------------------------------------------
# the CLI and the report
# ---------------------------------------------------------------------------

def test_cli_records_and_report(tmp_path, capsys):
    out = str(tmp_path)
    rc = dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                      "--shape", "long_500k", "--out", out])
    assert rc == 0
    names = sorted(os.listdir(out))
    assert names == ["llama3.2-3b__decode_32k__one-card__baseline.json",
                     "llama3.2-3b__long_500k__one-card__baseline.json"]
    with open(os.path.join(out, names[0])) as f:
        rec = json.load(f)
    for key in ("arch", "shape", "mesh", "chips", "kind", "n_params",
                "n_active_params", "roofline", "memory", "tag",
                "t_trace_s"):
        assert key in rec, key
    assert rec["mesh"] == "one-card" and rec["chips"] == 1
    for key in ("flops_per_chip", "hbm_bytes_per_chip",
                "wire_bytes_per_chip", "compute_s", "memory_s",
                "collective_s", "dominant", "model_flops_per_chip",
                "useful_flops_ratio", "roofline_fraction",
                "collective_counts", "dot_flops_per_chip",
                "collective_wire"):
        assert key in rec["roofline"], key
    assert rec["roofline"]["collective_s"] == 0
    assert rec["kernels"] == {"flash_decode": 28}
    # the KV cache of 128 slots x 32768 rows is read once a step: memory
    # bound, the cache alone 448 GiB at full size
    cache = 28 * 128 * 32768 * 8 * 128 * 2 * 2
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["roofline"]["hbm_bytes_per_chip"] > cache
    assert rec["memory"]["argument_size_in_bytes"] >= cache
    assert rec["memory"]["per_chip_gib"] > cache / 2 ** 30
    with open(os.path.join(out, names[1])) as f:
        skip = json.load(f)
    assert skip["skipped"] and "sub-quadratic" in skip["reason"]
    assert skip["tag"] == "baseline"
    text = make_report.report(out)
    assert "| llama3.2-3b | decode_32k | memo |" in text
    assert "| llama3.2-3b | long_500k |" in text
    assert "not measured" in text
    assert make_report.main([out]) == 0
    assert "decode_32k" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--mesh", "single"], ["--mesh", "multi"], ["--mesh", "both"],
    ["--rule", "batch=data"], ["--reduction", "hier"],
    ["--reduction", "hier_ef8"], ["--no-zero1"],
    ["--moe-dispatch", "local"], ["--tp-reduce", "bf16_dot"],
    ["--remat", "save_tp"]])
def test_mesh_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="1.11"):
        dryrun.main(flags + ["--arch", "llama3.2-3b", "--out",
                             str(tmp_path)])


def test_naive_attention_traces_the_plain_ops():
    """``--attn-impl naive`` charges the plain attention's aten ops in
    place of the kernel's cost: no kernel, and more bytes."""
    cfg = _f32_reduced("llama3.2-3b")
    counts = {}
    for naive in (False, True):
        model = registry.build_model(
            cfg, device="meta",
            kernels=counting_kernels(naive_attention=naive))
        with torch.no_grad(), C.CostMode() as mode:
            model.prefill(convert.abstract_params(cfg),
                          torch.zeros((2, 16), dtype=torch.int64,
                                      device="meta"),
                          model.init_cache(2, 16))
        counts[naive] = mode
    assert counts[True].kernels == {}
    assert counts[False].kernels == {"flash_attention": cfg.n_layers}
    assert counts[True].cost.bytes > counts[False].cost.bytes
