"""Quickstart: the paper's vector-unit semantics + a short LM train.

Port of ``examples/quickstart.py``.  Run:

    python -m repro_torch.examples.quickstart [--device cpu] [--steps 50]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import device as device_mod
from repro_torch.core import masking, reduction, vrf


def vector_unit_values(device) -> dict:
    """The paper's core mechanisms as library calls: the RVV 1.0 byte
    layout (§IV), the 3-step reduction (§V.e), the mask unit (§IV.D.1)."""
    mem = torch.arange(64, dtype=torch.uint8, device=device)
    lane_view = vrf.shuffle(mem, eew=2, lanes=4)   # 16-bit elements, 4 lanes
    back = vrf.deshuffle(lane_view, eew=2, lanes=4)
    assert torch.equal(back, mem)
    x = torch.arange(128.0, device=device)
    total = reduction.lane_tree_reduce(x, lanes=16, eew_bytes=8)
    bits = torch.tensor([True, False] * 32, device=device)
    packed = masking.pack_bits(bits, 64)
    img = torch.zeros(64, dtype=torch.uint8, device=device)
    img[:packed.numel()] = packed
    lanes_view = vrf.shuffle(img, eew=4, lanes=4)  # mask reg written at EEW=4
    pred = masking.mask_unit(lanes_view, stored_eew=4, lanes=4, num_elems=64)
    return {"element5_lane_bytes": lane_view[1, 2:4].cpu().tolist(),
            "lane_tree_reduce": float(total), "flat_sum": float(x.sum()),
            "ideal_cycles_16": reduction.ideal_cycles(1024, 16),
            "lane0_predicates": pred[0, :8].cpu().tolist()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--steps", type=int, default=50)
    args = p.parse_args(argv)
    dev = device_mod.resolve(args.device)

    vals = vector_unit_values(dev)
    print("== RVV 1.0 byte layout (paper §IV) ==")
    print("element 5 (bytes 10:12) lives in lane", 5 % 4, "->",
          vals["element5_lane_bytes"])
    print("\n== 3-step hierarchical reduction (paper §V.e) ==")
    print("lane_tree_reduce ==", vals["lane_tree_reduce"], "(flat sum:",
          vals["flat_sum"], ")")
    print("ideal cycles @16 lanes:", vals["ideal_cycles_16"])
    print("\n== Mask unit (paper §IV.D.1) ==")
    print("lane 0 predicates (elements 0,4,8,...):",
          vals["lane0_predicates"])

    print(f"\n== {args.steps}-step LM training (reduced qwen3-14b) ==")
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.models import registry
    from repro_torch.runtime.trainer import Trainer, TrainConfig

    bundle = registry.build("qwen3-14b", reduced=True, device=dev)
    tcfg = TrainConfig(num_steps=args.steps, log_every=10, peak_lr=1e-3)
    trainer = Trainer(bundle.model, tcfg)
    pipe = make_pipeline(bundle.cfg, ShapeConfig("qs", 64, 8, "train"),
                         num_steps=args.steps, device=dev)
    state = trainer.run(pipe)
    hist = state["_history"]
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({len(hist)} records)")
    assert hist[-1]["loss"] < hist[0]["loss"], "loss must decrease"
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
