"""The paper's experiments, interactively: Fig. 2 roofline, Table II
reductions, and the reshuffle-injection mechanism (§IV.D.2).

Port of ``examples/vector_unit_demo.py`` on the port's ``core/vu_model.py``
and ``core/vrf.py``.  Run:

    python -m repro_torch.examples.vector_unit_demo [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import device as device_mod
from repro_torch.core import vrf
from repro_torch.core.vu_model import (TABLE_II, matmul_cycles,
                                       reduction_cycles)


def fig2():
    print("== Fig. 2: fmatmul utilization vs n, lanes ==")
    print(f"{'n':>5} " + " ".join(f"l={lanes:<4}" for lanes in (2, 4, 8, 16)))
    for n in (16, 32, 64, 128, 256):
        row = [matmul_cycles(n, lanes)["utilization"]
               for lanes in (2, 4, 8, 16)]
        print(f"{n:>5} " + " ".join(f"{u:5.2f}" for u in row))
    print("(>0.985 at n=128, l=2 — the paper's headline)")


def table2():
    print("\n== Table II: reduction cycles (model vs paper) ==")
    for (lanes, vlb), (p8, p64) in sorted(TABLE_II.items()):
        m8 = reduction_cycles(vlb, lanes, 1)["model_cycles"]
        m64 = reduction_cycles(vlb, lanes, 8)["model_cycles"]
        print(f"  {lanes:>2} lanes {vlb:>5}B: model {m8:5.1f}/{m64:5.1f} "
              f"paper {p8}/{p64}")


def reshuffle_demo(device) -> dict:
    print("\n== §IV.D.2: reshuffle injection on EEW change ==")
    f = vrf.VectorRegisterFile(vlen_bits=512, lanes=4, device=device)
    img = torch.arange(64, dtype=torch.uint8, device=device)
    f.write(1, img, eew=8)                        # 64-bit write
    f.write(1, img + 100, eew=2, vl=8)            # partial 16-bit write
    print("  reshuffles injected:", f.stats["reshuffles"])
    out = f.read_mem_image(1)
    assert torch.equal(out[:16], (img + 100)[:16])
    assert torch.equal(out[16:], img[16:])
    print("  body updated, tail preserved (tail-undisturbed) ✓")
    return dict(f.stats)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    fig2()
    table2()
    reshuffle_demo(device_mod.resolve(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
