"""Batched serving example: prefill + queued decode across families.

Port of ``examples/serve_lm.py``: three architectures (dense, moe, ssm)
served through the same surface, ``launch.serve.generate``, the dispatch
queue keeping decode steps in flight.  Run:

    python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.launch.serve import generate
from repro_torch.models import registry

ARCHS = ("llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-2.7b")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        bundle = registry.build(arch, reduced=True, device=args.device)
        cfg = bundle.cfg
        params = bundle.model.init(0)
        prompts = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
        t0 = time.perf_counter()
        toks = generate(bundle, params, prompts, gen_tokens=24, depth=2)
        dt = time.perf_counter() - t0
        assert toks.shape == (4, 24)
        assert (toks >= 0).all() and (toks < cfg.vocab).all()
        print(f"{arch:18s} 4 reqs x 24 tokens in {dt:5.2f}s "
              f"({4 * 24 / dt:6.1f} tok/s)  first: {toks[0][:8]}")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
