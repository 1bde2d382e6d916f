"""End-to-end training driver: a ~100M-parameter LM for a few hundred
steps, with checkpoint-restart, prefetch, straggler monitoring — the
production loop at a small scale.

Port of ``examples/train_lm.py`` (one device: the port's ``Trainer``
takes no mesh).  Run:

    python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

``--ckpt-dir`` (default ``build/train_lm``, relative to the working
directory) holds the checkpoints a rerun resumes from.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import llama3_2_3b
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_pipeline
from repro_torch.models import registry
from repro_torch.runtime.trainer import Trainer, TrainConfig


def config():
    """A ~100M-parameter llama3-family config (wider than the smoke's
    ``reduced()``), f32."""
    return dataclasses.replace(
        llama3_2_3b.CONFIG, n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab=32_000, head_dim=64, max_seq=1024,
        param_dtype="float32", act_dtype="float32")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--ckpt-dir", default="build/train_lm")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    cfg = config()
    print(f"model: {cfg.n_params() / 1e6:.1f}M params")
    model = registry.build_model(cfg, device=args.device)
    tcfg = TrainConfig(
        num_steps=args.steps, log_every=20, peak_lr=3e-4, warmup_steps=30,
        ckpt_dir=args.ckpt_dir, ckpt_every=100, remat="full")
    trainer = Trainer(model, tcfg)
    state, start = trainer.maybe_restore()
    if start:
        print(f"resuming from checkpoint at step {start}")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    pipe = make_pipeline(cfg, shape, start_step=start,
                         num_steps=args.steps - start, device=model.device)
    state = trainer.run(pipe, start_step=start, state=state)
    hist = state["_history"]
    if hist:
        print("loss trajectory:",
              [f"{h['step']}:{h['loss']:.3f}" for h in hist])
        toks = (args.steps - start) * args.batch * args.seq
        print(f"trained on {toks / 1e6:.1f}M tokens; final loss "
              f"{hist[-1]['loss']:.3f} (start {hist[0]['loss']:.3f})")
    if trainer.monitor.events:
        print("straggler events:", trainer.monitor.events)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
