"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro/launch/train.py`` (flags :27-45) on one device, the card
unless ``--device cpu``: random init from ``--seed`` (the reference's
``TrainConfig.seed``), the synthetic data pipeline with prefetch, the
train step (attention through the hand-written forward and backward
kernels on the card), checkpoint-restart, straggler monitoring.  On the
card: ``python -m repro_torch.launch.train --arch llama3.2-3b --full
--steps 6 --batch 4 --seq 1024``.

``--reduced`` (the default) trains the smoke-test width, ``--full`` the
published config.  Every family trains: mamba2 and hymba's SSD layers
through the hand-written ``ssd`` and ``ssd_bwd`` kernels on the card
(``--arch mamba2-2.7b --full --steps 6 --batch 2 --seq 2048``).
``--data-axis`` / ``--model-axis`` take 1 only, and ``--reduction``
``gspmd`` only: the other values need the multi-device port (ROADMAP
1.11); ``--remat save_tp`` likewise.  Prints the reference's lines: the
mesh, the starting step, and the loss from the first log record to the
last.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ShapeConfig
from repro_torch.data import family_extras_fn, make_pipeline
from repro_torch.models import registry
from repro_torch.runtime.trainer import Trainer, TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=list(registry.ARCH_NAMES))
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--reduction", default="gspmd",
                   choices=["gspmd", "hier", "hier_tree", "hier_ef8"])
    p.add_argument("--remat", default="full",
                   choices=["none", "full", "dots", "save_tp"])
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data-axis", type=int, default=None,
                   help="data-axis size (one device: 1)")
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None, *, out: dict = None):
    """Train as the flags say.  ``out``, when given, receives the trainer
    and the final state (``"trainer"``, ``"state"``) for a caller that
    inspects them."""
    args = parse_args(argv)
    if (args.data_axis or 1) != 1 or args.model_axis != 1:
        raise NotImplementedError(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis}: "
            f"a mesh of more than one device comes with the multi-device "
            f"port (ROADMAP 1.11)")
    print("mesh: data=1 model=1 (1 devices)")
    bundle = registry.build(args.arch, reduced=args.reduced,
                            device=args.device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(
        num_steps=args.steps, reduction=args.reduction, remat=args.remat,
        microbatches=args.microbatches, peak_lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=args.log_every, seed=args.seed)
    trainer = Trainer(bundle.model, tcfg)
    state, start = trainer.maybe_restore()
    print(f"starting at step {start}")
    pipe = make_pipeline(
        bundle.cfg, shape, start_step=start, num_steps=args.steps - start,
        device=bundle.model.device, extras_fn=family_extras_fn(bundle.cfg))
    state = trainer.run(pipe, start_step=start, state=state)
    hist = state["_history"]
    print(f"done: {len(hist)} log records; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    if trainer.monitor.events:
        print(f"straggler events: {trainer.monitor.events}")
    if out is not None:
        out.update(trainer=trainer, state=state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
