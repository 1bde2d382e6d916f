"""Trainer: the train step and the fault-tolerant run loop.

Port of ``repro/runtime/trainer.py`` on one device.  The step is the
reference's ``reduction="gspmd"`` step: the loss and its gradients
(``grad_accum_chained`` over ``microbatches``), the cosine learning rate
at the optimizer's step, AdamW.  The other reductions (``hier``,
``hier_tree``, ``hier_ef8``) are schedules of the data-parallel
all-reduce and come with the multi-device port (ROADMAP 1.11).

On the card every attention layer runs the hand-written forward kernel
(twice under ``remat="full"``: the forward and its recompute) and the
hand-written backward kernel, and every SSD layer (mamba2, hymba) the
``ssd`` kernel twice and the ``ssd_bwd`` kernel once; there is no
plain-path fallback.

The run loop keeps the reference's contract: data that is a pure function
of the step index, the loss read once a step (the reference's
``block_until_ready``), a history record every ``log_every`` steps (and
for every straggler step), a checkpoint every ``ckpt_every`` steps and at
the end, and restart from the latest complete checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional

from repro_torch.core import chaining
from repro_torch.models import convert
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)

#: the families whose training path the port has: every family it serves
TRAINED_FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 100
    microbatches: int = 1
    reduction: str = "gspmd"          # gspmd | hier | hier_tree | hier_ef8
    remat: str = "full"               # none | full | dots
    zero1: bool = True
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    seed: int = 0
    # run-loop
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    straggler_slack: float = 2.0      # step > slack × EWMA ⇒ straggler event
    dispatch_depth: int = 2


def make_train_step(model, tcfg: TrainConfig,
                    adamw: Optional[AdamWConfig] = None) -> Callable:
    """The train step for ``model`` (reference :140, ``gspmd`` only):
    ``step(params, opt, batch) -> (params, opt, metrics)``, the params and
    the optimizer state updated in place; metrics {"grad_norm", "loss",
    "lr"} as 0-d device tensors."""
    if tcfg.reduction != "gspmd":
        raise NotImplementedError(
            f"reduction={tcfg.reduction!r} is a schedule of the "
            f"data-parallel all-reduce: it comes with the multi-device "
            f"port (ROADMAP 1.11); one device takes 'gspmd'")
    adamw = adamw or AdamWConfig(weight_decay=tcfg.weight_decay,
                                 clip_norm=tcfg.clip_norm)
    lr_fn = partial(cosine_schedule, peak_lr=tcfg.peak_lr,
                    warmup_steps=tcfg.warmup_steps,
                    total_steps=tcfg.num_steps)

    def loss_of(params, batch):
        loss, _ = model.loss_fn(params, batch, remat=tcfg.remat)
        return loss

    def step(params, opt, batch):
        loss, grads = chaining.grad_accum_chained(
            loss_of, params, batch, num_microbatches=tcfg.microbatches)
        lr = lr_fn(opt["step"])
        params, opt, metrics = adamw_update(params, grads, opt, lr, adamw)
        metrics.update(loss=loss, lr=lr)
        return params, opt, metrics

    return step


class StragglerMonitor:
    """Per-step wall-time EWMA; flags steps slower than ``slack`` x the
    mean (reference :280).  Stragglers do not move the baseline."""

    def __init__(self, *, slack: float = 2.0, alpha: float = 0.1):
        self.slack = slack
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.slack * self.ewma)
        if is_straggler:
            self.events.append((step, dt, self.ewma))
        else:   # stragglers don't poison the baseline estimate
            self.ewma = dt if self.ewma is None \
                else (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class Trainer:
    """Checkpoint-restarting training driver for one model on its device
    (reference :308)."""

    def __init__(self, model, tcfg: TrainConfig,
                 adamw: Optional[AdamWConfig] = None):
        self.model = model
        self.tcfg = tcfg
        self.step_fn = make_train_step(model, tcfg, adamw)
        self.monitor = StragglerMonitor(slack=tcfg.straggler_slack)
        self._ckpt = None
        if tcfg.ckpt_dir:
            from repro_torch.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)

    # -- state ---------------------------------------------------------------
    def init_state(self) -> dict:
        """Params from the model's ``init(seed)``, AdamW's zero state."""
        params = self.model.init(self.tcfg.seed)
        return {"params": params, "opt": adamw_init(params)}

    def abstract_state(self) -> dict:
        """Meta tensors shaped like :meth:`init_state` (no storage)."""
        return convert.abstract_state(self.model.cfg)

    # -- checkpointing ---------------------------------------------------------
    def maybe_restore(self):
        """(state, start_step): restored from the latest complete
        checkpoint onto the model's device, or fresh."""
        if self._ckpt is not None:
            state, meta, _ = self._ckpt.restore_latest(
                self.abstract_state(), device=self.model.device)
            if state is not None:
                return state, int(meta["step"])
        return self.init_state(), 0

    # -- the loop --------------------------------------------------------------
    def run(self, batches, *, start_step: int = 0,
            state: Optional[dict] = None,
            hooks: Optional[list[Callable]] = None) -> dict:
        """Train until tcfg.num_steps.  ``batches``: an iterator of device
        batches aligned with ``start_step``.  Returns the final state, the
        host metrics history under "_history"."""
        tcfg = self.tcfg
        if state is None:
            state, start_step = self.maybe_restore()
        history = []
        it = iter(batches)
        for step in range(start_step, tcfg.num_steps):
            batch = next(it)
            t0 = time.perf_counter()
            p, o, metrics = self.step_fn(state["params"], state["opt"], batch)
            state = {"params": p, "opt": o}
            del batch
            loss = metrics["loss"].item()         # the step's one host read
            dt = time.perf_counter() - t0
            straggler = self.monitor.observe(step, dt)
            if hooks:
                for h in hooks:
                    h(step, state, metrics)
            if step % tcfg.log_every == 0 or straggler:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(loss=loss, step=step, dt=dt, straggler=straggler)
                history.append(rec)
            if (self._ckpt is not None and step > 0
                    and step % tcfg.ckpt_every == 0):
                self._ckpt.save(step + 1, state, meta={"step": step + 1})
        if self._ckpt is not None:
            self._ckpt.save(tcfg.num_steps, state,
                            meta={"step": tcfg.num_steps})
            self._ckpt.wait()
        state["_history"] = history
        return state
