"""Bounded asynchronous dispatch with depth-lagged readback.

Port of ``repro/core/dispatch.py`` (``DispatchQueue`` at :34) for CUDA
streams: the host keeps up to ``depth`` device steps in flight and reads
each step's small output vector ``depth`` steps later, so steady-state
decode never waits on the device.  Each submitted step's readback vector is
copied ``non_blocking`` into pinned host memory and a CUDA event is
recorded behind the copy; :meth:`Readback.wait` synchronises on that event
only.  ``depth=0`` synchronises every step (the paper's blocking
dispatcher).  On the CPU the copy is a plain clone and nothing waits.
"""
from __future__ import annotations

import collections
from typing import Callable

import numpy as np
import torch


class Readback:
    """Host copy of a device vector, valid once :meth:`wait` returns."""

    def __init__(self, value: torch.Tensor):
        if value.device.type == "cuda":
            self._host = torch.empty(value.shape, dtype=value.dtype,
                                     pin_memory=True)
            self._host.copy_(value, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(value.device))
        else:
            self._host = value.detach().clone()
            self._event = None

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class DispatchQueue:
    """Keeps at most ``depth`` dispatched-but-unfinished steps in flight.

    :meth:`submit` takes the step to run (the engine's greedy or sampled
    decode step): ``step_fn(*args)`` enqueues one device step and returns
    the vector the host will read back; ``submit`` returns its
    :class:`Readback`.  All steps share the queue, in submit order.
    """

    def __init__(self, *, depth: int = 2):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.depth = depth
        self._inflight: collections.deque = collections.deque()

    def submit(self, step_fn: Callable, *args) -> Readback:
        rb = Readback(step_fn(*args))
        if self.depth == 0:
            rb.wait()
            return rb
        self._inflight.append(rb)
        while len(self._inflight) > self.depth:
            self._inflight.popleft().wait()
        return rb

    def drain(self) -> None:
        while self._inflight:
            self._inflight.popleft().wait()
