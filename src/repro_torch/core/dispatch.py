"""Bounded asynchronous dispatch with depth-lagged readback.

Port of ``repro/core/dispatch.py`` (``DispatchQueue`` at :34) for CUDA
streams: the host keeps up to ``depth`` device steps in flight and reads
each step's small output vector ``depth`` steps later, so steady-state
decode never waits on the device.  Each submitted step's readback vector is
copied ``non_blocking`` into pinned host memory and a CUDA event is
recorded behind the copy; :meth:`Readback.wait` synchronises on that event
only.  ``depth=0`` synchronises every step (the paper's blocking
dispatcher).  On the CPU the copy is a plain clone and nothing waits.

:class:`HostStaging` is the other direction: small host values (a chunk's
tokens, a captured step's scalars) copied ``non_blocking`` from pinned
memory into device buffers, so writing them never waits on the steps in
flight.
"""
from __future__ import annotations

import collections
import time
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


class HostStaging:
    """Host-to-device writes of small values that do not wait on the device.

    :meth:`write` puts ``values`` into device tensor ``dst`` in place: into
    one of ``ring`` pinned staging buffers of ``nbytes`` bytes, then
    ``dst.copy_(..., non_blocking=True)`` on the current stream, a CUDA
    event recorded behind the copy.  A buffer is reused only once its
    event has completed (the host waits on it then: with a ring much longer
    than the copies a step makes, it has long completed; :meth:`write`
    returns the seconds it waited).  A pageable copy would instead wait for
    every step in flight on the stream.  For a CPU ``dst`` the values are
    copied directly.
    """

    def __init__(self, device, *, nbytes: int, ring: int = 64):
        self.device = torch.device(device)
        self.nbytes = -(-nbytes // 16) * 16
        self._next = 0
        if self.device.type == "cuda":
            self._host = torch.empty((ring, self.nbytes), dtype=torch.uint8,
                                     pin_memory=True)
            self._events = [torch.cuda.Event() for _ in range(ring)]

    def write(self, dst: torch.Tensor, values) -> float:
        src = torch.as_tensor(np.asarray(values), dtype=dst.dtype).reshape(
            dst.shape)
        if self.device.type != "cuda":
            dst.copy_(src)
            return 0.0
        n = src.numel() * src.element_size()
        if n > self.nbytes:
            raise ValueError(f"{n} bytes to stage, buffers hold "
                             f"{self.nbytes}")
        i = self._next
        self._next = (i + 1) % len(self._events)
        t0 = time.perf_counter()
        self._events[i].synchronize()
        waited = time.perf_counter() - t0
        buf = self._host[i, :n].view(dst.dtype).view(dst.shape)
        buf.copy_(src)
        dst.copy_(buf, non_blocking=True)
        self._events[i].record(torch.cuda.current_stream(self.device))
        return waited
