"""The serving decode step as one CUDA graph: the port's counterpart of the
reference's compiled greedy step (``repro/runtime/serving/engine.py``
``_compiled_decode_greedy``, :198-216; "one compiled step, always the same
shape", :5-12).

The reference traces its step once and replays the compiled program; here
the step is captured once as a ``torch.cuda.CUDAGraph`` and replayed, so a
decode step costs one graph launch instead of some thirty eager ops per
layer, each with its Python dispatch (and each kernel call its ctypes call
and, in bf16, a host-side TMA-map encode).  What makes that valid:

  * the step reads and writes only tensors whose addresses never change:
    the engine's slot vectors, its arena and its parameters, all written in
    place; everything else it allocates comes from the graph's private pool
    and keeps its address across replays (the TMA maps the bf16 attention
    kernels encode at capture stay valid for that reason);
  * the step makes no host read (``tests/test_torch_graphs.py`` guards it);
  * warm-up on the capture stream runs first: it builds and loads the
    kernel libraries, sets their shared-memory attributes, encodes the TMA
    maps once, and allocates what lives outside the pool (cuBLAS's
    workspace on that stream, and the graph's own flash_decode arrival
    counters), none of which may happen under capture.

The pinned readback and its event (``core/dispatch.py``) stay outside the
graph: ``DispatchQueue.submit`` enqueues the copy of the static output on
the same stream right after each replay, so the next replay cannot
overwrite the output before it has been copied.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable

import torch

from repro_torch.kernels import flash_decode, ops
from repro_torch.models.layers import PARKED_POS

_GRAPH_IDS = itertools.count()


def parked_warm_up(step: Callable[[], torch.Tensor], tokens: torch.Tensor,
                   pos: torch.Tensor, active: torch.Tensor) -> None:
    """Run ``step`` once with every slot parked, then put the slot vectors
    back as they were.

    Parked (``pos = PARKED_POS``, ``active = 0``), the step writes no arena
    row (dense row writes are masked to ``pos < max_seq``), no recurrent
    state (keep-masked on ``pos < PARKED_POS``), no token (kept where not
    active) and no position (``pos += active``); the vectors are restored
    all the same, so the engine's state is bit for bit what it was.
    """
    saved = [t.clone() for t in (tokens, pos, active)]
    pos.fill_(PARKED_POS)
    active.zero_()
    step()
    for t, s in zip((tokens, pos, active), saved):
        t.copy_(s)


class DecodeGraph:
    """One captured decode step over the slot batch.

    ``step()`` enqueues the step on the current stream and returns the
    vector the host reads back; it must read and write only tensors that
    outlive the graph at fixed addresses (``tokens``, ``pos``, ``active``
    among them) and make no host read.  Construction warms up on a side
    stream with every slot parked (:func:`parked_warm_up`), then captures
    ``step`` on the same stream; both run under a flash_decode counter
    owner of the graph's own (``counters_owner``), so no other graph or
    stream shares its arrival counters.  A capture that fails raises.

    :meth:`replay` runs the captured step and returns its static output.
    The kernels' Python-side launch counters see no call on a replay, so
    each replay adds the launches the capture recorded
    (``ops.add_launches``); the capture itself launches nothing and its
    counts are taken back.  ``warmup_s`` / ``capture_s`` (wall seconds,
    synchronised) and ``pool_bytes`` (device memory the capture reserved:
    the segments of the graph's private pool, which the caching allocator
    never serves from blocks it already holds) say what the graph cost.
    """

    def __init__(self, step: Callable[[], torch.Tensor],
                 tokens: torch.Tensor, pos: torch.Tensor,
                 active: torch.Tensor):
        dev = pos.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {dev}")
        self.counters_owner = f"decode graph {next(_GRAPH_IDS)}"
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), \
                flash_decode.owned_counters(self.counters_owner):
            parked_warm_up(step, tokens, pos, active)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=stream), \
                flash_decode.owned_counters(self.counters_owner):
            # read inside: entering the capture empties the allocator's
            # cache, which would shrink the reserved memory read before it
            reserved = torch.cuda.memory_reserved(dev)
            self.out = step()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        #: {kernel name: launches} one replay runs
        self.launches = {k: n - before[k]
                         for k, n in ops.launch_counts().items()
                         if n != before[k]}
        ops.add_launches({k: -n for k, n in self.launches.items()})
        self.replays = 0

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        ops.add_launches(self.launches)
        self.replays += 1
        return self.out
