"""The serving engine's captured steps: each one CUDA graph, the port's
counterpart of one of the reference's compiled steps
(``repro/runtime/serving/engine.py``).

  * :class:`DecodeGraph` — the decode step over the slot batch, greedy or
    sampled (``_compiled_decode_greedy`` / ``_compiled_decode``, :167-216;
    "one compiled step, always the same shape", :5-12);
  * :class:`ChunkGraph` — one prompt chunk of one length into any slot at
    any start (``_compiled_prefill_chunk``, :328-339, whose slot, start and
    last index are traced: the only compile key is the chunk length);
  * :class:`CapturedStep` — what both share, and the sampled first draw's
    graph itself (the reference draws it inside its compiled prefill);
  * under speculative decoding, the draft's micro-step (a
    :class:`DecodeGraph` over the draft arena, ``_compiled_draft_propose``
    / ``_greedy``, :255-284) and the verify step of each ladder rung (a
    :class:`ChunkGraph` of kind "verify", ``_compiled_verify`` /
    ``_greedy``, :287-317), each in a greedy and a sampled twin.

The reference traces a step once and replays the compiled program; here a
step is captured once as a ``torch.cuda.CUDAGraph`` and replayed, so it
costs one graph launch instead of some thirty eager ops per layer, each
with its Python dispatch (and each kernel call its ctypes call and, in
bf16, a host-side TMA-map encode).  What makes that valid:

  * the step reads and writes only tensors whose addresses never change:
    the engine's slot vectors (and, under prefix sharing, its donor
    table), its arena, its parameters and the graph's static inputs, all
    written in place; everything else it allocates
    comes from the graph's private pool and keeps its address across
    replays (the TMA maps the bf16 attention kernels encode at capture
    stay valid for that reason; the chunk kernel reads its slot through a
    device slot table, not a slot view whose address would change);
  * the step makes no host read (``tests/test_torch_graphs.py`` and
    ``tests/test_torch_chunk_graphs.py`` guard it);
  * a warm-up that leaves no trace runs first on the capture stream: it
    builds and loads the kernel libraries, sets their shared-memory
    attributes, encodes the TMA maps once, and allocates what lives
    outside the pool (cuBLAS's workspace on that stream, and the graph's
    own flash_decode arrival counters), none of which may happen under
    capture.  A decode (or draft) step warms up with every slot parked, a
    chunk (or verify) step at ``start = PARKED_POS``: neither writes the
    arena.

The pinned readback and its event (``core/dispatch.py``) stay outside the
graph: ``DispatchQueue.submit`` enqueues the copy of the static output on
the same stream right after each replay, so the next replay cannot
overwrite the output before it has been copied.
"""
from __future__ import annotations

import gc
import itertools
import time
from typing import Callable, Optional

import torch

from repro_torch.kernels import flash_decode, ops
from repro_torch.models.layers import PARKED_POS

_GRAPH_IDS = itertools.count()


def parked_warm_up(step: Callable[[], torch.Tensor], tokens: torch.Tensor,
                   pos: torch.Tensor,
                   active: Optional[torch.Tensor] = None) -> None:
    """Run ``step`` once with every slot parked, then put the slot vectors
    back as they were.

    Parked (``pos = PARKED_POS``, ``active = 0``), the step writes no arena
    row (dense row writes are masked to ``pos < max_seq``), no recurrent
    state (keep-masked on ``pos < PARKED_POS``), no token (kept where not
    active) and no position (``pos += active``); the vectors are restored
    all the same, so the engine's state is bit for bit what it was.  A
    step with no ``active`` vector (the draft micro-step, which moves every
    slot's token and position) writes them, and they are restored too.
    """
    vectors = [t for t in (tokens, pos, active) if t is not None]
    saved = [t.clone() for t in vectors]
    pos.fill_(PARKED_POS)
    if active is not None:
        active.zero_()
    step()
    for t, s in zip(vectors, saved):
        t.copy_(s)


def parked_chunk_warm_up(step: Callable[[], torch.Tensor],
                         scalars: torch.Tensor) -> None:
    """Run chunk ``step`` once at ``start = PARKED_POS``, then put its
    scalars (slot, start, last_idx, and under prefix sharing share_src,
    share_len) back.  Parked, the chunk writes no arena row (dense rows
    past max_seq are written back unchanged; the donor table is read
    only) and no recurrent state (keep-masked on ``start < PARKED_POS``),
    so the engine's state is bit for bit what it was."""
    saved = scalars.clone()
    scalars[1] = PARKED_POS
    step()
    scalars.copy_(saved)


class CapturedStep:
    """One step captured as a CUDA graph.

    ``step()`` enqueues the step on the current stream and returns its
    output; it must read and write only tensors that outlive the graph at
    fixed addresses and make no host read.  ``warm_up()`` runs the step
    once leaving no trace.  Construction runs ``warm_up`` on a side stream,
    then captures ``step`` on the same stream (into the private pool
    ``pool`` if given, shared with the graphs given the same handle, which
    must then never replay concurrently); both run under a flash_decode
    counter owner of the graph's own (``counters_owner``), so no other
    graph or stream shares its arrival counters.  A capture that fails
    raises.

    :meth:`replay` runs the captured step and returns its static output.
    The kernels' Python-side launch counters see no call on a replay, so
    each replay adds the launches the capture recorded
    (``ops.add_launches``); the capture itself launches nothing and its
    counts are taken back (the warm-up's launches were real and stay
    counted).  ``warmup_s`` / ``capture_s`` (wall seconds, synchronised)
    and ``pool_bytes`` (device memory the capture reserved: new segments
    of its private pool, which the caching allocator never serves from
    blocks it already holds; a capture into a shared pool reserves only
    what the pool's segments cannot serve) say what the graph cost.
    """

    def __init__(self, step: Callable[[], torch.Tensor],
                 warm_up: Callable[[], None], device: torch.device, *,
                 kind: str, pool=None):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {device}")
        self.counters_owner = f"{kind} graph {next(_GRAPH_IDS)}"
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), \
                flash_decode.owned_counters(self.counters_owner):
            warm_up()
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # a dead engine's graphs and pinned buffers, freed by the cyclic
        # garbage collector in the middle of the capture, would invalidate
        # it (their teardown destroys graphs and records events, which a
        # capturing process may not do): hold the collector off until the
        # capture has ended (a full collection first would cost ~0.2 s)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream), \
                    flash_decode.owned_counters(self.counters_owner):
                # read inside: entering the capture empties the allocator's
                # cache, which would shrink the reserved memory read before
                reserved = torch.cuda.memory_reserved(device)
                self.out = step()
                self.pool_bytes = (torch.cuda.memory_reserved(device)
                                   - reserved)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
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


class DecodeGraph(CapturedStep):
    """One captured decode step over the slot batch: ``step()`` reads and
    writes the slot vectors ``tokens``, ``pos``, ``active`` in place and
    returns what the host reads back, for the engine's greedy and sampled
    steps one (2, slots) int64 tensor of the tokens over the per-slot
    finite flags (one copy, no second readback); it warms up with every
    slot parked (:func:`parked_warm_up`).  ``kind="draft"``: the speculative
    draft's micro-step (the reference's ``_compiled_draft_propose`` /
    ``_greedy``, engine.py:255-284) over the draft arena, which feeds its
    proposal back into ``tokens`` and advances every ``pos`` by one (no
    ``active``), so the k micro-steps of a round are k replays with no
    host write between them; it returns the proposals alone (no flag, as
    in the reference: a poisoned target shows in the verify's flag)."""

    def __init__(self, step: Callable[[], torch.Tensor],
                 tokens: torch.Tensor, pos: torch.Tensor,
                 active: Optional[torch.Tensor] = None, *,
                 kind: str = "decode"):
        super().__init__(step,
                         lambda: parked_warm_up(step, tokens, pos, active),
                         pos.device, kind=kind)


class ChunkGraph(CapturedStep):
    """One captured chunk step of length C: ``step()`` ingests a static
    (1, C) int64 token buffer into arena slot ``scalars[0]`` at ``start =
    scalars[1]`` with its last real token at ``scalars[2]`` (``scalars``:
    (3,) int64 on the device; (5,) under prefix sharing, rows [0,
    ``scalars[4]``) read from slot ``scalars[3]``, so one graph a length
    serves pure slots and forks) and returns the (1, V) f32 logits there.  The
    caller writes both buffers in place before each replay.  It warms up
    parked (:func:`parked_chunk_warm_up`); ``pool``: the private pool the
    engine's chunk graphs share (they replay one at a time, on one
    stream).  ``kind="verify"``: the speculative verify step of one
    ladder rung k (the reference's ``_compiled_verify`` / ``_greedy``,
    engine.py:287-317): ``LM.verify_chunk`` over a static (1, k) token
    buffer at (slot, start) = ``scalars``, then the draws at all k
    positions and the finite flag, returned as a (draws, ok) pair."""

    def __init__(self, step: Callable[[], torch.Tensor],
                 scalars: torch.Tensor, *, pool=None, kind: str = "chunk"):
        super().__init__(step, lambda: parked_chunk_warm_up(step, scalars),
                         scalars.device, kind=kind, pool=pool)
