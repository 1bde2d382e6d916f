"""Continuous-batching serving engine (port of ``repro/runtime/serving/
engine.py``'s ``ServingEngine``: greedy and sampled decode over any KV
storage format, ``EngineConfig.kv_format``).

The host runs scheduling and admission; the device runs one decode step
over the whole slot batch.  As in the reference:

  1. **One step over every slot.**  Dead slots keep decoding (masked): the
     new token is kept only where ``active``, and ``pos += active``
     freezes a dead slot's position (reference engine.py:199-216).
  2. **Steps flow through a DispatchQueue.**  ``depth`` steps stay in
     flight; the host reads step *i - depth*'s tokens (copied into pinned
     memory behind a CUDA event) while the device runs step *i*.  A
     finished slot decodes a few extra masked tokens that the host drops
     through the slot-generation guard.
  3. **One resident arena, written in place.**  Monolithic prefill writes
     the slot's rows of the arena directly through ``model.slot_view`` (no
     batch=1 cache + splice; a leaf's slot rows are f wide, f = n_heads for
     the fused SSD state), chunked prefill writes each chunk's rows or
     carried state, decode writes one row (or the new state) per slot per
     layer; the reference gets the same effect from buffer donation.
  4. **Captured steps.**  On the card each decode step is captured
     once as a CUDA graph (``graphs.DecodeGraph``) and replayed: the
     counterpart of the reference's compiled steps, always the same shape.
     As in the reference (engine.py:167-216) there are two: the sampled
     step (decode + ``sample_step`` over the five per-slot sampling
     vectors) and its pure-argmax twin.  The twin is captured at
     construction, the sampled step at the first sampled submit (the
     reference compiles it at its first call), and beside it the sampled
     first draw (``sample_step`` over one static logits row and six device
     scalars), which serves both prefill modes.  A step whose RUNNING
     slots are all greedy replays the twin, so greedy traffic pays nothing
     for sampling (``stats["sampled_steps"]`` counts the others).  Each
     chunk of chunked prefill replays one ``graphs.ChunkGraph`` per chunk
     length, captured at the first chunk of that length (the reference's
     ``_compiled_prefill_chunk`` compiles per length, its slot, start and
     last index traced): its tokens and (slot, start, last_idx) are
     device buffers written in place through pinned memory
     (``core.dispatch.HostStaging``), so no write waits on the steps in
     flight; the chunk graphs share one private pool and replay one at a
     time on one stream.  Monolithic prefill stays eager: it has one shape
     per prompt length, and a graph per length seen would hold a pool per
     length.  ``EngineConfig.decode_graph=False`` asks for eager decode
     steps and first draws, ``chunk_graph=False`` for eager chunk steps
     (through the same device buffers); on the CPU every step runs
     eagerly.
  5. **Keys fold (seed, position) only.**  A sampled slot's token at cache
     row q is drawn with ``fold_in(fold_in(PRNGKey(0), seed), q)``; the
     first token at q = prompt_len, off the prefill logits.  So a stream
     does not depend on its batch-mates, on chunking or on a preemption's
     recompute, and the slot-generation guard drops a step's token for a
     slot that was (re)admitted after the step was submitted, whichever of
     the two steps it was.

Prefill comes in two modes: monolithic (``prefill_chunks=None``; one call
per prompt) and chunked (bucket-sized chunks interleaved with decode under
a per-step token budget).  A slot being chunk-prefilled parks its position
at ``PARKED_POS``: in-flight decode steps then leave its rows untouched
(the row write is masked to ``pos < max_seq``; a recurrent state write is
keep-masked on ``pos < PARKED_POS``).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import kv_format as kvf
from repro_torch.core.dispatch import DispatchQueue, HostStaging, Readback
from repro_torch.models import layers as L
from repro_torch.models.layers import PARKED_POS
from repro_torch.runtime.serving import chunking, sampling
from repro_torch.runtime.serving.cache import PagedKVCacheManager
from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.graphs import (CapturedStep, ChunkGraph,
                                                DecodeGraph)
from repro_torch.runtime.serving.request import Request, RequestState, Status
from repro_torch.runtime.serving.scheduler import Scheduler


class ServingEngine:
    """Continuous-batching generation (greedy or sampled, per request) over
    a decoder-only LM.

    ``model`` exposes ``init_cache`` / ``slot_view`` / ``prefill`` /
    ``prefill_chunk`` / ``decode_step`` / ``decode_and_sample`` and
    ``layers.recurrent``
    (``models.transformer.LM``, any ported family); ``params`` live on the
    model's device, which is where the engine keeps its state.
    """

    def __init__(self, model, cfg, params, *,
                 config: Optional[EngineConfig] = None, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        config = config if config is not None else EngineConfig()
        self.config = config
        self.model = model
        self.cfg = cfg
        self.params = params
        self.device = model.device
        max_slots = self.max_slots = config.max_slots
        max_seq = self.max_seq = config.max_seq
        self.depth = config.depth
        self.prefill_chunks = config.prefill_chunks
        self.prefill_budget = (config.prefill_budget
                               if config.prefill_budget is not None
                               else (max(self.prefill_chunks)
                                     if self.prefill_chunks else 0))
        self.kv_format = config.kv_format
        self.base_seed = int(config.base_seed)
        # resident arena bytes of one token row, all layers (reference
        # engine.py:516-518)
        self.kv_row_bytes = kvf.bytes_per_row(
            kvf.get(self.kv_format), getattr(cfg, "n_kv_heads", 1),
            getattr(cfg, "hd", 0), cfg.adtype) * cfg.n_layers
        num_pages = config.num_pages
        if num_pages is None:
            num_pages = max_slots * -(-max_seq // config.page_size)
        self.cache_mgr = PagedKVCacheManager(
            num_pages, config.page_size, kv_format=self.kv_format,
            row_bytes=self.kv_row_bytes)
        self.scheduler = Scheduler(max_slots, self.cache_mgr,
                                   max_len=max_seq,
                                   chunked=self.prefill_chunks is not None)
        dev = self.device
        self._tokens = torch.zeros(max_slots, dtype=torch.int64, device=dev)
        self._pos = torch.zeros(max_slots, dtype=torch.int64, device=dev)
        self._active = torch.zeros(max_slots, dtype=torch.int64, device=dev)
        #: per-slot sampling vectors (greedy until a sampled admission)
        self._samp = sampling.init_slot_state(max_slots, dev)
        self._cache = model.init_cache(max_slots, max_seq,
                                       kv_format=self.kv_format)
        self.arena_bytes = sum(t.numel() * t.element_size()
                               for t in self._cache.values())
        # a recurrent arena (SSD state) has no sequence axis: its size is
        # per slot, whatever max_seq is
        recurrent = model.layers.recurrent
        self.arena_unit_bytes = self.arena_bytes // (
            max_slots if recurrent else max_slots * max_seq)
        self._capture = config.decode_graph and dev.type == "cuda"
        #: the captured greedy decode step (None: eager steps)
        self.graph = (DecodeGraph(self._decode_step, self._tokens,
                                  self._pos, self._active)
                      if self._capture else None)
        #: the captured sampled step: None until the first sampled submit
        #: (and always None for eager steps)
        self.sampled_graph = None
        self._greedy_step = (self.graph.replay if self._capture
                             else self._decode_step)
        self._sampled_step = (None if self._capture
                              else self._decode_step_sampled)
        # the first draw of a sampled request: its static (1, V) logits
        # row, (seed, q, top_k) int64 and (temperature, top_p, min_p) f32
        self._draw_logits = torch.zeros((1, cfg.vocab), dtype=torch.float32,
                                        device=dev)
        self._draw_ints = torch.zeros(3, dtype=torch.int64, device=dev)
        self._draw_floats = torch.zeros(3, dtype=torch.float32, device=dev)
        #: the captured first draw: None until the first sampled submit
        #: (and always None for eager steps)
        self.draw_graph = None
        self._draw_step = None if self._capture else self._first_draw_step
        self._chunk_capture = (config.chunk_graph and dev.type == "cuda"
                               and self.prefill_chunks is not None)
        self._chunk_pool = (torch.cuda.graph_pool_handle()
                            if self._chunk_capture else None)
        #: {chunk length: (static tokens (1, C), (slot, start, last_idx))}
        self._chunk_inputs: dict[int, tuple] = {}
        #: {chunk length: ChunkGraph}, captured at the first chunk of each
        #: length (empty for eager chunk steps)
        self.chunk_graphs: dict[int, ChunkGraph] = {}
        self._staging = HostStaging(
            dev, nbytes=8 * max(max(self.prefill_chunks or (0,)), 3))
        self._queue = DispatchQueue(depth=self.depth)
        # readbacks of in-flight steps with the slot -> (state, generation)
        # map seen at submit: a token is credited only if its slot still
        # holds the same admission generation
        self._pending: collections.deque = collections.deque()
        self._slot_gen = [0] * max_slots
        self._results: dict[Any, RequestState] = {}
        self._prefill_shapes: set = set()
        self._prefill_tick = 0
        self.stats = {"decode_steps": 0, "prefills": 0, "prefill_chunks": 0,
                      "prefill_shapes": 0, "prefill_rows": 0,
                      "tokens_out": 0, "requests": 0,
                      "sampled_requests": 0, "sampled_steps": 0,
                      "host_blocked_s": 0.0, "ttft_s": {},
                      "kv_format": self.kv_format,
                      **({"state_bytes_per_slot": self.arena_unit_bytes}
                         if recurrent else
                         {"kv_row_bytes": self.kv_row_bytes}),
                      "arena_bytes": self.arena_bytes}

    # -- the device steps ----------------------------------------------------
    def _decode_step(self) -> torch.Tensor:
        """One greedy decode step over every slot (in place on the slot
        vectors and the arena); returns the raw argmax vector the host
        reads back ``depth`` steps later.  This is what the greedy decode
        graph captures: it makes no host read, and the tensors it touches
        are never rebound (host writes to the slot vectors are in place)."""
        logits = self.model.decode_step(self.params, self._tokens,
                                        self._cache, self._pos)
        return self._advance(torch.argmax(logits, dim=-1))

    def _decode_step_sampled(self) -> torch.Tensor:
        """The sampled twin of :meth:`_decode_step` (reference
        ``_compiled_decode``): decode, then ``sample_step`` over the five
        per-slot sampling vectors, read in place (greedy slots take the
        argmax).  What the sampled decode graph captures."""
        sampled = self.model.decode_and_sample(self.params, self._tokens,
                                               self._cache, self._pos,
                                               self._samp)
        return self._advance(sampled)

    def _advance(self, sampled: torch.Tensor) -> torch.Tensor:
        """Keep the new token where a slot is active (a dead slot keeps its
        old one) and freeze a dead slot's position; returns ``sampled``,
        the raw vector the host reads back."""
        self._tokens.copy_(torch.where(self._active == 1, sampled,
                                       self._tokens))
        self._pos.add_(self._active)
        return sampled

    def _first_draw_step(self) -> torch.Tensor:
        """The first token of a sampled request (``sampling.sample_first``)
        off the static logits row, with its key at q and its knobs read from
        the static scalars; what the first-draw graph captures (no host
        read).  Returns (1,) int64."""
        i, f = self._draw_ints, self._draw_floats
        return L.sample_step(self._draw_logits, i[0:1], i[1:2], f[0:1],
                             i[2:3], f[1:2], f[2:3])

    def _chunk_step(self, tokens: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
        """One prompt chunk: the static ``tokens`` (1, C) into arena slot
        ``scalars[0]`` at ``start = scalars[1]``, logits (1, V) at its last
        real token ``scalars[2]``; what a chunk graph captures (no host
        read)."""
        return self.model.prefill_chunk(self.params, tokens, self._cache,
                                        scalars[0], scalars[1], scalars[2])

    def _stage(self, dst: torch.Tensor, values) -> None:
        """Write host ``values`` into device buffer ``dst`` in place,
        without waiting on the steps in flight."""
        self.stats["host_blocked_s"] += self._staging.write(dst, values)

    def _read_now(self, value: torch.Tensor) -> np.ndarray:
        t0 = time.perf_counter()
        host = Readback(value).wait()
        self.stats["host_blocked_s"] += time.perf_counter() - t0
        return host

    def _note_prefill_shape(self, key) -> None:
        self._prefill_shapes.add(key)
        self.stats["prefill_shapes"] = len(self._prefill_shapes)

    def _first_token(self, st: RequestState) -> None:
        if st.ttft_s is not None:
            return      # preemption recompute: keep the first first-token
        st.ttft_s = self._clock() - st.submitted_at
        self.stats["ttft_s"][st.request.uid] = st.ttft_s

    # -- intake --------------------------------------------------------------
    def submit(self, request: Request) -> RequestState:
        need = request.prompt.shape[0] + 1
        if need > self.max_seq:
            raise ValueError(
                f"request {request.uid!r}: prompt needs {need} rows "
                f"but a slot holds max_seq={self.max_seq}")
        plan = None
        if self.prefill_chunks is not None:
            plan = chunking.chunk_plan(request.prompt.shape[0],
                                       self.prefill_chunks)
            if sum(plan) > self.max_seq:
                raise ValueError(
                    f"request {request.uid!r}: padded chunk plan {plan} "
                    f"needs {sum(plan)} rows but a slot holds "
                    f"max_seq={self.max_seq}")
        st = self.scheduler.submit(request, chunk_plan=plan)
        st.submitted_at = self._clock()
        self.stats["requests"] += 1
        if not request.sampling.is_greedy:
            self.stats["sampled_requests"] += 1
            if self._sampled_step is None:
                # the reference compiles its sampled step at its first
                # call; here it is captured at the first sampled request,
                # so greedy-only traffic never pays for it
                self.sampled_graph = DecodeGraph(
                    self._decode_step_sampled, self._tokens, self._pos,
                    self._active)
                self._sampled_step = self.sampled_graph.replay
                # a pure function of its static inputs: running it is its
                # own trace-free warm-up
                self.draw_graph = CapturedStep(
                    self._first_draw_step, self._first_draw_step,
                    self.device, kind="first draw")
                self._draw_step = self.draw_graph.replay
        self._results[request.uid] = st
        return st

    # -- admission (prefill into the slot's arena rows) -------------------------
    def _admit(self) -> None:
        for st in self.scheduler.schedule():
            if st.slot is None:
                continue
            if st.status == Status.PREFILLING:
                # chunked: park the slot so in-flight decode steps leave
                # its rows alone (their row write is masked off)
                self._pos[st.slot] = PARKED_POS
                continue
            if st.status != Status.RUNNING:
                continue
            self._slot_gen[st.slot] += 1
            prompt = torch.as_tensor(st.request.prompt, dtype=torch.int64,
                                     device=self.device)[None, :]
            logits = self.model.prefill(
                self.params, prompt, self.model.slot_view(self._cache,
                                                          st.slot))
            self.stats["prefills"] += 1
            self._note_prefill_shape(("prefill", int(prompt.shape[1])))
            self._activate_slot(st, logits)

    def _activate_slot(self, st: RequestState, logits) -> None:
        """Draw the prompt's first token off ``logits`` (1, V) and put the
        slot into the decode batch — shared by monolithic admission and the
        chunked path's final chunk.  The token occupies row pos0 =
        prompt_len, so it is drawn with the decode path's key at q = pos0
        (the argmax for a greedy request); the slot's sampling vectors are
        (re)written before the slot joins the batch."""
        slot = st.slot
        pos0 = st.prompt_len
        sp = st.request.sampling
        seed = sampling.resolve_seed(sp, self.base_seed)
        if sp.is_greedy:
            token0 = torch.argmax(logits[0]).reshape(1)
        else:
            self._draw_logits.copy_(logits)
            self._stage(self._draw_ints, [seed, pos0, sp.top_k])
            self._stage(self._draw_floats,
                        [sp.temperature, sp.top_p, sp.min_p])
            token0 = self._draw_step()
        sampling.write_slot(self._samp, slot, sp, seed)
        tok = int(self._read_now(token0)[0])
        self._first_token(st)
        self._tokens[slot] = tok
        self._pos[slot] = pos0
        self._active[slot] = 1
        self.stats["tokens_out"] += 1
        for dslot, _ in self.scheduler.on_token(slot, tok):
            self._active[dslot] = 0

    # -- chunked prefill -------------------------------------------------------
    def _advance_prefill(self) -> None:
        """Ingest prompt chunks for PREFILLING slots, up to
        ``prefill_budget`` tokens this step (always at least one chunk):
        least-ingested-first, and every other step the FIFO-oldest
        PREFILLING slot first (reference engine.py:980)."""
        if self.prefill_chunks is None:
            return
        self._prefill_tick += 1
        spent = 0
        budget = self.prefill_budget

        def prefilling():
            return [st for st in self.scheduler.running.values()
                    if st.status == Status.PREFILLING
                    and st.slot is not None]

        if self._prefill_tick % 2:
            states = prefilling()
            if not states:
                return
            oldest = min(states, key=lambda s: s.seq)
            size = oldest.chunk_plan[oldest.chunk_idx]
            self._prefill_one_chunk(oldest, size)
            spent += size
        while True:
            states = sorted(prefilling(),
                            key=lambda s: (s.prefill_pos, s.seq))
            if not states:
                return
            for st in states:
                if st.status != Status.PREFILLING or st.slot is None:
                    continue        # departed via an earlier activation
                size = st.chunk_plan[st.chunk_idx]
                if spent and spent + size > budget:
                    return
                self._prefill_one_chunk(st, size)
                spent += size

    def _chunk_runner(self, size: int):
        """(static tokens, static scalars, step) of chunk length ``size``:
        the step replays its chunk graph (captured here at the first chunk
        of the length) or runs :meth:`_chunk_step` eagerly."""
        if size not in self._chunk_inputs:
            self._chunk_inputs[size] = (
                torch.zeros((1, size), dtype=torch.int64, device=self.device),
                torch.zeros(3, dtype=torch.int64, device=self.device))
        tokens, scalars = self._chunk_inputs[size]
        if not self._chunk_capture:
            return tokens, scalars, lambda: self._chunk_step(tokens, scalars)
        if size not in self.chunk_graphs:
            self.chunk_graphs[size] = ChunkGraph(
                lambda: self._chunk_step(tokens, scalars), scalars,
                pool=self._chunk_pool)
        return tokens, scalars, self.chunk_graphs[size].replay

    def _prefill_one_chunk(self, st: RequestState, size: int) -> None:
        req = st.request
        plen = st.prompt_len
        start = st.prefill_pos
        chunk = np.zeros((size,), np.int64)
        real = min(size, plen - start)
        chunk[:real] = req.prompt[start:start + real]
        is_last = st.chunk_idx == len(st.chunk_plan) - 1
        tokens, scalars, step = self._chunk_runner(size)
        self._stage(tokens, chunk)
        self._stage(scalars, [st.slot, start, real - 1])
        logits = step()
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_rows"] += size
        self._note_prefill_shape(("chunk", size))
        st.prefill_pos = start + size
        st.chunk_idx += 1
        if not is_last:
            return
        self.scheduler.finish_prefill(st.slot)
        # steps submitted mid-prefill are stale for this slot: drop them
        self._slot_gen[st.slot] += 1
        self._activate_slot(st, logits)

    # -- the continuous-batching loop ----------------------------------------
    def step(self) -> None:
        """One engine iteration: retire lagged outputs, admit, ingest
        prompt chunks, submit one decode step: the sampled one if a RUNNING
        slot samples, else its greedy twin."""
        self._drain_pending(limit=self.depth)
        self._admit()
        self._advance_prefill()
        running = [st for st in self.scheduler.running.values()
                   if st.status == Status.RUNNING]
        if not running:
            return
        if any(not st.request.sampling.is_greedy for st in running):
            self.stats["sampled_steps"] += 1
            read = self._queue.submit(self._sampled_step)
        else:
            read = self._queue.submit(self._greedy_step)
        self.stats["decode_steps"] += 1
        snapshot = {slot: (st, self._slot_gen[slot])
                    for slot, st in self.scheduler.running.items()}
        self._pending.append((read, snapshot))

    def _drain_pending(self, *, limit: int) -> None:
        """Credit the tokens of steps older than ``limit`` steps."""
        while len(self._pending) > limit:
            read, snapshot = self._pending.popleft()
            t0 = time.perf_counter()
            host_tokens = read.wait()
            self.stats["host_blocked_s"] += time.perf_counter() - t0
            for slot, (st, gen) in snapshot.items():
                # stale: the request left this slot after the step was
                # submitted, was still prefilling then, or the slot was
                # recycled to a newer admission
                if (st.status != Status.RUNNING or st.slot != slot
                        or gen != self._slot_gen[slot]):
                    continue
                self.stats["tokens_out"] += 1
                for dslot, _ in self.scheduler.on_token(
                        slot, int(host_tokens[slot])):
                    self._active[dslot] = 0

    def run(self, *, max_steps: Optional[int] = None) -> dict:
        """Drive until every submitted request finishes.  Returns
        {uid: (gen_tokens,) np.int32}."""
        steps = 0
        while not self.scheduler.all_done:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not converge in {max_steps} steps "
                    f"(waiting={len(self.scheduler.waiting)}, "
                    f"running={len(self.scheduler.running)})")
            self.step()
            steps += 1
            if not self.scheduler.running and self._pending:
                self._queue.drain()
                self._drain_pending(limit=0)
        self._queue.drain()
        self._drain_pending(limit=0)
        return {uid: st.output() for uid, st in self._results.items()}
