"""Continuous-batching serving engine (port of ``repro/runtime/serving/
engine.py``'s ``ServingEngine``: greedy and sampled decode over any KV
storage format, ``EngineConfig.kv_format``, with the copy-on-write prefix
cache, ``EngineConfig.prefix_sharing``, or speculative decoding,
``EngineConfig.speculative``; under deterministic fault injection,
deadlines and the health ladder, ``EngineConfig.faults`` / ``health``).

The host runs scheduling and admission; the device runs one decode step
over the whole slot batch.  As in the reference:

  1. **One step over every slot.**  Dead slots keep decoding (masked): the
     new token is kept only where ``active``, and ``pos += active``
     freezes a dead slot's position (reference engine.py:199-216).  The
     step also returns each slot's finite flag (its logits row holds no
     NaN or Inf) in the same (2, slots) readback as the tokens, so a
     poisoned slot is quarantined without its logits leaving the device.
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
     flight; the chunk graphs (and a speculative engine's draft chunk and
     verify graphs) share one private pool and replay one at a time on
     one stream.  Monolithic prefill stays eager: it has one shape
     per prompt length, and a graph per length seen would hold a pool per
     length.  ``EngineConfig.decode_graph=False`` asks for eager decode
     steps and first draws, ``chunk_graph=False`` for eager chunk steps
     (through the same device buffers); on the CPU every step runs
     eagerly.
  5. **Keys fold (seed, position) only.**  A sampled slot's token at cache
     row q is drawn with ``fold_in(fold_in(PRNGKey(0), seed), q)``; the
     first token at q = prompt_len (+ the patch rows of a vlm prompt),
     off the prefill logits.  So a stream does not depend on its
     batch-mates, on chunking or on a preemption's recompute, and the
     slot-generation guard drops a step's token for a slot that was
     (re)admitted after the step was submitted, whichever of the two
     steps it was.

Prefill comes in two modes: monolithic (``prefill_chunks=None``; one call
per prompt) and chunked (bucket-sized chunks interleaved with decode under
a per-step token budget).  A slot being chunk-prefilled parks its position
at ``PARKED_POS``: in-flight decode steps then leave its rows untouched
(the row write is masked to ``pos < max_seq``; a recurrent state write is
keep-masked on ``pos < PARKED_POS``).

Prefix sharing (chunked prefill only, reference engine.py:1046-1149): each
pure slot's ingested pages are registered in the cache manager's
hash-consed index as its chunks land; a later request whose prompt starts
with a registered chain *forks* onto it at its first chunk (its first k
private pages swapped for the chain's, refcounted) and ingests only its
tail, its chunk cursor starting at the divergence boundary.  The fork
reads the donor's rows in place, on the device: its chunks pass (donor
slot, shared length) as two more device scalars of the chunk graph, and
the decode graphs read two engine-owned (slots,) vectors, the donor table
of ``flash_decode`` and ``flash_prefill_chunk`` (the identity (slot, 0)
for an unshared slot).  Writes never go through it.  Recurrent state (the
ssm family's, the hybrid family's beside its K/V rows) has no rows to
share: the donor's state and conv tail are copied into a snapshot at each
page-aligned chunk end (eager copies on the stream the chunk graphs replay
on, after the chunk), and the fork splices the snapshot into its own slot
before its first tail chunk.

Speculative decoding (``EngineConfig.speculative``, the dense family,
every KV format; reference engine.py:601-633, :1205-1348): a draft LM in a
second slot arena (fp32 format) with the target's slot indices proposes k
tokens a slot, and the target verifies each RUNNING slot's proposals in
one chunk-shaped pass (``LM.verify_chunk``); the engine commits the
accepted run and the target's draw at the first mismatch
(``Scheduler.on_tokens``), so the stream is the target's own, bit for
bit.  Prefill mirrors every prompt (monolithic, eager) and every chunk
(the draft's chunk graph of that length) into the draft arena.  A round is
synchronous: k replays of the draft's micro-step graph, whose tokens and
positions are fed back on the device, then one replay of the verify graph
of rung k a slot (greedy or sampled twin; captured at its first use), then
one host sync.  A slot whose verify logits go non-finite is quarantined
(``Status.FAILED``).  When the health ladder reaches DEGRADED a
speculative engine runs queue decode instead (reference engine.py:
1338-1360): its slot vectors are written from host state in place, and on
the card its decode graph is captured there, at the first degraded step
(none is captured at construction, so an engine that never degrades pays
nothing for it); the way back to rounds retires every queue step in
flight first.

Robustness (reference engine.py:700-813, :1313-1440): the fault sites
``alloc`` (the page accountant's hook), ``chunk`` (a chunk's dispatch
dropped), ``decode`` (a step or round dropped), ``logits`` (one RUNNING
slot's arena region filled with NaN in place, between replays; prefix
donors and regions hosting registered pages excluded) and ``draft`` (a
round's proposals corrupted on the device before the verify) fire as the
injector says; a quarantined slot's region is zeroed before its next
resident.  Requests past their deadline depart ``TIMED_OUT``; the ladder
sheds admissions and fails waiting requests when it drains;
:meth:`ServingEngine.evacuate` hands every unfinished request back for a
router to place elsewhere.  No fault site or rung stands for a device
failure: a CUDA error, a failed capture or a kernel that fails to build
raises.

Left out, as in the reference's exclusions: speculative decoding together
with prefix sharing (the reference refuses the pair).
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
from repro_torch.runtime.serving.cache import PagedKVCacheManager, PrefixMatch
from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.faults import FaultInjector
from repro_torch.runtime.serving.graphs import (CapturedStep, ChunkGraph,
                                                DecodeGraph)
from repro_torch.runtime.serving.health import HealthMonitor, HealthState
from repro_torch.runtime.serving.request import Request, RequestState, Status
from repro_torch.runtime.serving.scheduler import AdmissionRejected, Scheduler
from repro_torch.runtime.serving.speculative import SpecController


def prefix_extra(cfg) -> int:
    """Arena rows a request holds before its prompt: llava's patch rows
    (the vlm family), 0 for every other family."""
    return cfg.n_patch_tokens if cfg.family == "vlm" else 0


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class ServingEngine:
    """Continuous-batching generation (greedy or sampled, per request) over
    any registry model.

    ``model`` exposes ``init_cache`` / ``slot_view`` / ``prefill`` /
    ``decode_step`` / ``decode_and_sample`` and ``seq_axes``, for chunked
    prefill ``prefill_chunk``, and for prefix sharing
    ``has_recurrent_state`` / ``extract_slot_state`` /
    ``splice_slot_state`` (``models.transformer.LM`` and ``models.vlm.
    VLM``; ``models.encdec.EncDecLM``, which says through
    ``supports_chunked_prefill`` / ``supports_prefix_sharing`` /
    ``supports_narrow_kv`` what it lacks, so the engine refuses those
    modes as the reference does).  A request's ``extras`` reach
    ``prefill`` as keywords (``patch_embeds``, ``frames``); ``params``
    live on the model's device, which is where the engine keeps its state.  ``clock``:
    the engine's time source (default ``time.perf_counter``), which
    stamps submissions, first tokens and deadlines; tests and the router's
    ``StepClock`` inject their own.
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
        #: arena rows a request holds before its prompt (reference
        #: engine.py:475)
        self.prefix_extra = prefix_extra(cfg)
        # the reference's refusals, in its order and words (engine.py:
        # 477-513, :608-610)
        if self.prefill_chunks is not None:
            if not getattr(model, "supports_chunked_prefill", False):
                raise ValueError(
                    f"family {cfg.family!r} does not support chunked "
                    f"prefill; use prefill_chunks=None")
            if self.prefix_extra:
                raise ValueError("chunked prefill with prefix_extra "
                                 "(VLM patch tokens) is unsupported")
        if config.prefix_sharing and not getattr(
                model, "supports_prefix_sharing", False):
            raise ValueError(
                f"family {cfg.family!r} does not support prefix sharing "
                f"(needs the chunked-prefill and arena-decode hooks)")
        if config.kv_format != "fp32" and not getattr(
                model, "supports_narrow_kv", True):
            raise ValueError(
                f"family {cfg.family!r} does not support kv_format="
                f"{config.kv_format!r}: its cache constructor is fp32-only")
        if config.speculative is not None and self.prefix_extra:
            raise ValueError("speculative decoding with prefix_extra "
                             "(VLM patch tokens) is unsupported")
        self.prefill_budget = (config.prefill_budget
                               if config.prefill_budget is not None
                               else (max(self.prefill_chunks)
                                     if self.prefill_chunks else 0))
        self.kv_format = config.kv_format
        self.base_seed = int(config.base_seed)
        self.prefix_sharing = bool(config.prefix_sharing)
        # a family with recurrent state (ssm, hybrid) forks only at
        # boundaries where the donor's state was checkpointed
        self._needs_state_snapshot = (self.prefix_sharing
                                      and model.has_recurrent_state)
        # resident arena bytes of one token row, all layers (reference
        # engine.py:516-518)
        self.kv_row_bytes = kvf.bytes_per_row(
            kvf.get(self.kv_format), getattr(cfg, "n_kv_heads", 1),
            getattr(cfg, "hd", 0), cfg.adtype) * cfg.n_layers
        # fault injection: one seeded injector for every site; the page
        # accountant consults it through a narrow callable
        self._injector = (FaultInjector(config.faults)
                          if config.faults is not None else None)
        num_pages = config.num_pages
        if num_pages is None:
            num_pages = max_slots * -(-max_seq // config.page_size)
        self.cache_mgr = PagedKVCacheManager(
            num_pages, config.page_size, max_chains=config.prefix_chain_cap,
            fault=self._cache_fault if self._injector else None,
            kv_format=self.kv_format, row_bytes=self.kv_row_bytes)
        self.scheduler = Scheduler(
            max_slots, self.cache_mgr, prefix_extra=self.prefix_extra,
            max_len=max_seq,
            chunked=self.prefill_chunks is not None,
            admission_reclaim_cap=config.admission_reclaim_cap,
            admission_attempt_cap=config.admission_attempt_cap,
            admission_backoff_cap=config.admission_backoff_cap,
            preempt_cap=config.preempt_cap)
        #: the health ladder, observed once a step off the engine's own
        #: counters (None: no monitoring)
        self.health = (HealthMonitor(config.health)
                       if config.health is not None else None)
        dev = self.device
        self._tokens = torch.zeros(max_slots, dtype=torch.int64, device=dev)
        self._pos = torch.zeros(max_slots, dtype=torch.int64, device=dev)
        self._active = torch.zeros(max_slots, dtype=torch.int64, device=dev)
        #: per-slot sampling vectors (greedy until a sampled admission)
        self._samp = sampling.init_slot_state(max_slots, dev)
        #: the donor table under prefix sharing, (share_src, share_len)
        #: (slots,) int64, read in place by the decode steps: slot b reads
        #: rows [0, share_len[b]) of slot share_src[b]; the identity (b, 0)
        #: for an unshared, parked or dead slot.  None with sharing off
        #: (the decode steps take today's path)
        self._share = ((torch.arange(max_slots, dtype=torch.int64,
                                     device=dev),
                        torch.zeros(max_slots, dtype=torch.int64,
                                    device=dev))
                       if self.prefix_sharing else None)
        self._cache = model.init_cache(max_slots, max_seq,
                                       kv_format=self.kv_format)
        self.arena_bytes = sum(t.numel() * t.element_size()
                               for t in self._cache.values())
        # the leaves with no sequence axis (SSD state, conv tail) are per
        # slot, whatever max_seq is; the hybrid arena has both kinds
        axes = model.seq_axes(self.kv_format)
        has_rows = any(ax >= 0 for ax in axes.values())
        #: resident bytes of one slot's recurrent state, all layers (0: the
        #: arena has none)
        self.state_bytes_per_slot = sum(
            t.numel() * t.element_size() for key, t in self._cache.items()
            if axes[key] < 0) // max_slots
        self._capture = config.decode_graph and dev.type == "cuda"
        #: the speculative controller (None: plain decode)
        self.spec: Optional[SpecController] = None
        if config.speculative is not None:
            self._init_spec(config.speculative)
        # a speculative engine runs rounds, and queue decode only when the
        # ladder degrades: its decode graph waits for that step
        plain_capture = self._capture and self.spec is None
        #: the captured greedy decode step (None: eager steps, or a
        #: speculative engine that has not degraded yet)
        self.graph = (DecodeGraph(self._decode_step, self._tokens,
                                  self._pos, self._active)
                      if plain_capture else None)
        #: the captured sampled step: None until the first sampled submit
        #: (a speculative engine's: its first sampled degraded step), and
        #: always None for eager steps
        self.sampled_graph = None
        self._greedy_step = (self.graph.replay if plain_capture
                             else None if self._capture
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
        # the private pool of the chunk graphs, the draft's chunk graphs
        # and the speculative verify graphs: they replay one at a time on
        # one stream, and each replay's output is read before the next
        self._chunk_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        #: {chunk length: (static tokens (1, C), (slot, start, last_idx),
        #: and with prefix sharing (..., share_src, share_len))}
        self._chunk_inputs: dict[int, tuple] = {}
        self._n_scalars = 5 if self.prefix_sharing else 3
        #: {chunk length: ChunkGraph}, captured at the first chunk of each
        #: length (empty for eager chunk steps)
        self.chunk_graphs: dict[int, ChunkGraph] = {}
        self._staging = HostStaging(
            dev, nbytes=8 * max(max(self.prefill_chunks or (0,)),
                                self._n_scalars, max_slots))
        self._queue = DispatchQueue(depth=self.depth)
        # readbacks of in-flight steps with the slot -> (state, generation)
        # map seen at submit: a token is credited only if its slot still
        # holds the same admission generation
        self._pending: collections.deque = collections.deque()
        self._slot_gen = [0] * max_slots
        self._results: dict[Any, RequestState] = {}
        self._prefill_shapes: set = set()
        self._prefill_tick = 0
        # robustness state: the step counter (admission backoff ticks),
        # the step's fault flag (the ladder's consecutive-faults signal),
        # the slots poisoned and not yet scrubbed, and whether the device
        # slot vectors lag a speculative round's commits
        self._tick = 0
        self._step_faulted = False
        self._deadlines_active = False
        self._poisoned_slots: set = set()
        self._spec_resync = False
        self.stats = {"decode_steps": 0, "prefills": 0, "prefill_chunks": 0,
                      "prefill_shapes": 0, "prefill_rows": 0,
                      "tokens_out": 0, "requests": 0,
                      "sampled_requests": 0, "sampled_steps": 0,
                      "forks": 0, "shared_prompt_tokens": 0,
                      "prefix_hits": 0, "prefix_deferrals": 0,
                      "snapshots": 0, "snapshot_bytes": 0,
                      "timed_out": 0, "failed": 0, "migrated": 0,
                      "quarantined": 0, "poisoned": 0,
                      "deadline_overrun_s": {},
                      "host_blocked_s": 0.0, "ttft_s": {},
                      "kv_format": self.kv_format,
                      **({"kv_row_bytes": self.kv_row_bytes}
                         if has_rows else {}),
                      **({"state_bytes_per_slot": self.state_bytes_per_slot}
                         if self.state_bytes_per_slot else {}),
                      "arena_bytes": self.arena_bytes}
        if self._injector is not None:
            # a live view of the per-site fire counts (aliased)
            self.stats["faults"] = self._injector.fired
        if self.health is not None:
            self.stats["health"] = self.health.state.name
            self.stats["health_transitions"] = 0
        if self.spec is not None:
            # rounds = verify rounds (the speculative decode_steps),
            # draft_steps = draft micro-steps, verify_calls = per-slot
            # verify passes, verify_compiles = the verify steps touched,
            # one per (ladder rung, greedy / sampled twin): on the card
            # the verify graphs captured (reference engine.py:683-691,
            # which counts rungs).  Per-request acceptance lives on
            # ``self.spec.stats``.
            self.stats.update({"spec_rounds": 0, "spec_draft_steps": 0,
                               "spec_verify_calls": 0,
                               "spec_verify_compiles": 0})

    def _init_spec(self, spec) -> None:
        """The draft side of speculative decoding (reference engine.py:
        601-633): the draft model (built on this engine's device with its
        kernels), its parameters from ``spec.draft_seed``, its own arena
        (fp32 format: the activation dtype), the round's device buffers,
        and on the card the draft's greedy micro-step captured (its sampled
        twin at the first sampled submit, the verify graphs at their first
        round)."""
        model, dev, b = self.model, self.device, self.max_slots
        self.spec = SpecController(self.cfg, spec, device=dev,
                                   kernels=model.kops)
        dm = self.draft_model = self.spec.draft_model
        self._draft_params = dm.init(spec.draft_seed)
        self._draft_cache = dm.init_cache(b, self.max_seq)
        k_max = max(spec.ladder())
        #: the draft micro-step's token and position vectors: staged once a
        #: round, then fed back and advanced on the device
        self._dtok = torch.zeros(b, dtype=torch.int64, device=dev)
        self._dpos = torch.zeros(b, dtype=torch.int64, device=dev)
        #: row 0: each slot's current token; row j: its j-th proposal
        self._chain = torch.zeros((k_max + 1, b), dtype=torch.int64,
                                  device=dev)
        #: the verify steps' (slot, start), and their outputs, one row a
        #: verified slot: the draws at the k positions and the finite flag
        self._vscalars = torch.zeros(2, dtype=torch.int64, device=dev)
        self._vdraws = torch.zeros((b, k_max), dtype=torch.int64,
                                   device=dev)
        self._vok = torch.zeros(b, dtype=torch.bool, device=dev)
        #: {k: static (1, k) verify tokens}
        self._vtokens: dict[int, torch.Tensor] = {}
        #: the (k, sampled) verify steps touched
        self._verify_keys: set = set()
        #: {(k, sampled): captured verify graph}, in the chunk graphs' pool
        #: (each verify's outputs are copied out before the next replay)
        self.verify_graphs: dict[tuple, ChunkGraph] = {}
        #: the draft's captured greedy micro-step (None: eager) and its
        #: sampled twin (None until the first sampled submit)
        self.draft_graph = (DecodeGraph(self._draft_step, self._dtok,
                                        self._dpos, kind="draft")
                            if self._capture else None)
        self.sampled_draft_graph = None
        self._draft_greedy = (self.draft_graph.replay if self._capture
                              else self._draft_step)
        self._draft_sampled = (None if self._capture
                               else self._draft_step_sampled)
        #: {chunk length: the draft's captured chunk graph}
        self.draft_chunk_graphs: dict[int, ChunkGraph] = {}

    # -- the device steps ----------------------------------------------------
    def _decode_step(self) -> torch.Tensor:
        """One greedy decode step over every slot (in place on the slot
        vectors and the arena); returns the (2, slots) int64 readback the
        host reads ``depth`` steps later: the raw argmax vector and each
        slot's finite flag.  This is what the greedy decode graph captures:
        it makes no host read, and the tensors it touches are never rebound
        (host writes to the slot vectors are in place)."""
        logits = self.model.decode_step(self.params, self._tokens,
                                        self._cache, self._pos,
                                        share=self._share)
        return self._advance(torch.argmax(logits, dim=-1),
                             L.finite_rows(logits))

    def _decode_step_sampled(self) -> torch.Tensor:
        """The sampled twin of :meth:`_decode_step` (reference
        ``_compiled_decode``): decode, then ``sample_step`` over the five
        per-slot sampling vectors, read in place (greedy slots take the
        argmax).  What the sampled decode graph captures."""
        sampled, ok = self.model.decode_and_sample(
            self.params, self._tokens, self._cache, self._pos, self._samp,
            share=self._share, with_flags=True)
        return self._advance(sampled, ok)

    def _advance(self, sampled: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
        """Keep the new token where a slot is active (a dead slot keeps its
        old one) and freeze a dead slot's position; returns the readback,
        ``sampled`` (the raw vector) over ``ok`` (the finite flags) as one
        (2, slots) int64 tensor, so one copy carries both."""
        self._tokens.copy_(torch.where(self._active == 1, sampled,
                                       self._tokens))
        self._pos.add_(self._active)
        return torch.stack((sampled, ok.to(torch.int64)))

    def _first_draw_step(self) -> torch.Tensor:
        """The first token of a sampled request (``sampling.sample_first``)
        off the static logits row, with its key at q and its knobs read from
        the static scalars, and whether that row is finite; what the
        first-draw graph captures (no host read).  Returns (2,) int64:
        (token, finite flag)."""
        i, f = self._draw_ints, self._draw_floats
        tok = L.sample_step(self._draw_logits, i[0:1], i[1:2], f[0:1],
                            i[2:3], f[1:2], f[2:3])
        return torch.cat((tok, L.finite_rows(self._draw_logits).to(
            torch.int64)))

    def _chunk_step(self, tokens: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
        """One prompt chunk: the static ``tokens`` (1, C) into arena slot
        ``scalars[0]`` at ``start = scalars[1]``, logits (1, V) at its last
        real token ``scalars[2]``, and with prefix sharing reading rows [0,
        ``scalars[4]``) from slot ``scalars[3]`` (a pure slot: its own, 0);
        what a chunk graph captures (no host read)."""
        share = ((scalars[3], scalars[4]) if self.prefix_sharing
                 else (None, None))
        return self.model.prefill_chunk(self.params, tokens, self._cache,
                                        scalars[0], scalars[1], scalars[2],
                                        *share)

    def _draft_step(self) -> torch.Tensor:
        """One greedy draft micro-step over every slot (reference
        ``_compiled_draft_propose_greedy``): decode the draft tokens at the
        draft positions over the draft arena, feed the argmax back as the
        next tokens and advance every position by one; what the draft
        graph captures (no host read)."""
        logits = self.draft_model.decode_step(self._draft_params, self._dtok,
                                              self._draft_cache, self._dpos)
        return self._draft_advance(torch.argmax(logits, dim=-1))

    def _draft_step_sampled(self) -> torch.Tensor:
        """The sampled twin of :meth:`_draft_step` (reference
        ``_compiled_draft_propose``): it draws with the *target's* per-slot
        sampling vectors, proposal j + 1 with the slot's (seed, pos + j +
        1) key, the key the target's Gumbel replay uses there, so the
        noise is shared and only the logits differ."""
        sampled = self.draft_model.decode_and_sample(
            self._draft_params, self._dtok, self._draft_cache, self._dpos,
            self._samp)
        return self._draft_advance(sampled)

    def _draft_advance(self, sampled: torch.Tensor) -> torch.Tensor:
        self._dtok.copy_(sampled)
        self._dpos.add_(1)
        return sampled

    def _verify_step(self, tokens: torch.Tensor, sampled: bool):
        """One slot's verify pass (reference ``_compiled_verify`` /
        ``_greedy``): the static ``tokens`` (1, k) through
        ``LM.verify_chunk`` at (slot, start) = ``self._vscalars``, then the
        target's draw at each of the k positions (the Gumbel replay, or the
        argmax for a greedy slot) and whether every logit is finite, so the
        (k, V) logits never leave the device.  What a verify graph captures
        (no host read).  Returns (draws (k,) int64, ok 0-d bool)."""
        slot, start = self._vscalars[0], self._vscalars[1]
        logits = self.model.verify_chunk(self.params, tokens, self._cache,
                                         slot, start)[0]
        draws = (sampling.verify_draws(logits, slot, start, self._samp)
                 if sampled else torch.argmax(logits, dim=-1))
        return draws, torch.isfinite(logits).all()

    # -- fault / health plumbing ---------------------------------------------
    def _cache_fault(self, site: str) -> bool:
        """The page accountant's fault hook: the injector's answer, and a
        fired fault flags the step for the ladder."""
        if self._injector.fire(site):
            self._step_faulted = True
            return True
        return False

    @property
    def _health_state(self) -> HealthState:
        return self.health.state if self.health else HealthState.HEALTHY

    def _effective_prefill_budget(self) -> int:
        """The configured budget, shrunk by the ladder at >= SHEDDING."""
        budget = self.prefill_budget
        if (self.health is not None and budget
                and self._health_state >= HealthState.SHEDDING):
            budget = max(1, int(budget
                                * self.health.config.shed_prefill_frac))
        return budget

    def _depart(self, st: RequestState, status: Status,
                reason: str) -> None:
        """An abnormal departure (``Scheduler.depart``), its slot out of the
        decode batch."""
        slot = self.scheduler.depart(st, status, reason)
        if slot is not None:
            self._deactivate(slot)
        key = {Status.TIMED_OUT: "timed_out",
               Status.MIGRATED: "migrated"}.get(status, "failed")
        self.stats[key] += 1

    def _expire_deadlines(self) -> None:
        """Depart every request past its deadline, waiting or resident,
        ``TIMED_OUT`` with its partial output (a clean prefix of its
        fault-free stream); the overrun is kept per request."""
        if not self._deadlines_active:
            return
        now = self._clock()
        states = [*self.scheduler.waiting,
                  *list(self.scheduler.running.values())]
        for st in states:
            if st.deadline_at is None or now < st.deadline_at or st.done:
                continue
            self.stats["deadline_overrun_s"][st.request.uid] = (
                now - st.deadline_at)
            self._depart(st, Status.TIMED_OUT, "deadline")

    def _observe_health(self) -> None:
        """Feed the ladder one step of signals; at DRAINING the waiting
        requests fail now (residents finish), so the engine converges."""
        if self.health is None:
            return
        state = self.health.observe(
            step=self._tick,
            pressure=self.cache_mgr.utilization(),
            preemptions=self.scheduler.stats["preempted"],
            timeouts=self.scheduler.stats["timed_out"],
            step_fault=self._step_faulted)
        self._step_faulted = False
        self.stats["health"] = state.name
        self.stats["health_transitions"] = len(self.health.transitions)
        if state >= HealthState.DRAINING:
            for st in list(self.scheduler.waiting):
                self._depart(st, Status.FAILED, "draining")

    def _fill_slot(self, slot: int, value: float, *,
                   floating_only: bool) -> None:
        """Fill slot ``slot``'s region of every arena leaf (all layers, all
        rows) with ``value``, in place on the current stream: between two
        replays, never inside one.  ``floating_only`` skips the integer
        leaves (an int8 arena's rows; its f32 scales are filled)."""
        for leaf in self.model.slot_view(self._cache, slot).values():
            if leaf.is_floating_point() or not floating_only:
                leaf.fill_(value)

    def _poison_slot(self, running) -> None:
        """The ``logits`` fault site (reference engine.py:767-799): fill one
        RUNNING slot's arena region with NaN (every floating leaf: fp32 /
        bf16 / fp8 rows, the scales of a scaled format, the SSD state and
        conv window of mamba2 and hymba), so its next decode or verify
        logits go non-finite and the quarantine departs it.  The victim
        pick is the injector's ``choose``.  Prefix donors, and regions
        hosting registered prefix pages a later fork could map, are
        excluded: the blast radius stays one slot."""
        cands = sorted(running, key=lambda s: s.slot)
        if self.prefix_sharing:
            donors = {st.share_src for st in
                      self.scheduler.running.values()
                      if st.share_src is not None
                      and st.share_src != st.slot}
            cands = [st for st in cands
                     if st.slot not in donors
                     and not self.cache_mgr.hosts_registered(st.slot)]
        if not cands:
            return
        victim = cands[self._injector.choose("logits", len(cands))]
        self._fill_slot(victim.slot, float("nan"), floating_only=True)
        self._poisoned_slots.add(victim.slot)
        self.stats["poisoned"] += 1
        self._step_faulted = True

    def _scrub_slot(self, slot: int) -> None:
        """Zero a poisoned slot's region (every leaf) before a new resident
        moves in (reference engine.py:801-813): chunked prefill writes only
        its chunks' rows, and monolithic prefill only the prompt's, so a
        stale NaN row would reach the next resident through the P.V
        product (a masked key's weight is 0, and 0 x NaN is NaN)."""
        self._fill_slot(slot, 0.0, floating_only=False)
        self._poisoned_slots.discard(slot)

    def _stage(self, dst: torch.Tensor, values) -> None:
        """Write host ``values`` into device buffer ``dst`` in place,
        without waiting on the steps in flight."""
        self.stats["host_blocked_s"] += self._staging.write(dst, values)

    def _read_now(self, value: torch.Tensor) -> np.ndarray:
        return self._wait(Readback(value))

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
        # a shedding or draining replica refuses intake: the typed
        # rejection is the router's signal to try another replica
        if self._health_state >= HealthState.SHEDDING:
            raise AdmissionRejected(request.uid,
                                    self._health_state.name.lower())
        need = request.prompt.shape[0] + self.prefix_extra + 1
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
        if self.prefix_sharing:
            # advisory: admission keeps its full-prompt reservation (the
            # fork happens at the first chunk, against the pages live then)
            if self.cache_mgr.lookup(
                    request.prompt, request.prompt.shape[0] - 1,
                    require_snapshot=self._needs_state_snapshot):
                self.stats["prefix_hits"] += 1
        st = self.scheduler.submit(request, chunk_plan=plan)
        st.submitted_at = self._clock()
        if request.deadline_ms is not None:
            st.deadline_at = st.submitted_at + request.deadline_ms / 1e3
            self._deadlines_active = True
        self.stats["requests"] += 1
        if not request.sampling.is_greedy:
            self.stats["sampled_requests"] += 1
            if self._capture and self.draw_graph is None:
                # the reference compiles its sampled step at its first
                # call; here it is captured at the first sampled request,
                # so greedy-only traffic never pays for it (a speculative
                # engine captures the draft's sampled micro-step instead)
                if self.spec is None:
                    self.sampled_graph = DecodeGraph(
                        self._decode_step_sampled, self._tokens, self._pos,
                        self._active)
                    self._sampled_step = self.sampled_graph.replay
                else:
                    self.sampled_draft_graph = DecodeGraph(
                        self._draft_step_sampled, self._dtok, self._dpos,
                        kind="draft")
                    self._draft_sampled = self.sampled_draft_graph.replay
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
        for st in self.scheduler.schedule(tick=self._tick):
            if st.slot is None:
                continue
            if st.slot in self._poisoned_slots:
                self._scrub_slot(st.slot)
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
            # the family's side inputs (frames, patch_embeds) batched; a
            # preemption's recompute passes them again
            extras = {key: torch.as_tensor(val, device=self.device)[None]
                      for key, val in (st.request.extras or {}).items()}
            logits = self.model.prefill(
                self.params, prompt,
                self.model.slot_view(self._cache, st.slot), **extras)
            if self.spec is not None:
                # mirror the prompt into the draft arena (logits dropped):
                # both arenas hold rows [0, prompt_len), and a preemption's
                # recompute re-runs both (reference engine.py:908-916)
                dm = self.draft_model
                dm.prefill(self._draft_params, prompt,
                           dm.slot_view(self._draft_cache, st.slot))
            self.stats["prefills"] += 1
            self._note_prefill_shape(("prefill", int(prompt.shape[1])))
            self._activate_slot(st, logits)

    def _activate_slot(self, st: RequestState, logits) -> None:
        """Draw the prompt's first token off ``logits`` (1, V) and put the
        slot into the decode batch — shared by monolithic admission and the
        chunked path's final chunk.  The token occupies row pos0 =
        prompt_len + prefix_extra, so it is drawn with the decode path's
        key at q = pos0 (the argmax for a greedy request); the slot's sampling vectors are
        (re)written before the slot joins the batch.

        The prompt's logits are checked first (reference engine.py:
        933-948): the token and the row's finite flag come back in one
        read, and a non-finite row (poisoned arena rows) fails the request
        before it commits a token."""
        slot = st.slot
        pos0 = st.prompt_len + self.prefix_extra
        sp = st.request.sampling
        seed = sampling.resolve_seed(sp, self.base_seed)
        if sp.is_greedy:
            first = torch.stack((torch.argmax(logits[0]),
                                 L.finite_rows(logits)[0].to(torch.int64)))
        else:
            self._draw_logits.copy_(logits)
            self._stage(self._draw_ints, [seed, pos0, sp.top_k])
            self._stage(self._draw_floats,
                        [sp.temperature, sp.top_p, sp.min_p])
            first = self._draw_step()
        tok, ok0 = (int(v) for v in self._read_now(first))
        if not ok0:
            self.stats["quarantined"] += 1
            self._step_faulted = True
            self._depart(st, Status.FAILED, "nan-logits")
            return
        sampling.write_slot(self._samp, slot, sp, seed)
        if self.prefix_sharing:
            # the slot's donor entry before it joins the decode batch: a
            # fork reads its shared rows from the donor's region, anyone
            # else gets the identity (reference engine.py:950-957)
            src = st.share_src if st.share_src is not None else slot
            self._stage(self._share[0][slot:slot + 1], [src])
            self._stage(self._share[1][slot:slot + 1], [st.share_len])
        self._first_token(st)
        self._tokens[slot] = tok
        self._pos[slot] = pos0
        self._active[slot] = 1
        self.stats["tokens_out"] += 1
        for dslot, _ in self.scheduler.on_token(slot, tok):
            self._deactivate(dslot)

    def _deactivate(self, slot: int) -> None:
        """A departed slot leaves the decode batch; its donor entry goes
        back to the identity."""
        self._active[slot] = 0
        if self.prefix_sharing:
            self._share[0][slot] = slot
            self._share[1][slot] = 0

    # -- chunked prefill -------------------------------------------------------
    def _advance_prefill(self) -> None:
        """Ingest prompt chunks for PREFILLING slots, up to
        ``prefill_budget`` tokens this step (always at least one chunk;
        shrunk at >= SHEDDING): least-ingested-first, and every other step
        the FIFO-oldest PREFILLING slot first (reference engine.py:980).
        A slot whose chunk dispatch the ``chunk`` site dropped stalls for
        the rest of the step."""
        if self.prefill_chunks is None:
            return
        self._prefill_tick += 1
        spent = 0
        budget = self._effective_prefill_budget()
        faulted: set = set()

        def prefilling():
            return [st for st in self.scheduler.running.values()
                    if st.status == Status.PREFILLING
                    and st.slot is not None]

        if self._prefill_tick % 2:
            states = prefilling()
            if not states:
                return
            oldest = min(states, key=lambda s: s.seq)
            # the oldest PREFILLING slot never defers (deferral waits on a
            # strictly older pure prefill), so this can only fork
            self._maybe_fork(oldest)
            size = oldest.chunk_plan[oldest.chunk_idx]
            if self._prefill_one_chunk(oldest, size):
                spent += size
            else:
                faulted.add(oldest.slot)
        while True:
            states = sorted(prefilling(),
                            key=lambda s: (s.prefill_pos, s.seq))
            if not states:
                return
            progressed = False
            for st in states:
                if st.status != Status.PREFILLING or st.slot is None:
                    continue        # departed via an earlier activation
                if st.slot in faulted:
                    continue        # dropped dispatch: stalled this step
                if self._maybe_fork(st):
                    continue        # deferred: an older donor is still
                    #                 publishing this slot's prefix
                size = st.chunk_plan[st.chunk_idx]
                if spent and spent + size > budget:
                    return
                if not self._prefill_one_chunk(st, size):
                    faulted.add(st.slot)
                    continue
                spent += size
                progressed = True
            if not progressed:
                return              # everything left is deferred / faulted

    def _maybe_fork(self, st: RequestState) -> bool:
        """At a slot's first chunk under prefix sharing: remap its leading
        pages onto a registered chain (a copy-on-write fork with no
        ingestion) and re-cut its plan to the tail.  Returns True if the
        slot should *defer* this round: a strictly older pure prefill is
        still publishing a longer usable prefix of this prompt (it
        progresses every step, so the wait is bounded).  Reference
        engine.py:1046-1111."""
        if (not self.prefix_sharing or st.prefill_pos or st.share_len
                or st.share_src is not None):
            return False
        mgr = self.cache_mgr
        ps = mgr.page_size
        plen = st.prompt_len
        prompt = st.request.prompt
        limit = plen - 1        # every fork ingests >= 1 real token
        m = mgr.lookup(prompt, limit,
                       require_snapshot=self._needs_state_snapshot)
        m = self._trim_match(m, plen)
        got = m.shared_len if m else 0
        best_pending = 0
        for other in self.scheduler.running.values():
            if (other is st or other.status != Status.PREFILLING
                    or other.slot is None or other.seq >= st.seq
                    or other.share_len or other.share_src is not None):
                continue
            p = _common_prefix_len(other.request.prompt, prompt)
            p = min(p, limit, other.prompt_len // ps * ps) // ps * ps
            best_pending = max(best_pending, p)
        if best_pending > got:
            self.stats["prefix_deferrals"] += 1
            return True
        if not m:
            return False
        # the fork swaps its first k private pages for the chain's k and
        # may need more tail pages where the re-cut plan's padding lands
        # further: the pool must cover that before committing
        rows = m.shared_len + sum(chunking.tail_plan(plen, m.shared_len,
                                                     self.prefill_chunks))
        k = len(m.entries)
        held = len(mgr.page_table(st.slot))
        new_len = max(rows, mgr.length(st.slot))
        extra = mgr.pages_for(new_len) - held
        if extra > mgr.free_pages + k:
            return False        # pool too tight to re-cut: ingest normally
        res = mgr.fork(st.slot, m)
        if not res:
            return False
        if extra > 0:
            mgr.extend(st.slot, new_len)
        if m.snapshot is not None:
            # resume the recurrence from the donor's checkpoint: eager
            # copies on this stream, before the fork's first chunk
            self.model.splice_slot_state(self._cache, m.snapshot, st.slot)
        st.share_src = res.src_slot
        st.share_len = res.shared_len
        st.chunk_plan = chunking.tail_plan(plen, res.shared_len,
                                           self.prefill_chunks)
        st.chunk_idx = 0
        st.prefill_pos = res.shared_len
        self.stats["forks"] += 1
        self.stats["shared_prompt_tokens"] += res.shared_len
        return False

    def _trim_match(self, m: Optional[PrefixMatch],
                    plen: int) -> Optional[PrefixMatch]:
        """Cut a match back until the shared pages plus the re-cut tail
        plan fit the slot arena (the tail's padding can land past the
        full plan's); a recurrent family re-trims to a snapshot
        boundary (reference engine.py:1113-1136)."""
        if m is None:
            return None
        entries = list(m.entries)
        ps = self.cache_mgr.page_size
        while entries:
            sl = len(entries) * ps
            rows = sl + sum(chunking.tail_plan(plen, sl,
                                               self.prefill_chunks))
            if rows <= self.max_seq:
                break
            entries.pop()
            if self._needs_state_snapshot:
                while entries and entries[-1].snapshot is None:
                    entries.pop()
        if not entries:
            return None
        return PrefixMatch(entries=tuple(entries), src_slot=m.src_slot,
                           shared_len=len(entries) * ps)

    def _register_prefix(self, st: RequestState) -> None:
        """Publish a pure slot's ingested pages into the index; a
        recurrent family checkpoints the slot's state at page-aligned
        chunk ends, the only points a fork can resume from (reference
        engine.py:1138-1149).  The snapshot is an eager copy on this
        stream, after the chunk that produced the state."""
        upto = min(st.prefill_pos, st.prompt_len)
        snap = None
        if (self._needs_state_snapshot and upto
                and upto % self.cache_mgr.page_size == 0):
            snap = self.model.extract_slot_state(self._cache, st.slot)
            self.stats["snapshots"] += 1
            self.stats["snapshot_bytes"] = sum(
                t.numel() * t.element_size() for t in snap)
        self.cache_mgr.register_prefix(st.slot, st.request.prompt, upto,
                                       snapshot=snap)

    def _chunk_runner(self, size: int):
        """(static tokens, static scalars, step) of chunk length ``size``:
        the step replays its chunk graph (captured here at the first chunk
        of the length) or runs :meth:`_chunk_step` eagerly."""
        if size not in self._chunk_inputs:
            self._chunk_inputs[size] = (
                torch.zeros((1, size), dtype=torch.int64, device=self.device),
                torch.zeros(self._n_scalars, dtype=torch.int64,
                            device=self.device))
        tokens, scalars = self._chunk_inputs[size]
        step = self._capture_chunk(self.chunk_graphs, size,
                                   lambda: self._chunk_step(tokens, scalars),
                                   scalars)
        if self.spec is None:
            return tokens, scalars, step
        draft = self._capture_chunk(
            self.draft_chunk_graphs, size,
            lambda: self._draft_chunk_step(tokens, scalars), scalars)

        def both():
            # lockstep draft ingestion (reference engine.py:1181-1186):
            # the same chunk into the draft arena, its logits dropped.  It
            # replays first, so no other replay of the shared pool comes
            # between the target's chunk and the read of its logits
            draft()
            return step()

        return tokens, scalars, both

    def _capture_chunk(self, graphs: dict, size: int, step, scalars):
        """``step`` as a replay of its chunk graph in ``graphs`` (captured
        here at the first chunk of length ``size``), or eager."""
        if not self._chunk_capture:
            return step
        if size not in graphs:
            graphs[size] = ChunkGraph(step, scalars, pool=self._chunk_pool)
        return graphs[size].replay

    def _draft_chunk_step(self, tokens: torch.Tensor,
                          scalars: torch.Tensor) -> torch.Tensor:
        """The draft's counterpart of :meth:`_chunk_step` over the draft
        arena (no prefix sharing under speculation)."""
        return self.draft_model.prefill_chunk(
            self._draft_params, tokens, self._draft_cache, scalars[0],
            scalars[1], scalars[2])

    def _prefill_one_chunk(self, st: RequestState, size: int) -> bool:
        """Ingest one chunk; False if the ``chunk`` fault site dropped its
        dispatch (the cursor stays, and the slot replays the same chunk
        next step)."""
        if self._injector is not None and self._injector.fire("chunk"):
            self._step_faulted = True
            return False
        req = st.request
        plen = st.prompt_len
        start = st.prefill_pos
        chunk = np.zeros((size,), np.int64)
        real = min(size, plen - start)
        chunk[:real] = req.prompt[start:start + real]
        is_last = st.chunk_idx == len(st.chunk_plan) - 1
        tokens, scalars, step = self._chunk_runner(size)
        self._stage(tokens, chunk)
        values = [st.slot, start, real - 1]
        if self.prefix_sharing:
            values += [st.share_src if st.share_src is not None
                       else st.slot, st.share_len]
        self._stage(scalars, values)
        logits = step()
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_rows"] += size
        self._note_prefill_shape(("chunk", size))
        st.prefill_pos = start + size
        st.chunk_idx += 1
        if self.prefix_sharing and st.share_src is None:
            self._register_prefix(st)
        if not is_last:
            return True
        self.scheduler.finish_prefill(st.slot)
        # steps submitted mid-prefill are stale for this slot: drop them
        self._slot_gen[st.slot] += 1
        self._activate_slot(st, logits)
        return True

    # -- speculative rounds ---------------------------------------------------
    def _verify_runner(self, k: int, sampled: bool):
        """(static (1, k) tokens, step) of the verify step of rung ``k`` and
        twin ``sampled``: the step replays its verify graph (captured here
        at its first use) or runs :meth:`_verify_step` eagerly."""
        if k not in self._vtokens:
            self._vtokens[k] = torch.zeros((1, k), dtype=torch.int64,
                                           device=self.device)
        tokens = self._vtokens[k]
        key = (k, sampled)
        self._verify_keys.add(key)
        self.stats["spec_verify_compiles"] = len(self._verify_keys)

        def step():
            return self._verify_step(tokens, sampled)

        if not self._capture:
            return tokens, step
        if key not in self.verify_graphs:
            self.verify_graphs[key] = ChunkGraph(
                step, self._vscalars, pool=self._chunk_pool, kind="verify")
        return tokens, self.verify_graphs[key].replay

    def _spec_round(self) -> None:
        """One draft-propose / chunk-verify / commit round over the RUNNING
        slots, in place of a decode step (reference engine.py:1205-1311).

        (1) The draft runs k micro-steps over the whole slot batch, fed
        each slot's current token and then its own proposals, writing
        draft rows [pos, pos + k) and drawing proposal j + 1 with the
        slot's (seed, pos + j + 1) key: the tokens and positions are
        staged once, then fed back and advanced on the device.  (2) Each
        RUNNING slot gets one verify pass over [current, d_1 .. d_{k-1}]
        at rows [pos, pos + k), its tokens copied on the device from the
        proposals, with the target's draws at all k positions.  (3) One
        host sync reads the proposals, draws and finite flags; the host
        accepts the longest leading run of proposals equal to the draws
        and commits them, plus the draw at the first mismatch.  Rejected
        rows in both arenas are dead, so rollback is the position cursor
        alone.  Non-RUNNING slots draft at ``PARKED_POS`` and write
        nothing.  When the ``draft`` fault site fires, every proposal is
        corrupted (+1 mod vocab) on the device before the verify reads it
        (the reference corrupts its host copy at the same point, :1263-
        1270); the committed stream stays the target's own.
        """
        running = [st for st in self.scheduler.running.values()
                   if st.status == Status.RUNNING]
        if not running:
            return
        k = self.spec.k
        tok0 = np.zeros(self.max_slots, np.int64)
        pos0 = np.full(self.max_slots, PARKED_POS, np.int64)
        for st in running:
            # the slot's current token (committed, not yet in the arena)
            # and the row it will occupy
            tok0[st.slot] = st.generated[-1]
            pos0[st.slot] = (st.prompt_len + self.prefix_extra
                             + len(st.generated) - 1)
        all_greedy = all(st.request.sampling.is_greedy for st in running)
        draft = self._draft_greedy if all_greedy else self._draft_sampled
        self._stage(self._dtok, tok0)
        self._stage(self._dpos, pos0)
        self._chain[0].copy_(self._dtok)
        for j in range(k):
            draft()
            self._chain[j + 1].copy_(self._dtok)
        self.stats["spec_draft_steps"] += k
        if self._injector is not None and self._injector.fire("draft"):
            props = self._chain[1:k + 1]
            props.copy_(torch.remainder(props + 1, self.cfg.vocab))
            self._step_faulted = True
        slots = [st.slot for st in running]
        for i, st in enumerate(running):
            tokens, verify = self._verify_runner(
                k, not st.request.sampling.is_greedy)
            tokens.copy_(self._chain[:k, st.slot].view(1, k))
            self._stage(self._vscalars, [st.slot, pos0[st.slot]])
            draws, ok = verify()
            self._vdraws[i, :k].copy_(draws)
            self._vok[i].copy_(ok)
        self.stats["spec_verify_calls"] += len(running)
        # the round's one host sync
        n = len(running)
        reads = [Readback(t) for t in (self._chain[1:k + 1],
                                       self._vdraws[:n, :k], self._vok[:n])]
        props, draws, oks = (self._wait(r) for r in reads)
        outcomes = []
        for i, (st, slot) in enumerate(zip(running, slots)):
            if st.status != Status.RUNNING or st.slot != slot:
                continue    # preempted by an earlier commit this round:
                #             its stream was rewound, and the recompute
                #             replays it; this round's draws are void
            if not oks[i]:
                # non-finite verify logits: quarantine the slot, none of
                # its tokens commit (the others are untouched: the fault
                # lives in the slot's own arena rows)
                self.stats["quarantined"] += 1
                self._step_faulted = True
                self._depart(st, Status.FAILED, "nan-logits")
                continue
            a, committed = sampling.accept_tokens(props[:, slot], draws[i])
            n_done, departures = self.scheduler.on_tokens(slot, committed)
            self.stats["tokens_out"] += n_done
            for dslot, _ in departures:
                self._deactivate(dslot)
            outcomes.append((st.request.uid, a, k))
        self.spec.observe_round(outcomes)
        self.stats["spec_rounds"] += 1
        self.stats["decode_steps"] += 1
        if not all_greedy:
            self.stats["sampled_steps"] += 1

    def _wait(self, read: Readback) -> np.ndarray:
        t0 = time.perf_counter()
        host = read.wait()
        self.stats["host_blocked_s"] += time.perf_counter() - t0
        return host

    # -- the continuous-batching loop ----------------------------------------
    def step(self) -> None:
        """One engine iteration (reference engine.py:1313-1380): retire
        lagged outputs, expire deadlines, observe health, admit, ingest
        prompt chunks, then submit one decode step: the sampled one if a
        RUNNING slot samples, else its greedy twin.  A speculative engine
        runs one synchronous draft / verify / commit round instead, while
        the ladder is below DEGRADED.  The ``decode`` fault site drops the
        step (or round); the ``logits`` site poisons a slot before it."""
        self._tick += 1
        self._drain_pending(limit=self.depth)
        self._expire_deadlines()
        self._observe_health()
        self._admit()
        self._advance_prefill()
        running = [st for st in self.scheduler.running.values()
                   if st.status == Status.RUNNING]
        if not running:
            return
        inj = self._injector
        if inj is not None and inj.fire("decode"):
            # a dropped dispatch: positions do not move, so no stream can
            # diverge; the fault costs a step, never a token
            self._step_faulted = True
            return
        if inj is not None and inj.fire("logits"):
            self._poison_slot(running)
        if self.spec is not None \
                and self._health_state < HealthState.DEGRADED:
            if self._pending:
                # queue decode -> rounds (the ladder recovered): retire
                # every queue step in flight first, so no committed token
                # is credited twice
                self._queue.drain()
                self._drain_pending(limit=0)
            self._spec_round()
            self._spec_resync = True
            return
        if self._spec_resync:
            # rounds -> queue decode (the ladder degraded): the device slot
            # vectors lag the rounds' commits; write each RUNNING slot's
            # token and position from host state, in place
            for st in running:
                self._tokens[st.slot] = st.generated[-1]
                self._pos[st.slot] = (st.prompt_len + self.prefix_extra
                                      + len(st.generated) - 1)
                self._active[st.slot] = 1
            self._spec_resync = False
        sampled = any(not st.request.sampling.is_greedy for st in running)
        if sampled:
            self.stats["sampled_steps"] += 1
        read = self._queue.submit(self._queue_step(sampled))
        self.stats["decode_steps"] += 1
        snapshot = {slot: (st, self._slot_gen[slot])
                    for slot, st in self.scheduler.running.items()}
        self._pending.append((read, snapshot))

    def _queue_step(self, sampled: bool):
        """The decode step to submit: the sampled or greedy graph's replay
        (a speculative engine captures the one it needs here, at its first
        degraded step of that kind), or the eager step."""
        if sampled:
            if self._sampled_step is None:
                self.sampled_graph = DecodeGraph(
                    self._decode_step_sampled, self._tokens, self._pos,
                    self._active)
                self._sampled_step = self.sampled_graph.replay
            return self._sampled_step
        if self._greedy_step is None:
            self.graph = DecodeGraph(self._decode_step, self._tokens,
                                     self._pos, self._active)
            self._greedy_step = self.graph.replay
        return self._greedy_step

    def _drain_pending(self, *, limit: int) -> None:
        """Credit the tokens of steps older than ``limit`` steps, and
        quarantine a slot whose flag says its logits went non-finite."""
        while len(self._pending) > limit:
            read, snapshot = self._pending.popleft()
            t0 = time.perf_counter()
            host_tokens, host_ok = read.wait()
            self.stats["host_blocked_s"] += time.perf_counter() - t0
            for slot, (st, gen) in snapshot.items():
                # stale: the request left this slot after the step was
                # submitted, was still prefilling then, or the slot was
                # recycled to a newer admission
                if (st.status != Status.RUNNING or st.slot != slot
                        or gen != self._slot_gen[slot]):
                    continue
                if not host_ok[slot]:
                    # the first poisoned entry departs the slot FAILED
                    # before a poisoned token commits (FIFO), and later
                    # entries for it die on the status guard above;
                    # co-resident slots are untouched (the NaN lives in
                    # the victim's own arena region)
                    self.stats["quarantined"] += 1
                    self._step_faulted = True
                    self._depart(st, Status.FAILED, "nan-logits")
                    continue
                self.stats["tokens_out"] += 1
                for dslot, _ in self.scheduler.on_token(
                        slot, int(host_tokens[slot])):
                    self._deactivate(dslot)

    def evacuate(self) -> list:
        """Take every unfinished request out of service for migration and
        return their :class:`Request` objects in arrival order (reference
        engine.py:1417-1440).  Each departs ``MIGRATED`` (counted apart
        from failures), its slot leaves the decode batch, its pages free
        through the refcounts, and its result is dropped here: the router
        owns it wherever it places it next.  A stream is a pure function
        of (seed, absolute position), so the new replica replays it bit
        for bit from the prompt."""
        states = [*self.scheduler.waiting,
                  *list(self.scheduler.running.values())]
        states.sort(key=lambda s: s.seq)
        moved = []
        for st in states:
            if st.done:
                continue
            self._depart(st, Status.MIGRATED, "migrated")
            self._results.pop(st.request.uid, None)
            moved.append(st.request)
        return moved

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
