#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

  1. device: the card as ``nvidia-smi`` reports it, CUDA and capability;
  2. build: the eight kernels (flash_attention, flash_attention_bwd,
     flash_decode, flash_prefill_chunk, ssd, matmul, dotp, conv2d) from
     ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one nvcc per
     source, all at once; then the SASS (``cuobjdump``): each bf16
     attention kernel must hold HGMMA (warpgroup MMA) and UTMALDG (TMA
     load), the scaled ones (bf16 q over int8 / fp8 arenas) included,
     flash_decode no combine kernel, each bf16 ssd kernel HMMA
     (mma.sync), the bf16 matmul kernel HGMMA and UTMALDG, the f32 matmul
     kernels LDGSTS (cp.async) and no tensor-core MMA, flash_attention_bwd's
     bf16 dK/dV and dQ kernels HGMMA and UTMALDG, its f32 ones no MMA,
     and none of those ssd / matmul /
     backward kernels may spill (registers and stack printed);
  3. per-kernel checks: each kernel against its plain PyTorch version on
     the card, at the serving path's full-width bf16 shapes (attention:
     ragged lengths, a parked slot, chunk prefix 0 and > 0; ssd: 80 heads,
     S 1024 / 768 / 1000, with and without an initial state, and the f32
     state it carries between its two passes) and at a small f32 shape,
     within the stated limit, each with a planted fault the limit must
     reject; kernel / plain / bound / library-call times (each bound
     from the kernel module's ``cost()``: the work's bytes and products at
     the H100's data-sheet rates, ``core/roofline.py``); flash_decode's
     arrival counters read 0 after its calls, and its CTAs an SM;
     chunk row j must equal flash_decode at pos = prefix + j bit for bit
     (bf16, full width), and at the speculative verify shape (C = 4 rows
     at prefix 1088 through the slot table; kernel / plain / SDPA times,
     the row ``flash_prefill_chunk_verify``); flash_prefill_chunk over a
     whole layer arena with
     a slot table (the captured chunk step's call) must equal it over the
     slot's view bit for bit (3a f32, 3b bf16, 3d int8 / fp8), and a table
     at the neighbour slot must fail the limit; 3d: the fused-dequant
     branch of flash_decode and
     flash_prefill_chunk, small f32 shapes over bf16 / int8 / fp8 arenas
     and bf16 q over int8 / fp8 arenas at llama3.2-3b's full width, against
     the plain versions with planted faults (V scaled by K's scales), the
     bit pin per format, times against the byte bound; 3b / 3d (donor
     table, prefix sharing): the kernels with a donor table (rows [0,
     share_len) of a query batch from another arena row) at small f32
     shapes over f32 / bf16 / int8 / fp8 arenas and at llama3.2-3b's width
     over bf16 / int8 / fp8 (decode with three slots forked onto one at
     share_len 512 and 528, the chunk C = 512 at prefix 512): bit for bit
     against the call without a table over equal donor rows (the own rows
     poisoned with NaN), against the plain versions with a planted fault
     (share_len one page short, > 10x), the pin under the table, times
     with and without the table in alternating pairs; 3e (hymba-1.5b):
     the four kernels of the hybrid path at its full width (hd 64, G = 5,
     each layer's window: 1024 and global; ssd at 50 heads, N = 16, S
     1536 / 1200), the window dropped as the planted fault (> 10x), the
     chunk/decode bit pin under window 1024 (C = 512 at prefix 1024),
     flash_decode rows whose first splits lie before the window, times
     against SDPA with the same mask and the bound over the visible keys;
     3f (qwen2-moe-a2.7b, G = 1, and qwen3-moe-30b-a3b, G = 8; hd 128):
     the three attention kernels at the moe serving runs' shapes, each
     with its planted fault (> 10x), the pin at C = 512 / 256 through the
     slot table, and flash_decode at G = 1 beside G = 8 over the same K/V
     (what the dead rows of the 64-row MMA tile cost); 3g (llava-next-34b,
     G = 7, hd 128; whisper-large-v3, MHA, hd 64): flash_attention causal
     at S = 576 patch rows + 1024 / 768 tokens (one patch row fewer the
     fault), non-causal over the encoder's S = 1500 and the cross prefill's
     Sq = 224 / 160 x Sk = 1500 (the last ragged key strip dropped the
     fault), flash_decode at G = 7 over bf16 and int8 arenas and over
     1500 cross rows with ``lengths=None``;
     3t: the attention backward kernel (flash_attention_bwd) at
     training shapes (llama3.2-3b's B 4 x S 1024, whisper's cross Sq 224
     x Sk 1500, llava's G = 7, hymba's window 1024 at S 2048) against the
     plain backward, the planted fault (delta dropped), two runs bit for
     bit, the forward's O with and without its LSE output bit for bit;
     kernel / plain / SDPA backward times; then SSD's backward (ssd_bwd)
     at mamba2-2.7b's and hymba-1.5b's training shapes (B 2 x S 2048)
     against ``ssd_bwd_plain``, the planted fault (the state gradient not
     carried between chunks), two runs bit for bit, kernel / plain times
     (the state walk's and the chunk kernel's apart), and the ssd forward
     at the same shapes;
  train: llama3.2-3b (batch 4 x seq 1024), then mamba2-2.7b and
     hymba-1.5b (batch 2 x seq 2048), each at full width trained 6 steps
     through ``repro_torch.launch.train`` (remat full), right after phase
     3 on an empty card: each step's loss, grad norm and lr, step wall,
     tokens/s, peak memory, one profiled step (busy share, device ms by
     op, the backward kernels' shares), the model-FLOP share; exact
     launches a step (each attention layer 2 forward and 1 backward, each
     SSD layer 2 ssd and 1 ssd_bwd), no plain attention or SSD, no SDPA
     or cuDNN attention; 5t: one f32 training step, kernel path against
     plain path (llama3.2-3b and mamba2-2.7b at full width and 2 layers;
     reduced qwen2-moe, llava, whisper, hymba), the plain backward run
     non-causal the planted fault; the restart: reduced llama3.2-3b and
     mamba2-2.7b, 6 steps straight = 3, a checkpoint (RPK1), a restore in
     a fresh Trainer, 3 more, bit for bit;
  4. serving, for llama3.2-3b (the attention kernels) and then
     mamba2-2.7b (ssd), each at full width through ``repro_torch.launch.
     serve`` (4 requests, prompts 1024/768, 64 new tokens, 4 slots,
     depth 2), monolithic then chunked, the decode step replayed as the
     engine's captured CUDA graph (the default on the card) and each
     chunk as its length's captured chunk graph (one graph a chunk length
     used, replays equal to the chunks), with each kernel's launch count
     (replays included: flash_decode n_layers x (replays + the warm-up
     step), the chunk kernel n_layers x (chunks + one warm-up a chunk
     graph)), no sampled step and no sampled graph in these greedy runs,
     and each graph's warm-up and capture time and pool bytes; 4b: short
     runs under torch.profiler (device time by kernel, the attention and
     ssd kernels' own line, device busy share; captured in both prefill
     modes; the graph
     launches must equal the replays, and each attention kernel's counted
     launches the ones the profile saw); 4c: the same requests with the
     eager step (``--no-decode-graph``) and the captured one, one pair a
     prefill mode, token streams equal to phase 4's, tok/s and wall ms per
     decode step; chunked with eager and captured chunk steps (decode
     captured), one pair, each run serving the requests twice
     on one engine (the second wave finds its chunk graphs captured):
     streams equal, tok/s, TTFT per request, ``host_blocked_s``, and a
     planted stale device ``start`` that must change the streams; and ms
     per decode step over decode-only windows (every prompt in, 32 steps
     synchronised at both ends, one pair); 4d: the sampled decode step, the
     engine's second graph: ``sample_step`` on the card against the CPU at
     4 x 128256 and 4 x 50280 (keys, words, kept sets and tokens bit for
     bit; q + 1 must move the tokens), its device time alone, a
     chi-square of 20000 draws on the card; then phase 4's requests with
     half of them sampled (temperature 0.6, top-k 50, top-p 0.9, min-p
     0.05), both prefill modes: captured streams (the sampled graph and
     the first-draw graph) equal to eager ones, the sampled requests'
     TTFT, the greedy requests equal to phase 4's, a sampled request
     served alone equal to its stream in the batch, the first draw alone
     captured against eager, and (llama3.2-3b) decode-only windows of
     the greedy twin against the sampled graph (one pair); 4e
     (llama3.2-3b): served with narrow KV arenas, bf16 (streams equal
     phase 4's), then int8 and fp8, both prefill modes captured and one
     eager run of each (eager decode steps; eager chunk steps), streams
     equal, every flash_decode launch scaled, the
     chunked first-token logits of the kernel and the plain model within
     the phase 5 limit, kv_row_bytes and arena bytes beside fp32's, the
     token match against fp32 and one decode-only window pair; 4f: the
     reference's shared-prefix mix (4 requests of 1024 tokens, the first
     512 common; chunks 512 / 256, pages of 16) with prefix sharing on
     and off in alternating pairs, llama3.2-3b over its fp32-format and
     int8 arenas and mamba2-2.7b: streams equal, 3 forks of 512 tokens,
     prefill_rows 1536 lower, every decode and chunk attention launch
     with the donor table, every page drained; the forks' TTFT, tok/s,
     the chunk steps' device time, the graph pools, mamba2's snapshot
     bytes and copy time, and a snapshot taken one chunk early (planted)
     changing a fork's stream; 4g (llama3.2-3b): speculative decoding on
     phase 4's chunked requests: the target as its own draft (same seed,
     k = 4 = max_slots) gives phase 4's, 4d's and 4e's int8 captured
     streams bit for bit with acceptance exactly 1.0 (greedy, sampled),
     a verify start one row late must change them; a 2-layer draft
     (adaptive k) greedy and at temperature 8.0, token match against
     plain decode, and one live request against plain decode in
     alternating pairs (each engine's first and second wave); acceptance,
     rounds, tokens a round, k, device ms of a round's draft steps and
     verify passes, wall ms a token, each draft and verify graph's
     warm-up / capture ms and pool bytes, and every flash_prefill_chunk /
     flash_decode launch held to the verify, draft and chunk graphs'
     replays (the verify launches also by their own counter); 4h: phase
     4's chunked requests under a fixed fault plan over alloc, chunk,
     decode and logits (NaN into one slot's arena region), two waves an
     engine, both models: the survivors equal phase 4's captured streams
     bit for bit, the victims keep a prefix, each poison is quarantined,
     a second faulted run repeats streams and fire counts, faulted
     against fault-free tok/s and TTFT in alternating pairs, poison and
     scrub ms; llama3.2-3b also over its int8 arena and monolithic, two
     planted faults the check must catch (the scrub skipped, the flag
     forced true), the finite flag's device ms a captured step, the
     self-draft under the health ladder (DEGRADED and back: queue decode
     with its graph captured at the first degraded step, streams equal
     plain decode's), and 8 requests over 2 replicas under each
     placement policy and with a mid-run drain and migration (streams
     equal one engine's; tok/s; device memory a replica beside the
     shared weights);
     Then hymba-1.5b (the hybrid family, :func:`hybrid_phase`), prompts
     1536 / 1200 past its 1024-key window: phase 4 in both prefill modes
     (flash_attention and ssd a layer a prefill, flash_prefill_chunk and
     ssd a layer a chunk, flash_decode a layer a replay, all held to the
     replays), 4c's chunk pair and decode windows (one each: captured =
     eager, the device ms a captured step by op), 4d's sampled half
     (captured = eager; ``sample_step`` at 4 x 32001 bit for bit with
     the CPU), 4f's mix (4 x 1536, 1024 common; the forks read donor rows
     through the table, the state from snapshots, a fork's decode window
     straddling its shared length), 4h's fault plan, and phase 5;
     Then qwen2-moe-a2.7b (the moe family, :func:`moe_phase`: 60 routed
     experts top 4 and 4 shared, the reference's capacity predication),
     under its published capacity_factor 1.25, which binds: phase 4 in
     both prefill modes, the share of pairs dropped in a prefill, a chunk
     and a decode step, an eager decode step under
     ``set_sync_debug_mode("error")``, 4c with the chunks eager too and a
     decode window (the captured step's device time by op), 4d's sampled
     half (captured = eager only: capacity couples a dispatch's rows), 4e
     over int8; then with capacity_factor = n_experts / top_k on the same
     weights, where a token's output is its own: phase 4, no pair
     dropped, 4f's mix (sharing on = off), 4h's plan (survivors bit for
     bit) and 2 replicas against one engine.  Then whisper-large-v3 (the
     encdec family, :func:`encdec_phase`): 4 requests of 1500 random
     frames and prompts of 224 / 160 tokens, monolithic (the reference
     refuses chunked prefill for the family): phase 4, one
     eager-vs-captured pair and a decode window, 4d's sampled half, 4h's
     plan (the poison fills the self and cross leaves) and 8 requests
     over 2 replicas against one engine.  Then qwen3-moe-30b-a3b
     (:func:`moe30b_phase`, at 24 of its 48 layers, 29.0 GiB of weights,
     every other model collected first): 4 x 512 tokens, 32 new, both
     modes captured.  Last
     llava-next-34b (the vlm family, :func:`vlm_phase`, 64.05 GiB of
     weights, every other model collected first): phase 4's prompts after
     576 patch rows each, monolithic (refused chunked with patch rows):
     phase 4, the pair and a window, 4d, 4e over int8, 4h;
  5. end to end, per model: request 0's prefill logits through the
     kernels against the same model built on the plain versions; for
     mamba2-2.7b (5c) one bf16 layer at full width, its SSD state carried
     through a chunk and 4 decode steps, held to limits stated from a
     control, on the served model's layer 0 and on 8 more weight draws
     of one layer, and (5b) the logits with f32 params and activations; each
     limit must reject a planted SSD fault; for hymba-1.5b the bf16
     reading beside the control, and (5b) the f32 logits within 1e-3,
     the window dropped in every windowed layer the planted fault; for
     qwen2-moe-a2.7b the logits and every layer's expert choices, kernel
     path against plain, no farther apart than a control (the plain path
     with SDPA attention), and layer 0's MoE dispatched in 512- and
     4-row pieces against one dispatch: with capacity free no token whose
     choices agree moves, under the published capacity tokens move; a
     planted attention fault (the softmax scale dropped) must read more
     than 10x the control; (5b) with capacity free, f32 params and
     activations through all 24 layers, monolithic = chunked first-token
     logits within 1e-3, the chunks under the published capacity the
     planted fault; for whisper-large-v3 the bf16 reading reported and
     (5b) the f32 logits through all 64 layers within
     WHISPER_F32_LOGIT_TOL, the encoder run causal the planted fault; for
     llava-next-34b the logits against the plain path within LOGIT_TOL or
     an SDPA control's reading, whichever is larger, the patch prefix one
     row later the planted fault;
  6. the vector-unit path (fmatmul, dot product, fconv2d, the core
     modules): driven at the paper's sweep sizes with its own launch
     counts; each kernel against its plain version there, at ragged
     shapes and at card shapes (matmul 4096^3 f32 / bf16, dotp 2^26 f32 /
     bf16, conv2d (64, 112, 112, 3) x (7, 7, 3, 64) f32 / bf16) within
     the reassociation bound, each with a planted fault the limit must
     reject by more than 10x; at the matmul and dotp card shapes kernel
     and plain version each against the float64 result within its own
     share; which bf16 matmul shapes take the padding step; dotp's and
     conv2d's bits repeated; kernel / plain / library times (conv2d also
     bf16 and at the sweep's 112 x 112 x 3 -> 8); the core modules on
     CUDA against the CPU, bit for bit;
  7a. analysis (after the restarts): llama3.2-3b's training step (B 4 x
     S 1024, remat full) and an eager decode step at 4 slots over 1024
     arena rows, each traced under ``core/cost.py``'s counting mode on the
     card, its counts equal to the meta trace's of the same shapes
     exactly; each step timed with the default kernels (CUDA events): the
     roofline terms (``launch/dryrun.py``, ``core/roofline.py``'s
     data-sheet constants) at most the measured time, the measured
     roofline fraction printed, the training trace's peak live bytes
     within PEAK_MARGIN of ``torch.cuda.max_memory_allocated``;
  7b. the four examples (``repro_torch.examples``: quickstart, serve_lm,
     vector_unit_demo, train_lm at 60 steps) on the card;
  8. summary: the kernel JSON line (with each kernel's ``design``; the
     rows ``<kernel>_hymba``, ``<kernel>_moe``, ``<kernel>_moe30b``,
     ``<kernel>_whisper`` and ``<kernel>_vlm`` are the kernels at hymba's,
     qwen2-moe's, qwen3-moe's, whisper's and llava's shapes, their
     launches those of the hybrid, moe, encdec and vlm paths), the
     card line, then
     ``{"ok": true, "device": {...}}`` as the last line.

Needs nothing but this checkout; imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Kernel vs plain version, element by element.  f32: JAX's own serving
# tolerance (tests/test_serving.py:195).  bf16: both versions accumulate in
# f32 and round the result to bf16 once; their f32 results differ far below
# a bf16 ulp (a few f32 ulps, from the order of the sums), so each element
# lands on the same bf16 value or on its neighbour: at most one bf16 ulp of
# the larger magnitude, plus BF16_ATOL for elements so close to 0 that
# their bf16 ulp is finer than the f32 noise.  A planted fault (one key too
# many or too few in one row) must exceed the limit at every full-width
# shape.
F32_TOL = 2e-5
BF16_ATOL = 2.0 ** -20
# ssd, kernel vs plain: the two sum in another order (64-token inner
# chunks and fma chains against 256-token chunks and einsums) and take exp
# of cumsums over other spans, so their f32 results differ by ~1e-6
# relative per term, more where terms cancel.  Limit per element: 1e-4 of
# the element or of the output's rms, plus one ulp of the output type
# (the bf16 y is rounded once by each).  A planted fault (initial state
# dropped, or one position's log decay off by 1) must exceed it.
SSD_RTOL = 1e-4
# Full-width prefill logits, kernel path vs plain path, against logits of
# std ~1.  llama3.2-3b (bf16): max |diff| measured 7.23e-2 on this seed
# (every run identical), limit 0.1.  mamba2-2.7b in bf16 reads 0.593, and
# the plain path against itself with 64-token instead of 256-token SSD
# chunks 0.504: 64 random-weight layers compound one-ulp bf16 flips of
# each layer's SSD output, so that reading is reported, not held to a
# limit.  mamba2-2.7b is held in f32 (params and activations) instead,
# where no such flips occur, to MAMBA2_F32_LOGIT_TOL: the reading is
# 1.13e-4 on this seed (f32 reassociation of the scan through 64 layers;
# deterministic), so 1e-3 leaves ~9x; a planted SSD fault (the carry into
# the last 64-token inner chunk dropped) reads 4.48 and must exceed it.
LOGIT_TOL = 0.1
MAMBA2_F32_LOGIT_TOL = 1e-3
# hymba-1.5b (phase 5b) as mamba2: its bf16 logits carry one-ulp flips of
# both branches through 32 layers, so the bf16 reading is reported beside
# the control (the plain path with 64-token SSD chunks); held in f32 to
# 1e-3, where a planted fault (the window dropped in every windowed layer)
# must read more than FAULT_MARGIN times that.
HYMBA_F32_LOGIT_TOL = 1e-3
# whisper-large-v3 (phase 5b) as hymba: its bf16 logits carry one-ulp
# flips through 32 encoder and 32 decoder layers (5.11e-2 on this seed),
# so the bf16 reading is reported; held in f32 (params and activations),
# where the first reading was 2.74e-6 (f32 reassociation through 64
# layers; deterministic), so 3e-5 leaves ~11x; a planted fault (the
# encoder run causal, 2.66 on this seed) must read more than FAULT_MARGIN
# times it.
WHISPER_F32_LOGIT_TOL = 3e-5
# qwen2-moe-a2.7b with capacity free (phase 5b): its bf16 monolithic and
# chunked logits part through router near-ties that one-ulp differences
# move (phase 5's expert choices), so that a token's output is its own
# once capacity no longer binds is held in f32 (params and activations):
# each prompt's first-token logits through monolithic prefill (one
# dispatch of S rows a layer, flash_attention) against chunked prefill
# (512, then 512 or 256 rows; flash_prefill_chunk), all 24 layers, to
# 1e-3, the limit of the other f32 checks; a planted fault (the chunks
# dispatched under the published capacity, which binds, so a token's
# output depends on its chunk-mates) must exceed it by more than
# FAULT_MARGIN.
MOE_F32_LOGIT_TOL = 1e-3
# Phase 5c holds the bf16 ssd tensor-core kernel inside the model: one
# mamba2-2.7b layer at full width in bf16 on request 0's prompt, the final
# SSD state carried through a 64-token chunk and 4 decode steps, kernel
# path against plain path.  The control is the plain path with 64-token
# instead of 256-token SSD chunks on the same layer and inputs, which
# changes nothing but the f32 rounding of the scan.  Each quantity is read
# in ulps of its own type: max over elements of |a - b| / (ulp(max(|a|,
# |b|)) + ulp(rms)), the rms term a floor for elements near 0 (layer_ulps).
# Limit per quantity: its margin times the control's reading, taken as at
# least 1 (a bf16 output the control happens to leave unflipped still
# flips by one ulp).
#   * bf16 outputs of a scan (the layer's y, the chunk's y): both paths
#     reach them through one-ulp flips of the bf16 SSD output; the
#     kernel's f32 results lie farther from the plain path's than the
#     control's (its f32 operands enter the tensor cores as two bf16
#     terms, ~2^-17 relative per term against ~2^-24), so more elements
#     flip, each by the same ulp, and the flips compound through the
#     gate, the norm and the out-projection: margin 4;
#   * the decode outputs: both paths run the same plain recurrence from
#     the carried state, so the kernel reaches them through that state's
#     rounding alone, not through a scan's flips: margin 2 (the kernel
#     read 0.50-0.67 ulps on SSM_LAYER_DRAWS);
#   * f32 states (after the prompt, after the chunk): they carry the
#     rounding itself.  The kernel reads 2.5x (prompt) and 20x (after the
#     chunk) the control; a lower-precision control, the same arithmetic
#     with one bf16 term per f32 operand instead of two (one_term), must
#     fail, and reads far above the kernel: margin 64, 3x above the
#     kernel's 20x, so that a state a few times less precise fails.
# The planted fault of phase 5b (the carry into the last 64-token inner
# chunk dropped, in every scan of the path as a kernel's fault would be:
# the prompt's, and the chunk's, whose carried state it then drops) must
# exceed every limit by more than FAULT_MARGIN.  With the fault in the
# prompt's scan alone and margin 4, 'decode out' read 12.7x on this seed
# but 6.2x on another weight draw; in every scan, 11.1-14.7x on the 8
# draws below.  So the check runs on the served model's layer 0 and on
# each of SSM_LAYER_DRAWS, a 1-layer model's weights from that seed.
SSM_LAYER_MARGIN = {"y": 4.0, "state": 64.0, "chunk y": 4.0,
                    "chunk state": 64.0, "decode out": 2.0}
SSM_LAYER_DRAWS = tuple(range(8))
# The vector-unit kernels (matmul, dotp, conv2d), kernel vs plain: a float32
# result may differ from the plain version's by the reassociation bound
# c 2^-24 sum |a b| over its contraction, with c stated beside each kernel
# (``<module>.error_bound``: 2 K for matmul, KH KW Cin + KH KW + Cin for
# conv2d, 2 depth(n) + 1 for dotp); a bf16 output by that plus one bf16
# ulp of the larger magnitude (each version rounds its f32 result once).
# Each planted fault (matmul: the last K tile dropped; conv2d: one tap
# dropped; dotp: one block's partial dropped) must exceed the limit by
# more than FAULT_MARGIN.
FAULT_MARGIN = 10.0
PARKED_POS = 1 << 30
# The kernels' designs (the JSON line's ``design``).
WGMMA_TMA = ("flash_attention", "flash_decode", "flash_prefill_chunk")
DESIGN = {
    **{k: "bf16: wgmma+tma; f32: cuda-core" for k in WGMMA_TMA},
    "flash_decode": "bf16: wgmma+tma; f32: cuda-core; one launch, the last "
                    "split CTA of a row merges its partials in split order",
    "ssd": "bf16: mma.sync m16n8k16, f32 operands as 2 bf16 terms, rows "
           "split into pieces over 2 passes; f32: cuda-core, a block a row",
    "matmul": "bf16: wgmma+tma, 128x256 tiles, 4-stage ring, a producer "
              "thread and 2 consumer warpgroups; f32: cuda-core fmaf, "
              "cp.async 4-stage ring, 2 blocks an SM",
    "dotp": "cuda-core f32",
    "conv2d": "cuda-core f32 fmaf, one chain an output: a persistent block "
              "an SM (12 warps; 4 when 12 would leave SMs idle, as at the "
              "sweep) per channel block of 32, its weights "
              "resident; tiles of 48 groups of 16 output columns, the "
              "halo channel-planar by cp.async into a second buffer while "
              "a tile computes; a thread 16 columns x 4 channels, its "
              "R + KW - 1 inputs slid across the taps; stores spread over "
              "the next tile's FMAs",
    "flash_prefill_chunk_verify": "the flash_prefill_chunk kernel at the "
                                  "speculative verify shape: C = 4 rows "
                                  "(G x C = 12 query rows of a 64-row "
                                  "wgmma tile) at prefix 1088, the slot "
                                  "read through the slot table",
    "flash_decode_scaled": "int8 / fp8 arena + f32 scales: TMA at one byte "
                           "an element, widened to bf16 in shared memory, "
                           "wgmma; scales on the scores and on P",
    "flash_prefill_chunk_scaled": "int8 / fp8 arena + f32 scales: TMA at one "
                                  "byte an element, widened to bf16 in shared "
                                  "memory, wgmma; scales on the scores and "
                                  "on P",
    **{k + "_donor": "donor table (prefix sharing): strips below share_len "
                     "by TMA from the donor row, at or above from the own "
                     "row, the straddling strip copied by rows (cp.async, "
                     "issued where the ring refills its stage) into the "
                     "same layout; f32: a row select per key"
       for k in ("flash_decode", "flash_prefill_chunk")},
    **{k + "_hymba": "the same kernel at hymba-1.5b's shapes (hd 64, G = "
                     "25 / 5 = 5 query heads a KV head, each layer's "
                     "window: 1024 or global), launched on the hybrid path"
       for k in WGMMA_TMA},
    **{k + "_moe": "the same kernel at qwen2-moe-a2.7b's shapes (MHA: 16 / "
                   "16 heads, G = 1, one live row of each 64-row MMA tile; "
                   "hd 128), launched on the moe path"
       for k in WGMMA_TMA},
    **{k + "_moe30b": "the same kernel at qwen3-moe-30b-a3b's shapes (32 / "
                      "4 heads, G = 8, hd 128), launched on the moe path"
       for k in WGMMA_TMA},
    "ssd_hymba": "the same kernel at hymba-1.5b's SSD branch (50 heads, P "
                 "64, N = 16: one 16-wide k-step, the warps of d_state "
                 "half 1 zero-filled), launched on the hybrid path",
    **{k + "_vlm": "the same kernel at llava-next-34b's shapes (56 / 8 "
                   "heads, G = 7: a 64-row MMA tile folds rows of several "
                   "heads; hd 128; prompts of 576 patch rows + text), "
                   "launched on the vlm path"
       for k in ("flash_attention", "flash_decode")},
    "flash_attention_whisper": "the same kernel at whisper-large-v3's "
                               "shapes (MHA 20 / 20, hd 64): the encoder "
                               "non-causal at S = 1500 (keys masked to the "
                               "true Sk in the last strip), the prompt "
                               "causal, the cross-attention non-causal at "
                               "Sq = prompt x Sk = 1500; launched on the "
                               "encdec path",
    "flash_attention_bwd": "bf16: wgmma+tma, one warpgroup a CTA, P and "
                           "dS as two bf16 register-A terms (10 products a "
                           "live block pair against the work's 5); f32: "
                           "cuda-core; a delta pass; dK/dV, a CTA a "
                           "(batch, KV head, 64-key block) walking its G "
                           "heads' query blocks in order; dQ, a CTA a "
                           "(batch, head, 64-row block); heaviest causal "
                           "CTAs first; no atomics, bits repeat",
    "flash_attention_train": "the flash_attention kernel as training "
                             "calls it: llama3.2-3b's training batch (B 4, "
                             "S 1024, causal) with the f32 row LSE written "
                             "for the backward; its launches are "
                             "llama3.2-3b's training path's (forward and "
                             "remat recompute)",
    "flash_attention_train_hymba": "the same kernel at hymba-1.5b's "
                                   "training shape (B 2, S 2048, 25 / 5 "
                                   "heads, hd 64, window 1024) with the "
                                   "LSE written, launched on the hybrid "
                                   "training path (window 1024 or global)",
    "flash_attention_bwd_hymba": "the same kernel at hymba-1.5b's training "
                                 "shape (B 2, S 2048, 25 / 5 heads, hd 64, "
                                 "window 1024 or global), launched on the "
                                 "hybrid training path",
    "ssd_bwd": "bf16 on the tensor cores (mma.sync m16n8k16, every f32 "
               "operand as two bf16 terms): a block a (row, direction) "
               "walks the chunks with the whole state in accumulators and "
               "the tiles in a 3-stage cp.async ring, writing each "
               "chunk's S0 / dS once as hi and lo bf16 planes; a block a "
               "(64-token chunk, B/C row, slice of its heads) forming C "
               "B^T once, the next head's tiles loading while one "
               "computes, dB / dC summed over the slice's heads in "
               "accumulators in head order, dx and d log_a per head; the "
               "slices summed in order; no atomics, bits repeat",
    "ssd_bwd_hymba": "the same kernel at hymba-1.5b's SSD branch in "
                     "training (100 rows, P 64, N = 16: the state walk "
                     "and the carries over one 16-column d_state tile), "
                     "launched on the hybrid training path",
    "ssd_train": "the ssd kernel at mamba2-2.7b's training batch (B 2 x "
                 "S 2048: 160 rows, one piece a row), launched on the "
                 "training path (forward and remat recompute)",
    "ssd_train_hymba": "the ssd kernel at hymba-1.5b's training batch "
                       "(100 rows, N = 16), launched on the hybrid "
                       "training path",
    "flash_decode_whisper": "the same kernel at whisper-large-v3's shapes "
                            "(G = 1, hd 64): the self-attention over the "
                            "slot's rows and the cross-attention over all "
                            "1500 encoder rows (lengths=None), launched on "
                            "the encdec path"}
# the TPU kernels' scaled branch each scaled row replaces
SCALED_REPLACES = {
    "flash_decode_scaled": "src/repro/kernels/flash_decode.py:39",
    "flash_prefill_chunk_scaled":
        "src/repro/kernels/flash_prefill_chunk.py:38"}
# kernels named in the profile's own line (phase 4b)
PROFILED_KERNELS = ("fa_tc_kernel", "fpc_tc_kernel", "fd_tc_kernel",
                    "ssd_tc_kernel<false>", "ssd_tc_kernel<true>",
                    "ssd_f32_kernel")
# seconds of idle time phase 4b's profile holds before and after its run
PROFILE_MARGIN_S = 0.5
# the device kernel(s) of a wrapper that a captured step launches
DEVICE_SYMBOL = {"flash_decode": re.compile(r"\bfd_(?:tc_)?kernel\b"),
                 "flash_prefill_chunk": re.compile(
                     r"\bfpc_(?:tc_)?kernel\b")}
# a tensor-core kernel instantiated for an int8 (mangled "a") or fp8 arena
NARROW_SYMBOL = re.compile(r"ILi\d+E(?:a|13__nv_fp8_e4m3)E")
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")


def sass_counts(_build, name):
    """{kernel function: {op: SASS lines holding it}} of library ``name``."""
    funcs, cur = {}, None
    for line in _build.sass(name).splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None:
            for op in SASS_OPS:
                funcs[cur][op] += op in line
    return funcs


# Phase 2b's rules for the kernels that must not spill: (library, kernel
# function, SASS ops it must hold, ops it must not hold, how many such
# functions the library has).
SASS_RULES = (("ssd", "ssd_tc_kernel", ("HMMA",), (), 2),
              ("matmul", "mm_bf16_kernel", ("HGMMA", "UTMALDG"), (), 1),
              ("matmul", "mm_f32_kernel", ("LDGSTS",), ("HMMA", "HGMMA"), 2),
              ("flash_attention_bwd", "fab_tc_dkdv", ("HGMMA", "UTMALDG"),
               (), 5),
              ("flash_attention_bwd", "fab_tc_dq", ("HGMMA", "UTMALDG"), (),
               5),
              ("flash_attention_bwd", "fab_dkdv", (), ("HMMA", "HGMMA"), 5),
              ("flash_attention_bwd", "fab_dq", (), ("HMMA", "HGMMA"), 5),
              ("ssd_bwd", "ssd_bwd_tc_states", ("HMMA",), (), 1),
              ("ssd_bwd", "ssd_bwd_tc_chunk", ("HMMA",), (), 1),
              ("ssd_bwd", "ssd_bwd_states", (), ("HMMA", "HGMMA"), 1),
              ("ssd_bwd", "ssd_bwd_chunk", (), ("HMMA", "HGMMA"), 1),
              # conv2d_kernel<T, KW, CIN, NW>: KW 7 / 5 / 3 / any, CIN 3 /
              # any, 12 or 4 warps a block
              ("conv2d", "conv2d_kernelIf", ("LDGSTS",), ("HMMA", "HGMMA"),
               10),
              ("conv2d", "conv2d_kernelI13__nv_bfloat16", (),
               ("HMMA", "HGMMA"), 10))


def sass_check(_build):
    """Phase 2b.  In each wgmma+tma library, every bf16 kernel (the
    functions named ``*_tc_*``, one per head dim) holds HGMMA and UTMALDG
    in its SASS; the f32 kernels beside them hold no HGMMA; flash_decode
    holds no combine kernel (one launch a call).  Then SASS_RULES: the two
    bf16 ssd kernels hold HMMA, the bf16 matmul kernel HGMMA and UTMALDG,
    the f32 matmul kernels LDGSTS and neither HMMA nor HGMMA, the bf16
    attention backward kernels (dK/dV, dQ) HGMMA and UTMALDG, the f32 ones
    neither HMMA nor HGMMA, the SSD backward's bf16 state walk and chunk
    kernels HMMA, its f32 ones neither, the conv2d kernels (every
    instantiation: f32 staging by cp.async, LDGSTS; bf16 widened at
    staging) neither HMMA nor HGMMA, and none of them spills (STACK and
    LOCAL 0); their registers are printed."""
    seen = {}
    for name in WGMMA_TMA:
        funcs = seen[name] = sass_counts(_build, name)
        tc = [c for f, c in funcs.items() if "_tc_" in f]
        narrow = [c for f, c in funcs.items()
                  if "_tc_" in f and NARROW_SYMBOL.search(f)]
        other = sum(c["HGMMA"] for f, c in funcs.items() if "_tc_" not in f)
        print(f"phase 2b: {name}: SASS of {len(tc)} bf16-q kernels: HGMMA "
              f"{[c['HGMMA'] for c in tc]}, UTMALDG "
              f"{[c['UTMALDG'] for c in tc]}; {len(funcs) - len(tc)} f32-q "
              f"kernels: HGMMA {other}")
        # one per head dim, and for the arena kernels one per head dim and
        # arena type (bf16, the scaled int8 and fp8)
        want = 5 if name == "flash_attention" else 15
        assert len(tc) == want and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                       for c in tc), (name, tc)
        assert len(narrow) == want - 5, (name, len(narrow))
        if narrow:
            print(f"phase 2b: {name}: the {len(narrow)} scaled bf16-q "
                  f"kernels (int8, fp8 arenas) hold HGMMA "
                  f"{[c['HGMMA'] for c in narrow]} and UTMALDG "
                  f"{[c['UTMALDG'] for c in narrow]}")
        assert other == 0, (name, other)
    fd = list(seen["flash_decode"])
    assert not any("combine" in f for f in fd), fd
    use = _build.resource_usage("flash_decode")
    print(f"phase 2b: flash_decode: {len(fd)} kernels, no combine kernel; "
          f"registers of the bf16 kernels "
          f"{[u.get('REG') for f, u in use.items() if '_tc_' in f]}")
    for name, new, want, none, count in SASS_RULES:
        funcs = sass_counts(_build, name)
        use = _build.resource_usage(name)
        hits = 0
        for f, c in funcs.items():
            if new not in f:
                continue
            u = next((v for k, v in use.items() if k in f or f in k), {})
            print(f"phase 2b: {name}: {f}: SASS "
                  f"{ {op: n for op, n in c.items() if n} }; REG "
                  f"{u.get('REG')} STACK {u.get('STACK')} LOCAL "
                  f"{u.get('LOCAL')}")
            hits += 1
            assert all(c[op] > 0 for op in want), (f, c)
            assert all(c[op] == 0 for op in none), (f, c)
            assert u.get("REG", 0) > 0 and u.get("STACK", 1) == 0 \
                and u.get("LOCAL", 0) == 0, (f, u)
        assert hits == count, (name, new, list(funcs))


def timed(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls (after a
    warm-up), measured with CUDA events.  A ~0.1 s sleep kernel goes first
    so the calls queue up behind it and the events time the device, not
    the host's launch gaps."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def sdpa(q, k, v, **kw):
    """``F.scaled_dot_product_attention`` with GQA: the yardstick only."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q, k, v, enable_gqa=k.shape[1] != q.shape[1], **kw)


def ulp(x, bits):
    """Spacing of floats with ``bits`` significant bits (bf16 8, f32 24)
    at |x|, in x's dtype; 0 at 0."""
    import torch
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - bits))


def type_bits(t) -> int:
    import torch
    return 8 if t.dtype == torch.bfloat16 else 24


def bf16_ulp(x):
    """Spacing of bfloat16 values (8 significant bits) at |x|; 0 at 0."""
    return ulp(x.float(), 8)


def ssd_limit(got, w):
    """ssd's per-element limit (see SSD_RTOL): SSD_RTOL (|w| + rms(w)) +
    one ulp of ``got``'s type at the larger magnitude (w: f32)."""
    import torch
    big = torch.maximum(got.float().abs(), w.abs())
    return (ulp(big, type_bits(got))
            + SSD_RTOL * (w.abs() + w.pow(2).mean().sqrt()))


def excess(got, want, dtype_name, bound=None) -> float:
    """max over elements of |got - want| / its limit (<= 1 passes);
    ``bound``: a per-element reassociation bound (plus one bf16 ulp for a
    bf16 output) in place of the dtype's limit."""
    import torch
    g, w = got.float(), want.float()
    if bound is not None:
        lim = bound
        if got.dtype == torch.bfloat16:
            lim = lim + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    elif dtype_name == "ssd":
        lim = ssd_limit(got, w)
    elif dtype_name == "float32":
        lim = F32_TOL
    else:
        lim = bf16_ulp(torch.maximum(g.abs(), w.abs())) + BF16_ATOL
    return ((g - w).abs() / lim).max().item()


def check(name, got, want, dtype_name, extra="", fault=None, bound=None,
          margin=1.0):
    """Hold a kernel's output against its plain version; with ``fault``
    (``(what, plain output of a planted fault)``) also show that the limit
    fails that fault by more than ``margin``.  ``dtype_name``: "float32",
    "bfloat16" or "ssd" (ssd_limit); ``bound``: see :func:`excess`.
    Returns the max abs error."""
    err = (got.float() - want.float()).abs().max().item()
    ratio = excess(got, want, dtype_name, bound)
    if bound is not None:
        limit = "c 2^-24 sum|ab|" + (" + 1 bf16 ulp"
                                     if dtype_name == "bfloat16" else "")
    else:
        limit = {"float32": f"{F32_TOL:.1e}",
                 "ssd": f"{SSD_RTOL:.0e} (|x| + rms) + 1 ulp"}.get(
            dtype_name, f"1 bf16 ulp + {BF16_ATOL:.1e}")
    print(f"  {name:<34} max|kernel-plain| = {err:.3e}, "
          f"{ratio:.3f} of the limit ({limit}) {extra}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: error {ratio} x the limit")
    if fault is not None:
        what, bad = fault
        f_err = (got.float() - bad.float()).abs().max().item()
        f_ratio = excess(got, bad, dtype_name, bound)
        print(f"    planted fault ({what}): max|kernel-fault| = "
              f"{f_err:.3e}, {f_ratio:.1f} of the limit")
        if not f_ratio > margin:
            raise AssertionError(f"{name}: the limit passes the planted "
                                 f"fault {what} ({f_ratio} x the limit, "
                                 f"needs > {margin})")
    return err


def exact_check(name, got, plain, exact, shares):
    """Hold the kernel's result and the plain version's to the float64
    result ``exact``, each under its own share of the reassociation bound
    (``shares``: (kernel, plain), the module's ``error_bound_exact`` and
    ``plain_bound_exact``), plus one bf16 ulp of the larger magnitude for
    a bf16 output (``matmul.exact_limit``); print the share of its limit
    each reads."""
    from repro_torch.kernels.matmul import exact_limit
    reads = [((r.double() - exact).abs() / exact_limit(r, exact, share))
             .max().item() for r, share in zip((got, plain), shares)]
    print(f"  {name:<34} against float64: kernel {reads[0]:.3e}, plain "
          f"{reads[1]:.3e} of its own share")
    if not max(reads) <= 1.0:
        raise AssertionError(f"{name}: against float64 {reads} x the "
                             f"limit")


def slot_table_check(torch, ops, label, q, k, v, ks=None, vs=None,
                     prefix=512, slot=2, dtype_name="bfloat16"):
    """Phases 3a / 3b / 3d: flash_prefill_chunk over a whole layer arena
    (N, S, KVH, D) with the slot table [slot] (the captured chunk step's
    call) against the kernel over the slot's own view, bit for bit (max
    diff must read 0.0), and against its plain version within the limit;
    the planted fault, the table at the neighbour slot, must fail that
    limit.  Returns the max abs error."""
    P = ops.PLAIN
    dev = q.device
    pf = torch.tensor([prefix], device=dev)
    table = torch.tensor([slot], device=dev)
    neighbour = torch.tensor([(slot + 1) % k.shape[0]], device=dev)
    own = slice(slot, slot + 1)
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    got = ops.flash_prefill_chunk(q, k, v, prefix=pf, slots=table, **sc)
    view = ops.flash_prefill_chunk(
        q, k[own], v[own], prefix=pf,
        **({} if ks is None else dict(k_scale=ks[own], v_scale=vs[own])))
    diff = (got.float() - view.float()).abs().max().item()
    print(f"  slot table ({label}): over the whole {k.shape[0]}-slot arena "
          f"with table [{slot}] vs over the slot's view: max diff {diff} "
          f"(must be 0.0)")
    assert torch.equal(got, view), (label, diff)
    return check(f"flash_prefill_chunk {label} slot table", got,
                 P.flash_prefill_chunk(q, k, v, prefix=pf, slots=table,
                                       **sc),
                 dtype_name, f"(prefix {prefix})",
                 fault=("the table at the neighbour slot",
                        P.flash_prefill_chunk(q, k, v, prefix=pf,
                                              slots=neighbour, **sc)))


def kernel_checks(torch, ops, cfg):
    """Phase 3a/3b: the attention kernels.  Returns {kernel name:
    record}; the library call is ``F.scaled_dot_product_attention``."""
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     flash_prefill_chunk)
    P = ops.PLAIN
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots, smax, nl = 4, 1121, 8   # chunked-mode arena; 8 layers > 50 MB L2
    rec = {}

    # -- small f32 shapes ---------------------------------------------------
    print("phase 3a: small float32 shapes")
    q = rn(3, 8, 16, dtype=torch.float32)
    k, v = rn(3, 40, 2, 16, dtype=torch.float32), rn(3, 40, 2, 16,
                                                     dtype=torch.float32)
    lens = torch.tensor([1, 17, PARKED_POS + 1], device=dev)
    for w in (None, 8):
        check(f"flash_decode f32 window={w}",
              ops.flash_decode(q, k, v, lengths=lens, window=w),
              P.flash_decode(q, k, v, lengths=lens, window=w), "float32")
    q = rn(2, 16, 8, 16, dtype=torch.float32)
    pre = torch.tensor([5, 0], device=dev)
    for w in (None, 8):
        check(f"flash_prefill_chunk f32 window={w}",
              ops.flash_prefill_chunk(q, k[:2], v[:2], prefix=pre, window=w),
              P.flash_prefill_chunk(q, k[:2], v[:2], prefix=pre, window=w),
              "float32")
    slot_table_check(torch, ops, "f32", q[:1], k, v, prefix=5, slot=1,
                     dtype_name="float32")
    q = rn(2, 8, 64, 16, dtype=torch.float32)
    k, v = rn(2, 2, 64, 16, dtype=torch.float32), rn(2, 2, 64, 16,
                                                     dtype=torch.float32)
    for causal, w in ((True, None), (True, 16), (False, None)):
        check(f"flash_attention f32 causal={causal} w={w}",
              ops.attention(q, k, v, causal=causal, window=w),
              P.attention(q, k, v, causal=causal, window=w), "float32")

    # -- flash_decode at the decode step's shapes ------------------------------
    print(f"phase 3b: full width bf16 (H={h}, KVH={kvh}, D={d}, "
          f"slots={slots}, max_seq={smax})")
    arena_k = rn(nl, slots, smax, kvh, d)
    arena_v = rn(nl, slots, smax, kvh, d)
    q = rn(slots, h, d)
    lens = torch.tensor([1088, 832, PARKED_POS + 1, 1], device=dev)
    bad_lens = lens + torch.tensor([1, 1, 0, 0], device=dev)
    err = check("flash_decode", ops.flash_decode(q, arena_k[0], arena_v[0],
                                                 lengths=lens),
                P.flash_decode(q, arena_k[0], arena_v[0], lengths=lens),
                "bfloat16", "(lengths 1088/832/parked/1)",
                fault=("lengths + 1 in the two long rows",
                       P.flash_decode(q, arena_k[0], arena_v[0],
                                      lengths=bad_lens)))
    layer = [0]

    def nxt():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    before = flash_decode.launches
    ms = timed(lambda: flash_decode.launch(q, arena_k[nxt()],
                                           arena_v[layer[0]], lens), 50)
    torch.cuda.synchronize()
    rows = slots * kvh
    left = int(flash_decode.counters(q.device, rows)[:rows].abs().sum())
    occ = flash_decode.occupancy(torch.bfloat16, d, h // kvh)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  flash_decode: {flash_decode.launches - before} calls, one "
          f"launch each; arrival counters after them: {left} (must be 0); "
          f"{occ} CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor"
          f", bf16, hd {d}, G {h // kvh}): {occ * sms} slots for "
          f"{-(-smax // flash_decode.SPLIT) * rows} CTAs at Sk={smax}")
    assert left == 0, left
    plain_ms = timed(lambda: P.flash_decode(q, arena_k[nxt()],
                                            arena_v[layer[0]],
                                            lengths=lens), 5)
    kpos = torch.arange(smax, device=dev)
    mask = (kpos[None] < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = timed(lambda: sdpa(qs, arena_k[nxt()].transpose(1, 2),
                                arena_v[layer[0]].transpose(1, 2),
                                attn_mask=mask), 20)
    rec["flash_decode"] = dict(
        module=flash_decode, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, cost=flash_decode.cost(q, arena_k[0], lens))

    # -- flash_prefill_chunk at a chunk's shapes -----------------------------
    c = 512
    q = rn(1, c, h, d)
    errs = []
    for p0 in (0, 512):
        pf = torch.tensor([p0], device=dev)
        ks, vs = arena_k[0, :1], arena_v[0, :1]
        errs.append(check(f"flash_prefill_chunk prefix={p0}",
                          ops.flash_prefill_chunk(q, ks, vs, prefix=pf),
                          P.flash_prefill_chunk(q, ks, vs, prefix=pf),
                          "bfloat16", f"(C={c})",
                          fault=("prefix + 1", P.flash_prefill_chunk(
                              q, ks, vs, prefix=pf + 1))))
    pf = torch.tensor([512], device=dev)
    chunk_out = ops.flash_prefill_chunk(q, arena_k[0, :1], arena_v[0, :1],
                                        prefix=pf)
    dec_out = ops.flash_decode(
        q[0], arena_k[0, :1].expand(c, smax, kvh, d),
        arena_v[0, :1].expand(c, smax, kvh, d),
        lengths=512 + torch.arange(c, device=dev) + 1)
    pin = bool(torch.equal(chunk_out[0], dec_out))
    print(f"  pin: chunk row j == flash_decode at pos 512 + j, bit for bit "
          f"(bf16): {pin} (max diff "
          f"{(chunk_out[0].float() - dec_out.float()).abs().max().item()})")
    assert pin, "chunk/decode bit pin broken at full width"
    errs.append(slot_table_check(torch, ops, "bf16", q, arena_k[0],
                                 arena_v[0]))
    # the main path's call: the whole layer arena and a slot table
    table = torch.tensor([2], device=dev)
    ms = timed(lambda: flash_prefill_chunk.launch(
        q, arena_k[nxt()], arena_v[layer[0]], pf, slots=table), 20)
    view_ms = timed(lambda: flash_prefill_chunk.launch(
        q, arena_k[nxt(), 2:3], arena_v[layer[0], 2:3], pf), 20)
    print(f"  flash_prefill_chunk C={c}: {ms:.4f} ms with the slot table, "
          f"{view_ms:.4f} ms over the slot's view")
    plain_ms = timed(lambda: P.flash_prefill_chunk(
        q, arena_k[nxt(), :1], arena_v[layer[0], :1], prefix=pf), 5)
    qpos = 512 + torch.arange(c, device=dev)
    cmask = kpos[None, :] <= qpos[:, None]
    qt = q.transpose(1, 2)
    lib_ms = timed(lambda: sdpa(qt, arena_k[nxt(), :1].transpose(1, 2),
                                arena_v[layer[0], :1].transpose(1, 2),
                                attn_mask=cmask), 20)
    rec["flash_prefill_chunk"] = dict(
        module=flash_prefill_chunk, max_abs_err=max(errs), ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms,
        cost=flash_prefill_chunk.cost(q, arena_k[0], pf), pin=pin)
    rec["flash_prefill_chunk_verify"] = verify_shape_check(
        torch, ops, h, arena_k, arena_v, nxt)

    # -- flash_attention at monolithic prefill's shapes ----------------------
    s = 1024
    qb = rn(1, s, h, d)
    kb, vb = rn(1, s, kvh, d), rn(1, s, kvh, d)
    q4, k4, v4 = qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2)
    err = check("flash_attention causal", ops.attention(q4, k4, v4),
                P.attention(q4, k4, v4), "bfloat16", f"(S={s})",
                fault=("the last row drops key 0",
                       P.attention(q4, k4, v4, window=s - 1)))
    ms = timed(lambda: flash_attention.launch(q4, k4, v4), 20)
    plain_ms = timed(lambda: P.attention(q4, k4, v4), 5)
    lib_ms = timed(lambda: sdpa(q4, k4, v4, is_causal=True), 20)
    rec["flash_attention"] = dict(
        module=flash_attention, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, cost=flash_attention.cost(q4, k4, v4))
    del arena_k, arena_v
    return rec


# Phase 3b (verify): the speculative verify pass's call, C = k = 4 rows at
# a slot's prefix 1088 (phase 4's longest prompt plus its first tokens),
# read through the slot table
VERIFY_C, VERIFY_PREFIX = 4, 1088


def verify_shape_check(torch, ops, h, arena_k, arena_v, nxt):
    """flash_prefill_chunk at the verify shape (bf16, full width; the row
    ``flash_prefill_chunk_verify``): against its plain version with a
    planted fault (prefix + 1), the pin (row j == flash_decode at pos =
    prefix + j, bit for bit), and kernel / plain / SDPA times over the
    slot's 1092 K/V rows (``arena_k`` / ``arena_v``: (layers, slots, S,
    KVH, hd); ``nxt()`` picks the next layer, so the timed calls read past
    L2)."""
    from repro_torch.kernels import flash_prefill_chunk
    P = ops.PLAIN
    _, _, smax, kvh, d = arena_k.shape
    c, p0, slot = VERIFY_C, VERIFY_PREFIX, 1
    gen = torch.Generator(device="cuda").manual_seed(24)
    q = torch.randn((1, c, h, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pf = torch.tensor([p0], device="cuda")
    table = torch.tensor([slot], device="cuda")
    ks, vs = arena_k[0], arena_v[0]
    own_k, own_v = ks[slot:slot + 1], vs[slot:slot + 1]
    err = check(f"flash_prefill_chunk verify C={c} prefix={p0}",
                ops.flash_prefill_chunk(q, ks, vs, prefix=pf, slots=table),
                P.flash_prefill_chunk(q, own_k, own_v, prefix=pf),
                "bfloat16", "(slot table)",
                fault=("prefix + 1", P.flash_prefill_chunk(
                    q, own_k, own_v, prefix=pf + 1)))
    chunk = ops.flash_prefill_chunk(q, ks, vs, prefix=pf, slots=table)
    dec = ops.flash_decode(q[0], own_k.expand(c, smax, kvh, d),
                           own_v.expand(c, smax, kvh, d),
                           lengths=p0 + 1 + torch.arange(c, device="cuda"))
    pin = bool(torch.equal(chunk[0], dec))
    print(f"  pin at the verify shape: chunk row j == flash_decode at pos "
          f"{p0} + j, bit for bit (bf16, C={c}, slot table): {pin}")
    assert pin, "chunk/decode bit pin broken at the verify shape"

    def layer_pair():
        i = nxt()
        return arena_k[i], arena_v[i]

    def kernel():
        k, v = layer_pair()
        return flash_prefill_chunk.launch(q, k, v, pf, slots=table)

    def plain():
        k, v = layer_pair()
        return P.flash_prefill_chunk(q, k[slot:slot + 1], v[slot:slot + 1],
                                     prefix=pf)

    kpos = torch.arange(smax, device="cuda")
    cmask = kpos[None, :] <= (p0 + torch.arange(c, device="cuda"))[:, None]
    qt = q.transpose(1, 2)

    def library():
        k, v = layer_pair()
        return sdpa(qt, k[slot:slot + 1].transpose(1, 2),
                    v[slot:slot + 1].transpose(1, 2), attn_mask=cmask)

    ms, plain_ms, lib_ms = timed(kernel, 50), timed(plain, 5), \
        timed(library, 50)
    return dict(module=flash_prefill_chunk, label=f"fpc verify C={c}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                cost=flash_prefill_chunk.cost(q, ks, pf), pin=pin)


def scaled_kernel_checks(torch, ops, cfg):
    """Phase 3d: the fused-dequant branch of flash_decode and
    flash_prefill_chunk (int8 / fp8 arenas with f32 scales per row and KV
    head).  Small f32 shapes over bf16, int8 and fp8 arenas (the CUDA-core
    tile) and bf16 q over int8 and fp8 arenas at llama3.2-3b's full width
    (the tensor-core tile: flash_decode at 4 x 1121 rows, lengths 1088 /
    832 / parked / 1; flash_prefill_chunk at C = 512, prefixes 0 and 512),
    each against its plain version within today's limits, each limit
    failing a planted fault (V scaled by K's scales; over a bf16 arena,
    which has no scales, one key too many); the chunk/decode bit pin per
    format at full width; kernel / plain times, and the byte bound of the
    arena, its scales, q and o.  Returns the two scaled records (times of
    int8; fp8's under ``formats``)."""
    from repro_torch.core import kv_format as kvf
    from repro_torch.kernels import flash_decode, flash_prefill_chunk
    P = ops.PLAIN
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)

    def arena(fmt, shape):
        k = torch.randn(shape, generator=gen, device=dev)
        v = torch.randn(shape, generator=gen, device=dev)
        (kq, ks), (vq, vs) = (kvf.quantize(kvf.get(fmt), t) for t in (k, v))
        return kq, vq, ks, vs

    def scales(ks, vs, fault=False):
        return ({} if ks is None
                else dict(k_scale=ks, v_scale=ks if fault else vs))

    print("phase 3d: small float32 shapes over bf16, int8 and fp8 arenas")
    q = torch.randn((3, 8, 16), generator=gen, device=dev)
    qc = torch.randn((2, 16, 8, 16), generator=gen, device=dev)
    lens = torch.tensor([1, 17, PARKED_POS + 1], device=dev)
    pre = torch.tensor([5, 0], device=dev)
    for fmt in ("bf16", "int8", "fp8"):
        k, v, ks, vs = arena(fmt, (3, 40, 2, 16))
        sc, bad = scales(ks, vs), scales(ks, vs, fault=True)
        sc2 = {key: t[:2] for key, t in sc.items()}
        bad2 = {key: t[:2] for key, t in bad.items()}
        what = ("V scaled by K's scales" if ks is not None
                else "one key too many")
        more = 0 if ks is not None else 1
        for w in (None, 8):
            check(f"flash_decode f32/{fmt} window={w}",
                  ops.flash_decode(q, k, v, lengths=lens, window=w, **sc),
                  P.flash_decode(q, k, v, lengths=lens, window=w, **sc),
                  "float32", fault=(what, P.flash_decode(
                      q, k, v, lengths=lens + more, window=w, **bad)))
            check(f"flash_prefill_chunk f32/{fmt} window={w}",
                  ops.flash_prefill_chunk(qc, k[:2], v[:2], prefix=pre,
                                          window=w, **sc2),
                  P.flash_prefill_chunk(qc, k[:2], v[:2], prefix=pre,
                                        window=w, **sc2),
                  "float32", fault=(what, P.flash_prefill_chunk(
                      qc, k[:2], v[:2], prefix=pre + more, window=w,
                      **bad2)))

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots, smax, nl, c = 4, 1121, 8, 512
    print(f"phase 3d: full width, bf16 q over int8 and fp8 arenas (H={h}, "
          f"KVH={kvh}, D={d}, slots={slots}, max_seq={smax}, {nl} layers > "
          f"50 MB L2)")
    lens = torch.tensor([1088, 832, PARKED_POS + 1, 1], device=dev)
    q = torch.randn((slots, h, d), generator=gen, device=dev).bfloat16()
    qc = torch.randn((1, c, h, d), generator=gen, device=dev).bfloat16()
    qpos = 512 + torch.arange(c, device=dev)
    out = {}
    for fmt in ("int8", "fp8"):
        layers = [arena(fmt, (slots, smax, kvh, d)) for _ in range(nl)]
        ak, av, aks, avs = (torch.stack(t) for t in zip(*layers))
        del layers
        layer = [0]

        def nxt():
            layer[0] = (layer[0] + 1) % nl
            return layer[0]

        sc = dict(k_scale=aks[0], v_scale=avs[0])
        bad = dict(k_scale=aks[0], v_scale=aks[0])
        err_d = check(f"flash_decode bf16/{fmt}",
                      ops.flash_decode(q, ak[0], av[0], lengths=lens, **sc),
                      P.flash_decode(q, ak[0], av[0], lengths=lens, **sc),
                      "bfloat16", "(lengths 1088/832/parked/1)",
                      fault=("V scaled by K's scales", P.flash_decode(
                          q, ak[0], av[0], lengths=lens, **bad)))
        ms_d = timed(lambda: flash_decode.launch(
            q, ak[nxt()], av[layer[0]], lens, k_scale=aks[layer[0]],
            v_scale=avs[layer[0]]), 50)
        torch.cuda.synchronize()
        left = int(flash_decode.counters(q.device, slots * kvh)[
            :slots * kvh].abs().sum())
        assert left == 0, left
        plain_d = timed(lambda: P.flash_decode(
            q, ak[nxt()], av[layer[0]], lengths=lens,
            k_scale=aks[layer[0]], v_scale=avs[layer[0]]), 5)
        errs = []
        for p0 in (0, 512):
            pf = torch.tensor([p0], device=dev)
            sc1 = {key: t[:1] for key, t in sc.items()}
            bad1 = {key: t[:1] for key, t in bad.items()}
            errs.append(check(
                f"flash_prefill_chunk bf16/{fmt} prefix={p0}",
                ops.flash_prefill_chunk(qc, ak[0, :1], av[0, :1], prefix=pf,
                                        **sc1),
                P.flash_prefill_chunk(qc, ak[0, :1], av[0, :1], prefix=pf,
                                      **sc1),
                "bfloat16", f"(C={c})", fault=(
                    "V scaled by K's scales", P.flash_prefill_chunk(
                        qc, ak[0, :1], av[0, :1], prefix=pf, **bad1))))
        pf = torch.tensor([512], device=dev)
        chunk_out = ops.flash_prefill_chunk(
            qc, ak[0, :1], av[0, :1], prefix=pf, k_scale=aks[0, :1],
            v_scale=avs[0, :1])
        ex = lambda t: t[0, :1].expand(c, *t.shape[2:])  # noqa: E731
        dec_out = ops.flash_decode(
            qc[0], ex(ak), ex(av), lengths=qpos + 1, k_scale=ex(aks),
            v_scale=ex(avs))
        pin = bool(torch.equal(chunk_out[0], dec_out))
        print(f"  pin ({fmt}): chunk row j == flash_decode at pos 512 + j, "
              f"bit for bit: {pin} (max diff "
              f"{(chunk_out[0].float() - dec_out.float()).abs().max().item()}"
              f")")
        assert pin, f"chunk/decode bit pin broken at full width ({fmt})"
        errs.append(slot_table_check(torch, ops, f"bf16/{fmt}", qc, ak[0],
                                     av[0], aks[0], avs[0]))
        table = torch.tensor([2], device=dev)
        ms_c = timed(lambda: flash_prefill_chunk.launch(
            qc, ak[nxt()], av[layer[0]], pf, k_scale=aks[layer[0]],
            v_scale=avs[layer[0]], slots=table), 20)
        plain_c = timed(lambda: P.flash_prefill_chunk(
            qc, ak[nxt(), :1], av[layer[0], :1], prefix=pf,
            k_scale=aks[layer[0], :1], v_scale=avs[layer[0], :1]), 5)
        # each input read once, each output written once: q and o in bf16,
        # the live K/V rows at one byte an element, one f32 scale per row
        # and KV head for K and for V
        out[fmt] = {
            "flash_decode_scaled": dict(
                err=err_d, ms=ms_d, plain_ms=plain_d,
                cost=flash_decode.cost(q, ak[0], lens, k_scale=aks[0])),
            "flash_prefill_chunk_scaled": dict(
                err=max(errs), ms=ms_c, plain_ms=plain_c,
                cost=flash_prefill_chunk.cost(qc, ak[0], pf,
                                              k_scale=aks[0]))}
        del ak, av, aks, avs
    rec = {}
    for name, module in (("flash_decode_scaled", flash_decode),
                         ("flash_prefill_chunk_scaled", flash_prefill_chunk)):
        i8 = out["int8"][name]
        rec[name] = dict(
            module=module, label=name, replaces=SCALED_REPLACES[name],
            max_abs_err=max(out[f][name]["err"] for f in out), ms=i8["ms"],
            plain_ms=i8["plain_ms"], library_ms=None, cost=i8["cost"],
            pin=True,
            formats={f: {k: out[f][name][k] for k in ("ms", "plain_ms")}
                     for f in out})
        print(f"  {name}: kernel ms int8 {out['int8'][name]['ms']:.4f}, fp8 "
              f"{out['fp8'][name]['ms']:.4f}; plain ms int8 "
              f"{out['int8'][name]['plain_ms']:.4f}, fp8 "
              f"{out['fp8'][name]['plain_ms']:.4f}")
    return rec


# The donor table's share lengths at full width (phases 3b / 3d): a
# multiple of the 64-key strip, and one page (16 rows) past it, so one
# strip straddles the length (loaded by rows)
SHARE_LENS = (512, 528)
PAGE = 16


def donor_checks(torch, ops, cfg):
    """Phases 3b / 3d, the donor table of flash_decode and
    flash_prefill_chunk (prefix sharing: query batch b reads rows [0,
    share_len[b]) from arena row share_src[b]).  Small f32 shapes over f32,
    bf16, int8 and fp8 arenas (the CUDA-core tile), then bf16 q over bf16,
    int8 and fp8 arenas at llama3.2-3b's width (H 24 / KVH 8, hd 128, 4
    slots x 1121 rows): flash_decode with slots 1-3 forked onto slot 0 at
    share_len 512 and 528, flash_prefill_chunk C = 512 at prefix 512 in
    slot 2 with (src 0, len 512).  Each: against its plain version within
    the limit, a planted fault (share_len one page short) failing it by
    more than FAULT_MARGIN; bit for bit against the call without a table
    over an arena whose donor rows equal the own rows, the own rows [0, L)
    of the table call poisoned (NaN; int8 the largest value under NaN
    scales), so a read of them would show; the chunk/decode pin under the
    table.  Times with and without the table, in alternating pairs.
    Returns the two donor records (times of the bf16 arena; int8's and
    fp8's under ``formats``)."""
    from repro_torch.core import kv_format as kvf
    from repro_torch.kernels import flash_decode, flash_prefill_chunk
    P = ops.PLAIN
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)

    def arena(fmt, shape, dtype=torch.bfloat16):
        k = torch.randn(shape, generator=gen, device=dev)
        v = torch.randn(shape, generator=gen, device=dev)
        if fmt in ("fp32", "bf16"):
            dt = dtype if fmt == "fp32" else torch.bfloat16
            return k.to(dt), v.to(dt), None, None
        (kq, ks), (vq, vs) = (kvf.quantize(kvf.get(fmt), t) for t in (k, v))
        return kq, vq, ks, vs

    def sc(ks, vs):
        return {} if ks is None else dict(k_scale=ks, v_scale=vs)

    def shared(ts, owners, src, length):
        """Copies of ``ts`` whose rows [0, length) of each owner are the
        donor's (the reference arena of the bit check)."""
        out = []
        for t in ts:
            if t is not None:
                t = t.clone()
                for o in owners:
                    t[o, :length] = t[src, :length]
            out.append(t)
        return out

    def poisoned(ts, owners, length):
        out = []
        for t in ts:
            if t is not None:
                t = t.clone()
                for o in owners:
                    if t.dtype == torch.int8:
                        t[o, :length] = 127
                    else:
                        t[o, :length] = float("nan")
            out.append(t)
        return out

    def table(n, owners, src, length):
        """The donor table of ``n`` query batches: each of ``owners``
        reads rows [0, length) from arena row ``src``, the rest their own
        (the identity)."""
        s, ln = list(range(n)), [0] * n
        for o in owners:
            s[o], ln[o] = src, length
        return dict(share_src=torch.tensor(s, dtype=torch.int32, device=dev),
                    share_len=torch.tensor(ln, dtype=torch.int32,
                                           device=dev))

    def bit_check(label, fn, ts, owners, src, length):
        """fn(arena, table or None): with the table over the poisoned
        arena == without it over the shared arena, bit for bit."""
        want = fn(shared(ts, owners, src, length), None)
        got = fn(poisoned(shared(ts, owners, src, length), owners, length),
                 (owners, src, length))
        diff = (got.float() - want.float()).abs().max().item()
        print(f"  donor table ({label}): with the table over poisoned own "
              f"rows vs without over equal rows: max diff {diff} (must be "
              f"0.0)")
        assert torch.equal(got, want), (label, diff)

    print("phase 3b/3d: donor table, small float32 shapes over f32, bf16, "
          "int8 and fp8 arenas (4 x 300 rows, hd 16)")
    n, s, kvh, h, d, c = 4, 300, 2, 6, 16, 40
    q = torch.randn((n, h, d), generator=gen, device=dev)
    qc = torch.randn((1, c, h, d), generator=gen, device=dev)
    lens = torch.tensor([17, 250, PARKED_POS + 1, 1], device=dev)
    pf, slot = torch.tensor([200], device=dev), torch.tensor([1], device=dev)
    for fmt in ("fp32", "bf16", "int8", "fp8"):
        ts = arena(fmt, (n, s, kvh, d), torch.float32)
        for length in (12, 64, 100):
            def dec(a, tab, length=length):
                kw = {} if tab is None else table(n, *tab)
                return ops.flash_decode(q, a[0], a[1], lengths=lens,
                                        **sc(a[2], a[3]), **kw)

            def chk(a, tab):
                kw = {} if tab is None else table(1, [0], tab[1], tab[2])
                return ops.flash_prefill_chunk(
                    qc, a[0], a[1], prefix=pf, slots=slot,
                    **sc(a[2], a[3]), **kw)
            bit_check(f"f32/{fmt} decode L={length}", dec, ts, [1], 3,
                      length)
            bit_check(f"f32/{fmt} chunk L={length}", chk, ts, [1], 3,
                      length)
            tab = table(n, [1], 3, length)
            bad = table(n, [1], 3, max(0, length - PAGE))
            check(f"flash_decode f32/{fmt} donor L={length}",
                  ops.flash_decode(q, ts[0], ts[1], lengths=lens,
                                   **sc(ts[2], ts[3]), **tab),
                  P.flash_decode(q, ts[0], ts[1], lengths=lens,
                                 **sc(ts[2], ts[3]), **tab), "float32",
                  fault=("share_len one page short", P.flash_decode(
                      q, ts[0], ts[1], lengths=lens, **sc(ts[2], ts[3]),
                      **bad)))
            tab1 = table(1, [0], 3, length)
            bad1 = table(1, [0], 3, max(0, length - PAGE))
            check(f"flash_prefill_chunk f32/{fmt} donor L={length}",
                  ops.flash_prefill_chunk(qc, ts[0], ts[1], prefix=pf,
                                          slots=slot, **sc(ts[2], ts[3]),
                                          **tab1),
                  P.flash_prefill_chunk(qc, ts[0], ts[1], prefix=pf,
                                        slots=slot, **sc(ts[2], ts[3]),
                                        **tab1), "float32",
                  fault=("share_len one page short", P.flash_prefill_chunk(
                      qc, ts[0], ts[1], prefix=pf, slots=slot,
                      **sc(ts[2], ts[3]), **bad1)))

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots, smax, nl, c = 4, 1121, 8, 512
    print(f"phase 3b/3d: donor table at full width, bf16 q over bf16, int8 "
          f"and fp8 arenas (H={h}, KVH={kvh}, D={d}, slots={slots}, "
          f"max_seq={smax}; slots 1-3 forked onto slot 0 at share_len "
          f"{SHARE_LENS}; chunk C={c} at prefix 512 in slot 2, (0, 512))")
    q = torch.randn((slots, h, d), generator=gen, device=dev).bfloat16()
    qc = torch.randn((1, c, h, d), generator=gen, device=dev).bfloat16()
    lens = torch.tensor([1088, 1060, 832, 1024], device=dev)
    pf, slot = torch.tensor([512], device=dev), torch.tensor([2], device=dev)
    qpos = 512 + torch.arange(c, device=dev)
    out = {}
    for fmt in ("bf16", "int8", "fp8"):
        layers = [arena(fmt, (slots, smax, kvh, d)) for _ in range(nl)]
        A = [None if t[0] is None else torch.stack(t)
             for t in zip(*layers)]
        del layers
        ts = [None if t is None else t[0] for t in A]
        errs_d, errs_c = [], []
        for length in SHARE_LENS:
            owners = [1, 2, 3]

            def dec(a, tab):
                kw = {} if tab is None else table(slots, *tab)
                return ops.flash_decode(q, a[0], a[1], lengths=lens,
                                        **sc(a[2], a[3]), **kw)
            bit_check(f"bf16/{fmt} decode L={length}", dec, ts, owners, 0,
                      length)
            tab = table(slots, owners, 0, length)
            bad = table(slots, owners, 0, length - PAGE)
            errs_d.append(check(
                f"flash_decode bf16/{fmt} donor L={length}",
                ops.flash_decode(q, ts[0], ts[1], lengths=lens,
                                 **sc(ts[2], ts[3]), **tab),
                P.flash_decode(q, ts[0], ts[1], lengths=lens,
                               **sc(ts[2], ts[3]), **tab),
                "bfloat16", "(lengths 1088/1060/832/1024)",
                fault=("share_len one page short", P.flash_decode(
                    q, ts[0], ts[1], lengths=lens, **sc(ts[2], ts[3]),
                    **bad)), margin=FAULT_MARGIN))

        def chk(a, tab):
            kw = {} if tab is None else table(1, [0], tab[1], tab[2])
            return ops.flash_prefill_chunk(qc, a[0], a[1], prefix=pf,
                                           slots=slot, **sc(a[2], a[3]),
                                           **kw)
        bit_check(f"bf16/{fmt} chunk L=512", chk, ts, [2], 0, 512)
        tab1, bad1 = table(1, [0], 0, 512), table(1, [0], 0, 512 - PAGE)
        got = ops.flash_prefill_chunk(qc, ts[0], ts[1], prefix=pf,
                                      slots=slot, **sc(ts[2], ts[3]), **tab1)
        errs_c.append(check(
            f"flash_prefill_chunk bf16/{fmt} donor", got,
            P.flash_prefill_chunk(qc, ts[0], ts[1], prefix=pf, slots=slot,
                                  **sc(ts[2], ts[3]), **tab1),
            "bfloat16", f"(C={c}, prefix 512)",
            fault=("share_len one page short", P.flash_prefill_chunk(
                qc, ts[0], ts[1], prefix=pf, slots=slot,
                **sc(ts[2], ts[3]), **bad1)), margin=FAULT_MARGIN))
        # the pin under the table: chunk row j == flash_decode at pos 512 +
        # j over a (c + 1)-row arena, rows 0..c-1 slot 2, row c the donor
        big = [None if t is None else torch.cat(
            (t[2:3].expand(c, *t.shape[1:]), t[0:1])) for t in ts]
        dec = ops.flash_decode(
            torch.cat((qc[0], qc[0, :1])), big[0], big[1],
            lengths=torch.cat((qpos + 1, torch.ones(1, dtype=torch.int64,
                                                    device=dev))),
            **sc(big[2], big[3]), **table(c + 1, range(c), c, 512))
        pin = bool(torch.equal(got[0], dec[:c]))
        print(f"  pin under the table ({fmt}): chunk row j == flash_decode "
              f"at pos 512 + j, bit for bit: {pin} (max diff "
              f"{(got[0].float() - dec[:c].float()).abs().max().item()})")
        assert pin, f"chunk/decode bit pin broken under the table ({fmt})"
        del big, dec
        layer = [0]

        def nxt():
            layer[0] = (layer[0] + 1) % nl
            return layer[0]

        def dcall(tab):
            i = nxt()
            return lambda: flash_decode.launch(
                q, A[0][i], A[1][i], lens,
                **sc(None if A[2] is None else A[2][i],
                     None if A[3] is None else A[3][i]), **tab)

        def ccall(tab):
            i = nxt()
            return lambda: flash_prefill_chunk.launch(
                qc, A[0][i], A[1][i], pf, slots=slot,
                **sc(None if A[2] is None else A[2][i],
                     None if A[3] is None else A[3][i]), **tab)

        def rotating(make, tab, iters):
            calls = [make(tab) for _ in range(nl)]
            it = [0]

            def fn():
                it[0] = (it[0] + 1) % nl
                calls[it[0]]()
            return timed(fn, iters)

        tab528 = table(slots, [1, 2, 3], 0, SHARE_LENS[-1])
        times = {"decode": {"table": [], "none": []},
                 "chunk": {"table": [], "none": []}}
        for i in range(2):
            for kind in (("none", "table") if i % 2 == 0
                         else ("table", "none")):
                t = tab528 if kind == "table" else {}
                times["decode"][kind].append(rotating(dcall, t, 50))
                times["chunk"][kind].append(rotating(
                    ccall, tab1 if kind == "table" else {}, 20))
        plain_d = timed(lambda: P.flash_decode(
            q, ts[0], ts[1], lengths=lens, **sc(ts[2], ts[3]), **tab528), 5)
        plain_c = timed(lambda: P.flash_prefill_chunk(
            qc, ts[0], ts[1], prefix=pf, slots=slot, **sc(ts[2], ts[3]),
            **tab1), 5)
        # each (slot, row) the forks read counted once
        out[fmt] = {
            "flash_decode_donor": dict(
                err=max(errs_d), ms=statistics.mean(times["decode"]["table"]),
                none_ms=statistics.mean(times["decode"]["none"]),
                plain_ms=plain_d,
                cost=flash_decode.cost(q, ts[0], lens, k_scale=ts[2],
                                       **tab528)),
            "flash_prefill_chunk_donor": dict(
                err=max(errs_c), ms=statistics.mean(times["chunk"]["table"]),
                none_ms=statistics.mean(times["chunk"]["none"]),
                plain_ms=plain_c,
                cost=flash_prefill_chunk.cost(qc, ts[0], pf, k_scale=ts[2],
                                              **tab1))}
        for name, r in out[fmt].items():
            print(f"  {name} ({fmt}): {r['ms']:.4f} ms with the table vs "
                  f"{r['none_ms']:.4f} ms without (2 alternating pairs: "
                  f"decode {[round(x, 4) for x in times['decode']['table']]}"
                  f" / {[round(x, 4) for x in times['decode']['none']]}, "
                  f"chunk {[round(x, 4) for x in times['chunk']['table']]}"
                  f" / {[round(x, 4) for x in times['chunk']['none']]}); "
                  f"plain {r['plain_ms']:.4f} ms")
        del A, ts
    rec = {}
    for name, module in (("flash_decode_donor", flash_decode),
                         ("flash_prefill_chunk_donor", flash_prefill_chunk)):
        b16 = out["bf16"][name]
        rec[name] = dict(
            module=module, label=name, max_abs_err=max(
                out[f][name]["err"] for f in out),
            ms=b16["ms"], plain_ms=b16["plain_ms"], library_ms=None,
            cost=b16["cost"], pin=True,
            formats={f: {k: out[f][name][k]
                         for k in ("ms", "none_ms", "plain_ms")}
                     for f in out})
    return rec


def ssd_checks(torch, ops, cfg):
    """Phase 3c: ssd against its plain version at the mamba2-2.7b path's
    shapes (one batch row of 80 heads, headdim 64, d_state 128, one B/C
    group shared by every head) and at a small f32 shape.  Returns the
    kernel's record."""
    from repro_torch.kernels import ssd
    P = ops.PLAIN
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    s_cfg = cfg.ssm
    nh, hd, n = s_cfg.n_heads(cfg.d_model), s_cfg.headdim, s_cfg.d_state

    def inputs(bh, s, p, n, groups, dtype):
        """x (as the layer hands it over: a head-transposed view), log
        decays -dt with dt in [0, 0.1), B/C, an initial state."""
        x = (torch.randn((s, bh, p), generator=gen, device=dev)
             * 0.05).to(dtype).transpose(0, 1)
        la = -torch.rand((s, bh), generator=gen, device=dev).T * 0.1
        B = torch.randn((groups, s, n), generator=gen, device=dev).to(dtype)
        C = torch.randn((groups, s, n), generator=gen, device=dev).to(dtype)
        st = torch.randn((bh, n, p), generator=gen, device=dev) * 0.1
        return x, la, B, C, st

    def both(name, x, la, B, C, st, extra):
        """y and the final state, each with a planted fault: for y the
        initial state dropped where there is one, else the log decay of
        the 8th position from the end lowered by 1; for the state that
        decay fault (the initial state has decayed away by the end)."""
        got = ops.ssd(x, la, B, C, chunk=s_cfg.chunk, initial_state=st)
        want = P.ssd(x, la, B, C, chunk=s_cfg.chunk, initial_state=st)
        la_bad = la.clone()
        la_bad[:, -8] -= 1.0
        decay = ("log_a[:, -8] - 1",
                 P.ssd(x, la_bad, B, C, chunk=s_cfg.chunk, initial_state=st))
        y_fault = decay if st is None else (
            "initial state dropped", P.ssd(x, la, B, C, chunk=s_cfg.chunk))
        return max(check(f"{name} y", got[0], want[0], "ssd", extra,
                         fault=(y_fault[0], y_fault[1][0])),
                   check(f"{name} state", got[1], want[1], "ssd", extra,
                         fault=(decay[0], decay[1][1])))

    print("phase 3c: ssd, small float32 shape (6 rows, 2 B/C groups)")
    x, la, B, C, st = inputs(6, 200, 16, 8, 2, torch.float32)
    for init in (None, st):
        both(f"ssd f32 init={init is not None}", x, la, B, C, init,
             "(S=200, P=16, N=8)")
    print(f"phase 3c: ssd full width bf16 ({nh} heads, P={hd}, N={n}, one "
          f"B/C group)")
    errs = []
    for s in (1024, 768, 1000):
        x, la, B, C, st = inputs(nh, s, hd, n, 1, torch.bfloat16)
        for init in (None, st):
            errs.append(both(f"ssd S={s} init={init is not None}", x, la, B,
                             C, init, ""))
    # timing at monolithic prefill's shape (S = 1024, no initial state);
    # three input sets in turn (3 x 24 MB > the 50 MB L2)
    s = 1024
    sets = [inputs(nh, s, hd, n, 1, torch.bfloat16)[:4] for _ in range(3)]
    k = [0]

    def nxt():
        k[0] = (k[0] + 1) % len(sets)
        return sets[k[0]]

    ms = timed(lambda: ssd.launch(*nxt()), 20)
    plain_ms = timed(lambda: P.ssd(*nxt(), chunk=s_cfg.chunk), 5)
    work = ssd.cost(*sets[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g, cpp = ssd.pieces(nh, s, sms)
    print(f"  ssd bf16 at {nh} rows x S={s} on {sms} SMs: {g} pieces of "
          f"{cpp} chunks a row ({(g - 1) * nh} blocks in pass 1, {g * nh} "
          f"in pass 2); f32 state carried between the passes: "
          f"{ssd.carried_bytes(nh, s, sms) / 1e6:.2f} MB, beside "
          f"{work.bytes / 1e6:.2f} MB of operands and results")
    return dict(module=ssd, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=None, cost=work)


def hybrid_kernel_checks(torch, ops, cfg):
    """Phase 3e: the four kernels of the hybrid path at hymba-1.5b's full
    width (25 query heads over 5 KV heads, hd 64, bf16; ssd at 50 heads,
    P 64, N 16), each layer's window: 1024 (29 layers) and cfg.max_seq + 1
    (the 3 global layers).  Each kernel against its plain version within
    the phase 3 limits, with the window dropped as the planted fault (the
    limit must fail it by more than FAULT_MARGIN); the chunk/decode bit
    pin under window 1024 (C = 512 at prefix 1024, rows whose windows
    cross strips and splits); flash_decode with rows whose first splits
    lie wholly before the window; ssd with and without an initial state.
    Timed: kernel, plain, SDPA with the same boolean mask, and the bound
    counting only the visible keys.  Returns {row name: record}."""
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     flash_prefill_chunk, ssd)
    from repro_torch.models import hybrid
    P = ops.PLAIN
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(26)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    win = cfg.attn_window
    windows = sorted(set(hybrid.window_schedule(cfg)))
    assert windows == [win, cfg.max_seq + 1], windows
    # the chunked engine's arena: prompts 1536 / 1200 + 64 new tokens + the
    # smallest chunk's slack; 8 layers past the 50 MB L2
    slots, smax, nl = 4, 1536 + 64 + 32 + 1, 8
    print(f"phase 3e: {cfg.name} full width bf16 (H={h}, KVH={kvh}, G="
          f"{h // kvh}, D={d}, windows {windows}, slots={slots}, "
          f"max_seq={smax})")
    rec = {}
    layer = [0]

    def nxt():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    # -- flash_attention: monolithic prefill, S 1536 and 1200 ---------------
    errs = []
    for s in (1536, 1200):
        qb, kb, vb = rn(1, s, h, d), rn(1, s, kvh, d), rn(1, s, kvh, d)
        q4, k4, v4 = qb.transpose(1, 2), kb.transpose(1, 2), \
            vb.transpose(1, 2)
        for w in windows:
            errs.append(check(
                f"flash_attention S={s} window={w}",
                ops.attention(q4, k4, v4, window=w),
                P.attention(q4, k4, v4, window=w), "bfloat16",
                "(tiles cross heads)" if s % 64 else "",
                fault=None if w > s else (
                    "the window dropped", P.attention(q4, k4, v4)),
                margin=FAULT_MARGIN))
    s = 1536
    sets = [tuple(t.transpose(1, 2) for t in
                  (rn(1, s, h, d), rn(1, s, kvh, d), rn(1, s, kvh, d)))
            for _ in range(3)]
    k_ = [0]

    def nset():
        k_[0] = (k_[0] + 1) % len(sets)
        return sets[k_[0]]

    pos = torch.arange(s, device=dev)
    amask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                              > pos[:, None] - win)
    ms = timed(lambda: flash_attention.launch(*nset(), window=win), 20)
    plain_ms = timed(lambda: P.attention(*nset(), window=win), 5)
    lib_ms = timed(lambda: sdpa(*nset(), attn_mask=amask), 20)
    rec["flash_attention_hymba"] = dict(
        module=flash_attention, label="fa hymba w=1024", max_abs_err=max(
            errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        cost=flash_attention.cost(*sets[0], window=win))

    # -- flash_decode: the decode step ---------------------------------------
    arena_k = rn(nl, slots, smax, kvh, d)
    arena_v = rn(nl, slots, smax, kvh, d)
    q = rn(slots, h, d)
    lens = torch.tensor([1600, 1264, PARKED_POS + 1, 1], device=dev)
    before = (1600 - win) // flash_decode.SPLIT
    errs = []
    for w in windows:
        errs.append(check(
            f"flash_decode window={w}",
            ops.flash_decode(q, arena_k[0], arena_v[0], lengths=lens,
                             window=w),
            P.flash_decode(q, arena_k[0], arena_v[0], lengths=lens,
                           window=w), "bfloat16",
            f"(lengths 1600/1264/parked/1; row 0's first {before} splits "
            f"of {flash_decode.SPLIT} keys wholly before the window)"
            if w == win else "(lengths 1600/1264/parked/1)",
            fault=None if w > smax else (
                "the window dropped",
                P.flash_decode(q, arena_k[0], arena_v[0], lengths=lens)),
            margin=FAULT_MARGIN))
    torch.cuda.synchronize()
    left = int(flash_decode.counters(q.device, slots * kvh)[
        :slots * kvh].abs().sum())
    assert left == 0, left
    ms = timed(lambda: flash_decode.launch(q, arena_k[nxt()],
                                           arena_v[layer[0]], lens,
                                           window=win), 50)
    plain_ms = timed(lambda: P.flash_decode(
        q, arena_k[nxt()], arena_v[layer[0]], lengths=lens, window=win), 5)
    kpos = torch.arange(smax, device=dev)
    vis = (kpos[None] < lens[:, None]) & (kpos[None] >= lens[:, None] - win)
    mask = vis[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = timed(lambda: sdpa(qs, arena_k[nxt()].transpose(1, 2),
                                arena_v[layer[0]].transpose(1, 2),
                                attn_mask=mask), 20)
    live = int(vis.sum())
    rec["flash_decode_hymba"] = dict(
        module=flash_decode, label="fd hymba w=1024", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        cost=flash_decode.cost(q, arena_k[0], lens, window=win))
    print(f"  flash_decode window={win}: {live} visible keys of "
          f"{int(torch.clamp(lens, max=smax).sum())} live rows; arrival "
          f"counters 0 after the calls")

    # -- flash_prefill_chunk: C = 512 at prefix 1024, and the pin ------------
    c, p0 = 512, 1024
    qc = rn(1, c, h, d)
    pf = torch.tensor([p0], device=dev)
    own_k, own_v = arena_k[0, 2:3], arena_v[0, 2:3]
    table = torch.tensor([2], device=dev)
    errs = []
    for w in windows:
        errs.append(check(
            f"flash_prefill_chunk window={w}",
            ops.flash_prefill_chunk(qc, arena_k[0], arena_v[0], prefix=pf,
                                    window=w, slots=table),
            P.flash_prefill_chunk(qc, own_k, own_v, prefix=pf, window=w),
            "bfloat16", f"(C={c} at prefix {p0}, slot table)",
            fault=None if w > smax else (
                "the window dropped",
                P.flash_prefill_chunk(qc, own_k, own_v, prefix=pf)),
            margin=FAULT_MARGIN))
    pins = {}
    for w in windows:
        chunk_out = ops.flash_prefill_chunk(qc, arena_k[0], arena_v[0],
                                            prefix=pf, window=w,
                                            slots=table)
        dec_out = ops.flash_decode(
            qc[0], own_k.expand(c, smax, kvh, d),
            own_v.expand(c, smax, kvh, d),
            lengths=p0 + torch.arange(c, device=dev) + 1, window=w)
        pins[w] = bool(torch.equal(chunk_out[0], dec_out))
        print(f"  pin under window {w}: chunk row j == flash_decode at pos "
              f"{p0} + j, bit for bit (bf16, G={h // kvh}, hd {d}): "
              f"{pins[w]} (max diff "
              f"{(chunk_out[0].float() - dec_out.float()).abs().max().item()}"
              f")")
    assert all(pins.values()), f"chunk/decode bit pin broken: {pins}"
    ms = timed(lambda: flash_prefill_chunk.launch(
        qc, arena_k[nxt()], arena_v[layer[0]], pf, window=win,
        slots=table), 20)
    plain_ms = timed(lambda: P.flash_prefill_chunk(
        qc, arena_k[nxt(), 2:3], arena_v[layer[0], 2:3], prefix=pf,
        window=win), 5)
    qpos = p0 + torch.arange(c, device=dev)
    cmask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :]
                                                > qpos[:, None] - win)
    qt = qc.transpose(1, 2)
    lib_ms = timed(lambda: sdpa(qt, arena_k[nxt(), 2:3].transpose(1, 2),
                                arena_v[layer[0], 2:3].transpose(1, 2),
                                attn_mask=cmask), 20)
    rec["flash_prefill_chunk_hymba"] = dict(
        module=flash_prefill_chunk, label="fpc hymba w=1024",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        cost=flash_prefill_chunk.cost(qc, arena_k[0], pf, window=win),
        pin=all(pins.values()))
    del arena_k, arena_v

    # -- ssd: the SSD branch, N = 16 ----------------------------------------
    s_cfg = cfg.ssm
    nh, hd, n = s_cfg.n_heads(cfg.d_model), s_cfg.headdim, s_cfg.d_state
    g2 = torch.Generator(device=dev).manual_seed(27)

    def inputs(s):
        x = (torch.randn((s, nh, hd), generator=g2, device=dev)
             * 0.05).to(torch.bfloat16).transpose(0, 1)
        la = -torch.rand((s, nh), generator=g2, device=dev).T * 0.1
        B = torch.randn((1, s, n), generator=g2, device=dev).to(
            torch.bfloat16)
        C = torch.randn((1, s, n), generator=g2, device=dev).to(
            torch.bfloat16)
        st = torch.randn((nh, n, hd), generator=g2, device=dev) * 0.1
        return x, la, B, C, st

    errs = []
    for s in (1536, 1200):
        x, la, B, C, st = inputs(s)
        for init in (None, st):
            got = ops.ssd(x, la, B, C, chunk=s_cfg.chunk, initial_state=init)
            want = P.ssd(x, la, B, C, chunk=s_cfg.chunk, initial_state=init)
            la_bad = la.clone()
            la_bad[:, -8] -= 1.0
            decay = P.ssd(x, la_bad, B, C, chunk=s_cfg.chunk,
                          initial_state=init)
            y_fault = (("log_a[:, -8] - 1", decay[0]) if init is None else
                       ("initial state dropped",
                        P.ssd(x, la, B, C, chunk=s_cfg.chunk)[0]))
            label = f"ssd N={n} S={s} init={init is not None}"
            errs.append(max(
                check(f"{label} y", got[0], want[0], "ssd",
                      fault=y_fault),
                check(f"{label} state", got[1], want[1], "ssd",
                      fault=("log_a[:, -8] - 1", decay[1]))))
    s = 1536
    sets = [inputs(s)[:4] for _ in range(3)]

    def nssd():
        k_[0] = (k_[0] + 1) % len(sets)
        return sets[k_[0]]

    ms = timed(lambda: ssd.launch(*nssd()), 20)
    plain_ms = timed(lambda: P.ssd(*nssd(), chunk=s_cfg.chunk), 5)
    rec["ssd_hymba"] = dict(
        module=ssd, label=f"ssd hymba N={n}", max_abs_err=max(errs), ms=ms,
        plain_ms=plain_ms, library_ms=None, cost=ssd.cost(*sets[0]))
    return rec


def moe_kernel_checks(torch, ops, cfg, suffix, prompts, gen):
    """Phase 3f: the three attention kernels of the moe path at ``cfg``'s
    full width (qwen2-moe-a2.7b: MHA, 16 / 16 heads, G = 1; qwen3-moe-30b-
    a3b: 32 / 4 heads, G = 8, qk_norm outside the kernels), hd 128, bf16,
    at the shapes its serving run gives them (``prompts``, ``gen`` new
    tokens, 4 slots, chunks of 512 / 256): flash_attention at each prompt
    length, flash_decode over the chunked engine's arena with lengths
    (prompt + gen, the shorter one's, parked, 1), flash_prefill_chunk at
    C = 512 (prefix 0 and 512) and C = 256 (prefix 512) through the slot
    table.  Each against its plain version within the phase 3 limit, with
    a planted fault the limit must fail (the last row dropping key 0;
    lengths + 1 in the live rows; prefix + 1); the chunk/decode bit pin at
    the model's G; kernel / plain / SDPA times and the bound.  At G = 1
    also flash_decode over the same K/V with 8 query heads a KV head (G
    = 8): the tensor-core tile pads the G query rows of a KV head to the
    MMA's 64 either way, so the two times show what the 63 dead rows of
    G = 1 cost.  Returns {``<kernel>_<suffix>``: record}."""
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     flash_prefill_chunk)
    P = ops.PLAIN
    dev = "cuda"
    gen_ = torch.Generator(device=dev).manual_seed(27)

    def rn(*shape):
        return torch.randn(shape, generator=gen_, device=dev).to(
            torch.bfloat16)

    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kvh
    slots, smax, nl = 4, max(prompts) + gen + 32 + 1, 8
    print(f"phase 3f: {cfg.name} full width bf16 (H={h}, KVH={kvh}, G={g}, "
          f"D={d}, prompts {list(prompts)}, slots={slots}, max_seq={smax})")
    rec = {}
    layer = [0]

    def nxt():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]

    # -- flash_attention: monolithic prefill at each prompt length ----------
    errs = []
    for s in sorted(set(prompts), reverse=True):
        q4, k4, v4 = (t.transpose(1, 2) for t in
                      (rn(1, s, h, d), rn(1, s, kvh, d), rn(1, s, kvh, d)))
        errs.append(check(f"flash_attention S={s}",
                          ops.attention(q4, k4, v4), P.attention(q4, k4, v4),
                          "bfloat16", "",
                          fault=("the last row drops key 0",
                                 P.attention(q4, k4, v4, window=s - 1))))
    s = max(prompts)
    sets = [tuple(t.transpose(1, 2) for t in
                  (rn(1, s, h, d), rn(1, s, kvh, d), rn(1, s, kvh, d)))
            for _ in range(3)]
    k_ = [0]

    def nset():
        k_[0] = (k_[0] + 1) % len(sets)
        return sets[k_[0]]

    rec[f"flash_attention_{suffix}"] = dict(
        module=flash_attention, label=f"fa {suffix} S={s}",
        max_abs_err=max(errs),
        ms=timed(lambda: flash_attention.launch(*nset()), 20),
        plain_ms=timed(lambda: P.attention(*nset()), 5),
        library_ms=timed(lambda: sdpa(*nset(), is_causal=True), 20),
        cost=flash_attention.cost(*sets[0]))
    del sets

    # -- flash_decode: the decode step ---------------------------------------
    arena_k = rn(nl, slots, smax, kvh, d)
    arena_v = rn(nl, slots, smax, kvh, d)
    q = rn(slots, h, d)
    long_, short = max(prompts) + gen, min(prompts) + gen
    lens = torch.tensor([long_, short, PARKED_POS + 1, 1], device=dev)
    bad_lens = lens + torch.tensor([1, 1, 0, 0], device=dev)
    err = check("flash_decode", ops.flash_decode(q, arena_k[0], arena_v[0],
                                                 lengths=lens),
                P.flash_decode(q, arena_k[0], arena_v[0], lengths=lens),
                "bfloat16", f"(lengths {long_}/{short}/parked/1)",
                fault=("lengths + 1 in the two long rows",
                       P.flash_decode(q, arena_k[0], arena_v[0],
                                      lengths=bad_lens)))
    torch.cuda.synchronize()
    left = int(flash_decode.counters(q.device, slots * kvh)[
        :slots * kvh].abs().sum())
    assert left == 0, left
    ms = timed(lambda: flash_decode.launch(q, arena_k[nxt()],
                                           arena_v[layer[0]], lens), 50)
    plain_ms = timed(lambda: P.flash_decode(q, arena_k[nxt()],
                                            arena_v[layer[0]],
                                            lengths=lens), 5)
    kpos = torch.arange(smax, device=dev)
    mask = (kpos[None] < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = timed(lambda: sdpa(qs, arena_k[nxt()].transpose(1, 2),
                                arena_v[layer[0]].transpose(1, 2),
                                attn_mask=mask), 20)
    rec[f"flash_decode_{suffix}"] = dict(
        module=flash_decode, label=f"fd {suffix} G={g}", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        cost=flash_decode.cost(q, arena_k[0], lens))
    if g == 1:
        q8 = rn(slots, 8 * kvh, d)
        ms8 = timed(lambda: flash_decode.launch(q8, arena_k[nxt()],
                                                arena_v[layer[0]], lens), 50)
        print(f"  flash_decode G=1 padding: {ms:.4f} ms at G = 1 ({h} query "
              f"rows over {kvh} KV heads, 1 live row of each 64-row MMA "
              f"tile) vs {ms8:.4f} ms at G = 8 over the same K/V "
              f"({8 * h} query rows): the G = 1 call costs "
              f"{ms / ms8:.3f}x the G = 8 call that does 8x the work")
        rec[f"flash_decode_{suffix}"]["g8_ms"] = ms8

    # -- flash_prefill_chunk: C = 512 / 256 through the slot table -----------
    table = torch.tensor([2], device=dev)
    own_k, own_v = arena_k[0, 2:3], arena_v[0, 2:3]
    errs, pins = [], []
    for c, p0 in ((512, 0), (512, 512), (256, 512)):
        qc = rn(1, c, h, d)
        pf = torch.tensor([p0], device=dev)
        got = ops.flash_prefill_chunk(qc, arena_k[0], arena_v[0], prefix=pf,
                                      slots=table)
        errs.append(check(
            f"flash_prefill_chunk C={c} prefix={p0}", got,
            P.flash_prefill_chunk(qc, own_k, own_v, prefix=pf), "bfloat16",
            "(slot table)",
            fault=("prefix + 1", P.flash_prefill_chunk(qc, own_k, own_v,
                                                       prefix=pf + 1))))
        dec = ops.flash_decode(qc[0], own_k.expand(c, smax, kvh, d),
                               own_v.expand(c, smax, kvh, d),
                               lengths=p0 + torch.arange(c, device=dev) + 1)
        pins.append(bool(torch.equal(got[0], dec)))
        print(f"  pin: chunk row j == flash_decode at pos {p0} + j, bit for "
              f"bit (bf16, G={g}, C={c}): {pins[-1]} (max diff "
              f"{(got[0].float() - dec.float()).abs().max().item()})")
    assert all(pins), f"chunk/decode bit pin broken at G = {g}: {pins}"
    c, p0 = 512, 512
    qc = rn(1, c, h, d)
    pf = torch.tensor([p0], device=dev)
    ms = timed(lambda: flash_prefill_chunk.launch(
        qc, arena_k[nxt()], arena_v[layer[0]], pf, slots=table), 20)
    plain_ms = timed(lambda: P.flash_prefill_chunk(
        qc, arena_k[nxt(), 2:3], arena_v[layer[0], 2:3], prefix=pf), 5)
    cmask = kpos[None, :] <= (p0 + torch.arange(c, device=dev))[:, None]
    qt = qc.transpose(1, 2)
    lib_ms = timed(lambda: sdpa(qt, arena_k[nxt(), 2:3].transpose(1, 2),
                                arena_v[layer[0], 2:3].transpose(1, 2),
                                attn_mask=cmask), 20)
    rec[f"flash_prefill_chunk_{suffix}"] = dict(
        module=flash_prefill_chunk, label=f"fpc {suffix} C={c}",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        cost=flash_prefill_chunk.cost(qc, arena_k[0], pf), pin=all(pins))
    del arena_k, arena_v
    return rec


def bound(r):
    """Fill ``bound_ms`` / ``bound_by`` of a kernel record from its
    ``cost`` (the kernel module's ``cost()``: the work's bytes and
    operations, and the peak of its type) and print it."""
    work = r["cost"]
    r["bound_ms"] = work.bound_s * 1e3
    r["bound_by"] = work.bound_by
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    print(f"  {r.get('label', r['module'].NAME):<20} kernel "
          f"{r['ms']:.4f} ms | plain "
          f"{r['plain_ms']:.4f} ms | library {lib} | bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
          f"{work.bytes / 1e6:.2f} MB, {work.flops / 1e9:.3f} GFLOP)")


SERVE_ARGS = ["--no-reduced", "--requests", "4", "--prompt-len", "1024",
              "--slots", "4", "--depth", "2", "--device", "cuda"]
# hymba-1.5b's prompts, 1536 / 1200: past its 1024-key window, so the
# window bites in prefill as well as decode (and S = 1200 puts query tiles
# across heads in monolithic prefill)
HYMBA = "hymba-1.5b"
HYMBA_PROMPTS = ["--prompt-len", "1536", "--prompt-mix", "1536,1200"]
# the moe family: qwen2-moe-a2.7b at phase 4's prompts (1024 / 768, 64 new
# tokens), qwen3-moe-30b-a3b in a shorter wave (4 x 512, 32 new tokens)
QWEN2_MOE = "qwen2-moe-a2.7b"
QWEN3_MOE = "qwen3-moe-30b-a3b"
QWEN3_PROMPTS = ["--prompt-len", "512", "--prompt-mix", "512"]
# the vlm and encdec families: llava-next-34b at phase 4's prompts (1024 /
# 768 text tokens, each after its 576 patch rows), whisper-large-v3 at
# prompts of 224 / 160 tokens (about half of its 448-token text context)
# after its encoder's 1500 frames
LLAVA = "llava-next-34b"
WHISPER = "whisper-large-v3"
WHISPER_PROMPTS = ["--prompt-len", "224", "--prompt-mix", "224,160"]


def serve_args(arch):
    """Phase 4's serve flags for ``arch`` (hymba-1.5b, qwen3-moe-30b-a3b
    and whisper-large-v3: their prompts)."""
    return SERVE_ARGS + {HYMBA: HYMBA_PROMPTS, QWEN3_MOE: QWEN3_PROMPTS,
                         WHISPER: WHISPER_PROMPTS}.get(arch, [])


def decode_launches(cfg) -> int:
    """flash_decode launches of one decode step: one a layer, two for
    encdec (its self-attention and its cross-attention)."""
    return cfg.n_layers * (2 if cfg.family == "encdec" else 1)


def prefill_launches(cfg, name) -> int:
    """``name``'s launches in one monolithic prefill: one a layer, and for
    encdec's flash_attention one an encoder layer and two a decoder layer
    (its prompt, causal; its cross-attention, non-causal)."""
    if cfg.family == "encdec" and name == "flash_attention":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def path_kernels(cfg):
    """(monolithic prefill's kernels, a chunk's kernels, decode's kernels)
    of the family's path: dense attention, ssm ssd, hybrid both."""
    attn, ssm = cfg.family != "ssm", cfg.ssm is not None
    return ((("flash_attention",) if attn else ()) + (("ssd",) if ssm
                                                      else ()),
            (("flash_prefill_chunk",) if attn else ()) + (("ssd",) if ssm
                                                          else ()),
            ("flash_decode",) if attn else ())


def serving_runs(torch, ops, serve, arch, gen, built=None,
                 modes=("monolithic", "chunked")):
    """Phase 4: the prefill ``modes`` of ``arch`` at full width (``built``:
    a (bundle, params) pair to serve instead of building the arch's).
    Returns (bundle, params, args, {mode: (engine, out, seconds, launch
    counts)})."""
    base = ["--arch", arch, "--gen", str(gen)] + serve_args(arch)
    args = serve.parse_args(base)
    t0 = time.perf_counter()
    bundle, params = built or serve.build(args)
    torch.cuda.synchronize()
    cfg = bundle.cfg
    shape = []
    if cfg.family != "ssm":
        shape.append(f"H={cfg.n_heads}/KVH={cfg.n_kv_heads}, hd={cfg.hd}, "
                     f"d_ff={cfg.d_ff}")
    if cfg.family == "hybrid":
        win = bundle.model.windows
        glob = [i for i, w in enumerate(win) if w != cfg.attn_window]
        shape.append(f"window {cfg.attn_window} in "
                     f"{win.count(cfg.attn_window)} layers, global layers "
                     f"{glob}")
    if cfg.moe is not None:
        me = cfg.moe
        shape.append(f"{me.n_experts} experts top {me.top_k} (d_ff_expert "
                     f"{me.d_ff_expert}), {me.n_shared_experts} shared "
                     f"(d_ff {me.d_ff_shared}), capacity_factor "
                     f"{me.capacity_factor}; {cfg.n_active_params() / 1e9:.3f}"
                     f" B active")
    if cfg.family == "vlm":
        shape.append(f"{cfg.n_patch_tokens} patch rows before each prompt")
    if cfg.family == "encdec":
        shape.append(f"{cfg.n_enc_layers} encoder layers over "
                     f"{cfg.enc_seq} frames")
    if cfg.ssm is not None:
        shape.append(f"d_inner={cfg.ssm.d_inner(cfg.d_model)}, "
                     f"{cfg.ssm.n_heads(cfg.d_model)} SSM heads x "
                     f"{cfg.ssm.headdim}, d_state={cfg.ssm.d_state}, "
                     f"chunk={cfg.ssm.chunk}")
    shape = ", ".join(shape)
    print(f"phase 4: {cfg.name} full width: {cfg.n_params() / 1e9:.3f} B "
          f"params ({cfg.n_layers} layers, d={cfg.d_model}, {shape}, "
          f"V={cfg.vocab}, {cfg.param_dtype}); init "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for mode in modes:
        margs = serve.parse_args(base + ["--prefill-mode", mode])
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        eng, out, dt = serve.serve(bundle, params, margs)
        counts = ops.launch_counts()
        total = sum(o.size for o in out.values())
        ttft = sorted(eng.stats["ttft_s"].values())
        print(f"  {mode}: {total} tokens in {dt:.3f} s = "
              f"{total / dt:.1f} tok/s ({1e3 * dt / eng.stats['decode_steps']:.2f}"
              f" ms wall per decode step incl. prefill); decode_steps="
              f"{eng.stats['decode_steps']} prefills={eng.stats['prefills']}"
              f" chunks={eng.stats['prefill_chunks']}; TTFT s "
              f"{[round(x, 4) for x in ttft]}; max_seq={eng.max_seq}")
        print(f"  {mode} kernel launches: {counts}; arena "
              f"{eng.arena_bytes / 1e6:.1f} MB; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        g = eng.graph
        assert g is not None and g.replays == eng.stats["decode_steps"], \
            "the engine must replay its captured decode step"
        # greedy traffic never captures or runs the sampled graphs
        assert eng.sampled_graph is None and eng.stats["sampled_steps"] == 0
        assert eng.draw_graph is None
        check_chunk_graphs(eng)
        print_graphs(f"  {mode}", eng)
        for name in path_kernels(cfg)[2]:
            # every replayed launch counted, plus the warm-up step's own
            assert counts[name] == decode_launches(cfg) * (g.replays + 1), \
                (counts, g.replays)
        for o in out.values():
            assert o.shape == (margs.gen,), o.shape
            assert ((o >= 0) & (o < cfg.vocab)).all()
        runs[mode] = (eng, out, dt, counts)
    # one launch per layer per prefill and per chunk, each chunk replayed
    # from its length's graph, plus each chunk graph's parked warm-up (as
    # flash_decode counts its decode graph's warm-up step)
    nl = cfg.n_layers
    prefill_k, chunk_k, decode_k = path_kernels(cfg)
    if "chunked" in runs:
        c_eng, chunked = runs["chunked"][0], runs["chunked"][3]
        for name in chunk_k:
            assert chunked[name] == nl * (c_eng.stats["prefill_chunks"]
                                          + len(c_eng.chunk_graphs)) > 0, \
                (name, chunked)
    m_eng, mono = runs["monolithic"][0], runs["monolithic"][3]
    for name in prefill_k:
        assert mono[name] == prefill_launches(cfg, name) \
            * m_eng.stats["prefills"] > 0, (name, mono)
    for name in decode_k:
        assert all(run[3][name] > 0 for run in runs.values()), runs
    return bundle, params, args, runs


def check_chunk_graphs(eng):
    """A chunked engine on the card replays one captured graph per chunk
    length it used (``stats["prefill_shapes"]``), once a chunk; a
    monolithic one holds none."""
    graphs = eng.chunk_graphs
    if eng.prefill_chunks is None:
        assert not graphs, sorted(graphs)
        return
    assert sorted(graphs) == sorted(eng._chunk_inputs), sorted(graphs)
    assert len(graphs) == eng.stats["prefill_shapes"] > 0, \
        (sorted(graphs), eng.stats["prefill_shapes"])
    assert sum(g.replays for g in graphs.values()) == \
        eng.stats["prefill_chunks"], eng.stats["prefill_chunks"]


def print_graphs(label, eng):
    """Print (and check) the cost of the engine's graphs: the decode
    graphs (the sampled one and the first draw where traffic sampled),
    built before the tok/s clock starts, and the chunk graphs, one a chunk
    length, captured at its first chunk inside the run (sharing one pool:
    a later capture reserves only what the pool cannot serve)."""
    named = [("greedy decode", eng.graph),
             ("sampled decode", eng.sampled_graph),
             ("first draw", eng.draw_graph)]
    named += [(f"chunk {c}", g) for c, g in sorted(eng.chunk_graphs.items())]
    for name, g in named:
        if g is None:
            continue
        if not name.startswith("chunk"):
            assert g.pool_bytes > 0, (name, g.pool_bytes)
        print(f"{label} {name} graph: warm-up {g.warmup_s * 1e3:.1f} "
              f"ms, capture {g.capture_s * 1e3:.1f} ms, pool "
              f"{g.pool_bytes / 1e6:.1f} MB; {g.replays} replays of "
              f"{g.launches}")
    if eng.chunk_graphs:
        pool = sum(g.pool_bytes for g in eng.chunk_graphs.values())
        assert pool > 0, pool
        print(f"{label} chunk graphs: {len(eng.chunk_graphs)} sharing one "
              f"pool of {pool / 1e6:.1f} MB")


def profile_events(prof):
    """The profiler's own events of a run, as torch.profiler would count
    them (its hidden and bookkeeping events left out), read from Kineto's
    results: building ``key_averages()``'s Python events costs tens of
    microseconds an event, minutes over the smoke's profiles of eager
    steps."""
    from torch.autograd.profiler_util import _filter_name
    return [e for e in prof.profiler.kineto_results.events()
            if not (_filter_name(e.name())
                    or getattr(e, "is_hidden_event", lambda: False)())]


def device_time(prof):
    """(kernel rows [(device us, count, name)] sorted by time, cudaGraphLaunch
    calls) of a torch.profiler run.  Only the device's own events count
    (``device_type`` CUDA: kernels, copies, memsets): an aten op's row
    repeats the device time of the kernels it launched, so summing every
    row would count an eager op twice and a graph's kernels (launched by
    no op) once."""
    from torch.autograd import DeviceType
    us, count, graph_launches = {}, {}, 0
    for e in profile_events(prof):
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            us[name] = us.get(name, 0.0) + e.duration_ns() / 1e3
            count[name] = count.get(name, 0) + 1
        elif name == "cudaGraphLaunch":
            graph_launches += 1
    rows = [(t, count[name], name) for name, t in us.items() if t > 0]
    return sorted(rows, reverse=True), graph_launches


def profile_run(torch, ops, serve, bundle, params, mode, chunk_graph=True):
    """Phase 4b: one short run in prefill ``mode`` (4 requests, prompts
    1024/768, 16 new tokens), its decode step captured, its chunks
    (chunked mode) captured (``chunk_graph``) or eager, under
    torch.profiler: device time by kernel, the attention and ssd kernels'
    own line, and the device's busy share of the wall time (the kernels'
    summed device time; profiler overhead included in the wall).  The
    engine (and its decode graph) is built before the profile starts; its
    chunk graphs are captured inside, at each length's first chunk.
    Returns the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = serve.parse_args(["--arch", bundle.name, "--gen", "16",
                             "--prefill-mode", mode]
                            + serve_args(bundle.name))
    args.chunk_graph = chunk_graph
    eng = serve.engine(bundle, params, args)
    label = (f"{bundle.name} {mode} captured"
             + ("" if mode == "monolithic" or chunk_graph
                else ", eager chunks"))
    before = ops.launch_counts()
    torch.cuda.synchronize()
    # the profiler drops every device event it places outside its window,
    # and a host whose clocks drift apart places the run's first or last
    # kernels there: an idle margin on each side keeps them in
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    counted = {k: n - before[k] for k, n in ops.launch_counts().items()}
    rows, graph_launches = device_time(prof)
    busy = sum(r[0] for r in rows) / 1e3
    # a captured run's replayed launches are counted, not seen: with no
    # device events they cannot be held against the device
    assert rows, f"phase 4b: {label}: profiler saw no device time"
    own = {}
    for us, n, key in rows:
        for kname in PROFILED_KERNELS:
            if kname in key:
                t, c = own.get(kname, (0.0, 0))
                own[kname] = (t + us / 1e3, c + n)
    if own:
        print(f"phase 4b: {label}: the port's kernels' device "
              f"time: " + ", ".join(f"{k} {t:.3f} ms in {c} launches"
                                    for k, (t, c) in own.items()))
    # the counts each replay adds (``ops.add_launches``) against the
    # kernels the device ran in the same run
    graphs = [eng.graph, *eng.chunk_graphs.values()]
    replays = sum(g.replays for g in graphs)
    print(f"phase 4b: {label}: {graph_launches} cudaGraphLaunch calls for "
          f"{replays} replays ({len(graphs)} graphs)")
    assert graph_launches == replays, (graph_launches, replays)
    for name in sorted({k for g in graphs for k in g.launches}
                       & set(DEVICE_SYMBOL)):
        symbol = DEVICE_SYMBOL[name]
        seen = sum(n for _, n, key in rows if symbol.search(key))
        print(f"phase 4b: {label}: {name} kernels in the profile {seen} of "
              f"{counted[name]} counted"
              + ("; the profiler shows graph launches in place of their "
                 "kernels" if not seen else ""))
        if seen != counted[name]:
            t0_ns = prof.profiler.kineto_results.trace_start_ns()
            spans = [(e.start_ns() - t0_ns, e.end_ns() - t0_ns)
                     for e in profile_events(prof)
                     if e.device_type() == DeviceType.CUDA
                     and symbol.search(e.name())]
            print(f"phase 4b: {label}: {name} kernels seen from "
                  f"{min(s for s, _ in spans) / 1e6:.1f} to "
                  f"{max(e for _, e in spans) / 1e6:.1f} ms of the "
                  f"profile; the run took {dt * 1e3:.1f} ms after a "
                  f"{PROFILE_MARGIN_S * 1e3:.0f} ms margin" if spans
                  else f"phase 4b: {label}: no {name} kernel seen")
        assert seen == counted[name], (name, seen, counted[name])
    print(f"phase 4b: {label} profiled run, "
          f"{eng.stats['decode_steps']} decode steps + "
          f"{eng.stats['prefills']} prefills "
          f"({eng.stats['prefill_chunks']} chunks): wall "
          f"{dt * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (dt * 1e3):.1f}%); top device time:")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")
    return busy / (dt * 1e3)


def same_streams(got, want) -> bool:
    return sorted(got) == sorted(want) and all(
        (got[u] == want[u]).all() for u in want)


# the order of the i-th eager / captured pair: alternating, as host-bound
# time drifts within a call
PAIR_ORDER = (("eager", "captured"), ("captured", "eager"))


def eager_vs_captured(serve, bundle, params, runs, gen, pairs=3,
                      eager_chunks=False, modes=("monolithic", "chunked")):
    """Phase 4c: phase 4's requests served again with the eager decode step
    (``--no-decode-graph``; with ``eager_chunks`` the chunks eager too)
    and with the captured one, ``pairs`` pairs a prefill mode in
    alternating order; every run's token streams must equal phase 4's
    captured run's.  Prints tok/s and wall ms per decode step (prefill
    included) of each run; returns {mode: {kind: [(tok/s, ms per step),
    ...]}}."""
    base = (["--arch", bundle.name, "--gen", str(gen)]
            + serve_args(bundle.name))
    table = {}
    for mode in modes:
        want = runs[mode][1]
        res = {"eager": [], "captured": []}
        for i in range(pairs):
            for kind in PAIR_ORDER[i % 2]:
                args = serve.parse_args(
                    base + ["--prefill-mode", mode]
                    + (["--no-decode-graph"] if kind == "eager" else []))
                args.chunk_graph = not (eager_chunks and kind == "eager")
                eng, out, dt = serve.serve(bundle, params, args)
                assert (eng.graph is None) == (kind == "eager")
                assert bool(eng.chunk_graphs) == (
                    mode == "chunked" and args.chunk_graph)
                assert same_streams(out, want), (mode, kind, i)
                total = sum(o.size for o in out.values())
                res[kind].append((total / dt,
                                  1e3 * dt / eng.stats["decode_steps"]))
                del eng, out
        table[mode] = res
        print(f"phase 4c: {bundle.name} {mode}: token streams of "
              f"{2 * pairs} runs (eager"
              + (" decode and chunk steps" if eager_chunks else "")
              + " and captured, alternating) equal phase 4's captured "
                "run's")
        for kind in ("eager", "captured"):
            print(f"  {kind:8s} tok/s "
                  f"{[round(r[0], 1) for r in res[kind]]}, ms per decode "
                  f"step incl. prefill {[round(r[1], 2) for r in res[kind]]}")
    return table


def chunk_pairs(torch, serve, bundle, params, runs, gen, pairs=3):
    """Phase 4c (chunks): phase 4's chunked requests with eager chunk steps
    (``chunk_graph = False``) and with the captured ones, the decode step
    captured in both, ``pairs`` pairs in alternating order.  Each run
    serves them twice on one engine: the first wave as phase 4 does (a
    captured engine captures its chunk graphs inside it, at each length's
    first chunk), then the same prompts again as new requests (the
    graphs already captured).  Every wave's streams must equal phase 4's
    chunked run's.  Then the planted fault: a captured run whose host
    skips writing the chunk's device ``start`` (each replay reads a stale
    one) must give other streams.  Returns {kind: {wave: [(tok/s, {uid:
    TTFT s}, host_blocked_s), ...]}}."""
    import numpy as np
    from repro_torch.runtime.serving import Request
    base = (["--arch", bundle.name, "--gen", str(gen)]
            + serve_args(bundle.name)
            + ["--prefill-mode", "chunked"])
    want = runs["chunked"][1]
    kinds = ("eager chunks", "captured chunks")
    waves = ("first", "second")
    res = {kind: {wave: [] for wave in waves} for kind in kinds}
    for i in range(pairs):
        for kind in (kinds if i % 2 == 0 else kinds[::-1]):
            args = serve.parse_args(base)
            args.chunk_graph = kind == "captured chunks"
            eng, out, dt = serve.serve(bundle, params, args)
            assert bool(eng.chunk_graphs) == args.chunk_graph
            if args.chunk_graph:
                check_chunk_graphs(eng)
            assert same_streams(out, want), (kind, i)
            st = eng.stats
            total = sum(o.size for o in out.values())
            res[kind]["first"].append((total / dt, dict(st["ttft_s"]),
                                       st["host_blocked_s"]))
            rng = np.random.default_rng(0)
            prompts = [rng.integers(0, bundle.cfg.vocab, n)
                       for n in serve.prompt_lengths(args)]
            for uid, prompt in enumerate(prompts):
                eng.submit(Request(uid=100 + uid, prompt=prompt,
                                   max_new_tokens=gen))
            blocked = st["host_blocked_s"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert all((again[100 + u] == want[u]).all() for u in want), \
                (kind, i)
            if args.chunk_graph:
                check_chunk_graphs(eng)
            res[kind]["second"].append((
                total / dt, {u: st["ttft_s"][100 + u] for u in want},
                st["host_blocked_s"] - blocked))
            del eng, out, again
    print(f"phase 4c: {bundle.name} chunked: token streams of {2 * pairs} "
          f"runs (eager and captured chunk steps, alternating; decode "
          f"captured), two waves each, equal phase 4's chunked run's")
    for kind in kinds:
        for wave in waves:
            rows = res[kind][wave]
            ttft = {u: statistics.median(r[1][u] for r in rows)
                    for u in rows[0][1]}
            print(f"  {kind:15s} {wave} wave: tok/s "
                  f"{[round(r[0], 1) for r in rows]}; TTFT ms per request "
                  f"(median of {pairs}) "
                  f"{ {u: round(1e3 * t, 1) for u, t in sorted(ttft.items())} }"
                  f"; host_blocked_s {[round(r[2], 4) for r in rows]}")
    eng = serve.engine(bundle, params, serve.parse_args(base))
    stage, inputs = eng._stage, eng._chunk_inputs

    def skip_start(dst, values):
        if any(dst is scalars for _, scalars in inputs.values()):
            stage(dst[0:1], values[0:1])
            stage(dst[2:3], values[2:3])
        else:
            stage(dst, values)

    eng._stage = skip_start
    bad = eng.run()
    differ = [u for u in sorted(want) if not (bad[u] == want[u]).all()]
    print(f"phase 4c: {bundle.name} planted fault (the host skips each "
          f"chunk's start write, replays read a stale device start): "
          f"streams of requests {differ} differ from phase 4's")
    assert differ, "a stale chunk start went unseen"
    return res


def decode_window(torch, serve, bundle, params, kinds=None, pairs=3,
                  steps=32, same=True, phase="4c"):
    """Phase 4c (and 4d, 4e), decode only: one engine per kind (``kinds``:
    {name: extra serve flags, or (flags, {args attribute: value}) for what
    the CLI does not take}; default eager and captured) takes the 4
    requests (monolithic) until every prompt is in, then runs ``steps``
    engine steps at a time, synchronised at both ends, ``pairs`` windows
    each in alternating order; all then run to the end and, if ``same``,
    must give the same token streams.  Then ``steps // 4`` more steps of
    each under torch.profiler give the device's time and busy share a
    decode step.  Returns ({kind: [ms per decode step, ...]}, {kind:
    (device ms, wall ms) a step})."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serving import Status
    kinds = kinds or {"eager": ["--no-decode-graph"], "captured": []}
    names = list(kinds)
    gen = pairs * steps + steps // 4 + 16
    engines = {}
    for kind, extra in kinds.items():
        flags, attrs = (extra, {}) if isinstance(extra, list) else extra
        args = serve.parse_args(
            ["--arch", bundle.name, "--gen", str(gen)]
            + serve_args(bundle.name) + flags)
        for key, value in attrs.items():
            setattr(args, key, value)
        eng = engines[kind] = serve.engine(bundle, params, args)
        while eng.scheduler.waiting or any(
                st.status != Status.RUNNING
                for st in eng.scheduler.running.values()):
            eng.step()
    ms = {kind: [] for kind in names}
    for i in range(pairs):
        for kind in (names if i % 2 == 0 else names[::-1]):
            eng = engines[kind]
            n0 = eng.stats["decode_steps"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            ms[kind].append(1e3 * (time.perf_counter() - t0) / steps)
            assert eng.stats["decode_steps"] - n0 == steps
    busy = {}
    for kind, eng in engines.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps // 4):
                eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        rows, _ = device_time(prof)
        busy[kind] = (sum(r[0] for r in rows) / 1e3 / (steps // 4),
                      dt * 1e3 / (steps // 4))
        if kind != "eager":
            print(f"phase {phase}: {bundle.name} {kind} decode step, top "
                  f"device time a step:")
            for us, n, key in rows[:10]:
                print(f"    {us / 1e3 / (steps // 4):8.3f} ms "
                      f"{n // (steps // 4):5d}x  {key[:90]}")
    outs = {kind: eng.run() for kind, eng in engines.items()}
    if same:
        assert same_streams(outs[names[0]], outs[names[1]])
    print(f"phase {phase}: {bundle.name} decode only (4 slots live, {steps} "
          f"steps a window, synchronised at both ends): ms per decode step "
          + ", ".join(f"{k} {[round(x, 3) for x in ms[k]]}" for k in names)
          + (f"; token streams ({gen} new tokens a request) equal"
             if same else ""))
    # the profiler slows the host's side, so the busy share is taken
    # against the unprofiled windows' median wall time a step
    print(f"phase {phase}: {bundle.name} decode only, {steps // 4} steps "
          f"under torch.profiler: " + ", ".join(
              f"{k} device {d:.3f} ms a step ({w:.3f} ms wall profiled; "
              f"{100 * d / statistics.median(ms[k]):.1f}% of the unprofiled "
              f"median)" for k, (d, w) in busy.items()))
    return ms, busy


# Phase 4d: the served runs' sampling knobs, every filter on (llama3.2-3b's
# published generation_config.json samples at temperature 0.6, top-p 0.9),
# half the requests sampled so that greedy and sampled slots share steps
SAMPLE_ARGS = ["--temperature", "0.6", "--top-k", "50", "--top-p", "0.9",
               "--min-p", "0.05", "--sampling-mix", "0.5"]
# (temperature, top_k, top_p, min_p, seed, q) of the four slots of the
# sampler check, one of them greedy
SLOT_KNOBS = ((0.6, 50, 0.9, 0.05, 3, 1025), (1.0, 0, 1.0, 0.0, 11, 769),
              (0.0, 0, 1.0, 0.0, 5, 1030),
              (1.3, 0, 0.95, 0.02, 2**31 - 1, 2**20))


def sampler_inputs(torch, v, dev):
    """Phase 4d's sampler inputs at vocabulary ``v``: f32 logits of std 3
    from a CPU generator, then the slots' vectors, all on ``dev``."""
    gen = torch.Generator().manual_seed(v)
    logits = torch.randn(len(SLOT_KNOBS), v, generator=gen) * 3
    t, k, p, m, seed, q = zip(*SLOT_KNOBS)
    vecs = (torch.tensor(seed), torch.tensor(q), torch.tensor(t),
            torch.tensor(k), torch.tensor(p), torch.tensor(m))
    return [x.to(dev) for x in (logits,) + vecs]


def chi2_check(torch, L, sampling, n=20000, v=101):
    """Phase 4d: ``n`` draws from one row at V = ``v`` taken as rows on the
    card (positions 0..n-1), chi-square against the port's numpy oracle
    (``sampling.chi2_gof``: the reference's harness)."""
    import numpy as np
    sp = sampling.SamplingParams(temperature=0.8, top_k=12, top_p=0.9,
                                 min_p=0.05)
    logits = np.random.default_rng(v).standard_normal(v).astype(np.float32)
    x = torch.as_tensor(logits, device="cuda")[None].expand(n, -1)

    def full(val, dtype):
        return torch.full((n,), val, dtype=dtype, device="cuda")

    toks = L.sample_step(x, full(17, torch.int64),
                         torch.arange(n, device="cuda"),
                         full(sp.temperature, torch.float32),
                         full(sp.top_k, torch.int64),
                         full(sp.top_p, torch.float32),
                         full(sp.min_p, torch.float32)).cpu().numpy()
    stat, df, limit = sampling.chi2_gof(
        toks, sampling.reference_probs(logits, sp))
    print(f"phase 4d: chi-square of {n} draws on the card at V={v} "
          f"({sp}): {stat:.2f} on {df} df, limit {limit:.2f}")
    assert stat < limit, (stat, limit)


def sampler_checks(torch):
    """Phase 4d (a): ``sample_step`` on the card against the same function
    on the CPU, same f32 logits at 4 x 128256 (llama3.2-3b), 4 x 50280
    (mamba2-2.7b) and 4 x 32001 (hymba-1.5b: an odd vocabulary, so the
    windowed sums pad unevenly), other knobs and seed in each slot: keys,
    the V-word
    draws, the kept sets and values and the tokens bit for bit; with q + 1
    the sampled slots' tokens must move (the planted fault) and the greedy
    slot's not.  Then the sampler alone on the card, eager (wall ms a call,
    synchronised) and captured in a CUDA graph (device ms a replay), and
    the chi-square."""
    from repro_torch.core import prng
    from repro_torch.models import layers as L
    from repro_torch.runtime.serving import sampling
    res = {}
    sampled = torch.tensor([kn[0] > 0 for kn in SLOT_KNOBS])
    for v in (128256, 50280, 32001):
        out = {}
        for dev in ("cpu", "cuda"):
            logits, seed, q, t, k, p, m = sampler_inputs(torch, v, dev)
            keys = prng.fold_in(prng.fold_in(
                torch.zeros((4, 2), dtype=torch.int64, device=dev), seed), q)
            out[dev] = [x.cpu() for x in (
                keys, prng.random_bits32(keys, (v,)),
                L.masked_logits(logits, t, k, p, m),
                L.sample_step(logits, seed, q, t, k, p, m),
                L.sample_step(logits, seed, q + 1, t, k, p, m))]
        (ck, cb, cx, ct, cf), (gk, gb, gx, gt, gf) = out["cpu"], out["cuda"]
        assert torch.equal(ck, gk) and torch.equal(cb, gb), v
        assert torch.equal(cx.view(torch.int32), gx.view(torch.int32)), v
        assert torch.equal(ct, gt) and torch.equal(cf, gf), v
        moved = (gt != gf) & sampled
        assert moved.any() and not (gt != gf)[~sampled].any(), (gt, gf)
        kept = torch.isfinite(gx).sum(-1).tolist()
        print(f"phase 4d: sample_step at 4 x {v}: keys, words, kept sets "
              f"(sizes {kept}) and values, tokens {gt.tolist()} equal on "
              f"the card and the CPU bit for bit; q + 1 moves "
              f"{int(moved.sum())} of {int(sampled.sum())} sampled tokens "
              f"({gf.tolist()}), the greedy slot's not")
        args = sampler_inputs(torch, v, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            L.sample_step(*args)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / 3
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            L.sample_step(*args)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tok = L.sample_step(*args)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(tok.cpu(), gt)
        captured_ms = timed(graph.replay, 20)
        res[v] = (eager_ms, captured_ms)
        print(f"phase 4d: sample_step alone at 4 x {v}: eager {eager_ms:.3f} "
              f"ms wall a call, captured {captured_ms:.4f} ms device a "
              f"replay")
        del graph
    chi2_check(torch, L, sampling)
    return res


def sampled_runs(torch, ops, serve, bundle, params, runs, gen=64,
                 per_token=True, modes=("monolithic", "chunked")):
    """Phase 4d (b): phase 4's requests with half of them sampled
    (SAMPLE_ARGS), both prefill modes, the decode steps captured (the
    default) and eager: streams equal; the greedy requests equal phase 4's
    streams (a greedy row takes the argmax, bit for bit, and no row's logits
    depend on its batch-mates); a sampled request served alone (same slots
    and arena) equal to its stream in the batch; the sampled graph replayed
    once a sampled step.  ``per_token=False`` (a moe model under binding
    capacity, where a row's logits do depend on its batch-mates) holds
    captured = eager only.  Returns ({mode: (tok/s, sampled steps, decode
    steps, the captured run's streams)}, [launch counts of each captured
    run])."""
    from repro_torch.runtime.serving import ServingEngine
    base = ["--arch", bundle.name, "--gen", str(gen)] \
        + serve_args(bundle.name) \
        + SAMPLE_ARGS
    cfg = bundle.cfg
    res, all_counts = {}, []
    for mode in modes:
        args = serve.parse_args(base + ["--prefill-mode", mode])
        plan = serve.sampling_plan(
            args.requests, temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, min_p=args.min_p, seed=args.seed,
            mix=args.sampling_mix)
        ops.reset_launch_counts()
        eng, out, dt = serve.serve(bundle, params, args)
        counts = ops.launch_counts()
        all_counts.append(counts)
        st = eng.stats
        total = sum(o.size for o in out.values())
        assert st["sampled_requests"] == 2 and st["sampled_steps"] > 0, st
        assert eng.sampled_graph.replays == st["sampled_steps"]
        assert eng.graph.replays + eng.sampled_graph.replays == \
            st["decode_steps"]
        # one first draw a sampled admission, each a replay
        assert eng.draw_graph.replays == st["sampled_requests"], \
            eng.draw_graph.replays
        check_chunk_graphs(eng)
        for name in path_kernels(cfg)[2]:
            assert counts[name] == decode_launches(cfg) * (
                st["decode_steps"] + 2), counts
        if cfg.ssm is not None:
            assert counts["ssd"] == cfg.n_layers * (
                st["prefills"] + st["prefill_chunks"]
                + len(eng.chunk_graphs)) > 0, counts
        print(f"phase 4d: {bundle.name} {mode}, requests "
              f"{[i for i, sp in enumerate(plan) if not sp.is_greedy]} "
              f"sampled: {total} tokens in {dt:.3f} s = {total / dt:.1f} "
              f"tok/s; {st['sampled_steps']} of {st['decode_steps']} decode "
              f"steps sampled; kernel launches {counts}")
        print_graphs(f"  {mode}", eng)
        eargs = serve.parse_args(base + ["--prefill-mode", mode,
                                         "--no-decode-graph"])
        e_eng, e_out, e_dt = serve.serve(bundle, params, eargs)
        assert e_eng.sampled_graph is None and e_eng.draw_graph is None
        assert same_streams(out, e_out), mode
        sampled = [i for i, sp in enumerate(plan) if not sp.is_greedy]
        print(f"phase 4d: {bundle.name} {mode}: TTFT ms of the sampled "
              f"requests {sampled}, first draw captured "
              f"{[round(1e3 * st['ttft_s'][u], 1) for u in sampled]}, eager "
              f"{[round(1e3 * e_eng.stats['ttft_s'][u], 1) for u in sampled]}"
              f"; of the greedy ones captured "
              f"{[round(1e3 * st['ttft_s'][u], 1) for u in range(len(plan)) if u not in sampled]}")
        if mode == "monolithic":
            draw_times(torch, eng)
        want = runs[mode][1]
        greedy = [i for i, sp in enumerate(plan) if sp.is_greedy]
        if not per_token:
            same = [i for i in greedy if (out[i] == want[i]).all()]
            print(f"phase 4d: {bundle.name} {mode}: streams of the captured "
                  f"and the eager engine ({e_eng.stats['sampled_steps']} "
                  f"eager sampled steps, {total / e_dt:.1f} tok/s) equal; "
                  f"capacity binds, so a row's logits depend on its "
                  f"batch-mates: greedy requests {same} of {greedy} equal "
                  f"phase 4's (not held)")
            res[mode] = (total / dt, st["sampled_steps"],
                         st["decode_steps"], out)
            del eng, e_eng
            continue
        for uid in greedy:
            assert (out[uid] == want[uid]).all(), (mode, uid)
        lens = serve.prompt_lengths(args)
        reqs = serve.requests(args, cfg.vocab, cfg=cfg)
        uid = next(i for i, sp in enumerate(plan) if not sp.is_greedy)
        alone = ServingEngine(bundle.model, cfg, params,
                              config=serve.engine_config(
                                  args, lens, serve.prefix_extra(cfg)))
        alone.submit(reqs[uid])
        a_out = alone.run()
        assert (a_out[uid] == out[uid]).all(), (mode, uid)
        n_diff = sum(int((out[i] != want[i]).any()) for i in out
                     if i not in greedy)
        print(f"phase 4d: {bundle.name} {mode}: streams of the captured "
              f"and the eager engine ({e_eng.stats['sampled_steps']} eager "
              f"sampled steps, {total / e_dt:.1f} tok/s) equal; greedy "
              f"requests {greedy} equal phase 4's; sampled request {uid} "
              f"served alone equals its stream in the batch; {n_diff} of "
              f"{len(out) - len(greedy)} sampled streams differ from phase "
              f"4's greedy ones")
        res[mode] = (total / dt, st["sampled_steps"], st["decode_steps"],
                     out)
        del eng, e_eng, alone
    return res, all_counts


def draw_times(torch, eng, n=20):
    """Phase 4d: the first draw alone at the model's vocabulary, wall ms a
    draw (synchronised), the captured graph's replay against the same step
    run eagerly, in alternating windows of ``n``."""
    ms = {"captured": [], "eager": []}
    for i in range(4):
        for kind in (("captured", "eager") if i % 2 == 0
                     else ("eager", "captured")):
            step = (eng.draw_graph.replay if kind == "captured"
                    else eng._first_draw_step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            ms[kind].append(1e3 * (time.perf_counter() - t0) / n)
    print(f"phase 4d: first draw alone at V={eng.cfg.vocab}, wall ms a "
          f"draw: " + ", ".join(f"{k} {[round(x, 3) for x in v]}"
                                for k, v in ms.items()))


def narrow_logits(torch, ops, bundle, params, prompt, fmt):
    """Request 0's first-token logits through chunked prefill (512-token
    chunks, each attending the arena in format ``fmt``) of the kernel model
    and of the same model on the plain versions: max |diff|."""
    from repro_torch.models import registry
    plain = registry.build_model(bundle.cfg, device="cuda", kernels=ops.PLAIN)
    n = prompt.shape[1]
    logits = {}
    for name, model in (("kernel", bundle.model), ("plain", plain)):
        cache = model.init_cache(1, n + 1, kv_format=fmt)
        for start in range(0, n, 512):
            piece = prompt[:, start:start + 512]
            out = model.prefill_chunk(params, piece, cache, 0, start,
                                      piece.shape[1] - 1)
        logits[name] = out[0]
        del cache
    return (logits["kernel"] - logits["plain"]).abs().max().item()


def narrow_runs(torch, ops, serve, bundle, params, runs, gen=64):
    """Phase 4e: llama3.2-3b served with narrow KV arenas.  bf16 first: for
    this bf16 model it is the fp32 format's arena, so its streams must equal
    phase 4's.  Then int8 and fp8 (fp8 through ``EngineConfig``, as in the
    reference): phase 4's requests, monolithic and chunked, the decode step
    captured, and one eager monolithic run, whose streams the captured
    run's must equal; every flash_decode launch (and every chunk's
    flash_prefill_chunk launch) scaled, their counts from these runs alone
    (set to 0 just before each run, read just after); the page pool and its
    scale sidecar drained; the eager run serves the first 16 tokens of each
    request (a stream does not depend on when the others stop: phase 4d's
    request served alone); request 0's chunked first-token logits, kernel
    model vs plain model, within LOGIT_TOL.  Printed: kv_row_bytes and arena
    bytes beside fp32's, the greedy token match against phase 4's fp32
    streams (``tolerance``), and one decode-only window each of fp32, int8
    and fp8 (device ms a step; reported, not gated).  Returns ([launch
    counts of each captured run], {format: {mode: the captured run's
    streams}})."""
    import numpy as np
    from repro_torch.runtime.serving import tolerance
    base = (["--arch", bundle.name, "--gen", str(gen)]
            + serve_args(bundle.name))
    cfg = bundle.cfg
    nl = cfg.n_layers
    all_counts = []

    def run(mode, fmt, eager=False, chunk_graph=True):
        args = serve.parse_args(base + ["--prefill-mode", mode]
                                + (["--no-decode-graph", "--gen", "16"]
                                   if eager else [])
                                + ([] if chunk_graph else ["--gen", "16"]))
        args.kv_format = fmt
        args.chunk_graph = chunk_graph
        ops.reset_launch_counts()
        eng, out, dt = serve.serve(bundle, params, args)
        return eng, out, dt, ops.launch_counts()

    eng, out, _, counts = run("monolithic", "bf16")
    assert same_streams(out, runs["monolithic"][1])
    assert counts["flash_decode_scaled"] == 0 and \
        eng.arena_bytes == runs["monolithic"][0].arena_bytes
    print("phase 4e: llama3.2-3b bf16 arena (the fp32 format's for this "
          "bf16 model): streams equal phase 4's, no scaled launch")
    streams = {}
    for fmt in ("int8", "fp8"):
        outs = streams[fmt] = {}
        for mode in ("monolithic", "chunked"):
            eng, out, dt, counts = run(mode, fmt)
            all_counts.append(counts)
            outs[mode] = out
            ref = runs[mode][0]
            steps = eng.stats["decode_steps"]
            assert eng.graph.replays == steps > 0
            assert counts["flash_decode_scaled"] == counts["flash_decode"] \
                == nl * (steps + 1), counts
            assert counts["flash_prefill_chunk_scaled"] == \
                counts["flash_prefill_chunk"], counts
            check_chunk_graphs(eng)
            if mode == "chunked":
                assert counts["flash_prefill_chunk_scaled"] == nl * (
                    eng.stats["prefill_chunks"] + len(eng.chunk_graphs)) \
                    > 0, counts
            assert eng.cache_mgr.free_pages == eng.cache_mgr.num_pages
            assert eng.cache_mgr.scale_sidecar_pages == 0
            report = tolerance.compare_streams(runs[mode][1], out)
            total = sum(o.size for o in out.values())
            print(f"phase 4e: {fmt} {mode}: {total} tokens in {dt:.3f} s = "
                  f"{total / dt:.1f} tok/s; kv_row_bytes "
                  f"{eng.kv_row_bytes} vs fp32's {ref.kv_row_bytes} "
                  f"({eng.kv_row_bytes / ref.kv_row_bytes:.3f}x), arena "
                  f"{eng.arena_bytes / 1e6:.1f} MB vs "
                  f"{ref.arena_bytes / 1e6:.1f} MB; token match vs fp32: "
                  f"{report.describe()}; launches {counts}")
            print_graphs(f"  {mode}", eng)
            del eng
        e_eng, e_out, e_dt, _ = run("monolithic", fmt, eager=True)
        assert e_eng.graph is None
        head = {u: o[:16] for u, o in outs["monolithic"].items()}
        assert same_streams(head, e_out), fmt
        e_tok = sum(o.size for o in e_out.values()) / e_dt
        c_eng, c_out, _, _ = run("chunked", fmt, chunk_graph=False)
        assert not c_eng.chunk_graphs
        head = {u: o[:16] for u, o in outs["chunked"].items()}
        assert same_streams(head, c_out), fmt
        print(f"phase 4e: {fmt}: the captured monolithic streams' first 16 "
              f"tokens equal the eager engine's ({e_tok:.1f} tok/s eager); "
              f"the captured chunked streams' first 16 equal those of eager "
              f"chunk steps")
        del e_eng, c_eng
        rng = np.random.default_rng(0)
        lens = serve.prompt_lengths(serve.parse_args(base))
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, lens[0]),
                                 device="cuda")[None]
        diff = narrow_logits(torch, ops, bundle, params, prompt, fmt)
        print(f"phase 4e: {fmt}: request 0's chunked first-token logits, "
              f"kernel vs plain model over the {fmt} arena: max |diff| = "
              f"{diff:.4e} (tol {LOGIT_TOL})")
        assert diff <= LOGIT_TOL, (fmt, diff)
    window, wbusy = decode_window(
        torch, serve, bundle, params, pairs=1, same=False, phase="4e",
        kinds={"fp32": [], "int8": ["--kv-format", "int8"],
               "fp8": ([], {"kv_format": "fp8"})})
    print(f"phase 4e: {bundle.name} decode only, one window each: "
          + ", ".join(f"{k} {window[k][0]:.3f} ms wall, device "
                      f"{wbusy[k][0]:.3f} ms a step" for k in window))
    return all_counts, streams


# Phase 4f: the reference's shared-prefix mix (serve.py:324-334): 4
# requests of 1024 tokens whose first 512 are common, chunks of 512 / 256
# (one 512 chunk a half), pages of 16
SHARED_ARGS = ["--requests", "4", "--prompt-len", "1024", "--prompt-mix",
               "shared-prefix", "--slots", "4", "--depth", "2",
               "--prefill-mode", "chunked", "--chunk-buckets", "256,512",
               "--page-size", "16", "--no-reduced", "--device", "cuda"]
# hymba-1.5b's shared-prefix mix: 4 x 1536 tokens, the first 1024 common,
# so a fork's decode window (1024 keys) straddles its shared length
HYMBA_SHARED = ["--prompt-len", "1536", "--shared-prefix", "1024"]


def chunk_timer(torch, eng):
    """Bracket each of ``eng``'s chunk steps with CUDA events on the
    current stream (the captured chunk graphs replay there, in order with
    the decode steps); returns the list the event pairs go into."""
    runner = eng._chunk_runner
    marks = []

    def timed_runner(size):
        tokens, scalars, step = runner(size)

        def bracketed():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step()
            e1.record()
            marks.append((e0, e1))
            return out
        return tokens, scalars, bracketed

    eng._chunk_runner = timed_runner
    return marks


def early_snapshots(torch, model):
    """The planted fault of phase 4f: ``model``'s snapshots taken one chunk
    early (each the slot's state before the chunk that ends at its page,
    zeros for the first).  Returns the function to put back."""
    extract = model.extract_slot_state
    held = {}

    def early(cache, slot):
        now = extract(cache, slot)
        before = held.get(slot, [torch.zeros_like(t) for t in now])
        held[slot] = now
        return before

    model.extract_slot_state = early
    return lambda: delattr(model, "extract_slot_state")


def shared_prefix_runs(torch, ops, serve, bundle, params, gen=64, pairs=2):
    """Phase 4f: the shared-prefix mix served at full width with prefix
    sharing on and off (alternating pairs, ``pairs`` of them), decode and
    chunks captured: llama3.2-3b over its fp32-format arena and int8,
    mamba2-2.7b, hymba-1.5b (its own mix, :data:`HYMBA_SHARED`: its forks
    read the donor's K/V rows through the table and resume the SSD state
    from snapshots).  Each run serves the requests twice on one engine: a
    first
    wave (which captures the chunk graph inside it, as phase 4c's) and a
    second of the same prompts as new requests (the graphs exist; with no
    chain cap the first wave's chains went with their holders, so it forks
    afresh).  Held: the greedy streams of every wave equal (sharing only
    moves where a fork's prefix rows come from); with sharing, each wave
    forks 3 requests of 512 shared tokens and ingests 1536 fewer prefill
    rows than without; every flash_decode and flash_prefill_chunk launch
    with a donor table (their counts set to 0 just before the run, read
    just after); every page back in the pool and no region pinned at the
    end; for mamba2, a snapshot taken one chunk early (the planted fault)
    must change a fork's stream.  Printed: the forks' TTFT, tok/s and the
    chunk steps' device time per wave, the snapshot bytes and copy time
    (mamba2), the graph pools with sharing on and off.  Returns [launch
    counts of each sharing run]."""
    from repro_torch.core import roofline
    from repro_torch.runtime.serving import Request
    t_phase = time.perf_counter()
    cfg = bundle.cfg
    dense = cfg.family == "dense"
    attn = path_kernels(cfg)[2]
    base = (["--arch", bundle.name, "--gen", str(gen)] + SHARED_ARGS
            + (HYMBA_SHARED if bundle.name == HYMBA else []))
    shared = serve.shared_prefix_len(serve.parse_args(base))
    n_req = serve.parse_args(base).requests
    forks = n_req - 1
    waves = ("first", "second")
    all_counts = []
    summary = []
    for fmt in (("fp32", "int8") if dense else ("fp32",)):
        want = None
        res = {kind: {w: [] for w in waves} for kind in ("off", "on")}
        engines = {}
        for i in range(pairs):
            for kind in (("off", "on") if i % 2 == 0 else ("on", "off")):
                args = serve.parse_args(
                    base + ["--kv-format", fmt]
                    + (["--prefix-sharing"] if kind == "on" else []))
                eng = serve.engine(bundle, params, args)
                marks = chunk_timer(torch, eng)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                before = {k: 0 for k in ("forks", "shared_prompt_tokens",
                                         "prefill_rows")}
                for w, wave in enumerate(waves):
                    if w:
                        for uid, prompt in enumerate(
                                serve.prompts(args, cfg.vocab)):
                            eng.submit(Request(uid=100 + uid, prompt=prompt,
                                               max_new_tokens=gen))
                    n_marks = len(marks)
                    t0 = time.perf_counter()
                    out = eng.run()
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    out = {u % 100: o for u, o in out.items()
                           if u // 100 == w}
                    st = eng.stats
                    if want is None:
                        want = out
                    if not same_streams(out, want):
                        differ = [u for u in sorted(want)
                                  if not (out[u] == want[u]).all()]
                        print(f"phase 4f: {bundle.name} {fmt} sharing "
                              f"{kind} {wave} wave: streams of requests "
                              f"{differ} differ from the first run's")
                        raise AssertionError("shared-prefix streams differ")
                    now = {k: st[k] for k in before}
                    got = {k: now[k] - before[k] for k in before}
                    before = now
                    assert got["forks"] == (forks if kind == "on" else 0), \
                        got
                    assert got["shared_prompt_tokens"] == (
                        forks * shared if kind == "on" else 0), got
                    total = sum(o.size for o in out.values())
                    res[kind][wave].append(dict(
                        tok_s=total / dt,
                        ttft=[st["ttft_s"][100 * w + u]
                              for u in range(n_req)],
                        rows=got["prefill_rows"],
                        chunk_ms=sum(a.elapsed_time(b)
                                     for a, b in marks[n_marks:]),
                        chunks=len(marks) - n_marks))
                counts = ops.launch_counts()
                m = eng.cache_mgr
                assert m.free_pages == m.num_pages, m.free_pages
                assert not any(m.region_pinned(s)
                               for s in range(eng.max_slots))
                check_chunk_graphs(eng)
                if attn:
                    for name in ("flash_decode", "flash_prefill_chunk"):
                        assert counts[name] > 0, counts
                        assert counts[name + "_donor"] == (
                            counts[name] if kind == "on" else 0), counts
                if kind == "on":
                    all_counts.append(counts)
                if i == 0:
                    engines[kind] = eng
                else:
                    del eng
        label = f"{bundle.name} {fmt}"
        for wave in waves:
            rows = {kind: {r["rows"] for r in res[kind][wave]}
                    for kind in res}
            assert len(rows["off"]) == len(rows["on"]) == 1, rows
            saved = rows["off"].pop() - rows["on"].pop()
            assert saved == forks * shared, (wave, saved)
        print(f"phase 4f: {label}: streams of {2 * pairs} runs x 2 waves "
              f"(sharing off / on, alternating) equal; each wave with "
              f"sharing forks {forks} requests of {shared} shared tokens "
              f"and ingests {forks * shared} fewer prefill rows; every page "
              f"back in the pool, no region pinned")
        for kind in ("off", "on"):
            for wave in waves:
                rs = res[kind][wave]
                print(f"  sharing {kind:3s} {wave:6s} wave: tok/s "
                      f"{[round(r['tok_s'], 1) for r in rs]}; TTFT ms "
                      f"(donor, forks) "
                      f"{[[round(1e3 * t, 1) for t in r['ttft']] for r in rs]}"
                      f"; chunk steps' device ms "
                      f"{[round(r['chunk_ms'], 3) for r in rs]} over "
                      f"{rs[0]['chunks']} chunks")
        for kind, eng in engines.items():
            print_graphs(f"  sharing {kind}", eng)
        if bundle.model.has_recurrent_state:
            eng = engines["on"]
            nbytes = eng.stats["snapshot_bytes"]
            snap_ms = timed(lambda: eng.model.extract_slot_state(
                eng._cache, 0), 5)
            print(f"phase 4f: {label}: {eng.stats['snapshots']} state "
                  f"snapshots in 2 waves, each {nbytes} bytes "
                  f"({nbytes / 1e6:.1f} MB: SSD state + conv tail, "
                  f"{cfg.n_layers} layers); one copy {snap_ms:.4f} ms on the "
                  f"card (bound {2 * nbytes / roofline.HBM_BW * 1e3:.4f} ms:"
                  f" read and write once)")
            summary.append(f"snapshot {nbytes / 1e6:.1f} MB, "
                           f"{snap_ms:.4f} ms a copy")
            args = serve.parse_args(base + ["--prefix-sharing"])
            eng = serve.engine(bundle, params, args)
            restore = early_snapshots(torch, eng.model)
            try:
                bad = eng.run()
            finally:
                restore()
            differ = [u for u in sorted(want)
                      if not (bad[u] == want[u]).all()]
            print(f"phase 4f: {label} planted fault (each snapshot taken "
                  f"one chunk early): streams of requests {differ} differ")
            assert differ and 0 not in differ, differ
            assert eng.stats["forks"] == forks
            del eng, bad
        pools = {kind: sum(g.pool_bytes for g in
                           [e.graph, *e.chunk_graphs.values()])
                 for kind, e in engines.items()}

        def med(kind, wave, key, pick=lambda r, k: r[k]):
            return statistics.median(pick(r, key)
                                     for r in res[kind][wave])
        fork_ttft = {(kind, wave): 1e3 * statistics.median(
            t for r in res[kind][wave] for t in r["ttft"][1:])
            for kind in res for wave in waves}
        summary.append(f"{fmt}: " + "; ".join(
            f"{wave} wave tok/s off {med('off', wave, 'tok_s'):.1f} / on "
            f"{med('on', wave, 'tok_s'):.1f}, forks' TTFT ms off "
            f"{fork_ttft[('off', wave)]:.1f} / on "
            f"{fork_ttft[('on', wave)]:.1f}, chunk steps' device ms off "
            f"{med('off', wave, 'chunk_ms'):.3f} / on "
            f"{med('on', wave, 'chunk_ms'):.3f}" for wave in waves)
            + f"; graph pools MB off {pools['off'] / 1e6:.1f} / on "
            f"{pools['on'] / 1e6:.1f}")
        del engines
    print(f"phase 4f: {bundle.name} summary, medians of {pairs}: "
          + "; ".join(summary)
          + f"; phase time {time.perf_counter() - t_phase:.1f} s")
    return all_counts


# Phase 4g: speculative decoding on llama3.2-3b at full width, chunked
# (phase 4's requests and chunks of 512 / 256), 64 new tokens, 4 slots.
# Temperature 8.0: the reference's traffic under preemption
# (tests/test_speculative.py), where the shared Gumbel noise lets an
# uncorrelated draft land proposals
HOT_ARGS = ["--temperature", "8.0", "--sampling-mix", "1.0"]


def match_prefix(got, want) -> dict:
    """{uid: how many leading tokens of ``got`` equal ``want``'s}."""
    import numpy as np
    out = {}
    for u in sorted(want):
        g, w = got[u], want[u]
        neq = np.nonzero(g[:len(w)] != w[:len(g)])[0]
        out[u] = int(neq[0]) if neq.size else min(len(g), len(w))
    return out


def spec_launches(eng, counts):
    """Hold a speculative run's attention launches to its replays: the
    verify graphs launch flash_prefill_chunk n_layers x (replays + one
    warm-up each), the draft's micro-step graphs flash_decode
    draft-layers x (replays + warm-ups), the chunk graphs of both models
    flash_prefill_chunk per chunk (and warm-up); nothing else launches
    them, and the replays equal the round's counted steps; the wrapper's
    own count of verify launches (``flash_prefill_chunk_verify``) equals
    the verify graphs' share."""
    st, nl = eng.stats, eng.cfg.n_layers
    nd = eng.spec.draft_cfg.n_layers
    verify = list(eng.verify_graphs.values())
    drafts = [g for g in (eng.draft_graph, eng.sampled_draft_graph)
              if g is not None]
    assert eng.graph is None and eng.sampled_graph is None
    assert len(verify) == st["spec_verify_compiles"] > 0
    assert sum(g.replays for g in verify) == st["spec_verify_calls"] > 0
    assert sum(g.replays for g in drafts) == st["spec_draft_steps"] > 0
    assert all(g.launches.get("flash_prefill_chunk") == nl
               and g.launches.get("flash_prefill_chunk_verify") == nl
               for g in verify)
    assert all(g.launches == {"flash_decode": nd} for g in drafts)
    check_chunk_graphs(eng)
    assert sorted(eng.draft_chunk_graphs) == sorted(eng.chunk_graphs)
    chunks = st["prefill_chunks"]
    v_launches = nl * sum(g.replays + 1 for g in verify)
    assert counts["flash_prefill_chunk"] == v_launches + nl * (
        chunks + len(eng.chunk_graphs)) + nd * (
        chunks + len(eng.draft_chunk_graphs)), counts
    assert counts["flash_decode"] == nd * sum(g.replays + 1
                                              for g in drafts), counts
    assert counts["flash_prefill_chunk_verify"] == v_launches, counts
    assert counts["flash_attention"] == 0, counts


def spec_report(label, eng, dt, plain_dt=None):
    """Print a speculative engine's acceptance, rounds, tokens committed a
    round, final k, verify graphs, host time blocked a round and wall ms a
    token over its ``dt`` seconds of runs (beside plain decode's, where
    given)."""
    st, sp = eng.stats, eng.spec
    outs = [s.output() for s in eng._results.values()]
    total = sum(o.size for o in outs)
    committed = total - len(outs)       # less each request's first token
    rounds = st["spec_rounds"]
    print(f"phase 4g: {label}: acceptance {sp.acceptance_rate:.4f} "
          f"({sp.stats['accepted']}/{sp.stats['proposed']}), {rounds} "
          f"rounds, {committed / rounds:.2f} tokens committed a round (all "
          f"slots), k {sp.k} at the end ({sp.stats['k_changes']} changes), "
          f"spec_verify_compiles {st['spec_verify_compiles']}, "
          f"host_blocked_s a round {st['host_blocked_s'] / rounds:.5f}; "
          f"{total} tokens in {dt:.3f} s, wall {1e3 * dt / total:.3f} ms a "
          f"token" + (f" (plain decode {1e3 * plain_dt / total:.3f})"
                      if plain_dt is not None else ""))


def spec_graphs(label, eng):
    """Print each speculative graph's warm-up / capture ms, pool bytes
    and replays."""
    from repro_torch.launch import serve
    for name, g in serve.named_graphs(eng):
        if g is None or not ("draft" in name or "verify" in name):
            continue
        print(f"  {label} {name} graph: warm-up {g.warmup_s * 1e3:.1f} ms, "
              f"capture {g.capture_s * 1e3:.1f} ms, pool "
              f"{g.pool_bytes / 1e6:.1f} MB; {g.replays} replays of "
              f"{g.launches}")


def round_device_ms(torch, eng, k, n=4):
    """Device ms of one round's parts over 4 live slots at prefix
    VERIFY_PREFIX (after the run, on the engine's own graphs): k greedy
    draft micro-steps, and the greedy verify of rung k for each slot.
    torch.profiler, device events only.  Returns (draft ms, verify ms)."""
    from torch.profiler import ProfilerActivity, profile
    b = eng.max_slots
    pos = [VERIFY_PREFIX] * b

    def device_ms(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows, _ = device_time(prof)
        assert rows, "phase 4g: the profiler saw no device time"
        return sum(r[0] for r in rows) / 1e3 / n

    def draft():
        eng._stage(eng._dtok, [1] * b)
        eng._stage(eng._dpos, pos)
        for _ in range(k):
            eng.draft_graph.replay()

    assert (k, False) in eng.verify_graphs
    _, verify = eng._verify_runner(k, False)

    def verify_all():
        for slot in range(b):
            eng._stage(eng._vscalars, [slot, VERIFY_PREFIX])
            verify()

    return device_ms(draft), device_ms(verify_all)


def speculative_runs(torch, ops, serve, bundle, params, runs, sampled_out,
                     int8_out, gen=64, pairs=4):
    """Phase 4g: speculative decoding on phase 4's chunked requests.

    (a) Self-draft: the draft is the target's own config from the target's
    parameter seed (a weight leaf must equal the target's), k = 4 =
    max_slots fixed.  Greedy and phase 4d's sampled mix: streams equal
    phase 4's and 4d's captured chunked streams bit for bit with
    acceptance exactly 1.0; over an int8 target arena, phase 4e's int8
    streams; a planted fault (every verify's device start one row late)
    must change the streams.  (b) A cheap draft: the target cut to 2
    layers (every width and the vocab kept, another seed), the
    reference's adaptive defaults (k 4, k_max 8): greedy (acceptance near
    0, k walks down) and temperature 8.0, token-match prefix against plain
    decode; then one live request at temperature 8.0 on the 4-slot
    engine against plain captured decode of it, ``pairs`` alternating
    pairs (each engine's first wave, which captures its graphs, and its
    second, which finds them).  Every run holds its launches to its
    replays (:func:`spec_launches`).  Returns [launch counts of each
    run]."""
    from repro_torch.runtime.serving import SpecConfig
    cfg = bundle.cfg
    base = (["--arch", bundle.name, "--gen", str(gen)]
            + serve_args(bundle.name)
            + ["--prefill-mode", "chunked"])
    all_counts = []

    def timed_run(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run(extra, spec, fmt="fp32", stage=None, again=False):
        """One engine's run of phase 4's requests (``extra`` flags,
        ``spec``); ``again``: then the same prompts once more as new
        requests (uid + 100), the graphs all captured, whose streams must
        equal the first wave's.  Returns (engine, streams, seconds[,
        second wave's seconds])."""
        args = serve.parse_args(base + extra)
        args.kv_format = fmt
        ops.reset_launch_counts()
        eng = serve.engine(bundle, params, args, speculative=spec)
        if stage is not None:
            eng._stage = stage(eng)
        out, dt = timed_run(eng)
        if again:
            for st in list(eng._results.values()):
                r = st.request
                eng.submit(dataclasses.replace(r, uid=100 + r.uid))
            out2, dt2 = timed_run(eng)
            assert all((out2[100 + u] == out[u]).all() for u in out)
        counts = ops.launch_counts()
        if spec is not None:
            spec_launches(eng, counts)
        all_counts.append(counts)
        return (eng, out, dt, dt2) if again else (eng, out, dt)

    t_start = time.perf_counter()
    want = runs["chunked"][1]
    # plain decode's two waves (the second finds its graphs captured)
    _, _, plain_dt, plain_dt2 = run([], None, again=True)
    own = SpecConfig(draft=cfg, k=4, adaptive=False, draft_seed=0)
    eng, out, dt, dt2 = run([], own, again=True)
    leaf = eng._draft_params["layers"]["attn"]["wq"]
    assert torch.equal(leaf, params["layers"]["attn"]["wq"]), \
        "the self-draft's weights differ from the target's"
    assert same_streams(out, want), "self-draft streams != phase 4's"
    assert eng.spec.acceptance_rate == 1.0, eng.spec.stats
    spec_report("self-draft greedy (k=4=max_slots), two waves", eng,
                dt + dt2, plain_dt + plain_dt2)
    total = sum(o.size for o in out.values())
    print(f"phase 4g: second wave (every graph captured): self-draft "
          f"{1e3 * dt2 / total:.3f} ms a token, plain decode "
          f"{1e3 * plain_dt2 / total:.3f}; first wave {1e3 * dt / total:.3f}"
          f" / {1e3 * plain_dt / total:.3f}")
    spec_graphs("self-draft greedy", eng)
    d_ms, v_ms = round_device_ms(torch, eng, 4)
    print(f"phase 4g: self-draft device ms a round at 4 live slots, prefix "
          f"{VERIFY_PREFIX} (torch.profiler, device events): 4 draft steps "
          f"{d_ms:.3f} + 4 verify passes {v_ms:.3f} = {d_ms + v_ms:.3f}")
    del eng
    eng, out, dt = run(SAMPLE_ARGS, own)
    assert same_streams(out, sampled_out), "self-draft sampled != 4d's"
    assert eng.spec.acceptance_rate == 1.0, eng.spec.stats
    assert sorted(eng._verify_keys) == [(4, False), (4, True)]
    spec_report("self-draft sampled mix (phase 4d's knobs)", eng, dt)
    spec_graphs("self-draft sampled", eng)
    del eng
    eng, out, dt = run([], own, fmt="int8")
    assert same_streams(out, int8_out), "self-draft int8 != 4e's"
    # every verify launch reads the int8 arena (the scaled branch)
    assert all_counts[-1]["flash_prefill_chunk_scaled"] == \
        cfg.n_layers * (sum(g.replays + 1 for g in eng.verify_graphs.values())
                        + eng.stats["prefill_chunks"]
                        + len(eng.chunk_graphs)), all_counts[-1]
    spec_report("self-draft over an int8 target arena (fp32-format draft "
                "arena)", eng, dt)
    del eng

    def late_start(eng):
        stage = eng._stage

        def staged(dst, values):
            if dst is eng._vscalars:
                values = [values[0], values[1] + 1]
            stage(dst, values)
        return staged

    _, bad, _ = run(["--gen", "16"], own, stage=late_start)
    differ = [u for u in sorted(want) if not (bad[u] == want[u][:16]).all()]
    print(f"phase 4g: planted fault (each verify's device start one row "
          f"late): streams of requests {differ} differ from phase 4's")
    assert differ, "a late verify start went unseen"

    cheap = dataclasses.replace(cfg, name=f"{cfg.name}-2-layer-draft",
                                n_layers=2)
    cheap_spec = SpecConfig(draft=cheap, draft_seed=1)
    eng, out, dt = run([], cheap_spec)
    spec_report("2-layer draft, greedy", eng, dt, plain_dt)
    print(f"phase 4g: 2-layer draft, greedy: token-match prefix against "
          f"plain decode {match_prefix(out, want)} of {gen}")
    spec_graphs("2-layer draft", eng)
    d_ms, v_ms = round_device_ms(torch, eng, 4)
    print(f"phase 4g: 2-layer draft device ms a round at k=4, 4 live "
          f"slots, prefix {VERIFY_PREFIX}: 4 draft steps {d_ms:.3f} + 4 "
          f"verify passes {v_ms:.3f} = {d_ms + v_ms:.3f}")
    del eng
    _, hot_plain, hot_dt = run(HOT_ARGS, None)
    eng, out, dt = run(HOT_ARGS, cheap_spec)
    spec_report("2-layer draft, temperature 8.0", eng, dt, hot_dt)
    print(f"phase 4g: 2-layer draft, temperature 8.0: token-match prefix "
          f"against plain decode {match_prefix(out, hot_plain)} of {gen}")
    del eng
    one = HOT_ARGS + ["--requests", "1"]
    # {kind: {wave: [ms a token of each engine]}}: the first wave captures
    # the engine's chunk graphs (and a speculative engine's verify graph of
    # each rung its walk visits), the second finds them all
    res = {kind: {"first": [], "second": []}
           for kind in ("speculative", "plain")}
    streams = {}
    for i in range(pairs):
        for kind in (("speculative", "plain") if i % 2 == 0
                     else ("plain", "speculative")):
            eng, out, dt, dt2 = run(one, cheap_spec if kind == "speculative"
                                    else None, again=True)
            res[kind]["first"].append(1e3 * dt / out[0].size)
            res[kind]["second"].append(1e3 * dt2 / out[0].size)
            streams[kind] = out
            if kind == "speculative":
                acc, k_end = eng.spec.acceptance_rate, eng.spec.k
            del eng
    for wave in ("second", "first"):
        spec_ms, plain_ms = (res[kind][wave]
                             for kind in ("speculative", "plain"))
        print(f"phase 4g: one live request at temperature 8.0 on the 4-slot "
              f"engine, {wave} wave of each engine (prefill included), "
              f"wall ms a token, {pairs} alternating pairs: speculative "
              f"(2-layer draft, acceptance {acc:.4f}, k {k_end} at the end) "
              f"{[round(x, 3) for x in spec_ms]}, plain "
              f"{[round(x, 3) for x in plain_ms]}; median ratio "
              f"{statistics.median(spec_ms) / statistics.median(plain_ms):.3f}"
              f", plain's spread {min(plain_ms):.3f}-{max(plain_ms):.3f}")
    print(f"phase 4g: one live request, token-match prefix "
          f"{match_prefix(streams['speculative'], streams['plain'])}")
    print(f"phase 4g: {len(all_counts)} runs in "
          f"{time.perf_counter() - t_start:.1f} s; verify launches of "
          f"flash_prefill_chunk (its wrapper's count) "
          f"{sum(c['flash_prefill_chunk_verify'] for c in all_counts)}")
    return all_counts


# Phase 4h: phase 4's requests (chunked, captured, 4 slots, depth 2)
# under one fixed fault plan over alloc, chunk, decode and logits.  Its
# fault interleaving is a function of the traffic's shape only (prompt
# lengths, new tokens, slots, chunks, pages), not of any token: for this
# traffic it poisons two requests in the first wave, each quarantined
# before a poisoned token commits, and fires every site (the same
# interleaving as the reduced model's on the CPU)
FAULT_PLAN = dict(seed=0, alloc=0.02, chunk=0.1, decode=0.05,
                  logits=(0.03, 2))


def fault_plan():
    from repro_torch.runtime.serving import FaultPlan, FaultSpec
    kw = dict(FAULT_PLAN)
    rate, cap = kw.pop("logits")
    return FaultPlan.of(**kw, logits=FaultSpec(rate, max_fires=cap))


def fault_problems(eng, out, clean) -> list:
    """What breaks the survivor contract (empty: it holds): every request
    terminal; a FINISHED one equal to its fault-free stream (``clean``,
    uid mod 100), any other FAILED "nan-logits" with a prefix of it; one
    quarantine for each poison and for nothing else; every page and the
    scale sidecar back."""
    from repro_torch.runtime.serving import Status
    bad = []
    for uid, st in eng._results.items():
        want, got = clean[uid % 100], out[uid]
        if st.status == Status.FINISHED:
            if not (got.shape == want.shape and (got == want).all()):
                bad.append(f"request {uid} finished with another stream")
        elif (st.status, st.finish_reason) == (Status.FAILED, "nan-logits"):
            if not (got == want[:got.size]).all():
                bad.append(f"request {uid} failed without a clean prefix")
        else:
            bad.append(f"request {uid} ended {st.status} "
                       f"({st.finish_reason})")
    st = eng.stats
    if not st["quarantined"] == st["poisoned"] >= 1:
        bad.append(f"{st['poisoned']} poisons, {st['quarantined']} "
                   f"quarantined")
    mgr = eng.cache_mgr
    if mgr.free_pages != mgr.num_pages or mgr.scale_sidecar_pages:
        bad.append("pages not drained")
    return bad


def fault_run(torch, serve, bundle, params, args, plan, patch=None,
              waves=2):
    """Phase 4's requests on one engine (``plan`` or fault-free), then the
    same prompts again as new requests (uid + 100) when ``waves`` is 2, so
    every slot, a quarantined victim's included, takes a new resident.
    ``patch(eng)`` (a planted fault) runs before the first step.  Returns
    (engine, streams, wave-1 seconds, wave-1 TTFTs)."""
    eng = serve.engine(bundle, params, args, faults=plan)
    if patch is not None:
        patch(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(max_steps=20000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ttft = list(eng.stats["ttft_s"].values())
    if waves == 2:
        for uid in list(out):
            r = eng._results[uid].request
            eng.submit(dataclasses.replace(r, uid=100 + uid))
        out = eng.run(max_steps=20000)
    return eng, out, dt, ttft


def flag_cost(torch, serve, bundle, params, n=40):
    """The device ms the finite flag adds to a captured decode step: on an
    engine with phase 4's 4 requests all decoding, each twin (greedy,
    sampled) captured twice, as the engine builds it and as it was before
    the flag (the raw token vector returned, no reduction, no stack), and
    replayed ``n`` times each in alternating order from the same slot
    vectors (put back after each replay), timed with CUDA events around
    each replay.  Returns {twin: (median ms with flag, without)}."""
    from repro_torch.models import layers as L
    from repro_torch.runtime.serving import Status, graphs
    args = serve.parse_args(["--arch", bundle.name, "--gen", "48"]
                            + serve_args(bundle.name) + SAMPLE_ARGS
                            + ["--sampling-mix", "1.0"])
    eng = serve.engine(bundle, params, args)
    while eng.scheduler.waiting or any(
            st.status != Status.RUNNING
            for st in eng.scheduler.running.values()):
        eng.step()
    eng._queue.drain()
    eng._drain_pending(limit=0)

    def old_greedy():
        logits = eng.model.decode_step(eng.params, eng._tokens, eng._cache,
                                       eng._pos, share=eng._share)
        return old_advance(torch.argmax(logits, dim=-1))

    def old_sampled():
        return old_advance(eng.model.decode_and_sample(
            eng.params, eng._tokens, eng._cache, eng._pos, eng._samp,
            share=eng._share))

    def old_advance(sampled):
        eng._tokens.copy_(torch.where(eng._active == 1, sampled,
                                      eng._tokens))
        eng._pos.add_(eng._active)
        return sampled

    vec = (eng._tokens, eng._pos, eng._active)
    out = {}
    for twin, new, old in (("greedy", eng._decode_step, old_greedy),
                           ("sampled", eng._decode_step_sampled,
                            old_sampled)):
        pair = [graphs.DecodeGraph(fn, *vec) for fn in (new, old)]
        assert pair[0].out.shape == (2, eng.max_slots)
        saved = [t.clone() for t in vec]
        ms = ([], [])
        for i in range(n):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                pair[j].replay()
                t1.record()
                for t, s in zip(vec, saved):
                    t.copy_(s)
                torch.cuda.synchronize()
                ms[j].append(t0.elapsed_time(t1))
        out[twin] = tuple(statistics.median(m) for m in ms)
        del pair
    logits = torch.randn((eng.max_slots, bundle.cfg.vocab), device="cuda")
    alone = timed(lambda: L.finite_rows(logits), 200)
    print(f"phase 4h: {bundle.name} the finite flag on a captured decode "
          f"step (4 live slots, {n} replays each, alternating, CUDA events "
          f"around each replay), median device ms with / without: "
          + ", ".join(f"{k} {a:.4f} / {b:.4f} (+{a - b:.4f})"
                      for k, (a, b) in out.items())
          + f"; the reduction alone over {eng.max_slots} x "
            f"{bundle.cfg.vocab} f32 logits {alone:.4f} ms")
    del eng
    return out


def fill_times(torch, eng):
    """Device ms of one poison (NaN into every floating leaf of a slot's
    region) and one scrub (zeros into every leaf), CUDA events over 20
    calls each, on a slot the engine does not use."""
    slot = eng.max_slots - 1
    poison = timed(lambda: eng._fill_slot(slot, float("nan"),
                                          floating_only=True), 20)
    scrub = timed(lambda: eng._fill_slot(slot, 0.0, floating_only=False),
                  20)
    return poison, scrub


def fault_phase(torch, ops, serve, bundle, params, runs, int8_out=None,
                pairs=2, mode="chunked"):
    """Phase 4h: phase 4's requests (prefill ``mode``, chunked unless
    given) under :data:`FAULT_PLAN`, the decode and chunk steps captured,
    two waves an engine (the second reuses every slot, a quarantined one
    after its scrub).

    Every family (hymba-1.5b: its poison fills K/V rows, SSD state and
    conv tail): fault-free and faulted runs in ``pairs`` alternating
    pairs; the faulted runs' survivors equal phase 4's captured chunked
    streams bit for bit, victims keep a prefix, each poison is
    quarantined (:func:`fault_problems`), and the two faulted runs repeat
    each other's streams and fire counts exactly; tok/s and TTFT medians
    of the first wave against the fault-free run's; one poison's and one
    scrub's device ms.  The faulted path's kernels launch: the counts are
    set to 0 before the first faulted run and read after it.

    llama3.2-3b also: the int8 arena faulted (phase 4e's int8 streams);
    two planted faults that the check must catch (the scrub skipped, the
    finite flag forced true); the flag's device cost (:func:`flag_cost`);
    the self-draft (k = 4 = max_slots) with the health ladder, a burst of
    three dropped rounds moving it to DEGRADED (queue decode, its decode
    graph captured there) and back, streams equal to plain decode's; and
    8 requests over 2 replicas under each placement policy and with a
    drain and migration of replica 0 mid-run, streams equal to one
    engine's, tok/s and the device memory each replica adds against the
    weights' bytes.  Returns [launch counts of the faulted run]."""
    from repro_torch.models import layers as L
    from repro_torch.runtime.serving import (FaultPlan, FaultSpec,
                                             HealthConfig, SpecConfig)
    t_start = time.perf_counter()
    name = bundle.name
    base = (["--arch", name, "--gen", "64"] + serve_args(name)
            + ["--prefill-mode", mode])
    args = serve.parse_args(base)
    clean = runs[mode][1]
    plan = fault_plan()
    rows = {"clean": [], "faulted": []}
    faulted = []
    counts = None
    for i in range(pairs):
        for kind in (("clean", "faulted") if i % 2 == 0
                     else ("faulted", "clean")):
            if kind == "faulted" and counts is None:
                ops.reset_launch_counts()
            eng, out, dt, ttft = fault_run(
                torch, serve, bundle, params, args,
                plan if kind == "faulted" else None)
            if kind == "faulted" and counts is None:
                counts = ops.launch_counts()
            wave1 = sum(out[u].size for u in clean)
            rows[kind].append((wave1 / dt, statistics.median(ttft)))
            if kind == "clean":
                assert same_streams({u: out[u] for u in clean}, clean)
                continue
            bad = fault_problems(eng, out, clean)
            assert not bad, (name, bad)
            faulted.append((out, dict(eng.stats["faults"]),
                            eng.stats["poisoned"]))
            if len(faulted) == 1:
                victims = sorted(u for u, st in eng._results.items()
                                 if st.status.value != "finished")
                poison_ms, scrub_ms = fill_times(torch, eng)
                print(f"phase 4h: {name} faulted (plan {FAULT_PLAN}): "
                      f"fired {eng.stats['faults']}, poisoned "
                      f"{eng.stats['poisoned']}, quarantined "
                      f"{eng.stats['quarantined']}, victims {victims} "
                      f"(outputs prefixes), the others equal phase 4's "
                      f"streams in both waves; preempted "
                      f"{eng.scheduler.stats['preempted']}; poison "
                      f"{poison_ms:.4f} ms, scrub {scrub_ms:.4f} ms a slot "
                      f"(device, arena {eng.arena_bytes / 1e6:.1f} MB)")
            del eng
    assert len(faulted) == pairs >= 2
    for out, fired, _ in faulted[1:]:
        assert fired == faulted[0][1] and same_streams(out, faulted[0][0])
    nl = bundle.cfg.n_layers
    prefill_k, chunk_k, decode_k = path_kernels(bundle.cfg)
    kernels = set((prefill_k if mode == "monolithic" else chunk_k)
                  + decode_k)
    assert all(counts[k] > 0 for k in kernels), counts
    print(f"phase 4h: {name} faulted run's launches {counts} ({nl} layers)")
    print(f"phase 4h: {name} medians of {pairs} alternating pairs, first "
          f"wave: " + "; ".join(
              f"{kind} {statistics.median(r[0] for r in rs):.1f} tok/s, "
              f"TTFT {1e3 * statistics.median(r[1] for r in rs):.1f} ms"
              for kind, rs in rows.items())
          + "; the faulted runs repeat each other's streams and fire "
            "counts")
    if bundle.cfg.family != "dense":
        print(f"phase 4h: {name} done in "
              f"{time.perf_counter() - t_start:.1f} s")
        return [counts]
    # the int8 arena under the same plan: phase 4e's int8 streams
    i8 = serve.parse_args(base + ["--kv-format", "int8"])
    eng, out, _, _ = fault_run(torch, serve, bundle, params, i8, plan)
    bad = fault_problems(eng, out, int8_out)
    assert not bad, ("int8", bad)
    poison_ms, scrub_ms = fill_times(torch, eng)
    print(f"phase 4h: {name} int8 arena faulted: fired "
          f"{eng.stats['faults']}, poisoned {eng.stats['poisoned']}, "
          f"quarantined {eng.stats['quarantined']}; survivors equal phase "
          f"4e's int8 streams; poison {poison_ms:.4f} ms (scales only), "
          f"scrub {scrub_ms:.4f} ms a slot")
    del eng
    # monolithic prefill (flash_attention) under the same plan, one wave
    mono = serve.parse_args(["--arch", name, "--gen", "64"]
                            + serve_args(name))
    ops.reset_launch_counts()
    eng, out, _, _ = fault_run(torch, serve, bundle, params, mono, plan,
                               waves=1)
    mcounts = ops.launch_counts()
    bad = fault_problems(eng, out, runs["monolithic"][1])
    assert not bad, ("monolithic", bad)
    assert mcounts["flash_attention"] > 0 and mcounts["flash_decode"] > 0
    print(f"phase 4h: {name} monolithic faulted: fired "
          f"{eng.stats['faults']}, poisoned {eng.stats['poisoned']}, "
          f"quarantined {eng.stats['quarantined']}; survivors equal phase "
          f"4's monolithic streams; launches {mcounts}")
    del eng

    # planted faults: each must break the survivor contract
    def skip_scrub(eng):
        eng._scrub_slot = eng._poisoned_slots.discard

    real = L.finite_rows
    for label, patch in (("the scrub skipped", skip_scrub),
                         ("the finite flag forced true", None)):
        if patch is None:
            L.finite_rows = lambda x: torch.ones(
                x.shape[0], dtype=torch.bool, device=x.device)
        try:
            eng, out, _, _ = fault_run(torch, serve, bundle, params, args,
                                       plan, patch=patch)
        finally:
            L.finite_rows = real
        bad = fault_problems(eng, out, clean)
        assert bad, f"phase 4h: planted fault ({label}) not caught"
        print(f"phase 4h: planted fault ({label}) caught: {bad[:3]}")
        del eng
    flag_cost(torch, serve, bundle, params)

    # the ladder under speculation: rounds -> queue decode -> rounds
    own = SpecConfig(draft=bundle.cfg, k=4, adaptive=False, draft_seed=0)
    eng = serve.engine(
        bundle, params, args, speculative=own,
        faults=FaultPlan.of(seed=4, decode=FaultSpec(1.0, max_fires=3)),
        health=HealthConfig(fault_degraded=2, fault_shedding=8,
                            fault_draining=12, recover_after=2,
                            shed_steps_draining=None))
    assert eng.graph is None
    out = eng.run(max_steps=20000)
    assert same_streams(out, clean), "spec under the ladder != phase 4's"
    trans = [(t[1], t[2]) for t in eng.health.transitions]
    assert ("HEALTHY", "DEGRADED") in trans and \
        ("DEGRADED", "HEALTHY") in trans, trans
    g = eng.graph
    queue = eng.stats["decode_steps"] - eng.stats["spec_rounds"]
    assert g is not None and g.replays == queue > 0, (g, queue)
    print(f"phase 4h: {name} self-draft k=4 under the ladder: transitions "
          f"{eng.health.transitions}; {eng.stats['spec_rounds']} rounds, "
          f"{queue} queue decode steps; streams equal phase 4's; decode "
          f"graph captured at the first degraded step: warm-up "
          f"{g.warmup_s * 1e3:.1f} ms, capture {g.capture_s * 1e3:.1f} ms, "
          f"pool {g.pool_bytes / 1e6:.1f} MB")
    del eng, g

    # replicas on the one card, 8 requests (4 slots each)
    eight = base + ["--requests", "8"]
    one, want, one_dt = serve.serve(bundle, params, serve.parse_args(eight))
    assert same_streams({u: want[u] for u in clean}, clean)
    one_tok = sum(o.size for o in want.values()) / one_dt
    del one
    weights = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    for policy in ("least-pressure", "round-robin", "affinity"):
        fargs = serve.parse_args(eight + ["--replicas", "2", "--placement",
                                          policy])
        torch.cuda.synchronize()
        before = (torch.cuda.memory_allocated(),
                  torch.cuda.memory_reserved())
        fleet, got, dt = serve.serve_fleet(bundle, params, fargs)
        after = (torch.cuda.memory_allocated(),
                 torch.cuda.memory_reserved())
        assert same_streams(got, want), policy
        engines = [r.engine for r in fleet.replicas.values()]
        assert all(e.params is params for e in engines)
        per = [(a - b) / 2 for a, b in zip(after, before)]
        assert per[0] < weights / 2, (per, weights)
        pools = [sum(g.pool_bytes for _, g in serve.named_graphs(e) if g)
                 for e in engines]
        print(f"phase 4h: {name} 2 replicas ({policy}), 8 requests: "
              f"{sum(o.size for o in got.values()) / dt:.1f} tok/s (one "
              f"4-slot engine {one_tok:.1f}); placed "
              f"{fleet.stats['placed']}; streams equal one engine's; "
              f"device memory a replica: allocated {per[0] / 1e6:.1f} MB, "
              f"reserved {per[1] / 1e6:.1f} MB (arena "
              f"{engines[0].arena_bytes / 1e6:.1f} MB, graph pools "
              f"{[round(p / 1e6, 1) for p in pools]} MB) against "
              f"{weights / 1e9:.2f} GB of weights, shared")
        del fleet, engines
    fleet = serve.router(bundle, params, serve.parse_args(
        eight + ["--replicas", "2"]))
    for _ in range(6):
        fleet.step()
    moved = fleet.drain(0, migrate=True)
    got = fleet.run()
    assert moved and same_streams(got, want), moved
    assert all(fleet.owner_of(u) == 1 for u in moved)
    assert fleet.replicas[0].engine.stats["migrated"] == len(moved)
    print(f"phase 4h: {name} drain of replica 0 with migration after 6 "
          f"steps: requests {moved} moved to replica 1, streams equal one "
          f"engine's; replica rows {fleet.replica_stats()}")
    del fleet
    print(f"phase 4h: {name} done in {time.perf_counter() - t_start:.1f} s")
    return [counts, mcounts]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def prefill_logits(model, params, prompt):
    cache = model.init_cache(1, prompt.shape[1] + 1)
    return model.prefill(params, prompt, cache)[0]


def ssm_f32_check(torch, ops, cfg, params, prompt):
    """Phase 5b (ssm): request 0's prefill logits with f32 params and
    activations, kernel path vs plain path, held to MAMBA2_F32_LOGIT_TOL;
    the plain path with a planted SSD fault (the carry into the last
    64-token inner chunk dropped, in every layer) must exceed it."""
    import types
    from repro_torch.models import registry
    P = ops.PLAIN

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    p32 = f32(params)
    faulty = types.SimpleNamespace(**{**vars(P), "ssd": carry_dropped(P)})
    logits = {name: prefill_logits(registry.build_model(
                  cfg32, device="cuda", kernels=k), p32, prompt)
              for name, k in (("kernel", ops), ("plain", P),
                              ("fault", faulty))}
    del p32
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    f_diff = (logits["fault"] - logits["plain"]).abs().max().item()
    tol = MAMBA2_F32_LOGIT_TOL
    print(f"phase 5b: {cfg.name} f32 request 0 prefill logits, kernel vs "
          f"plain path: max |diff| = {diff:.4e} (tol {tol}; logits std "
          f"{logits['plain'].std().item():.4f}); planted fault (carry into "
          f"the last inner chunk dropped): {f_diff:.4e}, "
          f"{f_diff / tol:.1f} of the limit")
    assert bool(torch.isfinite(logits["kernel"]).all())
    assert diff <= tol, diff
    assert f_diff > tol, f_diff


def hybrid_f32_check(torch, ops, cfg, params, prompt):
    """Phase 5b (hybrid): request 0's prefill logits (1536 tokens, past
    the window) with f32 params and activations, kernel path vs plain
    path, held to HYMBA_F32_LOGIT_TOL; the plain path with the window
    dropped in every windowed layer (the planted fault) must exceed it by
    more than FAULT_MARGIN."""
    from repro_torch.models import registry
    P = ops.PLAIN

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    p32 = f32(params)
    logits = {}
    for name, kops in (("kernel", ops), ("plain", P), ("fault", P)):
        model = registry.build_model(cfg32, device="cuda", kernels=kops)
        if name == "fault":
            model.windows = [cfg.max_seq + 1] * cfg.n_layers
        logits[name] = prefill_logits(model, p32, prompt)
    del p32
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    f_diff = (logits["fault"] - logits["plain"]).abs().max().item()
    tol = HYMBA_F32_LOGIT_TOL
    print(f"phase 5b: {cfg.name} f32 request 0 prefill logits "
          f"({prompt.shape[1]} tokens), kernel vs plain path: max |diff| = "
          f"{diff:.4e} (tol {tol}; logits std "
          f"{logits['plain'].std().item():.4f}); planted fault (the window "
          f"dropped in the {cfg.n_layers - cfg.n_global_layers} windowed "
          f"layers): {f_diff:.4e}, {f_diff / tol:.1f} of the limit")
    assert bool(torch.isfinite(logits["kernel"]).all())
    assert diff <= tol, diff
    assert f_diff > FAULT_MARGIN * tol, f_diff


def carry_dropped(P):
    """The plain ssd with a planted fault: the carry into the last 64-token
    inner chunk dropped (the state entering it is zero; in a scan of at
    most 64 tokens that is the initial state)."""
    import torch

    def ssd(x, log_a, B, C, *, chunk=256, initial_state=None):
        cut = (x.shape[1] - 1) // 64 * 64
        if cut == 0:
            return P.ssd(x, log_a, B, C, chunk=chunk)
        y0, _ = P.ssd(x[:, :cut], log_a[:, :cut], B[:, :cut], C[:, :cut],
                      chunk=chunk, initial_state=initial_state)
        y1, st = P.ssd(x[:, cut:], log_a[:, cut:], B[:, cut:], C[:, cut:],
                       chunk=chunk)
        return torch.cat([y0, y1], dim=1), st
    return ssd


def one_term():
    """A lower-precision ssd, the control phase 5c's state limits must
    reject: the bf16 kernel's arithmetic (64-token chunks in order; exact
    bf16 products, f32 sums) with each f32 operand the tensor cores take
    (the decayed scores G, the carried state H, w X) rounded to one bf16
    term instead of the kernel's two (``csrc/ssd.cu``)."""
    import torch

    def one(t):
        return t.bfloat16().float()

    def ssd(x, log_a, B, C, *, chunk=256, initial_state=None):
        bh, s, p = x.shape
        B, C = (t.float().repeat_interleave(bh // t.shape[0], 0)
                for t in (B, C))
        h = (torch.zeros((bh, B.shape[-1], p), device=x.device)
             if initial_state is None else initial_state.float())
        ys = []
        for c0 in range(0, s, 64):
            xb, Bb, Cb = (t[:, c0:c0 + 64].float() for t in (x, B, C))
            cum = torch.cumsum(log_a[:, c0:c0 + 64].float(), dim=-1)
            q = cum.shape[1]
            keep = torch.ones((q, q), dtype=torch.bool,
                              device=x.device).tril()
            g = torch.where(keep, (Cb @ Bb.transpose(1, 2)) * torch.exp(
                cum[:, :, None] - cum[:, None, :]), 0.0)
            ys.append((Cb @ one(h)) * torch.exp(cum)[..., None]
                      + one(g) @ xb)
            wx = torch.exp(cum[:, -1:] - cum)[..., None] * xb
            h = (h * torch.exp(cum[:, -1])[:, None, None]
                 + Bb.transpose(1, 2) @ one(wx))
        y = torch.cat(ys, 1) if ys else x.float()
        return y.to(x.dtype), h
    return ssd


def ssm_layer_check(torch, ops, cfg, params, prompt, label="layer 0"):
    """Phase 5c: layer 0 of mamba2-2.7b in bf16 (``mamba_apply`` on the
    rms-normed embeddings of request 0's prompt, as serving's monolithic
    prefill runs it), its final SSD state and conv tail carried through
    one 64-token chunk (``initial_state``) and 4 decode steps
    (``mamba_decode_step``).  Kernel path (the ssd tensor-core kernel)
    against plain path, each quantity held to SSM_LAYER_MARGIN times the
    control; the planted fault must exceed every limit by more than
    FAULT_MARGIN."""
    import types

    import numpy as np
    from repro_torch.kernels import ssd
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2
    from repro_torch.models.transformer import layer_params
    P = ops.PLAIN
    p = layer_params(params["layers"], 0)
    more = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, 64 + 4), device=prompt.device)
    cfg64 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                             chunk=64))

    def h(tokens):
        return L.rmsnorm(p["ln"], L.embed_lookup(params["embed"], tokens),
                         cfg.rms_eps)

    def run(kops, c):
        """The quantities of one path."""
        y, (st, tail) = mamba2.mamba_apply(p["mamba"], c, h(prompt),
                                           kops=kops, return_state=True)
        yc, (stc, tailc) = mamba2.mamba_apply(
            p["mamba"], c, h(more[None, :64]), kops=kops, initial_state=st,
            conv_tail=tail, return_state=True)
        cache, outs = {"ssm": stc, "conv": tailc}, []
        for t in range(64, 68):
            o, cache = mamba2.mamba_decode_step(p["mamba"], c,
                                                h(more[t:t + 1]), cache,
                                                kops=kops)
            outs.append(o)
        return {"y": y, "state": st, "chunk y": yc, "chunk state": stc,
                "decode out": torch.stack(outs)}

    before = ssd.launches
    got = run(ops, cfg)
    launched = ssd.launches - before
    plain, ctrl = run(P, cfg), run(P, cfg64)
    fault = run(types.SimpleNamespace(**{**vars(P),
                                         "ssd": carry_dropped(P)}), cfg)
    low = run(types.SimpleNamespace(**{**vars(P), "ssd": one_term()}), cfg)
    assert launched == 2, launched       # the prompt's scan and the chunk's
    assert got["y"].dtype == torch.bfloat16, got["y"].dtype
    print(f"phase 5c: {cfg.name} {label}, bf16, request 0's "
          f"{prompt.shape[1]}-token prompt, then a 64-token chunk and 4 "
          f"decode steps carried from its state ({launched} ssd launches on "
          f"the kernel path)")
    for q in got:
        c = layer_ulps(ctrl[q], plain[q])
        lim = SSM_LAYER_MARGIN[q] * max(c, 1.0)
        k = layer_ulps(got[q], plain[q])
        f = layer_ulps(fault[q], plain[q])
        lo = layer_ulps(low[q], plain[q])
        err = (got[q].float() - plain[q].float()).abs().max().item()
        print(f"  {q:<12} ({str(got[q].dtype)[6:]}) control {c:.2f} ulps, "
              f"limit {lim:.2f} ({SSM_LAYER_MARGIN[q]:g}x); kernel {k:.2f} "
              f"= {k / lim:.3f} of it (max|diff| {err:.3e}); planted fault "
              f"{f:.4g} = {f / lim:.1f}x; one bf16 term {lo:.4g} = "
              f"{lo / lim:.2f}x")
        assert bool(torch.isfinite(got[q]).all()), q
        assert k <= lim, (q, k, lim)
        assert f > FAULT_MARGIN * lim, (q, f, lim)
        if got[q].dtype == torch.float32:
            assert lo > lim, (q, lo, lim)


def layer_ulps(got, want) -> float:
    """max over elements of |got - want| in ulps of got's type (bf16 or
    f32) at the larger magnitude, floored at the ulp of want's rms."""
    import torch
    bits = type_bits(got)
    g, w = got.float(), want.float()
    floor = ulp(w.pow(2).mean().sqrt(), bits)
    return ((g - w).abs() / (ulp(torch.maximum(g.abs(), w.abs()), bits)
                             + floor)).max().item()


def end_to_end(torch, ops, serve, bundle, params, args, runs):
    """Phase 5: kernel path vs plain path logits for request 0's prompt."""
    import numpy as np
    from repro_torch.models import registry
    rng = np.random.default_rng(0)
    lens = serve.prompt_lengths(args)
    prompts = [rng.integers(0, bundle.cfg.vocab, n) for n in lens]
    prompt = torch.as_tensor(prompts[0], device="cuda")[None]
    plain = registry.build_model(bundle.cfg, device="cuda",
                                 kernels=ops.PLAIN)
    models = [("kernel", bundle.model), ("plain", plain)]
    ssm = bundle.cfg.ssm is not None
    if ssm:
        # control: the plain path with 64-token SSD chunks, which changes
        # nothing but the f32 rounding of the scan
        cfg64 = dataclasses.replace(bundle.cfg, ssm=dataclasses.replace(
            bundle.cfg.ssm, chunk=64))
        models.append(("plain64", registry.build_model(
            cfg64, device="cuda", kernels=ops.PLAIN)))
    logits = {name: prefill_logits(model, params, prompt)
              for name, model in models}
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    if ssm:
        ctrl = (logits["plain64"] - logits["plain"]).abs().max().item()
        print(f"phase 5: {bundle.name} control, plain path with 64-token "
              f"vs 256-token SSD chunks: max |diff| = {ctrl:.4e}")
    top2 = torch.topk(logits["plain"], 2).values
    gap = (top2[0] - top2[1]).item()
    tok_k = int(torch.argmax(logits["kernel"]))
    tok_p = int(torch.argmax(logits["plain"]))
    held = ("reported; the f32 check decides" if ssm
            else f"tol {LOGIT_TOL}")
    print(f"phase 5: {bundle.name} request 0 prefill logits, kernel vs "
          f"plain path: max |diff| = {diff:.4e} ({held}; logits std "
          f"{logits['plain'].std().item():.4f}, max "
          f"{logits['plain'].abs().max().item():.4f}); argmax {tok_k} vs "
          f"{tok_p}; plain top-2 gap {gap:.4e}")
    assert logits["kernel"].shape == (bundle.cfg.vocab,)
    assert bool(torch.isfinite(logits["kernel"]).all())
    if ssm:
        del logits, models, plain
        if bundle.cfg.family == "ssm":
            ssm_layer_check(torch, ops, bundle.cfg, params, prompt)
            one = dataclasses.replace(bundle.cfg, n_layers=1)
            for seed in SSM_LAYER_DRAWS:
                ssm_layer_check(torch, ops, one, registry.build_model(
                    one, device="cuda").init(seed), prompt,
                    label=f"layer 0 of a 1-layer draw from seed {seed}")
            ssm_f32_check(torch, ops, bundle.cfg, params, prompt)
        else:
            hybrid_f32_check(torch, ops, bundle.cfg, params, prompt)
    else:
        assert diff <= LOGIT_TOL, diff
        if gap >= LOGIT_TOL:
            assert tok_k == tok_p, (tok_k, tok_p)
    mono_out, chunk_out = runs["monolithic"][1], runs["chunked"][1]
    assert int(mono_out[0][0]) == tok_k, (mono_out[0][0], tok_k)
    for uid in sorted(mono_out):
        a, b = mono_out[uid], chunk_out[uid]
        n = int(np.argmin(a == b)) if not (a == b).all() else a.size
        print(f"  request {uid}: monolithic vs chunked token-match prefix "
              f"{n}/{a.size}")


def hybrid_phase(torch, ops, serve, smi):
    """Phases 4 and 5 for hymba-1.5b (the hybrid family: each layer's
    attention window and SSD branch side by side) at full width, random
    weights, prompts 1536 / 1200: served monolithic and chunked (4), the
    chunks eager against captured and the stale-start fault, decode-only
    windows eager against captured with the device ms a step (4c), half
    the requests sampled, captured against eager (4d), the shared-prefix
    mix with sharing on and off (4f), the fault plan (4h), and request 0's
    logits (5).  Fewer repetitions than the other two models' phases, to
    hold the smoke's time; every check in full.  Returns the launch counts
    of its main-path runs, each kernel's count under ``<kernel>_hymba``
    (the kernel table's rows 1h-4h)."""
    t_start = time.perf_counter()
    bundle, params, args, runs = serving_runs(torch, ops, serve, HYMBA,
                                              gen=64)
    cpairs = chunk_pairs(torch, serve, bundle, params, runs, gen=64,
                         pairs=1)
    window, wbusy = decode_window(torch, serve, bundle, params, pairs=1)
    mixed, counts4d = sampled_runs(torch, ops, serve, bundle, params, runs)
    shared = shared_prefix_runs(torch, ops, serve, bundle, params, pairs=1)
    faulted = fault_phase(torch, ops, serve, bundle, params, runs)
    end_to_end(torch, ops, serve, bundle, params, args, runs)
    ttft = {mode: sorted(run[0].stats["ttft_s"].values())
            for mode, run in runs.items()}
    tok_s = {mode: sum(o.size for o in run[1].values()) / run[2]
             for mode, run in runs.items()}
    pools = {mode: sum(g.pool_bytes for g in
                       [run[0].graph, *run[0].chunk_graphs.values()])
             for mode, run in runs.items()}
    rows = cpairs["captured chunks"]
    print(f"phase 4: {HYMBA} summary ({smi}): "
          + "; ".join(f"{mode} {tok_s[mode]:.1f} tok/s, TTFT ms "
                      f"{[round(1e3 * t, 1) for t in ttft[mode]]}, graph "
                      f"pools {pools[mode] / 1e6:.1f} MB" for mode in runs)
          + f"; captured greedy decode step {wbusy['captured'][0]:.3f} ms "
            f"device, {statistics.median(window['captured']):.3f} ms wall "
            f"(eager {statistics.median(window['eager']):.3f} ms wall); "
            f"captured chunks second wave "
            f"{statistics.median(r[0] for r in rows['second']):.1f} tok/s; "
            f"sampled mix " + ", ".join(f"{mode} {r[0]:.1f} tok/s"
                                        for mode, r in mixed.items())
          + f"; phases 4-5 in {time.perf_counter() - t_start:.1f} s")
    counts = [run[3] for run in runs.values()] + counts4d + shared + faulted
    del bundle, params, runs
    torch.cuda.empty_cache()
    return [{f"{k}_hymba": v for k, v in c.items()} for c in counts]


def free_capacity(registry, bundle):
    """``bundle``'s moe model with capacity_factor = n_experts / top_k, the
    reference's regime in which no (token, choice) pair is ever dropped
    (configs/base.py:183-195), so batching, chunking and sharing cannot
    change a token's output; a model of its own over the same parameter
    tensors."""
    me = bundle.cfg.moe
    cfg = dataclasses.replace(bundle.cfg, moe=dataclasses.replace(
        me, capacity_factor=me.n_experts / me.top_k))
    return registry.Bundle(name=bundle.name, cfg=cfg,
                           model=registry.build_model(cfg, device="cuda"))


def watch(module, name, seen):
    """Wrap ``module.name`` so that each call appends its result to
    ``seen``; returns the function that puts the original back."""
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def moe_prompts(torch, serve, bundle):
    """Phase 4's prompts of ``bundle`` as (1, S) device tensors."""
    args = serve.parse_args(["--arch", bundle.name]
                            + serve_args(bundle.name))
    return [torch.as_tensor(p, device="cuda")[None]
            for p in serve.prompts(args, bundle.cfg.vocab)]


def drop_shares(torch, bundle, params, prompts):
    """The share of (token, choice) pairs dropped by capacity in one
    prefill (request 0's prompt, one dispatch of S rows a layer), one
    chunk (its first 512 rows) and one decode step (4 slots: requests 0
    and 1 after their prompts, the chunk's slot, one parked), read off the
    ``keep`` of ``moe.dispatch`` in every layer; then the same decode step
    under ``torch.cuda.set_sync_debug_mode("error")``, where any host sync
    raises.  Returns {what: share}."""
    from repro_torch.models import moe
    model, cfg = bundle.model, bundle.cfg
    smax = max(p.shape[1] for p in prompts) + 2
    cache = model.init_cache(4, smax)
    shares, toks = {}, []

    def run(what, fn):
        seen = []
        restore = watch(moe, "dispatch", seen)
        try:
            out = fn()
        finally:
            restore()
        keep = torch.cat([k for _, k in seen])
        assert len(seen) == cfg.n_layers, len(seen)
        shares[what] = (1.0 - keep.float().mean().item(), keep.numel())
        return out

    for i, prompt in enumerate(prompts[:2]):
        view = model.slot_view(cache, i)
        toks.append(run(f"prefill S={prompt.shape[1]}", lambda: model.prefill(
            params, prompt, view)).argmax(-1))
    piece = prompts[0][:, :512]
    toks.append(run("chunk C=512", lambda: model.prefill_chunk(
        params, piece, cache, 2, 0, 511)).argmax(-1))
    tok = torch.cat(toks + [toks[0]])
    pos = torch.tensor([prompts[0].shape[1], prompts[1].shape[1], 512,
                        PARKED_POS], device="cuda")
    run("decode 4 slots", lambda: model.decode_step(params, tok, cache,
                                                    pos.clone()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = model.decode_step(params, tok, cache, pos.clone())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits[:3]).all())
    print(f"phase 4: {bundle.name} (capacity_factor "
          f"{cfg.moe.capacity_factor}) pairs dropped by capacity, all "
          f"{cfg.n_layers} layers: " + "; ".join(
              f"{what} {100 * sh:.2f}% of {n}" for what, (sh, n)
              in shares.items())
          + "; an eager decode step under set_sync_debug_mode('error') "
            "raised nothing")
    return {what: sh for what, (sh, _) in shares.items()}


def routed_logits(model, params, prompt):
    """Request 0's prefill logits and the expert choices (L, S, k) of
    every layer's dispatch on the way."""
    import torch
    from repro_torch.models import moe
    seen = []
    restore = watch(moe, "route", seen)
    try:
        logits = prefill_logits(model, params, prompt)
    finally:
        restore()
    return logits, torch.stack([idx for _, idx, _ in seen])


def moe_end_to_end(torch, ops, bundle, params, prompt, free_bundle):
    """Phase 5 (moe): request 0's prefill logits, kernel path against
    plain path, beside a control (the plain path with PyTorch's
    ``scaled_dot_product_attention`` for the attention op: another
    rounding of the same attention), and the share of (token, layer,
    choice) expert choices on which each pair agrees: a one-ulp attention
    difference can move a router near-tie, a moved choice replaces a
    quarter of that token's routed output, and under binding capacity it
    also moves which later pairs are dropped.  The same for the
    capacity-free variant.  Held: the kernel path's logits no farther from
    the plain path's, and its choices agreeing no less, than the
    control's; the plain path with a planted attention fault (the softmax
    scale dropped: 1 in place of hd^-1/2, in every layer) farther than
    FAULT_MARGIN times the control.  Returns {label: (max |diff|,
    agreement)}."""
    import types
    from repro_torch.models import registry
    P = ops.PLAIN

    def unscaled(q, k, v, *, causal=True, window=None, **_):
        return P.attention(q, k, v, causal=causal, window=window, scale=1.0)

    kops = {"control": sdpa_kops(P),
            "fault": types.SimpleNamespace(**{**vars(P),
                                              "attention": unscaled})}
    out = {}
    for label, b in (("published", bundle), ("capacity-free", free_bundle)):
        res = {name: routed_logits(m, params, prompt) for name, m in (
            ("kernel", b.model),
            ("plain", registry.build_model(b.cfg, device="cuda",
                                           kernels=P)),
            *((k, registry.build_model(b.cfg, device="cuda", kernels=o))
              for k, o in kops.items()))}
        diff = {k: (res[k][0] - res["plain"][0]).abs().max().item()
                for k in ("kernel", "control", "fault")}
        agree = {k: (res[k][1] == res["plain"][1]).float().mean().item()
                 for k in ("kernel", "control", "fault")}
        top2 = torch.topk(res["plain"][0], 2).values
        print(f"phase 5: {bundle.name} {label} (capacity_factor "
              f"{b.cfg.moe.capacity_factor:g}) request 0 prefill logits "
              f"against the plain path: kernel max |diff| "
              f"{diff['kernel']:.4e}, control (SDPA attention) "
              f"{diff['control']:.4e} (logits std "
              f"{res['plain'][0].std().item():.4f}); expert choices equal "
              f"on {100 * agree['kernel']:.3f}% (kernel) and "
              f"{100 * agree['control']:.3f}% (control) of "
              f"{res['plain'][1].numel()} (token, layer, choice); argmax "
              f"{int(res['kernel'][0].argmax())} vs "
              f"{int(res['plain'][0].argmax())}, plain top-2 gap "
              f"{(top2[0] - top2[1]).item():.4e}; planted fault (softmax "
              f"scale dropped in every layer) max |diff| "
              f"{diff['fault']:.4e} = "
              f"{diff['fault'] / diff['control']:.1f}x the control, "
              f"choices equal on {100 * agree['fault']:.3f}%")
        for k in ("kernel", "control"):
            assert res[k][0].shape == (b.cfg.vocab,)
            assert bool(torch.isfinite(res[k][0]).all())
        # the kernel path no farther from the plain path than another
        # rounding of the same attention, which a real fault is not
        assert diff["kernel"] <= diff["control"], (label, diff)
        assert agree["kernel"] >= agree["control"], (label, agree)
        assert diff["fault"] > FAULT_MARGIN * diff["control"], (label, diff)
        out[label] = (diff, agree)
        del res
    return out


# a token's MoE output "moves" between two dispatches when its relative
# change (row norm) exceeds this: bf16 rounding of GEMMs of other shapes
# stays far below it, one dropped pair of four (gate ~1/4) far above
MOVED_REL = 0.05


def split_invariance(torch, bundle, params, prompt):
    """Phase 5 (moe): layer 0's MoE input for ``prompt`` (through the
    kernel path's attention) dispatched as one (S rows, monolithic
    prefill's dispatch), in 512-row pieces (a chunk's) and in 4-row
    pieces (a decode step's); each token's output and expert choices in
    a split against the one dispatch.  Returns {split: (tokens whose
    choices differ, tokens with equal choices whose output moved (>
    MOVED_REL), the largest relative change among those that did not
    move)}."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models.transformer import attention_prefill, layer_params
    model, cfg = bundle.model, bundle.cfg
    p = layer_params(params["layers"], 0)
    s = prompt.shape[1]
    x = L.embed_lookup(params["embed"], prompt)
    cache = model.init_cache(1, s + 1)
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + attention_prefill(p["attn"], cfg, h,
                              {k: v[0] for k, v in cache.items()},
                              torch.arange(s, device=x.device)[None],
                              kops=model.kops)
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)

    def dispatched(rows):
        seen = []
        restore = watch(moe, "route", seen)
        try:
            y = torch.cat([moe.moe_mlp_apply(p["moe"], cfg, piece)[0]
                           for piece in h.split(rows, dim=1)], dim=1)
        finally:
            restore()
        return y[0].float(), torch.cat([idx for _, idx, _ in seen])

    y1, c1 = dispatched(s)
    out = {}
    for rows in (512, 4):
        y, c = dispatched(rows)
        same = (c == c1).all(-1)
        rel = (y - y1).norm(dim=-1) / y1.norm(dim=-1)
        moved = same & (rel > MOVED_REL)
        still = rel[same & ~moved]
        out[rows] = (int((~same).sum()), int(moved.sum()),
                     still.max().item() if still.numel() else 0.0)
    return out


def mono_chunked_logits(bundle, params, prompts):
    """Each prompt's first-token logits through monolithic prefill (one
    dispatch of S rows a layer) and chunked prefill (the engine's plan:
    512, then 512 or 256): max |diff| over the prompts."""
    model = bundle.model
    return max((prefill_logits(model, params, p)
                - chunked_routed_logits(model, params, p)[0]).abs().max()
               .item() for p in prompts[:2])


def chunked_routed_logits(model, params, prompt):
    """``prompt``'s first-token logits through chunked prefill (the
    engine's plan) and the expert choices (L, S, k) of every layer's
    dispatch on the way."""
    import torch
    from repro_torch.models import moe
    from repro_torch.runtime.serving import chunking
    n, seen = prompt.shape[1], []
    cache = model.init_cache(1, n + 1)
    start = 0
    restore = watch(moe, "route", seen)
    try:
        for c in chunking.chunk_plan(n):
            piece = prompt[:, start:start + c]
            last = model.prefill_chunk(params, piece, cache, 0, start,
                                       piece.shape[1] - 1)[0]
            start += c
    finally:
        restore()
    nl = model.cfg.n_layers
    chunks = len(seen) // nl
    return last, torch.stack([
        torch.cat([seen[i * nl + layer][1] for i in range(chunks)])
        for layer in range(nl)])


def moe_f32_check(torch, bundle, free, params, prompts):
    """Phase 5b (moe): requests 0 and 1's first-token logits with f32
    params and activations through all layers, monolithic against chunked
    prefill under capacity_factor = n_experts / top_k, held to
    MOE_F32_LOGIT_TOL, with the expert choices of the two compared; the
    planted fault (the chunks under the published capacity) must exceed
    the limit by more than FAULT_MARGIN.  Converts ``params`` to f32 in
    place, leaf by leaf, so the bf16 leaves leave the card as it goes
    (every engine over them must be collected first)."""
    from repro_torch.models import registry

    def to_f32(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                to_f32(v)
            else:
                tree[k] = v.float()

    held = torch.cuda.memory_allocated()
    to_f32(params)
    f32 = dict(param_dtype="float32", act_dtype="float32")
    models = {label: registry.build_model(dataclasses.replace(b.cfg, **f32),
                                          device="cuda")
              for label, b in (("free", free), ("published", bundle))}
    tol, diff, fault, agree = MOE_F32_LOGIT_TOL, 0.0, 0.0, []
    for prompt in prompts[:2]:
        mono, m_idx = routed_logits(models["free"], params, prompt)
        chunk, c_idx = chunked_routed_logits(models["free"], params, prompt)
        bad, _ = chunked_routed_logits(models["published"], params, prompt)
        assert mono.dtype == torch.float32 and mono.shape == (
            free.cfg.vocab,)
        assert bool(torch.isfinite(mono).all() & torch.isfinite(chunk).all())
        diff = max(diff, (mono - chunk).abs().max().item())
        fault = max(fault, (mono - bad).abs().max().item())
        agree.append(int((m_idx != c_idx).sum()))
    print(f"phase 5b: {free.name} capacity-free (capacity_factor "
          f"{free.cfg.moe.capacity_factor:g}) f32, all {free.cfg.n_layers} "
          f"layers ({held / 1e9:.1f} GB on the card before the f32 copy, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB after): first-token "
          f"logits of requests 0 and 1, monolithic vs chunked prefill: max "
          f"|diff| {diff:.4e} (tol {tol}); (token, layer, choice) expert "
          f"choices that differ: {agree}; planted fault (the chunks under "
          f"capacity_factor {bundle.cfg.moe.capacity_factor:g}): "
          f"{fault:.4e}, {fault / tol:.1f}x the limit")
    assert diff <= tol, diff
    assert fault > FAULT_MARGIN * tol, fault


def int8_runs(torch, ops, serve, bundle, params, runs, gen=64,
              modes=("monolithic", "chunked")):
    """Phase 4e (moe): phase 4's requests over an int8 arena, both
    prefill modes captured: every flash_decode and flash_prefill_chunk
    launch scaled (counts set to 0 just before each run), the pages and
    the scale sidecar drained; printed: kv_row_bytes and arena bytes
    beside the fp32 format's, the greedy token match against phase 4's
    streams.  Returns [launch counts of each run]."""
    from repro_torch.runtime.serving import tolerance
    nl = bundle.cfg.n_layers
    all_counts = []
    for mode in modes:
        args = serve.parse_args(["--arch", bundle.name, "--gen", str(gen),
                                 "--prefill-mode", mode, "--kv-format",
                                 "int8"] + serve_args(bundle.name))
        ops.reset_launch_counts()
        eng, out, dt = serve.serve(bundle, params, args)
        counts = ops.launch_counts()
        all_counts.append(counts)
        steps = eng.stats["decode_steps"]
        assert eng.graph.replays == steps > 0
        assert counts["flash_decode_scaled"] == counts["flash_decode"] \
            == nl * (steps + 1), counts
        assert counts["flash_prefill_chunk_scaled"] == \
            counts["flash_prefill_chunk"], counts
        check_chunk_graphs(eng)
        assert eng.cache_mgr.free_pages == eng.cache_mgr.num_pages
        assert eng.cache_mgr.scale_sidecar_pages == 0
        ref = runs[mode][0]
        report = tolerance.compare_streams(runs[mode][1], out)
        total = sum(o.size for o in out.values())
        print(f"phase 4e: {bundle.name} int8 {mode}: {total} tokens in "
              f"{dt:.3f} s = {total / dt:.1f} tok/s; kv_row_bytes "
              f"{eng.kv_row_bytes} vs fp32's {ref.kv_row_bytes} "
              f"({eng.kv_row_bytes / ref.kv_row_bytes:.3f}x), arena "
              f"{eng.arena_bytes / 1e6:.1f} MB vs {ref.arena_bytes / 1e6:.1f}"
              f" MB; greedy token match vs fp32: {report.describe()}")
        del eng
    return all_counts


def moe_phase(torch, ops, serve, registry, smi):
    """Phases 4 and 5 for qwen2-moe-a2.7b (the moe family: routed experts
    with the reference's capacity predication) at full width, random
    weights, prompts 1024 / 768, 64 new tokens, 4 slots.

    Under the published capacity_factor 1.25, which binds (cap 1 of 60
    experts in a decode step of 4 slots, 42 in a 512-row chunk, 85 in a
    1024-row prefill): served monolithic and chunked (4), the share of
    pairs dropped in a prefill, a chunk and a decode step and an eager
    decode step with no host sync, captured = eager with the chunks eager
    too and a decode-only window with the captured step's device time by
    op (4c), requests 1 and 3 sampled, captured = eager (4d), the int8
    arena (4e), and request 0's logits and expert choices against the
    plain path (5).  Under capacity_factor = n_experts / top_k (the same
    parameter tensors), where a token's output is its own: served in both
    modes, no pair dropped, layer 0's MoE dispatched in 512- and 4-row
    pieces against one dispatch (no token whose choices agree moves; the
    published config's tokens do move), monolithic against chunked
    first-token logits and streams (reported), the shared-prefix mix with
    sharing on and off (4f), the fault plan (4h) and 2 replicas behind
    the router against one engine.  Under binding
    capacity those equalities fail in the reference too, so they are not
    asserted there; that a token's output is its own once capacity no
    longer binds is held in f32 at the end (5b: monolithic = chunked
    through all layers), where the weights become f32.  Returns the
    launch counts of its main-path runs, each kernel's count under
    ``<kernel>_moe``."""
    import gc

    import numpy as np
    t_start = time.perf_counter()
    bundle, params, args, runs = serving_runs(torch, ops, serve, QWEN2_MOE,
                                              gen=64)
    prompts = moe_prompts(torch, serve, bundle)
    shares = drop_shares(torch, bundle, params, prompts)
    pairs = eager_vs_captured(serve, bundle, params, runs, gen=64, pairs=1,
                              eager_chunks=True)
    # the captured step alone: eager_vs_captured holds it to the eager one
    window, wbusy = decode_window(torch, serve, bundle, params, pairs=1,
                                  same=False, kinds={"captured": []})
    mixed, counts4d = sampled_runs(torch, ops, serve, bundle, params, runs,
                                   per_token=False)
    counts4e = int8_runs(torch, ops, serve, bundle, params, runs)
    free = free_capacity(registry, bundle)
    e2e = moe_end_to_end(torch, ops, bundle, params, prompts[0], free)
    t_bind = time.perf_counter() - t_start

    # capacity free: the per-token equalities
    fb, fp, fargs, fruns = serving_runs(torch, ops, serve, QWEN2_MOE,
                                        gen=64, built=(free, params))
    free_shares = drop_shares(torch, free, params, prompts)
    assert max(free_shares.values()) == 0.0, free_shares
    splits = {}
    for label, b in (("published", bundle), ("capacity-free", free)):
        splits[label] = split_invariance(torch, b, params, prompts[0])
        print(f"phase 5: {QWEN2_MOE} {label} (capacity_factor "
              f"{b.cfg.moe.capacity_factor:g}), layer 0's MoE over request "
              f"0's {prompts[0].shape[1]} rows dispatched in pieces against "
              f"one dispatch: " + "; ".join(
                  f"{rows}-row pieces: {flip} tokens with other expert "
                  f"choices, {moved} with the same choices whose output "
                  f"moved (> {MOVED_REL} of its norm), the rest within "
                  f"{worst:.3e}" for rows, (flip, moved, worst)
                  in splits[label].items()))
    for rows, (_, moved, worst) in splits["capacity-free"].items():
        assert moved == 0 and worst <= MOVED_REL, (rows, moved, worst)
    # the contrast: under binding capacity a token's output does depend on
    # how the rows were dispatched
    assert all(moved > 0 for _, moved, _ in splits["published"].values())
    diffs = {label: mono_chunked_logits(b, params, prompts)
             for label, b in (("published", bundle), ("capacity-free",
                                                      free))}
    print(f"phase 5: {QWEN2_MOE} first-token logits, monolithic vs chunked "
          f"prefill (flash_attention against flash_prefill_chunk, one "
          f"dispatch against chunks of 512 / 256): max |diff| "
          + ", ".join(f"{k} {v:.4e}" for k, v in diffs.items())
          + " (reported: bf16 rounding moves router near-ties through the "
            "24 layers, see the expert choices above; 5b holds them in "
            "f32)")
    for uid in sorted(fruns["monolithic"][1]):
        a, b = fruns["monolithic"][1][uid], fruns["chunked"][1][uid]
        n = int(np.argmin(a == b)) if not (a == b).all() else a.size
        print(f"  capacity-free request {uid}: monolithic vs chunked "
              f"token-match prefix {n}/{a.size}")
    shared = shared_prefix_runs(torch, ops, serve, fb, params, pairs=1)
    faulted = fault_phase(torch, ops, serve, fb, params, fruns)
    ttft = {mode: sorted(run[0].stats["ttft_s"].values())
            for mode, run in runs.items()}
    tok_s = {mode: sum(o.size for o in run[1].values()) / run[2]
             for mode, run in runs.items()}
    print(f"phase 4: {QWEN2_MOE} summary ({smi}): "
          + "; ".join(f"{mode} {tok_s[mode]:.1f} tok/s, TTFT ms "
                      f"{[round(1e3 * t, 1) for t in ttft[mode]]}"
                      for mode in runs)
          + f"; captured greedy decode step {wbusy['captured'][0]:.3f} ms "
            f"device, {statistics.median(window['captured']):.3f} ms wall; "
            f"4c " + ", ".join(
                f"{mode} {kind} {res[kind][0][0]:.1f} tok/s"
                for mode, res in pairs.items() for kind in res)
          + "; sampled mix " + ", ".join(f"{mode} {r[0]:.1f} tok/s"
                                         for mode, r in mixed.items())
          + "; dropped " + ", ".join(f"{k} {100 * v:.2f}%"
                                     for k, v in shares.items())
          + "; expert choices equal to the plain path's " + ", ".join(
              f"{label} {100 * a['kernel']:.3f}% (control "
              f"{100 * a['control']:.3f}%)" for label, (_, a) in e2e.items())
          + f"; binding phases {t_bind:.1f} s, phases 4-5 in "
            f"{time.perf_counter() - t_start:.1f} s")
    counts = ([run[3] for run in runs.values()] + counts4d + counts4e
              + [run[3] for run in fruns.values()] + shared + faulted)
    # the engines hold their graphs in reference cycles: collect them, so
    # that the bf16 weights leave the card as the f32 copy is made
    del runs, fruns, fp
    gc.collect()
    torch.cuda.empty_cache()
    moe_f32_check(torch, bundle, free, params, prompts)
    del bundle, params, free, fb
    torch.cuda.empty_cache()
    return [{f"{k}_moe": v for k, v in c.items()} for c in counts]


def moe30b_phase(torch, ops, serve, smi):
    """qwen3-moe-30b-a3b (32 / 4 heads, G = 8, qk_norm, 128 experts top
    8, no shared experts) at full width and 24 of its 48 layers (29.0
    GiB of bf16 weights), with every other model freed first: one greedy
    wave of 4 requests of 512 tokens and 32 new tokens, monolithic and
    chunked (4), and one 16-step decode window of the captured step with
    its device time by op (4c).  The same requests eager against captured
    are cut, and the depth is cut to 24 layers, to hold the smoke's time
    (qwen2-moe holds captured = eager; these checks do not depend on
    depth).  Returns the launch counts of the captured runs, each
    kernel's count under ``<kernel>_moe30b``."""
    from repro_torch.models import registry
    t_start = time.perf_counter()
    collect_for(torch, QWEN3_MOE)
    cfg = dataclasses.replace(registry.config(QWEN3_MOE), n_layers=24)
    model = registry.build_model(cfg, device="cuda")
    built = (registry.Bundle(name=QWEN3_MOE, cfg=cfg, model=model),
             model.init(0))
    bundle, params, args, runs = serving_runs(torch, ops, serve, QWEN3_MOE,
                                              gen=32, built=built)
    del built
    window, wbusy = decode_window(torch, serve, bundle, params, pairs=1,
                                  steps=16, same=False,
                                  kinds={"captured": []})
    tok_s = {mode: sum(o.size for o in run[1].values()) / run[2]
             for mode, run in runs.items()}
    print(f"phase 4: {QWEN3_MOE} summary ({smi}): " + "; ".join(
        f"{mode} {tok_s[mode]:.1f} tok/s, {1e3 * run[2] / run[0].stats['decode_steps']:.2f}"
        f" ms wall a decode step incl. prefill" for mode, run in runs.items())
        + f"; captured greedy decode step {wbusy['captured'][0]:.3f} ms "
          f"device, {window['captured'][0]:.3f} ms wall; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase "
          f"in {time.perf_counter() - t_start:.1f} s")
    counts = [run[3] for run in runs.values()]
    del bundle, params, runs
    torch.cuda.empty_cache()
    return [{f"{k}_moe30b": v for k, v in c.items()} for c in counts]


def vlm_encdec_kernel_checks(torch, ops, llava, whisper):
    """Phase 3g: the attention kernels at the new shapes of the vlm and
    encdec paths, bf16.  llava-next-34b (56 / 8 heads, G = 7, hd 128):
    flash_attention causal at its prefills, S = 576 patch rows + 1024 /
    768 text tokens, the planted fault one patch row fewer (key 0
    dropped); flash_decode over 4 slots of its arena (lengths prompt +
    64 new tokens, the shorter one's, parked, 1), bf16 and int8, the
    faults lengths + 1 and V scaled by K's scales.  whisper-large-v3 (MHA
    20 / 20, hd 64): flash_attention non-causal over the encoder's S =
    1500 (not a multiple of the 64-key strip) and the cross-attention
    prefill, Sq = 224 / 160 against Sk = 1500; flash_decode over all 1500
    cross rows of 4 slots (``lengths=None``); the planted fault the last
    ragged key strip dropped.  Each against its plain version within the
    phase 3 limit, each fault rejected by more than FAULT_MARGIN; kernel /
    plain / SDPA times and the bound.  Returns {``<kernel>_vlm``,
    ``<kernel>_whisper``: record}."""
    from repro_torch.core import kv_format as kvf
    from repro_torch.kernels import flash_attention, flash_decode
    P = ops.PLAIN
    dev = "cuda"
    gen_ = torch.Generator(device=dev).manual_seed(28)

    def rn(*shape):
        return torch.randn(shape, generator=gen_, device=dev).to(
            torch.bfloat16)

    def rotation(sets):
        """The next of ``sets`` at each call: timed calls read operands
        that are not in L2."""
        i = [0]

        def nxt():
            i[0] = (i[0] + 1) % len(sets)
            return sets[i[0]]
        return nxt

    rec = {}
    # -- llava-next-34b ------------------------------------------------------
    h, kvh, d = llava.n_heads, llava.n_kv_heads, llava.hd
    g, npatch = h // kvh, llava.n_patch_tokens
    prompts = (npatch + 1024, npatch + 768)
    print(f"phase 3g: {llava.name} full width bf16 (H={h}, KVH={kvh}, G={g},"
          f" D={d}; prompts {list(prompts)} = {npatch} patch rows + 1024 / "
          f"768 tokens)")
    errs = []
    for s in prompts:
        q, k, v = rn(1, h, s, d), rn(1, kvh, s, d), rn(1, kvh, s, d)
        errs.append(check(
            f"flash_attention S={s} G={g}", ops.attention(q, k, v),
            P.attention(q, k, v), "bfloat16", "(causal)",
            fault=("one patch row fewer: key 0 dropped",
                   P.attention(q, k[:, :, 1:], v[:, :, 1:]))))
    s = max(prompts)
    sets = [(rn(1, h, s, d), rn(1, kvh, s, d), rn(1, kvh, s, d))
            for _ in range(3)]
    nset = rotation(sets)
    rec["flash_attention_vlm"] = dict(
        module=flash_attention, label=f"fa vlm S={s}", max_abs_err=max(errs),
        ms=timed(lambda: flash_attention.launch(*nset()), 20),
        plain_ms=timed(lambda: P.attention(*nset()), 3),
        library_ms=timed(lambda: sdpa(*nset(), is_causal=True), 20),
        cost=flash_attention.cost(*sets[0]))
    del sets
    del nset

    slots, smax, nl = 4, s + 64 + 1, 8
    arena_k, arena_v = rn(nl, slots, smax, kvh, d), rn(nl, slots, smax,
                                                        kvh, d)
    q = rn(slots, h, d)
    lens = torch.tensor([prompts[0] + 64, prompts[1] + 64, PARKED_POS + 1,
                         1], device=dev)
    bad_lens = lens + torch.tensor([1, 1, 0, 0], device=dev)
    err = check(f"flash_decode G={g}",
                ops.flash_decode(q, arena_k[0], arena_v[0], lengths=lens),
                P.flash_decode(q, arena_k[0], arena_v[0], lengths=lens),
                "bfloat16", f"(lengths {lens[0].item()}/{lens[1].item()}/"
                            f"parked/1)",
                fault=("lengths + 1 in the two long rows",
                       P.flash_decode(q, arena_k[0], arena_v[0],
                                      lengths=bad_lens)))
    torch.cuda.synchronize()
    assert int(flash_decode.counters(q.device, slots * kvh)[
        :slots * kvh].abs().sum()) == 0
    layer = rotation(list(range(nl)))
    kpos = torch.arange(smax, device=dev)
    mask = (kpos[None] < lens[:, None])[:, None, None, :]

    def kernel():
        i = layer()
        return flash_decode.launch(q, arena_k[i], arena_v[i], lens)

    def plain():
        i = layer()
        return P.flash_decode(q, arena_k[i], arena_v[i], lengths=lens)

    def library():
        i = layer()
        return sdpa(q[:, :, None], arena_k[i].transpose(1, 2),
                    arena_v[i].transpose(1, 2), attn_mask=mask)

    ms, plain_ms, lib_ms = (timed(kernel, 50), timed(plain, 5),
                            timed(library, 20))
    # int8 arena: the scaled branch at G = 7
    (kq, ks), (vq, vs) = (kvf.quantize(kvf.get("int8"), t.float())
                          for t in (arena_k, arena_v))
    check(f"flash_decode G={g} bf16/int8",
          ops.flash_decode(q, kq[0], vq[0], lengths=lens, k_scale=ks[0],
                           v_scale=vs[0]),
          P.flash_decode(q, kq[0], vq[0], lengths=lens, k_scale=ks[0],
                         v_scale=vs[0]), "bfloat16", "",
          fault=("V scaled by K's scales",
                 P.flash_decode(q, kq[0], vq[0], lengths=lens,
                                k_scale=ks[0], v_scale=ks[0])))

    def kernel_int8():
        i = layer()
        return flash_decode.launch(q, kq[i], vq[i], lens, k_scale=ks[i],
                                   v_scale=vs[i])

    i8_ms = timed(kernel_int8, 50)
    print(f"  flash_decode G={g} int8 arena: {i8_ms:.4f} ms against "
          f"{ms:.4f} ms over the bf16 arena")
    rec["flash_decode_vlm"] = dict(
        module=flash_decode, label=f"fd vlm G={g}", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, int8_ms=i8_ms,
        cost=flash_decode.cost(q, arena_k[0], lens))
    del arena_k, arena_v, kq, vq, ks, vs

    # -- whisper-large-v3 ----------------------------------------------------
    h, kvh, d, se = whisper.n_heads, whisper.n_kv_heads, whisper.hd, \
        whisper.enc_seq
    full = se // 64 * 64
    strip = ("the last ragged key strip dropped (keys "
             f"{full}-{se - 1})")
    print(f"phase 3g: {whisper.name} full width bf16 (H={h}, KVH={kvh}, "
          f"D={d}; encoder S={se}, prompts 224 / 160)")
    q, k, v = rn(1, h, se, d), rn(1, kvh, se, d), rn(1, kvh, se, d)
    errs = [check(f"flash_attention encoder S={se}",
                  ops.attention(q, k, v, causal=False),
                  P.attention(q, k, v, causal=False), "bfloat16",
                  "(non-causal)",
                  fault=(strip, P.attention(q, k[:, :, :full],
                                            v[:, :, :full], causal=False)))]
    cross_ms = {}
    for sq in (224, 160):
        qc = rn(1, h, sq, d)
        errs.append(check(
            f"flash_attention cross Sq={sq} Sk={se}",
            ops.attention(qc, k, v, causal=False),
            P.attention(qc, k, v, causal=False), "bfloat16",
            "(non-causal)",
            fault=(strip, P.attention(qc, k[:, :, :full], v[:, :, :full],
                                      causal=False))))
        cross_ms[sq] = (timed(lambda: flash_attention.launch(
                            qc, k, v, causal=False), 20),
                        timed(lambda: sdpa(qc, k, v), 20))
    print("  cross prefill (K/V L2-resident): " + ", ".join(
        f"Sq={sq} kernel {a:.4f} ms, SDPA {b:.4f} ms"
        for sq, (a, b) in cross_ms.items()))
    sets = [(rn(1, h, se, d), rn(1, kvh, se, d), rn(1, kvh, se, d))
            for _ in range(3)]
    nset = rotation(sets)
    rec["flash_attention_whisper"] = dict(
        module=flash_attention, label=f"fa whisper S={se}",
        max_abs_err=max(errs),
        ms=timed(lambda: flash_attention.launch(*nset(), causal=False), 20),
        plain_ms=timed(lambda: P.attention(*nset(), causal=False), 3),
        library_ms=timed(lambda: sdpa(*nset()), 20),
        cost=flash_attention.cost(*sets[0], causal=False), cross_ms=cross_ms)
    del nset, sets

    ck, cv = rn(nl, slots, se, kvh, d), rn(nl, slots, se, kvh, d)
    q = rn(slots, h, d)
    short = torch.full((slots,), full, device=dev)
    err = check("flash_decode cross, lengths=None",
                ops.flash_decode(q, ck[0], cv[0]),
                P.flash_decode(q, ck[0], cv[0]), "bfloat16",
                f"({slots} slots x {se} rows)",
                fault=(strip, P.flash_decode(q, ck[0], cv[0],
                                             lengths=short)))
    torch.cuda.synchronize()
    assert int(flash_decode.counters(q.device, slots * kvh)[
        :slots * kvh].abs().sum()) == 0

    def cross_kernel():
        i = layer()
        return flash_decode.launch(q, ck[i], cv[i], None)

    def cross_plain():
        i = layer()
        return P.flash_decode(q, ck[i], cv[i])

    def cross_library():
        i = layer()
        return sdpa(q[:, :, None], ck[i].transpose(1, 2),
                    cv[i].transpose(1, 2))

    rec["flash_decode_whisper"] = dict(
        module=flash_decode, label="fd whisper cross", max_abs_err=err,
        ms=timed(cross_kernel, 50), plain_ms=timed(cross_plain, 5),
        library_ms=timed(cross_library, 20),
        cost=flash_decode.cost(q, ck[0]))
    del ck, cv
    return rec


def sdpa_kops(P):
    """The plain namespace with PyTorch's ``scaled_dot_product_attention``
    for the attention op: another rounding of the same attention, the
    control of phase 5."""
    import types
    import torch.nn.functional as F

    def sdpa_attention(q, k, v, *, causal=True, window=None, **_):
        assert window is None
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=k.shape[-3] != q.shape[-3])

    return types.SimpleNamespace(**{**vars(P), "attention": sdpa_attention})


def first_request(torch, serve, bundle, args):
    """Request 0 of ``args``'s run as device tensors: its prompt (1, S)
    and its extras, batched."""
    req = serve.requests(args, bundle.cfg.vocab, cfg=bundle.cfg)[0]
    return (torch.as_tensor(req.prompt, device="cuda")[None],
            {k: torch.as_tensor(v, device="cuda")[None]
             for k, v in (req.extras or {}).items()})


def extras_logits(model, params, prompt, extras, rows):
    """``model``'s prefill logits (V,) for ``prompt`` with ``extras``, into
    a one-slot arena of ``rows`` rows."""
    return model.prefill(params, prompt, model.init_cache(1, rows),
                         **extras)[0]


def vlm_end_to_end(torch, ops, serve, bundle, params, args, runs):
    """Phase 5 (vlm): request 0's prefill logits (its 576 patch rows, then
    its 1024 tokens) through the kernels against the plain path, beside a
    control (the plain path with SDPA attention).  Held: the kernel path
    no farther from the plain path than LOGIT_TOL or the control,
    whichever is larger; the plain path with the patch prefix moved one
    row later (row 0 zero, the last row dropped: the planted fault) farther
    than FAULT_MARGIN times that limit; the served stream's first token
    the kernel path's argmax."""
    from repro_torch.models import registry
    P = ops.PLAIN
    cfg = bundle.cfg
    prompt, extras = first_request(torch, serve, bundle, args)
    patches = extras["patch_embeds"]
    rows = prompt.shape[1] + patches.shape[1] + 1
    logits = {"kernel": extras_logits(bundle.model, params, prompt, extras,
                                      rows)}
    for name, kops in (("plain", P), ("control", sdpa_kops(P))):
        m = registry.build_model(cfg, device="cuda", kernels=kops)
        logits[name] = extras_logits(m, params, prompt, extras, rows)
    shifted = torch.cat([torch.zeros_like(patches[:, :1]),
                         patches[:, :-1]], 1)
    logits["fault"] = extras_logits(m, params, prompt,
                                    {"patch_embeds": shifted}, rows)
    diff = {k: (logits[k] - logits["plain"]).abs().max().item()
            for k in ("kernel", "control", "fault")}
    limit = max(LOGIT_TOL, diff["control"])
    tok = int(torch.argmax(logits["kernel"]))
    top2 = torch.topk(logits["plain"], 2).values
    print(f"phase 5: {bundle.name} request 0 prefill logits "
          f"({patches.shape[1]} patch rows + {prompt.shape[1]} tokens) against the plain path: "
          f"kernel max |diff| {diff['kernel']:.4e}, control (SDPA attention) "
          f"{diff['control']:.4e}, limit {limit:.4e} (logits std "
          f"{logits['plain'].std().item():.4f}); argmax {tok} vs "
          f"{int(torch.argmax(logits['plain']))}, plain top-2 gap "
          f"{(top2[0] - top2[1]).item():.4e}; planted fault (the patch "
          f"prefix one row later) {diff['fault']:.4e} = "
          f"{diff['fault'] / limit:.1f}x the limit")
    assert logits["kernel"].shape == (cfg.vocab,)
    assert bool(torch.isfinite(logits["kernel"]).all())
    assert diff["kernel"] <= limit, diff
    assert diff["fault"] > FAULT_MARGIN * limit, diff
    assert int(runs["monolithic"][1][0][0]) == tok


def encdec_end_to_end(torch, ops, serve, bundle, params, args, runs):
    """Phase 5 (encdec): request 0's prefill logits (its 1500 frames, then
    its 224 tokens), kernel path against plain path in bf16 (reported: 32
    + 32 random-weight layers carry one-ulp bf16 flips, as mamba2's and
    hymba's do), then (5b) with f32 params and activations through all 64
    layers, held to WHISPER_F32_LOGIT_TOL; the plain path with the encoder
    run causal (the planted fault) must exceed it by more than
    FAULT_MARGIN.  The served stream's first token is the bf16 kernel
    path's argmax."""
    import types
    from repro_torch.models import registry
    P = ops.PLAIN
    cfg = bundle.cfg
    prompt, extras = first_request(torch, serve, bundle, args)
    rows = prompt.shape[1] + 1
    plain = registry.build_model(cfg, device="cuda", kernels=P)
    k16 = extras_logits(bundle.model, params, prompt, extras, rows)
    p16 = extras_logits(plain, params, prompt, extras, rows)
    d16 = (k16 - p16).abs().max().item()
    tok = int(torch.argmax(k16))
    print(f"phase 5: {bundle.name} request 0 prefill logits ({cfg.enc_seq} "
          f"frames, {prompt.shape[1]} tokens), bf16, kernel vs plain path: "
          f"max |diff| {d16:.4e} (reported; 5b holds f32; logits std "
          f"{p16.std().item():.4f}); argmax {tok} vs "
          f"{int(torch.argmax(p16))}")
    assert bool(torch.isfinite(k16).all()) and k16.shape == (cfg.vocab,)
    assert int(runs["monolithic"][1][0][0]) == tok
    del plain, k16, p16

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    def causal_encoder(q, k, v, *, causal=True, **kw):
        return P.attention(q, k, v, causal=True, **kw)

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    p32 = f32(params)
    logits = {}
    for name, kops in (("kernel", ops), ("plain", P), ("fault", P)):
        model = registry.build_model(cfg32, device="cuda", kernels=kops)
        if name == "fault":
            enc = registry.build_model(cfg32, device="cuda",
                                       kernels=types.SimpleNamespace(
                                           **{**vars(P),
                                              "attention": causal_encoder}))
            model.encode = enc.encode
        logits[name] = extras_logits(model, p32, prompt, extras, rows)
    del p32
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    f_diff = (logits["fault"] - logits["plain"]).abs().max().item()
    tol = WHISPER_F32_LOGIT_TOL
    print(f"phase 5b: {bundle.name} f32 request 0 prefill logits, kernel vs "
          f"plain path through {cfg.n_enc_layers} + {cfg.n_layers} layers: "
          f"max |diff| = {diff:.4e} (tol {tol}; logits std "
          f"{logits['plain'].std().item():.4f}); planted fault (the encoder "
          f"run causal): {f_diff:.4e}, {f_diff / tol:.1f} of the limit")
    assert bool(torch.isfinite(logits["kernel"]).all())
    assert diff <= tol, diff
    assert f_diff > FAULT_MARGIN * tol, f_diff


def family_summary(name, smi, runs, window, wbusy, params, mixed, t_start):
    """Phase 4's summary line of the vlm and encdec phases: tok/s and TTFT
    of the captured run, the captured decode step's device and wall ms
    beside the read time at the HBM rate of the weights a decode step
    reads (every weight but the tables it reads a row of, ``embed`` and
    ``pos_embed``, and the encoder's), the sampled mix's tok/s."""
    eng, out, dt, _ = runs["monolithic"]
    ttft = sorted(eng.stats["ttft_s"].values())
    weights = sum(t.numel() * t.element_size() for key, tree in
                  params.items() if key not in ("embed", "pos_embed",
                                                "enc_layers", "enc_norm")
                  for t in _leaves({key: tree}))
    from repro_torch.core import roofline
    floor = 1e3 * weights / roofline.HBM_BW
    print(f"phase 4: {name} summary ({smi}): monolithic "
          f"{sum(o.size for o in out.values()) / dt:.1f} tok/s, TTFT ms "
          f"{[round(1e3 * t, 1) for t in ttft]}; captured greedy decode "
          f"step {wbusy['captured'][0]:.3f} ms device, "
          f"{statistics.median(window['captured']):.3f} ms wall, weight "
          f"read floor {floor:.3f} ms (the {weights / 2 ** 30:.2f} GiB a "
          f"decode step reads, at "
          f"{roofline.HBM_BW / 1e12:.2f} TB/s); sampled mix "
          + ", ".join(f"{mode} {r[0]:.1f} tok/s" for mode, r in mixed.items())
          + f"; phases 4-5 in {time.perf_counter() - t_start:.1f} s")


def collect_for(torch, name):
    """Collect the engines of the earlier phases (they hold their graphs
    in reference cycles), so their weights and pools leave the card before
    ``name``'s weights are made."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"phase 4: {name}: {held / 1e9:.2f} GB still allocated on the "
          f"card before its weights")
    assert held < 4e9, held


def vlm_phase(torch, ops, serve, smi):
    """Phases 4 and 5 for llava-next-34b (the vlm family: a dense LM whose
    prompts follow 576 patch rows) at full width, 64.05 GiB of random bf16
    weights, every other model collected first: 4 requests of 1024 / 768
    tokens after their patch rows, 64 new tokens, 4 slots, depth 2,
    monolithic prefill (the reference refuses chunked prefill with patch
    rows).  Served captured (4), one eager-vs-captured pair and a 16-step
    decode window of the captured step (4c), half the requests sampled,
    captured = eager (4d), the int8 arena (4e), the fixed fault plan (4h)
    and request 0's logits (5).  Returns the launch counts of its
    main-path runs, each kernel's count under ``<kernel>_vlm``."""
    import gc
    t_start = time.perf_counter()
    collect_for(torch, LLAVA)
    mono = ("monolithic",)
    bundle, params, args, runs = serving_runs(torch, ops, serve, LLAVA,
                                              gen=64, modes=mono)
    eager_vs_captured(serve, bundle, params, runs, gen=64, pairs=1,
                      modes=mono)
    window, wbusy = decode_window(torch, serve, bundle, params, pairs=1,
                                  steps=16, same=False,
                                  kinds={"captured": []})
    mixed, counts4d = sampled_runs(torch, ops, serve, bundle, params, runs,
                                   modes=mono)
    counts4e = int8_runs(torch, ops, serve, bundle, params, runs,
                         modes=mono)
    faulted = fault_phase(torch, ops, serve, bundle, params, runs,
                          mode="monolithic")
    vlm_end_to_end(torch, ops, serve, bundle, params, args, runs)
    family_summary(LLAVA, smi, runs, window, wbusy, params, mixed, t_start)
    counts = [run[3] for run in runs.values()] + counts4d + counts4e \
        + faulted
    del bundle, params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return [{f"{k}_vlm": v for k, v in c.items()} for c in counts]


def encdec_phase(torch, ops, serve, smi):
    """Phases 4 and 5 for whisper-large-v3 (the encdec family: an encoder
    over 1500 frames, a decoder with cross-attention) at full width,
    random bf16 weights: 4 requests of 1500 random frames each and
    prompts of 224 / 160 tokens, 64 new tokens, 4 slots, depth 2,
    monolithic prefill (the reference refuses chunked prefill for the
    family).  Served captured (4), one eager-vs-captured pair and a
    16-step decode window of the captured step (4c), half the requests
    sampled, captured = eager (4d), the fixed fault plan (4h: the poison
    fills the self and cross leaves), 8 requests over 2 replicas behind
    the router against one engine, and request 0's logits (5, 5b in f32).
    Returns the launch counts of its main-path runs, each kernel's count
    under ``<kernel>_whisper``."""
    import gc
    t_start = time.perf_counter()
    collect_for(torch, WHISPER)
    mono = ("monolithic",)
    bundle, params, args, runs = serving_runs(torch, ops, serve, WHISPER,
                                              gen=64, modes=mono)
    eager_vs_captured(serve, bundle, params, runs, gen=64, pairs=1,
                      modes=mono)
    window, wbusy = decode_window(torch, serve, bundle, params, pairs=1,
                                  steps=16, same=False,
                                  kinds={"captured": []})
    mixed, counts4d = sampled_runs(torch, ops, serve, bundle, params, runs,
                                   modes=mono)
    faulted = fault_phase(torch, ops, serve, bundle, params, runs,
                          mode="monolithic")
    eight = (["--arch", WHISPER, "--gen", "64"] + serve_args(WHISPER)
             + ["--requests", "8"])
    one, want, one_dt = serve.serve(bundle, params, serve.parse_args(eight))
    del one
    ops.reset_launch_counts()
    fleet, got, dt = serve.serve_fleet(bundle, params, serve.parse_args(
        eight + ["--replicas", "2"]))
    fleet_counts = ops.launch_counts()
    assert same_streams(got, want), "2 replicas != one engine"
    assert all(r.engine.params is params for r in fleet.replicas.values())
    print(f"phase 4h: {WHISPER} 2 replicas (least-pressure), 8 requests: "
          f"{sum(o.size for o in got.values()) / dt:.1f} tok/s (one 4-slot "
          f"engine {sum(o.size for o in want.values()) / one_dt:.1f}); "
          f"placed {fleet.stats['placed']}; streams equal one engine's")
    del fleet
    encdec_end_to_end(torch, ops, serve, bundle, params, args, runs)
    family_summary(WHISPER, smi, runs, window, wbusy, params, mixed,
                   t_start)
    counts = [run[3] for run in runs.values()] + counts4d + faulted \
        + [fleet_counts]
    del bundle, params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return [{f"{k}_whisper": v for k, v in c.items()} for c in counts]


def vector_unit_phase(torch, ops):
    """Phase 6: the vector-unit path (fmatmul, dot product, fconv2d and the
    core modules).  6a drives it on the card at the paper's sweep sizes
    (``configs/ara_vu.py``, ``benchmarks/bench_*.py``) with the launch
    counts set to 0 just before and read just after; 6b holds every kernel
    result against its plain version there, at the ragged shapes of
    ``tests/test_kernels.py`` and at card shapes, each with its planted
    fault, checks that dotp and conv2d (f32 and bf16 at the card shape)
    repeat bit for bit, and times kernel, plain version and library call
    (conv2d also in bf16 and at the sweep's 112 x 112 x 3 -> 8 shape,
    printed beside the JSON's f32 row); 6c compares the core modules' CUDA results
    with their CPU results, exactly.  Returns ({kernel name: record},
    the drive's launch counts)."""
    import torch.nn.functional as F
    from repro_torch.configs.ara_vu import CONFIG as VU
    from repro_torch.kernels import conv2d, dotp, matmul
    P = ops.PLAIN
    dev = "cuda"
    # the f32 plain versions and yardsticks in full f32, as main() sets
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(6)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # -- 6a: drive the path -------------------------------------------------
    print(f"phase 6a: vector-unit path on the card: matmul n^3 for n in "
          f"{VU.bench_matmul_sizes} + 512, dotp n = bench_vector_bytes / 4 "
          f"for {VU.bench_vector_bytes}, conv2d 7x7x3 -> 8 on hw in "
          f"(32, 64, 112); core modules over the Table II sweep")
    mm_in = [(rn(n, n), rn(n, n)) for n in VU.bench_matmul_sizes + (512,)]
    dp_in = [(rn(vb // 4), rn(vb // 4)) for vb in VU.bench_vector_bytes]
    cv_in = [(rn(1, hw, hw, 3), rn(7, 7, 3, 8)) for hw in (32, 64, 112)]
    core_in = core_inputs(torch, VU)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    mm_out = [ops.matmul(a, b) for a, b in mm_in]
    dp_out = [ops.dotp(a, b) for a, b in dp_in]
    cv_out = [ops.conv2d(x, w) for x, w in cv_in]
    core_out = core_run(torch, core_in, dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    want.update(matmul=len(mm_in), dotp=len(dp_in), conv2d=len(cv_in))
    print(f"  launches: {counts}")
    assert counts == want, (counts, want)
    for out, (a, b) in zip(mm_out, mm_in):
        assert out.shape == (a.shape[0], b.shape[1]), out.shape
    for out in dp_out:
        assert out.shape == () and out.dtype == torch.float32
    for out, (x, w) in zip(cv_out, cv_in):
        assert out.shape == (1, x.shape[1] - 6, x.shape[2] - 6, 8), out.shape
    for out in mm_out + dp_out + cv_out:
        assert bool(torch.isfinite(out).all())

    # -- 6b: kernel vs plain, faults, times ---------------------------------
    def mm_check(label, a, b, got=None):
        got = ops.matmul(a, b) if got is None else got
        kc = (a.shape[1] - 1) // matmul.BK * matmul.BK
        return check(f"matmul {label}", got, P.matmul(a, b),
                     names[a.dtype], bound=matmul.error_bound(a, b),
                     margin=FAULT_MARGIN,
                     fault=(f"last K tile, k >= {kc}, dropped",
                            P.matmul(a[:, :kc], b[:kc])))

    def dp_check(label, a, b, got=None):
        """Random signs against the plain version; then |a|, |b|, where
        sum |a_i b_i| is the result itself, so one partial dropped moves
        it by ~1/G of the limit's scale (with random signs a partial can
        cancel to nothing)."""
        got = ops.dotp(a, b) if got is None else got
        err = check(f"dotp {label}", got, P.dotp(a, b), "float32",
                    bound=dotp.error_bound(a, b))
        a, b = a.abs(), b.abs()
        length, g = dotp.split(a.shape[0])
        k = g // 2
        b_bad = b.clone()
        b_bad[k * length:(k + 1) * length] = 0
        return max(err, check(
            f"dotp {label} |a|.|b|", ops.dotp(a, b), P.dotp(a, b),
            "float32", bound=dotp.error_bound(a, b), margin=FAULT_MARGIN,
            fault=(f"partial {k} of {g} dropped", P.dotp(a, b_bad))))

    def cv_check(label, x, w, got=None):
        got = ops.conv2d(x, w) if got is None else got
        w_bad = w.clone()
        w_bad[-1, -1] = 0
        return check(f"conv2d {label}", got, P.conv2d(x, w), names[x.dtype],
                     bound=conv2d.error_bound(x, w), margin=FAULT_MARGIN,
                     fault=("tap (KH-1, KW-1) dropped", P.conv2d(x, w_bad)))

    errs = {"matmul": [], "dotp": [], "conv2d": []}
    print("phase 6b: the paper's sweep (6a's results)")
    for (a, b), out in zip(mm_in, mm_out):
        errs["matmul"].append(mm_check(f"{a.shape[0]}^3 f32", a, b, out))
    for (a, b), out in zip(dp_in, dp_out):
        errs["dotp"].append(dp_check(f"n={a.shape[0]} f32", a, b, out))
    for (x, w), out in zip(cv_in, cv_out):
        errs["conv2d"].append(cv_check(f"{tuple(x.shape)} x 7x7x3x8", x, w,
                                       out))
    print("phase 6b: ragged shapes")
    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"
        for m, k, n in ((257, 64, 33), (96, 130, 70), (1, 512, 1)):
            a, b = rn(m, k, dtype=dtype), rn(k, n, dtype=dtype)
            if dtype == torch.bfloat16:
                print(f"  matmul ({m}, {k}, {n}) bf16: the padding step "
                      f"copies {matmul.pad_operands(a, b)[2] or 'nothing'}")
            errs["matmul"].append(mm_check(f"({m}, {k}, {n}) {dn}", a, b))
        for n in (8, 100, 4097):
            errs["dotp"].append(dp_check(f"n={n} {dn}", rn(n, dtype=dtype),
                                         rn(n, dtype=dtype)))
    for xs, ws in (((2, 16, 16, 3), (7, 7, 3, 8)),
                   ((2, 32, 20, 4), (3, 3, 4, 4)),
                   ((2, 9, 9, 1), (7, 7, 1, 2))):
        errs["conv2d"].append(cv_check(f"{xs} x {ws} f32", rn(*xs),
                                       rn(*ws)))
    errs["conv2d"].append(cv_check(
        "(2, 16, 16, 3) x (7, 7, 3, 8) bf16",
        rn(2, 16, 16, 3, dtype=torch.bfloat16),
        rn(7, 7, 3, 8, dtype=torch.bfloat16)))
    try:
        ops.matmul(rn(4, 4), rn(4, 4, dtype=torch.bfloat16))
    except TypeError as e:
        print(f"  matmul refuses mixed operand dtypes: {e}")
    else:
        raise AssertionError("matmul took mixed operand dtypes")

    print("phase 6b: card shapes")
    rec = {}
    extra = []
    s = 4096
    for dtype in (torch.float32, torch.bfloat16):
        a, b = rn(s, s, dtype=dtype), rn(s, s, dtype=dtype)
        dn = names[dtype]
        got = ops.matmul(a, b)
        err = mm_check(f"{s}^3 {dn}", a, b, got)
        exact_check(f"matmul {s}^3 {dn}", got, P.matmul(a, b),
                    torch.matmul(a.double(), b.double()),
                    (matmul.error_bound_exact(a, b),
                     matmul.plain_bound_exact(a, b)))
        del got
        r = dict(module=matmul, label=f"matmul {dn}",
                 max_abs_err=max(errs["matmul"] + [err]),
                 ms=timed(lambda: matmul.launch(a, b), 10),
                 plain_ms=timed(lambda: P.matmul(a, b), 10),
                 library_ms=timed(lambda: torch.matmul(a, b), 10),
                 cost=matmul.cost(a, b))
        if dtype == torch.float32:
            rec["matmul"] = r
        else:
            extra.append(r)
        del a, b
    n = 1 << 26
    for dtype in (torch.float32, torch.bfloat16):
        a, b = rn(n, dtype=dtype), rn(n, dtype=dtype)
        dn = names[dtype]
        got = ops.dotp(a, b)
        err = dp_check(f"n=2^26 {dn}", a, b, got)
        exact_check(f"dotp n=2^26 {dn}", got, P.dotp(a, b),
                    (a.double() * b.double()).sum(),
                    (dotp.error_bound_exact(a, b),
                     dotp.plain_bound_exact(a, b)))
        r1, r2 = dotp.launch(a, b), dotp.launch(a.clone(), b.clone())
        same = bool(torch.equal(r1.reshape(1).view(torch.int32),
                                r2.reshape(1).view(torch.int32)))
        print(f"  dotp n=2^26 {dn}: two launches (the second on copies) "
              f"give the same bits: {same} ({r1.item()!r})")
        assert same, (r1.item(), r2.item())
        lib = (timed(lambda: torch.dot(a, b), 50)
               if dtype == torch.float32 else None)
        r = dict(module=dotp, label=f"dotp {dn}",
                 max_abs_err=max(errs["dotp"] + [err]),
                 ms=timed(lambda: dotp.launch(a, b), 50),
                 plain_ms=timed(lambda: P.dotp(a, b), 20), library_ms=lib,
                 cost=dotp.cost(a, b))
        if dtype == torch.float32:
            rec["dotp"] = r
        else:
            extra.append(r)
        del a, b
    def cv_rec(label, x, w, err, iters):
        """conv2d's record at x (N, H, W, Cin) x w: kernel, plain and
        F.conv2d (channels-last, cuDNN, no TF32: the yardstick) times."""
        x_cl = x.permute(0, 3, 1, 2)              # NCHW, channels-last
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return dict(
            module=conv2d, label=label, max_abs_err=err,
            ms=timed(lambda: conv2d.launch(x, w), iters),
            plain_ms=timed(lambda: P.conv2d(x, w), 3),
            library_ms=timed(lambda: F.conv2d(x_cl, w_cl), iters),
            cost=conv2d.cost(x, w))

    for dtype in (torch.float32, torch.bfloat16):
        dn = names[dtype]
        x, w = rn(64, 112, 112, 3, dtype=dtype), rn(7, 7, 3, 64, dtype=dtype)
        got = ops.conv2d(x, w)
        err = cv_check(f"(64, 112, 112, 3) x (7, 7, 3, 64) {dn}", x, w, got)
        again = conv2d.launch(x.clone(), w.clone())
        same = bool(torch.equal(got.view(torch.uint8),
                                again.view(torch.uint8)))
        print(f"  conv2d card shape {dn}: two launches (the second on "
              f"copies) give the same bits: {same}")
        assert same
        del got, again
        if dtype == torch.float32:
            x_cl = x.permute(0, 3, 1, 2)
            w_cl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_err = (F.conv2d(x_cl, w_cl).permute(0, 2, 3, 1)
                       - P.conv2d(x, w)).abs().max().item()
            print(f"  F.conv2d (channels-last, the yardstick) vs plain: "
                  f"max |diff| = {lib_err:.3e}")
            del x_cl, w_cl
            rec["conv2d"] = cv_rec("conv2d f32", x, w,
                                   max(errs["conv2d"] + [err]), 20)
        else:
            extra.append(cv_rec("conv2d bf16", x, w, err, 20))
        del x, w
    x, w = cv_in[-1]                      # the sweep's 112 x 112 x 3 -> 8
    extra.append(cv_rec("conv2d sweep 112", x, w, errs["conv2d"][2], 50))
    print("phase 6b: times (card shapes; bf16 rows beside the JSON's f32 "
          "ones)")
    for r in extra:
        bound(r)

    # -- 6c: the core modules, CUDA against CPU -------------------------------
    cpu_out = core_run(torch, core_in, "cpu")
    core_compare(torch, core_out, cpu_out)
    return rec, counts


def core_inputs(torch, VU):
    """Inputs of the core modules' run, made on the CPU from a seed: the
    Table II sweep (lanes x VL bytes x EEW) for lane_tree_reduce in int64
    and float32, integer-valued floats for the multiply-reduce and the
    strip-mined sum (every summation order gives the same exact result),
    VRF write sequences and mask bits."""
    import numpy as np
    rng = np.random.default_rng(7)
    red = []
    for lanes in VU.bench_lane_counts:
        for vlb in VU.bench_vector_bytes:
            for eew in VU.bench_eew_bytes:
                n = vlb // eew
                if n % (lanes * (8 // eew)):
                    continue
                red.append((lanes, eew, torch.from_numpy(
                    rng.integers(-100, 100, n)),
                    torch.from_numpy(rng.standard_normal(n).astype(
                        np.float32))))
    ints = rng.integers(-8, 9, (2, 4096)).astype(np.float32)
    writes = []
    for step in range(40):
        eew = int(rng.choice((1, 2, 4, 8)))
        vl = None if step % 5 == 0 else int(rng.integers(0, 512 // eew + 1))
        writes.append((int(rng.integers(0, 8)), eew, vl,
                       "agnostic_ones" if step % 7 == 3 else "undisturbed",
                       torch.from_numpy(rng.integers(0, 256, 512,
                                                     dtype=np.uint8))))
    bits = torch.from_numpy(rng.integers(0, 2, 4096) > 0)
    return dict(red=red, ints=torch.from_numpy(ints), writes=writes,
                bits=bits, stream=torch.from_numpy(
                    rng.integers(-50, 50, 5000).astype(np.float32)))


def core_run(torch, inp, dev):
    """The core modules on ``dev``: returns their results as CPU tensors
    (and the VRF's stats) for :func:`core_compare`."""
    from repro_torch.core import (chaining, masking, reduction, stripmine,
                                  vrf)
    out = {}
    for lanes, eew, xi, xf in inp["red"]:
        for op in ("add", "max", "min"):
            for kind, x in (("int", xi), ("f32", xf)):
                out[f"lane_tree_reduce {kind} lanes={lanes} eew={eew} {op}"] \
                    = reduction.lane_tree_reduce(x.to(dev), lanes=lanes,
                                                 eew_bytes=eew, op=op)
    ints = inp["ints"].to(dev)
    out["chained_mulreduce f32"] = chaining.chained_mulreduce(ints[0],
                                                              ints[1])
    bf = ints.to(torch.bfloat16)
    out["chained_mulreduce bf16"] = chaining.chained_mulreduce(bf[0], bf[1])

    def body(carry, strip, vl):
        keep = masking.tail_mask(strip.shape[0], vl)
        return carry + torch.where(keep, strip, 0.0).sum(), strip * 2.0 + vl

    x = inp["stream"].to(dev)
    carry, outs = stripmine.stripmine(body, torch.zeros((), device=dev), x,
                                      vlmax=512)
    out["stripmine carry"], out["stripmine outs"] = carry, outs
    out["stripmined_map"] = stripmine.stripmined_map(
        lambda s, vl: s * 3.0 - vl, x.reshape(50, 100), vlmax=16, axis=1)
    f = vrf.VectorRegisterFile(vlen_bits=4096, lanes=4, device=dev)
    for reg, eew, vl, policy, mem in inp["writes"]:
        f.write(reg, mem.to(dev), eew=eew, vl=vl, tail_policy=policy)
    for reg in range(8):
        out[f"vrf reg {reg}"] = f.regs[reg]
        out[f"vrf elements {reg} int32"] = f.elements(reg, torch.int32)
    out["vrf stats"] = dict(f.stats)
    bits = inp["bits"].to(dev)
    packed = masking.pack_bits(bits, bits.shape[0])
    out["pack_bits"] = packed
    out["unpack_bits"] = masking.unpack_bits(packed, bits.shape[0])
    for eew in (1, 2, 4, 8):
        lane = vrf.shuffle(packed, eew=eew, lanes=4)
        out[f"mask_unit eew={eew}"] = masking.mask_unit(
            lane, stored_eew=eew, lanes=4, num_elems=4096)
    out["predicated"] = masking.predicated(lambda v: v * 10.0)(
        x[:4096], ints[0], mask=bits)
    return {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def core_compare(torch, got, want):
    """Every core-module result on CUDA equals its CPU result: tensors bit
    for bit (dtype, shape, bytes), the VRF stats as dicts."""
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], want[k]
        if isinstance(g, dict):
            assert g == w, (k, g, w)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g, w)
        same = (torch.equal(g.reshape(-1).view(torch.uint8),
                            w.reshape(-1).view(torch.uint8))
                if g.dtype.is_floating_point else torch.equal(g, w))
        assert same, (k, g, w)
    print(f"phase 6c: {len(got)} core-module results (reduction, chaining, "
          f"stripmine, vrf, masking) on CUDA equal the CPU results bit for "
          f"bit; VRF stats {got['vrf stats']}")


# ---------------------------------------------------------------------------
# training (phases 3t, train_phase, 5t and the restart)
# ---------------------------------------------------------------------------

# The attention backward, kernel vs plain version, per element: one ulp of
# the output's type at the larger magnitude (each rounds its f32 result
# once) plus BWD_RTOL times the plain gradient's rms.  The kernel sums dK
# and dV over every query row of the G heads of a KV head, dQ over every
# key, in f32 in another order than the plain version's einsums, and the
# terms of dS = P (dP - delta) cancel, so an element near 0 carries the
# rounding of the whole sum: the rms term is its floor.  A planted fault
# (delta dropped: dS = P dP) must exceed the limit by more than
# FAULT_MARGIN.
BWD_RTOL = 1e-4
# The training shapes of phase 3t: (label, B, H, KVH, Sq, Sk, hd, causal,
# window).  llama3.2-3b's training step (train_phase's batch),
# whisper-large-v3's cross-attention (MHA, 224 decoder rows over 1500
# encoder rows, Sk not a multiple of the 64-key block), llava-next-34b's
# G = 7 over its 576 patch rows and 1024 tokens, hymba-1.5b's windowed
# layers at its training batch (G = 5, window 1024 at S 2048: past it).
TRAIN_SHAPES = (("llama3.2-3b", 4, 24, 8, 1024, 1024, 128, True, None),
                ("whisper cross", 4, 20, 20, 224, 1500, 64, False, None),
                ("llava G=7", 1, 56, 8, 1600, 1600, 128, True, None),
                ("hymba window", 2, 25, 5, 2048, 2048, 64, True, 1024))
# The SSD training shapes of phase 3t: (label, rows, B/C rows, S, P, N):
# mamba2-2.7b's and hymba-1.5b's layers at train_phase's batch 2 x 2048
# (80 and 50 heads a batch row, one B/C group).
SSD_TRAIN_SHAPES = (("mamba2-2.7b", 160, 2, 2048, 64, 128),
                    ("hymba-1.5b", 100, 2, 2048, 64, 16))
# train_phase's runs: (arch, batch, seq, launches a step per layer, the
# JSON rows their counts go to).  Each attention layer launches the
# forward twice (the forward and its remat recompute) and the backward
# once, each SSD layer ssd twice and ssd_bwd once.
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd")
TRAIN_RUNS = (
    ("llama3.2-3b", 4, 1024, {"flash_attention": 2, "flash_attention_bwd": 1},
     {"flash_attention": "flash_attention_train",
      "flash_attention_bwd": "flash_attention_bwd"}),
    ("mamba2-2.7b", 2, 2048, {"ssd": 2, "ssd_bwd": 1},
     {"ssd": "ssd_train", "ssd_bwd": "ssd_bwd"}),
    ("hymba-1.5b", 2, 2048, dict.fromkeys(TRAIN_KERNELS, 2)
     | {"flash_attention_bwd": 1, "ssd_bwd": 1},
     {"flash_attention": "flash_attention_train_hymba",
      "flash_attention_bwd": "flash_attention_bwd_hymba",
      "ssd": "ssd_train_hymba", "ssd_bwd": "ssd_bwd_hymba"}))
# the kernels named in train_phase's profile
TRAIN_PROFILED = ("fa_tc_kernel", "fab_tc_dkdv", "fab_tc_dq", "fab_delta",
                  "ssd_tc_kernel", "ssd_bwd_tc_states", "ssd_bwd_tc_chunk",
                  "ssd_bwd_states", "ssd_bwd_chunk", "ssd_bwd_reduce")


def train_args(arch, batch, seq):
    return ["--arch", arch, "--full", "--steps", "6", "--batch", str(batch),
            "--seq", str(seq), "--log-every", "1"]


# Phase 5t: one step's gradients, kernel path against plain path in f32,
# per leaf max |kernel - plain| / max |plain|, and the loss relative.  The
# first reading (NVIDIA H100 80GB HBM3, 700.00 W): gradients
# 4.8e-07 to 7.7e-07 (llama3.2-3b at full width and 2 layers, the
# reduced moe, vlm and encdec), losses 0 to 7.5e-08: f32 sums in another
# order, deterministic.  The limits leave ~13x; the planted fault (the
# plain backward non-causal) read 1.0, 1e5 x the gradient limit.
TRAIN_GRAD_TOL = 1e-5
TRAIN_LOSS_TOL = 1e-6


def bwd_excess(got, want):
    """max over elements of |got - want| / the backward's limit (see
    BWD_RTOL) over a tuple of gradients."""
    out = 0.0
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        lim = (ulp(g32.abs().maximum(w32.abs()), type_bits(g))
               + BWD_RTOL * w32.pow(2).mean().sqrt())
        out = max(out, ((g32 - w32).abs() / lim).max().item())
    return out


def train_kernel_checks(torch, ops):
    """Phase 3t: the backward kernel alone at the training shapes
    (TRAIN_SHAPES), against the plain backward within the limit, the
    planted fault (delta dropped) rejected by more than FAULT_MARGIN, two
    runs bit for bit, the forward's O with its LSE output on against off
    bit for bit; at llama3.2-3b's and hymba-1.5b's shapes the times
    (kernel, plain, SDPA's backward: forward plus backward less forward,
    with an explicit mask under hymba's window) and the bound, then the
    forward as training calls it (LSE on): O against the plain attention,
    the LSE against a plain masked logsumexp (LSE_TOL), the times and the
    bound.  Returns the records ``flash_attention_bwd``,
    ``flash_attention_bwd_hymba``, ``flash_attention_train`` and
    ``flash_attention_train_hymba``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    print("phase 3t: flash_attention_bwd at the training shapes (bf16)")
    for label, b, h, kvh, sq, sk, d, causal, window in TRAIN_SHAPES:
        def rn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        kw = dict(causal=causal, window=window)
        q = rn(b, sq, h, d).transpose(1, 2)
        k, v = rn(b, sk, kvh, d).transpose(1, 2), rn(b, sk, kvh, d) \
            .transpose(1, 2)
        o, lse = fa.launch(q, k, v, with_lse=True, **kw)
        same_o = torch.equal(o, fa.launch(q, k, v, **kw))
        g = rn(b, sq, h, d).transpose(1, 2)
        got = fab.launch(q, k, v, o, lse, g, **kw)
        again = fab.launch(q, k, v, o, lse, g, **kw)
        bits = all(torch.equal(x, y) for x, y in zip(got, again))
        want = ops._attention_bwd_plain(q, k, v, o, lse, g, scale=None, **kw)
        fault = ops._attention_bwd_plain(q, k, v, torch.zeros_like(o), lse,
                                         g, scale=None, **kw)
        ratio = bwd_excess(got, want)
        f_ratio = bwd_excess(got[:2], fault[:2])
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, want))
        print(f"  {label:<14} B={b} H={h}/{kvh} Sq={sq} Sk={sk} hd={d} "
              f"causal={causal} window={window}: max|kernel-plain| "
              f"{err:.3e}, {ratio:.3f} of the limit (1 ulp + "
              f"{BWD_RTOL:.0e} rms); planted fault (delta dropped) "
              f"{f_ratio:.1f} of the limit; two runs bit for bit {bits}; O "
              f"with LSE = O without, bit for bit {same_o}")
        assert ratio <= 1.0, (label, ratio)
        assert f_ratio > FAULT_MARGIN, (label, f_ratio)
        assert bits and same_o, (label, bits, same_o)
        if label not in ("llama3.2-3b", "hymba window"):
            continue
        name = ("flash_attention_bwd" if window is None
                else "flash_attention_bwd_hymba")
        ms = timed(lambda: fab.launch(q, k, v, o, lse, g, **kw), 5)
        plain_ms = timed(lambda: ops._attention_bwd_plain(
            q, k, v, o, lse, g, scale=None, **kw), 2)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        if window is None:
            lib = dict(is_causal=True)
        else:
            i = torch.arange(sq, device=dev)
            lib = dict(attn_mask=(i[None, :] <= i[:, None])
                       & (i[None, :] > i[:, None] - window))
        fwd_ms = timed(lambda: sdpa(qs, ks, vs, **lib), 10)
        both_ms = timed(lambda: torch.autograd.grad(
            sdpa(qs, ks, vs, **lib), (qs, ks, vs), g), 5)
        rec[name] = dict(
            module=fab, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=both_ms - fwd_ms,
            cost=fab.cost(q, k, v, o, lse, g, **kw), label=name)
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"SDPA backward {both_ms - fwd_ms:.4f} ms (forward + "
              f"backward {both_ms:.4f} less forward {fwd_ms:.4f})")
        f_name = "flash_attention_train" + name[len("flash_attention_bwd"):]
        f_ms = timed(lambda: fa.launch(q, k, v, with_lse=True, **kw), 20)
        f_plain = timed(lambda: ops.PLAIN.attention(q, k, v, **kw), 3)
        f_err = check(f"{f_name} O", o, ops.PLAIN.attention(q, k, v, **kw),
                      "bfloat16", "(LSE on)")
        fault = (dict(causal=True) if window is not None
                 else dict(causal=False))
        check(f"{f_name} LSE", lse, plain_lse(torch, q, k, **kw), "float32",
              fault=("the " + ("window" if window else "causal mask")
                     + " dropped", plain_lse(torch, q, k, **fault)),
              margin=FAULT_MARGIN)
        rec[f_name] = dict(
            module=fa, max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
            library_ms=fwd_ms, cost=fa.cost(q, k, v, with_lse=True, **kw),
            label=f_name)
        print(f"  {label}: forward with LSE {f_ms:.4f} ms, plain "
              f"{f_plain:.3f} ms")
    return rec


def plain_lse(torch, q, k, *, causal=True, window=None):
    """The (B, H, Sq) row log-sum-exp of the scaled scores under the causal
    / window mask, K expanded to q's heads, in float64 and returned in f32:
    the plain counterpart of the forward kernel's LSE output.  It is held
    to F32_TOL absolute: the kernel's LSE (~4-8 at the training shapes) is
    the log of an f32 sum of ex2.approx terms over up to 2048 keys, whose
    relative error, a few f32 ulps, is the LSE's absolute error."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double() * d ** -0.5,
                     k.double().repeat_interleave(g, dim=1))
    i = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")),
                           dim=-1).float()


def ssd_carry_dropped(torch, ops, x, la, B, C, dy):
    """The plain backward with the state gradient not carried between
    64-token chunks (each chunk from its true start state): the planted
    fault of the SSD backward checks."""
    parts, state = [], None
    for t0 in range(0, x.shape[1], 64):
        sl = slice(t0, t0 + 64)
        args = (x[:, sl], la[:, sl], B[:, sl], C[:, sl])
        parts.append(ops._ssd_bwd_plain(*args, dy[:, sl], chunk=64,
                                        initial_state=state))
        state = ops.PLAIN.ssd(*args, chunk=64, initial_state=state)[1]
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))


def ssd_train_checks(torch, ops):
    """Phase 3t, SSD: the ssd_bwd kernel at the training shapes
    (SSD_TRAIN_SHAPES, bf16) against ``ops._ssd_bwd_plain`` within the
    backward's limit (BWD_RTOL), the planted fault (the state gradient not
    carried between chunks) rejected by more than FAULT_MARGIN, two runs
    bit for bit, the kernel's and the plain version's times and the bound,
    and its three kernels' device times apart (torch.profiler); then the
    ssd forward at the same shapes against its plain version.
    Returns the records ``ssd_bwd``, ``ssd_bwd_hymba``, ``ssd_train`` and
    ``ssd_train_hymba``."""
    from repro_torch.kernels import ssd, ssd_bwd, ssd_bwd_parts
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)
    rec = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("phase 3t: ssd_bwd at the training shapes (bf16, B 2 x S 2048)")
    for label, bh, nb, s, p, n in SSD_TRAIN_SHAPES:
        x = (torch.randn((bh, s, p), generator=gen, device=dev)
             * 0.05).to(torch.bfloat16)
        la = -torch.rand((bh, s), generator=gen, device=dev) * 0.1
        B, C = (torch.randn((nb, s, n), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        dy = torch.randn((bh, s, p), generator=gen, device=dev).to(
            torch.bfloat16)
        got = ssd_bwd.launch(x, la, B, C, dy)
        again = ssd_bwd.launch(x, la, B, C, dy)
        bits = all(torch.equal(a, b) for a, b in zip(got, again))
        want = ops._ssd_bwd_plain(x, la, B, C, dy, chunk=64)
        ratio = bwd_excess(got, want)
        f_ratio = bwd_excess(got, ssd_carry_dropped(torch, ops, x, la, B, C,
                                                    dy))
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        hs, sl = ssd_bwd.cut(bh // nb, nb, s, sms, x.dtype)
        scratch = ssd_bwd.scratch_bytes(bh, nb, s, n, p, sms, x.dtype)
        print(f"  {label:<12} {bh} rows, {nb} B/C rows, S={s} P={p} N={n}: "
              f"max|kernel-plain| {err:.3e}, {ratio:.3f} of the limit (1 "
              f"ulp + {BWD_RTOL:.0e} rms); planted fault (dS not carried) "
              f"{f_ratio:.1f} of the limit; two runs bit for bit {bits}; "
              f"{sl} slices of {hs} heads; scratch {scratch / 1e6:.1f} MB")
        assert ratio <= 1.0, (label, ratio)
        assert f_ratio > FAULT_MARGIN, (label, f_ratio)
        assert bits, label
        suffix = "" if label.startswith("mamba2") else "_hymba"
        ms = timed(lambda: ssd_bwd.launch(x, la, B, C, dy), 5)
        plain_ms = timed(lambda: ops._ssd_bwd_plain(x, la, B, C, dy,
                                                    chunk=64), 2)
        split = ssd_bwd_parts.kernel_ms(
            lambda: ssd_bwd.launch(x, la, B, C, dy))
        print(f"  {label}: ssd_bwd's kernels, device ms a call: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()))
        rec["ssd_bwd" + suffix] = dict(
            module=ssd_bwd, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=None, cost=ssd_bwd.cost(x, la, B, C, dy),
            label="ssd_bwd" + suffix)
        f_err = check(f"ssd {label} train fwd", ssd.launch(x, la, B, C)[0],
                      ops.PLAIN.ssd(x, la, B, C, chunk=64)[0], "ssd")
        f_ms = timed(lambda: ssd.launch(x, la, B, C), 10)
        f_plain = timed(lambda: ops.PLAIN.ssd(x, la, B, C, chunk=64), 2)
        rec["ssd_train" + suffix] = dict(
            module=ssd, max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
            library_ms=None, label="ssd_train" + suffix,
            cost=ssd.cost(x, la, B, C))
        print(f"  {label}: ssd_bwd {ms:.4f} ms, plain {plain_ms:.3f} ms; "
              f"ssd forward {f_ms:.4f} ms, plain {f_plain:.3f} ms")
        del x, la, B, C, dy, got, again, want
    torch.cuda.empty_cache()
    return rec


def no_plain_versions(torch, seen):
    """Wrap the plain attention and SSD versions (forward and backward) so
    that a call is recorded in ``seen``; returns the function that puts
    them back."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd, ssd_bwd
    undo = [watch(fa, "flash_attention_plain", seen),
            watch(fab, "flash_attention_bwd_plain", seen),
            watch(kops, "_ssd_plain", seen),
            watch(ssd, "ssd_plain", seen),
            watch(ssd_bwd, "ssd_bwd_plain", seen)]
    return lambda: [u() for u in undo]


LIBRARY_ATTENTION = ("scaled_dot_product", "flash_attention_backward",
                     "efficient_attention", "cudnn", "_flash_attention")


def train_phase(torch, ops, smi, arch, batch, seq, per_layer, rows):
    """``arch`` at full width (bf16, random init from seed 0) through
    ``launch.train``'s ``main``: 6 steps at ``batch`` x ``seq``, remat
    full, the reference's lr, warmup, decay and clip (TRAIN_RUNS).  Each
    step's loss, grad norm and lr, the wall a step over steps 2-5, tokens
    a second, peak memory, then one more step under torch.profiler
    (device busy share, device ms by op, the kernels of TRAIN_PROFILED
    apart, the backward kernels' shares of the device time) and the
    model-FLOP share of the bf16 peak (``launch/dryrun.model_flops``
    over the step time, ``core/roofline.py``).  Asserts finite losses, the exact
    launches a step (``per_layer`` x the layers), and no plain attention
    or SSD version, SDPA or cuDNN attention on the path.  Returns the
    counts of the 6-step run under the JSON rows' names (``rows``)."""
    import gc
    import math
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.core import roofline
    from repro_torch.data import make_pipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_cli
    t0 = time.perf_counter()
    seen = []
    undo = no_plain_versions(torch, seen)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = {}
    try:
        train_cli.main(train_args(arch, batch, seq), out=out)
        torch.cuda.synchronize()
    finally:
        undo()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tr, state = out["trainer"], out["state"]
    model, cfg = tr.model, tr.model.cfg
    hist = state["_history"]
    steps, nl = len(hist), cfg.n_layers
    for h in hist:
        print(f"train_phase: {arch}: step {h['step']}: loss "
              f"{h['loss']:.6f}, grad norm {h['grad_norm']:.6f}, lr "
              f"{h['lr']:.3e}, wall {1e3 * h['dt']:.1f} ms")
    assert steps == 6 and all(math.isfinite(h["loss"]) for h in hist), hist
    assert not seen, f"a plain version ran on the path: {len(seen)}"
    want = {k: per_layer.get(k, 0) * nl * steps for k in TRAIN_KERNELS}
    got = {k: counts[k] for k in TRAIN_KERNELS}
    print(f"train_phase: {arch}: launches {got} (a step: " + ", ".join(
        f"{k} {m} x {nl}" for k, m in per_layer.items()) + ")")
    assert got == want, (got, want)
    dts = [h["dt"] for h in hist[2:6]]
    tokens = batch * seq
    step_s = sum(dts) / len(dts)
    # one more step under the profiler, on the next batch
    pbatch = next(iter(make_pipeline(cfg, ShapeConfig("t", seq, batch,
                                                      "train"),
                                     start_step=6, num_steps=1)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, _, m = tr.step_fn(state["params"], state["opt"], pbatch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    rows_t, _ = device_time(prof)
    busy = sum(r[0] for r in rows_t) / 1e3
    names = {e.name() for e in profile_events(prof)}
    lib = [n for n in names if any(x in n for x in LIBRARY_ATTENTION)]
    assert not lib, f"library attention on the training path: {lib}"
    own = {}
    for us, n, key in rows_t:
        for kname in TRAIN_PROFILED:
            if kname in key:
                t, c = own.get(kname, (0.0, 0))
                own[kname] = (t + us / 1e3, c + n)
    n_params = sum(t.numel() for t in tree.leaves(state["params"]))
    model_flops = dryrun.model_flops(cfg, ShapeConfig("t", seq, batch,
                                                      "train"))

    def share(prefix):
        ms = sum(t for k, (t, _) in own.items() if k.startswith(prefix))
        return f"{ms:.1f} ms ({100 * ms / busy:.1f}% of the device time)"
    print(f"train_phase: {arch} full width ({smi}): {n_params / 1e9:.3f} B "
          f"params; batch {batch} x seq {seq}; step wall over steps 2-5 "
          f"{1e3 * step_s:.1f} ms (median "
          f"{1e3 * statistics.median(dts):.1f}), {tokens / step_s:.0f} "
          f"tokens/s; peak memory {peak / 2 ** 30:.2f} GiB; model FLOPs a "
          f"step (launch/dryrun.model_flops: 6 N tokens + 6 L H hd B S^2, "
          f"the reference's formula) {model_flops / 1e12:.2f} TFLOP, "
          f"{100 * roofline.measured_fraction(model_flops, step_s):.1f}% "
          f"of {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s; profiled step wall "
          f"{1e3 * wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (1e3 * wall):.1f}%); the attention backward "
          f"kernel {share('fab_')}; the SSD backward kernel "
          f"{share('ssd_bwd_')}")
    print(f"train_phase: {arch}: the hand-written kernels' device time: "
          + ", ".join(f"{k} {t:.2f} ms in {c} launches"
                      for k, (t, c) in own.items()))
    print(f"train_phase: {arch}: top device time:")
    for us, n, key in rows_t[:14]:
        print(f"    {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")
    print(f"train_phase: {arch}: {time.perf_counter() - t0:.1f} s")
    del out, tr, state, model, pbatch, prof
    gc.collect()
    torch.cuda.empty_cache()
    return [{rows[k]: got[k] for k in rows}]


def grads_apart(kg, pg):
    """(max over leaves of max |kernel - plain| / max |plain|, the leaf)."""
    from repro_torch.core import tree
    worst = (0.0, "")
    for (p, a), (_, b) in zip(tree.items(kg), tree.items(pg)):
        r = ((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp(min=1e-30)).item()
        worst = max(worst, (r, "/".join(p)))
    return worst


def train_end_to_end(torch, ops, registry):
    """Phase 5t: one training step's loss and gradients, kernel path
    against plain path (the same weights, the plain model built with
    ``kernels=ops.PLAIN``: plain forward and backward), in f32:
    llama3.2-3b at full width and 2 layers (batch 2 x 1024), mamba2-2.7b
    at full width and 2 layers (batch 2 x 2048), then reduced
    qwen2-moe-a2.7b, llava-next-34b, whisper-large-v3 and hymba-1.5b
    (batch 2 x 64).  The loss within TRAIN_LOSS_TOL relative, each
    gradient leaf within TRAIN_GRAD_TOL of its largest element, the
    family's kernels launched (attention forward and backward, ssd and
    ssd_bwd); the planted fault (the plain path's backward run non-causal)
    must read more than FAULT_MARGIN times the limit at llama3.2-3b's
    width."""
    from repro_torch.core import chaining
    from repro_torch.data import SyntheticLMDataset, family_extras_fn
    from repro_torch.data.pipeline import to_device
    f32 = dict(param_dtype="float32", act_dtype="float32")
    cases = [("llama3.2-3b 2 layers", dataclasses.replace(
        registry.config("llama3.2-3b"), n_layers=2, **f32), 2, 1024),
        ("mamba2-2.7b 2 layers", dataclasses.replace(
            registry.config("mamba2-2.7b"), n_layers=2, **f32), 2, 2048)]
    for name in (QWEN2_MOE, LLAVA, WHISPER, HYMBA):
        cases.append((f"{name} reduced", dataclasses.replace(
            registry.config(name).reduced(), **f32), 2, 64))
    for label, cfg, b, s in cases:
        km = registry.build_model(cfg, device="cuda")
        pm = registry.build_model(cfg, device="cuda", kernels=ops.PLAIN)
        params = km.init(0)
        host = SyntheticLMDataset(vocab=cfg.vocab, seq_len=s,
                                  global_batch=b).batch(0)
        extras = family_extras_fn(cfg)
        batch = to_device(extras(0, host) if extras else host, "cuda")

        def vg(model):
            return chaining.value_and_grad(
                lambda p, bt: model.loss_fn(p, bt)[0], params, batch)
        ops.reset_launch_counts()
        kl, kg = vg(km)
        counts = ops.launch_counts()
        pl, pg = vg(pm)
        loss_rel = abs(kl.item() - pl.item()) / abs(pl.item())
        worst, leaf = grads_apart(kg, pg)
        print(f"phase 5t: {label}: loss kernel {kl.item():.6f} plain "
              f"{pl.item():.6f} ({loss_rel:.2e} relative, limit "
              f"{TRAIN_LOSS_TOL:.0e}); gradients: worst leaf {leaf} "
              f"{worst:.2e} of its max (limit {TRAIN_GRAD_TOL:.0e}); "
              f"launches "
              + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS))
        used = {"ssm": ("ssd", "ssd_bwd"),
                "hybrid": TRAIN_KERNELS}.get(cfg.family, TRAIN_KERNELS[:2])
        assert all(counts[k] > 0 for k in used), (label, counts)
        assert loss_rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL, (
            label, loss_rel, worst, leaf)
        if label.startswith("llama"):
            real = ops._attention_bwd_plain

            def noncausal(*a, **kw):
                kw["causal"] = False
                return real(*a, **kw)
            ops._attention_bwd_plain = noncausal
            try:
                _, fg = vg(pm)
            finally:
                ops._attention_bwd_plain = real
            f_worst, f_leaf = grads_apart(kg, fg)
            print(f"  planted fault (the plain backward non-causal): worst "
                  f"leaf {f_leaf} {f_worst:.2e}, "
                  f"{f_worst / TRAIN_GRAD_TOL:.1f} of the limit")
            assert f_worst > FAULT_MARGIN * TRAIN_GRAD_TOL, f_worst
            del fg
        del km, pm, params, kg, pg, batch
        torch.cuda.empty_cache()


# Phase 7a (analysis): llama3.2-3b's training step at the training phase's
# shape (B 4 x S 1024, remat full) and an eager decode step at 4 slots
# over 1024 arena rows, each traced under core.cost's counting mode on
# the card and on meta tensors; the trace's peak live bytes against the
# allocator's peak within PEAK_MARGIN (the training phase reads ~53.5 GiB
# at this shape; the ratio reads 0.9987 on an H100 80GB HBM3 at 700 W, so
# 2% leaves room for the allocator's rounding and little for an error in
# the live bytes)
ANALYSIS_ARCH = "llama3.2-3b"
ANALYSIS_TRAIN = (4, 1024)
ANALYSIS_DECODE = (4, 1024)
PEAK_MARGIN = 0.02


def analysis_phase(torch, registry, smi):
    """Phase 7a: the analysis path of ``launch/dryrun.py`` held against the
    card.  For llama3.2-3b's training step and an eager decode step: the
    step traced under ``core.cost.CostMode`` with the counting kernel
    bundle on the card (the hand-written kernels run, each charged once
    from its ``cost()``) must count exactly what the meta trace of the
    same shapes counts; the same step with the default kernels is timed
    with CUDA events (a warm-up step first); its roofline terms
    (``core/roofline.py`` on the H100's data-sheet constants) must each be
    at most that time (a bound over the measurement is an overcount); the
    measured roofline fraction (model FLOPs at the bf16 peak over the
    step) is printed; the training trace's peak live bytes must sit within
    PEAK_MARGIN of ``torch.cuda.max_memory_allocated`` of a timed step."""
    import gc
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import cost, roofline
    from repro_torch.kernels import counting
    from repro_torch.launch import dryrun
    from repro_torch.models import convert
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import TrainConfig, make_train_step
    t0 = time.perf_counter()
    cfg = registry.config(ANALYSIS_ARCH)
    tcfg = TrainConfig(remat="full")
    b, s = ANALYSIS_TRAIN
    slots, rows = ANALYSIS_DECODE
    shapes = {"train": ShapeConfig("train", s, b, "train"),
              "decode": ShapeConfig("decode", rows, slots, "decode")}

    def trace(model, kind, specs, params, opt=None):
        fn, inputs = dryrun.step_of(model, kind, specs, tcfg, params, opt)
        with cost.CostMode() as mode:
            mode.track(inputs)
            fn()
        torch.cuda.synchronize()
        return mode

    def counts(mode):
        return {**mode.cost.counts(), "kernels": dict(mode.kernels)}

    meta = {}
    for kind, shape in shapes.items():
        specs = (registry.train_batch_specs if kind == "train"
                 else registry.decode_specs)(cfg, shape)
        meta[kind] = trace(registry.build_model(
            cfg, device="meta", kernels=counting.counting_kernels()), kind,
            specs, convert.abstract_params(cfg))
    print(f"phase 7a: meta traces of {ANALYSIS_ARCH} in "
          f"{time.perf_counter() - t0:.1f} s")

    def timed_steps(fn, n):
        out = []
        for _ in range(n):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1) / 1e3)
        return out

    def hold(kind, mode, step_s):
        got, want = counts(mode), counts(meta[kind])
        if got != want:
            diff = {k: (got["bytes_by_op"].get(k), want["bytes_by_op"].get(k))
                    for k in set(got["bytes_by_op"]) | set(
                        want["bytes_by_op"])
                    if got["bytes_by_op"].get(k) != want["bytes_by_op"].get(k)}
            print(f"phase 7a: {kind}: card trace != meta trace: "
                  f"{ {k: (got[k], want[k]) for k in got if k != 'bytes_by_op' and got[k] != want[k]} }, "
                  f"bytes by op {diff}")
        assert got == want, f"{kind}: the card's counts differ from meta's"
        mf = dryrun.model_flops(cfg, shapes[kind])
        terms = roofline.derive(mode.cost, model_flops_global=mf)
        print(f"phase 7a: {ANALYSIS_ARCH} {kind} ({smi}): counted "
              f"{mode.cost.flops / 1e12:.4f} TFLOP, "
              f"{mode.cost.bytes / 1e9:.3f} GB, kernels {mode.kernels}; "
              f"the card's counts = meta's: True; model FLOPs "
              f"{mf / 1e12:.4f} T, useful_flops_ratio "
              f"{terms.useful_flops_ratio:.4f}; compute_s "
              f"{1e3 * terms.compute_s:.4f} ms, memory_s "
              f"{1e3 * terms.memory_s:.4f} ms ({terms.dominant}); measured "
              f"step {1e3 * step_s:.4f} ms: roofline_fraction measured "
              f"{100 * roofline.measured_fraction(mf, step_s):.2f}% (the "
              f"trace's bound {100 * terms.roofline_fraction:.2f}%), bound "
              f"/ measured {terms.bound_s / step_s:.4f}")
        assert terms.compute_s <= step_s and terms.memory_s <= step_s, (
            kind, terms.compute_s, terms.memory_s, step_s)
        return terms

    # -- the training step ---------------------------------------------------
    plain = registry.build_model(cfg, device="cuda")
    params = plain.init(0)
    gen = torch.Generator(device="cuda").manual_seed(34)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    opt = adamw_init(params)
    step = make_train_step(plain, tcfg)
    timed_steps(lambda: step(params, opt, batch), 1)       # warm-up
    torch.cuda.reset_peak_memory_stats()
    dts = timed_steps(lambda: step(params, opt, batch), 2)
    peak = torch.cuda.max_memory_allocated()
    mode = trace(registry.build_model(cfg, device="cuda",
                                      kernels=counting.counting_kernels()),
                 "train", batch, params, opt)
    hold("train", mode, min(dts))
    ratio = mode.peak_bytes / peak
    print(f"phase 7a: {ANALYSIS_ARCH} train: step ms {[round(1e3 * t, 2) for t in dts]}; "
          f"peak estimate (the trace's live bytes) "
          f"{mode.peak_bytes / 2 ** 30:.2f} GiB (meta "
          f"{meta['train'].peak_bytes / 2 ** 30:.2f}) against "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB: ratio "
          f"{ratio:.4f}")
    assert abs(ratio - 1) <= PEAK_MARGIN, ratio
    del params, opt, batch, tokens, step, mode, plain
    gc.collect()
    torch.cuda.empty_cache()

    # -- the eager decode step -----------------------------------------------
    plain = registry.build_model(cfg, device="cuda")
    params = plain.init(0)
    specs = {"token_t": torch.randint(0, cfg.vocab, (slots,), generator=gen,
                                      device="cuda"),
             "cache": plain.init_cache(slots, rows),
             "pos": torch.full((slots,), rows - 1, device="cuda")}
    fn, _ = dryrun.step_of(plain, "decode", specs, tcfg, params)
    timed_steps(fn, 3)
    dts = timed_steps(fn, 10)
    mode = trace(registry.build_model(cfg, device="cuda",
                                      kernels=counting.counting_kernels()),
                 "decode", specs, params)
    terms = hold("decode", mode, statistics.median(dts))
    weights = sum(t.numel() * t.element_size()
                  for t in _leaves(params))
    print(f"phase 7a: {ANALYSIS_ARCH} decode: step ms median "
          f"{1e3 * statistics.median(dts):.4f} (of "
          f"{[round(1e3 * t, 3) for t in dts]}); memory_s "
          f"{1e3 * terms.memory_s:.4f} ms against the "
          f"{weights / 1e9:.3f} GB of weights at the HBM rate "
          f"{1e3 * weights / roofline.HBM_BW:.4f} ms (the embedding table "
          f"is gathered, 4 rows, not read whole); "
          f"{time.perf_counter() - t0:.1f} s")
    del params, specs, fn, mode, plain
    gc.collect()
    torch.cuda.empty_cache()


def examples_phase(torch):
    """Phase 7b: the four examples on the card, each through its
    ``main`` (``repro_torch.examples``), ``train_lm`` at 60 steps of its
    ~100M-parameter config with checkpoints in a temporary directory."""
    import tempfile
    from repro_torch.examples import (quickstart, serve_lm, train_lm,
                                      vector_unit_demo)
    for name, fn in (("quickstart", lambda: quickstart.main([])),
                     ("serve_lm", lambda: serve_lm.main([])),
                     ("vector_unit_demo", lambda: vector_unit_demo.main([]))):
        t0 = time.perf_counter()
        assert fn() == 0, name
        torch.cuda.synchronize()
        print(f"phase 7b: example {name} ok in "
              f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        assert train_lm.main(["--steps", "60", "--ckpt-dir", ckpt]) == 0
        torch.cuda.synchronize()
        print(f"phase 7b: example train_lm (60 steps) ok in "
              f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def restart_check(torch, ops, registry, arch):
    """The restart on the card: reduced ``arch`` (bf16; llama3.2-3b, then
    mamba2-2.7b) trains 6 steps straight, and again as 3 steps, a
    checkpoint (the port's RPK1 file in whatever codec the machine has), a
    restore in a fresh Trainer and 3 more: losses and final params and
    moments bit for bit.  Run under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
    warnings name any op without a deterministic path."""
    import shutil
    import warnings
    from repro_torch.checkpoint import store
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.data import make_pipeline
    from repro_torch.runtime.trainer import Trainer, TrainConfig
    ck = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    bundle = registry.build(arch, reduced=True, device="cuda")
    shape = ShapeConfig("t", 64, 4, "train")
    kw = dict(log_every=1, peak_lr=1e-3, seed=0)

    def pipe(start, n):
        return make_pipeline(bundle.cfg, shape, start_step=start,
                             num_steps=n)
    torch.use_deterministic_algorithms(True, warn_only=True)
    ops.reset_launch_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            st_a = Trainer(bundle.model, TrainConfig(num_steps=6, **kw)).run(
                pipe(0, 6))
            Trainer(bundle.model, TrainConfig(
                num_steps=3, ckpt_dir=ck, ckpt_every=100, **kw)).run(
                    pipe(0, 3))
            tr_c = Trainer(bundle.model, TrainConfig(
                num_steps=6, ckpt_dir=ck, ckpt_every=100, **kw))
            state, start = tr_c.maybe_restore()
            st_c = tr_c.run(pipe(3, 3), start_step=start, state=state)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    counts = ops.launch_counts()
    with open(os.path.join(ck, "step_3", "state.ckpt"), "rb") as f:
        head = f.read(5)
    shutil.rmtree(ck, ignore_errors=True)
    a = [h["loss"] for h in st_a["_history"]][3:]
    c = [h["loss"] for h in st_c["_history"]]
    same = all(torch.equal(x, y) for x, y in zip(
        tree.leaves({"p": st_a["params"], "o": st_a["opt"]}),
        tree.leaves({"p": st_c["params"], "o": st_c["opt"]})))
    notes = sorted({str(w.message).split("\n")[0][:120] for w in caught
                    if "deterministic" in str(w.message)})
    bwd = "ssd_bwd" if bundle.cfg.family == "ssm" else "flash_attention_bwd"
    print(f"restart: {arch}: file header {head!r} (zstandard "
          f"{'present' if store.zstd is not None else 'absent'}); start "
          f"step {start}; losses straight {a} resumed {c}; params and "
          f"moments bit for bit {same}; launches "
          + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS)
          + f"; determinism warnings: {notes or 'none'}")
    assert start == 3 and head[:4] == b"RPK1", (start, head)
    assert a == c and same, (a, c, same)
    assert counts[bwd] > 0, counts


def main() -> int:
    # cuBLAS picks its workspace per stream; a fixed configuration keeps
    # its GEMMs' bits from run to run (the restart check); set before the
    # first cuBLAS handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, capability "
          f"{torch.cuda.get_device_capability(0)}")

    start = time.perf_counter()

    def stamp(what):
        print(f"timing: {what} done at {time.perf_counter() - start:.1f} s")

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"phase 2: built {sorted(secs)} in "
          f"{time.perf_counter() - t0:.1f} s wall (per library: "
          f"{ {k: round(v, 1) for k, v in secs.items()} })")
    sass_check(_build)

    sampler_checks(torch)
    rec = kernel_checks(torch, ops, registry.config("llama3.2-3b"))
    rec.update(scaled_kernel_checks(torch, ops,
                                    registry.config("llama3.2-3b")))
    rec.update(donor_checks(torch, ops, registry.config("llama3.2-3b")))
    rec["ssd"] = ssd_checks(torch, ops, registry.config("mamba2-2.7b"))
    rec.update(hybrid_kernel_checks(torch, ops, registry.config(HYMBA)))
    rec.update(moe_kernel_checks(torch, ops, registry.config(QWEN2_MOE),
                                 "moe", (1024, 768), 64))
    rec.update(moe_kernel_checks(torch, ops, registry.config(QWEN3_MOE),
                                 "moe30b", (512,), 32))
    rec.update(vlm_encdec_kernel_checks(torch, ops, registry.config(LLAVA),
                                        registry.config(WHISPER)))
    rec.update(train_kernel_checks(torch, ops))
    rec.update(ssd_train_checks(torch, ops))
    for name in sorted(rec):
        bound(rec[name])
    stamp("phases 1-3")
    all_runs = []
    for run in TRAIN_RUNS:
        all_runs += train_phase(torch, ops, smi, *run)
        stamp(f"train_phase {run[0]}")
    train_end_to_end(torch, ops, registry)
    stamp("phase 5t")
    for arch in ("llama3.2-3b", "mamba2-2.7b"):
        restart_check(torch, ops, registry, arch)
    stamp("the restarts")
    analysis_phase(torch, registry, smi)
    stamp("phase 7a")
    examples_phase(torch)
    stamp("phase 7b")
    for arch in ("llama3.2-3b", "mamba2-2.7b"):
        bundle, params, args, runs = serving_runs(torch, ops, serve, arch,
                                                  gen=64)
        stamp(f"{arch} phase 4")
        # no eager-decode and no eager-chunk profile (their busy shares
        # are recorded in PERF.md): they hold the smoke's time with the
        # vlm and encdec phases added
        busy = {(mode, "captured"): profile_run(torch, ops, serve, bundle,
                                                params, mode)
                for mode in ("monolithic", "chunked")}
        stamp(f"{arch} phase 4b")
        # the decode-step and chunk timing pairs run once each (their
        # checks in full) to hold the smoke's time with hymba's phases
        # added
        pairs = eager_vs_captured(serve, bundle, params, runs, gen=64,
                                  pairs=1)
        cpairs = chunk_pairs(torch, serve, bundle, params, runs, gen=64,
                             pairs=1)
        window, wbusy = decode_window(torch, serve, bundle, params, pairs=1)
        stamp(f"{arch} phase 4c")
        mixed, counts4d = sampled_runs(torch, ops, serve, bundle, params,
                                       runs)
        # the greedy twin against the sampled graph over decode-only
        # windows: llama3.2-3b's only (mamba2's is in PERF.md), to hold
        # the smoke's time with the vlm and encdec phases added
        swindow = sbusy = {}
        if bundle.cfg.family == "dense":
            swindow, sbusy = decode_window(
                torch, serve, bundle, params, same=False, phase="4d",
                pairs=1, kinds={"greedy": [], "sampled": SAMPLE_ARGS
                                + ["--sampling-mix", "1.0"]})
        stamp(f"{arch} phase 4d")
        windows = ("; decode only, median ms a step " + ", ".join(
            f"{kind} {statistics.median(ms):.3f} (device "
            f"{sbusy[kind][0]:.3f})" for kind, ms in swindow.items())
            if swindow else "")
        print(f"phase 4d: {bundle.name} summary ({smi}): mixed runs "
              + "; ".join(f"{mode} {r[0]:.1f} tok/s ({r[1]} of {r[2]} steps "
                          f"sampled)" for mode, r in mixed.items())
              + windows)
        print(f"phase 4c: {bundle.name} summary ({smi}), medians: " + "; ".join(
            f"{mode} {kind} {statistics.median(r[0] for r in res[kind]):.1f}"
            f" tok/s, {statistics.median(r[1] for r in res[kind]):.2f} ms a "
            f"step incl. prefill" for mode, res in pairs.items()
            for kind in res) + "; decode only " + ", ".join(
            f"{kind} {statistics.median(ms):.3f} ms a step (device "
            f"{wbusy[kind][0]:.3f} ms)" for kind, ms in window.items())
            + "; device busy (4b) " + ", ".join(
            f"{mode} {kind} {100 * b:.1f}%"
            for (mode, kind), b in busy.items()))
        print(f"phase 4c: {bundle.name} chunked summary ({smi}), medians: "
              + "; ".join(
                  f"{kind} {wave} wave "
                  f"{statistics.median(r[0] for r in rows):.1f} tok/s, TTFT "
                  f"{1e3 * statistics.median(t for r in rows for t in r[1].values()):.1f}"
                  f" ms (all requests), host_blocked_s "
                  f"{statistics.median(r[2] for r in rows):.4f}"
                  for kind, by_wave in cpairs.items()
                  for wave, rows in by_wave.items()))
        if bundle.cfg.family == "dense":
            counts4e, narrow = narrow_runs(torch, ops, serve, bundle, params,
                                           runs)
            all_runs += counts4e
            stamp(f"{arch} phase 4e")
        all_runs += shared_prefix_runs(torch, ops, serve, bundle, params)
        stamp(f"{arch} phase 4f")
        if bundle.cfg.family == "dense":
            all_runs += speculative_runs(
                torch, ops, serve, bundle, params, runs,
                mixed["chunked"][3], narrow["int8"]["chunked"])
            stamp(f"{arch} phase 4g")
        all_runs += fault_phase(
            torch, ops, serve, bundle, params, runs,
            narrow["int8"]["chunked"] if bundle.cfg.family == "dense"
            else None)
        stamp(f"{arch} phase 4h")
        end_to_end(torch, ops, serve, bundle, params, args, runs)
        stamp(f"{arch} phase 5")
        all_runs += [run[3] for run in runs.values()] + counts4d
        del bundle, params, runs
        torch.cuda.empty_cache()
    all_runs += hybrid_phase(torch, ops, serve, smi)
    stamp(f"{HYMBA} phases 4-5")
    all_runs += moe_phase(torch, ops, serve, registry, smi)
    stamp(f"{QWEN2_MOE} phases 4-5")
    all_runs += encdec_phase(torch, ops, serve, smi)
    stamp(f"{WHISPER} phases 4-5")
    all_runs += moe30b_phase(torch, ops, serve, smi)
    stamp(f"{QWEN3_MOE} phase 4")
    all_runs += vlm_phase(torch, ops, serve, smi)
    stamp(f"{LLAVA} phases 4-5")
    vu_rec, vu_counts = vector_unit_phase(torch, ops)
    stamp("phase 6")
    for name in sorted(vu_rec):
        bound(vu_rec[name])
    rec.update(vu_rec)
    all_runs.append(vu_counts)

    kernels = []
    for name in sorted(rec):
        r = rec[name]
        launches = sum(counts.get(name, 0) for counts in all_runs)
        assert launches > 0, (name, launches)
        kernels.append({
            "name": name, "route": "cuda", "source": r["module"].SOURCE,
            "replaces": r.get("replaces", r["module"].REPLACES),
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "design": DESIGN[name],
            **({"formats": r["formats"]} if "formats" in r else {})})
    print("kernels: " + ", ".join(
        f"{k['name']}=ok({k['launches']} launches)" for k in kernels)
        + f"; chunk/decode bit pin "
          f"{'holds' if rec['flash_prefill_chunk']['pin'] else 'broken'}"
          f" (bf16), holds (int8, fp8, under the donor table, under "
          f"hymba's window 1024: "
          f"{rec['flash_prefill_chunk_hymba']['pin']}, at G = 1: "
          f"{rec['flash_prefill_chunk_moe']['pin']} and G = 8: "
          f"{rec['flash_prefill_chunk_moe30b']['pin']})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
