#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

  1. device: the card as ``nvidia-smi`` reports it, CUDA and capability;
  2. build: the seven kernels (flash_attention, flash_decode,
     flash_prefill_chunk, ssd, matmul, dotp, conv2d) from
     ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one nvcc per
     source, all at once;
  3. per-kernel checks: each kernel against its plain PyTorch version on
     the card, at the serving path's full-width bf16 shapes (attention:
     ragged lengths, a parked slot, chunk prefix 0 and > 0; ssd: 80 heads,
     S 1024 / 768 / 1000, with and without an initial state) and at a
     small f32 shape, within the stated limit, each with a planted fault
     the limit must reject; kernel / plain / bound / library-call times;
     whether chunk row j equals flash_decode at pos = prefix + j bit for
     bit (reported, not asserted);
  4. serving, for llama3.2-3b (the attention kernels) and then
     mamba2-2.7b (ssd), each at full width through ``repro_torch.launch.
     serve`` (4 requests, prompts 1024/768, 64 new tokens, 4 slots,
     depth 2), monolithic then chunked, with each kernel's launch count;
     then a short run of each under torch.profiler (device time by
     kernel, device busy share);
  5. end to end, per model: request 0's prefill logits through the
     kernels against the same model built on the plain versions; for
     mamba2-2.7b also with f32 params and activations, where the limit
     must reject a planted SSD fault;
  6. the vector-unit path (fmatmul, dot product, fconv2d, the core
     modules): driven at the paper's sweep sizes with its own launch
     counts; each kernel against its plain version there, at ragged
     shapes and at card shapes (matmul 4096^3 f32 / bf16, dotp 2^26 f32 /
     bf16, conv2d (64, 112, 112, 3) x (7, 7, 3, 64) f32) within the
     reassociation bound, each with a planted fault the limit must reject
     by more than 10x; dotp's bits repeated; kernel / plain / library
     times; the core modules on CUDA against the CPU, bit for bit;
  7. summary: the kernel JSON line, the card line, then
     ``{"ok": true, "device": {...}}`` as the last line.

Needs nothing but this checkout; imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12           # H100 SXM float32 peak outside the tensor cores
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


def bf16_ulp(x):
    """Spacing of bfloat16 values (8 significant bits) at |x|; 0 at 0."""
    import torch
    x = x.float()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def ssd_limit(got, w):
    """ssd's per-element limit (see SSD_RTOL): SSD_RTOL (|w| + rms(w)) +
    one ulp of ``got``'s type at the larger magnitude (w: f32)."""
    import torch
    big = torch.maximum(got.float().abs(), w.abs())
    _, e = torch.frexp(big)
    bits = 24 if got.dtype == torch.float32 else 8
    ulp = torch.where(big == 0, 0.0,
                      torch.ldexp(torch.ones_like(big), e - bits))
    return ulp + SSD_RTOL * (w.abs() + w.pow(2).mean().sqrt())


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
    live = int(torch.clamp(lens, max=smax).sum())
    nbytes = 2 * (2 * q.numel() + 2 * live * kvh * d)
    flops = 4 * live * h * d
    rec["flash_decode"] = dict(
        module=flash_decode, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bytes=nbytes, flops=flops)

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
    print(f"  pin: chunk row j == flash_decode at pos 512 + j, bit for bit: "
          f"{pin} (max diff "
          f"{(chunk_out[0].float() - dec_out.float()).abs().max().item()})")
    ms = timed(lambda: flash_prefill_chunk.launch(
        q, arena_k[nxt(), :1], arena_v[layer[0], :1], pf), 20)
    plain_ms = timed(lambda: P.flash_prefill_chunk(
        q, arena_k[nxt(), :1], arena_v[layer[0], :1], prefix=pf), 5)
    qpos = 512 + torch.arange(c, device=dev)
    cmask = kpos[None, :] <= qpos[:, None]
    qt = q.transpose(1, 2)
    lib_ms = timed(lambda: sdpa(qt, arena_k[nxt(), :1].transpose(1, 2),
                                arena_v[layer[0], :1].transpose(1, 2),
                                attn_mask=cmask), 20)
    pairs = int(cmask.sum())
    rows = 512 + c
    rec["flash_prefill_chunk"] = dict(
        module=flash_prefill_chunk, max_abs_err=max(errs), ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms,
        bytes=2 * (2 * q.numel() + 2 * rows * kvh * d),
        flops=4 * pairs * h * d, pin=pin)

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
        library_ms=lib_ms,
        bytes=2 * (2 * qb.numel() + kb.numel() + vb.numel()),
        flops=4 * h * d * s * (s + 1) // 2)
    del arena_k, arena_v
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
    nbytes = (2 * nh * s * hd * 2          # x in, y out (bf16)
              + nh * s * 4                 # log_a (f32)
              + 2 * s * n * 2              # one group's B and C (bf16)
              + nh * n * hd * 4)           # final state out (f32)
    # the kernel's schedule (64-token inner chunks, csrc/ssd.cu's Q), the
    # causal half only: C.B^T and scores.X over the pairs j <= i of each
    # inner chunk, carry-in C.state and state update B^T.X per token
    q = 64
    full, rem = divmod(s, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
    flops = nh * (2 * pairs * (n + hd) + 2 * 2 * s * n * hd)
    return dict(module=ssd, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=None, bytes=nbytes, flops=flops)


def bound(r):
    """Fill ``bound_ms`` / ``bound_by`` of a kernel record and print it
    (operations at the record's ``flop_rate``, bf16's by default)."""
    t_bytes = r["bytes"] / HBM_BYTES_PER_S
    t_ops = r["flops"] / r.get("flop_rate", BF16_FLOP_PER_S)
    r["bound_ms"] = max(t_bytes, t_ops) * 1e3
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    print(f"  {r.get('label', r['module'].NAME):<20} kernel "
          f"{r['ms']:.4f} ms | plain "
          f"{r['plain_ms']:.4f} ms | library {lib} | bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
          f"{r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.3f} GFLOP)")


SERVE_ARGS = ["--no-reduced", "--requests", "4", "--prompt-len", "1024",
              "--slots", "4", "--depth", "2", "--device", "cuda"]


def serving_runs(torch, ops, serve, arch, gen):
    """Phase 4: both prefill modes of ``arch`` at full width.  Returns
    (bundle, params, args, {mode: (engine, out, seconds, launch
    counts)})."""
    base = ["--arch", arch, "--gen", str(gen)] + SERVE_ARGS
    args = serve.parse_args(base)
    t0 = time.perf_counter()
    bundle, params = serve.build(args)
    torch.cuda.synchronize()
    cfg = bundle.cfg
    if cfg.family == "ssm":
        shape = (f"d_inner={cfg.ssm.d_inner(cfg.d_model)}, "
                 f"{cfg.ssm.n_heads(cfg.d_model)} SSM heads x "
                 f"{cfg.ssm.headdim}, d_state={cfg.ssm.d_state}, "
                 f"chunk={cfg.ssm.chunk}")
    else:
        shape = f"H={cfg.n_heads}/KVH={cfg.n_kv_heads}, d_ff={cfg.d_ff}"
    print(f"phase 4: {cfg.name} full width: {cfg.n_params() / 1e9:.3f} B "
          f"params ({cfg.n_layers} layers, d={cfg.d_model}, {shape}, "
          f"V={cfg.vocab}, {cfg.param_dtype}); init "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for mode in ("monolithic", "chunked"):
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
        for o in out.values():
            assert o.shape == (margs.gen,), o.shape
            assert ((o >= 0) & (o < cfg.vocab)).all()
        runs[mode] = (eng, out, dt, counts)
    (m_eng, _, _, mono), (c_eng, _, _, chunked) = (runs["monolithic"],
                                                   runs["chunked"])
    if cfg.family == "ssm":
        # one ssd launch per layer per prefill and per prefill chunk
        nl = cfg.n_layers
        assert mono["ssd"] == nl * m_eng.stats["prefills"] > 0, mono
        assert chunked["ssd"] == nl * c_eng.stats["prefill_chunks"] > 0, \
            chunked
    else:
        assert mono["flash_attention"] > 0, mono
        assert mono["flash_decode"] > 0, mono
        assert chunked["flash_prefill_chunk"] > 0, chunked
        assert chunked["flash_decode"] > 0, chunked
    return bundle, params, args, runs


def profile_run(torch, serve, bundle, params):
    """Phase 4b: one short monolithic run (4 requests, prompts 1024/768,
    16 new tokens) under torch.profiler: device time by kernel and the
    device's busy share of the wall time (profiler overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    args = serve.parse_args(["--arch", bundle.name, "--gen", "16"]
                            + SERVE_ARGS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, _, dt = serve.serve(bundle, params, args)
    rows = []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    if not rows:
        print("phase 4b: profiler recorded no device time (not measured)")
        return
    print(f"phase 4b: {bundle.name} profiled monolithic run, "
          f"{eng.stats['decode_steps']} "
          f"decode steps + {eng.stats['prefills']} prefills: wall "
          f"{dt * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (dt * 1e3):.1f}%); top device time:")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")


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

    def carry_dropped(x, log_a, B, C, *, chunk=256, initial_state=None):
        cut = (x.shape[1] - 1) // 64 * 64
        y0, _ = P.ssd(x[:, :cut], log_a[:, :cut], B[:, :cut], C[:, :cut],
                      chunk=chunk, initial_state=initial_state)
        y1, st = P.ssd(x[:, cut:], log_a[:, cut:], B[:, cut:], C[:, cut:],
                       chunk=chunk)
        return torch.cat([y0, y1], dim=1), st

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32")
    p32 = f32(params)
    faulty = types.SimpleNamespace(**{**vars(P), "ssd": carry_dropped})
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
    ssm = bundle.cfg.family == "ssm"
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
        ssm_f32_check(torch, ops, bundle.cfg, params, prompt)
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


def vector_unit_phase(torch, ops):
    """Phase 6: the vector-unit path (fmatmul, dot product, fconv2d and the
    core modules).  6a drives it on the card at the paper's sweep sizes
    (``configs/ara_vu.py``, ``benchmarks/bench_*.py``) with the launch
    counts set to 0 just before and read just after; 6b holds every kernel
    result against its plain version there, at the ragged shapes of
    ``tests/test_kernels.py`` and at card shapes, each with its planted
    fault, checks that dotp repeats bit for bit, and times kernel, plain
    version and library call; 6c compares the core modules' CUDA results
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
            errs["matmul"].append(mm_check(f"({m}, {k}, {n}) {dn}",
                                           rn(m, k, dtype=dtype),
                                           rn(k, n, dtype=dtype)))
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
        err = mm_check(f"{s}^3 {dn}", a, b)
        r = dict(module=matmul, label=f"matmul {dn}",
                 max_abs_err=max(errs["matmul"] + [err]),
                 ms=timed(lambda: matmul.launch(a, b), 10),
                 plain_ms=timed(lambda: P.matmul(a, b), 10),
                 library_ms=timed(lambda: torch.matmul(a, b), 10),
                 bytes=3 * s * s * a.element_size(), flops=2 * s ** 3,
                 flop_rate=(F32_FLOP_PER_S if dtype == torch.float32
                            else BF16_FLOP_PER_S))
        if dtype == torch.float32:
            rec["matmul"] = r
        else:
            extra.append(r)
        del a, b
    n = 1 << 26
    for dtype in (torch.float32, torch.bfloat16):
        a, b = rn(n, dtype=dtype), rn(n, dtype=dtype)
        dn = names[dtype]
        err = dp_check(f"n=2^26 {dn}", a, b)
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
                 bytes=2 * n * a.element_size() + 4, flops=2 * n,
                 flop_rate=(F32_FLOP_PER_S if dtype == torch.float32
                            else BF16_FLOP_PER_S))
        if dtype == torch.float32:
            rec["dotp"] = r
        else:
            extra.append(r)
        del a, b
    x, w = rn(64, 112, 112, 3), rn(7, 7, 3, 64)
    err = cv_check("(64, 112, 112, 3) x (7, 7, 3, 64) f32", x, w)
    x_cl = x.permute(0, 3, 1, 2)                  # NCHW, channels-last
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib_out = F.conv2d(x_cl, w_cl).permute(0, 2, 3, 1)
    lib_err = (lib_out - P.conv2d(x, w)).abs().max().item()
    print(f"  F.conv2d (channels-last, the yardstick) vs plain: max |diff| "
          f"= {lib_err:.3e}")
    ho = 112 - 6
    rec["conv2d"] = dict(
        module=conv2d, label="conv2d f32",
        max_abs_err=max(errs["conv2d"] + [err]),
        ms=timed(lambda: conv2d.launch(x, w), 20),
        plain_ms=timed(lambda: P.conv2d(x, w), 3),
        library_ms=timed(lambda: F.conv2d(x_cl, w_cl), 20),
        bytes=4 * (x.numel() + w.numel() + 64 * ho * ho * 64),
        flops=2 * 64 * ho * ho * 64 * 7 * 7 * 3, flop_rate=F32_FLOP_PER_S)
    del x, w, x_cl, w_cl, lib_out
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


def main() -> int:
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

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"phase 2: built {sorted(secs)} in "
          f"{time.perf_counter() - t0:.1f} s wall (per library: "
          f"{ {k: round(v, 1) for k, v in secs.items()} })")

    rec = kernel_checks(torch, ops, registry.config("llama3.2-3b"))
    rec["ssd"] = ssd_checks(torch, ops, registry.config("mamba2-2.7b"))
    for name in sorted(rec):
        bound(rec[name])
    all_runs = []
    for arch in ("llama3.2-3b", "mamba2-2.7b"):
        bundle, params, args, runs = serving_runs(torch, ops, serve, arch,
                                                  gen=64)
        profile_run(torch, serve, bundle, params)
        end_to_end(torch, ops, serve, bundle, params, args, runs)
        all_runs += [run[3] for run in runs.values()]
        del bundle, params, runs
        torch.cuda.empty_cache()
    vu_rec, vu_counts = vector_unit_phase(torch, ops)
    for name in sorted(vu_rec):
        bound(vu_rec[name])
    rec.update(vu_rec)
    all_runs.append(vu_counts)

    kernels = []
    for name in sorted(rec):
        r = rec[name]
        launches = sum(counts[name] for counts in all_runs)
        assert launches > 0, (name, launches)
        kernels.append({
            "name": name, "route": "cuda", "source": r["module"].SOURCE,
            "replaces": r["module"].REPLACES, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print("kernels: " + ", ".join(
        f"{k['name']}=ok({k['launches']} launches)" for k in kernels)
        + f"; chunk/decode bit pin "
          f"{'holds' if rec['flash_prefill_chunk']['pin'] else 'broken'}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
