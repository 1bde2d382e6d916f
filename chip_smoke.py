#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

  1. device: the card as ``nvidia-smi`` reports it, CUDA and capability;
  2. build: the three attention kernels from ``src/repro_torch/kernels/
     csrc`` with nvcc for sm_90a, one nvcc per source, all at once;
  3. per-kernel checks: each kernel against its plain PyTorch version on
     the card, at the serving path's full-width bf16 shapes (ragged
     lengths, a parked slot, chunk prefix 0 and > 0) and at a small f32
     shape, within the stated tolerance; kernel / plain / bound /
     ``F.scaled_dot_product_attention`` times; whether chunk row j equals
     flash_decode at pos = prefix + j bit for bit (reported, not asserted);
  4. serving: llama3.2-3b at full width through ``repro_torch.launch.
     serve`` (4 requests, prompts 1024/768, 64 new tokens, 4 slots,
     depth 2), monolithic then chunked, with each kernel's launch count;
     then a short run under torch.profiler (device time by kernel);
  5. end to end: request 0's prefill logits through the kernels against
     the same model built on the plain versions, on the card;
  6. summary: the kernel JSON line, the card line, then
     ``{"ok": true, "device": {...}}`` as the last line.

Needs nothing but this checkout; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
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
# Full-width prefill logits, kernel path vs plain path: max |diff| measured
# 7.23e-2 on this seed (three runs, identical) against logits of std ~1.
LOGIT_TOL = 0.1
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


def excess(got, want, dtype_name) -> float:
    """max over elements of |got - want| / its limit (<= 1 passes)."""
    import torch
    g, w = got.float(), want.float()
    if dtype_name == "float32":
        lim = F32_TOL
    else:
        lim = bf16_ulp(torch.maximum(g.abs(), w.abs())) + BF16_ATOL
    return ((g - w).abs() / lim).max().item()


def check(name, got, want, dtype_name, extra="", fault=None):
    """Hold a kernel's output against its plain version; with ``fault``
    (``(what, plain output of a planted fault)``) also show that the limit
    fails that fault.  Returns the max abs error."""
    err = (got.float() - want.float()).abs().max().item()
    ratio = excess(got, want, dtype_name)
    limit = (f"{F32_TOL:.1e}" if dtype_name == "float32"
             else f"1 bf16 ulp + {BF16_ATOL:.1e}")
    print(f"  {name:<34} max|kernel-plain| = {err:.3e}, "
          f"{ratio:.3f} of the limit ({limit}) {extra}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: error {ratio} x the limit")
    if fault is not None:
        what, bad = fault
        f_err = (got.float() - bad.float()).abs().max().item()
        f_ratio = excess(got, bad, dtype_name)
        print(f"    planted fault ({what}): max|kernel-fault| = "
              f"{f_err:.3e}, {f_ratio:.1f} of the limit")
        if not f_ratio > 1.0:
            raise AssertionError(f"{name}: the limit passes the planted "
                                 f"fault {what} ({f_ratio} x the limit)")
    return err


def kernel_checks(torch, ops, cfg):
    """Phase 3.  Returns {kernel name: record}."""
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
    for name, r in rec.items():
        r["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                            r["flops"] / BF16_FLOP_PER_S) * 1e3
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / BF16_FLOP_PER_S else "operations")
        print(f"  {name:<20} kernel {r['ms']:.4f} ms | plain "
              f"{r['plain_ms']:.4f} ms | sdpa {r['library_ms']:.4f} ms | "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.3f} GFLOP)")
    del arena_k, arena_v
    return rec


def serving_runs(torch, ops, serve):
    """Phase 4: both prefill modes at full width.  Returns (bundle, params,
    args, {mode: (engine, out, seconds, launch counts)})."""
    base = ["--arch", "llama3.2-3b", "--no-reduced", "--requests", "4",
            "--prompt-len", "1024", "--gen", "64", "--slots", "4",
            "--depth", "2", "--device", "cuda"]
    args = serve.parse_args(base)
    t0 = time.perf_counter()
    bundle, params = serve.build(args)
    torch.cuda.synchronize()
    cfg = bundle.cfg
    print(f"phase 4: {cfg.name} full width: {cfg.n_params() / 1e9:.3f} B "
          f"params ({cfg.n_layers} layers, d={cfg.d_model}, H={cfg.n_heads}"
          f"/KVH={cfg.n_kv_heads}, d_ff={cfg.d_ff}, V={cfg.vocab}, "
          f"{cfg.param_dtype}); init {time.perf_counter() - t0:.1f} s")
    runs = {}
    for mode in ("monolithic", "chunked"):
        margs = serve.parse_args(base + ["--prefill-mode", mode])
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
        print(f"  {mode} kernel launches: {counts}")
        for o in out.values():
            assert o.shape == (margs.gen,), o.shape
            assert ((o >= 0) & (o < cfg.vocab)).all()
        runs[mode] = (eng, out, dt, counts)
    mono, chunked = runs["monolithic"][3], runs["chunked"][3]
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
    args = serve.parse_args(
        ["--arch", "llama3.2-3b", "--no-reduced", "--requests", "4",
         "--prompt-len", "1024", "--gen", "16", "--slots", "4",
         "--depth", "2", "--device", "cuda"])
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
    print(f"phase 4b: profiled monolithic run, {eng.stats['decode_steps']} "
          f"decode steps + {eng.stats['prefills']} prefills: wall "
          f"{dt * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (dt * 1e3):.1f}%); top device time:")
    for us, n, key in rows[:12]:
        print(f"    {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")


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
    logits = {}
    for name, model in (("kernel", bundle.model), ("plain", plain)):
        cache = model.init_cache(1, prompt.shape[1] + 1)
        logits[name] = model.prefill(params, prompt, cache)[0]
    diff = (logits["kernel"] - logits["plain"]).abs().max().item()
    top2 = torch.topk(logits["plain"], 2).values
    gap = (top2[0] - top2[1]).item()
    tok_k = int(torch.argmax(logits["kernel"]))
    tok_p = int(torch.argmax(logits["plain"]))
    print(f"phase 5: request 0 prefill logits, kernel vs plain path: max "
          f"|diff| = {diff:.4e} (tol {LOGIT_TOL}; logits std "
          f"{logits['plain'].std().item():.4f}, max "
          f"{logits['plain'].abs().max().item():.4f}); argmax {tok_k} vs "
          f"{tok_p}; plain top-2 gap {gap:.4e}")
    assert bool(torch.isfinite(logits["kernel"]).all())
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

    cfg = registry.config("llama3.2-3b")
    rec = kernel_checks(torch, ops, cfg)
    bundle, params, args, runs = serving_runs(torch, ops, serve)
    profile_run(torch, serve, bundle, params)
    end_to_end(torch, ops, serve, bundle, params, args, runs)

    kernels = []
    for name in sorted(rec):
        r = rec[name]
        launches = sum(run[3][name] for run in runs.values())
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
