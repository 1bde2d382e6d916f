"""Serving launcher: continuous batching over the port's engine.

``python -m repro_torch.launch.serve --arch llama3.2-3b --no-reduced
--requests 4 --prompt-len 1024 --gen 64 --slots 4 --depth 2``

Port of ``repro/launch/serve.py`` for every family (dense; moe:
``--arch qwen2-moe-a2.7b`` / ``qwen3-moe-30b-a3b``; ssm: ``--arch
mamba2-2.7b``; hybrid: ``--arch hymba-1.5b``, whose arena line gives both
its K/V bytes a row and its SSD state bytes a slot; vlm: ``--arch
llava-next-34b``, each request with its patch embeddings, which the arena
depth counts; encdec: ``--arch whisper-large-v3``, each request with its
frames, the arena line giving its cross K/V bytes a slot; both serve in
monolithic prefill only, as in the reference).  Runs on the card unless
``--device cpu``.
Weights are random, drawn from a ``torch.Generator`` seeded with 0 (the
reference always draws them from ``PRNGKey(0)``); prompts come from
``numpy.random.default_rng(0)`` as in the reference (odd requests get a
25%-shorter prompt, or ``--prompt-mix`` cycles given lengths, or
``--prompt-mix shared-prefix`` gives every request a common page-aligned
half of ``--prompt-len``, or ``--shared-prefix`` tokens, and a tail of its
own, reference serve.py:324-334); then each request's frames or patch
embeddings, N(0, 1) f32 from the same generator.
``--prefix-sharing`` (chunked prefill only) turns the copy-on-write prefix
cache on: later requests fork onto the first one's pages and ingest only
their tails.

Sampling as in the reference: ``--temperature`` > 0 makes a
``--sampling-mix`` fraction of the requests sample (spread evenly over
arrival order, the rest greedy) with ``--top-k`` / ``--top-p`` /
``--min-p``; ``--seed`` is the run's base sampling seed and request i
samples with ``--seed + i``, so a rerun replays the same streams.

``--speculative draft=<arch>:k=<n>[:k-max=<n>][:adaptive=0|1]`` turns on
speculative decoding: the registry arch, built reduced as in the reference,
proposes k tokens a round and the target verifies them in one chunk-shaped
pass; the streams stay those of plain decode.  A reduced draft has the
reduced vocabulary, so against a ``--no-reduced`` target the vocab check
refuses it; a full-width draft goes through ``EngineConfig(speculative=
SpecConfig(draft=<ArchConfig>))``.

Robustness as in the reference (serve.py:291-315): ``--deadline-ms``
gives every request a deadline (a request still in flight past it departs
TIMED_OUT with its partial output); ``--fault-plan site:rate[:seed],...``
injects deterministic faults over the sites alloc / chunk / decode /
logits / draft, seeded by ``--seed`` unless a site says otherwise;
``--health`` turns the degradation ladder on (default thresholds).  The
stats then end with a robustness line and the ladder's transitions.
``--replicas N`` (> 1) serves through the router over N engines on the
one card, sharing the model and its weights, placed by ``--placement``
(least-pressure, round-robin, affinity; request i has session
``s{i mod 2N}``); it prints the router's stats and one line a replica.

``--reduced`` (the default) builds the smoke-test width; ``--no-reduced``
builds the published config (the reference's flag is ``store_true`` with
``default=True`` and so can never be switched off).  On the card the
engine replays its decode steps (greedy and sampled) as captured CUDA
graphs; ``--no-decode-graph`` runs them eagerly
(``EngineConfig.decode_graph``).  Chunked prefill replays one captured
graph per chunk length; ``EngineConfig.chunk_graph`` (the namespace's
``chunk_graph``, no flag) runs the chunks eagerly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.runtime.serving import (DEFAULT_BUCKETS, GREEDY,
                                         PLACEMENT_POLICIES, EngineConfig,
                                         HealthConfig, Request, Router,
                                         RouterConfig, SamplingParams,
                                         ServingEngine, SpecConfig,
                                         parse_fault_plan)
from repro_torch.runtime.serving.engine import prefix_extra


def parse_speculative(text: str) -> SpecConfig:
    """Parse ``--speculative draft=<arch>:k=<n>[:k-max=<n>][:adaptive=0|1]``
    (and ``window`` / ``draft-seed`` / ``low`` / ``high`` / ``ema``) into a
    :class:`SpecConfig` (reference serve.py:82-104)."""
    fields: dict = {}
    for part in text.split(":"):
        key, sep, val = part.partition("=")
        if not sep:
            raise ValueError(f"--speculative: expected key=value, got "
                             f"{part!r}")
        key = key.replace("-", "_")
        if key == "draft":
            fields[key] = val
        elif key in ("k", "k_max", "window", "draft_seed"):
            fields[key] = int(val)
        elif key == "adaptive":
            fields[key] = bool(int(val))
        elif key in ("low", "high", "ema"):
            fields[key] = float(val)
        else:
            raise ValueError(f"--speculative: unknown key {key!r}")
    if "draft" not in fields:
        raise ValueError("--speculative requires draft=<arch>")
    return SpecConfig(**fields)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", required=True, choices=list(registry.ARCH_NAMES))
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--slots", type=int, default=None,
                   help="decode slots (default: --requests)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--pages", type=int, default=None,
                   help="cache pool pages (default: full arena)")
    p.add_argument("--prefill-mode", choices=["monolithic", "chunked"],
                   default="monolithic")
    p.add_argument("--chunk-buckets", default=None,
                   help="comma-separated chunk bucket sizes "
                        "(default 32,64,128,256,512)")
    p.add_argument("--prefill-budget", type=int, default=None,
                   help="max prompt tokens ingested per engine step "
                        "(default: largest bucket)")
    p.add_argument("--prompt-mix", default=None,
                   help="comma-separated prompt lengths cycled over the "
                        "requests, or 'shared-prefix' for a common prefix of "
                        "half --prompt-len (page-aligned) plus distinct "
                        "tails; overrides --prompt-len")
    p.add_argument("--shared-prefix", type=int, default=None,
                   help="the shared-prefix mix's common head in tokens "
                        "(cut to whole pages; default half --prompt-len)")
    p.add_argument("--prefix-sharing", action="store_true",
                   help="copy-on-write prefix cache: fork repeated "
                        "page-aligned prompt prefixes onto shared pages "
                        "(requires --prefill-mode chunked)")
    p.add_argument("--kv-format", choices=["fp32", "bf16", "int8"],
                   default="fp32",
                   help="KV-arena storage format (fp32 = stored at the "
                        "activation dtype; int8 adds per-row scales, "
                        "dequantized inside the attention kernels; fp8 "
                        "through EngineConfig)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature for sampled requests "
                        "(0 = greedy argmax for every request)")
    p.add_argument("--top-k", type=int, default=0,
                   help="keep only the k highest-probability tokens "
                        "(0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass bound in (0, 1]")
    p.add_argument("--min-p", type=float, default=0.0,
                   help="drop tokens below min-p * max token probability")
    p.add_argument("--seed", type=int, default=0,
                   help="run-level base PRNG seed; request i samples with "
                        "seed+i, so a rerun replays identical streams")
    p.add_argument("--sampling-mix", type=float, default=1.0,
                   help="fraction of requests that sample (evenly spread); "
                        "the rest decode greedily")
    p.add_argument("--speculative", default=None, metavar="SPEC",
                   help="speculative decoding: draft=<arch>:k=<n>"
                        "[:k-max=<n>][:adaptive=0|1]; a reduced registry "
                        "arch proposes k tokens a round, the target "
                        "verifies them in one chunk-shaped pass; the "
                        "streams stay those of plain decode")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request wall-clock deadline; a request still "
                        "in flight past it departs TIMED_OUT with its "
                        "partial output")
    p.add_argument("--fault-plan", default=None, metavar="PLAN",
                   help="deterministic fault injection: comma-separated "
                        "site:rate[:seed] entries over the sites "
                        "alloc/chunk/decode/logits/draft, e.g. "
                        "'alloc:0.05,logits:0.01:7'; seeded by --seed "
                        "unless a site gives its own, so a rerun replays "
                        "the same failure interleaving")
    p.add_argument("--health", action="store_true",
                   help="the degradation ladder (HEALTHY -> DEGRADED -> "
                        "SHEDDING -> DRAINING) at the default HealthConfig "
                        "thresholds; transitions print with the stats")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind the router (1 = a bare "
                        "engine); replicas share the model and its weights "
                        "on the one card")
    p.add_argument("--placement", choices=list(PLACEMENT_POLICIES),
                   default="least-pressure",
                   help="router placement policy (with --replicas > 1); "
                        "the streams are the same under every policy")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="smoke-test width (default); --no-reduced builds "
                        "the published config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--no-decode-graph", dest="decode_graph",
                   action="store_false",
                   help="run the decode step eagerly on the card too "
                        "(default: replay it as a captured CUDA graph)")
    # EngineConfig.chunk_graph has no flag; a caller may set the attribute
    p.set_defaults(chunk_graph=True)
    args = p.parse_args(argv)
    if args.prefix_sharing and args.prefill_mode != "chunked":
        p.error("--prefix-sharing requires --prefill-mode chunked")
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    return args


def build(args):
    """(bundle, params) for ``args``: the model on ``--device`` with random
    weights from seed 0."""
    bundle = registry.build(args.arch, reduced=args.reduced,
                            device=args.device)
    return bundle, bundle.model.init(0)


SHARED_PREFIX = "shared-prefix"


def shared_prefix_len(args) -> int:
    """The common prefix of the shared-prefix mix: ``--shared-prefix``
    (default half ``--prompt-len``) cut to whole pages, at least one
    page."""
    ps = args.page_size
    want = (args.shared_prefix if args.shared_prefix is not None
            else args.prompt_len // 2)
    return max(ps, want // ps * ps)


def prompt_lengths(args) -> list[int]:
    if args.prompt_mix == SHARED_PREFIX:
        n = shared_prefix_len(args) + max(1, args.prompt_len
                                          - shared_prefix_len(args))
        return [n] * args.requests
    if args.prompt_mix:
        mix = [int(x) for x in args.prompt_mix.split(",")]
        return [mix[i % len(mix)] for i in range(args.requests)]
    return [args.prompt_len if i % 2 == 0
            else max(1, args.prompt_len * 3 // 4)
            for i in range(args.requests)]


def prompts(args, vocab: int, rng=None) -> list[np.ndarray]:
    """The run's prompts, drawn from ``numpy.random.default_rng(0)`` (or
    ``rng``) as the reference draws them: the shared-prefix mix's common
    head first, then each tail; otherwise one prompt of each length in
    turn."""
    rng = np.random.default_rng(0) if rng is None else rng
    lens = prompt_lengths(args)
    if args.prompt_mix == SHARED_PREFIX:
        shared = shared_prefix_len(args)
        head = rng.integers(0, vocab, shared)
        return [np.concatenate([head, rng.integers(0, vocab, n - shared)])
                for n in lens]
    return [rng.integers(0, vocab, n) for n in lens]


def extras(args, cfg) -> list[dict]:
    """Each request's prefill side inputs (reference serve.py:353-360),
    drawn after the prompts from the same ``default_rng(0)``, f32: the
    encdec family's ``frames`` (enc_seq, d), the vlm family's
    ``patch_embeds`` (n_patch_tokens, d); empty dicts for the others."""
    rng = np.random.default_rng(0)
    prompts(args, cfg.vocab, rng)
    drawn = {}
    if cfg.family == "encdec":
        drawn["frames"] = rng.standard_normal(
            (args.requests, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        drawn["patch_embeds"] = rng.standard_normal(
            (args.requests, cfg.n_patch_tokens, cfg.d_model)
        ).astype(np.float32)
    return [{key: val[i] for key, val in drawn.items()}
            for i in range(args.requests)]


def engine_config(args, lens, prefix: int = 0) -> EngineConfig:
    """The run's EngineConfig; ``prefix``: the arena rows a request holds
    before its prompt (``engine.prefix_extra``), which its depth counts."""
    chunks = None
    if args.prefill_mode == "chunked":
        chunks = (tuple(int(x) for x in args.chunk_buckets.split(","))
                  if args.chunk_buckets else DEFAULT_BUCKETS)
    pad_slack = min(chunks) if chunks else 0
    return EngineConfig(
        max_slots=args.slots or args.requests,
        max_seq=max(lens) + prefix + args.gen + pad_slack + 1,
        depth=args.depth, page_size=args.page_size, num_pages=args.pages,
        prefill_chunks=chunks, prefill_budget=args.prefill_budget,
        prefix_sharing=args.prefix_sharing,
        speculative=(parse_speculative(args.speculative)
                     if args.speculative else None),
        kv_format=args.kv_format, base_seed=args.seed,
        faults=(parse_fault_plan(args.fault_plan, seed=args.seed)
                if args.fault_plan else None),
        health=HealthConfig() if args.health else None,
        decode_graph=args.decode_graph, chunk_graph=args.chunk_graph)


def sampling_plan(n_requests: int, *, temperature: float, top_k: int,
                  top_p: float, min_p: float, seed: int,
                  mix: float) -> list[SamplingParams]:
    """Per-request SamplingParams for a run (reference serve.py:117): a
    ``mix`` fraction of the requests sample (spread evenly over arrival
    order, Bresenham-style), the rest decode greedily.  Request i's seed is
    ``seed + i``, so streams differ but the run replays from one seed."""
    if temperature <= 0 or mix <= 0:
        return [GREEDY] * n_requests
    mix = min(mix, 1.0)
    return [
        SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                       min_p=min_p, seed=seed + i)
        if int((i + 1) * mix) > int(i * mix) else GREEDY
        for i in range(n_requests)
    ]


def requests(args, vocab: int, *, sessions: int = 0,
             cfg=None) -> list[Request]:
    """The run's requests: :func:`prompts`, sampled as
    :func:`sampling_plan` says, each with ``--deadline-ms``; ``sessions``
    > 0 gives request i the session ``s{i mod sessions}``; ``cfg`` (the
    model's config) gives each its :func:`extras`."""
    reqs = prompts(args, vocab)
    side = (extras(args, cfg) if cfg is not None
            else [None] * args.requests)
    plan = sampling_plan(args.requests, temperature=args.temperature,
                         top_k=args.top_k, top_p=args.top_p,
                         min_p=args.min_p, seed=args.seed,
                         mix=args.sampling_mix)
    return [Request(uid=i, prompt=reqs[i], max_new_tokens=args.gen,
                    sampling=plan[i], extras=side[i] or None,
                    deadline_ms=args.deadline_ms,
                    session=f"s{i % sessions}" if sessions else None)
            for i in range(args.requests)]


def make_engine(bundle, params, *, config: EngineConfig = None,
                **fields) -> ServingEngine:
    """The engine from an :class:`EngineConfig` (or its fields; reference
    serve.py:107)."""
    if config is None:
        config = EngineConfig(**fields)
    elif fields:
        config = config.replace(**fields)
    return ServingEngine(bundle.model, bundle.cfg, params, config=config)


def generate(bundle, params, prompts: np.ndarray, *, gen_tokens: int,
             depth: int = 2, extras=None, max_slots=None,
             page_size: int = 16, num_pages=None) -> np.ndarray:
    """prompts: (B, S) int.  Returns (B, gen_tokens) int32 greedy tokens.

    A batch-of-equal-length wrapper over the engine (the examples'
    surface; reference serve.py:204).  ``extras`` are batched (B, ...)
    prefill side inputs, sliced per request.
    """
    b, s = prompts.shape
    eng = make_engine(bundle, params, max_slots=max_slots or b,
                      max_seq=s + prefix_extra(bundle.cfg) + gen_tokens + 1,
                      depth=depth, page_size=page_size, num_pages=num_pages)
    for i in range(b):
        eng.submit(Request(
            uid=i, prompt=np.asarray(prompts[i], dtype=np.int32),
            max_new_tokens=gen_tokens,
            extras={k: np.asarray(v)[i] for k, v in (extras or {}).items()}
            or None))
    out = eng.run()
    return np.stack([out[i] for i in range(b)], axis=0)


def engine(bundle, params, args, **changes) -> ServingEngine:
    """The engine for ``args`` with the ``args.requests`` requests
    submitted (on the card its greedy decode graph captured, and its
    sampled one if a request samples).  ``changes``: EngineConfig fields
    set past what the flags say (e.g. ``speculative`` with a full-width
    draft)."""
    reqs = requests(args, bundle.cfg.vocab, cfg=bundle.cfg)
    config = engine_config(
        args, [r.prompt.size for r in reqs],
        prefix_extra(bundle.cfg)).replace(**changes)
    eng = make_engine(bundle, params, config=config)
    for r in reqs:
        eng.submit(r)
    return eng


def router(bundle, params, args, **changes) -> Router:
    """``args.replicas`` engines behind a :class:`Router` (placement
    ``--placement``), sharing ``bundle.model`` and ``params``, with the
    run's requests submitted; sessions cycle over twice the fleet so the
    affinity policy has pins to keep (reference serve.py:380-390)."""
    reqs = requests(args, bundle.cfg.vocab, sessions=2 * args.replicas,
                    cfg=bundle.cfg)
    config = engine_config(
        args, [r.prompt.size for r in reqs],
        prefix_extra(bundle.cfg)).replace(**changes)
    fleet = Router(bundle.model, bundle.cfg, params,
                   config=RouterConfig(replicas=args.replicas,
                                       placement=args.placement,
                                       engine=config))
    for r in reqs:
        fleet.submit(r)
    return fleet


def serve(bundle, params, args):
    """Serve ``args.requests`` requests; returns (engine, {uid:
    tokens}, wall seconds).  The clock starts after the engine is built
    (and its decode graphs captured) and stops after the device finished."""
    eng = engine(bundle, params, args)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    out = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, out, time.perf_counter() - t0


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def report_stats(eng: ServingEngine) -> None:
    stats = dict(eng.stats)
    ttft = sorted(stats.pop("ttft_s", {}).values())
    print("engine:", stats)
    units = ([f"{stats['kv_row_bytes']} bytes/row"]
             if "kv_row_bytes" in stats else []) \
        + ([f"{eng.state_bytes_per_slot} state bytes/slot"]
           if eng.state_bytes_per_slot else [])
    print(f"arena: {eng.arena_bytes / 1e6:.2f} MB resident "
          f"(kv_format={eng.kv_format}, {', '.join(units)}, "
          f"written in place)")
    total = max(stats["requests"], 1)
    sampled = stats["sampled_requests"]
    per_req = (f"{stats['sampled_steps'] / sampled:.1f} sampling "
               f"steps/request" if sampled else "n/a (greedy-only run)")
    print(f"sampler: base_seed={eng.base_seed} "
          f"sampled={sampled}/{total} requests "
          f"(greedy={total - sampled}; {per_req}; keys fold "
          f"(seed, position) — batch/preemption invariant)")
    print("scheduler:", eng.scheduler.stats)
    if eng.prefix_sharing:
        ps = eng.cache_mgr.stats
        print(f"prefix cache: forks={stats['forks']} "
              f"shared_prompt_tokens={stats['shared_prompt_tokens']} "
              f"prefill_rows={stats['prefill_rows']} "
              f"(pages: registered={ps['registered_pages']} "
              f"shared={ps['shared_pages']} max_ref={ps['max_page_ref']}"
              + (f"; {stats['snapshots']} state snapshots of "
                 f"{stats['snapshot_bytes']} bytes"
                 if stats["snapshots"] else "") + ")")
    if eng.spec is not None:
        sp = eng.spec.stats
        print(f"speculative: k={eng.spec.k} "
              f"accepted={sp['accepted']}/{sp['proposed']} proposals "
              f"(rate={eng.spec.acceptance_rate:.3f}) "
              f"rounds={sp['rounds']} resamples={sp['resamples']} "
              f"k_changes={sp['k_changes']} "
              f"verify_compiles={stats['spec_verify_compiles']} "
              f"draft_steps={stats['spec_draft_steps']}")
    for name, g in named_graphs(eng):
        if g is not None:
            print(f"{name} graph: warm-up {g.warmup_s * 1e3:.1f} ms, "
                  f"capture {g.capture_s * 1e3:.1f} ms, pool "
                  f"{g.pool_bytes / 1e6:.1f} MB, {g.replays} replays of "
                  f"{g.launches} kernel launches")
    if ttft:
        print(f"ttft_s: mean={np.mean(ttft):.4f} "
              f"p50={_percentile(ttft, 50):.4f} "
              f"p90={_percentile(ttft, 90):.4f} "
              f"max={max(ttft):.4f} (n={len(ttft)})")
    if eng._injector is not None or eng.health is not None:
        # what the fault plan did and where the ladder ended up
        fired = dict(stats.get("faults", {}))
        overruns = stats.get("deadline_overrun_s", {})
        print(f"robustness: health={stats.get('health', 'n/a')} "
              f"transitions={stats.get('health_transitions', 0)} "
              f"faults={fired} poisoned={stats['poisoned']} "
              f"quarantined={stats['quarantined']} "
              f"timed_out={stats['timed_out']} failed={stats['failed']} "
              f"deadline_overruns={len(overruns)}")
        if eng.health is not None:
            for step, frm, to, why in eng.health.transitions:
                print(f"  health step {step}: {frm} -> {to} ({why})")


def named_graphs(eng) -> list:
    """(name, graph) of every graph the engine may hold (None where it
    holds none): the decode steps, the first draw, the chunk steps, and
    under speculative decoding the draft's micro-steps and chunk steps and
    the verify steps."""
    graphs = [("greedy decode", eng.graph),
              ("sampled decode", eng.sampled_graph),
              ("first draw", eng.draw_graph)]
    graphs += [(f"chunk {c}", g) for c, g in sorted(eng.chunk_graphs.items())]
    if eng.spec is not None:
        graphs += [("greedy draft", eng.draft_graph),
                   ("sampled draft", eng.sampled_draft_graph)]
        graphs += [(f"draft chunk {c}", g)
                   for c, g in sorted(eng.draft_chunk_graphs.items())]
        graphs += [(f"verify k={k} {'sampled' if smp else 'greedy'}", g)
                   for (k, smp), g in sorted(eng.verify_graphs.items())]
    return graphs


def serve_fleet(bundle, params, args):
    """Serve ``args.requests`` requests through ``args.replicas`` replicas;
    returns (router, {uid: tokens}, wall seconds), clocked as
    :func:`serve`."""
    fleet = router(bundle, params, args)
    cuda = bundle.model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(bundle.model.device)
    t0 = time.perf_counter()
    out = fleet.run()
    if cuda:
        torch.cuda.synchronize(bundle.model.device)
    return fleet, out, time.perf_counter() - t0


def main(argv=None):
    args = parse_args(argv)
    bundle, params = build(args)
    ops.reset_launch_counts()
    if args.replicas > 1:
        fleet, out, dt = serve_fleet(bundle, params, args)
        total = sum(o.size for o in out.values())
        slots = fleet.config.engine.max_slots
        print(f"{args.arch}: {args.requests} requests over "
              f"{args.replicas} replicas ({args.placement}), {total} "
              f"tokens in {dt:.2f}s = {total / dt:.1f} tok/s "
              f"(device={args.device}, depth={args.depth}, "
              f"slots={slots}/replica, prefill={args.prefill_mode})")
        print("router:", fleet.stats)
        for row in fleet.replica_stats():
            print("  replica:", row)
        print("kernel launches:", ops.launch_counts())
        print("first request:", out[0][:16], "...")
        return 0
    eng, out, dt = serve(bundle, params, args)
    total = sum(o.size for o in out.values())
    print(f"{args.arch}: {args.requests} requests, {total} tokens in "
          f"{dt:.2f}s = {total / dt:.1f} tok/s (device={args.device}, "
          f"depth={args.depth}, slots={eng.max_slots}, "
          f"prefill={args.prefill_mode})")
    report_stats(eng)
    print("kernel launches:", ops.launch_counts())
    print("first request:", out[0][:16], "...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
