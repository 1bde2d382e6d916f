"""One-card dry run: trace every (arch x shape) cell at full size.

Port of ``repro/launch/dryrun.py``.  For each cell the reference builds
the full-size model abstractly, lowers and compiles its step for a
256-chip and a 512-chip mesh, and reads the roofline terms off the
optimized HLO.  Here each cell's step is traced instead (``trace_cell``):
the full-size model with meta parameters (shapes and dtypes, no storage,
so nothing is allocated), its inputs from ``registry.Bundle.input_specs``,
the step run under ``core.cost.CostMode`` with every kernel charged once
from its module's ``cost()`` (``kernels.counting.counting_kernels``): the train
step with AdamW, ``prefill`` or ``decode_step``.  ``analyse`` derives the
three roofline terms on the H100's data-sheet constants
(``core/roofline.py``) and the trace's peak live bytes, and ``run_cell``
writes one JSON per cell to ``--out`` (default ``dryrun_out/``, which git
ignores).

    python -m repro_torch.launch.dryrun [--arch A ...] [--shape S ...]

runs on a host with no card.  Everything that needs a mesh (``--mesh``
single / multi / both, ``--rule``, the ``hier*`` reductions,
``--no-zero1``, ``--moe-dispatch local``, ``--tp-reduce``, ``--remat
save_tp``) raises: it comes with the multi-device port (ROADMAP 1.11).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import cost as cost_mod
from repro_torch.core import roofline, tree
from repro_torch.kernels import counting
from repro_torch.models import convert, layers, registry
from repro_torch.optim import adamw_init
from repro_torch.runtime.trainer import TrainConfig, make_train_step

MESH = "one-card"
DEFAULT_OUT = "dryrun_out"


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful math" numerator of the roofline fraction)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape: ShapeConfig) -> float:
    """6·N·D for training, 2·N·D (+attention) for serving, per step (the
    reference's formula, :42-78, unchanged)."""
    n = cfg.n_active_params()
    b, s = shape.global_batch, shape.seq_len
    nh, hd = cfg.n_heads, cfg.hd
    if shape.kind == "train":
        flops = 6.0 * n * b * s
        if cfg.family != "ssm":
            # causal attention math (QK^T + PV, fwd+bwd = 3x fwd, half mask)
            flops += 3.0 * cfg.n_layers * 2.0 * nh * hd * b * s * s
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * n * b * s
        if cfg.family != "ssm":
            flops += cfg.n_layers * 2.0 * nh * hd * b * s * s
        return flops
    # decode: one token against a KV of length s
    flops = 2.0 * n * b
    if cfg.family == "ssm":
        ss = cfg.ssm
        di = ss.d_inner(cfg.d_model)
        flops += cfg.n_layers * 4.0 * di * ss.d_state * b
    else:
        window = cfg.attn_window or s
        kv = []
        for i in range(cfg.n_layers):
            if cfg.family == "hybrid":
                glob = {0, cfg.n_layers // 2, cfg.n_layers - 1}
                kv.append(s if i in glob else min(window, s))
            else:
                kv.append(s)
        flops += sum(4.0 * nh * hd * k * b for k in kv)
    return flops


# ---------------------------------------------------------------------------
# the trace of one cell
# ---------------------------------------------------------------------------

def step_of(model, kind: str, specs: dict, tcfg: TrainConfig, params,
            opt=None):
    """(the cell's step as a no-argument call, the tensors it takes in):
    the train step with AdamW (``tcfg``; ``opt`` its state, a fresh one
    by default), ``prefill`` or ``decode_step`` on ``params`` and the
    cell's ``specs``.  The step is the steady one: the RoPE table that the
    first call on a device builds (``layers.rope_table``, once a process)
    is built here, so a trace counts the same whichever step of the
    process it follows."""
    layers.rope_table(model.cfg, tree.leaves(params)[0].device)
    if kind == "train":
        step = make_train_step(model, tcfg)
        opt = adamw_init(params) if opt is None else opt
        return (lambda: step(params, opt, specs)), [params, opt, specs]
    if kind == "prefill":
        extras = {k: v for k, v in specs.items()
                  if k not in ("tokens", "cache")}

        def prefill():
            with torch.no_grad():
                return model.prefill(params, specs["tokens"], specs["cache"],
                                     **extras)
        return prefill, [params, specs]

    def decode():
        with torch.no_grad():
            return model.decode_step(params, specs["token_t"], specs["cache"],
                                     specs["pos"])
    return decode, [params, specs]


def trace_cell(arch: str, shape_name: str, *, tcfg: TrainConfig,
               naive_attention: bool = False):
    """(CostMode, meta) for one grid cell, traced at full size on meta
    tensors."""
    bundle = registry.build(
        arch, device="meta",
        kernels=counting.counting_kernels(naive_attention=naive_attention))
    cfg, shape = bundle.cfg, SHAPES[shape_name]
    params = convert.abstract_params(cfg)
    specs = bundle.input_specs(shape_name)
    fn, inputs = step_of(bundle.model, shape.kind, specs, tcfg, params)
    t0 = time.time()
    with cost_mod.CostMode() as mode:
        mode.track(inputs)
        argument = mode.live_bytes
        fn()
    meta = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
        "kind": shape.kind, "t_trace_s": round(time.time() - t0, 1),
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "argument_bytes": argument,
    }
    return mode, meta


def analyse(mode: cost_mod.CostMode, meta: dict, cfg, shape) -> dict:
    """The cell's record: the roofline terms of the traced cost on the
    H100's constants, the trace's memory, its kernel launches."""
    cost = mode.cost
    terms = roofline.derive(cost, model_flops_global=model_flops(cfg, shape),
                            n_chips=meta["chips"])
    rec = {k: v for k, v in meta.items() if k != "argument_bytes"}
    rec["roofline"] = terms.as_dict()
    rec["roofline"]["dot_flops_per_chip"] = cost.dot_flops
    rec["roofline"]["transcendentals_per_chip"] = cost.transcendentals
    rec["roofline"]["collective_wire"] = {
        k: float(v) for k, v in cost.collective_wire.items()}
    rec["roofline"]["copied_bytes_per_chip"] = cost_mod.copied_bytes(cost)
    rec["kernels"] = dict(sorted(mode.kernels.items()))
    if cost.warnings:
        rec["analyzer_warnings"] = cost.warnings[:10]
    argument = meta["argument_bytes"]
    rec["memory"] = {
        "argument_size_in_bytes": int(argument),
        "temp_size_in_bytes": int(mode.peak_bytes - argument),
        "peak_bytes": int(mode.peak_bytes),
        "per_chip_gib": round(mode.peak_bytes / 2 ** 30, 3),
    }
    return rec


def run_cell(arch: str, shape_name: str, *, out_dir: str, tcfg: TrainConfig,
             naive_attention: bool = False, tag: str = "baseline",
             verbose: bool = True) -> dict:
    cfg = registry.config(arch)
    shape = SHAPES[shape_name]
    ok, why = registry.cell_supported(cfg, shape)
    cell_id = f"{arch}__{shape_name}__{MESH}"
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
               "skipped": True, "reason": why}
    else:
        try:
            mode, meta = trace_cell(arch, shape_name, tcfg=tcfg,
                                    naive_attention=naive_attention)
            rec = analyse(mode, meta, cfg, shape)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
                   "failed": True, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
    rec["tag"] = tag
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{cell_id}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        r = rec.get("roofline", {})
        status = ("SKIP: " + rec["reason"] if rec.get("skipped")
                  else "FAIL: " + rec.get("error", "")
                  if rec.get("failed") else
                  f"dom={r['dominant']} frac={r['roofline_fraction']:.3f} "
                  f"c/m/w(ms)={1e3 * r['compute_s']:.2f}/"
                  f"{1e3 * r['memory_s']:.2f}/{1e3 * r['collective_s']:.2f}"
                  f" peak {rec['memory']['per_chip_gib']:.1f} GiB"
                  f" trace {rec['t_trace_s']:.1f} s")
        print(f"[{cell_id}] {status}", flush=True)
    return rec


def _needs_mesh(what: str):
    raise NotImplementedError(
        f"{what} needs a device mesh: it comes with the multi-device port "
        f"(ROADMAP 1.11); the dry run traces one card")


def check_one_card(args) -> None:
    """Raise for every flag that needs a mesh (ROADMAP 1.11)."""
    if args.mesh not in (None, MESH):
        _needs_mesh(f"--mesh {args.mesh}")
    if args.rule:
        _needs_mesh("--rule")
    if args.reduction != "gspmd":
        _needs_mesh(f"--reduction {args.reduction}")
    if args.no_zero1:
        _needs_mesh("--no-zero1 (ZeRO-1 shards the moments over data)")
    if args.moe_dispatch != "global":
        _needs_mesh(f"--moe-dispatch {args.moe_dispatch}")
    if args.tp_reduce != "auto":
        _needs_mesh(f"--tp-reduce {args.tp_reduce}")
    if args.remat == "save_tp":
        _needs_mesh("--remat save_tp")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", action="append", default=None,
                   choices=list(registry.ARCH_NAMES), help="repeatable")
    p.add_argument("--shape", action="append", default=None,
                   choices=list(SHAPES))
    p.add_argument("--mesh", default=None,
                   choices=[MESH, "single", "multi", "both"],
                   help="one-card only; the meshes need ROADMAP 1.11")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--tag", default="baseline")
    p.add_argument("--reduction", default="gspmd",
                   choices=["gspmd", "hier", "hier_tree", "hier_ef8"])
    p.add_argument("--remat", default="full",
                   choices=["none", "full", "dots", "save_tp"])
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--no-zero1", action="store_true")
    p.add_argument("--moe-dispatch", default="global",
                   choices=["global", "local"])
    p.add_argument("--tp-reduce", default="auto",
                   choices=["auto", "bf16_dot", "bf16_scatter"])
    p.add_argument("--attn-impl", default="flash",
                   choices=["flash", "naive"],
                   help="naive: trace the plain attention's ops in place of "
                        "the kernel's cost")
    p.add_argument("--rule", action="append", default=None,
                   metavar="logical=mesh1,mesh2")
    args = p.parse_args(argv)
    check_one_card(args)

    tcfg = TrainConfig(remat=args.remat, microbatches=args.microbatches)
    archs = args.arch or list(registry.ARCH_NAMES)
    shapes = args.shape or list(SHAPES)
    t0 = time.time()
    results = [run_cell(arch, shape, out_dir=args.out, tcfg=tcfg,
                        naive_attention=args.attn_impl == "naive",
                        tag=args.tag)
               for arch in archs for shape in shapes]
    n_ok = sum(1 for r in results
               if not r.get("failed") and not r.get("skipped"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    n_fail = sum(1 for r in results if r.get("failed"))
    print(f"\ndry-run: {n_ok} traced, {n_skip} skipped (documented), "
          f"{n_fail} FAILED in {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
