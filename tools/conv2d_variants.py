"""Where the conv2d kernel's time goes: ``src/repro_torch/kernels/csrc/
conv2d.cu`` built again with one part changed or skipped at run time (a
condition the compiler cannot drop, so nothing else is optimised away),
each variant timed with CUDA events at the card shape (64, 112, 112, 3) x
(7, 7, 3, 64) float32, beside cuDNN (``F.conv2d`` channels-last, no
TF32).  The skipped variants' results are wrong; only their times count.

    PYTHONPATH=src python tools/conv2d_variants.py           # on the card

prints the card's name and power limit, each variant's registers and
spills (``ptxas -v``) and its device ms a launch, in turns (every variant,
then every variant again).  Every variant is one nvcc build (all started
at once) into ``build/kernels``.

    PYTHONPATH=<tree>/src python tools/conv2d_variants.py --sweep

times ``conv2d.launch`` of the ``repro_torch`` on the path (so two trees
compare in one run) at the paper's sweep shapes (1, hw, hw, 3) x (7, 7, 3,
8), hw 32 / 64 / 112, and at the card shape, beside cuDNN; where that
``conv2d`` has ``plan_warps``, also each of the two block sizes.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

from repro_torch.kernels import _build, conv2d

NEVER = "a.N < 0"   # false for every launch: the launcher refuses N < 1

# (variant, [(text of csrc/conv2d.cu, its replacement)])
VARIANTS = {
    "design": [],
    "Cin not a template (ci loop not unrolled)": [(
        "    return a.Cin == 3 && a.nchunk == 1\n",
        f"    return {NEVER} && a.nchunk == 1\n")],
    "inputs read at each (ky, ci), not the one before": [
        ("            for (int i = 0; i < NV * 4; ++i) in[i] = nxt[i];\n"
         "            if (ci + 1 < ccu)",
         "            load_in(xr);\n"
         "            for (int i = 0; i < NV * 4; ++i) in[i] = nxt[i];\n"
         f"            if ({NEVER} && ci + 1 < ccu)"),
        ("            else if (ky + 1 < KH)",
         f"            else if ({NEVER} && ky + 1 < KH)")],
    "8 warps a block": [(
        "constexpr int SMALL_WARPS = 4;", "constexpr int SMALL_WARPS = 8;")],
    "16 channel groups a block (64 channels)": [],
    "taps' FMAs channel-outer (o outer, j inner)": [(
        "              for (int j = 0; j < R; ++j)\n#pragma unroll\n"
        "                for (int o = 0; o < CG; ++o)\n"
        "                  acc[j][o] = fmaf(in[j + kx]",
        "              for (int o = 0; o < CG; ++o)\n#pragma unroll\n"
        "                for (int j = 0; j < R; ++j)\n"
        "                  acc[j][o] = fmaf(in[j + kx]")],
    "inputs read once a ky, not a (ky, ci)": [
        ("              load_in(xr + a.HR * a.HWP);",
         f"              load_in(xr + ({NEVER} ? a.HR * a.HWP : 0));")],
    "stores at the tile's end, not in the next tile's FMAs": [(
        "          if (pend_next < R) store_next();        // warp-uniform\n",
        f"          if ({NEVER} && pend_next < R) store_next();\n")],
    "no stores": [(
        "    if (pend_next < pend_nj) {",
        f"    if ({NEVER} && pend_next < pend_nj) {{")],
    "no halo copies after the first step": [(
        "    for (int p = tid; p < npix; p += NT) {",
        f"    for (int p = tid; (s == 0 || {NEVER}) && p < npix; p += NT) {{")],
    "weights read once a (ky, ci), not a tap": [(
        "              const float* wk = wr + kx * CG;",
        f"              const float* wk = wr + ({NEVER} ? kx * CG : 0);")],
}
# conv2d's plan of a variant, where not the design's: its warps a block
# (``plan_warps``), or conv2d.py constants in place of the design's
PLANS = {"8 warps a block": {"warps": 8, "SMALL_WARPS": 8},
         "16 channel groups a block (64 channels)": {"CGB_MAX": 16}}
CARD = ((64, 112, 112, 3), (7, 7, 3, 64))
SWEEP = [((1, hw, hw, 3), (7, 7, 3, 8)) for hw in (32, 64, 112)]


def build() -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (library, ptxas's lines for its kernels)}, one nvcc a
    variant that changes the source (the others share the design's), all
    started together."""
    src = (_build.CSRC / "conv2d.cu").read_text()
    out = _build.build_dir() / "conv2d_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        if name != "design" and not subs:
            continue
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source changed: {old!r}")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = cu.with_suffix(".so"), subprocess.Popen(
            [_build.nvcc(), *_build._flags(), "-Xptxas", "-v", "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = (ctypes.CDLL(str(so)), ptxas(log))
    return {name: libs.get(name, libs["design"]) for name in VARIANTS}


def ptxas(log: str) -> str:
    """ptxas's registers, spills and stack for each conv2d_kernel."""
    lines, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "conv2d_kernel" in fn and re.search(
                r"registers|spill|stack frame", line):
            lines.append(f"{fn}: {line.split('ptxas info    :')[-1].strip()}")
    return "\n".join(lines)


def run(fn, x: torch.Tensor, w: torch.Tensor,
        choices: dict | None = None) -> torch.Tensor:
    """``conv2d.launch``'s call through the C function ``fn`` (of a
    variant's library, or conv2d's own), planned with ``choices``: the
    block's ``warps`` and conv2d.py constants in place of the design's."""
    fn.argtypes, fn.restype = conv2d._ARGS, ctypes.c_int
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    consts = dict(choices or {})
    warps = consts.pop("warps", None)
    design = {k: getattr(conv2d, k) for k in consts}
    vars(conv2d).update(consts)
    try:
        sms = conv2d._sm_count(x.device)
        p = (conv2d.plan(n, h, wd, cin, kh, kw, cout, sms) if warps is None
             else conv2d.plan_warps(n, h, wd, cin, kh, kw, cout, sms, warps))
    finally:
        vars(conv2d).update(design)
    y = torch.empty((n, p.ho, p.wo, cout), dtype=x.dtype, device=x.device)
    _build.check(fn(_build.dtype_code(x, w), _build.ptr(x), _build.ptr(w),
                    _build.ptr(y), n, h, wd, cin, kh, kw, cout,
                    *conv2d.launch_args(p), int(cout % 8 == 0),
                    _build.stream_of(x)), "conv2d_variants")
    return y


def timed(fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls queued behind a
    ~0.1 s sleep kernel (so the events time the device), after a
    warm-up."""
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


def channels_last(x: torch.Tensor, w: torch.Tensor):
    """x and w as ``F.conv2d`` takes them, channels-last (cuDNN's NHWC)."""
    cl = torch.channels_last
    return (x.permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1).contiguous(memory_format=cl))


def sweep() -> None:
    """``conv2d.launch`` at the sweep and card shapes beside cuDNN, in two
    turns; and both block sizes where ``conv2d`` has ``plan_warps``."""
    import torch.nn.functional as F
    print(f"conv2d from {conv2d.__file__}")
    sizes = hasattr(conv2d, "plan_warps")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for turn in range(2):
        for (n, h, wd, cin), (kh, kw, _, cout) in SWEEP + [CARD]:
            x = torch.randn((n, h, wd, cin), generator=gen, device="cuda")
            w = torch.randn((kh, kw, cin, cout), generator=gen, device="cuda")
            iters = 20 if n > 1 else 200
            want = conv2d.launch(x, w)
            err = (want - conv2d.conv2d_plain(x, w)).abs().max().item()
            xc, wc = channels_last(x, w)
            line = (f"turn {turn}: ({n}, {h}, {wd}, {cin}) x ({kh}, {kw}, "
                    f"{cin}, {cout}): launch "
                    f"{timed(lambda: conv2d.launch(x, w), iters):.4f} ms "
                    f"(vs plain {err:.2e}), cuDNN "
                    f"{timed(lambda: F.conv2d(xc, wc), iters):.4f} ms")
            if sizes:
                fn = _build.bind(conv2d.NAME, "conv2d_launch", conv2d._ARGS)
                p = conv2d.plan(n, h, wd, cin, kh, kw, cout,
                                conv2d._sm_count(x.device))
                line += f"; plan: {p.nw} warps, grid {p.grid}"
                for k in (conv2d.WARPS, conv2d.SMALL_WARPS):
                    ms = timed(lambda: run(fn, x, w, {"warps": k}), iters)
                    same = torch.equal(run(fn, x, w, {"warps": k}), want)
                    line += (f"; {k} warps {ms:.4f} ms"
                             f"{'' if same else ' (other passes: bits)'}")
            print(line, flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conv2d_variants: needs an NVIDIA GPU")
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    if "--sweep" in sys.argv[1:]:
        sweep()
        return
    libs = build()
    for name, (_, regs) in libs.items():
        print(f"{name}:\n{regs}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    (n, h, wd, cin), (kh, kw, _, cout) = CARD
    x = torch.randn((n, h, wd, cin), generator=gen, device="cuda")
    w = torch.randn((kh, kw, cin, cout), generator=gen, device="cuda")
    fns = {name: lib.conv2d_launch for name, (lib, _) in libs.items()}
    want = run(fns["design"], x, w)
    x_cl, w_cl = channels_last(x, w)
    flops = 2 * n * (h - kh + 1) * (wd - kw + 1) * cout * kh * kw * cin
    for turn in range(2):
        print(f"turn {turn}: cuDNN {timed(lambda: F.conv2d(x_cl, w_cl), 20):.4f}"
              f" ms", flush=True)
        for name, fn in fns.items():
            k = PLANS.get(name)
            ms = timed(lambda: run(fn, x, w, k), 20)
            same = bool(torch.equal(run(fn, x, w, k), want))
            print(f"turn {turn}: {name:<44} {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.2f} TFLOP/s, bits = design's: {same}",
                  flush=True)
    print(f"SM clock MHz, its max, power W, read while the design runs: "
          f"{clocks_under_load(lambda: run(fns['design'], x, w))}")


def clocks_under_load(fn, calls: int = 1000) -> str:
    """nvidia-smi's SM clock, its maximum and the power draw, read while
    ``calls`` calls of ``fn`` run on the card."""
    for _ in range(calls):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                          "clocks.max.sm,power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    main()
