"""Where the bf16 SSD backward's time goes: ``csrc/ssd_bwd.cu`` built again
with one part of its tensor-core kernels skipped at run time (a condition
the compiler cannot drop, so nothing else is optimised away), each
variant's kernels timed by torch.profiler at phase 3t's training shapes.
The skipped variants' results are wrong; only their device times count.

    python -m repro_torch.kernels.ssd_bwd_parts      # on the card

prints, per shape and variant, each kernel's device ms a call.  Every
variant is one nvcc build (all started at once) into ``build/kernels``.
"""
from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from repro_torch.kernels import _build, ssd_bwd

NEVER = "a.r < 0"   # false for every launch: the launcher refuses r < 1

# (variant, [(text of csrc/ssd_bwd.cu, its replacement)])
VARIANTS = {
    "all parts": [],
    "walk: no scratch stores": [(
        "        if (p < p16 && n < n16)\n          *reinterpret_cast<uint4*>",
        f"        if ({NEVER} && p < p16 && n < n16)\n"
        "          *reinterpret_cast<uint4*>")],
    "walk: no MMAs": [(
        "    for (int kb = 0; kb < 4; ++kb) {\n      // (weight",
        f"    for (int kb = 0; kb < ({NEVER} ? 4 : 0); ++kb) {{\n"
        "      // (weight")],
    "chunk: no next-head loads": [
        ("    if (h + 1 < h1) load_head(h + 1, buf ^ 1);",
         f"    if ({NEVER} && h + 1 < h1) load_head(h + 1, buf ^ 1);"),
        ("    if (h + 1 < h1)\n      load_state(S0s",
         f"    if ({NEVER} && h + 1 < h1)\n      load_state(S0s")],
    "chunk: no carries": [(
        "    if (hf == 0)\n      carry(Y, Sh, Sl, ecum, Cs, dcc);\n    else\n",
        f"    if ({NEVER} && hf == 0)\n      carry(Y, Sh, Sl, ecum, Cs, dcc);\n"
        f"    else if ({NEVER})\n")],
    "chunk: no W products": [
        ("    // row sums of W (.) C B^T, dC += W B\n    if (hf == 0) {",
         "    // row sums of W (.) C B^T, dC += W B\n"
         f"    if ({NEVER} && hf == 0) {{"),
        ("    } else {\n      // hf 1: W^T",
         f"    }} else if ({NEVER}) {{\n      // hf 1: W^T")],
    "chunk: no dx": [(
        "    // hi and lo terms in accumulators of their own: twice the chains)\n"
        "    {",
        "    // hi and lo terms in accumulators of their own: twice the chains)\n"
        f"    if ({NEVER}) {{")],
    "chunk: no L, no <dS, S0>": [
        ("    for (int k = 0; k < Q * Q / NT; ++k) {",
         f"    for (int k = 0; k < ({NEVER} ? Q * Q / NT : 0); ++k) {{"),
        ("        if (p >= p16 || n >= n16) break;",
         f"        if (!({NEVER}) || p >= p16 || n >= n16) break;")],
}
SHAPES = (("mamba2-2.7b", 160, 2, 2048, 64, 128),
          ("hymba-1.5b", 100, 2, 2048, 64, 16))


def build() -> dict[str, ctypes.CDLL]:
    """One library a variant, built by nvcc processes started together."""
    src = (_build.CSRC / "ssd_bwd.cu").read_text()
    out = _build.build_dir() / "ssd_bwd_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source changed: {old!r}")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build._flags(), "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out / f"v{i}.so"))
    return libs


def run(lib: ctypes.CDLL, x, la, B, C, dy) -> None:
    """``ssd_bwd.launch``'s call of the bf16 kernels, through ``lib``."""
    fn = lib.ssd_bwd_launch
    fn.argtypes, fn.restype = ssd_bwd._ARGS, ctypes.c_int
    bh, s, p = x.shape
    nb, _, n = B.shape
    dev, r, nch = x.device, bh // nb, -(-s // ssd_bwd.CHUNK)
    hs, sl = ssd_bwd.cut(r, nb, s, ssd_bwd._sm_count(dev), x.dtype)
    dx, dla = torch.empty_like(x), torch.empty((bh, s), device=dev)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    st = torch.empty((bh, nch, ssd_bwd.state_floats(n, p, x.dtype)),
                     device=dev)
    dst = torch.empty_like(st)
    pB = torch.empty((sl, nb, s, n), device=dev)
    pC = torch.empty_like(pB)
    ptr = _build.ptr
    _build.check(fn(1, ptr(x), ptr(la), ptr(B), ptr(C), ptr(dy), ptr(None),
                    ptr(dx), ptr(dla), ptr(dB), ptr(dC), ptr(st), ptr(dst),
                    ptr(pB), ptr(pC), x.stride(0), x.stride(1), la.stride(0),
                    la.stride(1), B.stride(0), B.stride(1), C.stride(0),
                    C.stride(1), dy.stride(0), dy.stride(1), bh, s, n, p, r,
                    hs, sl, _build.stream_of(x)), "ssd_bwd_parts")


def kernel_ms(fn, calls: int = 5) -> dict[str, float]:
    """{ssd_bwd kernel: device ms a call} of ``fn()`` under torch.profiler
    (its device events, read from Kineto's results), after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        m = re.search(r"ssd_bwd_\w+", e.name())
        if m and e.device_type() == DeviceType.CUDA:
            out[m.group(0)] = (out.get(m.group(0), 0.0)
                               + e.duration_ns() / 1e6 / calls)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_parts: needs an NVIDIA GPU")
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(3)
    print(torch.cuda.get_device_name(0))
    for label, bh, nb, s, p, n in SHAPES:
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (rn(bh, s, p) * 0.05).bfloat16()
        la = -torch.rand((bh, s), generator=gen, device="cuda") * 0.1
        B, C = rn(nb, s, n).bfloat16(), rn(nb, s, n).bfloat16()
        dy = rn(bh, s, p).bfloat16()
        for name, lib in libs.items():
            ms = kernel_ms(lambda: run(lib, x, la, B, C, dy))
            print(f"{label} {name:<26} " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(ms.items())), flush=True)


if __name__ == "__main__":
    main()
