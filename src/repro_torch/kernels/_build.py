"""Build the CUDA kernels with nvcc into shared libraries and load them with
ctypes.

Each ``csrc/<name>.cu`` becomes one ``lib<name>-<hash>.so`` with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes).  The
hash covers every source under ``csrc/`` and the compiler flags, so an edit
rebuilds and an unchanged tree reuses the library.  Libraries are built at
first use into ``<repo>/build/kernels``; :func:`build_all` starts one nvcc
per source, all at once.

The C entry points take pointers and the CUDA stream as ``c_void_p`` and
return ``cudaGetLastError()`` after their launches; :func:`check` raises on
a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode",
           "flash_prefill_chunk", "ssd", "ssd_bwd", "matmul", "dotp",
           "conv2d")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: seconds each library took to build in this process (0.0 = reused)
BUILD_SECONDS: dict[str, float] = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags() -> list[str]:
    return ARCH_FLAGS + NVCC_FLAGS


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags()).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (path, tmp path, process or None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc, t0: float) -> None:
    if proc is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names=KERNELS) -> dict[str, float]:
    """Build every named kernel library, one nvcc per source started
    together; returns {name: build seconds} (0.0 for a reused library)."""
    with _LOCK:
        t0 = time.perf_counter()
        started = [(n, *_start(n)) for n in names if n not in _LIBS]
        for n, out, tmp, proc in started:
            _finish(n, out, tmp, proc, t0)
        for n, out, _, _ in started:
            _LIBS[n] = ctypes.CDLL(str(out))
    return {n: BUILD_SECONDS.get(n, 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name]
    return lib


def sass(name: str) -> str:
    """The SASS of kernel library ``name`` (built on first use), as the
    toolkit's ``cuobjdump --dump-sass`` prints it."""
    load(name)
    tool = Path(nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "--dump-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def resource_usage(name: str) -> dict[str, dict[str, int]]:
    """{kernel function: {"REG": registers a thread, "STACK": bytes,
    "LOCAL": bytes, ...}} of library ``name`` (built on first use), as the
    toolkit's ``cuobjdump --dump-resource-usage`` prints them; a kernel
    with no local arrays that has STACK or LOCAL above 0 spills."""
    load(name)
    tool = Path(nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-resource-usage",
                          str(_lib_path(name))], capture_output=True,
                         text=True, check=True).stdout
    res, cur = {}, None
    for line in out.splitlines():
        if "Function " in line:
            cur = line.split("Function ", 1)[1].strip().rstrip(":")
            res[cur] = {}
        elif cur is not None and "REG:" in line:
            res[cur] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)",
                                                         line)}
    return res


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{code}")


# launch helpers shared by the kernel wrappers ----------------------------------
P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

HEAD_DIMS = (8, 16, 32, 64, 128)      # instantiated in flash_common.cuh


def bind(name: str, fn: str, argtypes: list):
    """The C function ``fn`` of kernel library ``name`` with its argtypes
    set (pointers and the stream as c_void_p, so 64-bit values survive)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def require_cuda(name: str, *ts) -> None:
    """A kernel runs on CUDA tensors only; anything else is an error (the
    plain versions are the CPU path, chosen by ``ops``, never here)."""
    bad = {str(t.device) for t in ts if t is not None
           and t.device.type != "cuda"}
    if bad:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{sorted(bad)}")


def type_codes(q_dtype, kv_dtype) -> tuple[int, int]:
    """(q code, arena code) of the attention kernels, as their C entry
    points take them: q 0 float32 / 1 bfloat16; the arena 0 float32, 1
    bfloat16, 2 int8, 3 fp8 e4m3 (the last two scaled, core/kv_format.py).
    float32 q reads any of them; bfloat16 q reads bfloat16, int8 or fp8.
    Raises ``TypeError`` on anything else."""
    import torch
    qt = {torch.float32: 0, torch.bfloat16: 1}.get(q_dtype)
    kt = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}.get(kv_dtype)
    if qt is None or kt is None or (qt == 1 and kt == 0):
        raise TypeError(f"attention kernels take float32 or bfloat16 "
                        f"queries over an arena of their own type, bfloat16 "
                        f"(under float32), int8 or float8_e4m3fn; got q "
                        f"{q_dtype} over {kv_dtype}")
    return qt, kt


def dtype_code(*ts) -> int:
    """0 for float32, 1 for bfloat16 operands; raises on anything else or
    on mixed types."""
    import torch
    dt = ts[0].dtype
    if any(t.dtype != dt for t in ts):
        raise TypeError(f"mixed operand dtypes {[t.dtype for t in ts]}")
    code = {torch.float32: 0, torch.bfloat16: 1}.get(dt)
    if code is None:
        raise TypeError(f"kernel operands must be float32 or bfloat16, "
                        f"got {dt}")
    return code


def kv_codes(q, k, v) -> tuple[int, int]:
    """:func:`type_codes` of attention operands; k and v share a type."""
    if k.dtype != v.dtype:
        raise TypeError(f"mixed K/V dtypes {k.dtype}, {v.dtype}")
    return type_codes(q.dtype, k.dtype)


def scales(k, k_scale, v_scale) -> int:
    """1 for a scaled arena (int8 / fp8 K with f32 ``k_scale`` /
    ``v_scale`` of shape K.shape[:3] and one stride set, read in place),
    0 for an unscaled one (no scales); raises on anything between."""
    narrow = k.element_size() == 1
    if k_scale is None and v_scale is None and not narrow:
        return 0
    if not narrow or k_scale is None or v_scale is None:
        raise ValueError(f"scales go with an int8 / fp8 arena and only with "
                         f"one: arena {k.dtype}, k_scale "
                         f"{k_scale is not None}, v_scale "
                         f"{v_scale is not None}")
    import torch
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(k.shape[:3]):
            raise ValueError(f"scales must be float32 {tuple(k.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if k_scale.stride() != v_scale.stride():
        raise ValueError(f"k_scale and v_scale strides differ: "
                         f"{k_scale.stride()} vs {v_scale.stride()}")
    return 1


def scale_strides(k_scale) -> tuple[int, int, int]:
    """(batch, position, head) element strides of the scales (0s if
    none): the kernels read them in place."""
    return tuple(k_scale.stride()) if k_scale is not None else (0, 0, 0)


def head_dim_ok(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not instantiated (have {HEAD_DIMS})")


def int32_sizes(name: str, *sizes) -> None:
    """The C entry points take sizes as 32-bit ints."""
    if any(s >= 2 ** 31 for s in sizes):
        raise ValueError(f"{name}: size {max(sizes)} does not fit the "
                         f"kernel's 32-bit sizes")


def inner_contiguous(t):
    """``t`` with a unit-stride last axis (the kernels' one layout need)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def vec_ok(*ts) -> int:
    """1 if 16-byte vector loads are legal on every tensor: aligned base,
    every outer stride and the last extent multiples of the vector."""
    for t in ts:
        vec = 16 // t.element_size()
        if (t.data_ptr() % 16 or t.shape[-1] % vec
                or any(s % vec for s in t.stride()[:-1])):
            return 0
    return 1


def tma_ok(t) -> bool:
    """A TMA map can read ``t`` in place: a 16-byte aligned base and
    outer strides that are multiples of 16 bytes."""
    return not (t.data_ptr() % 16 or any(
        (s * t.element_size()) % 16 for s in t.stride()[:-1]))


def _padded_copy(t):
    """``t`` copied into rows padded to a 16-byte multiple, as a view of
    the first ``t.shape[-1]`` columns (strides and base TMA can read)."""
    import torch
    per = 16 // t.element_size()
    d = t.shape[-1]
    buf = torch.zeros((*t.shape[:-1], -(-d // per) * per), dtype=t.dtype,
                      device=t.device)
    buf[..., :d] = t
    return buf[..., :d]


def aligned(dt: int, *ts):
    """The operands as the kernels take them: for bf16 (``dt`` 1) every
    tensor 16-byte aligned with 16-byte strides (the tensor-core path's TMA
    maps and Q loads; a view that is not is copied), with ``vec`` 1; for
    f32 as given, with ``vec`` = :func:`vec_ok` of the K/V operands."""
    if dt == 0:
        return (*ts, vec_ok(*ts[1:]))
    import torch
    ts = tuple(t if vec_ok(t)
               else t.clone(memory_format=torch.contiguous_format)
               for t in ts)
    return (*ts, 1)


def arena_aligned(qt: int, kt: int, q, k, v):
    """:func:`aligned` for the arena kernels, whose K/V may be narrower
    than q (``kt`` from :func:`type_codes`).  An int8 / fp8 K/V under
    bfloat16 q needs only what TMA needs (:func:`tma_ok`); rows of fewer
    than 16 bytes (head_dim 8) are copied into 16-byte rows."""
    if kt < 2 or qt == 0:
        return aligned(qt, q, k, v)
    (q,) = aligned(qt, q)[:1]
    k, v = (t if tma_ok(t) else _padded_copy(t) for t in (k, v))
    return q, k, v, 1


def donor_table(name: str, b: int, share_src, share_len):
    """The arena kernels' donor table as they take it: (share_src,
    share_len) (b,) int32 contiguous on the device, or (None, None);
    raises unless both or neither are given, each of shape (b,)."""
    if share_src is None and share_len is None:
        return None, None
    if share_src is None or share_len is None:
        raise ValueError(f"{name}: share_src and share_len go together")
    import torch
    out = []
    for t in (share_src, share_len):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name}: donor table {tuple(t.shape)}, "
                             f"expected ({b},)")
        out.append(t.to(dtype=torch.int32).contiguous())
    return tuple(out)


def stream_of(t) -> P:
    import torch
    return P(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> P:
    return P(t.data_ptr()) if t is not None else P(None)
