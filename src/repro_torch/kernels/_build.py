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
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("flash_attention", "flash_decode", "flash_prefill_chunk", "ssd",
           "matmul", "dotp", "conv2d")
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


def stream_of(t) -> P:
    import torch
    return P(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> P:
    return P(t.data_ptr()) if t is not None else P(None)
