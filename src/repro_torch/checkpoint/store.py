"""Atomic, async checkpointing in the reference's file format.

Port of ``repro/checkpoint/store.py``, with its contract:

  * **Atomicity** — a checkpoint is written to ``<dir>/tmp.step_<n>.<pid>``
    and renamed into place after fsync; a crash mid-write never leaves a
    checkpoint that restore would pick up.
  * **Validity marker** — each checkpoint directory carries a ``_COMPLETE``
    file written last; :func:`latest_step` considers marked steps only.
  * **Async** — :meth:`CheckpointManager.save` copies the state to host
    memory (blocking on that copy only) and hands serialization and disk
    I/O to a writer thread.
  * **Retention** — the ``keep`` most recent checkpoints stay; older ones
    are deleted after a successful save.

The file is the reference's (store.py:21-26, 38-66, 117-160): ``RPK1``, a
codec tag (``z`` zstd, ``d`` zlib), then the compressed msgpack of
``{"meta": json string, "leaves": {path: {"dtype", "shape", "data"}}}``,
paths the reference's flattened tree paths (``params/layers/attn/wq``,
``opt/m/...``, ``opt/step``), so either package restores a file the other
wrote.  bfloat16 leaves are stored under the dtype string ``"bfloat16"``
as their raw 2-byte words, which is what the reference writes through
``ml_dtypes``.  The msgpack codec is the port's own (:mod:`._msgpack`),
and zstd is used when the ``zstandard`` package is present, zlib
otherwise: the standard library, numpy and torch are all it needs.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.core import tree as tree_mod

try:
    import zstandard as zstd
except ImportError:          # optional: fall back to stdlib zlib
    zstd = None

_STEP_RE = re.compile(r"^step_(\d+)$")
_COMPLETE = "_COMPLETE"

_MAGIC = b"RPK1"
_CODEC_ZSTD = b"z"
_CODEC_ZLIB = b"d"
# legacy (pre-header) files were always zstd; its frame magic for detection
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"


def _compress(raw: bytes, level: int) -> bytes:
    if zstd is not None:
        return _MAGIC + _CODEC_ZSTD \
            + zstd.ZstdCompressor(level=level).compress(raw)
    return _MAGIC + _CODEC_ZLIB + zlib.compress(raw, level)


def _decompress(buf: bytes) -> bytes:
    if buf[:4] == _MAGIC:
        codec, body = buf[4:5], buf[5:]
        if codec == _CODEC_ZSTD:
            if zstd is None:
                raise RuntimeError(
                    "checkpoint is zstd-compressed but zstandard is not "
                    "installed; `pip install zstandard` to restore it")
            return zstd.ZstdDecompressor().decompress(body)
        if codec == _CODEC_ZLIB:
            return zlib.decompress(body)
        raise ValueError(f"unknown checkpoint codec tag {codec!r}")
    # legacy headerless file: always zstd
    if buf[:4] == _ZSTD_FRAME_MAGIC:
        if zstd is None:
            raise RuntimeError(
                "legacy zstd checkpoint needs the zstandard package")
        return zstd.ZstdDecompressor().decompress(buf)
    return zlib.decompress(buf)


class HostLeaf:
    """One leaf copied to host memory: its dtype string as the file names
    it and a numpy array of its values (bfloat16: the raw 16-bit
    words)."""
    __slots__ = ("dtype", "arr")

    def __init__(self, dtype: str, arr: np.ndarray):
        self.dtype = dtype
        self.arr = arr


def to_host(leaf) -> HostLeaf:
    """A tensor (any device), a numpy array or a :class:`HostLeaf` as a
    host copy that later in-place updates of the tensor do not reach."""
    if isinstance(leaf, HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return HostLeaf("bfloat16", t.view(torch.int16).numpy())
        arr = t.numpy()
        return HostLeaf(str(arr.dtype), arr)
    arr = np.asarray(leaf)
    return HostLeaf(str(arr.dtype), arr)


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree: Any) -> dict[str, HostLeaf]:
    return {_key(path): to_host(leaf)
            for path, leaf in tree_mod.items(tree)}


def _from_record(rec: dict):
    """A stored leaf as a CPU tensor of its file dtype."""
    data, shape = rec["data"], tuple(rec["shape"])
    if rec["dtype"] == "bfloat16":
        words = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    arr = np.frombuffer(data, dtype=np.dtype(rec["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy())


def save_pytree(path: str, tree: Any, *, meta: Optional[dict] = None,
                level: int = 3) -> None:
    """Synchronous atomic save of one tree (tensors, numpy arrays or host
    leaves) to the file ``path``."""
    flat = _flatten(tree)
    payload = {
        "meta": json.dumps(meta or {}),
        "leaves": {
            k: {"dtype": v.dtype, "shape": list(v.arr.shape),
                "data": v.arr.tobytes()}
            for k, v in flat.items()
        },
    }
    raw = _msgpack.packb(payload)
    comp = _compress(raw, level)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(comp)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def restore_pytree(path: str, template: Any, *,
                   device=None) -> tuple[Any, dict]:
    """Restore ``path`` into the structure of ``template`` (a tree whose
    leaves have ``.shape``: tensors, meta tensors included).  Each leaf
    keeps the file's dtype and lands on ``device``, or else on its
    template leaf's device (the CPU for a meta or non-tensor leaf).
    Returns (tree, meta).  A leaf missing from the file raises
    ``KeyError``, one of another shape ``ValueError``."""
    with open(path, "rb") as f:
        raw = _decompress(f.read())
    payload = _msgpack.unpackb(raw)
    records = payload["leaves"]
    leaves = []
    for p, leaf in tree_mod.items(template):
        key = _key(p)
        if key not in records:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = records[key]
        want = tuple(leaf.shape)
        if tuple(rec["shape"]) != want:
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {tuple(rec['shape'])} "
                f"!= {want}")
        dev = device
        if dev is None:
            dev = getattr(leaf, "device", None)
            if dev is None or dev.type == "meta":
                dev = "cpu"
        leaves.append(_from_record(rec).to(dev))
    return tree_mod.unflatten(template, leaves), json.loads(payload["meta"])


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, _COMPLETE)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class CheckpointManager:
    """Directory layout: ``<root>/step_<n>/{state.ckpt,_COMPLETE}``
    (reference :178)."""

    def __init__(self, root: str, *, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._q: Optional[queue.Queue] = None
        self._err: Optional[BaseException] = None
        if async_write:
            self._q = queue.Queue(maxsize=2)
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, *, meta: Optional[dict] = None):
        """Copy to host, then write async (or sync without the writer
        thread)."""
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        host = tree_mod.map_(to_host, state)      # blocks on the copy only
        meta = dict(meta or {}, step=step)
        if self._q is None:
            self._write(step, host, meta)
        else:
            self._q.put((step, host, meta))

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except BaseException as e:
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: Any, meta: dict):
        d = os.path.join(self.root, f"step_{step}")
        tmp = os.path.join(self.root, f"tmp.step_{step}.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_pytree(os.path.join(tmp, "state.ckpt"), host, meta=meta)
        with open(os.path.join(tmp, _COMPLETE), "w") as f:
            f.write(json.dumps(meta))
        shutil.rmtree(d, ignore_errors=True)
        os.rename(tmp, d)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(self.root))
            if m and os.path.exists(
                os.path.join(self.root, m.group(0), _COMPLETE)))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore_latest(self, template: Any, *, device=None):
        """Returns (state, meta, step) or (None, None, None)."""
        step = latest_step(self.root)
        if step is None:
            return None, None, None
        state, meta = restore_pytree(
            os.path.join(self.root, f"step_{step}", "state.ckpt"),
            template, device=device)
        return state, meta, step

    def wait(self):
        """Drain pending async writes (call before exit / in tests)."""
        if self._q is not None:
            self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        if self._q is not None:
            self._q.put(None)
            self._thread.join(timeout=30)
