"""Deterministic synthetic LM data pipeline with background prefetch.

Port of ``repro/data/pipeline.py``.  The dataset is stateless-resumable:
batch ``i`` is a pure function of ``(seed, i)`` (numpy's counter-based
Philox), so a run restarted from a checkpoint at step ``k`` sees exactly
the batches the lost run would have, and the batches equal the
reference's bit for bit (the same numpy draws).

The prefetcher keeps ``depth`` host-to-device copies in flight from a
worker thread.  On the card a batch is copied from pinned host memory with
``non_blocking=True`` on the default stream, which the training step runs
on too, so the step reads it after the copy; the pinned buffers ride on
the device batch (:class:`Batch`), alive until the step that consumed it
drops the batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import device as device_mod


class SyntheticLMDataset:
    """Zipf-ish token stream with next-token labels (reference :25)."""

    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2,
                 pad_fraction: float = 0.0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.pad_fraction = pad_fraction
        # Precompute the Zipf CDF once (vocab can be 256k: keep it f64).
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        w = ranks ** -zipf_a
        self._cdf = np.cumsum(w) / w.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed,
                                                   counter=[0, 0, 0, step]))
        u = rng.random((self.global_batch, self.seq_len + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.pad_fraction > 0:
            keep = rng.random((self.global_batch, self.seq_len)) \
                >= self.pad_fraction
            batch["loss_mask"] = keep.astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background host-to-device prefetch with a bounded queue (depth >= 1;
    reference :67).  ``put_fn`` maps a host batch to device tensors; it
    runs in the worker thread, so the copy of batch i + depth overlaps the
    step of batch i.  An error in the worker is raised by the next
    ``__next__``."""

    def __init__(self, it: Iterator[Any], put_fn: Callable[[Any], Any],
                 *, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(put_fn(item))
            except BaseException as e:   # surfaced on next __next__
                self._exc = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        while True:   # drain so the worker can exit
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


_SENTINEL = object()


class Batch(dict):
    """A device batch {name: tensor}; ``host`` holds the pinned host
    tensors its copies read, so they outlive the copies."""
    host: tuple = ()


def to_device(b: dict, device) -> Batch:
    """A host batch of numpy arrays as tensors on ``device``: on the card
    through pinned memory and a non-blocking copy, on the CPU as they
    are."""
    dev = torch.device(device)
    out = Batch()
    host = []
    for key, val in b.items():
        t = torch.from_numpy(np.ascontiguousarray(val))
        if dev.type == "cuda":
            t = t.pin_memory()
            host.append(t)
            t = t.to(dev, non_blocking=True)
        out[key] = t
    out.host = tuple(host)
    return out


def make_pipeline(cfg, shape, *, seed: int = 0, start_step: int = 0,
                  num_steps: Optional[int] = None, device="cuda",
                  extras_fn: Optional[Callable] = None,
                  prefetch: int = 2) -> Prefetcher:
    """End-to-end pipeline for (ArchConfig, ShapeConfig) (reference :119):
    batches ``start_step`` .. ``start_step + num_steps - 1`` (endless with
    None), ``extras_fn(step, batch)`` adding family inputs (frames, patch
    embeddings), as tensors on ``device``."""
    dev = device_mod.resolve(device)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=shape.seq_len,
                            global_batch=shape.global_batch, seed=seed)

    def gen():
        step = start_step
        while num_steps is None or step < start_step + num_steps:
            b = ds.batch(step)
            if extras_fn is not None:
                b = extras_fn(step, b)
            yield b
            step += 1

    return Prefetcher(gen(), lambda b: to_device(b, dev), depth=prefetch)


def family_extras_fn(cfg) -> Optional[Callable]:
    """Synthetic frontend stubs for encdec / vlm batches (reference :152),
    deterministic in the step: N(0, 1) f32 frames (Philox key 7) or patch
    embeddings (key 9) at counter ``step``.  The reference passes the
    counter as ``[step]``, which numpy refuses (an array counter needs 4
    words), so its launcher cannot make these batches; the port gives the
    step in numpy's integer form, the 256-bit counter ``step``."""
    if cfg.family == "encdec":
        def add_frames(step, b):
            rng = np.random.Generator(np.random.Philox(key=7, counter=step))
            b = dict(b)
            b["frames"] = rng.standard_normal(
                (b["tokens"].shape[0], cfg.enc_seq, cfg.d_model),
                dtype=np.float32)
            return b
        return add_frames
    if cfg.family == "vlm":
        def add_patches(step, b):
            rng = np.random.Generator(np.random.Philox(key=9, counter=step))
            b = dict(b)
            b["prefix_embeds"] = rng.standard_normal(
                (b["tokens"].shape[0], cfg.n_patch_tokens, cfg.d_model),
                dtype=np.float32)
            return b
        return add_patches
    return None
