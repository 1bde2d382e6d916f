"""EngineConfig: the serving engine's construction surface (port of
``repro/runtime/serving/config.py``).

``donate`` has no counterpart (the port's arena is written in place, so
there is no buffer to donate): passing it raises ``TypeError``.  An
unknown KV format, an invalid prefix-sharing setting, a ``speculative``
that is not a ``SpecConfig`` or comes with ``prefix_sharing``, a
``faults`` that is not a ``FaultPlan``, a ``health`` that is not a
``HealthConfig``, or a cap below 1 raises ``ValueError`` (reference
:84-94, :119-170).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import kv_format as kvf
from repro_torch.runtime.serving.chunking import validate_buckets
from repro_torch.runtime.serving.faults import FaultPlan
from repro_torch.runtime.serving.health import HealthConfig
from repro_torch.runtime.serving.speculative import SpecConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``max_slots``       decode-batch width (concurrent sequences)
    ``max_seq``         per-slot arena depth (cache rows)
    ``depth``           in-flight decode steps (0 = blocking dispatch)
    ``page_size``       cache-page granularity (rows) for admission control
    ``num_pages``       page-pool size; None = cover the full arena
    ``prefill_chunks``  bucket sizes for chunked prefill; None = monolithic
    ``prefill_budget``  prompt tokens ingested per engine step; None =
                        largest bucket
    ``prefix_sharing``  copy-on-write prefix cache: a request whose prompt
                        starts with a registered page-aligned prefix forks
                        onto the donor's pages and ingests only its tail
                        (needs chunked prefill)
    ``prefix_chain_cap`` None = a chain lives while a slot holds it; an int
                        keeps up to that many orphaned chains forkable
                        (needs ``prefix_sharing``, >= 1)
    ``kv_format``       KV-arena storage format (``core/kv_format.py``):
                        "fp32" (stores at the activation dtype), "bf16",
                        "int8" or "fp8" (the last two with per-row scales)
    ``speculative``     a ``SpecConfig``: draft-propose / chunk-verify
                        decoding (dense family; not with
                        ``prefix_sharing``); None = plain decode
    ``base_seed``       run-level sampling seed: a sampled request with
                        ``seed=None`` samples with it
    ``faults``          deterministic fault injection (:class:`FaultPlan`);
                        None = no injection.  Same plan + same traffic =>
                        the same failure interleaving
    ``health``          the degradation ladder (:class:`HealthConfig`);
                        None = no health monitoring
    ``admission_reclaim_cap``   orphan-chain reclaims per placement attempt
    ``admission_attempt_cap``   failed placements before a request departs
                        FAILED with a typed ``AdmissionRejected`` (None =
                        retry forever)
    ``admission_backoff_cap``   ceiling of the exponential admission
                        backoff, in engine steps
    ``preempt_cap``     preemption recomputes before a request departs
                        FAILED (``"recompute-cap"``); None = unbounded
    ``decode_graph``    on the card, replay the decode step as one
                        captured CUDA graph (the reference's compiled step),
                        and a sampled request's first draw as another;
                        False runs them eagerly there too.  On the CPU the
                        steps are always eager
    ``chunk_graph``     on the card, replay each chunk of chunked prefill
                        as the captured graph of its chunk length (the
                        reference's compiled chunk step); False runs the
                        chunks eagerly there too.  On the CPU they are
                        always eager
    """
    max_slots: int = 8
    max_seq: int = 256
    depth: int = 2
    page_size: int = 16
    num_pages: Optional[int] = None
    prefill_chunks: Optional[tuple[int, ...]] = None
    prefill_budget: Optional[int] = None
    prefix_sharing: bool = False
    prefix_chain_cap: Optional[int] = None
    kv_format: str = "fp32"
    speculative: Optional[SpecConfig] = None
    base_seed: int = 0
    faults: Optional[FaultPlan] = None
    health: Optional[HealthConfig] = None
    admission_reclaim_cap: int = 8
    admission_attempt_cap: Optional[int] = None
    admission_backoff_cap: int = 32
    preempt_cap: Optional[int] = None
    decode_graph: bool = True
    chunk_graph: bool = True

    def __post_init__(self):
        kvf.get(self.kv_format)
        for name in ("max_slots", "max_seq", "page_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"EngineConfig.{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.depth < 0:
            raise ValueError(f"EngineConfig.depth must be >= 0, "
                             f"got {self.depth}")
        if self.num_pages is not None and self.num_pages < 1:
            raise ValueError(f"EngineConfig.num_pages must be >= 1 or None, "
                             f"got {self.num_pages}")
        if self.prefill_chunks is not None:
            object.__setattr__(self, "prefill_chunks",
                               validate_buckets(self.prefill_chunks))
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError(
                f"EngineConfig.prefill_budget must be >= 1 or None, "
                f"got {self.prefill_budget}")
        if self.prefix_sharing and self.prefill_chunks is None:
            raise ValueError(
                "EngineConfig.prefix_sharing requires chunked prefill "
                "(prefill_chunks): forks resume ingestion at the divergence "
                "boundary, which monolithic prefill cannot express")
        if self.prefix_chain_cap is not None:
            if not self.prefix_sharing:
                raise ValueError(
                    "EngineConfig.prefix_chain_cap requires prefix_sharing")
            if self.prefix_chain_cap < 1:
                raise ValueError(
                    f"EngineConfig.prefix_chain_cap must be >= 1 or None, "
                    f"got {self.prefix_chain_cap}")
        if self.speculative is not None:
            if not isinstance(self.speculative, SpecConfig):
                raise ValueError(
                    f"EngineConfig.speculative must be a SpecConfig or "
                    f"None, got {type(self.speculative).__name__}")
            if self.prefix_sharing:
                raise ValueError(
                    "EngineConfig.speculative is unsupported with "
                    "prefix_sharing: the verify chunk would need the "
                    "composed share view threaded through the draft arena "
                    "as well")
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultPlan):
            raise ValueError(
                f"EngineConfig.faults must be a FaultPlan or None, "
                f"got {type(self.faults).__name__}")
        if self.health is not None and not isinstance(self.health,
                                                      HealthConfig):
            raise ValueError(
                f"EngineConfig.health must be a HealthConfig or None, "
                f"got {type(self.health).__name__}")
        if self.admission_reclaim_cap < 1:
            raise ValueError(
                f"EngineConfig.admission_reclaim_cap must be >= 1, "
                f"got {self.admission_reclaim_cap}")
        for name in ("admission_attempt_cap", "preempt_cap"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"EngineConfig.{name} must be >= 1 or "
                                 f"None, got {v}")
        if self.admission_backoff_cap < 1:
            raise ValueError(
                f"EngineConfig.admission_backoff_cap must be >= 1, "
                f"got {self.admission_backoff_cap}")

    def replace(self, **changes) -> "EngineConfig":
        """A copy with ``changes`` applied (validated again)."""
        return dataclasses.replace(self, **changes)
