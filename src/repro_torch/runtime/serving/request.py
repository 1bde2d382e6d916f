"""Serving request objects (copy of ``repro/runtime/serving/request.py``).

A :class:`Request` is immutable user input; :class:`RequestState` is the
scheduler's mutable bookkeeping for it.  States are host-only — device
state lives in the engine's slot batch.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np

from repro_torch.runtime.serving.sampling import GREEDY, SamplingParams


class Status(enum.Enum):
    WAITING = "waiting"        # queued, not yet admitted to a slot
    PREFILLING = "prefilling"  # owns a slot; prompt chunks being ingested
    RUNNING = "running"        # owns a slot; in the decode batch
    FINISHED = "finished"      # hit EOS or max_new_tokens; slot released
    TIMED_OUT = "timed_out"    # deadline expired; partial output kept
    FAILED = "failed"          # quarantined / rejected / capped; see
    #                            finish_reason ("nan-logits",
    #                            "admission-rejected", "recompute-cap",
    #                            "draining")
    MIGRATED = "migrated"      # evacuated for replay on another replica;
    #                            not a loss: the router resubmits the
    #                            Request and the (seed, position) contract
    #                            replays the identical stream there


#: statuses a request never leaves (slot released, output frozen);
#: MIGRATED is terminal for this replica only
TERMINAL = (Status.FINISHED, Status.TIMED_OUT, Status.FAILED,
            Status.MIGRATED)


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``prompt`` is a (S,) int32 token array.

    ``extras``: per-request prefill side inputs (whisper's ``frames``,
    llava's ``patch_embeds``), unbatched numpy arrays or tensors: the
    engine adds the batch dim and moves them to its device.

    ``deadline_ms`` (optional): wall-clock budget from submission; a
    request still waiting or resident past it departs ``TIMED_OUT`` with
    the tokens it has (a clean prefix of its fault-free stream).  It
    restarts from zero if the router migrates the request.  ``session``
    (optional): a multi-turn conversation key the router's affinity
    placement pins to one replica; the engine ignores it."""
    uid: Any
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    extras: Optional[dict] = None
    sampling: SamplingParams = GREEDY
    deadline_ms: Optional[float] = None
    session: Optional[Any] = None

    def __post_init__(self):
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"request {self.uid!r}: deadline_ms must be > 0")
        object.__setattr__(self, "prompt",
                           np.asarray(self.prompt, np.int32).reshape(-1))
        if self.prompt.size == 0:
            raise ValueError(f"request {self.uid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid!r}: max_new_tokens < 1")


@dataclasses.dataclass
class RequestState:
    request: Request
    status: Status = Status.WAITING
    slot: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    prefills: int = 0                     # >1 => recomputed after preemption
    finish_reason: Optional[str] = None   # "eos" | "max_new_tokens" |
    #                                       a departure's reason
    seq: int = 0                          # arrival order (scheduler-assigned)
    # chunked-prefill cursor (engine-owned; rewound to 0 on preemption so
    # recompute replays the identical chunk sequence)
    chunk_plan: Optional[list] = None
    chunk_idx: int = 0
    prefill_pos: int = 0
    # prefix-sharing bookkeeping (engine-owned).  A *forked* request reads
    # its first ``share_len`` cache rows from slot ``share_src``'s arena
    # region (the donor's refcounted prefix pages); its chunk plan is
    # re-cut to the unshared tail.  ``base_chunk_plan`` keeps the full
    # plan so preemption can rewind to an unforked state (re-admission
    # re-forks against whatever prefix pages are live *then*).
    share_src: Optional[int] = None       # donor region (None = unshared)
    share_len: int = 0                    # tokens read via shared pages
    base_chunk_plan: Optional[list] = None
    # service-time bookkeeping (engine-owned)
    submitted_at: Optional[float] = None  # engine clock at submit
    ttft_s: Optional[float] = None        # submit -> first token
    deadline_at: Optional[float] = None   # engine clock; None = none
    # recovery bookkeeping (scheduler-owned)
    preemptions: int = 0                  # recompute count (preempt_cap)
    admission_attempts: int = 0           # failed schedule() placements
    next_try_tick: int = 0                # admission backoff gate (ticks)
    rejection: Optional[Exception] = None  # AdmissionRejected, if so

    def reset_share(self) -> None:
        """Rewind to the unforked state (preemption): the full-prompt
        chunk plan is restored, the share mapping cleared."""
        self.share_src = None
        self.share_len = 0
        if self.base_chunk_plan is not None:
            self.chunk_plan = self.base_chunk_plan

    @property
    def done(self) -> bool:
        """Terminal: finished, timed out, failed or migrated."""
        return self.status in TERMINAL

    @property
    def prompt_len(self) -> int:
        return int(self.request.prompt.shape[0])

    def output(self) -> np.ndarray:
        return np.asarray(self.generated, np.int32)
