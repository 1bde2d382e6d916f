"""Continuous-batching scheduler (port of ``repro/runtime/serving/
scheduler.py``: ``AdmissionRejected`` and ``Scheduler``).

Keeps the decode batch full every step: finished sequences retire and
release their slot + pages, waiting requests are admitted into free slots
as soon as pages exist for their prompt, and when cache growth runs out of
pages the **youngest** running sequence is preempted (pages freed, request
requeued in arrival order, deterministic recompute on re-admission:
greedy or sampled, the draws fold only (seed, position)).  Pages are
freed by refcount, so a departing fork drops only its references to a
donor's shared prefix pages, and a region still hosting shared pages is
skipped at admission.  Victim-is-youngest is the progress guarantee:
the oldest running sequence is never evicted.

Under faults the loop stays bounded: a head-of-line request whose
placement fails backs off exponentially in engine ticks and, past
``admission_attempt_cap`` failures, departs FAILED with a typed
:class:`AdmissionRejected`; a request preempted ``preempt_cap`` times
departs FAILED instead of recomputing again; :meth:`Scheduler.depart`
takes a request out of service from any non-terminal state (deadline,
quarantine, drain, migration).  Pure host logic.
"""
from __future__ import annotations

import collections
import heapq

from repro_torch.runtime.serving.cache import PagedKVCacheManager
from repro_torch.runtime.serving.request import Request, RequestState, Status


class AdmissionRejected(Exception):
    """A request was refused service: its admission attempts reached their
    cap (``finish_reason == "admission-rejected"``, the exception on
    ``RequestState.rejection``) or the replica sheds load (raised by
    ``ServingEngine.submit``).  ``replica``: the replica that refused,
    attached by the router before it re-raises."""

    def __init__(self, uid, reason: str, attempts: int = 0,
                 replica=None):
        at = "" if replica is None else f" by replica {replica}"
        super().__init__(f"request {uid!r} rejected{at} ({reason}) "
                         f"after {attempts} admission attempts")
        self.uid = uid
        self.reason = reason
        self.attempts = attempts
        self.replica = replica


class Scheduler:
    def __init__(self, max_slots: int, cache: PagedKVCacheManager, *,
                 prefix_extra: int = 0, max_len: int | None = None,
                 chunked: bool = False, admission_reclaim_cap: int = 8,
                 admission_attempt_cap: int | None = None,
                 admission_backoff_cap: int = 32,
                 preempt_cap: int | None = None):
        """``prefix_extra``: arena rows a request occupies beyond its prompt
        before it decodes (llava's patch rows).  ``max_len``: the per-slot
        arena depth (engine's max_seq).
        ``chunked``: admissions enter PREFILLING (the engine ingests prompt
        chunks across steps and calls :meth:`finish_prefill`) instead of
        going straight to RUNNING via one monolithic prefill.

        ``admission_reclaim_cap``: orphaned prefix chains reclaimed per
        placement before the head of the line waits a step.
        ``admission_attempt_cap`` (None = never): failed placements before
        a request departs FAILED, ``"admission-rejected"``, with
        exponential tick backoff between attempts up to
        ``admission_backoff_cap`` (backoff needs :meth:`schedule`'s
        ``tick``).  ``preempt_cap`` (None = never): recomputes before a
        request departs FAILED, ``"recompute-cap"``, keeping its tokens."""
        if max_slots < 1:
            raise ValueError(max_slots)
        if admission_reclaim_cap < 1:
            raise ValueError(f"admission_reclaim_cap must be >= 1, "
                             f"got {admission_reclaim_cap}")
        self.max_slots = max_slots
        self.cache = cache
        self.prefix_extra = prefix_extra
        self.max_len = max_len
        self.chunked = chunked
        self.admission_reclaim_cap = admission_reclaim_cap
        self.admission_attempt_cap = admission_attempt_cap
        self.admission_backoff_cap = admission_backoff_cap
        self.preempt_cap = preempt_cap
        self.waiting: collections.deque[RequestState] = collections.deque()
        self.running: dict[int, RequestState] = {}
        self._free_slots: list[int] = list(range(max_slots))
        heapq.heapify(self._free_slots)
        self._next_seq = 0
        self.stats = {"admitted": 0, "finished": 0, "preempted": 0,
                      "timed_out": 0, "failed": 0, "rejected": 0,
                      "migrated": 0}

    # -- intake --------------------------------------------------------------
    def submit(self, request: Request,
               chunk_plan: list | None = None) -> RequestState:
        # a request that can't fit the pool even alone would preempt itself
        # forever; a chunked request's padded final chunk occupies rows past
        # the prompt, so its worst case is max(padded plan, prompt + gen)
        worst = (request.prompt.shape[0] + self.prefix_extra
                 + request.max_new_tokens)
        if chunk_plan is not None:
            worst = max(worst, sum(chunk_plan))
        if self.cache.pages_for(worst) > self.cache.num_pages:
            raise ValueError(
                f"request {request.uid!r} needs {worst} cache rows but the "
                f"pool holds {self.cache.num_pages * self.cache.page_size}")
        if self.max_len is not None and worst > self.max_len:
            raise ValueError(
                f"request {request.uid!r} needs {worst} cache rows but a "
                f"slot holds max_seq={self.max_len}")
        st = RequestState(request, seq=self._next_seq, chunk_plan=chunk_plan,
                          base_chunk_plan=chunk_plan)
        self._next_seq += 1
        self.waiting.append(st)
        return st

    @property
    def all_done(self) -> bool:
        return not self.waiting and not self.running

    # -- admission -----------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def schedule(self, tick: int | None = None) -> list[RequestState]:
        """Admit FIFO-head requests into free slots (smallest first) while
        cache pages last; returns the newly admitted states (RUNNING, or
        PREFILLING under chunked prefill).  Admission reserves pages for
        prompt + prefix_extra + the first generated token, and under
        chunked prefill at least the padded chunk plan.  A slot whose
        region is pinned (it hosts live shared prefix pages of a departed
        donor) is skipped;
        when every candidate is refused, the least recently forked
        orphaned chain is reclaimed and the placement retried, at most
        ``admission_reclaim_cap`` times (reference scheduler.py:135-210).

        ``tick`` (the engine's step counter) engages the bounded retry: a
        head-of-line request whose placement failed waits until
        ``next_try_tick`` (exponential backoff) and, at
        ``admission_attempt_cap`` failures, departs FAILED with a typed
        :class:`AdmissionRejected` on ``RequestState.rejection``."""
        admitted = []
        while self.waiting and self._free_slots:
            st = self.waiting[0]
            if tick is not None and st.next_try_tick > tick:
                break                      # backing off; FIFO kept
            need = st.prompt_len + self.prefix_extra + 1
            if st.chunk_plan is not None:
                need = max(need, sum(st.chunk_plan))
            slot = None
            reason = "no-pages"
            reclaims = 0
            while slot is None:
                for cand in sorted(self._free_slots):
                    res = self.cache.allocate(cand, need)
                    if res:
                        slot = cand
                        break
                    reason = res.reason
                    if res.reason != "region-pinned":
                        break              # no pages yet
                if slot is None:
                    if reclaims >= self.admission_reclaim_cap \
                            or not self.cache.reclaim_orphan():
                        break
                    reclaims += 1
            if slot is None:
                st.admission_attempts += 1
                cap = self.admission_attempt_cap
                if cap is not None and st.admission_attempts >= cap:
                    st.rejection = AdmissionRejected(
                        st.request.uid, reason, st.admission_attempts)
                    self.depart(st, Status.FAILED, "admission-rejected")
                    self.stats["rejected"] += 1
                    continue               # rejected head: the next may fit
                if tick is not None:
                    st.next_try_tick = tick + min(
                        1 << (st.admission_attempts - 1),
                        self.admission_backoff_cap)
                break                      # head-of-line blocks
            self._free_slots.remove(slot)
            heapq.heapify(self._free_slots)
            self.waiting.popleft()
            st.slot = slot
            st.status = Status.PREFILLING if self.chunked else Status.RUNNING
            st.prefills += 1
            self.running[slot] = st
            self.stats["admitted"] += 1
            admitted.append(st)
        return admitted

    def finish_prefill(self, slot: int) -> RequestState:
        """The engine ingested the request's final prompt chunk: it joins
        the decode batch."""
        st = self.running[slot]
        if st.status != Status.PREFILLING:
            raise ValueError(f"slot {slot} is {st.status}, not PREFILLING")
        st.status = Status.RUNNING
        return st

    # -- per-step outcome ----------------------------------------------------
    def on_token(self, slot: int,
                 token: int) -> list[tuple[int, RequestState]]:
        """Record one sampled token for ``slot``: retirement (EOS /
        max_new_tokens) and cache growth for the next position, preempting
        the youngest running sequence (possibly this one) until the row
        fits.  Returns the departures ``(slot, state)``."""
        st = self.running.get(slot)
        if st is None:
            return []
        st.generated.append(int(token))
        req = st.request
        if req.eos_id is not None and int(token) == req.eos_id:
            return [self._finish(st, "eos")]
        if len(st.generated) >= req.max_new_tokens:
            return [self._finish(st, "max_new_tokens")]
        departures = []
        new_len = st.prompt_len + self.prefix_extra + len(st.generated) + 1
        while not self.cache.extend(slot, new_len):
            victim = max(self.running.values(), key=lambda s: s.seq)
            departures.append(self._preempt(victim))
            if victim is st:
                break
        return departures

    def on_tokens(self, slot: int,
                  tokens) -> tuple[int, list[tuple[int, RequestState]]]:
        """Commit a speculative round's tokens for ``slot`` in order,
        stopping at the first departure (reference scheduler.py:251-275):
        EOS or ``max_new_tokens`` retires the request, and a page-growth
        preemption of this slot (preempting another keeps the commit going)
        sends it back to WAITING for a recompute.  Tokens past the
        departure are dropped, so the stream ends where plain decode would
        end it.  Returns ``(n_committed, departures)``, the departures of
        every committed token as :meth:`on_token` gives them."""
        st = self.running.get(slot)
        departures: list[tuple[int, RequestState]] = []
        n = 0
        for token in tokens:
            if st is None or st.slot != slot \
                    or st.status != Status.RUNNING:
                break
            departures.extend(self.on_token(slot, int(token)))
            n += 1
            if self.running.get(slot) is not st:
                break
        return n, departures

    def depart(self, st: RequestState, status: Status,
               reason: str) -> int | None:
        """Take a request out of service abnormally (reference
        scheduler.py:286-317): ``TIMED_OUT`` (deadline), ``FAILED``
        (quarantine, admission rejection, recompute cap, drain) or
        ``MIGRATED`` (evacuation; the request replays elsewhere), keeping
        what it generated.  A WAITING request leaves the queue; a resident
        one releases its slot through the same refcount-ordered free as
        retirement, so a departing fork drops only its references to the
        donor's pages, and the scale sidecar goes with each page that
        pools.  A terminal request is left as it is.  Returns the released
        slot (None if the request held none)."""
        if st.done:
            return None
        slot = None
        if st.status == Status.WAITING:
            try:
                self.waiting.remove(st)
            except ValueError:
                pass
        elif st.slot is not None and self.running.get(st.slot) is st:
            slot = st.slot
            self._release(st)
        st.status = status
        st.finish_reason = reason
        key = {Status.TIMED_OUT: "timed_out",
               Status.MIGRATED: "migrated"}.get(status, "failed")
        self.stats[key] += 1
        return slot

    def _finish(self, st: RequestState,
                reason: str) -> tuple[int, RequestState]:
        slot = st.slot
        st.status = Status.FINISHED
        st.finish_reason = reason
        self._release(st)
        self.stats["finished"] += 1
        return slot, st

    def _preempt(self, st: RequestState) -> tuple[int, RequestState]:
        """Out of pages: drop the slot, requeue in arrival order.  Greedy
        decode is deterministic, so the recompute replays the same tokens;
        a victim caught mid-prefill rewinds its chunk cursor to 0, and a
        forked one to the unforked state (its shared-page references went
        with the release; re-admission re-forks against whatever chains
        are live then).  A request already preempted ``preempt_cap`` times
        departs FAILED (``"recompute-cap"``) instead, keeping its tokens."""
        if self.preempt_cap is not None \
                and st.preemptions >= self.preempt_cap:
            return self.depart(st, Status.FAILED, "recompute-cap"), st
        st.preemptions += 1
        slot = st.slot
        self._release(st)
        st.status = Status.WAITING
        st.generated.clear()
        st.chunk_idx = 0
        st.prefill_pos = 0
        st.reset_share()
        idx = 0
        for w in self.waiting:
            if w.seq > st.seq:
                break
            idx += 1
        self.waiting.insert(idx, st)
        self.stats["preempted"] += 1
        return slot, st

    def _release(self, st: RequestState) -> None:
        slot = st.slot
        self.running.pop(slot, None)
        self.cache.free(slot)
        heapq.heappush(self._free_slots, slot)
        st.slot = None
