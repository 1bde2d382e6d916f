"""Speculative decoding: draft-model proposals, chunk-shaped verify,
deterministic rollback (port of ``repro/runtime/serving/speculative.py``).

A small draft LM proposes ``k`` tokens a slot, one decode micro-step at a
time over its own slot arena; the target then scores all of them in ONE
chunk-shaped pass (``LM.verify_chunk`` over ``flash_prefill_chunk``'s
runtime causal boundary), so it reads its weights once a round instead of
once a token.  As in the reference, two properties of the port make the
committed stream the target's own stream, bit for bit:

  * **Verify is a prompt chunk.**  Row j of ``flash_prefill_chunk`` at
    q-position ``start + j`` attends exactly the keys ``flash_decode`` at
    ``pos = start + j`` does, with the same arithmetic (the chunk/decode
    bit pin), so the verify pass replays k sequential decode steps;
  * **Rollback has no PRNG state.**  Every draw's key folds only (request
    seed, absolute position), so the target's draw at each verify position
    (``sampling.verify_draws``, the Gumbel replay) equals the token plain
    decode would have sampled there.  Acceptance is exact token match
    against those draws (argmax match for a greedy slot).

Rollback is a host cursor: the rows a rejected proposal wrote in either
arena are dead (no query reads a row at or past its own position, and the
next round's writes start at the committed position).  The draft arena
shares the target's slot indices; prefill mirrors every prompt (and every
chunk) into it, so the two arenas agree on rows [0, pos).

Adaptive k: an EMA of the acceptance fraction walks ``k`` along a
power-of-two ladder, down toward 1 when proposals keep missing and up
toward ``k_max`` when they keep landing; the ladder bounds the verify
shapes, so the engine captures at most one verify graph a rung and twin.

This module is host logic; the engine (``engine.py``) owns the device
side: both arenas and the captured draft and verify steps
(``graphs.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import device as device_mod
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``EngineConfig.speculative``).

    ``draft``       the draft LM: a registry arch name (built reduced) or an
                    ``ArchConfig`` (built as given); must share the
                    target's vocab
    ``k``           proposals a round at the start (also a ladder rung)
    ``k_max``       adaptive ceiling (rungs: powers of two in [1, k_max],
                    plus ``k``)
    ``adaptive``    walk k with the acceptance EMA; False pins k
    ``low``/``high`` acceptance-EMA thresholds: below ``low`` k steps down,
                    above ``high`` k steps up
    ``window``      rounds between adaptation decisions
    ``ema``         EMA decay toward history a round
    ``draft_seed``  seed of the draft model's random parameters (a
                    stand-in draft: the stream never depends on it, only
                    the acceptance rate does)
    """
    draft: Any
    k: int = 4
    k_max: int = 8
    adaptive: bool = True
    low: float = 0.4
    high: float = 0.85
    window: int = 8
    ema: float = 0.8
    draft_seed: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if self.k_max < self.k:
            raise ValueError(f"SpecConfig.k_max must be >= k={self.k}, "
                             f"got {self.k_max}")
        if not 0.0 <= self.low < self.high <= 1.0:
            raise ValueError(
                f"SpecConfig thresholds need 0 <= low < high <= 1, got "
                f"low={self.low} high={self.high}")
        if self.window < 1:
            raise ValueError(f"SpecConfig.window must be >= 1, "
                             f"got {self.window}")
        if not 0.0 < self.ema < 1.0:
            raise ValueError(f"SpecConfig.ema must be in (0, 1), "
                             f"got {self.ema}")

    def ladder(self) -> tuple[int, ...]:
        """The allowed k values: powers of two up to ``k_max`` plus the
        starting k (reference :114-123)."""
        rungs = {self.k}
        r = 1
        while r <= self.k_max:
            rungs.add(r)
            r *= 2
        return tuple(sorted(rungs))


class SpecController:
    """Pairs a draft LM with the target and owns the host-side speculative
    state: the resolved draft model, the adaptive-k walk and the
    acceptance bookkeeping (reference :126-216).  ``device`` / ``kernels``:
    where and with which kernel namespace the draft is built (the
    engine's).
    """

    #: families whose chunk logits replay decode bit for bit, the
    #: precondition of the determinism contract (a recurrent family would
    #: have to rewind state, not a position cursor)
    _OK_FAMILIES = ("dense",)

    #: the resolved (model, cfg) per (draft, device, kernels): engines with
    #: the same draft on the same device share one model instance
    _draft_memo: dict = {}

    def __init__(self, target_cfg, spec: SpecConfig, *, device="cuda",
                 kernels=ops):
        self.spec = spec
        self.draft_model, self.draft_cfg = self._resolve_draft(
            spec.draft, device_mod.resolve(device), kernels)
        for role, cfg in (("target", target_cfg), ("draft", self.draft_cfg)):
            if cfg.family not in self._OK_FAMILIES:
                raise ValueError(
                    f"speculative decoding requires a family whose chunk "
                    f"logits replay decode bit-exactly "
                    f"({'/'.join(self._OK_FAMILIES)}); {role} family is "
                    f"{cfg.family!r}")
        if self.draft_cfg.vocab != target_cfg.vocab:
            raise ValueError(
                f"draft vocab {self.draft_cfg.vocab} != target vocab "
                f"{target_cfg.vocab}: acceptance compares token ids")
        self._ladder = spec.ladder()
        self.k = spec.k
        self._ema: Optional[float] = None
        self._since_adapt = 0
        self.stats = {"rounds": 0, "proposed": 0, "accepted": 0,
                      "resamples": 0, "k_changes": 0, "per_request": {}}

    @classmethod
    def _resolve_draft(cls, draft, device, kernels):
        """Registry name -> the reduced config's model; ArchConfig -> its
        model, on ``device`` with ``kernels``."""
        from repro_torch.models import registry
        key = (draft, device, id(kernels))
        try:
            hit = cls._draft_memo.get(key)
        except TypeError:               # unhashable config: build fresh
            return registry.build_model(draft, device=device,
                                        kernels=kernels), draft
        if hit is not None:
            return hit
        if isinstance(draft, str):
            bundle = registry.build(draft, reduced=True, device=device,
                                    kernels=kernels)
            resolved = (bundle.model, bundle.cfg)
        else:
            resolved = (registry.build_model(draft, device=device,
                                             kernels=kernels), draft)
        cls._draft_memo[key] = resolved
        return resolved

    # -- acceptance bookkeeping + adaptive k ---------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted so far."""
        return self.stats["accepted"] / max(self.stats["proposed"], 1)

    def observe_round(self, outcomes) -> None:
        """Record one round's per-slot outcomes, ``(uid, accepted,
        proposed)`` triples, then let the EMA walk k along the ladder."""
        if not outcomes:
            return
        self.stats["rounds"] += 1
        fracs = []
        for uid, accepted, proposed in outcomes:
            self.stats["accepted"] += accepted
            self.stats["proposed"] += proposed
            if accepted < proposed:
                self.stats["resamples"] += 1
            acc, prop = self.stats["per_request"].get(uid, (0, 0))
            self.stats["per_request"][uid] = (acc + accepted,
                                              prop + proposed)
            fracs.append(accepted / proposed)
        mean = sum(fracs) / len(fracs)
        self._ema = mean if self._ema is None else (
            self.spec.ema * self._ema + (1.0 - self.spec.ema) * mean)
        self._maybe_adapt()

    def _maybe_adapt(self) -> None:
        if not self.spec.adaptive:
            return
        self._since_adapt += 1
        if self._since_adapt < self.spec.window:
            return
        i = self._ladder.index(self.k)
        if self._ema < self.spec.low and i > 0:
            self.k = self._ladder[i - 1]
            self.stats["k_changes"] += 1
            self._since_adapt = 0
        elif self._ema > self.spec.high and i + 1 < len(self._ladder):
            self.k = self._ladder[i + 1]
            self.stats["k_changes"] += 1
            self._since_adapt = 0
