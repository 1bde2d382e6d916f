"""Per-request sampling knobs (copy of the reference's ``SamplingParams``).

Only greedy decode is ported: the engine refuses a request whose params
are not greedy (on-device sampling is ROADMAP Open items 1.5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """``temperature <= 0`` means greedy (argmax; the other knobs are
    ignored).  Validation as in the reference (serving/sampling.py)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature < 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k < 0: {self.top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p outside (0, 1]: {self.top_p}")
        if not (0.0 <= self.min_p <= 1.0):
            raise ValueError(f"min_p outside [0, 1]: {self.min_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()
