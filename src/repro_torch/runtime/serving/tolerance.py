"""Token-match tolerance harness for narrow KV formats (port of
``repro/runtime/serving/tolerance.py``).

A narrow format (``EngineConfig.kv_format``: bf16, int8, fp8) trades
arena bytes for quantization noise, which greedy decode turns into a
discrete signal: the argmax token matches the fp32 stream or it does not.
:func:`measure` serves one workload through an fp32 oracle engine and a
candidate engine that differ in storage format only, and reports the
greedy match rate and each stream's first divergence.

Matches are counted up to each stream's first mismatch: one flipped token
changes every later input, so agreement after it is coincidence.  A
stream that ends early diverges at its length.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.serving.config import EngineConfig
from repro_torch.runtime.serving.engine import ServingEngine
from repro_torch.runtime.serving.request import Request


@dataclasses.dataclass(frozen=True)
class TokenMatchReport:
    """Greedy token agreement between an oracle and a candidate run.

    ``requests``          streams compared
    ``positions``         total oracle token positions
    ``matched``           positions matched before each stream's divergence
    ``match_rate``        matched / positions (1.0 for an empty workload)
    ``first_divergence``  uid -> position of the first mismatch; streams
                          that match end to end do not appear
    """
    requests: int
    positions: int
    matched: int
    match_rate: float
    first_divergence: dict

    @property
    def identical(self) -> bool:
        return not self.first_divergence

    def describe(self) -> str:
        div = (", ".join(f"{uid}@{pos}" for uid, pos in
                         sorted(self.first_divergence.items(),
                                key=lambda kv: str(kv[0])))
               if self.first_divergence else "none")
        return (f"match {self.matched}/{self.positions} "
                f"({self.match_rate:.4f}) over {self.requests} requests; "
                f"first divergence: {div}")


def compare_streams(oracle: dict, candidate: dict) -> TokenMatchReport:
    """Compare two uid -> token-array mappings (``engine.run()`` outputs).
    An oracle uid missing from the candidate diverges at position 0."""
    positions = matched = 0
    first_divergence: dict = {}
    for uid in sorted(oracle, key=str):
        ref = np.asarray(oracle[uid]).ravel()
        got = np.asarray(candidate.get(uid, ())).ravel()
        positions += ref.size
        n = min(ref.size, got.size)
        agree = ref[:n] == got[:n]
        if bool(agree.all()) and got.size >= ref.size:
            matched += ref.size
            continue
        div = int(np.argmax(~agree)) if not agree.all() else n
        matched += div
        first_divergence[uid] = div
    return TokenMatchReport(
        requests=len(oracle), positions=positions, matched=matched,
        match_rate=(matched / positions) if positions else 1.0,
        first_divergence=first_divergence)


def serve_streams(model, cfg, params, prompts, *, max_new_tokens: int,
                  config: EngineConfig,
                  kv_format: Optional[str] = None) -> dict:
    """One greedy workload through a fresh engine: uid -> tokens.
    ``kv_format`` overrides the config's format, the one knob the harness
    varies."""
    if kv_format is not None:
        config = config.replace(kv_format=kv_format)
    eng = ServingEngine(model, cfg, params, config=config)
    for i, prompt in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=np.asarray(prompt, np.int32),
                           max_new_tokens=max_new_tokens))
    return eng.run()


def measure(model, cfg, params, prompts, *, max_new_tokens: int,
            config: EngineConfig, kv_format: str) -> TokenMatchReport:
    """Serve the workload under fp32 and under ``kv_format``, configured
    alike otherwise, and report greedy token agreement."""
    oracle = serve_streams(model, cfg, params, prompts,
                           max_new_tokens=max_new_tokens, config=config,
                           kv_format="fp32")
    candidate = serve_streams(model, cfg, params, prompts,
                              max_new_tokens=max_new_tokens, config=config,
                              kv_format=kv_format)
    return compare_streams(oracle, candidate)
