"""Stochastic sampling for the serving engine: params, per-slot vectors,
the first token (port of ``repro/runtime/serving/sampling.py``).

:class:`SamplingParams` is the immutable per-request knob set carried on a
``Request``.  The device-side transform lives in ``models.layers``
(``masked_logits`` + ``sample_step``), shared by every family's decode
driver; this module owns the plumbing around it:

  * five per-slot vectors (temp / top_k / top_p / min_p / seed) allocated
    once (``init_slot_state``) and written in place at admission
    (``write_slot``): the sampled decode graph reads them at fixed
    addresses.  No key is stored: a slot's key for the token at cache
    position q is ``fold_in(fold_in(PRNGKey(0), seed), q)``, recomputed in
    the step, so a stream depends on nothing but (seed, q): not on its
    batch-mates, on chunking or on a preemption's recompute;
  * ``sample_first``: the first generated token, drawn off the prefill (or
    final chunk) logits at q = prompt_len, so monolithic and chunked
    prefill draw the same token;
  * ``verify_draws`` / ``accept_tokens``: the speculative engine's Gumbel
    replay and acceptance rule;
  * ``reference_probs``: the numpy oracle of the distribution drawn from,
    and ``chi2_gof``, the statistical tests' goodness of fit against it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  The default is greedy decode.

    ``temperature <= 0`` means greedy (bit-exact argmax; every other knob
    is ignored).  ``top_k <= 0`` disables the top-k filter; ``top_p`` is
    the nucleus mass bound in (0, 1]; ``min_p`` drops tokens whose
    probability is below ``min_p *`` the max probability.  ``seed=None``
    defers to the engine's run-level ``base_seed``.
    """
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


def resolve_seed(sp: SamplingParams, base_seed: int) -> int:
    """The request's effective seed (run-level default applied)."""
    seed = sp.seed if sp.seed is not None else base_seed
    return int(seed) % (1 << 31)


# ---------------------------------------------------------------------------
# per-slot device state
# ---------------------------------------------------------------------------

def init_slot_state(max_slots: int, device) -> dict:
    """The engine's per-slot sampling vectors (greedy everywhere): temp /
    top_p / min_p float32, top_k / seed int64."""
    def full(value, dtype):
        return torch.full((max_slots,), value, dtype=dtype, device=device)
    return {"temp": full(0.0, torch.float32),
            "top_k": full(0, torch.int64),
            "top_p": full(1.0, torch.float32),
            "min_p": full(0.0, torch.float32),
            "seed": full(0, torch.int64)}


def write_slot(samp: dict, slot: int, sp: SamplingParams, seed: int) -> None:
    """Install a request's params into its slot, in place (at admission; a
    re-admission after preemption writes the same values)."""
    samp["temp"][slot] = sp.temperature
    samp["top_k"][slot] = sp.top_k
    samp["top_p"][slot] = sp.top_p
    samp["min_p"][slot] = sp.min_p
    samp["seed"][slot] = seed


# ---------------------------------------------------------------------------
# first token (prefill / final-chunk logits)
# ---------------------------------------------------------------------------

def _one(value, dtype, device) -> torch.Tensor:
    return torch.full((1,), value, dtype=dtype, device=device)


def sample_first(logits: torch.Tensor, seed: int, q: int,
                 sp: SamplingParams) -> torch.Tensor:
    """The first generated token off (1, V) prefill logits, drawn with the
    decode path's key at absolute position ``q`` (= prompt_len, the row the
    token will occupy).  Returns a (1,) int64 tensor on the logits'
    device."""
    dev = logits.device
    return L.sample_step(logits, _one(seed, torch.int64, dev),
                         _one(q, torch.int64, dev),
                         _one(sp.temperature, torch.float32, dev),
                         _one(sp.top_k, torch.int64, dev),
                         _one(sp.top_p, torch.float32, dev),
                         _one(sp.min_p, torch.float32, dev))


# ---------------------------------------------------------------------------
# speculative verify: the Gumbel replay
# ---------------------------------------------------------------------------

def verify_draws(logits: torch.Tensor, slot, start,
                 samp: dict) -> torch.Tensor:
    """The target's draws at every verify position of one slot (reference
    sampling.py:141): row j of ``logits`` (C, V) predicts cache position
    ``start + 1 + j`` and draws with the key decode folds there, so each
    draw equals the token decode would sample one position at a time.
    Greedy slots take the argmax.  ``slot`` / ``start``: 0-d int64 device
    tensors, read on the device only (the captured verify step), or host
    ints.  Returns (C,) int64."""
    c = logits.shape[0]
    dev = logits.device
    slot, start = (torch.as_tensor(t, dtype=torch.int64, device=dev)
                   for t in (slot, start))
    q = start + 1 + torch.arange(c, dtype=torch.int64, device=dev)

    def rep(v):
        return v.index_select(0, slot.view(1)).expand(c)

    return L.sample_step(logits, rep(samp["seed"]), q, rep(samp["temp"]),
                         rep(samp["top_k"]), rep(samp["top_p"]),
                         rep(samp["min_p"]))


def accept_tokens(proposed, draws) -> tuple[int, list[int]]:
    """Leading-prefix acceptance (reference sampling.py:172): ``a`` is the
    longest leading run with proposal == draw; commits the accepted
    proposals plus, when a < k, the target's draw at the first mismatch.
    Returns ``(a, committed)``, 1 <= len(committed) <= k."""
    proposed = np.asarray(proposed)
    draws = np.asarray(draws)
    k = proposed.shape[0]
    neq = np.nonzero(proposed != draws)[0]
    a = int(neq[0]) if neq.size else k
    committed = [int(t) for t in proposed[:a]]
    if a < k:
        committed.append(int(draws[a]))
    return a, committed


# ---------------------------------------------------------------------------
# numpy reference (test oracle)
# ---------------------------------------------------------------------------

def reference_probs(logits, sp: SamplingParams) -> np.ndarray:
    """The masked, renormalised categorical distribution ``sample_step``
    draws from, in float64 numpy (a sort and a cumulative sum, not the
    bisection): the statistical tests' expected marginal.  logits (V,).
    Greedy params give a one-hot argmax."""
    x = np.asarray(logits, np.float64).reshape(-1)
    v = x.shape[0]
    if sp.is_greedy:
        out = np.zeros(v)
        out[int(np.argmax(x))] = 1.0
        return out
    x = x / max(sp.temperature, 1e-6)
    keep = np.ones(v, bool)
    sorted_x = np.sort(x)[::-1]
    if sp.top_k > 0:
        keep &= x >= sorted_x[min(sp.top_k, v) - 1]
    ps = np.exp(sorted_x - sorted_x[0])
    ps /= ps.sum()
    excl = np.cumsum(ps) - ps
    kept_sorted = sorted_x[excl < sp.top_p]
    keep &= x >= kept_sorted.min()
    probs = np.exp(x - x.max())
    probs /= probs.sum()
    keep &= probs >= sp.min_p * probs.max()
    keep |= x >= x.max()
    p = np.where(keep, probs, 0.0)
    return p / p.sum()


def chi2_gof(tokens, probs) -> tuple[float, int, float]:
    """Goodness of fit of drawn ``tokens`` to ``probs`` (the reference's
    harness, tests/test_sampling.py:168-189): bins expecting fewer than 5
    draws merged into one; raises if a draw lies outside the support.
    Returns (statistic, degrees of freedom, the Wilson-Hilferty 0.9995
    quantile the statistic must stay below)."""
    tokens = np.asarray(tokens)
    n = tokens.size
    counts = np.bincount(tokens, minlength=len(probs)).astype(np.float64)
    if counts[probs == 0].sum():
        raise ValueError("a draw outside the masked support")
    exp = n * probs
    big = exp >= 5
    obs_b = np.append(counts[big], counts[~big].sum())
    exp_b = np.append(exp[big], exp[~big].sum())
    keep = exp_b > 0
    obs_b, exp_b = obs_b[keep], exp_b[keep]
    stat = float(((obs_b - exp_b) ** 2 / exp_b).sum())
    df = max(len(exp_b) - 1, 1)
    z = 3.29
    limit = df * (1 - 2 / (9 * df) + z * np.sqrt(2 / (9 * df))) ** 3
    return stat, df, float(limit)
