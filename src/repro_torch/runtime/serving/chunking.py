"""Length bucketing + chunk planning for stripmined prefill (a copy of
``repro/runtime/serving/chunking.py``).

The paper's stripmining loop cuts an arbitrary application vector into
hardware-vector-length chunks so the lanes never see a new shape; here the
"hardware lengths" are a small geometric set of bucket sizes and the
"application vector" is the prompt.  A prompt is covered greedily by
bucket-sized chunks (largest first), padding only the final chunk — so

  * every chunk shape is drawn from the bucket set ⟹ distinct prefill
    compilations ≤ ``len(buckets)`` no matter how many prompt lengths the
    traffic mix contains (monolithic prefill compiles once *per length*);
  * padding waste is < ``min(buckets)`` tokens per prompt;
  * the largest bucket bounds how long any single prefill call can stall
    the co-resident decode batch (the TTFT knob).

Pure host-side arithmetic — unit-testable without a model.
"""
from __future__ import annotations

# Geometric bucket set: compile count ≤ 5, padding waste < 32 rows, and the
# longest single device call ingests 512 prompt tokens.
DEFAULT_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512)


def validate_buckets(buckets) -> tuple[int, ...]:
    bs = tuple(sorted(set(int(b) for b in buckets)))
    if not bs or bs[0] < 1:
        raise ValueError(f"invalid bucket set {buckets!r}")
    return bs


def chunk_plan(prompt_len: int, buckets=DEFAULT_BUCKETS) -> list[int]:
    """Greedy stripmine cover of ``prompt_len`` with bucket-sized chunks.

    Largest buckets first; a sub-``min(buckets)`` remainder takes one
    smallest bucket (the final chunk carries the padding).  Returns the
    chunk sizes in ingestion order: ``sum(plan) >= prompt_len`` and
    ``sum(plan) - prompt_len < min(buckets)``.
    """
    if prompt_len < 1:
        raise ValueError(f"prompt_len={prompt_len}")
    bs = validate_buckets(buckets)
    plan: list[int] = []
    rem = prompt_len
    for b in reversed(bs):
        while rem >= b:
            plan.append(b)
            rem -= b
    if rem:
        plan.append(bs[0])
    # boundary invariant: a prompt landing exactly on a bucket cover must
    # not emit an all-pad trailing chunk — every chunk ingests >= 1 real
    # token, so the engine never spends a compile + a scheduler step on a
    # zero-length tail (``>=`` above, not ``>``: rem == b consumes the
    # bucket instead of falling through to the pad branch).  An explicit
    # raise — not assert: it survives ``python -O`` and keeps this
    # module's ValueError contract on the submit path — pinned by the
    # boundary-length cases in tests/test_chunked_prefill.py.
    if not (sum(plan[:-1]) < prompt_len <= sum(plan)):
        raise ValueError(
            f"chunk_plan invariant violated: prompt_len={prompt_len}, "
            f"buckets={bs} -> {plan} (all-pad trailing chunk)")
    return plan



def tail_plan(prompt_len: int, shared_len: int,
              buckets=DEFAULT_BUCKETS) -> list[int]:
    """Chunk plan for the *unshared tail* of a prefix-sharing fork.

    The first ``shared_len`` prompt tokens were mapped onto existing
    prefix pages by reference — no ingestion — so only the remaining
    ``prompt_len - shared_len`` tokens are stripmined.  The fork's chunk
    cursor starts at ``shared_len`` (the divergence boundary), and the
    engine caps ``shared_len < prompt_len`` at fork time, so the tail is
    never empty: every fork ingests at least one real token to produce its
    first logits.
    """
    if not 0 <= shared_len < prompt_len:
        raise ValueError(
            f"shared_len={shared_len} outside [0, prompt_len={prompt_len})")
    return chunk_plan(prompt_len - shared_len, buckets)
