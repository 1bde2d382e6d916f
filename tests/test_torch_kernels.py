"""Parity of the port's attention ops (repro_torch.kernels.ops) with the JAX
package's (repro.kernels.ops): the same numpy inputs through both, the JAX
side in its ``ref`` mode and through the Pallas kernels in ``interpret``
mode, the port on the CPU (its plain versions).  Tolerance 2e-5, JAX's own
for these kernels (tests/test_serving.py:195).  The CUDA kernels themselves
are checked against the plain versions by tests/test_torch_cuda.py (on the
card) and by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL = 2e-5
PARKED = (1 << 30) + 1


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_decode_matches_jax(mode, g, window):
    """Ragged lengths (incl. 1 and Sk), Sk = 40 not a multiple of bk = 16."""
    rng = np.random.default_rng(g)
    b, kvh, s, hd = 4, 2, 40, 16
    q = _rand(rng, b, kvh * g, hd)
    k, v = _rand(rng, b, s, kvh, hd), _rand(rng, b, s, kvh, hd)
    lengths = np.array([1, 17, 40, 33], np.int32)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             lengths=jnp.asarray(lengths), window=window,
                             bk=16, mode=mode)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           lengths=torch.from_numpy(lengths), window=window,
                           bk=16)
    _close(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_flash_decode_parked_and_full_lengths(mode):
    """A parked slot (length PARKED_POS + 1, far past Sk) and lengths=None.
    Sk is a multiple of bk here: past the arena the reference also attends
    its zero strip padding, which the port never reads (ROADMAP §3)."""
    rng = np.random.default_rng(7)
    b, h, kvh, s, hd = 2, 6, 2, 48, 8
    q = _rand(rng, b, h, hd)
    k, v = _rand(rng, b, s, kvh, hd), _rand(rng, b, s, kvh, hd)
    for lengths in (np.array([PARKED, 5], np.int32), None):
        want = jops.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            lengths=None if lengths is None else jnp.asarray(lengths),
            bk=16, mode=mode)
        got = ops.flash_decode(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            lengths=None if lengths is None else torch.from_numpy(lengths),
            bk=16)
        _close(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("prefix", [0, 9])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_prefill_chunk_matches_jax(mode, g, prefix, window):
    rng = np.random.default_rng(10 * g + prefix)
    b, c, kvh, s, hd = 2, 8, 2, 40, 16
    q = _rand(rng, b, c, kvh * g, hd)
    k, v = _rand(rng, b, s, kvh, hd), _rand(rng, b, s, kvh, hd)
    pre = np.array([prefix, prefix + 3], np.int32)
    want = jops.flash_prefill_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        prefix=jnp.asarray(pre), window=window, bk=16, mode=mode)
    got = ops.flash_prefill_chunk(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        prefix=torch.from_numpy(pre), window=window, bk=16)
    _close(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (33, 33), (1, 40)])
def test_attention_matches_jax(mode, causal, window, sq, sk):
    if mode == "interpret" and sk % 32 and (not causal or sq != sk):
        # non-causal: the reference itself falls back to ref; causal with
        # Sq != Sk: its Pallas path pads Sk before right-aligning the
        # queries and so differs from its own ref (ROADMAP §3) — the ref
        # mode case covers both shapes
        pytest.skip("reference Pallas path does not handle ragged Sk here")
    rng = np.random.default_rng(sq + sk)
    q, k, v = (_rand(rng, 3, sq, 16), _rand(rng, 3, sk, 16),
               _rand(rng, 3, sk, 16))
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=window, bq=32, bk=32,
                          mode=mode, impl="naive")
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window,
                        bq=32, bk=32)
    _close(got, want)


@pytest.mark.parametrize("g", [1, 3])
def test_attention_gqa_in_place_matches_jax_repeat(g):
    """K/V with KVH heads (the port's prefill path) == the reference's
    pre-expanded ``jnp.repeat(k, G, axis=heads)``."""
    rng = np.random.default_rng(g)
    b, kvh, s, hd = 2, 2, 24, 8
    q = _rand(rng, b, kvh * g, s, hd)
    k, v = _rand(rng, b, kvh, s, hd), _rand(rng, b, kvh, s, hd)
    want = jops.attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 1),
                          jnp.repeat(jnp.asarray(v), g, 1), causal=True,
                          mode="ref", impl="naive")
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True)
    _close(got, want)


@pytest.mark.parametrize("axis,mult", [(0, 4), (1, 16), (-2, 5), (-1, 3)])
def test_pad_to_matches_jax(axis, mult):
    x = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    want = jops._pad_to(jnp.asarray(x), mult, axis)
    got = ops._pad_to(torch.from_numpy(x), mult, axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
