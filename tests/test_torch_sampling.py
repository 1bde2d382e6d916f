"""The port's sampler against the JAX package on the same numpy inputs.

  * ``core/prng.py``: keys and 32-bit words equal ``jax.random``'s bit for
    bit over a grid of seeds and positions and vocabularies up to 128256;
    uniforms, XLA's float32 ``log`` (``xla_log``) and Gumbels bit for bit
    (``GUMBEL_SPACINGS`` float32 steps of max(|g|, 1) is 0), and the
    Gumbel-argmax draw on exact ties of the perturbed scores;
  * ``models/layers.py``: ``_monotone_key``, the float32 ``exp`` and sum
    order of the reference (``xla_exp``, ``tree_sum``) bit for bit;
    ``masked_logits``' kept set and kept values and ``sample_step``'s tokens
    equal the reference's for rows with different knobs in one batch, wide
    vocabularies included, and the reference's pinned failing example
    (temperature 1e-3 draws token 14, temperature 0 token 0);
  * the reference's own sampling checks (``tests/test_sampling.py``), run on
    the port: support sizes, the nucleus bound, min-p, the extreme knobs,
    temperature 0, key purity, and the chi-square marginals against the
    port's ``reference_probs``;
  * ``runtime/serving/sampling.py`` and the engine: sampled token streams
    equal to the JAX ``ServingEngine``'s for the dense and the ssm family,
    monolithic and chunked prefill, dispatch depth 0 and 2, sampling mix
    0.5 and 1.0, and under preemption; the reference's engine checks (batch
    membership, chunking, the greedy twin, the base seed); the serve CLI.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro.runtime.serving import sampling as jsampling  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import sampling as tsampling  # noqa: E402

from test_torch_model import TINY, bridged  # noqa: E402
from test_torch_ssm import TINY_SSM, ssm_bridged  # noqa: E402

#: |gumbel_port - gumbel_jax| <= this many float32 steps at max(|g|, 1):
#: none, both logs are XLA's own float32 log
GUMBEL_SPACINGS = 0
SEEDS = (0, 1, 5, 836201, 2**31 - 1)
QS = (0, 1, 2, 2**20, 2**31 - 1, 2**32 - 1)
VOCABS = (1, 31, 97, 50280, 128256)


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def _jkeys(seeds, qs):
    return jax.vmap(lambda s, q: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(0), s), q))(
            jnp.asarray(seeds, jnp.uint32), jnp.asarray(qs, jnp.uint32))


def _tkeys(seeds, qs):
    k0 = torch.zeros((len(seeds), 2), dtype=torch.int64)
    return prng.fold_in(prng.fold_in(k0, torch.tensor(seeds)),
                        torch.tensor(qs))


# ---------------------------------------------------------------------------
# prng
# ---------------------------------------------------------------------------

def test_fold_in_known_values():
    key0 = torch.zeros(2, dtype=torch.int64)               # PRNGKey(0)
    assert key0.tolist() == _u32(jax.random.PRNGKey(0)).tolist()
    k = prng.fold_in(prng.fold_in(key0, 5), 7)
    assert k.tolist() == [1549493927, 1263336709]
    assert prng.random_bits32(k, (4,)).tolist() == [
        160882699, 546742299, 3678504328, 2719473464]


def test_keys_match_jax_over_the_grid():
    seeds = [s for s in SEEDS for _ in QS]
    qs = [q for _ in SEEDS for q in QS]
    np.testing.assert_array_equal(_tkeys(seeds, qs).numpy(),
                                  _u32(_jkeys(seeds, qs)))


@pytest.mark.parametrize("v", VOCABS)
def test_bits_uniform_gumbel_match_jax(v):
    seeds, qs = (0, 5, 2**31 - 1), (1, 2**20, 2**32 - 1)
    jk, tk = _jkeys(seeds, qs), _tkeys(seeds, qs)
    jbits = jax.vmap(lambda k: jax.random.bits(k, (v,), jnp.uint32))(jk)
    np.testing.assert_array_equal(prng.random_bits32(tk, (v,)).numpy(),
                                  _u32(jbits))
    ju = jax.vmap(lambda k: jax.random.uniform(k, (v,), jnp.float32))(jk)
    np.testing.assert_array_equal(prng.uniform(tk, (v,)).numpy(),
                                  np.asarray(ju))
    jg = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (v,), jnp.float32))(jk))
    tg = prng.gumbel(tk, (v,)).numpy()
    step = np.spacing(np.maximum(np.abs(jg), 1).astype(np.float32))
    assert np.abs(tg - jg).max() <= GUMBEL_SPACINGS * step.max()
    assert (np.abs(tg - jg) <= GUMBEL_SPACINGS * step).all()
    np.testing.assert_array_equal(tg, jg)


def test_xla_log_bit_for_bit():
    """Every float32 class: random bit patterns (normals, subnormals, both
    signs, inf, NaN), the neighbourhood of 1 and of sqrt(1/2), and the
    Gumbel's own range."""
    rng = np.random.default_rng(7)
    near1 = (np.float32(1) + np.arange(-4096, 4096, dtype=np.float32)
             * np.float32(2.0 ** -24))
    sqrthf = np.float32(0.70710677) + np.arange(
        -512, 512, dtype=np.float32) * np.float32(2.0 ** -25)
    x = np.concatenate([
        rng.integers(-2**31, 2**31, 400_000).astype(np.int32).view(
            np.float32),
        rng.uniform(0, 1, 100_000).astype(np.float32),
        np.exp(rng.uniform(-87.3, 88.7, 100_000)).astype(np.float32),
        near1, sqrthf,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 1e-45, -1e-45,
                  1e-40, np.finfo(np.float32).tiny,
                  -np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                  1.0, 2.0, 0.5], np.float32)])
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


#: (seed, q) pairs: the ROADMAP's key fold_in(fold_in(0, 5), 7) among them
GUMBEL_KEYS = ((5, 7), (0, 0), (1, 1), (836201, 2**20), (2**31 - 1, 3))


@pytest.mark.parametrize("v", [50280, 128256])
def test_gumbel_bit_for_bit_at_several_keys(v):
    seeds, qs = zip(*GUMBEL_KEYS)
    jg = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (v,), jnp.float32))(
            _jkeys(seeds, qs)))
    np.testing.assert_array_equal(prng.gumbel(_tkeys(seeds, qs),
                                              (v,)).numpy(), jg)


@pytest.mark.parametrize("v", [50280, 128256])
def test_sample_step_on_exact_ties_matches_jax(v):
    """Logits -g (g: jax's Gumbels at each row's key) make every perturbed
    score 0 in float32, so the draw is decided by the last bit of each
    Gumbel: a port whose Gumbel is one step above jax's anywhere draws
    another token.  A second batch nudges half the logits one step up."""
    seeds, qs = zip(*GUMBEL_KEYS)
    jg = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (v,), jnp.float32))(
            _jkeys(seeds, qs)))
    knobs = [(1.0, 0, 1.0, 0.0)] * len(seeds)
    nudge = np.random.default_rng(v).integers(0, 2, jg.shape).astype(bool)
    for logits in (-jg, np.where(nudge, np.nextafter(-jg, np.float32(np.inf)),
                                 -jg)):
        want, got = _both_tokens(logits.astype(np.float32), knobs, seeds, qs)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the reference's float32 arithmetic
# ---------------------------------------------------------------------------

def test_monotone_key_bit_for_bit():
    f = np.float32
    specials = np.array(
        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40,
         np.finfo(f).tiny, -np.finfo(f).tiny, np.finfo(f).max,
         -np.finfo(f).max, 1.0, -1.0, 0.5, -2.5], f)
    x = np.concatenate([specials, np.random.default_rng(0).standard_normal(
        1000).astype(f) * 50])
    got = TL._monotone_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _u32(JL._monotone_key(jnp.asarray(x))))
    order = np.argsort(x[2:], kind="stable")       # -0.0 and +0.0 aside
    assert (np.diff(got[2:][order]) >= 0).all()


def test_xla_exp_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(100_000) * 20, -np.abs(rng.standard_normal(
            100_000)) * 60,
        [0.0, -0.0, 88.8, -87.8, -87.3, -100.0, 100.0, -1e-40, np.inf,
         -np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(TL.xla_exp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("v", [1, 2, 31, 32, 33, 97, 1000, 1025, 50280,
                               128256])
def test_tree_sum_bit_for_bit(v):
    rng = np.random.default_rng(v)
    a = (rng.standard_normal((3, v)) ** 2 * np.exp(
        rng.standard_normal((3, v)) * 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TL.tree_sum(torch.from_numpy(a)).numpy(),
        np.asarray(jax.jit(lambda t: t.sum(-1))(a)))


# ---------------------------------------------------------------------------
# masked_logits / sample_step
# ---------------------------------------------------------------------------

#: (temperature, top_k, top_p, min_p) of one batch's rows; row 0 gets
#: tied logits
KNOBS = [(1.0, 5, 1.0, 0.0),           # top-k with ties
         (1.0, 0, 0.05, 0.0), (0.7, 0, 0.9, 0.0), (1.0, 0, 1.0, 0.0),
         (0.6, 0, 1.0, 0.0),           # top_p 1: the sums absorb the tail
         (1.0, 0, 1.0, 0.1),           # min-p
         (0.8, 12, 0.9, 0.05),         # all three
         (0.01, 1, 1e-6, 1.0),         # the extreme knobs
         (1e-3, 0, 1.0, 0.0), (2.0, 1000000, 0.95, 0.01),
         (0.0, 3, 0.5, 0.1)]           # greedy


def _knob_vectors(knobs):
    cols = list(zip(*knobs))
    return (np.array(cols[0], np.float32), np.array(cols[1], np.int32),
            np.array(cols[2], np.float32), np.array(cols[3], np.float32))


def _logits(v, scale, seed, n=len(KNOBS)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, v)) * scale).astype(np.float32)
    x[0] = rng.integers(-3, 3, v).astype(np.float32)          # ties
    return x


def _both_masked(logits, knobs):
    t, k, p, m = _knob_vectors(knobs)
    want = np.asarray(jax.jit(JL.masked_logits)(logits, t, k, p, m))
    got = TL.masked_logits(*(torch.from_numpy(a) for a in
                             (logits, t, k, p, m))).numpy()
    return want, got


def _assert_same_mask(want, got):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(want)],
                                  want[np.isfinite(want)])


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("v", [31, 97])
def test_masked_logits_matches_jax(v, scale):
    for seed in range(10):
        _assert_same_mask(*_both_masked(_logits(v, scale, seed), KNOBS))


@pytest.mark.parametrize("v", [32000, 128256])
def test_masked_logits_matches_jax_wide_vocab(v):
    _assert_same_mask(*_both_masked(_logits(v, 3.0, v), KNOBS))


def _both_tokens(logits, knobs, seeds, qs):
    t, k, p, m = _knob_vectors(knobs)
    s = np.asarray(seeds, np.int32)
    q = np.asarray(qs, np.int32)
    want = np.asarray(jax.jit(JL.sample_step)(logits, s, q, t, k, p, m))
    got = TL.sample_step(*(torch.from_numpy(a) for a in
                           (logits, s.astype(np.int64), q.astype(np.int64),
                            t, k, p, m))).numpy()
    return want, got


@pytest.mark.parametrize("v", [31, 97, 50280])
def test_sample_step_matches_jax(v):
    rng = np.random.default_rng(v + 1)
    for i in range(3 if v > 1000 else 12):
        seeds = rng.integers(0, 2**31, len(KNOBS))
        qs = rng.integers(0, 2**31, len(KNOBS))
        qs[:2] = (0, 1)
        want, got = _both_tokens(_logits(v, 2.0, 100 + i), KNOBS, seeds, qs)
        np.testing.assert_array_equal(got, want)


def test_pinned_example_draws_the_reference_token():
    """The reference's failing property example (seed=836201, draw_seed=0,
    q=1): its two largest logits are 1.1 nats apart at temperature 1e-3,
    so the Gumbel draw takes the second (token 14); temperature 0 is the
    argmax (token 0)."""
    x = np.random.default_rng(836201).standard_normal(31).astype(
        np.float32)[None]
    for temp, tok in ((1e-3, 14), (0.0, 0)):
        want, got = _both_tokens(x, [(temp, 0, 1.0, 0.0)], [0], [1])
        assert int(want[0]) == tok and int(got[0]) == tok


# ---------------------------------------------------------------------------
# the reference's checks (tests/test_sampling.py:78-205), on the port
# ---------------------------------------------------------------------------

def _mask_one(logits, sp):
    x = torch.as_tensor(np.asarray(logits, np.float32))[None]
    return TL.masked_logits(
        x, torch.tensor([sp.temperature]), torch.tensor([sp.top_k]),
        torch.tensor([sp.top_p]), torch.tensor([sp.min_p]))[0].numpy()


def _draws(logits, sp, n, seed=0):
    """n draws from one logits row at positions 0..n-1, as one batch."""
    x = torch.as_tensor(np.asarray(logits, np.float32))[None].expand(n, -1)

    def full(v, dtype):
        return torch.full((n,), v, dtype=dtype)

    return TL.sample_step(
        x, full(seed, torch.int64), torch.arange(n),
        full(sp.temperature, torch.float32), full(sp.top_k, torch.int64),
        full(sp.top_p, torch.float32), full(sp.min_p, torch.float32)).numpy()


@pytest.mark.parametrize("k", [0, 1, 5, 32, 33, 100])
def test_top_k_support_size(k):
    x = np.random.default_rng(0).standard_normal(33)
    m = _mask_one(x, tsampling.SamplingParams(temperature=1.0, top_k=k))
    assert np.isfinite(m).sum() == (min(k, 33) if k else 33)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_mass_bound_and_minimality(p):
    x = np.random.default_rng(1).standard_normal(64)
    m = _mask_one(x, tsampling.SamplingParams(temperature=1.0, top_p=p))
    probs = np.exp(x - x.max())
    probs /= probs.sum()
    kept = np.isfinite(m)
    mass = probs[kept].sum()
    assert mass >= p - 1e-6
    assert mass - probs[kept].min() < p


def test_min_p_filters_relative_to_max():
    x = np.random.default_rng(2).standard_normal(48)
    m = _mask_one(x, tsampling.SamplingParams(temperature=1.0, min_p=0.3))
    probs = np.exp(x - x.max())
    probs /= probs.sum()
    kept = np.isfinite(m)
    assert kept[np.argmax(probs)]
    np.testing.assert_array_equal(kept, probs >= 0.3 * probs.max())


def test_argmax_always_survives_extreme_knobs():
    x = np.random.default_rng(3).standard_normal(21)
    m = _mask_one(x, tsampling.SamplingParams(temperature=0.01, top_k=1,
                                              top_p=1e-6, min_p=1.0))
    kept = np.isfinite(m)
    assert kept.sum() == 1 and kept[np.argmax(x)]


def test_temperature_zero_is_exact_argmax():
    logits = np.random.default_rng(4).standard_normal((7, 53)).astype(
        np.float32)
    n = 7
    got = TL.sample_step(
        torch.from_numpy(logits), torch.arange(n), torch.arange(n),
        torch.zeros(n), torch.full((n,), 3), torch.full((n,), 0.5),
        torch.zeros(n)).numpy()
    np.testing.assert_array_equal(got, np.argmax(logits, -1))


def test_draw_is_pure_function_of_seed_and_position():
    rng = np.random.default_rng(5)
    row = rng.standard_normal(41).astype(np.float32)
    other = rng.standard_normal((3, 41)).astype(np.float32)

    def sample_at(rows, seeds, qs):
        n = len(rows)
        return TL.sample_step(
            torch.from_numpy(np.stack(rows)), torch.tensor(seeds),
            torch.tensor(qs), torch.full((n,), 0.9), torch.full((n,), 11),
            torch.full((n,), 0.9), torch.zeros(n)).numpy()

    alone = sample_at([row], [7], [13])[0]
    first = sample_at([row, other[0], other[1]], [7, 1, 2], [13, 4, 9])[0]
    last = sample_at([other[2], row], [3, 7], [2, 13])[1]
    assert alone == first == last
    assert len({sample_at([row], [7], [q])[0] for q in range(12)}) > 1


MARGINAL_CASES = [
    tsampling.SamplingParams(temperature=0.7),
    tsampling.SamplingParams(temperature=1.3, top_k=5),
    tsampling.SamplingParams(temperature=1.0, top_p=0.8),
    tsampling.SamplingParams(temperature=1.0, min_p=0.1),
    tsampling.SamplingParams(temperature=0.8, top_k=12, top_p=0.9,
                             min_p=0.05),
]


def _jparams(sp):
    return jsampling.SamplingParams(temperature=sp.temperature,
                                    top_k=sp.top_k, top_p=sp.top_p,
                                    min_p=sp.min_p, seed=sp.seed)


@pytest.mark.parametrize("vocab", [11, 37, 101])
@pytest.mark.parametrize("case", range(len(MARGINAL_CASES)))
def test_sampled_marginal_matches_reference(vocab, case):
    sp = MARGINAL_CASES[case]
    logits = np.random.default_rng(100 * vocab + case).standard_normal(
        vocab).astype(np.float32)
    n = 8000
    toks = _draws(logits, sp, n, seed=17 + case)
    ref = tsampling.reference_probs(logits, sp)
    np.testing.assert_array_equal(
        ref, jsampling.reference_probs(logits, _jparams(sp)))
    stat, df, limit = tsampling.chi2_gof(toks, ref)
    assert stat < limit, (stat, df, limit, sp)


# ---------------------------------------------------------------------------
# runtime/serving/sampling.py
# ---------------------------------------------------------------------------

def test_chi2_gof_rejects_a_wrong_marginal():
    """The harness itself: a fair die passes, a loaded one and a draw
    outside the support fail."""
    rng = np.random.default_rng(0)
    probs = np.full(6, 1 / 6)
    stat, df, limit = tsampling.chi2_gof(rng.integers(0, 6, 6000), probs)
    assert df == 5 and stat < limit
    loaded = rng.choice(6, 6000, p=[0.2, 0.2, 0.15, 0.15, 0.15, 0.15])
    stat, _, limit = tsampling.chi2_gof(loaded, probs)
    assert stat > limit
    with pytest.raises(ValueError, match="support"):
        tsampling.chi2_gof([0, 1, 5], np.array([0.5, 0.5, 0, 0, 0, 0.0]))


def test_sampling_params_validation_and_seed():
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(min_p=-0.5)):
        with pytest.raises(ValueError):
            tsampling.SamplingParams(**bad)
    assert tsampling.SamplingParams().is_greedy
    assert not tsampling.SamplingParams(temperature=0.5).is_greedy
    assert tserving.GREEDY == tsampling.SamplingParams()
    for seed, base in ((None, 0), (None, 7), (3, 7), (2**31 + 5, 0),
                       (-1, 0), (None, 2**40)):
        sp = tsampling.SamplingParams(temperature=1.0, seed=seed)
        assert tsampling.resolve_seed(sp, base) == jsampling.resolve_seed(
            _jparams(sp), base)


def test_slot_state_written_in_place():
    samp = tsampling.init_slot_state(3, "cpu")
    ref = jsampling.init_slot_state(3)
    assert sorted(samp) == sorted(ref)
    for k in samp:
        np.testing.assert_array_equal(samp[k].numpy(), np.asarray(ref[k]))
    ptrs = {k: v.data_ptr() for k, v in samp.items()}
    sp = tsampling.SamplingParams(temperature=0.6, top_k=50, top_p=0.9,
                                  min_p=0.05)
    tsampling.write_slot(samp, 1, sp, 1234)
    ref = jsampling.write_slot(ref, 1, _jparams(sp), 1234)
    for k in samp:
        assert samp[k].data_ptr() == ptrs[k]
        np.testing.assert_array_equal(samp[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("slot", [0, 2])
def test_sample_first_and_verify_draws_match_jax(slot):
    rng = np.random.default_rng(slot)
    logits = rng.standard_normal((5, 97)).astype(np.float32)
    sp = tsampling.SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                                  min_p=0.02)
    tsamp = tsampling.init_slot_state(3, "cpu")
    jsamp = jsampling.init_slot_state(3)
    tsampling.write_slot(tsamp, slot, sp, 99)
    jsamp = jsampling.write_slot(jsamp, slot, _jparams(sp), 99)
    for q in (0, 17):
        got = tsampling.sample_first(torch.from_numpy(logits[:1]), 99, q, sp)
        want = jsampling.sample_first(jnp.asarray(logits[:1]), 99, q,
                                      _jparams(sp))
        assert int(got[0]) == int(want)
    got = tsampling.verify_draws(torch.from_numpy(logits), slot, 11, tsamp)
    want = jsampling.verify_draws(jnp.asarray(logits), slot, 11, jsamp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("proposed,draws", [
    ([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 5, 3]), ([4, 2], [1, 2]),
    ([7], [7])])
def test_accept_tokens_matches_reference(proposed, draws):
    assert tsampling.accept_tokens(proposed, draws) == \
        jsampling.accept_tokens(proposed, draws)


# ---------------------------------------------------------------------------
# the engine against the JAX ServingEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["dense", "ssm"])
def family(request):
    """(JAX config, (jax model, jax params, port model, port params))."""
    if request.param == "dense":
        return TINY, bridged(TINY)
    return TINY_SSM, ssm_bridged(TINY_SSM)


PLAN = dict(temperature=0.8, top_k=20, top_p=0.9, min_p=0.05, seed=3)


def _serve_both(family, lens, gens, mix, **cfg):
    """Both engines on the same requests, request i sampled as the serve
    CLIs' ``sampling_plan`` says; returns ((jax out, port out), (jax
    engine, port engine))."""
    jcfg, (jm, jp, tm, tp) = family
    outs, engines = [], []
    for mod, model, mcfg, params, plan_fn in (
            (jserving, jm, jcfg, jp, jserve.sampling_plan),
            (tserving, tm, tm.cfg, tp, tserve.sampling_plan)):
        plan = plan_fn(len(lens), mix=mix, **PLAN)
        eng = mod.ServingEngine(model, mcfg, params,
                                config=mod.EngineConfig(**cfg))
        rng = np.random.default_rng(0)
        for i, (n, g) in enumerate(zip(lens, gens)):
            eng.submit(mod.Request(uid=i, prompt=rng.integers(0, 97, n),
                                   max_new_tokens=g, sampling=plan[i]))
        outs.append(eng.run(max_steps=2000))
        engines.append(eng)
    return outs, engines


def _assert_streams_equal(outs, engines):
    want, got = outs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")
    je, te = engines
    for k in ("sampled_requests", "sampled_steps", "decode_steps"):
        assert te.stats[k] == je.stats[k], k
    assert te.scheduler.stats == {k: je.scheduler.stats[k]
                                  for k in te.scheduler.stats}


@pytest.mark.parametrize("mix", [0.5, 1.0])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_engine_sampled_streams_match_jax(family, chunks, depth, mix):
    outs, engines = _serve_both(family, (5, 9, 7, 12), (8, 6, 10, 7), mix,
                                max_slots=2, max_seq=64, depth=depth,
                                prefill_chunks=chunks)
    _assert_streams_equal(outs, engines)
    assert engines[1].stats["sampled_requests"] == (2 if mix == 0.5 else 4)
    assert engines[1].stats["sampled_steps"] > 0


@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_engine_sampled_preemption_matches_jax(family, chunks):
    """--page-size 4 --pages 14: the youngest request is preempted and
    recomputed; its draws fold the same (seed, position) again."""
    outs, engines = _serve_both(family, (20, 15, 20, 15, 20), (12,) * 5,
                                0.5, max_slots=2, max_seq=64, depth=2,
                                page_size=4, num_pages=14,
                                prefill_chunks=chunks)
    _assert_streams_equal(outs, engines)
    assert engines[1].scheduler.stats["preempted"] > 0


def _run(family, reqs, **cfg):
    _, (_, _, tm, tp) = family
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(**cfg))
    for r in reqs:
        eng.submit(r)
    return eng.run(max_steps=2000), eng


def _req(uid, prompt, gen, **sp):
    return tserving.Request(uid=uid, prompt=prompt, max_new_tokens=gen,
                            sampling=tsampling.SamplingParams(**sp))


def test_engine_sampled_matches_sequential_decode(family):
    """The engine's streams equal one request at a time through the port's
    own LM: the first token at q = prompt_len, then q = pos + 1."""
    _, (_, _, tm, tp) = family
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 97, n) for n in (5, 9, 7)]
    sps = [tsampling.SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                                    seed=50 + i) for i in range(3)]
    out, eng = _run(family, [tserving.Request(uid=i, prompt=p,
                                              max_new_tokens=8, sampling=sp)
                             for i, (p, sp) in enumerate(zip(prompts, sps))],
                    max_slots=2, max_seq=64, depth=2)
    assert eng.stats["sampled_requests"] == 3
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        cache = tm.init_cache(1, 64)
        logits = tm.prefill(tp, torch.as_tensor(p)[None], cache)
        toks = [int(tsampling.sample_first(logits, sp.seed, len(p), sp)[0])]
        samp = tsampling.init_slot_state(1, "cpu")
        tsampling.write_slot(samp, 0, sp, sp.seed)
        pos = torch.tensor([len(p)])
        for _ in range(7):
            tok = tm.decode_and_sample(tp, torch.tensor(toks[-1:]), cache,
                                       pos, samp)
            toks.append(int(tok[0]))
            pos = pos + 1
        np.testing.assert_array_equal(out[i], toks)


def test_engine_sampled_invariant_to_batch_membership(family):
    rng = np.random.default_rng(11)
    target = rng.integers(0, 97, 9)
    others = [rng.integers(0, 97, n) for n in (6, 12)]
    sp = dict(temperature=0.9, top_k=15, top_p=0.9, seed=77)
    alone, _ = _run(family, [_req("t", target, 10, **sp)], max_slots=1,
                    max_seq=64, depth=2)
    crowded, _ = _run(family, [_req("t", target, 10, **sp)]
                      + [_req(i, p, 6, temperature=1.1, seed=i)
                         for i, p in enumerate(others)],
                      max_slots=3, max_seq=64, depth=2)
    np.testing.assert_array_equal(alone["t"], crowded["t"])


def test_engine_sampled_invariant_to_prefill_chunking(family):
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 97, n) for n in (5, 11, 7)]

    def reqs():
        return [_req(i, p, 8, temperature=0.8, top_p=0.9, seed=i)
                for i, p in enumerate(prompts)]

    mono, _ = _run(family, reqs(), max_slots=2, max_seq=64, depth=2)
    chunked, _ = _run(family, reqs(), max_slots=2, max_seq=64, depth=2,
                      prefill_chunks=(4, 8))
    for i in range(3):
        np.testing.assert_array_equal(mono[i], chunked[i])


def test_greedy_traffic_never_runs_the_sampled_step(family):
    rng = np.random.default_rng(14)
    gprompt = rng.integers(0, 97, 7)
    sprompt = rng.integers(0, 97, 9)
    alone, eng_g = _run(family, [_req("g", gprompt, 8)], max_slots=2,
                        max_seq=64)
    assert eng_g.stats["sampled_steps"] == 0
    assert eng_g.stats["decode_steps"] > 0
    mixed, eng_m = _run(family, [_req("g", gprompt, 8),
                                 _req("s", sprompt, 8, temperature=0.9,
                                      seed=3)], max_slots=2, max_seq=64)
    assert eng_m.stats["sampled_steps"] > 0
    np.testing.assert_array_equal(alone["g"], mixed["g"])


def test_engine_base_seed_default_and_divergence(family):
    prompt = np.random.default_rng(13).integers(0, 97, 8)

    def run(base):
        return _run(family, [_req(0, prompt, 10, temperature=1.0,
                                  top_k=30)],
                    max_slots=1, max_seq=64, base_seed=base)[0][0]

    a, b, c = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _knobs_of(sp):
    return (sp.temperature, sp.top_k, sp.top_p, sp.min_p, sp.seed)


@pytest.mark.parametrize("mix", [0.0, 0.3, 0.5, 1.0])
def test_sampling_plan_matches_reference(mix):
    kw = dict(temperature=0.6, top_k=50, top_p=0.9, min_p=0.05, seed=11,
              mix=mix)
    got = tserve.sampling_plan(7, **kw)
    want = jserve.sampling_plan(7, **kw)
    assert [_knobs_of(g) for g in got] == [_knobs_of(w) for w in want]
    assert tserve.sampling_plan(3, **{**kw, "temperature": 0.0}) == \
        [tserving.GREEDY] * 3


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_serve_cli_sampled_on_cpu(capsys, arch):
    argv = ["--arch", arch, "--device", "cpu", "--requests", "4",
            "--prompt-len", "12", "--gen", "4", "--slots", "2",
            "--temperature", "0.6", "--top-k", "50", "--top-p", "0.9",
            "--min-p", "0.05", "--sampling-mix", "0.5", "--seed", "7"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "4 requests, 16 tokens" in out
    assert "sampler: base_seed=7 sampled=2/4 requests" in out
    args = tserve.parse_args(argv)
    assert (args.temperature, args.top_k, args.top_p, args.min_p,
            args.sampling_mix, args.seed) == (0.6, 50, 0.9, 0.05, 0.5, 7)
    # --seed is the sampling seed: the weights come from seed 0 whatever it
    # says
    b0, p0 = tserve.build(tserve.parse_args(argv[:-2]))
    _, p7 = tserve.build(args)
    assert torch.equal(p0["embed"], p7["embed"])
