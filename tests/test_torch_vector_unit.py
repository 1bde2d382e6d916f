"""Parity of the port's vector-unit path with the JAX package's: the paper's
three kernels (fmatmul, dot product, fconv2d) through
``repro_torch.kernels.ops`` (their plain versions, on the CPU) against
``repro.kernels.ops`` in ``interpret`` mode (the Pallas kernels) and in
``ref`` mode, at the shapes and tolerances of ``tests/test_kernels.py``;
and the paper-model core modules (``reduction``, ``chaining``,
``stripmine``, ``vrf``, ``masking``) and ``configs/ara_vu`` against
their references on the same numpy inputs.  The CUDA kernels themselves
are held to the plain versions by ``tests/test_torch_cuda.py`` (on the
card) and by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import ara_vu as jara  # noqa: E402
from repro.core import chaining as jchaining  # noqa: E402
from repro.core import masking as jmasking  # noqa: E402
from repro.core import reduction as jreduction  # noqa: E402
from repro.core import stripmine as jstripmine  # noqa: E402
from repro.core import vrf as jvrf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs import ara_vu  # noqa: E402
from repro_torch.core import (chaining, masking, reduction,  # noqa: E402
                              stripmine, vrf)
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EEWS = (1, 2, 4, 8)
LANES = (1, 2, 4, 8, 16)


def _pair(x: np.ndarray, dtype: str):
    """The same f32 numpy values in both frameworks, rounded to ``dtype``
    (both round to nearest even, so the bf16 bits agree)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t, np.float32) if jnp.issubdtype(
        t.dtype, jnp.floating) else np.asarray(t)


# ---------------------------------------------------------------------------
# the three kernels (tests/test_kernels.py's shapes and tolerances)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 16, 8), (128, 128, 128),
                                   (96, 130, 70), (257, 64, 33),
                                   (1, 512, 1)])
def test_matmul_matches_jax(shape, dtype, mode):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    got = ops.matmul(ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(_np(got), _np(jops.matmul(ja, jb, mode=mode)),
                               **tol)
    np.testing.assert_allclose(_np(got), _np(jref.matmul(ja, jb)), **tol)


@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 16, 100, 128, 1024, 4097])
def test_dotp_matches_jax(n, dtype, mode):
    """n: tests/test_kernels.py's lengths and the paper's
    bench_vector_bytes / 4 (16, 128, 1024)."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    got = ops.dotp(ta, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got), _np(jops.dotp(ja, jb, mode=mode)),
                               rtol=rtol)
    np.testing.assert_allclose(_np(got), _np(jref.dotp(ja, jb)), rtol=rtol)


@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("n,hw,cin,cout,k", [
    (2, (16, 16), 3, 8, 7), (2, (32, 20), 4, 4, 3), (2, (9, 9), 1, 2, 7),
    (1, (64, 64), 3, 8, 7)])
def test_conv2d_matches_jax(n, hw, cin, cout, k, mode):
    """tests/test_kernels.py's cases and bench_conv2d.py's 64 x 64 x 3."""
    rng = np.random.default_rng(hw[0] * 100 + cin)
    x = rng.standard_normal((n, *hw, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (n, hw[0] - k + 1, hw[1] - k + 1, cout)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), mode=mode)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        _np(got), _np(jref.conv2d(jnp.asarray(x), jnp.asarray(w))),
        rtol=2e-3, atol=2e-3)


def test_plain_signatures_take_the_block_arguments():
    """The TPU block arguments are accepted and change nothing."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    assert torch.equal(ops.matmul(a, b, bm=8, bk=8, bn=8), ops.matmul(a, b))
    assert torch.equal(ops.PLAIN.matmul(a, b, bm=8), ops.matmul(a, b))
    assert torch.equal(ops.dotp(a[0], a[1], strip=1024),
                       ops.PLAIN.dotp(a[0], a[1]))
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 2)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 2, 4)).astype(np.float32))
    assert torch.equal(ops.conv2d(x, w, bh=2, bw=2), ops.PLAIN.conv2d(x, w))
    with pytest.raises(ValueError, match="larger than"):
        ops.conv2d(x, torch.zeros(7, 3, 2, 4))


# ---------------------------------------------------------------------------
# core/reduction.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("eew", EEWS)
@pytest.mark.parametrize("lanes", LANES)
def test_lane_tree_reduce_matches_jax(lanes, eew, op, dtype):
    """float32: bit for bit (the same elementwise operations in the same
    order); int: exact, int64 in the port, int32 in the reference
    (values kept inside int32)."""
    k = 8 // eew
    n = lanes * k * 5
    rng = np.random.default_rng(lanes * 10 + eew)
    if dtype == "float32":
        x = rng.standard_normal(n).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        x = rng.integers(-1000, 1000, n)
        jx, tx = jnp.asarray(x.astype(np.int32)), torch.from_numpy(x)
    got = reduction.lane_tree_reduce(tx, lanes=lanes, eew_bytes=eew, op=op)
    want = jreduction.lane_tree_reduce(jx, lanes=lanes, eew_bytes=eew, op=op)
    assert got.shape == ()
    if dtype == "float32":
        assert got.dtype == torch.float32
        assert got.numpy().view(np.uint32) == np.asarray(want).view(np.uint32)
    else:
        assert got.dtype == torch.int64
        assert int(got) == int(want)
        if op == "add":
            assert int(got) == int(x.sum())


def test_lane_tree_reduce_rejects_ragged():
    with pytest.raises(ValueError, match="lanes\\*simd"):
        reduction.lane_tree_reduce(torch.zeros(12), lanes=4, eew_bytes=4)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("vl_bytes", [64, 512, 4096])
def test_cycle_model_matches_jax(vl_bytes, lanes):
    assert (reduction.ideal_cycles(vl_bytes, lanes)
            == jreduction.ideal_cycles(vl_bytes, lanes))
    assert (reduction.ideal_cycles(vl_bytes, lanes, chained_ops=0)
            == jreduction.ideal_cycles(vl_bytes, lanes, chained_ops=0))
    for eew in EEWS:
        assert reduction.simd_lanes(eew) == jreduction.simd_lanes(eew)


# ---------------------------------------------------------------------------
# core/chaining.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [16, 256, 1000])
def test_chained_mulreduce_matches_jax(n, dtype):
    """The product in the input dtype, the sum in float32: both frameworks
    round each bf16 product once, so only the summation order differs;
    limit 1e-6 of sum |a_i b_i|."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    got = chaining.chained_mulreduce(ta, tb)
    want = jchaining.chained_mulreduce(ja, jb)
    assert got.dtype == torch.float32 and got.shape == ()
    scale = float((ta.float() * tb.float()).abs().sum())
    assert abs(float(got) - float(want)) <= 1e-6 * scale
    if dtype == "bfloat16":
        # the trap: the bf16 product is rounded before the f32 sum, where
        # ops.dotp widens first; each keeps the reference's own order
        prods = (ta * tb).float()
        assert abs(float(got) - float(prods.sum())) <= 1e-6 * scale
        assert not torch.equal(prods, ta.float() * tb.float())


# ---------------------------------------------------------------------------
# core/stripmine.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,vlmax", [(1, 16), (37, 16), (64, 32), (100, 32),
                                     (300, 100), (500, 128)])
def test_stripmine_carry_and_ragged_tail(n, vlmax):
    """A carried masked sum (the tail strip predicated) and a stacked
    tuple of per-strip outputs, against the reference's lax.scan."""
    rng = np.random.default_rng(n)
    x = rng.integers(-50, 50, n).astype(np.float32)   # exact sums

    def body(xp):
        def f(carry, strip, vl):
            mask = xp.arange(strip.shape[0]) < vl
            s = xp.where(mask, strip, xp.zeros_like(strip)).sum()
            return carry + s, (strip * 2.0 + vl, vl)
        return f

    got_c, got_o = stripmine.stripmine(body(torch), torch.zeros(()),
                                       torch.from_numpy(x), vlmax=vlmax)
    want_c, want_o = jstripmine.stripmine(body(jnp), jnp.zeros(()),
                                          jnp.asarray(x), vlmax=vlmax)
    assert float(got_c) == float(want_c) == float(x.sum())
    assert isinstance(got_o, tuple) and len(got_o) == len(want_o) == 2
    for g, w in zip(got_o, want_o):
        np.testing.assert_array_equal(_np(g), _np(w))
    padded, lengths = stripmine.pad_to_strips(torch.from_numpy(x), vlmax)
    jpadded, jlengths = jstripmine.pad_to_strips(jnp.asarray(x), vlmax)
    assert lengths.dtype == torch.int32
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    assert stripmine.num_strips(n, vlmax) == jstripmine.num_strips(n, vlmax)


@pytest.mark.parametrize("shape,axis,vlmax", [
    ((37,), 0, 16), ((2, 7, 3), 1, 4), ((5, 9), 0, 4), ((3, 10), 1, 4),
    ((2, 7, 3), -1, 2), ((4, 6), -1, 4)])
def test_stripmined_map_matches_jax(shape, axis, vlmax):
    """Reassembly of the mapped strips, including the reference's handling
    of a negative axis (the strip reaches ``fn`` strip axis first)."""
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)

    def fn(strip, vl):
        return strip * 3.0 + 1.0

    got = stripmine.stripmined_map(fn, torch.from_numpy(x), vlmax=vlmax,
                                   axis=axis)
    want = jstripmine.stripmined_map(fn, jnp.asarray(x), vlmax=vlmax,
                                     axis=axis)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# core/vrf.py
# ---------------------------------------------------------------------------

def _mem(vlenb, seed):
    return np.random.default_rng(seed).integers(0, 256, vlenb,
                                                dtype=np.uint8)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("eew", EEWS)
def test_vrf_shuffles_match_jax(eew, lanes):
    vlenb = 8 * lanes * 3
    mem = _mem(vlenb, eew * 31 + lanes)
    lane = vrf.shuffle(torch.from_numpy(mem), eew=eew, lanes=lanes)
    jlane = jvrf.shuffle(jnp.asarray(mem), eew=eew, lanes=lanes)
    assert lane.dtype == torch.uint8
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jlane))
    for other in EEWS:
        np.testing.assert_array_equal(
            vrf.deshuffle(lane, eew=other, lanes=lanes).numpy(),
            np.asarray(jvrf.deshuffle(jlane, eew=other, lanes=lanes)))
        np.testing.assert_array_equal(
            vrf.reshuffle(lane, old_eew=eew, new_eew=other,
                          lanes=lanes).numpy(),
            np.asarray(jvrf.reshuffle(jlane, old_eew=eew, new_eew=other,
                                      lanes=lanes)))
    batch = np.stack([mem, mem[::-1]])          # leading dims
    np.testing.assert_array_equal(
        vrf.shuffle(torch.from_numpy(batch.copy()), eew=eew,
                    lanes=lanes).numpy(),
        np.asarray(jvrf.shuffle(jnp.asarray(batch), eew=eew, lanes=lanes)))


@pytest.mark.parametrize("policy", ["undisturbed", "agnostic_ones"])
@pytest.mark.parametrize("eew", EEWS)
def test_vrf_write_register_matches_jax(eew, policy):
    lanes, vlenb = 4, 64
    old = vrf.shuffle(torch.from_numpy(_mem(vlenb, 1)), eew=eew, lanes=lanes)
    new = _mem(vlenb, 2)
    for vl in (0, 1, vlenb // eew // 2 + 1, vlenb // eew):
        got = vrf.write_register(old, True, torch.from_numpy(new), vl,
                                 eew=eew, lanes=lanes, tail_policy=policy)
        want = jvrf.write_register(jnp.asarray(old.numpy()), True,
                                   jnp.asarray(new), jnp.asarray(vl),
                                   eew=eew, lanes=lanes, tail_policy=policy)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="tail policy"):
        vrf.write_register(old, True, torch.from_numpy(new), 1, eew=eew,
                           lanes=lanes, tail_policy="bogus")


@pytest.mark.parametrize("bad", [dict(eew=3, lanes=4), dict(eew=4, lanes=3),
                                 dict(eew=8, lanes=16)])
def test_vrf_check_rejects_what_the_reference_rejects(bad):
    mem = np.zeros(64, np.uint8)
    with pytest.raises(ValueError):
        jvrf.shuffle(jnp.asarray(mem), **bad)
    with pytest.raises(ValueError):
        vrf.shuffle(torch.from_numpy(mem), **bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vector_register_file_sequence_matches_jax(seed):
    """The same write sequence, with EEW changes, full and partial writes
    and both tail policies: every register's bytes, EEW and the stats are
    equal, and so are the element views."""
    rng = np.random.default_rng(seed)
    kw = dict(vlen_bits=512, lanes=4, default_eew=1)
    f = vrf.VectorRegisterFile(device="cpu", **kw)
    jf = jvrf.VectorRegisterFile(**kw)
    for step in range(24):
        reg = int(rng.integers(0, 6))
        eew = int(rng.choice(EEWS))
        max_vl = f.vlenb // eew
        vl = None if rng.random() < 0.3 else int(rng.integers(0, max_vl + 1))
        policy = "undisturbed" if rng.random() < 0.7 else "agnostic_ones"
        mem = _mem(f.vlenb, seed * 100 + step)
        f.write(reg, torch.from_numpy(mem), eew=eew, vl=vl,
                tail_policy=policy)
        jf.write(reg, jnp.asarray(mem), eew=eew, vl=vl, tail_policy=policy)
    assert f.stats == jf.stats and f.stats["reshuffles"] > 0
    for reg in range(f.NUM_REGS):
        assert f.state[reg].eew == jf.state[reg].eew
        np.testing.assert_array_equal(f.regs[reg].numpy(),
                                      np.asarray(jf.regs[reg]))
        for td, jd in ((torch.uint8, jnp.uint8), (torch.int16, jnp.int16),
                       (torch.int32, jnp.int32), (torch.float32,
                                                  jnp.float32)):
            np.testing.assert_array_equal(
                f.elements(reg, td).numpy().view(np.uint8),
                np.asarray(jf.elements(reg, jd)).view(np.uint8))


def test_vector_register_file_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        vrf.VectorRegisterFile()


# ---------------------------------------------------------------------------
# core/masking.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_bits", [1, 7, 8, 9, 64, 200])
def test_pack_unpack_bits_match_jax(num_bits):
    bits = np.random.default_rng(num_bits).integers(0, 2, num_bits) > 0
    packed = masking.pack_bits(torch.from_numpy(bits), num_bits)
    jpacked = jmasking.pack_bits(jnp.asarray(bits), num_bits)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    got = masking.unpack_bits(packed, num_bits)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmasking.unpack_bits(jpacked, num_bits)))
    np.testing.assert_array_equal(got.numpy(), bits)
    raw = np.random.default_rng(num_bits + 1).integers(0, 256, (3, 5),
                                                        dtype=np.uint8)
    np.testing.assert_array_equal(   # leading dims, every byte value
        masking.unpack_bits(torch.from_numpy(raw), 37).numpy(),
        np.asarray(jmasking.unpack_bits(jnp.asarray(raw), 37)))


@pytest.mark.parametrize("lanes", [2, 4, 8])
@pytest.mark.parametrize("stored_eew", EEWS)
def test_mask_unit_matches_jax(stored_eew, lanes):
    vlenb, num_elems = 8 * lanes * 2, lanes * 16
    reg = _mem(vlenb, stored_eew * 10 + lanes).reshape(lanes, -1)
    got = masking.mask_unit(torch.from_numpy(reg), stored_eew=stored_eew,
                            lanes=lanes, num_elems=num_elems)
    want = jmasking.mask_unit(jnp.asarray(reg), stored_eew=stored_eew,
                              lanes=lanes, num_elems=num_elems)
    assert tuple(got.shape) == (lanes, num_elems // lanes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predication_matches_jax():
    dest = np.arange(8, dtype=np.float32)
    src = np.arange(8, dtype=np.float32) * 7 - 3
    mask = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)

    def fn(x):
        return x * 10

    got = masking.predicated(fn)(torch.from_numpy(dest), torch.from_numpy(src),
                                 mask=torch.from_numpy(mask))
    want = jmasking.predicated(fn)(jnp.asarray(dest), jnp.asarray(src),
                                   mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        masking.apply_mask(torch.from_numpy(dest), torch.from_numpy(src),
                           torch.from_numpy(mask)).numpy(),
        np.asarray(jmasking.apply_mask(jnp.asarray(dest), jnp.asarray(src),
                                       jnp.asarray(mask))))
    for vl in (0, 3, 8):
        np.testing.assert_array_equal(
            masking.tail_mask(8, torch.tensor(vl)).numpy(),
            np.asarray(jmasking.tail_mask(8, jnp.asarray(vl))))
        np.testing.assert_array_equal(masking.tail_mask(8, vl).numpy(),
                                      np.arange(8) < vl)


# ---------------------------------------------------------------------------
# configs/ara_vu.py
# ---------------------------------------------------------------------------

def test_ara_vu_config_matches_jax():
    got, want = ara_vu.CONFIG, jara.CONFIG
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert got.vrf_bytes == want.vrf_bytes == 16384
    for lanes in (None, 2, 4, 16):
        assert (got.peak_dp_flops_per_cycle(lanes)
                == want.peak_dp_flops_per_cycle(lanes))
    assert ara_vu.VectorUnitConfig(lanes=8) == ara_vu.VectorUnitConfig(
        **{**dataclasses.asdict(got), "lanes": 8})
