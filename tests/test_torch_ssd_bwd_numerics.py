"""The arithmetic of the bf16 tensor-core SSD backward
(``src/repro_torch/kernels/csrc/ssd_bwd.cu``, ``ssd_bwd_tc_states`` and
``ssd_bwd_tc_chunk``), emulated in plain PyTorch on the CPU and held to the
card's limit against the port's plain backward (``ops._ssd_bwd_plain``)
and, in one case, ``jax.vjp`` of the JAX package's ``_chunked_ssd_ref``.

The schedule, per (batch * head) row and 64-token chunk, with cum the
inclusive cumsum of log_a in the chunk, ecum = exp(cum), wdec =
exp(total - cum) and L_ij = exp(cum_i - cum_j) [j <= i]:

  * the state walk: S0 of chunk c in chunk order from ``initial_state``,
    S = exp(total) S + B^T (wdec x); dS of chunk c in reverse chunk order
    from zero, dS = exp(total) dS + C^T (ecum dy).  The carried states stay
    f32; the decay-weighted x and dy enter the products as ``n_terms`` bf16
    terms, and each chunk's S0 and dS are written as ``n_terms`` bf16
    terms (the scratch the chunk kernel reads);
  * the chunk: C B^T and dy x^T from the bf16 operands (exact products,
    f32 sums), G = C B^T (.) L and W = dy x^T (.) L in f32; dx = G^T dy +
    wdec (B dS), dC = W B + ecum (dy S0^T), dB = W^T C + wdec (x dS^T), G
    and W as ``n_terms`` terms; d log_a from the row and column sums of W
    (.) C B^T, the carry terms' dots and ecum[-1] <dS, S0> in f32, then the
    suffix sums over the chunk;
  * dB and dC summed over each B/C row's heads in head order within the
    bf16 kernel's slices (``ssd_bwd.tc_slices``), then the slices in
    order, and rounded once.

The limit is the card's (``tests/test_torch_cuda.py`` ``_bwd_within``,
``chip_smoke.py`` ``bwd_excess``): per element one ulp of the output's type
at the larger magnitude plus 1e-4 times the plain gradient's rms.  Two
terms stay inside it at mamba2-2.7b's and hymba-1.5b's widths; one term
misses it by more than 10x.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ssd_bwd  # noqa: E402

Q = ssd_bwd.CHUNK
BWD_RTOL = 1e-4


def split_terms(v, n):
    """``v`` (f32) as ``n`` bf16-valued terms, each the rounding of the
    remainder the terms before it leave."""
    terms, rest = [], v
    for _ in range(n):
        t = rest.bfloat16().float()
        terms.append(t)
        rest = rest - t
    return terms


def fed(v, n):
    """What the tensor cores see of the f32 operand ``v`` fed as ``n``
    bf16 terms: their sum, exact in f32 (each term's products with a bf16
    operand are exact, and the terms share one f32 accumulator)."""
    return sum(split_terms(v, n))


def emulate(x, la, B, C, dy, initial_state=None, *, n_terms=2, sms=132):
    """The kernels' schedule on CPU tensors: x, dy (BH, S, P) bf16; la
    (BH, S) f32; B / C (BH / r, S, N) bf16, row g shared by the r rows g r
    .. g r + r - 1 of x; initial_state (BH, N, P) f32 or None.  Returns
    (dx bf16, dla f32, dB bf16, dC bf16)."""
    bh, s, p = x.shape
    nb, _, n = B.shape
    r = bh // nb
    nch = -(-s // Q)
    pad = nch * Q - s

    def chunks(t, width):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.reshape(t.shape[0], nch, Q, width)
    xc, dyc = chunks(x, p), chunks(dy, p)
    Bc, Cc = (chunks(t, n).repeat_interleave(r, 0) for t in (B, C))
    lac = torch.nn.functional.pad(la.float(), (0, pad)).reshape(bh, nch, Q)
    cum = torch.cumsum(lac, dim=-1)
    ecum = torch.exp(cum)
    wdec = torch.exp(cum[..., -1:] - cum)
    dec = ecum[..., -1]

    # the state walk, one row's chunks in order (forward) and reversed
    h = (torch.zeros((bh, n, p)) if initial_state is None
         else initial_state.float())
    s0 = [None] * nch
    for c in range(nch):
        s0[c] = h
        h = dec[:, c, None, None] * h + Bc[:, c].transpose(1, 2) @ fed(
            wdec[:, c, :, None] * xc[:, c], n_terms)
    d = torch.zeros((bh, n, p))
    ds = [None] * nch
    for c in reversed(range(nch)):
        ds[c] = d
        d = dec[:, c, None, None] * d + Cc[:, c].transpose(1, 2) @ fed(
            ecum[:, c, :, None] * dyc[:, c], n_terms)
    s0 = fed(torch.stack(s0, 1), n_terms)   # the scratch, as terms
    ds = fed(torch.stack(ds, 1), n_terms)

    # the chunk kernel
    i = torch.arange(Q)
    lmat = torch.where(i[None, :] <= i[:, None],
                       torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    cb = Cc @ Bc.transpose(-1, -2)
    g = cb * lmat
    w = (dyc @ xc.transpose(-1, -2)) * lmat
    wq = fed(w, n_terms)
    dx = (fed(g, n_terms).transpose(-1, -2) @ dyc
          + wdec[..., None] * (Bc @ ds))
    c_carry = ecum[..., None] * (dyc @ s0.transpose(-1, -2))
    b_carry = wdec[..., None] * (xc @ ds.transpose(-1, -2))
    dC = wq @ Bc + c_carry
    dB = wq.transpose(-1, -2) @ Cc + b_carry
    m = w * cb
    b_dot = (Bc * b_carry).sum(-1)
    dcum = m.sum(-1) - m.sum(-2) + (Cc * c_carry).sum(-1) - b_dot
    dcum[..., -1] += dec * (ds * s0).sum((-1, -2)) + b_dot.sum(-1)
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), dim=-1), [-1])

    # dB / dC: head order inside a slice, then the slices in order
    hs, _ = ssd_bwd.tc_slices(r, nb, s, sms)

    def heads_summed(t):
        t = t.reshape(nb, r, nch * Q, n)
        parts = []
        for h0 in range(0, r, hs):
            acc = t[:, h0]
            for hh in range(h0 + 1, min(r, h0 + hs)):
                acc = acc + t[:, hh]
            parts.append(acc)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out[:, :s].bfloat16()

    return (dx.reshape(bh, nch * Q, p)[:, :s].bfloat16(),
            dla.reshape(bh, nch * Q)[:, :s], heads_summed(dB),
            heads_summed(dC))


def excess(got, want):
    """max over the gradients and their elements of |got - want| / the
    card's limit (<= 1 passes)."""
    worst = 0.0
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        big = torch.maximum(g32.abs(), w32.abs())
        _, e = torch.frexp(big)
        bits = 8 if g.dtype == torch.bfloat16 else 24
        ulp = torch.where(big == 0, 0.0,
                          torch.ldexp(torch.ones_like(big), e - bits))
        lim = ulp + BWD_RTOL * w32.pow(2).mean().sqrt()
        worst = max(worst, ((g32 - w32).abs() / lim).max().item())
    return worst


def _inputs(seed, bh, nb, s, p, n, with_state=False):
    """As phase 3t makes them: x * 0.05, log decays in (-0.1, 0], B, C and
    dy standard normal, in bf16; an initial state of std 0.1."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = torch.from_numpy(rng.standard_normal((bh, s, p), f)
                         * 0.05).bfloat16()
    la = torch.from_numpy(-rng.random((bh, s), f) * 0.1)
    B = torch.from_numpy(rng.standard_normal((nb, s, n), f)).bfloat16()
    C = torch.from_numpy(rng.standard_normal((nb, s, n), f)).bfloat16()
    dy = torch.from_numpy(rng.standard_normal((bh, s, p), f)).bfloat16()
    st = (torch.from_numpy(rng.standard_normal((bh, n, p), f) * 0.1)
          if with_state else None)
    return x, la, B, C, dy, st


CASES = {
    # name: (rows, B/C rows, S, P, N, initial state)
    "mamba2_width": (16, 2, 256, 64, 128, False),   # 8 heads a B/C row
    "mamba2_many_heads": (80, 1, 128, 64, 128, False),
    "hymba_width": (10, 2, 320, 64, 16, False),
    "ragged": (6, 3, 200, 12, 20, False),
    "ragged_init": (6, 2, 131, 40, 72, True),
    "mamba2_init": (8, 2, 192, 64, 128, True),
}


def _excess(case, n_terms, sms=132):
    bh, nb, s, p, n, init = CASES[case]
    x, la, B, C, dy, st = _inputs(len(case) + s, bh, nb, s, p, n, init)
    got = emulate(x, la, B, C, dy, st, n_terms=n_terms, sms=sms)
    want = ops._ssd_bwd_plain(x, la, B, C, dy, chunk=Q, initial_state=st)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    return excess(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_terms_within_card_limit(case):
    """Two bf16 terms per f32 operand stay inside the limit at every
    width: mamba2-2.7b's (P 64, N 128) with 8 and 80 heads a B/C row,
    hymba-1.5b's N 16, ragged S, N and P, and an initial state."""
    assert _excess(case, 2) <= 1.0


@pytest.mark.parametrize("sms", [1, 16, 132])
def test_two_terms_within_limit_over_several_slices(sms):
    """80 heads a B/C row over 2 chunks, cut as the card's SMs allow (1
    SM: one slice of all 80; 16 SMs: 8 slices of 10; 132 SMs: 40 slices
    of 2): the slices' order of summation keeps the limit."""
    assert ssd_bwd.tc_slices(80, 1, 128, sms)[1] == {1: 1, 16: 8,
                                                     132: 40}[sms]
    assert _excess("mamba2_many_heads", 2, sms=sms) <= 1.0


def test_one_term_misses_the_limit_at_mamba2_width():
    """G, W, the decay-weighted x and dy and the scratch states cast to
    bf16 once (~2^-9 relative) miss the limit by more than 10x: two terms
    are the fewest that hold it."""
    assert _excess("mamba2_width", 1) > 10.0


def test_one_term_misses_the_limit_at_hymba_width():
    assert _excess("hymba_width", 1) > 10.0


def test_emulation_matches_the_jax_vjp():
    """The emulation against ``jax.vjp`` of the reference's
    ``_chunked_ssd_ref`` (B/C repeated to their heads inside the
    differentiated function), ragged S with an initial state, under the
    same limit."""
    x, la, B, C, dy, st = _inputs(11, 6, 2, 131, 16, 24, True)
    r = 3
    got = emulate(x, la, B, C, dy, st)

    def jf(x, la, B, C):
        return jops._chunked_ssd_ref(
            x, la, jnp.repeat(B, r, axis=0), jnp.repeat(C, r, axis=0),
            chunk=Q, initial_state=jnp.asarray(st.numpy()))[0]
    args = [jnp.asarray(t.float().numpy()) for t in (x, la, B, C)]
    _, vjp = jax.vjp(jf, *args)
    jg = vjp(jnp.asarray(dy.float().numpy()))
    want = [torch.from_numpy(np.array(t)) for t in jg]
    want = [w.to(g.dtype) for g, w in zip(got, want)]
    assert excess(got, want) <= 1.0


def test_scratch_holds_two_terms_in_the_states_bytes():
    """The bf16 path's scratch: each chunk's S0 and dS as hi and lo bf16
    planes of d_state and headdim rounded up to 16, the bytes an f32 state
    takes at mamba2-2.7b's width, plus the slices' f32 partial dB / dC
    (2 slices of 40 heads in bf16, 5 of 16 in f32)."""
    bh, nb, s, n, p = 160, 2, 2048, 128, 64
    states = 2 * bh * (s // Q) * n * p * 4
    assert ssd_bwd.scratch_bytes(bh, nb, s, n, p, 132) == (
        states + 2 * 5 * nb * s * n * 4)
    assert ssd_bwd.scratch_bytes(bh, nb, s, n, p, 132,
                                 dtype=torch.bfloat16) == (
        states + 2 * 2 * nb * s * n * 4)
    # ragged widths: the bf16 planes are padded to 16 x 16 tiles
    got = ssd_bwd.scratch_bytes(6, 3, 200, 20, 12, 132,
                                dtype=torch.bfloat16)
    _, sl = ssd_bwd.tc_slices(2, 3, 200, 132)
    assert got == 2 * 6 * 4 * 32 * 16 * 4 + 2 * sl * 3 * 200 * 20 * 4


@pytest.mark.parametrize("r,nb,s,want", [
    (80, 2, 2048, (40, 2)),     # mamba2-2.7b at batch 2 x 2048: one wave
    (50, 2, 2048, (25, 2)),     # hymba-1.5b at batch 2 x 2048
    (80, 1, 1000, (10, 8)),     # 16 chunks: 128 blocks of 10 heads
    (80, 1, 64, (1, 80)),       # one chunk: a slice a head
    (3, 2, 20, (1, 3)),
])
def test_tc_slices_fill_one_wave(r, nb, s, want):
    """The bf16 chunk kernel's cut on 132 SMs (one block an SM): the
    fewest rounds of head work, then the fewest slices; every head in one
    slice, none empty."""
    hs, sl = ssd_bwd.tc_slices(r, nb, s, 132)
    assert (hs, sl) == want
    assert hs * sl >= r and (sl - 1) * hs < r
