"""The arithmetic of the bf16 tensor-core ssd routine
(``src/repro_torch/kernels/csrc/ssd.cu``, ``tc::ssd_tc_kernel``), emulated
in plain PyTorch on the CPU and held to the card's limit against the port's
plain version and the JAX package's ``ops.ssd`` in ref mode.

The routine cuts each (batch * head) row's 64-token chunks into
``ssd.pieces`` consecutive pieces.  Pass 1 scans every piece but the last
from a zero state and keeps its local end state and decay product; pass 2
folds the pieces before its own in order (state = dec * state + local, from
``initial_state``) and scans its chunks from that carry-in.  Per chunk it
forms S = C B^T from the bf16 operands (exact products, f32 sums), the
decayed scores G = S exp(cum_i - cum_j) [j <= i], y = exp(cum) (C H) + G X
and H = exp(total) H + B^T (w X) with w = exp(total - cum).  G, H and w X
are f32; the tensor cores take them as ``n_terms`` bf16 terms, each the
rounding of what the terms before it leave.  Two terms stay inside the
card's limit at mamba2-2.7b width; one term misses it.

The limit is the card's (``chip_smoke.py`` ``ssd_limit``,
``tests/test_torch_cuda.py``): per element SSD_RTOL (|want| + rms(want))
plus one ulp of the output type at the larger magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ssd  # noqa: E402

Q = ssd.CHUNK
SSD_RTOL = 1e-4


def split_terms(v, n):
    """``v`` (f32) as ``n`` bf16-valued terms, each the rounding of the
    remainder the terms before it leave."""
    terms, rest = [], v
    for _ in range(n):
        t = rest.bfloat16().float()
        terms.append(t)
        rest = rest - t
    return terms


def _chunk(h, x, la, B, C, *, want_y, n_terms):
    """One 64-token chunk of every row: h (BH, N, P) f32; x (BH, Q, P),
    la (BH, Q), B / C (BH, Q, N), zero past S.  Returns (y f32 or None,
    new h, the chunk's decay exp(total))."""
    cum = torch.cumsum(la, dim=-1)
    ecum = torch.exp(cum)
    dec = ecum[:, -1]
    y = None
    if want_y:
        s = C @ B.transpose(1, 2)
        i = torch.arange(Q)
        keep = i[None, :] <= i[:, None]
        g = torch.where(keep, s * torch.exp(cum[:, :, None] - cum[:, None, :]),
                        0.0)
        y = sum(C @ t for t in split_terms(h, n_terms)) * ecum[..., None]
        y = y + sum(t @ x for t in split_terms(g, n_terms))
    wx = torch.exp(cum[:, -1:] - cum)[..., None] * x
    h = h * dec[:, None, None] + sum(B.transpose(1, 2) @ t
                                     for t in split_terms(wx, n_terms))
    return y, h, dec


def emulate(x, la, B, C, initial_state=None, *, sms=132, n_terms=2):
    """The kernel's schedule on CPU tensors: x (BH, S, P) bf16, la (BH, S)
    f32, B / C (BH / r, S, N) bf16 (row g shared by r rows of x),
    initial_state (BH, N, P) f32 or None.  Returns (y bf16, final state
    f32)."""
    bh, s, p = x.shape
    r = bh // B.shape[0]
    n = B.shape[-1]
    g_count, cpp = ssd.pieces(bh, s, sms)
    nch = -(-s // Q)
    pad = nch * Q - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    laf = torch.nn.functional.pad(la.float(), (0, pad))
    Bf, Cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
              .repeat_interleave(r, 0) for t in (B, C))

    def run(piece, h, want_y):
        ys, d = [], torch.ones(bh)
        for c in range(piece * cpp, min(piece * cpp + cpp, nch)):
            sl = slice(c * Q, c * Q + Q)
            y, h, dec = _chunk(h, xf[:, sl], laf[:, sl], Bf[:, sl], Cf[:, sl],
                               want_y=want_y, n_terms=n_terms)
            ys.append(y)
            d = d * dec
        return ys, h, d

    zero = torch.zeros((bh, n, p))
    local = [run(q, zero, False)[1:] for q in range(g_count - 1)]
    ys = []
    for piece in range(g_count):
        h = zero if initial_state is None else initial_state.float()
        for loc, dec in local[:piece]:
            h = dec[:, None, None] * h + loc
        y, h, _ = run(piece, h, True)
        ys += y
    y = torch.cat(ys, dim=1)[:, :s] if ys else torch.zeros((bh, 0, p))
    return y.bfloat16(), h


def excess(got, want):
    """max over elements of |got - want| / the card's ssd limit (<= 1
    passes)."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(big)
    bits = 24 if got.dtype == torch.float32 else 8
    ulp = torch.where(big == 0, 0.0, torch.ldexp(torch.ones_like(big),
                                                 e - bits))
    lim = ulp + SSD_RTOL * (w.abs() + w.pow(2).mean().sqrt())
    return ((g - w).abs() / lim).max().item() if g.numel() else 0.0


def _inputs(seed, bh, s, p, n, groups):
    """As chip_smoke.py makes them: x * 0.05 and B / C in bf16, log decays
    -dt with dt in [0, 0.1), an initial state of std 0.1."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bh, s, p), np.float32)
                         * 0.05).bfloat16()
    la = torch.from_numpy(-rng.random((bh, s), np.float32) * 0.1)
    B = torch.from_numpy(rng.standard_normal((groups, s, n),
                                             np.float32)).bfloat16()
    C = torch.from_numpy(rng.standard_normal((groups, s, n),
                                             np.float32)).bfloat16()
    st = torch.from_numpy(rng.standard_normal((bh, n, p), np.float32) * 0.1)
    return x, la, B, C, st


def test_pieces_fill_the_card_and_cover_every_chunk():
    """80 rows at S 1024 on 132 SMs: 3 pieces of 6 / 6 / 4 chunks (240
    blocks); one piece once the rows alone fill two blocks an SM; never an
    empty piece; no chunk, one piece."""
    assert ssd.pieces(80, 1024, 132) == (3, 6)
    assert ssd.pieces(320, 1024, 132) == (1, 16)
    assert ssd.pieces(4, 0, 132) == (1, 0)
    for bh in (1, 3, 80, 200):
        for s in (1, 63, 64, 65, 200, 1000, 1024):
            g, cpp = ssd.pieces(bh, s, 132)
            nch = -(-s // Q)
            assert 1 <= g <= nch and (g - 1) * cpp < nch <= g * cpp
    assert ssd.carried_bytes(80, 1024, 132) == 80 * 2 * (128 * 64 + 1) * 4


def test_bf16_rows_are_made_16_byte_aligned():
    """The bf16 kernel's operand contract (``ssd._rows16``): a view whose
    base or row strides are not 16-byte aligned is copied into a buffer
    with aligned rows and the same values; an aligned one passes as it
    is."""
    base = torch.randn(3, 10, 13).bfloat16()
    for t in (base, base[:, :, 1:], base[:, 1:, :8]):
        got = ssd._rows16(t)
        assert torch.equal(got, t)
        assert got.data_ptr() % 16 == 0
        assert all(st % 8 == 0 for st in got.stride()[:-1])
    ok = torch.randn(2, 5, 16).bfloat16().transpose(0, 1)
    assert ssd._rows16(ok) is ok


@pytest.mark.parametrize("s", [1, 63, 200, 1000])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("sms", [132, 5])
def test_emulation_within_card_limit(s, with_state, groups, sms):
    """Ragged S, with and without an initial state, B/C rows shared by 2
    or 4 heads; 132 SMs cut the 4 rows into one piece a chunk, 5 SMs into
    two pieces of several chunks.  Held to the port's plain version (the
    serving path's 256-token chunks) and to the JAX package's ops.ssd in
    ref mode."""
    bh, p, n = 4, 16, 32
    x, la, B, C, st = _inputs(s + groups, bh, s, p, n, groups)
    init = st if with_state else None
    got_y, got_st = emulate(x, la, B, C, init, sms=sms)
    want_y, want_st = ops.PLAIN.ssd(x, la, B, C, chunk=256,
                                    initial_state=init)
    assert excess(got_y, want_y) <= 1.0
    assert excess(got_st, want_st) <= 1.0
    r = bh // groups
    jy, jst = jops.ssd(jnp.asarray(x.float().numpy()), jnp.asarray(la.numpy()),
                       jnp.asarray(B.float().repeat_interleave(r, 0).numpy()),
                       jnp.asarray(C.float().repeat_interleave(r, 0).numpy()),
                       chunk=256, mode="ref",
                       initial_state=None if init is None
                       else jnp.asarray(init.numpy()))
    assert excess(got_y, torch.from_numpy(np.array(jy))) <= 1.0
    assert excess(got_st, torch.from_numpy(np.array(jst))) <= 1.0


def _mamba2_excess(n_terms, with_state):
    """4 heads of mamba2-2.7b width (P 64, N 128, one B/C group), S 1024,
    on 132 SMs (16 pieces of one chunk: the most carries)."""
    x, la, B, C, st = _inputs(7, 4, 1024, 64, 128, 1)
    init = st if with_state else None
    got = emulate(x, la, B, C, init, n_terms=n_terms)
    want = ops.PLAIN.ssd(x, la, B, C, chunk=256, initial_state=init)
    return max(excess(got[0], want[0]), excess(got[1], want[1]))


@pytest.mark.parametrize("with_state", [False, True])
def test_two_terms_pass_at_mamba2_width(with_state):
    assert _mamba2_excess(2, with_state) <= 1.0


def test_one_term_misses_the_limit_at_mamba2_width():
    """G, H and w X cast to bf16 once (~2^-9 relative) miss the limit by
    more than 10x."""
    assert _mamba2_excess(1, False) > 10.0


@pytest.mark.parametrize("s,groups,with_state", [(64, 2, True),
                                                 (128, 1, True),
                                                 (192, 1, False),
                                                 (192, 2, True)])
def test_phase_5c_control_is_the_one_term_routine(s, groups, with_state):
    """``chip_smoke.one_term``, the lower-precision control phase 5c's
    state limits must reject, is this emulation with one term on one
    piece, bit for bit, and misses the card's kernel-level limit."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    x, la, B, C, st = _inputs(s, 4, s, 16, 32, groups)
    init = st if with_state else None
    got = chip_smoke.one_term()(x, la, B, C, initial_state=init)
    want = emulate(x, la, B, C, init, sms=1, n_terms=1)
    assert ssd.pieces(4, s, 1) == (1, s // Q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = ops.PLAIN.ssd(x, la, B, C, chunk=256, initial_state=init)
    assert excess(got[1], plain[1]) > 10.0
