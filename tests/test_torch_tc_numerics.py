"""The arithmetic of the bf16 tensor-core attention routine
(``src/repro_torch/kernels/csrc/flash_tc.cuh``), emulated in plain PyTorch
on the CPU and held to the card's limit against the port's plain versions.

The routine computes per 64-key strip S = Q K^T from the bf16 operands with
f32 accumulation (the products are exact), scales S in f32 after the
product, runs the online softmax in f32, and feeds P to the P.V product as
bf16 register operands.  This file justifies how P is fed: split into three
bf16 terms P = P_hi + P_mid + P_lo (each the bf16 rounding of what the
terms before it leave, so P is exact), every term multiplied by V into the
same f32 accumulator.  One term (P cast to bf16, as SDPA does) misses the
limit by far; two terms (hi + lo, ~2^-18 relative per term) still miss it
where a few keys cancel to a small output (a sliding window at hd 128);
three stay inside it.  The limit is the card's (``chip_smoke.py``,
``tests/test_torch_cuda.py``): one bf16 ulp of the larger magnitude plus
2^-20 per element.

The emulation follows the kernels' structure: flash_attention walks all
strips with one softmax state; flash_prefill_chunk and flash_decode walk
128-key splits from key 0, each from a fresh state, and merge them in order
with ``merge_coeffs`` (M' = max(M, m), A' = A e^(M - M') + acc e^(m - M')).
"""
import math

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ops  # noqa: E402

BK, SPLIT = 64, 128           # keys per strip / per split, as fk::BK, SPLIT
NEG_INF = -1e30


def split_terms(e, n):
    """``e`` (f32) as ``n`` bf16 terms, each the rounding of the remainder
    the terms before it leave (the remainders are exact in f32)."""
    terms, rest = [], e
    for _ in range(n):
        t = rest.bfloat16().float()
        terms.append(t)
        rest = rest - t
    return terms


def emulate(q, k, v, qpos, *, causal, window, scale, splits, n_terms=3):
    """One (batch, KV head) tile: q (R, D) bf16 folded query rows at
    absolute positions ``qpos`` (R,); k/v (S, D) bf16.  Returns (R, D)
    bf16, rounded once from the f32 result."""
    r, d = q.shape
    s_len = k.shape[0]
    qf, kf, vf = q.float(), k.float(), v.float()

    def fresh():
        return (torch.full((r,), NEG_INF), torch.zeros(r),
                torch.zeros(r, d))

    gm, gl, acc_g = fresh()
    m, l, acc = fresh()
    for j0 in range(0, s_len, BK):
        kpos = torch.arange(j0, min(j0 + BK, s_len))
        s = (qf @ kf[j0:j0 + BK].T) * scale
        vis = torch.ones(r, kpos.numel(), dtype=torch.bool)
        if causal:
            vis &= kpos[None] <= qpos[:, None]
        if window:
            vis &= kpos[None] > qpos[:, None] - window
        s = torch.where(vis, s, -math.inf)
        mx = torch.maximum(m, s.max(-1).values)
        alpha = torch.exp(m - mx)
        e = torch.exp(s - mx[:, None])
        l = l * alpha + e.sum(-1)
        acc = acc * alpha[:, None]
        for t in split_terms(e, n_terms):
            acc = acc + t @ vf[j0:j0 + BK]
        m = mx
        if splits and ((j0 + BK) % SPLIT == 0 or j0 + BK >= s_len):
            m2 = torch.maximum(gm, m)
            a, b = torch.exp(gm - m2), torch.exp(m - m2)
            acc_g = acc_g * a[:, None] + acc * b[:, None]
            gl = gl * a + l * b
            gm = m2
            m, l, acc = fresh()
    if not splits:
        acc_g, gl = acc, l
    return (acc_g / torch.where(gl > 0, gl, 1.0)[:, None]).bfloat16()


def excess(got, want):
    """max over elements of |got - want| / (one bf16 ulp of the larger
    magnitude + 2^-20): <= 1 is within the card's limit."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(big)
    ulp = torch.where(big == 0, 0.0, torch.ldexp(torch.ones_like(big), e - 8))
    return ((g - w).abs() / (ulp + 2.0 ** -20)).max().item()


def _inputs(seed, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).bfloat16() for s in shapes]


def chunk_excess(d, c, s, pre, window, n_terms=3, kvh=2, g=3, seed=0):
    """flash_prefill_chunk: the emulation of every (KV head) tile of one
    chunk against the plain version."""
    q, k, v = _inputs(seed, (1, c, kvh * g, d), (1, s, kvh, d),
                      (1, s, kvh, d))
    want = ops.PLAIN.flash_prefill_chunk(q, k, v,
                                         prefix=torch.tensor([pre]),
                                         window=window)
    worst = 0.0
    for kh in range(kvh):
        rows = q[0, :, kh * g:(kh + 1) * g].permute(1, 0, 2).reshape(-1, d)
        qpos = (pre + torch.arange(c)).repeat(g)
        got = emulate(rows, k[0, :, kh], v[0, :, kh], qpos, causal=True,
                      window=window, scale=d ** -0.5, splits=True,
                      n_terms=n_terms)
        ref = want[0, :, kh * g:(kh + 1) * g].permute(1, 0, 2).reshape(-1, d)
        worst = max(worst, excess(got, ref))
    return worst


def decode_excess(d, s, lengths, window, kvh=2, g=3, seed=1):
    q, k, v = _inputs(seed, (len(lengths), kvh * g, d),
                      (len(lengths), s, kvh, d), (len(lengths), s, kvh, d))
    lens = torch.tensor(lengths)
    want = ops.PLAIN.flash_decode(q, k, v, lengths=lens, window=window)
    worst = 0.0
    for b, n in enumerate(lengths):
        for kh in range(kvh):
            got = emulate(q[b, kh * g:(kh + 1) * g], k[b, :, kh],
                          v[b, :, kh], torch.full((g,), n - 1), causal=True,
                          window=window, scale=d ** -0.5, splits=True)
            worst = max(worst, excess(got, want[b, kh * g:(kh + 1) * g]))
    return worst


def attention_excess(d, sq, sk, causal, window, kvh=2, g=3, seed=2):
    q, k, v = _inputs(seed, (1, kvh * g, sq, d), (1, kvh, sk, d),
                      (1, kvh, sk, d))
    want = ops.PLAIN.attention(q, k, v, causal=causal, window=window)
    worst = 0.0
    for kh in range(kvh):
        rows = q[0, kh * g:(kh + 1) * g].reshape(-1, d)
        qpos = (sk - sq + torch.arange(sq)).repeat(g)
        got = emulate(rows, k[0, kh], v[0, kh], qpos, causal=causal,
                      window=window, scale=d ** -0.5, splits=False)
        ref = want[0, kh * g:(kh + 1) * g].reshape(-1, d)
        worst = max(worst, excess(got, ref))
    return worst


@pytest.mark.parametrize("d,c,s,pre,window", [
    (16, 16, 300, 200, None), (16, 16, 300, 200, 8), (8, 8, 40, 9, 8),
    (128, 64, 300, 200, None), (128, 256, 1024, 512, None),
    (128, 256, 1024, 512, 8)])
def test_chunk_emulation_within_card_limit(d, c, s, pre, window):
    assert chunk_excess(d, c, s, pre, window) <= 1.0


@pytest.mark.parametrize("d,window", [(16, None), (8, 8), (128, None),
                                      (128, 8)])
def test_decode_emulation_within_card_limit(d, window):
    """Ragged lengths against 64-key strips and 128-key splits; one row at
    length 1, one at the arena's end."""
    assert decode_excess(d, 300, [1, 65, 200, 300], window) <= 1.0


@pytest.mark.parametrize("d,sq,sk,causal,window", [
    (16, 33, 33, True, None), (8, 50, 130, True, 8),
    (128, 50, 130, False, None), (128, 256, 256, True, None),
    (128, 256, 256, True, 8)])
def test_attention_emulation_within_card_limit(d, sq, sk, causal, window):
    assert attention_excess(d, sq, sk, causal, window) <= 1.0


@pytest.mark.parametrize("n_terms,low,high", [(1, 10.0, math.inf),
                                              (2, 1.0, 10.0)])
def test_fewer_p_terms_miss_the_limit(n_terms, low, high):
    """The same chunk with P as one bf16 term misses the limit by more than
    10x; as two terms (hi + lo) by less, but still misses it (a window of
    8 keys at hd 128: small outputs where the keys cancel)."""
    ratio = chunk_excess(128, 256, 1024, 512, 8, n_terms=n_terms)
    assert low < ratio < high, ratio


def test_bf16_operands_are_made_tma_ready():
    """The wrappers' operand contract (``_build.aligned``): a bf16 view
    whose base or strides are not 16-byte aligned is copied into a
    contiguous tensor with the same values, an aligned one (a
    broadcast batch included) is passed as it is, with ``vec`` 1; f32
    operands pass as they are with ``vec`` from the K/V operands."""
    from repro_torch.kernels import _build
    base = torch.randn(2, 6, 17).bfloat16()
    odd = base[..., 1:]                       # 2-byte base offset
    k = torch.randn(1, 40, 2, 16).bfloat16().expand(3, 40, 2, 16)
    q2, k2, vec = _build.aligned(1, odd, k)
    assert vec == 1 and k2 is k
    assert q2.is_contiguous() and q2.data_ptr() % 16 == 0
    assert torch.equal(q2, odd)
    f = base.float()[..., 1:]
    out = _build.aligned(0, f, f, f)
    assert out[:3] == (f, f, f) and out[3] == 0
