"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither jax nor the JAX package, so it runs where
JAX is absent; every test skips without a CUDA device.  On the card:

    PYTHONPATH=src python -m pytest --noconftest -m gpu -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py imports jax.)
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

PARKED = (1 << 30) + 1


def _within_limit(got, want):
    """Every element within its limit: 2e-5 in f32; in bf16 one bf16 ulp of
    the larger magnitude plus 2^-20 (both versions round one f32 result to
    bf16 once; ``chip_smoke.py`` states the argument)."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        return bool(((g - w).abs() <= 2e-5).all())
    big = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(big)
    ulp = torch.where(big == 0, 0.0, torch.ldexp(torch.ones_like(big), e - 8))
    return bool(((g - w).abs() <= ulp + 2.0 ** -20).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rn(3, 6, 16), rn(3, 40, 2, 16), rn(3, 40, 2, 16)
    lens = torch.tensor([1, 17, PARKED], device=cuda)
    got = ops.flash_decode(q, k, v, lengths=lens)
    want = ops.PLAIN.flash_decode(q, k, v, lengths=lens)
    assert _within_limit(got, want)
    qc = rn(2, 8, 6, 16)
    pre = torch.tensor([0, 9], device=cuda)
    got = ops.flash_prefill_chunk(qc, k[:2], v[:2], prefix=pre)
    want = ops.PLAIN.flash_prefill_chunk(qc, k[:2], v[:2], prefix=pre)
    assert _within_limit(got, want)
    qa, ka, va = rn(2, 6, 33, 16), rn(2, 2, 33, 16), rn(2, 2, 33, 16)
    got = ops.attention(qa, ka, va)
    want = ops.PLAIN.attention(qa, ka, va)
    assert _within_limit(got, want)


@pytest.mark.gpu
def test_cuda_chunk_rows_bit_equal_decode(cuda):
    """Chunk row j == flash_decode at pos = prefix + j, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    c, s, kvh, h, d = 16, 300, 2, 6, 16
    q = torch.randn((1, c, h, d), generator=gen, device=cuda)
    k = torch.randn((1, s, kvh, d), generator=gen, device=cuda)
    v = torch.randn((1, s, kvh, d), generator=gen, device=cuda)
    pre = 200
    chunk = ops.flash_prefill_chunk(q, k, v, prefix=torch.tensor([pre],
                                                                 device=cuda))
    dec = ops.flash_decode(q[0], k.expand(c, s, kvh, d),
                           v.expand(c, s, kvh, d),
                           lengths=pre + 1 + torch.arange(c, device=cuda))
    assert torch.equal(chunk[0], dec)


def _ssd_within_limit(got, want):
    """ssd's per-element limit (``chip_smoke.py`` states the argument):
    1e-4 of the element or of the output's rms (two f32 summation orders),
    plus one ulp of the output type (each version rounds once)."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean().sqrt()
    big = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(big)
    bits = 8 if got.dtype == torch.bfloat16 else 24
    ulp = torch.where(big == 0, 0.0,
                      torch.ldexp(torch.ones_like(big), e - bits))
    return bool(((g - w).abs() <= ulp + 1e-4 * (w.abs() + rms)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 20, 64, 200])
def test_cuda_ssd_matches_plain(cuda, dtype, s):
    """The ssd kernel against its plain version: ragged S, an initial
    state, B/C rows shared by 3 heads, strided x / log_a views."""
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    bh, p, n = 6, 16, 8
    x = rn(s, bh, p).to(dtype).transpose(0, 1)
    la = -rn(s, bh).abs().transpose(0, 1) * 0.1
    B, C = rn(2, s, n).to(dtype), rn(2, s, n).to(dtype)
    st = rn(bh, n, p)
    for init in (None, st):
        got = ops.ssd(x, la, B, C, chunk=16, initial_state=init)
        want = ops.PLAIN.ssd(x, la, B, C, chunk=16, initial_state=init)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        assert _ssd_within_limit(got[0], want[0])
        assert _ssd_within_limit(got[1], want[1])


def _reassoc_within_limit(got, want, bound):
    """The vector-unit kernels' limit (``chip_smoke.py`` states it): the
    per-element reassociation bound c 2^-24 sum |a b| of the kernel module's
    ``error_bound``, plus one bf16 ulp of the larger magnitude for a bf16
    output."""
    g, w = got.float(), want.float()
    lim = bound
    if got.dtype == torch.bfloat16:
        big = torch.maximum(g.abs(), w.abs())
        _, e = torch.frexp(big)
        lim = lim + torch.where(big == 0, 0.0,
                                torch.ldexp(torch.ones_like(big), e - 8))
    return bool(((g - w).abs() <= lim).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 16, 16), (257, 64, 33),
                                   (96, 130, 70), (1, 512, 1), (130, 0, 5)])
def test_cuda_matmul_matches_plain(cuda, dtype, shape):
    """Ragged M / K / N (and K = 0) masked in the kernel; A a column
    slice (row stride K + 3)."""
    from repro_torch.kernels import matmul
    gen = torch.Generator(device=cuda).manual_seed(3)
    m, k, n = shape
    a = torch.randn((m, k + 3), generator=gen, device=cuda).to(dtype)[:, :k]
    b = torch.randn((k, n), generator=gen, device=cuda).to(dtype)
    before = matmul.launches
    got = ops.matmul(a, b)
    assert matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert _reassoc_within_limit(got, ops.PLAIN.matmul(a, b),
                                 matmul.error_bound(a, b))
    with pytest.raises(TypeError, match="mixed"):
        ops.matmul(a.float(), b.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 8, 100, 4097, 1 << 20])
def test_cuda_dotp_matches_plain_and_repeats(cuda, dtype, n):
    """Ragged tails, an unaligned view (scalar loads), and the same bits
    on a second launch."""
    from repro_torch.kernels import dotp
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn((n + 1,), generator=gen, device=cuda).to(dtype)
    b = torch.randn((n,), generator=gen, device=cuda).to(dtype)
    for x in (a[:n], a[1:]):                 # aligned, then offset by one
        got = ops.dotp(x, b)
        assert got.dtype == torch.float32 and got.shape == ()
        assert _reassoc_within_limit(got, ops.PLAIN.dotp(x, b),
                                     dotp.error_bound(x, b))
        again = dotp.launch(x.clone(), b.clone())
        assert torch.equal(got.reshape(1).view(torch.int32),
                           again.reshape(1).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,ws", [
    ((2, 16, 16, 3), (7, 7, 3, 8)), ((2, 32, 20, 4), (3, 3, 4, 4)),
    ((2, 9, 9, 1), (7, 7, 1, 2)), ((1, 40, 37, 20), (7, 7, 20, 70)),
    ((1, 12, 30, 5), (3, 5, 5, 16))])
def test_cuda_conv2d_matches_plain(cuda, dtype, xs, ws):
    """Ragged output tiles; Cout above one 64-channel block and not a
    multiple of 8; 20 input channels at 7 x 7 staged 6 per pass (83 KB of
    shared memory); a non-square window."""
    from repro_torch.kernels import conv2d
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(xs, generator=gen, device=cuda).to(dtype)
    w = torch.randn(ws, generator=gen, device=cuda).to(dtype)
    got = ops.conv2d(x, w)
    assert got.dtype == dtype
    assert got.shape == (xs[0], xs[1] - ws[0] + 1, xs[2] - ws[1] + 1, ws[3])
    assert _reassoc_within_limit(got, ops.PLAIN.conv2d(x, w),
                                 conv2d.error_bound(x, w))
