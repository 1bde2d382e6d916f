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
