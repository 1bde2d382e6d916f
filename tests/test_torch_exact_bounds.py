"""The vector-unit kernels' error shares against an exact (float64) result,
and the bf16 matmul's padding step, on the CPU.

``matmul.error_bound_exact`` / ``plain_bound_exact`` and their ``dotp``
counterparts state how far each version may lie from the exact product;
``chip_smoke.py`` holds kernel and plain version to them at card shapes.
Here the plain versions are held to them on seeded inputs, and the two
shares are shown to add up to the kernel-vs-plain ``error_bound``.  The
padding step (``matmul.pad_operands``) gives the bf16 kernel's TMA maps
16-byte rows without changing the product.  This file imports neither jax
nor the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import dotp, matmul  # noqa: E402

RAGGED = [(257, 64, 33), (96, 130, 70), (1, 512, 1), (130, 0, 5)]


def _operands(shape, dtype, a_pad, seed=0):
    """A (M, K) as a column slice of (M, K + a_pad) when a_pad, B (K, N);
    made from a seed with numpy."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k + a_pad)).astype(
        np.float32)).to(dtype)[:, :k]
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(dtype)
    return a, b


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_pad", [0, 3])
@pytest.mark.parametrize("shape", RAGGED)
def test_pad_operands_aligns_rows_and_keeps_the_product(shape, dtype, a_pad):
    """Every operand leaves the padding step TMA-ready (16-byte base, row
    stride a multiple of 8 elements, at least one column); exactly the
    operands that were not are copied; and the plain product of the padded
    operands equals the original's bit for bit (zero K columns add exact
    zeros)."""
    a, b = _operands(shape, dtype, a_pad)
    want_copied = tuple(name for name, t in (("A", a), ("B", b))
                        if not matmul.tma_ready(t))
    a2, b2, copied = matmul.pad_operands(a, b)
    assert copied == want_copied
    for t in (a2, b2):
        assert matmul.tma_ready(t)
        assert t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0
    assert a2.shape[0] == a.shape[0] and b2.shape[1] == b.shape[1]
    assert a2.shape[1] == b2.shape[0] == max(a.shape[1], 1)
    got, want = matmul.matmul_plain(a2, b2), matmul.matmul_plain(a, b)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def test_pad_operands_leaves_aligned_operands_in_place():
    a, b = _operands((64, 128, 72), torch.bfloat16, 0)
    a2, b2, copied = matmul.pad_operands(a, b)
    assert copied == () and a2 is a and b2 is b


def _within_exact(got, exact, share):
    """|got - exact| <= share (+ one bf16 ulp of the larger magnitude for a
    bf16 result), in float64 (``matmul.exact_limit``)."""
    return bool(((got.double() - exact).abs()
                 <= matmul.exact_limit(got, exact, share)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_limit_adds_one_bf16_ulp_to_a_bf16_result(dtype):
    """``matmul.exact_limit``: the share alone for a float32 result; plus
    one bf16 ulp of the larger magnitude (2^-7 at 1, 2^-6 at 2.5, none at
    0) for a bf16 one."""
    got = torch.tensor([1.0, 2.5, 0.0]).to(dtype)
    exact = torch.tensor([1.0, -1.0, 0.0], dtype=torch.float64)
    share = torch.full((3,), 1e-6)
    extra = [2.0 ** -7, 2.0 ** -6, 0.0] if dtype == torch.bfloat16 else [0.0] * 3
    lim = matmul.exact_limit(got, exact, share)
    assert lim.dtype == torch.float64
    assert torch.equal(lim, share.double()
                       + torch.tensor(extra, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 16, 16), (33, 257, 65),
                                   (8, 4096, 8), (70, 130, 96)])
def test_matmul_plain_within_its_exact_share(shape, dtype):
    """The plain version against the float64 product within
    ``plain_bound_exact``; the two shares add up to ``error_bound``."""
    a, b = _operands(shape, dtype, 0, seed=1)
    exact = torch.matmul(a.double(), b.double())
    assert _within_exact(matmul.matmul_plain(a, b), exact,
                         matmul.plain_bound_exact(a, b))
    assert torch.equal(matmul.error_bound_exact(a, b)
                       + matmul.plain_bound_exact(a, b),
                       matmul.error_bound(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 100, 4097, 1 << 20])
def test_dotp_plain_within_its_exact_share(n, dtype):
    """The plain dot product against the float64 one within
    ``plain_bound_exact``; the kernel's share plus the plain one is
    ``error_bound`` (c = 2 depth(n) + 1)."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    exact = (a.double() * b.double()).sum()
    assert _within_exact(dotp.dotp_plain(a, b), exact,
                         dotp.plain_bound_exact(a, b))
    total = dotp.error_bound_exact(a, b) + dotp.plain_bound_exact(a, b)
    assert torch.allclose(total, dotp.error_bound(a, b), rtol=1e-6, atol=0)
