"""SSD's backward on the CPU: the port's ``ops.ssd`` with a gradient (the
plain path of ``ops._SSD``: ``ssd_plain`` forward, ``ssd_bwd_plain``
backward) against ``jax.vjp`` of the reference's ``_chunked_ssd_ref`` on
the same numpy inputs, with B/C rows repeated to their heads inside the
differentiated function (the reference's broadcast, mamba2.py:120-125):

  * S a multiple of the chunk and S ragged, at chunk 16 and the kernel's 64;
  * B/C rows shared by r > 1 heads, one group and two;
  * a nonzero forward ``initial_state`` (no gradient taken for it).

Tolerance (f32): 1e-5 relative + 1e-6 of the gradient's largest element.
Both packages sum the same f32 terms in another order (the chunk products,
the reverse cumsum of d log_a over a chunk), so an element's error scales
with the largest terms of its sums, not with the element itself; the
largest differences read ~3e-7 of the largest element.

Also: a float64 ``torch.autograd.gradcheck`` of ``ops._SSD`` (the
formulas against finite differences), ``ssd_bwd_plain`` against autograd
through ``ssd_plain``'s own ops, the refusals (a gradient of the final or
initial state, CPU tensors handed to the kernel) and the kernel's slicing
of each B/C row's heads.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ssd, ssd_bwd  # noqa: E402

RTOL, ATOL_OF_MAX = 1e-5, 1e-6

CASES = {
    # name: (batch rows, groups a row, heads a group, S, P, N, chunk, init)
    "whole": (2, 1, 1, 48, 8, 6, 16, False),
    "ragged": (2, 1, 1, 37, 8, 6, 16, False),
    "chunk64_ragged": (1, 1, 2, 150, 8, 5, 64, False),
    "shared_r4": (2, 1, 4, 40, 8, 6, 16, False),
    "groups2": (2, 2, 3, 45, 4, 6, 16, False),
    "initial_state": (2, 1, 2, 37, 8, 6, 16, True),
    "initial_state_chunk64": (1, 2, 2, 70, 8, 4, 64, True),
}


def _inputs(case, seed=0):
    b, g, r, s, p, n, chunk, init = CASES[case]
    rng = np.random.default_rng(seed)
    bh, nb = b * g * r, b * g
    f = np.float32
    x = rng.standard_normal((bh, s, p)).astype(f)
    la = (-0.3 * np.abs(rng.standard_normal((bh, s)))).astype(f)
    B = rng.standard_normal((nb, s, n)).astype(f)
    C = rng.standard_normal((nb, s, n)).astype(f)
    dy = rng.standard_normal((bh, s, p)).astype(f)
    st = (0.5 * rng.standard_normal((bh, n, p))).astype(f) if init else None
    return x, la, B, C, dy, st, r, chunk


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_backward_matches_jax_vjp(case):
    x, la, B, C, dy, st, r, chunk = _inputs(case)
    jst = None if st is None else jnp.asarray(st)

    def jf(x, la, B, C):
        return jops._chunked_ssd_ref(
            x, la, jnp.repeat(B, r, axis=0), jnp.repeat(C, r, axis=0),
            chunk=chunk, initial_state=jst)[0]
    jy, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (x, la, B, C)))
    jgrads = vjp(jnp.asarray(dy))

    ts = [torch.from_numpy(a).requires_grad_() for a in (x, la, B, C)]
    ops.reset_launch_counts()
    ty, _ = ops.ssd(*ts, chunk=chunk,
                    initial_state=None if st is None
                    else torch.from_numpy(st))
    tgrads = torch.autograd.grad(ty, ts, torch.from_numpy(dy))
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL_OF_MAX
                               * np.abs(np.asarray(jy)).max())
    for name, t, j in zip(("dx", "dlog_a", "dB", "dC"), tgrads, jgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                                   atol=ATOL_OF_MAX * np.abs(j).max(),
                                   err_msg=name)


def test_ssd_bwd_plain_matches_autograd_of_the_forward():
    """The written-out formulas against autograd through ``ssd_plain``'s
    own ops (float64: the two differ only by summation order)."""
    x, la, B, C, dy, st, r, chunk = _inputs("initial_state", seed=3)
    ts = [torch.from_numpy(a).double().requires_grad_()
          for a in (x, la, B, C)]
    Be, Ce = (t.repeat_interleave(r, dim=0) for t in ts[2:])
    y, _ = ssd.ssd_plain(ts[0], ts[1], Be, Ce, chunk=chunk,
                         initial_state=torch.from_numpy(st).double())
    want = torch.autograd.grad(y, ts, torch.from_numpy(dy).double())
    got = ops._ssd_bwd_plain(*(t.detach() for t in ts),
                             torch.from_numpy(dy).double(), chunk=chunk,
                             initial_state=torch.from_numpy(st).double())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_gradcheck_float64(init):
    """``ops._SSD`` (plain path) against central finite differences in
    float64: ragged S over two chunks of 4, B/C shared by 2 heads."""
    gen = torch.Generator().manual_seed(5)

    def rn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)
    x = rn(4, 11, 3).requires_grad_()
    la = (-0.3 * rn(4, 11).abs()).requires_grad_()
    B, C = rn(2, 11, 2).requires_grad_(), rn(2, 11, 2).requires_grad_()
    st = rn(4, 2, 3) if init else None
    assert torch.autograd.gradcheck(
        lambda *a: ops.ssd(*a, chunk=4, initial_state=st)[0],
        (x, la, B, C), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_ssd_gradient_of_the_states_raises():
    """Training passes no initial state and drops the final one: a
    gradient that reaches either raises, it is not zeroed."""
    x = torch.randn(2, 9, 4, requires_grad=True)
    la = -torch.rand(2, 9)
    B, C = torch.randn(1, 9, 3), torch.randn(1, 9, 3)
    y, st = ops.ssd(x, la, B, C, chunk=4)
    with pytest.raises(NotImplementedError, match="final"):
        (y.sum() + st.sum()).backward()
    st0 = torch.randn(2, 3, 4, requires_grad=True)
    y, _ = ops.ssd(x.detach(), la, B, C, chunk=4, initial_state=st0)
    with pytest.raises(NotImplementedError, match="initial"):
        y.sum().backward()
    # y alone: the gradient flows to x and nowhere else
    y, _ = ops.ssd(x, la, B, C, chunk=4)
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_ssd_bwd_kernel_refuses_cpu_tensors():
    x = torch.randn(2, 9, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd.launch(x, -torch.rand(2, 9), torch.randn(1, 9, 3),
                       torch.randn(1, 9, 3), x)


@pytest.mark.parametrize("r,nb,s,want", [
    (80, 2, 2048, (16, 5)),     # mamba2-2.7b at batch 2 x 2048
    (50, 2, 2048, (10, 5)),     # hymba-1.5b at batch 2 x 2048
    (80, 1, 64, (1, 80)),       # one chunk: a slice a head
    (3, 2, 20, (1, 3)),
])
def test_ssd_bwd_slices(r, nb, s, want):
    """Each B/C row's heads cut into slices for the chunk kernel on 132
    SMs: every head in one slice, none empty."""
    hs, sl = ssd_bwd.slices(r, nb, s, 132)
    assert (hs, sl) == want
    assert hs * sl >= r and (sl - 1) * hs < r
