"""The port's cost model (``core/cost.py``), roofline (``core/roofline.py``)
and kernel work counts (each kernel module's ``cost()``) on the CPU.

Counterparts of ``tests/test_hlo_analysis.py``: a matmul's FLOPs and bytes
exact and equal to the reference's ``hlo_analysis.analyze`` of the same
``jnp.dot``; a Python loop of N matmuls counted N times (the reference's
scan trip count); a gather charged at the slice's size and an in-place
slice write at the update's; ``resident_bytes``; the peak live bytes of a
scripted sequence, exact; the wire formulas against the reference's
``CollectiveOp`` for every kind and group sizes 1-16; ``RooflineTerms``'
properties on the H100's constants.

The kernel table's bound column: each kernel module's ``cost()`` against
the formula ``chip_smoke.py`` wrote inline before it read ``cost()``, at
the table's shapes, integer for integer (so no printed MB, GFLOP or bound
moves), and at a few of the table's printed figures.

The reference's three byte-count claims (``tests/test_zero_copy.py``
:251-300) for the port's dense, ssm, hybrid and moe tiny configs: a chunk
step's copied bytes bounded by its chunk rows (and, for a recurrent
family, one slot's carry), unchanged when the arena's slots double with
its total bytes within 5%, and a decode step's copies far below the
arena.  All exact integer arithmetic: no tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import tiny_family_configs  # noqa: E402
from repro.core import hlo_analysis  # noqa: E402
from repro.core import roofline as jroofline  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import cost as C  # noqa: E402
from repro_torch.kernels.counting import counting_kernels  # noqa: E402
from repro_torch.core import roofline  # noqa: E402
from repro_torch.kernels import (conv2d, dotp, flash_attention,  # noqa: E402
                                 flash_attention_bwd, flash_decode,
                                 flash_prefill_chunk, matmul, pairs, ssd,
                                 ssd_bwd)
from repro_torch.models import convert, registry  # noqa: E402
from repro_torch.models.layers import PARKED_POS  # noqa: E402

from test_torch_model import port_cfg  # noqa: E402

META = torch.device("meta")


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _trace(fn, *args):
    """(fn(*args), the CostMode it ran under)."""
    with C.CostMode() as mode:
        out = fn(*args)
    return out, mode


# ---------------------------------------------------------------------------
# the op-by-op model
# ---------------------------------------------------------------------------

def test_matmul_flops_bytes_exact_and_equal_reference():
    m, k, n = 1024, 512, 1024
    _, mode = _trace(lambda a, b: a @ b, _m(m, k), _m(k, n))
    c = mode.cost
    assert c.dot_flops == c.flops == 2 * m * k * n
    assert c.bytes == (m * k + k * n + m * n) * 4
    ref = hlo_analysis.analyze(jax.jit(jnp.dot).lower(
        jax.ShapeDtypeStruct((m, k), jnp.float32),
        jax.ShapeDtypeStruct((k, n), jnp.float32)).compile().as_text())
    assert (c.dot_flops, c.bytes) == (ref.dot_flops, ref.bytes)


@pytest.mark.parametrize("n_layers", [1, 12])
def test_python_loop_counts_each_iteration(n_layers):
    """The reference multiplies a scan body by its trip count; a Python
    loop is traced once per iteration."""
    def f(x, w):
        for wl in w.unbind(0):
            x = torch.tanh(x @ wl)
        return x.sum()

    _, mode = _trace(f, _m(8, 64), _m(n_layers, 64, 64))
    assert mode.cost.dot_flops == n_layers * 2 * 8 * 64 * 64
    assert mode.cost.transcendentals == n_layers * 8 * 64


def test_gather_charged_at_slice_size():
    """An embedding lookup reads its rows, not the table."""
    v, d, b = 50000, 64, 16

    def f(table, idx):
        return table[idx].sum()

    _, mode = _trace(f, _m(v, d), torch.empty(b, dtype=torch.int64,
                                               device=META))
    by = mode.cost.bytes_by_op
    assert by["index"] == 2 * b * d * 4 + b * 8
    assert mode.cost.bytes < v * d * 4 * 0.5


def test_slice_write_charged_at_update_size():
    """A decode-style row append: each write charged at the row, read and
    written, never at the cache."""
    s, d, steps = 8192, 64, 16

    def f(cache, x):
        for t in range(steps):
            cache[t] = x[t]
        return cache

    _, mode = _trace(f, _m(s, d), _m(steps, d))
    assert C.copied_bytes(mode.cost) == steps * 2 * d * 4
    assert mode.cost.bytes < s * d * 4 * 4


def test_views_are_free():
    def f(x):
        return x.reshape(-1).view(64, 64).t()[3:].unsqueeze(0).expand(2, -1,
                                                                        -1)

    _, mode = _trace(f, _m(64, 64))
    assert mode.cost.bytes == 0 and mode.cost.flops == 0
    # a reshape that cannot be a view is a copy
    _, mode = _trace(lambda x: x.t().reshape(-1), _m(64, 64))
    assert mode.cost.bytes_by_op == {"clone": 2 * 64 * 64 * 4}


def test_elementwise_and_reduction_rules():
    def f(x):
        y = torch.exp(x)                # |result| flops, transcendental
        z = y * 2.0                     # |result| flops
        return z.sum(dim=0)             # |operand| flops

    _, mode = _trace(f, _m(32, 16))
    c = mode.cost
    assert c.flops == 3 * 32 * 16 and c.transcendentals == 32 * 16
    assert c.bytes == 4 * (2 * 512 + 2 * 512 + 512 + 16)


def test_convolution_charged_by_its_taps():
    """2 |result| x (taps x input channels a group), as the reference
    charges an HLO convolution."""
    import torch.nn.functional as F
    _, mode = _trace(lambda x, w: F.conv2d(x, w), _m(2, 3, 16, 16),
                      _m(8, 3, 5, 5))
    assert mode.cost.dot_flops == 2 * (2 * 8 * 12 * 12) * 3 * 5 * 5
    _, mode = _trace(lambda x, w: F.conv2d(x, w, groups=3),
                      _m(2, 6, 16, 16), _m(9, 2, 3, 3))
    assert mode.cost.dot_flops == 2 * (2 * 9 * 14 * 14) * 2 * 3 * 3


def test_ops_off_the_steps_device_are_not_charged():
    """Host bookkeeping beside a step on another device (the CPU copy of
    the CUDA RNG state a checkpoint restores) is not the step's work."""
    x = _m(64)
    with C.CostMode() as mode:
        mode.track([x])
        torch.zeros(16, dtype=torch.uint8).clone()
        y = x * 2.0
    assert mode.device == "meta"
    assert mode.cost.bytes_by_op == {"mul": 2 * 64 * 4}
    assert mode.peak_bytes == 2 * 64 * 4
    del y


def test_resident_bytes_sums_tree_leaves():
    tree = {"k": torch.zeros((2, 8, 4)), "v": torch.zeros((2, 8, 4),
                                                          dtype=torch.int8),
            "s": {"x": torch.zeros((2, 8))}}
    out = C.resident_bytes(tree)
    assert out["resident"] == 2 * 8 * 4 * 4 + 2 * 8 * 4 + 2 * 8 * 4
    meta = {"k": _m(2, 8, 4), "v": _m(2, 8, 4, dtype=torch.int8),
            "s": {"x": _m(2, 8)}}
    assert C.resident_bytes(meta)["resident"] == out["resident"]


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_peak_live_bytes_of_a_scripted_sequence(device):
    """Live bytes by storage, from the op that makes a tensor to its
    freeing; views share their base's storage."""
    a = torch.empty(1000, device=device)                  # 4000 bytes

    def f(a):
        b = a * 2.0                                       # 8000 live
        c = b + 1.0                                       # 12000
        v = c[10:]                                        # a view: 12000
        del b                                             # 8000
        d = torch.cat([c, c])                             # 16000
        del c, d                                          # 8000 (v keeps c)
        return v.sum()                                    # 8004, then v
        #                                                   goes: 4004

    with C.CostMode() as mode:
        mode.track([a])
        assert mode.live_bytes == 4000
        s = f(a)
        assert mode.live_bytes == 4004
    assert mode.peak_bytes == 16000
    del s
    assert mode.live_bytes == 4000
    assert C.resident_bytes([a])["resident"] == 4000


@pytest.mark.parametrize("kind", roofline.COLLECTIVE_KINDS)
def test_wire_formulas_equal_reference(kind):
    for group in range(1, 17):
        for b in (1, 100, 4096, 3 * 2 ** 20):
            got = roofline.CollectiveOp(kind, b, group).wire_bytes
            want = jroofline.CollectiveOp(kind, b, group).wire_bytes
            assert got == want, (kind, group, b, got, want)


def test_roofline_terms_math():
    t = roofline.RooflineTerms(
        flops_per_chip=roofline.PEAK_FLOPS * 0.5,      # 0.5 s of compute
        hbm_bytes_per_chip=roofline.HBM_BW * 0.25,     # 0.25 s of memory
        wire_bytes_per_chip=roofline.NVLINK_BW * 0.1,  # 0.1 s of wire
        collective_counts={},
        model_flops_per_chip=roofline.PEAK_FLOPS * 0.4,
        compute_s_per_chip=0.5)
    assert t.dominant == "compute"
    np.testing.assert_allclose(t.bound_s, 0.5)
    np.testing.assert_allclose(t.roofline_fraction, 0.8)
    np.testing.assert_allclose(t.useful_flops_ratio, 0.8)
    ref = jroofline.RooflineTerms(1.0, 1.0, 1.0, {}, 1.0)
    assert sorted(t.as_dict()) == sorted(ref.as_dict())
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.F32_PEAK_FLOPS) == (989e12, 3.35e12, 450e9, 67e12)


def test_derive_from_a_trace():
    _, mode = _trace(lambda a, b: a @ b, _m(256, 256), _m(256, 256))
    t = roofline.derive(mode.cost, model_flops_global=4 * 2 * 256 ** 3,
                        n_chips=4)
    assert t.flops_per_chip == 2 * 256 ** 3
    assert t.model_flops_per_chip == 2 * 256 ** 3
    assert t.wire_bytes_per_chip == 0 and t.collective_s == 0
    assert t.useful_flops_ratio == 1.0


@pytest.mark.parametrize("tf32", [False, True])
def test_compute_time_at_each_units_peak(tf32):
    """compute_s times each op's FLOPs at its units' peak: a bf16 matmul
    at the tensor cores' 989 TFLOP/s, an f32 one at the CUDA cores' 67
    (TF32's 494.5 where PyTorch allows it), an elementwise op at 67 in
    any type, a kernel at its ``KernelCost.flop_rate``."""
    n = 256
    mm = 2 * n ** 3
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with C.CostMode() as mode:
            _m(n, n, dtype=torch.bfloat16) @ _m(n, n, dtype=torch.bfloat16)
            _m(n, n) @ _m(n, n)
            _m(n, n, dtype=torch.bfloat16) + 1.0
            mode.charge_kernel(roofline.KernelCost("k", 1000, 0,
                                                   roofline.F32_PEAK_FLOPS))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    f32 = roofline.TF32_PEAK_FLOPS if tf32 else roofline.F32_PEAK_FLOPS
    want = (mm / roofline.PEAK_FLOPS + mm / f32
            + (n * n + 1000) / roofline.F32_PEAK_FLOPS)
    np.testing.assert_allclose(mode.cost.compute_s, want, rtol=1e-12)
    assert mode.cost.flops == 2 * mm + n * n + 1000
    t = roofline.derive(mode.cost)
    assert t.compute_s == mode.cost.compute_s > t.flops_per_chip / \
        roofline.PEAK_FLOPS


# ---------------------------------------------------------------------------
# each kernel's work: cost() against the formulas the kernel table used
# ---------------------------------------------------------------------------

def test_query_pairs_equal_the_mask():
    rng = np.random.default_rng(0)
    for _ in range(400):
        sk = int(rng.integers(1, 50))
        q0, nq = int(rng.integers(-10, 60)), int(rng.integers(0, 40))
        causal = bool(rng.integers(0, 2))
        window = [None, 1, 3, 16, 70][int(rng.integers(0, 5))]
        qp = torch.arange(q0, q0 + nq)[:, None]
        kp = torch.arange(sk)[None]
        mask = torch.ones((nq, sk), dtype=torch.bool)
        if causal:
            mask &= kp <= qp
        if window is not None:
            mask &= kp > qp - window
        assert pairs.query_pairs(q0, nq, sk, causal=causal,
                                 window=window) == int(mask.sum())


def _bf(*shape):
    return _m(*shape, dtype=torch.bfloat16)


def _window_pairs(s, window=None):
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _ssd_pairs(s, q=64):
    full, rem = divmod(s, q)
    return full * q * (q + 1) // 2 + rem * (rem + 1) // 2


def _decode_case(window):
    h, kvh, d, smax = (24, 8, 128, 1121) if window is None else \
        (25, 5, 64, 1633)
    lens = ([1088, 832, PARKED_POS + 1, 1] if window is None
            else [1600, 1264, PARKED_POS + 1, 1])
    q, k = _bf(4, h, d), _bf(4, smax, kvh, d)
    kpos = torch.arange(smax)[None]
    lt = torch.tensor(lens)[:, None]
    vis = kpos < lt
    if window is not None:
        vis &= kpos >= lt - window
    live = int(vis.sum())
    return (flash_decode.cost(q, k, torch.tensor(lens), window=window),
            2 * (2 * q.numel() + 2 * live * kvh * d), 4 * live * h * d)


def _chunk_case(c, p0, smax, h, kvh, d, window=None, esize=2, scale=0):
    q = _bf(1, c, h, d)
    k = _m(4, smax, kvh, d, dtype=torch.bfloat16 if esize == 2
           else torch.int8)
    qpos = p0 + torch.arange(c)[:, None]
    kpos = torch.arange(smax)[None]
    cmask = kpos <= qpos
    if window is not None:
        cmask &= kpos > qpos - window
    rows = int(cmask.any(0).sum())
    sc = _m(4, smax, kvh) if scale else None
    return (flash_prefill_chunk.cost(q, k, torch.tensor([p0]), window=window,
                                     k_scale=sc),
            2 * 2 * q.numel() + 2 * rows * kvh * (d * esize + scale),
            4 * int(cmask.sum()) * h * d)


def _kernel_cases():
    """(label, cost, the inline bytes, the inline FLOPs, the peak)."""
    out = []
    # flash_attention: llama S 1024, moe S 1024 G 1, llava 1600 G 7,
    # whisper's encoder (non-causal), hymba window 1024 at S 1536
    for s, h, kvh, d in ((1024, 24, 8, 128), (1024, 16, 16, 128),
                         (1600, 56, 8, 128)):
        q, k, v = _bf(1, h, s, d), _bf(1, kvh, s, d), _bf(1, kvh, s, d)
        out.append((f"fa S={s} H={h}", flash_attention.cost(q, k, v),
                    2 * (2 * s * h * d + 2 * s * kvh * d),
                    4 * h * d * s * (s + 1) // 2))
    q, k, v = _bf(1, 20, 1500, 64), _bf(1, 20, 1500, 64), _bf(1, 20, 1500, 64)
    out.append(("fa whisper", flash_attention.cost(q, k, v, causal=False),
                2 * (2 * 1500 * 20 * 64 + 2 * 1500 * 20 * 64),
                4 * 20 * 64 * 1500 * 1500))
    s, h, kvh, d, w = 1536, 25, 5, 64, 1024
    q, k, v = _bf(1, h, s, d), _bf(1, kvh, s, d), _bf(1, kvh, s, d)
    out.append(("fa hymba", flash_attention.cost(q, k, v, window=w),
                2 * (2 * s * h * d + 2 * s * kvh * d),
                4 * _window_pairs(s, w) * h * d))
    # training: forward with the LSE, backward (llama B 4 x 1024, hymba
    # B 2 x 2048 window 1024)
    for b, h, kvh, s, d, w in ((4, 24, 8, 1024, 128, None),
                               (2, 25, 5, 2048, 64, 1024)):
        q, k = _bf(b, h, s, d), _bf(b, kvh, s, d)
        lse = _m(b, h, s)
        fwd = 4 * b * h * d * _window_pairs(s, w)
        out.append((f"fa train w={w}",
                    flash_attention.cost(q, k, k, window=w, with_lse=True),
                    2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel(),
                    fwd))
        out.append((f"fab w={w}",
                    flash_attention_bwd.cost(q, k, k, q, lse, q, window=w),
                    2 * (3 * q.numel() + 2 * q.numel() + 4 * k.numel())
                    + 4 * lse.numel(), int(2.5 * fwd)))
    # flash_decode: llama, hymba's window, an int8 arena, the donor table,
    # whisper's cross rows (lengths=None)
    for w in (None, 1024):
        work, nb, fl = _decode_case(w)
        out.append((f"fd w={w}", work, nb, fl))
    lens = torch.tensor([1088, 832, PARKED_POS + 1, 1])
    q, k = _bf(4, 24, 128), _m(4, 1121, 8, 128, dtype=torch.int8)
    live = 1088 + 832 + 1121 + 1
    out.append(("fd int8", flash_decode.cost(q, k, lens, k_scale=_m(
        4, 1121, 8)), 2 * 2 * q.numel() + 2 * live * 8 * (128 + 4),
        4 * live * 24 * 128))
    lens = torch.tensor([1088, 1060, 832, 1024])
    tab = dict(share_src=torch.tensor([0, 0, 0, 0]),
               share_len=torch.tensor([0, 528, 528, 528]))
    read = 1088 + (1060 - 528) + (832 - 528) + (1024 - 528)
    kb = _bf(4, 1121, 8, 128)
    out.append(("fd donor", flash_decode.cost(q, kb, lens, **tab),
                2 * 2 * q.numel() + 2 * read * 8 * 128 * 2,
                4 * int(lens.sum()) * 24 * 128))
    q, k = _bf(4, 20, 64), _bf(4, 1500, 20, 64)
    out.append(("fd whisper", flash_decode.cost(q, k),
                2 * (2 * q.numel() + 2 * 4 * 1500 * 20 * 64),
                4 * 4 * 1500 * 20 * 64))
    # flash_prefill_chunk: llama C 512 at 512, the verify shape, hymba's
    # window, an int8 arena
    for label, args in (("fpc", (512, 512, 1121, 24, 8, 128)),
                        ("fpc verify", (4, 1088, 1121, 24, 8, 128)),
                        ("fpc moe", (512, 512, 1121, 16, 16, 128)),
                        ("fpc hymba", (512, 1024, 1633, 25, 5, 64, 1024)),
                        ("fpc int8", (512, 512, 1121, 24, 8, 128, None, 1,
                                      4))):
        work, nb, fl = _chunk_case(*args)
        out.append((label, work, nb, fl))
    # ssd: mamba2's serving shape (80 heads, one B/C group, S 1024, with an
    # S not a multiple of 64), its training shape and hymba's
    for bh, nb_, s, p, n in ((80, 1, 1024, 64, 128), (80, 1, 1000, 64, 128),
                             (50, 1, 1536, 64, 16), (160, 2, 2048, 64, 128),
                             (100, 2, 2048, 64, 16)):
        x = _bf(bh, s, p)
        la, B = _m(bh, s), _bf(nb_, s, n)
        pr = _ssd_pairs(s)
        out.append((f"ssd {bh}x{s}", ssd.cost(x, la, B, B),
                    2 * 2 * bh * s * p + 4 * bh * s + 2 * 2 * nb_ * s * n
                    + 4 * bh * n * p,
                    bh * (2 * pr * (n + p) + 2 * 2 * s * n * p)))
        out.append((f"ssd_bwd {bh}x{s}", ssd_bwd.cost(x, la, B, B, x),
                    2 * (3 * bh * s * p + 4 * nb_ * s * n) + 2 * 4 * bh * s,
                    bh * (5 * 2 * s * n * p + 2 * pr * (2 * p + 2 * n))
                    + nb_ * 2 * pr * n))
    # the vector-unit kernels, f32 and bf16
    for dt in (torch.float32, torch.bfloat16):
        es = 4 if dt == torch.float32 else 2
        peak = 67e12 if dt == torch.float32 else 989e12
        a = _m(4096, 4096, dtype=dt)
        out.append((f"matmul {dt}", matmul.cost(a, a), 3 * 4096 ** 2 * es,
                    2 * 4096 ** 3, peak))
        v = _m(1 << 26, dtype=dt)
        out.append((f"dotp {dt}", dotp.cost(v, v), 2 * (1 << 26) * es + 4,
                    2 * (1 << 26), peak))
        for n, cout in ((64, 64), (1, 8)):
            x, w = _m(n, 112, 112, 3, dtype=dt), _m(7, 7, 3, cout, dtype=dt)
            out.append((f"conv2d {dt} {n}", conv2d.cost(x, w),
                        es * (x.numel() + w.numel() + n * 106 * 106 * cout),
                        2 * n * 106 * 106 * cout * 7 * 7 * 3, peak))
    return [c if len(c) == 5 else (*c, 989e12) for c in out]


CASES = _kernel_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_cost_equals_the_table_formula(case):
    _, work, nbytes, flops, peak = case
    assert (work.bytes, work.flops, work.flop_rate) == (nbytes, flops, peak)
    t_bytes, t_ops = nbytes / 3.35e12, flops / peak
    assert work.bound_s == max(t_bytes, t_ops)
    assert work.bound_by == ("bytes" if t_bytes >= t_ops else "operations")


@pytest.mark.parametrize("label, want", [
    ("fd w=None", (12.51e6, 0.0037)), ("fab w=None", (64.487e9, 0.0652)),
    ("fd donor", (9.96e6, 0.0030)), ("ssd 80x1024", (24.44e6, 0.0073)),
    ("ssd_bwd 160x2048", (132.64e6, 0.0396)),
    ("conv2d torch.float32 64", (13.531e9, 0.2020)),
    ("matmul torch.bfloat16", (137.439e9, 0.1390))])
def test_kernel_cost_reads_the_printed_table(label, want):
    """A few of PERF.md's kernel-table figures (MB or GFLOP, bound ms),
    as the smoke prints them."""
    work = next(c[1] for c in CASES if c[0] == label)
    figure, bound_ms = want
    got = work.bytes if figure < 1e9 else work.flops
    digits = 2 if figure < 1e9 else 3
    scale = 1e6 if figure < 1e9 else 1e9
    assert round(got / scale, digits) == pytest.approx(figure / scale)
    assert round(work.bound_s * 1e3, 4) == pytest.approx(bound_ms)


# ---------------------------------------------------------------------------
# the reference's byte-count claims on the port (test_zero_copy.py:251-300)
# ---------------------------------------------------------------------------

TINY = ArchConfig(name="tiny-zc", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab=97, head_dim=8,
                  param_dtype="float32", act_dtype="float32", max_seq=64)
SLOTS, SEQ, CHUNK = 3, 48, 8


def _family_cfg(family):
    return TINY if family == "dense" else port_cfg(
        tiny_family_configs()[family])


def _arena_bytes(cache):
    return sum(t.numel() * t.element_size() for t in cache.values())


def _chunk_cost(cfg, slots):
    model = registry.build_model(cfg, device="meta",
                                 kernels=counting_kernels())
    params = convert.abstract_params(cfg)
    cache = model.init_cache(slots, SEQ)
    toks = torch.zeros((1, CHUNK), dtype=torch.int64, device=META)
    with torch.no_grad(), C.CostMode() as mode:
        model.prefill_chunk(params, toks, cache, 0, 8, CHUNK - 1)
    return mode.cost, cache


def _carry_bytes(cfg, cache, slots):
    """One slot's recurrent state (its arena leaves with no sequence
    axis) and its K/V chunk rows."""
    model = registry.build_model(cfg, device="meta")
    axes = model.seq_axes()
    state = sum(t.numel() * t.element_size() for key, t in cache.items()
                if axes[key] < 0) // slots
    kv = 2 * cfg.n_layers * CHUNK * cfg.n_kv_heads * cfg.hd * 4 \
        if "k" in cache else 0
    return kv + state


FAMILIES = ("dense", "ssm", "hybrid", "moe")


@pytest.mark.parametrize("family", FAMILIES)
def test_chunk_copied_bytes_bounded_by_chunk_rows(family):
    """The chunk step's write traffic is O(chunk rows + one slot's carry):
    2x for the read+write charge, 2x headroom for small copies; a family
    without recurrent state stays below one slot's rows."""
    cfg = _family_cfg(family)
    cost, cache = _chunk_cost(cfg, SLOTS)
    rows = _carry_bytes(cfg, cache, SLOTS)
    copied = C.copied_bytes(cost)
    assert copied <= 4 * rows + 4096, (copied, rows)
    if family in ("dense", "moe"):
        assert copied < _arena_bytes(cache) / SLOTS


@pytest.mark.parametrize("family", FAMILIES)
def test_chunk_bytes_independent_of_arena_width(family):
    cfg = _family_cfg(family)
    c1, _ = _chunk_cost(cfg, SLOTS)
    c2, _ = _chunk_cost(cfg, 2 * SLOTS)
    assert C.copied_bytes(c2) == C.copied_bytes(c1), \
        f"{family}: chunk copied bytes scale with arena width"
    assert c2.bytes <= c1.bytes * 1.05, (c2.bytes, c1.bytes)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_step_copies_far_below_arena(family):
    """The decode step writes its rows (dense, moe) or each slot's new
    state (ssm, hybrid) in place: its copies stay far below the arena."""
    cfg = _family_cfg(family)
    model = registry.build_model(cfg, device="meta",
                                 kernels=counting_kernels())
    params = convert.abstract_params(cfg)
    cache = model.init_cache(SLOTS, SEQ)
    with torch.no_grad(), C.CostMode() as mode:
        model.decode_step(params,
                          torch.zeros(SLOTS, dtype=torch.int64, device=META),
                          cache, torch.full((SLOTS,), 4, device=META))
    arena = _arena_bytes(cache)
    assert C.copied_bytes(mode.cost) < 0.5 * arena, \
        (dict(mode.cost.bytes_by_op), arena)


def test_counting_bundle_leaves_the_default_path_alone():
    """A model built with the default kernels runs as before: ``ops`` on
    meta tensors raises (a kernel cannot run there), and a CPU model's
    logits are the same with and without the counting bundle."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(TINY, n_layers=1)
    q = _m(1, 4, 8, 8)
    with pytest.raises(ValueError, match="unsupported"):
        ops.attention(q, q, q)
    plain = registry.build_model(cfg, device="cpu")
    counted = registry.build_model(cfg, device="cpu",
                                   kernels=counting_kernels())
    params = plain.init(0)
    toks = torch.arange(6, dtype=torch.int64)[None] % cfg.vocab
    with torch.no_grad():
        want = plain.prefill(params, toks, plain.init_cache(1, 8))
        with C.CostMode() as mode:
            got = counted.prefill(params, toks, counted.init_cache(1, 8))
    assert torch.equal(got, want)
    assert mode.kernels == {"flash_attention": 1}
