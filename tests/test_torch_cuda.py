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
@pytest.mark.parametrize("d,window", [(16, None), (16, 8), (8, 8),
                                      (32, 8), (64, None), (128, None)])
def test_cuda_kernels_match_plain(cuda, dtype, d, window):
    """All three attention kernels against their plain versions: ragged
    lengths and a parked slot, chunk prefixes 0 and 9, a sliding window;
    head dims 8 and 16 (bf16: zero-padded to the MMA's depth 16) and 128
    (two swizzled boxes a row); flash_attention with Sq = Sk = 33 and with
    Sq = 50 < Sk = 130 (Sk not a multiple of the 64-key strip)."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rn(3, 6, d), rn(3, 40, 2, d), rn(3, 40, 2, d)
    lens = torch.tensor([1, 17, PARKED], device=cuda)
    got = ops.flash_decode(q, k, v, lengths=lens, window=window)
    want = ops.PLAIN.flash_decode(q, k, v, lengths=lens, window=window)
    assert got.dtype == dtype and _within_limit(got, want)
    qc = rn(2, 8, 6, d)
    pre = torch.tensor([0, 9], device=cuda)
    got = ops.flash_prefill_chunk(qc, k[:2], v[:2], prefix=pre,
                                  window=window)
    want = ops.PLAIN.flash_prefill_chunk(qc, k[:2], v[:2], prefix=pre,
                                         window=window)
    assert got.dtype == dtype and _within_limit(got, want)
    for sq, sk in ((33, 33), (50, 130)):
        qa, ka, va = rn(2, 6, sq, d), rn(2, 2, sk, d), rn(2, 2, sk, d)
        for causal in (True, False):
            got = ops.attention(qa, ka, va, causal=causal, window=window)
            want = ops.PLAIN.attention(qa, ka, va, causal=causal,
                                       window=window)
            assert got.dtype == dtype and _within_limit(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,c", [(torch.float32, 16, 16),
                                       (torch.bfloat16, 16, 16),
                                       (torch.bfloat16, 128, 16),
                                       (torch.bfloat16, 128, 40)])
def test_cuda_chunk_rows_bit_equal_decode(cuda, dtype, d, c):
    """Chunk row j == flash_decode at pos = prefix + j, bit for bit: S = 300
    arena rows (ragged against the 64-key strips), G = 3 query heads a KV
    head, so a 64-row bf16 tile crosses heads (C = 16: one tile of 48 rows;
    C = 40: two tiles of 120 rows)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    s, kvh, h = 300, 2, 6
    q = torch.randn((1, c, h, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((1, s, kvh, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, s, kvh, d), generator=gen, device=cuda).to(dtype)
    pre = 200
    chunk = ops.flash_prefill_chunk(q, k, v, prefix=torch.tensor([pre],
                                                                 device=cuda))
    dec = ops.flash_decode(q[0], k.expand(c, s, kvh, d),
                           v.expand(c, s, kvh, d),
                           lengths=pre + 1 + torch.arange(c, device=cuda))
    assert torch.equal(chunk[0], dec)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,window", [(16, 6, 8), (64, 10, 8),
                                        (64, 10, 77), (64, 10, 200)])
def test_cuda_chunk_rows_bit_equal_decode_under_window(cuda, dtype, d, h,
                                                       window):
    """The chunk/decode bit pin under a sliding window: C = 40 rows at
    prefix 300 of 400 arena rows, 2 KV heads (G = 3, or hymba's G = 5 at
    hd 64, so 64-row bf16 tiles cross heads).  Window 8; 77, whose edge
    (keys 224-263 for the chunk's rows) falls inside a 64-key strip; 200,
    whose edge (keys 101-140) crosses the first 128-key split boundary:
    the chunk's tile walks strips wholly before a row's window, which must
    leave the row as skipping them does."""
    gen = torch.Generator(device=cuda).manual_seed(window)
    s, kvh, c, pre = 400, 2, 40, 300
    q = torch.randn((1, c, h, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((1, s, kvh, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, s, kvh, d), generator=gen, device=cuda).to(dtype)
    chunk = ops.flash_prefill_chunk(
        q, k, v, prefix=torch.tensor([pre], device=cuda), window=window)
    dec = ops.flash_decode(q[0], k.expand(c, s, kvh, d),
                           v.expand(c, s, kvh, d),
                           lengths=pre + 1 + torch.arange(c, device=cuda),
                           window=window)
    assert torch.equal(chunk[0], dec)
    want = ops.PLAIN.flash_prefill_chunk(
        q, k, v, prefix=torch.tensor([pre], device=cuda), window=window)
    assert _within_limit(chunk, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [8, 64, 100, 1024])
def test_cuda_decode_splits_before_the_window(cuda, dtype, window):
    """flash_decode over 1633 rows (13 splits of 128 keys) at hymba's head
    shape (hd 64, G = 5) with rows whose every split but the last lies
    wholly before the window (length 1633, 1600), one whose window reaches
    key 0 (length 129 at window 1024), a parked slot and a length-1 row:
    within the limit of the plain version, bits repeated, the arrival
    counters back at 0."""
    from repro_torch.kernels import flash_decode
    gen = torch.Generator(device=cuda).manual_seed(window)
    s, kvh, h, d = 1633, 5, 25, 64
    q = torch.randn((5, h, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((5, s, kvh, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((5, s, kvh, d), generator=gen, device=cuda).to(dtype)
    lens = torch.tensor([1633, 1600, 129, PARKED, 1], device=cuda)
    got = ops.flash_decode(q, k, v, lengths=lens, window=window)
    want = ops.PLAIN.flash_decode(q, k, v, lengths=lens, window=window)
    assert _within_limit(got, want)
    again = ops.flash_decode(q, k, v, lengths=lens, window=window)
    assert torch.equal(got, again)
    torch.cuda.synchronize()
    rows = 5 * kvh
    assert int(flash_decode.counters(q.device, rows)[:rows].abs().sum()) == 0


# (q dtype, arena format) of the scaled-branch tests: f32 q over a bf16,
# int8 or fp8 arena (the CUDA-core tile), bf16 q over int8 or fp8 (the
# tensor-core tile; a bf16 arena under bf16 q is the unscaled path above)
NARROW_CASES = [(torch.float32, "bf16"), (torch.float32, "int8"),
                (torch.float32, "fp8"), (torch.bfloat16, "int8"),
                (torch.bfloat16, "fp8")]


def _narrow_arena(gen, fmt_name, shape, device):
    """(k, v, k_scale, v_scale) of a random f32 arena stored in format
    ``fmt_name`` (scales None for an unscaled format)."""
    from repro_torch.core import kv_format as kvf
    fmt = kvf.get(fmt_name)
    k = torch.randn(shape, generator=gen, device=device)
    v = torch.randn(shape, generator=gen, device=device)
    (kq, ks), (vq, vs) = kvf.quantize(fmt, k), kvf.quantize(fmt, v)
    return kq, vq, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fmt", NARROW_CASES)
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("window", [None, 8])
def test_cuda_narrow_arena_kernels_match_plain(cuda, dtype, fmt, d, window):
    """flash_decode and flash_prefill_chunk over a narrow arena (the scaled
    branch for int8 / fp8) against their plain versions, within the dtype's
    limit: lengths 1 / 17 / parked / 130 over 130 rows (three 64-key
    strips, two splits), chunk prefixes 0, 9 and 100.  The kernels scale
    the scores and P where the plain versions scale K and V: they differ
    by f32 rounding only."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((4, 6, d), generator=gen, device=cuda).to(dtype)
    k, v, ks, vs = _narrow_arena(gen, fmt, (4, 130, 2, d), cuda)
    lens = torch.tensor([1, 17, PARKED, 130], device=cuda)
    kw = dict(lengths=lens, window=window, k_scale=ks, v_scale=vs)
    got = ops.flash_decode(q, k, v, **kw)
    want = ops.PLAIN.flash_decode(q, k, v, **kw)
    assert got.dtype == dtype and _within_limit(got, want)
    qc = torch.randn((3, 8, 6, d), generator=gen, device=cuda).to(dtype)
    sc = {} if ks is None else dict(k_scale=ks[:3], v_scale=vs[:3])
    pre = torch.tensor([0, 9, 100], device=cuda)
    got = ops.flash_prefill_chunk(qc, k[:3], v[:3], prefix=pre,
                                  window=window, **sc)
    want = ops.PLAIN.flash_prefill_chunk(qc, k[:3], v[:3], prefix=pre,
                                         window=window, **sc)
    assert got.dtype == dtype and _within_limit(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fmt", NARROW_CASES)
@pytest.mark.parametrize("d,c", [(16, 16), (128, 16), (128, 40)])
def test_cuda_narrow_chunk_rows_bit_equal_decode(cuda, dtype, fmt, d, c):
    """The chunk/decode bit pin per format: chunk row j == flash_decode at
    pos = prefix + j over the same narrow arena and scales, bit for bit
    (S = 300, G = 3, a 64-row tile crossing heads)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    s, kvh, h = 300, 2, 6
    q = torch.randn((1, c, h, d), generator=gen, device=cuda).to(dtype)
    k, v, ks, vs = _narrow_arena(gen, fmt, (1, s, kvh, d), cuda)
    pre = 200
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    chunk = ops.flash_prefill_chunk(
        q, k, v, prefix=torch.tensor([pre], device=cuda), **sc)
    ex = {key: t.expand(c, *t.shape[1:]) for key, t in sc.items()}
    dec = ops.flash_decode(q[0], k.expand(c, s, kvh, d),
                           v.expand(c, s, kvh, d),
                           lengths=pre + 1 + torch.arange(c, device=cuda),
                           **ex)
    assert torch.equal(chunk[0], dec)


# (q dtype, arena format) of the slot-table tests: "fp32" stores at q's
# dtype (the unscaled tiles), the rest as NARROW_CASES
SLOT_CASES = [(torch.float32, "fp32"), (torch.bfloat16, "fp32")] + \
    NARROW_CASES


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fmt", SLOT_CASES)
@pytest.mark.parametrize("d", [16, 128])
def test_cuda_slot_table_equals_slot_view(cuda, dtype, fmt, d):
    """flash_prefill_chunk over a 4-slot arena with a slot table (the
    captured chunk step's form) equals the kernel over the slot's own view
    bit for bit, one batch a slot and two batches on slots 3 and 1 (S = 300,
    G = 3, prefixes 200 and 9), and its plain version within the limit; a
    table pointing at the neighbour slot gives other values."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, s, kvh, h, c = 4, 300, 2, 6, 40
    if fmt == "fp32":
        k, v = (torch.randn((n, s, kvh, d), generator=gen,
                            device=cuda).to(dtype) for _ in range(2))
        ks = vs = None
    else:
        k, v, ks, vs = _narrow_arena(gen, fmt, (n, s, kvh, d), cuda)
    q = torch.randn((2, c, h, d), generator=gen, device=cuda).to(dtype)
    pre = torch.tensor([200, 9], device=cuda)

    def rows(t, idx):
        return None if t is None else t[idx]

    sc = dict(k_scale=ks, v_scale=vs)
    for slot in range(n):
        slots, own = torch.tensor([slot], device=cuda), slice(slot, slot + 1)
        view = ops.flash_prefill_chunk(q[:1], k[own], v[own], prefix=pre[:1],
                                       k_scale=rows(ks, own),
                                       v_scale=rows(vs, own))
        got = ops.flash_prefill_chunk(q[:1], k, v, prefix=pre[:1],
                                      slots=slots, **sc)
        assert torch.equal(got, view), slot
        plain = ops.PLAIN.flash_prefill_chunk(q[:1], k, v, prefix=pre[:1],
                                              slots=slots, **sc)
        assert _within_limit(got, plain), slot
        wrong = ops.flash_prefill_chunk(q[:1], k, v, prefix=pre[:1],
                                        slots=(slots + 1) % n, **sc)
        assert not torch.equal(wrong, view), slot
    pick = torch.tensor([3, 1], device=cuda)
    got = ops.flash_prefill_chunk(q, k, v, prefix=pre, slots=pick,
                                  k_scale=ks, v_scale=vs)
    view = ops.flash_prefill_chunk(q, k[pick], v[pick], prefix=pre,
                                   k_scale=rows(ks, pick),
                                   v_scale=rows(vs, pick))
    assert torch.equal(got, view)


@pytest.mark.gpu
def test_cuda_slot_table_refuses_a_copied_arena(cuda):
    """With a slot table the arena is read in place: an int8 arena of
    8-byte rows under bf16 q (which the kernel reads only through a padded
    copy) raises rather than copying every slot; without a table it takes
    the copy as before."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    k, v, ks, vs = _narrow_arena(gen, "int8", (3, 64, 2, 8), cuda)
    q = torch.randn((1, 8, 4, 8), generator=gen,
                    device=cuda).to(torch.bfloat16)
    pre = torch.tensor([9], device=cuda)
    with pytest.raises(ValueError, match="in place"):
        ops.flash_prefill_chunk(q, k, v, prefix=pre, k_scale=ks, v_scale=vs,
                                slots=torch.tensor([1], device=cuda))
    out = ops.flash_prefill_chunk(q, k[1:2], v[1:2], prefix=pre,
                                  k_scale=ks[1:2], v_scale=vs[1:2])
    assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_cuda_scaled_kernels_count_and_repeat(cuda, fmt):
    """A scaled call adds one to its kernel's launches and one to its
    ``_scaled`` count; an unscaled call only to the first; repeated calls
    give the same bits; a planted fault (V scaled by K's scales) leaves the
    limit."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((4, 24, 128), generator=gen, device=cuda).bfloat16()
    k, v, ks, vs = _narrow_arena(gen, fmt, (4, 1121, 8, 128), cuda)
    lens = torch.tensor([1088, 832, PARKED, 1], device=cuda)
    ops.reset_launch_counts()
    a = ops.flash_decode(q, k, v, lengths=lens, k_scale=ks, v_scale=vs)
    b = ops.flash_decode(q, k, v, lengths=lens, k_scale=ks, v_scale=vs)
    ops.flash_decode(q, k.float().bfloat16(), v.float().bfloat16(),
                     lengths=lens)
    counts = ops.launch_counts()
    assert counts["flash_decode"] == 3 and counts["flash_decode_scaled"] == 2
    assert torch.equal(a, b)
    rows = 4 * 8
    assert int(fd.counters(q.device, rows)[:rows].abs().sum()) == 0
    want = ops.PLAIN.flash_decode(q, k, v, lengths=lens, k_scale=ks,
                                  v_scale=vs)
    fault = ops.PLAIN.flash_decode(q, k, v, lengths=lens, k_scale=ks,
                                   v_scale=ks)
    assert _within_limit(a, want) and not _within_limit(a, fault)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_cuda_narrow_engine_captured_equals_eager(cuda, dtype, fmt, chunks):
    """The reduced llama3.2-3b served with a narrow arena: the captured
    decode step gives the eager engine's streams; a scaled format's
    flash_decode launches are all scaled (n_layers x (replays + the
    warm-up step)), and so are its chunks' flash_prefill_chunk launches."""
    model, params = _tiny("dense", dtype)
    want = _graph_engine(model, params, decode_graph=False, kv_format=fmt,
                         prefill_chunks=chunks).run()
    ops.reset_launch_counts()
    eng = _graph_engine(model, params, kv_format=fmt, prefill_chunks=chunks)
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    nl, replays = model.cfg.n_layers, eng.graph.replays
    assert counts["flash_decode"] == nl * (replays + 1), counts
    scaled = fmt != "bf16"
    assert counts["flash_decode_scaled"] == (counts["flash_decode"]
                                             if scaled else 0)
    assert counts["flash_prefill_chunk_scaled"] == (
        counts["flash_prefill_chunk"] if scaled else 0)
    if chunks:
        # every chunk replayed, plus each chunk graph's parked warm-up
        assert counts["flash_prefill_chunk"] == nl * (
            eng.stats["prefill_chunks"] + len(eng.chunk_graphs)) > 0
    assert eng.cache_mgr.scale_sidecar_pages == 0


@pytest.mark.gpu
def test_cuda_bf16_views_not_16_byte_aligned(cuda):
    """bf16 operands whose base or strides are not 16-byte aligned (the
    tensor-core kernels' TMA maps and Q loads need it) are copied, not
    refused, and give the plain versions' result."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device=cuda).to(torch.bfloat16)

    q, k, v = rn(2, 6, 17)[..., 1:], rn(2, 40, 2, 17)[..., 1:], \
        rn(2, 40, 2, 16)
    lens = torch.tensor([5, 40], device=cuda)
    assert _within_limit(ops.flash_decode(q, k, v, lengths=lens),
                         ops.PLAIN.flash_decode(q, k, v, lengths=lens))
    qc, pre = rn(2, 8, 6, 17)[..., 1:], torch.tensor([0, 9], device=cuda)
    assert _within_limit(ops.flash_prefill_chunk(qc, k, v, prefix=pre),
                         ops.PLAIN.flash_prefill_chunk(qc, k, v,
                                                       prefix=pre))
    qa, ka = rn(1, 6, 33, 17)[..., 1:], rn(1, 2, 33, 17)[..., 1:]
    va = rn(1, 2, 33, 16)
    assert _within_limit(ops.attention(qa, ka, va),
                         ops.PLAIN.attention(qa, ka, va))


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [6, 80, 160])
@pytest.mark.parametrize("s", [1, 64, 65, 1000])
def test_cuda_ssd_pieces_match_plain_and_repeat(cuda, dtype, bh, s):
    """mamba2-2.7b's head width (P 64, N 128), two B/C groups: 6 rows cut
    into one piece a chunk, 80 rows into 3 pieces of several chunks, 160
    rows into one piece; S below one chunk, at one, just past one, and
    ragged across pieces.  Within the limit, and y and the state repeat bit
    for bit on a second call."""
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=cuda).manual_seed(8)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    p, n = 64, 128
    x = (rn(s, bh, p) * 0.05).to(dtype).transpose(0, 1)
    la = -torch.rand((bh, s), generator=gen, device=cuda) * 0.1
    B, C = rn(2, s, n).to(dtype), rn(2, s, n).to(dtype)
    st = rn(bh, n, p) * 0.1
    for init in (None, st):
        before = ssd.launches
        got = ops.ssd(x, la, B, C, chunk=256, initial_state=init)
        assert ssd.launches == before + 1
        want = ops.PLAIN.ssd(x, la, B, C, chunk=256, initial_state=init)
        assert _ssd_within_limit(got[0], want[0])
        assert _ssd_within_limit(got[1], want[1])
        again = ssd.launch(x, la, B, C, initial_state=init)
        for a, b in zip(got, again):
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))


@pytest.mark.gpu
def test_cuda_ssd_bf16_unaligned_rows(cuda):
    """bf16 x / B / C whose rows are not 16-byte aligned (headdim 12,
    d_state 20, x offset by one element) are copied to aligned rows by the
    wrapper; the result is within the limit."""
    gen = torch.Generator(device=cuda).manual_seed(10)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    bh, s, p, n = 6, 150, 12, 20
    x = rn(bh, s, p + 1).bfloat16()[..., 1:]
    la = -torch.rand((bh, s), generator=gen, device=cuda) * 0.1
    B, C = rn(3, s, n).bfloat16(), rn(3, s, n).bfloat16()
    st = rn(bh, n, p)
    got = ops.ssd(x, la, B, C, chunk=256, initial_state=st)
    want = ops.PLAIN.ssd(x, la, B, C, chunk=256, initial_state=st)
    assert _ssd_within_limit(got[0], want[0])
    assert _ssd_within_limit(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 65, 1536])
def test_cuda_ssd_hymba_shape_matches_plain_and_repeats(cuda, s):
    """hymba-1.5b's SSD branch: 50 rows, P 64, N 16 (one 16-wide k-step;
    the warps of d_state half 1 hold zero-filled columns), one B/C group,
    bf16, with and without an initial state: within the limit, y and the
    state repeated bit for bit on a second call."""
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=cuda).manual_seed(s)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    bh, p, n = 50, 64, 16
    x = (rn(s, bh, p) * 0.05).bfloat16().transpose(0, 1)
    la = -torch.rand((bh, s), generator=gen, device=cuda) * 0.1
    B, C = rn(1, s, n).bfloat16(), rn(1, s, n).bfloat16()
    st = rn(bh, n, p) * 0.1
    for init in (None, st):
        got = ops.ssd(x, la, B, C, chunk=256, initial_state=init)
        want = ops.PLAIN.ssd(x, la, B, C, chunk=256, initial_state=init)
        assert _ssd_within_limit(got[0], want[0])
        assert _ssd_within_limit(got[1], want[1])
        again = ssd.launch(x, la, B, C, initial_state=init)
        for a, b in zip(got, again):
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))


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
@pytest.mark.parametrize("shape", [(64, 5, 64), (130, 50, 70),
                                   (1, 300, 129), (200, 16, 6)])
@pytest.mark.parametrize("b_stride", [0, 1])
def test_cuda_matmul_edges_repeat(cuda, dtype, shape, b_stride):
    """K shorter than one 16-deep stage, K not a multiple of it, M = 1, N
    not a multiple of 4; B contiguous or a column slice (row stride N + 1:
    4-byte copies in place of 16-byte ones).  Within the limit, and the
    same bits on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    m, k, n = shape
    a = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    b = torch.randn((k, n + b_stride), generator=gen,
                    device=cuda).to(dtype)[:, :n]
    from repro_torch.kernels import matmul
    got = ops.matmul(a, b)
    assert got.shape == (m, n) and got.dtype == dtype
    assert _reassoc_within_limit(got, ops.PLAIN.matmul(a, b),
                                 matmul.error_bound(a, b))
    again = matmul.launch(a.clone(), b.clone())
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))


def _exact_within_limit(got, exact, share):
    """Against the float64 product: the module's ``error_bound_exact``
    share, plus one bf16 ulp of the larger magnitude for a bf16 output
    (``matmul.exact_limit``)."""
    from repro_torch.kernels.matmul import exact_limit
    return bool(((got.double() - exact).abs()
                 <= exact_limit(got, exact, share)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 512, 4096), (1, 1, 1),
                                   (63, 65, 129), (65, 129, 255),
                                   (129, 255, 63), (255, 63, 65),
                                   (129, 64, 257)])
def test_cuda_matmul_bf16_tiles_exact_and_repeat(cuda, shape):
    """The tensor-core kernel where M, N and K cross the 128 x 256 tile and
    the 64-deep stage (and 4096 x 512 x 4096): within ``error_bound`` of the
    plain version, within ``error_bound_exact`` of the float64 product, the
    same bits on a second call; operands whose rows are not 16-byte
    aligned take the padding step."""
    from repro_torch.kernels import matmul
    gen = torch.Generator(device=cuda).manual_seed(11)
    m, k, n = shape
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    assert matmul.pad_operands(a, b)[2] == tuple(
        name for name, t in (("A", a), ("B", b)) if not matmul.tma_ready(t))
    got = ops.matmul(a, b)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _reassoc_within_limit(got, ops.PLAIN.matmul(a, b),
                                 matmul.error_bound(a, b))
    assert _exact_within_limit(got, torch.matmul(a.double(), b.double()),
                               matmul.error_bound_exact(a, b))
    again = matmul.launch(a, b)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["a column slice", "b column slice",
                                  "a base offset", "k zero", "aligned"])
def test_cuda_matmul_bf16_unaligned_rows_take_the_copy(cuda, case):
    """Each operand the TMA maps cannot read in place (row stride not a
    multiple of 8 elements, base not 16-byte aligned, K = 0) goes through
    the padding step; an aligned pair does not; every result is within
    the limit of the plain version and of the float64 product."""
    from repro_torch.kernels import matmul
    gen = torch.Generator(device=cuda).manual_seed(12)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).bfloat16()

    m, k, n = 70, 96, 130
    a, b = rn(m, k), rn(k, n + 6)[:, :n]     # b: row stride 136, aligned
    want = ()
    if case == "a column slice":
        a, want = rn(m, k + 3)[:, :k], ("A",)
    elif case == "b column slice":
        b, want = rn(k, n + 1)[:, :n], ("B",)
    elif case == "a base offset":
        a, want = rn(m * k + 1)[1:].view(m, k), ("A",)
    elif case == "k zero":
        a, b, want = rn(m, 0), rn(0, n), ("A", "B")
    assert matmul.pad_operands(a, b)[2] == want
    got = ops.matmul(a, b)
    assert _reassoc_within_limit(got, ops.PLAIN.matmul(a, b),
                                 matmul.error_bound(a, b))
    assert _exact_within_limit(got, torch.matmul(a.double(), b.double()),
                               matmul.error_bound_exact(a, b))


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,ws", [
    ((64, 112, 112, 3), (7, 7, 3, 64)), ((1, 5, 600, 3), (3, 3, 3, 24)),
    ((1, 30, 30, 4), (21, 21, 4, 64)), ((40, 7, 9, 2), (7, 2, 2, 40)),
    ((3, 20, 11, 6), (1, 1, 6, 9))])
def test_cuda_conv2d_bits_repeat(cuda, dtype, xs, ws):
    """Two launches, the second on copies, give the same bits (one fmaf
    chain an output, no atomics), within the limit of the plain version:
    the card shape, and shapes of the generic paths (3 column tiles, 4
    passes over the channels at one block an SM, tiles across images of
    one output row, a 1 x 1 window over 2 channel blocks)."""
    from repro_torch.kernels import conv2d
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(xs, generator=gen, device=cuda).to(dtype)
    w = torch.randn(ws, generator=gen, device=cuda).to(dtype)
    got = conv2d.launch(x, w)
    again = conv2d.launch(x.clone(), w.clone())
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    assert _reassoc_within_limit(got, ops.PLAIN.conv2d(x, w),
                                 conv2d.error_bound(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hw", [(1, 32), (1, 64), (1, 112), (3, 50)])
def test_cuda_conv2d_cout8_matches_plain(cuda, dtype, n, hw):
    """The paper's sweep (7 x 7 x 3 -> 8): two channel groups of 4 a
    block, 16 pixel groups a warp, against the plain version."""
    from repro_torch.kernels import conv2d
    assert conv2d.plan(n, hw, hw, 3, 7, 7, 8).cgb == 2
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((n, hw, hw, 3), generator=gen, device=cuda).to(dtype)
    w = torch.randn((7, 7, 3, 8), generator=gen, device=cuda).to(dtype)
    got = ops.conv2d(x, w)
    assert got.dtype == dtype and got.shape == (n, hw - 6, hw - 6, 8)
    assert _reassoc_within_limit(got, ops.PLAIN.conv2d(x, w),
                                 conv2d.error_bound(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("warps", [4, 12])
@pytest.mark.parametrize("xs,ws", [((1, 112, 112, 3), (7, 7, 3, 8)),
                                   ((2, 40, 37, 20), (7, 7, 20, 70))])
def test_cuda_conv2d_block_sizes_same_bits(cuda, xs, ws, warps):
    """Both block sizes the kernel is built for give the bits of
    ``conv2d.launch``'s own plan where they cut the input channels into the
    same passes (one fmaf chain an output in the order pass, ky, ci, kx,
    whatever the tiles), and stay within the plain version's limit where
    they do not: the sweep's 112 shape (two passes at 12 warps, one at
    4), and 20 channels over 2 images and 3 channel blocks."""
    from repro_torch.kernels import _build, conv2d
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(xs, generator=gen, device=cuda)
    w = torch.randn(ws, generator=gen, device=cuda)
    want = conv2d.launch(x, w)
    n, h, wd, cin = xs
    kh, kw, _, cout = ws
    sms = conv2d._sm_count(x.device)
    own = conv2d.plan(n, h, wd, cin, kh, kw, cout, sms)
    p = conv2d.plan_warps(n, h, wd, cin, kh, kw, cout, sms, warps)
    y = torch.empty_like(want)
    fn = _build.bind(conv2d.NAME, "conv2d_launch", conv2d._ARGS)
    _build.check(fn(0, _build.ptr(x), _build.ptr(w), _build.ptr(y), n, h,
                    wd, cin, kh, kw, cout, *conv2d.launch_args(p),
                    int(y.data_ptr() % 16 == 0 and cout % 8 == 0),
                    _build.stream_of(x)), conv2d.NAME)
    if p.cc == own.cc:
        assert torch.equal(y, want)
    assert _reassoc_within_limit(y, ops.PLAIN.conv2d(x, w),
                                 conv2d.error_bound(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [1, 128, 129, 1121])
def test_cuda_flash_decode_one_launch_counters_and_repeat(cuda, dtype, sk):
    """One launch a call: rows of length 1, parked (2^30 + 1) and full
    beside each other combine to the plain version's result; the arrival
    counters read 0 after every call; two back-to-back calls give the
    same bits."""
    from repro_torch.kernels import flash_decode
    gen = torch.Generator(device=cuda).manual_seed(13)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    b, kvh, g, d = 4, 2, 3, 128
    q, k, v = rn(b, kvh * g, d), rn(b, sk, kvh, d), rn(b, sk, kvh, d)
    lens = torch.tensor([1, PARKED, sk, max(1, sk // 2)], device=cuda)
    before = flash_decode.launches
    got = ops.flash_decode(q, k, v, lengths=lens)
    again = ops.flash_decode(q, k, v, lengths=lens)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 2
    count = flash_decode.counters(q.device, b * kvh)
    assert not bool(count.any())
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    assert _within_limit(got, ops.PLAIN.flash_decode(q, k, v, lengths=lens))


# ---------------------------------------------------------------------------
# the serving engine's captured decode step (runtime/serving/graphs.py)
# ---------------------------------------------------------------------------

def _tiny(family, dtype):
    """(model, params): the reduced config of llama3.2-3b (dense),
    mamba2-2.7b (ssm) or hymba-1.5b (hybrid, its window cut to 8 so the
    tests' prompts pass it) at ``dtype``, random weights from seed 0."""
    import dataclasses
    from repro_torch.models import registry
    arch = {"dense": "llama3.2-3b", "ssm": "mamba2-2.7b",
            "hybrid": "hymba-1.5b"}[family]
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = dataclasses.replace(registry.config(arch).reduced(),
                              param_dtype=name, act_dtype=name)
    if family == "hybrid":
        cfg = dataclasses.replace(cfg, attn_window=8)
    model = registry.build_model(cfg, device="cuda")
    return model, model.init(0)


def _graph_engine(model, params, lens=(5, 9, 7, 12), gens=(8, 6, 10, 7),
                  plan=None, **kw):
    """A port engine with requests of prompt ``lens`` submitted, greedy
    unless ``plan`` gives request i's SamplingParams."""
    import numpy as np
    from repro_torch.runtime import serving
    eng = serving.ServingEngine(model, model.cfg, params,
                                config=serving.EngineConfig(
                                    **{"max_slots": 2, "max_seq": 64, **kw}))
    rng = np.random.default_rng(0)
    for i, (n, g) in enumerate(zip(lens, gens)):
        eng.submit(serving.Request(
            uid=i, prompt=rng.integers(0, model.cfg.vocab, n),
            max_new_tokens=g,
            sampling=plan[i] if plan else serving.GREEDY))
    return eng


def _same_streams(got, want):
    assert sorted(got) == sorted(want)
    return all((got[u] == want[u]).all() for u in want)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_cuda_decode_graph_streams_equal_eager(cuda, family, dtype, chunks):
    """The captured engine (the default on the card) gives the eager
    engine's token streams; its graph is replayed once a decode step; the
    launch counters see every replayed launch: flash_decode n_layers x
    (replays + the warm-up step), ssd only in prefill.  Greedy traffic
    captures no sampled graph."""
    model, params = _tiny(family, dtype)
    want = _graph_engine(model, params, decode_graph=False,
                         prefill_chunks=chunks).run()
    ops.reset_launch_counts()
    eng = _graph_engine(model, params, prefill_chunks=chunks)
    assert eng.graph is not None
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    replays, nl = eng.graph.replays, model.cfg.n_layers
    assert replays == eng.stats["decode_steps"] > 0
    assert eng.sampled_graph is None and eng.stats["sampled_steps"] == 0
    assert eng.graph.pool_bytes > 0
    if family == "dense":
        assert eng.graph.launches == {"flash_decode": nl}
        assert counts["flash_decode"] == nl * (replays + 1), counts
    else:
        assert eng.graph.launches == {}
        # each prefill and chunk, and each chunk graph's parked warm-up
        prefills = eng.stats["prefills"] + eng.stats["prefill_chunks"] \
            + len(eng.chunk_graphs)
        assert counts["ssd"] == nl * prefills, counts


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_graph_logits_bit_equal_eager(cuda, family, dtype):
    """Three decode steps of the model's ``decode_step`` captured (a parked
    slot beside two live ones) against the same steps run eagerly on a copy
    of the arena: logits and arena bit for bit after every step."""
    from repro_torch.models.layers import PARKED_POS
    from repro_torch.runtime.serving.graphs import DecodeGraph
    model, params = _tiny(family, dtype)
    gen = torch.Generator(device=cuda).manual_seed(5)
    cache = model.init_cache(3, 64)
    for slot, n in ((0, 9), (2, 20)):
        prompt = torch.randint(0, model.cfg.vocab, (1, n), generator=gen,
                               device=cuda)
        model.prefill(params, prompt, model.slot_view(cache, slot))
    copy = {k: v.clone() for k, v in cache.items()}
    tokens = torch.tensor([3, 4, 5], device=cuda)
    pos = torch.tensor([9, PARKED_POS, 20], device=cuda)
    graph = DecodeGraph(lambda: model.decode_step(params, tokens, cache,
                                                  pos),
                        tokens, pos, torch.zeros_like(pos))
    for _ in range(3):
        got = graph.replay()
        want = model.decode_step(params, tokens, copy, pos)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        for k in cache:
            assert torch.equal(cache[k].view(torch.uint8),
                               copy[k].view(torch.uint8)), k
        tokens.copy_(torch.argmax(want, dim=-1))
        pos.add_(torch.tensor([1, 0, 1], device=cuda))


@pytest.mark.gpu
def test_cuda_second_engine_leaves_first_unchanged(cuda):
    """A second engine captured while the first is mid-run (its own graph,
    pool and flash_decode counters at another slot count) leaves the
    first's token streams unchanged, and gives the eager streams itself; a
    third at the first's slot count gets arrival counters of its own, and
    stepping it between the first's steps changes neither stream."""
    from repro_torch.kernels import flash_decode
    model, params = _tiny("dense", torch.bfloat16)
    kw2 = dict(max_slots=3, prefill_chunks=(4, 8))
    want1 = _graph_engine(model, params, decode_graph=False).run()
    want2 = _graph_engine(model, params, decode_graph=False, **kw2).run()
    first = _graph_engine(model, params)
    for _ in range(6):
        first.step()
    second = _graph_engine(model, params, **kw2)
    third = _graph_engine(model, params)
    assert second.graph is not first.graph
    rows = 2 * model.cfg.n_kv_heads
    keys = [(torch.cuda.current_device(), e.graph.counters_owner, rows)
            for e in (first, third)]
    assert keys[0] != keys[1]
    assert all(k in flash_decode._COUNTERS for k in keys)
    for _ in range(4):
        third.step()
        first.step()
    assert _same_streams(first.run(), want1)
    assert _same_streams(second.run(), want2)
    assert _same_streams(third.run(), want1)


# ---------------------------------------------------------------------------
# on-device sampling (models/layers.py sample_step, the sampled graph)
# ---------------------------------------------------------------------------

#: (temperature, top_k, top_p, min_p, seed, q) of the four slots
SLOT_KNOBS = ((0.6, 50, 0.9, 0.05, 3, 1025), (1.0, 0, 1.0, 0.0, 11, 769),
              (0.0, 0, 1.0, 0.0, 5, 1030), (1.3, 0, 0.95, 0.02, 2**31 - 1,
                                            2**20))


def _sampler_inputs(v, dev):
    gen = torch.Generator().manual_seed(v)
    logits = torch.randn(len(SLOT_KNOBS), v, generator=gen) * 3
    t, k, p, m, seed, q = zip(*SLOT_KNOBS)
    vecs = (torch.tensor(seed), torch.tensor(q), torch.tensor(t),
            torch.tensor(k), torch.tensor(p), torch.tensor(m))
    return [x.to(dev) for x in (logits,) + vecs]


@pytest.mark.gpu
@pytest.mark.parametrize("v", [50280, 128256])
def test_cuda_sample_step_equals_cpu(cuda, v):
    """Keys, words, kept sets and tokens on the card equal the CPU's bit for
    bit at full vocabulary, different knobs and seeds in each slot; q off by
    one moves the sampled tokens."""
    from repro_torch.core import prng
    from repro_torch.models import layers as L
    out = {}
    for dev in ("cpu", cuda):
        logits, seed, q, t, k, p, m = _sampler_inputs(v, dev)
        keys = prng.fold_in(prng.fold_in(
            torch.zeros((4, 2), dtype=torch.int64, device=dev), seed), q)
        out[str(dev)] = (keys, prng.random_bits32(keys, (v,)),
                         L.masked_logits(logits, t, k, p, m),
                         L.sample_step(logits, seed, q, t, k, p, m),
                         L.sample_step(logits, seed, q + 1, t, k, p, m))
    cpu, card = out["cpu"], out["cuda"]
    for a, b in zip(cpu[:2], card[:2]):
        assert torch.equal(a, b.cpu())
    assert torch.equal(torch.isfinite(cpu[2]), torch.isfinite(card[2]).cpu())
    assert torch.equal(cpu[2].view(torch.int32), card[2].cpu().view(
        torch.int32))
    assert torch.equal(cpu[3], card[3].cpu())
    assert torch.equal(cpu[4], card[4].cpu())
    sampled = torch.tensor([kn[0] > 0 for kn in SLOT_KNOBS])
    assert (card[3] != card[4]).cpu()[sampled].any()
    assert torch.equal(card[3][~sampled.to(cuda)],
                       card[4][~sampled.to(cuda)])


@pytest.mark.gpu
def test_cuda_sampled_marginal_matches_reference(cuda):
    """20000 draws at V = 101 taken as rows on the card: chi-square against
    the port's numpy oracle (the reference's harness)."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.runtime.serving import sampling
    sp = sampling.SamplingParams(temperature=0.8, top_k=12, top_p=0.9,
                                 min_p=0.05)
    logits = np.random.default_rng(101).standard_normal(101).astype(
        np.float32)
    n = 20000
    x = torch.as_tensor(logits, device=cuda)[None].expand(n, -1)

    def full(val, dtype):
        return torch.full((n,), val, dtype=dtype, device=cuda)

    toks = L.sample_step(x, full(17, torch.int64),
                         torch.arange(n, device=cuda),
                         full(sp.temperature, torch.float32),
                         full(sp.top_k, torch.int64),
                         full(sp.top_p, torch.float32),
                         full(sp.min_p, torch.float32)).cpu().numpy()
    stat, df, limit = sampling.chi2_gof(
        toks, sampling.reference_probs(logits, sp))
    assert stat < limit, (stat, df, limit)


def _mixed_plan(n=4):
    from repro_torch.launch import serve
    return serve.sampling_plan(n, temperature=0.6, top_k=50, top_p=0.9,
                               min_p=0.05, seed=0, mix=0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_cuda_sampled_graph_streams_equal_eager(cuda, family, dtype, chunks):
    """Half the requests sampled: the captured engine (greedy twin and
    sampled graph) gives the eager engine's streams; the sampled graph is
    replayed once a sampled step, the twin once each other step; the greedy
    requests' streams equal an all-greedy run's."""
    model, params = _tiny(family, dtype)
    plan = _mixed_plan()
    want = _graph_engine(model, params, plan=plan, decode_graph=False,
                         prefill_chunks=chunks).run()
    greedy = _graph_engine(model, params, prefill_chunks=chunks).run()
    ops.reset_launch_counts()
    eng = _graph_engine(model, params, plan=plan, prefill_chunks=chunks)
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    for uid, sp in enumerate(plan):
        if sp.is_greedy:
            assert (got[uid] == greedy[uid]).all(), uid
    st, nl = eng.stats, model.cfg.n_layers
    assert eng.sampled_graph.replays == st["sampled_steps"] > 0
    assert eng.graph.replays + eng.sampled_graph.replays == \
        st["decode_steps"]
    assert st["sampled_requests"] == 2
    assert eng.sampled_graph.pool_bytes > 0
    if family == "dense":
        assert eng.sampled_graph.launches == {"flash_decode": nl}
        assert counts["flash_decode"] == nl * (st["decode_steps"] + 2), \
            counts


@pytest.mark.gpu
def test_cuda_sampled_graph_warm_up_leaves_vectors(cuda):
    """Capturing a sampled graph on a mid-run engine (its parked warm-up)
    leaves the engine's sampling vectors and slot vectors bit for bit, and
    the run goes on to the eager streams."""
    from repro_torch.runtime.serving.graphs import DecodeGraph
    model, params = _tiny("dense", torch.bfloat16)
    plan = _mixed_plan()
    want = _graph_engine(model, params, plan=plan, decode_graph=False).run()
    eng = _graph_engine(model, params, plan=plan)
    for _ in range(5):
        eng.step()
    state = {**{f"samp.{k}": v for k, v in eng._samp.items()},
             "tokens": eng._tokens, "pos": eng._pos, "active": eng._active}
    before = {k: v.clone() for k, v in state.items()}
    DecodeGraph(eng._decode_step_sampled, eng._tokens, eng._pos,
                eng._active)
    for k, v in state.items():
        assert torch.equal(v, before[k]), k
    assert _same_streams(eng.run(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_cuda_sampled_graph_captured_at_first_sampled_submit(cuda, family):
    """A greedy-only engine holds no sampled graph; the first sampled
    request submitted mid-run captures it (its parked warm-up leaves the
    slot and sampling vectors bit for bit), a second one reuses it, and
    the run gives the streams of an eager engine fed the same way."""
    import numpy as np
    from repro_torch.runtime import serving
    model, params = _tiny(family, torch.bfloat16)
    sp = _mixed_plan()[1]
    assert not sp.is_greedy
    rng = np.random.default_rng(1)
    late = [rng.integers(0, model.cfg.vocab, n) for n in (6, 10)]

    def feed(eng, checks):
        for _ in range(5):
            eng.step()
        for i, prompt in enumerate(late):
            if checks:
                assert (eng.sampled_graph is None) == (i == 0)
                state = {**{f"samp.{k}": v for k, v in eng._samp.items()},
                         "tokens": eng._tokens, "pos": eng._pos,
                         "active": eng._active}
                before = {k: v.clone() for k, v in state.items()}
                graph = eng.sampled_graph
            eng.submit(serving.Request(uid=10 + i, prompt=prompt,
                                       max_new_tokens=8, sampling=sp))
            if checks:
                assert eng.sampled_graph is not None
                assert graph is None or eng.sampled_graph is graph
                for k, v in state.items():
                    assert torch.equal(v, before[k]), k
        return eng.run()

    want = feed(_graph_engine(model, params, decode_graph=False), False)
    eng = _graph_engine(model, params)
    assert eng.sampled_graph is None
    assert _same_streams(feed(eng, True), want)
    assert eng.sampled_graph.replays == eng.stats["sampled_steps"] > 0


# ---------------------------------------------------------------------------
# captured chunk steps and the first-draw graph
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s", [(6, 1), (6, 200), (80, 64), (80, 1000)])
def test_cuda_ssd_zero_initial_state_equals_none(cuda, dtype, bh, s):
    """The chunk step always hands ssd an initial state, zeros on a
    prompt's first chunk: y and the final state equal ssd's without one,
    bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    p, n = 64, 128
    x = torch.randn((bh, s, p), generator=gen, device=cuda).to(dtype)
    log_a = -torch.rand((bh, s), generator=gen, device=cuda) * 0.1
    B = torch.randn((1, s, n), generator=gen, device=cuda).to(dtype)
    C = torch.randn((1, s, n), generator=gen, device=cuda).to(dtype)
    y0, st0 = ops.ssd(x, log_a, B, C)
    y1, st1 = ops.ssd(x, log_a, B, C,
                      initial_state=torch.zeros((bh, n, p), device=cuda))
    assert torch.equal(y0, y1) and torch.equal(st0, st1)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sampled", [False, True])
def test_cuda_chunk_graphs_streams_equal_eager(cuda, family, dtype, sampled):
    """Chunked prefill with an undersized page pool (preemption and
    recompute): the engine replaying one captured graph per chunk length
    (and, with sampled requests, the first-draw graph) gives the streams of
    the engine whose chunks, decode steps and draws all run eagerly; one
    chunk graph per chunk length used, replays equal to the chunks, every
    chunk's kernel launch counted (plus each graph's parked warm-up), the
    first-draw graph replayed once a sampled admission."""
    model, params = _tiny(family, dtype)
    plan = _mixed_plan() if sampled else None
    kw = dict(prefill_chunks=(4, 8), page_size=4, num_pages=9, plan=plan)
    want_eng = _graph_engine(model, params, decode_graph=False,
                             chunk_graph=False, **kw)
    want = want_eng.run()
    assert want_eng.chunk_graphs == {} and want_eng.draw_graph is None
    ops.reset_launch_counts()
    eng = _graph_engine(model, params, **kw)
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    st, nl = eng.stats, model.cfg.n_layers
    assert eng.scheduler.stats["preempted"] > 0
    assert sorted(eng.chunk_graphs) == sorted(eng._chunk_inputs) == [4, 8]
    assert st["prefill_shapes"] == len(eng.chunk_graphs)
    assert sum(g.replays for g in eng.chunk_graphs.values()) == \
        st["prefill_chunks"] > 0
    name = "flash_prefill_chunk" if family == "dense" else "ssd"
    assert counts[name] == nl * (st["prefill_chunks"]
                                 + len(eng.chunk_graphs)), counts
    assert all(g.launches == {name: nl} for g in eng.chunk_graphs.values())
    assert (eng.draw_graph is not None) == sampled
    if sampled:
        assert eng.draw_graph.replays >= st["sampled_requests"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_cuda_chunk_graph_capture_leaves_the_arena(cuda, fmt):
    """Capturing a chunk graph on a mid-run engine (its parked warm-up, its
    scalars pointing at a live slot) leaves every arena leaf and the slot
    vectors bit for bit, and the run goes on to the eager streams."""
    from repro_torch.runtime.serving.graphs import ChunkGraph
    model, params = _tiny("dense", torch.bfloat16)
    kw = dict(prefill_chunks=(4, 8), kv_format=fmt)
    want = _graph_engine(model, params, chunk_graph=False, **kw).run()
    eng = _graph_engine(model, params, **kw)
    for _ in range(6):
        eng.step()
    state = {**{f"cache.{k}": v for k, v in eng._cache.items()},
             "tokens": eng._tokens, "pos": eng._pos, "active": eng._active}
    before = {k: v.clone() for k, v in state.items()}
    tokens = torch.zeros((1, 16), dtype=torch.int64, device=cuda)
    scalars = torch.tensor([1, 4, 15], device=cuda)
    ChunkGraph(lambda: eng._chunk_step(tokens, scalars), scalars)
    assert scalars.tolist() == [1, 4, 15]
    for k, v in state.items():
        assert torch.equal(v.view(torch.uint8),
                           before[k].view(torch.uint8)), k
    assert _same_streams(eng.run(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_cuda_first_draw_graph_equals_eager_draw(cuda, family):
    """The captured first draw (captured at the first sampled submit) over
    its static logits row and scalars equals ``sampling.sample_first`` run
    eagerly on the same logits, at several knob sets (every filter on,
    each off) and positions."""
    from repro_torch.runtime import serving
    from repro_torch.runtime.serving import sampling
    model, params = _tiny(family, torch.bfloat16)
    v = model.cfg.vocab
    eng = _graph_engine(model, params, lens=(5,), gens=(2,),
                        plan=[_mixed_plan()[1]])
    graph = eng.draw_graph
    assert graph is not None and graph.pool_bytes > 0
    gen = torch.Generator(device=cuda).manual_seed(v)
    knobs = ((0.6, 50, 0.9, 0.05, 3, 1025), (1.0, 0, 1.0, 0.0, 11, 769),
             (1.3, 7, 1.0, 0.0, 0, 1), (0.8, 0, 0.5, 0.2, 123, 40))
    for temp, top_k, top_p, min_p, seed, q in knobs:
        logits = torch.randn((1, v), generator=gen, device=cuda) * 3
        sp = serving.SamplingParams(temperature=temp, top_k=top_k,
                                    top_p=top_p, min_p=min_p, seed=seed)
        eng._draw_logits.copy_(logits)
        eng._stage(eng._draw_ints, [seed, q, top_k])
        eng._stage(eng._draw_floats, [temp, top_p, min_p])
        got = graph.replay().clone()
        want = sampling.sample_first(logits, seed, q, sp)
        # the draw over the row's finite flag, one readback
        assert torch.equal(got[:1], want) and int(got[1]) == 1, (sp, q)


# ---------------------------------------------------------------------------
# the donor table of the arena kernels (prefix sharing)
# ---------------------------------------------------------------------------

def _donor_arena(gen, dtype, fmt, shape, device):
    """(k, v, k_scale, v_scale) of a random arena: ``fmt`` "fp32" stores at
    q's ``dtype`` (no scales), the rest as :func:`_narrow_arena`."""
    if fmt == "fp32":
        k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
                for _ in range(2))
        return k, v, None, None
    return _narrow_arena(gen, fmt, shape, device)


def _poison(t, slot, rows):
    """Rows [0, rows) of ``slot`` made unreadable: NaN where the type has
    one (f32, bf16, fp8 and the scales), else the largest value (int8,
    whose scale rows are NaN beside it)."""
    if t is None:
        return
    if t.dtype == torch.int8:
        t[slot, :rows] = 127
    else:
        t[slot, :rows] = float("nan")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fmt", SLOT_CASES)
@pytest.mark.parametrize("d", [8, 16, 128])
@pytest.mark.parametrize("share_len", [0, 12, 64, 100, 128])
def test_cuda_donor_table_bit_equal_no_table(cuda, dtype, fmt, d, share_len):
    """The donor table changes only where rows come from: slot a's rows
    [0, L) copied into slot d (the arena then the reference) and then
    poisoned in slot a (NaN, or int8's
    largest value under NaN scales), flash_decode and flash_prefill_chunk
    with the table (a -> (d, L), every other slot the identity) equal the
    calls without a table over the original arena bit for bit, and nothing
    reads the poison; L a multiple of 64, not one (the straddling strip
    loaded by rows), and 0.  The chunk/decode pin holds under the table.
    An int8 / fp8 arena of 8-byte rows under bf16 q is read only through a
    copy: the chunk kernel refuses a table there (decode takes the copy)."""
    gen = torch.Generator(device=cuda).manual_seed(d + share_len)
    n, s, kvh, h, c = 4, 300, 2, 6, 40
    a, donor, pre = 1, 3, 200
    k, v, ks, vs = _donor_arena(gen, dtype, fmt, (n, s, kvh, d), cuda)
    for t in (k, v, ks, vs):
        if t is not None:
            t[donor, :share_len] = t[a, :share_len]
    orig = [None if t is None else t.clone() for t in (k, v, ks, vs)]
    for t in (k, v, ks, vs):
        _poison(t, a, share_len)
    src = torch.tensor([0, donor, 2, 3], device=cuda)
    ln = torch.tensor([0, share_len, 0, 0], device=cuda)
    q = torch.randn((n, h, d), generator=gen, device=cuda).to(dtype)
    lens = torch.tensor([17, 250, PARKED, 1], device=cuda)
    got = ops.flash_decode(q, k, v, lengths=lens, k_scale=ks, v_scale=vs,
                           share_src=src, share_len=ln)
    want = ops.flash_decode(q, orig[0], orig[1], lengths=lens,
                            k_scale=orig[2], v_scale=orig[3])
    assert torch.equal(got, want)
    assert torch.isfinite(got[1].float()).all()
    qc = torch.randn((1, c, h, d), generator=gen, device=cuda).to(dtype)
    pf = torch.tensor([pre], device=cuda)
    slot = torch.tensor([a], device=cuda)
    table = dict(share_src=torch.tensor([donor], device=cuda),
                 share_len=torch.tensor([share_len], device=cuda))
    if d == 8 and dtype == torch.bfloat16 and fmt != "fp32":
        with pytest.raises(ValueError, match="in place"):
            ops.flash_prefill_chunk(qc, k, v, prefix=pf, k_scale=ks,
                                    v_scale=vs, slots=slot, **table)
        return
    got = ops.flash_prefill_chunk(qc, k, v, prefix=pf, k_scale=ks,
                                  v_scale=vs, slots=slot, **table)
    want = ops.flash_prefill_chunk(qc, orig[0], orig[1], prefix=pf,
                                   k_scale=orig[2], v_scale=orig[3],
                                   slots=slot)
    assert torch.equal(got, want)
    plain = ops.PLAIN.flash_prefill_chunk(qc, k, v, prefix=pf, k_scale=ks,
                                          v_scale=vs, slots=slot, **table)
    assert _within_limit(got, plain)
    # the pin under the table: chunk row j == flash_decode at pos pre + j
    # over a (c + 1)-slot arena whose rows 0..c-1 are slot a and whose
    # last row is the donor, every row's table entry (c, L)
    big = [None if t is None else torch.cat(
        (t[a:a + 1].expand(c, *t.shape[1:]), t[donor:donor + 1]))
        for t in (k, v, ks, vs)]
    qd = qc[0]
    dec = ops.flash_decode(
        torch.cat((qd, qd[:1])), big[0].contiguous(), big[1].contiguous(),
        lengths=torch.cat((pre + 1 + torch.arange(c, device=cuda),
                           torch.tensor([1], device=cuda))),
        k_scale=None if big[2] is None else big[2].contiguous(),
        v_scale=None if big[3] is None else big[3].contiguous(),
        share_src=torch.full((c + 1,), c, device=cuda),
        share_len=torch.cat((torch.full((c,), share_len, device=cuda),
                             torch.zeros(1, dtype=torch.int64,
                                         device=cuda))))
    assert torch.equal(got[0], dec[:c])


def _shared_prefix_engine(model, params, **kw):
    """A port engine with prefix sharing on and four requests whose
    prompts share their first 16 tokens (page size 4), tails 3..9."""
    import numpy as np
    from repro_torch.runtime import serving
    eng = serving.ServingEngine(model, model.cfg, params,
                                config=serving.EngineConfig(
                                    **{"max_slots": 4, "max_seq": 64,
                                       "page_size": 4,
                                       "prefill_chunks": (4, 8, 16),
                                       "prefix_sharing": True, **kw}))
    rng = np.random.default_rng(5)
    head = rng.integers(0, model.cfg.vocab, 16)
    for i, tail in enumerate((3, 9, 5, 7)):
        prompt = np.concatenate([head, rng.integers(0, model.cfg.vocab,
                                                    tail)])
        eng.submit(serving.Request(uid=i, prompt=prompt,
                                   max_new_tokens=8 + i))
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("family,fmt", [("dense", "fp32"), ("dense", "int8"),
                                        ("ssm", "fp32")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_shared_prefix_captured_equals_eager(cuda, family, fmt, dtype):
    """With prefix sharing on, the engine replaying its captured decode and
    chunk graphs (the forks' donor table read in place by both) gives the
    streams of the engine whose steps all run eagerly; three forks of 16
    shared tokens each, one chunk graph a length, every page back in the
    pool and no region pinned at the end."""
    model, params = _tiny(family, dtype)
    want_eng = _shared_prefix_engine(model, params, kv_format=fmt,
                                     decode_graph=False, chunk_graph=False)
    want = want_eng.run()
    eng = _shared_prefix_engine(model, params, kv_format=fmt)
    got = eng.run()
    assert _same_streams(got, want)
    for e in (eng, want_eng):
        assert e.stats["forks"] == 3
        assert e.stats["shared_prompt_tokens"] == 3 * 16
        m = e.cache_mgr
        assert m.free_pages == m.num_pages
        assert not any(m.region_pinned(s) for s in range(e.max_slots))
    assert sorted(eng.chunk_graphs) == sorted(eng._chunk_inputs)
    assert eng.stats["prefill_shapes"] == len(eng.chunk_graphs)
    if family == "ssm":
        assert eng.stats["snapshots"] > 0


# ---------------------------------------------------------------------------
# speculative decoding: the verify shapes and the captured rounds
# ---------------------------------------------------------------------------

# the verify pin's arena depth and starts: a start just below and on a
# 64-row strip edge, one deep in the arena, and the last row (a chunk of
# C > 1 there overruns the slot by C - 1 rows)
VERIFY_S = 1090
VERIFY_STARTS = (63, 64, 1087, VERIFY_S - 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fmt", SLOT_CASES)
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_cuda_verify_rows_bit_equal_decode(cuda, dtype, fmt, d, c):
    """The chunk/decode pin at the verify shapes: a chunk of C = 1, 2, 4 or
    8 rows (G x C = 3 .. 24 query rows of a 64-row tile) read through the
    slot table (slot 1 of 3) at starts 63, 64, 1087 and S - 1, each row j
    equal to flash_decode at pos = start + j over the same slot, bit for
    bit, in every arena format, rows past S included (both read the S
    rows there is)."""
    gen = torch.Generator(device=cuda).manual_seed(c * d)
    n, kvh, h, s = 3, 2, 6, VERIFY_S
    if fmt == "fp32":
        k, v = (torch.randn((n, s, kvh, d), generator=gen,
                            device=cuda).to(dtype) for _ in range(2))
        ks = vs = None
    else:
        k, v, ks, vs = _narrow_arena(gen, fmt, (n, s, kvh, d), cuda)
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    slot = torch.tensor([1], device=cuda)
    for start in VERIFY_STARTS:
        q = torch.randn((1, c, h, d), generator=gen, device=cuda).to(dtype)
        chunk = ops.flash_prefill_chunk(
            q, k, v, prefix=torch.tensor([start], device=cuda), slots=slot,
            **sc)
        one = {key: t[1:2].expand(c, *t.shape[1:]) for key, t in sc.items()}
        dec = ops.flash_decode(
            q[0], k[1:2].expand(c, s, kvh, d), v[1:2].expand(c, s, kvh, d),
            lengths=start + 1 + torch.arange(c, device=cuda), **one)
        assert torch.equal(chunk[0], dec), start


def _spec_engine(model, params, spec, n=4, **kw):
    """A 4-slot engine with ``spec`` (None: plain) and four requests, two
    of them sampled."""
    import numpy as np
    from repro_torch.runtime import serving
    plan = [serving.GREEDY, serving.SamplingParams(temperature=0.8,
                                                   top_k=20, seed=3),
            serving.GREEDY, serving.SamplingParams(temperature=1.1,
                                                   top_p=0.9, seed=4)]
    eng = serving.ServingEngine(model, model.cfg, params,
                                config=serving.EngineConfig(
                                    **{"max_slots": 4, "max_seq": 96,
                                       "speculative": spec, **kw}))
    rng = np.random.default_rng(6)
    for i, plen in enumerate((9, 20, 13, 30)[:n]):
        eng.submit(serving.Request(
            uid=i, prompt=rng.integers(0, model.cfg.vocab, plen),
            max_new_tokens=24, sampling=plan[i]))
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [None, (8, 16)])
@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_cuda_speculative_self_draft_equals_plain(cuda, chunks, fmt):
    """The tiny dense model in bf16 as its own draft (the same weights,
    from the same seed) at
    k = max_slots = 4: the captured speculative engine's streams equal the
    plain captured engine's bit for bit, greedy and sampled, with every
    proposal accepted (an fp32-format draft arena against an int8 target
    arena need not accept all); the verify graphs are captured once a
    (rung, twin) and the draft graphs once a twin, then replayed; with
    monolithic prefill flash_prefill_chunk runs only in the verify graphs
    (n_layers x (replays + warm-ups)) and flash_decode only in the draft
    graphs."""
    from repro_torch.runtime import serving
    model, params = _tiny("dense", torch.bfloat16)
    want = _spec_engine(model, params, None, prefill_chunks=chunks,
                        kv_format=fmt).run()
    # the target's own seed: the draft's weights are the target's
    spec = serving.SpecConfig(draft=model.cfg, k=4, adaptive=False,
                              draft_seed=0)
    ops.reset_launch_counts()
    eng = _spec_engine(model, params, spec, prefill_chunks=chunks,
                       kv_format=fmt)
    assert torch.equal(eng._draft_params["layers"]["attn"]["wq"],
                       params["layers"]["attn"]["wq"])
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    if fmt == "fp32":
        assert eng.spec.acceptance_rate == 1.0
    assert eng.graph is None and eng.sampled_graph is None
    assert sorted(eng.verify_graphs) == [(4, False), (4, True)]
    assert eng.stats["spec_verify_compiles"] == 2
    vg = list(eng.verify_graphs.values())
    dg = [eng.draft_graph, eng.sampled_draft_graph]
    assert sum(g.replays for g in vg) == eng.stats["spec_verify_calls"]
    assert sum(g.replays for g in dg) == eng.stats["spec_draft_steps"]
    # the greedy draft graph (captured at construction) may see no round
    # with only greedy slots
    assert all(g.replays > 0 for g in vg)
    assert eng.sampled_draft_graph.replays > 0
    nl = model.cfg.n_layers
    # the wrapper counts each verify launch apart, and a replay adds what
    # its capture counted
    assert all(g.launches["flash_prefill_chunk_verify"] == nl for g in vg)
    assert counts["flash_prefill_chunk_verify"] == nl * sum(
        g.replays + 1 for g in vg), counts
    if chunks is None:
        assert counts["flash_prefill_chunk"] == nl * sum(
            g.replays + 1 for g in vg), counts
        assert counts["flash_decode"] == nl * sum(
            g.replays + 1 for g in dg), counts
    else:
        assert sorted(eng.draft_chunk_graphs) == sorted(eng.chunk_graphs)


@pytest.mark.gpu
def test_cuda_speculative_cheap_draft_captured_equals_eager(cuda):
    """A one-layer draft at the target's widths and vocab (another seed):
    the captured speculative engine, the eager one and the plain captured
    engine give the same streams, chunked, with k walking the ladder."""
    import dataclasses
    from repro_torch.runtime import serving
    model, params = _tiny("dense", torch.bfloat16)
    draft = dataclasses.replace(model.cfg, name="tiny-draft", n_layers=1)
    spec = serving.SpecConfig(draft=draft, k=2, k_max=4, window=2,
                              draft_seed=7)
    want = _spec_engine(model, params, None, prefill_chunks=(8, 16)).run()
    eager = _spec_engine(model, params, spec, prefill_chunks=(8, 16),
                         decode_graph=False, chunk_graph=False)
    ops.reset_launch_counts()
    e_out = eager.run()
    # an eager verify pass launches flash_prefill_chunk once a layer
    assert ops.launch_counts()["flash_prefill_chunk_verify"] == (
        model.cfg.n_layers * eager.stats["spec_verify_calls"])
    eng = _spec_engine(model, params, spec, prefill_chunks=(8, 16))
    got = eng.run()
    assert _same_streams(got, want) and _same_streams(e_out, want)
    assert not eager.verify_graphs and eager.draft_graph is None
    assert eng.spec.stats == eager.spec.stats
    assert len(eng.verify_graphs) == eng.stats["spec_verify_compiles"]


# ---------------------------------------------------------------------------
# faults on the card: a NaN-filled slot stays in its slot, the finite flag
# of the captured steps, faulted engines captured against eager
# ---------------------------------------------------------------------------

NAN_S = 1121


def _fill_nan(t, slot):
    """Slot ``slot``'s whole region NaN where the type is floating (the
    engine's ``logits`` fault site: an int8 arena's rows stay, its scales
    go NaN)."""
    if t is not None and t.is_floating_point():
        t[slot] = float("nan")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,fmt", SLOT_CASES)
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("donor", [False, True])
def test_cuda_nan_slot_stays_in_its_slot(cuda, dtype, fmt, d, donor):
    """Slot 2 of a 4-slot arena of Sk = 1121 rows filled with NaN, as the
    ``logits`` fault site fills it: flash_decode (survivor lengths 1121,
    1089 and 1100, so each reaches its last 64-key strip, rows 1088-1120,
    which runs past the slot's edge) and flash_prefill_chunk through the
    slot table (chunks ending at row 1121) give the survivors' outputs bit
    for bit as over the NaN-free arena, and the victim's non-finite;
    ``donor``: slot 3 reads rows [0, 64) of slot 1 through the donor
    table."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    n, kvh, h, c, victim = 4, 2, 6, 40, 2
    clean = _donor_arena(gen, dtype, fmt, (n, NAN_S, kvh, d), cuda)
    bad = [None if t is None else t.clone() for t in clean]
    for t in bad:
        _fill_nan(t, victim)
    table = {}
    if donor:
        table = dict(share_src=torch.tensor([0, 1, 2, 1], device=cuda),
                     share_len=torch.tensor([0, 0, 0, 64], device=cuda))
    q = torch.randn((n, h, d), generator=gen, device=cuda).to(dtype)
    lens = torch.tensor([NAN_S, 1089, 50, 1100], device=cuda)

    def decode(arena):
        k, v, ks, vs = arena
        return ops.flash_decode(q, k, v, lengths=lens, k_scale=ks,
                                v_scale=vs, **table)

    want, got = decode(clean), decode(bad)
    live = [0, 1, 3]
    assert torch.equal(got[live], want[live])
    assert not torch.isfinite(got[victim].float()).any()
    assert torch.isfinite(want.float()).all()
    qc = torch.randn((n, c, h, d), generator=gen, device=cuda).to(dtype)
    slots = torch.arange(n, device=cuda)
    pre = torch.tensor([NAN_S - c, 1049, 9, NAN_S - c], device=cuda)
    ctab = {}
    if donor:
        ctab = dict(share_src=table["share_src"], share_len=table["share_len"])

    def chunk(arena):
        k, v, ks, vs = arena
        return ops.flash_prefill_chunk(qc, k, v, prefix=pre, k_scale=ks,
                                       v_scale=vs, slots=slots, **ctab)

    want, got = chunk(clean), chunk(bad)
    assert torch.equal(got[live], want[live])
    assert not torch.isfinite(got[victim].float()).any()


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("sampled", [False, True])
def test_cuda_captured_flag_equals_eager(cuda, family, sampled):
    """The finite flag of the captured decode step (greedy or sampled
    twin) equals the eager step's on the same state: two engines, one
    captured and one eager, through the same steps, then one slot filled
    with NaN in both; the (2, slots) readbacks are equal, the victim's
    flag 0 and the others' 1, and the captured step's tokens of the
    survivors equal the eager ones."""
    from repro_torch.runtime import serving
    model, params = _tiny(family, torch.bfloat16)
    plan = ([serving.SamplingParams(temperature=0.9, top_k=20, seed=5)] * 4
            if sampled else None)
    engines = [_graph_engine(model, params, plan=plan, max_slots=4,
                             decode_graph=graph, gens=(20,) * 4)
               for graph in (True, False)]
    for eng in engines:
        for _ in range(3):
            eng.step()
        eng._queue.drain()
        eng._drain_pending(limit=0)
    outs = []
    for eng in engines:
        victim = sorted(eng.scheduler.running)[1]
        eng._fill_slot(victim, float("nan"), floating_only=True)
        step = eng._queue_step(sampled)
        outs.append(step().clone())
    torch.cuda.synchronize()
    assert engines[0].graph is not None
    assert torch.equal(outs[0], outs[1])
    flags = outs[0][1].tolist()
    assert flags[victim] == 0
    assert [f for i, f in enumerate(flags) if i != victim] == [1, 1, 1]


def _faulted_engine(model, params, plan, **kw):
    """Five requests (two sampled) on 3 slots under fault plan ``plan``."""
    import numpy as np
    from repro_torch.runtime import serving
    eng = serving.ServingEngine(model, model.cfg, params,
                                config=serving.EngineConfig(
                                    **{"max_slots": 3, "max_seq": 64,
                                       "page_size": 8, "faults": plan,
                                       **kw}))
    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 11, 7, 16, 9)):
        sp = (serving.SamplingParams(temperature=1.1, top_k=20, seed=11 + i)
              if i % 2 else serving.GREEDY)
        eng.submit(serving.Request(uid=i, prompt=rng.integers(
            0, model.cfg.vocab, n), max_new_tokens=10, sampling=sp))
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("family,fmt", [("dense", "fp32"), ("dense", "int8"),
                                        ("ssm", "fp32")])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_cuda_faulted_engine_captured_equals_eager(cuda, family, fmt,
                                                   chunks):
    """A fault plan over alloc, chunk, decode and logits: the captured
    engine (decode, chunk and first-draw graphs) and the eager one give
    the same streams, statuses and fault counts; every survivor equals
    the fault-free captured run, every victim keeps a prefix of it, and
    every page drains."""
    from repro_torch.runtime import serving
    model, params = _tiny(family, torch.bfloat16)
    plan = serving.FaultPlan.of(seed=7, alloc=0.1, decode=0.1,
                                logits=serving.FaultSpec(0.2, max_fires=2),
                                **({"chunk": 0.2} if chunks else {}))
    kw = dict(prefill_chunks=chunks, kv_format=fmt)
    clean = _faulted_engine(model, params, None, **kw).run()
    runs = []
    for graph in (True, False):
        eng = _faulted_engine(model, params, plan, decode_graph=graph,
                              chunk_graph=graph, **kw)
        runs.append((eng.run(max_steps=3000), eng))
    (got, eng), (want, eager) = runs
    assert _same_streams(got, want)
    assert eng.stats["faults"] == eager.stats["faults"]
    assert eng.stats["poisoned"] == eager.stats["poisoned"] > 0
    assert eng.stats["quarantined"] == eager.stats["quarantined"] > 0
    for uid, st in eng._results.items():
        assert st.status == eager._results[uid].status
        n = got[uid].size
        assert (got[uid] == clean[uid][:n]).all()
        if st.status == serving.Status.FINISHED:
            assert n == clean[uid].size
    assert eng.cache_mgr.free_pages == eng.cache_mgr.num_pages


@pytest.mark.gpu
def test_cuda_ladder_degrades_speculation_to_captured_decode(cuda):
    """The self-draft (k = max_slots = 4) with the health ladder on: a
    burst of dropped rounds moves it to DEGRADED, where the engine
    captures its decode graph and runs queue decode, then back to rounds;
    the streams equal the plain captured engine's."""
    from repro_torch.runtime import serving
    model, params = _tiny("dense", torch.bfloat16)
    want = _spec_engine(model, params, None, prefill_chunks=(8, 16)).run()
    spec = serving.SpecConfig(draft=model.cfg, k=4, adaptive=False,
                              draft_seed=0)
    eng = _spec_engine(
        model, params, spec, prefill_chunks=(8, 16),
        faults=serving.FaultPlan.of(
            seed=4, decode=serving.FaultSpec(1.0, max_fires=3)),
        health=serving.HealthConfig(fault_degraded=2, fault_shedding=8,
                                    fault_draining=12, recover_after=2,
                                    shed_steps_draining=None))
    assert eng.graph is None
    got = eng.run(max_steps=3000)
    assert _same_streams(got, want)
    trans = [(f, t) for _, f, t, _ in eng.health.transitions]
    assert ("HEALTHY", "DEGRADED") in trans and ("DEGRADED", "HEALTHY") in trans
    assert eng.graph is not None or eng.sampled_graph is not None
    replays = sum(g.replays for g in (eng.graph, eng.sampled_graph) if g)
    assert replays == eng.stats["decode_steps"] - eng.stats["spec_rounds"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["monolithic", "chunked", "sampled",
                                  "shared", "faulted"])
def test_cuda_hybrid_engine_captured_equals_eager(cuda, dtype, mode):
    """The reduced hymba-1.5b (window 8, one global layer) served with its
    decode, chunk and first-draw steps captured gives the streams of the
    engine whose steps all run eagerly: monolithic and chunked prefill
    (prompts past the window, preemption in chunked), half the requests
    sampled, prefix sharing (forks read the donor's K/V rows through the
    table, the SSD state from snapshots) and a fault plan.  Every kernel
    of the hybrid path launches: flash_decode n_layers x (replays + the
    warm-up), a chunk's flash_prefill_chunk and ssd alike."""
    from repro_torch.runtime import serving
    model, params = _tiny("hybrid", dtype)
    if mode == "shared":
        def make(**kw):
            return _shared_prefix_engine(model, params, **kw)
    elif mode == "faulted":
        plan = serving.FaultPlan.of(seed=7, alloc=0.1, decode=0.1, chunk=0.2,
                                    logits=serving.FaultSpec(0.2,
                                                             max_fires=2))

        def make(**kw):
            return _faulted_engine(model, params, plan, prefill_chunks=(4, 8),
                                   **kw)
    else:
        chunked = mode != "monolithic"
        kw0 = dict(lens=(9, 21, 13, 17), prefill_chunks=(4, 8) if chunked
                   else None, plan=_mixed_plan() if mode == "sampled"
                   else None)
        if mode == "chunked":
            kw0.update(page_size=4, num_pages=10)

        def make(**kw):
            return _graph_engine(model, params, **kw0, **kw)
    eager = make(decode_graph=False, chunk_graph=False)
    want = eager.run(max_steps=3000)
    ops.reset_launch_counts()
    eng = make()
    got = eng.run(max_steps=3000)
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    st, nl = eng.stats, model.cfg.n_layers
    assert counts["flash_decode"] == nl * (
        eng.graph.replays + (eng.sampled_graph.replays
                             if eng.sampled_graph else 0)
        + 1 + (eng.sampled_graph is not None)), counts
    chunk_calls = st["prefill_chunks"] + len(eng.chunk_graphs)
    assert counts["flash_prefill_chunk"] == nl * chunk_calls, counts
    assert counts["ssd"] == nl * (chunk_calls + st["prefills"]), counts
    assert counts["flash_attention"] == nl * st["prefills"], counts
    if mode == "chunked":
        assert eng.scheduler.stats["preempted"] > 0
    if mode == "shared":
        assert st["forks"] == 3 and st["snapshots"] > 0
        assert counts["flash_decode_donor"] == counts["flash_decode"]
        assert counts["flash_prefill_chunk_donor"] == \
            counts["flash_prefill_chunk"]
    if mode == "faulted":
        assert st["faults"] == eager.stats["faults"]
        assert st["poisoned"] == eager.stats["poisoned"] > 0
        assert st["quarantined"] == st["poisoned"]


# ---------------------------------------------------------------------------
# the moe family (routed experts with capacity predication)
# ---------------------------------------------------------------------------

def _tiny_moe(dtype, capacity_factor=None):
    """(model, params): the reduced qwen2-moe-a2.7b (4 experts top 2, 2
    shared) at ``dtype``, at its published capacity_factor 1.25 (binding)
    or the given one, random weights from seed 0."""
    import dataclasses
    from repro_torch.models import registry
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = dataclasses.replace(registry.config("qwen2-moe-a2.7b").reduced(),
                              param_dtype=name, act_dtype=name)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    model = registry.build_model(cfg, device="cuda")
    return model, model.init(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
@pytest.mark.parametrize("capacity", [None, 2.0], ids=["binding", "free"])
def test_cuda_moe_engine_captured_equals_eager(cuda, dtype, chunks,
                                               capacity):
    """The reduced qwen2-moe served by the captured engine (decode and
    chunk graphs) and by the eager one: equal streams under binding
    capacity (the dispatch of a replay sees the same rows as the eager
    step's) and free; flash_decode n_layers x (replays + the warm-up)."""
    model, params = _tiny_moe(dtype, capacity)
    kw = dict(max_slots=3, prefill_chunks=chunks)
    want = _graph_engine(model, params, decode_graph=False,
                         chunk_graph=False, **kw).run()
    ops.reset_launch_counts()
    eng = _graph_engine(model, params, **kw)
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    nl = model.cfg.n_layers
    assert counts["flash_decode"] == nl * (eng.graph.replays + 1), counts
    if chunks:
        assert len(eng.chunk_graphs) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", [1.0, 2.0], ids=["binding", "free"])
def test_cuda_moe_mlp_matches_cpu(cuda, capacity):
    """``moe_mlp_apply`` in f32 on the card against the CPU on the same
    inputs: the same expert choices and drops, y within 2e-5, aux within
    1e-6 relative."""
    from repro_torch.models import moe
    model, params = _tiny_moe(torch.float32, capacity)
    cfg = model.cfg
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 33, cfg.d_model), generator=gen, device="cuda")
    y, aux = moe.moe_mlp_apply(p, cfg, x)
    cpu = {k: (v.cpu() if not isinstance(v, dict) else
               {kk: vv.cpu() for kk, vv in v.items()}) for k, v in p.items()}
    y_c, aux_c = moe.moe_mlp_apply(cpu, cfg, x.cpu())
    xf = x.reshape(-1, cfg.d_model)
    _, idx, _ = moe.route(p, cfg, xf)
    _, idx_c, _ = moe.route(cpu, cfg, xf.cpu())
    assert torch.equal(idx.cpu(), idx_c)
    cap = moe.capacity(cfg, xf.shape[0])
    assert torch.equal(moe.dispatch(idx, 4, cap)[1].cpu(),
                       moe.dispatch(idx_c, 4, cap)[1])
    assert ((y.cpu() - y_c).abs() <= 2e-5).all()
    assert abs(float(aux) - float(aux_c)) <= 1e-6 * abs(float(aux_c))


@pytest.mark.gpu
def test_cuda_moe_decode_step_makes_no_sync(cuda):
    """An eager bf16 moe decode step (a parked slot among live ones) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in routing,
    capacity, dispatch or combine synchronises with the host."""
    model, params = _tiny_moe(torch.bfloat16)
    cache = model.init_cache(3, 32)
    tok = torch.tensor([3, 5, 7], device="cuda")
    pos = torch.tensor([4, (1 << 30), 9], device="cuda")
    model.decode_step(params, tok, cache, pos)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = model.decode_step(params, tok, cache, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the vlm and encdec families (llava-next-34b, whisper-large-v3)
# ---------------------------------------------------------------------------

def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 100, 600, 1600])
def test_cuda_vlm_attention_g7(cuda, dtype, s):
    """flash_attention causal at llava's head shape (14 / 2 heads, G = 7,
    hd 128): the tensor-core tile's 64 folded rows cross heads."""
    gen = torch.Generator(device="cuda").manual_seed(s)
    q = _randn(gen, 1, 14, s, 128, dtype=dtype)
    k, v = (_randn(gen, 1, 2, s, 128, dtype=dtype) for _ in range(2))
    assert _within_limit(ops.attention(q, k, v),
                         ops.PLAIN.attention(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(1500, 1500), (224, 1500), (160, 1500),
                                   (7, 1500), (1, 1500), (50, 130)])
def test_cuda_encdec_attention_non_causal(cuda, dtype, sq, sk):
    """flash_attention non-causal at hd 64, MHA: whisper's encoder (S =
    1500, not a multiple of 64) and its cross-attention prefill (Sq < Sk
    = 1500)."""
    gen = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = _randn(gen, 2, 4, sq, 64, dtype=dtype)
    k, v = (_randn(gen, 2, 4, sk, 64, dtype=dtype) for _ in range(2))
    assert _within_limit(ops.attention(q, k, v, causal=False),
                         ops.PLAIN.attention(q, k, v, causal=False))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,s", [(20, 20, 64, 1500), (4, 4, 64, 24),
                                       (14, 2, 128, 1665)])
def test_cuda_encdec_flash_decode_without_lengths(cuda, dtype, h, kvh, d,
                                                  s):
    """flash_decode with ``lengths=None`` (every row attended: whisper's
    cross-attention over 1500 encoder rows) and at llava's G = 7, against
    the plain version; the arrival counters read 0 after the call."""
    from repro_torch.kernels import flash_decode
    gen = torch.Generator(device="cuda").manual_seed(s)
    q = _randn(gen, 4, h, d, dtype=dtype)
    k, v = (_randn(gen, 4, s, kvh, d, dtype=dtype) for _ in range(2))
    assert _within_limit(ops.flash_decode(q, k, v),
                         ops.PLAIN.flash_decode(q, k, v))
    lens = torch.tensor([s, s // 2, PARKED, 1], device="cuda")
    assert _within_limit(ops.flash_decode(q, k, v, lengths=lens),
                         ops.PLAIN.flash_decode(q, k, v, lengths=lens))
    torch.cuda.synchronize()
    assert int(flash_decode.counters(q.device, 4 * kvh)[:4 * kvh]
               .abs().sum()) == 0


def _tiny_family(name, dtype):
    """(model, params): the reduced ``name`` at ``dtype``, random weights
    from seed 0."""
    import dataclasses
    from repro_torch.models import registry
    dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = dataclasses.replace(registry.config(name).reduced(),
                              param_dtype=dt, act_dtype=dt)
    model = registry.build_model(cfg, device="cuda")
    return model, model.init(0)


def _extras_engine(model, params, sampled=False, **kw):
    """A port engine with 4 requests (prompts 5 / 9 / 7 / 12), each with
    the family's extras; requests 1 and 3 sampled if ``sampled``."""
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.runtime import serving
    eng = serving.ServingEngine(model, model.cfg, params,
                                config=serving.EngineConfig(
                                    **{"max_slots": 2, "max_seq": 64, **kw}))
    args = serve.parse_args(["--arch", model.cfg.name, "--requests", "4"])
    side = serve.extras(args, model.cfg)
    rng = np.random.default_rng(0)
    for i, (n, g) in enumerate(zip((5, 9, 7, 12), (8, 6, 10, 7))):
        sp = (serving.SamplingParams(temperature=0.9, top_k=20, seed=7 + i)
              if sampled and i % 2 else serving.GREEDY)
        eng.submit(serving.Request(
            uid=i, prompt=rng.integers(0, model.cfg.vocab, n),
            max_new_tokens=g, sampling=sp, extras=side[i]))
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llava-next-34b", "whisper-large-v3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_cuda_vlm_encdec_engine_captured_equals_eager(cuda, name, dtype,
                                                      sampled):
    """The reduced llava (12 patch rows) and whisper (enc_seq 24) served by
    the captured engine and by the eager one: equal streams, every arena
    leaf (whisper's cross leaves included) bit for bit after the run,
    flash_decode n_layers x (replays + the warm-up) (x 2 for whisper: self
    and cross), flash_attention once a prefill (x 3 for whisper's layers:
    the encoder's, the decoder's self and cross)."""
    model, params = _tiny_family(name, dtype)
    eager = _extras_engine(model, params, sampled, decode_graph=False)
    want = eager.run()
    ops.reset_launch_counts()
    eng = _extras_engine(model, params, sampled)
    got = eng.run()
    counts = ops.launch_counts()
    assert _same_streams(got, want)
    for key, leaf in eng._cache.items():
        assert torch.equal(leaf, eager._cache[key]), key
    cfg = model.cfg
    encdec = cfg.family == "encdec"
    replays = eng.graph.replays + (eng.sampled_graph.replays if sampled
                                   else 0)
    warm = 2 if sampled else 1
    assert counts["flash_decode"] == (2 if encdec else 1) * cfg.n_layers \
        * (replays + warm), counts
    prefills = eng.stats["prefills"]
    attn = (cfg.n_enc_layers + 2 * cfg.n_layers) if encdec else cfg.n_layers
    assert counts["flash_attention"] == attn * prefills, counts


@pytest.mark.gpu
def test_cuda_encdec_decode_step_makes_no_sync(cuda):
    """An eager bf16 encdec decode step (a parked slot among live ones)
    under ``torch.cuda.set_sync_debug_mode("error")``: the learned
    positions' clamp, the self row writes and the cross-attention make no
    host sync; the parked slot's self rows stay as they were."""
    model, params = _tiny_family("whisper-large-v3", torch.bfloat16)
    cache = model.init_cache(3, 32)
    frames = torch.randn((1, model.cfg.enc_seq, model.cfg.d_model),
                         device="cuda")
    for b in range(3):
        model.prefill(params, torch.arange(4, device="cuda")[None],
                      model.slot_view(cache, b), frames=frames)
    tok = torch.tensor([3, 5, 7], device="cuda")
    pos = torch.tensor([4, (1 << 30), 9], device="cuda")
    model.decode_step(params, tok, cache, pos)
    before = cache["k"][:, 1].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = model.decode_step(params, tok, cache, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())
    assert torch.equal(cache["k"][:, 1], before)


# ---------------------------------------------------------------------------
# training: the attention backward kernel and the trainer on the card
# ---------------------------------------------------------------------------

def _bwd_within(got, want, rtol=1e-4):
    """Each gradient within one ulp of its type at the larger magnitude
    plus ``rtol`` x the plain gradient's rms (chip_smoke.py's BWD_RTOL
    states the argument)."""
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        big = torch.maximum(g32.abs(), w32.abs())
        _, e = torch.frexp(big)
        bits = 8 if g.dtype == torch.bfloat16 else 24
        ulp = torch.where(big == 0, 0.0,
                          torch.ldexp(torch.ones_like(big), e - bits))
        lim = ulp + rtol * w32.pow(2).mean().sqrt()
        if not bool(((g32 - w32).abs() <= lim).all()):
            return False
    return True


BWD_CASES = {
    # name: (causal, window, Sq, Sk, KVH, G)
    "causal": (True, None, 100, 100, 2, 1),
    "noncausal": (False, None, 77, 77, 1, 3),
    "window": (True, 33, 130, 130, 1, 7),
    "sq_lt_sk": (True, None, 40, 150, 1, 8),
    "ragged_sk": (False, None, 64, 93, 2, 3),
    # several full 64-row blocks on each side: each CTA refills its ring
    "multi_block": (True, None, 320, 320, 2, 4),
    # Sq not a multiple of 64 under a window
    "window_ragged_sq": (True, 50, 150, 150, 2, 2),
    # hymba-1.5b's training attention: 25 / 5 heads, window 1024, S 2048
    "hymba_window": (True, 1024, 2048, 2048, 5, 5),
}


def _bwd_inputs(case, d, dtype, seed=0):
    causal, window, sq, sk, kvh, g = BWD_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = rn(2, sq, kvh * g, d).transpose(1, 2)
    k = rn(2, sk, kvh, d).transpose(1, 2)
    v = rn(2, sk, kvh, d).transpose(1, 2)
    do = rn(2, sq, kvh * g, d).transpose(1, 2)
    return q, k, v, do, dict(causal=causal, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_cuda_bwd_kernel_matches_plain(cuda, dtype, d, case):
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    q, k, v, do, kw = _bwd_inputs(case, d, dtype)
    o, lse = flash_attention.launch(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd.launch(q, k, v, o, lse, do, **kw)
    want = ops._attention_bwd_plain(q, k, v, o, lse, do, scale=None, **kw)
    assert _bwd_within(got, want), case
    fault = ops._attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do,
                                     scale=None, **kw)
    assert not _bwd_within(got[:2], fault[:2]), "delta dropped passes"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bwd_bits_repeat_and_lse_leaves_o(cuda, dtype):
    """Two backward runs give the same bits (no atomics), and the forward's
    O is the same bits with its LSE output on and off."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    for case in sorted(BWD_CASES):
        q, k, v, do, kw = _bwd_inputs(case, 64, dtype, seed=1)
        o, lse = flash_attention.launch(q, k, v, with_lse=True, **kw)
        assert torch.equal(o, flash_attention.launch(q, k, v, **kw)), case
        a = flash_attention_bwd.launch(q, k, v, o, lse, do, **kw)
        b = flash_attention_bwd.launch(q, k, v, o, lse, do, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case


@pytest.mark.gpu
@pytest.mark.parametrize("sq,g", [(4096, 2), (8192, 1)])
def test_cuda_bwd_long_causal_sequence(cuda, sq, g):
    """bf16 at hd 128, causal, Sq = Sk up to 8192 (128 key blocks a dQ row,
    128 query blocks a dK/dV CTA for each of its G heads): every block's
    product is summed in f32 on its own, so the gradients stay within the
    limit however long the sequence."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    q, do = (rn(1, sq, g, 128).transpose(1, 2) for _ in range(2))
    k, v = (rn(1, sq, 1, 128).transpose(1, 2) for _ in range(2))
    o, lse = flash_attention.launch(q, k, v, causal=True, with_lse=True)
    got = flash_attention_bwd.launch(q, k, v, o, lse, do, causal=True)
    want = ops._attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                    window=None, scale=None)
    assert _bwd_within(got, want)


@pytest.mark.gpu
def test_cuda_bwd_autograd_counts_launches(cuda):
    """ops.attention with a gradient: one forward launch (LSE on) and one
    backward launch a call, no plain version."""
    q, k, v, do, kw = _bwd_inputs("causal", 64, torch.bfloat16)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    out = ops.attention(q, k, v, **kw)
    torch.autograd.grad(out, (q, k, v), do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1, counts
    assert counts["flash_attention_bwd"] == 1, counts


def _train_cfg(name, dtype):
    import dataclasses
    from repro_torch.models import registry
    cfg = registry.config(name).reduced()
    if dtype == torch.float32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  act_dtype="float32")
    return cfg


SSD_BWD_CASES = {
    # name: (rows, B/C rows, S, P, N, initial state)
    "one_chunk": (6, 2, 20, 16, 8, False),
    "ragged_init": (6, 3, 200, 12, 20, True),
    "mamba2_width": (8, 2, 300, 64, 128, False),
    "hymba_width": (10, 2, 257, 64, 16, True),
    "head_a_row": (4, 4, 129, 64, 128, True),
    # 80 heads a B/C row over 16 chunks: the bf16 chunk kernel's 8 slices
    # of 10 heads, the state walk's ring refilled past its 3 stages
    "many_heads": (80, 1, 1000, 64, 128, False),
    # hymba-1.5b's N 16 and 25 heads a B/C row, an initial state, x strided
    "n16_init": (50, 2, 520, 64, 16, True),
}


def _ssd_bwd_inputs(case, dtype, seed=0):
    bh, nb, s, p, n, init = SSD_BWD_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (rn(s, bh, p) * 0.5).to(dtype).transpose(0, 1)
    la = -torch.rand((bh, s), generator=gen, device="cuda") * 0.1
    B, C = rn(nb, s, n).to(dtype), rn(nb, s, n).to(dtype)
    dy = rn(bh, s, p).to(dtype)
    st = rn(bh, n, p) * 0.1 if init else None
    return x, la, B, C, dy, st


def _ssd_carry_dropped(x, la, B, C, dy, st):
    """The plain backward with the state gradient not carried between
    64-token chunks (each chunk from its true start state): the planted
    fault the kernel must not pass for."""
    parts, state = [], st
    for t0 in range(0, x.shape[1], 64):
        sl = slice(t0, t0 + 64)
        args = (x[:, sl], la[:, sl], B[:, sl], C[:, sl])
        parts.append(ops._ssd_bwd_plain(*args, dy[:, sl], chunk=64,
                                        initial_state=state))
        state = ops.PLAIN.ssd(*args, chunk=64, initial_state=state)[1]
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SSD_BWD_CASES))
def test_cuda_ssd_bwd_kernel_matches_plain(cuda, dtype, case):
    """The ssd_bwd kernel against ``ssd_bwd_plain`` (B/C repeated to their
    heads, dB / dC summed back): ragged S, strided x, an initial state,
    B/C shared by several heads; each gradient within one ulp of its type
    plus 1e-4 of its rms.  Dropping the carried state gradient between
    chunks fails that limit, and two runs give the same bits."""
    from repro_torch.kernels import ssd_bwd
    x, la, B, C, dy, st = _ssd_bwd_inputs(case, dtype)
    got = ssd_bwd.launch(x, la, B, C, dy, initial_state=st)
    want = ops._ssd_bwd_plain(x, la, B, C, dy, chunk=64, initial_state=st)
    assert [g.dtype for g in got] == [dtype, torch.float32, dtype, dtype]
    assert _bwd_within(got, want), case
    if x.shape[1] > 64:
        assert not _bwd_within(got, _ssd_carry_dropped(x, la, B, C, dy, st))
    again = ssd_bwd.launch(x, la, B, C, dy, initial_state=st)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), case


@pytest.mark.gpu
def test_cuda_ssd_autograd_counts_launches(cuda):
    """ops.ssd with a gradient: one ssd launch and one ssd_bwd launch a
    call, no plain version."""
    x, la, B, C, dy, _ = _ssd_bwd_inputs("mamba2_width", torch.bfloat16)
    x, la, B, C = (t.detach().requires_grad_() for t in (x, la, B, C))
    ops.reset_launch_counts()
    y, _ = ops.ssd(x, la, B, C)
    torch.autograd.grad(y, (x, la, B, C), dy)
    counts = ops.launch_counts()
    assert counts["ssd"] == 1 and counts["ssd_bwd"] == 1, counts


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "llava-next-34b", "whisper-large-v3",
                                  "mamba2-2.7b", "hymba-1.5b"])
def test_cuda_train_kernel_path_matches_plain(cuda, name):
    """One step's loss and gradients in f32 on a reduced model: the kernel
    path against the plain path (``kernels=ops.PLAIN``) on the same
    weights, each leaf within 1e-5 of its largest element (chip_smoke.py's
    TRAIN_GRAD_TOL: the first reading was ~8e-7)."""
    from repro_torch.core import chaining, tree
    from repro_torch.data import SyntheticLMDataset, family_extras_fn
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import registry
    cfg = _train_cfg(name, torch.float32)
    km = registry.build_model(cfg, device="cuda")
    pm = registry.build_model(cfg, device="cuda", kernels=ops.PLAIN)
    params = km.init(0)
    host = SyntheticLMDataset(vocab=cfg.vocab, seq_len=48,
                              global_batch=2).batch(0)
    extras = family_extras_fn(cfg)
    batch = to_device(extras(0, host) if extras else host, "cuda")
    kl, kg = chaining.value_and_grad(lambda p, b: km.loss_fn(p, b)[0],
                                     params, batch)
    pl, pg = chaining.value_and_grad(lambda p, b: pm.loss_fn(p, b)[0],
                                     params, batch)
    assert abs(kl.item() - pl.item()) <= 1e-6 * abs(pl.item())
    for (p, a), (_, b) in zip(tree.items(kg), tree.items(pg)):
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        assert rel <= 1e-5, (p, rel)


@pytest.mark.gpu
def test_cuda_train_trainer_kernel_path_matches_plain(cuda):
    """Two Trainer steps of reduced llama3.2-3b in f32 from one state, the
    kernel path against the plain path: losses, grad norms and lr within
    1e-5 relative; params within 2 x lr, the most two AdamW steps can
    part an element whose gradient sits near eps (an update of about lr
    either way), and on average within 1e-6."""
    import copy
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.data import make_pipeline
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.trainer import Trainer, TrainConfig
    cfg = _train_cfg("llama3.2-3b", torch.float32)
    tcfg = TrainConfig(num_steps=2, log_every=1, peak_lr=1e-3)
    out = []
    params = registry.build_model(cfg, device="cuda").init(0)
    for kernels in (ops, ops.PLAIN):
        model = registry.build_model(cfg, device="cuda", kernels=kernels)
        p = copy.deepcopy(params)
        state = {"params": p, "opt": adamw_init(p)}
        pipe = make_pipeline(cfg, ShapeConfig("t", 64, 4, "train"),
                             num_steps=2)
        out.append(Trainer(model, tcfg).run(pipe, state=state))
    (k, pl) = out
    for a, b in zip(k["_history"], pl["_history"]):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), (key, a, b)
    diffs = [(x - y).abs() for x, y in zip(tree.leaves(k["params"]),
                                           tree.leaves(pl["params"]))]
    assert max(d.max().item() for d in diffs) <= 2e-3
    assert max(d.mean().item() for d in diffs) <= 1e-6


@pytest.mark.gpu
def test_cuda_train_head_f32_matches_upcast(cuda):
    """The bf16 LM head's f32 logits (the f32-out GEMM) and its gradients
    against the same product on f32 copies: logits within f32 rounding of
    bf16 products summed in f32, gradients within one bf16 rounding (the
    backward takes the cotangent at bf16, as a bf16 GEMM's is)."""
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 64, 256), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    w = (torch.randn((256, 1000), generator=gen, device="cuda") / 16).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn((2, 64, 1000), generator=gen, device="cuda")
    out = layers.head_f32(x, w)
    assert out.dtype == torch.float32
    dx, dw = torch.autograd.grad(out, (x, w), g)
    xf, wf = (t.detach().float().requires_grad_() for t in (x, w))
    ref = xf @ wf
    rx, rw = torch.autograd.grad(ref, (xf, wf), g)
    assert torch.allclose(out, ref, atol=1e-4, rtol=1e-4)
    for got, want in ((dx, rx), (dw, rw)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want).abs().max() / want.abs().max()
        assert err < 2 ** -7, err


@pytest.mark.gpu
def test_cuda_train_restart_bit_for_bit(cuda, tmp_path):
    """Reduced llama3.2-3b (bf16) on the card: 6 steps straight = 3 steps,
    a checkpoint, a fresh Trainer restoring it, 3 more; losses and final
    params bit for bit."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.data import make_pipeline
    from repro_torch.models import registry
    from repro_torch.runtime.trainer import Trainer, TrainConfig
    bundle = registry.build("llama3.2-3b", reduced=True, device="cuda")
    shape = ShapeConfig("t", 64, 4, "train")
    kw = dict(log_every=1, peak_lr=1e-3, seed=0)
    ck = str(tmp_path / "ck")

    def pipe(start, n):
        return make_pipeline(bundle.cfg, shape, start_step=start,
                             num_steps=n)
    st_a = Trainer(bundle.model, TrainConfig(num_steps=6, **kw)).run(
        pipe(0, 6))
    Trainer(bundle.model, TrainConfig(num_steps=3, ckpt_dir=ck, **kw)).run(
        pipe(0, 3))
    tr = Trainer(bundle.model, TrainConfig(num_steps=6, ckpt_dir=ck, **kw))
    state, start = tr.maybe_restore()
    assert start == 3
    st_c = tr.run(pipe(3, 3), start_step=start, state=state)
    assert [h["loss"] for h in st_a["_history"]][3:] == \
        [h["loss"] for h in st_c["_history"]]
    for a, c in zip(tree.leaves(st_a["params"]), tree.leaves(st_c["params"])):
        assert torch.equal(a, c)
