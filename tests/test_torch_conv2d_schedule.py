"""The launch of the conv2d kernel (``src/repro_torch/kernels/csrc/conv2d.cu``)
as ``conv2d.plan`` sizes it and ``conv2d.tile_of`` / ``block_tiles`` mirror
its walk: every block's tiles, every warp's channel group and every lane's
group of 16 output columns (R), on the CPU.

Over the shapes of ``tests/test_torch_cuda.py``'s conv2d cases, the paper's
sweep (``chip_smoke.py`` phase 6a), the card shape and a few that reach the
generic paths (column tiles, passes over the input channels, the one-block
budget, images of one output row): every output is stored by exactly one
lane of one block, no tile lies past the edge, each lane's inputs lie in
the halo its tile stages, and the shared memory fits the card's 227 KB.
"""
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import conv2d  # noqa: E402

phys = conv2d.phys

CUDA_CASES = [((2, 16, 16, 3), (7, 7, 3, 8)), ((2, 32, 20, 4), (3, 3, 4, 4)),
              ((2, 9, 9, 1), (7, 7, 1, 2)), ((1, 40, 37, 20), (7, 7, 20, 70)),
              ((1, 12, 30, 5), (3, 5, 5, 16))]
SWEEP = [((1, hw, hw, 3), (7, 7, 3, 8)) for hw in (32, 64, 112)]
CARD = ((64, 112, 112, 3), (7, 7, 3, 64))
GENERIC = [((1, 5, 600, 3), (3, 3, 3, 24)),     # 75 groups: 3 column tiles
           ((1, 30, 30, 4), (21, 21, 4, 64)),   # 4 passes
           ((40, 7, 9, 2), (7, 2, 2, 40)),      # Ho = 1: a tile spans images
           ((3, 20, 11, 6), (1, 1, 6, 9))]      # 1 x 1, 9 channels: 2 blocks
SHAPES = CUDA_CASES + SWEEP + [CARD] + GENERIC
MAX_SMEM = 227 * 1024 - 64     # the kernel's static bytes aside


def _id(case):
    return "x".join(map(str, case[0])) + "-" + "x".join(map(str, case[1]))


def _lanes(p):
    """Each thread's (channel group in its block, group in its tile): the
    CGB lanes of a group are adjacent (csrc/conv2d.cu ``cgl``, ``gw``)."""
    tid = torch.arange(32 * p.nw)
    return tid % 32 % p.cgb, tid // 32 * (32 // p.cgb) + tid % 32 // p.cgb


def _walk(xs, ws, warps=None):
    """(plan, counts): how many lanes store each (output row, group of 16
    columns, channel group), walking every block's tiles as the kernel
    does; asserts each tile's lanes and halo on the way."""
    n, h, w, cin = xs
    kh, kw, _, cout = ws
    p = (conv2d.plan(n, h, w, cin, kh, kw, cout) if warps is None else
         conv2d.plan_warps(n, h, w, cin, kh, kw, cout, conv2d.SMS, warps))
    groups = -(-cout // conv2d.CG)
    counts = torch.zeros((n * p.ho, p.g, groups), dtype=torch.int32)
    cgl, gw = _lanes(p)
    # the last float a lane reads past its group's first column: the
    # 16-byte reads of the slide (KW 3, 5, 7) or the scalar ones
    reach = (phys(-(-(conv2d.R + kw - 1) // 4) * 4 - 1) if kw in (3, 5, 7)
             else phys(conv2d.R + kw - 2))
    seen = set()
    for b in range(p.grid):
        cb, tiles = conv2d.block_tiles(p, b)
        assert len(tiles) >= 1, (b, p)
        for t in tiles:
            assert (cb, t) not in seen
            seen.add((cb, t))
            tl = conv2d.tile_of(p, t, n, w, kh, kw)
            q = tl.q0 + gw
            qc = q.clamp(max=tl.q1)           # tail lanes read a real row
            row, gl = qc // p.gt, qc % p.gt
            gcol = tl.ct * p.gt + gl
            cg = cb * p.cgb + cgl
            active = cg * conv2d.CG < cout
            store = (q <= tl.q1) & (gcol < p.g) & active
            assert bool(store.any()), ("a tile past the edge", t)
            # halo rows: every computing lane's KH rows are staged
            hrow = row + row // p.ho * (kh - 1) - tl.v0
            assert int(hrow.min()) >= 0
            assert int(hrow.max()) + kh <= tl.rows <= p.hr, (t, tl, p.hr)
            # halo columns: a stored output's taps are staged, and every
            # read stays inside the row stride
            ox_last = torch.clamp(gcol * conv2d.R + conv2d.R - 1,
                                  max=p.wo - 1)
            assert bool((ox_last[store] + kw <= tl.col0 + tl.width).all())
            assert phys(int(gl.max()) * conv2d.R) + reach < p.hwp
            assert tl.col0 + tl.width <= w
            counts.index_put_((row[store], gcol[store], cg[store]),
                              torch.ones((), dtype=torch.int32),
                              accumulate=True)
    return p, counts


@pytest.mark.parametrize("xs,ws", SHAPES, ids=[_id(c) for c in SHAPES])
def test_every_output_stored_once(xs, ws):
    """Each (row, group of 16 columns, channel group) of the output is
    stored by one lane of one block, over the whole grid's walk."""
    p, counts = _walk(xs, ws)
    assert bool((counts == 1).all()), (
        int((counts == 0).sum()), int((counts > 1).sum()), p)


WARPS_CASES = [(c, k) for c in SWEEP[1:] + [CUDA_CASES[3], GENERIC[2]]
               for k in (conv2d.WARPS, conv2d.SMALL_WARPS)]


@pytest.mark.parametrize("case,warps", WARPS_CASES,
                         ids=[f"{_id(c)}-{k}w" for c, k in WARPS_CASES])
def test_every_output_stored_once_any_warps(case, warps):
    """The same at both block sizes the kernel is built for, whichever
    ``plan`` would choose (``plan_warps``; ``tools/conv2d_variants.py``
    times both)."""
    p, counts = _walk(*case, warps=warps)
    assert p.nw == warps and p.tp * p.cgb == 32 * warps
    assert bool((counts == 1).all()), (
        int((counts == 0).sum()), int((counts > 1).sum()), p)


@pytest.mark.parametrize("xs,ws", SHAPES, ids=[_id(c) for c in SHAPES])
def test_plan_counts(xs, ws):
    """Shared memory as the kernel counts it, within the card's 227 KB, the
    weights and halo rows laid out for reads free of bank conflicts; the
    passes cover the input channels; the grid is whole channel blocks of
    at most an SM each, each with tiles, their counts within one of each
    other."""
    n, h, w, cin = xs
    kh, kw, _, cout = ws
    p = conv2d.plan(n, h, w, cin, kh, kw, cout)
    slots = conv2d.R * 32 * p.nw * conv2d.CG
    assert p.smem == 4 * ((2 if p.nchunk > 1 else 1) * p.w_floats
                          + 2 * p.x_floats + slots) <= MAX_SMEM
    assert p.tp * p.cgb == 32 * p.nw
    # 12 warps, or 4 when 12 would leave SMs idle
    big = conv2d.plan_warps(n, h, w, cin, kh, kw, cout, conv2d.SMS,
                            conv2d.WARPS)
    idle = big.tiles < conv2d.SMS // big.ncb
    assert p.nw == (conv2d.SMALL_WARPS if idle else conv2d.WARPS)
    assert p.w_floats == kh * p.cc * p.cgb * conv2d.wstride(kw)
    assert conv2d.wstride(kw) >= kw * conv2d.CG
    assert conv2d.wstride(kw) // 4 % 2 == 1    # 8 groups: 8 bank quads
    assert p.x_floats == p.cc * p.hr * p.hwp and p.hwp % 4 == 0
    assert p.hwp % 32 == phys(conv2d.R) * p.gt % 32
    assert p.cc * p.nchunk >= cin > p.cc * (p.nchunk - 1) >= 0
    assert p.cgb in (1, 2, 4, 8) and p.cgb * conv2d.CG * p.ncb >= cout
    assert p.grid % p.ncb == 0
    nbc = p.grid // p.ncb
    assert nbc == min(p.tiles, max(1, conv2d.SMS // p.ncb))
    walks = [len(conv2d.block_tiles(p, b)[1]) for b in range(p.grid)]
    assert min(walks) >= 1 and max(walks) - min(walks) <= 1
    assert sum(walks) == p.tiles * p.ncb


def test_card_shape_plan():
    """The card shape: one column tile of the 7 groups of a 106-column
    row, 8 channel groups of 4 a block (tiles of 48 groups) in 2 channel
    blocks, the weights resident (one pass), a block on each of the 132
    SMs, and at most 6% of the FMAs on outputs that do not exist."""
    (n, h, w, cin), (kh, kw, _, cout) = CARD
    p = conv2d.plan(n, h, w, cin, kh, kw, cout)
    assert (p.ho, p.g, p.gt, p.ct, p.cgb, p.ncb, p.tp) == (
        106, 7, 7, 1, 8, 2, 48)
    assert (p.cc, p.nchunk, p.hr, p.hwp) == (3, 1, 20, 172)
    assert p.tiles == -(-64 * 106 * 7 // 48) == 990
    assert p.grid == 132 and p.smem <= conv2d.SMEM_BUDGET
    computed = p.tiles * p.tp * conv2d.R * p.cgb * conv2d.CG * p.ncb
    assert computed / (n * p.ho * p.wo * cout) - 1 <= 0.06


def test_sweep_plan_puts_warps_on_pixels():
    """At Cout = 8 a block is two channel groups of 4, so a warp takes 16
    consecutive groups.  12-warp blocks would leave all but 1, 2 and 4 of
    the 132 SMs idle at hw 32, 64 and 112; the blocks shrink to 4 warps
    (one a scheduler, tiles of 64 groups), 1, 4 and 12 of them, and each
    stages all 3 channels at once."""
    grids = []
    for (n, h, w, cin), (kh, kw, _, cout) in SWEEP:
        p = conv2d.plan(n, h, w, cin, kh, kw, cout)
        assert (p.cgb, p.ncb, p.nw, p.tp, p.nchunk) == (2, 1, 4, 64, 1)
        assert conv2d.plan_warps(n, h, w, cin, kh, kw, cout, conv2d.SMS,
                                 12).grid == {32: 1, 64: 2, 112: 4}[h]
        grids.append(p.grid)
    assert grids == [1, 4, 12]
    with pytest.raises(ValueError, match="warps a block"):
        conv2d.plan_warps(1, 112, 112, 3, 7, 7, 8, conv2d.SMS, 8)


def test_plan_passes_and_budgets():
    """20 channels at 7 x 7 x 70 pass over the channels in even chunks
    (two weight buffers); the card shape's 3 channels stay resident, and
    the sweep's (two passes at 64 and 112 in 12-warp blocks, where 192
    groups span 35 to 55 halo rows); a 21 x 21 window over 4 channels
    takes a pass a channel; a window whose weights alone exceed 227 KB is
    refused."""
    p = conv2d.plan(1, 40, 37, 20, 7, 7, 70)
    assert p.nchunk > 1 and p.cc == -(-20 // p.nchunk)
    assert [conv2d.plan(1, hw, hw, 3, 7, 7, 8).nchunk
            for hw in (32, 64, 112)] == [1, 1, 1]
    assert [conv2d.plan_warps(1, hw, hw, 3, 7, 7, 8, conv2d.SMS, 12).nchunk
            for hw in (32, 64, 112)] == [1, 2, 2]
    p = conv2d.plan(1, 30, 30, 4, 21, 21, 64)
    assert p.nchunk == 4 and p.smem <= conv2d.SMEM_BUDGET
    with pytest.raises(ValueError, match="does not fit"):
        conv2d.plan(1, 41, 41, 1, 40, 40, 64)


def test_halo_rows_bound_is_reached():
    """``halo_rows`` is the most rows any tile stages, not more: some tile
    of a shape whose tiles cross image boundaries needs all of them."""
    n, h, w, cin, kh, kw, cout = 8, 12, 86, 3, 7, 7, 64
    p = conv2d.plan(n, h, w, cin, kh, kw, cout)
    rows = [conv2d.tile_of(p, t, n, w, kh, kw).rows for t in range(p.tiles)]
    assert max(rows) == p.hr


def _emulate(x, w, vec=True):
    """csrc/conv2d.cu's index arithmetic run sequentially in float64: the
    staging of each step into its halo (columns swizzled by ``phys``) and
    weight (``wstride`` floats a channel group) buffers of one flat shared
    memory, the slide over each lane's R + KW - 1 inputs and the stores
    (4 channels at a time with ``vec``, else one by one), block by block
    in the kernel's step order."""
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    p = conv2d.plan(n, h, wd, cin, kh, kw, cout)
    R, CG, wst = conv2d.R, conv2d.CG, conv2d.wstride(kw)
    xf, wf = x.double().reshape(-1), w.double().reshape(-1)
    y = torch.full((n * p.ho * p.wo * cout,), float("nan"),
                   dtype=torch.float64)
    nwb = 2 if p.nchunk > 1 else 1
    cgl, gw = _lanes(p)
    j = torch.arange(R)
    o = torch.arange(CG)
    ph = torch.tensor([phys(c) for c in range(R + kw)])
    for b in range(p.grid):
        cb, tiles = conv2d.block_tiles(p, b)
        sm = torch.zeros(nwb * p.w_floats + 2 * p.x_floats,
                         dtype=torch.float64)
        steps = [(t, c) for t in tiles for c in range(p.nchunk)]

        def stage(s):
            t, c = steps[s]
            tl = conv2d.tile_of(p, t, n, wd, kh, kw)
            c0 = c * p.cc
            cc = min(p.cc, cin - c0)
            xs = nwb * p.w_floats + (s & 1) * p.x_floats
            pix = torch.arange(tl.rows * tl.width)
            r, cx = pix // tl.width, pix % tl.width
            for ci in range(cc):
                src = ((tl.v0 + r) * wd + tl.col0 + cx) * cin + c0 + ci
                sm[xs + (ci * p.hr + r) * p.hwp + cx + (cx >> 4) * 4] = \
                    xf[src]
            if p.nchunk == 1 and s > 0:
                return
            ws = (s & 1) * p.w_floats if p.nchunk > 1 else 0
            e = torch.arange(kh * cc * p.cgb * kw * CG)
            rr = e // CG
            kx = rr % kw
            rr = rr // kw
            co = cb * p.cgb * CG + rr % p.cgb * CG + e % CG
            ci, ky = rr // p.cgb % cc, rr // p.cgb // cc
            ok = co < cout
            src = ((ky * kw + kx) * cin + c0 + ci) * cout + co
            sm[ws + rr * wst + kx * CG + e % CG] = torch.where(
                ok, wf[src.clamp(max=wf.numel() - 1)], 0.0)

        acc = torch.zeros((len(gw), R, CG), dtype=torch.float64)
        # the pending tile: each lane's parked outputs, y offset of its
        # first column and channel, columns that exist, next to store
        slots = torch.zeros_like(acc)
        pend_y = torch.zeros(len(gw), dtype=torch.long)
        pend_nj = torch.zeros(len(gw), dtype=torch.long)
        pend = [R]
        co0 = (cb * p.cgb + cgl) * CG

        def store_next():
            jn = pend[0]
            live = jn < pend_nj
            ok = live[:, None] & ((co0[:, None] + o < cout) | vec)
            dst = pend_y[:, None] + jn * cout + o
            assert bool(torch.isnan(y[dst[ok]]).all()), "stored twice"
            y[dst[ok]] = slots[:, jn][ok]
            pend[0] += 1

        stage(0)
        for s in range(len(steps)):
            if s + 1 < len(steps):
                stage(s + 1)
            t, c = steps[s]
            tl = conv2d.tile_of(p, t, n, wd, kh, kw)
            cc = min(p.cc, cin - c * p.cc)
            q = tl.q0 + gw
            qc = q.clamp(max=tl.q1)
            row = qc // p.gt
            gl = qc - row * p.gt
            hrow = row + row // p.ho * (kh - 1) - tl.v0
            xp = nwb * p.w_floats + (s & 1) * p.x_floats + hrow * p.hwp \
                + gl * R + gl * 4
            wp = ((s & 1) * p.w_floats if p.nchunk > 1 else 0) + cgl * wst
            for ky in range(kh):
                for ci in range(cc):
                    if pend[0] < R:
                        store_next()
                    xr = xp + ci * p.hr * p.hwp + ky * p.hwp
                    wr = wp + (ky * cc + ci) * p.cgb * wst
                    for kx in range(kw):
                        inp = sm[xr[:, None] + ph[j + kx]]    # (lanes, R)
                        wv = sm[wr[:, None] + kx * CG + o]   # (lanes, CG)
                        acc += inp[:, :, None] * wv[:, None, :]
            if c == p.nchunk - 1:
                while pend[0] < R:
                    store_next()
                ox0 = tl.col0 + gl * R
                pend_y = (row * p.wo + ox0) * cout + co0
                pend_nj = torch.where((q <= tl.q1) & (tl.ct * p.gt + gl < p.g)
                                      & (co0 < cout),
                                      (p.wo - ox0).clamp(max=R), 0)
                pend[0] = 0
                slots = acc.clone()
                acc.zero_()
        while pend[0] < R:
            store_next()
    return y.reshape(n, p.ho, p.wo, cout)


SMALL = CUDA_CASES + SWEEP[:1] + GENERIC + [((2, 13, 13, 3), (7, 7, 3, 64))]


@pytest.mark.parametrize("xs,ws", SMALL, ids=[_id(c) for c in SMALL])
def test_kernel_indexing_emulated(xs, ws):
    """The kernel's staging, slide and store indices, emulated, give the
    convolution (float64, against the tap-by-tap sum of the same values),
    with the stores the launch takes (4 channels at a time when Cout % 8
    == 0)."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(xs, generator=gen, dtype=torch.float64)
    w = torch.randn(ws, generator=gen, dtype=torch.float64)
    got = _emulate(x, w, vec=ws[3] % 8 == 0)
    kh, kw = ws[:2]
    want = sum(torch.einsum("nhwc,cd->nhwd",
                            x[:, ky:ky + got.shape[1], kx:kx + got.shape[2]],
                            w[ky, kx])
               for ky in range(kh) for kx in range(kw))
    assert not bool(torch.isnan(got).any())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
