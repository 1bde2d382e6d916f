"""fconv2d — valid 2-D convolution, NHWC x HWIO -> NHWC (paper §VI.A).

Port of ``repro/kernels/conv2d.py`` (``conv2d``, the Pallas kernel at :46).
Two versions of one function live here:

  * :func:`conv2d_plain` — the valid convolution in float32 as the TPU
    kernel shapes it, KH·KW shifted (pixels, Cin) x (Cin, Cout) products
    summed tap by tap, cast to ``x.dtype`` (the CPU path, and the oracle
    the CUDA kernel is held against; ``kernels/ref.py`` defines the same
    function with ``lax.conv_general_dilated``);
  * :func:`launch` — the hand-written CUDA kernel (``csrc/conv2d.cu``):
    persistent blocks with their weights resident in shared memory, each
    walking tiles of output pixel groups (16 consecutive columns x 4
    channels a thread, one fmaf chain an output) whose input halo arrives
    by cp.async while the tile before computes.

:func:`plan` sizes each launch (grid, shared memory, the tile walk, the
channel chunks) with the counts ``csrc/conv2d.cu`` uses, and
:func:`tile_of` / :func:`block_tiles` mirror the kernel's walk, so the CPU
tests can check the schedule.  ``ops.conv2d`` picks between the two
versions by the tensors' device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

NAME = "conv2d"
SOURCE = "src/repro_torch/kernels/csrc/conv2d.cu"
REPLACES = "src/repro/kernels/conv2d.py:46"
R = 16            # output columns a thread (csrc/conv2d.cu)
CG = 4            # output channels a thread
WARPS = 12        # warps a block
SMALL_WARPS = 4   # warps a block when WARPS leave SMs idle: one a scheduler
CGB_MAX = 8       # channel groups of CG a block at most
GT_MAX = 16       # groups of R columns a column tile: 256 columns
#: dynamic shared-memory bytes of the block an SM (beside its 40 static)
SMEM_BUDGET = 227 * 1024 - 64
SMS = 132         # the H100's SMs: the default of plan()

#: kernel launches through :func:`launch` (reset by the caller)
launches = 0


def _out_hw(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int]:
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d: x {tuple(x.shape)} (NHWC), w "
                         f"{tuple(w.shape)} (HWIO)")
    ho, wo = x.shape[1] - w.shape[0] + 1, x.shape[2] - w.shape[1] + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv2d: window {tuple(w.shape[:2])} larger than "
                         f"the image {tuple(x.shape[1:3])}")
    return ho, wo


def conv2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin), w (KH, KW, Cin, Cout) -> (N, Ho, Wo, Cout) in x's
    dtype, summed in float32."""
    ho, wo = _out_hw(x, w)
    kh, kw = w.shape[:2]
    xf, wf = x.float(), w.float()
    out = torch.zeros((x.shape[0], ho, wo, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for ky in range(kh):
        for kx in range(kw):
            out += xf[:, ky:ky + ho, kx:kx + wo, :] @ wf[ky, kx]
    return out.to(x.dtype)


def error_bound(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per output element, how far the kernel's float32 result may lie from
    :func:`conv2d_plain`'s before rounding to the output dtype:
    c 2^-24 sum |x w| over the window with c = KH KW Cin + KH KW + Cin —
    the kernel's one fmaf chain over the KH KW Cin terms, and the plain
    version's per-tap product over Cin (product rounding included) and
    its sum over the KH KW taps (first-order bounds, TF32 excluded)."""
    kh, kw, cin, _ = w.shape
    c = kh * kw * cin + kh * kw + cin
    return c * 2.0 ** -24 * conv2d_plain(x.float().abs(), w.float().abs())


class Plan(NamedTuple):
    """One launch of ``csrc/conv2d.cu``: its ``Args``, in its names.  The
    kernel takes every count from here and only checks their ranges and
    that its shared-memory layout fits ``smem``."""
    ho: int
    wo: int
    g: int          # groups of R columns in an output row
    gt: int         # groups a row of a column tile
    ct: int         # column tiles
    cgb: int        # channel groups of CG a block: 1, 2, 4 or 8
    ncb: int        # channel blocks
    nw: int         # warps a block
    tp: int         # groups a tile: 32 nw / cgb
    tiles_ct: int   # tiles a column tile
    tiles: int      # tiles in all
    cc: int         # input channels a pass
    nchunk: int     # passes
    hr: int         # halo rows a buffer
    hwp: int        # halo row stride, floats (columns swizzled: phys)
    w_floats: int   # one weight buffer
    x_floats: int   # one halo buffer
    smem: int       # bytes: one weight buffer (two with passes), two
                    # halos, the slots of each lane's R x CG outputs
    grid: int       # blocks: ncb x blocks a channel block


def phys(c: int) -> int:
    """Where a halo row's column ``c`` lies in shared memory: each 16
    columns take 20 floats (csrc/conv2d.cu ``phys``)."""
    return c + (c >> 4) * 4


def wstride(kw: int) -> int:
    """Floats a channel group's ``kw`` taps of CG weights take in shared
    memory: an odd number of float4s (csrc/conv2d.cu ``wstride``)."""
    return (kw + 1 - kw % 2) * 4


def halo_stride(gt: int, kw: int) -> int:
    """Floats a halo row takes: its logical columns (``gt`` groups and
    the window's overhang, whole float4s) in swizzled blocks of 16, then
    the least more that keeps the rows of consecutive groups 20 floats
    apart mod 32."""
    lw = gt * R + -(-(kw - 1) // 4) * 4
    hw = -(-lw // R) * phys(R)
    return hw + (phys(R) * gt - hw) % 32


def halo_rows(n: int, ho: int, kh: int, gt: int, tp: int) -> int:
    """Input rows a tile of ``tp`` consecutive groups (``gt`` a row) can
    need: the output rows it touches, the KH - 1 rows below the last, and
    KH - 1 more for each image boundary it crosses (x seen as N H rows)."""
    span = min(-(-(tp - 1) // gt) + 1, n * ho)
    cross = min(span - 1, n - 1, -(-(span - 1) // ho))
    return span - 1 + cross * (kh - 1) + kh


def plan(n: int, h: int, w: int, cin: int, kh: int, kw: int, cout: int,
         sms: int = SMS) -> Plan:
    """The launch of an (n, h, w, cin) x (kh, kw, cin, cout) convolution on
    ``sms`` SMs: :func:`plan_warps` at WARPS warps a block, or at
    SMALL_WARPS when a channel block would have fewer tiles of WARPS than
    there are SMs (one warp a scheduler then beats three on a few SMs)."""
    p = plan_warps(n, h, w, cin, kh, kw, cout, sms, WARPS)
    if p.tiles < sms // p.ncb:
        p = plan_warps(n, h, w, cin, kh, kw, cout, sms, SMALL_WARPS)
    return p


def plan_warps(n: int, h: int, w: int, cin: int, kh: int, kw: int,
               cout: int, sms: int, nw: int) -> Plan:
    """The launch at ``nw`` warps a block (WARPS or SMALL_WARPS, the two
    the kernel is built for): the widest column tile (at most GT_MAX
    groups, halved until a channel fits) and the most input channels a
    pass whose shared memory fits the block an SM, the passes evened out;
    an SM per channel block's block, no more than there are tiles.
    Raises ``ValueError`` when not even one channel of a one-group tile
    fits."""
    if cin < 1:
        raise ValueError("conv2d: the kernel needs at least one input "
                         "channel")
    if nw not in (WARPS, SMALL_WARPS):
        raise ValueError(f"conv2d: {nw} warps a block, not {WARPS} or "
                         f"{SMALL_WARPS}")
    ho, wo = h - kh + 1, w - kw + 1
    g = -(-wo // R)
    groups = -(-cout // CG)
    cgb = 1
    while cgb < groups and cgb < CGB_MAX:
        cgb *= 2
    ncb = -(-groups // cgb)
    tp = nw * 32 // cgb
    slots = R * 32 * nw * CG
    gt = min(g, GT_MAX)
    while True:
        hr, hwp = halo_rows(n, ho, kh, gt, tp), halo_stride(gt, kw)
        wf1, xf1 = kh * cgb * wstride(kw), hr * hwp  # a channel's floats
        room = SMEM_BUDGET // 4 - slots
        if cin * (wf1 + 2 * xf1) <= room:
            cc = cin
            break
        cc = min(cin, max(0, room) // (2 * (wf1 + xf1)))
        if cc >= 1:
            break
        if gt == 1:
            raise ValueError(f"conv2d: a {kh} x {kw} window does not fit "
                             f"the kernel's shared memory")
        gt //= 2
    nchunk = -(-cin // cc)
    cc = -(-cin // nchunk)                 # even passes, no more of them
    ct = -(-g // gt)
    tiles_ct = -(-(n * ho * gt) // tp)
    tiles = ct * tiles_ct
    w_floats, x_floats = kh * cc * cgb * wstride(kw), cc * hr * hwp
    smem = 4 * ((2 if nchunk > 1 else 1) * w_floats + 2 * x_floats + slots)
    nbc = min(tiles, max(1, sms // ncb))
    return Plan(ho, wo, g, gt, ct, cgb, ncb, nw, tp, tiles_ct, tiles, cc,
                nchunk, hr, hwp, w_floats, x_floats, smem, ncb * nbc)


class Tile(NamedTuple):
    """Where tile ``t`` lies (``tile_of`` in csrc/conv2d.cu): its groups
    q0 .. q1 of column tile ct, its halo the input rows v0 .. v0 + rows - 1
    of the N H and the columns col0 .. col0 + width - 1."""
    ct: int
    q0: int
    q1: int
    v0: int
    rows: int
    col0: int
    width: int


def tile_of(p: Plan, t: int, n: int, w: int, kh: int, kw: int) -> Tile:
    ct = t // p.tiles_ct
    q0 = (t - ct * p.tiles_ct) * p.tp
    q1 = min(q0 + p.tp, n * p.ho * p.gt) - 1
    row0, row1 = q0 // p.gt, q1 // p.gt
    v0 = row0 + row0 // p.ho * (kh - 1)
    rows = row1 + row1 // p.ho * (kh - 1) + kh - v0
    col0 = ct * p.gt * R
    return Tile(ct, q0, q1, v0, rows, col0, min(p.gt * R + kw - 1, w - col0))


def block_tiles(p: Plan, b: int) -> tuple[int, range]:
    """Block ``b``'s channel block and the tiles it walks, in order."""
    nbc = p.grid // p.ncb
    return b % p.ncb, range(b // p.ncb, p.tiles, nbc)


_ARGS = [_build.I, _build.P, _build.P, _build.P] + [_build.I] * 20 + [
    _build.LL, _build.I, _build.P]


def launch_args(p: Plan) -> tuple[int, ...]:
    """The plan's counts as ``conv2d_launch`` takes them, after the
    shape: GT .. x_floats, then the grid and the shared-memory bytes."""
    return (p.gt, p.cgb, p.ncb, p.nw, p.tiles_ct, p.tiles, p.cc, p.nchunk,
            p.hr, p.hwp, p.w_floats, p.x_floats, p.grid, p.smem)


_SMS: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CUDA kernel.  x (N, H, W, Cin), w (KH, KW, Cin, Cout), both float32
    or both bfloat16.  Returns (N, Ho, Wo, Cout) in x's dtype."""
    global launches
    _build.require_cuda(NAME, x, w)
    ho, wo = _out_hw(x, w)
    dt = _build.dtype_code(x, w)
    x, w = x.contiguous(), w.contiguous()
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    _build.int32_sizes(NAME, n, h, wd, cin, cout)
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    if n == 0 or cout == 0:
        return y
    p = plan(n, h, wd, cin, kh, kw, cout, _sm_count(x.device))
    _build.int32_sizes(NAME, n * ho * p.gt, p.tiles)
    vec = int(cout % 8 == 0 and y.data_ptr() % 16 == 0)
    fn = _build.bind(NAME, "conv2d_launch", _ARGS)
    code = fn(dt, _build.ptr(x), _build.ptr(w), _build.ptr(y), n, h, wd,
              cin, kh, kw, cout, *launch_args(p), vec, _build.stream_of(x))
    launches += 1
    _build.check(code, NAME)
    return y
