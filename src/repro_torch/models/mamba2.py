"""Mamba2 (SSD) layer and the ssm family's layer set [arXiv:2405.21060].

Port of ``repro/models/mamba2.py``: ``mamba_params_init`` (:23),
``_causal_depthwise_conv`` (:51), ``mamba_apply`` (:69),
``mamba_decode_step`` (:160) and the layer plumbing (:213-335).  Layer:
in-proj -> depthwise causal conv(4) on (x, B, C) -> SSD -> gated RMSNorm ->
out-proj.  Serving keeps an O(N·P) recurrent state per head and a W-1 row
conv tail per slot, no KV rows:

    arena {"ssm": (L, slots·nh, N, P) f32, "conv": (L, slots, W-1, di+2gn)}

Where the reference's layers emit the new state and a scatter writes the
arena after the layer scan (``ssm_chunk_scatter`` / ``ssm_rows_scatter``),
each layer here writes its own arena slice in place: the chunk layer the
slot's fused head rows, the decode layer every live slot's state, masked so
that a parked slot (``pos == PARKED_POS``) comes out bit-identical.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import LayerSet, stack_layers


def _dims(cfg):
    s = cfg.ssm
    d = cfg.d_model
    return s, d, s.d_inner(d), s.n_heads(d), s.n_groups * s.d_state


def mamba_params_init(cfg, gen, dev) -> dict:
    """Stacked (L, ...) Mamba2 parameters with the reference's
    distributions: projections N(0, 1) d^-1/2, conv N(0, 1) 0.1, w_out
    N(0, 1) di^-1/2, A_log 0, D 1, dt_bias the inverse softplus of dt ~
    exp(U(log 1e-3, log 1e-1)).  A_log, dt_bias and D are float32 whatever
    the param dtype (reference :42-44)."""
    s, d, di, nh, gn = _dims(cfg)
    pd, nl = cfg.pdtype, cfg.n_layers

    def normal(shape, std):
        return stack_layers(nl, lambda: L._normal(gen, shape, std, pd, dev),
                            dev)

    def dt_bias():
        u = torch.rand((nh,), generator=gen, dtype=torch.float32,
                       device=dev)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))

    sc = d ** -0.5
    return {
        "w_z": normal((d, di), sc),
        "w_x": normal((d, di), sc),
        "w_B": normal((d, gn), sc),
        "w_C": normal((d, gn), sc),
        "w_dt": normal((d, nh), sc),
        "conv": normal((s.conv_width, di + 2 * gn), 0.1),
        "A_log": torch.zeros((nl, nh), dtype=torch.float32, device=dev),
        "dt_bias": stack_layers(nl, dt_bias, dev),
        "D": torch.ones((nl, nh), dtype=torch.float32, device=dev),
        "norm": {"scale": torch.ones((nl, di), dtype=pd, device=dev)},
        "w_out": normal((di, d), di ** -0.5),
    }


def _causal_depthwise_conv(x, w, tail=None):
    """x: (B, S, C), w: (W, C) — causal depthwise conv along S, f32 sums.
    ``tail``: optional (B, W-1, C) raw channel inputs preceding ``x``
    (a chunked caller's stored conv state); None = zero history."""
    wlen = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, wlen - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(wlen):
        out = out + xp[:, i:i + x.shape[1]].float() * w[i].float()
    return out.to(x.dtype)


def _group_rows(t, b, seq, groups, n):
    """(B, S, G·N) -> (B·G, S, N): row bi·G + g serves heads g·nh/G ..
    (g+1)·nh/G - 1 of batch row bi, which ``ops.ssd`` reads in place (the
    reference broadcasts it to every head first, mamba2.py:120-125)."""
    return t.reshape(b, seq, groups, n).transpose(1, 2).reshape(
        b * groups, seq, n)


def mamba_apply(p, cfg, x, *, kops=ops, initial_state=None, conv_tail=None,
                nvalid=None, return_state: bool = False):
    """x: (B, S, d) -> y (B, S, d) [+ (ssm_state, conv_tail)].

    ``initial_state`` (B·nh, N, P) and ``conv_tail`` (B, W-1, di+2gn raw
    pre-conv inputs) carry the recurrence across prompt chunks (None at
    sequence start, the same as zeros).  ``nvalid`` (a host int or a 0-d
    int device tensor, read on the device; None = S) marks the first
    ``nvalid`` positions as real: pad positions get x̄ = 0 and decay 1, so
    the returned state is the state after the real tokens alone.  The
    returned conv tail is the last W-1 raw inputs ending at ``nvalid``,
    drawn from [tail ; chunk], so a chunk with fewer than W-1 real tokens
    pulls the rest from the stored tail.
    """
    s, d, di, nh, gn = _dims(cfg)
    b, seq, _ = x.shape
    hd, n = s.headdim, s.d_state
    adt = cfg.adtype

    z = L._dot(x, p["w_z"], adt)                          # (B, S, di)
    xin = L._dot(x, p["w_x"], adt)
    Bv = L._dot(x, p["w_B"], adt)
    Cv = L._dot(x, p["w_C"], adt)
    dt = x.float() @ p["w_dt"].float()

    xbc_raw = torch.cat([xin, Bv, Cv], dim=-1)
    xbc = F.silu(_causal_depthwise_conv(xbc_raw, p["conv"], conv_tail)
                 .float()).to(adt)
    xin, Bv, Cv = torch.split(xbc, [di, gn, gn], dim=-1)

    dt = F.softplus(dt + p["dt_bias"])                    # (B, S, nh) f32
    A = -torch.exp(p["A_log"])                            # (nh,)
    log_a = dt * A                                        # (B, S, nh)

    # head split; fold dt into x (x̄ = dt * x)
    xh = xin.reshape(b, seq, nh, hd).float() * dt[..., None]
    if nvalid is not None:
        live = (torch.arange(seq, device=x.device) < nvalid).float()
        xh = xh * live[None, :, None, None]
        log_a = log_a * live[None, :, None]

    y, state = kops.ssd(
        xh.transpose(1, 2).reshape(b * nh, seq, hd).to(adt),
        log_a.transpose(1, 2).reshape(b * nh, seq),
        _group_rows(Bv, b, seq, s.n_groups, n),
        _group_rows(Cv, b, seq, s.n_groups, n),
        chunk=s.chunk, initial_state=initial_state)
    y = y.reshape(b, nh, seq, hd).transpose(1, 2).float()
    y = y + p["D"][None, None, :, None] * xh              # skip connection
    y = y.reshape(b, seq, di).to(adt)

    y = L.rmsnorm(p["norm"], y * F.silu(z.float()).to(adt), cfg.rms_eps)
    out = L._dot(y, p["w_out"], adt)
    if not return_state:
        return out
    wtail = s.conv_width - 1
    hist = (F.pad(xbc_raw, (0, 0, wtail, 0)) if conv_tail is None
            else torch.cat([conv_tail.to(xbc_raw.dtype), xbc_raw], dim=1))
    end = seq if nvalid is None else nvalid
    rows = end + torch.arange(wtail, device=x.device)
    return out, (state, hist.index_select(1, rows))


def mamba_decode_step(p, cfg, x_t, cache, *, kops=ops):
    """One-token recurrence.  x_t: (B, d); cache: {"ssm": (B·nh, N, P),
    "conv": (B, W-1, di+2gn)}.  Returns (out (B, d), {"ssm", "conv"} new
    state); the cache is not written."""
    s, d, di, nh, gn = _dims(cfg)
    b = x_t.shape[0]
    hd, n, g = s.headdim, s.d_state, s.n_groups
    adt = cfg.adtype

    z = L._dot(x_t, p["w_z"], adt)
    xin = L._dot(x_t, p["w_x"], adt)
    Bv = L._dot(x_t, p["w_B"], adt)
    Cv = L._dot(x_t, p["w_C"], adt)
    dt = x_t.float() @ p["w_dt"].float()

    xbc_t = torch.cat([xin, Bv, Cv], dim=-1)              # (B, di+2gn)
    hist = torch.cat([cache["conv"], xbc_t[:, None]], dim=1)
    conv_out = (hist.float() * p["conv"][None].float()).sum(dim=1)
    xbc = F.silu(conv_out).to(adt)
    xin, Bv, Cv = torch.split(xbc, [di, gn, gn], dim=-1)

    dt = F.softplus(dt + p["dt_bias"])                    # (B, nh)
    A = -torch.exp(p["A_log"])
    log_a = (dt * A).reshape(b * nh)
    xh = (xin.reshape(b, nh, hd).float() * dt[..., None]).reshape(b * nh, hd)

    def heads(t):      # (B, G·N) -> (B·nh, N): head h reads group h // (nh/G)
        return t.reshape(b, g, 1, n).expand(b, g, nh // g, n).reshape(
            b * nh, n)

    y, new_state = kops.ssd_decode_step(xh.to(adt), log_a, heads(Bv),
                                        heads(Cv), cache["ssm"])
    y = y.reshape(b, nh, hd).float() \
        + p["D"][None, :, None] * xh.reshape(b, nh, hd)
    y = y.reshape(b, di).to(adt)
    y = L.rmsnorm(p["norm"], y * F.silu(z.float()).to(adt), cfg.rms_eps)
    out = L._dot(y, p["w_out"], adt)
    return out, {"ssm": new_state, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# layer plumbing for the LM driver
# ---------------------------------------------------------------------------

def ssm_layer_init(cfg, gen, dev) -> dict:
    ln = {"scale": torch.ones((cfg.n_layers, cfg.d_model), dtype=cfg.pdtype,
                              device=dev)}
    return {"ln": ln, "mamba": mamba_params_init(cfg, gen, dev)}


def init_ssm_cache(cfg, batch: int, max_seq: int, kv_format: str,
                   device) -> dict:
    """Stacked {"ssm": (L, batch·nh, N, P) f32, "conv": (L, batch, W-1,
    di+2gn) adtype}; ``max_seq`` is unused (the state has no sequence
    axis).  Recurrent state stays full precision: ``LM.init_cache`` admits
    only the fp32 format."""
    del max_seq, kv_format
    s, d, di, nh, gn = _dims(cfg)
    nl = cfg.n_layers
    return {
        "ssm": torch.zeros((nl, batch * nh, s.d_state, s.headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((nl, batch, s.conv_width - 1, di + 2 * gn),
                            dtype=cfg.adtype, device=device),
    }


def ssm_prefill_branch(p_mamba, cfg, h, view_l, *, kops=ops):
    """The SSD branch of a monolithic prefill over normed input ``h``: its
    final state and conv tail go into the (slot's) arena view's "ssm" /
    "conv" leaves in place.  Returns the branch output."""
    y, (state, tail) = mamba_apply(p_mamba, cfg, h, kops=kops,
                                   return_state=True)
    view_l["ssm"].copy_(state)
    view_l["conv"].copy_(tail)
    return y


def ssm_prefill_layer(p, cfg, x, view_l, positions, *, kops=ops):
    """Monolithic prefill: the layer's final state and conv tail go into
    the (slot's) arena view in place."""
    del positions
    h = L.rmsnorm(p["ln"], x, cfg.rms_eps)
    return x + ssm_prefill_branch(p["mamba"], cfg, h, view_l, kops=kops)


def _by_slot(layer_l):
    """A layer's arena leaves with the slot as their leading axis: ssm
    (slots, nh, N, P) and conv (slots, W-1, di+2gn), views."""
    ssm, conv = layer_l["ssm"], layer_l["conv"]
    return ssm.view(conv.shape[0], -1, *ssm.shape[1:]), conv


def chunk_carry(layer_l, slot, start):
    """The SSD carry-in for a prompt chunk at ``start`` into arena slot
    ``slot`` (reference :268), gathered by device index: the slot's
    threaded (state (nh, N, P), conv tail (1, W-1, di+2gn)) on a
    continuation chunk, zeros on the first.  The reset is a select on
    ``start > 0``, not a multiply, so a previous occupant's NaN does not
    survive it; it is load-bearing, since a slot's previous occupant
    leaves its state behind and a preemption replay restarts at start 0.
    Returns (state0, tail0, the slot's stored (state, tail))."""
    ssm, conv = _by_slot(layer_l)
    stored = (ssm.index_select(0, slot.view(1))[0],
              conv.index_select(0, slot.view(1)))
    go = start > 0
    return (torch.where(go, stored[0], 0.0), torch.where(go, stored[1], 0),
            stored)


def ssm_chunk_branch(p_mamba, cfg, h, layer_l, slot, start, nvalid, *,
                     kops=ops):
    """The SSD branch of one prompt chunk over normed input ``h`` into
    arena slot ``slot`` of the layer's "ssm" (N·nh, N, P) / "conv" (N,
    W-1, di+2gn) leaves: the carried state and conv tail are written back
    by device index (the reference's ``ssm_chunk_scatter``, :303),
    keep-masked on ``start < PARKED_POS`` as :func:`ssm_rows_write` masks
    a parked decode slot, so a parked chunk (the captured step's warm-up)
    writes the old values back.  ``nvalid`` keeps the final chunk's
    padding out of the recurrence.  The ssd kernel always gets an initial
    state (zeros on the first chunk), as in the reference.  Returns the
    branch output."""
    state0, tail0, stored = chunk_carry(layer_l, slot, start)
    y, (state, tail) = mamba_apply(p_mamba, cfg, h, kops=kops,
                                   initial_state=state0, conv_tail=tail0,
                                   nvalid=nvalid, return_state=True)
    live = start < L.PARKED_POS
    ssm, conv = _by_slot(layer_l)
    ssm.index_copy_(0, slot.view(1),
                    torch.where(live, state, stored[0])[None])
    conv.index_copy_(0, slot.view(1),
                     torch.where(live, tail.to(conv.dtype), stored[1]))
    return y


def ssm_layer_chunk(p, cfg, x, layer_l, slot, positions, start, nvalid,
                    prefix, *, kops=ops, share=None):
    """One prompt chunk through an SSM layer (reference :283) into arena
    slot ``slot`` (:func:`ssm_chunk_branch`).  ``share`` is unused: the
    state has no sequence axis, so a fork's share of it was spliced into
    the slot before its first chunk (at ``start = share_len > 0``, which
    :func:`chunk_carry` carries)."""
    del positions, prefix, share
    h = L.rmsnorm(p["ln"], x, cfg.rms_eps)
    return x + ssm_chunk_branch(p["mamba"], cfg, h, layer_l, slot, start,
                                nvalid, kops=kops)


def ssm_rows_write(view_l, new, pos) -> None:
    """Write one decode step's new state (``new``: {"ssm", "conv"}) into
    the layer's arena slice in place, keep-masked per slot (reference
    ``ssm_rows_scatter``, :247): the state is not position-addressed, so a
    parked slot (pos == PARKED_POS, mid-chunked-prefill) must keep the
    state its chunks are threading, bit for bit."""
    b = pos.shape[0]
    live = pos < L.PARKED_POS
    for key, val in new.items():
        leaf = view_l[key]
        f = leaf.shape[0] // b
        m = live.repeat_interleave(f).reshape((b * f,) + (1,) * (leaf.ndim - 1))
        leaf.copy_(torch.where(m, val.to(leaf.dtype), leaf))


def ssm_decode_branch(p_mamba, cfg, h, view_l, pos, *, kops=ops):
    """The SSD branch of one decode step over normed input ``h`` against
    the layer's "ssm" / "conv" leaves, its new state written back in
    place (:func:`ssm_rows_write`).  Returns the branch output."""
    y, new = mamba_decode_step(p_mamba, cfg, h, view_l, kops=kops)
    ssm_rows_write(view_l, new, pos)
    return y


def ssm_layer_decode_rows(p, cfg, x_t, view_l, pos, *, kops=ops,
                          share=None):
    """One decode step through an SSM layer (reference :226); ``share`` is
    unused (no sequence axis)."""
    del share
    h = L.rmsnorm(p["ln"], x_t, cfg.rms_eps)
    return x_t + ssm_decode_branch(p["mamba"], cfg, h, view_l, pos,
                                   kops=kops)


def ssm_train_layer(p, cfg, x, positions, *, kops=ops):
    """One SSM layer of the training forward (reference
    ``ssm_layer_apply``, :221): rmsnorm, ``mamba_apply`` from a zero state
    with no state returned, the residual.  With a gradient the scan goes
    through ``ops._SSD`` (on the card the ``ssd`` and ``ssd_bwd``
    kernels).  Returns (x, aux = 0)."""
    del positions
    h = L.rmsnorm(p["ln"], x, cfg.rms_eps)
    return (x + mamba_apply(p["mamba"], cfg, h, kops=kops),
            x.new_zeros((), dtype=torch.float32))


def _factors(cfg) -> dict:
    return {"ssm": cfg.ssm.n_heads(cfg.d_model), "conv": 1}


#: the ssm family: per-slot SSD state + conv tail, the ``ssd`` kernel
#: (and ``ssd_bwd`` in training)
SSM = LayerSet(
    init_params=ssm_layer_init, init_cache=init_ssm_cache,
    factors=_factors, prefill_layer=ssm_prefill_layer,
    chunk_layer=ssm_layer_chunk, decode_layer=ssm_layer_decode_rows,
    train_layer=ssm_train_layer)
