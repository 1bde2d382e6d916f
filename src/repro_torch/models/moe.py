"""Mixture-of-Experts layer with capacity predication and the moe family's
layer set.

Port of ``repro/models/moe.py``: ``moe_mlp_init`` (:31), the global
dispatch ``_moe_mlp_global`` (:117) as :func:`moe_mlp_apply`, and the
serving layer functions ``moe_prefill_layer`` / ``moe_layer_chunk`` /
``moe_layer_decode_rows`` (:212-270).  The reference computes the layer in
plain ``jnp`` with no Pallas kernel, so it is plain PyTorch here, the
expert products ``torch.bmm``.  Per layer:

  1. routing (:func:`route`): f32 router logits, softmax, the top-k of
     the probabilities (ties to the lower expert index, as
     ``jax.lax.top_k``), gates renormalised over the k;
  2. dispatch (:func:`dispatch`): each (token, choice) pair, token-major,
     takes the next free row of its expert's ``cap`` rows (an exclusive
     cumsum over the one-hot); a pair that finds none is dropped and
     contributes nothing.  ``cap = max(int(k t capacity_factor / E), 1)``
     over every row that enters the layer: a chunk's pad rows and the
     decode batch's parked and dead slots compete for capacity too;
  3. the experts on the dense (E, cap, d) buffer, gate and up products in
     f32, ``silu(g) * u`` rounded to the activation dtype once;
  4. combine: each token's k weighted rows summed in f32 in choice order;
  5. the shared experts (if any) times a sigmoid gate, added in f32.

Every shape comes from t, k, E and cap, and nothing reads a value on the
host, so the captured decode and chunk steps hold the layer as they hold
the dense MLP.  Capacity couples the rows of one dispatch: under a
binding capacity a token's output depends on its batch-mates (the
reference's caveat, :232-238, :256-262); with ``capacity_factor >=
n_experts / top_k`` nothing is dropped and every token's output is its
own.

Left out: the reference's ``MOE_DISPATCH = "local"`` (a ``shard_map``
over data shards, :58-114), which needs the multi-device port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def moe_mlp_init(cfg, gen, dev) -> dict:
    """Stacked (L, ...) MoE parameters with the reference's distributions
    (:31): the router (L, d, E) N(0, 1) d^-1/2 in f32 whatever the param
    dtype; the experts' ``w_gate`` / ``w_up`` (L, E, d, f) N(0, 1) d^-1/2
    and ``w_down`` (L, E, f, d) N(0, 1) f^-1/2; with shared experts their
    gated MLP ``shared`` (d -> d_ff_shared) and ``shared_gate`` (L, d, 1)
    N(0, 1) d^-1/2."""
    me, d, nl, pd = cfg.moe, cfg.d_model, cfg.n_layers, cfg.pdtype
    e, f = me.n_experts, me.d_ff_expert

    def normal(shape, std, dtype=pd):
        return T.stack_layers(
            nl, lambda: L._normal(gen, shape, std, dtype, dev), dev)

    p = {"router": normal((d, e), d ** -0.5, torch.float32),
         "experts": {"w_gate": normal((e, d, f), d ** -0.5),
                     "w_up": normal((e, d, f), d ** -0.5),
                     "w_down": normal((e, f, d), f ** -0.5)}}
    if me.n_shared_experts:
        fs = me.d_ff_shared
        p["shared"] = {"w_up": normal((d, fs), d ** -0.5),
                       "w_down": normal((fs, d), fs ** -0.5),
                       "w_gate": normal((d, fs), d ** -0.5)}
        p["shared_gate"] = normal((d, 1), d ** -0.5)
    return p


def route(p: dict, cfg, xf: torch.Tensor):
    """Routing of ``xf`` (T, d) (reference :126-137): returns (gates (T, k)
    f32, expert indices (T, k) int64, aux loss (0-d f32)).

    Logits ``f32(x) @ router`` in f32, softmax in f32, the top-k of the
    probabilities by a stable descending sort (equal probabilities keep
    the lower expert first, ``jax.lax.top_k``'s order, which fixes every
    later capacity position), gates divided by ``max(sum, 1e-9)``.  The aux
    loss is the Switch load balance over each token's first choice plus
    the router z-loss; only training reads it."""
    me = cfg.moe
    e, k = me.n_experts, me.top_k
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :k], top.indices[:, :k]
    # the k-term sum left to right, XLA's order for so few terms
    gates = gates / torch.clamp(L._seq_sum(gates), min=1e-9)[:, None]
    first = (idx[:, :1] == torch.arange(e, device=xf.device)).float()
    aux = me.router_aux_weight * e * torch.sum(first.mean(0)
                                               * probs.mean(0))
    zloss = me.router_z_weight * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return gates, idx, aux + zloss


def capacity(cfg, t: int) -> int:
    """Rows per expert for a dispatch of ``t`` tokens (reference :145)."""
    me = cfg.moe
    return max(int(me.top_k * t * me.capacity_factor / me.n_experts), 1)


def dispatch(idx: torch.Tensor, e: int, cap: int):
    """Capacity positions of the (T, k) expert choices ``idx`` (reference
    :140-147): flattened token-major, pair i takes row ``pos[i]`` of its
    expert, the number of earlier pairs that chose the same expert (an
    exclusive cumsum over the one-hot), and is kept iff ``pos < cap``.
    Returns (slot (T·k,): ``expert · cap + pos`` for a kept pair, the
    overflow row ``E · cap`` for a dropped one; keep (T·k,) bool)."""
    flat = idx.reshape(-1)
    onehot = (flat[:, None] == torch.arange(e, device=idx.device)).to(
        torch.int32)
    before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = before.gather(1, flat[:, None])[:, 0].long()
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos, e * cap)
    return slot, keep


def _expert_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched (E, C, i) @ (E, i, o) -> f32 (the reference's einsum with
    ``preferred_element_type=f32``): f32 operands multiply in f32; on the
    card bf16 operands go through the f32-out bf16 GEMM, which reads the
    expert weights as they are stored; on the CPU they are upcast."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(a, w)
    if a.device.type == "cpu" or (torch.is_grad_enabled()
                                   and (a.requires_grad or w.requires_grad)):
        # training upcasts on the card too: the f32-out GEMM has no
        # gradient formula
        return torch.bmm(a.float(), w.float())
    return torch.bmm(a, w, out_dtype=torch.float32)


def combine(rows: torch.Tensor, gates: torch.Tensor, slot: torch.Tensor,
            keep: torch.Tensor, adt) -> torch.Tensor:
    """The weighted combine (reference :174-179): pair i of token i // k
    contributes ``rows[slot_i] * gate_i`` (a product in ``adt``; a dropped
    pair reads row 0 with gate 0), and each token's k contributions are
    summed in f32 from zero in choice order j = 0 .. k-1, the order in
    which the reference's scatter-add applies them.  A fixed order with no
    atomics, so the sum does not vary from run to run.  rows: (E·cap, d);
    gates: (T, k) f32; slot / keep: (T·k,).  Returns (T, d) f32."""
    t, k = gates.shape
    flat_gate = gates.reshape(-1) * keep
    contrib = rows[torch.where(keep, slot, 0)] * flat_gate[:, None].to(adt)
    y = torch.zeros((t, rows.shape[1]), dtype=torch.float32,
                    device=rows.device)
    for j in range(k):
        y = y + contrib[j::k].float()
    return y


def moe_mlp_apply(p: dict, cfg, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d) at the activation dtype, aux loss): the
    reference's global dispatch over all B·S rows of ``x`` (:117-190)."""
    me, adt = cfg.moe, cfg.adtype
    b, s, d = x.shape
    t, e, k = b * s, me.n_experts, me.top_k
    xf = x.reshape(t, d)
    gates, idx, aux = route(p, cfg, xf)
    cap = capacity(cfg, t)
    slot, keep = dispatch(idx, e, cap)

    # gather into the (E, cap, d) buffer; an empty row reads the zero row t
    token_of = torch.arange(t * k, device=x.device) // k
    buf_tok = torch.full((e * cap + 1,), t, dtype=torch.int64,
                         device=x.device)
    buf_tok.scatter_(0, slot, torch.where(keep, token_of, t))
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    xe = xf_pad[buf_tok[:-1]].reshape(e, cap, d)

    # the experts: gate and up in f32, silu(g) * u rounded once
    we = p["experts"]
    hg = _expert_dot(xe, we["w_gate"])
    hu = _expert_dot(xe, we["w_up"])
    h = (F.silu(hg) * hu).to(adt)
    ye = _expert_dot(h, we["w_down"]).to(adt)

    y = combine(ye.reshape(e * cap, d), gates, slot, keep, adt)
    if me.n_shared_experts:
        sh = L.mlp(p["shared"], cfg, xf, act="silu_gated")
        sgate = torch.sigmoid(xf.float() @ p["shared_gate"].float())
        y = y + sh.float() * sgate
    return y.to(adt).reshape(b, s, d), aux


def moe_layer_init(cfg, gen, dev) -> dict:
    """The stacked moe layer tree (reference :193): the dense layer's
    ``ln1`` / ``attn`` / ``ln2`` and ``moe`` in place of its MLP."""
    tree = T._dense_init_params(cfg, gen, dev, mlp=False)
    tree["moe"] = moe_mlp_init(cfg, gen, dev)
    return tree


def _mlp_residual(p, cfg, x):
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    y, _ = moe_mlp_apply(p["moe"], cfg, h)
    return x + y


def moe_train_layer(p, cfg, x, positions, *, kops=ops):
    """One moe layer of the training forward (reference ``moe_layer_apply``,
    :203-209): causal attention with no cache, then the expert MLP over
    all B·S rows as one dispatch; returns (x, the layer's aux loss)."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + L.attention(p["attn"], cfg, h, positions=positions, causal=True,
                        kops=kops)
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    y, aux = moe_mlp_apply(p["moe"], cfg, h)
    return x + y, aux


def moe_prefill_layer(p, cfg, x, view_l, positions, *, kops=ops):
    """Monolithic prefill (reference :212): attention filling K/V rows [0,
    S) of the (slot's) arena view, then the expert MLP over the prompt's S
    rows as one dispatch."""
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + T.attention_prefill(p["attn"], cfg, h, view_l, positions,
                                kops=kops)
    return _mlp_residual(p, cfg, x)


def moe_layer_chunk(p, cfg, x, layer_kv, slot, positions, start, nvalid,
                    prefix, *, kops=ops, share=None):
    """One prompt chunk into arena slot ``slot`` (reference :224): the
    dense layer's chunk attention, then the expert MLP over all C rows of
    the chunk as one dispatch, pad rows (token 0) included, as in the
    reference.  ``nvalid`` is unused (the cache is pure K/V)."""
    del nvalid
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + L.attention_chunk(p["attn"], cfg, h, layer_kv, slot, positions,
                              start, prefix, kops=kops, share=share)
    return _mlp_residual(p, cfg, x)


def moe_layer_decode_rows(p, cfg, x_t, layer_kv, pos, *, kops=ops,
                          share=None):
    """One decode step over every slot (reference :249): the dense
    layer's decode attention, then the expert MLP over the B slots' rows
    as one dispatch, parked and dead slots included."""
    h = L.rmsnorm(p["ln1"], x_t, cfg.rms_eps)
    x_t = x_t + L.attention_decode_rows(p["attn"], cfg, h, layer_kv, pos,
                                        kops=kops, share=share)
    return _mlp_residual(p, cfg, x_t[:, None])[:, 0]


#: the moe family: the dense arena (every KV format) and its attention
#: kernels, the expert MLP in place of the dense one
MOE = T.LayerSet(
    init_params=moe_layer_init, init_cache=T._dense_init_cache,
    factors=T.DENSE.factors, prefill_layer=moe_prefill_layer,
    chunk_layer=moe_layer_chunk, decode_layer=moe_layer_decode_rows,
    train_layer=moe_train_layer)
