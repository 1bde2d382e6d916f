"""Decoder-only LM: dense layer functions + the family-pluggable drivers.

Port of ``repro/models/transformer.py``: the dense layer functions
(:55-101), ``attention_prefill`` (:169) and the ``LM`` driver (:245) with
``init``, ``init_cache``, ``prefill``, ``prefill_chunk`` / ``_chunk_hidden``,
``verify_chunk``, ``decode_step`` / ``_decode_rows`` and
``decode_and_sample``.  As in the
reference the driver is family-pluggable: a :class:`LayerSet` bundles one
family's layer functions and arena (:data:`DENSE` here, ``moe.MOE`` for
the moe family, ``mamba2.SSM`` for the ssm family, ``hybrid.HYBRID`` for
the hybrid family), and the driver runs any of them.

Parameters keep the reference's layout — per-layer tensors stacked on a
leading L axis, weights stored (in, out) and applied as ``x @ W`` — so a
JAX parameter pytree converts leaf by leaf (``models/convert.py``).  The
reference's ``lax.scan`` over layers is a Python loop over L here.  The
arena (dense: ``{"k", "v"}`` of (L, slots, max_seq, KVH, hd)) is resident
and written in place: each layer writes its own rows or state into its
arena slice, where the reference scans read-only views and scatters once
after the scan (under buffer donation).  Logits come out in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import device as device_mod
from repro_torch.core import kv_format as kvf
from repro_torch.kernels import ops
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# dense layer
# ---------------------------------------------------------------------------

def dense_layer_chunk(p, cfg, x, layer_kv, slot, positions, start, nvalid,
                      prefix, *, window=None, kops=ops, share=None):
    """One prompt chunk through a dense layer (reference :74) into arena
    slot ``slot``.  ``nvalid`` is unused: pad rows land past the prompt and
    are overwritten by decode before any query attends them."""
    del nvalid
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + L.attention_chunk(p["attn"], cfg, h, layer_kv, slot, positions,
                              start, prefix, window=window, kops=kops,
                              share=share)
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + L.mlp(p["mlp"], cfg, h)


def dense_layer_decode_rows(p, cfg, x_t, layer_kv, pos, *, window=None,
                            kops=ops, share=None):
    """One decode step through a dense layer (reference :90)."""
    h = L.rmsnorm(p["ln1"], x_t, cfg.rms_eps)
    x_t = x_t + L.attention_decode_rows(p["attn"], cfg, h, layer_kv, pos,
                                        window=window, kops=kops,
                                        share=share)
    h = L.rmsnorm(p["ln2"], x_t, cfg.rms_eps)
    return x_t + L.mlp(p["mlp"], cfg, h)


def attention_prefill(p_attn, cfg, h, cache_kv, positions, *, window=None,
                      kops=ops):
    """Causal full-sequence attention + KV-cache fill (reference :169).

    h: (B, S, d); cache_kv: {"k", "v"} views (B, Smax, KVH, hd) (+ their
    scales for a scaled format), rows [0, S) written in place, quantized
    to the arena's format.  Attention reads the fresh K/V at full
    precision, as in the reference (:189-202); only the arena copy is
    narrowed.  K/V go to the attention op with their KVH heads; the kernel
    reads query head h's KV head as h // G instead of the reference's
    ``jnp.repeat``.
    """
    q, k, v = L._project_qkv(p_attn, cfg, h, positions)
    b, s = q.shape[:2]
    for key, rows in L._quantized(cache_kv, k, v).items():
        cache_kv[key][:, :s] = rows
    of = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window)
    o = of.transpose(1, 2).reshape(b, s, -1)
    return L._dot(o, p_attn["wo"], cfg.adtype)


def _prefill_layer(p, cfg, x, cache_kv, positions, *, window=None,
                   kops=ops):
    h = L.rmsnorm(p["ln1"], x, cfg.rms_eps)
    x = x + attention_prefill(p["attn"], cfg, h, cache_kv, positions,
                              window=window, kops=kops)
    h = L.rmsnorm(p["ln2"], x, cfg.rms_eps)
    return x + L.mlp(p["mlp"], cfg, h)


def layer_params(stacked, i: int):
    """The i-th layer's parameter views of a stacked (L, ...) tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def head_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, d) @ (d, V) -> f32 logits (reference: ``preferred_element_type
    = f32``).  f32 operands multiply in f32.  On the card, bf16 operands go
    through the f32-out bf16 GEMM (``torch.mm(..., out_dtype=f32)``), which
    does not upcast the head (a 3072 x 128256 f32 copy per step at
    llama3.2-3b width); on the CPU they are upcast."""
    if h.dtype == torch.float32 and w.dtype == torch.float32:
        return h @ w
    if h.device.type == "cpu":
        return h.float() @ w.float()
    return torch.mm(h, w, out_dtype=torch.float32)


def stack_layers(n_layers: int, make, device) -> torch.Tensor:
    """(n_layers, ...) tensor of ``make()`` draws, made one layer-slice at
    a time (the full-width weights never exist twice in f32)."""
    first = make()
    out = torch.empty((n_layers, *first.shape), dtype=first.dtype,
                      device=device)
    out[0] = first
    for i in range(1, n_layers):
        out[i] = make()
    return out


# ---------------------------------------------------------------------------
# family layer sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSet:
    """One family's layers behind the :class:`LM` driver — the port's form
    of the reference's hooks (transformer.py:255-269).  Every layer
    function reads and writes its per-layer arena view in place:

      * ``init_params(cfg, gen, device)`` -> the stacked ``layers`` tree;
      * ``init_cache(cfg, batch, max_seq, kv_format, device)`` -> the
        stacked arena {leaf: (L, batch * f, ...)};
      * ``factors(cfg)`` -> {leaf: f}, the per-leaf batch factor: leaf dim
        1 is slots x f (1 for K/V, their scales and conv leaves, n_heads
        for the fused SSD state; reference ``_cache_factors``, :451);
      * ``prefill_layer(p, cfg, x, view_l, positions, *, kops)``;
      * ``chunk_layer(p, cfg, x, layer_l, slot, positions, start, nvalid,
        prefix, *, kops, share)``: one chunk into arena slot ``slot`` of
        the layer's whole arena ``layer_l``, ``nvalid`` real tokens, the
        rest padding; ``slot`` / ``start`` / ``nvalid`` are 0-d int64
        device tensors, read on the device only (the captured chunk step),
        and a chunk at ``start = PARKED_POS`` must leave the arena
        untouched; ``share`` (0-d (src, len) or None): sequence rows [0,
        len) are read from slot src (a recurrent layer has none: its
        share was spliced into the slot's state at the fork);
      * ``decode_layer(p, cfg, x_t, view_l, pos, *, kops, share)``: slots
        parked at ``PARKED_POS`` must come out untouched; ``share``: (B,)
        (src, len) or None, as for the chunk;
      * ``windows(cfg)`` (optional) -> one attention window a layer, host
        ints: the driver passes layer i's as ``window=`` to each of the
        three layer functions (the reference scans them as ``layer_xs``,
        transformer.py:298-312; a captured step holds each layer's as a
        constant of its launch).  None: the layers take no window.

    Which arena leaves have a sequence axis is not declared: the driver
    reads it off the arena's shapes (:meth:`LM.seq_axes`).
    """
    init_params: Callable
    init_cache: Callable
    factors: Callable
    prefill_layer: Callable
    chunk_layer: Callable
    decode_layer: Callable
    windows: Optional[Callable] = None


def _dense_init_params(cfg, gen, dev, mlp: bool = True) -> dict:
    """N(0, 1) scaled by fan-in^-1/2 for every projection (reference
    layers.py:160-174, :450-459), unit norms; ``mlp=False`` leaves the
    MLP out (a family that brings its own, as the moe family)."""
    pd, d, nl = cfg.pdtype, cfg.d_model, cfg.n_layers

    def ones(n):
        return torch.ones((nl, n), dtype=pd, device=dev)

    def normal(shape, std):
        return stack_layers(nl, lambda: L._normal(gen, shape, std, pd, dev),
                            dev)

    std_in, std_ff = d ** -0.5, cfg.d_ff ** -0.5
    std_o = (cfg.n_heads * cfg.hd) ** -0.5
    shapes = {"wq": ((d, cfg.n_heads * cfg.hd), std_in),
              "wk": ((d, cfg.n_kv_heads * cfg.hd), std_in),
              "wv": ((d, cfg.n_kv_heads * cfg.hd), std_in),
              "wo": ((cfg.n_heads * cfg.hd, d), std_o)}
    attn = {name: normal(s, sd) for name, (s, sd) in shapes.items()}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ones(cfg.hd)}
        attn["k_norm"] = {"scale": ones(cfg.hd)}
    tree = {"ln1": {"scale": ones(d)}, "attn": attn,
            "ln2": {"scale": ones(d)}}
    if mlp:
        shapes = {"w_up": ((d, cfg.d_ff), std_in),
                  "w_down": ((cfg.d_ff, d), std_ff)}
        if cfg.act == "silu_gated":
            shapes["w_gate"] = ((d, cfg.d_ff), std_in)
        tree["mlp"] = {name: normal(s, sd) for name, (s, sd) in
                       shapes.items()}
    return tree


def _dense_init_cache(cfg, batch, max_seq, kv_format, device) -> dict:
    return L.init_kv_cache(cfg, batch, max_seq, kv_format=kv_format,
                           device=device, n_layers=cfg.n_layers)


#: the dense family: K/V arena rows, attention kernels
DENSE = LayerSet(
    init_params=_dense_init_params, init_cache=_dense_init_cache,
    factors=lambda cfg: dict.fromkeys(("k", "v", "k_scale", "v_scale"), 1),
    prefill_layer=_prefill_layer,
    chunk_layer=dense_layer_chunk, decode_layer=dense_layer_decode_rows)


# ---------------------------------------------------------------------------
# LM driver
# ---------------------------------------------------------------------------

class LM:
    """Decoder-only LM: parameter init, arena init and the three serving
    drivers (monolithic prefill, chunked prefill, decode step) over one
    family's :class:`LayerSet` (``layers``, which ``models/registry.py``
    picks per family).

    ``device``: where ``init``/``init_cache`` allocate ("cuda" unless the
    caller asks for "cpu"; a missing card raises).  ``kernels``: the
    kernel-op namespace — :mod:`repro_torch.kernels.ops` (dispatch by
    device: the CUDA kernels on the card) or ``ops.PLAIN`` (the plain
    versions everywhere, the on-card oracle).
    """

    def __init__(self, cfg, layers, *, device="cuda", kernels=ops):
        self.cfg = cfg
        self.layers = layers
        self.device = device_mod.resolve(device)
        self.kops = kernels
        #: layer i's attention window (host ints), or None
        self.windows = (list(layers.windows(cfg)) if layers.windows
                        else None)
        self._seq_axes: dict = {}

    # -- params ------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """Random weights from an explicit ``torch.Generator`` seeded with
        ``seed``, with the reference's distributions (the family's layers,
        then d^-1/2 for the embedding and head tables, layers.py:491, unit
        norms), made on ``self.device``."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        pd, d = cfg.pdtype, cfg.d_model
        layers = self.layers.init_params(cfg, gen, dev)
        params = {
            "embed": L.embed_init(gen, cfg.vocab, d, pd, dev),
            "layers": layers,
            "final_norm": {"scale": torch.ones(d, dtype=pd, device=dev)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.embed_init(gen, cfg.vocab, d, pd,
                                             dev).T.contiguous()
        return params

    def head(self, params) -> torch.Tensor:
        return params["lm_head"] if not self.cfg.tie_embeddings \
            else params["embed"].T

    # -- arena ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   kv_format: str = "fp32") -> dict:
        """The family's stacked per-layer arena for ``batch`` slots (dense:
        {"k", "v"} of (L, batch, max_seq, KVH, hd) in ``kv_format``'s
        storage dtype, + {"k_scale", "v_scale"} of (L, batch, max_seq, KVH)
        for a scaled format).  An unknown format, or a narrow one for a
        family with recurrent state (ssm, hybrid), raises ``ValueError``
        (reference :399-405)."""
        kvf.get(kv_format)
        if kv_format != "fp32" and self.has_recurrent_state:
            raise ValueError(
                f"kv_format={kv_format!r}: the {self.cfg.family} family's "
                f"recurrent state stays full precision (only 'fp32')")
        return self.layers.init_cache(self.cfg, batch, max_seq, kv_format,
                                      self.device)

    def seq_axes(self, kv_format: str = "fp32") -> dict:
        """{leaf: index of its sequence axis in the per-layer leaf, or -1
        for a leaf with none (the SSD state, the conv tail)} of the
        family's arena in ``kv_format`` (reference ``_seq_axes``, :464):
        read off two arenas of one slot on the meta device, 8 and 16 rows
        deep, as the axis whose extent follows max_seq."""
        axes = self._seq_axes.get(kv_format)
        if axes is None:
            meta = torch.device("meta")
            small, big = (self.layers.init_cache(self.cfg, 1, n, kv_format,
                                                 meta) for n in (8, 16))
            axes = {}
            for key, leaf in small.items():
                diff = [i for i, (a, b) in enumerate(
                    zip(leaf.shape[1:], big[key].shape[1:])) if a != b]
                axes[key] = diff[0] if diff else -1
            self._seq_axes[kv_format] = axes
        return axes

    @property
    def has_recurrent_state(self) -> bool:
        """Some arena leaf holds per-slot state with no sequence axis
        (reference :487): those leaves cannot be shared by position, so a
        fork needs a snapshot of the donor's state at the divergence
        boundary, and the state stays full precision."""
        return any(ax < 0 for ax in self.seq_axes().values())

    #: prefix sharing composes the chunk path (a fork's ingestion resumes
    #: at the divergence boundary) with the arena decode path (the donor
    #: table reads its rows in place); every ported family has both
    #: (reference :329-332)
    supports_prefix_sharing = True

    def _state_leaves(self, cache: dict):
        """(key, leaf, factor) of the arena leaves with no sequence axis
        (:meth:`seq_axes` < 0): the ssm family's all, the hybrid family's
        "ssm" and "conv", none of the dense family's."""
        fmt = L.kv_cache_format(cache) if "k" in cache else "fp32"
        axes = self.seq_axes(fmt)
        factors = self.layers.factors(self.cfg)
        return [(key, leaf, factors[key]) for key, leaf in cache.items()
                if axes[key] < 0]

    def extract_slot_state(self, cache: dict, slot: int) -> list:
        """A copy of slot ``slot``'s recurrent-state leaves, a list in
        arena-leaf order (reference :549): the SSD state and the conv
        tail, (L, f, ...) each (K/V rows are not copied: a fork reads
        them in place through the donor table).  The serving engine
        checkpoints a prefix donor's state with it at page boundaries, so
        a later fork resumes the recurrence there.  Runs on the current
        stream, after whatever was enqueued before it."""
        return [leaf[:, slot * f:(slot + 1) * f].clone()
                for _, leaf, f in self._state_leaves(cache)]

    def splice_slot_state(self, cache: dict, state: list, slot: int) -> None:
        """Write a snapshot of :meth:`extract_slot_state` into slot
        ``slot``'s recurrent-state leaves in place (reference :569); the
        snapshot itself is not changed, so one serves every fork of its
        prefix."""
        leaves = self._state_leaves(cache)
        if len(state) != len(leaves):
            raise ValueError(f"a snapshot of {len(state)} leaves for "
                             f"{len(leaves)} recurrent arena leaves")
        for (_, leaf, f), piece in zip(leaves, state):
            leaf[:, slot * f:(slot + 1) * f].copy_(piece)

    def num_slots(self, cache: dict) -> int:
        factors = self.layers.factors(self.cfg)
        key = next(iter(cache))
        return cache[key].shape[1] // factors[key]

    def slot_view(self, cache: dict, slot: int) -> dict:
        """Slot ``slot``'s rows of every arena leaf across all layers, as
        views (writes land in the arena): leaf (L, slots * f, ...) ->
        (L, f, ...) with the leaf's batch factor f (reference
        ``_slot_view``, :588).  Monolithic prefill and the tests take it;
        ``slot`` is a host int, and an out-of-range slot is an error.  The
        chunk step reads its slot as device data instead
        (:meth:`prefill_chunk`), as the reference's traced one does."""
        nslots = self.num_slots(cache)
        if not (isinstance(slot, int) and 0 <= slot < nslots):
            raise ValueError(f"slot {slot!r}: a slot view takes a host int "
                             f"in [0, {nslots}) (a chunk takes its slot "
                             f"as a device tensor)")
        factors = self.layers.factors(self.cfg)
        return {key: leaf[:, slot * factors[key]:(slot + 1) * factors[key]]
                for key, leaf in cache.items()}

    @staticmethod
    def _layer_view(cache: dict, i: int) -> dict:
        return {key: leaf[i] for key, leaf in cache.items()}

    def _layer_kw(self, i: int) -> dict:
        """Layer i's side inputs: its window, where the family has them."""
        return {} if self.windows is None else {"window": self.windows[i]}

    # -- drivers -------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor,
                cache: dict) -> torch.Tensor:
        """Run the prompt, fill ``cache`` (a (L, B*f, ...) arena or a
        ``slot_view`` of one) in place — dense: rows [0, S); recurrent: the
        state after the prompt — and return last-position logits (B, V)
        f32."""
        cfg = self.cfg
        b, s = tokens.shape
        x = L.embed_lookup(params["embed"], tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(cfg.n_layers):
            x = self.layers.prefill_layer(
                layer_params(params["layers"], i), cfg, x,
                self._layer_view(cache, i), positions, kops=self.kops,
                **self._layer_kw(i))
        h = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        return head_logits(h[:, -1], self.head(params))

    def prefill_chunk(self, params, tokens: torch.Tensor, cache: dict,
                      slot, start, last_idx, share_src=None,
                      share_len=None) -> torch.Tensor:
        """Ingest one prompt chunk into slot ``slot`` of the arena.

        tokens: (1, C); the chunk occupies rows [start, start + C) of the
        slot (dense: those rows are written in place, rows past max_seq
        dropped; recurrent: the slot's state is carried from ``start`` — reset
        at start 0 — and only the ``last_idx + 1`` real tokens enter it).
        Returns the logits (1, V) f32 at the chunk's last real token
        ``last_idx``.

        ``slot``, ``start`` and ``last_idx`` are 0-d int64 tensors on the
        model's device, read there only, so one captured step serves every
        chunk of its length (the reference traces all three, engine.py:
        328-339); host ints are turned into such tensors here (a host
        ``slot`` out of range raises).  A chunk at ``start = PARKED_POS``
        writes nothing (the captured step's warm-up).

        ``share_src`` / ``share_len`` (0-d, optional; host ints are turned
        into device tensors too): prefix sharing, the slot reads sequence
        rows [0, share_len) from slot ``share_src`` (reference
        :612-661); a fork's chunks all start at ``start >= share_len``,
        so the writes still go to the slot's own rows.  None keeps
        today's path, unchanged.
        """
        if isinstance(slot, int):
            self.slot_view(cache, slot)             # range check
        dev = tokens.device
        slot, start, last_idx = (torch.as_tensor(t, dtype=torch.int64,
                                                 device=dev)
                                 for t in (slot, start, last_idx))
        share = None
        if share_src is not None:
            # int32, as the kernels read the table: converted once a chunk,
            # not once a layer
            share = tuple(torch.as_tensor(t, dtype=torch.int32, device=dev)
                          for t in (share_src, share_len))
        h = self._chunk_hidden(params, tokens, cache, slot, start,
                               last_idx + 1, share)
        last = h.index_select(1, last_idx.view(1))[:, 0]
        return head_logits(last, self.head(params))

    def verify_chunk(self, params, tokens: torch.Tensor, cache: dict,
                     slot, start) -> torch.Tensor:
        """The speculative verify pass (reference :703-740): C tokens
        already proposed (the slot's current token, then C - 1 draft
        proposals; never padded, so all C rows are real) through slot
        ``slot`` exactly as a prompt chunk at rows [start, start + C), with
        the logits of *every* row.  Row j predicts position ``start + 1 +
        j``; by the chunk/decode bit pin it is what a decode step at ``pos
        = start + j`` would give.  The chunk's rows are written in place
        (``layers.write_chunk_rows``): a row at or past max_seq keeps its
        old value (a verify chunk overruns the slot by at most C - 1 rows),
        and a row past the accepted prefix is dead until the next round's
        chunk overwrites it.

        ``slot`` / ``start``: 0-d int64 device tensors, read on the device
        only (the captured verify step), or host ints (a host ``slot`` out
        of range raises).  Returns (1, C, V) f32.  Its flash_prefill_chunk
        launches also count as ``flash_prefill_chunk_verify``
        (``ops.verify_pass``).
        """
        if self.layers.chunk_layer is None:
            raise NotImplementedError(
                f"speculative verify not supported for family "
                f"{self.cfg.family!r} (needs the chunked-prefill hooks)")
        if isinstance(slot, int):
            self.slot_view(cache, slot)             # range check
        dev = tokens.device
        slot, start = (torch.as_tensor(t, dtype=torch.int64, device=dev)
                       for t in (slot, start))
        c = tokens.shape[1]
        with ops.verify_pass():
            h = self._chunk_hidden(params, tokens, cache, slot, start,
                                   start.new_full((), c))
        b, _, d = h.shape
        return head_logits(h.reshape(b * c, d),
                           self.head(params)).reshape(b, c, -1)

    def _chunk_hidden(self, params, tokens, cache, slot, start, nvalid,
                      share=None):
        cfg = self.cfg
        b, c = tokens.shape
        x = L.embed_lookup(params["embed"], tokens)
        positions = (start + torch.arange(c, device=x.device))[None]
        positions = positions.expand(b, c)
        prefix = start.to(torch.int32).expand(b)
        for i in range(cfg.n_layers):
            x = self.layers.chunk_layer(
                layer_params(params["layers"], i), cfg, x,
                self._layer_view(cache, i), slot, positions, start, nvalid,
                prefix, kops=self.kops, share=share, **self._layer_kw(i))
        return L.rmsnorm(params["final_norm"], x, cfg.rms_eps)

    def decode_step(self, params, token_t: torch.Tensor, cache: dict,
                    pos: torch.Tensor, share=None) -> torch.Tensor:
        """token_t: (B,) int; pos: (B,) row to write per slot.  Updates
        each layer's arena slice in place (parked slots, pos =
        PARKED_POS, untouched) and returns logits (B, V) f32.  ``share``:
        (share_src, share_len) (B,) device tensors or None (reference
        :756-778): slot b reads rows [0, share_len[b]) from slot
        share_src[b] (identity (b, 0) for an unshared slot), its writes
        still target its own rows."""
        cfg = self.cfg
        if share is not None:
            # int32, as the kernels read the table: converted once a step,
            # not once a layer
            share = tuple(t.to(torch.int32) for t in share)
        x_t = L.embed_lookup(params["embed"], token_t)
        x_t = self._decode_rows(params, cfg, x_t, cache, pos, share)
        h = L.rmsnorm(params["final_norm"], x_t, cfg.rms_eps)
        return head_logits(h, self.head(params))

    def decode_and_sample(self, params, token_t: torch.Tensor, cache: dict,
                          pos: torch.Tensor, samp: dict, share=None,
                          with_flags: bool = False):
        """One decode step, then on-device sampling (reference
        transformer.py:785), shared by every family: the (B, V) logits stay
        on the device and the (B,) int64 tokens come out.  ``samp`` is the
        engine's per-slot vectors (``temp`` / ``top_p`` / ``min_p`` float32,
        ``top_k`` / ``seed`` int); the token drawn here will occupy row
        ``pos + 1``, so its key folds ``(seed, pos + 1)``.  Slots with
        ``temp <= 0`` take the argmax, bit for bit.  ``share``: as for
        :meth:`decode_step`.

        ``with_flags``: also return the (B,) bool per-slot finite flag,
        True iff the slot's logits row is finite throughout, as ``(tokens,
        ok)`` (reference :786-815): the engine's quarantine reads it beside
        the tokens, and the (B, V) logits never leave the device."""
        logits = self.decode_step(params, token_t, cache, pos, share)
        tok = L.sample_step(logits, samp["seed"], pos + 1, samp["temp"],
                            samp["top_k"], samp["top_p"], samp["min_p"])
        if with_flags:
            return tok, L.finite_rows(logits)
        return tok

    def _decode_rows(self, params, cfg, x_t, cache, pos, share=None):
        for i in range(cfg.n_layers):
            x_t = self.layers.decode_layer(
                layer_params(params["layers"], i), cfg, x_t,
                self._layer_view(cache, i), pos, kops=self.kops,
                share=share, **self._layer_kw(i))
        return x_t
