"""LLaVA-NeXT backbone: a dense LM with a patch-embedding prefix.

Port of ``repro/models/vlm.py``.  The anyres vision frontend is a stub:
the caller hands over precomputed patch embeddings (576 rows a tile, one
tile), which the backbone treats as a prefix of the text.  Prefill writes
the prefix rows into the slot's arena exactly like prompt rows, so decode,
``decode_and_sample``, every KV format and the captured steps are the
dense LM's.  Sampling positions are absolute arena rows, so the prefix
shifts them: the first generated token's key folds ``(seed,
n_patch_tokens + prompt_len)``, which the serving engine accounts for with
its ``prefix_extra``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T


class VLM(T.LM):
    """Dense LM + the patch prefix on the prefill path."""

    def prefill(self, params, tokens: torch.Tensor, cache: dict, *,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The prompt is ``[patch_embeds ; embed(tokens)]`` at positions
        [0, P + S) (reference :25-50): both fill ``cache`` rows, and the
        logits (B, V) f32 come from the last row.  patch_embeds: (B, P, d),
        cast to the activation dtype; None prefills the text alone."""
        x = L.embed_lookup(params["embed"], tokens)
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(device=x.device, dtype=x.dtype),
                           x], dim=1)
        return self._prefill_rows(params, x, cache)
