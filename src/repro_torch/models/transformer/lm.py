"""LM-level entry points (twin of ``repro.models.transformer.lm``): the
loss, and the prefill / greedy serve step factories. The train step
(``make_train_step``) comes with the LM training slice (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.transformer import stack
from repro_torch.models.transformer.config import TransformerConfig


def cross_entropy(logits, labels):
    """logits (B,S,V) float; labels (B,S) integers, -1 = ignored."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: TransformerConfig,
            backend: Optional[str] = None):
    logits = stack.forward(params, batch["tokens"], cfg, backend=backend)
    return cross_entropy(logits.float(), batch["labels"])


def make_prefill_step(cfg: TransformerConfig, backend: Optional[str] = None):
    def prefill_step(params, batch):
        return stack.prefill(params, batch["tokens"], cfg, backend=backend)
    return prefill_step


def make_serve_step(cfg: TransformerConfig):
    """One greedy token for the whole batch against the KV cache (updated
    in place): ``serve_step(params, cache, tokens (B, 1), pos)`` ->
    (next tokens (B,) int32, cache)."""
    def serve_step(params, cache, tokens, pos: int):
        logits, cache = stack.decode_step(params, tokens, cache, pos, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return serve_step
