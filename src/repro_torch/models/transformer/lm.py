"""LM-level entry points (twin of ``repro.models.transformer.lm``): the
loss, the train step (microbatched gradient accumulation included) and
the prefill / greedy serve step factories.

The train step updates the model in place: the nested parameter tree
(dicts, and per-repeat lists under ``"layers"``) is flattened into the
name -> tensor dict of ``optim.adam`` (:func:`flatten_params`; names are
the tree's paths, e.g. ``layers/0/3/mix/wq``), and
``adam.apply_updates_`` writes the new values into those tensors.
:func:`input_specs` and :func:`cache_specs` give a cell's inputs and
decode cache as ``meta``-device tensors (shapes and dtypes, no memory),
the reference's ShapeDtypeStructs for the one-card dry run
(``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.transformer import stack
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.optim import adam

_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    """The mean cross entropy of ``batch``'s ``tokens`` against its
    ``labels``; ``batch["xsource"]``, where present, is the
    cross-attention source (or the encoder's input)."""
    logits = stack.forward(params, batch["tokens"], cfg,
                           xsource=batch.get("xsource"), backend=backend)
    return cross_entropy(logits.float(), batch["labels"])


def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree's tensors by path (``a/b/0/c``), in the tree's order;
    empty dicts (a ``shared_attn`` entry's ``mix``) give none."""
    out: Dict[str, torch.Tensor] = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_params(flat: Dict[str, torch.Tensor], like, prefix: str = ""):
    """The tree of ``like``'s structure with each tensor taken from
    ``flat`` by its path."""
    if isinstance(like, dict):
        return {k: unflatten_params(flat, v, f"{prefix}/{k}" if prefix
                                    else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflatten_params(flat, v, f"{prefix}/{k}" if prefix
                                 else str(k)) for k, v in enumerate(like)]
    return flat[prefix]


def init_opt_state(params, opt_cfg: adam.AdamConfig) -> dict:
    """Adam's state for the tree ``params`` (zero moments by path)."""
    return adam.init_state(flatten_params(params), opt_cfg)


def make_grad_fn(cfg: TransformerConfig, backend: Optional[str] = None,
                 num_microbatches: int = 1, accum_dtype: str = "float32"):
    """``grad_fn(params, batch) -> (loss, grads by path)``: the loss's
    gradient with respect to every tensor of ``params``. With ``n =
    num_microbatches > 1`` the batch splits along axis 0 into n slices,
    taken in turn; the gradients accumulate as ``acc + g / n`` in
    ``accum_dtype`` and the loss as ``loss / n``, the reference's order.
    Every entry of the batch (``xsource`` too) splits the same way. A
    tensor the loss does not reach (an encoder's unused token
    embedding) gets a zero gradient, as ``jax.grad`` gives it. The
    reference's ``unroll_microbatches`` (a switch for XLA's cost
    analysis, which counts a scan's body once) has no counterpart: this
    loop is always unrolled."""
    n = num_microbatches
    adt = _ACCUM[accum_dtype]

    def grads_of(params, batch):
        leaves = {k: t.detach().requires_grad_()
                  for k, t in flatten_params(params).items()}
        loss = loss_fn(unflatten_params(leaves, params), batch, cfg,
                       backend=backend)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(t) if g is None else g
            for (k, t), g in zip(leaves.items(), grads)}

    def grad_fn(params, batch):
        if n == 1:
            return grads_of(params, batch)
        dev = batch["tokens"].device
        # a 0-d device tensor as divisor: a Python one is a reciprocal
        # multiply on the card
        nt = torch.tensor(float(n), dtype=torch.float32, device=dev)
        acc = {k: torch.zeros(t.shape, dtype=adt, device=t.device)
               for k, t in flatten_params(params).items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            loss, grads = grads_of(params, mb)
            for k, g in grads.items():
                acc[k] = acc[k] + g.to(adt) / nt.to(adt)
            loss_acc = loss_acc + loss / nt
            del grads
        return loss_acc, acc

    return grad_fn


def make_train_step(cfg: TransformerConfig, opt_cfg: adam.AdamConfig,
                    lr_schedule=None, backend: Optional[str] = None,
                    num_microbatches: int = 1,
                    accum_dtype: str = "float32"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the reference's, with ``metrics["loss"]`` and (with
    clipping) ``metrics["grad_norm"]``. ``batch`` holds ``tokens`` and
    ``labels`` (B, S), and for a config with cross-attention
    ``xsource`` (B, Sx, width); ``opt_state`` comes from
    :func:`init_opt_state`. An encoder's parameters (``params["encoder"]``)
    are trained with the rest.
    ``params`` and ``opt_state`` are updated in place and returned.

    ``backend`` replaces the reference's ``use_flash``: ``"cuda"`` runs
    every causal self-attention of the forward (and of its recompute
    under remat) through the flash kernel, whose backward is the plain
    version's autograd, as the reference's ``custom_vjp``; ``"eager"``
    the plain path; ``None``/``"auto"`` resolves by the tokens' device.
    ``lr_schedule(step)`` scales the learning rate (e.g.
    ``adam.cosine_schedule``)."""
    grad_fn = make_grad_fn(cfg, backend, num_microbatches, accum_dtype)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        lr_scale = lr_schedule(opt_state["step"]) if lr_schedule else 1.0
        _, opt_state, metrics = adam.apply_updates_(
            flatten_params(params), grads, opt_state, opt_cfg, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: TransformerConfig, backend: Optional[str] = None):
    def prefill_step(params, batch):
        return stack.prefill(params, batch["tokens"], cfg,
                             xsource=batch.get("xsource"), backend=backend)
    return prefill_step


def make_serve_step(cfg: TransformerConfig):
    """One greedy token for the whole batch against the KV cache (updated
    in place): ``serve_step(params, cache, tokens (B, 1), pos)`` ->
    (next tokens (B,) int32, cache)."""
    def serve_step(params, cache, tokens, pos: int):
        logits, cache = stack.decode_step(params, tokens, cache, pos, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return serve_step


# ---------------------------------------------------------------------------
# dry-run specs: meta-device tensors (no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: TransformerConfig, shape) -> Dict[str, object]:
    """``meta`` stand-ins for every model input of a cell (``shape``, a
    ``config.ShapeSpec``): a train cell's ``batch`` of ``tokens`` and
    ``labels`` (B, S) int32, a prefill's ``tokens``, with ``xsource`` (B,
    source length, width) in the config's dtype where it has
    cross-attention; a decode cell's ``tokens`` (B, 1) and ``pos`` ()."""
    B, S = shape.global_batch, shape.seq_len

    def t(size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": t((B, 1), torch.int32), "pos": t((), torch.int32)}
    batch = {"tokens": t((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = t((B, S), torch.int32)
    if cfg.xattn_every or cfg.has_block("xattn"):
        batch["xsource"] = t(
            (B, cfg.xattn_source_len, cfg.xattn_source_dim or cfg.d_model),
            getattr(torch, cfg.dtype))
    return {"batch": batch}


def cache_specs(cfg: TransformerConfig, shape):
    """The decode cache of a cell (``stack.init_cache`` at the cell's
    batch and sequence) on the ``meta`` device."""
    return stack.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device="meta")
