"""Adam with global-norm clipping (twin of ``repro.optim.adam``), as
plain functions on tensors.

Parameters, gradients and moments are dicts of name -> tensor (the
names of ``nn.Module.named_parameters()``; the LM's train step flattens
its nested tree into such a dict). The update is the reference's
formula, ``mhat / (sqrt(nhat) + eps)`` with the bias corrections
``1 - b**t`` in float32 -- ``torch.optim.Adam`` places eps elsewhere.
The moments are stored in ``AdamConfig.state_dtype`` (``"bfloat16"``
halves the optimizer's memory) and updated in float32.

:func:`apply_updates` returns new tensors and changes none in place;
:func:`apply_updates_` computes the same values and writes them into the
parameters, moments and gradients it is given, so that a step holds one
copy of each (a full-width gemma2-2b step in fp32 would otherwise hold
two copies of 31 GB of parameters and moments: torch has no buffer
donation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

Tensors = Dict[str, torch.Tensor]

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    state_dtype: str = "float32"  # "bfloat16" halves optimizer memory


def init_state(params: Tensors, cfg: AdamConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` and a step count of 0 (int32,
    on the params' device)."""
    sdt = _STATE_DTYPES[cfg.state_dtype]
    dev = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p, dtype=sdt)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=sdt)
                   for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # tensor / tensor: a Python scalar / tensor multiplies by a reciprocal
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tensors,
                        max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def _prepare(grads: Tensors, state: dict, cfg: AdamConfig,
             lr_scale: Union[float, torch.Tensor]):
    """The clipping norm and scale, the new step count, the bias
    corrections and the learning rate of one step."""
    metrics, scale = {}, None
    if cfg.grad_clip is not None:
        norm = global_norm(grads)
        scale = _clip_scale(norm, cfg.grad_clip)
        metrics["grad_norm"] = norm
    step = state["step"] + 1
    t = step.to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - f32(cfg.b1) ** t
    bc2 = 1.0 - f32(cfg.b2) ** t
    return metrics, scale, step, bc1, bc2, cfg.lr * lr_scale


def _update(p, g, mu, nu, scale, bc1, bc2, lr, cfg: AdamConfig):
    """One tensor's clipped gradient, new moments (float32) and new
    parameter, in the reference's order of operations."""
    if scale is not None:
        g = (g.to(torch.float32) * scale).to(g.dtype)
    g32 = g.to(torch.float32)
    mu32 = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g32
    nu32 = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * torch.square(g32)
    delta = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), mu32, nu32


def apply_updates(params: Tensors, grads: Tensors, state: dict,
                  cfg: AdamConfig,
                  lr_scale: Union[float, torch.Tensor] = 1.0
                  ) -> Tuple[Tensors, dict, dict]:
    """One Adam(W) step with the learning rate ``cfg.lr * lr_scale``
    (``lr_scale`` a float or a 0-d tensor, e.g. a schedule's value).
    Returns (new params, new state, metrics)."""
    metrics, scale, step, bc1, bc2, lr = _prepare(grads, state, cfg,
                                                  lr_scale)
    sdt = _STATE_DTYPES[cfg.state_dtype]
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        new_p[k], mu, nu = _update(p, grads[k], state["mu"][k],
                                   state["nu"][k], scale, bc1, bc2, lr, cfg)
        new_mu[k], new_nu[k] = mu.to(sdt), nu.to(sdt)
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, metrics


@torch.no_grad()
def apply_updates_(params: Tensors, grads: Tensors, state: dict,
                   cfg: AdamConfig,
                   lr_scale: Union[float, torch.Tensor] = 1.0
                   ) -> Tuple[Tensors, dict, dict]:
    """:func:`apply_updates`'s values written in place, one tensor at a
    time: the parameters and moments into the tensors given, and each
    gradient is freed from ``grads`` once used. Returns (params, state,
    metrics), the objects passed in."""
    metrics, scale, step, bc1, bc2, lr = _prepare(grads, state, cfg,
                                                  lr_scale)
    for k, p in params.items():
        new, mu, nu = _update(p, grads.pop(k), state["mu"][k],
                              state["nu"][k], scale, bc1, bc2, lr, cfg)
        p.copy_(new)
        state["mu"][k].copy_(mu)
        state["nu"][k].copy_(nu)
        del new, mu, nu
    state["step"] = step
    return params, state, metrics


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """The reference's learning-rate multiplier: linear warm-up over
    ``warmup`` steps, then a cosine from 1 down to ``floor`` at
    ``total``; ``sched(step)`` on an integer step tensor gives a float32
    0-d tensor. ``base_lr`` is unused, as in the reference."""
    del base_lr

    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=s.device)
        warm = torch.clamp(s / f32(max(warmup, 1)), max=1.0)
        prog = torch.clamp((s - warmup) / f32(max(total - warmup, 1)),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return warm * cos
    return sched
