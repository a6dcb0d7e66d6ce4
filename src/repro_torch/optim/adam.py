"""Adam with global-norm clipping (twin of ``repro.optim.adam``), as
plain functions on tensors.

Parameters, gradients and moments are dicts of name -> tensor (the
names of ``nn.Module.named_parameters()``); every function returns new
tensors and changes none in place. The update is the reference's
formula, ``mhat / (sqrt(nhat) + eps)`` with the bias corrections
``1 - b**t`` in float32 -- ``torch.optim.Adam`` places eps elsewhere --
and the moments are float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0


def init_state(params: Tensors, cfg: AdamConfig) -> dict:
    """Zero moments and a step count of 0 (int32, on the params'
    device)."""
    del cfg
    dev = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tree.values()))


def clip_by_global_norm(grads: Tensors,
                        max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    norm = global_norm(grads)
    # tensor / tensor: a Python scalar / tensor multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def apply_updates(params: Tensors, grads: Tensors, state: dict,
                  cfg: AdamConfig) -> Tuple[Tensors, dict, dict]:
    """One Adam(W) step. Returns (new params, new state, metrics)."""
    metrics = {}
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        metrics["grad_norm"] = gnorm
    step = state["step"] + 1
    t = step.to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - f32(cfg.b1) ** t
    bc2 = 1.0 - f32(cfg.b2) ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        mu = cfg.b1 * state["mu"][k] + (1 - cfg.b1) * g32
        nu = cfg.b2 * state["nu"][k] + (1 - cfg.b2) * torch.square(g32)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - cfg.lr * delta).to(p.dtype)
        new_mu[k], new_nu[k] = mu, nu
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, metrics
