"""Gradient compression for the data-parallel all-reduce (twin of
``repro.distributed.compression``).

Modes:
  * ``"none"``: the float32 mean over the ranks (one all-reduce of
    every gradient, flattened into one buffer).
  * ``"bf16"``: cast to bfloat16 before the all-reduce, with error
    feedback (the rounding residual is carried to the next step).
  * ``"int8"``: a ring reduce-scatter + all-gather over int8 payloads,
    each chunk with its float32 scale, every hop re-quantised, with
    error feedback: the int8 chunks and their scales really cross the
    links (``Mesh.ppermute``).

Error feedback (Karimireddy et al. 2019) adds the quantisation residual
back into the next step's gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

MODES = ("none", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"  # none | bf16 | int8

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"gradient compression must be one of "
                             f"{MODES}, got {self.mode!r}")


def init_error_state(params: Dict[str, torch.Tensor],
                     cfg: CompressionConfig) -> Optional[dict]:
    """Zero float32 residuals shaped as ``params`` (None when off)."""
    if cfg.mode == "none":
        return None
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quant_int8(x: torch.Tensor):
    """(int8 values, float32 scale): scale = max|x| / 127 (at least
    1e-12 / 127), values round-half-even of x / scale clipped to
    +-127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ring_allreduce_int8(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of float32 ``x`` over the mesh with int8 payloads: the
    classic two-phase ring (reduce-scatter, then all-gather; P - 1 hops
    each), every hop re-quantised to int8 plus one float32 scale."""
    P, idx = mesh.size, mesh.rank
    n = x.numel()
    pad = (-n) % P
    acc = F.pad(x.reshape(-1).to(torch.float32), (0, pad)).reshape(P, -1)
    acc = acc.clone()

    def hop(chunk):
        q, s = _quant_int8(chunk)
        return _dequant_int8(mesh.ppermute(q), mesh.ppermute(s.reshape(1))[0])

    # reduce-scatter: after P - 1 hops this rank holds the full sum of
    # chunk (idx + 1) % P
    for i in range(P - 1):
        recv = (idx - i - 1) % P
        acc[recv] = acc[recv] + hop(acc[(idx - i) % P])
    own = (idx + 1) % P
    # all-gather: circulate the owned chunks, P - 1 hops
    for i in range(P - 1):
        recv = (own - i - 1) % P
        acc[recv] = hop(acc[(own - i) % P])
    return acc.reshape(-1)[:n].reshape(x.shape) / P


def compressed_mean(grads: Dict[str, torch.Tensor], err: Optional[dict],
                    cfg: CompressionConfig, mesh):
    """The mean of ``grads`` (name -> tensor) over the mesh, compressed
    per ``cfg`` with error feedback. Returns (mean grads, new error
    state)."""
    if cfg.mode == "none":
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1).to(torch.float32)
                          for k in names])
        red = mesh.pmean(flat)
        out, o = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = red[o:o + n].view(grads[k].shape)
            o += n
        return out, err
    red, new_err = {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + err[k]
        if cfg.mode == "bf16":
            sent = g32.to(torch.bfloat16).to(torch.float32)
            new_err[k] = g32 - sent
            red[k] = mesh.pmean(sent)
        else:
            q, s = _quant_int8(g32)
            sent = _dequant_int8(q, s)
            new_err[k] = g32 - sent
            red[k] = ring_allreduce_int8(sent, mesh)
    return red, new_err
