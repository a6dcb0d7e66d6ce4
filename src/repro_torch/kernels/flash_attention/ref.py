"""Plain PyTorch attention (twin of ``repro.kernels.flash_attention.ref``,
the TPU kernel's own oracle): the contract of ``csrc/flash_attention.cu``
and what its wrapper runs on a CPU tensor."""
from __future__ import annotations

import math

import torch


def visible(Sq: int, Sk: int, causal: bool, window, device,
            q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: query i (at position q_offset + i) sees key j when
    j <= i (causal) and i - j < window (a sliding window)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, q_offset=0):
    """q (B, Sq, Hq, hd); k, v (B, Sk, Hkv, hd), Hq a multiple of Hkv
    (query head h reads KV head h // (Hq / Hkv)). fp32 scores
    ``q.k * scale`` (scale 1/sqrt(hd) by default), then ``tanh(s / c) c``
    with a softcap c, masked scores -1e30, softmax over the keys, the
    weighted sum of v; the output in q's dtype. ``q_offset`` places the
    queries at positions q_offset.. (a chunk of a longer sequence)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = visible(Sq, Sk, causal, window, q.device, q_offset)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
