"""Plain PyTorch attention (twin of ``repro.kernels.flash_attention.ref``,
the TPU kernel's own oracle): the contract of ``csrc/flash_attention.cu``
and what its wrapper runs on a CPU tensor; and the plain version of the
kernel's prologue (:func:`split_tf32`, :func:`prologue_ref`), the scratch
it writes before the products (the main kernel splits q the same way)."""
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


#: position p of each 8-key k-step of fp32 V^T holds key VT_PERM[p]: a
#: TF32 A fragment's k index t and t + 4 stand for the accumulator's keys
#: 2t and 2t + 1
VT_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(bits: torch.Tensor) -> torch.Tensor:
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32``: the 13 low mantissa
    bits cleared, to nearest with ties away from zero (NaN kept)."""
    out = _float((_bits(x) + 0x1000) & 0xFFFFE000)
    return torch.where(torch.isnan(x), x, out)


def split_tf32(x: torch.Tensor):
    """The prologue's 3xTF32 split of float32 ``x``: (big, small), both TF32
    values, big = tf32(x), small = tf32(x - big), so that big + small = x
    to ~2^-22 of x (normal x). A finite x that rounds to inf keeps its
    truncation as big; an infinite x has small 0."""
    big = tf32_rna(x)
    over = torch.isinf(big) & torch.isfinite(x)
    big = torch.where(over, _float(_bits(x) & 0xFFFFE000), big)
    small = torch.where(torch.isinf(x), torch.zeros_like(x),
                        tf32_rna(x - big))
    return big, small


def _parts(x: torch.Tensor) -> torch.Tensor:
    """(B, H, ...) -> (B, H, parts, ...): fp32's big and small, bf16 as it
    is."""
    if x.dtype == torch.float32:
        return torch.stack(split_tf32(x), 2)
    return x.unsqueeze(2)


def prologue_ref(k, v):
    """The scratch the kernel's prologue writes, from k, v (B, Sk, Hkv,
    hd): K (B, Hkv, parts, Sk, hd) and V^T (B, Hkv, parts, hd, Skp), Skp =
    Sk rounded up to 8 with zero keys; parts = (big, small) for fp32,
    (value,) for bf16; fp32 V^T's keys in :data:`VT_PERM` order within each
    8."""
    Sk = k.shape[1]
    skp = (Sk + 7) // 8 * 8
    vt = torch.nn.functional.pad(v.permute(0, 2, 3, 1), (0, skp - Sk))
    if v.dtype == torch.float32:
        pos = torch.arange(skp, device=v.device)
        perm = torch.tensor(VT_PERM, device=v.device)
        vt = vt[..., (pos & ~7) | perm[pos & 7]]
    return _parts(k.permute(0, 2, 1, 3)), _parts(vt)
