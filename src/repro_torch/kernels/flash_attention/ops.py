"""Wrapper of the Hopper flash-attention kernel of
``csrc/flash_attention.cu``, which replaces the TPU ``_flash_kernel`` of
``repro/kernels/flash_attention/flash_attention.py`` (B9).

Layout (B, S, H, hd) at the public function, as the reference's; the
kernel reads q, k and v through their strides (the head dimension
contiguous) and writes a new contiguous output of q's shape and dtype.
On a CPU tensor :func:`flash_attention` runs the plain version in
``ref.py``; on a CUDA tensor it launches the kernel or raises, and adds
one to :data:`LAUNCHES` per launch. Its gradient recomputes through the
plain version's autograd, as the reference's ``custom_vjp`` does
(``flash_attention/ops.py``): the backward is no kernel there either.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.frontier.ops import _stream

#: head dimensions the kernel is built for
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _checked(q, k, v):
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}: q, k and v must "
                            "share float32 or bfloat16")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be (B, S, H, hd) with a "
                             "contiguous head dimension")
    B, Sq, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV "
                         "heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dimension {hd} not built; one of "
                         f"{HEAD_DIMS}")
    return B, Sq, k.shape[1], Hq, Hkv, hd


def _aligned16(t: torch.Tensor) -> bool:
    """Every (batch, seq, head) row of ``t`` starts 16-byte aligned."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The kernel on CUDA tensors (contract: ``ref.attention_ref``)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd needs CUDA tensors, got "
                         f"{q.device}")
    B, Sq, Sk, Hq, Hkv, hd = _checked(q, k, v)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty(B, Sq, Hq, hd, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    # bit 0: q's rows start 16-byte aligned, bit 1: k's and v's; the
    # kernel copies such rows 16 bytes at a time, others element-wise
    vec = int(_aligned16(q)) | 2 * int(_aligned16(k) and _aligned16(v))
    status = _build.function("flash_attention_fwd")(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        B, Sq, Sk, Hq, Hkv, hd, *strides, int(bool(causal)),
        int(window is not None), int(window or 0),
        int(softcap is not None), ctypes.c_float(softcap or 0.0),
        ctypes.c_float(scale), _DTYPES[q.dtype], vec, _stream(q.device))
    _build.check(status, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes the plain version and
    differentiates it (the reference's ``_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return flash_attention_fwd(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.attention_ref(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention (B, Sq, Hq, hd) from q (B, Sq, Hq, hd) and k,
    v (B, Sk, Hkv, hd); the reference's ``flash_attention`` signature
    without ``interpret``."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
