"""Wrapper of the Hopper flash-attention kernel of
``csrc/flash_attention.cu``, which replaces the TPU ``_flash_kernel`` of
``repro/kernels/flash_attention/flash_attention.py`` (B9).

Layout (B, S, H, hd) at the public function, as the reference's; the
kernel's prologue reads k and v through their strides (the head
dimension contiguous, any alignment) into head-major scratch this wrapper
allocates (:func:`scratch_shapes`; ``ref.prologue_ref`` is its plain
version), and the main kernel reads q through its strides and writes a
new contiguous output of q's shape and dtype. :data:`PLANS` mirrors the
kernel's tile plan, which :func:`plan` expands into shared memory and
TMA boxes. On a CPU tensor :func:`flash_attention` runs the plain
version in ``ref.py``; on a CUDA tensor it launches the prologue and the
kernel or raises, and adds one to :data:`LAUNCHES` per call. Its
gradient recomputes through the
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

#: the kernel's tile plan, a copy of ``Plan<T, HD>`` in
#: ``csrc/flash_attention.cu``: (dtype, hd) -> (C consumer warpgroups of 64
#: query rows, BK keys a tile, DC head dims a ring slab, NS slabs)
PLANS = {
    (torch.float32, 16): (2, 64, 16, 4),
    (torch.float32, 32): (2, 64, 32, 4),
    (torch.float32, 64): (2, 64, 64, 4),
    (torch.float32, 80): (2, 64, 80, 3),
    (torch.float32, 128): (2, 64, 64, 3),
    (torch.float32, 256): (1, 64, 64, 3),
    (torch.bfloat16, 16): (2, 64, 16, 4),
    (torch.bfloat16, 32): (2, 64, 32, 4),
    (torch.bfloat16, 64): (2, 64, 64, 4),
    (torch.bfloat16, 80): (2, 64, 80, 4),
    (torch.bfloat16, 128): (2, 64, 128, 4),
    (torch.bfloat16, 256): (2, 64, 256, 4),
}
#: the shared memory one block can use on the H100
SMEM_LIMIT = 232_448


def _swizzle_for(row_bytes: int) -> int:
    """The widest TMA / wgmma swizzle (bytes) that divides a row."""
    return next(s for s in (128, 64, 32) if row_bytes % s == 0)


def plan(hd: int, dtype: torch.dtype) -> dict:
    """The kernel's tiles for (hd, dtype), as ``Geo<T, HD>`` derives them:
    query rows ``BQ``, keys ``BK``, slab dims ``DC``, ring depth ``NS``,
    ``parts`` (2 for fp32's big and small, 1 for bf16), the element size,
    the swizzle (bytes) of Q's and K's rows in shared memory and of V^T's,
    the TMA box {inner elements, rows} of each scratch (K, V^T), and the
    dynamic shared memory of a block: 1024 of alignment, Q, the ring, 256
    of barriers."""
    C, BK, DC, NS = PLANS[(dtype, hd)]
    elem = 4 if dtype == torch.float32 else 2
    parts = 2 if dtype == torch.float32 else 1
    sw = _swizzle_for(hd * elem)
    BQ = 64 * C
    return dict(C=C, BQ=BQ, BK=BK, DC=DC, NS=NS, parts=parts, elem=elem,
                swizzle={"q": sw, "k": sw, "vt": 128},
                box={"k": (sw // elem, BK), "vt": (128 // elem, DC)},
                smem=1024 + BQ * hd * elem * parts + NS * BK * DC * elem
                * parts + 256)


def scratch_shapes(B: int, Sk: int, Hkv: int, hd: int, dtype: torch.dtype):
    """Shapes of the prologue's scratch (``ref.prologue_ref``'s): K (B,
    Hkv, parts, Sk, hd) and V^T (B, Hkv, parts, hd, Skp), Skp = Sk rounded
    up to 8, so that every row is a multiple of 16 bytes."""
    parts = 2 if dtype == torch.float32 else 1
    skp = (Sk + 7) // 8 * 8
    return (B, Hkv, parts, Sk, hd), (B, Hkv, parts, hd, skp)


def scratch_layout(B: int, Sk: int, Hkv: int, hd: int, dtype: torch.dtype):
    """Element offsets of K and V^T in the one scratch buffer (each
    256-byte aligned) and its size in elements."""
    offsets, end = [], 0
    for shape in scratch_shapes(B, Sk, Hkv, hd, dtype):
        offsets.append(end)
        end += -(-math.prod(shape) // 128) * 128
    return offsets, end


def scratch_views(buf: torch.Tensor, B: int, Sk: int, Hkv: int,
                  hd: int):
    """K's and V^T's scratch in the buffer of a call (shapes as
    :func:`scratch_shapes`)."""
    offsets, _ = scratch_layout(B, Sk, Hkv, hd, buf.dtype)
    return [buf[o:o + math.prod(s)].view(s) for o, s in
            zip(offsets, scratch_shapes(B, Sk, Hkv, hd, buf.dtype))]


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


def _launch(q, k, v, causal, window, softcap, scale):
    """Prologue and kernel on CUDA tensors; returns (output, the scratch
    buffer: :func:`scratch_views` cuts it)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd needs CUDA tensors, got "
                         f"{q.device}")
    B, Sq, Sk, Hq, Hkv, hd = _checked(q, k, v)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty(B, Sq, Hq, hd, dtype=q.dtype, device=q.device)
    offsets, size = scratch_layout(B, Sk, Hkv, hd, q.dtype)
    buf = torch.empty(size, dtype=q.dtype, device=q.device)
    args = (ctypes.c_longlong * 24)(
        B, Sq, Sk, Hq, Hkv, hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
        int(window is not None), int(window or 0), int(softcap is not None),
        _DTYPES[q.dtype], offsets[1] * q.element_size())
    ptrs = (ctypes.c_void_p * 5)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), buf.data_ptr())
    status = _build.function("flash_attention_fwd")(
        ptrs, args, ctypes.c_float(softcap or 0.0), ctypes.c_float(scale),
        _stream(q.device))
    _build.check(status, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return out, buf


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The kernel on CUDA tensors (contract: ``ref.attention_ref``)."""
    return _launch(q, k, v, causal, window, softcap, scale)[0]


def kernel_plan(hd: int, dtype: torch.dtype) -> dict:
    """The plan compiled into the kernel (C, BK, DC, NS, Q's and K's
    swizzle, shared memory), read from the library: on the card it must
    equal :func:`plan`'s."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.function("flash_attention_plan")(
        hd, _DTYPES[dtype], ctypes.addressof(out)), "flash_attention_plan")
    return dict(zip(("C", "BK", "DC", "NS", "swizzle", "smem"), out))


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
