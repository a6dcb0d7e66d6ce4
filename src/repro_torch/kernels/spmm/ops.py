"""Wrapper of the Hopper SpMM kernel (``csrc/spmm.cu``), which replaces
the TPU ``_spmm_kernel`` of ``repro/kernels/spmm/spmm.py`` on the
``aggregate`` forward.

Sorted-prefix contract: the edges at index < ``n_live`` (all of them
when ``n_live`` is None) are sorted by ``dst_slot`` (non-decreasing, no
-1 among them), and the edges past it are masked. ``build_block`` emits
exactly that layout: ``compact`` keeps the segment order of
``expand_seed_edges``, and ``edge_mask`` is the prefix ``[0,
num_edges)``. On a CPU tensor the wrapper runs ``ref.spmm_block_ref``;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier.ops import _check, _check_live, _stream
from repro_torch.kernels.spmm import ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"spmm": 0}


def reset_launches() -> None:
    LAUNCHES["spmm"] = 0


def spmm_block(src_slot: torch.Tensor, dst_slot: torch.Tensor,
               weight: torch.Tensor, mask: torch.Tensor, h: torch.Tensor,
               num_rows: int, n_live: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Aggregate ``weight * h[src_slot]`` into ``num_rows`` destination
    rows; h float32 (T, F) -> (num_rows, F), every row written."""
    if h.device.type == "cpu":
        return ref.spmm_block_ref(src_slot, dst_slot, weight, mask, h,
                                  num_rows)
    dev = h.device
    E = dst_slot.shape[0]
    _check("src_slot", src_slot, torch.int32, dev)
    _check("dst_slot", dst_slot, torch.int32, dev)
    _check("weight", weight, torch.float32, dev)
    _check("mask", mask, torch.bool, dev)
    _check_live(n_live, dev)
    if not (src_slot.shape[0] == weight.shape[0] == mask.shape[0] == E):
        raise ValueError("edge arrays differ in length")
    if h.dtype != torch.float32 or h.dim() != 2 or not h.is_contiguous():
        raise ValueError("h must be a contiguous float32 (T, F) tensor")
    T, F = h.shape
    out = torch.empty(num_rows, F, dtype=torch.float32, device=dev)
    status = _build.function("spmm_rows")(
        _build.ptr(dst_slot), _build.ptr(src_slot), _build.ptr(weight),
        _build.ptr(mask), E, _build.ptr(n_live), _build.ptr(h), T, F,
        num_rows, _build.ptr(out), _stream(dev))
    _build.check(status, "spmm_rows")
    LAUNCHES["spmm"] += 1
    return out
