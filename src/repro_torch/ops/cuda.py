"""The ``"cuda"`` graph-ops backend: the Hopper kernels of
``repro_torch/csrc`` through their wrappers (the counterpart of the
reference's ``"pallas"`` backend, ``repro.ops.pallas``).

``aggregate`` is a ``torch.autograd.Function`` whose backward is built
from kernels too (the DGL gSpMM/gSDDMM factorisation):

  * the gradient for ``h`` is the TRANSPOSED SpMM -- the same kernel
    with src and dst swapped, fed through ``SampledLayer.src_perm`` so
    that the swapped destinations are a sorted prefix;
  * the gradient for the edge weights is the SDDMM
    ``<g[dst], h[src]>``, whose destination half is the row-gather
    kernel (``gather_dst``) and whose source half a plain gather.

Each runs only when autograd asks for that input's gradient: the first
GCN layer's input (the features) needs none, and the sampler's edge
weights need none in a train step.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.frontier.ops import (  # noqa: F401
    compact, compact_perm, hash_dedup, masked_cdf_draw, segment_select)
from repro_torch.kernels.spmm.ops import (gather_dst_rows, spmm_block,
                                          spmm_transposed)
from repro_torch.ops import gather_src

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.interface import SampledLayer


def _live(blk: "SampledLayer") -> torch.Tensor:
    return torch.clamp(blk.num_edges, max=blk.edge_cap)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, blk):
        ctx.blk = blk
        ctx.save_for_backward(h, weight)
        return spmm_block(blk.src_slot, blk.dst_slot, weight, blk.edge_mask,
                          h, blk.seed_cap, n_live=_live(blk))

    @staticmethod
    def backward(ctx, g):
        h, weight = ctx.saved_tensors
        blk = ctx.blk
        g = g.contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = spmm_transposed(blk.src_slot, blk.dst_slot, weight,
                                 blk.edge_mask, blk.src_perm, g, h.shape[0],
                                 n_live=_live(blk))
        if ctx.needs_input_grad[1]:   # sddmm(op="dot") on this backend
            dw = torch.sum(gather_dst(blk, g) * gather_src(blk, h), dim=-1)
        return dh, dw, None


def aggregate(blk: "SampledLayer", h: torch.Tensor) -> torch.Tensor:
    """Weighted SpMM over the block's dst-sorted valid-edge prefix
    ``[0, num_edges)``, differentiable in ``h`` and ``blk.weight``."""
    return _Aggregate.apply(h.contiguous(), blk.weight, blk)


def gather_dst(blk: "SampledLayer", rows: torch.Tensor) -> torch.Tensor:
    """rows[dst_slot] per edge through the row-gather kernel, 0 on
    masked edges. Forward only: its backward (``scatter_edges``) is not
    ported, so rows that need a gradient are refused."""
    if rows.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "gather_dst has no backward on the cuda backend yet "
            "(scatter_edges is not ported)")
    return gather_dst_rows(blk.dst_slot, blk.edge_mask, rows.contiguous(),
                           n_live=_live(blk))
