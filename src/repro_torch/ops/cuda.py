"""The ``"cuda"`` graph-ops backend: the Hopper kernels of
``repro_torch/csrc`` through their wrappers (the counterpart of the
reference's ``"pallas"`` backend, ``repro.ops.pallas``).

Every primitive is a ``torch.autograd.Function`` whose backward is built
from kernels too (the DGL gSpMM/gSDDMM factorisation):

  * ``aggregate``: the gradient for ``h`` is the TRANSPOSED SpMM -- the
    same kernel with src and dst swapped, fed through
    ``SampledLayer.src_perm`` so that the swapped destinations are a
    sorted prefix; the gradient for the edge weights is the SDDMM
    ``<g[dst], h[src]>``, whose destination half is the row-gather
    kernel and whose source half a plain gather. Each runs only when
    autograd asks for that input's gradient: the first GCN layer's input
    (the features) needs none, and the sampler's edge weights need none
    in a train step.
  * ``scatter_edges`` (the per-edge scatter kernel, ``scatter_rows``) and
    ``gather_dst`` (the row-gather kernel) are each other's transposes:
    each one's backward is the other's forward.
  * ``gather_src`` is the row-gather kernel indexed by ``src_slot``; its
    backward is the per-edge scatter through ``src_perm`` with
    ``src_slot`` as the destination, a fixed-order sum per source row.
  * ``edge_softmax`` is the edge-softmax kernel; its backward is the
    segment softmax Jacobian ``alpha * (g - gather_dst(scatter_edges(
    alpha * g)))``, one scatter and one gather.

Every kernel reads only the block's live prefix ``[0, num_edges)``.
Where a slot is -1 (only in a block whose caps overflowed, whose
update the engine discards and whose request it re-runs), the gathers
read nothing for it and the scatters add it to no row; the plain
versions would wrap it to the last row.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.edge_softmax.ops import edge_softmax_rows
from repro_torch.kernels.frontier.ops import (  # noqa: F401
    compact, compact_perm, hash_dedup, masked_cdf_draw, segment_select)
from repro_torch.kernels.spmm.ops import (gather_dst_rows, scatter_rows,
                                          spmm_block, spmm_transposed)
from repro_torch.ops import ref

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.interface import SampledLayer


def _live(blk: "SampledLayer") -> torch.Tensor:
    return torch.clamp(blk.num_edges, max=blk.edge_cap)


def _gather(blk, index, rows):
    return gather_dst_rows(index, blk.edge_mask, rows.contiguous(),
                           n_live=_live(blk))


def _scatter(blk, g, num_rows, index=None, perm=None):
    index = blk.dst_slot if index is None else index
    return scatter_rows(index, blk.edge_mask, g.contiguous(), num_rows,
                        perm=perm, n_live=_live(blk))


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
            dw = torch.sum(_gather(blk, blk.dst_slot, g)
                           * ref.gather_src(blk, h), dim=-1)
        return dh, dw, None


def aggregate(blk: "SampledLayer", h: torch.Tensor) -> torch.Tensor:
    """Weighted SpMM over the block's dst-sorted valid-edge prefix
    ``[0, num_edges)``, differentiable in ``h`` and ``blk.weight``."""
    return _Aggregate.apply(h.contiguous(), blk.weight, blk)


class _GatherDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, blk):
        ctx.blk, ctx.num_rows = blk, rows.shape[0]
        return _gather(blk, blk.dst_slot, rows)

    @staticmethod
    def backward(ctx, g):
        return _scatter(ctx.blk, g, ctx.num_rows), None


def gather_dst(blk: "SampledLayer", rows: torch.Tensor) -> torch.Tensor:
    """rows[dst_slot] per edge through the row-gather kernel, 0 on
    masked edges; its backward is the per-edge scatter."""
    return _GatherDst.apply(rows, blk)


class _ScatterEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, blk):
        ctx.blk = blk
        return _scatter(blk, values, blk.seed_cap)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.blk, ctx.blk.dst_slot, g), None


def scatter_edges(blk: "SampledLayer", values: torch.Tensor) -> torch.Tensor:
    """Per-edge rows (edge_cap, F) summed into seed rows through the
    per-edge scatter kernel; its backward is the row gather."""
    return _ScatterEdges.apply(values, blk)


class _GatherSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, blk):
        ctx.blk, ctx.num_rows = blk, rows.shape[0]
        return _gather(blk, blk.src_slot, rows)

    @staticmethod
    def backward(ctx, g):
        blk = ctx.blk
        return _scatter(blk, g, ctx.num_rows, index=blk.src_slot,
                        perm=blk.src_perm), None


def gather_src(blk: "SampledLayer", rows: torch.Tensor) -> torch.Tensor:
    """rows[src_slot] per edge through the row-gather kernel, 0 on
    masked edges; its backward sums each source row's edges in
    ``src_perm`` order (no atomics)."""
    return _GatherSrc.apply(rows, blk)


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, blk):
        alpha = edge_softmax_rows(blk.dst_slot, blk.edge_mask,
                                  logits.contiguous(), blk.seed_cap,
                                  n_live=_live(blk))
        ctx.blk = blk
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        (alpha,) = ctx.saved_tensors
        blk = ctx.blk
        inner = _scatter(blk, alpha * g, blk.seed_cap)
        return alpha * (g - _gather(blk, blk.dst_slot, inner)), None


def edge_softmax(blk: "SampledLayer", logits: torch.Tensor) -> torch.Tensor:
    """Per-destination softmax of edge logits (edge_cap, H <= 128)
    through the edge-softmax kernel, 0 on masked edges."""
    return _EdgeSoftmax.apply(logits, blk)
