"""The ``"eager"`` graph-ops backend: the plain PyTorch versions of every
primitive (twin of ``repro.ops.ref``). They run on whatever device their
tensors are on, never launch a hand-written kernel, and are
differentiable through PyTorch's autograd (as the reference's ``"xla"``
backend is through JAX's)."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.edge_softmax.ref import edge_softmax_ref
from repro_torch.kernels.frontier.ref import (  # noqa: F401
    compact, compact_perm, hash_dedup, masked_cdf_draw, segment_select)
from repro_torch.kernels.spmm.ref import (gather_dst_ref, gather_rows_ref,
                                          scatter_rows_ref, spmm_block_ref)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.interface import SampledLayer


def aggregate(blk: "SampledLayer", h: torch.Tensor) -> torch.Tensor:
    """Weighted SpMM (the paper's Hajek estimator, eq. 6): h over
    ``blk.next_seeds`` (next_cap, F) -> (seed_cap, F)."""
    return spmm_block_ref(blk.src_slot, blk.dst_slot, blk.weight,
                          blk.edge_mask, h, blk.seed_cap)


def gather_dst(blk: "SampledLayer", rows: torch.Tensor) -> torch.Tensor:
    """rows[dst_slot] per edge, 0 on masked edges."""
    return gather_dst_ref(blk.dst_slot, blk.edge_mask, rows)


def scatter_edges(blk: "SampledLayer", values: torch.Tensor) -> torch.Tensor:
    """Unweighted segment sum of per-edge rows into seed rows: values
    (edge_cap, F) -> (seed_cap, F)."""
    return scatter_rows_ref(blk.dst_slot, blk.edge_mask, values,
                            blk.seed_cap)


def gather_src(blk: "SampledLayer", rows: torch.Tensor) -> torch.Tensor:
    """rows[src_slot] per edge, 0 on masked edges (the reference's
    gather: a negative slot wraps to the last row)."""
    return gather_rows_ref(rows, blk.src_slot, blk.edge_mask)


def edge_softmax(blk: "SampledLayer", logits: torch.Tensor) -> torch.Tensor:
    """Per-destination segment softmax of edge logits (edge_cap, H), 0
    on masked edges."""
    return edge_softmax_ref(blk.dst_slot, blk.edge_mask, logits,
                            blk.seed_cap)
