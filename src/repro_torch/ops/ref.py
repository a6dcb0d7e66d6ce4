"""The ``"eager"`` graph-ops backend: the plain PyTorch versions of every
primitive (twin of ``repro.ops.ref``). They run on whatever device their
tensors are on, never launch a hand-written kernel, and are
differentiable through PyTorch's autograd (as the reference's ``"xla"``
backend is through JAX's)."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.frontier.ref import (  # noqa: F401
    compact, compact_perm, hash_dedup, masked_cdf_draw, segment_select)
from repro_torch.kernels.spmm.ref import gather_dst_ref, spmm_block_ref

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
