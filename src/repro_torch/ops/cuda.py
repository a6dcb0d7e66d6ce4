"""The ``"cuda"`` graph-ops backend: the Hopper kernels of
``repro_torch/csrc`` through their wrappers (the counterpart of the
reference's ``"pallas"`` backend, ``repro.ops.pallas``). Forward only:
the serving path needs no gradients."""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.frontier.ops import (  # noqa: F401
    compact, compact_perm, hash_dedup)
from repro_torch.kernels.spmm.ops import spmm_block

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.interface import SampledLayer


def aggregate(blk: "SampledLayer", h: torch.Tensor) -> torch.Tensor:
    """Weighted SpMM over the block's dst-sorted valid-edge prefix
    ``[0, num_edges)``."""
    live = torch.clamp(blk.num_edges, max=blk.edge_cap)
    return spmm_block(blk.src_slot, blk.dst_slot, blk.weight, blk.edge_mask,
                      h.contiguous(), blk.seed_cap, n_live=live)

