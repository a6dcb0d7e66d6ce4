"""Graph-ops primitives behind the backend registry (twin of
``repro.ops``): the model's ``aggregate`` (differentiable on both
backends), the SDDMM pieces ``gather_dst``/``gather_src``/``sddmm`` of
its weight gradient, and the frontier family the sampler's block
epilogue runs on."""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.ops.backend import (BACKEND_CHOICES, get_backend,
                                     resolve_backend)
from repro_torch.ops.frontier import (compact, compact_perm, hash_dedup,
                                      masked_cdf_draw, segment_select)

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.interface import SampledLayer


def aggregate(blk: "SampledLayer", h: torch.Tensor, *,
              backend: Optional[str] = None) -> torch.Tensor:
    """out[s] = sum_e A'_e h[src_e] per destination seed: h over
    ``blk.next_seeds`` in, h over ``blk.seeds`` out. Differentiable in
    ``h`` and in ``blk.weight``."""
    return get_backend(backend, h.device).aggregate(blk, h)


def gather_dst(blk: "SampledLayer", rows: torch.Tensor, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """Per-edge fetch of destination-row values, 0 on masked edges:
    rows (seed_cap, F) -> (edge_cap, F). Its transpose
    (``scatter_edges``) is not ported, so the ``cuda`` backend refuses
    rows that need a gradient."""
    return get_backend(backend, rows.device).gather_dst(blk, rows)


def gather_src(blk: "SampledLayer", rows: torch.Tensor) -> torch.Tensor:
    """Per-edge fetch of source-row values, 0 on masked edges: rows
    (next_cap, F) -> (edge_cap, F). A plain gather on every backend."""
    safe = torch.where(blk.edge_mask, blk.src_slot, 0).long()
    return rows[safe] * blk.edge_mask[:, None].to(rows.dtype)


def sddmm(blk: "SampledLayer", u: torch.Tensor, v: torch.Tensor, *,
          op: str = "dot", backend: Optional[str] = None) -> torch.Tensor:
    """Sampled dense-dense product per edge: u (seed_cap, F) on the dst
    side, v (next_cap, F) on the src side; ``op="dot"`` gives
    <u[dst], v[src]> (edge_cap,), the SpMM's weight gradient. ``op="add"``
    (GATv2's scores) is not ported yet."""
    if op != "dot":
        raise NotImplementedError(f"sddmm op {op!r} is not ported; only "
                                  "'dot'")
    return torch.sum(gather_dst(blk, u, backend=backend) * gather_src(blk, v),
                     dim=-1)


__all__ = ["BACKEND_CHOICES", "aggregate", "compact", "compact_perm",
           "gather_dst", "gather_src", "get_backend", "hash_dedup",
           "masked_cdf_draw", "resolve_backend", "sddmm",
           "segment_select"]
