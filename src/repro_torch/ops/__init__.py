"""Graph-ops primitives behind the backend registry (twin of
``repro.ops``): the models' ``aggregate`` (the weighted SpMM), the
per-edge pieces GATv2 is built from (``scatter_edges``, ``gather_dst``,
``gather_src``, ``sddmm``, ``edge_softmax``), all differentiable on both
backends, and the frontier family the sampler's block epilogue runs on."""
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


def scatter_edges(blk: "SampledLayer", values: torch.Tensor, *,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Segment-sum per-edge rows (edge_cap, F) into seed rows
    (seed_cap, F), masked edges left out."""
    return get_backend(backend, values.device).scatter_edges(blk, values)


def gather_dst(blk: "SampledLayer", rows: torch.Tensor, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """Per-edge fetch of destination-row values, 0 on masked edges:
    rows (seed_cap, F) -> (edge_cap, F). The transpose of
    :func:`scatter_edges`."""
    return get_backend(backend, rows.device).gather_dst(blk, rows)


def gather_src(blk: "SampledLayer", rows: torch.Tensor, *,
               backend: Optional[str] = None) -> torch.Tensor:
    """Per-edge fetch of source-row values, 0 on masked edges: rows
    (next_cap, F) -> (edge_cap, F)."""
    return get_backend(backend, rows.device).gather_src(blk, rows)


def sddmm(blk: "SampledLayer", u: torch.Tensor, v: torch.Tensor, *,
          op: str = "add", backend: Optional[str] = None) -> torch.Tensor:
    """Sampled dense-dense combine per edge: u (seed_cap, F) on the dst
    side, v (next_cap, F) on the src side. ``op="add"`` gives
    u[dst] + v[src] (edge_cap, F), GATv2's scores; ``op="dot"`` gives
    <u[dst], v[src]> (edge_cap,), the SpMM's weight gradient. Masked
    edges are 0; differentiable on both backends."""
    if op not in ("add", "dot"):
        raise ValueError(f"sddmm op must be 'add' or 'dot', got {op!r}")
    ud = gather_dst(blk, u, backend=backend)
    vs = gather_src(blk, v, backend=backend)
    return ud + vs if op == "add" else torch.sum(ud * vs, dim=-1)


def edge_softmax(blk: "SampledLayer", logits: torch.Tensor, *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Normalise edge logits (edge_cap, H) into attention coefficients
    per destination row, 0 on masked edges."""
    return get_backend(backend, logits.device).edge_softmax(blk, logits)


__all__ = ["BACKEND_CHOICES", "aggregate", "compact", "compact_perm",
           "edge_softmax", "gather_dst", "gather_src", "get_backend",
           "hash_dedup", "masked_cdf_draw", "resolve_backend",
           "scatter_edges", "sddmm", "segment_select"]
