"""In-neighbourhood CSR graphs (twin of ``repro.graph.csr``).

For a destination vertex ``s``, ``indices[indptr[s]:indptr[s+1]]`` lists
the source vertices ``t`` of the edges ``t -> s`` (the paper samples
incoming edges of seeds).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """indptr int32[V + 1], indices int32[E]; ``weights`` optional
    float32[E] edge weights A_ts (paper §A.7), ``None`` for uniform
    weights (A_ts = 1)."""
    indptr: torch.Tensor
    indices: torch.Tensor
    weights: Optional[torch.Tensor] = None

    @property
    def num_vertices(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def degrees(self) -> torch.Tensor:
        """In-degree of every vertex, int32[V]."""
        return self.indptr[1:] - self.indptr[:-1]

    def in_degree(self, v) -> torch.Tensor:
        """In-degree of the vertices ``v`` (an int or int tensor)."""
        v = torch.as_tensor(v, device=self.indptr.device).long()
        return self.indptr[v + 1] - self.indptr[v]

    def validate(self) -> None:
        """Host-side structural validation, with the reference's
        messages."""
        indptr = self.indptr.cpu().numpy()
        indices = self.indices.cpu().numpy()
        if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
            raise ValueError("indptr does not cover indices")
        if np.any(np.diff(indptr) < 0):
            raise ValueError("indptr must be non-decreasing")
        if indices.size and (indices.min() < 0
                             or indices.max() >= self.num_vertices):
            raise ValueError("indices out of range")
        if (self.weights is not None
                and tuple(self.weights.shape) != tuple(self.indices.shape)):
            raise ValueError("weights shape mismatch")

    def to(self, device) -> "Graph":
        return Graph(
            indptr=self.indptr.to(device),
            indices=self.indices.to(device),
            weights=None if self.weights is None else self.weights.to(device))


def from_coo(src: np.ndarray, dst: np.ndarray, num_vertices: int,
             weights: Optional[np.ndarray] = None, dedup: bool = True,
             device="cpu") -> Graph:
    """Build an in-neighbourhood CSR ``Graph`` from a COO edge list
    (host numpy work, identical to the reference's)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dedup:
        key = dst * num_vertices + src
        if weights is None:
            key = np.unique(key)
            dst, src = key // num_vertices, key % num_vertices
        else:
            key, idx = np.unique(key, return_index=True)
            dst, src = key // num_vertices, key % num_vertices
            weights = np.asarray(weights)[idx]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if weights is not None:
        weights = np.asarray(weights)[order]
    counts = np.bincount(dst, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(
        indptr=torch.as_tensor(indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(src.astype(np.int32), device=device),
        weights=(None if weights is None else
                 torch.as_tensor(np.asarray(weights, np.float32),
                                 device=device)))


def reverse(graph: Graph) -> Graph:
    """Reverse the edge directions (host-side), carrying the edge
    weights; the result lives on ``graph``'s device."""
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()
    n = graph.num_vertices
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    weights = None if graph.weights is None else graph.weights.cpu().numpy()
    return from_coo(dst, indices.astype(np.int64), n, weights=weights,
                    dedup=False, device=graph.indptr.device)


def expand_seed_edges(graph: Graph, seeds: torch.Tensor, edge_cap: int, *,
                      seed_rows: Optional[torch.Tensor] = None,
                      backend: Optional[str] = None) -> dict:
    """Edge-centric CSR expansion with a static edge budget.

    ``seeds`` int32[S] (padding -1). Returns flat int32[edge_cap]
    buffers laid out segment-contiguously (all in-edges of seed 0, then
    seed 1, ...): ``seed_slot``, ``src`` (both -1 past the real edges),
    ``mask`` bool[edge_cap], ``seg_start``/``deg`` int32[S], ``total``
    int32[] (may exceed ``edge_cap`` => overflow), ``live`` int32[]
    = min(total, edge_cap), the device-side length of the real prefix
    that the frontier kernels bound their work by, and ``edge_weight``
    float32[edge_cap] (A_ts of each edge, 0 past the real prefix) when
    ``graph.weights`` is set, else None.

    ``seed_rows`` maps each seed to its CSR row (default: the seed id):
    the multi-device engine passes local rows (v // P) so that sampling
    reads a partition-local CSR while the seeds, and the global source
    ids that CSR stores, stay global.

    Bit-exact with the reference, including its clamped segment bumps
    when ``total > edge_cap``. The nonzero-degree row list goes through
    the frontier ``compact`` primitive, so no host sync is needed.
    """
    from repro_torch.core.cs_solve import SPILL_BINS, spill_index
    from repro_torch.ops import frontier as frontier_ops

    S = seeds.shape[0]
    dev = seeds.device
    indptr = graph.indptr
    valid = seeds >= 0
    safe = torch.where(valid, seeds if seed_rows is None else seed_rows,
                       0).long()
    deg = torch.where(valid, indptr[safe + 1] - indptr[safe], 0)
    seg_start = torch.cumsum(deg, 0, dtype=torch.int32) - deg
    total = deg.sum(dtype=torch.int32)

    # standard CSR expansion: scatter segment bumps, inclusive scan;
    # seed_slot[e] = (number of segment starts <= e) - 1, mapped back to
    # the rows of nonzero-degree seeds
    # (zero-degree seeds add nothing: they go to spill bins)
    bump_at = spill_index(deg > 0, torch.clamp(seg_start, max=edge_cap - 1),
                          edge_cap)
    bumps = torch.zeros(edge_cap + SPILL_BINS, dtype=torch.int32,
                        device=dev).scatter_add_(
        0, bump_at, torch.ones_like(bump_at, dtype=torch.int32))[:edge_cap]
    seed_slot = torch.cumsum(bumps, 0, dtype=torch.int32) - 1
    nz_rows, _, _ = frontier_ops.compact(deg > 0, S, backend=backend)
    seed_slot = nz_rows[torch.clamp(seed_slot, 0, S - 1).long()]

    live = torch.clamp(total, max=edge_cap)
    pos = torch.arange(edge_cap, dtype=torch.int32, device=dev)
    mask = pos < live
    slot_l = seed_slot.long()
    offset_in_seg = pos - seg_start[slot_l]
    row_start = indptr[safe[slot_l]]
    gidx = torch.where(mask, row_start + offset_in_seg, 0).long()
    src = torch.where(mask, graph.indices[gidx], -1)
    seed_slot = torch.where(mask, seed_slot, -1)
    ew = (None if graph.weights is None
          else torch.where(mask, graph.weights[gidx], 0.0))
    return dict(seed_slot=seed_slot, src=src, mask=mask,
                seg_start=seg_start, deg=deg, total=total, live=live,
                edge_weight=ew)
