"""Vertex partitioning for the multi-device GNN engine (twin of
``repro.graph.partition``).

Destination-owned 1-D partitioning: vertex ``v`` is owned by partition
``v % P`` at local row ``v // P`` (stateless: any rank computes the
owner of any vertex, which the feature all-to-all relies on). Each
partition stores the in-edge CSR of its owned destinations with GLOBAL
source ids. Seeds are routed to their owner and sampled there; the
shared randomness r_t hashes the global id, so LABOR's correlated
sampling holds across partitions with no extra communication.

Every partition is padded to common shapes (the reference needs them
for its one ``shard_map``; here they keep every rank's buffers the same
size).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.graph.csr import Graph


@dataclasses.dataclass
class PartitionedGraph:
    num_parts: int
    num_vertices: int  # global
    # stacked per-partition CSR, padded to common shapes:
    indptr: np.ndarray   # int32[P, max_local_v + 1]
    indices: np.ndarray  # int32[P, max_local_e]  (global source ids)
    local_counts: np.ndarray  # int32[P] owned-vertex counts
    edge_counts: np.ndarray   # int32[P]

    def owner(self, v: np.ndarray) -> np.ndarray:
        return v % self.num_parts

    def local_id(self, v: np.ndarray) -> np.ndarray:
        return v // self.num_parts

    def global_id(self, part: int, local: np.ndarray) -> np.ndarray:
        return local * self.num_parts + part

    def part_graph(self, p: int, device="cpu") -> Graph:
        """Partition ``p`` as a local-destination ``Graph``."""
        nloc = int(self.local_counts[p])
        ne = int(self.edge_counts[p])
        return Graph(
            indptr=torch.as_tensor(self.indptr[p, : nloc + 1],
                                   device=device),
            indices=torch.as_tensor(self.indices[p, :ne], device=device))


def partition_part(graph: Graph, num_parts: int, p: int):
    """Partition ``p`` alone: (indptr int32[max_local_v + 1] padded flat
    past the owned rows, indices int32[its edge count], global source
    ids). Each rank of the engine builds only its own part."""
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()
    n = graph.num_vertices
    max_v = -(-n // num_parts)
    nloc = len(range(p, n, num_parts))
    deg = np.diff(indptr)
    rows = np.arange(p, n, num_parts)
    d = deg[rows]
    out_ptr = np.zeros(max_v + 1, dtype=np.int32)
    out_ptr[1: nloc + 1] = np.cumsum(d)
    out_ptr[nloc + 1:] = out_ptr[nloc]
    # each owned row's in-edges in CSR order (a stable sort by local
    # destination keeps them so)
    starts = indptr[rows]
    if d.sum():
        seg = np.repeat(starts - out_ptr[:nloc], d)
        idx = np.arange(int(d.sum()), dtype=np.int64) + seg
        edges = indices[idx].astype(np.int32)
    else:
        edges = np.zeros(0, np.int32)
    return out_ptr, edges


def partition_graph(graph: Graph, num_parts: int) -> PartitionedGraph:
    """Split an in-CSR graph into destination-owned modulo partitions."""
    n = graph.num_vertices
    parts: List = [partition_part(graph, num_parts, p)
                   for p in range(num_parts)]
    local_counts = np.array(
        [len(range(p, n, num_parts)) for p in range(num_parts)],
        dtype=np.int32)
    edge_counts = np.array([e.size for _, e in parts], dtype=np.int32)
    max_e = int(edge_counts.max())
    padded = np.zeros((num_parts, max_e), dtype=np.int32)
    for p, (_, e) in enumerate(parts):
        padded[p, : e.size] = e
    return PartitionedGraph(
        num_parts=num_parts, num_vertices=n,
        indptr=np.stack([ptr for ptr, _ in parts]), indices=padded,
        local_counts=local_counts, edge_counts=edge_counts)


def partition_rows(values: np.ndarray, num_parts: int, p: int) -> np.ndarray:
    """Partition ``p``'s rows of a per-vertex array: rows ``p, p + P,
    ...`` into a zero-padded [ceil(V/P), ...] block."""
    n = values.shape[0]
    per = (n + num_parts - 1) // num_parts
    out = np.zeros((per,) + values.shape[1:], dtype=values.dtype)
    rows = values[p::num_parts]
    out[: rows.shape[0]] = rows
    return out


def partition_features(features: np.ndarray, num_parts: int) -> np.ndarray:
    """[V, F] -> [P, ceil(V/P), F] modulo-partitioned, zero-padded."""
    return np.stack([partition_rows(features, num_parts, p)
                     for p in range(num_parts)])
