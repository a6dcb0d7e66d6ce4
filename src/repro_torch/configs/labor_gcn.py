"""labor-gcn: the paper's own workload as a full-scale configuration
(twin of ``repro.configs.labor_gcn``).

A 3-layer GCN (hidden 256, residuals; paper §4) trained with LABOR-0
sampling on a products-scale graph (|V| = 2.45M, average degree 25),
with modulo-partitioned features, partition-local sampling, the feature
all-to-all and the gradient all-reduce of the multi-device engine
(``runtime/engine.py``, ``launch/gnn_step.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GNNWorkloadConfig:
    name: str = "labor-gcn"
    num_vertices: int = 2_449_029          # products scale (Table 1)
    avg_degree: float = 25.26
    feature_dim: int = 100
    num_classes: int = 47
    hidden: int = 256
    num_layers: int = 3
    fanouts: Tuple[int, ...] = (10, 10, 10)
    sampler: str = "labor-0"
    global_batch: int = 32768              # seeds per step across the mesh
    # safety for the registry-derived static caps (LayerCaps and the
    # per-peer all-to-all schedule), sized per RANK-LOCAL batch by
    # launch/gnn_step.build_gnn_engine
    cap_safety: float = 1.6
    grad_compression: str = "none"          # none | bf16 | int8
    backend: str = "auto"                   # graph-ops backend (repro_torch.ops)
    # "off" | "prefetch" | "full": the pipelined driver
    # (runtime/pipeline.py); build_gnn_engine wraps the engine in a
    # PipelinedEngine when not "off"
    pipeline: str = "off"
    dtype: str = "float32"


def config(**kw) -> GNNWorkloadConfig:
    return GNNWorkloadConfig(**kw)


# the paper's four dataset-scale variants
VARIANTS = {
    "labor-gcn": dict(),
    "labor-gcn-reddit": dict(num_vertices=232_965, avg_degree=493.56,
                             feature_dim=602, num_classes=41),
    "labor-gcn-yelp": dict(num_vertices=716_847, avg_degree=19.52,
                           feature_dim=300, num_classes=100),
    "labor-gcn-flickr": dict(num_vertices=89_250, avg_degree=10.09,
                             feature_dim=500, num_classes=7),
}
