"""The multi-device GNN launch glue: the paper's workload at full scale
(twin of ``repro.launch.gnn_step``).

The step itself is :class:`repro_torch.runtime.engine.TrainEngine` on a
mesh: the destination-owned partitioned CSR, per-layer seed routing,
partition-local LABOR with the global-id hash r_t, the fixed-capacity
feature / hidden all-to-alls and the (optionally compressed) gradient
all-reduce. This module derives the rank-local batch from a
:class:`~repro_torch.configs.labor_gcn.GNNWorkloadConfig` and builds
the sampler through the registry (``from_graph_stats``, the one cap
construction path, the per-peer all-to-all caps included).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.labor_gcn import GNNWorkloadConfig
from repro_torch.core import samplers as sampler_registry
from repro_torch.optim import adam
from repro_torch.runtime.engine import TrainEngine
from repro_torch.runtime.pipeline import PipelinedEngine


def build_gnn_engine(mesh, cfg: GNNWorkloadConfig,
                     lr: float = 1e-3) -> Tuple[object, dict]:
    """The mesh ``TrainEngine`` for ``cfg`` on ``mesh`` (a
    ``launch.mesh.Mesh``) and its launch metadata; with ``cfg.pipeline``
    not "off" the engine comes wrapped in the
    :class:`~repro_torch.runtime.pipeline.PipelinedEngine` driver (the
    engine is ``driver.engine``). The caps are sized for the rank-local
    batch ``global_batch // ranks`` (at least 8)."""
    num_devices = mesh.size
    local_batch = max(cfg.global_batch // num_devices, 8)
    max_deg = int(min(cfg.avg_degree * 64, cfg.num_vertices - 1))
    sampler = sampler_registry.from_graph_stats(
        cfg.sampler, batch_size=local_batch, fanouts=cfg.fanouts,
        avg_degree=cfg.avg_degree, max_degree=max_deg,
        num_vertices=cfg.num_vertices,
        num_edges=int(cfg.num_vertices * cfg.avg_degree),
        safety=cfg.cap_safety, num_parts=num_devices)
    engine = TrainEngine(sampler, adam.AdamConfig(lr=lr), mesh=mesh,
                         backend=cfg.backend,
                         grad_compression=cfg.grad_compression)
    meta = dict(
        backend=engine.backend,
        local_batch=local_batch,
        global_batch=local_batch * num_devices,
        caps=list(sampler.caps),
        peer_caps=list(sampler.spec.peer_caps),
        num_devices=num_devices,
        v_local=-(-cfg.num_vertices // num_devices),
        pipeline=cfg.pipeline,
    )
    if cfg.pipeline != "off":
        return PipelinedEngine(engine, mode=cfg.pipeline), meta
    return engine, meta
