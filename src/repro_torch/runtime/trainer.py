"""The GNN training loop (twin of ``repro.runtime.trainer``'s
``GNNTrainConfig``, ``build_sampler``, ``train_gnn`` and
``evaluate_gnn``), single device.

The batch schedule is a pure function of the step: seeds
``SeedBatches.at(step)``, key ``fold_in(key(seed + 1), step)``, as in
the reference; the parameters start from the model's init (``MODELS``:
``gcn``, ``sage`` or ``gatv2``) at ``key(seed)``. Every
step goes through :meth:`TrainEngine.step` (the reference's fused path)
with its one-step-late overflow replay. Checkpoints, the guardrail, the
pipelined driver and the mesh are not ported: asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core import samplers as sampler_registry
from repro_torch.core.interface import Sampler, pad_seeds
from repro_torch.data.gnn_loader import (LoaderStats, SeedBatches,
                                         sample_with_retry)
from repro_torch.graph.generators import GraphDataset
from repro_torch.models import gnn as gnn_models
from repro_torch.optim import adam
from repro_torch.runtime.engine import TrainEngine, gather_feats


@dataclasses.dataclass
class GNNTrainConfig:
    model: str = "gcn"                  # gcn | sage | gatv2
    hidden: int = 256
    fanouts: tuple = (10, 10, 10)
    sampler: str = "labor-0"            # a repro_torch.core.samplers entry
    layer_sizes: Optional[tuple] = None  # (p)ladies budgets; None -> default
    batch_size: int = 1000
    lr: float = 1e-3
    steps: int = 200
    seed: int = 0
    cap_safety: float = 2.0
    device: str = "cuda"
    # not ported: each raises NotImplementedError when set
    pipeline: str = "off"
    mesh_devices: int = 0
    guard: str = "off"
    ckpt_dir: Optional[str] = None

    def __post_init__(self):
        unported = [name for name, off in (
            ("pipeline", self.pipeline == "off"),
            ("mesh_devices", self.mesh_devices == 0),
            ("guard", self.guard == "off"),
            ("ckpt_dir", self.ckpt_dir is None)) if not off]
        if unported:
            raise NotImplementedError(
                f"not ported to repro_torch yet: {', '.join(unported)}")
        if self.model not in gnn_models.MODELS:
            raise ValueError(f"unknown model {self.model!r}; choose from "
                             f"{sorted(gnn_models.MODELS)}")


def build_sampler(ds: GraphDataset, cfg: GNNTrainConfig) -> Sampler:
    """The registry entry with caps from the dataset's graph statistics
    (train and eval share it)."""
    return sampler_registry.from_dataset(
        cfg.sampler, ds, batch_size=cfg.batch_size, fanouts=cfg.fanouts,
        layer_sizes=cfg.layer_sizes, safety=cfg.cap_safety)


def train_gnn(ds: GraphDataset, cfg: GNNTrainConfig) -> Dict[str, Any]:
    """Train for ``cfg.steps`` steps. Returns {"params": the model,
    "history": per-step loss/acc/sampled_v/sampled_e, "stats":
    LoaderStats, "wall_time": seconds}."""
    if len(ds.train_idx) < cfg.batch_size:
        raise ValueError(
            f"batch_size {cfg.batch_size} exceeds the {len(ds.train_idx)}"
            "-vertex train split (SeedBatches drops partial batches)")
    stats = LoaderStats()
    engine = TrainEngine(build_sampler(ds, cfg), adam.AdamConfig(lr=cfg.lr),
                         device=cfg.device, stats=stats)
    in_dim, n_cls = ds.features.shape[1], int(ds.labels.max()) + 1
    init = gnn_models.MODELS[cfg.model][0]
    model = init(rng_lib.key(cfg.seed), in_dim, cfg.hidden, n_cls,
                 len(cfg.fanouts), device=engine.device)
    data = engine.make_data_from_dataset(ds)
    state = engine.init_state(model)
    batches = SeedBatches(ds.train_idx, cfg.batch_size, seed=cfg.seed,
                          device=engine.device)
    base_key = rng_lib.key(cfg.seed + 1)
    # metrics stay on the device during the loop; read once at the end
    device_history: List[Dict[str, Any]] = []

    def drain_replays():
        for idx, rm in engine.replayed:
            device_history[idx] = {**device_history[idx], **rm}
        engine.replayed.clear()

    t0 = time.time()
    for step in range(cfg.steps):
        seeds = batches.at(step)
        sk = rng_lib.fold_in(base_key, step)
        model, state, m = engine.step(model, state, data, seeds, sk,
                                      tag=len(device_history))
        device_history.append({"step": step + 1, **m})
        drain_replays()
    model, state, _ = engine.flush(model, state, data)
    drain_replays()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.time() - t0
    history = [{"step": int(r["step"]), "loss": float(r["loss"]),
                "acc": float(r["acc"]), "sampled_v": int(r["sampled_v"]),
                "sampled_e": int(r["sampled_e"])} for r in device_history]
    return {"params": model, "history": history, "stats": stats,
            "wall_time": wall, "sampler": engine.sampler}


@torch.no_grad()
def evaluate_gnn(ds: GraphDataset, model, cfg: GNNTrainConfig,
                 idx: np.ndarray, batches: int = 8, key=None) -> float:
    """Sampled evaluation accuracy on ``idx`` vertices; keys from
    ``key(1234)`` by ``split``, as in the reference."""
    engine = TrainEngine(build_sampler(ds, cfg), device=cfg.device)
    data = engine.make_data_from_dataset(ds)
    sampler = engine.sampler
    key = key if key is not None else rng_lib.key(1234)
    correct = total = 0
    for i in range(batches):
        lo = i * cfg.batch_size
        if lo >= len(idx):
            break
        chunk = np.asarray(idx[lo:lo + cfg.batch_size])
        seeds = pad_seeds(chunk, cfg.batch_size, device=engine.device)
        key, sk = rng_lib.split(key)
        blocks, sampler = sample_with_retry(sampler, data.graph, seeds, sk,
                                            backend=engine.backend)
        logits = model(blocks, gather_feats(data.features, blocks[-1]),
                       backend=engine.backend)
        pred = torch.argmax(logits, -1)[:len(chunk)].cpu().numpy()
        correct += int((pred == np.asarray(ds.labels)[chunk]).sum())
        total += len(chunk)
    return correct / max(total, 1)
