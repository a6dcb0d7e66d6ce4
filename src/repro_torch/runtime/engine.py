"""The inference engine of the serving path (twin of the single-device
half of ``repro.runtime.engine.TrainEngine``).

One request runs what the reference's ``_build_single_infer`` program
runs, eagerly: sample the blocks, gather the deepest layer's features,
apply the model, return the logits and the per-layer overflow flags.
:meth:`TrainEngine.infer_with_retry` doubles every cap and re-runs the
same key when a flag is set. Training (the fused step, the overflow
ledger, replay) and the multi-device engine are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.interface import Sampler, overflow_flags
from repro_torch.data.gnn_loader import SamplingOverflowError
from repro_torch.graph.csr import Graph
from repro_torch.ops.backend import resolve_backend
from repro_torch.runtime.guard import RetryPolicy


def gather_feats(features: torch.Tensor, block) -> torch.Tensor:
    """Rows of ``features`` for ``block.next_seeds``; padding slots (-1)
    read no row and give zeros (the reference's ``mode="fill"``: a
    negative torch index would silently read the last row)."""
    idx = block.next_seeds
    valid = idx >= 0
    rows = features[torch.where(valid, idx, 0).long()]
    return torch.where(valid[:, None], rows, 0.0)


@dataclasses.dataclass(frozen=True)
class EngineData:
    """Request-invariant inputs, on the engine's device."""
    graph: Graph
    features: torch.Tensor
    labels: torch.Tensor


class TrainEngine:
    """``TrainEngine(sampler, device=..., backend=...)``; ``infer`` and
    ``infer_with_retry`` take the model (a ``repro_torch.models.gnn.GCN``)
    where the reference takes its params pytree."""

    def __init__(self, sampler: Sampler, *, device="cuda",
                 backend: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                               "available (pass device='cpu' to run the "
                               "plain versions on the CPU)")
        self.sampler = sampler
        self.backend = resolve_backend(backend, self.device)
        # bumped by grow(): the first request at new caps is tagged as a
        # set-up event by the serving metrics
        self.generation = 0

    def make_data(self, graph: Graph, features, labels) -> EngineData:
        return EngineData(
            graph=graph.to(self.device),
            features=torch.as_tensor(features, dtype=torch.float32).to(
                self.device),
            labels=torch.as_tensor(labels).to(self.device))

    def make_data_from_dataset(self, ds) -> EngineData:
        return self.make_data(ds.graph, ds.features, ds.labels)

    def grow(self):
        """Double every static cap (the logarithmic retry schedule)."""
        self.sampler = self.sampler.doubled()
        self.generation += 1

    @torch.no_grad()
    def infer_blocks(self, params, data: EngineData, seeds: torch.Tensor,
                     key):
        """Sample + gather + forward for one padded seed batch; returns
        (logits, overflow flags bool[num_layers], blocks)."""
        salts = self.sampler.spec.salts(key)
        blocks = self.sampler.sample(data.graph, seeds, salts,
                                     backend=self.backend)
        feats = gather_feats(data.features, blocks[-1])
        logits = params(blocks, feats, backend=self.backend)
        return logits, overflow_flags(blocks), blocks

    def infer(self, params, data: EngineData, seeds: torch.Tensor, key):
        """(logits, overflow flags) for one padded seed batch."""
        logits, flags, _ = self.infer_blocks(params, data, seeds, key)
        return logits, flags

    def infer_with_retry(self, params, data: EngineData, seeds, key, *,
                         max_retries: int = 4):
        """:meth:`infer` under the overflow-retry contract: on overflow,
        :meth:`grow` and re-run the SAME key (the sampled set is
        salt-determined, so the retry answers the same request, just
        untruncated). Raises ``SamplingOverflowError`` when
        ``max_retries`` doublings do not clear it. Returns
        ``(logits, grows)``."""
        grows = {"n": 0}

        def attempt(_i):
            out = self.infer(params, data, seeds, key)
            if bool(out[-1].any()):       # one host read per request
                return None
            return out

        def escalate(_i):
            self.grow()
            grows["n"] += 1

        out = RetryPolicy(max_retries).run(
            attempt, grow=escalate, error=SamplingOverflowError,
            describe="sampling overflow persisted after cap doubling "
                     "while serving")
        return out[0], grows["n"]
