"""LABOR sampling (paper §3.2), LABOR-0 path (twin of ``repro.core.labor``).

With uniform pi (``importance_iters=0``) the per-seed scale c_s has the
closed form c = k/d for k < d and 1 otherwise (``fast_solve``), and an
in-edge t -> s is included iff r_t < c_s, where r_t is the stateless
per-vertex hash shared by every seed. Both are single IEEE operations,
so the inclusion sets match the reference bit for bit. The other
configurations (LABOR-i / LABOR-*, NS via per-edge randomness,
sequential Poisson, layer dependency, weighted graphs) are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.interface import (LayerCaps, SampledLayer, Sampler,
                                        SamplerSpec, build_block)
from repro_torch.graph.csr import Graph, expand_seed_edges


@dataclasses.dataclass(frozen=True)
class LaborConfig:
    fanouts: Sequence[int]
    importance_iters: int = 0
    layer_dependency: bool = False
    per_edge_rng: bool = False
    exact_k: bool = False
    fast_solve: bool = True

    def __post_init__(self):
        if (self.importance_iters != 0 or self.layer_dependency
                or self.per_edge_rng or self.exact_k or not self.fast_solve):
            raise NotImplementedError(
                "only LABOR-0 (importance_iters=0, fast_solve=True, no "
                "layer dependency, per-vertex randomness) is ported")


def layer_inclusion(graph: Graph, seeds: torch.Tensor, salt: int, k: int,
                    caps: LayerCaps, *, backend: Optional[str] = None):
    """The sampling decision of one LABOR-0 layer, before the block
    epilogue: (expanded neighbourhood, include bool[expand_cap],
    1/p_ts float32[expand_cap])."""
    if graph.weights is not None:
        raise NotImplementedError("weighted graphs (§A.7) are not ported")
    S = seeds.shape[0]
    exp = expand_seed_edges(graph, seeds, caps.expand_cap, backend=backend)
    src, slot, mask, deg = exp["src"], exp["seed_slot"], exp["mask"], exp["deg"]

    # uniform pi: c = k/d for k < d, 1 otherwise (tensor / tensor keeps
    # the IEEE division; a Python scalar / tensor would multiply by a
    # reciprocal)
    degf = deg.to(torch.float32)
    kf = torch.full_like(degf, float(k))
    c = torch.where(deg > 0,
                    torch.where(kf >= degf, 1.0,
                                kf / torch.clamp(degf, min=1.0)), 0.0)
    r = rng_lib.hash_uniform(salt, src)
    c_e = c[torch.clamp(slot, 0, S - 1).long()]
    prob = torch.clamp(c_e, max=1.0)           # min(1, c_s * pi_t), pi = 1
    include = mask & (r < c_e)
    inv_p = torch.ones_like(prob) / torch.clamp(prob, min=1e-20)
    return exp, include, inv_p


def sample_layer(graph: Graph, seeds: torch.Tensor, salt: int, k: int,
                 caps: LayerCaps, *,
                 backend: Optional[str] = None) -> SampledLayer:
    """One layer of LABOR-0 for padded ``seeds`` (int32[S], -1 pad)."""
    exp, include, inv_p = layer_inclusion(graph, seeds, salt, k, caps,
                                          backend=backend)
    return build_block(seeds, exp, include, inv_p, caps, backend=backend)


def sample_with_salts(cfg: LaborConfig, caps: Sequence[LayerCaps],
                      graph: Graph, seeds: torch.Tensor,
                      salts: Sequence[int], *,
                      backend: Optional[str] = None) -> List[SampledLayer]:
    """Multi-layer sampling; each layer's ``next_seeds`` seed the next."""
    blocks = []
    cur = seeds
    for layer, (k, lcaps) in enumerate(zip(cfg.fanouts, caps)):
        blk = sample_layer(graph, cur, salts[layer], k, lcaps,
                           backend=backend)
        blocks.append(blk)
        cur = blk.next_seeds
    return blocks


@dataclasses.dataclass(frozen=True)
class LaborSampler(Sampler):
    """Multi-layer LABOR-0 sampler on the ``Sampler`` protocol."""
    config: LaborConfig = None

    @classmethod
    def build(cls, config: LaborConfig, caps: Sequence[LayerCaps],
              name: Optional[str] = None) -> "LaborSampler":
        if len(caps) != len(config.fanouts):
            raise ValueError("need one LayerCaps per fanout")
        config = dataclasses.replace(config, fanouts=tuple(config.fanouts))
        spec = SamplerSpec(name=name or "labor-0", budgets=config.fanouts,
                           caps=tuple(caps))
        return cls(spec=spec, config=config)

    def sample(self, graph: Graph, seeds: torch.Tensor, salts: Sequence[int],
               *, backend: Optional[str] = None) -> List[SampledLayer]:
        return sample_with_salts(self.config, self.spec.caps, graph, seeds,
                                 salts, backend=backend)
