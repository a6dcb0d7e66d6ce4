"""LABOR sampling (paper §3.2) and Neighbor Sampling as its degenerate
case (twin of ``repro.core.labor``).

With uniform pi (``importance_iters=0``) the per-seed scale c_s has the
closed form c = k/d for k < d and 1 otherwise (``fast_solve``). LABOR-0
includes an in-edge t -> s iff r_t < c_s, where r_t is the stateless
per-vertex hash shared by every seed; ``per_edge_rng`` draws a per-edge
r_ts instead (NS, the end of §3.2), and ``exact_k`` replaces the
Poisson test by sequential Poisson sampling (§A.3): each seed takes the
min(k, d_s) smallest r / c_s of its segment, through the frontier
primitive ``segment_select`` -- which reproduces vanilla NS exactly.
Every decision is a single IEEE operation per edge, so the inclusion
sets match the reference bit for bit. Importance iterations (LABOR-i,
LABOR-*), layer dependency and weighted graphs are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.interface import (LayerCaps, SampledLayer, Sampler,
                                        SamplerSpec, build_block)
from repro_torch.graph.csr import Graph, expand_seed_edges
from repro_torch.ops import frontier as frontier_ops


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
                or not self.fast_solve):
            raise NotImplementedError(
                "only uniform pi (importance_iters=0, fast_solve=True) "
                "without layer dependency is ported: LABOR-0 and NS")


def _exact_k_include(r: torch.Tensor, c_e: torch.Tensor, exp: dict, k: int,
                     *, backend: Optional[str] = None) -> torch.Tensor:
    """Sequential Poisson (§A.3): per segment the min(k, d) smallest
    r / (c_s pi_t), through ``segment_select``. pi = 1 here, so
    c_s pi_t is c_s exactly; masked edges get the largest key."""
    mask = exp["mask"]
    ratio = torch.where(mask, r / torch.clamp(c_e, min=1e-20),
                        torch.tensor(3.4e38, dtype=torch.float32,
                                     device=r.device))
    keys = torch.minimum(ratio, torch.tensor(1e30, dtype=torch.float32,
                                             device=r.device))
    take = torch.clamp(exp["deg"], max=k).to(torch.int32)
    return frontier_ops.segment_select(keys, exp["seed_slot"], mask,
                                       exp["seg_start"], take,
                                       backend=backend, n_live=exp["live"])


def layer_inclusion(graph: Graph, seeds: torch.Tensor, salt: int, k: int,
                    caps: LayerCaps, *, per_edge_rng: bool = False,
                    exact_k: bool = False, backend: Optional[str] = None):
    """The sampling decision of one layer (LABOR-0, or NS with
    ``per_edge_rng`` and ``exact_k``), before the block epilogue:
    (expanded neighbourhood, include bool[expand_cap], 1/p_ts
    float32[expand_cap])."""
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
    safe_slot = torch.clamp(slot, 0, S - 1).long()
    if per_edge_rng:
        r = rng_lib.hash_uniform_edge(
            salt, src, torch.where(mask, seeds[safe_slot], 0))
    else:
        r = rng_lib.hash_uniform(salt, src)
    c_e = c[safe_slot]
    prob = torch.clamp(c_e, max=1.0)           # min(1, c_s * pi_t), pi = 1
    if exact_k:
        include = _exact_k_include(r, c_e, exp, k, backend=backend)
    else:
        include = mask & (r < c_e)
    inv_p = torch.ones_like(prob) / torch.clamp(prob, min=1e-20)
    return exp, include, inv_p


def sample_layer(graph: Graph, seeds: torch.Tensor, salt: int, k: int,
                 caps: LayerCaps, *, per_edge_rng: bool = False,
                 exact_k: bool = False,
                 backend: Optional[str] = None) -> SampledLayer:
    """One layer of LABOR-0 (or NS) for padded ``seeds`` (int32[S], -1
    pad)."""
    exp, include, inv_p = layer_inclusion(graph, seeds, salt, k, caps,
                                          per_edge_rng=per_edge_rng,
                                          exact_k=exact_k, backend=backend)
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
                           per_edge_rng=cfg.per_edge_rng,
                           exact_k=cfg.exact_k, backend=backend)
        blocks.append(blk)
        cur = blk.next_seeds
    return blocks


@dataclasses.dataclass(frozen=True)
class LaborSampler(Sampler):
    """Multi-layer LABOR-0 / NS sampler on the ``Sampler`` protocol."""
    config: LaborConfig = None

    @classmethod
    def build(cls, config: LaborConfig, caps: Sequence[LayerCaps],
              name: Optional[str] = None) -> "LaborSampler":
        if len(caps) != len(config.fanouts):
            raise ValueError("need one LayerCaps per fanout")
        config = dataclasses.replace(config, fanouts=tuple(config.fanouts))
        spec = SamplerSpec(name=name or ("ns" if config.per_edge_rng
                                         else "labor-0"),
                           budgets=config.fanouts,
                           caps=tuple(caps))
        return cls(spec=spec, config=config)

    def sample(self, graph: Graph, seeds: torch.Tensor, salts: Sequence[int],
               *, backend: Optional[str] = None) -> List[SampledLayer]:
        return sample_with_salts(self.config, self.spec.caps, graph, seeds,
                                 salts, backend=backend)
