"""LADIES (Zou et al. 2019) baseline and PLADIES (paper §3.1); twin of
``repro.core.ladies``.

Both sample a number ``n`` of vertices per layer with probabilities
proportional to the squared column norms of the row-normalised
adjacency restricted to the seeds:  p_t  ∝  sum_{s in S, t->s} 1/d_s^2.

* LADIES: n draws WITH replacement (inverse CDF, ``masked_cdf_draw``),
  deduplicated, with the reference implementation's weights
  total / (n p_t), Hajek row-normalised;
* PLADIES: Poisson sampling with inclusion probabilities
  pi_t = min(1, lam p_t), water-filled so that sum pi = n, weights
  1 / pi_t.

Blocks carry every edge from a sampled vertex into the seeds. The
randomness hashes a per-layer uint32 salt, as in the LABOR family.
Every per-vertex quantity lives on the candidate frontier (the unique
expanded sources, from ``hash_dedup``), never on a vertex-sized buffer.

The column norms are summed per candidate in a fixed order (a stable
sort by candidate, then one reduction per run, no atomics): on the CPU
in edge order, XLA's scatter order, and on the card the same in every
run. The
water-fill's totals are ``torch.sum``s, which may differ from the
reference's in the last bit. Its grow loop (at most 20 iterations, as
``hi`` stops below 1e12) and its 50 bisection steps run with the state
frozen on the device: no host read. On a weighted graph (§A.7) each
edge's column-norm term carries A_ts^2.

On a rank of the multi-device engine
(:meth:`LadiesSampler.sample_layer_partitioned`) each rank holds its
owned share of the layer's seeds and adds their column-norm terms into
a dense vertex-sized vector (``dense``); the mesh's ``psum`` completes
the batch-global p_t, and the water-fill, the draws and the
memberships run on that vector, the same on every rank. The psum adds
the ranks' partial sums in another association than the single-device
per-candidate sum, so p_t may differ from it in the last bit: the
sampled sets are equal in practice, not by construction (as in the
reference).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.cs_solve import _segment_sum_sorted, segment_offsets
from repro_torch.core.interface import (LayerCaps, SampledLayer, Sampler,
                                        SamplerSpec, build_block)
from repro_torch.graph.csr import Graph, expand_seed_edges
from repro_torch.ops import frontier as frontier_ops

#: the water-fill's grow loop multiplies hi = 1 by 4 while hi < 1e12
GROW_STEPS = 20


def _edge_contrib(exp: dict) -> torch.Tensor:
    """Per expanded edge: A_ts^2 / d_s^2, the column-norm term each edge
    contributes to its source's p_t (A_ts = 1 on an unweighted graph)."""
    slot, mask, deg = exp["seed_slot"], exp["mask"], exp["deg"]
    degf = torch.clamp(deg.to(torch.float32), min=1.0)
    d = degf[torch.clamp(slot, 0, deg.shape[0] - 1).long()]
    contrib = torch.where(mask, torch.ones_like(d) / d ** 2, 0.0)
    ew = exp.get("edge_weight")
    if ew is not None:
        contrib = contrib * torch.where(mask, ew ** 2, 0.0)
    return contrib


def _layer_probs(graph: Graph, exp: dict, num_vertices: int) -> torch.Tensor:
    """p_t ∝ sum_s A_ts^2 / d_s^2 over a dense vertex vector (0 outside
    N(S)): the multi-device layout (one aligned vector on every rank for
    the psum) and the oracle the candidate-frontier path is tested
    against."""
    del graph
    src, mask = exp["src"], exp["mask"]
    idx = torch.where(mask, src, 0).long()
    return torch.zeros(num_vertices, dtype=torch.float32,
                       device=src.device).index_add_(0, idx,
                                                     _edge_contrib(exp))


def _candidate_sum(vals: torch.Tensor, cidx: torch.Tensor,
                   mask: torch.Tensor, num: int, *,
                   backend: Optional[str] = None,
                   n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[c] = sum of vals[e] over masked e with cidx[e] == c in a fixed
    order: ``compact_perm`` sorts the edges stably by candidate, then
    each run is reduced without atomics."""
    perm = frontier_ops.compact_perm(cidx, mask, num, backend=backend,
                                     n_live=n_live).long()
    keys = torch.where(mask, cidx, -1)[perm]
    return _segment_sum_sorted(vals[perm], segment_offsets(keys, num))


def _waterfill_lambda(p: torch.Tensor, n: int, iters: int = 50
                      ) -> torch.Tensor:
    """lam with sum min(1, lam p) = n (monotone, so bisection), as a
    float32 device scalar."""
    dev = p.device
    total = torch.clamp(torch.sum(p), min=1e-20)
    nf = torch.tensor(float(n), dtype=torch.float32, device=dev)
    target = torch.tensor(n * 0.999, dtype=torch.float32, device=dev)

    def mass(lam):
        return torch.sum(torch.clamp(lam * p / total * nf, max=1.0))

    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.ones((), dtype=torch.float32, device=dev)
    for _ in range(GROW_STEPS):   # grow hi until feasible or all clipped
        grow = (mass(hi) < target) & (hi < 1e12)
        hi = torch.where(grow, hi * 4.0, hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        low = mass(mid) < nf
        lo, hi = torch.where(low, mid, lo), torch.where(low, hi, mid)
    return 0.5 * (lo + hi) / total * nf


def sample_layer_ladies(graph: Graph, seeds: torch.Tensor, salt: int, n: int,
                        caps: LayerCaps, poisson: bool = False, *,
                        seed_rows: Optional[torch.Tensor] = None,
                        num_vertices: Optional[int] = None, mesh=None,
                        dense: Optional[bool] = None,
                        backend: Optional[str] = None,
                        log: Optional[dict] = None) -> SampledLayer:
    """One LADIES (or, with ``poisson``, PLADIES) layer from a uint32
    ``salt``. ``log``, when given, receives the layer's candidate
    probabilities ``p`` and PLADIES's ``lam``. ``seed_rows``/
    ``num_vertices``/``mesh``/``dense`` are the partition-local mode
    (module docstring; ``dense`` is implied by ``mesh``)."""
    if dense is None:
        dense = mesh is not None
    exp = expand_seed_edges(graph, seeds, caps.expand_cap,
                            seed_rows=seed_rows, backend=backend)
    src, mask = exp["src"], exp["mask"]
    E = src.shape[0]
    dev = src.device
    if dense:
        V = num_vertices if num_vertices is not None else graph.num_vertices
        p = _layer_probs(graph, exp, V)
        if mesh is not None:
            p = mesh.psum(p)
        cands = torch.arange(V, dtype=torch.int32, device=dev)
        valid = p > 0
        cidx = torch.where(mask, src, 0)   # per-edge index into p
        E = V
    else:
        # candidate frontier: every distinct expanded source, ascending
        dd = frontier_ops.hash_dedup(src, mask, None, E, backend=backend,
                                     n_live=exp["live"])
        cands = dd.new
        cidx = torch.where(mask, dd.slots, 0)
        p = _candidate_sum(_edge_contrib(exp), cidx, mask, E,
                           backend=backend, n_live=exp["live"])
        valid = (cands >= 0) & (p > 0)

    if poisson:
        lam = _waterfill_lambda(p, n)
        pi = torch.clamp(lam * p, max=1.0)                   # sum pi = n
        r = rng_lib.hash_uniform(salt, cands)     # -1 pad hashes too
        member = (r < pi) & valid
        inv_pi = torch.where(member, torch.ones_like(pi)
                             / torch.clamp(pi, min=1e-20), 0.0)
    else:
        # n draws with replacement through the inverse CDF; the CDF is
        # normalised by its own final value and the draws are clipped
        total = torch.clamp(torch.sum(torch.where(valid, p, 0.0)),
                            min=1e-20)
        u = rng_lib.hash_uniform(salt, torch.arange(n, dtype=torch.int32,
                                                    device=dev))
        draws = frontier_ops.masked_cdf_draw(p, valid, u, backend=backend)
        member = torch.zeros(E, dtype=torch.bool, device=dev)
        member[draws.long()] = True
        member = member & valid
        # the reference implementation's weights: 1/(n p_t) as if HT
        inv_pi = torch.where(member, total / torch.clamp(p * n, min=1e-20),
                             0.0)
    if log is not None:
        log.update(p=p, valid=valid, lam=lam if poisson else None)

    # block edges: every edge t -> s with t sampled
    eidx = cidx.long()
    include = mask & member[eidx]
    return build_block(seeds, exp, include, inv_pi[eidx], caps,
                       backend=backend)


@dataclasses.dataclass(frozen=True)
class LadiesConfig:
    layer_sizes: Sequence[int]   # n per layer, outermost first
    poisson: bool = False        # True => PLADIES


@dataclasses.dataclass(frozen=True)
class LadiesSampler(Sampler):
    """LADIES/PLADIES on the ``Sampler`` protocol."""
    config: LadiesConfig = None

    @classmethod
    def build(cls, config: LadiesConfig, caps: Sequence[LayerCaps],
              name: Optional[str] = None) -> "LadiesSampler":
        if len(caps) != len(config.layer_sizes):
            raise ValueError("need one LayerCaps per layer size")
        config = dataclasses.replace(config,
                                     layer_sizes=tuple(config.layer_sizes))
        spec = SamplerSpec(name=name or ("pladies" if config.poisson
                                         else "ladies"),
                           budgets=config.layer_sizes, caps=tuple(caps))
        return cls(spec=spec, config=config)

    def with_caps(self, caps: Sequence[LayerCaps]) -> "LadiesSampler":
        if len(caps) != len(self.config.layer_sizes):
            raise ValueError("need one LayerCaps per layer size")
        return super().with_caps(caps)

    def sample(self, graph: Graph, seeds: torch.Tensor, salts: Sequence[int],
               *, backend: Optional[str] = None) -> List[SampledLayer]:
        blocks = []
        cur = seeds
        for layer, (n, caps) in enumerate(zip(self.config.layer_sizes,
                                              self.spec.caps)):
            blk = sample_layer_ladies(graph, cur, salts[layer], n, caps,
                                      poisson=self.config.poisson,
                                      backend=backend)
            blocks.append(blk)
            cur = blk.next_seeds
        return blocks

    def sample_layer_partitioned(self, graph: Graph, seeds: torch.Tensor,
                                 salt: int, layer: int, *,
                                 seed_rows: torch.Tensor, num_vertices: int,
                                 mesh=None, backend: Optional[str] = None
                                 ) -> SampledLayer:
        return sample_layer_ladies(
            graph, seeds, salt, self.config.layer_sizes[layer],
            self.spec.caps[layer], poisson=self.config.poisson,
            seed_rows=seed_rows, num_vertices=num_vertices, mesh=mesh,
            backend=backend)


def ladies_sampler(layer_sizes, caps) -> LadiesSampler:
    return LadiesSampler.build(LadiesConfig(tuple(layer_sizes),
                                            poisson=False), caps)


def pladies_sampler(layer_sizes, caps) -> LadiesSampler:
    return LadiesSampler.build(LadiesConfig(tuple(layer_sizes),
                                            poisson=True), caps)
