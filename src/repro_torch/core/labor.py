"""LABOR sampling (paper §3.2) and Neighbor Sampling as its degenerate
case (twin of ``repro.core.labor``).

One call to :func:`sample_layer` samples one layer for a padded seed
set; :class:`LaborSampler` recurses it over layers. An in-edge t -> s
is included iff r_t < c_s * pi_t, where r_t is the stateless per-vertex
hash shared by every seed. With uniform pi (``importance_iters=0``,
LABOR-0) c_s has the closed form k/d for k < d and 1 otherwise
(``fast_solve``). LABOR-i runs i fixed-point iterations of eq. 18
(pi_t <- pi_t * max_{t->s} c_s), each solving c_s (``solve_cs``), and
LABOR-* (``CONVERGE``) iterates until the relative change of E[|T|]
falls below ``converge_tol`` (§4.3). The per-vertex pi lives on the
deduplicated candidate frontier (the unique expanded sources, through
``hash_dedup``), never on a vertex-sized buffer, except in the dense
mode of the multi-device engine (below). ``layer_dependency``
reuses one salt, hence r_t, across layers (labor-d, §A.8).
``per_edge_rng`` draws a per-edge r_ts instead (NS, the end of §3.2),
and ``exact_k`` replaces the Poisson test by sequential Poisson
sampling (§A.3): each seed takes the min(k, d_s) smallest r / (c_s
pi_t) of its segment through ``segment_select``.

LABOR-0, labor-d and NS decide every edge in one IEEE operation and
match the reference bit for bit. LABOR-i and LABOR-* decide through
float sums (c_s, E[|T|]), summed here in a fixed order: on the CPU the
per-seed sums equal XLA's, while the totals of the convergence test
may differ in the last bit. The LABOR-* loop reads its condition on
the host once per iteration (``cs_solve.HOST_READS``). On a weighted
graph (§A.7) pi starts at the edge weights A_ts and c_s comes from
``solve_cs_weighted``; ``importance_iters`` is not consulted there, as
in the reference.

On a rank of the multi-device engine
(:meth:`LaborSampler.sample_layer_partitioned`) the seeds are the
rank's owned share of the layer's frontier, read from its partition's
CSR at ``seed_rows`` with global ids, and pi lives on a dense
vertex-sized vector (``dense``): eq. 18's max over destinations is
completed with the mesh's ``pmax`` (exact in any order), so pi, c_s and
every decision are the single-device ones; ``solve_cs`` takes its
residual's max over the ranks too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.cs_solve import read_flag, solve_cs, solve_cs_weighted
from repro_torch.core.interface import (LayerCaps, SampledLayer, Sampler,
                                        SamplerSpec, build_block)
from repro_torch.graph.csr import Graph, expand_seed_edges
from repro_torch.ops import frontier as frontier_ops

CONVERGE = -1  # importance_iters value for LABOR-*


@dataclasses.dataclass(frozen=True)
class LaborConfig:
    fanouts: Sequence[int]
    importance_iters: int = 0       # 0, i (LABOR-i) or CONVERGE (LABOR-*)
    layer_dependency: bool = False  # reuse r_t across layers (§A.8)
    per_edge_rng: bool = False      # r_ts instead of r_t: Neighbor Sampling
    exact_k: bool = False           # sequential Poisson (§A.3): min(k, d_s)
    converge_tol: float = 1e-4      # paper: rel change of E[|T|] < 1e-4
    converge_max_iters: int = 30
    # closed-form uniform-pi c + warm-started importance solves; False
    # reproduces the original cold-start solver (benchmark baseline)
    fast_solve: bool = True

    def __post_init__(self):
        if self.importance_iters < CONVERGE:
            raise ValueError(f"importance_iters {self.importance_iters}: "
                             "use i >= 0, or CONVERGE (-1) for LABOR-*")


def _expected_num_sampled(pi: torch.Tensor, max_c: torch.Tensor
                          ) -> torch.Tensor:
    """E[|T|] = sum_t min(1, pi_t * max_{t->s} c_s)   (eq. 11)."""
    return torch.sum(torch.clamp(pi * max_c, max=1.0))


def _scatter_max_c(c_edges: torch.Tensor, src: torch.Tensor,
                   mask: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """max_{t->s} c_s per source vertex t, dense over V (0 elsewhere)."""
    idx = torch.where(mask, src, 0).long()
    vals = torch.where(mask, c_edges, 0.0)
    return torch.zeros(num_vertices, dtype=torch.float32,
                       device=src.device).scatter_reduce_(0, idx, vals,
                                                          "amax")


def run_importance_iterations(graph: Graph, exp: dict, k, num_seeds: int,
                              importance_iters: int,
                              converge_tol: float = 1e-4,
                              converge_max_iters: int = 30,
                              fast_solve: bool = True, *,
                              num_vertices: Optional[int] = None,
                              mesh=None, dense: Optional[bool] = None,
                              backend: Optional[str] = None,
                              log: Optional[dict] = None):
    """Fixed-point iterations on pi (eq. 18): pi_t <- pi_t * max_{t->s} c_s.

    Returns (pi_e float32[expand_cap], pi gathered per expanded edge;
    c float32[S]). For ``importance_iters == 0`` this is one c solve
    with uniform pi: the closed form under ``fast_solve``, else the
    cold-start solver. Per-vertex pi lives on the candidate frontier
    (one slot per unique expanded source, from ``hash_dedup``).

    ``log``, when given, receives ``outer`` (LABOR-*'s iteration count)
    and ``solves`` (each ``solve_cs`` call's iteration count, an int32
    device scalar, in call order).

    ``dense`` (implied by ``mesh``) keeps pi on a dense vector over
    ``num_vertices`` (default: the graph's) instead of the candidate
    frontier, the layout the multi-device engine's ``pmax`` needs: each
    vertex's pi takes the same factors either way, so the fixed point
    is the same per vertex."""
    if dense is None:
        dense = mesh is not None
    src, slot, mask = exp["src"], exp["seed_slot"], exp["mask"]
    deg = exp["deg"]
    E = src.shape[0]
    S = num_seeds
    dev = src.device
    solves = None if log is None else log.setdefault("solves", [])

    if importance_iters == 0:
        pi_e = torch.ones(E, dtype=torch.float32, device=dev)
        if not fast_solve:
            return pi_e, solve_cs(pi_e, slot, deg, k, S, mask,
                                  iters_out=solves)
        # uniform pi: eq. 14 reduces to c = k/d for k < d, 1 otherwise
        # (tensor / tensor keeps the IEEE division; a Python scalar /
        # tensor would multiply by a reciprocal)
        degf = deg.to(torch.float32)
        kf = torch.broadcast_to(torch.as_tensor(k, dtype=torch.float32,
                                                device=dev), (S,))
        c = torch.where(deg > 0,
                        torch.where(kf >= degf, 1.0,
                                    kf / torch.clamp(degf, min=1.0)), 0.0)
        return pi_e, c

    safe_slot = torch.clamp(slot, 0, S - 1).long()
    if dense:
        V = num_vertices if num_vertices is not None else graph.num_vertices
        gather = torch.where(mask, src, 0).long()

        def fac_of(c):
            fac = _scatter_max_c(c[safe_slot], src, mask, V)
            return fac if mesh is None else mesh.pmax(fac)

        pi0 = torch.ones(V, dtype=torch.float32, device=dev)
    else:
        # candidate frontier: one slot per unique expanded source
        dd = frontier_ops.hash_dedup(src, mask, None, E, backend=backend,
                                     n_live=exp["live"])
        cidx = torch.where(mask, dd.slots, E).long()
        gather = torch.clamp(cidx, 0, E - 1)
        pi0 = torch.ones(E, dtype=torch.float32, device=dev)

        def fac_of(c):
            # max_{t->s} c_s per candidate (max is exact in any order)
            c_e = torch.where(mask, c[safe_slot], 0.0)
            out = torch.zeros(E + 1, dtype=torch.float32, device=dev)
            return out.scatter_reduce_(0, cidx, c_e, "amax")[:E]

    def c_of(pi, c_prev=None):
        return solve_cs(pi[gather], slot, deg, k, S, mask,
                        c_init=c_prev if fast_solve else None,
                        iters_out=solves, mesh=mesh)

    def one_step(pi, c_prev=None):
        c = c_of(pi, c_prev)
        fac = fac_of(c)
        return torch.where(fac > 0, pi * fac, pi), c

    if importance_iters > 0:
        pi, c = pi0, None
        for _ in range(importance_iters):
            pi, c = one_step(pi, c)
        return pi[gather], c_of(pi, c)

    # LABOR-*: iterate until the relative change in E[|T|] < tol (§4.3);
    # at least 2 iterations, at most converge_max_iters
    def cost(pi, c):
        return _expected_num_sampled(pi, fac_of(c))

    c = c_of(pi0)
    pi, prev_cost = pi0, cost(pi0, c)
    rel = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    i = 0
    while i < converge_max_iters and (
            i < 2 or read_flag(rel > converge_tol, "labor_star")):
        pi_new, c_mid = one_step(pi, c)
        c = c_of(pi_new, c_mid)
        new_cost = cost(pi_new, c)
        rel = torch.abs(prev_cost - new_cost) / torch.clamp(new_cost,
                                                            min=1.0)
        pi, prev_cost, i = pi_new, new_cost, i + 1
    if log is not None:
        log["outer"] = i
    return pi[gather], c_of(pi, c)


def _exact_k_include_dense(r: torch.Tensor, exp: dict, k: int
                           ) -> torch.Tensor:
    """The original global-sort sequential Poisson, the O(E log E)
    baseline and the oracle ``segment_select`` is held to: a stable
    sort by (slot, key), then the first min(k, d_s) of each segment.
    Not on any sampling path."""
    slot, mask = exp["seed_slot"], exp["mask"]
    deg, seg_start = exp["deg"], exp["seg_start"]
    S = deg.shape[0]
    E = r.shape[0]
    dev = r.device
    key = torch.where(mask, torch.clamp(r, max=1e30),
                      torch.tensor(3.4e38, dtype=torch.float32, device=dev))
    slot_sort = torch.where(mask, slot, S)
    # lexsort((key, slot)): by slot, ties by key, ties by position
    order = torch.argsort(key, stable=True)
    order = order[torch.argsort(slot_sort[order], stable=True)]
    slot_s = slot_sort[order]
    safe = torch.clamp(slot_s, 0, S - 1).long()
    pos = torch.arange(E, dtype=torch.int32, device=dev)
    pos_in_seg = pos - torch.where(slot_s < S, seg_start[safe], 0)
    take = torch.clamp(deg[safe], max=k)
    inc_sorted = (slot_s < S) & (pos_in_seg < take)
    out = torch.zeros(E, dtype=torch.bool, device=dev)
    out[order] = inc_sorted
    return out


def _exact_k_include(r: torch.Tensor, exp: dict, k: int, *,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Sequential Poisson (§A.3): per segment the min(k, d) smallest
    keys, through ``segment_select``. ``r`` is already divided by
    c_s pi_t (masked edges hold the largest key)."""
    keys = torch.minimum(r, torch.tensor(1e30, dtype=torch.float32,
                                         device=r.device))
    take = torch.clamp(exp["deg"], max=k).to(torch.int32)
    return frontier_ops.segment_select(keys, exp["seed_slot"], exp["mask"],
                                       exp["seg_start"], take,
                                       backend=backend, n_live=exp["live"])


def layer_inclusion(graph: Graph, seeds: torch.Tensor, salt: int, k: int,
                    caps: LayerCaps, *, importance_iters: int = 0,
                    per_edge_rng: bool = False, exact_k: bool = False,
                    converge_tol: float = 1e-4, converge_max_iters: int = 30,
                    fast_solve: bool = True,
                    seed_rows: Optional[torch.Tensor] = None,
                    num_vertices: Optional[int] = None, mesh=None,
                    backend: Optional[str] = None):
    """The sampling decision of one layer, before the block epilogue:
    (expanded neighbourhood, include bool[expand_cap], 1/p_ts
    float32[expand_cap]). ``seed_rows``/``num_vertices``/``mesh`` are
    the partition-local mode (module docstring)."""
    S = seeds.shape[0]
    exp = expand_seed_edges(graph, seeds, caps.expand_cap,
                            seed_rows=seed_rows, backend=backend)
    src, slot, mask = exp["src"], exp["seed_slot"], exp["mask"]
    if graph.weights is None:
        pi_e, c = run_importance_iterations(
            graph, exp, k, S, importance_iters, converge_tol,
            converge_max_iters, fast_solve, num_vertices=num_vertices,
            mesh=mesh, backend=backend)
    else:
        # weighted (§A.7): per-edge pi starts at A_ts
        a_e = exp["edge_weight"]
        pi_e = torch.where(mask, a_e, 1.0)
        c = solve_cs_weighted(pi_e, a_e, slot, exp["deg"], k, S, mask)

    safe_slot = torch.clamp(slot, 0, S - 1).long()
    if per_edge_rng:
        r = rng_lib.hash_uniform_edge(
            salt, src, torch.where(mask, seeds[safe_slot], 0))
    else:
        r = rng_lib.hash_uniform(salt, src)
    c_e = c[safe_slot]
    cp = c_e * pi_e
    prob = torch.clamp(c_e * torch.clamp(pi_e, min=0.0), max=1.0)
    if exact_k:
        ratio = torch.where(mask, r / torch.clamp(cp, min=1e-20),
                            torch.tensor(3.4e38, dtype=torch.float32,
                                         device=r.device))
        include = _exact_k_include(ratio, exp, k, backend=backend)
    else:
        include = mask & (r < cp)
    inv_p = torch.ones_like(prob) / torch.clamp(prob, min=1e-20)
    return exp, include, inv_p


def sample_layer(graph: Graph, seeds: torch.Tensor, salt: int, k: int,
                 caps: LayerCaps, *, importance_iters: int = 0,
                 per_edge_rng: bool = False, exact_k: bool = False,
                 converge_tol: float = 1e-4, converge_max_iters: int = 30,
                 fast_solve: bool = True,
                 backend: Optional[str] = None) -> SampledLayer:
    """One layer of LABOR-i sampling for padded ``seeds`` (int32[S], -1
    pad); Hajek weights, compaction and ``next_seeds`` come from the
    shared epilogue ``build_block``."""
    exp, include, inv_p = layer_inclusion(
        graph, seeds, salt, k, caps, importance_iters=importance_iters,
        per_edge_rng=per_edge_rng, exact_k=exact_k,
        converge_tol=converge_tol, converge_max_iters=converge_max_iters,
        fast_solve=fast_solve, backend=backend)
    return build_block(seeds, exp, include, inv_p, caps, backend=backend)


def layer_salts(cfg: LaborConfig, key: rng_lib.Key) -> List[int]:
    """Per-layer uint32 salts for ``cfg`` from a threefry key;
    ``layer_dependency`` repeats the base salt (§A.8)."""
    return rng_lib.layer_salts_from_key(key, len(cfg.fanouts),
                                        shared=cfg.layer_dependency)


def sample_with_salts(cfg: LaborConfig, caps: Sequence[LayerCaps],
                      graph: Graph, seeds: torch.Tensor,
                      salts: Sequence[int], *,
                      backend: Optional[str] = None) -> List[SampledLayer]:
    """Multi-layer sampling from an explicit per-layer salt schedule;
    each layer's ``next_seeds`` seed the next."""
    blocks = []
    cur = seeds
    for layer, (k, lcaps) in enumerate(zip(cfg.fanouts, caps)):
        blk = sample_layer(graph, cur, salts[layer], k, lcaps,
                           importance_iters=cfg.importance_iters,
                           per_edge_rng=cfg.per_edge_rng,
                           exact_k=cfg.exact_k,
                           converge_tol=cfg.converge_tol,
                           converge_max_iters=cfg.converge_max_iters,
                           fast_solve=cfg.fast_solve, backend=backend)
        blocks.append(blk)
        cur = blk.next_seeds
    return blocks


def sample_with_salt(cfg: LaborConfig, caps: Sequence[LayerCaps],
                     graph: Graph, seeds: torch.Tensor, salt: int, *,
                     backend: Optional[str] = None) -> List[SampledLayer]:
    """Multi-layer sampling from a raw uint32 salt: layer salts are
    remixed from it unless ``layer_dependency`` is set
    (``Sampler.sample_with_salt`` of the configured sampler)."""
    return LaborSampler.build(cfg, caps).sample_with_salt(
        graph, seeds, salt, backend=backend)


def _labor_name(cfg: LaborConfig) -> str:
    """Canonical registry name for a LABOR-family config."""
    if cfg.per_edge_rng:
        return "ns"
    if cfg.layer_dependency and cfg.importance_iters == 0:
        return "labor-d"
    if cfg.importance_iters == CONVERGE:
        return "labor-*"
    return f"labor-{cfg.importance_iters}"


@dataclasses.dataclass(frozen=True)
class LaborSampler(Sampler):
    """Multi-layer LABOR-i sampler (paper Algorithm 1 over l layers) on
    the ``Sampler`` protocol."""
    config: LaborConfig = None

    @classmethod
    def build(cls, config: LaborConfig, caps: Sequence[LayerCaps],
              name: Optional[str] = None) -> "LaborSampler":
        if len(caps) != len(config.fanouts):
            raise ValueError("need one LayerCaps per fanout")
        config = dataclasses.replace(config, fanouts=tuple(config.fanouts))
        spec = SamplerSpec(name=name or _labor_name(config),
                           budgets=config.fanouts, caps=tuple(caps),
                           shared_salts=config.layer_dependency)
        return cls(spec=spec, config=config)

    def with_caps(self, caps: Sequence[LayerCaps]) -> "LaborSampler":
        if len(caps) != len(self.config.fanouts):
            raise ValueError("need one LayerCaps per fanout")
        return super().with_caps(caps)

    def sample(self, graph: Graph, seeds: torch.Tensor, salts: Sequence[int],
               *, backend: Optional[str] = None) -> List[SampledLayer]:
        return sample_with_salts(self.config, self.spec.caps, graph, seeds,
                                 salts, backend=backend)

    def sample_layer_partitioned(self, graph: Graph, seeds: torch.Tensor,
                                 salt: int, layer: int, *,
                                 seed_rows: torch.Tensor, num_vertices: int,
                                 mesh=None, backend: Optional[str] = None
                                 ) -> SampledLayer:
        cfg = self.config
        caps = self.spec.caps[layer]
        exp, include, inv_p = layer_inclusion(
            graph, seeds, salt, cfg.fanouts[layer], caps,
            importance_iters=cfg.importance_iters,
            per_edge_rng=cfg.per_edge_rng, exact_k=cfg.exact_k,
            converge_tol=cfg.converge_tol,
            converge_max_iters=cfg.converge_max_iters,
            fast_solve=cfg.fast_solve, seed_rows=seed_rows,
            num_vertices=num_vertices, mesh=mesh, backend=backend)
        return build_block(seeds, exp, include, inv_p, caps,
                           backend=backend)


def neighbor_sampler(fanouts: Sequence[int], caps: Sequence[LayerCaps],
                     exact: bool = True) -> LaborSampler:
    """Vanilla Neighbor Sampling (Hamilton et al. 2017) as the degenerate
    LABOR configuration: per-edge randomness, uniform pi; ``exact=True``
    takes exactly min(k, d_s) neighbours."""
    return LaborSampler.build(
        LaborConfig(fanouts=tuple(fanouts), importance_iters=0,
                    per_edge_rng=True, exact_k=exact), caps)


def labor_sampler(fanouts: Sequence[int], caps: Sequence[LayerCaps],
                  variant=0, layer_dependency: bool = False) -> LaborSampler:
    """LABOR-i factory. variant: 0, 1, 2, ... or '*' for convergence."""
    iters = CONVERGE if variant in ("*", CONVERGE) else int(variant)
    return LaborSampler.build(
        LaborConfig(fanouts=tuple(fanouts), importance_iters=iters,
                    layer_dependency=layer_dependency), caps)
