"""Synthetic graph generators calibrated to the paper's datasets (numpy
copy of ``repro.graph.generators``: the same seed gives the same graph,
features, labels and splits).

A degree-corrected stochastic block model whose (|V|, average degree,
skew) match the paper's Table 1 at a configurable scale, with features
= community centroid + noise and labels = community.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.graph.csr import Graph, from_coo


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_vertices: int
    avg_degree: float
    num_features: int
    num_classes: int
    train_frac: float
    val_frac: float
    # degree-distribution skew: 0 = near-regular, 1 = heavy power law
    skew: float
    # paper Table 1 |V^3| sampling budget (scaled with the graph)
    budget: int


# Paper Table 1, scaled by `scale` at generation time.
PAPER_DATASETS: Dict[str, DatasetSpec] = {
    "reddit": DatasetSpec("reddit", 232_965, 493.56, 602, 41, 0.66, 0.10, 0.85, 60_000),
    "products": DatasetSpec("products", 2_449_029, 25.26, 100, 47, 0.08, 0.02, 0.70, 400_000),
    "yelp": DatasetSpec("yelp", 716_847, 19.52, 300, 100, 0.75, 0.10, 0.55, 200_000),
    "flickr": DatasetSpec("flickr", 89_250, 10.09, 500, 7, 0.50, 0.25, 0.55, 70_000),
}


@dataclasses.dataclass
class GraphDataset:
    spec: DatasetSpec
    graph: Graph          # on the CPU; TrainEngine.make_data moves it
    features: np.ndarray  # float32[V, F]
    labels: np.ndarray    # int32[V]
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    max_in_degree: int


def _power_law_degrees(n: int, avg: float, skew: float, rng: np.random.Generator,
                       d_max: int | None = None) -> np.ndarray:
    """Sample in-degrees with mean ``avg`` and controllable tail weight."""
    if skew <= 1e-3:
        deg = np.full(n, avg)
    else:
        # Pareto tail mixed with a uniform body; alpha shrinks with skew.
        alpha = 3.5 - 2.3 * skew
        raw = (rng.pareto(alpha, size=n) + 1.0)
        deg = raw / raw.mean() * avg
    if d_max is None:
        d_max = int(min(n - 1, max(4 * avg, avg * n ** 0.33)))
    deg = np.clip(deg, 1, d_max)
    # restore mean after clipping
    deg *= avg / max(deg.mean(), 1e-9)
    deg = np.clip(deg, 1, d_max)
    ideg = np.floor(deg).astype(np.int64)
    frac = deg - ideg
    ideg += (rng.random(n) < frac).astype(np.int64)
    return ideg


def generate(spec: DatasetSpec, scale: float = 1.0, seed: int = 0,
             feature_dim: int | None = None, d_max: int | None = None) -> GraphDataset:
    """Generate a dataset matching ``spec`` scaled down by ``scale``.

    An edge's source is drawn from the destination's community with
    probability 0.75, else globally, popularity-weighted, so
    neighbourhoods overlap heavily inside communities (what LABOR
    exploits) and labels are graph-correlated.
    """
    rng = np.random.default_rng(seed)
    n = max(int(spec.num_vertices * scale), 256)
    avg = spec.avg_degree
    nfeat = feature_dim if feature_dim is not None else spec.num_features
    ncls = spec.num_classes

    deg = _power_law_degrees(n, avg, spec.skew, rng, d_max=d_max)
    m = int(deg.sum())

    comm_sizes = rng.dirichlet(np.full(ncls, 0.6))
    comm = rng.choice(ncls, size=n, p=comm_sizes)
    pop = deg.astype(np.float64) + 1.0

    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    q = 0.75  # in-community edge fraction
    in_comm = rng.random(m) < q

    src = np.empty(m, dtype=np.int64)
    glob_p = pop / pop.sum()
    n_glob = int((~in_comm).sum())
    src[~in_comm] = rng.choice(n, size=n_glob, p=glob_p)
    # the in-community edges grouped by their destination's community,
    # each group in edge order (a stable sort): the edges ``in_comm &
    # (comm[dst] == c)`` selects, found once instead of once a class
    local = np.nonzero(in_comm)[0]
    local_comm = comm[dst[local]]
    local = local[np.argsort(local_comm, kind="stable")]
    ends = np.searchsorted(np.sort(local_comm), np.arange(ncls + 1))
    for c in range(ncls):
        members = np.nonzero(comm == c)[0]
        if members.size == 0:
            members = np.arange(n)
        sel = local[ends[c]:ends[c + 1]]
        k = sel.shape[0]
        if k == 0:
            continue
        p = pop[members] / pop[members].sum()
        src[sel] = members[rng.choice(members.size, size=k, p=p)]

    g = from_coo(src, dst, n, dedup=True)
    indptr = g.indptr.numpy()
    max_in_degree = int(np.max(np.diff(indptr))) if n > 0 else 0

    centroids = rng.normal(0, 1, size=(ncls, nfeat)).astype(np.float32)
    feats = centroids[comm] + rng.normal(0, 1.5, size=(n, nfeat)).astype(np.float32)
    labels = comm.astype(np.int32)

    perm = rng.permutation(n)
    n_tr = int(spec.train_frac * n)
    n_va = int(spec.val_frac * n)
    return GraphDataset(
        spec=spec,
        graph=g,
        features=feats,
        labels=labels,
        train_idx=perm[:n_tr],
        val_idx=perm[n_tr:n_tr + n_va],
        test_idx=perm[n_tr + n_va:],
        max_in_degree=max_in_degree,
    )


def paper_dataset(name: str, scale: float = 1.0, seed: int = 0,
                  feature_dim: int | None = None, d_max: int | None = None) -> GraphDataset:
    return generate(PAPER_DATASETS[name], scale=scale, seed=seed,
                    feature_dim=feature_dim, d_max=d_max)
