"""Sampler registry (twin of ``repro.core.samplers``): one namespace and
one construction path from graph statistics to a configured sampler,
with the reference's eight entries in its order (plus ``labor-<i>`` for
any i >= 0):

  ns        vanilla Neighbor Sampling (LABOR degenerate case, §3.2/§A.3)
  labor-0   LABOR with uniform pi (the paper's default)
  labor-1   one importance fixed-point iteration
  labor-*   iterate importance sampling to convergence (§4.3)
  labor-d   layer-dependent LABOR-0: r_t reused across layers (§A.8)
  ladies    LADIES baseline (Zou et al. 2019)
  pladies   Poisson LADIES (paper §3.1)
  full      full neighbourhood, cap-bounded: exact inference and serving

  from repro_torch.core import samplers
  sampler = samplers.from_dataset("labor-0", ds, batch_size=1024,
                                  fanouts=(10, 10, 10))
  blocks = sampler.sample_with_key(graph, seeds, key)

Every entry accepts a weighted graph (``Graph.weights``, §A.7), as the
reference's do: the LABOR family then solves c_s with
``solve_cs_weighted`` (``importance_iters`` is not consulted), LADIES
and PLADIES square the weights into the column norms, and ``full``
ignores them.

Adding a sampler: subclass ``Sampler`` (a ``sample(graph, seeds,
salts)`` built on ``build_block``) and ``register(name, builder,
doc=...)`` with ``builder(budgets, caps) -> Sampler``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.interface import (LayerCaps, SampledLayer, Sampler,
                                        SamplerSpec, build_block,
                                        suggest_caps, suggest_peer_caps)
from repro_torch.core.labor import CONVERGE, LaborConfig, LaborSampler
from repro_torch.core.ladies import LadiesConfig, LadiesSampler
from repro_torch.graph.csr import Graph, expand_seed_edges


@dataclasses.dataclass(frozen=True)
class FullSampler(Sampler):
    """Full-neighbourhood "sampler": every in-edge of every seed, layer by
    layer, cap-bounded. Deterministic (salts are ignored); the Hajek
    weights reduce to 1/d_s, the exact row-normalised aggregation."""

    def sample(self, graph: Graph, seeds: torch.Tensor, salts: Sequence[int],
               *, backend: Optional[str] = None) -> List[SampledLayer]:
        del salts  # deterministic: include everything
        blocks = []
        cur = seeds
        for caps in self.spec.caps:
            exp = expand_seed_edges(graph, cur, caps.expand_cap,
                                    backend=backend)
            inv_p = torch.ones(caps.expand_cap, dtype=torch.float32,
                               device=cur.device)          # p_ts = 1
            blk = build_block(cur, exp, exp["mask"], inv_p, caps,
                              backend=backend)
            blocks.append(blk)
            cur = blk.next_seeds
        return blocks

    def sample_layer_partitioned(self, graph: Graph, seeds: torch.Tensor,
                                 salt: int, layer: int, *,
                                 seed_rows: torch.Tensor, num_vertices: int,
                                 mesh=None, backend: Optional[str] = None
                                 ) -> SampledLayer:
        del salt, mesh, num_vertices  # deterministic, per seed: no collective
        caps = self.spec.caps[layer]
        exp = expand_seed_edges(graph, seeds, caps.expand_cap,
                                seed_rows=seed_rows, backend=backend)
        inv_p = torch.ones(caps.expand_cap, dtype=torch.float32,
                           device=seeds.device)
        return build_block(seeds, exp, exp["mask"], inv_p, caps,
                           backend=backend)


class UnknownSamplerError(ValueError):
    """Raised for a sampler name the registry cannot resolve."""


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    name: str
    builder: Callable          # (budgets, caps) -> Sampler
    doc: str = ""
    budget_kind: str = "fanouts"   # "fanouts" | "layer_sizes"
    dense: bool = False            # caps must hold full neighbourhoods


_REGISTRY: dict = {}


def register(name: str, builder: Callable, *, doc: str = "",
             budget_kind: str = "fanouts", dense: bool = False,
             overwrite: bool = False) -> Callable:
    """Register ``builder(budgets, caps) -> Sampler`` under ``name``."""
    if budget_kind not in ("fanouts", "layer_sizes"):
        raise ValueError(f"bad budget_kind {budget_kind!r}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"sampler {name!r} already registered")
    _REGISTRY[name] = RegistryEntry(name=name, builder=builder, doc=doc,
                                    budget_kind=budget_kind, dense=dense)
    return builder


def list_samplers() -> tuple:
    """Registered sampler names (``labor-<i>`` also resolves for any i)."""
    return tuple(_REGISTRY)


def describe() -> list:
    """(name, doc) pairs for ``--list-samplers`` style output."""
    return [(e.name, e.doc) for e in _REGISTRY.values()]


def resolve(name: str) -> RegistryEntry:
    """Entry for ``name``; the ``labor-<i>`` family resolves for any i.
    Raises :class:`UnknownSamplerError`, with the listing, otherwise."""
    entry = _REGISTRY.get(name)
    if entry is not None:
        return entry
    m = re.fullmatch(r"labor-(\d+)", name)
    if m:
        iters = int(m.group(1))
        return RegistryEntry(
            name=name, builder=_labor_builder(name, iters),
            doc=f"LABOR with {iters} importance fixed-point iteration(s)")
    raise UnknownSamplerError(
        f"unknown sampler {name!r}; registered: "
        f"{', '.join(list_samplers())} (plus labor-<i> for any i >= 0)")


def sampler_arg_type(name: str) -> str:
    """``argparse`` ``type=`` hook shared by the launchers: validate
    ``--sampler`` at parse time."""
    import argparse
    try:
        resolve(name)
    except UnknownSamplerError as e:
        raise argparse.ArgumentTypeError(str(e))
    return name


def make_list_samplers_action():
    """An ``argparse`` action class for ``--list-samplers``: print the
    registry (one line per entry, plus the ``labor-<i>`` family) and
    exit. Shared by ``launch/train.py`` and ``launch/serve.py``."""
    import argparse

    class ListSamplers(argparse.Action):
        def __init__(self, option_strings, dest, **kw):
            super().__init__(option_strings, dest, nargs=0, **kw)

        def __call__(self, parser, namespace, values, option_string=None):
            for name, doc in describe():
                print(f"{name:10s} {doc}")
            print(f"{'labor-<i>':10s} LABOR with any number of importance "
                  "fixed-point iterations")
            parser.exit()

    return ListSamplers


def get(name: str, budgets: Sequence[int],
        caps: Sequence[LayerCaps]) -> Sampler:
    """Build a registered sampler from explicit budgets + caps: per-layer
    fanouts, or per-layer sizes for the ladies family (each entry's
    ``budget_kind``)."""
    return resolve(name).builder(tuple(int(b) for b in budgets), tuple(caps))


def from_graph_stats(name: str, *, batch_size: int, fanouts: Sequence[int],
                     avg_degree: float, max_degree: int,
                     num_vertices: Optional[int] = None,
                     num_edges: Optional[int] = None,
                     layer_sizes: Optional[Sequence[int]] = None,
                     safety: float = 2.0,
                     num_parts: Optional[int] = None) -> Sampler:
    """A sampler with its cap schedule derived from graph statistics:
    ``suggest_caps`` sizes the buffers from the fanouts (from
    ``max_degree`` per layer for ``dense`` entries such as ``full``), and
    the ladies family takes ``layer_sizes`` as budgets (default
    ``batch_size * k`` per layer). ``num_parts`` adds the multi-device
    engine's per-peer all-to-all caps (``spec.peer_caps``,
    ``suggest_peer_caps``), with ``batch_size`` read as the RANK-LOCAL
    batch; overflow replay doubles both schedules together."""
    entry = resolve(name)
    fanouts = tuple(int(k) for k in fanouts)
    cap_fanouts = (tuple(int(max_degree) for _ in fanouts) if entry.dense
                   else fanouts)
    caps = suggest_caps(batch_size, cap_fanouts, avg_degree, max_degree,
                        safety=safety, num_vertices=num_vertices,
                        num_edges=num_edges)
    if entry.budget_kind == "layer_sizes":
        budgets = (tuple(int(n) for n in layer_sizes)
                   if layer_sizes is not None
                   else tuple(batch_size * k for k in fanouts))
        if len(budgets) != len(fanouts):
            raise ValueError(
                f"sampler {name!r}: {len(budgets)} layer_sizes for "
                f"{len(fanouts)} layers")
    else:
        budgets = fanouts
    sampler = entry.builder(budgets, tuple(caps))
    if num_parts is not None:
        sampler = sampler.with_peer_caps(
            suggest_peer_caps(batch_size, caps, num_parts, safety=safety))
    return sampler


def from_dataset(name: str, ds, *, batch_size: int, fanouts: Sequence[int],
                 layer_sizes: Optional[Sequence[int]] = None,
                 safety: float = 2.0,
                 num_parts: Optional[int] = None) -> Sampler:
    """:func:`from_graph_stats` with the statistics of a GraphDataset."""
    g = ds.graph
    return from_graph_stats(
        name, batch_size=batch_size, fanouts=fanouts,
        avg_degree=g.num_edges / g.num_vertices,
        max_degree=ds.max_in_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, layer_sizes=layer_sizes, safety=safety,
        num_parts=num_parts)


def _labor_builder(name: str, iters: int, **kw) -> Callable:
    def build(budgets, caps):
        return LaborSampler.build(
            LaborConfig(fanouts=budgets, importance_iters=iters, **kw),
            caps, name=name)
    return build


def _ladies_builder(name: str, poisson: bool) -> Callable:
    def build(budgets, caps):
        return LadiesSampler.build(LadiesConfig(budgets, poisson=poisson),
                                   caps, name=name)
    return build


register("ns", _labor_builder("ns", 0, per_edge_rng=True, exact_k=True),
         doc="vanilla Neighbor Sampling: per-edge randomness, exactly "
             "min(k, d) neighbors (LABOR degenerate case, §3.2/§A.3)")
register("labor-0", _labor_builder("labor-0", 0),
         doc="LABOR with uniform pi — the paper's default (§3.2)")
register("labor-1", _labor_builder("labor-1", 1),
         doc="LABOR with one importance fixed-point iteration (§4.3)")
register("labor-*", _labor_builder("labor-*", CONVERGE),
         doc="LABOR iterated to importance-sampling convergence (§4.3)")
register("labor-d", _labor_builder("labor-d", 0, layer_dependency=True),
         doc="layer-dependent LABOR-0: one salt shared across layers so "
             "r_t is reused and |V^3| shrinks further (§A.8)")
register("ladies", _ladies_builder("ladies", False),
         budget_kind="layer_sizes",
         doc="LADIES baseline (Zou et al. 2019): n vertices per layer, "
             "with-replacement inverse-CDF draws")
register("pladies", _ladies_builder("pladies", True),
         budget_kind="layer_sizes",
         doc="Poisson LADIES (§3.1): water-filled inclusion probs, "
             "E[|layer|] = n, unbiased by construction")
register("full",
         lambda budgets, caps: FullSampler(
             SamplerSpec(name="full", budgets=budgets, caps=caps)),
         dense=True,
         doc="full neighborhood, cap-bounded — exact (zero-variance) "
             "aggregation for inference/serving")
