"""Sampler registry (twin of ``repro.core.samplers``): one construction
path from graph statistics to a configured sampler. ``labor-0`` (the
paper's default) and ``ns`` (the baseline it is compared with) are
registered in this package so far.

  from repro_torch.core import samplers
  sampler = samplers.from_dataset("labor-0", ds, batch_size=1024,
                                  fanouts=(10, 10, 10))
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.interface import LayerCaps, Sampler, suggest_caps
from repro_torch.core.labor import LaborConfig, LaborSampler


class UnknownSamplerError(ValueError):
    """Raised for a sampler name the registry cannot resolve."""


def _labor_builder(name: str, **kw) -> Callable:
    def build(budgets, caps) -> Sampler:
        return LaborSampler.build(LaborConfig(fanouts=budgets, **kw), caps,
                                  name=name)
    return build


#: name -> (builder(budgets, caps), one-line description)
_REGISTRY: Dict[str, Tuple[Callable, str]] = {
    "ns": (_labor_builder("ns", per_edge_rng=True, exact_k=True),
           "vanilla Neighbor Sampling: per-edge randomness, exactly "
           "min(k, d) neighbors (LABOR degenerate case, §3.2/§A.3)"),
    "labor-0": (_labor_builder("labor-0"),
                "LABOR with uniform pi — the paper's default (§3.2)"),
}


def list_samplers() -> tuple:
    return tuple(_REGISTRY)


def describe() -> list:
    """(name, doc) pairs for ``--list-samplers`` style output."""
    return [(name, doc) for name, (_, doc) in _REGISTRY.items()]


def resolve(name: str) -> Callable:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise UnknownSamplerError(
            f"sampler {name!r} is not ported to repro_torch yet; "
            f"registered: {', '.join(list_samplers())}")
    return entry[0]


def sampler_arg_type(name: str) -> str:
    """``argparse`` ``type=`` hook: validate ``--sampler`` at parse time."""
    import argparse
    try:
        resolve(name)
    except UnknownSamplerError as e:
        raise argparse.ArgumentTypeError(str(e))
    return name


def get(name: str, budgets: Sequence[int],
        caps: Sequence[LayerCaps]) -> Sampler:
    """Build a registered sampler from explicit budgets + caps."""
    return resolve(name)(tuple(int(b) for b in budgets), tuple(caps))


def from_graph_stats(name: str, *, batch_size: int, fanouts: Sequence[int],
                     avg_degree: float, max_degree: int,
                     num_vertices: Optional[int] = None,
                     num_edges: Optional[int] = None,
                     safety: float = 2.0) -> Sampler:
    """A sampler with its cap schedule derived from graph statistics."""
    builder = resolve(name)
    fanouts = tuple(int(k) for k in fanouts)
    caps = suggest_caps(batch_size, fanouts, avg_degree, max_degree,
                        safety=safety, num_vertices=num_vertices,
                        num_edges=num_edges)
    return builder(fanouts, tuple(caps))


def from_dataset(name: str, ds, *, batch_size: int, fanouts: Sequence[int],
                 safety: float = 2.0) -> Sampler:
    """:func:`from_graph_stats` with the statistics of a GraphDataset."""
    g = ds.graph
    return from_graph_stats(
        name, batch_size=batch_size, fanouts=fanouts,
        avg_degree=g.num_edges / g.num_vertices,
        max_degree=ds.max_in_degree, num_vertices=g.num_vertices,
        num_edges=g.num_edges, safety=safety)
