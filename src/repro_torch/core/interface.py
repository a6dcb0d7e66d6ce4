"""The ``Sampler`` protocol and the static-shape sampled block (twin of
``repro.core.interface``).

A ``SampledLayer`` holds cap-sized buffers; real sizes ride along as
int32 device scalars, and overflow (a real size above its cap) is flagged,
never silently truncated. Layout:

  * ``seeds`` are this layer's destination vertices (padding -1);
  * ``next_seeds`` = ``[seeds ; sorted unique new sources]`` are the
    input vertices, so a model takes residuals as ``h[:seed_cap]``;
  * edges are compacted after sampling: ``src``/``dst_slot``/
    ``src_slot``/``weight`` are aligned, padded with -1 / 0, and the
    valid edges are the prefix ``[0, num_edges)``, sorted by
    ``dst_slot``.

Integer fields stay int32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.cs_solve import _segment_sum_sorted, segment_offsets
from repro_torch.ops import frontier as frontier_ops


@dataclasses.dataclass(frozen=True)
class SampledLayer:
    seeds: torch.Tensor        # int32[S] destination vertex ids, -1 pad
    next_seeds: torch.Tensor   # int32[T] input vertex ids (seeds prefix)
    src: torch.Tensor          # int32[E] source vertex id per sampled edge
    dst_slot: torch.Tensor     # int32[E] index into seeds
    src_slot: torch.Tensor     # int32[E] index into next_seeds
    weight: torch.Tensor       # float32[E] Hajek-normalised A'_ts
    edge_mask: torch.Tensor    # bool[E]
    src_perm: torch.Tensor     # int32[E] edges in src_slot order, pad last
    num_seeds: torch.Tensor    # int32[] real seed count
    num_next: torch.Tensor     # int32[] real next_seeds count
    num_edges: torch.Tensor    # int32[] real sampled edge count
    overflow: torch.Tensor     # bool[] a cap was exceeded in this layer

    @property
    def seed_cap(self) -> int:
        return self.seeds.shape[0]

    @property
    def next_cap(self) -> int:
        return self.next_seeds.shape[0]

    @property
    def edge_cap(self) -> int:
        return self.src.shape[0]


#: the fields compared bit for bit by the parity tests (``weight`` is
#: compared to a tolerance)
INT_FIELDS = ("seeds", "next_seeds", "src", "dst_slot", "src_slot",
              "edge_mask", "src_perm", "num_seeds", "num_next", "num_edges",
              "overflow")


def overflow_flags(blocks: Sequence[SampledLayer]) -> torch.Tensor:
    """Per-layer overflow flags stacked as bool[num_layers]."""
    return torch.stack([b.overflow for b in blocks])


def sampled_counts(blocks: Sequence[SampledLayer]) -> dict:
    """``sampled_v`` = vertex count of the deepest layer, ``sampled_e`` =
    sampled edges over all layers (device scalars)."""
    return {"sampled_v": blocks[-1].num_next,
            "sampled_e": sum(b.num_edges for b in blocks)}


@dataclasses.dataclass(frozen=True)
class LayerCaps:
    """Static buffer sizes for one sampling layer."""
    expand_cap: int   # buffer for ALL in-edges of the layer's seeds
    edge_cap: int     # buffer for sampled edges
    vertex_cap: int   # buffer for next_seeds


def double_caps(caps: Sequence[LayerCaps]) -> List[LayerCaps]:
    """The overflow-retry schedule: double every buffer of every layer."""
    return [dataclasses.replace(c, expand_cap=c.expand_cap * 2,
                                edge_cap=c.edge_cap * 2,
                                vertex_cap=c.vertex_cap * 2) for c in caps]


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def suggest_caps(batch_size: int, fanouts: Sequence[int], avg_degree: float,
                 max_degree: int, safety: float = 1.5,
                 max_expand: int = 1 << 22,
                 num_vertices: Optional[int] = None,
                 num_edges: Optional[int] = None) -> List[LayerCaps]:
    """Cap schedule from fanout geometry + slack (mean * safety + a few
    sigma), clamped to the whole graph when its sizes are given."""
    caps = []
    n_seeds = batch_size
    for k in fanouts:
        exp_edges = n_seeds * min(k, avg_degree)
        sampled = int(exp_edges * safety + 6 * exp_edges ** 0.5) + 64
        expand = int(min(n_seeds * avg_degree * safety + 4 * max_degree,
                         max_expand)) + 64
        if num_edges is not None:
            sampled = min(sampled, num_edges)
            expand = min(expand, num_edges)
        n_next = n_seeds + sampled
        if num_vertices is not None:
            n_next = min(n_next, n_seeds + num_vertices)
        caps.append(LayerCaps(
            expand_cap=_round_up(max(expand, sampled), 128),
            edge_cap=_round_up(sampled, 128),
            vertex_cap=_round_up(max(n_next, n_seeds + 128), 128),
        ))
        # the next layer's seed buffer is exactly this layer's vertex buffer
        n_seeds = caps[-1].vertex_cap
    return caps


def pad_seeds(seeds, cap: int, device=None) -> torch.Tensor:
    """int32[cap]: ``seeds`` followed by -1 padding."""
    seeds = torch.as_tensor(seeds, device=device).to(torch.int32)
    n = seeds.shape[0]
    if n > cap:
        raise ValueError(f"seed count {n} exceeds cap {cap}")
    pad = torch.full((cap - n,), -1, dtype=torch.int32, device=seeds.device)
    return torch.cat([seeds, pad])


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Frozen, hashable description of a configured sampler: registry
    name, per-layer budgets (fanouts), static caps, salt schedule. The
    reference's per-peer all-to-all caps belong to the multi-device
    engine, which this package does not have yet."""
    name: str
    budgets: tuple
    caps: tuple
    shared_salts: bool = False

    def __post_init__(self):
        object.__setattr__(self, "budgets",
                           tuple(int(b) for b in self.budgets))
        object.__setattr__(self, "caps", tuple(self.caps))
        if len(self.caps) != len(self.budgets):
            raise ValueError(
                f"spec {self.name!r}: {len(self.budgets)} budgets but "
                f"{len(self.caps)} LayerCaps — need one cap per layer")

    @property
    def num_layers(self) -> int:
        return len(self.caps)

    def salts(self, key: rng_lib.Key) -> List[int]:
        """Per-layer uint32 salts from a threefry key (host ints)."""
        return rng_lib.layer_salts_from_key(key, self.num_layers,
                                            shared=self.shared_salts)

    def salts_from_uint32(self, salt: int) -> List[int]:
        """Per-layer uint32 salts from a raw uint32 salt (host ints)."""
        return rng_lib.layer_salts_from_uint32(salt, self.num_layers,
                                               shared=self.shared_salts)

    def with_caps(self, caps: Sequence[LayerCaps]) -> "SamplerSpec":
        return dataclasses.replace(self, caps=tuple(caps))

    def doubled(self) -> "SamplerSpec":
        return self.with_caps(double_caps(self.caps))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Protocol base: a frozen spec + ``sample``."""
    spec: SamplerSpec

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def caps(self) -> tuple:
        return self.spec.caps

    @property
    def num_layers(self) -> int:
        return self.spec.num_layers

    def sample(self, graph, seeds: torch.Tensor, salts: Sequence[int], *,
               backend: Optional[str] = None) -> List[SampledLayer]:
        """Multi-layer sampling from a per-layer salt schedule; returns
        blocks, batch (outermost) layer first."""
        raise NotImplementedError

    def sample_with_key(self, graph, seeds: torch.Tensor, key, *,
                        backend: Optional[str] = None) -> List[SampledLayer]:
        return self.sample(graph, seeds, self.spec.salts(key),
                           backend=backend)

    def sample_with_salt(self, graph, seeds: torch.Tensor, salt: int, *,
                         backend: Optional[str] = None
                         ) -> List[SampledLayer]:
        """Multi-layer sampling from a raw uint32 salt, remixed per layer
        by :meth:`SamplerSpec.salts_from_uint32`."""
        return self.sample(graph, seeds, self.spec.salts_from_uint32(salt),
                           backend=backend)

    def with_caps(self, caps: Sequence[LayerCaps]) -> "Sampler":
        return dataclasses.replace(self, spec=self.spec.with_caps(caps))

    def doubled(self) -> "Sampler":
        """The overflow-retry step: every cap doubled, same sampling."""
        return dataclasses.replace(self, spec=self.spec.doubled())


def build_block(seeds: torch.Tensor, exp: dict, include: torch.Tensor,
                inv_p: torch.Tensor, caps: LayerCaps,
                backend: Optional[str] = None) -> SampledLayer:
    """Shared epilogue of every sampler: from per-edge inclusion
    decisions over an expanded neighbourhood to a finished block.

    Hajek-normalises ``inv_p`` into edge weights (Algorithm 1), compacts
    the included edges into ``edge_cap`` (order-preserving, so they stay
    dst-sorted), builds ``next_seeds = [seeds ; sorted unique new srcs]``
    with the source -> slot map in one ``hash_dedup``, and the transposed
    (src-sorted, stable) edge order with ``compact_perm``. Every frontier
    call gets the live prefix length as a device scalar, so the kernels
    work on real counts without a host sync.
    """
    S = seeds.shape[0]
    src, slot = exp["src"], exp["seed_slot"]
    safe_slot = torch.clamp(slot, 0, S - 1).long()

    # Hajek weights (Algorithm 1): A'_ts = (1/p_ts) / sum_t' 1/p_t's, the
    # sums in a fixed order over each seed's contiguous segment (adding
    # the excluded edges' zeros changes no sum), so every run and both
    # backends get the same weights
    inv_p = torch.where(include, inv_p, 0.0)
    w = _segment_sum_sorted(inv_p, segment_offsets(slot, S))
    weight_full = torch.where(
        include, inv_p / torch.clamp(w[safe_slot], min=1e-20), 0.0)

    sel, emask, num_sampled = frontier_ops.compact(
        include, caps.edge_cap, backend=backend, n_live=exp["live"])
    sel = sel.long()
    e_src = torch.where(emask, src[sel], -1)
    e_dst_slot = torch.where(emask, slot[sel], -1)
    e_weight = torch.where(emask, weight_full[sel], 0.0)
    live = torch.clamp(num_sampled, max=caps.edge_cap)

    new_cap = caps.vertex_cap - S
    if new_cap <= 0:
        raise ValueError("vertex_cap must exceed seed buffer size")
    seeds = seeds.to(torch.int32)
    dd = frontier_ops.hash_dedup(e_src, emask, seeds, new_cap,
                                 backend=backend, n_live=live)
    next_seeds = torch.cat([seeds, dd.new])
    e_src_slot = torch.where(emask, dd.slots, -1)

    num_seeds = (seeds >= 0).sum(dtype=torch.int32)
    src_perm = frontier_ops.compact_perm(e_src_slot, emask, caps.vertex_cap,
                                         backend=backend, n_live=live)
    overflow = ((exp["total"] > caps.expand_cap)
                | (num_sampled > caps.edge_cap) | dd.overflow)
    return SampledLayer(
        seeds=seeds, next_seeds=next_seeds, src=e_src, dst_slot=e_dst_slot,
        src_slot=e_src_slot, weight=e_weight, edge_mask=emask,
        src_perm=src_perm, num_seeds=num_seeds,
        num_next=num_seeds + dd.num_new, num_edges=num_sampled,
        overflow=overflow)
