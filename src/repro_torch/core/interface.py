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


def suggest_peer_caps(batch_size: int, caps: Sequence[LayerCaps],
                      num_parts: int, safety: float = 2.0) -> tuple:
    """Per-peer all-to-all slot counts for the multi-device engine.

    ``peer_caps[i]`` bounds how many ids one rank may address to one
    peer in an all-to-all keyed on frontier buffer ``i``: buffer 0 is
    the rank-local seed batch, buffer ``l + 1`` is layer ``l``'s
    ``next_seeds`` buffer (``caps[l].vertex_cap``). The same schedule
    covers seed routing, the hidden-state exchange and the feature
    fetch. Ids spread over owners about uniformly (modulo partition), so
    mean / num_parts plus slack concentrates as the LayerCaps do.
    """
    sizes = [batch_size] + [c.vertex_cap for c in caps]
    return tuple(
        _round_up(int(t / num_parts * safety) + 6 * int(t ** 0.5) + 16, 8)
        for t in sizes)


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
    name, per-layer budgets (fanouts), static caps, salt schedule, and
    ``peer_caps``: the multi-device engine's per-peer all-to-all slot
    schedule (num_layers + 1 entries, :func:`suggest_peer_caps`; None on
    a sampler built without a partition count). :meth:`doubled` doubles
    them with the LayerCaps, so an all-to-all overflow heals through the
    same replay as a sampling overflow."""
    name: str
    budgets: tuple
    caps: tuple
    shared_salts: bool = False
    peer_caps: Optional[tuple] = None

    def __post_init__(self):
        object.__setattr__(self, "budgets",
                           tuple(int(b) for b in self.budgets))
        object.__setattr__(self, "caps", tuple(self.caps))
        if len(self.caps) != len(self.budgets):
            raise ValueError(
                f"spec {self.name!r}: {len(self.budgets)} budgets but "
                f"{len(self.caps)} LayerCaps — need one cap per layer")
        if self.peer_caps is not None:
            object.__setattr__(self, "peer_caps",
                               tuple(int(c) for c in self.peer_caps))
            if len(self.peer_caps) != len(self.caps) + 1:
                raise ValueError(
                    f"spec {self.name!r}: peer_caps must have "
                    f"num_layers + 1 = {len(self.caps) + 1} entries "
                    f"(got {len(self.peer_caps)})")

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
        """New LayerCaps; ``peer_caps`` are left as they are."""
        return dataclasses.replace(self, caps=tuple(caps))

    def doubled(self) -> "SamplerSpec":
        """Every LayerCaps buffer and every per-peer cap doubled."""
        peer = (None if self.peer_caps is None
                else tuple(c * 2 for c in self.peer_caps))
        return dataclasses.replace(self, caps=tuple(double_caps(self.caps)),
                                   peer_caps=peer)


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
        """The overflow-retry step: every cap (the per-peer caps too)
        doubled, same sampling."""
        return dataclasses.replace(self, spec=self.spec.doubled())

    def with_peer_caps(self, peer_caps) -> "Sampler":
        """Clone with a per-peer all-to-all schedule (None: none)."""
        return dataclasses.replace(self, spec=dataclasses.replace(
            self.spec, peer_caps=peer_caps))

    def sample_layer_partitioned(self, graph, seeds: torch.Tensor,
                                 salt: int, layer: int, *,
                                 seed_rows: torch.Tensor, num_vertices: int,
                                 mesh=None, backend: Optional[str] = None
                                 ) -> SampledLayer:
        """One sampling layer against a partition-local CSR, on one rank
        of the multi-device engine.

        ``seeds`` are GLOBAL vertex ids owned by this partition (so the
        stateless hash r_t, and with it the sampled set, is the
        single-device one bit for bit); ``seed_rows`` maps each seed to
        its row of the partition-local ``graph`` (v // P);
        ``num_vertices`` is the global vertex count for the dense
        per-vertex state; ``mesh`` (a ``launch.mesh.Mesh``, or None)
        completes the batch-global reductions some samplers need
        (LABOR's importance max, LADIES's column norms). Returns one
        :class:`SampledLayer` in global-id space."""
        raise NotImplementedError(
            f"sampler {self.name!r} does not implement the "
            "partition-local sampling path of the multi-device engine")


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


def build_block_dense(num_vertices: int, seeds: torch.Tensor, exp: dict,
                      include: torch.Tensor, inv_p: torch.Tensor,
                      caps: LayerCaps) -> SampledLayer:
    """The original dense epilogue, the O(V) baseline: three V-sized
    membership / position buffers and a full stable sort per layer
    instead of the frontier primitives. It gives :func:`build_block`'s
    block field for field (the same inclusion set, the same ascending
    ``next_seeds``, the same stable ``src_perm``), which is what the
    parity tests hold the frontier kernels to. Not on any sampling
    path."""
    S = seeds.shape[0]
    dev = seeds.device
    src, slot = exp["src"], exp["seed_slot"]
    safe_slot = torch.clamp(slot, 0, S - 1).long()

    inv_p = torch.where(include, inv_p, 0.0)
    w = _segment_sum_sorted(inv_p, segment_offsets(slot, S))
    weight_full = torch.where(
        include, inv_p / torch.clamp(w[safe_slot], min=1e-20), 0.0)

    num_sampled = include.sum(dtype=torch.int32)
    sel = torch.nonzero(include).flatten()[: caps.edge_cap]
    sel = torch.cat([sel, torch.zeros(caps.edge_cap - sel.shape[0],
                                      dtype=sel.dtype, device=dev)])
    emask = (torch.arange(caps.edge_cap, device=dev)
             < torch.clamp(num_sampled, max=caps.edge_cap))
    e_src = torch.where(emask, src[sel], -1)
    e_dst_slot = torch.where(emask, slot[sel], -1)
    e_weight = torch.where(emask, weight_full[sel], 0.0)

    V = num_vertices
    seeds = seeds.to(torch.int32)
    seed_member = torch.zeros(V, dtype=torch.bool, device=dev)
    seed_member[seeds[seeds >= 0].long()] = True
    samp_member = torch.zeros(V, dtype=torch.bool, device=dev)
    samp_member[e_src[emask].long()] = True
    new_member = samp_member & ~seed_member
    num_new = new_member.sum(dtype=torch.int32)
    new_cap = caps.vertex_cap - S
    if new_cap <= 0:
        raise ValueError("vertex_cap must exceed seed buffer size")
    new_vs = torch.nonzero(new_member).flatten()[:new_cap].to(torch.int32)
    new_vs = torch.cat([new_vs, torch.full((new_cap - new_vs.shape[0],),
                                           -1, dtype=torch.int32,
                                           device=dev)])
    next_seeds = torch.cat([seeds, new_vs])

    pos = torch.full((V,), -1, dtype=torch.int32, device=dev)
    live = next_seeds >= 0
    pos[next_seeds[live].long()] = torch.nonzero(live).flatten().to(
        torch.int32)
    e_src_slot = torch.where(emask, pos[torch.where(emask, e_src, 0).long()],
                             -1)

    num_seeds = (seeds >= 0).sum(dtype=torch.int32)
    src_perm = torch.argsort(
        torch.where(emask, e_src_slot, caps.vertex_cap),
        stable=True).to(torch.int32)
    overflow = ((exp["total"] > caps.expand_cap)
                | (num_sampled > caps.edge_cap) | (num_new > new_cap))
    return SampledLayer(
        seeds=seeds, next_seeds=next_seeds, src=e_src, dst_slot=e_dst_slot,
        src_slot=e_src_slot, weight=e_weight, edge_mask=emask,
        src_perm=src_perm, num_seeds=num_seeds,
        num_next=num_seeds + num_new, num_edges=num_sampled,
        overflow=overflow)
