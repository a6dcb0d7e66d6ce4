"""The distributed vertex-feature gather: the collective the paper's
technique shrinks (twin of ``repro.distributed.feature_exchange``).

After sampling, every rank needs feature rows for its block's
``next_seeds``; they live with their owners. This module fetches them
with a fixed-capacity request / response all-to-all pair: each rank
sends every owner the local rows it wants (at most ``per_peer_cap`` per
peer) and gets the rows back in the same slots. LABOR's smaller |V^3|
cuts the bytes of both all-to-alls. Every cap is static, and overflow
is returned as a flag, never truncated silently.

Both ownership conventions of the reference are here: ``"range"``
(owner v // V_local, row v % V_local: contiguous sharding) and
``"mod"`` (owner v % P, row v // P: the partition of
``graph/partition.py``, which the engine uses for features, labels and
hidden states). :func:`exchange_features` is differentiable in the
owned rows: the response all-to-all's backward sends the gradient rows
back to their owners.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.cs_solve import SPILL_BINS, spill_index


class _TakeRows(torch.autograd.Function):
    """The row gather of :func:`take_rows`. Its backward adds each
    gradient row into its source row (``index_add_``) and each padding
    row's zeros into spill rows past the end: autograd's own backward of
    an index gather adds the padding entries, often most of a padded
    buffer, into one row, which the card serialises."""

    @staticmethod
    def forward(ctx, features, ids):
        valid = ids >= 0
        ctx.save_for_backward(ids)
        ctx.num_rows = features.shape[0]
        rows = features[torch.where(valid, ids, 0).long()]
        return torch.where(valid[:, None], rows, 0.0)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n = ctx.num_rows
        out = torch.zeros(n + SPILL_BINS, g.shape[1], dtype=g.dtype,
                          device=g.device)
        return out.index_add_(0, spill_index(ids >= 0, ids, n), g)[:n], None


def take_rows(features: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``features`` at ``ids``; padding ids (-1) read no row and
    give zeros (the reference's ``mode="fill"``: a negative torch index
    would silently read the last row). Differentiable in
    ``features``."""
    return _TakeRows.apply(features, ids)


class _AllToAll(torch.autograd.Function):
    """``mesh.all_to_all`` as an autograd op: the layout is its own
    transpose, so the backward is the same all-to-all of the
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous()), None


def request_layout(ids: torch.Tensor, num_parts: int, per_peer_cap: int,
                   v_local: int, owner_mode: str = "range"):
    """Group padded global ids (-1 pad) by owner into (P, cap) with the
    originating position, so that responses can be scattered back.

    Returns (req_ids (P, cap) int32 local rows, -1 in empty slots;
    req_pos (P, cap) int32 positions into ``ids``; overflow bool[]: an
    owner was sent more than ``per_peer_cap`` ids; those past the cap
    are dropped). Within an owner the ids keep their order."""
    T = ids.shape[0]
    dev = ids.device
    valid = ids >= 0
    if owner_mode == "mod":
        owner = torch.where(valid, ids % num_parts, num_parts)
        row = ids // num_parts
    elif owner_mode == "range":
        owner = torch.where(valid,
                            torch.clamp(ids // v_local, max=num_parts - 1),
                            num_parts)
        row = ids - owner * v_local
    else:
        raise ValueError(f"unknown owner_mode {owner_mode!r}")
    # rank of each id within its owner group, in order (a stable sort by
    # owner: the reference's exclusive one-hot cumsum)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=num_parts + 1)
    starts = torch.cumsum(counts, 0) - counts
    ow_sorted = owner[order]
    rank = torch.empty(T, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(T, device=dev) - starts[ow_sorted]
    overflow = torch.any(torch.where(valid, rank, 0) >= per_peer_cap)
    dump = num_parts * per_peer_cap
    # the ids that get no slot are dropped into spill slots of their own
    # past the layout: on the card, writes of many entries to one spill
    # address serialise
    ar = torch.arange(T, device=dev)
    slot = torch.where(valid & (rank < per_peer_cap),
                       owner * per_peer_cap + rank, dump + ar)
    local_row = torch.where(valid, row, -1).to(torch.int32)
    pos = torch.where(valid, ar.to(torch.int32), -1)
    req_ids = torch.full((dump + T,), -1, dtype=torch.int32, device=dev)
    req_ids = req_ids.scatter_(0, slot, local_row)[:dump]
    req_pos = torch.full((dump + T,), -1, dtype=torch.int32, device=dev)
    req_pos = req_pos.scatter_(0, slot, pos)[:dump]
    return (req_ids.view(num_parts, per_peer_cap),
            req_pos.view(num_parts, per_peer_cap), overflow)


def exchange_features(local_feats: torch.Tensor, ids: torch.Tensor, mesh,
                      per_peer_cap: int, owner_mode: str = "range"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On every rank: fetch the feature rows of global ``ids`` (-1 pad).

    local_feats (V_local, F): this rank's owned rows (``request_layout``
    has the two conventions). Returns (feats (T, F), zeros at padding
    and at ids dropped by an overflow; overflow bool[])."""
    P = mesh.size
    T = ids.shape[0]
    V_local, F = local_feats.shape
    req_ids, req_pos, overflow = request_layout(ids, P, per_peer_cap,
                                                V_local, owner_mode)
    # my requests to their owners; the others' requests for my rows,
    # served by a gather that reads no row for an empty slot (-1)
    incoming = mesh.all_to_all(req_ids)                       # (P, cap)
    resp = take_rows(local_feats, incoming.reshape(-1))
    back = _AllToAll.apply(resp.view(P, per_peer_cap, F), mesh)
    # each position's response slot (P * cap where it has none), then one
    # gather: no two writes land on one row
    n = P * per_peer_cap
    slots = torch.arange(n, device=ids.device)
    pos = req_pos.reshape(-1).long()
    at = torch.full((T + n,), n, dtype=torch.int64, device=ids.device)
    at = at.scatter_(0, torch.where(pos >= 0, pos, T + slots), slots)[:T]
    return take_rows(back.reshape(n, F), torch.where(at < n, at, -1)), \
        overflow


def make_sharded_gather(mesh, per_peer_cap: int, owner_mode: str = "range"):
    """``gather(local_feats, ids) -> (feats, overflow)`` on this rank:
    :func:`exchange_features` bound to ``mesh`` and a cap."""

    def gather(local_feats, ids):
        return exchange_features(local_feats, ids, mesh, per_peer_cap,
                                 owner_mode)

    return gather
