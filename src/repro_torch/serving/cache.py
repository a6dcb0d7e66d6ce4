"""Device-resident vertex caches for serving (twin of
``repro.serving.cache``).

Inference traffic is skewed: a few hot vertices show up in most
requests, and LABOR bounds the vertices a request samples, so the
working set fits on the card. Two caches use that:

:class:`VertexCache` (the feature cache)
    A table ``keys int32[C]`` / ``values f32[C, F]`` keyed by vertex id.
    A lookup is one call of the frontier primitive ``hash_dedup`` (the
    CUDA kernel of ``csrc/frontier.cu`` on the card) with the queried
    ids as its values and the key column as its "seeds": for each id,
    its slot in ``[keys ; new]``, so a slot below C is a hit at that
    row and a slot at C or above points into the ascending list of
    unique misses ``new``. Only the unique misses are read from the
    feature store; hits are served from the table. The misses are then
    inserted under a ``fifo`` ring or a ``freq`` least-frequently-hit
    policy. Values are verbatim feature rows, so the gathered rows equal
    a direct gather bit for bit.

:class:`HiddenCache` (the stale hidden-state cache)
    The same table, holding the deepest GNN layer's output keyed by
    vertex id, served only while ``step - born[slot] <= max_age`` (in
    serve steps). ``max_age=0`` never serves an entry of an earlier
    step, so the logits equal the cache-off logits bit for bit;
    ``max_age>0`` serves a state computed under an earlier request's
    salts (exact for the deterministic ``full`` sampler) and refreshes
    expired hits in place.

The cache classes are frozen (hashable) configurations; all state
lives in :class:`CacheState`, and every operation returns a new state
(new tensors; nothing is updated in place), which the driver commits
only for a clean dispatch. Nothing here reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.cs_solve import SPILL_BINS, spill_index
from repro_torch.ops import frontier as frontier_ops

POLICIES = ("fifo", "freq")


@dataclasses.dataclass(frozen=True)
class CacheState:
    """One cache's table, on one device.

    keys:   int32[C] vertex id held by each slot, -1 = empty.
    values: f32[C, F] cached row of each slot.
    freq:   int32[C] hit counter (``freq`` eviction policy).
    born:   int32[C] serve step at which the slot's value was computed.
    ptr:    int32[] FIFO ring insertion cursor.
    step:   int32[] serve-step clock, one a dispatch.
    """
    keys: torch.Tensor
    values: torch.Tensor
    freq: torch.Tensor
    born: torch.Tensor
    ptr: torch.Tensor
    step: torch.Tensor


def _set_rows(table: torch.Tensor, index: torch.Tensor, keep: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with ``table[index[i]] = rows[i]`` where
    ``keep[i]`` (the reference's scatter with ``mode="drop"``). Each row
    of the table learns which entry writes it (an int scatter whose
    dropped entries spread over ``SPILL_BINS`` bins), then gathers that
    entry's row: no two dropped rows are written to one address. Entries
    that write one row must carry equal rows."""
    C = table.shape[0]
    src = torch.full((C + SPILL_BINS,), -1, dtype=torch.long,
                     device=table.device).scatter_(
        0, spill_index(keep, index, C),
        torch.arange(index.shape[0], device=table.device))[:C]
    taken = (src >= 0).view((C,) + (1,) * (table.dim() - 1))
    picked = rows[torch.clamp(src, min=0)].to(table.dtype)
    return torch.where(taken, picked, table)


@dataclasses.dataclass(frozen=True)
class VertexCache:
    """Cap-bounded device-resident feature cache keyed by vertex id.

    ``capacity`` is the slot count C; ``policy`` picks the slots that
    missed rows overwrite: ``fifo`` a ring of slots (oldest inserted
    first), ``freq`` the least-frequently-hit slots (empty slots first;
    a new entry starts at freq 1).
    """
    capacity: int
    policy: str = "fifo"

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got "
                             f"{self.capacity}")
        if self.policy not in POLICIES:
            raise ValueError(f"cache policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")

    def init_state(self, feat_dim: int, dtype=torch.float32,
                   device="cpu") -> CacheState:
        C = self.capacity

        def zeros(*shape, dt=torch.int32):
            return torch.zeros(shape, dtype=dt, device=device)

        return CacheState(
            keys=torch.full((C,), -1, dtype=torch.int32, device=device),
            values=zeros(C, feat_dim, dt=dtype), freq=zeros(C),
            born=zeros(C), ptr=zeros(), step=zeros())

    def _lookup(self, state: CacheState, ids: torch.Tensor,
                backend: Optional[str] = None):
        """One ``hash_dedup`` call against the key column: each id's slot
        in ``[keys ; new]`` and the hit mask. ``new_cap = len(ids)``
        cannot overflow (at most that many distinct misses exist)."""
        dd = frontier_ops.hash_dedup(ids, ids >= 0, state.keys,
                                     ids.shape[0], backend=backend)
        hit = (dd.slots >= 0) & (dd.slots < self.capacity)
        return dd, hit

    def _insert(self, state: CacheState, missed: torch.Tensor,
                num_miss: torch.Tensor, rows: torch.Tensor,
                hit_slots: torch.Tensor, hit_mask: torch.Tensor
                ) -> CacheState:
        """Insert the unique missed ids and their rows, evicting per
        policy; count the hits; advance the step clock."""
        C = self.capacity
        dev = state.keys.device
        # duplicate queried ids share a slot, so their hits add up: freq
        # counts requests, which is what skew-aware eviction wants
        freq = torch.cat([state.freq, state.freq.new_zeros(SPILL_BINS)])
        freq = freq.scatter_add_(
            0, spill_index(hit_mask, hit_slots, C),
            torch.ones_like(hit_slots, dtype=torch.int32))[:C]
        n_ins = torch.clamp(num_miss, max=C)
        # at most C misses are inserted: the first min(T, C) of the list
        T = min(missed.shape[0], C)
        pos = torch.arange(T, dtype=torch.int32, device=dev)
        take = pos < n_ins
        if self.policy == "fifo":
            tgt = (state.ptr + pos) % C
            ptr = (state.ptr + n_ins) % C
        else:
            # least frequently hit first, empty slots (-1) before any
            # count; the stable argsort keeps the eviction deterministic
            order = torch.argsort(torch.where(state.keys >= 0, freq, -1),
                                  stable=True).to(torch.int32)
            tgt = order[pos.long()]
            ptr = state.ptr
        # the first n_ins (<= C) targets are distinct; the rest are dropped
        return CacheState(
            keys=_set_rows(state.keys, tgt, take, missed[:T]),
            values=_set_rows(state.values, tgt, take, rows[:T]),
            freq=_set_rows(freq, tgt, take,
                           torch.ones_like(tgt, dtype=torch.int32)),
            born=_set_rows(state.born, tgt, take, state.step.expand(T)),
            ptr=ptr, step=state.step + 1)

    def gather(self, state: CacheState, ids: torch.Tensor,
               fetch: Callable[[torch.Tensor], torch.Tensor], *,
               backend: Optional[str] = None):
        """Rows for the (-1 padded) ``ids``, with only the unique missed
        ids read through ``fetch``.

        ``fetch(missed int32[T] unique ascending, -1 pad) -> f32[T, F]``
        reads the backing store (0 on pad slots). Returns ``(rows
        f32[T, F], new_state, metrics)``; the metrics are device scalars
        ``hits``, ``misses`` (queried ids that missed) and
        ``unique_misses``. Hits serve earlier fetched rows verbatim, so
        the rows equal a direct gather bit for bit."""
        C, T = self.capacity, ids.shape[0]
        dd, hit = self._lookup(state, ids, backend)
        fetched = fetch(dd.new)
        hit_slots = torch.clamp(dd.slots, 0, C - 1).long()
        hit_rows = state.values[hit_slots]
        miss_rows = fetched[torch.clamp(dd.slots - C, 0, T - 1).long()]
        rows = torch.where(hit[:, None], hit_rows, miss_rows)
        rows = torch.where((ids >= 0)[:, None], rows, 0.0)
        new_state = self._insert(state, dd.new, dd.num_new, fetched,
                                 hit_slots, hit)
        valid = (ids >= 0).sum(dtype=torch.int32)
        hits = hit.sum(dtype=torch.int32)
        metrics = {"hits": hits, "misses": valid - hits,
                   "unique_misses": dd.num_new}
        return rows, new_state, metrics


@dataclasses.dataclass(frozen=True)
class HiddenCache:
    """Stale hidden-state cache: the deepest GNN layer's output for hot
    vertices, served while at most ``max_age`` serve steps old.

    ``max_age=0`` serves no entry of an earlier step (the logits equal
    the cache-off logits bit for bit); ``max_age=k`` serves entries up
    to k steps old and refreshes expired hits in place.
    """
    capacity: int
    max_age: int = 0
    policy: str = "fifo"

    def __post_init__(self):
        if self.max_age < 0:
            raise ValueError(f"max_age must be >= 0, got {self.max_age}")
        self._table  # constructing it validates capacity and policy

    @property
    def _table(self) -> VertexCache:
        return VertexCache(self.capacity, self.policy)

    def init_state(self, hidden_dim: int, dtype=torch.float32,
                   device="cpu") -> CacheState:
        return self._table.init_state(hidden_dim, dtype, device)

    def substitute(self, state: CacheState, ids: torch.Tensor,
                   fresh: torch.Tensor, *, backend: Optional[str] = None):
        """Cached rows for unexpired hits, ``fresh`` otherwise; misses
        insert their fresh rows and expired hits are refreshed in place.

        ``fresh f32[S, H]`` is this step's hidden state for ``ids`` (the
        fixed-shape forward computes it regardless: the cache bounds
        staleness, it does not shrink the work). Returns ``(rows,
        new_state, metrics)`` with device scalars ``hidden_hits``,
        ``hidden_expired`` and ``max_served_age`` (<= max_age always)."""
        C, S = self.capacity, ids.shape[0]
        dd, hit = self._table._lookup(state, ids, backend)
        slot = torch.clamp(dd.slots, 0, C - 1).long()
        age = state.step - state.born[slot]
        live = hit & (age <= self.max_age)
        fresh = fresh.to(state.values.dtype)
        rows = torch.where(live[:, None], state.values[slot], fresh)
        rows = torch.where((ids >= 0)[:, None], rows, 0.0)

        # refresh expired hits in place (same slot, new value and birth;
        # copies of one id carry one fresh row)
        expired = hit & ~live
        refreshed = dataclasses.replace(
            state, values=_set_rows(state.values, slot, expired, fresh),
            born=_set_rows(state.born, slot, expired, state.step.expand(S)))

        # misses insert their fresh rows, laid out in the miss list's
        # order first (slot - C is each missed id's place in dd.new); the
        # insert reads the first min(S, C) of them
        first = min(S, C)
        fresh_by_miss = _set_rows(
            fresh.new_zeros((first,) + tuple(fresh.shape[1:])),
            (dd.slots - C).long(),
            (dd.slots >= C) & (dd.slots - C < first), fresh)
        new_state = self._table._insert(refreshed, dd.new, dd.num_new,
                                        fresh_by_miss, slot, live)
        served_age = torch.where(live, age, 0)
        metrics = {"hidden_hits": live.sum(dtype=torch.int32),
                   "hidden_expired": expired.sum(dtype=torch.int32),
                   "max_served_age": served_age.max()}
        return rows, new_state, metrics
