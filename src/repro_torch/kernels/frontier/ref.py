"""Plain PyTorch versions of the frontier primitives (twin of
``repro.kernels.frontier.ref``).

Each function is the contract its CUDA kernel in ``csrc/frontier.cu`` is
held to, and what the kernel wrappers run on a CPU tensor. Nothing here
is sized by the graph's vertex count, and nothing syncs with the host.

Bit-compatibility contracts (relied on by the sampler parity tests):

  * ``hash_dedup`` returns the unique new values in ASCENDING order; on
    overflow ``new`` holds the smallest ``new_cap`` of them, ``num_new``
    stays exact and a dropped value's slot is -1;
  * ``compact`` preserves arrival order (``jnp.nonzero(size=cap,
    fill_value=0)``);
  * ``compact_perm`` is a STABLE by-key ordering, invalid entries last;
  * ``segment_select`` takes, per segment, the ``take`` smallest keys,
    ties in arrival order -- the set a stable per-segment sort takes.

The ``n_live`` argument of each primitive is a hint for the kernels
(entries at index >= n_live are masked); these versions do not need it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_INT_MAX = 2**31 - 1


class DedupResult(NamedTuple):
    """new int32[new_cap] unique new values, ascending, -1 pad;
    slots int32[E] index of values[e] in ``[seeds ; new]`` (-1 where
    masked or dropped); num_new int32[] exact distinct count;
    overflow bool[] num_new > new_cap."""
    new: torch.Tensor
    slots: torch.Tensor
    num_new: torch.Tensor
    overflow: torch.Tensor


def _seed_member(values, valid, seeds):
    """bool[E]: values[e] appears among the valid entries of seeds."""
    S = seeds.shape[0]
    sseeds = torch.sort(torch.where(seeds >= 0, seeds, _INT_MAX)).values
    j = torch.clamp(torch.searchsorted(sseeds, values), 0, S - 1)
    return valid & (sseeds[j] == values)


def hash_dedup(values: torch.Tensor, mask: torch.Tensor,
               seeds: Optional[torch.Tensor], new_cap: int,
               n_live: Optional[torch.Tensor] = None) -> DedupResult:
    """Deduplicate masked ``values`` against ``seeds`` (unique ids, -1
    pad) and build the value -> slot lookup of ``[seeds ; new]``, with
    cap-bounded sorts."""
    del n_live
    E = values.shape[0]
    dev = values.device
    valid = mask & (values >= 0)
    valid_new = (valid & ~_seed_member(values, valid, seeds)
                 if seeds is not None else valid)

    sc = torch.sort(torch.where(valid_new, values, _INT_MAX)).values
    first = torch.ones(min(E, 1), dtype=torch.bool, device=dev)
    uniq = (sc != _INT_MAX) & torch.cat([first, sc[1:] != sc[:-1]])
    num_new = uniq.sum(dtype=torch.int32)
    pos = torch.cumsum(uniq.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(uniq & (pos < new_cap), pos, new_cap).long()
    new = torch.full((new_cap + 1,), -1, dtype=torch.int32, device=dev)
    new = new.scatter_(0, tgt, torch.where(uniq, sc, -1))[:-1]

    new_keys = torch.where(new >= 0, new, _INT_MAX)
    tbl = (torch.cat([torch.where(seeds >= 0, seeds, _INT_MAX), new_keys])
           if seeds is not None else new_keys)
    order = torch.argsort(tbl, stable=True)
    tv = tbl[order]
    j = torch.clamp(torch.searchsorted(tv, values), 0, tv.shape[0] - 1)
    found = valid & (tv[j] == values)
    slots = torch.where(found, order[j].to(torch.int32), -1)
    return DedupResult(new=new, slots=slots, num_new=num_new,
                       overflow=num_new > new_cap)


def compact(flags: torch.Tensor, cap: int,
            n_live: Optional[torch.Tensor] = None):
    """Order-preserving stream compaction: (sel int32[cap] indices of
    the first ``cap`` set flags, 0 past the end; emask bool[cap];
    num int32[] the true count)."""
    del n_live
    E = flags.shape[0]
    dev = flags.device
    f = flags.to(torch.int32)
    num = f.sum(dtype=torch.int32)
    pos = torch.cumsum(f, 0, dtype=torch.int32) - 1
    tgt = torch.where(flags & (pos < cap), pos, cap).long()
    sel = torch.zeros(cap + 1, dtype=torch.int32, device=dev).scatter_(
        0, tgt, torch.arange(E, dtype=torch.int32, device=dev))[:-1]
    emask = torch.arange(cap, device=dev) < torch.clamp(num, max=cap)
    return sel, emask, num


def compact_perm(keys: torch.Tensor, valid: torch.Tensor, num_keys: int,
                 n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable permutation ordering entries by ascending key (keys in
    [-1, num_keys); invalid entries last) -- ``SampledLayer.src_perm``."""
    del n_live
    return torch.argsort(torch.where(valid, keys, num_keys),
                         stable=True).to(torch.int32)


def segment_select(keys: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                   seg_start: torch.Tensor, take: torch.Tensor,
                   n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment smallest-``take`` selection over segment-contiguous
    edges (sequential Poisson, paper §A.3): include[e] iff (keys[e], e)
    ranks below take[slot[e]] within its segment.

    keys float32[E] >= 0; ``slot`` int32[E] is the segment of each
    masked-in edge, and segment s occupies ``[seg_start[s],
    seg_start[s + 1])`` (the last one ends at E): the
    ``expand_seed_edges`` layout, masked entries only on the tail;
    ``take`` int32[S]. A segment whose buffer holds fewer than ``take``
    edges includes all it holds; a ``take`` of 0 selects nothing.

    The threshold T_s, the take-th smallest key, is built bit by bit
    over the keys' monotone int32 view: 31 masked segment counts (a
    prefix sum and two boundary gathers each), then the keys below T_s
    and the earliest ties at T_s up to the budget are included.
    """
    del n_live
    E = keys.shape[0]
    S = seg_start.shape[0]
    dev = keys.device
    u = keys.to(torch.float32).contiguous().view(torch.int32)
    cslot = torch.clamp(slot, 0, S - 1).long()
    starts = torch.clamp(seg_start, 0, E).long()
    ends = torch.cat([starts[1:], torch.full((1,), E, dtype=torch.int64,
                                             device=dev)])
    zero = torch.zeros(1, dtype=torch.int32, device=dev)

    def seg_count(pred):
        ex = torch.cat([zero, torch.cumsum(pred.to(torch.int32), 0,
                                           dtype=torch.int32)])
        return ex[ends] - ex[starts]

    T = torch.zeros(S, dtype=torch.int32, device=dev)
    for b in range(30, -1, -1):
        cand = T + ((1 << b) - 1)
        T = torch.where(seg_count(mask & (u <= cand[cslot])) >= take,
                        T, T + (1 << b))
    Te = T[cslot]
    lt = mask & (u < Te)
    cnt_lt = seg_count(lt)
    eq = mask & (u == Te)
    excl = torch.cumsum(eq.to(torch.int32), 0, dtype=torch.int32) - eq.to(
        torch.int32)
    base = excl[torch.clamp(seg_start, 0, max(E - 1, 0)).long()]
    eq_rank = excl - base[cslot]
    budget = (take - cnt_lt)[cslot]
    return lt | (eq & (eq_rank < budget))


#: row length of :func:`fixed_order_cumsum`
SCAN_ROW = 1024


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float cumsum of a non-negative 1-D tensor in one fixed
    order, non-decreasing: rows of ``SCAN_ROW`` entries are scanned along
    dim 1, then the row totals by the same function, and added. A
    multi-row scan is PyTorch's row-scan kernel on the card, whose order
    is fixed; a 1-D ``torch.cumsum`` there is a single-pass scan whose
    float association depends on timing, so two runs could differ in the
    last bits. The carry is summed in another order than each row, so a
    row could start an ulp below the previous row's end: each row is
    lifted to the running max of the row ends before it, so that every
    exact search over the sum (the kernel's G-ary rounds, searchsorted's
    bisection) finds the same index."""
    C = x.shape[0]
    R = -(-C // SCAN_ROW)
    xp = torch.zeros(max(R, 2) * SCAN_ROW, dtype=x.dtype, device=x.device)
    xp[:C] = x
    rows = torch.cumsum(xp.view(-1, SCAN_ROW), dim=1)
    if R <= 1:
        return rows[0, :C]
    rows = rows[:R]
    carry = fixed_order_cumsum(rows[:, -1].contiguous())
    rows[1:] += carry[:-1, None]
    ends = torch.cummax(rows[:, -1], 0).values
    rows[1:] = torch.maximum(rows[1:], ends[:-1, None])
    return rows.reshape(-1)[:C]


def normalized_cdf(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked cumulative distribution normalised by its own final value,
    non-decreasing, so that the last entry is exactly 1.0 (or every entry
    0 when nothing is valid) and an inverse-CDF draw can never index past
    the buffer.
    Shared by the kernel and the plain search, so both search the same
    floats."""
    pv = torch.where(valid, torch.clamp(p, min=0.0), 0.0)
    cdf = fixed_order_cumsum(pv)
    return cdf / torch.clamp(cdf[-1:], min=1e-30)


#: lanes per draw of the kernel's search (``kG`` in ``csrc/search.cu``;
#: a card test checks that the two agree)
SEARCH_G = 8


def search_rounds(C: int) -> int:
    """Rounds of the ``SEARCH_G``-ary search over a CDF of ``C`` entries:
    a round leaves at most ceil(len / G) - 1 of ``len`` candidates."""
    rounds = 0
    while C > 0:
        C = -(-C // SEARCH_G) - 1
        rounds += 1
    return rounds


def cdf_search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each u, the first index i with ``cdf[i] >= u`` (searchsorted
    'left' over a non-decreasing cdf), clipped into [0, C - 1]: int32[n].
    The kernel's arithmetic (``csrc/search.cu``), so the two agree on any
    input: every draw searches [lo, hi) in lockstep; a round splits it
    into ``SEARCH_G`` chunks of ceil(len / G) entries, probes the last
    entry of each (a probe past hi - 1 counts as reached), and keeps the
    first chunk whose probe reaches u, without that probe; no chunk
    reaching u leaves lo = hi. A NaN u reaches no entry and ends at C,
    clipped to C - 1."""
    C, n = cdf.shape[0], u.shape[0]
    dev = u.device
    lanes = torch.arange(1, SEARCH_G + 1, dtype=torch.int64, device=dev)
    lo = torch.zeros(n, dtype=torch.int64, device=dev)
    hi = torch.full((n,), C, dtype=torch.int64, device=dev)
    for _ in range(search_rounds(C)):
        step = (hi - lo + SEARCH_G - 1) // SEARCH_G
        p = lo[:, None] + lanes * step[:, None] - 1
        reached = (p >= hi[:, None]) | (
            cdf[torch.clamp(p, 0, C - 1)] >= u[:, None])
        k = torch.argmax(reached.to(torch.uint8), dim=1)   # first reached
        go = (lo < hi) & reached.any(1)
        stop = (lo < hi) & ~go
        lo, hi = (torch.where(go, lo + k * step, torch.where(stop, hi, lo)),
                  torch.where(go, torch.minimum(lo + (k + 1) * step - 1, hi),
                              hi))
    return torch.clamp(lo, 0, C - 1).to(torch.int32)


def masked_cdf_draw(p: torch.Tensor, valid: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws over the valid entries of ``p``: for each u in
    [0, 1), the first index whose normalised CDF reaches u, clipped into
    the buffer (int32[n]). u = 0 gives index 0 whether or not entry 0 is
    valid, and a plateau of zero mass resolves to its first index."""
    return cdf_search(normalized_cdf(p, valid), u)
