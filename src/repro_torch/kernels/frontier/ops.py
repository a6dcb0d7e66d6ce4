"""Wrappers of the Hopper frontier kernels (``csrc/frontier.cu``,
``csrc/select.cu``, ``csrc/search.cu``).

They replace the TPU kernels of ``repro/kernels/frontier``: the serial
``compact_kernel``/``dedup_kernel``/``lookup_kernel``/``perm_kernel``/
``select_kernel``/``search_kernel`` (``frontier.py``) and the
grid-parallel ``compact_tiles_kernel``/``dedup_tiles_kernel``/
``dedup_merge_kernel``/``lookup_batched_kernel``/``sort_packed_kernel``/
``sort_pairs_kernel``/``select_sort_kernel``/``batched_search_kernel``
(``parallel.py``). One design per contract; both
TPU variants are held to the same contract.

On a CPU tensor each wrapper runs the plain version in ``ref.py``; on a
CUDA tensor it checks device, dtype, shape and contiguity, allocates its
outputs at the static caps (no host sync sizes anything; compact,
compact_perm, hash_dedup and segment_select take their scratch from
:func:`_scratch`, cached per stream), launches on the current stream,
raises if the launch failed, and adds one to its entry of
:data:`LAUNCHES`. ``n_live`` (an int32 device scalar, optional) bounds
the work by the real count: entries at index >= n_live must be masked,
and the kernels stop there.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier import ref
from repro_torch.kernels.frontier.ref import DedupResult

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"compact": 0, "hash_dedup": 0, "compact_perm": 0,
            "segment_select": 0, "masked_cdf_draw": 0}

# constants of frontier.cu (a card test checks the first three)
_COMPACT_TILE = 16384  # kCompactTile: flags a compact tile
_SORT_TILE = 4096      # kSortTile: keys a radix-sort tile
_DIGIT_BITS = 8        # kDigitBits: bits a radix-sort pass
_RADIX = 1 << _DIGIT_BITS
_MAX_PASSES = 4        # kMaxPasses: 32-bit keys


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


def _check_live(n_live: Optional[torch.Tensor], device) -> None:
    if n_live is None:
        return
    if (n_live.device != device or n_live.dtype != torch.int32
            or n_live.numel() != 1):
        raise ValueError("n_live must be one int32 element on the device "
                         "of the inputs")


def _stream(device) -> int:
    """The raw handle of the current stream on ``device`` (a CUDA device
    with its index): ``current_stream(device).cuda_stream`` without
    building a Stream object on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


#: scratch per (kernel, device index, stream): [list of int64 tensors, the
#: last epoch]; each tensor grown on demand, never shared between kernels
#: or streams
_SCRATCH = {}
_EPOCH_END = 1 << 30   # epochs are 1 .. 2^30 - 1 (30 bits of a word)
#: held from taking an epoch to the launch, so epochs rise in launch order
#: on a stream (the kernels' tickets and tagged words rely on it)
_SCRATCH_LOCK = threading.Lock()


def _scratch(kernel: str, dev, stream: int, *words: int):
    """``kernel``'s scratch tensors on this stream, the i-th of at least
    ``words[i]`` int64 words, and this call's epoch. A kernel keeps each
    kind of epoch-tagged word in a tensor of its own, so that whatever
    sizes earlier calls had, a word there is either this call's or reads
    as an earlier epoch's. A new or grown tensor is zeroed (epoch 0 is
    never a call's) and the epoch counter runs on, so the other tensors'
    words stay older than the next epoch; when the counter wraps, every
    tensor is zeroed once more, so no earlier call's word can carry the
    current epoch."""
    key = (kernel, dev.index, stream)
    entry = _SCRATCH.get(key)
    if entry is None:
        entry = _SCRATCH[key] = [[None] * len(words), 0]
    bufs = entry[0]
    for i, need in enumerate(words):
        if bufs[i] is None or bufs[i].numel() < need:
            size = need if bufs[i] is None else max(need,
                                                    2 * bufs[i].numel() - 1)
            bufs[i] = torch.zeros(size, dtype=torch.int64, device=dev)
    entry[1] += 1
    if entry[1] == _EPOCH_END:
        for b in bufs:
            b.zero_()
        entry[1] = 1
    return bufs, entry[1]


def _perm_passes(num_keys: int) -> int:
    """Digit passes of compact_perm's radix sort: its keys are at most
    ``num_keys + 1``."""
    return max(1, -(-(num_keys + 1).bit_length() // _DIGIT_BITS))


def _sort_words(E: int, passes: int) -> int:
    """The radix sort's tagged words (``sort_words`` in frontier.cu):
    digit totals and a ticket for each of 4 passes, a count and a max
    word, then a status word per digit, tile and pass."""
    tiles = max(1, -(-E // _SORT_TILE))
    return _MAX_PASSES * (_RADIX + 1) + 2 + passes * tiles * _RADIX


def _dedup_table(S: int, E: int) -> int:
    """Slots of hash_dedup's table (``dedup_table_cap``): a power of two
    (8 at the least) at least 1.5 (S + E), so at most 2/3 full."""
    p, need = 8, S + E + (S + E + 1) // 2
    while p < need:
        p *= 2
    return p


def compact(flags: torch.Tensor, cap: int,
            n_live: Optional[torch.Tensor] = None):
    """Order-preserving stream compaction (contract: ``ref.compact``):
    one launch, a single-pass chained scan with decoupled look-back over
    tiles of the live flags, scratch reused per stream."""
    if flags.device.type == "cpu":
        return ref.compact(flags, cap)
    dev = flags.device
    _check("flags", flags, torch.bool, dev)
    _check_live(n_live, dev)
    E = flags.shape[0]
    stream = _stream(dev)
    sel = torch.empty(cap, dtype=torch.int32, device=dev)
    emask = torch.empty(cap, dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    fn = _build.function("frontier_compact")
    with _SCRATCH_LOCK:
        (scratch,), epoch = _scratch("compact", dev, stream,
                                     1 + 2 * -(-E // _COMPACT_TILE))
        status = fn(_build.ptr(flags), E, _build.ptr(n_live), cap,
                    _build.ptr(sel), _build.ptr(emask), _build.ptr(num),
                    _build.ptr(scratch), epoch, stream)
    _build.check(status, "frontier_compact")
    LAUNCHES["compact"] += 1
    return sel, emask, num


def compact_perm(keys: torch.Tensor, valid: torch.Tensor, num_keys: int,
                 n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable permutation by ascending key, invalid last (contract:
    ``ref.compact_perm``): the shared single-pass radix sort of ``key +
    1`` with the index as payload, 1 + :func:`_perm_passes` launches."""
    if keys.device.type == "cpu":
        return ref.compact_perm(keys, valid, num_keys)
    dev = keys.device
    _check("keys", keys, torch.int32, dev)
    _check("valid", valid, torch.bool, dev)
    _check_live(n_live, dev)
    E = keys.shape[0]
    if valid.shape[0] != E:
        raise ValueError("keys and valid differ in length")
    if not 0 <= num_keys < 2**31 - 2:
        raise ValueError(f"num_keys {num_keys} out of range")
    passes = _perm_passes(num_keys)
    perm = torch.empty(E, dtype=torch.int32, device=dev)
    stream = _stream(dev)
    fn = _build.function("frontier_compact_perm")
    with _SCRATCH_LOCK:
        # the sort's tagged words; two lists of (key, index) pairs
        (sorts, lists), epoch = _scratch("compact_perm", dev, stream,
                                         _sort_words(E, passes), 2 * E)
        status = fn(_build.ptr(keys), _build.ptr(valid), E,
                    _build.ptr(n_live), num_keys, passes, _build.ptr(perm),
                    _build.ptr(sorts), sorts.numel(), _build.ptr(lists),
                    2 * lists.numel(), epoch, stream)
    _build.check(status, "frontier_compact_perm")
    LAUNCHES["compact_perm"] += 1
    return perm


def hash_dedup(values: torch.Tensor, mask: torch.Tensor,
               seeds: Optional[torch.Tensor], new_cap: int,
               n_live: Optional[torch.Tensor] = None) -> DedupResult:
    """Dedup against ``seeds`` + value -> slot lookup (contract:
    ``ref.hash_dedup``, overflow included): an epoch-tagged
    open-addressing table cached per stream, the new values sorted by the
    shared radix sort, one probe per value; 7 launches (6 with no
    seeds)."""
    if values.device.type == "cpu":
        return ref.hash_dedup(values, mask, seeds, new_cap)
    dev = values.device
    _check("values", values, torch.int32, dev)
    _check("mask", mask, torch.bool, dev)
    if seeds is not None:
        _check("seeds", seeds, torch.int32, dev)
    _check_live(n_live, dev)
    E = values.shape[0]
    if mask.shape[0] != E:
        raise ValueError("values and mask differ in length")
    S = 0 if seeds is None else seeds.shape[0]
    new = torch.empty(new_cap, dtype=torch.int32, device=dev)
    slots = torch.empty(E, dtype=torch.int32, device=dev)
    num_new = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    stream = _stream(dev)
    fn = _build.function("frontier_hash_dedup")
    table = _dedup_table(S, E)
    with _SCRATCH_LOCK:
        # the sort's tagged words; the table's slots; the table's values
        # and two lists of (value, slot)
        (sorts, tkeys, lists), epoch = _scratch(
            "hash_dedup", dev, stream, _sort_words(E, _MAX_PASSES), table,
            (table + 4 * E + 1) // 2)
        status = fn(_build.ptr(values), _build.ptr(mask), E,
                    _build.ptr(n_live), _build.ptr(seeds), S, new_cap,
                    _build.ptr(new), _build.ptr(slots), _build.ptr(num_new),
                    _build.ptr(overflow), _build.ptr(sorts), sorts.numel(),
                    _build.ptr(tkeys), tkeys.numel(), _build.ptr(lists),
                    2 * lists.numel(), epoch, stream)
    _build.check(status, "frontier_hash_dedup")
    LAUNCHES["hash_dedup"] += 1
    return DedupResult(new=new, slots=slots, num_new=num_new,
                       overflow=overflow)


def segment_select(keys: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                   seg_start: torch.Tensor, take: torch.Tensor,
                   n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment smallest-``take`` keys, ties by arrival order
    (contract: ``ref.segment_select``): one warp per segment with the
    keys in registers, one block per segment longer than 256 edges (a
    radix select over keys staged in shared memory); 2 launches, the
    long-segment list cached per stream. The kernel reads the segments
    from ``seg_start``; ``slot`` must agree with it, as in the
    ``expand_seed_edges`` layout."""
    if keys.device.type == "cpu":
        return ref.segment_select(keys, slot, mask, seg_start, take)
    dev = keys.device
    _check("keys", keys, torch.float32, dev)
    _check("slot", slot, torch.int32, dev)
    _check("mask", mask, torch.bool, dev)
    _check("seg_start", seg_start, torch.int32, dev)
    _check("take", take, torch.int32, dev)
    _check_live(n_live, dev)
    E, S = keys.shape[0], seg_start.shape[0]
    if not (slot.shape[0] == mask.shape[0] == E and take.shape[0] == S):
        raise ValueError("segment_select: edge or segment arrays differ "
                         "in length")
    include = torch.empty(E, dtype=torch.bool, device=dev)
    stream = _stream(dev)
    fn = _build.function("frontier_segment_select")
    with _SCRATCH_LOCK:
        # the tagged long-segment count; the list, two int32 a word
        (count, lst), epoch = _scratch("segment_select", dev, stream, 1,
                                       (S + 1) // 2)
        status = fn(_build.ptr(keys), _build.ptr(mask), E,
                    _build.ptr(n_live), _build.ptr(seg_start),
                    _build.ptr(take), S, _build.ptr(include),
                    _build.ptr(count), _build.ptr(lst), epoch, stream)
    _build.check(status, "frontier_segment_select")
    LAUNCHES["segment_select"] += 1
    return include


def cdf_search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """First index with ``cdf >= u``, clipped into the buffer (contract:
    ``ref.cdf_search``): a group of ``ref.SEARCH_G`` (8) lanes per
    draw, a G-ary search with one ballot a round, the first two rounds'
    entries staged in shared memory once per block."""
    if cdf.device.type == "cpu":
        return ref.cdf_search(cdf, u)
    dev = cdf.device
    _check("cdf", cdf, torch.float32, dev)
    _check("u", u, torch.float32, dev)
    C, n = cdf.shape[0], u.shape[0]
    if C < 1:
        raise ValueError("cdf_search needs a CDF of at least one entry")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    status = _build.function("frontier_cdf_search")(
        _build.ptr(cdf), C, _build.ptr(u), n, _build.ptr(out), _stream(dev))
    _build.check(status, "frontier_cdf_search")
    LAUNCHES["masked_cdf_draw"] += 1
    return out


def masked_cdf_draw(p: torch.Tensor, valid: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws over the valid entries of ``p`` (contract:
    ``ref.masked_cdf_draw``): the shared plain ``normalized_cdf``, then
    the search kernel."""
    if p.device.type == "cpu":
        return ref.masked_cdf_draw(p, valid, u)
    _check("p", p, torch.float32, p.device)
    _check("valid", valid, torch.bool, p.device)
    if valid.shape != p.shape:
        raise ValueError("p and valid differ in length")
    return cdf_search(ref.normalized_cdf(p, valid), u)
