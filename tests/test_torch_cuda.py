"""The CUDA kernels of repro_torch against their plain versions, on the
card. No JAX here: the machine with the card has none. Every test is
marked ``cuda`` and skips without a card; run them there with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import ops as TO  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS, pad_seeds  # noqa: E402
from repro_torch.graph.generators import paper_dataset  # noqa: E402
from repro_torch.kernels.edge_softmax import ops as ek  # noqa: E402
from repro_torch.kernels.edge_softmax import ref as er  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fr_attn  # noqa: E402
from repro_torch.kernels.frontier import ops as fk  # noqa: E402
from repro_torch.kernels.frontier import ref as fr  # noqa: E402
from repro_torch.kernels.spmm import ops as sk  # noqa: E402
from repro_torch.kernels.spmm import ref as sr  # noqa: E402
from repro_torch.models.gnn import MODELS, gcn_init  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime.engine import (TrainEngine, gnn_loss_fn,  # noqa: E402
                                        seed_labels)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (the kernels have no CPU
    mode); skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 255, 2048, 4097, 50_000])
def test_frontier_kernels_match_plain(cuda_device, E):
    """compact, compact_perm and hash_dedup at tile-boundary sizes, with
    and without the n_live prefix, overflow included."""
    g = torch.Generator(device=cuda_device).manual_seed(E)
    live = torch.tensor(E - E // 3, dtype=torch.int32, device=cuda_device)
    prefix = torch.arange(E, device=cuda_device) < live
    flags = (torch.rand(E, generator=g, device=cuda_device) < 0.4) & prefix
    for n in (None, live):
        for got, want in zip(fk.compact(flags, E // 2 + 1, n),
                             fr.compact(flags, E // 2 + 1)):
            assert torch.equal(got, want)
    keys = torch.randint(-1, 300, (E,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    assert torch.equal(fk.compact_perm(keys, prefix, 300, live),
                       fr.compact_perm(keys, prefix, 300))
    seeds = torch.randperm(400, generator=g, device=cuda_device)[:50].to(
        torch.int32)
    for new_cap in (5, E):
        got = fk.hash_dedup(keys, prefix, seeds, new_cap, live)
        want = fr.hash_dedup(keys, prefix, seeds, new_cap)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


#: both sides of a warp's 32 flags and of 1, 2, 32 and 33 of compact's
#: tiles (the look-back walks back 32 tiles a step)
COMPACT_SIZES = [1, 31, 33] + [k * fk._COMPACT_TILE + d
                               for k in (1, 2, 32, 33) for d in (-1, 0, 1)]


def _compact_equal(flags, cap, live=None):
    for got, want in zip(fk.compact(flags, cap, live),
                         fr.compact(flags, cap)):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("E", COMPACT_SIZES)
def test_compact_single_pass_matches_plain(cuda_device, E):
    """The one-launch compact bit for bit at tile-boundary sizes: n_live
    0, half and E (and none), cap 0, below, at and above num, and E."""
    g = torch.Generator(device=cuda_device).manual_seed(E)
    flags = torch.rand(E, generator=g, device=cuda_device) < 0.5
    for n_live in (None, 0, E // 2, E):
        f = flags.clone()
        if n_live is not None:
            f[n_live:] = False
            live = torch.tensor(n_live, dtype=torch.int32, device=cuda_device)
        else:
            live = None
        num = int(f.sum())
        for cap in sorted({0, max(num - 1, 0), num, num + 1, E}):
            _compact_equal(f, cap, live)


@pytest.mark.cuda
def test_compact_at_the_layer2_edge_cap(cuda_device):
    """E = 9,426,304 slots (LADIES's and LABOR-0's layer-2 cap), ~10%
    set over a live prefix, cap = E and cap below num."""
    E = 9_426_304
    g = torch.Generator(device=cuda_device).manual_seed(5)
    flags = torch.rand(E, generator=g, device=cuda_device) < 0.1
    for n_live in (E, 5_000_001):
        flags[n_live:] = False
        live = torch.tensor(n_live, dtype=torch.int32, device=cuda_device)
        for cap in (E, 448_384):
            _compact_equal(flags, cap, live)


@pytest.mark.cuda
def test_compact_repeated_calls_reuse_the_scratch(cuda_device):
    """50 calls in a row of different sizes on one stream: the cached
    status words, the per-call epoch and the epoch-tagged ticket."""
    rng = torch.Generator().manual_seed(9)
    outs = []
    for i in range(50):
        E = int(torch.randint(1, 200_000, (1,), generator=rng))
        p = float(torch.rand(1, generator=rng))
        flags = (torch.rand(E, generator=rng) < p).to(cuda_device)
        live = torch.tensor(int(torch.randint(0, E + 1, (1,), generator=rng)),
                            dtype=torch.int32, device=cuda_device)
        flags[int(live):] = False
        cap = int(torch.randint(0, E + 1, (1,), generator=rng))
        outs.append((flags, cap, fk.compact(flags, cap, live)))
    for flags, cap, got in outs:
        for x, y in zip(got, fr.compact(flags, cap)):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_compact_after_a_skipped_epoch_and_the_wrap(cuda_device):
    """An epoch taken with no launch (as by a launch that failed) leaves
    the ticket of the call before; the next calls raise it and still
    match. Then the epoch counter runs past its end and wraps."""
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(17)
    key = ("compact", dev.index, fk._stream(dev))
    for E in (200_000, 70_001, 200_000):
        flags = torch.rand(E, generator=g, device=dev) < 0.4
        _compact_equal(flags, E // 3)
        fk._scratch("compact", dev, key[2], 1 + 2 * -(-E // fk._COMPACT_TILE))
    fk._SCRATCH[key][1] = fk._EPOCH_END - 3
    for E in (50_000, 200_000, 33, 120_000, 16_385):
        flags = torch.rand(E, generator=g, device=dev) < 0.6
        _compact_equal(flags, E)
    assert fk._SCRATCH[key][1] == 3


@pytest.mark.cuda
def test_compact_on_two_streams(cuda_device):
    """Calls interleaved on two streams, each with its own scratch, each
    result checked."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    inputs = [torch.rand(E, generator=g, device=cuda_device) < 0.3
              for E in (70_000, 123_457, 9_000, 300_001) * 3]
    outs = []
    for i, flags in enumerate(inputs):
        st = streams[i % 2]
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append((st, fk.compact(flags, flags.shape[0] // 2)))
    torch.cuda.synchronize()
    for flags, (st, got) in zip(inputs, outs):
        for x, y in zip(got, fr.compact(flags, flags.shape[0] // 2)):
            assert torch.equal(x, y)
    scratch = [fk._SCRATCH[("compact", 0, st.cuda_stream)][0][0]
               for st in streams]
    assert scratch[0].data_ptr() != scratch[1].data_ptr()


@pytest.mark.cuda
def test_wrapper_constants_match_the_kernels(cuda_device):
    """The tile widths the wrappers size compact's and the radix sort's
    scratch by, the sort's digit width, and the lanes per draw the plain
    search mirrors, are the built kernels'."""
    from repro_torch.kernels import _build
    assert fk._COMPACT_TILE == _build.function("frontier_compact_tile")()
    assert fk._SORT_TILE == _build.function("frontier_sort_tile")()
    assert fk._DIGIT_BITS == _build.function("frontier_digit_bits")()
    assert fr.SEARCH_G == _build.function("frontier_search_group")()


@pytest.mark.cuda
def test_compact_is_one_device_operation(cuda_device):
    """torch.profiler sees one device kernel per compact call, and no
    memset or copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flags = torch.rand(500_000, device=cuda_device) < 0.2
    live = torch.tensor(400_000, dtype=torch.int32, device=cuda_device)
    fk.compact(flags, 100_000, live)
    torch.cuda.synchronize()
    for _ in range(3):   # profiled again when the profiler lost events
        fk.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(7):
                fk.compact(flags, 100_000, live)
            torch.cuda.synchronize()
        ops = [(e.key, e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
        if sum(c for _, c in ops) >= 7:
            break
    assert fk.LAUNCHES["compact"] == 7
    assert sum(c for _, c in ops) == 7, ops
    assert all("compact" in k for k, _ in ops), ops


def _perm_equal(keys, valid, K, live=None):
    got = fk.compact_perm(keys, valid, K, live)
    want = fr.compact_perm(keys, valid, K)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _dedup_equal(values, mask, seeds, new_cap, live=None):
    got = fk.hash_dedup(values, mask, seeds, new_cap, live)
    want = fr.hash_dedup(values, mask, seeds, new_cap)
    for f, x, y in zip(want._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    return int(want.num_new)


def _dedup_inputs(g, E, hi, dev):
    """E values, half of them drawn from [0, hi) and half from a narrow
    range (duplicates), 80% masked in; seeds: distinct ids taken from the
    values and from [0, hi), -1 padded."""
    wide = torch.randint(0, hi, (E,), generator=g, device=dev,
                         dtype=torch.int32)
    narrow = torch.randint(0, E // 4 + 2, (E,), generator=g, device=dev,
                           dtype=torch.int32)
    values = torch.where(torch.rand(E, generator=g, device=dev) < 0.5, wide,
                         narrow)
    mask = torch.rand(E, generator=g, device=dev) < 0.8
    pick = values[torch.randperm(E, generator=g, device=dev)[:E // 8 + 1]]
    extra = torch.randint(0, hi, (E // 8 + 1,), generator=g, device=dev,
                          dtype=torch.int32)
    seeds = torch.unique(torch.cat([pick, extra])).to(torch.int32)
    seeds = torch.cat([seeds[torch.randperm(seeds.shape[0], generator=g,
                                            device=dev)],
                       torch.full((7,), -1, dtype=torch.int32, device=dev)])
    return values, mask, seeds


#: both sides of one radix-sort tile, of 2, of 4 and 5 (the look-back reads
#: four words a step; 4 tiles are one fill ticket) and of 32
SORT_SIZES = [1, 31, 33, 255] + [k * fk._SORT_TILE + d
                                 for k in (1, 2, 4, 5, 32) for d in (-1, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("E", SORT_SIZES)
def test_sort_kernels_at_tile_boundaries(cuda_device, E):
    """compact_perm with 1, 2 and 3 digit passes and hash_dedup (values
    up to 2^31 - 1, so that all four of its passes have work) bit for
    bit at tile-boundary sizes: n_live none, half and E, new_cap below,
    at and above the distinct count."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(E)
    for n_live in (None, E // 2, E):
        live = (None if n_live is None else
                torch.tensor(n_live, dtype=torch.int32, device=dev))
        valid = torch.rand(E, generator=g, device=dev) < 0.8
        for K in (200, 40_000, 1_083_008):
            keys = torch.randint(-1, K, (E,), generator=g, device=dev,
                                 dtype=torch.int32)
            v = valid.clone()
            if n_live is not None:
                v[n_live:] = False
            _perm_equal(keys, v, K, live)
        values, mask, seeds = _dedup_inputs(g, E, 2**31 - 1, dev)
        if n_live is not None:
            mask[n_live:] = False
        num = _dedup_equal(values, mask, seeds, E, live)
        for new_cap in sorted({max(num - 1, 1), max(num, 1), num + 1}):
            _dedup_equal(values, mask, seeds, new_cap, live)
            _dedup_equal(values, mask, None, new_cap, live)


@pytest.mark.cuda
def test_sort_kernels_at_the_layer2_shapes(cuda_device):
    """Phase 2's layer 2: E = 9,426,304 edge slots, 866,504 live, S =
    470,656 seeds, new_cap = 612,352 (and one that overflows), K =
    1,083,008 vertex slots."""
    dev = cuda_device
    E, n, S, new_cap, K = 9_426_304, 866_504, 470_656, 612_352, 1_083_008
    g = torch.Generator(device=dev).manual_seed(2)
    values = torch.randint(0, 1_000_000, (E,), generator=g, device=dev,
                           dtype=torch.int32)
    mask = torch.arange(E, device=dev) < n
    seeds = torch.randperm(1_000_000, generator=g, device=dev)[:S].to(
        torch.int32)
    live = torch.tensor(n, dtype=torch.int32, device=dev)
    num = _dedup_equal(values, mask, seeds, new_cap, live)
    assert 200_000 < num < new_cap
    _dedup_equal(values, mask, seeds, 200_000, live)
    keys = torch.randint(-1, K, (E,), generator=g, device=dev,
                         dtype=torch.int32)
    _perm_equal(keys, mask, K, live)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 4097, 70_000])
def test_dedup_values_with_the_high_bits(cuda_device, E):
    """Values with bits 24-30 set, 0 and 2^31 - 2 among them (2^31 - 1 is
    the plain version's sentinel, no vertex id), seeds among them too:
    every digit pass of hash_dedup's sort has work."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(E + 1)
    values = torch.randint(2**24, 2**31 - 1, (E,), generator=g, device=dev,
                           dtype=torch.int32)
    values[::7] = 2**31 - 2
    values[3::11] = 0
    values[5::13] = values[1::13][:values[5::13].shape[0]]
    mask = torch.rand(E, generator=g, device=dev) < 0.9
    seeds = torch.unique(values[::5]).to(torch.int32)
    for s in (None, seeds):
        num = _dedup_equal(values, mask, s, E)
        _dedup_equal(values, mask, s, max(num // 2, 1))


@pytest.mark.cuda
def test_sort_kernels_adversarial(cuda_device):
    """chip_smoke.py's adversarial cases of both kernels."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(1)

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    def bools(n, p):
        return torch.rand(n, generator=g, device=dev) < p

    seeds = torch.cat([torch.randperm(5000, generator=g, device=dev)[:300]
                       .to(torch.int32),
                       torch.full((20,), -1, dtype=torch.int32, device=dev)])
    for values, mask, s, new_cap in [
            (ints(3000, 0, 5000), bools(3000, 0.0), seeds, 400),
            (torch.full((3000,), 7, dtype=torch.int32, device=dev),
             bools(3000, 1.0), seeds, 400),
            (ints(20000, 0, 100000), bools(20000, 0.9), seeds, 500),
            (seeds[:300].repeat(10), bools(3000, 1.0), seeds, 10),
            (ints(3000, -1, 800), bools(3000, 0.8), None, 1000),
            (ints(1, 0, 10), bools(1, 1.0), seeds, 1),
            (ints(0, 0, 10), bools(0, 1.0), seeds, 3)]:
        _dedup_equal(values, mask, s, new_cap)
    for E, K, p in ((3000, 1, 0.7), (3000, 50, 0.0), (20000, 70000, 0.8),
                    (2049, 3, 1.0), (0, 5, 1.0)):
        keys, valid = ints(E, -1, K), bools(E, p)
        _perm_equal(keys, valid, K)
        live = torch.tensor(E // 3, dtype=torch.int32, device=dev)
        valid[E // 3:] = False
        _perm_equal(keys, valid, K, live)


def _sort_calls(g, dev, count):
    """``count`` calls of random sizes, hash_dedup and compact_perm in
    turn; returns each call's inputs and outputs, checked later."""
    calls = []
    for i in range(count):
        E = int(torch.randint(1, 150_000, (1,), generator=g, device=dev))
        live = torch.randint(0, E + 1, (), generator=g, device=dev,
                             dtype=torch.int32)
        if i % 2:
            K = int(torch.randint(1, 2_000_000, (1,), generator=g,
                                  device=dev))
            keys = torch.randint(-1, K, (E,), generator=g, device=dev,
                                 dtype=torch.int32)
            valid = (torch.rand(E, generator=g, device=dev) < 0.7) & (
                torch.arange(E, device=dev) < live)
            calls.append((fr.compact_perm, (keys, valid, K),
                          fk.compact_perm(keys, valid, K, live)))
        else:
            values, mask, seeds = _dedup_inputs(g, E, 1 << 22, dev)
            mask &= torch.arange(E, device=dev) < live
            new_cap = int(torch.randint(1, E + 1, (1,), generator=g,
                                        device=dev))
            args = (values, mask, seeds if i % 4 else None, new_cap)
            calls.append((fr.hash_dedup, args, fk.hash_dedup(*args, live)))
    return calls


def _check_calls(calls):
    for plain, args, got in calls:
        want = plain(*args)
        for x, y in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_sort_kernels_repeated_calls_reuse_the_scratch(cuda_device):
    """40 calls in a row of different sizes on one stream, checked after
    the last: the cached table, lists and status words, the per-call
    epoch and the epoch-tagged tickets and counts."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    _check_calls(_sort_calls(g, cuda_device, 40))


@pytest.mark.cuda
def test_sort_kernels_on_two_streams(cuda_device):
    """Calls interleaved on two streams, each stream with its own
    scratch per kernel, each result checked."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    calls = []
    for i in range(12):
        st = streams[i % 2]
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            calls += _sort_calls(g, cuda_device, 2)
    torch.cuda.synchronize()
    _check_calls(calls)
    for kernel in ("hash_dedup", "compact_perm"):
        a, b = (fk._SCRATCH[(kernel, 0, st.cuda_stream)][0] for st in streams)
        assert {x.data_ptr() for x in a}.isdisjoint(x.data_ptr() for x in b)


@pytest.mark.cuda
def test_sort_kernels_after_a_skipped_epoch_and_the_wrap(cuda_device):
    """An epoch taken with no launch leaves the words of the call before;
    the next calls still match. Then each kernel's epoch counter runs
    past its end and wraps, which zeroes its scratch once."""
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(17)
    stream = fk._stream(dev)
    _check_calls(_sort_calls(g, dev, 4))
    for kernel in ("hash_dedup", "compact_perm"):
        entry = fk._SCRATCH[(kernel, dev.index, stream)]
        fk._scratch(kernel, dev, stream, *[0] * len(entry[0]))
        entry[1] = fk._EPOCH_END - 3
    _check_calls(_sort_calls(g, dev, 10))
    for kernel in ("hash_dedup", "compact_perm"):
        assert fk._SCRATCH[(kernel, dev.index, stream)][1] == 3


def _cache_inputs(g, C, T, dev, empty=0.4, hits=0.5, V=612_257):
    """A feature cache's lookup: a key column of C slots holding distinct
    vertex ids with -1 scattered over ``empty`` of it (a ``freq`` table
    evicts anywhere), and T queried ids (the deepest layer's
    ``next_seeds``: a -1 padded tail of a tenth) of which ``hits`` are
    drawn from the keys, repeats included."""
    n_keys = int(C * (1 - empty))
    ids = torch.randperm(V, generator=g, device=dev)[:n_keys].to(torch.int32)
    keys = torch.full((C,), -1, dtype=torch.int32, device=dev)
    keys[torch.randperm(C, generator=g, device=dev)[:n_keys]] = ids
    q = torch.randint(0, V, (T,), generator=g, device=dev, dtype=torch.int32)
    if n_keys:
        pick = ids[torch.randint(0, n_keys, (T,), generator=g, device=dev)]
        q = torch.where(torch.rand(T, generator=g, device=dev) < hits, pick,
                        q)
    q[T - T // 10:] = -1
    return q, keys


def _cache_lookup(q, keys):
    """The lookup of ``VertexCache._lookup``: (plain, kernel) args."""
    return (q, q >= 0, keys, q.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case,C,T,empty,hits", [
    ("scattered empty slots", 262_144, 1_083_008, 0.4, 0.5),
    ("keys outnumber the query", 262_144, 10_000, 0.2, 0.5),
    ("cold table, all -1", 262_144, 300_000, 1.0, 0.0),
    ("every query a hit", 262_144, 500_000, 0.0, 1.0),
])
def test_hash_dedup_at_the_cache_shapes(cuda_device, case, C, T, empty,
                                        hits):
    """hash_dedup as the serving caches call it (the queried ids against
    the cache's key column as its "seeds"), bit for bit against its
    plain version: shapes ``build_block`` never sends, which the
    per-stream scratch must size for."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    q, keys = _cache_inputs(g, C, T, cuda_device, empty, hits)
    args = _cache_lookup(q, keys)
    got = fk.hash_dedup(*args)
    want = fr.hash_dedup(*args)
    for f, x, y in zip(want._fields, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), (case, f)
    hit = (want.slots >= 0) & (want.slots < C)
    if hits == 1.0:
        assert int(want.num_new) == 0 and bool(hit[q >= 0].all())
    if empty == 1.0:
        assert not bool(hit.any())


@pytest.mark.cuda
@pytest.mark.parametrize("S,distinct", [(64, 5), (1024, 300),
                                        (470_656, 20_000)])
def test_hash_dedup_with_repeated_seeds(cuda_device, S, distinct):
    """Seeds that repeat (a coalesced batch of requests that share
    vertices): a value equal to a repeated seed maps to the seed's first
    index, as in the plain version's stable order and the reference's
    serial kernel, bit for bit, in 5 calls of the same inputs."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    dev = cuda_device
    seeds = torch.randint(0, distinct, (S,), generator=g, device=dev,
                          dtype=torch.int32)
    seeds[-S // 10:] = -1
    E = 4 * S
    values = torch.randint(0, 2 * distinct, (E,), generator=g, device=dev,
                           dtype=torch.int32)
    mask = torch.rand(E, generator=g, device=dev) < 0.9
    for _ in range(5):
        _dedup_equal(values, mask, seeds, E)


@pytest.mark.cuda
def test_hash_dedup_cache_lookups_in_a_row(cuda_device):
    """30 cache lookups in a row on one stream, of growing and shrinking
    key columns and queries, each checked after the last: the cached
    table and lists, sized by the largest, stay right for the smaller."""
    g = torch.Generator(device=cuda_device).manual_seed(29)
    calls = []
    for i in range(30):
        C = int(torch.randint(1, 262_145, (1,), generator=g,
                              device=cuda_device))
        T = int(torch.randint(1, 400_000, (1,), generator=g,
                              device=cuda_device))
        q, keys = _cache_inputs(g, C, T, cuda_device, empty=(i % 5) / 4,
                                hits=(i % 3) / 2)
        args = _cache_lookup(q, keys)
        calls.append((fr.hash_dedup, args, fk.hash_dedup(*args)))
    torch.cuda.synchronize()
    _check_calls(calls)


def _device_ops(fn, calls):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _device_ops_of(fn, calls, per_call):
    """``_device_ops`` of ``calls`` calls, profiled again (up to three
    times) when the profiler saw fewer than ``per_call`` operations a
    call: a torch.profiler run on the card now and then loses some of
    its kernel events (a whole test file's run showed it, and
    chip_smoke's trials: one round in five)."""
    for _ in range(3):
        ops = _device_ops(fn, calls)
        if sum(c for _, c in ops) >= calls * per_call:
            break
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("K,passes", [(22_272, 2), (470_656, 3),
                                      (1_083_008, 3)])
def test_compact_perm_is_one_plus_passes_device_operations(cuda_device, K,
                                                           passes):
    """torch.profiler sees the upsweep and one kernel a digit pass per
    compact_perm call at phase 2's vertex caps, and no memset or copy."""
    E = 448_384
    keys = torch.randint(-1, K, (E,), device=cuda_device, dtype=torch.int32)
    valid = torch.rand(E, device=cuda_device) < 0.3
    live = torch.tensor(E // 2, dtype=torch.int32, device=cuda_device)
    valid[E // 2:] = False
    assert fk._perm_passes(K) == passes
    ops = _device_ops_of(lambda: fk.compact_perm(keys, valid, K, live), 5,
                         1 + passes)
    assert sum(c for _, c in ops) == 5 * (1 + passes), ops
    assert all("perm_upsweep" in k or "sort_pass" in k for k, _ in ops), ops


@pytest.mark.cuda
@pytest.mark.parametrize("with_seeds", [True, False])
def test_hash_dedup_is_at_most_seven_device_operations(cuda_device,
                                                       with_seeds):
    """torch.profiler sees 7 kernels per hash_dedup call (6 with no
    seeds), and no memset or copy."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(4)
    values, mask, seeds = _dedup_inputs(g, 448_384, 1 << 20, dev)
    live = torch.tensor(109_557, dtype=torch.int32, device=dev)
    mask[109_557:] = False
    s = seeds if with_seeds else None
    ops = _device_ops_of(lambda: fk.hash_dedup(values, mask, s, 448_384,
                                               live), 5,
                         7 if with_seeds else 6)
    assert sum(c for _, c in ops) == 5 * (7 if with_seeds else 6), ops
    assert all("dedup_" in k or "sort_pass" in k for k, _ in ops), ops


@pytest.mark.cuda
def test_warm_calls_allocate_only_their_outputs(cuda_device):
    """Once the scratch is cached, a hash_dedup call allocates its four
    outputs and compact_perm and segment_select calls their one, nothing
    else."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(6)
    values, mask, seeds = _dedup_inputs(g, 100_000, 1 << 20, dev)
    keys = torch.randint(-1, 22_272, (100_000,), generator=g, device=dev,
                         dtype=torch.int32)
    live = torch.tensor(60_000, dtype=torch.int32, device=dev)
    mask[60_000:] = False
    sel = _segments(g, torch.randint(0, 300, (2000,), generator=g,
                                     device=dev), 200_000, dev)
    calls = ((lambda: fk.hash_dedup(values, mask, seeds, 50_000, live), 4),
             (lambda: fk.compact_perm(keys, mask, 22_272, live), 1),
             (lambda: fk.segment_select(*sel), 1))
    for fn, outputs in calls:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            before = torch.cuda.memory_stats()["allocation.all.allocated"]
            out = fn()
            after = torch.cuda.memory_stats()["allocation.all.allocated"]
            assert after - before == outputs
            del out


@pytest.fixture(scope="module")
def served():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds = paper_dataset("products", 0.004, seed=2)
    sampler = TS.from_dataset("labor-0", ds, batch_size=64, fanouts=(5, 5, 5))
    out = {}
    for backend in ("cuda", "eager"):
        eng = TrainEngine(sampler, device="cuda", backend=backend)
        data = eng.make_data_from_dataset(ds)
        model = gcn_init(TR.key(0), 100, 32, 47, 3, device="cuda")
        out[backend] = eng.infer_blocks(model, data,
                                        pad_seeds(ds.val_idx[:60], 64,
                                                  device="cuda"),
                                        TR.key(11))
    return out


@pytest.mark.cuda
def test_spmm_on_a_sampled_block(served):
    """The SpMM kernel fed blocks straight from the sampler."""
    for blk in served["cuda"][2]:
        for F in (100, 256):
            h = torch.randn(blk.next_cap, F, device="cuda")
            torch.testing.assert_close(TO.aggregate(blk, h, backend="cuda"),
                                       TO.aggregate(blk, h, backend="eager"),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_serving_path_kernels_match_plain(served):
    """One request end to end: blocks bit for bit, logits to 1e-4."""
    (lk, fk_, bk), (le, fe, be) = served["cuda"], served["eager"]
    assert torch.equal(fk_, fe)
    for a, b in zip(bk, be):
        for f in INT_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        torch.testing.assert_close(a.weight, b.weight, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(lk, le, rtol=1e-4, atol=1e-4)


def _segments(g, deg, cap, dev, tie_every=0):
    """An expand_seed_edges-style layout over ``cap`` slots (truncated
    when the degrees sum past it), keys with ties, take = min(k, d)
    with some takes of 0."""
    deg = torch.as_tensor(deg, dtype=torch.int32, device=dev)
    seg_start = (torch.cumsum(deg, 0, dtype=torch.int32) - deg)
    total = int(deg.sum())
    live = min(total, cap)
    pos = torch.arange(cap, device=dev)
    slot = (torch.searchsorted(torch.cumsum(deg, 0), pos, right=True)
            .to(torch.int32))
    mask = pos < live
    slot = torch.where(mask, slot, -1)
    keys = torch.rand(cap, generator=g, device=dev) * 4
    if tie_every:
        keys = torch.where(pos % tie_every == 0, torch.full_like(keys, 0.5),
                           keys)
    keys = torch.where(mask, keys, 3.4e38)
    take = torch.clamp(deg, max=10)
    take = torch.where(torch.arange(len(deg), device=dev) % 11 == 3, 0, take)
    return keys, slot, mask, seg_start, take.to(torch.int32), torch.tensor(
        live, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg,max_deg,trunc", [(1, 1, 1.0), (7, 40, 1.0),
                                                 (300, 300, 1.0),
                                                 (2000, 1500, 0.6)])
def test_segment_select_kernel_matches_plain(cuda_device, n_seg, max_deg,
                                             trunc):
    """B6 bit for bit: warp-sized and block-sized (> 256) segments, ties,
    takes of 0, an expansion truncated at the cap."""
    g = torch.Generator(device=cuda_device).manual_seed(n_seg)
    deg = torch.randint(0, max_deg + 1, (n_seg,), generator=g,
                        device=cuda_device)
    deg[0] = max_deg
    cap = max(1, int(int(deg.sum()) * trunc))
    for tie in (0, 3):
        keys, slot, mask, seg_start, take, live = _segments(
            g, deg, cap, cuda_device, tie)
        want = fr.segment_select(keys, slot, mask, seg_start, take)
        for n in (None, live):
            got = fk.segment_select(keys, slot, mask, seg_start, take, n)
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 255, 4097])
@pytest.mark.parametrize("F", [1, 100, 128, 129, 256])
def test_gather_dst_kernel_matches_plain(cuda_device, E, F):
    """B5 bit for bit, with masked edges past the live count and -1 and
    out-of-range row indices reading nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(E * F)
    S = 37
    dst = torch.randint(-1, S + 2, (E,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    live = torch.tensor(E - E // 4, dtype=torch.int32, device=cuda_device)
    mask = torch.arange(E, device=cuda_device) < live
    rows = torch.randn(S, F, generator=g, device=cuda_device)
    want = sr.gather_dst_ref(dst, mask, rows)
    for n in (None, live):
        assert torch.equal(sk.gather_dst_rows(dst, mask, rows, n), want)


@pytest.mark.cuda
def test_transposed_spmm_on_a_sampled_block(served):
    """The SpMM kernel with roles swapped, fed a sampled block's
    src_perm, against the plain transposed version."""
    for blk in served["cuda"][2]:
        live = torch.clamp(blk.num_edges, max=blk.edge_cap)
        for F in (100, 256):
            gr = torch.randn(blk.seed_cap, F, device="cuda")
            args = (blk.src_slot, blk.dst_slot, blk.weight, blk.edge_mask,
                    blk.src_perm, gr, blk.next_cap)
            torch.testing.assert_close(sk.spmm_transposed(*args, n_live=live),
                                       sr.spmm_transposed_ref(*args),
                                       rtol=1e-5, atol=1e-5)


def _cdf_case(g, C, n, dev, plateaus=True):
    """A normalised CDF with zero-mass plateaus and u that hit its
    values exactly, 0 and values just below 1."""
    p = torch.rand(C, generator=g, device=dev) ** 4
    if plateaus:
        p = torch.where(torch.rand(C, generator=g, device=dev) < 0.3, 0.0, p)
    valid = torch.rand(C, generator=g, device=dev) < 0.9
    cdf = fr.normalized_cdf(p, valid)
    u = torch.rand(n, generator=g, device=dev)
    hits = cdf[torch.randint(0, C, (n // 4,), generator=g, device=dev)]
    u = torch.cat([u, hits, torch.tensor([0.0, 1.0 - 6e-8, 1.0 - 1e-7],
                                         device=dev)])
    return p, valid, cdf, u


@pytest.mark.cuda
@pytest.mark.parametrize("C,n", [(1, 5), (2, 64), (1000, 10_240),
                                 (1 << 20, 10_240), (9_426_304, 10_240)])
def test_cdf_search_kernel_matches_plain(cuda_device, C, n):
    """B7 bit for bit against the plain lockstep search and against
    torch.searchsorted (clamped), at LADIES's layer-2 size too."""
    g = torch.Generator(device=cuda_device).manual_seed(C)
    p, valid, cdf, u = _cdf_case(g, C, n, cuda_device)
    want = fr.cdf_search(cdf, u)
    got = fk.cdf_search(cdf, u)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    lib = torch.clamp(torch.searchsorted(cdf, u), 0, C - 1).to(torch.int32)
    assert torch.equal(lib, want)
    assert torch.equal(fk.masked_cdf_draw(p, valid, u),
                       fr.masked_cdf_draw(p, valid, u))


def _search_probes(C):
    """Positions of the G-ary search's first two rounds of probes (the
    entries the kernel stages in shared memory)."""
    G = fr.SEARCH_G
    out = []
    step0 = -(-C // G)
    for k in range(G):
        if (k + 1) * step0 - 1 < C:
            out.append((k + 1) * step0 - 1)
        lo, hi = k * step0, min((k + 1) * step0 - 1, C)
        if lo < hi:
            step1 = -(-(hi - lo) // G)
            out += list(range(lo + step1 - 1, hi, step1))
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 7, 8, 9, 31, 32, 33, 63, 64, 65, 511,
                               512, 513, 1023, 1024, 1025, 4095, 4096, 4097,
                               32_769, 262_145, 9_426_304])
def test_cdf_search_gary_adversarial(cuda_device, C):
    """B7's G-ary search bit for bit against the plain lockstep and
    clamp(searchsorted): C near powers of 8 and 32, u at every staged probe,
    a plateau across the first round's probes, NaN and 1.0 in u; then an
    all-zero CDF of the same length."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(C)
    cdf = torch.sort(torch.rand(C, generator=g, device=dev)).values
    cdf[-1] = 1.0
    probes = _search_probes(C).to(dev)
    if C > 64:   # one value from before round 0's first probe to past
        # its third, over round 1's probes between them
        step0 = -(-C // fr.SEARCH_G)
        a, b = step0 // 2, 3 * step0 + 3
        cdf[a:b] = cdf[a]
        plateau = [cdf[a], cdf[a].nextafter(torch.zeros((), device=dev))]
    else:
        plateau = []
    u = torch.cat([cdf[probes], torch.rand(4096, generator=g, device=dev),
                   torch.tensor([0.0, 1.0, float("nan"), 2.0, -1.0],
                                device=dev)] + [x.reshape(1)
                                                for x in plateau])
    for c in (cdf, torch.zeros_like(cdf)):
        want = fr.cdf_search(c, u)
        assert torch.equal(fk.cdf_search(c, u), want)
        lib = torch.clamp(torch.searchsorted(c, u), 0, C - 1).to(torch.int32)
        assert torch.equal(lib, want)


@pytest.mark.cuda
def test_cdf_search_kernel_adversarial(cuda_device):
    """The regression weights of the reference's suite, an all-invalid
    p, u = 0 over an invalid entry 0, no draws, one entry."""
    dev = cuda_device
    ones = torch.ones
    cases = [
        (torch.cat([torch.full((4096,), 1e-7), torch.full((8,), 3e8),
                    torch.full((4096,), 1e-7)]), ones(8200, dtype=torch.bool),
         torch.tensor([0.0, 0.5, 1.0 - 1e-7, 1.0 - 6e-8])),
        (ones(9), torch.zeros(9, dtype=torch.bool),
         torch.tensor([0.0, 0.3, 0.999])),
        (torch.tensor([5.0, 1.0, 0.0, 2.0]),
         torch.tensor([False, True, True, True]), torch.tensor([0.0, 0.4])),
        (ones(5), ones(5, dtype=torch.bool), torch.zeros(0)),
        (torch.tensor([0.5]), ones(1, dtype=torch.bool),
         torch.tensor([0.0, 0.7])),
    ]
    for p, valid, u in cases:
        p, valid, u = p.to(dev), valid.to(dev), u.to(dev)
        got = fk.masked_cdf_draw(p, valid, u)
        assert torch.equal(got, fr.masked_cdf_draw(p, valid, u))
    assert got.tolist() == [0, 0]
    with pytest.raises(ValueError):
        fk.cdf_search(torch.zeros(0, device=dev), torch.zeros(3, device=dev))
    with pytest.raises(TypeError):
        fk.cdf_search(torch.zeros(4, device=dev, dtype=torch.float64),
                      torch.zeros(3, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["labor-*", "ladies", "pladies"])
def test_float_decisions_are_deterministic_on_the_card(cuda_device, sampler):
    """The float sums that decide LABOR-*, LADIES and PLADIES (c_s,
    E[|T|], column norms, the CDF, the water-fill) and the Hajek
    denominators run in a fixed order: two runs of the plain versions
    and one of the kernels sample the same blocks, weights bit for
    bit."""
    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset(sampler, ds, batch_size=64, fanouts=(5, 5, 5))
    graph = ds.graph.to(cuda_device)
    seeds = pad_seeds(ds.train_idx[:64], 64, device="cuda")
    runs = [smp.sample_with_key(graph, seeds, TR.key(9), backend=b)
            for b in ("eager", "eager", "cuda")]
    for blocks in runs[1:]:
        for a, b in zip(runs[0], blocks):
            for f in INT_FIELDS + ("weight",):
                assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["labor-0", "ns", "labor-1", "labor-*",
                                     "labor-d", "ladies", "pladies"])
def test_train_step_cuda_matches_eager(cuda_device, sampler):
    """One train step with the kernels against the plain versions on the
    card: the same sampled counts, loss and parameters to 1e-4."""
    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset(sampler, ds, batch_size=64, fanouts=(5, 5, 5))
    seeds = pad_seeds(ds.train_idx[:64], 64, device="cuda")
    out = {}
    fk.reset_launches()
    sk.reset_launches()
    for backend in ("cuda", "eager"):
        eng = TrainEngine(smp, adam.AdamConfig(), device="cuda",
                          backend=backend)
        data = eng.make_data_from_dataset(ds)
        model = gcn_init(TR.key(0), 100, 32, 47, 3, device="cuda")
        model, _, m = eng.step(model, eng.init_state(model), data, seeds,
                               TR.key(4))
        out[backend] = (model, m)
    assert sk.LAUNCHES["spmm_t"] == 2      # not for the first GCN layer
    assert (fk.LAUNCHES["segment_select"] > 0) == (sampler == "ns")
    assert (fk.LAUNCHES["masked_cdf_draw"] > 0) == (sampler == "ladies")
    (mk, m_k), (me, m_e) = out["cuda"], out["eager"]
    for f in ("sampled_v", "sampled_e", "overflow"):
        assert torch.equal(m_k[f], m_e[f]), f
    torch.testing.assert_close(m_k["loss"], m_e["loss"], rtol=1e-4,
                               atol=1e-5)
    for (n, a), (_, b) in zip(mk.named_parameters(), me.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=n)


def _edge_layout(g, E, S, live_n, dev, masked_in_prefix=0.0, outside=0):
    """A dst-sorted prefix of ``live_n`` edges over ``S`` rows (some rows
    empty, some with one edge), masked and -1 past it; optionally some
    masked edges inside the prefix, and with ``outside`` the keys drawn
    from [-1, S + outside): masked-in edges of no row at both ends of the
    prefix."""
    lo = -1 if outside else 0
    dst = torch.sort(torch.randint(lo, S + outside, (E,), generator=g,
                                   device=dev, dtype=torch.int32)).values
    live = torch.arange(E, device=dev) < live_n
    dst = torch.where(live, dst, -1)
    mask = live & (torch.rand(E, generator=g, device=dev)
                   >= masked_in_prefix)
    return dst, mask, torch.tensor(live_n, dtype=torch.int32, device=dev)


def _check_softmax(got, want, dst, mask, S):
    """B8 against its plain version to 1e-6; 0 on every masked edge and
    every edge of no row; each row with a masked-in edge sums to 1
    (summed in float64: a float sum of a 50,000-edge row drops ~5e-5 of
    it)."""
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.all(got[~mask] == 0)
    valid = mask & (dst >= 0) & (dst < S)
    assert torch.all(got[~valid] == 0)
    sums = torch.zeros(S, got.shape[1], dtype=torch.float64,
                       device=got.device).index_add_(
        0, dst[valid].long(), got[valid].double())
    rows = torch.unique(dst[valid].long())
    torch.testing.assert_close(sums[rows], torch.ones_like(sums[rows]),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,H,live_frac,masked,variant", [
    (1, 1, 1, 1.0, 0.0, ""), (5000, 300, 1, 0.9, 0.0, ""),
    (5000, 4000, 8, 0.5, 0.3, ""), (50_000, 3000, 8, 0.2, 0.0, ""),
    (4097, 100, 128, 1.0, 0.1, ""), (2000, 50, 3, 0.0, 0.0, ""),
    # rows of ~450 edges, past the long-row threshold (128): by the block
    (20_000, 40, 8, 0.9, 0.1, ""),
    # one row holds every live edge (50,000)
    (60_000, 1, 8, 5 / 6, 0.0, ""),
    (5000, 700, 2, 0.8, 0.1, ""), (3000, 200, 32, 0.7, 0.1, ""),
    # n H = 8,997 (not a multiple of 4) and E H = 14,997 (odd); 33 heads,
    # E H = 99,033
    (4999, 500, 3, 0.6, 0.1, ""), (3001, 100, 33, 0.7, 0.1, ""),
    (5000, 300, 8, 1.0, 0.2, "no n_live"),
    (5000, 300, 8, 0.9, 0.1, "dst outside [0, S)")])
def test_edge_softmax_kernel_matches_plain(cuda_device, E, S, H, live_frac,
                                           masked, variant):
    """B8 against its plain version to 1e-6: rows with one edge and with
    none, long rows and one row of every edge, 1 to 128 heads, masked
    edges inside the prefix, no live edge at all, an unaligned fill,
    ``n_live=None`` (every edge live), dst slots outside [0, S) inside
    the prefix, and a row spread of 200 in logits (a shared shift would
    underflow the low rows to 0)."""
    g = torch.Generator(device=cuda_device).manual_seed(E + H)
    dst, mask, live = _edge_layout(
        g, E, S, round(E * live_frac), cuda_device, masked,
        outside=20 if variant == "dst outside [0, S)" else 0)
    if variant == "no n_live":
        live = None
    logits = torch.randn(E, H, generator=g, device=cuda_device) * 3
    logits[::7] += 200.0
    want = er.edge_softmax_ref(dst, mask, logits, S)
    got = ek.edge_softmax_rows(dst, mask, logits, S, live)
    _check_softmax(got, want, dst, mask, S)
    with pytest.raises(ValueError, match="128 heads"):
        ek.edge_softmax_rows(dst, mask, torch.zeros(E, 129,
                                                    device=cuda_device), S)


def _softmax_layer2(dev):
    """Phase 2's deepest GATv2 call in shape: 86,803 rows of Poisson(10)
    edges (and a few of 300) in a seed cap of 470,656, edge cap
    9,426,304, 8 heads."""
    g = torch.Generator(device=dev).manual_seed(20)
    lens = torch.poisson(torch.full((86_803,), 10.0, device=dev),
                         generator=g).long()
    lens[::5000] = 300
    n = int(lens.sum())
    E, S = 9_426_304, 470_656
    dst = torch.full((E,), -1, dtype=torch.int32, device=dev)
    dst[:n] = torch.repeat_interleave(
        torch.arange(86_803, device=dev, dtype=torch.int32), lens)
    mask = torch.arange(E, device=dev) < n
    logits = torch.randn(E, 8, generator=g, device=dev) * 3
    return dst, mask, logits, S, torch.tensor(n, dtype=torch.int32,
                                              device=dev)


@pytest.mark.cuda
def test_edge_softmax_calls_are_bit_identical(cuda_device):
    """No atomics: two calls on the same inputs give the same bits."""
    dst, mask, logits, S, live = _softmax_layer2(cuda_device)
    a = ek.edge_softmax_rows(dst, mask, logits, S, live)
    b = ek.edge_softmax_rows(dst, mask, logits, S, live)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    _check_softmax(a, er.edge_softmax_ref(dst, mask, logits, S), dst, mask,
                   S)


@pytest.mark.cuda
def test_edge_softmax_is_at_most_two_device_operations(cuda_device):
    """torch.profiler sees the kernel and nothing else (no memset): at
    most 2 device operations a call at the deepest layer's shape. The
    profiler on the card now and then drops kernel events (three tries
    in a row once saw 3 of 5 calls), which can only lower the count, so
    the count is bounded above and the kernel must have been seen."""
    args = _softmax_layer2(cuda_device)
    ops = _device_ops_of(lambda: ek.edge_softmax_rows(*args), 5, 1)
    assert 0 < sum(c for _, c in ops) <= 2 * 5, ops
    assert all("edge_softmax" in k for k, _ in ops), ops


@pytest.mark.cuda
def test_edge_softmax_on_a_sampled_block(served):
    """The kernel fed blocks straight from the sampler, whose seed rows
    past the last live key hold no edge, against its plain version."""
    gaps = 0
    for i, blk in enumerate(served["cuda"][2]):
        live = torch.clamp(blk.num_edges, max=blk.edge_cap)
        n = int(live)
        gaps += int(blk.dst_slot[n - 1]) + 1 < blk.seed_cap if n else 1
        g = torch.Generator(device="cuda").manual_seed(i)
        logits = torch.randn(blk.edge_cap, 8, generator=g, device="cuda")
        got = ek.edge_softmax_rows(blk.dst_slot, blk.edge_mask, logits,
                                   blk.seed_cap, live)
        want = er.edge_softmax_ref(blk.dst_slot, blk.edge_mask, logits,
                                   blk.seed_cap)
        _check_softmax(got, want, blk.dst_slot, blk.edge_mask, blk.seed_cap)
    assert gaps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 8, 47, 256])
def test_scatter_rows_kernel_matches_plain(cuda_device, F):
    """The per-edge scatter, dst-sorted and through a src_perm, against
    its plain version and index_add_, to 1e-5."""
    g = torch.Generator(device=cuda_device).manual_seed(F)
    E, S, T = 20_000, 700, 3000
    dst, mask, live = _edge_layout(g, E, S, 15_000, cuda_device)
    src = torch.randint(-1, T, (E,), generator=g, device=cuda_device,
                        dtype=torch.int32)
    perm = fr.compact_perm(src, mask, T)
    vals = torch.randn(E, F, generator=g, device=cuda_device)
    for index, p, rows in ((dst, None, S), (src, perm, T)):
        want = sr.scatter_rows_ref(index, mask, vals, rows, p)
        got = sk.scatter_rows(index, mask, vals, rows, perm=p, n_live=live)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        keep = mask & (index >= 0)
        lib = torch.zeros(rows, F, device=cuda_device).index_add_(
            0, index[keep].long(), vals[keep])
        torch.testing.assert_close(got, lib, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sage", "gatv2"])
def test_model_step_is_repeatable_and_matches_eager(cuda_device, model):
    """A SAGE or GATv2 train step on the kernels, three times from the same
    parameters: gradients bit for bit (no atomics on the path), and to
    1e-4 of the plain versions on the card."""
    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset("labor-0", ds, batch_size=64, fanouts=(5, 5, 5))
    seeds = pad_seeds(ds.train_idx[:64], 64, device="cuda")
    init = MODELS[model][0]
    grads = {}
    for backend in ("cuda", "cuda", "cuda", "eager"):
        eng = TrainEngine(smp, adam.AdamConfig(), device="cuda",
                          backend=backend)
        data = eng.make_data_from_dataset(ds)
        net = init(TR.key(0), 100, 32, 47, 3, device="cuda")
        blocks, feats = eng.sample_batch(data, seeds, TR.key(4))
        loss, _ = gnn_loss_fn(net, blocks, feats,
                              seed_labels(data.labels, seeds), backend)
        grads.setdefault(backend, []).append(
            torch.autograd.grad(loss, list(net.parameters())))
    first = grads["cuda"][0]
    for other in grads["cuda"][1:]:
        for a, b in zip(first, other):
            assert torch.equal(a, b)
    for a, b in zip(first, grads["eager"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# -- B9: the flash-attention kernel ------------------------------------------

#: (B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, scale, dtype)
FLASH_CASES = [
    (2, 1, 1, 4, 4, 64, True, None, None, None, torch.float32),
    (1, 130, 130, 8, 1, 128, True, None, 50.0, None, torch.float32),
    (1, 1000, 1000, 4, 2, 256, True, 1, None, None, torch.float32),
    (2, 1000, 1000, 2, 2, 80, True, 1000, None, None, torch.float32),
    (1, 130, 130, 8, 4, 16, True, 7, 30.0, 0.3, torch.float32),
    (1, 300, 300, 4, 2, 32, True, None, None, None, torch.bfloat16),
    (1, 257, 257, 8, 4, 256, True, 64, 50.0, 256 ** -0.5, torch.bfloat16),
    (1, 130, 333, 4, 4, 64, False, None, None, None, torch.float32),
    (1, 1, 1000, 2, 1, 64, True, None, None, None, torch.float32),
    (2, 200, 50, 2, 1, 64, False, 20, None, None, torch.float32),
]


def _flash_inputs(case, dev, layout="contiguous"):
    B, Sq, Sk, Hq, Hkv, hd, *_, dtype = case
    g = torch.Generator(device=dev).manual_seed(Sq * 7 + hd)
    if layout == "strided":   # q as a slice of a fused (B, S, 2, Hq, hd)
        q = torch.randn(B, Sq, 2, Hq, hd, generator=g, device=dev)[:, :, 1]
    else:
        q = torch.randn(B, Sq, Hq, hd, generator=g, device=dev)
    if layout == "misaligned":  # one element off: staged element-wise
        flat = torch.empty(q.numel() + 1, dtype=dtype, device=dev)
        q = flat[1:].view(q.shape).copy_(q)
    k = torch.randn(B, Sk, Hkv, hd, generator=g, device=dev)
    v = torch.randn(B, Sk, Hkv, hd, generator=g, device=dev) * 3
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, case):
    """Every head dimension, GQA ratios 1-8, window 1 and window >= S, the
    softcap, a custom scale, bf16, one query, a non-causal ragged Sk and
    queries that see no key (the mean of v), q through its strides and
    one element off its alignment: fp32
    within 2e-5 x max(1, max|v|), bf16 within 3e-2; one launch each."""
    *_, causal, window, softcap, scale, dtype = case
    for layout in ("contiguous", "strided", "misaligned"):
        q, k, v = _flash_inputs(case, cuda_device, layout)
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        want = fr_attn.attention_ref(q, k, v, **kw)
        fa.reset_launches()
        got = fa.flash_attention(q, k, v, causal, window, softcap, scale)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == 1
        assert got.dtype == dtype and got.shape == q.shape
        atol = (3e-2 if dtype == torch.bfloat16
                else 2e-5 * max(1.0, v.abs().max().item()))
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)


@pytest.mark.cuda
def test_flash_gradient_matches_plain(cuda_device):
    """The autograd Function's backward is the plain version's."""
    case = (2, 150, 150, 4, 2, 64, True, 40, 30.0, None, torch.float32)
    q, k, v = _flash_inputs(case, cuda_device)
    g = torch.randn_like(q)
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, True, 40, 30.0),
               lambda a, b, c: fr_attn.attention_ref(a, b, c, window=40,
                                                     softcap=30.0)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_prefill_runs_the_kernel_per_layer(cuda_device, monkeypatch):
    """A reduced gemma2 prefill on the ``cuda`` backend launches the
    kernel once per layer and never the plain version on a CUDA tensor;
    its logits and caches match the ``eager`` backend's on the card."""
    from repro_torch import configs
    from repro_torch.configs.reduce import reduce_cfg
    from repro_torch.models.transformer import stack
    cfg = dataclasses.replace(reduce_cfg(configs.get_config("gemma2-2b")),
                              num_layers=4)
    params = stack.init_params(TR.key(0), cfg, device="cuda")
    tokens = TR.randint(TR.key(0), (2, 200), 0, cfg.vocab, device="cuda")
    want_logits, want_cache = stack.prefill(params, tokens, cfg,
                                            backend="eager")
    plain = fr_attn.attention_ref

    def no_plain_on_the_card(q, *a, **kw):
        assert q.device.type != "cuda", "plain attention ran on the card"
        return plain(q, *a, **kw)

    monkeypatch.setattr(fr_attn, "attention_ref", no_plain_on_the_card)
    fa.reset_launches()
    logits, cache = stack.prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-5)
    for got, want in zip(cache, want_cache):
        for n in ("k", "v"):
            torch.testing.assert_close(got[n], want[n], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk,causal", [(1, 1, True), (33, 33, True),
                                          (130, 130, True),
                                          (1000, 1000, True),
                                          (33, 1000, False),
                                          (1000, 33, False)])
def test_flash_kernel_every_head_dim(cuda_device, hd, Sq, Sk, causal):
    """The tensor-core kernel at every built head dimension and at
    lengths off the 64-query and 32/64-key tiles: GQA 8 with window 1,
    a softcap with a custom scale, a misaligned q (staged element-wise)
    and bf16; fp32 within 2e-5 x max(1, max|v|), bf16 within 3e-2."""
    variants = [
        (8, 1, 1, None, None, torch.float32, "contiguous"),
        (2, 2, None, 30.0, 0.3, torch.float32, "contiguous"),
        (4, 2, max(1, Sq // 2), None, None, torch.float32, "misaligned"),
        (8, 1, None, 50.0, None, torch.bfloat16, "contiguous"),
    ]
    for Hq, Hkv, window, softcap, scale, dtype, layout in variants:
        case = (1, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, scale,
                dtype)
        q, k, v = _flash_inputs(case, cuda_device, layout)
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        want = fr_attn.attention_ref(q, k, v, **kw)
        got = fa.flash_attention(q, k, v, causal, window, softcap, scale)
        torch.cuda.synchronize()
        atol = (3e-2 if dtype == torch.bfloat16
                else 2e-5 * max(1.0, v.abs().max().item()))
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol, msg=str(case))


def _flash_against_plain(case, dev, layout="contiguous"):
    """One call of the kernel against the plain version on the card: fp32
    within 2e-5 x max(1, max|v|), bf16 within 3e-2."""
    *_, causal, window, softcap, scale, dtype = case
    q, k, v = _flash_inputs(case, dev, layout)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    want = fr_attn.attention_ref(q, k, v, **kw)
    got = fa.flash_attention(q, k, v, causal, window, softcap, scale)
    torch.cuda.synchronize()
    atol = (3e-2 if dtype == torch.bfloat16
            else 2e-5 * max(1.0, v.abs().max().item()))
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=atol, msg=str(case))


@pytest.mark.cuda
def test_flash_kernel_plan_is_the_wrappers(cuda_device):
    """The plan compiled into the kernel equals ``ops.plan``'s mirror for
    every (hd, dtype)."""
    for (dtype, hd) in fa.PLANS:
        p = fa.plan(hd, dtype)
        assert fa.kernel_plan(hd, dtype) == dict(
            C=p["C"], BK=p["BK"], DC=p["DC"], NS=p["NS"],
            swizzle=p["swizzle"]["q"], smem=p["smem"]), (dtype, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "misaligned"])
def test_flash_prologue_matches_plain(cuda_device, layout, dtype):
    """The prologue's scratch (K's 3xTF32 parts, V^T permuted and padded)
    equals ``ref.prologue_ref`` bit for bit, for q, k and v read through
    their strides and one element off their alignment too."""
    case = (2, 70, 37, 4, 2, 80, True, None, None, None, dtype)
    q, k, v = _flash_inputs(case, cuda_device, layout)
    if layout == "misaligned":   # k and v one element off too
        k, v = (torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)
                [1:].view(t.shape).copy_(t) for t in (k, v))
    elif layout == "strided":    # k and v as slices of a fused kv tensor
        kv = torch.stack([k, v], 2)
        k, v = kv[:, :, 0], kv[:, :, 1]
    _, buf = fa._launch(q, k, v, True, None, None, None)
    torch.cuda.synchronize()
    scratch = fa.scratch_views(buf, 2, k.shape[1], 2, 80)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for got, want in zip(scratch, fr_attn.prologue_ref(k, v)):
        assert torch.equal(got.view(bits), want.contiguous().view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_kernel_at_the_ring_edges(cuda_device, hd, dtype):
    """Sk one short of, equal to and one past one key tile (BK) and NS
    key tiles (the ring's depth in slabs), causal and not, GQA 2; and
    windows that end inside a key tile."""
    p = fa.plan(hd, dtype)
    for m in (1, p["NS"]):
        for Sk in (m * p["BK"] - 1, m * p["BK"], m * p["BK"] + 1):
            _flash_against_plain((1, Sk, Sk, 4, 2, hd, True, None, None,
                                  None, dtype), cuda_device)
            _flash_against_plain((2, 100, Sk, 4, 2, hd, False, None, 30.0,
                                  None, dtype), cuda_device)
    for window in (37, p["BK"] + 5, 2 * p["BK"] - 1):
        _flash_against_plain((1, 300, 300, 4, 4, hd, True, window, None,
                              None, dtype), cuda_device, "misaligned")


@pytest.mark.cuda
def test_flash_kernel_hd256_fp32_long(cuda_device):
    """hd 256 in fp32 (one consumer warpgroup, K and V in 64-dim slabs)
    at Sq 4,096: GQA 8/4 with gemma2's softcap, global and local."""
    for window in (None, 1024):
        _flash_against_plain((1, 4096, 4096, 8, 4, 256, True, window, 50.0,
                              256 ** -0.5, torch.float32), cuda_device)


# -- C2: the seeded draws on the card equal the CPU draw ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["uniform", "normal", "randint"])
def test_rng_draws_on_the_card_equal_the_cpu(cuda_device, draw):
    """More than one pass of ``_CHUNK`` counters, bit for bit: the draws
    that make the LM weights and prompts on the card are the CPU's (and
    so ``jax.random``'s)."""
    n = TR._CHUNK + 4099
    key = TR.key(3)
    fn = {"uniform": lambda d: TR.uniform(key, (n,), -0.5, 2.0, device=d),
          "normal": lambda d: TR.normal(key, (n,), device=d),
          "randint": lambda d: TR.randint(key, (n,), 0, 256_000,
                                          device=d)}[draw]
    got, want = fn(cuda_device).cpu(), fn("cpu")
    assert got.dtype == want.dtype
    bad = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
    assert bad.numel() == 0, (f"{draw}: {bad.numel()} of {n} differ, first "
                              f"at {bad[:5].flatten().tolist()}")


@pytest.mark.cuda
def test_init_params_on_the_card_equal_the_cpu(cuda_device):
    """Every leaf of the reduced gemma2-2b's initial parameters, drawn on
    the card, equals the CPU draw bit for bit."""
    from repro_torch import configs
    from repro_torch.configs.reduce import reduce_cfg
    from repro_torch.models.transformer import stack
    cfg = reduce_cfg(configs.get_config("gemma2-2b"))

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    got = dict(leaves(stack.init_params(TR.key(0), cfg, device="cuda")))
    want = dict(leaves(stack.init_params(TR.key(0), cfg, device="cpu")))
    assert got.keys() == want.keys() and len(got) > 10
    for name, t in got.items():
        assert torch.equal(t.cpu(), want[name]), name


# -- the SpMM's offsets pass against the binary-search kernel it replaced ----

#: the earlier row kernel of csrc/spmm.cu (two binary searches per warp and
#: 128-column slice), kept here as the yardstick of the offsets pass
_SEARCH_KERNEL = r'''
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kThreads = 256, kSlice = 128, kPerLane = kSlice / 32;
constexpr long kGridCap = 132 * 64;
__device__ __forceinline__ int edge_at(const int* perm, int i) {
  return perm != nullptr ? perm[i] : i;
}
__device__ __forceinline__ int lower_bound(const int* a, const int* perm,
                                           int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[edge_at(perm, mid)] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}
template <bool kEdgeValues>
__global__ void spmm_rows_kernel(const int* dst, const int* src,
                                 const float* w, const uint8_t* mask,
                                 const int* perm, int E, const int* n_live,
                                 const float* h, int T, int F, int S,
                                 float* out) {
  int n = E;
  if (n_live != nullptr) { n = *n_live; n = n < 0 ? 0 : (n < E ? n : E); }
  const int slices = (F + kSlice - 1) / kSlice;
  const long items = (long)S * slices;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (long it = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       it < items; it += nwarps) {
    const int row = (int)(it / slices);
    const int c0 = (int)(it % slices) * kSlice + lane;
    const int lo = lower_bound(dst, perm, 0, n, row);
    const int hi = lower_bound(dst, perm, lo, n, row + 1);
    float acc[kPerLane];
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int i = lo; i < hi; ++i) {
      const int e = edge_at(perm, i);
      if (!mask[e]) continue;
      if (kEdgeValues) {
        const float* vr = h + (long)e * F;
        for (int k = 0; k < kPerLane; ++k) {
          const int c = c0 + 32 * k;
          if (c < F) acc[k] = __fadd_rn(acc[k], vr[c]);
        }
        continue;
      }
      int s = src[e];
      if (s < 0) s += T;
      const float we = w[e];
      const float* hr = h + (long)s * F;
      for (int k = 0; k < kPerLane; ++k) {
        const int c = c0 + 32 * k;
        if (c < F) acc[k] = __fadd_rn(acc[k], __fmul_rn(hr[c], we));
      }
    }
    float* o = out + (long)row * F;
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + 32 * k;
      if (c < F) o[c] = acc[k];
    }
  }
}
int blocks(int S, int F) {
  const long items = (long)S * ((F + kSlice - 1) / kSlice);
  long b = (items * 32 + kThreads - 1) / kThreads;
  return (int)(b > kGridCap ? kGridCap : (b < 1 ? 1 : b));
}
}  // namespace
extern "C" int search_spmm_rows(const int* dst, const int* src,
                                const float* w, const uint8_t* mask,
                                const int* perm, int E, const int* n_live,
                                const float* h, int T, int F, int S,
                                float* out) {
  spmm_rows_kernel<false><<<blocks(S, F), kThreads>>>(
      dst, src, w, mask, perm, E, n_live, h, T, F, S, out);
  return (int)cudaDeviceSynchronize();
}
extern "C" int search_scatter_rows(const int* dst, const uint8_t* mask,
                                   const int* perm, int E, const int* n_live,
                                   const float* values, int F, int S,
                                   float* out) {
  spmm_rows_kernel<true><<<blocks(S, F), kThreads>>>(
      dst, nullptr, nullptr, mask, perm, E, n_live, values, E, F, S, out);
  return (int)cudaDeviceSynchronize();
}
'''


@pytest.fixture(scope="module")
def search_kernel(tmp_path_factory):
    """The binary-search kernel above, built with nvcc into a scratch
    directory and loaded with ctypes, as the package builds its own
    (a plain C interface compiles in seconds)."""
    import ctypes
    import subprocess

    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = tmp_path_factory.mktemp("search_kernel")
    src, lib = d / "search.cu", d / "search.so"
    src.write_text(_SEARCH_KERNEL)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.search_spmm_rows.argtypes = [P] * 5 + [I, P, P, I, I, I, P]
    so.search_scatter_rows.argtypes = [P, P, P, I, P, P, I, I, P]
    return so


def _keyed_edges(g, E, rows, live_n, dev, case):
    """Keys over ``rows`` rows for the edge cases of the offsets pass
    (sorted over the live prefix when read through the returned perm, or
    directly when perm is None), with empty rows before the first key,
    between keys and after the last; -1 keys at the front
    (``neg``); keys at and past ``rows`` at the back (``past``); two rows
    of 1,200 and 200 edges, past the 128 one warp sums and across two
    1,024-edge chunks of the kernel that takes them (``hubs``); a gap of
    ~800 rows between two clusters, wider than one thread writes
    (``wide gap``)."""
    lo, hi = (5, rows - 5) if rows > 10 else (0, rows)
    key = torch.randint(lo, max(hi, lo + 1), (E,), generator=g, device=dev,
                        dtype=torch.int32)
    key = key - key % 3      # two rows of three empty between keys
    if case == "neg":
        key[:E // 5] = -1
    if case == "past":
        key[-(E // 5):] = rows + torch.arange(E // 5, device=dev,
                                              dtype=torch.int32) % 3
    if case == "hubs":   # rows too long for one warp: 1,200 and 200 edges
        key[:1200] = 7
        key[1200:1400] = 11
    if case == "wide gap":   # ~800 empty rows between two clusters of keys
        key = torch.where(key < rows // 2, key % 50, rows - 50 + key % 45)
    live = torch.arange(E, device=dev) < live_n
    mask = live & (torch.rand(E, generator=g, device=dev) > 0.1)
    return key, mask, live


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 8, 47, 256, 300])
@pytest.mark.parametrize("case", ["gaps", "neg", "past", "hubs",
                                  "wide gap", "no live edge"])
@pytest.mark.parametrize("with_perm", [False, True])
def test_spmm_forms_equal_the_search_kernel(cuda_device, search_kernel, F,
                                            case, with_perm):
    """The offsets pass against a sorted search, then all four SpMM forms
    (forward, transposed through a perm, scatter dst-sorted and through a
    perm) bit for bit against the binary-search kernel they replace, and
    two calls bit-equal."""
    from repro_torch.kernels import _build
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(F * 31 + len(case))
    E, rows, T = 6000, 900, 700
    live_n = 0 if case == "no live edge" else 4500
    key, mask, live = _keyed_edges(g, E, rows, live_n, dev, case)
    n_live = torch.tensor(live_n, dtype=torch.int32, device=dev)
    if with_perm:   # the edges in any order; perm sorts the live prefix
        order = torch.randperm(E, generator=g, device=dev)
        key, mask, live = key[order], mask[order], live[order]
        perm = torch.argsort(torch.where(live, key, 2**30),
                             stable=True).to(torch.int32)
    else:
        key = torch.where(live, key, -1)
        key[:live_n] = torch.sort(key[:live_n]).values
        perm = None
    sweep = key[perm.long()] if with_perm else key
    want_start = torch.searchsorted(sweep[:live_n].contiguous(),
                                    torch.arange(rows + 1, device=dev,
                                                 dtype=torch.int32))
    got_start = torch.full((rows + 1,), -7, dtype=torch.int32, device=dev)
    _build.check(_build.function("spmm_row_offsets")(
        key.data_ptr(), _build.ptr(perm), E, n_live.data_ptr(), rows,
        got_start.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "spmm_row_offsets")
    assert torch.equal(got_start, want_start.to(torch.int32))

    src = torch.randint(-T, T, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand(E, generator=g, device=dev) - 0.3
    h = torch.randn(T, F, generator=g, device=dev)
    vals = torch.randn(E, F, generator=g, device=dev)
    P = _build.ptr

    def old_spmm():
        out = torch.empty(rows, F, device=dev)
        assert search_kernel.search_spmm_rows(
            P(key), P(src), P(w), P(mask), P(perm), E, P(n_live),
            P(h), T, F, rows, P(out)) == 0
        return out

    def old_scatter():
        out = torch.empty(rows, F, device=dev)
        assert search_kernel.search_scatter_rows(
            P(key), P(mask), P(perm), E, P(n_live), P(vals), F,
            rows, P(out)) == 0
        return out

    if with_perm:   # the transposed SpMM: its "dst" is the src_slot
        def new_spmm():
            return sk.spmm_transposed(key, src, w, mask, perm, h, rows,
                                      n_live=n_live)
    else:
        def new_spmm():
            return sk.spmm_block(src, key, w, mask, h, rows, n_live=n_live)

    def new_scatter():
        return sk.scatter_rows(key, mask, vals, rows, perm=perm,
                               n_live=n_live)

    for new, old in ((new_spmm, old_spmm), (new_scatter, old_scatter)):
        a, b = new(), new()
        torch.cuda.synchronize()
        ref = old()
        assert torch.equal(a, b)
        assert torch.equal(a.view(torch.int32), ref.view(torch.int32))


# -- the forward SpMM kernel at its paths' boundaries ------------------------

#: row lengths around the forward kernel's splits: one lane group's
#: 32-edge chunk, the 128-edge limit past which the block sums a row
FORWARD_ROWS = (0, 1, 32, 33, 128, 129, 0, 3, 10, 0, 0, 64, 31, 1, 2, 5)


def _forward_case(g, lens, S, T, dev, tail=100, masked=0.1):
    """A dst-sorted live prefix of rows 0 .. len(lens) - 1 with lens[r]
    edges each, then ``tail`` masked edges keyed -1; sources in [-1, T)
    (a -1 source wraps to the last row, as the plain version's index
    does), weights in [-0.3, 0.7), about ``masked`` of the live edges
    masked."""
    lens_t = torch.as_tensor(lens, device=dev)
    n = int(lens_t.sum())
    dst = torch.cat([torch.repeat_interleave(
        torch.arange(len(lens), device=dev, dtype=torch.int32), lens_t),
        torch.full((tail,), -1, dtype=torch.int32, device=dev)])
    E = n + tail
    mask = (torch.arange(E, device=dev) < n) & (
        torch.rand(E, generator=g, device=dev) >= masked)
    src = torch.randint(-1, T, (E,), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand(E, generator=g, device=dev) - 0.3
    return src, dst, w, mask, torch.tensor(n, dtype=torch.int32, device=dev)


def _forward_equal(src, dst, w, mask, h, S, live):
    """The kernel against the plain version run on the CPU, whose
    scatter_add sums each row in edge order: bit for bit."""
    got = sk.spmm_block(src, dst, w, mask, h, S, n_live=live)
    want = sr.spmm_block_ref(src.cpu(), dst.cpu(), w.cpu(), mask.cpu(),
                             h.cpu(), S)
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 47, 64, 65, 100, 128, 129, 256, 300])
def test_spmm_forward_rows_at_the_kernel_splits(cuda_device, F):
    """Rows of 0, 1, 32, 33, 128 and 129 edges at every width split
    (half a warp up to 64 columns, a float4 a lane up to 128, two up to
    256, more passes past it, scalar columns at odd widths), a -1
    source, masked edges, a seed cap 20x the live rows, and 0 live
    edges; and a misaligned h, which takes the scalar columns."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(F)
    lens = FORWARD_ROWS * 40
    S, T = 20 * len(lens), 3000
    src, dst, w, mask, live = _forward_case(g, lens, S, T, dev)
    src[:7] = -1
    h = torch.randn(T, F, generator=g, device=dev)
    _forward_equal(src, dst, w, mask, h, S, live)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    got = _forward_equal(src, dst, w, mask & False, h, S, zero)
    assert not got.any()
    hb = torch.randn(T * F + 1, generator=g, device=dev)[1:].view(T, F)
    _forward_equal(src, dst, w, mask, hb, S, live)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["neg", "past", "gap", "one row"])
def test_spmm_forward_keys_outside_the_rows(cuda_device, case):
    """-1 keys before the first row, keys at and past S after the last,
    a gap of 5,000 empty rows between two rows, and one row of 3,000
    edges (summed by the block) alone in the output."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(len(case))
    F, T = 100, 2000
    if case == "one row":
        lens, S = (0,) * 9 + (3000,), 50
    else:
        lens, S = FORWARD_ROWS * 10, 12_000
    src, dst, w, mask, live = _forward_case(g, lens, S, T, dev)
    n = int(live)
    if case == "neg":
        dst[:50] = -1
    if case == "past":
        dst[n - 300:n] = S + torch.arange(300, device=dev,
                                          dtype=torch.int32) // 7
        dst[n - 400:n - 300] = S - 1
    if case == "gap":
        dst[:n] = torch.where(dst[:n] >= 50, dst[:n] + 5000, dst[:n])
    h = torch.randn(T, F, generator=g, device=dev)
    _forward_equal(src, dst, w, mask, h, S, live)


@pytest.mark.cuda
def test_spmm_forward_at_the_layer2_shape(cuda_device):
    """Layer 2 of a products-0.25 LABOR-0 request: 866,504 live edges
    of ~10 per row over 86,803 live rows, a seed cap of 470,656 (79% of
    the rows past the last key), F = 100, an edge cap of 9,426,304."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(2)
    rows, S, E, T = 86_803, 470_656, 9_426_304, 1_083_008
    lens = torch.poisson(torch.full((rows,), 10.0), generator=torch.Generator(
        ).manual_seed(0)).to(torch.int64)
    src, dst, w, mask, live = _forward_case(
        g, lens.tolist(), S, T, dev, tail=E - int(lens.sum()), masked=0.0)
    h = torch.randn(T, 100, generator=g, device=dev)
    _forward_equal(src, dst, w, mask, h, S, live)


@pytest.mark.cuda
def test_spmm_forward_heavy_queue_overflow(cuda_device):
    """More rows of over 128 edges than a block's queue holds (64 a
    block over ~34 chunks of 256 edges each): the rest are summed by
    their groups, window by window; both equal the plain version."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(8)
    rows = 140_000
    src, dst, w, mask, live = _forward_case(g, (130,) * rows, rows, 5000,
                                            dev, masked=0.05)
    h = torch.randn(5000, 4, generator=g, device=dev)
    _forward_equal(src, dst, w, mask, h, rows, live)


@pytest.mark.cuda
def test_spmm_forward_is_one_device_operation(cuda_device):
    """torch.profiler sees one kernel per forward SpMM call (no memset,
    no offsets pass), and a warm call allocates only its output."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(4)
    src, dst, w, mask, live = _forward_case(g, FORWARD_ROWS * 500, 200_000,
                                            30_000, dev)
    h = torch.randn(30_000, 100, generator=g, device=dev)
    ops = _device_ops_of(lambda: sk.spmm_block(src, dst, w, mask, h,
                                               200_000, n_live=live), 5, 1)
    assert sum(c for _, c in ops) == 5, ops
    assert all("spmm_forward_kernel" in k for k, _ in ops), ops
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = sk.spmm_block(src, dst, w, mask, h, 200_000, n_live=live)
    grew = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    assert grew == 1, (grew, [t.name for t in threading.enumerate()])
    del out


# -- segment_select's long segments and its scratch --------------------------

def _select_equal(args, live=None):
    got = fk.segment_select(*args, live)
    assert torch.equal(got, fr.segment_select(*args))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [[256, 257, 5, 0, 300], [2048, 3, 2049],
                                 [12_000, 10, 600], [60_000, 257]])
@pytest.mark.parametrize("tie_every", [0, 3, 1])
def test_segment_select_long_segments(cuda_device, deg, tie_every):
    """Segments of 256 (the warp's), 257 and 2,048 edges (staged in
    shared memory), 12,000 and 60,000 (past the 10,240 keys a block
    stages: the same passes over memory), with ties every third key
    and all keys tied, takes of 0, of 10 and at or past the live count,
    truncated and not."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(sum(deg) + tie_every)
    total = sum(deg)
    for cap in (total, total - deg[-1] // 2):
        keys, slot, mask, seg_start, take, live = _segments(
            g, deg, cap, dev, tie_every)
        if tie_every == 1:
            keys = torch.where(mask, torch.full_like(keys, 0.5), keys)
        for t in (take, torch.full_like(take, 10),
                  torch.as_tensor(deg, dtype=torch.int32, device=dev),
                  torch.as_tensor(deg, dtype=torch.int32, device=dev) + 7,
                  torch.zeros_like(take)):
            args = (keys, slot, mask, seg_start, t)
            _select_equal(args, live)
            _select_equal(args)


@pytest.mark.cuda
def test_segment_select_at_the_layer2_shape(cuda_device):
    """Layer 2 of an NS batch at products 0.25: 470,656 segments of
    which the first ~97k hold ~44 edges on average, a Pareto tail up to
    ~2,000, in an expand cap of 9,426,304 slots."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(11)
    live_segs, S, E = 96_770, 470_656, 9_426_304
    deg = torch.clamp((torch.rand(live_segs, generator=torch.Generator(
        ).manual_seed(1)) ** -1.0 * 8).to(torch.int64), max=2016)
    deg = torch.cat([deg, torch.zeros(S - live_segs, dtype=torch.int64)])
    keys, slot, mask, seg_start, take, live = _segments(g, deg.tolist(), E,
                                                        dev)
    _select_equal((keys, slot, mask, seg_start, take), live)


@pytest.mark.cuda
def test_segment_select_empty_and_degenerate(cuda_device):
    """No segment at all (every flag 0), a segment that starts past the
    live prefix, one segment over everything, takes of 0, and a first
    segment that starts past 0 (the edges before it masked)."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(12)
    E = 5000
    keys = torch.rand(E, generator=g, device=dev)
    live = torch.tensor(3000, dtype=torch.int32, device=dev)
    pos = torch.arange(E, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    got = fk.segment_select(keys, none.new_zeros(E), pos < 3000, none, none,
                            live)
    assert not got.any()
    for starts, takes in (([0], [5]), ([0, 2999, 4000], [4, 1, 3]),
                          ([500, 4000], [2, 2]), ([0, 400, 1300], [0, 0, 9])):
        seg_start = torch.tensor(starts, dtype=torch.int32, device=dev)
        take = torch.tensor(takes, dtype=torch.int32, device=dev)
        mask = (pos < 3000) & (pos >= starts[0])
        slot = (torch.searchsorted(seg_start, pos.to(torch.int32),
                                   right=True) - 1).to(torch.int32)
        slot = torch.where(mask, slot, -1)
        _select_equal((keys, slot, mask, seg_start, take), live)


def _select_calls(g, dev, count):
    """``count`` segment_select calls of random sizes on the current
    stream; returns each call's inputs and output, checked later."""
    calls = []
    for _ in range(count):
        n_seg = int(torch.randint(1, 3000, (1,), generator=g, device=dev))
        deg = torch.randint(0, 40, (n_seg,), generator=g, device=dev)
        deg[torch.rand(n_seg, generator=g, device=dev) < 0.02] = 700
        cap = max(1, int(int(deg.sum()) * 0.9))
        keys, slot, mask, seg_start, take, live = _segments(g, deg, cap, dev,
                                                            3)
        args = (keys, slot, mask, seg_start, take)
        calls.append((fr.segment_select, args,
                      fk.segment_select(*args, live)))
    return calls


@pytest.mark.cuda
def test_segment_select_repeated_calls_reuse_the_scratch(cuda_device):
    """30 calls in a row of different sizes on one stream, checked after
    the last: the cached list and its epoch-tagged count."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    _check_calls(_select_calls(g, cuda_device, 30))


@pytest.mark.cuda
def test_segment_select_on_two_streams(cuda_device):
    """Calls interleaved on two streams, each with its own scratch."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    calls = []
    for i in range(10):
        st = streams[i % 2]
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            calls += _select_calls(g, cuda_device, 1)
    torch.cuda.synchronize()
    _check_calls(calls)
    a, b = (fk._SCRATCH[("segment_select", 0, st.cuda_stream)][0]
            for st in streams)
    assert {x.data_ptr() for x in a}.isdisjoint(x.data_ptr() for x in b)


@pytest.mark.cuda
def test_segment_select_after_a_skipped_epoch_and_the_wrap(cuda_device):
    """An epoch taken with no launch leaves the count of the call
    before; the next calls still match. Then the epoch counter wraps."""
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(29)
    stream = fk._stream(dev)
    _check_calls(_select_calls(g, dev, 3))
    entry = fk._SCRATCH[("segment_select", dev.index, stream)]
    fk._scratch("segment_select", dev, stream, *[0] * len(entry[0]))
    entry[1] = fk._EPOCH_END - 3
    _check_calls(_select_calls(g, dev, 5))
    assert entry[1] == 3


@pytest.mark.cuda
def test_segment_select_is_two_device_operations(cuda_device):
    """torch.profiler sees the warp pass and the long-segment pass per
    call, and no memset or copy."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(31)
    deg = torch.randint(0, 60, (20_000,), generator=g, device=dev)
    deg[::97] = 900
    cap = int(deg.sum())
    keys, slot, mask, seg_start, take, live = _segments(g, deg, cap, dev)
    ops = _device_ops_of(lambda: fk.segment_select(keys, slot, mask,
                                                   seg_start, take, live),
                         5, 2)
    assert sum(c for _, c in ops) == 10, ops
    assert all("select_warp" in k or "select_block" in k
               for k, _ in ops), ops


# ----------------------------------------------------------------------
# the runtime: the event-based poll, the guard, async checkpoints
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_event_poll_reads_each_steps_flags(cuda_device):
    """The ledger's and the guard rail's poll over 50 steps in a row,
    with the flags set on chosen steps behind queued work: each poll
    reads its own step's flags."""
    from repro_torch.data.gnn_loader import LoaderStats, OverflowLedger
    from repro_torch.runtime.guard import GuardConfig, GuardRail

    chosen = [3, 4, 17, 31, 49]
    led, rail = OverflowLedger(LoaderStats()), GuardRail(GuardConfig())
    x = torch.randn(2048, 2048, device=cuda_device)
    replays, flagged = [], []
    for i in range(50):
        y = x @ x                          # work queued ahead of the flags
        bad = (y[0, 0] * 0 + float(i in chosen)) > 0.5
        due = led.record(i, torch.stack([torch.zeros_like(bad), bad]))
        if due is not None:
            replays.append(due)
        w = rail.record(i, None, None, torch.stack([bad, bad & False]))
        if w is not None:
            flagged.append(w.step)
    while (due := led.flush()) is not None:
        replays.append(due)
    while (w := rail.flush()) is not None:
        flagged.append(w.step)
    assert replays == chosen and flagged == chosen
    assert led.stats.overflow_replays == rail.stats.nonfinite_batches == 5


@pytest.mark.cuda
def test_event_poll_does_not_wait_on_the_stream(cuda_device):
    """Reading an older step's flags returns while work queued after it
    is still running on the stream."""
    from repro_torch.data.gnn_loader import LoaderStats, OverflowLedger

    led = OverflowLedger(LoaderStats())
    x = torch.randn(8192, 8192, device=cuda_device)
    torch.cuda.synchronize()
    led.record("a", torch.ones(2, dtype=torch.bool, device=cuda_device))
    for _ in range(8):                     # ~0.2 s of fp32 products
        x = x @ x * 1e-4
    assert led.record("b", torch.zeros(2, dtype=torch.bool,
                                       device=cuda_device)) == "a"
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_clean_guarded_step_adds_no_synchronizing_call(cuda_device):
    """One warm LABOR-0 step under ``set_sync_debug_mode("warn")``, with
    and without the guard: the same synchronizing calls (the polls wait
    on events, which the mode does not count), the same parameters."""
    import warnings

    from repro_torch.runtime.guard import GuardConfig, GuardRail

    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset("labor-0", ds, batch_size=64, fanouts=(5, 5, 5))
    syncs, params = {}, {}
    for guard in (None, GuardConfig()):
        eng = TrainEngine(smp, adam.AdamConfig(), device="cuda", guard=guard)
        rail = GuardRail(guard) if guard is not None else None
        data = eng.make_data_from_dataset(ds)
        model = gcn_init(TR.key(0), 100, 32, 47, 3, device="cuda")
        state = eng.init_state(model)

        def step(i):
            nonlocal model, state
            seeds = pad_seeds(ds.train_idx[64 * i:64 * (i + 1)], 64,
                              device="cuda")
            model, state, m = eng.step(model, state, data, seeds,
                                       TR.key(i))
            if rail is not None:
                assert rail.record(i, seeds, None, m["guard_flags"]) is None

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(3)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs[guard is not None] = sorted(
            str(w.message) for w in caught
            if "called a synchronizing" in str(w.message))
        params[guard is not None] = [p.detach().clone()
                                     for p in model.parameters()]
    assert syncs[True] == syncs[False]
    for a, b in zip(params[True], params[False]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_async_saver_snapshot_of_card_tensors(cuda_device, tmp_path):
    """A save of the card's parameters and moments holds the values of
    the moment it was asked for, whatever the steps after it write in
    place."""
    from repro_torch.runtime import checkpoint as ck

    ds = paper_dataset("products", 0.004, seed=2)
    smp = TS.from_dataset("labor-0", ds, batch_size=64, fanouts=(5, 5, 5))
    eng = TrainEngine(smp, adam.AdamConfig(lr=1e-2), device="cuda")
    data = eng.make_data_from_dataset(ds)
    model = gcn_init(TR.key(0), 100, 32, 47, 3, device="cuda")
    state = eng.init_state(model)
    seeds = pad_seeds(ds.train_idx[:64], 64, device="cuda")
    model, state, _ = eng.step(model, state, data, seeds, TR.key(1))
    want = {k: v.clone() for k, v in ck.unnest(
        ck.state_tree(model, state)).items()}
    saver = ck.AsyncSaver(str(tmp_path))
    saver.save(1, ck.state_tree(model, state))
    for i in range(3):
        model, state, _ = eng.step(model, state, data, seeds, TR.key(2 + i))
    saver.wait()
    got = ck.unnest(ck.restore(str(tmp_path), 1,
                               ck.state_tree(model, state)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k], v), k
    assert not torch.equal(got["params.layers.0.w"],
                           dict(model.named_parameters())["layers.0.w"])


# -- LM training and the new LM blocks on the card ---------------------------

#: (B, S, Hq, Hkv, hd): zamba2's shared attention (MHA, 32 heads of 80)
#: and qwen3-moe's (GQA 64/4, a ratio of 16, at 128)
LM_FLASH_SHAPES = [(1, 300, 32, 32, 80), (1, 300, 64, 4, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LM_FLASH_SHAPES,
                         ids=["mha32x80", "gqa16x128"])
def test_flash_backward_at_the_new_lm_shapes(cuda_device, shape):
    """B9's autograd Function at the head shapes of zamba2 and qwen3-moe:
    the kernel's forward within 2e-5 x max|v| of the plain version, and
    its backward (the plain version's autograd) equal to differentiating
    the plain version."""
    B, S, Hq, Hkv, hd = shape
    case = (B, S, S, Hq, Hkv, hd, True, None, None, None, torch.float32)
    q, k, v = _flash_inputs(case, cuda_device)
    g = torch.randn_like(q)
    outs, grads = [], []
    fa.reset_launches()
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, True),
               lambda a, b, c: fr_attn.attention_ref(a, b, c)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=2e-5 * max(1.0, v.abs().max().item()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("gemma2-2b", 4),
                                         ("zamba2-2.7b", 12),
                                         ("qwen3-moe-235b-a22b", 2)])
def test_lm_train_step_cuda_matches_eager(cuda_device, arch, layers):
    """Two reduced train steps with remat on, on the ``cuda`` backend
    (B9 in the forward and in each recompute: two launches per attention
    layer a step; zamba2's shared block counts once per use) against
    the ``eager`` backend on the card from the same parameters: the
    losses within 1e-5 relative, every parameter within 1e-3 relative
    L2."""
    from repro_torch import configs
    from repro_torch.configs.reduce import reduce_cfg
    from repro_torch.data.tokens import BigramStream
    from repro_torch.models.transformer import lm, stack
    cfg = dataclasses.replace(reduce_cfg(configs.get_config(arch)),
                              num_layers=layers, remat=True)
    n_attn = sum(k != "mamba" for k in cfg.layer_pattern) * cfg.repeats
    opt_cfg = adam.AdamConfig(lr=1e-3)
    runs = []
    for backend in ("cuda", "eager"):
        params = stack.init_params(TR.key(0), cfg, device="cuda")
        opt = lm.init_opt_state(params, opt_cfg)
        step = lm.make_train_step(cfg, opt_cfg, backend=backend)
        stream = BigramStream(cfg.vocab, seed=1)
        losses = []
        for _ in range(2):
            toks, labels = stream.batch(2, 96, device="cuda")
            fa.reset_launches()
            params, opt, m = step(params, opt, {"tokens": toks,
                                                "labels": labels})
            losses.append(m["loss"].item())
            assert fa.LAUNCHES["flash_attention"] == (
                2 * n_attn if backend == "cuda" else 0)
        runs.append((losses, lm.flatten_params(params)))
    (lk, pk), (le, pe) = runs
    torch.testing.assert_close(torch.tensor(lk), torch.tensor(le),
                               rtol=1e-5, atol=0)
    for name, t in pk.items():
        rel = ((t.double() - pe[name].double()).norm()
               / pe[name].double().norm().clamp(min=1e-30)).item()
        assert rel <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("gemma2-2b", 4),
                                         ("zamba2-2.7b", 12)])
def test_lm_train_step_remat_matches_no_remat(cuda_device, arch, layers):
    """Two reduced train steps on the ``cuda`` backend with remat on
    (``torch.utils.checkpoint`` per repeat group; zamba2's shared set
    reached through the group's closure) against remat off, from the same
    parameters on the same batches: the losses within 1e-6 relative,
    every parameter within 1e-4 relative L2; B9 launches twice per
    attention layer a step with remat, once without."""
    from repro_torch import configs
    from repro_torch.configs.reduce import reduce_cfg
    from repro_torch.data.tokens import BigramStream
    from repro_torch.models.transformer import lm, stack
    base = dataclasses.replace(reduce_cfg(configs.get_config(arch)),
                               num_layers=layers)
    n_attn = sum(k != "mamba" for k in base.layer_pattern) * base.repeats
    opt_cfg = adam.AdamConfig(lr=1e-3)
    runs = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        params = stack.init_params(TR.key(0), cfg, device="cuda")
        opt = lm.init_opt_state(params, opt_cfg)
        step = lm.make_train_step(cfg, opt_cfg, backend="cuda")
        stream = BigramStream(cfg.vocab, seed=1)
        losses = []
        for _ in range(2):
            toks, labels = stream.batch(2, 96, device="cuda")
            fa.reset_launches()
            params, opt, m = step(params, opt, {"tokens": toks,
                                                "labels": labels})
            losses.append(m["loss"].item())
            assert fa.LAUNCHES["flash_attention"] == (
                2 * n_attn if remat else n_attn)
        runs.append((losses, lm.flatten_params(params)))
    (lr_, pr), (ln, pn) = runs
    torch.testing.assert_close(torch.tensor(lr_), torch.tensor(ln),
                               rtol=1e-6, atol=0)
    for name, t in pr.items():
        rel = ((t.double() - pn[name].double()).norm()
               / pn[name].double().norm().clamp(min=1e-30)).item()
        assert rel <= 1e-4, name


def _encdec_cfg():
    """A reduced encoder-decoder of whisper's shape: a 2-layer
    ``is_encoder`` stack, a decoder of ``("attn", "xattn")`` x 2, GQA 4/2,
    ``qkv_bias``, layernorm, gelu, 40 frames, remat on."""
    from repro_torch.models.transformer.config import TransformerConfig
    common = dict(d_model=64, n_heads=4, head_dim=16, d_ff=96, vocab=257,
                  qkv_bias=True, norm="layernorm", activation="gelu",
                  gated_mlp=False, dtype="float32", remat=True)
    enc = TransformerConfig(name="enc", num_layers=2, n_kv_heads=4,
                            layer_pattern=("attn",), is_encoder=True,
                            **common)
    return TransformerConfig(name="encdec", num_layers=4, n_kv_heads=2,
                             layer_pattern=("attn", "xattn"),
                             mixers=("none", "mlp"), encoder=enc,
                             xattn_source_len=40, xattn_source_dim=64,
                             **common)


@pytest.mark.cuda
def test_encdec_prefill_and_train_step_match_eager(cuda_device):
    """An encoder-decoder on the ``cuda`` backend against ``eager`` on
    the card: B9 runs only the decoder's causal self-attention (2
    launches a prefill, 2 x 2 a remat train step; the encoder and the
    cross-attention take the plain path); the prefill's logits and every
    cache tensor (the cross K/V too) within rtol 1e-4 / atol 1e-5; one
    train step's loss within 1e-5 relative and every parameter within
    1e-3 relative L2, but the cross blocks' bk (a gradient 0 in exact
    arithmetic, so Adam moves it along rounding noise), within 2 lr."""
    from repro_torch.data.tokens import BigramStream
    from repro_torch.models.transformer import lm, stack
    cfg = _encdec_cfg()
    params = stack.init_params(TR.key(0), cfg, device="cuda")
    tokens = TR.randint(TR.key(0), (2, 120), 0, cfg.vocab, device="cuda")
    xs = TR.normal(TR.key(1), (2, 40, 64), device="cuda")
    want_logits, want_cache = stack.prefill(params, tokens, cfg, xsource=xs,
                                            backend="eager")
    fa.reset_launches()
    logits, cache = stack.prefill(params, tokens, cfg, xsource=xs)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 2
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-5)
    for got, want in zip(cache, want_cache):
        assert sorted(got) == sorted(want)
        for n in want:
            torch.testing.assert_close(got[n], want[n], rtol=1e-4,
                                       atol=1e-5)
    opt_cfg = adam.AdamConfig(lr=1e-3)
    toks, labels = BigramStream(cfg.vocab, seed=1).batch(2, 96,
                                                         device="cuda")
    batch = {"tokens": toks, "labels": labels, "xsource": xs}
    runs = []
    for backend in ("cuda", "eager"):
        p = stack.init_params(TR.key(0), cfg, device="cuda")
        opt = lm.init_opt_state(p, opt_cfg)
        fa.reset_launches()
        p, opt, m = lm.make_train_step(cfg, opt_cfg, backend=backend)(
            p, opt, batch)
        assert fa.LAUNCHES["flash_attention"] == (
            4 if backend == "cuda" else 0)
        runs.append((m["loss"].item(), lm.flatten_params(p)))
    (lk, pk), (le, pe) = runs
    assert abs(lk - le) <= 1e-5 * abs(le)
    cross_bk = {f"layers/1/{r}/mix/bk" for r in range(cfg.repeats)}
    assert any(n.startswith("encoder/layers/") for n in pk)
    for name, t in pk.items():
        if name in cross_bk:
            assert (t - pe[name]).abs().max().item() <= 2e-3, name
            continue
        rel = ((t.double() - pe[name].double()).norm()
               / pe[name].double().norm().clamp(min=1e-30)).item()
        assert rel <= 1e-3, name


# -- FSDP x TP placements and elastic resharding --------------------------------

@pytest.mark.cuda
def test_elastic_reshard_on_one_card(cuda_device, tmp_path):
    """A 2-layer cut of gemma2-2b at full width placed on a (1, 1) mesh
    of a world-size-1 NCCL group, saved, and resharded from the
    checkpoint and from the live DTensors onto a new (1, 1) mesh: every
    tensor bit for bit, with the rules' placements."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import lm, stack
    from repro_torch.runtime import checkpoint as ck
    from repro_torch.runtime import elastic

    cfg = dataclasses.replace(configs.get_config("gemma2-2b",
                                                 dtype="float32"),
                              num_layers=2)
    shapes = lm.flatten_params(stack.init_params(TR.key(0), cfg,
                                                 device="meta"))
    g = torch.Generator(device=cuda_device).manual_seed(0)
    flat = {k: torch.randn(t.shape, generator=g, device=cuda_device)
            for k, t in shapes.items()}
    params = lm.unflatten_params(flat, stack.init_params(TR.key(0), cfg,
                                                        device="meta"))
    make_mesh(1, "cuda")
    try:
        mesh = sh.make_mesh((1, 1), "cuda")
        placed = sh.distribute(params, mesh)
        ck.save(str(tmp_path), 1, {"params": sh.full_tensors(placed)})
        new = sh.make_mesh((1, 1), "cuda")
        for out in (elastic.reshard_checkpoint(str(tmp_path), 1,
                                               {"params": params},
                                               new)["params"],
                    elastic.reshard_live(placed, new)):
            got = lm.flatten_params(sh.full_tensors(out))
            for k, t in lm.flatten_params(out).items():
                assert tuple(t.placements) == sh.placements(
                    sh.leaf_entries(tuple(k.split("/")), t, new), new)
                assert torch.equal(got[k].to(cuda_device), flat[k]), k
    finally:
        dist.destroy_process_group()
