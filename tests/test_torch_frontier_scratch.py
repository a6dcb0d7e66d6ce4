"""The host-side bookkeeping of the frontier kernels' wrappers, on the CPU
(no card, no JAX): the shared per-stream scratch helper ``_scratch``
(growth, one entry per kernel and stream, rising epochs, the zeroing at
the epoch counter's wrap) and the digit passes and scratch sizes that
``compact_perm`` and ``hash_dedup`` derive from their arguments. The
card tests in ``tests/test_torch_cuda.py`` assert the same pass counts
as device operations per call."""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

from repro_torch.kernels.frontier import ops as fk  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def fresh(monkeypatch):
    """An empty scratch cache for the test, the module's own restored
    after it."""
    cache = {}
    monkeypatch.setattr(fk, "_SCRATCH", cache)
    return cache


def test_scratch_is_zeroed_and_reused_with_rising_epochs(fresh):
    (t,), e = fk._scratch("compact", CPU, 7, 100)
    assert t.dtype == torch.int64 and t.numel() == 100
    assert e == 1 and not t.any()
    t.fill_(5)                      # words a kernel left behind
    for want in (2, 3, 4):
        (u,), e = fk._scratch("compact", CPU, 7, 60)
        assert u.data_ptr() == t.data_ptr() and e == want
    assert bool((u == 5).all())     # a reuse clears nothing
    assert list(fresh) == [("compact", None, 7)]


def test_scratch_one_tensor_per_kind_of_word(fresh):
    (a, b, c), e = fk._scratch("hash_dedup", CPU, 1, 10, 20, 30)
    assert [x.numel() for x in (a, b, c)] == [10, 20, 30] and e == 1
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    again, e = fk._scratch("hash_dedup", CPU, 1, 10, 20, 30)
    assert all(x is y for x, y in zip(again, (a, b, c))) and e == 2


def test_scratch_grows_each_tensor_on_demand(fresh):
    (t, u), _ = fk._scratch("hash_dedup", CPU, 1, 100, 50)
    t.fill_(3)
    u.fill_(4)
    (t2, u2), e = fk._scratch("hash_dedup", CPU, 1, 150, 50)
    # at least twice the old size (less one), zeroed; the other tensor
    # and the epoch count run on (its words stay older than the epoch)
    assert t2.numel() == 199 and not t2.any()
    assert u2 is u and bool((u == 4).all()) and e == 2
    (t3, _), _ = fk._scratch("hash_dedup", CPU, 1, 1000, 50)
    assert t3.numel() == 1000
    (t4, _), e = fk._scratch("hash_dedup", CPU, 1, 999, 50)
    assert t4 is t3 and e == 4


def test_scratch_one_entry_per_kernel_and_stream(fresh):
    (a,), ea = fk._scratch("compact", CPU, 1, 10)
    (b,), eb = fk._scratch("compact", CPU, 2, 10)
    (c,), ec = fk._scratch("compact_perm", CPU, 1, 10)
    (a2,), ea2 = fk._scratch("compact", CPU, 1, 10)
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    assert (ea, eb, ec, ea2) == (1, 1, 1, 2)
    assert a2.data_ptr() == a.data_ptr()
    assert set(fresh) == {("compact", None, 1), ("compact", None, 2),
                          ("compact_perm", None, 1)}


def test_scratch_zeroed_when_the_epoch_wraps(fresh):
    (t, u), _ = fk._scratch("compact_perm", CPU, 3, 32, 8)
    fresh[("compact_perm", None, 3)][1] = fk._EPOCH_END - 2
    t.fill_(9)
    u.fill_(9)
    _, e = fk._scratch("compact_perm", CPU, 3, 32, 8)
    assert e == fk._EPOCH_END - 1 and bool((t == 9).all())
    (t2, u2), e = fk._scratch("compact_perm", CPU, 3, 32, 8)
    assert t2 is t and u2 is u
    assert e == 1 and not t.any() and not u.any()


#: (num_keys, digit passes): keys of compact_perm's sort are at most
#: num_keys + 1, 8 bits a pass; the three layers of the serving path's
#: vertex caps (22,272 / 470,656 / 1,083,008) and the edges of a digit
@pytest.mark.parametrize("num_keys,passes", [
    (0, 1), (1, 1), (254, 1), (255, 2), (22_272, 2), (65_534, 2),
    (65_535, 3), (470_656, 3), (1_083_008, 3), (2**24 - 2, 3),
    (2**24 - 1, 4), (2**31 - 3, 4)])
def test_perm_passes(num_keys, passes):
    assert fk._DIGIT_BITS == 8
    assert fk._perm_passes(num_keys) == passes
    assert (num_keys + 1) < 2 ** (fk._DIGIT_BITS * passes)


@pytest.mark.parametrize("E", [0, 1, 4095, 4096, 4097, 9_426_304])
def test_sort_scratch_covers_every_tile(E):
    """A status word per digit, pass and tile of the largest sort, after
    4 passes' digit totals and tickets and a count and a max word."""
    tiles = max(1, -(-E // fk._SORT_TILE))
    for passes in range(1, fk._MAX_PASSES + 1):
        words = fk._sort_words(E, passes)
        assert words == fk._MAX_PASSES * (fk._RADIX + 1) + 2 + (
            passes * tiles * fk._RADIX)
    assert fk._sort_words(E, 2) - fk._sort_words(E, 1) == tiles * 256


@pytest.mark.parametrize("S,E,table", [
    (0, 1, 8), (3, 1, 8), (3, 3, 16), (1024, 21_248, 65_536),
    (470_656, 866_504, 1 << 21), (470_656, 9_426_304, 1 << 24)])
def test_dedup_table_is_at_most_two_thirds_full(S, E, table):
    """The table's slots: a power of two (8 at the least) at least 1.5
    (S + E), so that a probe ends and is short; at layer 2's live count
    (866,504 values, 470,656 seeds) 2^21 slots, 24 MB with the values."""
    assert fk._dedup_table(S, E) == table
    assert 3 * (S + E) <= 2 * table
    assert table == 8 or 3 * (S + E) > table
