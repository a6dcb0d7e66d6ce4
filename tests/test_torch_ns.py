"""Neighbor Sampling in repro_torch against repro on the CPU:

  * ``hash_uniform_edge`` (NS's per-edge r_ts) bit for bit;
  * the plain ``segment_select`` against repro's bisection, its lexsort
    form and the serial and grid-parallel Pallas kernels in interpret
    mode, bit for bit, on random segments with ties and on the
    adversarial cases: a take of 0, a segment truncated by the expansion
    cap, a masked tail, one segment of length 1, segments longer than
    the kernel's 256-edge warp path (256 and 257 edges, 2,048, all keys
    tied over them, takes at and past the live count);
  * three-layer NS blocks at products 0.004 (batch 64, fanouts 5,5,5):
    every integer field bit for bit, ``weight`` to rtol 1e-6 / atol 1e-7
    (the serving tests' tolerance for the Hajek weights);
  * the per-layer sampled-vertex counts of NS and LABOR-0 under the same
    salts equal repro's (the paper's comparison).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import rng as JR  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro.kernels.frontier import ops as jfk  # noqa: E402
from repro.kernels.frontier import parallel as jpar  # noqa: E402
from repro.kernels.frontier import ref as jfr  # noqa: E402
from repro_torch import ops as TO  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.kernels.frontier import ops as tfk  # noqa: E402

B, FANOUTS = 64, (5, 5, 5)


@pytest.mark.parametrize("salt", [0, 1, 0x9E3779B9, 2**32 - 1])
def test_hash_uniform_edge_bit_exact(salt):
    rng = np.random.default_rng(salt % 997)
    src = rng.integers(-1, 2**31 - 1, size=4000).astype(np.int32)
    dst = rng.integers(-1, 2**31 - 1, size=4000).astype(np.int32)
    src[:9], dst[5:14] = -1, 0          # padding ids and the masked dst 0
    want = np.asarray(JR.hash_uniform_edge(jnp.uint32(salt), jnp.asarray(src),
                                           jnp.asarray(dst)))
    got = TR.hash_uniform_edge(salt, torch.as_tensor(src),
                               torch.as_tensor(dst)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _layout(deg, cap, rng, k, ties=True, tail_keys=3.4e38):
    """Keys over an ``expand_seed_edges``-style buffer of ``cap`` slots:
    segment s holds deg[s] edges from seg_start[s] (truncated at cap),
    masked entries only past the live prefix."""
    deg = np.asarray(deg, np.int64)
    seg_start = (np.cumsum(deg) - deg).astype(np.int32)
    live = min(int(deg.sum()), cap)
    slot = np.full(cap, -1, np.int32)
    for s, (a, d) in enumerate(zip(seg_start, deg)):
        slot[a:min(a + d, live)] = s
    mask = np.arange(cap) < live
    keys = rng.random(cap).astype(np.float32) * 10
    if ties:
        keys[rng.random(cap) < 0.3] = 0.5
    keys[~mask] = tail_keys
    take = np.minimum(k, deg).astype(np.int32)
    return keys, slot, mask, seg_start, take, live


def _cases():
    rng = np.random.default_rng(12)
    out = []
    for t in range(4):
        deg = rng.integers(0, 14, size=int(rng.integers(1, 25)))
        out.append((f"random{t}", _layout(deg, int(deg.sum()) + 5, rng,
                                          int(rng.integers(1, 9)))))
    out.append(("truncated", _layout([6, 9, 12, 7], 20, rng, 8)))
    out.append(("masked_tail", _layout([4, 0, 7], 40, rng, 3,
                                       tail_keys=0.0)))
    out.append(("single_length_one", _layout([1], 1, rng, 1)))
    ties = _layout([10, 10], 20, rng, 4)
    out.append(("all_ties", (np.full(20, 0.25, np.float32),) + ties[1:]))
    out.append(("long_segments", _layout([300, 5, 600, 257], 1200, rng, 10)))
    zero = list(_layout([2, 2], 4, rng, 1))
    zero[0] = np.asarray([0.0, 1.0, 2.0, 0.5], np.float32)
    zero[4] = np.asarray([0, 1], np.int32)
    out.append(("take_zero", tuple(zero)))
    return out


def _padded(case, E=1280, S=32):
    """The case in a buffer of E edges and S segments (masked edges and
    empty segments with take 0 appended), so that every case shares one
    shape and the reference's functions compile once."""
    keys, slot, mask, seg_start, take, live = case
    e, s = len(keys), len(seg_start)
    end = max(int(seg_start[-1]), e)
    return (np.concatenate([keys, np.full(E - e, 3.4e38, np.float32)]),
            np.concatenate([slot, np.full(E - e, -1, np.int32)]),
            np.concatenate([mask, np.zeros(E - e, bool)]),
            np.concatenate([seg_start, np.full(S - s, end, np.int32)]),
            np.concatenate([take, np.zeros(S - s, np.int32)]), live)


def _long_cases():
    """The shapes the kernel's paths split on: segments of 256 and 257
    edges (the warp path's limit), 2,048 (the graph's in-degree tail,
    staged in shared memory), all keys tied over long segments, and takes
    at and past the live count (a truncated expansion included)."""
    rng = np.random.default_rng(21)
    out = [("warp_limit_256_257", _layout([256, 257, 3, 258], 900, rng, 10)),
           ("segment_2048", _layout([2048, 7, 300, 0, 12], 2400, rng, 10))]
    tied = _layout([700, 257, 40], 1000, rng, 10)
    out.append(("all_tied_long", (np.full(1000, 0.75, np.float32),)
                + tied[1:]))
    big = list(_layout([300, 500, 20, 260], 900, rng, 10))
    big[4] = np.asarray([300, 600, 25, 300], np.int32)  # take >= live
    out.append(("take_at_least_live", tuple(big)))
    return out


CASES = [(name, _padded(case)) for name, case in _cases()] + [
    (name, _padded(case, E=2560, S=8)) for name, case in _long_cases()]
_REF = jax.jit(jfr.segment_select, static_argnums=5)
_LEXSORT = jax.jit(jfr.segment_select_lexsort, static_argnums=5)


@pytest.mark.parametrize("name,case", CASES, ids=[c[0] for c in CASES])
def test_segment_select_matches_reference(name, case):
    keys, slot, mask, seg_start, take, live = case
    S = len(seg_start)
    j = tuple(jnp.asarray(x) for x in (keys, slot, mask))
    want = np.asarray(_REF(*j, jnp.asarray(seg_start), jnp.asarray(take), S))
    oracles = {
        "lexsort": _LEXSORT(*j, jnp.asarray(seg_start), jnp.asarray(take), S),
        "pallas_serial": jfk.segment_select_block(
            *j, jnp.asarray(take), S, max(10, int(take.max())),
            interpret=True),
        "pallas_parallel": jpar.segment_select_block_parallel(
            *j, jnp.asarray(seg_start), jnp.asarray(take), S,
            interpret=True),
    }
    for oname, inc in oracles.items():
        np.testing.assert_array_equal(np.asarray(inc), want, err_msg=oname)
    t = [torch.as_tensor(x) for x in (keys, slot, mask, seg_start, take)]
    tfk.reset_launches()
    got = tfk.segment_select(*t, n_live=torch.tensor(live, dtype=torch.int32))
    assert tfk.LAUNCHES["segment_select"] == 0   # a CPU tensor: plain
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TO.segment_select(*t, backend="eager").numpy(), want)
    if name == "take_zero":
        assert got.numpy()[:4].tolist() == [False, False, False, True]


@pytest.fixture(scope="module")
def dsets():
    return jds("products", 0.004, seed=0), tds("products", 0.004, seed=0)


def _blocks(dsets, name, key_seed, n_seeds):
    dj, dt = dsets
    sj = JS.from_dataset(name, dj, batch_size=B, fanouts=FANOUTS)
    st = TS.from_dataset(name, dt, batch_size=B, fanouts=FANOUTS)
    assert [vars(c) for c in sj.caps] == [vars(c) for c in st.caps]
    seeds = dj.val_idx[key_seed:key_seed + n_seeds]
    key = jax.random.fold_in(jax.random.key(key_seed), 1)
    kt = TR.fold_in(TR.key(key_seed), 1)
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), B), key)
    bt = st.sample_with_key(dt.graph, tpad(seeds, B), kt)
    return bj, bt


@pytest.mark.parametrize("key_seed,n_seeds", [(0, 64), (7, 33)])
def test_three_layer_ns_blocks_bit_exact(dsets, key_seed, n_seeds):
    bj, bt = _blocks(dsets, "ns", key_seed, n_seeds)
    assert len(bj) == len(bt) == 3
    for layer, (a, b) in enumerate(zip(bj, bt)):
        for f in INT_FIELDS:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, (layer, f)
            np.testing.assert_array_equal(y, x, err_msg=f"layer {layer} {f}")
        np.testing.assert_allclose(b.weight.numpy(), np.asarray(a.weight),
                                   rtol=1e-6, atol=1e-7)
        assert not bool(b.overflow)
        # NS takes exactly min(k, d_s) in-edges of every seed
        dst = b.dst_slot.numpy()[:int(b.num_edges)]
        assert np.bincount(dst).max() <= FANOUTS[layer]


def test_sampled_vertices_ns_vs_labor0_match_reference(dsets):
    """The paper's metric, per layer, under the same salts: LABOR-0
    samples fewer vertices than NS at the same fanout."""
    counts = {}
    for name in ("ns", "labor-0"):
        bj, bt = _blocks(dsets, name, 3, 64)
        cj = [int(b.num_next) for b in bj]
        ct = [int(b.num_next) for b in bt]
        assert ct == cj, name
        counts[name] = ct
    assert counts["labor-0"][-1] < counts["ns"][-1]


def test_ns_is_registered_with_its_doc():
    assert TS.list_samplers() == JS.list_samplers()
    assert dict(TS.describe())["ns"] == dict(JS.describe())["ns"]
    assert TS.sampler_arg_type("ns") == "ns"
