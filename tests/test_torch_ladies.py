"""LADIES and PLADIES in repro_torch against repro on the CPU:

  * ``masked_cdf_draw``: the port's search (``ref.cdf_search`` and the
    wrapper ``cdf_search`` on a CPU tensor) on repro's CDF floats
    against repro's draws, bit for bit: random weight spreads, the
    adversarial weights of ``tests/test_frontier.py`` (4,096 x 1e-7,
    8 x 3e8, 4,096 x 1e-7; u in {0, 0.5, 1 - 1e-7, 1 - 6e-8}, also
    against both Pallas kernels in interpret mode), u = 0 over an
    invalid entry 0, zero-mass plateaus, an all-invalid p, n = 0, C = 1;
  * the 8-ary lockstep ``ref.cdf_search`` (the kernel's rounds) on
    repro's CDF floats at C near powers of 8 and 32 against repro's jitted
    draw and both Pallas draw kernels in interpret mode, bit for bit,
    and against ``torch.searchsorted`` (clamped) with u at every probed
    entry of the first two rounds, plateaus across probes, NaN and 1.0,
    an all-zero CDF;
  * ``normalized_cdf`` non-decreasing where the fixed-order sum's rows
    meet over zero mass (the carry used to dip an ulp there);
  * the port's own ``normalized_cdf`` against repro's to rtol 1e-5 /
    atol 1e-7 (float32 cumsums associate differently), and its draws
    equal to repro's except where u lies within that gap of a CDF value
    between the two draws;
  * ``hash_uniform`` over ``arange(n)`` (LADIES's u) bit for bit;
  * ``_waterfill_lambda``: lam to rtol 1e-5 (its totals are float sums
    in another order), including the all-clipped case;
  * the candidate column norms p of a real layer to rtol 1e-6 (summed
    per candidate in edge order on both sides), and the dense oracle
    ``_layer_probs`` at the candidates;
  * the four variance oracles to rtol 1e-6;
  * three-layer ``ladies`` and ``pladies`` blocks (products 0.004,
    batch 64, fanouts 5,5,5, default layer sizes, two key seeds)
    against repro's jitted samplers: every integer field bit for bit;
    a sampled vertex may only differ where its draw u (LADIES) or its
    r_t (PLADIES) lies within the float gap of its threshold, and the
    test stops at that layer; ``weight`` to rtol 1e-5 / atol 1e-6 (the
    LADIES total and PLADIES's lam are float sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ladies as JLd  # noqa: E402
from repro.core import rng as JR  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.core import variance as JV  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph.csr import expand_seed_edges as jexpand  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro.kernels.frontier import ops as jfk  # noqa: E402
from repro.kernels.frontier import parallel as jpar  # noqa: E402
from repro.kernels.frontier import ref as jfr  # noqa: E402
from repro.ops import frontier as jops  # noqa: E402
from repro_torch.core import ladies as TLd  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core import variance as TV  # noqa: E402
from repro_torch.core.interface import INT_FIELDS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.csr import expand_seed_edges as texpand  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.kernels.frontier import ops as tfk  # noqa: E402
from repro_torch.kernels.frontier import ref as tfr  # noqa: E402

CDF_TOL = dict(rtol=1e-5, atol=1e-7)
B, FANOUTS = 64, (5, 5, 5)
_DRAW = jax.jit(jfr.masked_cdf_draw)
_CDF = jax.jit(jfr.normalized_cdf)


def _draw_cases():
    rng = np.random.default_rng(400)
    out = []
    for t in range(5):
        C, n = int(rng.integers(2, 3000)), int(rng.integers(1, 200))
        p = (np.abs(rng.normal(size=C)) * 10.0 ** rng.integers(
            -6, 6, size=C)).astype(np.float32)
        valid = rng.random(C) < 0.8
        out.append((f"random{t}", p, valid,
                    rng.random(n).astype(np.float32)))
    p = np.concatenate([np.full(4096, 1e-7, np.float32),
                        np.full(8, 3e8, np.float32),
                        np.full(4096, 1e-7, np.float32)])
    u_adv = np.asarray([0.0, 0.5, 1.0 - 1e-7, np.float32(1.0 - 6e-8)],
                       np.float32)
    out.append(("adversarial", p, np.ones_like(p, bool), u_adv))
    p = np.asarray([5.0, 1.0, 0.0, 0.0, 2.0, 0.0, 2.0], np.float32)
    valid = np.asarray([False, True, True, True, True, False, True])
    # u = 0 over an invalid entry 0; u exactly at the plateaus' values
    out.append(("zero_and_plateaus", p, valid,
                np.asarray([0.0, 0.2, 0.6, 0.6000001, 0.99], np.float32)))
    out.append(("all_invalid", np.ones(9, np.float32), np.zeros(9, bool),
                np.asarray([0.0, 0.3, 0.999], np.float32)))
    out.append(("no_draws", np.ones(5, np.float32), np.ones(5, bool),
                np.zeros(0, np.float32)))
    out.append(("one_entry", np.asarray([0.5], np.float32),
                np.asarray([True]), np.asarray([0.0, 0.7], np.float32)))
    return out


DRAW_CASES = _draw_cases()


def _flips_in_cdf_gap(cdf, u, d_ref, d_port, tol):
    """Draws that differ must have u within ``tol`` of a CDF value
    between them: returns how many differ."""
    bad = np.nonzero(d_ref != d_port)[0]
    for i in bad:
        lo, hi = sorted((int(d_ref[i]), int(d_port[i])))
        gap = np.min(np.abs(cdf[lo:hi + 1] - u[i]))
        assert gap <= tol, (i, u[i], d_ref[i], d_port[i], gap)
    return len(bad)


@pytest.mark.parametrize("name,p,valid,u", DRAW_CASES,
                         ids=[c[0] for c in DRAW_CASES])
def test_masked_cdf_draw_matches_reference(name, p, valid, u):
    jp, jv, ju = jnp.asarray(p), jnp.asarray(valid), jnp.asarray(u)
    want = np.asarray(_DRAW(jp, jv, ju))
    cdf_j = np.array(_CDF(jp, jv))
    if name == "adversarial":
        for oracle in (jfk.masked_cdf_draw_block(jp, jv, ju, interpret=True),
                       jpar.masked_cdf_draw_block_parallel(
                           jp, jv, ju, interpret=True)):
            np.testing.assert_array_equal(np.asarray(oracle), want)
    # the port's search on repro's CDF floats: bit for bit
    tfk.reset_launches()
    for got in (tfr.cdf_search(torch.as_tensor(cdf_j), torch.as_tensor(u)),
                tfk.cdf_search(torch.as_tensor(cdf_j), torch.as_tensor(u))):
        assert got.dtype == torch.int32 and got.shape == u.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert tfk.LAUNCHES["masked_cdf_draw"] == 0       # CPU: plain
    # the port's own CDF and draws
    tp, tv, tu = (torch.as_tensor(x) for x in (p, valid, u))
    cdf_t = tfr.normalized_cdf(tp, tv).numpy()
    np.testing.assert_allclose(cdf_t, cdf_j, **CDF_TOL)
    d_t = tfk.masked_cdf_draw(tp, tv, tu).numpy()
    np.testing.assert_array_equal(d_t, tfr.masked_cdf_draw(tp, tv,
                                                           tu).numpy())
    _flips_in_cdf_gap(cdf_t, u, want, d_t, 1e-5 * np.abs(cdf_t).max()
                      + 1e-7)
    if len(u):
        assert want.min() >= 0 and want.max() < len(p)
    if name == "adversarial":
        assert (p[want] > 0).all()
        np.testing.assert_array_equal(d_t, want)
    if name == "zero_and_plateaus":
        # u = 0 -> index 0 though invalid; plateaus resolve to their
        # first index
        assert want[0] == 0 and want.tolist() == d_t.tolist()
    if name == "all_invalid":
        assert want.tolist() == [0, 8, 8]


#: C near powers of 8 (the kernel's lanes per draw, one to five rounds)
#: and of 32
SEARCH_SIZES = [1, 2, 7, 8, 9, 31, 32, 33, 63, 64, 65, 511, 512, 513, 1023,
                1024, 1025, 4095, 4096, 4097, 32767, 32768, 32769]


def _splitters(C):
    """The positions the G-ary search probes in its first two rounds
    (the entries the kernel stages in shared memory)."""
    G = tfr.SEARCH_G
    out = []
    step0 = -(-C // G)
    for k in range(G):
        p0 = (k + 1) * step0 - 1
        if p0 < C:
            out.append(p0)
        lo, hi = k * step0, min((k + 1) * step0 - 1, C)
        if lo < hi:
            step1 = -(-(hi - lo) // G)
            out += [p for p in range(lo + step1 - 1, hi, step1)]
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("C", SEARCH_SIZES)
def test_gary_cdf_search_matches_reference_oracles(C):
    """The G-ary lockstep (``ref.cdf_search``, the kernel's arithmetic)
    on repro's CDF floats against repro's jitted draw and both Pallas
    draw kernels in interpret mode, bit for bit: seeded weights with
    invalid entries, u uniform and u equal to probed entries."""
    rng = np.random.default_rng(C)
    p = (rng.random(C) * 10.0 ** rng.integers(-3, 3, size=C)).astype(
        np.float32)
    valid = rng.random(C) < 0.7
    jp, jv = jnp.asarray(p), jnp.asarray(valid)
    cdf = np.array(_CDF(jp, jv))
    u = np.concatenate([rng.random(48), cdf[rng.choice(_splitters(C), 16)],
                        [0.0, 1.0]]).astype(np.float32)
    ju = jnp.asarray(u)
    want = np.asarray(_DRAW(jp, jv, ju))
    for oracle in (jfk.masked_cdf_draw_block(jp, jv, ju, interpret=True),
                   jpar.masked_cdf_draw_block_parallel(jp, jv, ju,
                                                       interpret=True)):
        np.testing.assert_array_equal(np.asarray(oracle), want)
    got = tfr.cdf_search(torch.as_tensor(cdf), torch.as_tensor(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalized_cdf_never_dips(seed):
    """Where rows of the fixed-order sum meet over zero mass, the carry
    (summed in another order) used to leave an entry an ulp below its
    predecessor (10 such dips at this size and seed 0); the lifted sum is
    non-decreasing, stays within CDF_TOL of repro's CDF, and every exact
    search agrees on it, u at every row boundary included."""
    rng = np.random.default_rng(seed)
    C = 100_000
    p = (rng.random(C) ** 4).astype(np.float32)
    valid = rng.random(C) < 0.05
    cdf = tfr.normalized_cdf(torch.as_tensor(p), torch.as_tensor(valid))
    assert bool((cdf[1:] >= cdf[:-1]).all())
    np.testing.assert_allclose(cdf.numpy(), np.asarray(
        _CDF(jnp.asarray(p), jnp.asarray(valid))), **CDF_TOL)
    edges = torch.arange(tfr.SCAN_ROW - 1, C - 1, tfr.SCAN_ROW)
    u = torch.cat([cdf[edges], cdf[edges + 1], torch.rand(
        256, generator=torch.Generator().manual_seed(seed))])
    want = torch.clamp(torch.searchsorted(cdf, u), 0, C - 1).to(torch.int32)
    assert torch.equal(tfr.cdf_search(cdf, u), want)


def _search_cases():
    """(name, cdf, u): C near powers of 8 and 32 with u at every probed
    entry of the first two rounds,
    plateaus across a probe, NaN and 1.0, an all-zero CDF."""
    rng = np.random.default_rng(17)
    out = []
    for C in SEARCH_SIZES + [1 << 20, (1 << 20) + 1]:
        cdf = np.sort(rng.random(C)).astype(np.float32)
        cdf[-1] = 1.0
        u = np.concatenate([cdf[_splitters(C)], rng.random(64), [0.0]])
        out.append((f"powers{C}", cdf, u.astype(np.float32)))
    # one long plateau over the first two rounds' probes, and runs of
    # equal values across each probe
    cdf = np.full(40_000, 0.5, np.float32)
    cdf[:3] = [0.0, 0.1, 0.2]
    cdf[-5:] = [0.6, 0.7, 0.8, 0.9, 1.0]
    out.append(("long_plateau", cdf, np.asarray(
        [0.5, 0.4999999, 0.5000001, 0.2, 0.0, 1.0], np.float32)))
    cdf = np.repeat(np.linspace(0, 1, 50, dtype=np.float32), 700)
    out.append(("plateaus_across_probes", cdf,
                np.concatenate([cdf[::350], rng.random(32)]).astype(
                    np.float32)))
    cdf = np.linspace(0, 1, 5000, dtype=np.float32)
    out.append(("nan_and_one", cdf, np.asarray(
        [np.nan, 1.0, np.float32(1 - 6e-8), 2.0, -1.0, np.nan], np.float32)))
    out.append(("all_zero", np.zeros(3000, np.float32),
                np.asarray([0.0, 1e-9, 0.5, 1.0, np.nan], np.float32)))
    return out


SEARCH_CASES = _search_cases()


@pytest.mark.parametrize("name,cdf,u", SEARCH_CASES,
                         ids=[c[0] for c in SEARCH_CASES])
def test_gary_cdf_search_matches_searchsorted(name, cdf, u):
    """The G-ary lockstep against ``torch.searchsorted`` clamped into
    [0, C - 1] (NaN u goes past the end in both), and the wrapper on a
    CPU tensor runs it."""
    tc, tu = torch.as_tensor(cdf), torch.as_tensor(u)
    want = torch.clamp(torch.searchsorted(tc, tu), 0, len(cdf) - 1).to(
        torch.int32)
    got = tfr.cdf_search(tc, tu)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    tfk.reset_launches()
    assert torch.equal(tfk.cdf_search(tc, tu), want)
    assert tfk.LAUNCHES["masked_cdf_draw"] == 0       # CPU: plain
    if name == "nan_and_one":
        assert got.tolist() == [4999, 4999, 4999, 4999, 0, 4999]
    if name == "all_zero":
        assert got.tolist() == [0, 2999, 2999, 2999, 2999]


@pytest.mark.parametrize("salt", [0, 7, 0xDEADBEEF])
def test_hash_uniform_over_draw_indices_bit_exact(salt):
    want = np.asarray(JR.hash_uniform(jnp.uint32(salt), jnp.arange(4096)))
    got = TR.hash_uniform(salt, torch.arange(4096, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _waterfill_cases():
    rng = np.random.default_rng(0)
    p = np.abs(rng.normal(size=5000)).astype(np.float32)
    spread = (p * 10.0 ** rng.integers(-4, 4, size=5000)).astype(np.float32)
    sparse = np.where(rng.random(5000) < 0.05, p, 0.0).astype(np.float32)
    return [("normal", p, 50), ("normal", p, 500), ("normal", p, 3000),
            ("spread", spread, 700), ("all_clipped", sparse, 1000)]


@pytest.mark.parametrize("name,p,n", _waterfill_cases(),
                         ids=lambda x: str(x) if not hasattr(x, "shape")
                         else "p")
def test_waterfill_lambda_matches_reference(name, p, n):
    want = float(jax.jit(JLd._waterfill_lambda, static_argnums=1)(
        jnp.asarray(p), n))
    lam = TLd._waterfill_lambda(torch.as_tensor(p), n)
    assert lam.dtype == torch.float32 and lam.shape == ()
    assert float(lam) == pytest.approx(want, rel=1e-5)
    mass = float(torch.sum(torch.clamp(lam * torch.as_tensor(p), max=1.0)))
    if name == "all_clipped":
        assert mass == pytest.approx(float((p > 0).sum()), rel=1e-5)
    else:
        assert mass == pytest.approx(n, rel=2e-2)


@pytest.fixture(scope="module")
def dsets():
    return jds("products", 0.004, seed=0), tds("products", 0.004, seed=0)


def test_candidate_column_norms_match_reference(dsets):
    dj, dt = dsets
    seeds = dj.val_idx[:200]
    cap = 8192
    ej = jexpand(dj.graph, jpad(jnp.asarray(seeds), 256), cap)
    dd = jops.hash_dedup(ej["src"], ej["mask"], None, cap)
    cidx = jnp.where(ej["mask"], dd.slots, cap)
    pj = np.asarray(jnp.zeros(cap + 1).at[cidx].add(
        JLd._edge_contrib(ej), mode="drop")[:cap])
    et = texpand(dt.graph, tpad(seeds, 256), cap)
    log = {}
    caps = TS.from_dataset("ladies", dt, batch_size=256,
                           fanouts=(5,)).caps[0]
    caps = type(caps)(expand_cap=cap, edge_cap=cap, vertex_cap=cap + 256)
    TLd.sample_layer_ladies(dt.graph, tpad(seeds, 256), 3, 300, caps,
                            log=log)
    np.testing.assert_allclose(log["p"].numpy(), pj, rtol=1e-6, atol=0)
    dense = TLd._layer_probs(dt.graph, et, dt.graph.num_vertices).numpy()
    cands = np.asarray(dd.new)
    live = cands >= 0
    np.testing.assert_allclose(log["p"].numpy()[live], dense[cands[live]],
                               rtol=1e-6)
    assert (dense > 0).sum() == live.sum()


def test_variance_oracles_match_reference():
    d = np.arange(1, 60, dtype=np.float32)
    for k in (1, 3, 10, 70):
        for tf, jf in ((TV.ns_without_replacement_variance,
                        JV.ns_without_replacement_variance),
                       (TV.poisson_uniform_variance,
                        JV.poisson_uniform_variance)):
            np.testing.assert_allclose(tf(d, k).numpy(),
                                       np.asarray(jf(jnp.asarray(d), k)),
                                       rtol=1e-6, atol=1e-7)
    d2 = d[1:]
    np.testing.assert_allclose(
        TV.calibrated_target_matches_ns(d2, 4).numpy(),
        np.asarray(JV.calibrated_target_matches_ns(jnp.asarray(d2), 4)),
        atol=1e-6)
    pi = np.random.default_rng(3).uniform(0.05, 1.0, 23).astype(np.float32)
    assert float(TV.poisson_ht_variance(pi)) == pytest.approx(
        float(JV.poisson_ht_variance(jnp.asarray(pi))), rel=1e-6)


def _vertex_set(blk):
    return set(np.asarray(blk.src)[:int(blk.num_edges)].tolist())


def _flips_in_gap(dt, st, seeds, salt, layer, bj, bt):
    """At the first layer whose blocks differ: each vertex sampled by one
    side only must have r_t within rtol 1e-5 of pi_t (PLADIES), or a
    draw u within 1e-5 of its CDF interval's ends (LADIES), both from
    the port's floats. Returns the flipped vertices."""
    log = {}
    TLd.sample_layer_ladies(dt.graph, seeds, salt,
                            st.config.layer_sizes[layer], st.caps[layer],
                            poisson=st.config.poisson, log=log)
    exp = texpand(dt.graph, seeds, st.caps[layer].expand_cap)
    E = exp["src"].shape[0]
    cands = tfk.hash_dedup(exp["src"], exp["mask"], None, E).new.numpy()
    flips = _vertex_set(bj) ^ _vertex_set(bt)
    p = log["p"].numpy()
    if st.config.poisson:
        pi = np.minimum(1.0, float(log["lam"]) * p)
        r = TR.hash_uniform(salt, torch.as_tensor(cands)).numpy()
    else:
        cdf = tfr.normalized_cdf(log["p"], log["valid"]).numpy()
        u = TR.hash_uniform(salt, torch.arange(
            st.config.layer_sizes[layer], dtype=torch.int32)).numpy()
    for t in flips:
        j = int(np.searchsorted(cands[cands >= 0], t))
        if st.config.poisson:
            assert abs(r[j] - pi[j]) <= 1e-5 * pi[j], (layer, t)
        else:
            ends = [cdf[j]] + ([cdf[j - 1]] if j else [])
            assert min(np.abs(u - e).min() for e in ends) <= 1e-5, (layer, t)
    return flips


@pytest.mark.parametrize("sampler,key_seed,n_seeds",
                         [(s, ks, n) for s in ("ladies", "pladies")
                          for ks, n in ((0, 64), (7, 33))])
def test_three_layer_blocks_match_reference(dsets, sampler, key_seed,
                                            n_seeds):
    dj, dt = dsets
    sj = JS.from_dataset(sampler, dj, batch_size=B, fanouts=FANOUTS)
    st = TS.from_dataset(sampler, dt, batch_size=B, fanouts=FANOUTS)
    assert [vars(c) for c in sj.caps] == [vars(c) for c in st.caps]
    assert st.spec.budgets == sj.spec.budgets == (320, 320, 320)
    seeds = dj.val_idx[key_seed:key_seed + n_seeds]
    key = jax.random.fold_in(jax.random.key(key_seed), 1)
    kt = TR.fold_in(TR.key(key_seed), 1)
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), B), key)
    bt = st.sample_with_key(dt.graph, tpad(seeds, B), kt)
    salts = st.spec.salts(kt)
    assert len(bj) == len(bt) == 3
    for layer, (a, b) in enumerate(zip(bj, bt)):
        if not all(np.array_equal(np.asarray(getattr(a, f)),
                                  getattr(b, f).numpy()) for f in INT_FIELDS):
            flips = _flips_in_gap(dt, st, b.seeds, salts[layer], layer, a, b)
            assert flips, f"layer {layer} differs beyond its sampled set"
            return
        for f in INT_FIELDS:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, (layer, f)
            np.testing.assert_array_equal(y, x, err_msg=f"layer {layer} {f}")
        np.testing.assert_allclose(b.weight.numpy(), np.asarray(a.weight),
                                   rtol=1e-5, atol=1e-6)
        assert not bool(b.overflow)
        if sampler == "ladies":   # at most n distinct sampled vertices
            assert len(_vertex_set(b)) <= st.config.layer_sizes[layer]
