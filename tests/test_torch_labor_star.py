"""The rest of the LABOR family in repro_torch against repro on the CPU:

  * ``solve_cs`` (cold start, warm start, the fully-clipped halving
    branch, the k >= d exact branch, per-seed fanouts, the ``max_iters``
    and ``tol`` stopping rule): c to rtol 1e-5, and the SAME iteration
    count. The reference's loops are counted by running it eagerly
    (``jax.disable_jit``) with ``jax.lax.while_loop`` wrapped;
  * ``run_importance_iterations`` for LABOR-1, LABOR-2, LABOR-1 with the
    cold-start solver and LABOR-* on a real layer: pi_e and c to rtol
    1e-5, LABOR-*'s outer iteration count and every solve's count equal;
  * three-layer blocks of ``labor-1``, ``labor-*``, ``labor-d`` and
    ``full`` (products 0.004, batch 64, fanouts 5,5,5, two key seeds)
    against repro's jitted samplers: every integer field bit for bit.
    An inclusion of labor-1/* may only differ where r_t lies within
    rtol 1e-5 of its threshold c_s pi_t (the float gap): the test checks
    that and stops at that layer. ``weight`` to rtol 1e-6 / atol 1e-7
    for labor-d and full (no float sum decides them), to rtol 1e-5 /
    atol 1e-6 for labor-1/* (1/(c pi) inherits c's last bits);
  * the registry: the reference's entries, order, docs, budget kinds
    and caps, and ``labor-<i>`` for any i.

rtol 1e-5 for c and pi: the per-seed sums are sequential in edge order
on both sides (bit-identical here), but XLA may reorder the fused
arithmetic of a jitted program, and LABOR-*'s E[|T|] totals are summed
in another order (``torch.sum``); both move the last bits only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cs_solve as JC  # noqa: E402
from repro.core import labor as JL  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph.csr import expand_seed_edges as jexpand  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro_torch.core import cs_solve as TC  # noqa: E402
from repro_torch.core import labor as TL  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.csr import expand_seed_edges as texpand  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402

C_TOL = 1e-5
B, FANOUTS = 64, (5, 5, 5)


@pytest.fixture
def ref_loops(monkeypatch):
    """Run repro eagerly with every ``while_loop`` counted: a list of
    (the loop's function, iterations) in completion order."""
    counts = []
    orig = jax.lax.while_loop

    def counted_loop(cond, body, init):
        n = 0

        def counted(state):
            nonlocal n
            n += 1
            return body(state)

        out = orig(cond, counted, init)
        counts.append((cond.__qualname__.split(".")[0], n))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", counted_loop)
    with jax.disable_jit():
        yield counts


def _layout(rng, S=40, max_deg=30, pad=17):
    deg = rng.integers(0, max_deg, size=S).astype(np.int32)
    deg[:4] = [0, 1, 5, 3]                       # k >= d for k = 5
    E = int(deg.sum()) + pad
    slot = np.full(E, -1, np.int32)
    slot[:deg.sum()] = np.repeat(np.arange(S), deg)
    pi = (rng.random(E) * 10.0 ** rng.uniform(-2, 1, size=E)).astype(
        np.float32)
    return pi, slot, slot >= 0, deg


def _solve_cases():
    rng = np.random.default_rng(21)
    out = []
    for name, kw in (("cold", {}), ("warm", {"c_init": "random"}),
                     ("warm_above_fixed_point", {"c_init": 500.0}),
                     ("per_seed_k", {"k": "per_seed"}),
                     ("max_iters_2", {"max_iters": 2}),
                     ("loose_tol", {"tol": 1e-2})):
        pi, slot, mask, deg = _layout(rng)
        S = deg.shape[0]
        k = 5
        if kw.get("k") == "per_seed":
            k = rng.integers(1, 12, size=S).astype(np.int32)
        c_init = kw.get("c_init")
        if c_init == "random":
            c_init = (rng.random(S) * 0.5).astype(np.float32)
            c_init[::5] = 0.0                     # -> the eq. 15 guess
        elif c_init is not None:
            c_init = np.full(S, c_init, np.float32)
        out.append((name, (pi, slot, mask, deg, k, c_init,
                           kw.get("max_iters", 64), kw.get("tol", 1e-6))))
    return out


SOLVE_CASES = _solve_cases()


@pytest.mark.parametrize("name,case", SOLVE_CASES,
                         ids=[c[0] for c in SOLVE_CASES])
def test_solve_cs_matches_reference(name, case, ref_loops):
    pi, slot, mask, deg, k, c_init, max_iters, tol = case
    S = deg.shape[0]
    want = np.asarray(JC.solve_cs(
        jnp.asarray(pi), jnp.asarray(slot), jnp.asarray(deg),
        jnp.asarray(k), S, jnp.asarray(mask), max_iters=max_iters, tol=tol,
        c_init=None if c_init is None else jnp.asarray(c_init)))
    iters = []
    TC.reset_host_reads()
    got = TC.solve_cs(
        torch.as_tensor(pi), torch.as_tensor(slot), torch.as_tensor(deg),
        torch.as_tensor(k), S, torch.as_tensor(mask), max_iters=max_iters,
        tol=tol, c_init=None if c_init is None else torch.as_tensor(c_init),
        iters_out=iters)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=C_TOL, atol=0)
    assert [n for f, n in ref_loops if f == "solve_cs"] == [int(iters[0])]
    # the condition is read after every CHECK_EVERY iterations (frozen
    # once it fails), so ceil(n / CHECK_EVERY) reads, at least one
    assert TC.HOST_READS["solve_cs"] == max(
        1, -(-int(iters[0]) // TC.CHECK_EVERY))
    if name == "max_iters_2":
        assert int(iters[0]) == 2
    assert (got.numpy()[deg == 0] == 0).all()


@pytest.fixture(scope="module")
def dsets():
    return jds("products", 0.004, seed=0), tds("products", 0.004, seed=0)


@pytest.mark.parametrize("iters,fast", [(1, True), (2, True), (1, False),
                                        (JL.CONVERGE, True)],
                         ids=["labor-1", "labor-2", "labor-1-cold",
                              "labor-star"])
def test_importance_iterations_match_reference(dsets, iters, fast,
                                               ref_loops):
    dj, dt = dsets
    seeds = dj.val_idx[:200]
    cap = 8192
    ej = jexpand(dj.graph, jpad(jnp.asarray(seeds), 256), cap)
    et = texpand(dt.graph, tpad(seeds, 256), cap)
    pj, cj = JL.run_importance_iterations(dj.graph, ej, 5, 256, iters,
                                          fast_solve=fast)
    log = {}
    pt, ct = TL.run_importance_iterations(dt.graph, et, 5, 256, iters,
                                          fast_solve=fast, log=log)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=C_TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=C_TOL)
    assert [n for f, n in ref_loops if f == "solve_cs"] == [
        int(n) for n in log["solves"]]
    outer = [n for f, n in ref_loops if f == "run_importance_iterations"]
    if iters == JL.CONVERGE:
        assert outer == [int(log["outer"])] and outer[0] >= 2
    else:
        assert outer == [] and "outer" not in log


def _edge_set(blk):
    n = int(blk.num_edges)
    src = np.asarray(blk.src)[:n]
    dst = np.asarray(blk.seeds)[np.asarray(blk.dst_slot)[:n]]
    return set(zip(src.tolist(), dst.tolist()))


def _flips_in_gap(dt, st, seeds, salt, layer, bj, bt):
    """At the first layer whose blocks differ: every edge included by one
    side only must have r_t within C_TOL of the port's threshold c_s pi_t
    (a decision inside the float gap). Returns the flips."""
    cfg = st.config
    caps = st.caps[layer]
    exp = texpand(dt.graph, seeds, caps.expand_cap)
    pi_e, c = TL.run_importance_iterations(
        dt.graph, exp, cfg.fanouts[layer], seeds.shape[0],
        cfg.importance_iters)
    slot = torch.clamp(exp["seed_slot"], 0, seeds.shape[0] - 1).long()
    thr = (c[slot] * pi_e).numpy()
    r = TR.hash_uniform(salt, exp["src"]).numpy()
    pos = {(int(s), int(d)): i for i, (s, d) in enumerate(zip(
        exp["src"].numpy(), seeds.numpy()[slot.numpy()]))
        if bool(exp["mask"][i])}
    flips = _edge_set(bj) ^ _edge_set(bt)
    for edge in flips:
        i = pos[edge]
        assert abs(r[i] - thr[i]) <= C_TOL * thr[i], (layer, edge, r[i],
                                                       thr[i])
    return flips


SAMPLER_CASES = [(s, ks, n) for s in ("labor-1", "labor-*", "labor-d",
                                      "full")
                 for ks, n in ((0, 64), (7, 33))]


@pytest.mark.parametrize("sampler,key_seed,n_seeds", SAMPLER_CASES)
def test_three_layer_blocks_match_reference(dsets, sampler, key_seed,
                                            n_seeds):
    dj, dt = dsets
    sj = JS.from_dataset(sampler, dj, batch_size=B, fanouts=FANOUTS)
    st = TS.from_dataset(sampler, dt, batch_size=B, fanouts=FANOUTS)
    assert [vars(c) for c in sj.caps] == [vars(c) for c in st.caps]
    assert sj.spec.budgets == st.spec.budgets
    assert sj.spec.shared_salts == st.spec.shared_salts
    seeds = dj.val_idx[key_seed:key_seed + n_seeds]
    key = jax.random.fold_in(jax.random.key(key_seed), 1)
    kt = TR.fold_in(TR.key(key_seed), 1)
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), B), key)
    bt = st.sample_with_key(dt.graph, tpad(seeds, B), kt)
    salts = st.spec.salts(kt)
    importance = sampler in ("labor-1", "labor-*")
    tol = dict(rtol=1e-5, atol=1e-6) if importance else dict(rtol=1e-6,
                                                             atol=1e-7)
    assert len(bj) == len(bt) == 3
    for layer, (a, b) in enumerate(zip(bj, bt)):
        same = all(np.array_equal(np.asarray(getattr(a, f)),
                                  getattr(b, f).numpy()) for f in INT_FIELDS)
        if not same and importance:
            flips = _flips_in_gap(dt, st, b.seeds, salts[layer], layer, a, b)
            assert flips, f"layer {layer} differs beyond its inclusions"
            return
        for f in INT_FIELDS:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, (layer, f)
            np.testing.assert_array_equal(y, x, err_msg=f"layer {layer} {f}")
        np.testing.assert_allclose(b.weight.numpy(), np.asarray(a.weight),
                                   **tol)
        assert not bool(b.overflow)
    if sampler == "full":   # every in-edge, weights 1/d_s
        b = bt[0]
        n = int(b.num_edges)
        deg = np.bincount(b.dst_slot.numpy()[:n], minlength=B)
        np.testing.assert_allclose(
            b.weight.numpy()[:n], 1.0 / deg[b.dst_slot.numpy()[:n]],
            rtol=1e-6)


def test_labor_d_shares_one_salt_and_sampled_sets_shrink(dsets):
    """labor-d reuses r_t across layers (§A.8); in Table-2 order its
    |V^3| and LABOR-*'s stay at or below LABOR-0's."""
    dj, dt = dsets
    kt = TR.fold_in(TR.key(5), 1)
    counts = {}
    for name in ("labor-0", "labor-1", "labor-*", "labor-d"):
        st = TS.from_dataset(name, dt, batch_size=B, fanouts=FANOUTS)
        if name == "labor-d":
            salts = st.spec.salts(kt)
            assert len(set(salts)) == 1
        counts[name] = int(st.sample_with_key(dt.graph, tpad(
            dj.val_idx[:B], B), kt)[-1].num_next)
    assert counts["labor-*"] <= counts["labor-0"]
    assert counts["labor-d"] <= counts["labor-0"]


def test_factories_and_salt_schedules_match_reference():
    """``labor_sampler``/``neighbor_sampler`` build the reference's
    specs; ``layer_salts`` and ``sample_with_salt``'s remixed salts are
    the reference's, shared across layers under layer dependency."""
    caps = TS.suggest_caps(32, (4, 6), 9.0, 40)
    for tf, jf, kw in ((TL.labor_sampler, JL.labor_sampler,
                        dict(variant="*")),
                       (TL.labor_sampler, JL.labor_sampler,
                        dict(variant=2, layer_dependency=True)),
                       (TL.neighbor_sampler, JL.neighbor_sampler, {})):
        st, sj = tf((4, 6), caps, **kw), jf((4, 6), caps, **kw)
        assert (st.name, st.spec.budgets, st.spec.shared_salts) == (
            sj.name, sj.spec.budgets, sj.spec.shared_salts)
        assert dataclasses.asdict(st.config) == dataclasses.asdict(
            sj.config)
        for key_seed in (0, 5):
            want = [int(x) for x in np.asarray(JL.layer_salts(
                sj.config, jax.random.key(key_seed)))]
            assert TL.layer_salts(st.config, TR.key(key_seed)) == want
    seen = []
    orig = TL.sample_with_salts
    try:
        TL.sample_with_salts = lambda cfg, caps, g, seeds, salts, **kw: (
            seen.append(salts))
        for dep in (False, True):
            TL.sample_with_salt(TL.LaborConfig((4, 6),
                                               layer_dependency=dep),
                                caps, None, None, 0xABCDEF)
    finally:
        TL.sample_with_salts = orig
    assert seen[0] == TR.layer_salts_from_uint32(0xABCDEF, 2)
    assert seen[1] == [0xABCDEF, 0xABCDEF]


def test_registry_matches_reference():
    assert TS.list_samplers() == JS.list_samplers() == (
        "ns", "labor-0", "labor-1", "labor-*", "labor-d", "ladies",
        "pladies", "full")
    assert TS.describe() == JS.describe()
    for name in TS.list_samplers() + ("labor-7",):
        et, ej = TS.resolve(name), JS.resolve(name)
        assert (et.name, et.doc, et.budget_kind, et.dense) == (
            ej.name, ej.doc, ej.budget_kind, ej.dense)
    kw = dict(batch_size=100, fanouts=(3, 4), avg_degree=12.5,
              max_degree=90, num_vertices=5000, num_edges=60000)
    for name, extra in (("full", {}), ("ladies", {}),
                        ("pladies", {"layer_sizes": (70, 90)}),
                        ("labor-3", {})):
        sj = JS.from_graph_stats(name, **kw, **extra)
        st = TS.from_graph_stats(name, **kw, **extra)
        assert st.spec.budgets == sj.spec.budgets
        assert [vars(c) for c in st.caps] == [vars(c) for c in sj.caps]
        assert st.name == sj.name == name
    with pytest.raises(TS.UnknownSamplerError):
        TS.resolve("labor-x")
    with pytest.raises(ValueError):
        TS.from_graph_stats("ladies", layer_sizes=(5,), **kw)
    assert TL._labor_name(TL.LaborConfig((5,), importance_iters=4)) == \
        JL._labor_name(JL.LaborConfig((5,), importance_iters=4))
