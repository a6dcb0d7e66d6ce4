"""Weighted graphs (LABOR §A.7) in repro_torch against repro, on the CPU.

On a ``generate`` mini graph (2,000 vertices, average degree 12) with
edge weights drawn from a numpy seed, uniform in [0.1, 2), built by
``from_coo`` in both packages:

  * the ``Graph`` helpers (``degrees``, ``in_degree``, ``validate`` with
    its error messages, ``reverse`` with the weights) give repro's
    values and errors;
  * ``expand_seed_edges`` emits repro's ``edge_weight``, bit for bit,
    overflowing cap included (None on an unweighted graph in both);
  * ``solve_cs_weighted``'s c within rtol 1e-6 of repro's (it is a fixed
    64-step bisection: no host read);
  * every registered sampler samples two layers: every integer block
    field bit for bit, the weights within rtol 1e-6 / atol 1e-7;
  * ``SamplerSpec.salts_from_uint32`` and ``Sampler.sample_with_salt``
    equal repro's.

The reference samplers run jitted (``sample_with_key``): eager JAX
compiles op by op.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import labor as JL  # noqa: E402
from repro.core import ladies as JD  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.core.cs_solve import solve_cs_weighted as j_solve  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph import csr as JG  # noqa: E402
from repro.graph.generators import DatasetSpec, generate  # noqa: E402
from repro_torch.core import cs_solve as TC  # noqa: E402
from repro_torch.core import labor as TL  # noqa: E402
from repro_torch.core import ladies as TD  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph import csr as TG  # noqa: E402

B, FANOUTS = 64, (4, 3)


@pytest.fixture(scope="module")
def graphs():
    """(repro graph, port graph, dataset): the mini graph with seeded
    weights, through each package's ``from_coo``."""
    ds = generate(DatasetSpec("mini", 2000, 12.0, 16, 5, 0.5, 0.2, 0.6,
                              1000), seed=0)
    indptr = np.asarray(ds.graph.indptr)
    src = np.asarray(ds.graph.indices)
    dst = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    w = np.random.default_rng(5).uniform(0.1, 2.0, len(src)).astype(
        np.float32)
    n = len(indptr) - 1
    return (JG.from_coo(src, dst, n, weights=w),
            TG.from_coo(src, dst, n, weights=w), ds)


def _seeds(ds, n=50):
    return np.asarray(ds.val_idx)[:n]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_graph_helpers_match(graphs):
    gj, gt, _ = graphs
    np.testing.assert_array_equal(_np(gt.indptr), _np(gj.indptr))
    np.testing.assert_array_equal(_np(gt.indices), _np(gj.indices))
    np.testing.assert_array_equal(_np(gt.weights), _np(gj.weights))
    np.testing.assert_array_equal(_np(gt.degrees()), _np(gj.degrees()))
    v = np.array([0, 5, 1999, 17, 17])
    np.testing.assert_array_equal(_np(gt.in_degree(torch.as_tensor(v))),
                                  _np(gj.in_degree(jnp.asarray(v))))
    assert int(gt.in_degree(3)) == int(gj.in_degree(3))
    gj.validate()
    gt.validate()
    rj, rt = JG.reverse(gj), TG.reverse(gt)
    for f in ("indptr", "indices", "weights"):
        a, b = _np(getattr(rj, f)), _np(getattr(rt, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    back = TG.reverse(rt)
    np.testing.assert_array_equal(_np(back.weights), _np(gt.weights))
    assert TG.reverse(TG.Graph(gt.indptr, gt.indices)).weights is None


_BAD = {
    "cover": ([0, 1, 3], [1, 0], None),
    "decreasing": ([0, 2, 1, 2], [1, 0], None),
    "range": ([0, 1, 2], [1, 2], None),
    "weights": ([0, 1, 2], [1, 0], [1.0, 2.0, 3.0]),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_validate_raises_the_reference_errors(case):
    indptr, indices, w = _BAD[case]
    gj = JG.Graph(jnp.asarray(indptr, jnp.int32),
                  jnp.asarray(indices, jnp.int32),
                  None if w is None else jnp.asarray(w, jnp.float32))
    gt = TG.Graph(torch.tensor(indptr, dtype=torch.int32),
                  torch.tensor(indices, dtype=torch.int32),
                  None if w is None else torch.tensor(w))
    with pytest.raises(ValueError) as ej:
        gj.validate()
    with pytest.raises(ValueError, match=str(ej.value)):
        gt.validate()


@pytest.mark.parametrize("edge_cap", [2048, 300])   # 300 overflows
def test_expand_seed_edges_emits_the_weights(graphs, edge_cap):
    gj, gt, ds = graphs
    seeds = _seeds(ds)
    j = JG.expand_seed_edges(gj, jpad(jnp.asarray(seeds), B), edge_cap)
    t = TG.expand_seed_edges(gt, tpad(seeds, B), edge_cap)
    assert (int(j["total"]) > edge_cap) == (edge_cap == 300)
    for f in ("seed_slot", "src", "mask", "deg", "total", "edge_weight"):
        np.testing.assert_array_equal(_np(t[f]), _np(j[f]), err_msg=f)
    assert t["edge_weight"].dtype == torch.float32
    assert not t["edge_weight"][~t["mask"]].any()
    unweighted = TG.Graph(gt.indptr, gt.indices)
    assert TG.expand_seed_edges(unweighted, tpad(seeds, B),
                                edge_cap)["edge_weight"] is None


@pytest.mark.parametrize("k", [1, 3, 4, 10, 20])
def test_solve_cs_weighted_matches(graphs, k):
    """c within rtol 1e-6 (the bisection's midpoints are correctly
    rounded float32 roots and its target one fused multiply-add, as
    XLA's, so on these inputs the two agree to the bit), max 1/pi where
    k >= d, and no host read."""
    gj, gt, ds = graphs
    seeds = _seeds(ds)
    j = JG.expand_seed_edges(gj, jpad(jnp.asarray(seeds), B), 2048)
    t = TG.expand_seed_edges(gt, tpad(seeds, B), 2048)
    cj = j_solve(jnp.where(j["mask"], j["edge_weight"], 1.0),
                 j["edge_weight"], j["seed_slot"], j["deg"], k, B, j["mask"])
    TC.reset_host_reads()
    ct = TC.solve_cs_weighted(torch.where(t["mask"], t["edge_weight"], 1.0),
                              t["edge_weight"], t["seed_slot"], t["deg"], k,
                              B, t["mask"])
    assert sum(TC.HOST_READS.values()) == 0
    assert ct.dtype == torch.float32 and ct.shape == (B,)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)
    deg = t["deg"].numpy()
    assert (ct.numpy()[deg == 0] == 0).all()
    assert (ct.numpy()[(deg > 0) & (deg <= k)] > 0).all()


def _samplers(graphs, name):
    _, gt, ds = graphs
    ls = (192, 128) if name in ("ladies", "pladies") else None
    kw = dict(batch_size=B, fanouts=FANOUTS, layer_sizes=ls, safety=3.0)
    stats = dict(avg_degree=gt.num_edges / gt.num_vertices,
                 max_degree=ds.max_in_degree, num_vertices=gt.num_vertices,
                 num_edges=gt.num_edges)
    return (JS.from_graph_stats(name, **kw, **stats),
            TS.from_graph_stats(name, **kw, **stats))


def _same_blocks(bj, bt):
    assert len(bj) == len(bt)
    for layer, (a, b) in enumerate(zip(bj, bt)):
        for f in INT_FIELDS:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype, (layer, f)
            np.testing.assert_array_equal(y, x, err_msg=f"layer {layer} {f}")
        np.testing.assert_allclose(b.weight.numpy(), np.asarray(a.weight),
                                   rtol=1e-6, atol=1e-7)
        assert not bool(b.overflow)


def test_the_registry_is_the_reference_registry():
    assert TS.list_samplers() == JS.list_samplers()


@pytest.mark.parametrize("name", JS.list_samplers())
def test_every_sampler_samples_a_weighted_graph(graphs, name):
    """Every registry entry accepts a weighted graph, as repro's does,
    and samples its blocks bit for bit (LABOR-i/* ignore
    ``importance_iters`` there; ``full`` ignores the weights)."""
    gj, gt, ds = graphs
    sj, st = _samplers(graphs, name)
    seeds = _seeds(ds)
    TC.reset_host_reads()
    bt = st.sample_with_key(gt, tpad(seeds, B), TR.key(7))
    if name != "labor-*":
        assert sum(TC.HOST_READS.values()) == 0, name
    bj = sj.sample_with_key(gj, jpad(jnp.asarray(seeds), B),
                            jax.random.key(7))
    _same_blocks(bj, bt)
    assert int(bt[-1].num_next) > int(bt[0].num_next)


def test_salts_from_uint32_and_sample_with_salt(graphs):
    gj, gt, ds = graphs
    for name in ("labor-0", "labor-d", "pladies"):
        sj, st = _samplers(graphs, name)
        for salt in (0, 7, 2**32 - 1):
            assert st.spec.salts_from_uint32(salt) == [
                int(x) for x in np.asarray(sj.spec.salts_from_uint32(
                    jnp.uint32(salt)))]
    sj, st = _samplers(graphs, "labor-0")
    seeds = _seeds(ds)
    salt = 123456789
    bj = jax.jit(sj.sample_with_salt)(gj, jpad(jnp.asarray(seeds), B),
                                      jnp.uint32(salt))
    bt = st.sample_with_salt(gt, tpad(seeds, B), salt)
    _same_blocks(bj, bt)
    # the free function of core/labor.py is the same trace
    bf = TL.sample_with_salt(st.config, st.caps, gt, tpad(seeds, B), salt)
    for a, b in zip(bt, bf):
        for f in INT_FIELDS + ("weight",):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_tiny_weighted_graph_samples_like_the_reference():
    """The two-vertex weighted graph that the port used to refuse: LABOR
    with an importance iteration and LADIES sample it as repro does."""
    indptr, indices, w = [0, 1, 2], [1, 0], [0.5, 2.0]
    gj = JG.Graph(jnp.asarray(indptr, jnp.int32),
                  jnp.asarray(indices, jnp.int32), jnp.asarray(w))
    gt = TG.Graph(torch.tensor(indptr, dtype=torch.int32),
                  torch.tensor(indices, dtype=torch.int32), torch.tensor(w))
    seeds = np.array([0, 1], np.int32)
    caps = TS.suggest_caps(2, (1,), 1.0, 1)[0]
    jcaps = JS.suggest_caps(2, (1,), 1.0, 1)[0]
    bj = JL.sample_layer(gj, jnp.asarray(seeds), jnp.uint32(3), 1, jcaps,
                         importance_iters=1)
    bt = TL.sample_layer(gt, torch.as_tensor(seeds), 3, 1, caps,
                         importance_iters=1)
    _same_blocks([bj], [bt])
    bj = JD.sample_layer_ladies(gj, jnp.asarray(seeds), jnp.uint32(3), 1,
                                jcaps)
    bt = TD.sample_layer_ladies(gt, torch.as_tensor(seeds), 3, 1, caps)
    _same_blocks([bj], [bt])
