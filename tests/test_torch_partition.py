"""The multi-device engine's pure functions against repro's, in process,
on the CPU (``generate`` mini graph, 2,000 vertices):

  * ``partition_graph`` (P = 3, 4), ``partition_features``,
    ``part_graph`` and the ownership maps, array for array;
  * ``suggest_peer_caps``, ``SamplerSpec.peer_caps`` and its doubling,
    ``from_dataset(num_parts=)``;
  * ``request_layout`` in both owner modes, with and without overflow,
    bit for bit;
  * the int8 quantiser bit for bit;
  * ``build_block_dense`` against ``build_block`` (repro's bit-exactness
    oracle) and against repro's ``build_block``;
  * LABOR's ``_scatter_max_c`` and ``_exact_k_include_dense`` against
    repro's and against ``segment_select``;
  * every registry sampler's ``sample_layer_partitioned`` with no mesh
    (one partition of four, seeds drawn with numpy from a seed) against
    repro's with no axis: the integer fields bit for bit, the weights
    within 1e-6 relative;
  * the dense modes with no mesh (LABOR-1's and LADIES's dense per-vertex
    state) giving the candidate-frontier layer bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import interface as JI  # noqa: E402
from repro.core import labor as JL  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import feature_exchange as jfx  # noqa: E402
from repro.graph import csr as JG  # noqa: E402
from repro.graph import partition as jpart  # noqa: E402
from repro.graph.generators import DatasetSpec as JSpec  # noqa: E402
from repro.graph.generators import generate as jgen  # noqa: E402
from repro_torch.core import interface as TI  # noqa: E402
from repro_torch.core import labor as TL  # noqa: E402
from repro_torch.core import ladies as TLd  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import feature_exchange as tfx  # noqa: E402
from repro_torch.graph import csr as TG  # noqa: E402
from repro_torch.graph import partition as tpart  # noqa: E402
from repro_torch.graph.generators import DatasetSpec as TSpec  # noqa: E402
from repro_torch.graph.generators import generate as tgen  # noqa: E402
from repro_torch.ops import frontier as tops  # noqa: E402

MINI = ("mini", 2000, 12.0, 16, 5, 0.5, 0.2, 0.6, 1000)
SAMPLERS = ("ns", "labor-0", "labor-1", "labor-*", "labor-d", "ladies",
            "pladies", "full")
P, PART, S = 4, 1, 48


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def dsets():
    return tgen(TSpec(*MINI), seed=0), jgen(JSpec(*MINI), seed=0)


@pytest.mark.parametrize("parts", [3, 4])
def test_partition_graph_matches_the_reference(dsets, parts):
    dt, dj = dsets
    t = tpart.partition_graph(dt.graph, parts)
    j = jpart.partition_graph(dj.graph, parts)
    for f in ("indptr", "indices", "local_counts", "edge_counts"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
    assert t.num_vertices == j.num_vertices
    v = np.arange(t.num_vertices)
    np.testing.assert_array_equal(t.owner(v), j.owner(v))
    np.testing.assert_array_equal(t.local_id(v), j.local_id(v))
    for p in range(parts):
        gt, gj = t.part_graph(p), j.part_graph(p)
        np.testing.assert_array_equal(gt.indptr.numpy(), _np(gj.indptr))
        np.testing.assert_array_equal(gt.indices.numpy(), _np(gj.indices))
        ptr, idx = tpart.partition_part(dt.graph, parts, p)
        np.testing.assert_array_equal(ptr, j.indptr[p])
        np.testing.assert_array_equal(idx, j.indices[p, :j.edge_counts[p]])


def test_partition_features_and_rows(dsets):
    dt, _ = dsets
    feats = np.asarray(dt.features)
    t = tpart.partition_features(feats, P)
    np.testing.assert_array_equal(t, jpart.partition_features(feats, P))
    labels = np.asarray(dt.labels)
    for p in range(P):
        rows = tpart.partition_rows(labels, P, p)
        np.testing.assert_array_equal(rows[: len(labels[p::P])],
                                      labels[p::P])


def test_peer_caps_and_their_doubling(dsets):
    dt, dj = dsets
    caps = TI.suggest_caps(32, (4, 3), 12.0, 60)
    jcaps = JI.suggest_caps(32, (4, 3), 12.0, 60)
    for parts, safety in ((2, 2.0), (4, 3.0), (8, 1.6)):
        assert (TI.suggest_peer_caps(32, caps, parts, safety)
                == JI.suggest_peer_caps(32, jcaps, parts, safety))
    for name in SAMPLERS:
        ls = (256, 192) if "ladies" in name else None
        t = TS.from_dataset(name, dt, batch_size=32, fanouts=(4, 3),
                            safety=3.0, layer_sizes=ls, num_parts=P)
        j = JS.from_dataset(name, dj, batch_size=32, fanouts=(4, 3),
                            safety=3.0, layer_sizes=ls, num_parts=P)
        assert t.spec.peer_caps == j.spec.peer_caps, name
        assert t.doubled().spec.peer_caps == j.doubled().spec.peer_caps
        assert ([dataclasses.astuple(c) for c in t.doubled().caps]
                == [dataclasses.astuple(c) for c in j.doubled().caps])
    with pytest.raises(ValueError, match="peer_caps"):
        TI.SamplerSpec("x", (1,), caps[:1], peer_caps=(8,))
    assert TS.from_dataset("ns", dt, batch_size=32,
                           fanouts=(4, 3)).spec.peer_caps is None


@pytest.mark.parametrize("mode", ["mod", "range"])
@pytest.mark.parametrize("cap", [96, 5])
def test_request_layout_bit_exact(mode, cap):
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 400, size=300).astype(np.int32)
    t = tfx.request_layout(torch.from_numpy(ids), P, cap, 100, mode)
    j = jfx.request_layout(jnp.asarray(ids), P, cap, 100, owner_mode=mode)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert bool(t[2]) == (cap == 5)
    with pytest.raises(ValueError, match="owner_mode"):
        tfx.request_layout(torch.from_numpy(ids), P, cap, 100, "rows")


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4, 0.0])
def test_int8_quantiser_bit_exact(scale):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(7, 33)) * scale).astype(np.float32)
    qt, st = tcomp._quant_int8(torch.from_numpy(x))
    qj, sj = jcomp._quant_int8(jnp.asarray(x))
    np.testing.assert_array_equal(qt.numpy(), _np(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(tcomp._dequant_int8(qt, st).numpy(),
                                  _np(jcomp._dequant_int8(qj, sj)))


def _seeds():
    """Seeds owned by partition PART of P: global ids, their local rows."""
    rng = np.random.default_rng(11)
    n = -(-MINI[1] // P)
    rows = np.sort(rng.choice(len(range(PART, MINI[1], P)), S,
                              replace=False))
    seeds = (rows * P + PART).astype(np.int32)
    return seeds, rows.astype(np.int32), n


def _block_fields(bt, bj, ctx):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(bt, f).numpy(), _np(getattr(bj, f)), err_msg=f"{ctx} {f}")
    np.testing.assert_allclose(bt.weight.numpy(), _np(bj.weight), rtol=1e-6,
                               err_msg=f"{ctx} weight")


def test_build_block_dense_matches_build_block(dsets):
    dt, dj = dsets
    caps = TI.suggest_caps(S, (5,), 12.0, 60)[0]
    seeds, _, _ = _seeds()
    ts = TI.pad_seeds(seeds, S)
    exp = TG.expand_seed_edges(dt.graph, ts, caps.expand_cap)
    inc, inv_p = (TL.layer_inclusion(dt.graph, ts, 5, 5, caps)[1:])
    dense = TI.build_block_dense(dt.graph.num_vertices, ts, exp, inc,
                                 inv_p, caps)
    fast = TI.build_block(ts, exp, inc, inv_p, caps)
    for f in INT_FIELDS:
        assert torch.equal(getattr(dense, f), getattr(fast, f)), f
    assert torch.equal(dense.weight, fast.weight)
    jcaps = JI.LayerCaps(*dataclasses.astuple(caps))
    jexp = JG.expand_seed_edges(dj.graph, jnp.asarray(ts.numpy()),
                                caps.expand_cap)
    jb = jax.jit(JI.build_block, static_argnames=("caps",))(
        jnp.asarray(ts.numpy()), jexp, jnp.asarray(inc.numpy()),
        jnp.asarray(inv_p.numpy()), caps=jcaps)
    _block_fields(dense, jb, "dense vs repro build_block")


def test_build_block_dense_keeps_vertex_zero():
    """Vertex 0 sampled next to masked edges: the port's dense epilogue
    gives build_block's block (repro's build_block_dense drops vertex 0
    here: its membership scatter writes the masked edges' False to row
    0, ROADMAP §C5)."""
    src, dst = np.array([0, 2, 0, 3]), np.array([5, 5, 6, 6])
    caps = TI.LayerCaps(16, 16, 16)
    ts = torch.tensor([5, 6, -1, -1], dtype=torch.int32)
    g = TG.from_coo(src, dst, 8)
    exp = TG.expand_seed_edges(g, ts, 16)
    ones = torch.ones(16)
    dense = TI.build_block_dense(8, ts, exp, exp["mask"], ones, caps)
    fast = TI.build_block(ts, exp, exp["mask"], ones, caps)
    for f in INT_FIELDS:
        assert torch.equal(getattr(dense, f), getattr(fast, f)), f
    jexp = JG.expand_seed_edges(JG.from_coo(src, dst, 8),
                                jnp.asarray(ts.numpy()), 16)
    jb = JI.build_block(jnp.asarray(ts.numpy()), jexp, jexp["mask"],
                        jnp.ones(16, jnp.float32),
                        JI.LayerCaps(16, 16, 16))
    _block_fields(dense, jb, "vertex 0")
    assert dense.next_seeds[:7].tolist() == [5, 6, -1, -1, 0, 2, 3]


def test_scatter_max_and_exact_k_dense(dsets):
    dt, dj = dsets
    caps = TI.suggest_caps(S, (5,), 12.0, 60)[0]
    seeds, _, _ = _seeds()
    ts = TI.pad_seeds(seeds, S)
    exp = TG.expand_seed_edges(dt.graph, ts, caps.expand_cap)
    rng = np.random.default_rng(5)
    c = rng.random(exp["src"].shape[0]).astype(np.float32)
    V = dt.graph.num_vertices
    np.testing.assert_array_equal(
        TL._scatter_max_c(torch.from_numpy(c), exp["src"], exp["mask"],
                          V).numpy(),
        _np(JL._scatter_max_c(jnp.asarray(c), jnp.asarray(exp["src"]),
                              jnp.asarray(exp["mask"]), V)))
    r = torch.from_numpy(rng.random(c.shape[0]).astype(np.float32))
    for k in (1, 3, 7):
        dense = TL._exact_k_include_dense(r, exp, k)
        fast = TL._exact_k_include(r, exp, k)
        assert torch.equal(dense, fast), k
        j = JL._exact_k_include_dense(
            jnp.asarray(r.numpy()), jnp.asarray(exp["seed_slot"]),
            jnp.asarray(exp["mask"]), jnp.asarray(exp["deg"]),
            jnp.asarray(exp["seg_start"]), k, S, c.shape[0])
        np.testing.assert_array_equal(dense.numpy(), _np(j))
    assert tops.compact(torch.ones(3, dtype=torch.bool), 3)[2] == 3


@pytest.fixture(scope="module")
def partitions(dsets):
    dt, dj = dsets
    pt = tpart.partition_graph(dt.graph, P)
    pj = jpart.partition_graph(dj.graph, P)
    return pt.part_graph(PART), pj.part_graph(PART)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sample_layer_partitioned_matches_the_reference(dsets, partitions,
                                                        name):
    dt, dj = dsets
    gt, gj = partitions
    ls = (96, 64) if "ladies" in name else None
    st = TS.from_dataset(name, dt, batch_size=S, fanouts=(4, 3),
                         safety=3.0, layer_sizes=ls, num_parts=P)
    sj = JS.from_dataset(name, dj, batch_size=S, fanouts=(4, 3),
                         safety=3.0, layer_sizes=ls, num_parts=P)
    seeds, rows, n = _seeds()
    salt = 0x9E3779B9
    # the deeper layer: its seed buffer is the first layer's vertex cap
    cap = st.caps[0].vertex_cap
    ts = TI.pad_seeds(seeds, cap)
    tr = TI.pad_seeds(rows, cap)
    bt = st.sample_layer_partitioned(gt, ts, salt, 1, seed_rows=tr,
                                     num_vertices=P * n)
    fn = jax.jit(lambda g, s, r: sj.sample_layer_partitioned(
        g, s, jnp.uint32(salt), 1, seed_rows=r, num_vertices=P * n))
    bj = fn(gj, jnp.asarray(ts.numpy()), jnp.asarray(tr.numpy()))
    _block_fields(bt, bj, name)
    assert not bool(bt.overflow)


@pytest.mark.parametrize("name", ["labor-1", "labor-*", "pladies"])
def test_dense_mode_gives_the_candidate_layer(dsets, name):
    """The dense per-vertex layout of a rank (no mesh) samples the same
    layer as the candidate frontier, field for field."""
    dt, _ = dsets
    seeds, _, _ = _seeds()
    ts = TI.pad_seeds(seeds, S)
    g = dt.graph
    st = TS.from_dataset(name, dt, batch_size=S, fanouts=(4,), safety=3.0,
                         layer_sizes=(96,) if "ladies" in name else None)
    caps = st.caps[0]
    if name == "pladies":
        cand = TLd.sample_layer_ladies(g, ts, 77, 96, caps, poisson=True)
        dense = TLd.sample_layer_ladies(g, ts, 77, 96, caps, poisson=True,
                                        dense=True)
        assert torch.equal(cand.next_seeds, dense.next_seeds)
        assert torch.equal(cand.src, dense.src)
        return
    iters = 1 if name == "labor-1" else TL.CONVERGE
    exp = TG.expand_seed_edges(g, ts, caps.expand_cap)
    pc, cc = TL.run_importance_iterations(g, exp, 4, S, iters)
    pd, cd = TL.run_importance_iterations(g, exp, 4, S, iters, dense=True)
    assert torch.equal(pc[exp["mask"]], pd[exp["mask"]])
    assert torch.equal(cc, cd)
