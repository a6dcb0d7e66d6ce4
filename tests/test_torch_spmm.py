"""``repro_torch.ops.aggregate`` on a sampled block against
``repro.ops.aggregate`` with the ``"xla"`` backend and the Pallas SpMM in
interpret mode, at the paper's two widths (100 input features, 256
hidden), and at 100 on a block whose seed rows are mostly padding.
rtol = atol = 1e-5: the sums run in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import ops as O  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro_torch import ops as TO  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.kernels.spmm import ops as sk  # noqa: E402


@pytest.fixture(scope="module")
def blocks():
    dj, dt = jds("products", 0.004, seed=2), tds("products", 0.004, seed=2)
    kw = dict(batch_size=64, fanouts=(5, 5, 5))
    sj, st = JS.from_dataset("labor-0", dj, **kw), TS.from_dataset(
        "labor-0", dt, **kw)
    seeds = dj.val_idx[:60]
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), 64),
                            jax.random.key(11))
    bt = st.sample_with_key(dt.graph, tpad(seeds, 64), TR.key(11))
    return bj, bt


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("F", [100, 256])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_aggregate_matches_reference(blocks, layer, F, backend):
    bj, bt = blocks[0][layer], blocks[1][layer]
    h = np.random.default_rng(layer * 1000 + F).normal(
        size=(bt.next_cap, F)).astype(np.float32)
    want = np.asarray(O.aggregate(bj, jnp.asarray(h), backend=backend))
    got = TO.aggregate(bt, torch.as_tensor(h))
    assert got.shape == (bt.seed_cap, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def padded_blocks():
    """A batch of 64 seed slots holding 6 real seeds: every layer's
    seed_cap is many times its live rows, the forward kernel's flat
    fill of the rows past the last live key."""
    dj, dt = jds("products", 0.004, seed=2), tds("products", 0.004, seed=2)
    kw = dict(batch_size=64, fanouts=(5, 5, 5))
    sj, st = JS.from_dataset("labor-0", dj, **kw), TS.from_dataset(
        "labor-0", dt, **kw)
    seeds = dj.val_idx[:6]
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), 64),
                            jax.random.key(5))
    bt = st.sample_with_key(dt.graph, tpad(seeds, 64), TR.key(5))
    return bj, bt


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_aggregate_on_padded_seed_rows(padded_blocks, layer, backend):
    bj, bt = padded_blocks[0][layer], padded_blocks[1][layer]
    n = int(bt.num_edges)
    live_rows = int(torch.unique(bt.dst_slot[:n]).numel())
    assert bt.seed_cap >= 4 * live_rows
    h = np.random.default_rng(layer + 77).normal(
        size=(bt.next_cap, 100)).astype(np.float32)
    want = np.asarray(O.aggregate(bj, jnp.asarray(h), backend=backend))
    got = TO.aggregate(bt, torch.as_tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    last = int(bt.dst_slot[n - 1])
    assert not got[last + 1:].any() and not want[last + 1:].any()


def test_cpu_wrapper_is_the_plain_version(blocks):
    blk = blocks[1][1]
    h = torch.randn(blk.next_cap, 100, generator=torch.Generator().manual_seed(0))
    sk.reset_launches()
    got = sk.spmm_block(blk.src_slot, blk.dst_slot, blk.weight,
                        blk.edge_mask, h, blk.seed_cap,
                        n_live=blk.num_edges.reshape(()))
    assert torch.equal(got, TO.aggregate(blk, h, backend="eager"))
    assert sk.LAUNCHES["spmm"] == 0


def test_sampled_block_meets_the_sorted_prefix_contract(blocks):
    """The kernel's contract: valid edges are the prefix [0, num_edges),
    non-decreasing in dst_slot."""
    for blk in blocks[1]:
        n = int(blk.num_edges)
        mask = blk.edge_mask.numpy()
        assert mask[:n].all() and not mask[n:].any()
        assert (np.diff(blk.dst_slot.numpy()[:n]) >= 0).all()
