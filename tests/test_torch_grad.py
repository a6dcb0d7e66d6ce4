"""The gradients of ``repro_torch.ops.aggregate`` against ``jax.grad`` of
``repro.ops.aggregate`` on both of repro's backends (``xla`` autodiff and
the Pallas custom VJP in interpret mode), on the three LABOR-0 blocks of
one batch (products 0.004, batch 64, fanouts 5,5,5), for the port's two
backends:

  * ``eager``: plain autograd through the plain SpMM;
  * the ``cuda`` backend's ``torch.autograd.Function`` run on CPU
    tensors, where its wrappers run their plain versions: the gradient
    for h goes through the transposed SpMM (edges permuted by
    ``src_perm``, roles swapped), the gradient for the edge weights
    through the SDDMM with ``gather_dst``.

rtol = atol = 1e-5: the sums run in another order than XLA's. Also the
forward parity of ``gather_dst`` and ``sddmm(op="dot")``, and which
backward pieces run for which input.
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

from repro import ops as O  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro_torch import ops as TO  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.kernels.spmm import ref as sref  # noqa: E402
from repro_torch.ops import cuda as tcuda  # noqa: E402

F = 32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def blocks():
    dj, dt = jds("products", 0.004, seed=4), tds("products", 0.004, seed=4)
    kw = dict(batch_size=64, fanouts=(5, 5, 5))
    sj, st = JS.from_dataset("labor-0", dj, **kw), TS.from_dataset(
        "labor-0", dt, **kw)
    seeds = dj.val_idx[:61]
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), 64),
                            jax.random.key(5))
    bt = st.sample_with_key(dt.graph, tpad(seeds, 64), TR.key(5))
    assert not any(bool(b.overflow) for b in bt)
    return bj, bt


def _inputs(blk, layer):
    rng = np.random.default_rng(100 + layer)
    h = rng.normal(size=(blk.next_cap, F)).astype(np.float32)
    c = rng.normal(size=(blk.seed_cap, F)).astype(np.float32)
    return h, c


def _jax_grads(bj, h, c, backend):
    # jitted, with the block as an argument (not a folded constant)
    def loss(h_, w_, b, c_):
        b = dataclasses.replace(b, weight=w_)
        return jnp.sum(O.aggregate(b, h_, backend=backend) * c_)

    gh, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(h), bj.weight, bj, jnp.asarray(c))
    return np.asarray(gh), np.asarray(gw)


def _torch_grads(bt, h, c, aggregate):
    ht = torch.tensor(h, requires_grad=True)
    wt = bt.weight.clone().requires_grad_()
    b = dataclasses.replace(bt, weight=wt)
    out = aggregate(b, ht)
    torch.sum(out * torch.as_tensor(c)).backward()
    return ht.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_aggregate_grads_match_jax(blocks, layer, jax_backend):
    bj, bt = blocks[0][layer], blocks[1][layer]
    h, c = _inputs(bt, layer)
    gh, gw = _jax_grads(bj, h, c, jax_backend)
    for name, agg in (("eager", lambda b, x: TO.aggregate(b, x,
                                                          backend="eager")),
                      ("cuda-function", tcuda.aggregate)):
        th, tw = _torch_grads(bt, h, c, agg)
        np.testing.assert_allclose(th, gh, err_msg=f"{name} dh", **TOL)
        np.testing.assert_allclose(tw, gw, err_msg=f"{name} dweight", **TOL)


def test_backward_runs_only_what_is_asked(blocks, monkeypatch):
    """The transposed SpMM runs only for an h that needs a gradient (not
    for the first GCN layer's features); the SDDMM only for weights
    that need one."""
    calls = []
    for name in ("spmm_transposed_ref", "gather_dst_ref"):
        fn = getattr(sref, name)
        monkeypatch.setattr(sref, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    bt = blocks[1][1]
    h, c = _inputs(bt, 1)
    for h_grad, w_grad, want in ((True, False, ["spmm_transposed_ref"]),
                                 (False, True, ["gather_dst_ref"]),
                                 (True, True, ["spmm_transposed_ref",
                                               "gather_dst_ref"])):
        calls.clear()
        ht = torch.tensor(h, requires_grad=h_grad)
        wt = bt.weight.clone().requires_grad_(w_grad)
        out = tcuda.aggregate(dataclasses.replace(bt, weight=wt), ht)
        torch.sum(out * torch.as_tensor(c)).backward()
        assert calls == want


def test_transposed_spmm_sees_a_sorted_prefix(blocks):
    """The kernel's contract after the permutation: the first num_edges
    entries of src_slot[src_perm] are non-decreasing and masked in."""
    for blk in blocks[1]:
        n = int(blk.num_edges)
        p = blk.src_perm.long()
        assert blk.edge_mask[p][:n].all() and not blk.edge_mask[p][n:].any()
        assert (np.diff(blk.src_slot[p][:n].numpy()) >= 0).all()


@pytest.mark.parametrize("layer", [0, 2])
def test_gather_dst_and_sddmm_forward_parity(blocks, layer):
    bj, bt = blocks[0][layer], blocks[1][layer]
    rng = np.random.default_rng(layer)
    u = rng.normal(size=(bt.seed_cap, F)).astype(np.float32)
    v = rng.normal(size=(bt.next_cap, F)).astype(np.float32)
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    for jb in ("xla", "pallas"):
        want = np.asarray(O.gather_dst(bj, jnp.asarray(u), backend=jb))
        np.testing.assert_array_equal(TO.gather_dst(bt, ut).numpy(), want)
        np.testing.assert_array_equal(tcuda.gather_dst(bt, ut).numpy(), want)
        want = np.asarray(O.sddmm(bj, jnp.asarray(u), jnp.asarray(v),
                                  op="dot", backend=jb))
        np.testing.assert_allclose(
            TO.sddmm(bt, ut, vt, op="dot").numpy(), want, **TOL)
    with pytest.raises(NotImplementedError):
        tcuda.gather_dst(bt, ut.clone().requires_grad_())
    with pytest.raises(NotImplementedError):
        TO.sddmm(bt, ut, vt, op="add")
