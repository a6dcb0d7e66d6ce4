"""GraphSAGE and GATv2 in repro_torch against repro on the CPU
(products 0.004, LABOR-0, batch 64, fanouts 5,5, hidden 32):

  * the per-edge primitives ``scatter_edges``, ``gather_dst``,
    ``gather_src``, ``sddmm(op="add")`` and ``edge_softmax`` (2 and 8
    heads), forward and gradient, against ``jax.grad`` on repro's ``xla``
    and ``pallas`` (interpret) backends, for the port's ``eager`` backend
    and for its ``cuda`` backend's autograd Functions on CPU tensors
    (their wrappers run the plain versions: the backward of
    ``gather_src`` is the per-edge scatter through ``src_perm``, that of
    ``edge_softmax`` the segment-softmax Jacobian). rtol = atol = 1e-5:
    the sums run in another order than XLA's. Plus the extreme logit
    spread of repro's own softmax regression test;
  * ``rng.normal`` against ``jax.random.normal`` to 1e-6 relative (not
    bit for bit: XLA's ``log1p`` differs in the last bit now and then;
    the share of draws that differ is printed);
  * ``sage_init`` bit for bit, ``gatv2_init`` to 1e-6 relative;
    ``params_from_jax`` for both, logits to 1e-5 and each parameter
    gradient to rtol 1e-4 plus atol 1e-5 of the tensor's largest entry
    (sums over hundreds of edges in another order; entries near 0 come
    out of cancellation);
  * both launchers with ``--model sage|gatv2`` on the verify surface
    (flickr 0.02, fanouts 5,5, batch 128, 8 steps): the same
    ``avg_sampled_vertices`` and overflow counts, ``final_loss`` within
    atol 1e-5 + rtol 1e-3 (eight Adam steps in fp32, as for the GCN);
    and GATv2 served through both serve launchers with the same accuracy.

The reference's gradients are jitted with the block passed as an
argument: closed-over blocks are folded as constants and compile for a
minute.
"""
import json
import sys

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
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch import ops as TO  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.ops import backend as tbackend  # noqa: E402
from repro_torch.ops import cuda as tcuda  # noqa: E402

F = 16
HEADS = (2, 8)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
HIDDEN = 32


@pytest.fixture(scope="module")
def blocks():
    dj, dt = jds("products", 0.004, seed=4), tds("products", 0.004, seed=4)
    kw = dict(batch_size=64, fanouts=(5, 5))
    sj, st = JS.from_dataset("labor-0", dj, **kw), TS.from_dataset(
        "labor-0", dt, **kw)
    seeds = dj.val_idx[:61]
    bj = sj.sample_with_key(dj.graph, jpad(jnp.asarray(seeds), 64),
                            jax.random.key(5))
    bt = st.sample_with_key(dt.graph, tpad(seeds, 64), TR.key(5))
    assert not any(bool(b.overflow) for b in bt)
    feats = np.asarray(dt.features)[bt[-1].next_seeds.clamp(min=0).numpy()]
    feats = feats * (bt[-1].next_seeds >= 0).numpy()[:, None]
    return bj, bt, feats.astype(np.float32)


def _primitive_inputs(blk, layer):
    rng = np.random.default_rng(200 + layer)
    E, S, T = blk.edge_cap, blk.seed_cap, blk.next_cap

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = {"u": arr(S, F), "v": arr(T, F), "vals": arr(E, F)}
    for H in HEADS:
        x[f"logit{H}"] = arr(E, H, scale=3.0)
    # cotangents of each output
    c = {"scatter": arr(S, F), "gdst": arr(E, F), "gsrc": arr(E, F),
         "add": arr(E, F), **{f"sm{H}": arr(E, H) for H in HEADS}}
    return x, c


def _jax_primitives(bj, x, c, backend):
    """Forward outputs and the gradient of sum(out * cotangent) for each
    primitive, one jitted program with the block as an argument."""
    def run(x, c, b):
        outs = {
            "scatter": lambda x: O.scatter_edges(b, x["vals"],
                                                 backend=backend),
            "gdst": lambda x: O.gather_dst(b, x["u"], backend=backend),
            "gsrc": lambda x: O.gather_src(b, x["v"]),
            "add": lambda x: O.sddmm(b, x["u"], x["v"], op="add",
                                     backend=backend),
            **{f"sm{H}": (lambda x, H=H: O.edge_softmax(
                b, x[f"logit{H}"], backend=backend)) for H in HEADS}}
        res = {}
        for name, fn in outs.items():
            out, vjp = jax.vjp(fn, x)
            res[name] = (out, vjp(c[name])[0])
        return res

    res = jax.jit(run)(x, c, bj)
    return jax.tree_util.tree_map(np.asarray, res)


def _torch_primitives(bt, x, c, backend):
    kw = dict(backend=backend)
    outs = {
        "scatter": ("vals", lambda t: TO.scatter_edges(bt, t["vals"], **kw)),
        "gdst": ("u", lambda t: TO.gather_dst(bt, t["u"], **kw)),
        "gsrc": ("v", lambda t: TO.gather_src(bt, t["v"], **kw)),
        "add": (("u", "v"), lambda t: TO.sddmm(bt, t["u"], t["v"], op="add",
                                               **kw)),
        **{f"sm{H}": (f"logit{H}", (lambda t, H=H: TO.edge_softmax(
            bt, t[f"logit{H}"], **kw))) for H in HEADS}}
    res = {}
    for name, (wrt, fn) in outs.items():
        t = {k: torch.tensor(v, requires_grad=True) for k, v in x.items()}
        out = fn(t)
        torch.sum(out * torch.as_tensor(c[name])).backward()
        wrt = (wrt,) if isinstance(wrt, str) else wrt
        res[name] = (out.detach().numpy(),
                     {k: t[k].grad.numpy() for k in wrt})
    return res


@pytest.fixture
def cuda_functions_on_cpu(monkeypatch):
    """The ``cuda`` backend's autograd Functions on CPU tensors: every
    backend but an explicit ``eager`` resolves to ``cuda``, whose
    wrappers run the plain versions on the CPU and launch nothing."""
    monkeypatch.setattr(tbackend, "resolve_backend",
                        lambda name, dev: "eager" if name == "eager"
                        else "cuda")


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_per_edge_primitives_match_jax(blocks, layer, jax_backend,
                                       cuda_functions_on_cpu):
    bj, bt = blocks[0][layer], blocks[1][layer]
    x, c = _primitive_inputs(bt, layer)
    want = _jax_primitives(bj, {k: jnp.asarray(v) for k, v in x.items()},
                           {k: jnp.asarray(v) for k, v in c.items()},
                           jax_backend)
    for backend in ("cuda", "eager"):
        got = _torch_primitives(bt, x, c, backend)
        for name, (out, grads) in got.items():
            w_out, w_grad = want[name]
            np.testing.assert_allclose(out, w_out, **TOL,
                                       err_msg=f"{backend} {name}")
            for k, g in grads.items():
                np.testing.assert_allclose(g, w_grad[k], **TOL,
                                           err_msg=f"{backend} {name} d{k}")


@pytest.mark.parametrize("op", ["dot", "bogus"])
def test_sddmm_ops(blocks, op):
    bt = blocks[1][0]
    u = torch.ones(bt.seed_cap, 3)
    v = torch.ones(bt.next_cap, 3)
    if op == "bogus":
        with pytest.raises(ValueError):
            TO.sddmm(bt, u, v, op=op)
        return
    n = int(bt.num_edges)
    out = TO.sddmm(bt, u, v, op=op)
    assert out.shape == (bt.edge_cap,) and torch.all(out[:n] == 3)


def test_edge_softmax_extreme_logit_spread(blocks, cuda_functions_on_cpu):
    """repro's regression case: one logit of 500 beside normal ones; every
    destination still normalises to 1 in both heads, on both port
    backends, as on both reference backends."""
    bj, bt = blocks[0][0], blocks[1][0]
    rng = np.random.default_rng(8)
    logit = rng.normal(size=(bt.edge_cap, 2)).astype(np.float32)
    first_valid = int(np.flatnonzero(bt.edge_mask.numpy())[0])
    logit[first_valid, 0] = 500.0
    want = [np.asarray(O.edge_softmax(bj, jnp.asarray(logit), backend=b))
            for b in ("xla", "pallas")]
    mask = bt.edge_mask.numpy()
    dst = bt.dst_slot.numpy()[mask]
    for got in (tcuda.edge_softmax(bt, torch.as_tensor(logit)),
                TO.edge_softmax(bt, torch.as_tensor(logit),
                                backend="eager")):
        got = got.numpy()
        for w in want:
            np.testing.assert_allclose(got, w, atol=1e-5)
        sums = np.zeros((bt.seed_cap, 2))
        np.add.at(sums, dst, got[mask])
        np.testing.assert_allclose(sums[np.unique(dst)], 1.0, atol=1e-5)
        assert np.all(got[~mask] == 0)


def test_edge_softmax_refuses_more_than_128_heads(blocks):
    bt = blocks[1][0]
    with pytest.raises(ValueError, match="128 heads"):
        tcuda.edge_softmax(bt, torch.zeros(bt.edge_cap, 129))


@pytest.mark.parametrize("seed,shape", [(0, (20_000,)), (7, (8, 32)),
                                        (3, (1, 47)), (11, (256, 4))])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = TR.normal(TR.key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    print(f"normal {shape}: {np.mean(got != want):.4%} of the draws differ "
          "from jax.random.normal")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _jax_params(name, heads=8):
    init = jgnn.MODELS[name][0]
    kw = dict(heads=heads) if name == "gatv2" else {}
    return init(jax.random.key(3), 100, HIDDEN, 47, 2, **kw)


def test_sage_init_is_bit_exact():
    want = _jax_params("sage")
    got = tgnn.sage_init(TR.key(3), 100, HIDDEN, 47, 2, device="cpu")
    for p, layer in zip(want["layers"], got.layers):
        for k in ("w", "b"):
            np.testing.assert_array_equal(getattr(layer, k).detach().numpy(),
                                          np.asarray(p[k]))


@pytest.mark.parametrize("heads", HEADS)
def test_gatv2_init_matches_jax(heads):
    want = _jax_params("gatv2", heads)
    got = tgnn.gatv2_init(TR.key(3), 100, HIDDEN, 47, 2, heads=heads,
                          device="cpu")
    for p, layer in zip(want["layers"], got.layers):
        for k in ("ws", "wt", "b"):
            np.testing.assert_array_equal(getattr(layer, k).detach().numpy(),
                                          np.asarray(p[k]))
        np.testing.assert_allclose(layer.attn.detach().numpy(),
                                   np.asarray(p["attn"]), rtol=1e-6, atol=0)


def _jax_logits_and_grads(name, params, bj, feats, c, backend):
    apply = jgnn.MODELS[name][1]

    def loss(p, blks):
        out = apply(p, blks, jnp.asarray(feats), backend=backend)
        return jnp.sum(out * c), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, list(bj))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, g)


@pytest.mark.parametrize("name,heads", [("sage", None), ("gatv2", 8)])
def test_params_from_jax_forward_and_gradients(blocks, name, heads,
                                               cuda_functions_on_cpu):
    bj, bt, feats = blocks
    params = _jax_params(name, heads or 8)
    c = np.random.default_rng(4).normal(
        size=(bt[0].seed_cap, 47)).astype(np.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    for jb in ("xla", "pallas"):
        want_out, want_g = _jax_logits_and_grads(name, params, bj, feats,
                                                 jnp.asarray(c), jb)
        for backend in ("cuda", "eager"):
            model = tgnn.params_from_jax(tree, device="cpu", model=name)
            out = model(bt, torch.as_tensor(feats), backend=backend)
            torch.sum(out * torch.as_tensor(c)).backward()
            np.testing.assert_allclose(out.detach().numpy(), want_out,
                                       err_msg=f"{backend} vs {jb}", **TOL)
            for i, (layer, p) in enumerate(zip(model.layers,
                                               want_g["layers"])):
                for k, param in layer.named_parameters():
                    np.testing.assert_allclose(
                        param.grad.numpy(), p[k], rtol=GRAD_RTOL,
                        atol=GRAD_ATOL * np.abs(p[k]).max(),
                        err_msg=f"{backend} vs {jb}: layer {i} d{k}")


SURFACE = ["--dataset", "flickr", "--scale", "0.02", "--fanouts", "5,5",
           "--batch-size", "128", "--steps", "8", "--seed", "3"]


@pytest.mark.parametrize("model", ["sage", "gatv2"])
def test_train_launchers_agree(model, monkeypatch, capsys):
    from repro.launch import train as jlaunch
    from repro_torch.launch import train as tlaunch
    args = SURFACE + ["--model", model]
    monkeypatch.setattr(sys, "argv", ["train", "--workload", "gnn"] + args)
    jlaunch.main()
    ref = json.loads(capsys.readouterr().out)
    report = tlaunch.main(args + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out == report and set(out) == set(ref)
    assert out["avg_sampled_vertices"] == ref["avg_sampled_vertices"]
    for k in ("overflow_retries", "overflow_replays", "stragglers_skipped"):
        assert out[k] == ref[k], k
    assert abs(out["final_loss"] - ref["final_loss"]) <= (
        1e-5 + 1e-3 * abs(ref["final_loss"]))


def test_gatv2_serves_like_the_reference(monkeypatch, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    args = ["--workload", "gnn", "--driver", "off", "--dataset", "products",
            "--scale", "0.004", "--sampler", "labor-0", "--fanouts", "5,5",
            "--hidden", "32", "--batch", "64", "--requests", "2",
            "--model", "gatv2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    ref = json.loads(capsys.readouterr().out)
    report = tserve.main(args + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(ref) and out == report
    for k in ("requests_served", "sampler", "accuracy", "grow_events"):
        assert out[k] == ref[k], k


def test_models_registry_and_config():
    from repro_torch.runtime.trainer import GNNTrainConfig
    assert sorted(tgnn.MODELS) == sorted(jgnn.MODELS)
    for name in tgnn.MODELS:
        GNNTrainConfig(model=name, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        GNNTrainConfig(model="gin", device="cpu")
    with pytest.raises(ValueError):
        tgnn.params_from_jax(
            {"layers": [{"w": np.zeros((4, 3)), "b": np.zeros(3)},
                        {"w": np.zeros((8, 5)), "b": np.zeros(5)}]},
            device="cpu", model="sage")
