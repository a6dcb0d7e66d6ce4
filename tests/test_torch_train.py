"""The training slice of repro_torch against repro on the CPU:

  * ``optim.adam.apply_updates`` with global-norm clipping, three steps:
    parameters and moments to rtol 1e-6 / atol 1e-9 (float32 ``pow``
    of the bias corrections may differ in the last bit);
  * ``rng.uniform`` and ``models.gnn.gcn_init`` bit for bit against
    ``jax.random.uniform`` and repro's ``gcn_init``;
  * ``SeedBatches.at`` and ``epoch`` bit for bit;
  * one ``TrainEngine.step`` (products 0.004, batch 64, fanouts 5,5,5,
    hidden 32) for LABOR-0 and NS: the gradients, the loss, the grad
    norm and the updated parameters and moments to rtol 1e-5 / atol
    1e-6 (three fp32 layers, sums in another order);
  * the verify-skill surface on both launchers with the same ``--seed``
    (``--dataset flickr --scale 0.02 --fanouts 5,5 --batch-size 128
    --steps 8``) for every registry entry (``labor-0``, ``ns``,
    ``labor-1``, ``labor-*``, ``labor-d``, ``ladies``, ``pladies``,
    ``full``): the same JSON keys, the
    same ``avg_sampled_vertices`` and overflow counts, ``final_loss``
    within atol 1e-5 + rtol 1e-3 (eight Adam steps in fp32, a loss that
    falls towards 1e-4 where the relative error grows);
  * under forced tiny caps, the same replays, retries and sampled
    vertices per step;
  * the port's modules load neither jax nor repro.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP threads spinning against them slow every worker several-fold
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import samplers as JS  # noqa: E402
from repro.core.interface import pad_seeds as jpad  # noqa: E402
from repro.data.gnn_loader import SeedBatches as JBatches  # noqa: E402
from repro.graph.generators import paper_dataset as jds  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import engine as jeng  # noqa: E402
from repro.runtime import trainer as jtrain  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import pad_seeds as tpad  # noqa: E402
from repro_torch.data.gnn_loader import SeedBatches as TBatches  # noqa: E402
from repro_torch.graph.generators import paper_dataset as tds  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import engine as teng  # noqa: E402
from repro_torch.runtime import trainer as ttrain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _kd(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_adam_apply_updates_with_clipping():
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "wr": (3, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg_j, cfg_t = jadam.AdamConfig(lr=1e-2), tadam.AdamConfig(lr=1e-2)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    sj, st = jadam.init_state(pj, cfg_j), tadam.init_state(pt, cfg_t)
    for step in range(3):
        # norms 30x and 0.1x the clip: clipped, then not
        scale = 30.0 if step < 2 else 0.02
        g = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        pj, sj, mj = jadam.apply_updates(
            pj, {k: jnp.asarray(v) for k, v in g.items()}, sj, cfg_j)
        pt, st, mt = tadam.apply_updates(
            pt, {k: torch.as_tensor(v) for k, v in g.items()}, st, cfg_t)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        assert int(st["step"]) == int(sj["step"]) == step + 1
        for k in shapes:
            for a, b in ((pt[k], pj[k]), (st["mu"][k], sj["mu"][k]),
                         (st["nu"][k], sj["nu"][k])):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_uniform_and_gcn_init_bit_exact(seed):
    k = jax.random.key(seed)
    for shape, lo, hi in (((100, 256), -0.13, 0.13), ((33,), 0.0, 1.0),
                          ((256, 47), -2.5, 0.5)):
        want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
        got = TR.uniform(_kd(k), shape, lo, hi).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    pj = jgnn.gcn_init(k, 100, 256, 47, 3)
    model = tgnn.gcn_init(TR.key(seed), 100, 256, 47, 3, device="cpu")
    for layer, lj in zip(model.layers, pj["layers"]):
        for name in ("w", "b", "wr"):
            want = np.asarray(lj[name])
            got = getattr(layer, name).detach().numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32), err_msg=name)


def test_seed_batches_at_and_epoch_bit_exact():
    idx = np.random.default_rng(1).permutation(1000)[:333]
    bj, bt = JBatches(idx, 64, seed=9), TBatches(idx, 64, seed=9)
    assert bt.per_epoch == bj.per_epoch == 5
    for step in (0, 1, 4, 5, 11, 3):        # crosses epochs, goes back
        got = bt.at(step)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(bj.at(step)))
    for a, b in zip(JBatches(idx, 64, seed=2, drop_last=False).epoch(),
                    TBatches(idx, 64, seed=2, drop_last=False).epoch()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def products():
    return jds("products", 0.004, seed=0), tds("products", 0.004, seed=0)


@pytest.mark.parametrize("sampler", ["labor-0", "ns"])
def test_one_train_step(products, sampler):
    dj, dt = products
    kw = dict(batch_size=64, fanouts=(5, 5, 5))
    sj, st = JS.from_dataset(sampler, dj, **kw), TS.from_dataset(
        sampler, dt, **kw)
    n_cls = int(dj.labels.max()) + 1
    pj = jgnn.gcn_init(jax.random.key(3), 100, 32, n_cls, 3)
    model = tgnn.gcn_init(TR.key(3), 100, 32, n_cls, 3, device="cpu")
    ej = jeng.TrainEngine(sj, jgnn.gcn_apply, jadam.AdamConfig(),
                          backend="xla")
    et = teng.TrainEngine(st, tadam.AdamConfig(), device="cpu")
    data_j, data_t = ej.make_data_from_dataset(dj), et.make_data_from_dataset(dt)
    seeds = dj.train_idx[:60]
    sdj, sdt = jpad(jnp.asarray(seeds), 64), tpad(seeds, 64)
    key, kt = jax.random.fold_in(jax.random.key(1), 0), TR.fold_in(TR.key(1), 0)

    # gradients of the loss on the same blocks
    blocks = sj.sample_with_key(dj.graph, sdj, key)
    feats = jeng.gather_feats(data_j.features, blocks[-1])
    labels = data_j.labels[jnp.where(sdj >= 0, sdj, 0)]
    # jitted with the blocks as arguments: eager autodiff compiles op by
    # op, and blocks closed over as constants get folded at compile time
    (lj, aj), gj = jax.jit(jax.value_and_grad(
        lambda p, b, x, y: jeng.gnn_loss_fn(jgnn.gcn_apply, p, b, x, y,
                                            "xla"), has_aux=True))(
        pj, blocks, feats, labels)
    tb, tf = et.sample_batch(data_t, sdt, kt)
    lt, at = teng.gnn_loss_fn(model, tb, tf,
                              teng.seed_labels(data_t.labels, sdt), et.backend)
    gt = torch.autograd.grad(lt, list(model.parameters()))
    np.testing.assert_allclose(float(lt.detach()), float(lj), **STEP_TOL)
    assert float(at) == pytest.approx(float(aj))
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, gt):
        _, i, leaf = name.split(".")
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(gj["layers"][int(i)][leaf]),
                                   err_msg=name, **STEP_TOL)

    # one step of each engine from the same parameters
    p_before = jax.tree.map(np.asarray, pj)
    pj2, sj2, mj = ej.step(pj, ej.init_state(pj), data_j, sdj, key)
    model, st2, mt = et.step(model, et.init_state(model), data_t, sdt, kt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               **STEP_TOL)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), **STEP_TOL)
    assert int(mt["sampled_v"]) == int(mj["sampled_v"])
    assert int(mt["sampled_e"]) == int(mj["sampled_e"])
    np.testing.assert_array_equal(mt["overflow"].numpy(),
                                  np.asarray(mj["overflow"]))
    for name, p in model.named_parameters():
        _, i, leaf = name.split(".")
        want = np.asarray(pj2["layers"][int(i)][leaf])
        assert not np.array_equal(want, p_before["layers"][int(i)][leaf])
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=name,
                                   **STEP_TOL)
        np.testing.assert_allclose(
            st2.opt["mu"][name].numpy(),
            np.asarray(sj2.opt["mu"]["layers"][int(i)][leaf]), **STEP_TOL)
    assert int(st2.opt["step"]) == int(sj2.opt["step"]) == 1


SURFACE = ["--dataset", "flickr", "--scale", "0.02", "--fanouts", "5,5",
           "--batch-size", "128", "--steps", "8", "--seed", "3"]


@pytest.mark.parametrize("sampler", ["labor-0", "ns", "labor-1", "labor-*",
                                     "labor-d", "ladies", "pladies", "full"])
def test_launchers_print_the_same_report(sampler, monkeypatch, capsys):
    from repro.launch import train as jlaunch
    from repro_torch.launch import train as tlaunch
    args = SURFACE + ["--sampler", sampler]
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


@pytest.mark.parametrize("sampler", ["labor-0", "ns"])
def test_forced_tiny_caps_replay_like_the_reference(sampler):
    """cap_safety 0.2 overflows the first batches: both trainers gate,
    replay one step late and grow the caps the same number of times."""
    dj, dt = jds("flickr", 0.02, seed=0), tds("flickr", 0.02, seed=0)
    kw = dict(fanouts=(5, 5), sampler=sampler, batch_size=128, steps=6,
              seed=0, cap_safety=0.2)
    oj = jtrain.train_gnn(dj, jtrain.GNNTrainConfig(**kw))
    ot = ttrain.train_gnn(dt, ttrain.GNNTrainConfig(device="cpu", **kw))
    assert ot["stats"].overflow_replays == oj["stats"].overflow_replays >= 1
    assert ot["stats"].overflow_retries == oj["stats"].overflow_retries >= 1
    for a, b in zip(oj["history"], ot["history"]):
        assert (b["sampled_v"], b["sampled_e"]) == (a["sampled_v"],
                                                    a["sampled_e"])
        assert abs(b["loss"] - a["loss"]) <= 1e-5 + 1e-4 * abs(a["loss"])


def test_cuda_is_the_default_and_unported_options_raise():
    from repro_torch.launch import train as tlaunch
    assert tlaunch.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tlaunch.main(SURFACE)
    for kw in (dict(guard="rollback"), dict(pipeline="full"),
               dict(mesh_devices=4), dict(ckpt_dir="ck")):
        with pytest.raises(NotImplementedError):
            ttrain.GNNTrainConfig(**kw)
    with pytest.raises(ValueError, match="unknown model"):
        ttrain.GNNTrainConfig(model="gin")
    with pytest.raises(SystemExit, match="not ported"):
        tlaunch.main(["--workload", "lm", "--device", "cpu"])


def test_port_modules_load_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "import repro_torch.runtime.trainer, repro_torch.ops.cuda\n"
        "import repro_torch.kernels.frontier.ops, repro_torch.optim.adam\n"
        "import repro_torch.core.ladies, repro_torch.core.variance\n"
        "import repro_torch.core.samplers, repro_torch.core.cs_solve\n"
        "import repro_torch.kernels.edge_softmax.ops, repro_torch.models.gnn\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
