"""The port's checkpoints (``runtime/checkpoint.py``) and preemption
harness (``runtime/fault_tolerance.py``) against repro's, on the CPU.

  * repro's checkpoint cases on the port: a bf16 round trip, keep-k, no
    ``.tmp`` left behind, meta, a missing leaf, truncation and bit flips
    detected and skipped, a checkpoint without a CRC manifest passing,
    ``torn_ckpt`` skipped on resume, ``ckpt_error`` raised on ``wait()``
    and on the next ``save()``, and an ``AsyncSaver`` snapshot that a
    later in-place update does not reach;
  * one GCN + Adam + guard state (repro's ``gcn_init`` carried across by
    ``params_from_jax``) saved by both packages: the same npz keys in the
    same order, dtypes, shapes and CRC manifest; a checkpoint of either
    package restores into the other bit for bit;
  * a run trained 6 steps under one package and resumed to 10 under the
    other, against the resuming package's own 10-step run: the same
    sampled vertices, losses within ``test_torch_train.py``'s bound
    (atol 1e-5 + rtol 1e-3), for each direction;
  * the engine record: the port writes ``torch_backend`` and ``peer_caps``
    null, refuses another sampler or backend, re-adopts the caps, and
    ignores repro's ``backend``;
  * repro's preempt-and-resume on the port, and a preempted
    ``train_gnn`` resumed by ``run_with_restarts`` equal bit for bit to
    an unpreempted run;
  * both train launchers with ``--ckpt-dir --guard --inject --pipeline``
    print the same report, and a checkpoint the port's launcher wrote
    serves alike on both serve launchers.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph.generators import DatasetSpec as JSpec  # noqa: E402
from repro.graph.generators import generate as jgen  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro.runtime import trainer as jtrain  # noqa: E402
from repro_torch.core import rng as rng_lib  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.graph.generators import DatasetSpec as TSpec  # noqa: E402
from repro_torch.graph.generators import generate as tgen  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import checkpoint as ck  # noqa: E402
from repro_torch.runtime import inject as inject_lib  # noqa: E402
from repro_torch.runtime import trainer as ttrain  # noqa: E402
from repro_torch.runtime.engine import EngineState  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    Preemptor, SimulatedPreemption, run_with_restarts)
from repro_torch.runtime.guard import init_guard_state  # noqa: E402

MINI = ("mini", 2000, 12.0, 16, 5, 0.5, 0.2, 0.6, 1000)
BASE = dict(hidden=16, fanouts=(4, 4), batch_size=64, lr=1e-2,
            cap_safety=3.0)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"layers": [{"w": torch.as_tensor(
            rng.normal(size=(4, 5)), dtype=torch.float32),
            "b": torch.zeros(5, dtype=torch.bfloat16)}]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else
            ([_zeros_like(x) for x in v] if isinstance(v, list)
             else torch.zeros_like(v)) for k, v in tree.items()}


def _leaves(tree):
    return [leaf for _, leaf in ck._leaves(tree)]


# ----------------------------------------------------------------------
# repro's checkpoint cases, on the port
# ----------------------------------------------------------------------

def test_round_trip_with_bf16(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 10, t)
    out = ck.restore(str(tmp_path), 10, _zeros_like(t))
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_latest_keep_k_meta_and_no_tmp(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ck.save(d, s, _tree(), keep=3, meta={"loss": 1.5})
    assert ck.latest_step(d) == 5 and ck.latest_steps(d) == [3, 4, 5]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    m = ck.read_meta(d, 5)
    assert m["step"] == 5 and m["loss"] == 1.5
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))
    assert ck.latest_step(d) == 5          # a stray tmp dir is ignored
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(d, 5, {**_zeros_like(_tree()),
                          "guard": {"ema": torch.zeros(())}})


def test_integrity_manifest_and_corruption_skipped(tmp_path):
    d, t = str(tmp_path), _tree()
    ck.save(d, 4, t)
    assert set(ck.read_meta(d, 4)["integrity"]) == {
        "params///layers///0///w", "params///layers///0///b@bf16",
        "opt///step"}
    ck.verify(d, 4)
    ck.save(d, 5, t)
    ck.save(d, 10, t)
    npz = os.path.join(d, "step_0000000010", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore(d, 10, _zeros_like(t))
    assert ck.latest_good_step(d) == ck.latest_step(d) == 5
    # a bit flip in one array
    path = os.path.join(d, "step_0000000005", "arrays.npz")
    with np.load(path) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["params///layers///0///w"][0, 0] += 1.0
    np.savez(path, **arrays)
    with pytest.raises(ck.CheckpointCorruptError, match="CRC mismatch"):
        ck.verify(d, 5)
    assert ck.latest_step(d) == 4


def test_pre_integrity_checkpoint_passes(tmp_path):
    d = str(tmp_path)
    ck.save(d, 3, _tree())
    mp = os.path.join(d, "step_0000000003", "meta.json")
    with open(mp) as f:
        m = json.load(f)
    del m["integrity"]
    with open(mp, "w") as f:
        json.dump(m, f)
    ck.verify(d, 3)
    assert ck.latest_good_step(d) == 3


def test_torn_ckpt_injector_skipped_on_resume(tmp_path):
    d, plan = str(tmp_path), inject_lib.parse("torn_ckpt@1")
    ck.save(d, 5, _tree(), inject=plan)
    ck.save(d, 10, _tree(), inject=plan)
    assert plan.all_fired() and plan.log == [("torn_ckpt", 1)]
    assert ck.latest_steps(d) == [5, 10] and ck.latest_step(d) == 5


@pytest.mark.parametrize("surface", ["wait", "next save"])
def test_async_saver_error_surfaces(tmp_path, surface):
    d = str(tmp_path)
    saver = ck.AsyncSaver(d, inject=inject_lib.parse("ckpt_error@0"))
    saver.save(10, _tree())
    with pytest.raises(OSError, match="injected checkpoint write"):
        saver.wait() if surface == "wait" else saver.save(20, _tree())
    saver.save(30, _tree())   # the error is cleared once raised
    saver.wait()
    assert ck.latest_step(d) == 30


def test_async_saver_snapshot_owns_its_memory(tmp_path):
    """The engine writes parameters in place: a save in flight must hold
    the values of the moment it was asked for."""
    d, t = str(tmp_path), _tree()
    want = t["params"]["layers"][0]["w"].clone()
    saver = ck.AsyncSaver(d, keep=2)
    saver.save(1, t)
    t["params"]["layers"][0]["w"].add_(1.0)     # the next step, in place
    saver.wait()
    out = ck.restore(d, 1, _zeros_like(t))
    assert torch.equal(out["params"]["layers"][0]["w"], want)


# ----------------------------------------------------------------------
# one state, both packages
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """repro's GCN + Adam + guard state after one Adam update, and the
    port's (model, EngineState) holding the same numbers."""
    pj = jgnn.gcn_init(jax.random.key(5), 16, 16, 5, 2)
    cfg = jadam.AdamConfig(lr=1e-2)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.25), pj)
    pj, oj, _ = jadam.apply_updates(pj, grads, jadam.init_state(pj, cfg),
                                    cfg)
    gj = {"ema": jnp.float32(1.25), "steps": jnp.int32(3)}
    tree_j = {"params": pj, "opt": oj, "guard": gj}
    host = jax.tree.map(np.asarray, tree_j)
    model = tgnn.params_from_jax(host["params"], device="cpu")
    names = [k for k, _ in model.named_parameters()]
    flat = lambda t: {k: torch.as_tensor(np.array(v))
                      for k, v in ck.unnest(t).items()}
    mu, nu = flat(host["opt"]["mu"]), flat(host["opt"]["nu"])
    state = EngineState(
        opt={"mu": {k: mu[k] for k in names}, "nu": {k: nu[k] for k in names},
             "step": torch.as_tensor(np.array(host["opt"]["step"]))},
        guard={k: torch.as_tensor(np.array(v))
               for k, v in host["guard"].items()})
    return tree_j, model, state


def test_both_packages_write_the_same_arrays(tmp_path, states):
    tree_j, model, state = states
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save(dj, 3, tree_j)
    ck.save(dt, 3, ck.state_tree(model, state))
    with np.load(os.path.join(dj, "step_0000000003", "arrays.npz")) as zj, \
            np.load(os.path.join(dt, "step_0000000003", "arrays.npz")) as zt:
        assert zt.files == zj.files
        assert "opt///mu///layers///0///w" in zt.files
        assert {"guard///ema", "guard///steps", "opt///step"} <= set(
            zt.files)
        for k in zj.files:
            assert (zt[k].dtype, zt[k].shape) == (zj[k].dtype, zj[k].shape)
    assert (ck.read_meta(dt, 3)["integrity"]
            == jck.read_meta(dj, 3)["integrity"])


def test_checkpoints_restore_across_packages(tmp_path, states):
    tree_j, model, state = states
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save(dj, 3, tree_j)
    ck.save(dt, 3, ck.state_tree(model, state))
    # repro's checkpoint into a fresh port model and state
    fresh = tgnn.gcn_init(rng_lib.key(9), 16, 16, 5, 2, device="cpu")
    st0 = EngineState(opt=tadam.init_state(
        {k: p.detach() for k, p in fresh.named_parameters()},
        tadam.AdamConfig()), guard=init_guard_state())
    st1 = ck.load_state_tree(fresh, st0, ck.restore(
        dj, 3, ck.state_tree(fresh, st0)))
    for a, b in zip(_leaves(ck.state_tree(fresh, st1)),
                    _leaves(ck.state_tree(model, state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port's checkpoint into repro's structure
    like = jax.tree.map(jnp.zeros_like, tree_j)
    out = jck.restore(dt, 3, like)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(tree_j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------
# training resumed across packages
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def dsets():
    return jgen(JSpec(*MINI), seed=0), tgen(TSpec(*MINI), seed=0)


@pytest.fixture(scope="module")
def ten_steps(dsets):
    dj, dt = dsets
    return (jtrain.train_gnn(dj, jtrain.GNNTrainConfig(
                **BASE, steps=10, eval_every=1000)),
            ttrain.train_gnn(dt, ttrain.GNNTrainConfig(
                **BASE, steps=10, device="cpu")))


def _close_to(hist, ref_hist):
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    for a, b in zip(hist, ref_hist):
        assert a["sampled_v"] == b["sampled_v"]
        assert a["sampled_e"] == b["sampled_e"]
        assert abs(a["loss"] - b["loss"]) <= 1e-5 + 1e-3 * abs(b["loss"])


@pytest.mark.parametrize("first", ["repro", "port"])
def test_resume_across_packages(tmp_path, dsets, ten_steps, first):
    dj, dt = dsets
    d = str(tmp_path)
    jcfg = lambda n: jtrain.GNNTrainConfig(**BASE, steps=n, eval_every=1000,
                                           ckpt_dir=d)
    tcfg = lambda n: ttrain.GNNTrainConfig(**BASE, steps=n, device="cpu",
                                           ckpt_dir=d)
    if first == "repro":
        jtrain.train_gnn(dj, jcfg(6))
        assert jck.latest_step(d) == 6
        out, ref = ttrain.train_gnn(dt, tcfg(10)), ten_steps[1]
    else:
        ttrain.train_gnn(dt, tcfg(6))
        assert ck.latest_step(d) == 6
        out, ref = jtrain.train_gnn(dj, jcfg(10)), ten_steps[0]
    assert ck.latest_step(d) == 10
    _close_to(out["history"], ref["history"][6:])


def test_engine_record_rules(tmp_path, dsets, monkeypatch):
    from repro_torch.ops import autotune
    cache = autotune.TuneCache(str(tmp_path / "tune.json"), {
        autotune.bucket_key("hash_dedup", "cuda", {"E": 4096, "S": 64}):
            {"table_load": 1.5, "us": 12.5}})
    cache.save()
    monkeypatch.setenv(autotune.CACHE_ENV, cache.path)
    monkeypatch.setattr(autotune, "_STATE", {"path": None, "cache": None})
    _, dt = dsets
    s = TS.from_dataset("labor-0", dt, batch_size=64, fanouts=(4, 4),
                        safety=3.0)
    meta = ck.engine_restore_meta(s.doubled(), backend="eager")
    assert meta["torch_backend"] == "eager" and "backend" not in meta
    assert meta["sampler"]["peer_caps"] is None
    assert cache.fingerprint() is not None
    assert meta["frontier_tuning"] == cache.fingerprint()
    back = ck.validate_restore_meta(json.loads(json.dumps(meta)), s,
                                    backend="eager")
    assert back.caps == s.doubled().caps          # caps re-adopted
    # repro's backend names its own kernels: not checked by the port
    ck.validate_restore_meta({**meta, "backend": "pallas"}, s,
                             backend="eager")
    with pytest.raises(ValueError, match="backend 'eager' != current"):
        ck.validate_restore_meta(meta, s, backend="cuda")
    ns = TS.from_dataset("ns", dt, batch_size=64, fanouts=(4, 4))
    with pytest.raises(ValueError, match="sampler 'labor-0'"):
        ck.validate_restore_meta(meta, ns)
    with pytest.raises(ValueError, match="mesh"):
        ck.validate_restore_meta({**meta, "mesh_devices": 4}, s)
    with pytest.raises(ValueError, match="compression"):
        ck.validate_restore_meta({**meta, "grad_compression": "int8"}, s)
    assert ck.validate_restore_meta({}, s) is s


# ----------------------------------------------------------------------
# preemption
# ----------------------------------------------------------------------

def test_preempt_and_resume(tmp_path, dsets):
    """repro's test on the port: an unfused loop with async saves is
    preempted at step 13 and resumed from its last checkpoint."""
    from repro_torch.data.gnn_loader import SeedBatches, sample_with_retry
    from repro_torch.runtime.engine import gather_feats, seed_labels

    _, ds = dsets
    total, every = 24, 6
    cfg = ttrain.GNNTrainConfig(hidden=32, fanouts=(4, 4), batch_size=64,
                                steps=total, lr=3e-3, device="cpu",
                                ckpt_dir=str(tmp_path), ckpt_every=every)
    preemptor = Preemptor(fire_step=13)

    def job():
        model = tgnn.gcn_init(rng_lib.key(cfg.seed), 16, cfg.hidden, 5, 2,
                              device="cpu")
        opt_cfg = tadam.AdamConfig(lr=cfg.lr)
        state = EngineState(opt=tadam.init_state(
            {k: p.detach() for k, p in model.named_parameters()}, opt_cfg))
        sampler = ttrain.build_sampler(ds, cfg)
        step_fn = ttrain.make_gnn_train_step(opt_cfg, "eager")
        saver = ck.AsyncSaver(cfg.ckpt_dir)
        start = ck.latest_step(cfg.ckpt_dir) or 0
        if start:
            state = ck.load_state_tree(model, state, ck.restore(
                cfg.ckpt_dir, start, ck.state_tree(model, state)))
        feats = torch.as_tensor(ds.features)
        labels = torch.as_tensor(ds.labels)
        it = iter(SeedBatches(ds.train_idx, 64, seed=0).epoch())
        key = rng_lib.key(cfg.seed + 1)
        history = []
        for step in range(start, total):
            preemptor.check(step)
            try:
                seeds = next(it)
            except StopIteration:
                it = iter(SeedBatches(ds.train_idx, 64, seed=0).epoch())
                seeds = next(it)
            key, sk = rng_lib.split(key)
            blocks, sampler = sample_with_retry(sampler, ds.graph, seeds, sk)
            with torch.no_grad():
                bf = gather_feats(feats, blocks[-1])
            _, opt, m = step_fn(model, state.opt, blocks, bf,
                                seed_labels(labels, seeds))
            state = EngineState(opt=opt)
            history.append({"step": step + 1, "loss": float(m["loss"])})
            if (step + 1) % every == 0:
                saver.save(step + 1, ck.state_tree(model, state))
        saver.save(total, ck.state_tree(model, state))
        saver.wait()
        return {"history": history}

    result = run_with_restarts(job, max_restarts=2)
    assert result["restarts"] == 1
    hist = result["history"]
    assert hist[0]["step"] >= 13 - every and hist[-1]["step"] == total
    assert ck.latest_step(str(tmp_path)) == total
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_preempted_train_gnn_resumes_bit_exact(tmp_path, dsets, ten_steps):
    _, ds = dsets
    cfg = ttrain.GNNTrainConfig(**BASE, steps=10, device="cpu",
                                ckpt_dir=str(tmp_path), ckpt_every=4)
    p = Preemptor(fire_step=7)
    out = run_with_restarts(lambda: ttrain.train_gnn(ds, cfg, preemptor=p))
    assert out["restarts"] == 1
    assert [h["step"] for h in out["history"]] == list(range(5, 11))
    for (_, a), (_, b) in zip(out["params"].named_parameters(),
                              ten_steps[1]["params"].named_parameters()):
        assert torch.equal(a, b)
    p2 = Preemptor(fire_step=0)

    def job():
        p2.fired = False
        p2.check(0)

    with pytest.raises(SimulatedPreemption):
        run_with_restarts(job, max_restarts=2)


# ----------------------------------------------------------------------
# the launchers
# ----------------------------------------------------------------------

TRAIN_ARGS = ["--dataset", "flickr", "--scale", "0.02", "--fanouts", "5,5",
              "--batch-size", "128", "--steps", "8", "--seed", "3",
              "--guard", "quarantine", "--guard-warmup", "2",
              "--inject", "nan_grad@3", "--pipeline", "prefetch"]
SERVE_ARGS = ["--workload", "gnn", "--driver", "async", "--dataset",
              "flickr", "--scale", "0.02", "--fanouts", "5,5", "--batch",
              "64", "--requests", "4", "--request-size", "16", "--seed", "3"]


def test_launchers_train_and_serve_checkpoints_across_packages(
        tmp_path, monkeypatch, capsys):
    """Both train launchers with the runtime flags print the same report
    (guard counters and fired injectors included); a checkpoint the
    port's launcher wrote serves on both serve launchers alike."""
    import sys

    from repro.launch import serve as jserve
    from repro.launch import train as jtrain_l
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain_l

    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    monkeypatch.delenv(inject_lib.ENV_VAR, raising=False)
    monkeypatch.setattr(sys, "argv", ["train", "--workload", "gnn"]
                        + TRAIN_ARGS + ["--ckpt-dir", dj])
    jtrain_l.main()
    ref = json.loads(capsys.readouterr().out)
    out = ttrain_l.main(TRAIN_ARGS + ["--device", "cpu", "--ckpt-dir", dt])
    capsys.readouterr()
    assert set(out) == set(ref)
    for k in ("guard", "guard_quarantines", "guard_rollbacks",
              "guard_nonfinite_batches", "guard_spike_batches",
              "inject_fired", "avg_sampled_vertices", "overflow_replays"):
        assert out[k] == ref[k], k
    assert out["inject_fired"] == [["nan_grad", 3]]
    assert abs(out["final_loss"] - ref["final_loss"]) <= (
        1e-5 + 1e-3 * abs(ref["final_loss"]))
    assert ck.latest_step(dt) == jck.latest_step(dj) == 8

    served = {}
    for name, mod in (("repro", jserve), ("port", tserve)):
        argv = SERVE_ARGS + ["--ckpt-dir", dt]
        if name == "repro":
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            mod.main()
        else:
            mod.main(argv + ["--device", "cpu"])
        served[name] = json.loads(capsys.readouterr().out)
    fresh = tserve.main(SERVE_ARGS + ["--device", "cpu"])
    capsys.readouterr()
    assert served["port"]["accuracy"] == served["repro"]["accuracy"]
    assert served["port"]["requests_served"] == 4
    assert served["port"]["accuracy"] != fresh["accuracy"]
