"""The port's multi-device GNN engine (``TrainEngine(mesh=...)``,
``launch/mesh.py``, ``distributed/{feature_exchange,compression}.py``,
``train_gnn(mesh_devices=N)``, ``launch/gnn_step.py``) on 4 gloo CPU
ranks, held to the port's single-device engine, and LABOR-0's
frontiers held to repro's 4-device run.

One spawn of 4 ranks (``launch.mesh.spawn``) runs every check of
``CHECKS`` on the ``generate`` mini graph (2,000 vertices), batch 128,
fanouts (4, 3); each test reads its check's record:

  * every registry sampler's mesh step against the single-device step
    with the same seeds and key: each layer's frontier set and the
    deepest one equal bit for bit, ``sampled_v`` and ``sampled_e``
    equal, loss within 1e-4, accuracy within 1e-6, the updated
    parameters within 2e-5 (repro's ``tests/test_engine.py`` contract);
  * gcn, sage and gatv2 on a mesh, under the same contract;
  * the all-to-all overflow (per-peer caps cut 16x) replayed with grown
    ``peer_caps``, the parameters finite and moved;
  * the mesh's inference equal to the single-device inference (``full``);
  * the guard on a mesh: a clean guarded run equal bit for bit to an
    unguarded one, a ``nan_grad@3`` batch quarantined;
  * the pipelined driver (``prefetch``, ``full``) on a mesh against the
    serial mesh run: frontiers, counts and parameters bit for bit;
  * ``make_sharded_gather`` in both owner modes against a direct
    gather, and its overflow flag;
  * ``ring_allreduce_int8`` against a numpy model of repro's ring (bit
    for bit) and ``compressed_mean``'s error feedback converging;
  * ``build_gnn_engine``, the launcher's rank report (``--mesh-devices``)
    and the checkpoint meta of a mesh run.

The cross-package check runs repro's partitioned sampling program on 4
forced host devices in one subprocess (``tests/_subproc.py``) and
compares its LABOR-0 frontiers and |V^3| with the port's mesh run.
"""
import dataclasses
import os
import tempfile
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

MINI = ("mini", 2000, 12.0, 16, 5, 0.5, 0.2, 0.6, 1000)
P, B, FANOUTS = 4, 128, (4, 3)
SAMPLERS = ("ns", "labor-0", "labor-1", "labor-*", "labor-d", "ladies",
            "pladies", "full")
MODELS = ("gcn", "sage", "gatv2")
PIPELINES = ("prefetch", "full")


def _dataset():
    from repro_torch.graph.generators import DatasetSpec, generate
    return generate(DatasetSpec(*MINI), seed=0)


def _engines(ds, name, mesh, model="gcn"):
    from repro_torch.core import samplers as TS
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import TrainEngine
    # the ladies family's budgets are batch-global, so both engines get
    # the same explicit layer sizes
    ls = (256, 192) if name in ("ladies", "pladies") else None
    s1 = TS.from_dataset(name, ds, batch_size=B, fanouts=FANOUTS,
                         safety=3.0, layer_sizes=ls)
    sP = TS.from_dataset(name, ds, batch_size=B // P, fanouts=FANOUTS,
                         safety=3.0, layer_sizes=ls, num_parts=P)
    opt = adam.AdamConfig(lr=1e-2)
    return (TrainEngine(s1, opt, device="cpu"),
            TrainEngine(sP, opt, mesh=mesh))


def _model(name="gcn"):
    from repro_torch.core import rng as TR
    from repro_torch.models import gnn as tgnn
    return tgnn.MODELS[name][0](TR.key(0), 16, 32, 5, len(FANOUTS),
                                device="cpu")


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _step_pair(ds, mesh, name, model="gcn"):
    """One single-device and one mesh step with the same seeds and key:
    the record the contract is checked on (the single-device step on
    rank 0 alone, whose record comes back)."""
    from repro_torch.core import rng as TR
    from repro_torch.core.interface import pad_seeds
    e1, eP = _engines(ds, name, mesh, model)
    dP = eP.make_data_from_dataset(ds)
    seeds = pad_seeds(np.asarray(ds.train_idx[:B], np.int32), B)
    key = TR.key(7)
    mP_ = _model(model)
    mP_, _, mP = eP.step(mP_, eP.init_state(mP_), dP, seeds, key)
    if mesh.rank:
        return None
    d1 = e1.make_data_from_dataset(ds)
    m1_ = _model(model)
    m1_, _, m1 = e1.step(m1_, e1.init_state(m1_), d1, seeds, key)
    blocks = e1.sampler.sample_with_key(d1.graph, seeds, key)
    single = [seeds] + [b.next_seeds for b in blocks]
    return dict(
        single_sets=[sorted(set(s.tolist()) - {-1}) for s in single],
        mesh_sets=[sorted(set(f.tolist()) - {-1}) for f in mP["frontiers"]],
        overflow=(bool(m1["overflow"].any()), bool(mP["overflow"].any())),
        sampled_v=(int(m1["sampled_v"]), int(mP["sampled_v"])),
        sampled_e=(int(m1["sampled_e"]), int(mP["sampled_e"])),
        loss=(float(m1["loss"]), float(mP["loss"])),
        acc=(float(m1["acc"]), float(mP["acc"])),
        params=(_params(m1_), _params(mP_)))


def _check_overflow_replay(ds, mesh):
    from repro_torch.core import rng as TR
    from repro_torch.core import samplers as TS
    from repro_torch.core.interface import pad_seeds
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import TrainEngine
    sP = TS.from_dataset("labor-0", ds, batch_size=B // P, fanouts=FANOUTS,
                         safety=3.0, num_parts=P)
    # sampling caps untouched, per-peer all-to-all caps far too small
    tiny = tuple(max(c // 16, 8) for c in sP.spec.peer_caps)
    eng = TrainEngine(sP.with_peer_caps(tiny), adam.AdamConfig(lr=1e-2),
                      mesh=mesh)
    data = eng.make_data_from_dataset(ds)
    model = _model()
    base = _params(model)
    state = eng.init_state(model)
    rng = np.random.default_rng(0)
    key = TR.key(3)
    for t in range(4):
        seeds = pad_seeds(rng.choice(ds.train_idx, size=B, replace=False)
                          .astype(np.int32), B)
        key, sk = TR.split(key)
        model, state, _ = eng.step(model, state, data, seeds, sk, tag=t)
    model, state, _ = eng.flush(model, state, data)
    return dict(replays=eng.stats.overflow_replays,
                retries=eng.stats.overflow_retries, tiny=tiny,
                peer=eng.sampler.spec.peer_caps, base=base,
                params=_params(model))


def _check_infer(ds, mesh):
    from repro_torch.core import rng as TR
    from repro_torch.core.interface import pad_seeds
    e1, eP = _engines(ds, "full", mesh)
    dP = eP.make_data_from_dataset(ds)
    seeds = pad_seeds(np.asarray(ds.val_idx[:B], np.int32), B)
    model = _model()
    owned, logitsP, ovfP = eP.infer(model, dP, seeds, TR.key(9))
    if mesh.rank:
        return None
    logits1, ovf1 = e1.infer(model, e1.make_data_from_dataset(ds), seeds,
                             TR.key(9))
    return dict(seeds=seeds, logits1=logits1, ovf1=ovf1, owned=owned,
                logitsP=logitsP, ovfP=ovfP)


def _train(ds, **kw):
    from repro_torch.runtime.trainer import GNNTrainConfig, train_gnn
    base = dict(hidden=16, fanouts=(4, 4), batch_size=64, steps=8, lr=1e-2,
                cap_safety=3.0, mesh_devices=P, device="cpu")
    out = train_gnn(ds, GNNTrainConfig(**{**base, **kw}))
    return dict(params=_params(out["params"]), history=out["history"],
                guard_stats=out.get("guard_stats"),
                inject_log=out.get("inject_log"))


def _check_guard(ds, mesh):
    return dict(off=_train(ds), on=_train(ds, guard="quarantine"),
                faulted=_train(ds, guard="quarantine", guard_warmup=2,
                               inject="nan_grad@3"))


def _check_pipeline(ds, mesh, mode):
    from repro_torch.core import rng as TR
    from repro_torch.core.interface import pad_seeds
    from repro_torch.runtime.pipeline import PipelinedEngine
    runs = {}
    for how in ("serial", mode):
        _, eng = _engines(ds, "labor-0", mesh)
        data = eng.make_data_from_dataset(ds)
        model = _model()
        state = eng.init_state(model)
        driver = None if how == "serial" else PipelinedEngine(eng, mode)
        rng = np.random.default_rng(1)
        hist = []
        for t in range(4):
            seeds = pad_seeds(rng.choice(ds.train_idx, size=B,
                                         replace=False).astype(np.int32), B)
            key = TR.fold_in(TR.key(5), t)
            if driver is None:
                model, state, m = eng.step(model, state, data, seeds, key)
                hist.append(m)
            else:
                model, state, done = driver.step(model, state, data, seeds,
                                                 key, tag=t)
                hist += [dm for _, dm in done]
        if driver is not None:
            model, state, done = driver.flush(model, state, data)
            hist += [dm for _, dm in done]
        runs[how] = dict(
            fronts=[[f.clone() for f in m["frontiers"]] for m in hist],
            counts=[(int(m["sampled_v"]), int(m["sampled_e"]))
                    for m in hist],
            params=_params(model))
    return runs


def _ring_model(xs):
    """repro's ``ring_allreduce_int8`` over P float32 vectors, in numpy
    (the reference's quantiser and hop order)."""
    Pn = len(xs)
    n = xs[0].size
    pad = (-n) % Pn
    acc = [np.pad(x.reshape(-1), (0, pad)).reshape(Pn, -1).astype(np.float32)
           for x in xs]

    def quant(v):
        scale = np.float32(max(np.max(np.abs(v)), np.float32(1e-12))
                           / np.float32(127.0))
        q = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
        return q, scale

    for i in range(Pn - 1):
        sent = [quant(acc[d][(d - i) % Pn]) for d in range(Pn)]
        for d in range(Pn):
            q, s = sent[(d - 1) % Pn]
            r = (d - i - 1) % Pn
            acc[d][r] = acc[d][r] + q.astype(np.float32) * s
    for i in range(Pn - 1):
        sent = [quant(acc[d][((d + 1) % Pn - i) % Pn]) for d in range(Pn)]
        for d in range(Pn):
            q, s = sent[(d - 1) % Pn]
            r = ((d + 1) % Pn - i - 1) % Pn
            acc[d][r] = q.astype(np.float32) * s
    return [a.reshape(-1)[:n].reshape(xs[0].shape) / np.float32(Pn)
            for a in acc]


def _check_compression(ds, mesh):
    from repro_torch.distributed import compression as comp
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(P, 33)).astype(np.float32)
    ring = comp.ring_allreduce_int8(torch.from_numpy(xs[mesh.rank]), mesh)
    # every rank's result, for the model's per-rank answer
    rings = mesh.all_gather(ring)
    cfg = comp.CompressionConfig("int8")
    # a distributed quadratic: rank r's target is r, the mean gradient
    # drives x to the mean target; error feedback keeps the bias ~0
    x = torch.zeros(4)
    err = comp.init_error_state({"x": x}, cfg)
    for _ in range(200):
        g = {"x": 2 * (x - float(mesh.rank))}
        red, err = comp.compressed_mean(g, err, cfg, mesh)
        x = x - 0.05 * red["x"]
    bf = comp.CompressionConfig("bf16")
    redb, errb = comp.compressed_mean(
        {"x": torch.full((3,), 1.0 + mesh.rank / 3)},
        comp.init_error_state({"x": torch.zeros(3)}, bf), bf, mesh)
    return dict(xs=xs, rings=rings, x=x, bf16=redb["x"], bf16_err=errb["x"])


def _check_exchange(ds, mesh):
    """repro's ``test_feature_exchange_matches_direct_gather``, in both
    owner modes: each rank fetches random ids (-1 pad) of a (V, F)
    table sharded over the ranks, through ``make_sharded_gather``."""
    from repro_torch.distributed.feature_exchange import make_sharded_gather
    from repro_torch.graph.partition import partition_rows
    V, F, T = 64, 5, 16
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(V, F)).astype(np.float32)
    ids = rng.integers(-1, V, size=(P, T)).astype(np.int32)
    want = np.where(ids[mesh.rank, :, None] >= 0,
                    feats[np.maximum(ids[mesh.rank], 0)], 0.0)
    per = V // P
    out = {}
    for mode, local in (("range", feats[mesh.rank * per:(mesh.rank + 1)
                                        * per]),
                        ("mod", partition_rows(feats, P, mesh.rank))):
        for cap in (T, 2):
            got, ovf = make_sharded_gather(mesh, cap, mode)(
                torch.from_numpy(local), torch.from_numpy(ids[mesh.rank]))
            out[(mode, cap)] = (got, bool(mesh.pmax(ovf.to(torch.int32))))
    return dict(want=want, got=out)


def _check_gnn_step(ds, mesh):
    from repro_torch.configs.labor_gcn import GNNWorkloadConfig
    from repro_torch.core import rng as TR
    from repro_torch.core.interface import pad_seeds
    from repro_torch.launch.gnn_step import build_gnn_engine
    g = ds.graph
    cfg = GNNWorkloadConfig(num_vertices=g.num_vertices,
                            avg_degree=g.num_edges / g.num_vertices,
                            feature_dim=16, num_classes=5, hidden=32,
                            num_layers=2, fanouts=(4, 4), global_batch=128,
                            cap_safety=3.0)
    engine, meta = build_gnn_engine(mesh, cfg, lr=1e-2)
    from repro_torch.models import gnn as tgnn
    model = tgnn.gcn_init(TR.key(0), 16, 32, 5, 2, device="cpu")
    data = engine.make_data_from_dataset(ds)
    state = engine.init_state(model)
    seeds = pad_seeds(np.asarray(ds.train_idx[:128], np.int32), 128)
    losses, ovf, sv = [], [], []
    for t in range(3):
        model, state, m = engine.step(model, state, data, seeds,
                                      TR.key(42 + t), tag=t)
        losses.append(float(m["loss"]))
        ovf.append(bool(m["overflow"].any()))
        sv.append(int(m["sampled_v"]))
    engine.flush(model, state, data)
    return dict(meta=meta, losses=losses, overflow=ovf, sampled_v=sv)


def _check_launcher(ds, mesh):
    import argparse

    from repro_torch.launch import train as launch
    from repro_torch.runtime import checkpoint as ckpt_lib
    args = launch.parser().parse_args(
        ["--device", "cpu", "--dataset", "flickr", "--scale", "0.01",
         "--fanouts", "4,4", "--batch-size", "64", "--steps", "3",
         "--seed", "3", "--mesh-devices", str(P)])
    assert isinstance(args, argparse.Namespace)
    mesh_report = launch._rank_report(mesh, args)
    single_report = None
    if mesh.rank == 0:
        single = dataclasses.replace(launch.config(args), mesh_devices=0)
        single_report, _ = launch.train_report(launch.dataset(args), single,
                                               evaluate=False)
    # a mesh run's checkpoint records the mesh and the compression
    tmp = os.path.join(tempfile.gettempdir(), f"mesh_ckpt_{os.getppid()}")
    if mesh.rank == 0 and os.path.isdir(tmp):
        import shutil
        shutil.rmtree(tmp)
    mesh.psum(torch.zeros(1))
    _train(ds, steps=2, ckpt_dir=tmp, grad_compression="bf16")
    mesh.psum(torch.zeros(1))   # rank 0's save has landed
    meta = ckpt_lib.read_meta(tmp, ckpt_lib.latest_step(tmp))
    refused = None
    try:
        _train(ds, steps=3, ckpt_dir=tmp)   # compression none: refused
    except ValueError as e:
        refused = str(e)
    mesh.psum(torch.zeros(1))
    if mesh.rank == 0:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(mesh=mesh_report, single=single_report, meta=meta,
                refused=refused)


CHECKS = ([f"step[{n}]" for n in SAMPLERS]
          + [f"model[{m}]" for m in MODELS[1:]]
          + ["overflow_replay", "infer", "guard"]
          + [f"pipeline[{m}]" for m in PIPELINES]
          + ["exchange", "compression", "gnn_step", "launcher"])


def _run_check(name, ds, mesh):
    if name.startswith("step["):
        return _step_pair(ds, mesh, name[5:-1])
    if name.startswith("model["):
        return _step_pair(ds, mesh, "labor-0", name[6:-1])
    if name.startswith("pipeline["):
        return _check_pipeline(ds, mesh, name[9:-1])
    return globals()[f"_check_{name}"](ds, mesh)


def _ranks(mesh):
    """Every check on one rank; rank 0's records come back. A check that
    raises on every rank alike is recorded as its traceback."""
    torch.set_num_threads(1)
    ds = _dataset()
    out = {}
    for name in CHECKS:
        try:
            out[name] = _run_check(name, ds, mesh)
        except Exception:  # the test of this check reports it
            out[name] = {"error": traceback.format_exc()}
    return out


@pytest.fixture(scope="module")
def mesh_run():
    from repro_torch.launch.mesh import spawn
    return spawn(_ranks, P, device="cpu", timeout_s=300.0)


def _record(mesh_run, name):
    rec = mesh_run[name]
    assert "error" not in rec, rec.get("error")
    return rec


def _assert_contract(rec):
    assert rec["overflow"] == (False, False)
    for l, (a, b) in enumerate(zip(rec["single_sets"], rec["mesh_sets"])):
        assert a == b, ("layer", l, len(set(a) ^ set(b)))
    assert len(rec["mesh_sets"]) == len(FANOUTS) + 1
    assert rec["sampled_v"][0] == rec["sampled_v"][1]
    assert rec["sampled_v"][1] == len(rec["mesh_sets"][-1])
    assert rec["sampled_e"][0] == rec["sampled_e"][1]
    assert abs(rec["loss"][0] - rec["loss"][1]) < 1e-4
    assert abs(rec["acc"][0] - rec["acc"][1]) < 1e-6
    for a, b in zip(*rec["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("name", SAMPLERS)
def test_mesh_step_matches_single_device(mesh_run, name):
    _assert_contract(_record(mesh_run, f"step[{name}]"))


@pytest.mark.parametrize("model", MODELS)
def test_models_on_a_mesh(mesh_run, model):
    key = "step[labor-0]" if model == "gcn" else f"model[{model}]"
    _assert_contract(_record(mesh_run, key))


def test_all_to_all_overflow_replays_with_grown_peer_caps(mesh_run):
    rec = _record(mesh_run, "overflow_replay")
    assert rec["replays"] >= 1 and rec["retries"] >= 1
    assert all(c > t for c, t in zip(rec["peer"], rec["tiny"]))
    assert all(torch.isfinite(p).all() for p in rec["params"])
    assert any(not torch.equal(a, b)
               for a, b in zip(rec["base"], rec["params"]))


def test_mesh_infer_matches_single_device(mesh_run):
    rec = _record(mesh_run, "infer")
    assert not rec["ovf1"].any() and not rec["ovfP"].any()
    seeds = rec["seeds"].numpy()
    pos = {int(v): i for i, v in enumerate(seeds) if v >= 0}
    n = 0
    for i, v in enumerate(rec["owned"].tolist()):
        if v >= 0:
            np.testing.assert_allclose(rec["logitsP"][i].numpy(),
                                       rec["logits1"][pos[v]].numpy(),
                                       atol=1e-4)
            n += 1
    assert n == (seeds >= 0).sum()


def test_mesh_guard_clean_and_quarantine(mesh_run):
    rec = _record(mesh_run, "guard")
    for a, b in zip(rec["off"]["params"], rec["on"]["params"]):
        assert torch.equal(a, b)
    assert rec["on"]["guard_stats"].quarantines == 0
    gs = rec["faulted"]["guard_stats"]
    assert gs.nonfinite_batches == 1 and gs.quarantines >= 1, gs
    assert rec["faulted"]["inject_log"] == [("nan_grad", 3)]
    assert np.isfinite([h["loss"] for h in rec["faulted"]["history"]]).all()


@pytest.mark.parametrize("mode", PIPELINES)
def test_mesh_pipeline_matches_serial(mesh_run, mode):
    rec = _record(mesh_run, f"pipeline[{mode}]")
    s, p = rec["serial"], rec[mode]
    assert s["counts"] == p["counts"]
    for fs, fp in zip(s["fronts"], p["fronts"]):
        for a, b in zip(fs, fp):
            assert torch.equal(a, b)
    for a, b in zip(s["params"], p["params"]):
        assert torch.equal(a, b)


def test_sharded_gather_matches_a_direct_gather(mesh_run):
    rec = _record(mesh_run, "exchange")
    for (mode, cap), (got, ovf) in rec["got"].items():
        if cap == 2:      # 16 ids over 4 owners cannot fit 2 a peer
            assert ovf, mode
            continue
        assert not ovf, mode
        np.testing.assert_array_equal(got.numpy(), rec["want"], err_msg=mode)


def test_ring_allreduce_int8_and_compressed_mean(mesh_run):
    rec = _record(mesh_run, "compression")
    want = _ring_model(list(rec["xs"]))
    for d in range(P):
        np.testing.assert_array_equal(rec["rings"][d].numpy(), want[d])
        np.testing.assert_allclose(want[d], rec["xs"].mean(0), atol=0.05)
    np.testing.assert_allclose(rec["x"].numpy(), 1.5, atol=0.05)
    vals = [np.float32(1.0 + r / 3) for r in range(P)]
    sent = [float(torch.tensor(v).to(torch.bfloat16)) for v in vals]
    np.testing.assert_allclose(rec["bf16"].numpy(), np.mean(sent),
                               rtol=1e-7)
    np.testing.assert_allclose(rec["bf16_err"].numpy(),
                               vals[0] - np.float32(sent[0]), rtol=1e-6)


def test_build_gnn_engine_trains(mesh_run):
    rec = _record(mesh_run, "gnn_step")
    assert rec["meta"]["num_devices"] == P
    assert rec["meta"]["local_batch"] == 128 // P
    assert len(rec["meta"]["peer_caps"]) == 3
    assert not any(rec["overflow"])
    assert all(v > 128 for v in rec["sampled_v"])
    assert rec["losses"][-1] < rec["losses"][0], rec["losses"]


def test_launcher_rank_report_and_checkpoint_meta(mesh_run):
    rec = _record(mesh_run, "launcher")
    mesh, single = rec["mesh"], rec["single"]
    assert set(mesh) == set(single)
    assert mesh["avg_sampled_vertices"] == single["avg_sampled_vertices"]
    assert abs(mesh["final_loss"] - single["final_loss"]) < 1e-4
    assert mesh["val_acc"] is not None
    assert rec["meta"]["mesh_devices"] == P
    assert rec["meta"]["grad_compression"] == "bf16"
    assert len(rec["meta"]["sampler"]["peer_caps"]) == 3
    assert rec["refused"] is not None and "compression" in rec["refused"]


_REPRO_SNIPPET = """
import os
# one thread a device: the suite's other workers share the cores
os.environ["XLA_FLAGS"] += (" --xla_cpu_multi_thread_eigen=false"
                            " intra_op_parallelism_threads=1")
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.core import samplers
from repro.core.interface import pad_seeds
from repro.graph.generators import DatasetSpec, generate
from repro.launch.mesh import make_mesh
from repro.models import gnn as gnn_models
from repro.optim import adam
from repro.runtime.engine import TrainEngine

ds = generate(DatasetSpec(*{mini!r}), seed=0)
sP = samplers.from_dataset("labor-0", ds, batch_size={bl}, fanouts={fan!r},
                           safety=3.0, num_parts={p})
eng = TrainEngine(sP, gnn_models.gcn_apply, adam.AdamConfig(lr=1e-2),
                  mesh=make_mesh(({p},), ("data",)))
data = eng.make_data_from_dataset(ds)
seeds = pad_seeds(jnp.asarray(np.asarray(ds.train_idx[:{b}], np.int32)), {b})
bnd, fronts = eng.staged.sample(data.indptr, data.indices, data.labels,
                                seeds, jax.random.key(7))
print("RESULT", json.dumps(dict(
    frontiers=[sorted(set(np.asarray(f).tolist()) - {{-1}})
               for f in fronts],
    sampled_v=int(np.asarray(bnd["deep_n"])[0]))))
"""


def test_labor0_mesh_frontiers_match_repro(mesh_run):
    """LABOR-0 at P = 4: the port's mesh frontiers and |V^3| equal
    repro's partitioned sampling program on 4 forced host devices."""
    import json

    from tests._subproc import run_with_devices
    out = run_with_devices(_REPRO_SNIPPET.format(
        mini=MINI, bl=B // P, fan=FANOUTS, p=P, b=B), n=P, timeout=600)
    ref = json.loads(out.split("RESULT", 1)[1])
    rec = _record(mesh_run, "step[labor-0]")
    assert rec["mesh_sets"] == ref["frontiers"]
    assert rec["sampled_v"][1] == ref["sampled_v"]
