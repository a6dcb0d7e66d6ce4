"""The port's pipelined driver (``runtime/pipeline.py``), the step's
stages (``TrainEngine.sample_stage`` / ``gather_stage``), the
depth-aware ``OverflowLedger``, the
prefetch iterator and the unfused step, against the port's serial run
and repro's, on the CPU (``generate`` mini graph, GCN of hidden 16).

  * the ledger's depth window and its errors;
  * a staged sample equal field for field to the serial step's sampling
    and to repro's staged sample (bit for bit), for labor-0, ns and
    ladies;
  * ``prefetch`` and ``full`` against the port's serial run (sampled
    vertices and edges per step, and the parameters, bit for bit) and
    against repro's pipelined run (sampled vertices and edges bit for
    bit, losses within atol 1e-5 + rtol 1e-3), for the same samplers;
  * the replay with two batches in flight (forced tiny caps): repro's
    replay, retry and invalidation counts, parameters bit for bit
    against the serial run; invalidation re-samples the queued batches
    at the grown caps;
  * ``fused=False`` against repro's unfused step (sampled vertices bit
    for bit, losses within the bound above) and equal bit for bit to the
    port's fused run;
  * ``PrefetchIterator``: order, and stragglers counted.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import samplers as JS  # noqa: E402
from repro.graph.generators import DatasetSpec as JSpec  # noqa: E402
from repro.graph.generators import generate as jgen  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.runtime import trainer as jtrain  # noqa: E402
from repro.runtime.engine import TrainEngine as JEngine  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.core.interface import INT_FIELDS, pad_seeds  # noqa: E402
from repro_torch.data.gnn_loader import (LoaderStats,  # noqa: E402
                                         OverflowLedger, PrefetchIterator)
from repro_torch.graph.generators import DatasetSpec as TSpec  # noqa: E402
from repro_torch.graph.generators import generate as tgen  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import trainer as ttrain  # noqa: E402
from repro_torch.runtime.engine import TrainEngine  # noqa: E402
from repro_torch.runtime.pipeline import PipelinedEngine  # noqa: E402

MINI = ("mini", 2000, 12.0, 16, 5, 0.5, 0.2, 0.6, 1000)
SAMPLERS = ["labor-0", "ns", "ladies"]
LOSS_TOL = lambda ref: 1e-5 + 1e-3 * abs(ref)


@pytest.fixture(scope="module")
def dsets():
    return jgen(JSpec(*MINI), seed=0), tgen(TSpec(*MINI), seed=0)


def _cfg(sampler, **kw):
    ls = (192, 144) if sampler in ("ladies", "pladies") else None
    return {**dict(hidden=16, fanouts=(4, 3), sampler=sampler,
                   layer_sizes=ls, batch_size=48, steps=5, lr=1e-2, seed=0,
                   cap_safety=3.0), **kw}


def _port(ds, **kw):
    return ttrain.train_gnn(ds, ttrain.GNNTrainConfig(device="cpu", **kw))


def _ref(ds, **kw):
    return jtrain.train_gnn(ds, jtrain.GNNTrainConfig(**kw))


def _same_counts(a, b):
    assert [(h["step"], h["sampled_v"], h["sampled_e"]) for h in a] == [
        (h["step"], h["sampled_v"], h["sampled_e"]) for h in b]


def _params_equal(a, b):
    for (n, x), (_, y) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(x, y), n


@pytest.fixture(scope="module")
def serial(dsets):
    return {s: _port(dsets[1], **_cfg(s)) for s in SAMPLERS}


# ----------------------------------------------------------------------
# the ledger
# ----------------------------------------------------------------------

def test_ledger_depth_window():
    ovf, ok = torch.tensor([True]), torch.tensor([False])
    led = OverflowLedger(LoaderStats(), depth=2)
    assert led.record("a", ovf) is None       # window: [a]
    assert led.record("b", ok) is None        # window: [a, b]
    assert led.record("c", ok) == "a"         # a falls out: replay
    assert led.record("d", ovf) is None       # b falls out, clean
    assert led.flush() == "d"                 # c clean, d overflowed
    assert led.flush() is None
    assert led.stats.overflow_replays == 2
    led = OverflowLedger(LoaderStats(), depth=1)
    assert led.record("a", ovf) is None
    assert led.record("b", ok) == "a"
    assert led.flush() is None
    with pytest.raises(ValueError):
        OverflowLedger(LoaderStats(), depth=0)


def test_pipelined_engine_rejects_bad_mode_and_depth(dsets):
    s = TS.from_dataset("ns", dsets[1], batch_size=32, fanouts=(4,),
                        safety=3.0)
    eng = TrainEngine(s, tadam.AdamConfig(lr=1e-2), device="cpu")
    with pytest.raises(ValueError):
        PipelinedEngine(eng, mode="turbo")
    assert PipelinedEngine(eng, mode="prefetch").depth == 1
    assert PipelinedEngine(eng, mode="full").depth == 2


# ----------------------------------------------------------------------
# the staged sample, the pipeline modes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sampler", SAMPLERS)
def test_staged_sample_is_the_serial_and_the_reference_sample(dsets,
                                                              sampler):
    dj, dt = dsets
    kw = dict(batch_size=48, fanouts=(4, 3), safety=3.0,
              layer_sizes=_cfg(sampler)["layer_sizes"])
    et = TrainEngine(TS.from_dataset(sampler, dt, **kw), device="cpu")
    ej = JEngine(JS.from_dataset(sampler, dj, **kw), jgnn.gcn_apply,
                 jadam.AdamConfig(), backend="xla")
    data_t = et.make_data_from_dataset(dt)
    data_j = ej.make_data_from_dataset(dj)
    ids = np.asarray(dt.train_idx[:40])
    seeds, key = pad_seeds(ids, 48), TR.fold_in(TR.key(1), 3)
    staged = et.sample_stage(data_t.graph, seeds, key)
    serial, feats = et.sample_batch(data_t, seeds, key)
    ref = ej.staged.sample(data_j.graph, jnp.asarray(np.asarray(seeds)),
                           jax.random.fold_in(jax.random.key(1), 3))
    for a, b, r in zip(staged, serial, ref):
        for f in INT_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(r, f)), f)
        assert torch.equal(a.weight, b.weight)
    g_feats, labels = et.gather_stage(data_t.features, data_t.labels,
                                      staged)
    assert torch.equal(g_feats, feats)


@pytest.mark.parametrize("mode", ["prefetch", "full"])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_pipeline_modes_match_serial_and_reference(dsets, serial, sampler,
                                                   mode):
    dj, dt = dsets
    out = _port(dt, **_cfg(sampler, pipeline=mode))
    ref = _ref(dj, **_cfg(sampler, pipeline=mode))
    _same_counts(out["history"], serial[sampler]["history"])
    _params_equal(out, serial[sampler])
    _same_counts(out["history"], ref["history"])
    for a, b in zip(out["history"], ref["history"]):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL(b["loss"])


def test_replay_with_two_batches_in_flight(dsets):
    """Forced overflow with two batches in flight (full, depth 2): the
    doubled-caps replay lands in the serial update slot, and the queued
    batches are re-sampled at the grown caps."""
    dj, dt = dsets
    kw = dict(hidden=16, fanouts=(8,), sampler="ns", batch_size=128,
              steps=6, lr=1e-2, seed=0, cap_safety=0.02)
    ser = _port(dt, **kw)
    out = _port(dt, **kw, pipeline="full")
    ref = _ref(dj, **kw, pipeline="full")
    assert ser["stats"].overflow_replays >= 1
    for k in ("overflow_replays", "overflow_retries",
              "pipeline_invalidations"):
        assert getattr(out["stats"], k) == getattr(ref["stats"], k), k
    assert out["stats"].overflow_replays == ser["stats"].overflow_replays
    assert out["stats"].pipeline_invalidations >= 1
    _same_counts(out["history"], ser["history"])
    _params_equal(out, ser)
    _same_counts(out["history"], ref["history"])


def test_invalidation_resamples_queued_batches(dsets):
    ds = dsets[1]
    s = TS.from_dataset("ns", ds, batch_size=48, fanouts=(4, 3), safety=3.0)
    eng = TrainEngine(s, tadam.AdamConfig(lr=1e-2), device="cpu")
    data = eng.make_data_from_dataset(ds)
    drv = PipelinedEngine(eng, mode="full")
    model = tgnn.gcn_init(TR.key(0), 16, 16, 5, 2, device="cpu")
    state = eng.init_state(model)
    seeds = pad_seeds(np.asarray(ds.train_idx[:48]), 48)
    for t in range(2):
        model, state, done = drv.step(model, state, data, seeds, TR.key(t),
                                      tag=t)
        assert done == []
    assert drv.in_flight == 2
    old = eng.sampler.caps[0].vertex_cap
    eng.grow()                       # what a replay does on overflow
    drv._invalidate(data)
    assert eng.stats.pipeline_invalidations == 2
    assert eng.sampler.caps[0].vertex_cap == 2 * old
    for ent in drv._queue:
        assert ent.sampler is eng.sampler
        assert ent.blocks[0].next_cap == ent.sampler.caps[0].vertex_cap
    model, state, done = drv.flush(model, state, data)
    assert [t for t, _ in done] == [0, 1]


# ----------------------------------------------------------------------
# the unfused step; the prefetch iterator
# ----------------------------------------------------------------------

def test_unfused_matches_the_reference_and_the_fused_run(dsets, serial):
    dj, dt = dsets
    out = _port(dt, **_cfg("labor-0", fused=False))
    ref = _ref(dj, **_cfg("labor-0", fused=False))
    _same_counts(out["history"], ref["history"])
    for a, b in zip(out["history"], ref["history"]):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL(b["loss"])
    _same_counts(out["history"], serial["labor-0"]["history"])
    _params_equal(out, serial["labor-0"])
    for kw in (dict(guard="quarantine"), dict(pipeline="prefetch")):
        with pytest.raises(ValueError, match="fused"):
            _port(dt, **_cfg("ns", fused=False, **kw))


def test_prefetch_iterator_order_and_stragglers():
    stats = LoaderStats()
    assert list(PrefetchIterator(iter(range(5)), stats=stats)) == list(
        range(5))
    assert stats.batches == 5 and stats.stragglers_skipped == 0

    def slow():
        yield 0
        time.sleep(0.3)
        yield 1

    stats = LoaderStats()
    out = list(PrefetchIterator(slow(), straggler_timeout=0.05, stats=stats))
    assert out == [0, 1] and stats.stragglers_skipped >= 1


def test_guarded_pipeline_is_the_serial_run(dsets):
    """pipeline x guard: the rail reads the retired batches' flags; a
    clean guarded pipelined run is the serial run bit for bit."""
    dt = dsets[1]
    ser = _port(dt, **_cfg("labor-0", steps=6))
    for mode in ("prefetch", "full"):
        out = _port(dt, **_cfg("labor-0", steps=6, pipeline=mode,
                               guard="quarantine", guard_warmup=2))
        assert dataclasses.asdict(out["guard_stats"]) == dict(
            quarantines=0, rollbacks=0, nonfinite_batches=0,
            spike_batches=0)
        _params_equal(out, ser)
