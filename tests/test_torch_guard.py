"""The port's guardrail and fault injection (``runtime/{guard,inject}.py``
and the guarded ``train_gnn``, ``TrainEngine`` and ``ServingDriver``)
against repro's, on the CPU (``generate`` mini graph, GCN of hidden 16,
two layers, batch 64, ten steps).

  * the injector registry and grammar: the same sites and defaults, the
    same parses and errors, ``fires`` / ``armed`` / ``log`` semantics;
  * ``guard_update`` against repro's on the same inputs over a sequence
    of batches (finite, NaN loss, Inf gradient, spikes before and after
    warmup, overflow-suppressed): flags and ``steps`` equal, ``ema``
    within rtol 2.4e-7 (two float32 ulps: the EMA's product and sum may
    be contracted into one fused multiply-add by XLA);
  * ``quarantine_key`` bit for bit against ``jax.random``;
  * the fault matrix (``nan_grad``, ``corrupt_feats``, ``corrupt_labels``
    x pipeline ``off`` / ``prefetch``): repro's ``inject_log`` and guard
    counters, the same sampled vertices, losses within atol 1e-5 + rtol
    1e-3 (``test_torch_train.py``'s bound);
  * a clean guarded run equal bit for bit to an unguarded one, from as
    many dispatches;
  * rollback equal bit for bit to an unfaulted run with and without a
    checkpoint and past a torn one; the rollback budget raising
    ``GuardFault``; ``overflow_storm`` replaying once and, exhausted,
    raising; a stalled pipeline stage changing nothing;
  * the serving sites: ``cache_corrupt`` falls back to cache-off,
    ``pump_death`` is restarted by the watchdog, ``stall_stage`` still
    serves;
  * every ``SITES`` entry is covered (``MATRIX``, as repro's).
"""
import dataclasses
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.graph.generators import DatasetSpec as JSpec  # noqa: E402
from repro.graph.generators import generate as jgen  # noqa: E402
from repro.runtime import guard as jguard  # noqa: E402
from repro.runtime import inject as jinject  # noqa: E402
from repro.runtime import trainer as jtrain  # noqa: E402
from repro_torch.core import rng as TR  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.data.gnn_loader import SamplingOverflowError  # noqa: E402
from repro_torch.graph.generators import DatasetSpec as TSpec  # noqa: E402
from repro_torch.graph.generators import generate as tgen  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.runtime import inject as inject_lib  # noqa: E402
from repro_torch.runtime import trainer as ttrain  # noqa: E402
from repro_torch.runtime.engine import TrainEngine  # noqa: E402
from repro_torch.runtime.guard import (GuardConfig, GuardFault,  # noqa: E402
                                       RetryPolicy, guard_update,
                                       init_guard_state, quarantine_key)

MINI = ("mini", 2000, 12.0, 16, 5, 0.5, 0.2, 0.6, 1000)
BASE = dict(hidden=16, fanouts=(4, 4), batch_size=64, steps=10, lr=1e-2,
            cap_safety=3.0)

# site -> the test(s) proving its recovery path; a site added to SITES
# without a test here fails test_sites_all_covered
MATRIX = {
    "nan_grad": "test_fault_matrix_quarantine / test_rollback_bit_exact",
    "corrupt_feats": "test_fault_matrix_quarantine / test_rollback_bit_exact",
    "corrupt_labels": "test_fault_matrix_quarantine",
    "overflow_storm": "test_overflow_storm_replays_once_then_exhausts",
    "torn_ckpt": "test_rollback_bit_exact[torn] + test_torch_checkpoint.py",
    "ckpt_error": "test_torch_checkpoint.py::test_async_saver_error_surfaces",
    "stall_stage": "test_stall_stage_pipeline_parity / "
                   "test_serving_cache_corrupt_and_stall",
    "cache_corrupt": "test_serving_cache_corrupt_and_stall",
    "pump_death": "test_serving_pump_death_watchdog",
}


@pytest.fixture(scope="module")
def dsets():
    return jgen(JSpec(*MINI), seed=0), tgen(TSpec(*MINI), seed=0)


def _port(ds, **kw):
    return ttrain.train_gnn(ds, ttrain.GNNTrainConfig(
        **{**BASE, "device": "cpu", **kw}))


def _params_equal(a, b):
    for (n, x), (_, y) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(x, y), n


@pytest.fixture(scope="module")
def clean(dsets):
    return _port(dsets[1])


# ----------------------------------------------------------------------
# the registry, the grammar, the plan
# ----------------------------------------------------------------------

def test_sites_all_covered():
    assert set(MATRIX) == set(inject_lib.SITES) == set(jinject.SITES)
    for site, (what, default) in jinject.SITES.items():
        got = inject_lib.SITES[site]
        assert got[0] == what
        assert got[1] == default or (np.isnan(got[1]) and np.isnan(default))
    assert inject_lib.ENV_VAR == jinject.ENV_VAR


@pytest.mark.parametrize("text", [
    "overflow_storm@3:2=1.5, nan_grad", "stall_stage@0", "torn_ckpt:4",
    "corrupt_feats@6=1e8,corrupt_labels@7", "  ", None])
def test_parse_matches_the_reference(text):
    got, want = inject_lib.parse(text), jinject.parse(text)
    if want is None:
        assert got is None
        return
    for a, b in zip(got.specs, want.specs):
        assert (a.site, a.at, a.count, a.param) == (b.site, b.at, b.count,
                                                    b.param)
        assert a.effect == b.effect or (np.isnan(a.effect)
                                        and np.isnan(b.effect))
    assert got.describe() == want.describe()


@pytest.mark.parametrize("text,match", [("rm_rf_slash@2", "unknown injector"),
                                        ("nan_grad@x", "malformed"),
                                        ("nan_grad@-1", "at must be"),
                                        ("nan_grad:0", "count >= 1")])
def test_parse_errors_match_the_reference(text, match):
    for mod in (inject_lib, jinject):
        with pytest.raises(ValueError, match=match):
            mod.parse(text)


def test_plan_fires_consumes_counts_and_logs(monkeypatch):
    plan = inject_lib.parse("stall_stage@3:2")
    assert plan.fires("stall_stage", 0) is None    # before `at`
    assert plan.fires("nan_grad", 99) is None      # unarmed site
    assert plan.fires("stall_stage", 3) is not None
    assert plan.fires("stall_stage", 7) is not None
    assert plan.fires("stall_stage", 8) is None    # count consumed
    assert plan.all_fired() and not plan.armed("stall_stage")
    assert plan.log == [("stall_stage", 3), ("stall_stage", 7)]
    monkeypatch.setenv(inject_lib.ENV_VAR, "pump_death@1")
    assert inject_lib.plan_from_env().specs[0].site == "pump_death"


def test_retry_policy_and_guard_config():
    calls = []
    with pytest.raises(GuardFault, match="gave up"):
        RetryPolicy(2).run(lambda i: calls.append(("try", i)) or None,
                           grow=lambda i: calls.append(("grow", i)),
                           error=GuardFault, describe="gave up")
    assert calls == [("try", 0), ("grow", 0), ("try", 1), ("grow", 1),
                     ("try", 2), ("grow", 2)]
    with pytest.raises(ValueError):
        GuardConfig(mode="panic")
    with pytest.raises(ValueError):
        GuardConfig(spike_factor=1.0)
    assert GuardConfig(max_quarantine=5).quarantine_policy().max_retries == 5


# ----------------------------------------------------------------------
# the device-side flag math
# ----------------------------------------------------------------------

#: (loss, gradient fill, suppress) per batch: clean, a spike before the
#: warmup ends, NaN loss, Inf gradient under a finite loss, a spike, an
#: overflowed NaN batch, a loss below the spike line
SEQUENCE = [(1.0, 0.5, False), (0.8, 0.5, False), (50.0, 0.1, False),
            (float("nan"), 0.1, False), (0.7, float("inf"), False),
            (1000.0, 0.1, False), (float("nan"), 0.1, True),
            (0.9, -0.2, False), (3.1, 0.0, False), (0.6, 0.3, False)]


@pytest.mark.parametrize("warmup,factor", [(2, 4.0), (0, 1.25), (5, 4.0)])
def test_guard_update_matches_the_reference(warmup, factor):
    cj = jguard.GuardConfig(warmup=warmup, spike_factor=factor)
    ct = GuardConfig(warmup=warmup, spike_factor=factor)
    gj, gt = jguard.init_guard_state(), init_guard_state()
    for loss, fill, suppress in SEQUENCE:
        shapes = {"w": (3, 4), "b": (4,)}
        fj, gj = jguard.guard_update(
            cj, jnp.float32(loss),
            {k: jnp.full(s, fill, jnp.float32) for k, s in shapes.items()},
            gj, jnp.asarray(suppress))
        ft, gt = guard_update(
            ct, torch.tensor(loss, dtype=torch.float32),
            {k: torch.full(s, fill) for k, s in shapes.items()}, gt,
            torch.tensor(suppress))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        assert int(gt["steps"]) == int(gj["steps"])
        assert gt["ema"].dtype == torch.float32
        np.testing.assert_allclose(float(gt["ema"]), float(gj["ema"]),
                                   rtol=2.4e-7)


@pytest.mark.parametrize("seed,attempt", [(7, 0), (7, 1), (2**31 - 1, 3)])
def test_quarantine_key_bit_exact(seed, attempt):
    base = jax.random.fold_in(jax.random.key(seed), 5)
    want = np.asarray(jax.random.key_data(jguard.quarantine_key(base,
                                                                attempt)))
    got = quarantine_key(TR.fold_in(TR.key(seed), 5), attempt)
    assert tuple(int(x) for x in want) == TR.key_data(got)


# ----------------------------------------------------------------------
# the fault matrix against repro
# ----------------------------------------------------------------------

BATCH_FAULTS = [("nan_grad@4", "nonfinite_batches"),
                ("corrupt_feats@6=1e8", "spike_batches"),
                ("corrupt_labels@7", "spike_batches")]


@pytest.mark.parametrize("pipeline", ["off", "prefetch"])
@pytest.mark.parametrize("spec,counter", BATCH_FAULTS)
def test_fault_matrix_quarantine(dsets, pipeline, spec, counter):
    """repro's matrix (spike factor 1.25: a rotated-label batch lands
    1.35-1.7x the EMA on this graph), in both packages."""
    dj, dt = dsets
    kw = dict(pipeline=pipeline, guard="quarantine", guard_warmup=2,
              guard_spike_factor=1.25, inject=spec)
    ref = jtrain.train_gnn(dj, jtrain.GNNTrainConfig(**BASE, **kw,
                                                     eval_every=1000))
    out = _port(dt, **kw)
    assert out["inject_log"] == [tuple(x) for x in ref["inject_log"]]
    assert [s for s, _ in out["inject_log"]] == [spec.split("@")[0]]
    gs, gj = out["guard_stats"], ref["guard_stats"]
    assert dataclasses.asdict(gs) == dataclasses.asdict(gj)
    assert getattr(gs, counter) >= 1
    assert gs.quarantines >= 1 and gs.rollbacks == 0
    assert len(out["history"]) == BASE["steps"]
    for a, b in zip(out["history"], ref["history"]):
        assert (a["step"], a["sampled_v"], a["sampled_e"]) == (
            b["step"], b["sampled_v"], b["sampled_e"])
        assert abs(a["loss"] - b["loss"]) <= 1e-5 + 1e-3 * abs(b["loss"])


def test_clean_guarded_run_bit_exact_same_dispatches(dsets, clean):
    import repro_torch.runtime.engine as engine_mod

    made = []
    orig = engine_mod.TrainEngine.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(self)

    engine_mod.TrainEngine.__init__ = spy
    try:
        counts = {}
        for guard in ("off", "quarantine"):
            made.clear()
            out = _port(dsets[1], guard=guard)
            counts[guard] = sum(e.dispatches for e in made)
    finally:
        engine_mod.TrainEngine.__init__ = orig
    _params_equal(out, clean)
    assert counts["off"] == counts["quarantine"] == BASE["steps"]
    assert out["guard_stats"].quarantines == out["guard_stats"].rollbacks == 0


# ----------------------------------------------------------------------
# rollback and its budget
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["checkpoint", "no checkpoint", "torn"])
def test_rollback_bit_exact(dsets, clean, case):
    """A transient fault healed by rollback lands on the unfaulted
    trajectory bit for bit: batches and keys are pure functions of the
    step."""
    steps = 12 if case == "torn" else BASE["steps"]
    ref = clean if steps == BASE["steps"] else _port(dsets[1], steps=steps)
    with tempfile.TemporaryDirectory() as d:
        if case == "checkpoint":
            kw = dict(ckpt_dir=d, ckpt_every=5, inject="corrupt_feats@6=1e8")
            log = [("corrupt_feats", 6)]
        elif case == "no checkpoint":
            kw = dict(inject="nan_grad@4")
            log = [("nan_grad", 4)]
        else:
            kw = dict(ckpt_dir=d, ckpt_every=4,
                      inject="torn_ckpt@1,nan_grad@9")
            log = [("torn_ckpt", 1), ("nan_grad", 9)]
        out = _port(dsets[1], steps=steps, guard="rollback", guard_warmup=2,
                    **kw)
    assert out["guard_stats"].rollbacks == 1
    assert out["inject_log"] == log
    assert [h["step"] for h in out["history"]] == list(range(1, steps + 1))
    _params_equal(out, ref)


def test_torn_checkpoint_logs_in_loop_order_with_a_slow_writer(
        dsets, monkeypatch):
    """The torn write of step 8 is logged before step 9's fault even when
    the save thread is still writing while step 9 runs: the checkpoint
    faults are decided on the training thread."""
    from repro_torch.runtime import checkpoint as ckpt_lib
    write = ckpt_lib._write

    def slow_write(*args):
        threading.Event().wait(0.5)
        return write(*args)

    monkeypatch.setattr(ckpt_lib, "_write", slow_write)
    with tempfile.TemporaryDirectory() as d:
        out = _port(dsets[1], steps=12, guard="rollback", guard_warmup=2,
                    ckpt_dir=d, ckpt_every=4,
                    inject="torn_ckpt@1,corrupt_feats@9=1e8")
    assert out["inject_log"] == [("torn_ckpt", 1), ("corrupt_feats", 9)]
    assert out["guard_stats"].rollbacks == 1


def test_rollback_budget_exhaustion_raises_guardfault(dsets):
    with pytest.raises(GuardFault, match="rollback budget exhausted"):
        _port(dsets[1], guard="rollback", guard_max_rollbacks=1,
              inject="nan_grad@4:100")


# ----------------------------------------------------------------------
# overflow storm and stalls
# ----------------------------------------------------------------------

def _engine(ds, plan=None, retries=3):
    s = TS.from_dataset("labor-0", ds, batch_size=32, fanouts=(4,),
                        safety=3.0)
    eng = TrainEngine(s, tadam.AdamConfig(lr=1e-2), device="cpu",
                      inject=plan, max_replay_retries=retries)
    model = tgnn.gcn_init(TR.key(0), ds.features.shape[1], 16,
                          int(ds.labels.max()) + 1, 1, device="cpu")
    return eng, model, eng.make_data_from_dataset(ds)


def test_overflow_storm_replays_once_then_exhausts(dsets):
    ds = dsets[1]
    plan = inject_lib.parse("overflow_storm@1:1")
    eng, model, data = _engine(ds, plan)
    state = eng.init_state(model)
    rng = np.random.default_rng(0)
    for i in range(4):
        seeds = torch.as_tensor(rng.integers(0, 2000, size=32))
        model, state, _ = eng.step(model, state, data, seeds,
                                   TR.fold_in(TR.key(1), i), tag=i)
    model, state, _ = eng.flush(model, state, data)
    assert plan.all_fired()
    assert eng.stats.overflow_replays == eng.stats.overflow_retries == 1
    assert eng.generation == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())

    plan = inject_lib.parse("overflow_storm@0:100")
    eng, model, data = _engine(ds, plan, retries=1)
    state = eng.init_state(model)
    seeds = torch.arange(32)
    with pytest.raises(SamplingOverflowError):
        for i in range(3):
            model, state, _ = eng.step(model, state, data, seeds,
                                       TR.fold_in(TR.key(1), i), tag=i)
        eng.flush(model, state, data)


def test_stall_stage_pipeline_parity(dsets):
    plan = inject_lib.parse("stall_stage@2:2=0.05")
    ref = _port(dsets[1], pipeline="prefetch")
    stalled = _port(dsets[1], pipeline="prefetch", inject=plan)
    assert plan.all_fired()
    _params_equal(ref, stalled)


# ----------------------------------------------------------------------
# the serving sites
# ----------------------------------------------------------------------

def _serving(ds, plan=None, cache=False, **kw):
    from repro_torch.serving import ServingDriver, VertexCache
    eng, model, data = _engine(ds)
    return ServingDriver(eng, model, data, batch_size=32,
                         feature_cache=VertexCache(512) if cache else None,
                         inject=plan, **kw)


def test_serving_cache_corrupt_and_stall(dsets):
    # two corruptions spaced so the cache refills between them: the first
    # invalidates and re-serves cache-off, the second exhausts
    # cache_fault_limit and the caches stay off
    plan = inject_lib.parse("cache_corrupt@2,cache_corrupt@4,"
                            "stall_stage@1:1=0.05")
    drv = _serving(dsets[1], plan, cache=True, cache_fault_limit=2)
    tickets = []
    for _ in range(6):
        tickets.append(drv.submit(np.arange(8)))
        drv.pump()
    assert plan.all_fired()
    assert drv.stats.nonfinite_batches == 2
    assert drv.stats.cache_fallbacks == 1 and drv.feature_cache is None
    for t in tickets:
        assert t.status == "ok" and np.isfinite(t.logits).all()


def test_serving_pump_death_watchdog(dsets):
    plan = inject_lib.parse("pump_death@1")
    drv = _serving(dsets[1], plan, watchdog_interval_s=0.02)
    hook = threading.excepthook
    threading.excepthook = lambda args: None   # the killed thread's report
    try:
        drv.start()
        rng = np.random.default_rng(0)
        tickets = [drv.submit(rng.integers(0, 2000, size=4))
                   for _ in range(4)]
        assert all(t.wait(timeout=30) for t in tickets)
        drv.stop()
    finally:
        threading.excepthook = hook
    assert plan.all_fired() and plan.log == [("pump_death", 1)]
    assert drv.stats.pump_restarts >= 1
    assert all(t.status == "ok" for t in tickets)
