"""The async serving driver of repro_torch (``serving/{batcher,cache,
driver}.py``, ``TrainEngine.cached_infer_fn``, ``serve_gnn_driver``)
against repro's, on the CPU.

  * ``coalesce`` and ``scatter_back`` pack and slice the same queues as
    repro's;
  * the caches alone, on an id stream that evicts: the same rows, hit
    counts and tables as repro's, for ``fifo`` and ``freq``;
  * on a ``generate`` mini graph with a Zipfian trace of 16-seed
    requests, and repro's GCN parameters carried across by
    ``params_from_jax``, the port's driver and repro's give the same
    ticket statuses, the same per-batch ``hits`` / ``misses`` /
    ``unique_misses``, the same cache ``keys`` / ``freq`` / ``born``
    after every batch (bit for bit, ``fifo`` and ``freq``) and logits
    within rtol = atol = 1e-4;
  * in the port, cache-on equals cache-off bit for bit at ``max_age=0``,
    and a hidden cache of ``max_age > 0`` under the ``full`` sampler
    serves stale rows that are still exact;
  * a grow invalidates the caches; admission, backpressure, shedding and
    timeouts; the background thread serves, restarts a dead pump and
    stops;
  * ``serve_gnn_driver`` through ``main(... --device cpu)`` prints
    repro's report keys and values.
"""
import json
import sys
import time
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serving as JV  # noqa: E402
from repro.core import samplers as JS  # noqa: E402
from repro.graph.generators import DatasetSpec as JSpec  # noqa: E402
from repro.graph.generators import generate as jgen  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adam  # noqa: E402
from repro.runtime.engine import TrainEngine as JEngine  # noqa: E402
from repro_torch import serving as TV  # noqa: E402
from repro_torch.core import samplers as TS  # noqa: E402
from repro_torch.data.gnn_loader import SamplingOverflowError  # noqa: E402
from repro_torch.graph.generators import DatasetSpec as TSpec  # noqa: E402
from repro_torch.graph.generators import generate as tgen  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.runtime import inject as TI  # noqa: E402
from repro_torch.runtime.engine import TrainEngine as TEngine  # noqa: E402

B, FANOUTS, HIDDEN, N_CLS = 64, (4, 3), 16, 5
MINI = ("mini", 2000, 12.0, 16, N_CLS, 0.5, 0.2, 0.6, 1000)


@pytest.fixture(scope="module")
def dsets():
    return jgen(JSpec(*MINI), seed=0), tgen(TSpec(*MINI), seed=0)


@pytest.fixture(scope="module")
def params(dsets):
    """repro's GCN parameters and the port's model carrying them."""
    dj, _ = dsets
    p = jgnn.gcn_init(jax.random.key(3), dj.features.shape[1], HIDDEN,
                      N_CLS, len(FANOUTS))
    tree = {"layers": [{k: np.asarray(v) for k, v in layer.items()}
                       for layer in p["layers"]]}
    return p, tgnn.params_from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def trace(dsets):
    """12 Zipfian requests of 16 seeds over the validation ids (repeats
    within and across requests): 3 coalesced batches of 64."""
    idx = np.asarray(dsets[0].val_idx)
    rng = np.random.default_rng(11)
    p = np.arange(1, len(idx) + 1, dtype=np.float64) ** -1.1
    return [rng.choice(idx, size=16, p=p / p.sum()) for _ in range(12)]


def _engines(dsets, name="labor-0"):
    dj, dt = dsets
    kw = dict(batch_size=B, fanouts=FANOUTS, safety=3.0)
    ej = JEngine(JS.from_dataset(name, dj, **kw), jgnn.gcn_apply,
                 adam.AdamConfig(), backend="xla")
    et = TEngine(TS.from_dataset(name, dt, **kw), device="cpu")
    return (ej, ej.make_data_from_dataset(dj)), (et,
                                                 et.make_data_from_dataset(dt))


def _port_driver(dsets, model, name="labor-0", **kw):
    _, (et, data) = _engines(dsets, name)
    return TV.ServingDriver(et, model, data, batch_size=B, seed=9, **kw)


def _spy_cache_metrics(driver):
    """Record each batch's cache metrics as the driver folds them in."""
    seen = []
    orig = driver.stats.record_cache

    def spy(m):
        seen.append({k: int(v) for k, v in m.items()})
        orig(m)

    driver.stats.record_cache = spy
    return seen


# ----------------------------------------------------------------------
# batcher
# ----------------------------------------------------------------------

def _queues(n_each=(10, 30, 20, 40, 5), deadlines=(None, 5.0, 0.5, None,
                                                  None)):
    """The same queue of tickets in both packages (submitted at t=0)."""
    out = []
    for mod in (JV, TV):
        q = deque()
        for i, (n, dl) in enumerate(zip(n_each, deadlines)):
            q.append(mod.Ticket(rid=i, seeds=np.arange(n, dtype=np.int32)
                                + 100 * i, deadline_s=dl, submitted_s=0.0))
        out.append(q)
    return out


@pytest.mark.parametrize("batch,now", [(64, 1.0), (40, 1.0), (64, 0.1),
                                       (8, 1.0)])
def test_coalesce_and_scatter_back_match(batch, now):
    qj, qt = _queues()
    while qj or qt:
        bj, tj = JV.coalesce(qj, batch, now=now)
        bt, tt = TV.coalesce(qt, batch, now=now)
        assert [t.rid for t in tt] == [t.rid for t in tj]
        assert (bt is None) == (bj is None)
        if bj is None:   # empty, or a request larger than the batch heads it
            assert [t.rid for t in qt] == [t.rid for t in qj]
            break
        np.testing.assert_array_equal(bt.seeds, bj.seeds)
        assert bt.seeds.dtype == bj.seeds.dtype
        assert [(t.rid, lo, hi) for t, lo, hi in bt.parts] == [
            (t.rid, lo, hi) for t, lo, hi in bj.parts]
        assert bt.n_seeds == bj.n_seeds
        logits = np.random.default_rng(0).normal(size=(batch, 3))
        JV.scatter_back(bj, logits, now=2.0)
        TV.scatter_back(bt, logits, compile_tainted=True, now=2.0)
        for (a, _, _), (b, _, _) in zip(bj.parts, bt.parts):
            assert b.status == a.status == "ok" and b.done and b.wait(0)
            np.testing.assert_array_equal(b.logits, a.logits)
            assert b.latency_ms == a.latency_ms and b.compile_tainted
        assert len(qt) == len(qj)


# ----------------------------------------------------------------------
# the caches alone
# ----------------------------------------------------------------------

def _same_state(st, sj, what):
    for f in ("keys", "freq", "born", "ptr", "step", "values"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert a.dtype == b.dtype, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} {f}")


@pytest.mark.parametrize("policy", ["fifo", "freq"])
def test_caches_alone_match(policy):
    """Feature and hidden cache on an id stream ten times the capacity:
    the same rows, metrics and tables as repro's after every call."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(300, 8)).astype(np.float32)
    fj, fcj = jnp.asarray(feats), JV.VertexCache(16, policy)
    fct = TV.VertexCache(16, policy)
    hcj, hct = JV.HiddenCache(12, 1, policy), TV.HiddenCache(12, 1, policy)
    gather_j = jax.jit(lambda s, ids: fcj.gather(
        s, ids, lambda m: jnp.take(fj, m, axis=0, mode="fill",
                                   fill_value=0)))
    sub_j = jax.jit(hcj.substitute)
    sj, st = fcj.init_state(8), fct.init_state(8)
    hj, ht = hcj.init_state(8), hct.init_state(8)
    ft = torch.from_numpy(feats)

    def fetch(m):
        return torch.where((m >= 0)[:, None],
                           ft[torch.where(m >= 0, m, 0).long()], 0.0)

    for i in range(8):
        ids = rng.integers(0, 60 if i % 2 else 300, size=24).astype(np.int32)
        ids[::7] = -1
        rj, sj, mj = gather_j(sj, jnp.asarray(ids))
        rt, st, mt = fct.gather(st, torch.from_numpy(ids), fetch)
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        assert {k: int(v) for k, v in mt.items()} == {
            k: int(v) for k, v in mj.items()}
        _same_state(st, sj, f"feature call {i}")
        fresh = rng.normal(size=(24, 8)).astype(np.float32)
        fresh[ids < 0] = 0
        # a vertex's fresh row is one value, wherever it repeats
        for v in np.unique(ids):
            fresh[ids == v] = fresh[np.argmax(ids == v)]
        rj, hj, mj = sub_j(hj, jnp.asarray(ids), jnp.asarray(fresh))
        rt, ht, mt = hct.substitute(ht, torch.from_numpy(ids),
                                    torch.from_numpy(fresh))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        assert {k: int(v) for k, v in mt.items()} == {
            k: int(v) for k, v in mj.items()}
        _same_state(ht, hj, f"hidden call {i}")
    with pytest.raises(ValueError):
        TV.VertexCache(0)
    with pytest.raises(ValueError):
        TV.VertexCache(4, "lru")
    with pytest.raises(ValueError):
        TV.HiddenCache(4, max_age=-1)


# ----------------------------------------------------------------------
# the driver against repro's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fifo", "freq"])
def test_driver_matches_the_reference(dsets, params, trace, policy):
    pj, model = params
    (ej, dj), (et, dt) = _engines(dsets)
    caches = dict(feature_cache=(400, policy), hidden_cache=(48, policy))
    drv_j = JV.ServingDriver(
        ej, pj, dj, batch_size=B, seed=9,
        feature_cache=JV.VertexCache(*caches["feature_cache"]),
        hidden_cache=JV.HiddenCache(48, 0, policy))
    drv_t = TV.ServingDriver(
        et, model, dt, batch_size=B, seed=9,
        feature_cache=TV.VertexCache(*caches["feature_cache"]),
        hidden_cache=TV.HiddenCache(48, 0, policy))
    seen_j, seen_t = _spy_cache_metrics(drv_j), _spy_cache_metrics(drv_t)
    tj = [drv_j.submit(r) for r in trace]
    tt = [drv_t.submit(r) for r in trace]
    for batch in range(3):
        assert drv_t.pump() == drv_j.pump() == 4
        assert seen_t[batch] == seen_j[batch], batch
        for st, sj in zip(drv_t.cache_states,
                          (drv_j._fc_state, drv_j._hc_state)):
            for f in ("keys", "freq", "born", "ptr", "step"):
                np.testing.assert_array_equal(
                    getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                    err_msg=f"batch {batch} {f}")
    assert drv_t.pump() == drv_j.pump() == 0
    assert seen_t[-1]["unique_misses"] > 0 and seen_t[-1]["hits"] > 0
    assert [t.status for t in tt] == [t.status for t in tj] == ["ok"] * 12
    for a, b in zip(tj, tt):
        assert b.logits.shape == (16, N_CLS)
        np.testing.assert_allclose(b.logits, a.logits, rtol=1e-4, atol=1e-4)
    rj, rt = drv_j.stats.report(), drv_t.stats.report()
    assert set(rt) == set(rj)
    for k in ("requests_served", "batches", "avg_batch_occupancy",
              "cache_hit_rate", "grow_events"):
        assert rt[k] == rj[k], k


def test_cache_on_equals_cache_off(dsets, params, trace):
    """max_age=0: the tickets' logits with both caches on equal those
    with both off, bit for bit; the hidden cache never serves."""
    _, model = params
    off = _port_driver(dsets, model)
    on = _port_driver(dsets, model,
                      feature_cache=TV.VertexCache(100, "fifo"),
                      hidden_cache=TV.HiddenCache(32, 0, "freq"))
    t_off = [off.submit(r) for r in trace]
    t_on = [on.submit(r) for r in trace]
    off.drain()
    on.drain()
    for a, b in zip(t_off, t_on):
        assert a.status == b.status == "ok"
        np.testing.assert_array_equal(b.logits, a.logits)
    assert on.stats.feat_hits > 0 and on.stats.hidden_hits == 0


def test_stale_hidden_rows_are_exact_under_full(dsets, params, trace):
    """The ``full`` sampler is deterministic, so a hidden row computed
    batches ago is the row of today: max_age > 0 serves hits that leave
    the logits bit for bit, and no entry older than max_age."""
    _, model = params
    off = _port_driver(dsets, model, name="full")
    on = _port_driver(dsets, model, name="full",
                      hidden_cache=TV.HiddenCache(256, max_age=2))
    reqs = trace * 2
    t_off = [off.submit(r) for r in reqs]
    t_on = [on.submit(r) for r in reqs]
    off.drain()
    on.drain()
    for a, b in zip(t_off, t_on):
        np.testing.assert_array_equal(b.logits, a.logits)
    assert on.stats.hidden_hits > 0
    assert 0 < on.stats.max_served_age <= 2


def test_grow_invalidates_the_caches(dsets, params, trace):
    _, model = params
    drv = _port_driver(dsets, model,
                       feature_cache=TV.VertexCache(400, "fifo"))
    drv.submit(trace[0])
    drv.drain()
    fc, _ = drv.cache_states
    assert int(fc.step) == 1 and int((fc.keys >= 0).sum()) > 0
    fn = drv.engine.cached_infer_fn(drv.feature_cache, None)
    assert drv.engine.cached_infer_fn(drv.feature_cache, None) is fn
    drv.engine.grow()
    assert drv.engine.cached_infer_fn(drv.feature_cache, None) is not fn
    t = drv.submit(trace[1])
    drv.drain()
    assert t.status == "ok" and drv.stats.cache_invalidations == 1
    fc, _ = drv.cache_states
    assert int(fc.step) == 1                 # restarted from a cold table
    assert len(drv.stats.events) == 2        # both dispatches set-up
    hc = TV.HiddenCache(8)
    seeds = torch.full((B,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-layer model"):
        drv.engine.cached_infer_fn(None, hc)(
            lambda *a, **k: None, drv.data.graph, drv.data.features, None,
            hc.init_state(HIDDEN), seeds, (0, 1))


def test_admission_backpressure_and_timeouts(dsets, params):
    _, model = params
    drv = _port_driver(dsets, model, max_queue=2)
    with pytest.raises(TV.AdmissionError, match="does not fit"):
        drv.submit(np.arange(B + 1))
    with pytest.raises(TV.AdmissionError):
        drv.submit([])
    drv.submit([1, 2])
    late = drv.submit([3, 4], deadline_ms=0.001)
    with pytest.raises(TV.AdmissionError, match="backpressure"):
        drv.submit([5])
    assert drv.pending == 2 and drv.stats.rejected == 3
    time.sleep(0.01)
    assert drv.drain() == 2
    assert late.status == "timeout" and drv.stats.timeouts == 1
    assert drv.stats.served == 1
    # shedding: with a warm p50 and a full batch queued ahead, a deadline
    # shorter than the estimated wait is refused at admission
    drv = _port_driver(dsets, model, max_queue=100, deadline_ms=1e6)
    drv.stats.warm_ms.append(50.0)
    for _ in range(B):
        drv.submit([7])
    with pytest.raises(TV.AdmissionError, match="load shed"):
        drv.submit([8], deadline_ms=60.0)
    assert drv.stats.shed == 1
    with pytest.raises(ValueError, match="malformed injector spec"):
        _port_driver(dsets, model, inject=TI.parse("cache_corrupt@one"))


def test_overflow_grows_then_raises(dsets, params):
    """A cap overflow grows and retries with the same key; when doubling
    cannot help, every ticket of the batch resolves "error" and
    ``SamplingOverflowError`` reaches the caller."""
    _, model = params
    drv = _port_driver(dsets, model, max_grows=0)
    caps = [TS.LayerCaps(128, 128, 256), TS.LayerCaps(128, 128, 512)]
    drv.engine.sampler = drv.engine.sampler.with_caps(caps)
    t = drv.submit(np.asarray(dsets[1].val_idx[:B]))
    with pytest.raises(SamplingOverflowError):
        drv.pump()
    assert t.status == "error" and drv.stats.pump_errors == 1
    drv = _port_driver(dsets, model, max_grows=8)
    drv.engine.sampler = drv.engine.sampler.with_caps(caps)
    t = drv.submit(np.asarray(dsets[1].val_idx[:B]))
    drv.drain()
    assert t.status == "ok" and drv.stats.grow_events >= 1


class _Death(BaseException):
    """Kills the pump's thread (nothing in the loop catches it)."""


def test_background_thread_serves_restarts_and_stops(dsets, params, trace):
    _, model = params
    drv = _port_driver(dsets, model, watchdog_interval_s=0.01)
    orig, calls = drv.pump, {"n": 0}

    def pump():
        calls["n"] += 1
        if calls["n"] == 1:
            raise _Death()
        return orig()

    drv.pump = pump
    import threading
    hook = threading.excepthook
    threading.excepthook = lambda args: None   # the killed thread's report
    try:
        drv.start()
        with pytest.raises(RuntimeError, match="already started"):
            drv.start()
        tickets = [drv.submit(r) for r in trace[:6]]
        assert all(t.wait(60) for t in tickets)
        drv.stop()
    finally:
        threading.excepthook = hook
    assert [t.status for t in tickets] == ["ok"] * 6
    assert drv.stats.pump_restarts >= 1 and drv.stats.served == 6
    assert drv._thread is None
    drv.stop()                                  # stopping twice is a no-op


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

SERVE_ARGS = ["--workload", "gnn", "--driver", "async", "--dataset",
              "products", "--scale", "0.004", "--sampler", "labor-0",
              "--fanouts", "5,5,5", "--hidden", "32", "--batch", "64",
              "--requests", "8", "--request-size", "16", "--trace", "zipf",
              "--feature-cache", "512", "--hidden-cache", "128",
              "--cache-policy", "freq"]


def test_serve_gnn_driver_prints_the_reference_report(monkeypatch, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE_ARGS)
    jserve.main()
    ref = json.loads(capsys.readouterr().out)
    report = tserve.main(SERVE_ARGS + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == set(ref) and out == report
    for k in ("driver", "sampler", "exact", "accuracy", "batches",
              "requests_served", "request_size", "batch",
              "avg_batch_occupancy", "cache_hit_rate", "grow_events",
              "timeouts", "rejected"):
        assert out[k] == ref[k], k
    assert out["driver"] == "async" and out["backend"] == "eager"
    args = tserve.parser().parse_args([])
    assert (args.workload, args.batch, args.driver, args.device) == (
        "lm", 4, "async", "cuda")
    assert (args.feature_cache, args.hidden_cache, args.max_age,
            args.cache_policy, args.deadline_ms, args.max_queue,
            args.cache_fault_limit) == (0, 0, 0, "fifo", None, 1024, 2)
