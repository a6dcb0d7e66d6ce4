"""The async request driver: continuous batching over the engine's infer
request (twin of ``repro.serving.driver``).

The synchronous path of ``launch/serve.py`` pays one fixed-shape dispatch
per request, so a 4-seed request costs as much as a full batch. This
driver keeps a queue instead and, whenever the device is free,
coalesces what is pending (whole requests, FIFO) into one fixed-shape
dispatch (:mod:`repro_torch.serving.batcher`), then slices the per-seed
logits back to each request's ticket: no waiting for a full batch under
light load, full batches under heavy load, one cap schedule throughout.

Per request:

* **Admission.** ``submit`` refuses a request larger than the seed
  buffer and, once ``max_queue`` tickets are pending, refuses instead of
  buffering without bound (:class:`~repro_torch.serving.batcher.
  AdmissionError`). Under queue pressure it sheds a deadlined request
  that the warm p50 says cannot be served in time.
* **Deadlines.** A request still queued past its deadline is dropped as
  a timeout, never dispatched; one served later than it counts as an
  SLO miss. p50/p99 cover warm batches only: the first dispatch and
  every grow are tagged set-up events (:mod:`repro_torch.serving.
  metrics`).
* **Overflow.** A cap overflow follows the training contract:
  ``engine.grow()`` and a retry with the same key, raising
  ``SamplingOverflowError`` when doubling stops helping. A grow
  invalidates the caches (counted in ``stats.cache_invalidations``).
* **Cache faults.** Non-finite logits with a cache on re-serve the
  batch cache-off under the same key; after ``cache_fault_limit`` such
  faults the caches stay off.

The driver owns the cache states (:mod:`repro_torch.serving.cache`) and
passes them through ``engine.cached_infer_fn``; with both caches off it
dispatches ``engine.infer``. Batch ``i`` (from 1) is keyed by
``rng.fold_in(rng.key(seed), i)``, as in the reference, so a trace
served twice, with or without caches, or by either package, sees the
same salts per batch.

Use it inline (``pump`` until drained: deterministic, what the tests and
``launch/serve.py`` do) or on a background thread (``start``/``stop``,
with a watchdog that restarts a dead pump). ``inject`` (a
``runtime/inject.py`` plan) arms the serving sites: ``stall_stage``
sleeps in the dispatch, ``cache_corrupt`` NaN-poisons the cache tables
before the firing batch (the cache-fault path must recover), both
indexed by the batch ordinal, and ``pump_death`` kills the background
pump (the watchdog must restart it), indexed by the pump's iteration.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.data.gnn_loader import SamplingOverflowError
from repro_torch.runtime.engine import EngineData, TrainEngine
from repro_torch.runtime.guard import RetryPolicy
from repro_torch.runtime.inject import InjectedThreadDeath
from repro_torch.serving.batcher import (AdmissionError, Ticket, coalesce,
                                         scatter_back)
from repro_torch.serving.cache import HiddenCache, VertexCache
from repro_torch.serving.metrics import ServingStats


class ServingDriver:
    """Continuous-batching serving loop over one
    :class:`~repro_torch.runtime.engine.TrainEngine`.

    Args:
      engine: the engine whose infer request answers the batches (its
        sampler's cap schedule fixes the seed-buffer shape).
      params: the served model (a ``repro_torch.models.gnn`` module),
        frozen for the driver's life.
      data: :meth:`TrainEngine.make_data` of the served graph.
      batch_size: the seed-buffer shape, the coalescing target (the
        batch size the sampler's caps were derived for).
      feature_cache / hidden_cache: optional cache configurations; the
        state is the driver's.
      deadline_ms: default per-request deadline (None: no deadline).
      max_queue: pending tickets before admission refuses.
      max_grows: cap doublings per dispatch before
        ``SamplingOverflowError`` reaches every ticket of the batch.
      seed: base of the per-batch key schedule.
      inject: a fault-injection plan (``runtime.inject.FaultPlan``).
      cache_fault_limit: non-finite-logit faults under an enabled cache
        before the driver turns the caches off for good.
      watchdog_interval_s: how often the watchdog checks that the
        background pump is alive.
    """

    def __init__(self, engine: TrainEngine, params, data: EngineData, *,
                 batch_size: int,
                 feature_cache: Optional[VertexCache] = None,
                 hidden_cache: Optional[HiddenCache] = None,
                 deadline_ms: Optional[float] = None,
                 max_queue: int = 1024, max_grows: int = 4, seed: int = 0,
                 inject=None, cache_fault_limit: int = 2,
                 watchdog_interval_s: float = 0.05):
        self.engine = engine
        self.params = params
        self.data = data
        self.batch_size = int(batch_size)
        self.feature_cache = feature_cache
        self.hidden_cache = hidden_cache
        self.deadline_ms = deadline_ms
        self.max_queue = int(max_queue)
        self.max_grows = int(max_grows)
        self.cache_fault_limit = int(cache_fault_limit)
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.inject = inject
        self.stats = ServingStats()
        self._key = rng_lib.key(seed)
        self._batch_index = 0
        self._pump_iter = 0
        self._pending: deque = deque()
        self._lock = threading.Lock()
        self._rid = 0
        self._fc_state = None
        self._hc_state = None
        self._cache_gen = engine.generation
        self._cache_faults = 0
        self._compiled_gens: set = set()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()
        self._init_cache_state()

    # ------------------------------------------------------------------
    # cache state
    # ------------------------------------------------------------------

    def _init_cache_state(self):
        feats = self.data.features
        if self.feature_cache is not None:
            self._fc_state = self.feature_cache.init_state(
                feats.shape[1], feats.dtype, feats.device)
        if self.hidden_cache is not None:
            self._hc_state = self.hidden_cache.init_state(
                self._hidden_dim(), device=feats.device)

    def _hidden_dim(self) -> int:
        # the deepest layer's output width: its bias's length
        return int(self.params.layers[0].b.shape[-1])

    def _invalidate_caches(self):
        """Cold-restart the cache tables (after ``engine.grow()`` or a
        cache fault): a cold cache refills in a few batches."""
        if self.feature_cache is None and self.hidden_cache is None:
            return
        self.stats.cache_invalidations += 1
        self._init_cache_state()

    @property
    def cache_states(self):
        """(feature cache state, hidden cache state), None where off."""
        return self._fc_state, self._hc_state

    # ------------------------------------------------------------------
    # request side
    # ------------------------------------------------------------------

    def submit(self, seeds, deadline_ms: Optional[float] = None) -> Ticket:
        """Enqueue one request (thread-safe): a 1-D array of vertex ids.
        Raises :class:`AdmissionError` for a request larger than the
        seed buffer, a full queue, or a deadline the queue cannot
        meet."""
        seeds = np.asarray(seeds, np.int32).reshape(-1)
        now = time.monotonic()
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        with self._lock:
            self.stats.submitted += 1
            if seeds.size == 0 or seeds.size > self.batch_size:
                self.stats.rejected += 1
                raise AdmissionError(
                    f"request of {seeds.size} seeds does not fit the "
                    f"engine's {self.batch_size}-seed infer program")
            if len(self._pending) >= self.max_queue:
                self.stats.rejected += 1
                raise AdmissionError(
                    f"queue full ({self.max_queue} pending) — backpressure")
            # under queue pressure (a full batch already ahead), shed a
            # deadlined request that the warm latency says cannot be
            # served in time
            if dl is not None and len(self._pending) >= self.batch_size:
                est = self._estimated_wait_ms(len(self._pending))
                if est is not None and est > dl:
                    self.stats.shed += 1
                    raise AdmissionError(
                        f"load shed: estimated wait {est:.1f}ms exceeds "
                        f"the {dl:g}ms deadline")
            self._rid += 1
            t = Ticket(rid=self._rid, seeds=seeds,
                       deadline_s=None if dl is None else now + dl / 1e3,
                       submitted_s=now)
            self._pending.append(t)
        self._work.set()
        return t

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _estimated_wait_ms(self, pending_n: int) -> Optional[float]:
        """Batches ahead of a new request times the warm p50; None until
        there is a warm sample (never shed blind)."""
        p50 = self.stats.percentile_ms(50)
        if p50 is None:
            return None
        batches_ahead = -(-(pending_n + 1) // self.batch_size)
        return batches_ahead * p50

    # ------------------------------------------------------------------
    # serving side
    # ------------------------------------------------------------------

    def _batch_key(self):
        return rng_lib.fold_in(self._key, self._batch_index)

    def _apply_injectors(self):
        """The serving sites of the fault plan: ``stall_stage`` sleeps in
        the dispatch, ``cache_corrupt`` multiplies every float table of
        the cache states by NaN (the non-finite-logit fallback must
        recover)."""
        inj = self.inject
        if inj is None:
            return
        if inj.armed("stall_stage"):
            spec = inj.fires("stall_stage", self._batch_index)
            if spec is not None:
                time.sleep(spec.effect)
        if inj.armed("cache_corrupt") and (self._fc_state is not None
                                           or self._hc_state is not None):
            spec = inj.fires("cache_corrupt", self._batch_index)
            if spec is not None:
                def nan_poison(state):
                    return dataclasses.replace(state, **{
                        f.name: getattr(state, f.name) * float("nan")
                        for f in dataclasses.fields(state)
                        if getattr(state, f.name).is_floating_point()})
                if self._fc_state is not None:
                    self._fc_state = nan_poison(self._fc_state)
                if self._hc_state is not None:
                    self._hc_state = nan_poison(self._hc_state)

    def _infer_batch(self, seeds_np: np.ndarray):
        """One dispatch of the (cache-aware) infer request under the
        grow-and-retry overflow protocol (:class:`RetryPolicy`). Returns
        (logits as numpy, set-up event, cache metrics)."""
        eng = self.engine
        seeds = torch.as_tensor(seeds_np, device=eng.device)
        self._batch_index += 1
        key = self._batch_key()
        self._apply_injectors()

        def attempt(_i):
            if eng.generation != self._cache_gen:
                self._invalidate_caches()
                self._cache_gen = eng.generation
            compile_event = eng.generation not in self._compiled_gens
            cm = {}
            if self.feature_cache is None and self.hidden_cache is None:
                logits, ovf = eng.infer(self.params, self.data, seeds, key)
                fc2 = hc2 = None
            else:
                fn = eng.cached_infer_fn(self.feature_cache,
                                         self.hidden_cache)
                logits, ovf, fc2, hc2, cm = fn(
                    self.params, self.data.graph, self.data.features,
                    self._fc_state, self._hc_state, seeds, key)
            if bool(ovf.any()):
                return None
            # commit the cache states only for a clean dispatch
            if self.feature_cache is not None:
                self._fc_state = fc2
            if self.hidden_cache is not None:
                self._hc_state = hc2
            self._compiled_gens.add(eng.generation)
            return logits.cpu().numpy(), compile_event, cm

        def grow(_i):
            eng.grow()
            eng.stats.overflow_retries += 1
            self.stats.grow_events += 1

        return RetryPolicy(self.max_grows).run(
            attempt, grow=grow, error=SamplingOverflowError,
            describe="sampling overflow persisted after cap doubling "
                     "while serving")

    def _recover_cache_fault(self, seeds_np: np.ndarray) -> np.ndarray:
        """Non-finite logits under an enabled cache: cold-restart the
        caches, re-serve this batch cache-off under the same key, and
        after ``cache_fault_limit`` faults keep the caches off."""
        self.stats.nonfinite_batches += 1
        self._invalidate_caches()
        self._cache_faults += 1
        if self._cache_faults >= self.cache_fault_limit:
            self.feature_cache = None
            self.hidden_cache = None
            self._fc_state = self._hc_state = None
            self.stats.cache_fallbacks += 1
        seeds = torch.as_tensor(seeds_np, device=self.engine.device)
        logits, _ = self.engine.infer(self.params, self.data, seeds,
                                      self._batch_key())
        return logits.cpu().numpy()

    def pump(self) -> int:
        """Serve at most one coalesced batch. Returns the requests
        resolved (served and timed out); 0 means the queue was empty."""
        with self._lock:
            batch, timed_out = coalesce(self._pending, self.batch_size)
        now = time.monotonic()
        for t in timed_out:
            t.resolve("timeout", now=now)
            self.stats.timeouts += 1
        if batch is None:
            return len(timed_out)
        t0 = time.perf_counter()
        try:
            logits, compile_event, cm = self._infer_batch(batch.seeds)
            if (not np.isfinite(logits).all()
                    and (self.feature_cache is not None
                         or self.hidden_cache is not None)):
                logits = self._recover_cache_fault(batch.seeds)
                compile_event = True  # the retry's timing is tainted
        except Exception as e:
            # no ticket is stranded: every request of the batch resolves
            # "error" and the cause lands in the stats
            now = time.monotonic()
            for t, _, _ in batch.parts:
                t.resolve("error", now=now)
            self.stats.pump_errors += 1
            self.stats.last_error = f"{type(e).__name__}: {e}"
            if isinstance(e, SamplingOverflowError):
                raise
            return len(timed_out) + len(batch.parts)
        dt = time.perf_counter() - t0
        self.stats.record_batch(dt, batch.n_seeds, len(batch.parts),
                                compile_event=compile_event)
        self.stats.record_cache({k: v.cpu().numpy() for k, v in cm.items()})
        now = time.monotonic()
        scatter_back(batch, logits, compile_tainted=compile_event, now=now)
        for t, _, _ in batch.parts:
            self.stats.served += 1
            if t.deadline_s is not None and now > t.deadline_s:
                self.stats.slo_miss += 1
        return len(timed_out) + len(batch.parts)

    def drain(self) -> int:
        """Pump until the queue is empty; returns the requests
        resolved."""
        n = 0
        while True:
            served = self.pump()
            if served == 0 and self.pending == 0:
                return n
            n += served

    # ------------------------------------------------------------------
    # background loop
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Run the serving loop on a background thread until
        :meth:`stop`. A watchdog thread restarts the pump if its thread
        dies, also of a death the loop's own handler cannot catch (the
        ``pump_death`` injector raises a ``BaseException``)."""
        if self._thread is not None:
            raise RuntimeError("driver already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                inj = self.inject
                if inj is not None and inj.armed("pump_death"):
                    if inj.fires("pump_death", self._pump_iter) is not None:
                        raise InjectedThreadDeath(
                            f"pump killed at iteration {self._pump_iter}")
                self._pump_iter += 1
                try:
                    served = self.pump()
                except SamplingOverflowError:
                    # pump() resolved the batch's tickets as errors; keep
                    # serving what can be served
                    continue
                if served == 0:
                    self._work.clear()
                    self._work.wait(timeout=0.05)

        def watchdog():
            while not self._stop.wait(timeout=self.watchdog_interval_s):
                if self._thread is not None and not self._thread.is_alive():
                    self.stats.pump_restarts += 1
                    self._thread = threading.Thread(target=loop, daemon=True)
                    self._thread.start()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        self._watchdog = threading.Thread(target=watchdog, daemon=True)
        self._watchdog.start()

    def stop(self, drain: bool = True) -> None:
        if self._thread is None:
            return
        if drain:
            while self.pending:
                time.sleep(0.001)
        self._stop.set()
        self._work.set()
        self._thread.join()
        self._watchdog.join()
        self._thread = None
        self._watchdog = None
