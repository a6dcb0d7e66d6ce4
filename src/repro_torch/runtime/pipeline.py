"""The pipelined training driver: sample-ahead execution of the engine's
staged step (twin of ``repro.runtime.pipeline``), on one device or on
a mesh.

The sampling half of a step depends on the salt only, not on the
parameters, so batch t+1's blocks can be queued while batch t trains.
The driver runs the engine's stages (:meth:`TrainEngine.sample_stage`,
:meth:`TrainEngine.gather_stage` and the compute) ahead of each other:

``prefetch``
    ``sample(t+1)`` is queued before ``gather(t)`` + ``compute(t)`` are
    consumed (depth 1).

``full``
    ``sample(t+2)`` and ``gather(t+1)`` are queued while ``compute(t)``
    trains (depth 2).

Every stage runs on the current stream, as in the reference's single
execution stream: the stages are the serial step's ops in the serial
step's order per batch, so the sampled sets and the parameters equal
the serial run's. On a mesh the stages are the mesh engine's (seed
routing and partition-local sampling; the feature all-to-all; the
partitioned compute and the gradient all-reduce): every rank runs the
same driver, so the ranks call the same collectives in the same order.

Overflow protocol: the driver owns an :class:`~repro_torch.data.
gnn_loader.OverflowLedger` of depth 1 over compute dispatches. Computes
retire in batch order through the serial engine's record / poll /
replay protocol, so the order of applied updates (an overflowed batch is
a gated no-op, replayed after the next batch's update) is the serial
one at any depth. A replay doubles the caps (``engine.grow()``), which
makes every queued batch stale: :meth:`PipelinedEngine._invalidate`
re-samples them at the grown caps, as the serial engine samples every
later batch (``stats.pipeline_invalidations`` counts them).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Tuple

from repro_torch.data.gnn_loader import OverflowLedger
from repro_torch.runtime.engine import EngineData, EngineState, TrainEngine

MODES = ("prefetch", "full")


@dataclasses.dataclass
class _InFlight:
    """One sampled-ahead batch: what the driver needs to retire, replay
    or re-sample it."""
    seeds: Any
    key: Any
    tag: Any
    sampler: Any          # engine.sampler when the batch was sampled
    blocks: Any
    gathered: Any = None  # full mode: (feats, labels)


class PipelinedEngine:
    """Drives a :class:`TrainEngine`'s stages with ``depth`` batches
    sampled ahead of the compute at the head of the queue (1 for
    ``prefetch``, 2 for ``full``). Route every training step of the
    engine through it."""

    def __init__(self, engine: TrainEngine, mode: str = "prefetch"):
        if mode not in MODES:
            raise ValueError(f"pipeline mode must be one of {MODES}, "
                             f"got {mode!r}")
        self.engine = engine
        self.mode = mode
        self.depth = 1 if mode == "prefetch" else 2
        self.stats = engine.stats
        # poll lag 1 over compute dispatches: the serial protocol
        self._ledger = OverflowLedger(engine.stats, depth=1)
        self._queue: deque = deque()
        self._sample_dispatches = 0

    @property
    def in_flight(self) -> int:
        """Batches sampled but not yet retired by a compute."""
        return len(self._queue)

    def _sample(self, data: EngineData, seeds, key):
        inj = self.engine.inject
        if inj is not None and inj.armed("stall_stage"):
            spec = inj.fires("stall_stage", self._sample_dispatches)
            if spec is not None:
                time.sleep(spec.effect)   # a stalled sample stage
        self._sample_dispatches += 1
        return self.engine.sample_stage(data.graph, seeds, key)

    def _enqueue(self, data: EngineData, seeds, key, tag):
        ent = _InFlight(seeds=seeds, key=key, tag=tag,
                        sampler=self.engine.sampler,
                        blocks=self._sample(data, seeds, key))
        if self.mode == "full":
            ent.gathered = self.engine.gather_stage(data.features,
                                                    data.labels, ent.blocks)
        return ent

    def _compute(self, model, state: EngineState, data: EngineData,
                 ent: _InFlight):
        self.engine.dispatches += 1
        gathered = ent.gathered
        if gathered is None:   # prefetch: the gather heads the compute
            gathered = self.engine.gather_stage(data.features, data.labels,
                                                ent.blocks)
        return self.engine._compute(model, state, ent.blocks, *gathered)

    def _retire(self, model, state, data, done: List[Tuple[Any, Any]]):
        """Pop the oldest batch, dispatch its compute and run the record
        / poll / replay protocol: the serial step with its sampling
        already queued."""
        ent = self._queue.popleft()
        model, state, m = self._compute(model, state, data, ent)
        done.append((ent.tag, m))
        due = self._ledger.record((ent.seeds, ent.key, ent.tag, ent.sampler),
                                  self.engine._read_overflow(m))
        if due is not None:
            model, state, _ = self.engine._replay(model, state, data, *due)
            self._invalidate(data)
        return model, state

    def _invalidate(self, data: EngineData):
        """Re-sample every queued batch sampled at caps a replay has
        since doubled; sampled sets do not depend on the caps."""
        for i, ent in enumerate(self._queue):
            if ent.sampler is self.engine.sampler:
                continue
            self.stats.pipeline_invalidations += 1
            self._queue[i] = self._enqueue(data, ent.seeds, ent.key, ent.tag)

    def step(self, model, state: EngineState, data: EngineData, seeds, key,
             tag: Any = None):
        """Feed one batch. Returns ``(model, state, done)``, ``done`` the
        ``(tag, metrics)`` of every batch whose compute was dispatched in
        this call: none while the pipeline fills, one a call after.
        Replay metrics land in ``engine.replayed``.

        Retire before enqueue: the retire ends in the ledger's poll,
        which waits for the compute before the one just dispatched; with
        the sample queued first that compute would sit behind the
        sample's work in the single stream."""
        done: List[Tuple[Any, Any]] = []
        while len(self._queue) >= self.depth:
            model, state = self._retire(model, state, data, done)
        self._queue.append(self._enqueue(data, seeds, key, tag))
        return model, state, done

    def flush(self, model, state: EngineState, data: EngineData):
        """Retire every queued batch, then drain the ledger (end of
        training, or before a checkpoint: a gated no-op batch must be
        replayed before its parameters are saved). Returns ``(model,
        state, done)``."""
        done: List[Tuple[Any, Any]] = []
        while self._queue:
            model, state = self._retire(model, state, data, done)
        while True:
            due = self._ledger.flush()
            if due is None:
                break
            model, state, _ = self.engine._replay(model, state, data, *due)
        return model, state, done

    def reset(self):
        """Drop every queued batch and the ledger window unretired (the
        guardrail's rollback: they belong to a discarded trajectory)."""
        self._queue.clear()
        self._ledger = OverflowLedger(self.engine.stats, depth=1)
        self.engine.reset_protocol()
