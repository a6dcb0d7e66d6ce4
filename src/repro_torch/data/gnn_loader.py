"""GNN minibatch feeding (twin of ``repro.data.gnn_loader``): shuffled
padded seed batches, a background prefetch thread with a straggler
watchdog, the eager overflow retry, and the overflow ledger of the
one-step-late replay protocol."""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.interface import pad_seeds
from repro_torch.runtime.guard import HostFlags, RetryPolicy


@dataclasses.dataclass
class LoaderStats:
    batches: int = 0
    overflow_retries: int = 0
    overflow_replays: int = 0   # batches replayed one step late
    stragglers_skipped: int = 0
    # pipelined path: in-flight batches re-sampled after a replay grew
    # the caps (runtime/pipeline.py)
    pipeline_invalidations: int = 0


class SamplingOverflowError(RuntimeError):
    """Sampling overflow persisted after the cap-doubling retry schedule
    was exhausted -- the one error type every retry surface raises."""


class SeedBatches:
    """Shuffled, padded seed batches over training vertices, each of the
    full ``batch_size`` (-1 padding), as int32 tensors on ``device``.
    The permutations are numpy's, so they equal the reference's."""

    def __init__(self, train_idx: np.ndarray, batch_size: int, seed: int = 0,
                 drop_last: bool = True, device="cpu"):
        self.train_idx = np.asarray(train_idx)
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.device = device
        self._at_cache: Optional[tuple] = None  # (epoch, permutation)

    def _batch(self, ids: np.ndarray) -> torch.Tensor:
        return pad_seeds(ids, self.batch_size, device=self.device)

    def epoch(self) -> Iterator[torch.Tensor]:
        perm = self.rng.permutation(self.train_idx)
        n_full = len(perm) // self.batch_size
        for i in range(n_full):
            yield self._batch(perm[i * self.batch_size:(i + 1)
                                   * self.batch_size])
        rem = len(perm) - n_full * self.batch_size
        if rem and not self.drop_last:
            yield self._batch(perm[-rem:])

    @property
    def per_epoch(self) -> int:
        """Full batches per epoch (the :meth:`at` schedule)."""
        return max(len(self.train_idx) // self.batch_size, 1)

    def at(self, step: int) -> torch.Tensor:
        """The batch for global ``step``, a pure function of ``(seed,
        step)``: epoch ``step // per_epoch`` is the permutation of
        ``default_rng((seed, epoch))`` (cached per epoch)."""
        epoch, i = divmod(step, self.per_epoch)
        if self._at_cache is None or self._at_cache[0] != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            self._at_cache = (epoch, rng.permutation(self.train_idx))
        perm = self._at_cache[1]
        return self._batch(perm[i * self.batch_size:(i + 1)
                                * self.batch_size])


class PrefetchIterator:
    """Runs ``produce`` on a background thread into a queue of ``depth``
    items. With ``straggler_timeout`` (seconds) a wait that outlasts it
    is skipped and counted in ``stats.stragglers_skipped`` (a slow
    producer does not stall the consumer; the item still arrives
    later)."""

    def __init__(self, produce: Iterator, depth: int = 2,
                 straggler_timeout: Optional[float] = None,
                 stats: Optional[LoaderStats] = None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.timeout = straggler_timeout
        self.stats = stats or LoaderStats()
        self._done = object()
        self._thread = threading.Thread(target=self._run, args=(produce,),
                                        daemon=True)
        self._thread.start()

    def _run(self, produce):
        try:
            for item in produce:
                self.q.put(item)
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = (self.q.get(timeout=self.timeout) if self.timeout
                        else self.q.get())
            except queue.Empty:
                # the producer missed the deadline: skip this slot
                self.stats.stragglers_skipped += 1
                continue
            if item is self._done:
                raise StopIteration
            self.stats.batches += 1
            return item


def sample_with_retry(sampler, graph, seeds, key,
                      stats: Optional[LoaderStats] = None,
                      max_retries: int = 3, *, backend=None):
    """Sample; on overflow double every cap and retry (one host read of
    the flags per attempt). Returns ``(blocks, sampler)``, the sampler
    with the caps that sufficed."""
    box = {"sampler": sampler}

    def attempt(_i):
        blocks = box["sampler"].sample_with_key(graph, seeds, key,
                                                backend=backend)
        if bool(torch.stack([b.overflow for b in blocks]).any()):
            return None
        return blocks

    def grow(_i):
        if stats is not None:
            stats.overflow_retries += 1
        box["sampler"] = box["sampler"].doubled()

    blocks = RetryPolicy(max_retries).run(
        attempt, grow=grow, error=SamplingOverflowError,
        describe="sampling overflow persisted after cap doubling")
    return blocks, box["sampler"]


class OverflowLedger:
    """The async overflow protocol of the train step: a step gates its
    update on the device's overflow flags (an overflowed batch changes
    nothing) and records them here; a record is read only once ``depth``
    newer ones sit on top of it, and an overflowed batch is handed back
    for replay with doubled caps. The serial engine and the pipelined
    driver (over its compute dispatches) both poll with ``depth`` 1.

    The read is late in fact, not only in name: ``record`` starts the
    flags' copy to pinned host memory behind a CUDA event
    (:class:`~repro_torch.runtime.guard.HostFlags`), and the poll waits
    on that event alone, so the steps queued after the polled one keep
    the card busy while the host reads."""

    def __init__(self, stats: Optional[LoaderStats] = None, depth: int = 1):
        if depth < 1:
            raise ValueError(f"ledger depth must be >= 1, got {depth}")
        self.stats = stats or LoaderStats()
        self.depth = depth
        self._pending: deque = deque()  # (tag, HostFlags), oldest first

    def record(self, tag, flags):
        """Register batch ``tag`` with its device-side flags; returns the
        tag of the batch that fell out of the ``depth``-deep window if it
        overflowed, else None."""
        self._pending.append((tag, HostFlags(flags)))
        if len(self._pending) > self.depth:
            return self._overflowed(self._pending.popleft())
        return None

    def flush(self):
        """Read every pending batch, oldest first; returns the first
        overflowed tag (callers re-invoke until None)."""
        while self._pending:
            due = self._overflowed(self._pending.popleft())
            if due is not None:
                return due
        return None

    def _overflowed(self, entry):
        tag, flags = entry
        if flags.read().any():
            self.stats.overflow_replays += 1
            return tag
        return None
