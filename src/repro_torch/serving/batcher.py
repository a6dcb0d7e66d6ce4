"""Requests and dynamic batch coalescing for the serving driver (twin of
``repro.serving.batcher``; host code, numpy only).

The engine's infer path has one fixed seed-buffer shape (the batch size
its cap schedule was derived for), and real traffic is a stream of much
smaller requests. The batcher packs pending requests FIFO into that
shape, whole requests only, so that scattering the answers back is a
slice per request; it pads the rest with ``pad_seeds``' -1 and slices
the per-seed logits back out to each request's ticket.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np


class AdmissionError(RuntimeError):
    """A request refused at admission: larger than the engine's seed
    buffer, or the queue is full (backpressure)."""


@dataclasses.dataclass
class Ticket:
    """Handle returned by ``ServingDriver.submit``: resolved with per-seed
    logits (``status == "ok"``), or terminally dropped (``timeout``,
    ``error``). Latency is measured from submit to resolve."""
    rid: int
    seeds: np.ndarray
    deadline_s: Optional[float]          # absolute monotonic deadline
    submitted_s: float
    status: str = "pending"              # pending | ok | timeout | error
    logits: Optional[np.ndarray] = None
    latency_ms: Optional[float] = None
    # served by a dispatch tagged as set-up (first dispatch, grow retry):
    # left out of the warm percentiles
    compile_tainted: bool = False
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def resolve(self, status: str, logits: Optional[np.ndarray] = None,
                *, now: Optional[float] = None) -> None:
        self.status = status
        self.logits = logits
        self.latency_ms = ((now or time.monotonic()) - self.submitted_s) * 1e3
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


@dataclasses.dataclass
class Batch:
    """One coalesced dispatch: the padded seed vector and the (ticket,
    lo, hi) slices that scatter the per-seed logits back."""
    seeds: np.ndarray                    # int32[B], -1 pad
    parts: List[Tuple[Ticket, int, int]]

    @property
    def n_seeds(self) -> int:
        return sum(hi - lo for _, lo, hi in self.parts)


def coalesce(pending: "deque[Ticket]", batch_size: int, *,
             now: Optional[float] = None) -> Tuple[Optional[Batch],
                                                   List[Ticket]]:
    """Pack pending tickets FIFO into one fixed-shape batch.

    Tickets past their absolute deadline are dropped and returned apart.
    Packs whole requests only and stops at the first ticket that does
    not fit, so FIFO order holds and a large request blocks at most one
    batch. Returns ``(batch or None, timed_out_tickets)``.
    """
    now = time.monotonic() if now is None else now
    timed_out: List[Ticket] = []
    parts: List[Tuple[Ticket, int, int]] = []
    used = 0
    while pending:
        t = pending[0]
        if t.deadline_s is not None and now > t.deadline_s:
            timed_out.append(pending.popleft())
            continue
        n = len(t.seeds)
        if used + n > batch_size:
            break
        pending.popleft()
        parts.append((t, used, used + n))
        used += n
    if not parts:
        return None, timed_out
    seeds = np.full((batch_size,), -1, np.int32)
    for t, lo, hi in parts:
        seeds[lo:hi] = t.seeds
    return Batch(seeds=seeds, parts=parts), timed_out


def scatter_back(batch: Batch, logits: np.ndarray, *,
                 compile_tainted: bool = False,
                 now: Optional[float] = None) -> None:
    """Slice the per-seed logits back to each packed ticket and resolve
    it."""
    now = time.monotonic() if now is None else now
    for t, lo, hi in batch.parts:
        t.compile_tainted = compile_tainted
        t.resolve("ok", logits[lo:hi], now=now)
