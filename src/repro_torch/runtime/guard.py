"""The guardrail runtime (twin of ``repro.runtime.guard``): NaN/Inf and
loss-spike detection with quarantine or checkpoint-rollback recovery,
and the one shared :class:`RetryPolicy` behind every bounded recovery
loop.

The train step computes a two-entry flag vector ``[nonfinite, spike]``
on the device beside the update (:func:`guard_update`), gates the
parameter, optimizer and EMA update off when a flag fires (a bad batch
changes nothing, like an overflowed one) and returns the flags in the
step's metrics. The host reads them one step late (:class:`GuardRail`),
through :class:`HostFlags`: at record time the flags go to pinned host
memory by a ``non_blocking`` copy with a CUDA event behind it, and the
read waits on that event only, never on the stream. So a clean run pays
no host synchronisation beyond the wait for a step that has already
finished. Only when a flag fires does the host act: ``quarantine``
re-draws the batch under a fresh ``fold_in`` salt (:func:`quarantine_key`),
escalating to rollback when re-draws keep faulting; ``rollback``
restores the last CRC-verified checkpoint and resumes from its step
(``runtime/trainer.py``).

Spike detection keeps a float32 loss EMA in ``{"ema", "steps"}``
(``EngineState.guard``, saved in checkpoints as ``guard///ema`` and
``guard///steps``). The EMA never absorbs a flagged or overflowed batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib


class GuardFault(RuntimeError):
    """A guarded run could not be healed: quarantine re-draws and
    checkpoint rollbacks both spent their budgets while the fault kept
    firing."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, deterministic retry schedule: at most ``max_retries + 1``
    attempts, ``grow`` (the escalation, e.g. cap doubling) after each
    failed one, no randomised backoff."""
    max_retries: int = 3

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")

    def run(self, attempt: Callable[[int], Any], *,
            grow: Optional[Callable[[int], None]] = None,
            error: type = RuntimeError,
            describe: str = "retry budget exhausted"):
        """Run ``attempt(i)`` until it returns non-None (the result) or
        the budget is spent; raises ``error(describe)`` on exhaustion."""
        for i in range(self.max_retries + 1):
            out = attempt(i)
            if out is not None:
                return out
            if grow is not None:
                grow(i)
        raise error(describe)


class HostFlags:
    """A small device flag vector on its way to the host. On a CUDA
    tensor the constructor enqueues a ``non_blocking`` copy into pinned
    host memory and records an event behind it; :meth:`read` waits on
    that event alone (not on the stream, so work queued after the flags
    keeps running) and returns the host copy. On the CPU it reads the
    tensor."""

    __slots__ = ("_flags", "_host", "_event")

    def __init__(self, flags: torch.Tensor):
        self._flags = flags
        self._host = self._event = None
        if flags.is_cuda:
            self._host = torch.empty(flags.shape, dtype=flags.dtype,
                                     pin_memory=True)
            self._host.copy_(flags, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def read(self) -> np.ndarray:
        if self._event is None:
            return self._flags.numpy()
        self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """mode: ``quarantine`` re-draws a flagged batch under a fresh salt
    (escalating to rollback); ``rollback`` restores the last good
    checkpoint. spike_factor: loss > factor x EMA flags a spike once
    ``warmup`` clean batches were absorbed. ema_beta: EMA decay per
    clean batch. max_quarantine: re-draws per flagged batch.
    max_rollbacks: rollbacks per run before :class:`GuardFault`."""
    mode: str = "quarantine"
    spike_factor: float = 4.0
    warmup: int = 5
    ema_beta: float = 0.9
    max_quarantine: int = 2
    max_rollbacks: int = 3

    def __post_init__(self):
        if self.mode not in ("quarantine", "rollback"):
            raise ValueError(f"guard mode must be 'quarantine' or "
                             f"'rollback', got {self.mode!r}")
        if self.spike_factor <= 1.0:
            raise ValueError("spike_factor must exceed 1.0")

    def quarantine_policy(self) -> RetryPolicy:
        return RetryPolicy(self.max_quarantine)

    def rollback_policy(self) -> RetryPolicy:
        return RetryPolicy(self.max_rollbacks)


def init_guard_state(device="cpu") -> dict:
    """The loss EMA (float32) and the count of clean batches it absorbed
    (int32), on ``device``."""
    return {"ema": torch.zeros((), dtype=torch.float32, device=device),
            "steps": torch.zeros((), dtype=torch.int32, device=device)}


def guard_update(cfg: GuardConfig, loss: torch.Tensor, grads, gstate: dict,
                 suppress: torch.Tensor):
    """Detect, and advance the EMA, with tensor ops only (no host read).

    ``grads``: the unclipped gradients (an iterable of tensors, or a
    dict of them). ``suppress``: the batch's overflow flag, which keeps an
    overflowed batch out of detection and the EMA. Returns ``(flags,
    gstate')``, ``flags`` = bool[2] ``[nonfinite, spike]``. The
    arithmetic is the reference's, in float32."""
    total = loss.to(torch.float32)
    for g in (grads.values() if isinstance(grads, dict) else grads):
        total = total + torch.sum(g).to(torch.float32)
    nonfinite = ~torch.isfinite(total)
    steps, ema = gstate["steps"], gstate["ema"]
    armed = steps >= cfg.warmup
    # a Python scalar times a float32 tensor is a float32 product, as
    # in the reference
    spike = armed & torch.isfinite(loss) & (loss > cfg.spike_factor * ema)
    bad = nonfinite | spike
    absorb = ~(bad | suppress)
    ema_new = torch.where(steps == 0, loss,
                          cfg.ema_beta * ema + (1.0 - cfg.ema_beta) * loss)
    gstate_out = {"ema": torch.where(absorb, ema_new, ema),
                  "steps": torch.where(absorb, steps + 1, steps)}
    flags = torch.stack([nonfinite, spike])
    flags = torch.where(suppress, torch.zeros_like(flags), flags)
    return flags, gstate_out


@dataclasses.dataclass
class GuardStats:
    quarantines: int = 0          # fresh-salt re-draw dispatches
    rollbacks: int = 0            # checkpoint restores
    nonfinite_batches: int = 0    # flagged [nonfinite]
    spike_batches: int = 0        # flagged [spike]


@dataclasses.dataclass
class _Watched:
    """One dispatched batch in the guard window."""
    step: int
    seeds: Any
    key: Any
    flags: HostFlags


class GuardRail:
    """The host side of the guard: ``record`` a dispatched batch's flags
    and the oldest batch is read only once ``depth`` newer ones sit on
    top of it, when its step has finished; ``flush`` drains the window
    (end of run, or before a checkpoint is saved); ``reset`` drops it
    (after a rollback). The rail only detects; the training loop
    recovers."""

    def __init__(self, cfg: GuardConfig, stats: Optional[GuardStats] = None,
                 depth: int = 1):
        if depth < 1:
            raise ValueError(f"guard window depth must be >= 1, got {depth}")
        self.cfg = cfg
        self.stats = stats or GuardStats()
        self.depth = depth
        self._window: Deque[_Watched] = deque()

    def record(self, step: int, seeds, key, flags) -> Optional[_Watched]:
        """Register a dispatched batch; returns the batch that fell out
        of the window if it was flagged, else None."""
        self._window.append(_Watched(step, seeds, key, HostFlags(flags)))
        if len(self._window) > self.depth:
            return self._polled(self._window.popleft())
        return None

    def flush(self) -> Optional[_Watched]:
        """Read every pending batch, oldest first; returns the first
        flagged one (callers re-invoke until None)."""
        while self._window:
            due = self._polled(self._window.popleft())
            if due is not None:
                return due
        return None

    def reset(self) -> None:
        """Drop the window unread: after a rollback its entries belong to
        a discarded trajectory."""
        self._window.clear()

    def _polled(self, w: _Watched) -> Optional[_Watched]:
        flags = w.flags.read()
        if not flags.any():
            return None
        if flags[0]:
            self.stats.nonfinite_batches += 1
        if flags[-1]:
            self.stats.spike_batches += 1
        return w


def quarantine_key(key: rng_lib.Key, attempt: int) -> rng_lib.Key:
    """The fresh salt of a quarantined batch's re-draw ``attempt``:
    ``fold_in(key, 0x51A7 + attempt)``, disjoint from the trainer's
    per-step keys (``fold_in`` of the base key, never of a step key)."""
    return rng_lib.fold_in(key, 0x51A7 + attempt)
