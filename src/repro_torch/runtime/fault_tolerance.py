"""Simulated preemptions and supervised restarts (twin of
``repro.runtime.fault_tolerance``).

On a cluster the runtime gets SIGTERM ahead of a preemption and the
scheduler relaunches the job; here :func:`run_with_restarts` plays the
scheduler and :class:`Preemptor` the signal, so a test can train to
step N, be killed, restart from the checkpoint and finish.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


class SimulatedPreemption(RuntimeError):
    pass


@dataclasses.dataclass
class Preemptor:
    """Raises :class:`SimulatedPreemption` once, when ``check`` is called
    at a step >= ``fire_step``."""
    fire_step: Optional[int] = None
    fired: bool = False

    def check(self, step: int):
        if (self.fire_step is not None and not self.fired
                and step >= self.fire_step):
            self.fired = True
            raise SimulatedPreemption(f"preempted at step {step}")


def run_with_restarts(job: Callable[[], dict], max_restarts: int = 3,
                      restartable: tuple = (SimulatedPreemption,)) -> dict:
    """Run ``job`` (which resumes from its checkpoint directory),
    restarting it on an exception in ``restartable``, at most
    ``max_restarts`` times. Returns the job's result with
    ``"restarts"`` set; any other exception fails at once."""
    restarts = 0
    while True:
        try:
            out = job()
            out["restarts"] = restarts
            return out
        except restartable:
            restarts += 1
            if restarts > max_restarts:
                raise
