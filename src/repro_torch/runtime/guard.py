"""The one shared bounded retry loop (twin of
``repro.runtime.guard.RetryPolicy``). The guardrail itself (NaN/spike
flags, quarantine, rollback) belongs to training and is not ported."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


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
