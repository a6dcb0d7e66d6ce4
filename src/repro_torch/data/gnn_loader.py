"""The overflow error of the retry contract (twin of
``repro.data.gnn_loader.SamplingOverflowError``). The training loader
(seed batches, prefetch, the overflow ledger) is not ported yet."""
from __future__ import annotations


class SamplingOverflowError(RuntimeError):
    """Sampling overflow persisted after the cap-doubling retry schedule
    was exhausted -- the one error type every retry surface raises."""
