"""Serving-side latency / SLO / cache accounting (copy of
``repro.serving.metrics``, numpy only, so both launchers print the same
report keys).

One recorder serves both serving paths: the async driver
(:mod:`repro_torch.serving.driver`) and the synchronous ``--driver off``
path of ``launch/serve.py``. Set-up time is not latency: the first
dispatch (which builds the CUDA kernels on first use and warms the
device) and every ``engine.grow()`` retry are recorded as tagged
"compile" events, excluded from the warm p50/p99 and reported
separately.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ServingStats:
    """Running counters + event log for one serving run.

    Latency samples land in ``warm_ms`` only when the dispatch hit an
    already-compiled program; compile-tagged samples (first dispatch of
    a program generation, grow retries) go to ``events``. Request
    accounting: ``served`` completed OK, ``timeouts`` dropped past
    their deadline before dispatch, ``rejected`` refused at admission
    (queue full / oversized), ``slo_miss`` served but slower than
    their deadline.
    """
    submitted: int = 0
    served: int = 0
    timeouts: int = 0
    rejected: int = 0
    slo_miss: int = 0
    batches: int = 0
    occupancy: int = 0          # valid seeds packed across all batches
    seeds_served: int = 0       # valid seeds in warm (timed) batches
    grow_events: int = 0
    cache_invalidations: int = 0
    # degradation accounting (docs/robustness.md): batch dispatches that
    # raised (tickets resolved "error"), the last cause, watchdog pump
    # restarts, deadlined requests shed at admission under queue
    # pressure, nonfinite-logit batches under an enabled cache, and
    # permanent cache-off fallbacks after repeated cache faults
    pump_errors: int = 0
    last_error: Optional[str] = None
    pump_restarts: int = 0
    shed: int = 0
    nonfinite_batches: int = 0
    cache_fallbacks: int = 0
    feat_hits: int = 0
    feat_misses: int = 0
    hidden_hits: int = 0
    max_served_age: int = 0
    warm_ms: List[float] = dataclasses.field(default_factory=list)
    warm_seconds: float = 0.0
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    # -- recording -----------------------------------------------------

    def record_batch(self, seconds: float, n_seeds: int, n_requests: int,
                     *, compile_event: bool, grows: int = 0) -> None:
        self.batches += 1
        self.occupancy += n_seeds
        if compile_event:
            self.events.append({"kind": "compile", "ms":
                                round(seconds * 1e3, 3), "grows": grows})
        else:
            self.warm_ms.append(seconds * 1e3)
            self.warm_seconds += seconds
            self.seeds_served += n_seeds

    def record_cache(self, m: Dict[str, Any]) -> None:
        """Fold one program's device-side cache metrics (already
        host-synced by the caller) into the running totals."""
        self.feat_hits += int(m.get("hits", 0))
        self.feat_misses += int(m.get("misses", 0))
        self.hidden_hits += int(m.get("hidden_hits", 0))
        self.max_served_age = max(self.max_served_age,
                                  int(m.get("max_served_age", 0)))

    # -- derived -------------------------------------------------------

    @property
    def hit_rate(self) -> Optional[float]:
        tot = self.feat_hits + self.feat_misses
        return self.feat_hits / tot if tot else None

    def percentile_ms(self, q: float) -> Optional[float]:
        if not self.warm_ms:
            return None
        return float(np.percentile(np.asarray(self.warm_ms), q))

    @property
    def nodes_per_sec(self) -> Optional[float]:
        if self.warm_seconds <= 0:
            return None
        return self.seeds_served / self.warm_seconds

    def report(self) -> Dict[str, Any]:
        """The JSON-friendly summary both serve paths print."""
        p50, p99 = self.percentile_ms(50), self.percentile_ms(99)
        nps = self.nodes_per_sec
        compile_ms = sum(e["ms"] for e in self.events
                         if e["kind"] == "compile")
        out = {
            "requests_served": self.served,
            "timeouts": self.timeouts,
            "rejected": self.rejected,
            "slo_miss": self.slo_miss,
            "batches": self.batches,
            "avg_batch_occupancy": (round(self.occupancy / self.batches, 2)
                                    if self.batches else None),
            "latency_ms_p50": None if p50 is None else round(p50, 3),
            "latency_ms_p99": None if p99 is None else round(p99, 3),
            "nodes_per_sec": None if nps is None else round(nps, 1),
            "compile_events": len(self.events),
            "compile_ms_total": round(compile_ms, 1),
            "grow_events": self.grow_events,
        }
        if self.feat_hits or self.feat_misses:
            out["cache_hit_rate"] = round(self.hit_rate, 4)
        if self.hidden_hits:
            out["hidden_hits"] = self.hidden_hits
            out["max_served_age"] = self.max_served_age
        if self.cache_invalidations:
            out["cache_invalidations"] = self.cache_invalidations
        if self.pump_errors:
            out["pump_errors"] = self.pump_errors
            out["last_error"] = self.last_error
        if self.pump_restarts:
            out["pump_restarts"] = self.pump_restarts
        if self.shed:
            out["shed"] = self.shed
        if self.nonfinite_batches:
            out["nonfinite_batches"] = self.nonfinite_batches
        if self.cache_fallbacks:
            out["cache_fallbacks"] = self.cache_fallbacks
        return out
