"""The serving subsystem (twin of ``repro.serving``): continuous batching
and device-resident vertex caches behind an async request driver.

:class:`ServingDriver` packs a stream of small requests into the
engine's fixed-shape infer request (continuous batching, deadline and
SLO accounting); :class:`VertexCache` and :class:`HiddenCache` keep hot
vertices' feature rows and deepest-layer hidden states on the device,
keyed by vertex id through the frontier ``hash_dedup`` primitive.
"""
from repro_torch.serving.batcher import (AdmissionError, Batch, Ticket,
                                         coalesce, scatter_back)
from repro_torch.serving.cache import CacheState, HiddenCache, VertexCache
from repro_torch.serving.driver import ServingDriver
from repro_torch.serving.metrics import ServingStats

__all__ = [
    "AdmissionError", "Batch", "Ticket", "coalesce", "scatter_back",
    "CacheState", "HiddenCache", "VertexCache",
    "ServingDriver", "ServingStats",
]
