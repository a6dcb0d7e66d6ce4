"""Graph-ops primitives behind the backend registry (twin of
``repro.ops``): the model's ``aggregate`` and the frontier family the
sampler's block epilogue runs on. Forward only in this package."""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.ops.backend import (BACKEND_CHOICES, get_backend,
                                     resolve_backend)
from repro_torch.ops.frontier import compact, compact_perm, hash_dedup

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.interface import SampledLayer


def aggregate(blk: "SampledLayer", h: torch.Tensor, *,
              backend: Optional[str] = None) -> torch.Tensor:
    """out[s] = sum_e A'_e h[src_e] per destination seed: h over
    ``blk.next_seeds`` in, h over ``blk.seeds`` out."""
    return get_backend(backend, h.device).aggregate(blk, h)


__all__ = ["BACKEND_CHOICES", "aggregate", "compact", "compact_perm",
           "get_backend", "hash_dedup", "resolve_backend"]
