"""Frontier-primitive dispatch -- the sampling half of the backend
registry (twin of ``repro.ops.frontier``). Each call goes to the backend
resolved for its tensors' device (``repro_torch.ops.backend``).
``n_live`` is an optional int32 device scalar: entries at index >=
n_live are masked, and the kernels bound their work by it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.ops.backend import get_backend


def hash_dedup(values: torch.Tensor, mask: torch.Tensor,
               seeds: Optional[torch.Tensor], new_cap: int, *,
               backend: Optional[str] = None,
               n_live: Optional[torch.Tensor] = None):
    """Unique new values (ascending, -1 pad) among masked ``values`` not
    in ``seeds``, plus the value -> slot lookup into ``[seeds ; new]``
    (a ``DedupResult``)."""
    return get_backend(backend, values.device).hash_dedup(
        values, mask, seeds, new_cap, n_live)


def compact(flags: torch.Tensor, cap: int, *, backend: Optional[str] = None,
            n_live: Optional[torch.Tensor] = None):
    """Order-preserving stream compaction: (sel int32[cap], emask
    bool[cap], num int32[])."""
    return get_backend(backend, flags.device).compact(flags, cap, n_live)


def compact_perm(keys: torch.Tensor, valid: torch.Tensor, num_keys: int, *,
                 backend: Optional[str] = None,
                 n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable permutation sorting entries by ascending key (keys in
    [-1, num_keys); invalid last) -- ``SampledLayer.src_perm``."""
    return get_backend(backend, keys.device).compact_perm(
        keys, valid, num_keys, n_live)


def segment_select(keys: torch.Tensor, slot: torch.Tensor, mask: torch.Tensor,
                   seg_start: torch.Tensor, take: torch.Tensor, *,
                   backend: Optional[str] = None,
                   n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment smallest-``take`` selection over segment-contiguous
    edges, ties by arrival order (sequential Poisson): bool[E]."""
    return get_backend(backend, keys.device).segment_select(
        keys, slot, mask, seg_start, take, n_live)


def masked_cdf_draw(p: torch.Tensor, valid: torch.Tensor,
                    u: torch.Tensor, *,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Inverse-CDF draws over the valid entries of ``p`` (LADIES): for
    each u in [0, 1) the first index whose normalised CDF reaches u,
    clipped into the buffer: int32[n]."""
    return get_backend(backend, p.device).masked_cdf_draw(p, valid, u)
