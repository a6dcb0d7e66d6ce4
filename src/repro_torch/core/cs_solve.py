"""Per-seed reductions of the c_s solve (twin of ``repro.core.cs_solve``).

Only ``_segment_sum`` is ported: LABOR-0 solves c_s in closed form
(``core/labor.py``), and the Hajek denominators of ``build_block`` are
its one remaining segment reduction.
"""
from __future__ import annotations

import torch

#: dropped entries are spread over this many spill bins past the real
#: segments: on the card, millions of atomic adds into one spill address
#: serialise
SPILL_BINS = 1024


def spill_index(keep: torch.Tensor, index: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """``index`` where ``keep``, else one of SPILL_BINS bins at
    ``num_bins + (position mod SPILL_BINS)``, as int64 for scatters."""
    pos = torch.arange(index.shape[0], device=index.device)
    return torch.where(keep, index.long(), num_bins + pos % SPILL_BINS)


def _segment_sum(vals: torch.Tensor, slots: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """out[s] = sum of vals[e] over slots[e] == s; slots < 0 dropped.

    Floats are summed in another order than XLA's on the card (atomic
    adds), so results may differ from the reference in the last bits;
    no integer decision of LABOR-0 depends on them."""
    seg = spill_index(slots >= 0, slots, num_segments)
    out = torch.zeros(num_segments + SPILL_BINS, dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(0, seg, vals)[:num_segments]
