"""Plain PyTorch SpMM (twin of ``repro.kernels.spmm.ref``): the contract
of the kernel in ``csrc/spmm.cu`` and what its wrapper runs on a CPU
tensor."""
from __future__ import annotations

import torch

from repro_torch.core.cs_solve import SPILL_BINS, spill_index


def spmm_block_ref(src_slot, dst_slot, weight, mask, h, num_rows):
    """out[r] = sum_{e: dst_slot[e] = r, mask[e]} weight[e] * h[src_slot[e]]
    over ``num_rows`` rows; h (T, F) -> (num_rows, F)."""
    F = h.shape[1]
    msg = h[torch.where(mask, src_slot, 0).long()] * weight[:, None].to(h.dtype)
    msg = torch.where(mask[:, None], msg, 0.0)
    seg = spill_index(mask, dst_slot, num_rows)
    out = torch.zeros(num_rows + SPILL_BINS, F, dtype=h.dtype,
                      device=h.device)
    return out.scatter_add_(0, seg[:, None].expand(-1, F), msg)[:num_rows]
