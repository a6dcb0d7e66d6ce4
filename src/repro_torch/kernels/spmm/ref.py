"""Plain PyTorch graph ops of a sampled block (twin of
``repro.kernels.spmm.ref``): the contracts of the kernels in
``csrc/spmm.cu`` and what their wrappers run on a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.core.cs_solve import SPILL_BINS, spill_index


def spmm_block_ref(src_slot, dst_slot, weight, mask, h, num_rows):
    """out[r] = sum_{e: dst_slot[e] = r, mask[e]} weight[e] * h[src_slot[e]]
    over ``num_rows`` rows; h (T, F) -> (num_rows, F). An edge whose
    ``dst_slot`` is negative matches no row."""
    F = h.shape[1]
    msg = h[torch.where(mask, src_slot, 0).long()] * weight[:, None].to(h.dtype)
    msg = torch.where(mask[:, None], msg, 0.0)
    seg = spill_index(mask & (dst_slot >= 0), dst_slot, num_rows)
    out = torch.zeros(num_rows + SPILL_BINS, F, dtype=h.dtype,
                      device=h.device)
    return out.scatter_add_(0, seg[:, None].expand(-1, F), msg)[:num_rows]


def spmm_transposed_ref(src_slot, dst_slot, weight, mask, perm, g, num_rows):
    """The aggregate's gradient for h: the SpMM with src and dst swapped,
    over the edges in ``perm`` (src-sorted) order; g (S, F) ->
    (num_rows, F)."""
    perm = perm.long()
    return spmm_block_ref(dst_slot[perm], src_slot[perm], weight[perm],
                          mask[perm], g, num_rows)


def gather_dst_ref(dst_slot, mask, rows):
    """out[e] = rows[dst_slot[e]] for masked-in edges, 0 elsewhere (and
    where the index is outside the rows); rows (S, F) -> (E, F)."""
    valid = mask & (dst_slot >= 0) & (dst_slot < rows.shape[0])
    out = rows[torch.where(valid, dst_slot, 0).long()]
    return torch.where(valid[:, None], out, 0.0)
