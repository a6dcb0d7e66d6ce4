"""Plain PyTorch graph ops of a sampled block (twin of
``repro.kernels.spmm.ref``): the contracts of the kernels in
``csrc/spmm.cu`` and what their wrappers run on a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.core.cs_solve import SPILL_BINS, spill_index


def gather_rows_ref(rows, index, valid):
    """rows[index] where ``valid``, 0 elsewhere (a negative index wraps,
    as a torch index does). The invalid entries read one of SPILL_BINS
    zero rows appended to ``rows``, so that their (zero) gradients spread
    over those rows: a sampled block's padded edges, ~10x its live ones,
    would otherwise pile their adds onto one row on the card. An
    ``index_select``, whose backward is an ``index_add_``: a tensor
    index's backward sorts the indices and sums each run serially."""
    S = rows.shape[0]
    ext = torch.cat([rows, rows.new_zeros(SPILL_BINS, rows.shape[1])])
    index = torch.where(index < 0, index + S, index)
    return ext.index_select(0, spill_index(valid, index, S))


def spmm_block_ref(src_slot, dst_slot, weight, mask, h, num_rows):
    """out[r] = sum_{e: dst_slot[e] = r, mask[e]} weight[e] * h[src_slot[e]]
    over ``num_rows`` rows; h (T, F) -> (num_rows, F). An edge whose
    ``dst_slot`` is negative matches no row."""
    msg = gather_rows_ref(h, src_slot, mask) * weight[:, None].to(h.dtype)
    return scatter_rows_ref(dst_slot, mask, msg, num_rows)


def spmm_transposed_ref(src_slot, dst_slot, weight, mask, perm, g, num_rows):
    """The aggregate's gradient for h: the SpMM with src and dst swapped,
    over the edges in ``perm`` (src-sorted) order; g (S, F) ->
    (num_rows, F)."""
    perm = perm.long()
    return spmm_block_ref(dst_slot[perm], src_slot[perm], weight[perm],
                          mask[perm], g, num_rows)


def scatter_rows_ref(dst_slot, mask, values, num_rows, perm=None):
    """out[r] = sum_{e: dst_slot[e] = r, mask[e]} values[e] over
    ``num_rows`` rows, the edges read in ``perm`` order when it is given
    (the backward of ``gather_src`` through ``src_perm``); values (E, F)
    -> (num_rows, F). An edge whose ``dst_slot`` is negative matches no
    row."""
    if perm is not None:
        perm = perm.long()
        dst_slot, mask, values = dst_slot[perm], mask[perm], values[perm]
    F = values.shape[1]
    vals = torch.where(mask[:, None], values, 0.0)
    seg = spill_index(mask & (dst_slot >= 0), dst_slot, num_rows)
    out = torch.zeros(num_rows + SPILL_BINS, F, dtype=values.dtype,
                      device=values.device)
    return out.scatter_add(0, seg[:, None].expand(-1, F), vals)[:num_rows]


def gather_dst_ref(dst_slot, mask, rows):
    """out[e] = rows[dst_slot[e]] for masked-in edges, 0 elsewhere (and
    where the index is outside the rows); rows (S, F) -> (E, F)."""
    valid = mask & (dst_slot >= 0) & (dst_slot < rows.shape[0])
    return gather_rows_ref(rows, dst_slot, valid)
