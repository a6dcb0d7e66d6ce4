"""Plain PyTorch edge softmax (twin of
``repro.kernels.edge_softmax.ref``): the contract of
``csrc/edge_softmax.cu`` and what its wrapper runs on a CPU tensor."""
from __future__ import annotations

import torch


def edge_softmax_ref(dst_slot, mask, logits, num_rows):
    """Per-destination segment softmax of edge logits (E, H):
    ``out[e] = exp(l_e - m_r) / max(s_r, 1e-9)`` over the masked-in
    edges of e's destination row r, 0 on every other edge. ``m_r`` is
    the exact per-row max, detached (the reference's ``stop_gradient``:
    softmax is shift-invariant), and 0 for a row with no edges; ``s_r``
    sums ``exp(l - m_r)`` over the row's edges. An edge whose
    ``dst_slot`` is outside [0, num_rows) belongs to no row and gets 0.

    The max and the sum run over the edges stably sorted by row, in edge
    order within each row (``torch.segment_reduce``, no atomics), so the
    result is the same in every run on the card."""
    S = num_rows
    valid = mask & (dst_slot >= 0) & (dst_slot < S)
    key = torch.where(valid, dst_slot.long(), S)
    order = torch.sort(key, stable=True).indices
    # the edges of no row (key S) sort last, past offsets[S], and are
    # left out of every segment
    offsets = torch.searchsorted(key[order],
                                 torch.arange(S + 1, device=key.device))
    mx = torch.segment_reduce(logits.detach()[order], "max",
                              offsets=offsets, unsafe=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    safe = torch.where(valid, dst_slot, 0).long()
    shifted = torch.where(valid[:, None], logits - mx[safe], -torch.inf)
    ex = torch.exp(shifted)
    den = torch.segment_reduce(ex[order], "sum", offsets=offsets,
                               unsafe=True)
    return ex / torch.clamp(den[safe], min=1e-9)
