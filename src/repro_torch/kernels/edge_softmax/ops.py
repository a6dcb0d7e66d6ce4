"""Wrapper of the Hopper edge-softmax kernel of ``csrc/edge_softmax.cu``,
which replaces the TPU ``_stats_kernel`` of
``repro/kernels/edge_softmax/edge_softmax.py`` together with the
normalisation of its wrapper ``edge_softmax_block``: it writes the
attention coefficients themselves.

Sorted-prefix contract, as for the SpMM (``kernels/spmm/ops.py``): the
edges below ``n_live`` are sorted by ``dst_slot`` and the edges past it
are masked. On a CPU tensor the wrapper runs the plain version in
``ref.py``; on a CUDA tensor it launches the kernel or raises, and adds
one to :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.edge_softmax import ref
from repro_torch.kernels.frontier.ops import _check, _check_live, _stream

#: heads per call, the reference's limit (one TPU lane block)
MAX_HEADS = 128

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"edge_softmax": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def edge_softmax_rows(dst_slot: torch.Tensor, mask: torch.Tensor,
                      logits: torch.Tensor, num_rows: int,
                      n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention coefficients (E, H) from edge logits float32 (E, H),
    softmax-normalised over each destination row's masked-in edges
    (contract: ``ref.edge_softmax_ref``), every entry written."""
    H = logits.shape[-1]
    if H > MAX_HEADS:
        raise ValueError(f"edge_softmax supports up to {MAX_HEADS} heads, "
                         f"got {H}")
    if logits.device.type == "cpu":
        return ref.edge_softmax_ref(dst_slot, mask, logits, num_rows)
    dev = logits.device
    _check("dst_slot", dst_slot, torch.int32, dev)
    _check("mask", mask, torch.bool, dev)
    _check_live(n_live, dev)
    if (logits.dtype != torch.float32 or logits.dim() != 2
            or not logits.is_contiguous()):
        raise ValueError("logits must be a contiguous float32 (E, H) tensor")
    E = logits.shape[0]
    if not dst_slot.shape[0] == mask.shape[0] == E:
        raise ValueError("edge arrays differ in length")
    out = torch.empty(E, H, dtype=torch.float32, device=dev)
    status = _build.function("edge_softmax")(
        _build.ptr(dst_slot), _build.ptr(mask), E, _build.ptr(n_live),
        _build.ptr(logits), H, num_rows, _build.ptr(out), _stream(dev))
    _build.check(status, "edge_softmax")
    LAUNCHES["edge_softmax"] += 1
    return out
