"""Wrappers of the Hopper graph-op kernels of ``csrc/spmm.cu``.

``spmm_block`` and ``spmm_transposed`` launch the SpMM kernel, which
replaces the TPU ``_spmm_kernel`` of ``repro/kernels/spmm/spmm.py`` on
the ``aggregate`` forward and on its backward for h; ``scatter_rows``
launches its per-edge-value form (the reference's
``scatter_sorted_block``: ``scatter_edges``, the backwards of
``gather_dst``, ``gather_src`` and ``edge_softmax``); ``gather_dst_rows``
launches the row gather that replaces ``_gather_kernel`` (the SDDMM's
destination half, ``ops.gather_dst``).

Sorted-prefix contract of the SpMM: the edges at index < ``n_live``
(all of them when ``n_live`` is None) are sorted by ``dst_slot``
(non-decreasing; -1 entries sort first and match no row), and the edges
past it are masked. ``build_block`` emits exactly that layout:
``compact`` keeps the segment order of ``expand_seed_edges``, and
``edge_mask`` is the prefix ``[0, num_edges)``. The transposed call
permutes the edges by ``src_perm``, a stable sort by ``src_slot`` with
the masked edges last, so the same prefix is sorted by ``src_slot``.

The forward SpMM (``spmm_block``) is one launch with no scratch: a
group of lanes per chunk of live edges sums the rows that start in it,
and the rows past the last live key are zeroed in one flat fill. The
transposed SpMM and ``scatter_rows`` first write each output row's edge
range into an int32 scratch that the wrapper allocates (``num_rows + 1``
offsets, and a list of the rows too long for one warp), then sum each
row. ``n_live`` stays on the device.

On a CPU tensor each wrapper runs its plain version in ``ref.py``; on a
CUDA tensor it launches the kernel or raises, and adds one to its entry
of :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier.ops import _check, _check_live, _stream
from repro_torch.kernels.spmm import ref

#: kernel launches per wrapper since the last :func:`reset_launches`
#: (``spmm_t`` counts the transposed SpMM of the backward)
LAUNCHES = {"spmm": 0, "spmm_t": 0, "gather_dst": 0, "scatter_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 (rows, F) "
                         "tensor")


def _scratch(num_rows: int, dev) -> torch.Tensor:
    """The kernels' int32 scratch: each output row's first edge and one
    past the last row's, the count and list of rows too long for one warp
    (written on the device, never read here; the caching allocator hands
    it out in stream order)."""
    return torch.empty(2 * (num_rows + 1) + 1, dtype=torch.int32,
                       device=dev)


def _spmm(src_slot, dst_slot, weight, mask, h, num_rows, n_live,
          perm=None):
    dev = h.device
    E = dst_slot.shape[0]
    _check("src_slot", src_slot, torch.int32, dev)
    _check("dst_slot", dst_slot, torch.int32, dev)
    _check("weight", weight, torch.float32, dev)
    _check("mask", mask, torch.bool, dev)
    _check_live(n_live, dev)
    if perm is not None:
        _check("perm", perm, torch.int32, dev)
    if not (src_slot.shape[0] == weight.shape[0] == mask.shape[0] == E
            and (perm is None or perm.shape[0] == E)):
        raise ValueError("edge arrays differ in length")
    _check_rows("h", h)
    T, F = h.shape
    out = torch.empty(num_rows, F, dtype=torch.float32, device=dev)
    # the forward kernel (no perm) needs no scratch
    scratch = None if perm is None else _scratch(num_rows, dev)
    status = _build.function("spmm_rows")(
        _build.ptr(dst_slot), _build.ptr(src_slot), _build.ptr(weight),
        _build.ptr(mask), _build.ptr(perm), E, _build.ptr(n_live),
        _build.ptr(h), T, F, num_rows, _build.ptr(scratch),
        _build.ptr(out), _stream(dev))
    _build.check(status, "spmm_rows")
    return out


def spmm_block(src_slot: torch.Tensor, dst_slot: torch.Tensor,
               weight: torch.Tensor, mask: torch.Tensor, h: torch.Tensor,
               num_rows: int, n_live: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Aggregate ``weight * h[src_slot]`` into ``num_rows`` destination
    rows; h float32 (T, F) -> (num_rows, F), every row written: one
    launch of the forward kernel."""
    if h.device.type == "cpu":
        return ref.spmm_block_ref(src_slot, dst_slot, weight, mask, h,
                                  num_rows)
    out = _spmm(src_slot, dst_slot, weight, mask, h, num_rows, n_live)
    LAUNCHES["spmm"] += 1
    return out


def spmm_transposed(src_slot: torch.Tensor, dst_slot: torch.Tensor,
                    weight: torch.Tensor, mask: torch.Tensor,
                    perm: torch.Tensor, g: torch.Tensor, num_rows: int,
                    n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The transposed SpMM (contract: ``ref.spmm_transposed_ref``): the
    same kernel with src and dst swapped, reading the edges in ``perm``
    order (the block's ``src_perm``) so that its destinations, the
    edges' ``src_slot``, are a sorted prefix. g (S, F) -> (num_rows, F).
    ``n_live`` is the live edge count, which the permutation keeps in
    front."""
    if g.device.type == "cpu":
        return ref.spmm_transposed_ref(src_slot, dst_slot, weight, mask,
                                       perm, g, num_rows)
    out = _spmm(dst_slot, src_slot, weight, mask, g, num_rows, n_live,
                perm=perm)
    LAUNCHES["spmm_t"] += 1
    return out


def scatter_rows(dst_slot: torch.Tensor, mask: torch.Tensor,
                 values: torch.Tensor, num_rows: int,
                 perm: Optional[torch.Tensor] = None,
                 n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum each edge's own row of ``values`` into its ``dst_slot`` row,
    unweighted (contract: ``ref.scatter_rows_ref``); values float32
    (E, F) -> (num_rows, F), every row written. With ``perm`` (a
    ``src_perm``) the edges are read in that order, which must sort the
    live prefix by ``dst_slot``: pass the edges' ``src_slot`` as
    ``dst_slot`` for the backward of ``gather_src``."""
    if values.device.type == "cpu":
        return ref.scatter_rows_ref(dst_slot, mask, values, num_rows, perm)
    dev = values.device
    _check("dst_slot", dst_slot, torch.int32, dev)
    _check("mask", mask, torch.bool, dev)
    _check_live(n_live, dev)
    if perm is not None:
        _check("perm", perm, torch.int32, dev)
    _check_rows("values", values)
    E, F = values.shape
    if not (dst_slot.shape[0] == mask.shape[0] == E
            and (perm is None or perm.shape[0] == E)):
        raise ValueError("edge arrays differ in length")
    out = torch.empty(num_rows, F, dtype=torch.float32, device=dev)
    status = _build.function("scatter_rows")(
        _build.ptr(dst_slot), _build.ptr(mask), _build.ptr(perm), E,
        _build.ptr(n_live), _build.ptr(values), F, num_rows,
        _build.ptr(_scratch(num_rows, dev)), _build.ptr(out), _stream(dev))
    _build.check(status, "scatter_rows")
    LAUNCHES["scatter_rows"] += 1
    return out


def gather_dst_rows(dst_slot: torch.Tensor, mask: torch.Tensor,
                    rows: torch.Tensor,
                    n_live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[e] = rows[dst_slot[e]] for the masked-in edges below
    ``n_live``, 0 for every other edge (contract: ``ref.gather_dst_ref``);
    rows float32 (S, F) -> (E, F), every row written."""
    if rows.device.type == "cpu":
        return ref.gather_dst_ref(dst_slot, mask, rows)
    dev = rows.device
    _check("dst_slot", dst_slot, torch.int32, dev)
    _check("mask", mask, torch.bool, dev)
    _check_live(n_live, dev)
    if mask.shape[0] != dst_slot.shape[0]:
        raise ValueError("dst_slot and mask differ in length")
    _check_rows("rows", rows)
    E = dst_slot.shape[0]
    S, F = rows.shape
    out = torch.empty(E, F, dtype=torch.float32, device=dev)
    status = _build.function("gather_dst_rows")(
        _build.ptr(dst_slot), _build.ptr(mask), E, _build.ptr(n_live),
        _build.ptr(rows), S, F, _build.ptr(out), _stream(dev))
    _build.check(status, "gather_dst_rows")
    LAUNCHES["gather_dst"] += 1
    return out
