"""Per-seed scale factor c_s solve (paper eq. 13-17; twin of
``repro.core.cs_solve``).

Given per-edge (unnormalised) probabilities ``pi`` laid out segment-
contiguously by seed, find for every seed ``s`` the scalar ``c_s`` with

    sum_{t->s} 1 / min(1, c_s * pi_t)  =  d_s^2 / k          (eq. 14)

when ``k < d_s``; otherwise ``c_s = max_{t->s} 1/pi_t``, so that every
in-edge is taken with probability 1. :func:`solve_cs` runs the paper's
iterative algorithm (eq. 15-17), which converges monotonically from
below, with the reference's fixed-point residual exit.

The reference runs the loop as one ``while_loop`` inside an XLA
program. Here the loop condition lives on the device: each iteration
is applied under ``torch.where(active, new, old)``, so the state
freezes once the condition fails, and the host reads the condition
only every ``CHECK_EVERY`` iterations (:func:`read_flag`, counted in
:data:`HOST_READS`). The result is the reference loop's state at the
same iteration.

The per-seed sums (here and in ``build_block``'s Hajek denominators) go
through :func:`_segment_sum_sorted`, a reduction per contiguous segment
in a fixed order (``torch.segment_reduce``, no atomics), so on the card
every run and both graph-ops backends get the same floats; on the CPU
each segment is summed in edge order, which is XLA's scatter order.
:func:`solve_cs_weighted` (weighted graphs, §A.7) is a fixed 64-step
bisection with no loop condition, so it reads nothing back to the host.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core import rng as rng_lib

#: dropped entries are spread over this many spill bins past the real
#: segments: on the card, millions of atomic adds into one spill address
#: serialise
SPILL_BINS = 1024

#: iterations of :func:`solve_cs` between two host reads of its loop
#: condition (a warm-started solve on the paper's path takes 1-2)
CHECK_EVERY = 2

#: host reads of device-side loop conditions since the last
#: :func:`reset_host_reads`, by loop (the reference's loops run inside
#: one XLA program and read none)
HOST_READS = {"solve_cs": 0, "labor_star": 0}


def reset_host_reads() -> None:
    for k in HOST_READS:
        HOST_READS[k] = 0


def read_flag(flag: torch.Tensor, loop: str) -> bool:
    """Read a device-side loop condition on the host, counted."""
    HOST_READS[loop] += 1
    return bool(flag)


def spill_index(keep: torch.Tensor, index: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """``index`` where ``keep``, else one of SPILL_BINS bins at
    ``num_bins + (position mod SPILL_BINS)``, as int64 for scatters."""
    pos = torch.arange(index.shape[0], device=index.device)
    return torch.where(keep, index.long(), num_bins + pos % SPILL_BINS)


def segment_offsets(keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64[num_segments + 1] run boundaries of ``keys``, which must be
    non-decreasing over the entries with a key >= 0 and hold -1 only
    after them (the ``expand_seed_edges`` layout, or keys sorted by
    ``compact_perm``): segment s is ``[out[s], out[s + 1])``."""
    k = torch.where(keys >= 0, keys, num_segments).contiguous()
    bounds = torch.arange(num_segments + 1, device=keys.device,
                          dtype=k.dtype)
    return torch.searchsorted(k, bounds)


def _segment_sum_sorted(vals: torch.Tensor, offsets: torch.Tensor,
                        reduce: str = "sum") -> torch.Tensor:
    """Per-segment reduction over contiguous runs (``segment_offsets``)
    in a fixed order, without atomics: the same floats in every run.
    Empty segments give 0 for "sum" and -inf for "max"."""
    return torch.segment_reduce(vals, reduce, offsets=offsets, unsafe=True)


def _segment_max(vals: torch.Tensor, offsets: torch.Tensor,
                 fill: float = 0.0) -> torch.Tensor:
    out = _segment_sum_sorted(vals, offsets, "max")
    return torch.where(torch.isfinite(out), out, fill)


def solve_cs(pi_e: torch.Tensor, seed_slot: torch.Tensor, deg: torch.Tensor,
             k, num_seeds: int, edge_mask: torch.Tensor, max_iters: int = 64,
             tol: float = 1e-6, c_init: Optional[torch.Tensor] = None, *,
             iters_out: Optional[List[torch.Tensor]] = None,
             mesh=None) -> torch.Tensor:
    """Solve eq. 14 for every seed (the reference's arguments).

    pi_e float32[E] (padding arbitrary); seed_slot int32[E], -1 for
    padding, segment-contiguous; deg int32[S]; k the fanout (int or
    int32[S]); edge_mask bool[E], masked entries only on the tail;
    ``c_init`` an optional float32[S] warm start. Returns c float32[S]
    (0 for padding seeds). ``iters_out``, when given, receives the
    iteration count as an int32 device scalar. ``mesh`` (a rank of the
    multi-device engine, holding a share of the batch's seeds) takes
    the residual's max over every rank, so the loop runs the
    single-device solve's iterations and each seed's c is its c
    there."""
    S = num_seeds
    dev = pi_e.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    pi_e = torch.where(edge_mask, torch.clamp(pi_e, min=1e-20), one)
    slot = torch.where(edge_mask, seed_slot, -1)
    offsets = segment_offsets(slot, S)
    degf = deg.to(torch.float32)
    kf = torch.broadcast_to(torch.as_tensor(k, dtype=torch.float32,
                                            device=dev), (S,))
    valid = deg > 0
    target = torch.where(valid, degf * degf / torch.clamp(kf, min=1e-9), one)

    inv_pi = torch.where(edge_mask, one / pi_e, 0.0)
    inv_pi_sum = _segment_sum_sorted(inv_pi, offsets)
    inv_pi_max = _segment_max(inv_pi, offsets)

    exact = kf >= degf                       # k >= d: c = max 1/pi
    eq15 = kf / torch.clamp(degf, min=1.0) ** 2 * inv_pi_sum
    if c_init is None:
        c = torch.where(valid, eq15, 0.0)
    else:
        c = torch.where(valid & (c_init > 0), c_init, eq15)
    solving = valid & ~exact
    safe_slot = torch.clamp(slot, 0, S - 1).long()
    clip_one = torch.ones_like(pi_e)

    def body(c):
        c_e = c[safe_slot]
        cp = c_e * pi_e
        clipped = cp >= 1.0
        inv_min = torch.where(edge_mask, torch.where(clipped, clip_one,
                                                     clip_one / cp), 0.0)
        ssum = _segment_sum_sorted(inv_min, offsets)   # sum 1/min(1, c pi)
        v = _segment_sum_sorted((edge_mask & clipped).to(torch.float32),
                                offsets)                # eq. 17
        denom = torch.clamp(target - v, min=1e-9)
        # a warm start above the fixed point can clip every edge of a
        # seed (ssum == v); halve instead of collapsing c to 0
        fully_clipped = ssum - v <= 1e-12
        c_new = torch.where(fully_clipped, c * 0.5, c / denom * (ssum - v))
        c_new = torch.where(solving, c_new, c)
        resid = torch.max(torch.where(
            solving, torch.abs(c_new - c) / torch.clamp(c, min=1e-20), 0.0))
        return c_new, resid

    resid = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    i = torch.zeros((), dtype=torch.int32, device=dev)

    def running():
        return (resid > tol) & (i < max_iters)

    while True:
        for _ in range(CHECK_EVERY):
            active = running()
            c_new, r_new = body(c)
            if mesh is not None:
                r_new = mesh.pmax(r_new)
            c = torch.where(active, c_new, c)
            resid = torch.where(active, r_new, resid)
            i = i + active.to(torch.int32)
        if not read_flag(running(), "solve_cs"):
            break
    if iters_out is not None:
        iters_out.append(i)
    c = torch.where(exact & valid, inv_pi_max, c)
    return torch.where(valid, c, 0.0)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of float32 ``x``, as
    XLA's: torch's CPU ``sqrt`` is not correctly rounded on some inputs,
    and a midpoint one ulp away flips a bisection step. The float64 root of a float32
    rounds to the float32 root exactly (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def solve_cs_weighted(pi_e: torch.Tensor, a_e: torch.Tensor,
                      seed_slot: torch.Tensor, deg: torch.Tensor, k,
                      num_seeds: int, edge_mask: torch.Tensor,
                      max_iters: int = 64, tol: float = 1e-6
                      ) -> torch.Tensor:
    """Weighted-graph c_s solve (paper §A.7, eq. 23; the reference's
    arguments): c_s with

        (1 / A_{*s}^2) (sum_t A_ts^2 / min(1, c_s pi_ts) - sum_t A_ts^2)
            = 1/k - 1/d_s,

    by ``max_iters`` bisection steps in log space on the monotone
    left-hand side, from [1e-9, 1e9]. Every step runs; nothing is read
    back to the host. ``tol`` is unused, as in the reference. Returns
    c float32[S] (max 1/pi over the segment where k >= d, 0 for padding
    seeds)."""
    del tol
    S = num_seeds
    dev = pi_e.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    pi_e = torch.where(edge_mask, torch.clamp(pi_e, min=1e-20), one)
    a2 = torch.where(edge_mask, a_e * a_e, 0.0)
    slot = torch.where(edge_mask, seed_slot, -1)
    offsets = segment_offsets(slot, S)
    degf = deg.to(torch.float32)
    kf = torch.broadcast_to(torch.as_tensor(k, dtype=torch.float32,
                                            device=dev), (S,))
    valid = deg > 0

    a_sum = _segment_sum_sorted(torch.where(edge_mask, a_e, 0.0), offsets)
    a2_sum = _segment_sum_sorted(a2, offsets)
    v_target = torch.where(valid, one / torch.clamp(kf, min=1e-9)
                           - one / torch.clamp(degf, min=1.0), 0.0)
    # the target of sum_t A_ts^2 / min(1, c pi), rounded once as XLA
    # contracts it
    target = rng_lib.fma(v_target, torch.clamp(a_sum, min=1e-20) ** 2,
                         a2_sum)
    safe_slot = torch.clamp(slot, 0, S - 1).long()

    def lhs(c):
        p = torch.clamp(c[safe_slot] * pi_e, max=1.0)
        return _segment_sum_sorted(
            torch.where(edge_mask, a2 / torch.clamp(p, min=1e-20), 0.0),
            offsets)

    # lhs decreases in c: bisect in log space, the midpoint in float32
    lo = torch.full((S,), 1e-9, dtype=torch.float32, device=dev)
    hi = torch.full((S,), 1e9, dtype=torch.float32, device=dev)
    for _ in range(max_iters):
        mid = _sqrt_f32(lo * hi)
        too_low = lhs(mid) > target          # c must grow
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    c = _sqrt_f32(lo * hi)
    inv_pi_max = _segment_max(torch.where(edge_mask, one / pi_e, 0.0),
                              offsets)
    c = torch.where(kf >= degf, inv_pi_max, c)
    return torch.where(valid, c, 0.0)
