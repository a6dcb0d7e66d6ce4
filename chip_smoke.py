#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--scale 0.25] [--requests 8] [--steps 8] [--reps 20]

Phases, each printing JSON lines; any mismatch, build failure or launch
error exits non-zero:

  1. device + build: the card's name and power limit (nvidia-smi), the
     seconds to compile every ``csrc/*.cu`` (one nvcc each, in parallel);
  2. kernels against plain: each CUDA kernel and its plain PyTorch
     version on the same inputs on the card, plus adversarial cases.
     The serving kernels (compact, hash_dedup, compact_perm, SpMM) get
     the real inputs of every layer of the first served request; the
     training kernels the real inputs of every layer of the first
     training batch: segment_select on NS's, masked_cdf_draw's search
     on LADIES's CDFs, the transposed SpMM and the row gather
     (``gather_dst``) on LABOR-0's, the gather driven through an
     ``aggregate`` backward with the edge weights requiring a gradient
     (its own path: counts zeroed before, read after).
     Integers must match bit for bit, floats to rtol = atol = 1e-5
     (summation order). Times with CUDA events, beside the bound (bytes
     over 3.35 TB/s or flops over 67 TFLOP/s fp32, whichever is larger,
     counting what these inputs need) and one PyTorch library call
     computing the same function;
  3. serve: ``--requests`` requests through ``repro_torch.launch.serve``'s
     synchronous path on products at ``--scale`` (0.25: 612,257
     vertices) with the paper's widths (100 features, hidden 256, 47
     classes, 3 layers, fanouts 10,10,10, LABOR-0, batch 1024). Launch
     counters are zeroed just before and read just after; every serving
     kernel must have run. The first request is then recomputed with the
     plain versions on the card: integer block fields bit for bit,
     logits to rtol = atol = 1e-4. Then 2 exact requests with the
     ``full`` sampler at ``FULL_DEPTH`` layers (every in-edge; the
     caps grow on overflow), counted as their own path and recomputed
     the same way;
  4. train: ``--steps`` steps each of LABOR-0, NS, LABOR-1, LABOR-*,
     labor-d, LADIES and PLADIES through ``repro_torch.launch.train``'s
     path at the same widths (Adam, lr 1e-3, clip 1.0; LADIES/PLADIES
     draw 10,240 vertices per layer), counts zeroed before and read
     after each: every kernel of the path must have run (segment_select
     for NS, masked_cdf_draw for LADIES, the transposed SpMM for all),
     every loss must be finite; the final caps (after any overflow
     replay), the host reads of loop conditions in one warm step and
     LABOR-i/*'s iteration counts per layer are printed. Step 0 is
     recomputed with the plain versions on the card from the same
     initial parameters, and with the plain versions in fp64: blocks bit
     for bit; the loss of both fp32 paths within 1e-5 (relative) of
     fp64; per tensor, the gradients and the updated parameters of both
     fp32 paths within 1e-3 relative L2 of fp64. The bound is per tensor
     and in L2 because fp32 sums in another order move a pre-activation
     near 0 across the ReLU in one path and not the other (the number of
     such flips is printed), which changes whole gradient rows, and
     Adam's first step moves each entry by about lr along its gradient's
     sign, which float noise decides for a gradient near 0. One warm step
     is split by CUDA events into sample / gather / forward / backward /
     Adam; then torch.profiler over a window of warm steps through
     ``TrainEngine.step`` gives the device's busy time per step, its
     idle share in that same window and the top device kernels; steps/s,
     sampled vertices per step and peak memory are printed per sampler;
  5. where the serving time goes: one warm request split into sample /
     gather / forward with CUDA events; then torch.profiler over a
     window of warm requests, as for training.

The line before the last is the ``kernels`` JSON object: per kernel,
``launches_by_path`` holds its count on each counted path (serve, serve
full, train <sampler> for each sampler, the weight-gradient path) and
``launches`` their sum.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA the
script exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
INT_MAX = 2**31 - 1
DEV = "cuda"
WGRAD_PATH = "aggregate backward, weights requiring a gradient"
# Layers of the exact ``full`` serving requests: the model's 3. At products
# scale 0.25 three hops already reach all but one of the 612,257 vertices
# over 13.8 M edges, and take ~21 ms per request, so the paper's depth fits
# the time limit with room to spare.
FULL_DEPTH = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(name, a, b):
    """Bit-exact comparison of two tensors (or tuples of tensors)."""
    if isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            same(f"{name}[{i}]", x, y)
        return
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        bad = (a != b).nonzero()[:5].tolist() if a.shape == b.shape else "shape"
        fail(f"{name}: kernel and plain version differ (dtype {a.dtype} vs "
             f"{b.dtype}, shape {tuple(a.shape)} vs {tuple(b.shape)}, first "
             f"differences at {bad})")


class Record:
    """Per-kernel sums over the calls of one request."""

    def __init__(self, name, route, source, replaces):
        self.row = dict(name=name, route=route, source=source,
                        replaces=replaces, launches=0,
                        launches_by_path={}, max_abs_err=0.0,
                        ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        bound_by="bytes", library_ms=0.0)
        self.flop_bound = 0.0
        self.byte_bound = 0.0

    def add(self, ms, plain_ms, library_ms, nbytes, flops=0.0, err=0.0):
        """Adds one call's times; returns them with its bound, for the
        per-call line."""
        r = self.row
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += library_ms
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = flops / FP32_FLOP_PER_S * 1e3
        self.byte_bound += byte_ms
        self.flop_bound += flop_ms
        r["bound_ms"] = max(self.byte_bound, self.flop_bound)
        r["bound_by"] = ("bytes" if self.byte_bound >= self.flop_bound
                         else "operations")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=max(byte_ms, flop_ms))


def phase_kernels(engine, data, seeds, key, reps, records):
    """Phase 2: every kernel against its plain version at the inputs of
    each layer of one request, then adversarial inputs."""
    from repro_torch.core.interface import build_block
    from repro_torch.core.labor import layer_inclusion
    from repro_torch.kernels.frontier import ops as fk
    from repro_torch.kernels.frontier import ref as fr
    from repro_torch.kernels.spmm import ops as sk
    from repro_torch.kernels.spmm import ref as sr
    from repro_torch.runtime.engine import gather_feats

    sampler = engine.sampler
    salts = sampler.spec.salts(key)
    cur = seeds
    blocks = []
    gen = torch.Generator(device=DEV).manual_seed(0)
    for layer, (k, caps) in enumerate(zip(sampler.config.fanouts,
                                          sampler.caps)):
        exp, include, inv_p = layer_inclusion(data.graph, cur, salts[layer],
                                              k, caps, backend="eager")
        blk = build_block(cur, exp, include, inv_p, caps, backend="eager")
        blocks.append(blk)
        S = cur.shape[0]

        # compact: the sampled-edge compaction, and the nonzero-degree
        # row list of expand_seed_edges
        for flags, cap, live in ((include, caps.edge_cap, exp["live"]),
                                 (exp["deg"] > 0, S, None)):
            got = fk.compact(flags, cap, live)
            want = fr.compact(flags, cap)
            torch.cuda.synchronize()
            same(f"compact layer {layer} cap {cap}", got, want)
            n = flags.shape[0] if live is None else int(live)
            t = records["compact"].add(
                cuda_ms(lambda: fk.compact(flags, cap, live), reps),
                cuda_ms(lambda: fr.compact(flags, cap), reps),
                cuda_ms(lambda: torch.nonzero(flags), reps),
                nbytes=n + cap * 5 + 4)
            emit({"phase": "kernels", "kernel": "compact", "layer": layer,
                  "E": flags.shape[0], "cap": cap, "live": n, **t})

        live = torch.clamp(blk.num_edges, max=caps.edge_cap)
        n = int(live)
        E = blk.edge_cap
        new_cap = caps.vertex_cap - S
        args = (blk.src, blk.edge_mask, blk.seeds, new_cap)
        got = fk.hash_dedup(*args, live)
        want = fr.hash_dedup(*args)
        torch.cuda.synchronize()
        same(f"hash_dedup layer {layer}", tuple(got), tuple(want))

        def unique_lookup(values=blk.src, mask=blk.edge_mask, s=blk.seeds):
            u = torch.unique(torch.cat([s, torch.where(mask, values, -1)]))
            return torch.searchsorted(u, values)

        t = records["hash_dedup"].add(
            cuda_ms(lambda: fk.hash_dedup(*args, live), reps),
            cuda_ms(lambda: fr.hash_dedup(*args), reps),
            cuda_ms(unique_lookup, reps),
            nbytes=n * 5 + S * 4 + new_cap * 4 + E * 4 + 5)
        emit({"phase": "kernels", "kernel": "hash_dedup", "layer": layer,
              "E": E, "S": S, "new_cap": new_cap, "live": n,
              "num_new": int(got.num_new), **t})

        pargs = (blk.src_slot, blk.edge_mask, caps.vertex_cap)
        got = fk.compact_perm(*pargs, live)
        want = fr.compact_perm(*pargs)
        torch.cuda.synchronize()
        same(f"compact_perm layer {layer}", got, want)
        keyed = torch.where(blk.edge_mask, blk.src_slot, caps.vertex_cap)
        t = records["compact_perm"].add(
            cuda_ms(lambda: fk.compact_perm(*pargs, live), reps),
            cuda_ms(lambda: fr.compact_perm(*pargs), reps),
            cuda_ms(lambda: torch.argsort(keyed, stable=True), reps),
            nbytes=n * 5 + E * 4)
        emit({"phase": "kernels", "kernel": "compact_perm", "layer": layer,
              "E": E, "K": caps.vertex_cap, "live": n, **t})
        cur = blk.next_seeds

    # SpMM: the deepest block aggregates the 100 input features, the
    # other two the 256-wide hidden states
    for layer, blk in enumerate(blocks):
        if layer == len(blocks) - 1:
            h = gather_feats(data.features, blk)
        else:
            h = torch.randn(blk.next_cap, 256, generator=gen, device=DEV)
        F = h.shape[1]
        live = torch.clamp(blk.num_edges, max=blk.edge_cap)
        n = int(live)
        sargs = (blk.src_slot, blk.dst_slot, blk.weight, blk.edge_mask, h,
                 blk.seed_cap)
        got = sk.spmm_block(*sargs, n_live=live)
        want = sr.spmm_block_ref(*sargs)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"spmm layer {layer} F {F}: max abs err "
                 f"{(got - want).abs().max().item()}")
        err = (got - want).abs().max().item()
        src = blk.src_slot[:n]
        rows = int(torch.unique(src).numel())
        seg = blk.dst_slot[:n].long()

        def library(h=h, src=src, seg=seg, w=blk.weight[:n], S=blk.seed_cap):
            return torch.zeros(S, h.shape[1], device=DEV).index_add_(
                0, seg, h[src.long()] * w[:, None])

        t = records["spmm"].add(
            cuda_ms(lambda: sk.spmm_block(*sargs, n_live=live), reps),
            cuda_ms(lambda: sr.spmm_block_ref(*sargs), reps),
            cuda_ms(library, reps),
            nbytes=n * 13 + rows * F * 4 + blk.seed_cap * F * 4,
            flops=2.0 * n * F, err=err)
        emit({"phase": "kernels", "kernel": "spmm", "layer": layer,
              "S": blk.seed_cap, "T": blk.next_cap, "F": F, "live": n,
              "max_abs_err": err, **t})
    adversarial(fk, fr, sk, sr)


def adversarial(fk, fr, sk, sr):
    """Edge cases held bit for bit (the SpMM to 1e-5)."""
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(1)

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    def bools(n, p):
        return torch.rand(n, generator=g, device=dev) < p

    cases = 0
    for E, cap, p in ((5000, 100, 0.0), (5000, 100, 1.0), (10007, 9000, 0.5),
                      (1, 1, 1.0), (4096 * 3 + 1, 8000, 0.7)):
        flags = bools(E, p)
        same(f"compact adversarial E={E}", fk.compact(flags, cap),
             fr.compact(flags, cap))
        live = torch.tensor(E // 2, dtype=torch.int32, device=dev)
        flags[E // 2:] = False
        same(f"compact adversarial live E={E}", fk.compact(flags, cap, live),
             fr.compact(flags, cap))
        cases += 2
    seeds = torch.cat([torch.randperm(5000, generator=g, device=dev)[:300]
                       .to(torch.int32), torch.full((20,), -1, dtype=torch.int32,
                                                    device=dev)])
    dedup_cases = [
        ("all masked", ints(3000, 0, 5000), bools(3000, 0.0), seeds, 400),
        ("all duplicates", torch.full((3000,), 7, dtype=torch.int32,
                                      device=dev), bools(3000, 1.0), seeds, 400),
        ("overflow", ints(20000, 0, 100000), bools(20000, 0.9), seeds, 500),
        ("equal to seeds", seeds[:300].repeat(10), bools(3000, 1.0), seeds, 10),
        ("no seeds", ints(3000, -1, 800), bools(3000, 0.8), None, 1000),
        ("one value", ints(1, 0, 10), bools(1, 1.0), seeds, 1),
    ]
    for name, values, mask, s, new_cap in dedup_cases:
        got, want = fk.hash_dedup(values, mask, s, new_cap), \
            fr.hash_dedup(values, mask, s, new_cap)
        same(f"hash_dedup adversarial {name}", tuple(got), tuple(want))
        cases += 1
    for E, K, p in ((3000, 1, 0.7), (3000, 50, 0.0), (20000, 70000, 0.8),
                    (2049, 3, 1.0)):
        keys, valid = ints(E, -1, K), bools(E, p)
        same(f"compact_perm adversarial E={E} K={K}",
             fk.compact_perm(keys, valid, K), fr.compact_perm(keys, valid, K))
        live = torch.tensor(E // 3, dtype=torch.int32, device=dev)
        valid[E // 3:] = False
        same(f"compact_perm adversarial live E={E} K={K}",
             fk.compact_perm(keys, valid, K, live),
             fr.compact_perm(keys, valid, K))
        cases += 2
    for E, S, T, F, live_n in ((5000, 300, 700, 100, 4000),
                               (5000, 300, 700, 256, 0),
                               (64, 1000, 50, 33, 64)):
        dst = torch.sort(ints(E, 0, S)).values
        src, w = ints(E, 0, T), torch.rand(E, generator=g, device=dev)
        mask = torch.arange(E, device=dev) < live_n
        dst = torch.where(mask, dst, -1)
        h = torch.randn(T, F, generator=g, device=dev)
        live = torch.tensor(live_n, dtype=torch.int32, device=dev)
        got = sk.spmm_block(src, dst, w, mask, h, S, n_live=live)
        want = sr.spmm_block_ref(src, dst, w, mask, h, S)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"spmm adversarial E={E} F={F} live={live_n}")
        cases += 1
    # masked_cdf_draw: the reference suite's adversarial weights, u = 0
    # over an invalid entry 0, zero-mass plateaus, an all-invalid p, no
    # draws, one entry
    ones = torch.ones
    draw_cases = [
        ("adversarial weights",
         torch.cat([torch.full((4096,), 1e-7), torch.full((8,), 3e8),
                    torch.full((4096,), 1e-7)]), ones(8200, dtype=torch.bool),
         torch.tensor([0.0, 0.5, 1.0 - 1e-7, 1.0 - 6e-8])),
        ("u = 0 and plateaus",
         torch.tensor([5.0, 1.0, 0.0, 0.0, 2.0, 0.0, 2.0]),
         torch.tensor([False, True, True, True, True, False, True]),
         torch.tensor([0.0, 0.2, 0.6, 0.6000001, 0.99])),
        ("all invalid", ones(9), torch.zeros(9, dtype=torch.bool),
         torch.tensor([0.0, 0.3, 0.999])),
        ("no draws", ones(5), ones(5, dtype=torch.bool), torch.zeros(0)),
        ("one entry", torch.tensor([0.5]), ones(1, dtype=torch.bool),
         torch.tensor([0.0, 0.7])),
    ]
    for name, p, valid, u in draw_cases:
        p, valid, u = p.to(dev), valid.to(dev), u.to(dev)
        same(f"masked_cdf_draw adversarial {name}",
             fk.masked_cdf_draw(p, valid, u), fr.masked_cdf_draw(p, valid, u))
        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "adversarial_cases": cases, "ok": True})


def capture(module, name, run):
    """Run ``run()`` with ``module.<name>`` wrapped; returns the
    (args, kwargs) of each call it made."""
    calls = []
    orig = getattr(module, name)

    def spy(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return calls


def allclose_or_fail(name, got, want, tol=1e-5):
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if got.shape != want.shape or not torch.allclose(got, want, rtol=tol,
                                                     atol=tol):
        fail(f"{name}: kernel and plain version differ by {err}")
    return err


def library_select(keys, slot, mask, seg_start, take):
    """segment_select as one stable torch.sort of the packed (segment,
    key bits) plus the rank filter -- the library yardstick."""
    E, S = keys.shape[0], seg_start.shape[0]
    seg = torch.where(mask, slot, S).long()
    packed = (seg << 32) | keys.view(torch.int32).long()
    order = torch.sort(packed, stable=True).indices
    seg_s = seg[order]
    cs = torch.clamp(seg_s, 0, S - 1)
    pos = torch.arange(E, device=keys.device) - seg_start[cs]
    inc = (seg_s < S) & (pos < take[cs])
    return torch.zeros(E, dtype=torch.bool, device=keys.device).scatter_(
        0, order, inc)


def phase_train_kernels(samplers_, data, seeds, key, reps, records):
    """Phase 2, training half: segment_select on the NS batch's real
    inputs, masked_cdf_draw's search on the LADIES batch's CDFs, the
    transposed SpMM and the row gather on the LABOR-0 batch's blocks,
    then the weight-gradient path."""
    from repro_torch import ops as TO
    from repro_torch.kernels.frontier import ops as fk
    from repro_torch.kernels.frontier import ref as fr
    from repro_torch.kernels.spmm import ops as sk
    from repro_torch.kernels.spmm import ref as sr
    from repro_torch.ops import frontier as frontier_ops
    from repro_torch.runtime.engine import gather_feats

    ns = samplers_["ns"]
    calls = capture(frontier_ops, "segment_select", lambda: ns.sample(
        data.graph, seeds, ns.spec.salts(key), backend="eager"))
    if len(calls) != ns.num_layers:
        fail(f"NS ran segment_select {len(calls)} times for "
             f"{ns.num_layers} layers")
    for layer, (a, kw) in enumerate(calls):
        keys, slot, mask, seg_start, take = a
        live = kw["n_live"]
        got = fk.segment_select(keys, slot, mask, seg_start, take, live)
        want = fr.segment_select(keys, slot, mask, seg_start, take)
        torch.cuda.synchronize()
        same(f"segment_select layer {layer}", got, want)
        same(f"segment_select library layer {layer}",
             library_select(keys, slot, mask, seg_start, take), want)
        n, E, S = int(live), keys.shape[0], seg_start.shape[0]
        t = records["segment_select"].add(
            cuda_ms(lambda: fk.segment_select(keys, slot, mask, seg_start,
                                              take, live), reps),
            cuda_ms(lambda: fr.segment_select(keys, slot, mask, seg_start,
                                              take), reps),
            cuda_ms(lambda: library_select(keys, slot, mask, seg_start,
                                           take), reps),
            nbytes=n * 5 + S * 8 + E)
        emit({"phase": "kernels", "kernel": "segment_select", "layer": layer,
              "E": E, "S": S, "live": n, "selected": int(want.sum()), **t})

    ladies = samplers_["ladies"]
    calls = capture(frontier_ops, "masked_cdf_draw", lambda: ladies.sample(
        data.graph, seeds, ladies.spec.salts(key), backend="eager"))
    if len(calls) != ladies.num_layers:
        fail(f"LADIES drew {len(calls)} times for {ladies.num_layers} "
             "layers")
    for layer, (a, _) in enumerate(calls):
        p, valid, u = a
        cdf = fr.normalized_cdf(p, valid)
        got = fk.cdf_search(cdf, u)
        want = fr.cdf_search(cdf, u)
        torch.cuda.synchronize()
        same(f"masked_cdf_draw layer {layer}", got, want)
        C, n = cdf.shape[0], u.shape[0]

        def library(cdf=cdf, u=u, C=C):
            return torch.clamp(torch.searchsorted(cdf, u), 0, C - 1)

        same(f"masked_cdf_draw library layer {layer}",
             library().to(torch.int32), want)
        # u and the draws once each, and one dependent 4-byte CDF read per
        # level of the binary search (ceil(log2(C + 1)) levels), at most
        # the whole CDF
        probes = min(C, n * C.bit_length())
        t = records["masked_cdf_draw"].add(
            cuda_ms(lambda: fk.cdf_search(cdf, u), reps),
            cuda_ms(lambda: fr.cdf_search(cdf, u), reps),
            cuda_ms(library, reps), nbytes=8 * n + 4 * probes)
        emit({"phase": "kernels", "kernel": "masked_cdf_draw",
              "layer": layer, "C": C, "n": n,
              "valid": int(valid.sum()), **t})

    engine = samplers_["engine"]
    blocks, feats = engine.sample_batch(data, seeds, key)
    gen = torch.Generator(device=DEV).manual_seed(2)
    last = len(blocks) - 1
    inputs = []
    for layer, blk in enumerate(blocks):
        h = feats if layer == last else torch.randn(
            blk.next_cap, 256, generator=gen, device=DEV)
        g = torch.randn(blk.seed_cap, h.shape[1], generator=gen, device=DEV)
        inputs.append((h, g))
        live = torch.clamp(blk.num_edges, max=blk.edge_cap)
        n, E, F = int(live), blk.edge_cap, h.shape[1]
        gargs = (blk.dst_slot, blk.edge_mask, g)
        got = sk.gather_dst_rows(*gargs, live)
        want = sr.gather_dst_ref(*gargs)
        torch.cuda.synchronize()
        same(f"gather_dst layer {layer}", got, want)
        rows = int(torch.unique(blk.dst_slot[:n]).numel())
        # the library call: index_select into g with a zero row appended
        # for the masked edges (both made once, outside the timing)
        gz = torch.cat([g, torch.zeros(1, F, device=DEV)])
        idx = torch.where(blk.edge_mask, blk.dst_slot, blk.seed_cap)
        same(f"gather_dst library layer {layer}", gz.index_select(0, idx),
             want)
        t = records["gather_dst"].add(
            cuda_ms(lambda: sk.gather_dst_rows(*gargs, live), reps),
            cuda_ms(lambda: sr.gather_dst_ref(*gargs), reps),
            cuda_ms(lambda: gz.index_select(0, idx), reps),
            nbytes=n * 5 + rows * F * 4 + E * F * 4)
        emit({"phase": "kernels", "kernel": "gather_dst", "layer": layer,
              "E": E, "F": F, "live": n, **t})
        if layer == last:
            continue   # the first GCN layer's input needs no gradient
        targs = (blk.src_slot, blk.dst_slot, blk.weight, blk.edge_mask,
                 blk.src_perm, g, blk.next_cap)
        got = sk.spmm_transposed(*targs, n_live=live)
        want = sr.spmm_transposed_ref(*targs)
        torch.cuda.synchronize()
        err = allclose_or_fail(f"spmm_t layer {layer}", got, want)
        src = blk.src_slot[:n].long()
        dst = blk.dst_slot[:n].long()
        w = blk.weight[:n]

        def library(g=g, src=src, dst=dst, w=w, T=blk.next_cap):
            return torch.zeros(T, g.shape[1], device=DEV).index_add_(
                0, src, g[dst] * w[:, None])

        t = records["spmm_t"].add(
            cuda_ms(lambda: sk.spmm_transposed(*targs, n_live=live), reps),
            cuda_ms(lambda: sr.spmm_transposed_ref(*targs), reps),
            cuda_ms(library, reps),
            nbytes=n * 17 + rows * F * 4 + blk.next_cap * F * 4,
            flops=2.0 * n * F, err=err)
        emit({"phase": "kernels", "kernel": "spmm_t", "layer": layer,
              "S": blk.next_cap, "F": F, "live": n, "max_abs_err": err, **t})

    # the weight-gradient path: aggregate backward with the edge weights
    # requiring a gradient, against plain autograd on the card
    fk.reset_launches()
    sk.reset_launches()
    torch.cuda.synchronize()
    grads = []
    for layer, (blk, (h, g)) in enumerate(zip(blocks, inputs)):
        got = []
        for backend in ("cuda", "eager"):
            w = blk.weight.detach().clone().requires_grad_()
            x = h.detach().clone().requires_grad_(layer != last)
            out = TO.aggregate(dataclasses.replace(blk, weight=w), x,
                               backend=backend)
            out.backward(g)
            got.append((w.grad, x.grad))
        grads.append(got)
    torch.cuda.synchronize()
    wgrad_launches = dict(fk.LAUNCHES, **sk.LAUNCHES)
    errs = []
    for layer, ((wk, hk), (we, he)) in enumerate(grads):
        errs.append(allclose_or_fail(f"weight gradient layer {layer}", wk, we))
        if hk is not None:
            errs.append(allclose_or_fail(f"h gradient layer {layer}", hk, he))
    if wgrad_launches["gather_dst"] != len(blocks):
        fail(f"gather_dst ran {wgrad_launches['gather_dst']} times on the "
             "weight-gradient path")
    for k in ("spmm", "spmm_t"):
        if wgrad_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the weight-gradient path")
    emit({"phase": "kernels", "path": WGRAD_PATH, "launches": wgrad_launches,
          "max_abs_err": max(errs)})
    adversarial_train(fk, fr, sk, sr)
    return wgrad_launches


def adversarial_train(fk, fr, sk, sr):
    """Edge cases of the training kernels, held bit for bit (the
    transposed SpMM to 1e-5)."""
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(3)
    cases = 0
    # segment_select: ties, takes of 0, warp- and block-sized segments,
    # an expansion truncated at the cap, a segment of length 1
    for deg_list, cap_frac, k in (([1], 1.0, 1), ([0, 3, 0, 40, 1], 1.0, 4),
                                  ([700, 2, 257, 256, 5000], 1.0, 10),
                                  ([30] * 50 + [900], 0.7, 10)):
        deg = torch.tensor(deg_list, dtype=torch.int32, device=dev)
        total = int(deg.sum())
        cap = max(1, int(total * cap_frac))
        seg_start = torch.cumsum(deg, 0, dtype=torch.int32) - deg
        pos = torch.arange(cap, device=dev)
        live = min(total, cap)
        mask = pos < live
        slot = torch.where(mask, torch.searchsorted(
            torch.cumsum(deg, 0), pos, right=True).to(torch.int32), -1)
        for ties in (False, True):
            keys = torch.rand(cap, generator=g, device=dev)
            if ties:
                keys = torch.floor(keys * 3) / 3
            keys = torch.where(mask, keys, 3.4e38)
            take = torch.clamp(deg, max=k)
            take[::3] = 0
            args = (keys, slot, mask, seg_start, take.to(torch.int32))
            n = torch.tensor(live, dtype=torch.int32, device=dev)
            same(f"segment_select adversarial {deg_list[:3]} ties={ties}",
                 fk.segment_select(*args, n), fr.segment_select(*args))
            cases += 1
    # gather_dst: -1 and out-of-range rows, masked tail, ragged widths
    for E, S, F in ((1, 1, 1), (4097, 37, 129), (300, 1000, 256)):
        dst = torch.randint(-1, S + 2, (E,), generator=g, device=dev,
                            dtype=torch.int32)
        mask = torch.rand(E, generator=g, device=dev) < 0.7
        rows = torch.randn(S, F, generator=g, device=dev)
        live = torch.tensor(E - E // 5, dtype=torch.int32, device=dev)
        mask[E - E // 5:] = False
        same(f"gather_dst adversarial E={E} F={F}",
             sk.gather_dst_rows(dst, mask, rows, live),
             sr.gather_dst_ref(dst, mask, rows))
        cases += 1
    # transposed SpMM through a permutation whose front holds -1 keys
    for E, S, T, F in ((5000, 300, 700, 100), (64, 50, 1000, 256)):
        src = torch.randint(-1, T, (E,), generator=g, device=dev,
                            dtype=torch.int32)
        dst = torch.sort(torch.randint(0, S, (E,), generator=g, device=dev,
                                       dtype=torch.int32)).values
        live_n = E - E // 4
        mask = torch.arange(E, device=dev) < live_n
        perm = fr.compact_perm(src, mask, T)
        w = torch.rand(E, generator=g, device=dev)
        gr = torch.randn(S, F, generator=g, device=dev)
        live = torch.tensor(live_n, dtype=torch.int32, device=dev)
        allclose_or_fail(
            f"spmm_t adversarial E={E} F={F}",
            sk.spmm_transposed(src, dst, w, mask, perm, gr, T, n_live=live),
            sr.spmm_transposed_ref(src, dst, w, mask, perm, gr, T))
        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "adversarial_train_cases": cases, "ok": True})


def train_step_split(engine, model, state, data, seeds, key):
    """One warm train step split by CUDA events into its stages."""
    from repro_torch.runtime.engine import (gather_feats, gnn_loss_fn,
                                            seed_labels)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    ev[0].record()
    with torch.no_grad():
        blocks = engine.sampler.sample(data.graph, seeds,
                                       engine.sampler.spec.salts(key),
                                       backend=engine.backend)
        ev[1].record()
        feats = gather_feats(data.features, blocks[-1])
        labels = seed_labels(data.labels, seeds)
    ev[2].record()
    loss, _ = gnn_loss_fn(model, blocks, feats, labels, engine.backend)
    ev[3].record()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ev[4].record()
    engine.apply_update(model, state, grads, blocks)
    ev[5].record()
    torch.cuda.synchronize()
    names = ("sample_ms", "gather_ms", "forward_ms", "backward_ms", "adam_ms")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["step_ms"] = ev[0].elapsed_time(ev[5])
    return out


def against_fp64(what, kernel, plain, ref, names, tol=1e-3):
    """Per tensor, the relative L2 error of the kernel path and of the
    plain path against the fp64 recompute; both must stay within
    ``tol``. Returns the worst of each, with their tensors' names."""
    def rel(a, c):
        return ((a.double() - c).norm() / c.norm().clamp(min=1e-300)).item()

    out = {"kernel": (0.0, ""), "plain": (0.0, "")}
    for n, a, b, c in zip(names, kernel, plain, ref):
        for path, x in (("kernel", a), ("plain", b)):
            e = rel(x, c)
            if e > tol:
                fail(f"{what} {n}: the {path} path is {e} (relative L2) "
                     "from the fp64 recompute")
            out[path] = max(out[path], (e, n))
    return out


def relu_masks(model):
    """Record each hidden layer's ReLU mask (output > 0) in the next
    forward; returns (list, the hooks' handles)."""
    masks, handles = [], []
    for layer in list(model.layers)[:-1]:
        handles.append(layer.register_forward_hook(
            lambda m, i, out: masks.append(out.detach() > 0)))
    return masks, handles


def recompute_step0(ds, cfg):
    """Step 0 of the run again, with the kernels and with the plain
    versions on the card, from the same initial parameters, and the
    plain versions in fp64 as the yardstick of both."""
    import copy

    from repro_torch.core import rng as rng_lib
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.models import gnn as gnn_models
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import (TrainEngine, gnn_loss_fn,
                                            seed_labels)
    from repro_torch.runtime.trainer import build_sampler

    sampler = build_sampler(ds, cfg)
    seeds = SeedBatches(ds.train_idx, cfg.batch_size, seed=cfg.seed,
                        device=DEV).at(0)
    key = rng_lib.fold_in(rng_lib.key(cfg.seed + 1), 0)
    n_cls = int(ds.labels.max()) + 1
    opt = adam.AdamConfig(lr=cfg.lr)
    res = {}
    for backend in ("cuda", "eager"):
        eng = TrainEngine(sampler, opt, device=DEV, backend=backend)
        data = eng.make_data_from_dataset(ds)
        model = gnn_models.gcn_init(rng_lib.key(cfg.seed),
                                    ds.features.shape[1], cfg.hidden, n_cls,
                                    len(cfg.fanouts), device=DEV)
        names = [n for n, _ in model.named_parameters()]
        blocks, feats = eng.sample_batch(data, seeds, key)
        labels = seed_labels(data.labels, seeds)
        masks, handles = relu_masks(model)
        loss, _ = gnn_loss_fn(model, blocks, feats, labels, backend)
        for h in handles:
            h.remove()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        if backend == "eager":
            m64 = copy.deepcopy(model).double()
            loss64, _ = gnn_loss_fn(m64, blocks, feats.double(), labels,
                                    "eager")
            g64 = torch.autograd.grad(loss64, list(m64.parameters()))
            p64 = {n: p.detach() for n, p in m64.named_parameters()}
            p64, _, _ = adam.apply_updates(p64, dict(zip(names, g64)),
                                           adam.init_state(p64, opt), opt)
        model, _, m = eng.step(model, eng.init_state(model), data, seeds, key)
        res[backend] = (blocks, loss.detach(), grads,
                        [p.detach() for p in model.parameters()], m, masks)
        del data
    (bk, lk, gk, pk, m_k, mask_k), (be, le, ge, pe, m_e, mask_e) = (
        res["cuda"], res["eager"])
    torch.cuda.synchronize()
    compare_blocks(bk, be, f"{cfg.sampler} step 0")
    if not torch.equal(m_k["overflow"], m_e["overflow"]):
        fail(f"{cfg.sampler} step 0 overflow flags differ")
    for path, x in (("kernel", lk), ("plain", le)):
        if abs(x.item() - loss64.item()) > 1e-5 * abs(loss64.item()):
            fail(f"{cfg.sampler} step 0 loss of the {path} path {x.item()}, "
                 f"fp64 {loss64.item()}")
    return {"blocks_bit_exact": True, "loss": lk.item(),
            "loss_plain": le.item(), "loss_fp64": loss64.item(),
            "grad_rel_l2_vs_fp64": against_fp64(
                f"{cfg.sampler} step 0 gradient", gk, ge, g64, names),
            "param_rel_l2_vs_fp64": against_fp64(
                f"{cfg.sampler} step 0 updated parameter", pk, pe,
                [p64[n] for n in names], names),
            "relu_flips_kernel_vs_plain": [int((a != b).sum()) for a, b in
                                           zip(mask_k, mask_e)],
            "num_next": [int(b.num_next) for b in bk],
            "num_edges": [int(b.num_edges) for b in bk]}


#: every sampler trained in phase 4, and the kernels only its path runs
#: (every path runs compact, hash_dedup, compact_perm and both SpMMs)
TRAIN_SAMPLERS = {"labor-0": (), "ns": ("segment_select",), "labor-1": (),
                  "labor-*": (), "labor-d": (),
                  "ladies": ("masked_cdf_draw",), "pladies": ()}


def importance_iterations(engine, data, seeds, key):
    """LABOR-i's solve counts and LABOR-*'s outer count per layer, from
    one more sampling of the batch with run_importance_iterations'
    log."""
    from repro_torch.core import labor
    logs = []
    orig = labor.run_importance_iterations

    def logged(*a, **kw):
        logs.append({})
        kw["log"] = logs[-1]
        return orig(*a, **kw)

    labor.run_importance_iterations = logged
    try:
        engine.sample_batch(data, seeds, key)
    finally:
        labor.run_importance_iterations = orig
    return [{"outer": int(lg["outer"]) if "outer" in lg else None,
             "solves": [int(n) for n in lg["solves"]]} for lg in logs]


def phase_train(ds, opts, fk, sk):
    """Phase 4: train each sampler through the launcher's path."""
    from repro_torch.core import cs_solve
    from repro_torch.core import rng as rng_lib
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.launch import train
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import TrainEngine

    paths = {}
    for name, own in TRAIN_SAMPLERS.items():
        args = train.parser().parse_args([
            "--device", DEV, "--dataset", "products",
            "--scale", str(opts.scale), "--sampler", name,
            "--fanouts", "10,10,10", "--batch-size", "1024",
            "--steps", str(opts.steps), "--seed", str(opts.seed)])
        cfg = train.config(args)
        # warm-up (first use of each cuBLAS shape, the allocator's pools):
        # two steps, outside the counts and the timing
        train.train_report(ds, dataclasses.replace(cfg, steps=2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launches()
        sk.reset_launches()
        report, out = train.train_report(ds, cfg)
        torch.cuda.synchronize()
        launches = dict(fk.LAUNCHES, **sk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k in ("compact", "hash_dedup", "compact_perm", "spmm",
                  "spmm_t") + own:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the {name} training "
                     "path")
        losses = [h["loss"] for h in out["history"]]
        if len(losses) != opts.steps or not all(map(math.isfinite, losses)):
            fail(f"{name}: losses {losses}")
        emit({"phase": "train", "sampler": name, "report": report,
              "losses": losses, "launches": launches,
              "steps_per_s": opts.steps / out["wall_time"],
              "sampled_v_per_step": [h["sampled_v"] for h in out["history"]],
              "sampled_e_per_step": [h["sampled_e"] for h in out["history"]],
              "avg_sampled_vertices": report["avg_sampled_vertices"],
              "final_caps": [c.__dict__ for c in out["sampler"].caps],
              "peak_memory_gib": peak})
        check = recompute_step0(ds, cfg)
        emit({"phase": "train", "sampler": name,
              "recompute": "step 0 with the plain versions on the card",
              **check})
        eng = TrainEngine(out["sampler"], adam.AdamConfig(lr=cfg.lr),
                          device=DEV)
        data = eng.make_data_from_dataset(ds)
        model = out["params"]
        state = eng.init_state(model)
        batches = SeedBatches(ds.train_idx, cfg.batch_size, seed=cfg.seed,
                              device=DEV)

        def step_key(i):
            return rng_lib.fold_in(rng_lib.key(cfg.seed + 1), i)

        seeds, key = batches.at(opts.steps), step_key(opts.steps)
        train_step_split(eng, model, state, data, seeds, key)   # warm-up
        cs_solve.reset_host_reads()
        split = train_step_split(eng, model, state, data, seeds, key)
        # loop conditions read on the host in that step's sampling (the
        # engine's one-step-late overflow read is one more per step)
        split["loop_host_reads"] = dict(cs_solve.HOST_READS)
        if name.startswith("labor-") and name not in ("labor-0", "labor-d"):
            split["importance_iterations"] = importance_iterations(
                eng, data, seeds, key)
        emit({"phase": "train", "sampler": name, "warm_step": split})
        # a window of warm steps through TrainEngine.step (the ledger's
        # one-step-late flag read included) under the profiler
        n_win = 5

        def run(i, first=opts.steps + 1):
            nonlocal model, state
            model, state, _ = eng.step(model, state, data,
                                       batches.at(first + i),
                                       step_key(first + i))

        run(-1)   # fills the ledger, so every profiled step polls one
        window = profile_window(run, n_win)
        eng.flush(model, state, data)
        emit({"phase": "train", "sampler": name, "window_steps": n_win,
              **window})
        paths[name] = launches
        del data, eng
    return paths


def phase_serve_full(ds, opts, fk, sk):
    """Phase 3, exact inference: 2 requests with the ``full`` sampler
    (every in-edge, caps grown on overflow) through the launcher's
    synchronous path, counts zeroed before and read after; request 0
    again with the plain versions on the card."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.core.interface import pad_seeds
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import TrainEngine

    args = serve.parser().parse_args([
        "--device", DEV, "--dataset", "products",
        "--scale", str(opts.scale), "--sampler", "full",
        "--fanouts", ",".join(["10"] * FULL_DEPTH), "--hidden", "256",
        "--batch", "1024", "--requests", "2", "--seed", str(opts.seed)])
    built = serve.build_gnn_serving(args, ds)
    _, engine, data, model, _ = built
    fk.reset_launches()
    sk.reset_launches()
    torch.cuda.synchronize()
    report = serve.serve_gnn_sync(args, built)
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES, **sk.LAUNCHES)
    for name in ("compact", "hash_dedup", "compact_perm", "spmm"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the full serving path")
    if report["requests_served"] != 2 or not report["exact"]:
        fail(f"full serving: {report}")
    seeds = pad_seeds(serve.gnn_trace(args, ds)[0], args.batch, device=DEV)
    key = rng_lib.split(rng_lib.key(args.seed + 1))[1]
    out = [TrainEngine(engine.sampler, device=DEV, backend=b).infer_blocks(
        model, data, seeds, key) for b in ("cuda", "eager")]
    torch.cuda.synchronize()
    (logits_k, flags_k, blocks_k), (logits_e, flags_e, blocks_e) = out
    compare_blocks(blocks_k, blocks_e, "full request 0")
    same("full request 0 overflow flags", flags_k, flags_e)
    if bool(flags_k.any()) or not bool(torch.isfinite(logits_k).all()):
        fail("full request 0: overflow at the grown caps or non-finite "
             "logits")
    err = (logits_k - logits_e).abs().max().item()
    if not torch.allclose(logits_k, logits_e, rtol=1e-4, atol=1e-4):
        fail(f"full request 0 logits differ from the plain versions by {err}")
    emit({"phase": "serve full", "depth": FULL_DEPTH,
          "report": report, "launches": launches,
          "caps": [c.__dict__ for c in engine.sampler.caps],
          "logits_max_abs_err": err,
          "num_next": [int(b.num_next) for b in blocks_k],
          "num_edges": [int(b.num_edges) for b in blocks_k],
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches


def compare_blocks(blocks_k, blocks_e, what="request 0"):
    from repro_torch.core.interface import INT_FIELDS
    for layer, (a, b) in enumerate(zip(blocks_k, blocks_e)):
        for f in INT_FIELDS:
            same(f"{what} layer {layer} {f}", getattr(a, f), getattr(b, f))
        if not torch.allclose(a.weight, b.weight, rtol=1e-6, atol=1e-7):
            fail(f"{what} layer {layer} weight differs")


def phase_profile(engine, data, model, seeds, key):
    """Phase 5: one warm request split by stage, and its top kernels."""
    from repro_torch.runtime.engine import gather_feats
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    salts = engine.sampler.spec.salts(key)
    with torch.no_grad():
        torch.cuda.synchronize()
        ev[0].record()
        blocks = engine.sampler.sample(data.graph, seeds, salts,
                                       backend=engine.backend)
        ev[1].record()
        feats = gather_feats(data.features, blocks[-1])
        ev[2].record()
        model(blocks, feats, backend=engine.backend)
        ev[3].record()
        torch.cuda.synchronize()
    request_ms = ev[0].elapsed_time(ev[3])
    emit({"phase": "profile", "sample_ms": ev[0].elapsed_time(ev[1]),
          "gather_ms": ev[1].elapsed_time(ev[2]),
          "forward_ms": ev[2].elapsed_time(ev[3]), "request_ms": request_ms})
    n_req = 5
    window = profile_window(
        lambda i: engine.infer(model, data, seeds, key), n_req)
    emit({"phase": "profile", "window_requests": n_req, **window})


def profile_window(run, n):
    """torch.profiler over ``run(0) .. run(n - 1)``: the window's
    elapsed time, the device's busy time and operations per call, its
    idle share in that same window, and the top device kernels per call.
    Busy and elapsed come from the same window (one stream, so the sum
    of device events is the busy time). The profiler's host overhead
    slows the launches, so the idle share is an upper estimate of the
    unprofiled one. No device events -> busy and idle are not measured
    (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # the device's own events (kernels, copies, memsets): an
    # operator's device time repeats its kernels' and is left out
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"window_ms": window_ms,
            "device_busy_ms_per_call": busy_ms / n or None,
            "device_ops_per_call": sum(r[2] for r in rows) / n,
            "device_idle_share": (max(0.0, 1.0 - busy_ms / window_ms)
                                  if busy_ms else None),
            "top": [{"name": k[:80], "calls_per_call": c / n,
                     "device_ms_per_call": us / 1e3 / n}
                    for us, k, c in rows[:15]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only "
             "on a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import rng as rng_lib
    from repro_torch.core.interface import pad_seeds
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import ops as fk
    from repro_torch.kernels.spmm import ops as sk
    from repro_torch.launch import serve, train
    from repro_torch.runtime.engine import TrainEngine
    from repro_torch.runtime.trainer import build_sampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- phase 1: device and build -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "seconds": build_s, "card": card,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln]
                    for k, v in _build.BUILD_LOG.items()}})

    args = serve.parser().parse_args([
        "--device", DEV, "--dataset", "products",
        "--scale", str(opts.scale), "--sampler", "labor-0",
        "--fanouts", "10,10,10", "--hidden", "256", "--batch", "1024",
        "--requests", str(opts.requests), "--seed", str(opts.seed)])
    t0 = time.perf_counter()
    built = serve.build_gnn_serving(args)
    ds, engine, data, model, _ = built
    emit({"phase": "setup", "dataset_seconds": time.perf_counter() - t0,
          "num_vertices": ds.graph.num_vertices,
          "num_edges": ds.graph.num_edges,
          "caps": [c.__dict__ for c in engine.sampler.caps]})
    seeds0 = pad_seeds(serve.gnn_trace(args, ds)[0], args.batch,
                       device=DEV)
    key0 = rng_lib.split(rng_lib.key(args.seed + 1))[1]

    # -- phase 2: kernels against their plain versions ---------------------
    records = {
        "compact": Record("compact", "cuda",
                          "src/repro_torch/csrc/frontier.cu",
                          "src/repro/kernels/frontier/parallel.py:317, "
                          "src/repro/kernels/frontier/frontier.py:175"),
        "hash_dedup": Record("hash_dedup", "cuda",
                             "src/repro_torch/csrc/frontier.cu",
                             "src/repro/kernels/frontier/parallel.py:160,"
                             "197,214, src/repro/kernels/frontier/"
                             "frontier.py:71,130"),
        "compact_perm": Record("compact_perm", "cuda",
                               "src/repro_torch/csrc/frontier.cu",
                               "src/repro/kernels/frontier/parallel.py:381,"
                               "390, src/repro/kernels/frontier/"
                               "frontier.py:199"),
        "spmm": Record("spmm", "cuda", "src/repro_torch/csrc/spmm.cu",
                       "src/repro/kernels/spmm/spmm.py:31"),
        "segment_select": Record(
            "segment_select", "cuda", "src/repro_torch/csrc/select.cu",
            "src/repro/kernels/frontier/frontier.py:231, "
            "src/repro/kernels/frontier/parallel.py:431"),
        "gather_dst": Record("gather_dst", "cuda",
                             "src/repro_torch/csrc/spmm.cu",
                             "src/repro/kernels/spmm/spmm.py:51"),
        "spmm_t": Record("spmm_t", "cuda", "src/repro_torch/csrc/spmm.cu",
                         "src/repro/kernels/spmm/spmm.py:31 (transposed, "
                         "in the aggregate backward)"),
        "masked_cdf_draw": Record(
            "masked_cdf_draw", "cuda", "src/repro_torch/csrc/search.cu",
            "src/repro/kernels/frontier/frontier.py:303, "
            "src/repro/kernels/frontier/parallel.py:503"),
    }
    phase_kernels(engine, data, seeds0, key0, opts.reps, records)

    # the first training batch of the launcher's run, for NS, LADIES and
    # LABOR-0 (the engine)
    train_args = train.parser().parse_args([
        "--device", DEV, "--batch-size", "1024", "--fanouts", "10,10,10",
        "--seed", str(opts.seed)])
    cfg = train.config(train_args)
    samplers_ = {
        name: build_sampler(ds, dataclasses.replace(cfg, sampler=name))
        for name in ("ns", "ladies")}
    samplers_["engine"] = TrainEngine(build_sampler(ds, cfg), device=DEV)
    seeds_t = SeedBatches(ds.train_idx, 1024, seed=opts.seed,
                          device=DEV).at(0)
    key_t = rng_lib.fold_in(rng_lib.key(opts.seed + 1), 0)
    wgrad_launches = phase_train_kernels(samplers_, data, seeds_t, key_t,
                                         opts.reps, records)
    del samplers_

    # -- phase 3: serve through the launcher's synchronous path ------------
    fk.reset_launches()
    sk.reset_launches()
    torch.cuda.synchronize()
    report = serve.serve_gnn_sync(args, built)
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES, **sk.LAUNCHES)
    emit({"phase": "serve", "launches": launches,
          "requests_served": report["requests_served"],
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    for name in ("compact", "hash_dedup", "compact_perm", "spmm"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    if report["requests_served"] != opts.requests:
        fail(f"served {report['requests_served']} of {opts.requests}")

    eng_k = TrainEngine(engine.sampler, device=DEV, backend="cuda")
    eng_e = TrainEngine(engine.sampler, device=DEV, backend="eager")
    logits_k, flags_k, blocks_k = eng_k.infer_blocks(model, data, seeds0,
                                                     key0)
    logits_e, flags_e, blocks_e = eng_e.infer_blocks(model, data, seeds0,
                                                     key0)
    torch.cuda.synchronize()
    compare_blocks(blocks_k, blocks_e)
    same("request 0 overflow flags", flags_k, flags_e)
    n_cls = int(ds.labels.max()) + 1
    if logits_k.shape != (args.batch, n_cls) or not bool(
            torch.isfinite(logits_k).all()):
        fail(f"logits: shape {tuple(logits_k.shape)} or non-finite values")
    err = (logits_k - logits_e).abs().max().item()
    if not torch.allclose(logits_k, logits_e, rtol=1e-4, atol=1e-4):
        fail(f"request 0 logits differ from the plain versions by {err}")
    emit({"phase": "serve", "recompute": "plain versions on the card",
          "blocks_bit_exact": True, "logits_max_abs_err": err,
          "sampled_v": int(blocks_k[-1].num_next),
          "num_next": [int(b.num_next) for b in blocks_k],
          "num_edges": [int(b.num_edges) for b in blocks_k]})

    # exact inference: full neighbourhoods, at FULL_DEPTH layers
    full_launches = phase_serve_full(ds, opts, fk, sk)

    # -- phase 4: train every sampler through the launcher's path ---------
    paths = {"serve": launches, "serve full": full_launches,
             **{f"train {k}": v for k, v in phase_train(ds, opts, fk,
                                                         sk).items()},
             WGRAD_PATH: wgrad_launches}
    for name, rec in records.items():
        by_path = {p: counts[name] for p, counts in paths.items()}
        rec.row["launches_by_path"] = by_path
        rec.row["launches"] = sum(by_path.values())

    # -- phase 5: where the serving time goes -------------------------------
    phase_profile(eng_k, data, model, seeds0, key0)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [r.row for r in records.values()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
