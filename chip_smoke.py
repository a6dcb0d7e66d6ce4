#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--scale 0.25] [--requests 8] [--steps 8] [--reps 20]
                        [--kernels-only | --lm-only | --mesh-only]
                        [--parent-src DIR/src]
  python3 chip_smoke.py --window-only [--src DIR/src]

Phases, each printing JSON lines; any mismatch, build failure or launch
error exits non-zero:

  1. device + build: the card's name and power limit (nvidia-smi), the
     seconds to compile every ``csrc/*.cu`` (one nvcc each, in parallel),
     each kernel's registers and spills, and ``cuobjdump -sass`` of B9's
     library, which must hold HGMMA (wgmma) instructions of the TF32 and
     BF16 kinds and UTMALDG (TMA) loads, and no HMMA (mma.sync);
  2. kernels against plain: each CUDA kernel and its plain PyTorch
     version on the same inputs on the card, plus adversarial cases
     (B9's in phase 6).
     The serving kernels (compact, hash_dedup, compact_perm, SpMM) get
     the real inputs of every layer of the first served request; the
     training kernels the real inputs of every layer of the first
     training batch: segment_select on NS's, masked_cdf_draw's search
     on LADIES's CDFs, the transposed SpMM and the row gather
     (``gather_dst``) on LABOR-0's, the gather driven through an
     ``aggregate`` backward with the edge weights requiring a gradient
     (its own path: counts zeroed before, read after); the edge softmax
     (B8) on the logits of each layer of the first LABOR-0 GATv2 batch
     (8, 8 and 1 heads) and the per-edge scatter ``scatter_rows`` in
     both forms (dst-sorted, and through ``src_perm``) at that batch's
     widths.
     Integers must match bit for bit, floats to rtol = atol = 1e-5
     (summation order). Times with CUDA events, beside the bound (bytes
     over 3.35 TB/s or flops over 67 TFLOP/s fp32, whichever is larger,
     counting what these inputs need) and one PyTorch library call
     computing the same function, where there is one (none computes a
     segment softmax). Compact against ``torch.nonzero``, hash_dedup
     against ``torch.unique`` + ``torch.searchsorted``, compact_perm
     against a stable ``torch.argsort``, the forward SpMM against a
     gather + ``index_add_``, segment_select against one stable
     ``torch.sort`` + a rank filter and B7's search against
     ``torch.searchsorted`` are then timed again on the same
     inputs, ``TRIAL_ROUNDS`` rounds in turn, all rounds printed, each
     as event ms (back-to-back calls between CUDA events), device ms
     and operations (torch.profiler over the same calls) and enqueue ms
     (a host clock over them with no sync), then each call's device ms
     (for the SpMM, segment_select and the edge softmax also in every
     round and by device operation; the edge softmax's trial has no
     library side). Every bound comes from ``launch/roofline.py``'s
     work of the kernel's contract. hash_dedup's tuning candidates
     (``ops/autotune.py``: one, the kernel's own table of 1.5 slots an
     entry) run on layer 2's inputs, each bit for bit against a first
     call on the same cached table and timed. With ``--kernels-only``
     the script stops here;
  3. serve: ``--requests`` requests through ``repro_torch.launch.serve``'s
     synchronous path on products at ``--scale`` (0.25: 612,257
     vertices) with the paper's widths (100 features, hidden 256, 47
     classes, 3 layers, fanouts 10,10,10, LABOR-0, batch 1024). Launch
     counters are zeroed just before and read just after; every serving
     kernel must have run. The first request is then recomputed with the
     plain versions on the card: integer block fields bit for bit,
     logits to rtol = atol = 1e-4. Then 2 exact requests with the
     ``full`` sampler at ``FULL_DEPTH`` layers (every in-edge; the
     caps grow on overflow), and ``--requests`` LABOR-0 requests of
     ``--model gatv2`` (8 heads of 32), each counted as its own path,
     recomputed the same way and profiled over 5 warm requests (device
     busy ms, operations and idle share a request). Then weighted graphs
     (LABOR §A.7): the same CSR with a weight per edge from numpy at
     ``--seed`` (uniform in [0.1, 2)); LABOR-0, NS, LABOR-1, LADIES and
     PLADIES each sample the first request's 3 layers on the kernel path
     (its own path, ``weighted <sampler>``) and on the plain path on the
     card: integer block fields bit for bit, weights to rtol = atol =
     1e-5; per-layer vertices and edges beside the unweighted ones, and
     the host reads of loop conditions (none for LABOR-0). Then the
     async driver (``serve async``): LABOR-0 GCN through
     ``serve_gnn_driver``'s path on 256 Zipfian (a = 1.1) requests of 64
     seeds, 16 coalesced dispatches of 1024, once with a 262,144-slot
     FIFO feature cache and a 16,384-slot hidden cache at max_age 0 and
     once with both off: every ticket's logits equal bit for bit, 5
     hash_dedup launches a dispatch (the sampler's 3 and one lookup a
     cache), the first dispatch recomputed on the plain path (blocks bit
     for bit, logits to 1e-4; the tickets' logits equal the kernel
     path's), p50/p99, nodes/s, hit rate, unique misses a dispatch, 5
     warm dispatches under torch.profiler and one cache lookup at layer
     2's shape timed beside its bytes bound;
  4. train: ``--steps`` steps each of LABOR-0, NS, LABOR-1, LABOR-*,
     labor-d, LADIES and PLADIES with the GCN, and of LABOR-0 with
     GraphSAGE and with GATv2, through ``repro_torch.launch.train``'s
     path at the same widths (Adam, lr 1e-3, clip 1.0; LADIES/PLADIES
     draw 10,240 vertices per layer), counts zeroed before and read
     after each: every kernel of the path must have run (segment_select
     for NS, masked_cdf_draw for LADIES, the transposed SpMM for the GCN
     and SAGE, the gather, the per-edge scatter and the edge softmax for
     GATv2), every loss must be finite; the final caps (after any
     overflow replay), the host reads of loop conditions in one warm
     step and LABOR-i/*'s iteration counts per layer are printed. Step 0
     is recomputed with the plain versions on the card from the same
     initial parameters, and with the plain versions in fp64: blocks bit
     for bit; the loss of both fp32 paths within 1e-5 (relative) of
     fp64; per tensor, the gradients and the updated parameters of both
     fp32 paths within 1e-3 relative L2 of fp64. GATv2's fp64 pass does
     not fit the card at batch 1024, so there its two fp32 paths are
     held to each other (the same bounds) and the fp64 yardstick runs at
     batch ``GATV2_FP64_BATCH``. The bound is per tensor
     and in L2 because fp32 sums in another order move a pre-activation
     near 0 across the ReLU in one path and not the other (the number of
     such sign flips, at each ReLU, ELU and GATv2 LeakyReLU, is
     printed), which changes whole gradient rows, and
     Adam's first step moves each entry by about lr along its gradient's
     sign, which float noise decides for a gradient near 0. One warm step
     is split by CUDA events into sample / gather / forward / backward /
     Adam; then torch.profiler over a window of warm steps through
     ``TrainEngine.step`` gives the device's busy time per step, its
     idle share in that same window and the top device kernels; steps/s,
     sampled vertices per step and peak memory are printed per path;
  4b. the runtime (checkpoints, the guardrail, fault injection, the
     pipelined driver), LABOR-0 GCN at phase 4's widths through
     ``train_gnn``, ``max(--steps, 12)`` steps a run: (a) two clean
     serial runs, which must agree bit for bit (the later comparisons are
     held to the largest difference of these two), and a run with
     ``guard="quarantine"`` equal to them bit for bit (counted path
     ``train guarded``); one warm step with and without the guard under
     ``torch.cuda.set_sync_debug_mode("warn")`` (the guard may add no
     synchronizing call) and under the profiler (device operations,
     busy ms); (b) ``nan_grad@3,corrupt_feats@6=1e8`` quarantined
     (warmup 2): both fired, a nonfinite and a spike batch, 2 or more
     quarantines, no rollback, all losses finite; (c) ``guard="rollback"``
     with a checkpoint every 4 steps and ``torn_ckpt@1,corrupt_feats@9=1e8``:
     one rollback, the torn step 8 skipped for step 4, the parameters the
     clean run's; (d) ``run_with_restarts`` over a run preempted at step 7
     (checkpoints every 4): one restart, the history resumed at step 5,
     the parameters the clean run's; (e) ``serve_gnn_driver``'s path with
     ``--ckpt-dir`` of (c) (counted path ``serve checkpoint``): the
     restored parameters and dispatch 1's logits equal the in-memory
     model's bit for bit; then the driver on a background thread with
     both caches on and ``SERVE_FAULTS``: every ticket served, the
     cache-off fallback taken, the pump restarted by the watchdog; (f)
     ``pipeline`` ``prefetch`` and ``full`` (counted paths ``train
     prefetch``, ``train full``): sampled vertices and edges per step and
     the parameters equal the serial run's; 5 warm steps of ``off``,
     ``prefetch`` and ``full`` under the profiler (busy ms, operations,
     idle share) and 5 timed by the host clock (steps/s); with
     ``--parent-src`` also the ``off`` window of that tree (a child
     process of ``--window-only``, which builds that tree's kernels);
  4c. the multi-device engine (``train mesh``): the labor-gcn
     configuration (``configs/labor_gcn.py``: features 100, hidden 256,
     47 classes, 3 layers, fanouts 10,10,10, LABOR-0, cap safety 1.6,
     global batch 32,768) on the same products graph, its one cut (scale
     0.25: 612,257 vertices instead of 2,449,029; generating scale 1.0
     takes a minute of host time). ``MESH_STEPS`` steps of the launcher's
     batches, each followed by a flush, through
     ``launch/gnn_step.build_gnn_engine``: the single-device engine on
     the card first (through ``launch/perf.measure_gnn``: its roofline
     terms from the sampled blocks' live sizes, dominant term, ``mfu``
     and measured step, with the card), then world size 1 (an NCCL group
     of this process;
     counted path ``train mesh``; step 0's sampling half, the routing
     included, recomputed on the plain path, bit for bit), then world
     size 2 (two spawned ranks on this card in a gloo group over CUDA
     tensors, which read the graph this process saved instead of
     generating it; counted path ``train mesh 2 ranks``, the counts
     summed over the ranks). Each mesh run is held to the single-device
     one: every layer's frontier set bit for bit, ``sampled_v`` and
     ``sampled_e`` equal, loss within 1e-4, accuracy within 1e-6, the
     final parameters within 2e-5; compact, hash_dedup, compact_perm and
     the SpMM both ways launched. Printed: the warm step's seconds, the
     feature all-to-all's live rows and bytes and its padded bytes a
     step, |V^3| beside the single-device one, the collectives staged
     through pinned host memory, the card. ``--mesh-only`` runs phase 1
     and this phase alone (no ``kernels`` or ``ok`` line);
  5. where the serving time goes: one warm request split into sample /
     gather / forward with CUDA events; then torch.profiler over a
     window of warm requests, as for training;
  6. LM serving, after the GNN phases' memory is freed: B9 (the flash
     kernel) against its plain version on adversarial inputs (Sq 1, 130
     and 1000, window 1 and window >= S, GQA ratios 1-8, every head
     dimension, bf16, a custom scale, non-causal with a ragged Sk,
     queries that see no key, strided and misaligned q; fp32 within 2e-5
     x max(1, max|v|), bf16 within 3e-2; MHA of 32 heads of 80 and
     GQA 64/4 at hd 128 among them); then each path of ``LM_PATHS``
     through ``repro_torch.launch.serve``'s ``serve_lm`` at full width with
     random weights (gemma2-2b: batch 1, a 32,768-token prompt, 32
     tokens; stablelm-1.6b: batch 4, 4,096, 16), counts zeroed before
     and read after (one B9 launch per layer: 26 and 24), B9 held
     against its plain version and timed on the real q, k and v of the
     first layers (the plain version in 1024-query chunks; SDPA as the
     library call where it computes the same function), beside two
     bounds (fp32 FMA at 67 TFLOP/s, 3xTF32 at 165; ``bound_ms`` is the
     latter, the rate B9's tensor-core products run at), the prefill
     recomputed on the plain path on the card (last logits and every
     layer's K/V within 1e-4 relative L2), the decode teacher-forced
     from both caches with the served tokens, both fp32 paths within
     1e-4 of an fp64 recompute at a 2,048-token prompt, 3 decode steps
     and one prefill under the profiler (B9's share of the device time,
     idle shares);
  7. LM training through ``repro_torch.launch.train``'s ``--workload lm``
     path (``train_lm``), remat on, Adam lr 1e-3
     on the reference's bigram stream, at full width and cut depth
     (``LM_TRAIN_PATHS``, listed in each path's line): gemma2-2b (phase
     6's weights cut to 4 of its 26 layers, batch 1 x 2,048 tokens, 4
     steps) and mamba2-370m (8 of its 48 layers, 4 x 2,048, 4 steps).
     Step 0 recomputed on the kernel and the plain path from the
     same weights (losses within 1e-5 relative; every gradient and every
     parameter after the step's update within 1e-3 relative L2 per
     tensor) and against fp64 at ``TRAIN_FP64_SEQ`` tokens with remat
     off (both fp32 paths' loss within 1e-5, gradients within 1e-3: the
     checkpointed gradients against plain autograd); for mamba2-370m 2
     microbatches against 1 on the same batch (loss within 1e-5,
     gradients within 1e-4). Counts zeroed before the run, read after:
     B9 launches twice per attention layer a step (the forward and the
     remat recompute: 4 x 2 for gemma2-2b, none for mamba2-370m); the
     losses finite, the last below the first; one more step and one
     no-gradient forward under the profiler (busy ms, operations, idle
     share, B9's share);
  8. LM serving of the other blocks, as phase 6, at full width and cut
     depth (each cut listed in its line as ``reduced``; the time limit,
     with phase 9): mamba2-370m at 24 of its 48 layers (batch 4, a
     4,096-token prompt, 16 tokens; the conv and SSM states in the cache
     checks, as the prefill left them), zamba2-2.7b at 18 of its 54 (1,
     8,192, 16; its shared attention is 3 B9 launches, MHA of 32 heads
     of 80) and qwen3-moe-235b-a22b at one of its 94 layers (1, 4,096,
     16; GQA 64/4 at hd 128);
  9. the encoder-decoder (cross-attention and an encoder, at
     whisper-large-v3's widths: ``encdec_cfg()``, 32 encoder layers and
     32 decoder layers of self- plus cross-attention, 20 heads of 64,
     1,500 frames, random weights): ``serve lm whisper-large-v3`` as
     phase 6 at full depth (batch 4, 1,500 frames of the launcher's
     ``normal(key(seed))`` source, a 416-token prompt, 32 tokens; one B9
     launch per decoder self-attention layer, 32 a prefill; the cross
     K/V among the cache checks; the encoder and the cross-attention
     take the plain path, as in the reference), then ``train lm
     whisper-large-v3`` as phase 7 from the same weights, cut to 8 of
     the decoder's 64 layer entries and 4 of the encoder's 32 (listed
     in its line; 4 x 448 tokens and the serving path's 1,500 random
     frames, handed to ``train_lm``: its default zero frames overflow a
     deep encoder's gradient, ROADMAP C7; 4 steps; step 0's checks and 2
     microbatches against 1, the encoder's gradients and parameters
     included, a cross block's ``bk`` gradient, 0 in exact arithmetic,
     held to the noise level; B9 2 x 4 launches a step; one step on
     batch 0 must lower batch 0's loss). ``--lm-only`` runs phase 1 and
     then phases 6-9 alone (no ``kernels`` or ``ok`` line).
     In phases 6-9 each path's line carries the dry run's account
     (``launch/dryrun.account`` of its config, batch and sequence:
     parameters, gradients, Adam's moments, activations, cache) beside
     its measured peak; the resident state (the parameters, and the
     optimizer state or the cache the path holds) must not exceed the
     peak. Each training path also prints ``launch/perf.measure_lm``'s
     roofline terms and ``mfu`` for its measured warm step.

The line before the last is the ``kernels`` JSON object: per kernel,
``launches_by_path`` holds its count on each counted path (serve, serve
full, serve gatv2, weighted <sampler> for each weighted sampler, serve
async, train <sampler> for each sampler, train sage, train gatv2, the
weight-gradient path, train guarded, train prefetch, train full, serve
checkpoint, train mesh, train mesh 2 ranks, serve lm gemma2-2b, serve
lm stablelm-1.6b, train lm gemma2-2b, train lm mamba2-370m, serve lm
mamba2-370m, serve lm zamba2-2.7b, serve lm qwen3-moe-235b-a22b, serve
lm whisper-large-v3, train lm whisper-large-v3) and ``launches`` their
sum.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA the
script exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# GATv2's first layer allocates and frees (9.4 M, 256) tensors of 9.65 GB
# in turn; growable segments keep the cached blocks from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import numpy as np  # noqa: E402
import torch  # noqa: E402

#: rounds of phase 2's trials (each kernel in ``trials`` against its
#: library call)
TRIAL_ROUNDS = 5
#: trials that also print each call's device operations by name
SPLIT_TRIALS = ("spmm", "segment_select", "edge_softmax")
INT_MAX = 2**31 - 1
DEV = "cuda"
WGRAD_PATH = "aggregate backward, weights requiring a gradient"
# Layers of the exact ``full`` serving requests: the model's 3. At products
# scale 0.25 three hops already reach all but one of the 612,257 vertices
# over 13.8 M edges, and take ~21 ms per request, so the paper's depth fits
# the time limit with room to spare.
FULL_DEPTH = 3


def tensor_core_sass(build):
    """B9 runs on Hopper's own units: ``cuobjdump -sass`` of its library
    holds HGMMA (wgmma) instructions of the TF32 kind and of the BF16
    kind, and UTMALDG (TMA tensor loads), and no HMMA (``mma.sync``);
    fails otherwise, and returns the counts."""
    lib = build._target("flash_attention")
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    lines = [ln.strip() for ln in sass.stdout.splitlines()]
    hgmma = [ln for ln in lines if "HGMMA" in ln]
    tf32 = [ln for ln in hgmma if ".TF32" in ln]
    bf16 = [ln for ln in hgmma if ".BF16" in ln]
    tma = [ln for ln in lines if "UTMALDG" in ln]
    hmma = [ln for ln in lines if "HMMA" in ln]
    counts = {"hgmma_lines": len(hgmma), "tf32_hgmma_lines": len(tf32),
              "bf16_hgmma_lines": len(bf16), "utmaldg_lines": len(tma),
              "hmma_lines": len(hmma)}
    if sass.returncode != 0 or not tf32 or not bf16 or not tma or hmma:
        fail(f"cuobjdump -sass of {lib.name}: {counts} "
             f"({sass.stderr.strip()[:200]})")
    return {**counts, "first_tf32": tf32[0], "first_bf16": bf16[0],
            "first_utmaldg": tma[0]}


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
    """Per-kernel sums over the calls of one request. ``status``: a
    note on the kernel's design for the ``kernels`` line, or None.
    ``peak``: the name of the card's peak for the kernel's operations in
    ``launch/roofline.py`` (fp32 FMA, or 3xTF32 on the tensor cores,
    where the row also carries both bounds)."""

    def __init__(self, name, route, source, replaces, status=None,
                 peak="fp32"):
        self.row = dict(name=name, route=route, source=source,
                        replaces=replaces, status=status, launches=0,
                        launches_by_path={}, max_abs_err=0.0,
                        ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        bound_by="bytes", library_ms=0.0)
        self.peak = peak
        self.flops = 0.0
        self.flop_bound = 0.0
        self.byte_bound = 0.0

    def add(self, ms, plain_ms, library_ms, work, err=0.0):
        """Adds one call's times; returns them with its bound (from
        ``work``, the call's ``roofline.Work``), for the per-call line.
        ``library_ms`` None: no one PyTorch call computes the same
        function."""
        from repro_torch.launch import roofline as rl
        nbytes, flops = work
        rate = rl.PEAKS[self.peak]
        r = self.row
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        if library_ms is None:
            r["library_ms"] = None
        elif r["library_ms"] is not None:
            r["library_ms"] += library_ms
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        byte_ms = nbytes / rl.HBM_BW * 1e3
        flop_ms = flops / rate * 1e3
        self.byte_bound += byte_ms
        self.flop_bound += flop_ms
        self.flops += flops
        r["bound_ms"] = max(self.byte_bound, self.flop_bound)
        r["bound_by"] = ("bytes" if self.byte_bound >= self.flop_bound
                         else "operations")
        out = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(byte_ms, flop_ms))
        if self.peak != "fp32":
            both = {"bound_ms_fp32_fma": (self.flops / rl.PEAK_FP32 * 1e3,
                                          flops / rl.PEAK_FP32 * 1e3),
                    "bound_ms_3xtf32": (self.flops / rl.PEAK_TF32X3 * 1e3,
                                        flops / rl.PEAK_TF32X3 * 1e3)}
            for k, (total, call) in both.items():
                r[k] = max(self.byte_bound, total)
                out[k] = max(byte_ms, call)
        return out


def phase_kernels(engine, data, seeds, key, reps, records, trials):
    """Phase 2: every kernel against its plain version at the inputs of
    each layer of one request, then adversarial inputs. Appends each
    compact, hash_dedup and compact_perm call's (kernel, library) pair
    to ``trials``."""
    from repro_torch.launch import roofline as rl
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
            pair = (lambda flags=flags, cap=cap, live=live:
                    fk.compact(flags, cap, live),
                    lambda flags=flags: torch.nonzero(flags))
            trials["compact"].append(pair)
            t = records["compact"].add(
                cuda_ms(pair[0], reps),
                cuda_ms(lambda: fr.compact(flags, cap), reps),
                cuda_ms(pair[1], reps), rl.compact(n, cap))
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

        pair = (lambda args=args, live=live: fk.hash_dedup(*args, live),
                unique_lookup)
        trials["hash_dedup"].append(pair)
        t = records["hash_dedup"].add(
            cuda_ms(pair[0], reps),
            cuda_ms(lambda: fr.hash_dedup(*args), reps),
            cuda_ms(pair[1], reps),
            rl.hash_dedup(n, S, new_cap, E))
        emit({"phase": "kernels", "kernel": "hash_dedup", "layer": layer,
              "E": E, "S": S, "new_cap": new_cap, "live": n,
              "num_new": int(got.num_new), **t})
        if layer == len(sampler.caps) - 1:
            autotune_candidates(args, live, reps)

        pargs = (blk.src_slot, blk.edge_mask, caps.vertex_cap)
        got = fk.compact_perm(*pargs, live)
        want = fr.compact_perm(*pargs)
        torch.cuda.synchronize()
        same(f"compact_perm layer {layer}", got, want)
        keyed = torch.where(blk.edge_mask, blk.src_slot, caps.vertex_cap)
        pair = (lambda pargs=pargs, live=live: fk.compact_perm(*pargs, live),
                lambda keyed=keyed: torch.argsort(keyed, stable=True))
        trials["compact_perm"].append(pair)
        t = records["compact_perm"].add(
            cuda_ms(pair[0], reps),
            cuda_ms(lambda: fr.compact_perm(*pargs), reps),
            cuda_ms(pair[1], reps), rl.compact_perm(n, E))
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
        err = spmm_bits_or_fail(f"spmm layer {layer} F {F}", got, sargs)
        src = blk.src_slot[:n]
        rows = int(torch.unique(src).numel())
        seg = blk.dst_slot[:n].long()
        live_rows = int(torch.unique(seg[seg >= 0]).numel())
        last_key = int(seg[-1]) if n else -1
        past_last = blk.seed_cap - min(max(last_key + 1, 0), blk.seed_cap)

        def library(h=h, src=src, seg=seg, w=blk.weight[:n], S=blk.seed_cap):
            return torch.zeros(S, h.shape[1], device=DEV).index_add_(
                0, seg, h[src.long()] * w[:, None])

        pair = (lambda sargs=sargs, live=live: sk.spmm_block(*sargs,
                                                             n_live=live),
                library)
        trials["spmm"].append(pair)
        t = records["spmm"].add(
            cuda_ms(pair[0], reps),
            cuda_ms(lambda: sr.spmm_block_ref(*sargs), reps),
            cuda_ms(pair[1], reps),
            rl.spmm(n, rows, blk.seed_cap, F), err=err)
        emit({"phase": "kernels", "kernel": "spmm", "layer": layer,
              "S": blk.seed_cap, "T": blk.next_cap, "F": F, "live": n,
              "live_rows": live_rows, "rows_past_last_key": past_last,
              "max_abs_err": err, **t})
    adversarial(fk, fr, sk, sr)


def autotune_candidates(args, live, reps):
    """hash_dedup's tuning candidates (``ops/autotune.py``: the kernel's
    own table, 1.5 slots an entry) on one layer's inputs: each bit for
    bit against a first call's, each timed (CUDA events)."""
    from repro_torch.ops import autotune
    try:
        timed = autotune.time_candidates(*args, live, reps=reps)
    except ValueError as e:
        fail(str(e))
    emit({"phase": "kernels", "kernel": "hash_dedup", "autotune": [
        {**cand, "ms": us / 1e3, "bit_exact": True} for cand, us in timed],
        "cache_fingerprint": autotune.cache_fingerprint()})


def spmm_bits_or_fail(name, got, sargs):
    """The forward SpMM against its plain version run on the CPU, whose
    scatter_add sums each row in edge order (on the card it adds with
    atomics, in no fixed order): bit for bit. Returns the max abs error
    (0.0)."""
    from repro_torch.kernels.spmm import ref as sr
    want = sr.spmm_block_ref(*[x.cpu() for x in sargs[:5]], sargs[5])
    got = got.cpu()
    if got.shape != want.shape or not torch.equal(got.view(torch.int32),
                                                  want.view(torch.int32)):
        err = ((got - want).abs().max().item() if got.shape == want.shape
               else "shape")
        fail(f"{name}: kernel and plain version differ (max abs err {err})")
    return 0.0


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
        sargs = (src, dst, w, mask, h, S)
        spmm_bits_or_fail(f"spmm adversarial E={E} F={F} live={live_n}",
                          sk.spmm_block(*sargs, n_live=live), sargs)
        cases += 1
    # the forward kernel's splits on a padded F = 100 block: rows of 0, 1,
    # 32, 33, 128 and 129 edges (a lane group's chunk, the block-summed
    # rows), a row of 3,000, -1 sources, masked edges, a seed cap 20x the
    # live rows; then the same rows at F = 64 (half a warp a row) and 300
    lens = torch.tensor([0, 1, 32, 33, 128, 129, 3, 10, 0, 64] * 300
                        + [3000], device=dev)
    dst = torch.repeat_interleave(torch.arange(
        lens.numel(), device=dev, dtype=torch.int32), lens)
    n = dst.numel()
    E, S, T = n + 500, 20 * lens.numel(), 40_000
    dst = torch.cat([dst, torch.full((500,), -1, dtype=torch.int32,
                                     device=dev)])
    mask = (torch.arange(E, device=dev) < n) & bools(E, 0.9)
    src, w = ints(E, -1, T), torch.rand(E, generator=g, device=dev) - 0.3
    live = torch.tensor(n, dtype=torch.int32, device=dev)
    for F in (100, 64, 300):
        h = torch.randn(T, F, generator=g, device=dev)
        sargs = (src, dst, w, mask, h, S)
        spmm_bits_or_fail(f"spmm adversarial padded block F={F}",
                          sk.spmm_block(*sargs, n_live=live), sargs)
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


def device_rows(prof):
    """``launch/perf.py``'s (self device us, name, count) of each device
    event of a finished profile."""
    from repro_torch.launch import perf
    return perf.device_rows(prof)


def enqueue_ms(fn, reps):
    """Host clock over ``reps`` calls with no sync in between, per call:
    the time the host takes to enqueue one call (all of it for a call
    that reads the device, as ``torch.nonzero`` does)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def device_ms(fns, reps):
    """torch.profiler over ``reps`` calls of each of ``fns``: the summed
    device time of their own device operations (kernels, copies,
    memsets) per call, and the number of those operations per call,
    each summed over ``fns``; (None, None) where the profiler saw no
    device event (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return None, None
    return (sum(r[0] for r in rows) / 1e3 / reps,
            sum(r[2] for r in rows) / reps)


def device_ms_by_op(fn, reps):
    """torch.profiler over ``reps`` calls of ``fn``: each device operation
    by name, with its device ms and its count per call (None where the
    profiler saw no device event: not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return None
    return {name[:80]: {"ms": us / 1e3 / reps, "count": c / reps}
            for us, name, c in sorted(rows, reverse=True)}


def split_ms(fns, reps):
    """Per call, summed over ``fns``: CUDA-event ms of back-to-back calls
    (``cuda_ms``), device ms and device operations (``device_ms``), and
    enqueue ms (``enqueue_ms``)."""
    dev, ops = device_ms(fns, reps)
    return {"event_ms": sum(cuda_ms(f, reps) for f in fns),
            "device_ms": dev, "device_ops": ops,
            "enqueue_ms": sum(enqueue_ms(f, reps) for f in fns)}


def phase_trials(trials, reps):
    """Each kernel of ``trials`` against its library call (compact:
    ``torch.nonzero``; hash_dedup: ``torch.unique`` +
    ``torch.searchsorted``; compact_perm: a stable ``torch.argsort``; the
    forward SpMM: a gather + ``index_add_``; segment_select:
    ``library_select``; B7's search: ``torch.searchsorted``) on the same
    real inputs,
    ``TRIAL_ROUNDS`` rounds in turn (kernel, library) in one run. Each
    round gives, for both sides, the event, device and enqueue ms of
    ``split_ms``, summed over the calls of phase 2 (``reps`` launches
    each): the event ms is the larger of the device's and the host's
    pace, and the split says which one it is. Then each call's device ms
    alone, in phase 2's order, and for ``SPLIT_TRIALS`` each call's
    device ms in every round (``*_device_ms_by_call_rounds``, one list a
    call) and its device operations by name. A pair whose library call
    is None (the edge softmax: no PyTorch call computes it) has the
    kernel side only, and the line says so."""
    for name, pairs in trials.items():
        sides = (("kernel", 0),)
        if all(lib is not None for _, lib in pairs):
            sides += (("library", 1),)
        rounds = {side: [] for side, _ in sides}
        for _ in range(TRIAL_ROUNDS):
            for side, i in sides:
                rounds[side].append(split_ms([p[i] for p in pairs], reps))
        out = {"phase": "kernels", "trial": name, "calls": len(pairs),
               "rounds": TRIAL_ROUNDS}
        if len(sides) == 1:
            out["library"] = "none: no single PyTorch call computes it"
        for side, rs in rounds.items():
            for key in rs[0]:
                out[f"{side}_{key}"] = [r[key] for r in rs]
        for side, i in sides:
            out[f"{side}_device_ms_by_call"] = [
                device_ms([pair[i]], reps)[0] for pair in pairs]
        if name in SPLIT_TRIALS:
            # each call's device ms in every round, both sides in turn
            for side, _ in sides:
                out[f"{side}_device_ms_by_call_rounds"] = [[] for _ in pairs]
            for _ in range(TRIAL_ROUNDS):
                for side, i in sides:
                    for c, pair in enumerate(pairs):
                        out[f"{side}_device_ms_by_call_rounds"][c].append(
                            device_ms([pair[i]], reps)[0])
            out["kernel_device_ops_by_call"] = [
                device_ms_by_op(pair[0], reps) for pair in pairs]
        if "library" in rounds:
            for key in ("event_ms", "device_ms", "enqueue_ms"):
                out[f"kernel_faster_in_{key[:-3]}"] = sum(
                    a < b for a, b in zip(out[f"kernel_{key}"],
                                          out[f"library_{key}"])
                    if a is not None and b is not None)
        emit(out)


def counters():
    """The kernel wrappers' modules, each with its LAUNCHES counts."""
    from repro_torch.kernels.edge_softmax import ops as ek
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.frontier import ops as fk
    from repro_torch.kernels.spmm import ops as sk
    return fk, sk, ek, fa


def reset_launches():
    for m in counters():
        m.reset_launches()


def launch_counts():
    """Launches per kernel wrapper since the last reset_launches()."""
    out = {}
    for m in counters():
        out.update(m.LAUNCHES)
    return out


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


def segment_lengths(seg_start, E, n):
    """Live edges of each segment of an expand_seed_edges layout: segment
    s spans [seg_start[s], seg_start[s + 1]) (the last one ends at E),
    clipped to the buffer and the live prefix n."""
    starts = torch.clamp(seg_start.long(), 0, E)
    ends = torch.cat([starts[1:], starts.new_full((1,), E)])
    return torch.clamp(torch.clamp(ends, max=n) - starts, min=0)


def phase_train_kernels(samplers_, data, seeds, key, reps, records, trials):
    """Phase 2, training half: segment_select on the NS batch's real
    inputs, masked_cdf_draw's search on the LADIES batch's CDFs, the
    transposed SpMM and the row gather on the LABOR-0 batch's blocks,
    then the weight-gradient path."""
    from repro_torch.launch import roofline as rl
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
        lens = segment_lengths(seg_start, E, n)
        pair = (lambda a=a, live=live: fk.segment_select(*a, live),
                lambda a=a: library_select(*a))
        trials["segment_select"].append(pair)
        t = records["segment_select"].add(
            cuda_ms(pair[0], reps),
            cuda_ms(lambda: fr.segment_select(keys, slot, mask, seg_start,
                                              take), reps),
            cuda_ms(pair[1], reps),
            rl.segment_select(n, S, E))
        emit({"phase": "kernels", "kernel": "segment_select", "layer": layer,
              "E": E, "S": S, "live": n, "selected": int(want.sum()),
              "segments_over_256": int((lens > 256).sum()),
              "longest_segment": int(lens.max()) if S else 0, **t})

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
        pair = (lambda cdf=cdf, u=u: fk.cdf_search(cdf, u), library)
        trials["masked_cdf_draw"].append(pair)
        t = records["masked_cdf_draw"].add(
            cuda_ms(pair[0], reps),
            cuda_ms(lambda: fr.cdf_search(cdf, u), reps),
            cuda_ms(pair[1], reps), rl.masked_cdf_draw(C, n))
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
            rl.gather_dst(n, rows, E, F))
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
            rl.spmm_t(n, rows, blk.next_cap, F), err=err)
        emit({"phase": "kernels", "kernel": "spmm_t", "layer": layer,
              "S": blk.next_cap, "F": F, "live": n, "max_abs_err": err, **t})

    # the weight-gradient path: aggregate backward with the edge weights
    # requiring a gradient, against plain autograd on the card
    reset_launches()
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
    wgrad_launches = launch_counts()
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
    # segment_select: ties (some, then all keys), takes of 0, warp- and
    # block-sized segments, segments longer than a block stages, takes
    # at and past the live count, an expansion truncated at the cap, a
    # segment of length 1
    for deg_list, cap_frac, k in (([1], 1.0, 1), ([0, 3, 0, 40, 1], 1.0, 4),
                                  ([700, 2, 257, 256, 5000], 1.0, 10),
                                  ([30] * 50 + [900], 0.7, 10),
                                  # past the 10,240 keys a block stages
                                  ([12_000, 2048, 60_000, 5], 0.9, 10),
                                  # takes at and past the live count
                                  ([256, 257, 2048, 300], 1.0, 3000)):
        deg = torch.tensor(deg_list, dtype=torch.int32, device=dev)
        total = int(deg.sum())
        cap = max(1, int(total * cap_frac))
        seg_start = torch.cumsum(deg, 0, dtype=torch.int32) - deg
        pos = torch.arange(cap, device=dev)
        live = min(total, cap)
        mask = pos < live
        slot = torch.where(mask, torch.searchsorted(
            torch.cumsum(deg, 0), pos, right=True).to(torch.int32), -1)
        for ties in (0, 3, 1):
            keys = torch.rand(cap, generator=g, device=dev)
            if ties:
                keys = torch.floor(keys * ties) / ties
            keys = torch.where(mask, keys, 3.4e38)
            take = torch.clamp(deg, max=k)
            if k > max(deg_list):   # at the live count, and past it
                take[1::2] += 7
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


def sorted_edges(g, E, S, live_n, masked_in_prefix=0.0):
    """A block-like edge layout: a dst-sorted prefix of ``live_n`` edges
    over ``S`` rows (some rows empty, some with one edge), -1 and masked
    past it, optionally with masked edges inside the prefix."""
    dst = torch.sort(torch.randint(0, S, (E,), generator=g, device=DEV,
                                   dtype=torch.int32)).values
    live = torch.arange(E, device=DEV) < live_n
    dst = torch.where(live, dst, -1)
    mask = live & (torch.rand(E, generator=g, device=DEV) >= masked_in_prefix)
    return dst, mask, torch.tensor(live_n, dtype=torch.int32, device=DEV)


def check_softmax_rows(name, alpha, dst, mask, S):
    """Masked edges 0, every row with a masked-in edge sums to 1 (summed
    in float64: a float sum of a 50,000-edge row drops ~5e-5 of it)."""
    if bool((alpha[~mask] != 0).any()):
        fail(f"{name}: a masked edge has a non-zero coefficient")
    H = alpha.shape[1]
    sums = torch.zeros(S, H, dtype=torch.float64, device=DEV).index_add_(
        0, dst[mask].long(), alpha[mask].double())
    rows = torch.unique(dst[mask].long())
    err = (sums[rows] - 1).abs().max().item() if rows.numel() else 0.0
    if err > 1e-5:
        fail(f"{name}: a row's coefficients sum to 1 +- {err}")


def sums_close_or_fail(name, got, want, abs_sum, tol=1e-5):
    """Two sums of the same terms in another order: per entry, the gap
    within ``tol`` of the sum of the terms' magnitudes (``abs_sum``),
    the size of a summation-order difference; a row of many terms that
    cancel has a small sum but not a small gap. Returns the largest
    gap."""
    gap = (got - want).abs()
    if got.shape != want.shape or bool((gap > tol * abs_sum + 1e-30).any()):
        worst = (gap / abs_sum.clamp(min=1e-30)).max().item()
        fail(f"{name}: kernel and plain version differ by up to {worst} of "
             "the sum of the terms' magnitudes")
    return gap.max().item() if gap.numel() else 0.0


def phase_gatv2_kernels(engine, data, seeds, key, reps, records, n_cls,
                        seed):
    """Phase 2, GATv2 half: the edge-softmax kernel (B8) on the logits of
    the first LABOR-0 GATv2 batch at each layer (heads 8, 8, 1), then
    its trial (each call's device ms in each round and its device
    operations by name; no library side), the
    per-edge scatter in both forms (dst-sorted: ``scatter_edges``;
    through ``src_perm``: the backward of ``gather_src``) at that
    batch's widths, then adversarial cases."""
    from repro_torch.launch import roofline as rl
    from repro_torch import ops as TO
    from repro_torch.core import rng as rng_lib
    from repro_torch.kernels.edge_softmax import ops as ek
    from repro_torch.kernels.edge_softmax import ref as er
    from repro_torch.kernels.spmm import ops as sk
    from repro_torch.kernels.spmm import ref as sr
    from repro_torch.models import gnn as gnn_models

    blocks, feats = engine.sample_batch(data, seeds, key)
    model = gnn_models.gatv2_init(rng_lib.key(seed), feats.shape[1], 256,
                                  n_cls, len(blocks), device=DEV)
    with torch.no_grad():
        calls = capture(TO, "edge_softmax", lambda: model(
            blocks, feats, backend="eager"))
    if len(calls) != len(blocks):
        fail(f"GATv2 ran edge_softmax {len(calls)} times for {len(blocks)} "
             "layers")
    gen = torch.Generator(device=DEV).manual_seed(4)
    softmax_calls = []
    for i, ((blk, logit), _) in enumerate(calls):
        layer = len(blocks) - 1 - i          # the block's index
        logit = logit.contiguous()
        live = torch.clamp(blk.num_edges, max=blk.edge_cap)
        n, (E, H), S = int(live), logit.shape, blk.seed_cap
        sargs = (blk.dst_slot, blk.edge_mask, logit, S)
        got = ek.edge_softmax_rows(*sargs, live)
        want = er.edge_softmax_ref(*sargs)
        torch.cuda.synchronize()
        err = allclose_or_fail(f"edge_softmax layer {layer}", got, want)
        check_softmax_rows(f"edge_softmax layer {layer}", got, blk.dst_slot,
                           blk.edge_mask, S)
        kernel = (lambda sargs=sargs, live=live:
                  ek.edge_softmax_rows(*sargs, live))
        softmax_calls.append((kernel, None))
        t = records["edge_softmax"].add(
            cuda_ms(kernel, reps),
            cuda_ms(lambda: er.edge_softmax_ref(*sargs), reps), None,
            rl.edge_softmax(n, H, E), err=err)
        emit({"phase": "kernels", "kernel": "edge_softmax", "layer": layer,
              "E": E, "H": H, "S": S, "live": n, "max_abs_err": err,
              "library": "none: no single PyTorch call computes a segment "
                         "softmax", **t})
        del got, want
        # the per-edge scatter at this layer's message width
        F = model.layers[i].b.shape[0]
        vals = torch.randn(E, F, generator=gen, device=DEV)
        for form, index, perm, rows in (
                ("dst-sorted", blk.dst_slot, None, S),
                ("src_perm", blk.src_slot, blk.src_perm, blk.next_cap)):
            got = sk.scatter_rows(index, blk.edge_mask, vals, rows, perm=perm,
                                  n_live=live)
            want = sr.scatter_rows_ref(index, blk.edge_mask, vals, rows, perm)
            # through src_perm a row is a source vertex, and popular
            # ones sum hundreds of edges
            abs_sum = sr.scatter_rows_ref(index, blk.edge_mask, vals.abs(),
                                          rows)
            torch.cuda.synchronize()
            err = sums_close_or_fail(f"scatter_rows {form} layer {layer}",
                                     got, want, abs_sum)
            keep = blk.edge_mask & (index >= 0)
            idx, v = index[keep].long(), vals[keep]

            def library(idx=idx, v=v, rows=rows, F=F):
                return torch.zeros(rows, F, device=DEV).index_add_(0, idx, v)

            sums_close_or_fail(f"scatter_rows {form} library layer {layer}",
                               library(), want, abs_sum)
            t = records["scatter_rows"].add(
                cuda_ms(lambda: sk.scatter_rows(index, blk.edge_mask, vals,
                                                rows, perm=perm, n_live=live),
                        reps),
                cuda_ms(lambda: sr.scatter_rows_ref(index, blk.edge_mask,
                                                    vals, rows, perm), reps),
                cuda_ms(library, reps),
                rl.scatter_rows(n, F, rows, perm is not None), err=err)
            # the sweep's keys: the longest row (one warp's sequential
            # sum) and the widest jump between neighbours (rows the
            # offsets pass fills)
            keys = (index if perm is None else index[perm.long()])[:n]
            gap = int((keys[1:] - keys[:-1]).max()) if n > 1 else 0
            longest = int(torch.bincount(keys[keys >= 0].long()).max()
                          ) if n else 0
            emit({"phase": "kernels", "kernel": "scatter_rows", "form": form,
                  "layer": layer, "E": E, "F": F, "rows": rows, "live": n,
                  "longest_row": longest, "widest_key_gap": gap,
                  "max_abs_err": err, **t})
            del keys
            del got, want, abs_sum, idx, v
        del vals
    phase_trials({"edge_softmax": softmax_calls}, reps)
    E = blocks[-1].edge_cap
    del calls, blocks, feats, model, softmax_calls
    torch.cuda.empty_cache()
    attention_scores(E, 8, 32)
    adversarial_gatv2(ek, er, sk, sr)


def attention_scores(E, H, P):
    """GATv2's per-edge scores ``sum_p e[:, h, p] attn[h, p]``, forward
    and backward, two ways at the first layer's shape: ``torch.einsum``
    (whose ``attn`` gradient cuBLAS runs as one GEMV over all E edges)
    and the product with ``attn``'s block-diagonal (H*P, H) matrix that
    the model runs. One timed call each (CUDA events) after a warm-up;
    their gradients for ``attn`` agree to 1e-5 relative L2, those for
    ``e`` (the same products) to 1e-6 of their largest entry."""
    g = torch.Generator(device=DEV).manual_seed(6)
    e = torch.randn(E, H, P, generator=g, device=DEV, requires_grad=True)
    attn = torch.randn(H, P, generator=g, device=DEV, requires_grad=True)
    cot = torch.randn(E, H, generator=g, device=DEV)

    def einsum():
        return torch.autograd.grad(torch.einsum("ehp,hp->eh", e, attn),
                                   (e, attn), cot)

    def block_diagonal():
        blocks = torch.block_diag(*attn[:, :, None].unbind(0))
        return torch.autograd.grad(e.view(E, H * P) @ blocks, (e, attn), cot)

    de_ref, dattn_ref = einsum()
    de, dattn = block_diagonal()
    de_err = ((de - de_ref).abs().max() / de_ref.abs().max()).item()
    if de_err > 1e-6:
        fail(f"attention scores: d e differs by {de_err} of its largest entry")
    dattn_err = kernel_vs_plain("attention scores", [dattn], [dattn_ref],
                                ["d attn"], tol=1e-5)
    del de, dattn, de_ref, dattn_ref
    emit({"phase": "kernels", "attention_scores": {"E": E, "H": H, "P": P},
          "einsum_fwd_bwd_ms": cuda_ms(einsum, 1),
          "block_diagonal_fwd_bwd_ms": cuda_ms(block_diagonal, 1),
          "d_e_max_rel_err": de_err, "d_attn_rel_l2": dattn_err[0]})
    del e, attn, cot
    torch.cuda.empty_cache()


def adversarial_gatv2(ek, er, sk, sr):
    """Edge cases of the edge-softmax kernel (to 1e-6) and the per-edge
    scatter (to 1e-5)."""
    from repro_torch.kernels.frontier import ref as fr
    g = torch.Generator(device=DEV).manual_seed(5)
    cases = 0
    # (E, S, H, live edges, masked share inside the prefix, row spread)
    for E, S, H, live_n, masked, spread in (
            (5000, 300, 8, 4000, 0.0, 200.0),   # rows 200 apart in logits
            (3000, 5000, 8, 3000, 0.0, 0.0),    # mostly one edge a row
            (1, 1, 1, 1, 0.0, 0.0), (4000, 100, 1, 3500, 0.0, 90.0),
            (6000, 400, 8, 5000, 0.3, 0.0),     # masked inside the prefix
            (2000, 50, 8, 0, 0.0, 0.0),         # no live edge
            (20000, 40, 8, 18000, 0.1, 0.0),    # rows of ~450: by the block
            (60000, 1, 8, 50000, 0.0, 0.0),     # one row holds every edge
            (5000, 300, 3, 4001, 0.2, 200.0),   # 3 heads, n H odd
            (3000, 200, 128, 2500, 0.1, 200.0)):  # 128 heads
        dst, mask, live = sorted_edges(g, E, S, live_n, masked)
        offset = (torch.rand(S, generator=g, device=DEV) - 0.5) * spread
        logits = (torch.randn(E, H, generator=g, device=DEV) * 3
                  + offset[dst.clamp(min=0).long()][:, None])
        name = f"edge_softmax adversarial E={E} S={S} H={H} live={live_n}"
        got = ek.edge_softmax_rows(dst, mask, logits, S, live)
        allclose_or_fail(name, got, er.edge_softmax_ref(dst, mask, logits, S),
                         tol=1e-6)
        check_softmax_rows(name, got, dst, mask, S)
        cases += 1
    for E, S, T, F, live_n in ((20000, 700, 3000, 1, 15000),
                               (20000, 700, 3000, 47, 20000),
                               (5000, 40, 60, 256, 0)):
        dst, mask, live = sorted_edges(g, E, S, live_n)
        src = torch.randint(-1, T, (E,), generator=g, device=DEV,
                            dtype=torch.int32)
        perm = fr.compact_perm(src, mask, T)
        vals = torch.randn(E, F, generator=g, device=DEV)
        for index, p, rows in ((dst, None, S), (src, perm, T)):
            got = sk.scatter_rows(index, mask, vals, rows, perm=p,
                                  n_live=live)
            name = f"scatter_rows adversarial E={E} F={F} perm={p is not None}"
            allclose_or_fail(name, got,
                             sr.scatter_rows_ref(index, mask, vals, rows, p))
            keep = mask & (index >= 0)
            allclose_or_fail(name + " library", got, torch.zeros(
                rows, F, device=DEV).index_add_(0, index[keep].long(),
                                                vals[keep]))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "adversarial_gatv2_cases": cases, "ok": True})


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


def rel_l2(a, c):
    return ((a.double() - c.double()).norm()
            / c.double().norm().clamp(min=1e-300)).item()


def against_fp64(what, kernel, plain, ref, names, tol=1e-3):
    """Per tensor, the relative L2 error of the kernel path and of the
    plain path against the fp64 recompute; both must stay within
    ``tol``. Returns the worst of each, with their tensors' names."""
    out = {"kernel": (0.0, ""), "plain": (0.0, "")}
    for n, a, b, c in zip(names, kernel, plain, ref):
        for path, x in (("kernel", a), ("plain", b)):
            e = rel_l2(x, c)
            if e > tol:
                fail(f"{what} {n}: the {path} path is {e} (relative L2) "
                     "from the fp64 recompute")
            out[path] = max(out[path], (e, n))
    return out


def kernel_vs_plain(what, kernel, plain, names, tol=1e-3):
    """Per tensor, the relative L2 distance of the kernel path from the
    plain path (both fp32) within ``tol``; returns the worst."""
    worst = (0.0, "")
    for n, a, b in zip(names, kernel, plain):
        e = rel_l2(a, b)
        if e > tol:
            fail(f"{what} {n}: the kernel path is {e} (relative L2) from "
                 "the plain path")
        worst = max(worst, (e, n))
    return worst


def sign_masks(model):
    """Record, in the next forward, where each activation's input is
    positive (its output > 0): each hidden layer's ReLU (GCN, SAGE) or
    ELU (GATv2), and each GATv2 layer's LeakyReLU of its scores. Returns
    (list of (site, mask), the hooks' handles)."""
    masks, handles = [], []
    layers = list(model.layers)

    def hook(site):
        return lambda m, a, out: masks.append((site, out.detach() > 0))

    for i, layer in enumerate(layers):
        leaky = getattr(layer, "leaky", None)
        if leaky is not None:
            handles.append(leaky.register_forward_hook(
                hook(f"layer {i} leaky_relu")))
        if i < len(layers) - 1:
            act = "relu" if leaky is None else "elu"
            handles.append(layer.register_forward_hook(
                hook(f"layer {i} {act}")))
    return masks, handles


def recompute_step0(ds, cfg, fp64=True):
    """Step 0 of the run again, with the kernels and with the plain
    versions on the card, from the same initial parameters: blocks bit
    for bit, and with ``fp64`` the plain versions in fp64 as the
    yardstick of both fp32 paths; without it (a model whose fp64 pass
    does not fit at this batch) the two fp32 paths against each other."""
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
    init = gnn_models.MODELS[cfg.model][0]
    opt = adam.AdamConfig(lr=cfg.lr)
    res = {}
    for backend in ("cuda", "eager"):
        eng = TrainEngine(sampler, opt, device=DEV, backend=backend)
        data = eng.make_data_from_dataset(ds)
        model = init(rng_lib.key(cfg.seed), ds.features.shape[1], cfg.hidden,
                     n_cls, len(cfg.fanouts), device=DEV)
        names = [n for n, _ in model.named_parameters()]
        blocks, feats = eng.sample_batch(data, seeds, key)
        labels = seed_labels(data.labels, seeds)
        masks, handles = sign_masks(model)
        loss, _ = gnn_loss_fn(model, blocks, feats, labels, backend)
        for h in handles:
            h.remove()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        if backend == "eager" and fp64:
            m64 = copy.deepcopy(model).double()
            loss64, _ = gnn_loss_fn(m64, blocks, feats.double(), labels,
                                    "eager")
            g64 = torch.autograd.grad(loss64, list(m64.parameters()))
            p64 = {n: p.detach() for n, p in m64.named_parameters()}
            p64, _, _ = adam.apply_updates(p64, dict(zip(names, g64)),
                                           adam.init_state(p64, opt), opt)
            del m64
        model, _, m = eng.step(model, eng.init_state(model), data, seeds, key)
        res[backend] = (blocks, loss.detach(), grads,
                        [p.detach() for p in model.parameters()], m, masks)
        del data, feats
    (bk, lk, gk, pk, m_k, mask_k), (be, le, ge, pe, m_e, mask_e) = (
        res["cuda"], res["eager"])
    torch.cuda.synchronize()
    what = f"{cfg.model} {cfg.sampler} step 0 (batch {cfg.batch_size})"
    compare_blocks(bk, be, what)
    if not torch.equal(m_k["overflow"], m_e["overflow"]):
        fail(f"{what}: overflow flags differ")
    out = {"batch": cfg.batch_size, "blocks_bit_exact": True,
           "loss": lk.item(), "loss_plain": le.item(),
           "sign_flips_kernel_vs_plain": {
               site: int((a != b).sum())
               for (site, a), (_, b) in zip(mask_k, mask_e)},
           "num_next": [int(b.num_next) for b in bk],
           "num_edges": [int(b.num_edges) for b in bk]}
    if not fp64:
        if abs(lk.item() - le.item()) > 1e-5 * abs(le.item()):
            fail(f"{what}: loss of the kernel path {lk.item()}, plain "
                 f"{le.item()}")
        out["grad_rel_l2_kernel_vs_plain"] = kernel_vs_plain(
            f"{what} gradient", gk, ge, names)
        out["param_rel_l2_kernel_vs_plain"] = kernel_vs_plain(
            f"{what} updated parameter", pk, pe, names)
        return out
    for path, x in (("kernel", lk), ("plain", le)):
        if abs(x.item() - loss64.item()) > 1e-5 * abs(loss64.item()):
            fail(f"{what}: loss of the {path} path {x.item()}, fp64 "
                 f"{loss64.item()}")
    out.update(loss_fp64=loss64.item(),
               grad_rel_l2_vs_fp64=against_fp64(
                   f"{what} gradient", gk, ge, g64, names),
               param_rel_l2_vs_fp64=against_fp64(
                   f"{what} updated parameter", pk, pe,
                   [p64[n] for n in names], names))
    return out


#: the kernels every sampling path runs, and those of each model
SAMPLING = ("compact", "hash_dedup", "compact_perm")
MODEL_KERNELS = {"gcn": ("spmm", "spmm_t"), "sage": ("spmm", "spmm_t"),
                 "gatv2": ("gather_dst", "scatter_rows", "edge_softmax")}
#: the kernels of each model's forward (a served request)
FORWARD_KERNELS = {"gcn": ("spmm",), "sage": ("spmm",),
                   "gatv2": MODEL_KERNELS["gatv2"]}
#: phase 4's training paths: name -> (sampler, model, kernels only that
#: sampler runs)
TRAIN_PATHS = {"labor-0": ("labor-0", "gcn", ()),
               "ns": ("ns", "gcn", ("segment_select",)),
               "labor-1": ("labor-1", "gcn", ()),
               "labor-*": ("labor-*", "gcn", ()),
               "labor-d": ("labor-d", "gcn", ()),
               "ladies": ("ladies", "gcn", ("masked_cdf_draw",)),
               "pladies": ("pladies", "gcn", ()),
               "sage": ("labor-0", "sage", ()),
               "gatv2": ("labor-0", "gatv2", ())}
#: GATv2's fp64 step-0 yardstick runs at this batch: at 1024 seeds its
#: first layer holds a few (9.4 M, 256) tensors, which fp64 doubles past
#: the card's memory
GATV2_FP64_BATCH = 256


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


def phase_train(ds, opts):
    """Phase 4: train each path of TRAIN_PATHS through the launcher's
    path."""
    from repro_torch.core import cs_solve
    from repro_torch.core import rng as rng_lib
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.launch import train
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import TrainEngine

    paths = {}
    for name, (sampler, model_name, own) in TRAIN_PATHS.items():
        args = train.parser().parse_args([
            "--device", DEV, "--dataset", "products",
            "--scale", str(opts.scale), "--sampler", sampler,
            "--model", model_name, "--fanouts", "10,10,10",
            "--batch-size", "1024", "--steps", str(opts.steps),
            "--seed", str(opts.seed)])
        cfg = train.config(args)
        # warm-up (first use of each cuBLAS shape, the allocator's pools):
        # two steps, outside the counts and the timing
        train.train_report(ds, dataclasses.replace(cfg, steps=2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        report, out = train.train_report(ds, cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k in SAMPLING + MODEL_KERNELS[model_name] + own:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the {name} training "
                     "path")
        losses = [h["loss"] for h in out["history"]]
        if len(losses) != opts.steps or not all(map(math.isfinite, losses)):
            fail(f"{name}: losses {losses}")
        emit({"phase": "train", "path": name, "sampler": sampler,
              "model": model_name, "report": report,
              "losses": losses, "launches": launches,
              "steps_per_s": opts.steps / out["wall_time"],
              "sampled_v_per_step": [h["sampled_v"] for h in out["history"]],
              "sampled_e_per_step": [h["sampled_e"] for h in out["history"]],
              "avg_sampled_vertices": report["avg_sampled_vertices"],
              "final_caps": [c.__dict__ for c in out["sampler"].caps],
              "peak_memory_gib": peak})
        fp64 = model_name != "gatv2"
        check = recompute_step0(ds, cfg, fp64=fp64)
        if not fp64:
            torch.cuda.empty_cache()
            check["fp64_yardstick"] = recompute_step0(
                ds, dataclasses.replace(cfg, batch_size=GATV2_FP64_BATCH))
        torch.cuda.empty_cache()
        emit({"phase": "train", "path": name,
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
        emit({"phase": "train", "path": name, "warm_step": split})
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
        emit({"phase": "train", "path": name, "window_steps": n_win,
              **window})
        paths[name] = launches
        del data, eng, model, state, out
        torch.cuda.empty_cache()
    return paths


#: the runtime phase's training runs (at least 12 steps)
RUNTIME_STEPS = 12
#: the runtime phase's serving faults, by batch ordinal (stall, cache) and
#: pump iteration (death)
SERVE_FAULTS = "stall_stage@2=0.05,cache_corrupt@3,pump_death@4"


def train_window(ds, cfg, mode, n=5):
    """A fresh LABOR-0 GCN run of ``cfg`` through ``TrainEngine.step``
    (``mode`` "off") or the pipelined driver ("prefetch", "full"): 3
    warm steps, then ``n`` steps under torch.profiler (busy ms, device
    operations and idle share a step) and ``n`` more timed by the host
    clock (ending in a synchronise) for steps/s. Uses only the API of
    the serial engine for "off", so ``--window-only`` can run it against
    an earlier tree of the port."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.core import samplers
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.models.gnn import gcn_init
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import TrainEngine

    sampler = samplers.from_dataset(
        "labor-0", ds, batch_size=cfg["batch_size"],
        fanouts=cfg["fanouts"], safety=2.0)
    eng = TrainEngine(sampler, adam.AdamConfig(lr=cfg["lr"]), device=DEV)
    data = eng.make_data_from_dataset(ds)
    model = gcn_init(rng_lib.key(cfg["seed"]), ds.features.shape[1],
                     cfg["hidden"], int(ds.labels.max()) + 1,
                     len(cfg["fanouts"]), device=DEV)
    state = eng.init_state(model)
    batches = SeedBatches(ds.train_idx, cfg["batch_size"], seed=cfg["seed"],
                          device=DEV)
    base = rng_lib.key(cfg["seed"] + 1)
    driver = None
    if mode != "off":
        from repro_torch.runtime.pipeline import PipelinedEngine
        driver = PipelinedEngine(eng, mode=mode)
    box = {"i": 0}

    def step(_i):
        nonlocal model, state
        i = box["i"]
        box["i"] += 1
        seeds, key = batches.at(i), rng_lib.fold_in(base, i)
        if driver is None:
            model, state, _ = eng.step(model, state, data, seeds, key)
        else:
            model, state, _ = driver.step(model, state, data, seeds, key)

    for i in range(3):
        step(i)
    window = profile_window(step, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(i)
    torch.cuda.synchronize()
    window["steps_per_s"] = n / (time.perf_counter() - t0)
    del window["top"]
    return window


def runtime_step_cost(ds, cfg, guard):
    """One warm LABOR-0 step through ``TrainEngine.step`` (and, guarded,
    the rail's record, as the trainer does): the synchronizing calls
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, each by the
    innermost lines of the port that made it, and the device operations
    and busy ms a step over 3 profiled steps."""
    import traceback
    import warnings

    from repro_torch.core import rng as rng_lib
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.models.gnn import gcn_init
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import TrainEngine
    from repro_torch.runtime.guard import GuardRail
    from repro_torch.runtime.trainer import build_sampler

    eng = TrainEngine(build_sampler(ds, cfg), adam.AdamConfig(lr=cfg.lr),
                      device=DEV, guard=guard)
    rail = GuardRail(guard) if guard is not None else None
    data = eng.make_data_from_dataset(ds)
    model = gcn_init(rng_lib.key(cfg.seed), ds.features.shape[1], cfg.hidden,
                     int(ds.labels.max()) + 1, len(cfg.fanouts), device=DEV)
    state = eng.init_state(model)
    batches = SeedBatches(ds.train_idx, cfg.batch_size, seed=cfg.seed,
                          device=DEV)
    base = rng_lib.key(cfg.seed + 1)
    box = {"i": 0}

    def step(_i):
        nonlocal model, state
        i = box["i"]
        box["i"] += 1
        seeds, key = batches.at(i), rng_lib.fold_in(base, i)
        model, state, m = eng.step(model, state, data, seeds, key)
        if rail is not None and rail.record(i, seeds, key,
                                            m["guard_flags"]) is not None:
            fail("runtime: a clean guarded step was flagged")

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    sites = []

    def seen(message, *_a, **_kw):
        # the mode warns from inside the synchronizing call: the Python
        # stack at this point names the line that made it
        if "called a synchronizing" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename]
            sites.append(" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                    for f in frames[::-1][:3]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    window = profile_window(step, 3)
    return {"sync_calls_per_step": len(sites), "sync_sites": sites,
            "device_ops_per_step": window["device_ops_per_call"],
            "device_busy_ms_per_step": window["device_busy_ms_per_call"]}


def phase_runtime(ds, opts):
    """Phase 4b, the runtime: checkpoints, the guardrail, fault injection
    and the pipelined driver on LABOR-0 GCN at the widths of phase 4,
    ``RUNTIME_STEPS`` steps a run through ``train_gnn``. Returns the
    launch counts of its counted paths (train guarded, train prefetch,
    train full, serve checkpoint)."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core import rng as rng_lib
    from repro_torch.launch import serve, train
    from repro_torch.runtime import checkpoint as ckpt_lib
    from repro_torch.runtime import inject as inject_lib
    from repro_torch.runtime.engine import TrainEngine
    from repro_torch.runtime.fault_tolerance import (Preemptor,
                                                     run_with_restarts)
    from repro_torch.runtime.guard import GuardConfig
    from repro_torch.runtime.trainer import train_gnn
    from repro_torch.serving import HiddenCache, ServingDriver, VertexCache

    t_phase = time.perf_counter()
    steps = max(opts.steps, RUNTIME_STEPS)
    cfg = train.config(train.parser().parse_args([
        "--device", DEV, "--dataset", "products", "--scale", str(opts.scale),
        "--sampler", "labor-0", "--fanouts", "10,10,10", "--batch-size",
        "1024", "--steps", str(steps), "--seed", str(opts.seed)]))
    paths = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")

    def run(path=None, preemptor=None, **kw):
        torch.cuda.synchronize()
        reset_launches()
        out = train_gnn(ds, dataclasses.replace(cfg, **kw),
                        preemptor=preemptor)
        torch.cuda.synchronize()
        if path is not None:
            launches = launch_counts()
            for k in SAMPLING + MODEL_KERNELS["gcn"]:
                if launches[k] <= 0:
                    fail(f"kernel {k} was not launched on the {path} path")
            paths[path] = launches
        losses = [h["loss"] for h in out["history"]]
        if not all(map(math.isfinite, losses)):
            fail(f"runtime {path or kw}: losses {losses}")
        return out

    def counts(out):
        return [(h["step"], h["sampled_v"], h["sampled_e"])
                for h in out["history"]]

    def diff(a, b):
        return max((x - y).abs().max().item() for x, y in zip(
            a["params"].parameters(), b["params"].parameters()))

    def held(what, out, ref, tol):
        if counts(out)[-len(ref["history"]):] != counts(ref)[
                -len(out["history"]):]:
            fail(f"runtime {what}: sampled vertices or edges differ from "
                 "the clean run's")
        d = diff(out, ref)
        if d > tol:
            fail(f"runtime {what}: parameters differ from the clean run's "
                 f"by {d} (allowed {tol})")
        return d

    try:
        # (a) two clean runs, then the guard on a clean run
        clean = run()
        again = run()
        det = held("second clean run", again, clean, float("inf"))
        guarded = run("train guarded", guard="quarantine")
        held("guarded clean run", guarded, clean, 0.0)
        cost = {name: runtime_step_cost(ds, cfg, g) for name, g in (
            ("unguarded", None), ("guarded", GuardConfig()))}
        if (cost["guarded"]["sync_calls_per_step"]
                > cost["unguarded"]["sync_calls_per_step"]):
            fail(f"runtime: the guard added synchronizing calls: {cost}")
        emit({"phase": "runtime", "check": "clean", "steps": steps,
              "determinism_max_abs_diff": det, "bit_exact_runs": det == 0.0,
              "guarded_bit_exact": True,
              "guard_stats": dataclasses.asdict(guarded["guard_stats"]),
              "losses": [h["loss"] for h in clean["history"]],
              "step_cost": cost})
        tol = det

        # (b) quarantine
        q = run(guard="quarantine", guard_warmup=2,
                inject="nan_grad@3,corrupt_feats@6=1e8")
        gs = q["guard_stats"]
        if ([s for s, _ in q["inject_log"]] != ["nan_grad", "corrupt_feats"]
                or gs.nonfinite_batches < 1 or gs.spike_batches < 1
                or gs.quarantines < 2 or gs.rollbacks != 0
                or len(q["history"]) != steps):
            fail(f"runtime quarantine: {q['inject_log']} {gs}")
        emit({"phase": "runtime", "check": "quarantine",
              "inject_log": q["inject_log"],
              "guard_stats": dataclasses.asdict(gs),
              "losses": [h["loss"] for h in q["history"]]})

        # (c) rollback past a torn checkpoint
        ckdir = os.path.join(tmp, "rollback")
        restored = []
        orig_restore = ckpt_lib.restore

        def spy(d, step, like):
            restored.append(step)
            return orig_restore(d, step, like)

        ckpt_lib.restore = spy
        try:
            rb = run(guard="rollback", guard_warmup=2, ckpt_dir=ckdir,
                     ckpt_every=4, inject="torn_ckpt@1,corrupt_feats@9=1e8")
        finally:
            ckpt_lib.restore = orig_restore
        if (rb["guard_stats"].rollbacks != 1 or restored != [4]
                or rb["inject_log"] != [("torn_ckpt", 1),
                                        ("corrupt_feats", 9)]
                or [h["step"] for h in rb["history"]]
                != list(range(1, steps + 1))):
            fail(f"runtime rollback: {rb['guard_stats']}, restored "
                 f"{restored}, {rb['inject_log']}")
        d_rb = held("rollback", rb, clean, tol)
        emit({"phase": "runtime", "check": "rollback",
              "inject_log": rb["inject_log"], "restored_steps": restored,
              "guard_stats": dataclasses.asdict(rb["guard_stats"]),
              "checkpoints": ckpt_lib.latest_steps(ckdir),
              "params_max_abs_diff_vs_clean": d_rb})

        # (d) preemption
        pdir = os.path.join(tmp, "preempt")
        preemptor = Preemptor(fire_step=7)
        pre = run_with_restarts(lambda: run(ckpt_dir=pdir, ckpt_every=4,
                                            preemptor=preemptor))
        if (pre["restarts"] != 1 or [h["step"] for h in pre["history"]]
                != list(range(5, steps + 1))):
            fail(f"runtime preemption: restarts {pre['restarts']}, steps "
                 f"{[h['step'] for h in pre['history']]}")
        d_pre = held("preemption", pre, clean, tol)
        emit({"phase": "runtime", "check": "preemption",
              "restarts": pre["restarts"],
              "resumed_at_step": pre["history"][0]["step"],
              "params_max_abs_diff_vs_clean": d_pre})

        # (e) serving the checkpoint of (c), then the serving faults
        sargs = serve.parser().parse_args(
            ["--workload", "gnn", "--driver", "async", "--device", DEV,
             "--dataset", "products", "--scale", str(opts.scale),
             "--sampler", "labor-0", "--fanouts", "10,10,10", "--hidden",
             "256", "--batch", "1024", "--seed", str(opts.seed),
             "--ckpt-dir", ckdir] + ASYNC_TRAFFIC)
        built = serve.build_gnn_serving(sargs, ds)
        _, s_engine, s_data, s_model, _ = built
        for (n, a), (_, b) in zip(s_model.named_parameters(),
                                  rb["params"].named_parameters()):
            if not torch.equal(a, b):
                fail(f"serve checkpoint: restored {n} differs from the "
                     "trained model's")
        torch.cuda.synchronize()
        reset_launches()
        _, requests, driver, tickets = serve.run_gnn_driver(sargs, built)
        torch.cuda.synchronize()
        launches = launch_counts()
        for k in SAMPLING + ("spmm",):
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the serve checkpoint "
                     "path")
        paths["serve checkpoint"] = launches
        if any(t.status != "ok" for t in tickets):
            fail("serve checkpoint: a ticket was not served")
        first = [t for t in tickets if t.rid <= 1024 // 64]
        seeds = torch.from_numpy(np.concatenate([t.seeds for t in first])
                                 ).to(DEV)
        key = rng_lib.fold_in(rng_lib.key(sargs.seed + 1), 1)
        logits, _ = TrainEngine(s_engine.sampler, device=DEV).infer(
            rb["params"], s_data, seeds, key)
        if not np.array_equal(np.concatenate([t.logits for t in first]),
                              logits.cpu().numpy()):
            fail("serve checkpoint: dispatch 1's logits differ from the "
                 "in-memory trained model's")
        plan = inject_lib.parse(SERVE_FAULTS)
        fdrv = ServingDriver(
            s_engine, s_model, s_data, batch_size=1024,
            feature_cache=VertexCache(262144, "fifo"),
            hidden_cache=HiddenCache(16384, max_age=0, policy="fifo"),
            seed=sargs.seed + 1, inject=plan, cache_fault_limit=1,
            watchdog_interval_s=0.02)
        ftickets = [fdrv.submit(r) for r in requests]
        hook = threading.excepthook
        deaths = []
        threading.excepthook = lambda a: deaths.append(a.exc_type.__name__)
        try:
            fdrv.start()
            resolved = all(t.wait(300) for t in ftickets)
            fdrv.stop()
        finally:
            threading.excepthook = hook
        st = fdrv.stats
        if (not resolved or any(t.status != "ok"
                                or not np.isfinite(t.logits).all()
                                for t in ftickets)
                or not plan.all_fired() or st.nonfinite_batches < 1
                or st.cache_fallbacks != 1 or st.pump_restarts < 1):
            fail(f"serve faults: resolved {resolved}, {plan.describe()}, "
                 f"nonfinite {st.nonfinite_batches}, fallbacks "
                 f"{st.cache_fallbacks}, restarts {st.pump_restarts}")
        emit({"phase": "runtime", "check": "serve checkpoint",
              "checkpoint_step": ckpt_lib.latest_step(ckdir),
              "dispatch1_bit_exact": True, "tickets": len(tickets),
              "launches": launches, "faults": plan.describe(),
              "fault_log": plan.log, "fault_tickets_ok": len(ftickets),
              "nonfinite_batches": st.nonfinite_batches,
              "cache_fallbacks": st.cache_fallbacks,
              "pump_restarts": st.pump_restarts, "thread_deaths": deaths,
              "batches": st.batches})
        del built, s_engine, s_data, s_model, driver, fdrv

        # (f) the pipeline modes against the serial run, then windows
        for mode in ("prefetch", "full"):
            out = run(f"train {mode}", pipeline=mode)
            emit({"phase": "runtime", "check": f"pipeline {mode}",
                  "sampled_bit_exact": True,
                  "params_max_abs_diff_vs_serial": held(
                      f"pipeline {mode}", out, clean, tol),
                  "pipeline_invalidations":
                      out["stats"].pipeline_invalidations})
        wcfg = dict(batch_size=cfg.batch_size, fanouts=cfg.fanouts,
                    lr=cfg.lr, seed=cfg.seed, hidden=cfg.hidden)
        for mode in ("off", "prefetch", "full"):
            emit({"phase": "runtime", "window": mode, "steps": 5,
                  **train_window(ds, wcfg, mode)})
            torch.cuda.empty_cache()
        emit({"phase": "runtime", "seconds": time.perf_counter() - t_phase})
        if opts.parent_src:
            t0 = time.perf_counter()
            window = parent_window(opts)
            emit({"phase": "runtime", "window": "off, parent tree",
                  "src": opts.parent_src, **window,
                  "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


def parent_window(opts):
    """The serial window of the tree at ``--parent-src`` (its own kernels,
    built there), in a child process of ``--window-only``."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--window-only",
           "--src", opts.parent_src, "--scale", str(opts.scale),
           "--seed", str(opts.seed)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode != 0 or not lines:
        fail(f"parent window: exit {res.returncode}: {res.stderr[-2000:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# the multi-device engine (phase "train mesh")
# ---------------------------------------------------------------------------

#: steps of each mesh run (each followed by a flush)
MESH_STEPS = 3
#: the kernels each mesh path must launch: the partition-local
#: build_block's, the route's dedup, and the GCN's SpMM both ways
MESH_KERNELS = ("compact", "hash_dedup", "compact_perm", "spmm", "spmm_t")


def mesh_workload(ds):
    """The labor-gcn configuration (``configs/labor_gcn.py``: features
    100, hidden 256, 47 classes, 3 layers, fanouts 10,10,10, LABOR-0,
    cap safety 1.6, global batch 32,768) on this graph's statistics."""
    from repro_torch.configs.labor_gcn import GNNWorkloadConfig
    g = ds.graph
    return GNNWorkloadConfig(num_vertices=g.num_vertices,
                             avg_degree=g.num_edges / g.num_vertices)


def mesh_batches(ds, cfg, seed):
    """The launcher's schedule at the global batch, on the host: seeds
    ``SeedBatches.at(t)`` (numpy), keys ``fold_in(key(seed + 1), t)``."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.data.gnn_loader import SeedBatches
    sb = SeedBatches(ds.train_idx, cfg.global_batch, seed=seed)
    return [(sb.at(t).numpy(), rng_lib.fold_in(rng_lib.key(seed + 1), t))
            for t in range(MESH_STEPS)]


def sync(device):
    """Waits for ``device``'s queue (a no-op for the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mesh_drive(mesh, ds, batches, seed, check_plain=False, profile=False):
    """``build_gnn_engine`` on ``mesh`` over ``batches`` through
    ``launch/perf.py``'s step loop (each step followed by a flush; an
    overflowed batch is replayed before the next one, so the order of
    updates is the single-device run's whatever either run's caps do).
    Counts are zeroed before the steps and read after, summed over the
    ranks. ``check_plain``: step 0's sampling half (routing included)
    recomputed on the plain path on the card, blocks and frontiers bit
    for bit. ``profile``: one more step under torch.profiler, after the
    counts are read. Returns each step's metrics (the frontier sets on
    the host), the final parameters, the counts and the engine's
    metadata."""
    from repro_torch.launch import perf
    from repro_torch.launch.gnn_step import build_gnn_engine
    from repro_torch.runtime.engine import TrainEngine

    t_set = time.perf_counter()
    cfg = mesh_workload(ds)
    engine, meta = build_gnn_engine(mesh, cfg)
    build_s = time.perf_counter() - t_set

    def before(engine, data, batches):
        if check_plain:
            seeds, key = batches[0]
            plain = TrainEngine(engine.sampler, mesh=mesh, backend="eager")
            bk = engine.sample_stage(data.graph, seeds, key)
            be = plain.sample_stage(data.graph, seeds, key)
            sync(mesh.device)
            compare_blocks(bk.blocks, be.blocks, "train mesh step 0")
            for a, b in zip(bk.frontiers, be.frontiers):
                same("train mesh step 0 frontier", a, b)
        sync(mesh.device)
        reset_launches()

    def after():
        counts = launch_counts()
        names = sorted(counts)
        summed = mesh.psum(torch.tensor([counts[n] for n in names],
                                        dtype=torch.int64,
                                        device=mesh.device))
        return dict(zip(names, summed.tolist()))

    run = perf._drive_gnn(engine, ds, cfg, batches, seed, mesh.device,
                          mesh=mesh, profile=profile, count=False,
                          before_steps=before, after_steps=after)
    return dict(steps=run["steps"], meta=meta,
                setup_seconds=build_s + run["setup_seconds"],
                profile=run["profile"],
                staged=sorted(mesh.staged), backend=mesh.backend,
                ranks=mesh.size, replays=run["replays"],
                retries=run["retries"],
                caps=[c.__dict__ for c in engine.sampler.caps],
                peer_caps=list(engine.sampler.spec.peer_caps),
                params=run["params"], launches=run["after"])


def _mesh_rank(mesh, path, batches, seed):
    """One rank of the two-rank run: the graph from ``path`` (saved by
    :func:`phase_mesh`, not generated again), then :func:`mesh_drive`."""
    from repro_torch.graph.csr import Graph
    from repro_torch.graph.generators import GraphDataset
    torch.backends.cuda.matmul.allow_tf32 = False
    z = {k: np.load(os.path.join(path, k + ".npy"))
         for k in ("indptr", "indices", "features", "labels")}
    ds = GraphDataset(
        spec=None, graph=Graph(indptr=torch.from_numpy(z["indptr"]),
                               indices=torch.from_numpy(z["indices"])),
        features=z["features"], labels=z["labels"], train_idx=None,
        val_idx=None, test_idx=None, max_in_degree=0)
    return mesh_drive(mesh, ds, batches, seed)


def mesh_hold(what, got, want, feat_dim):
    """Holds a mesh run to the single-device run on the card: every
    layer's frontier set bit for bit, ``sampled_v``/``sampled_e`` equal,
    loss within 1e-4, accuracy within 1e-6, the final parameters within
    2e-5 (repro's own tolerances); every path kernel launched. Returns
    the phase line's numbers."""
    for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        if g["overflow"] or w["overflow"]:
            fail(f"{what} step {t}: overflow after the replay "
                 f"(mesh {g['overflow']}, single {w['overflow']})")
        for l, (a, b) in enumerate(zip(g["frontiers"], w["frontiers"])):
            if not torch.equal(a, b):
                fail(f"{what} step {t} layer {l}: frontier sets differ "
                     f"({a.numel()} vs {b.numel()} vertices)")
        for k in ("sampled_v", "sampled_e"):
            if g[k] != w[k]:
                fail(f"{what} step {t}: {k} {g[k]} vs {w[k]}")
        if not abs(g["loss"] - w["loss"]) < 1e-4:
            fail(f"{what} step {t}: loss {g['loss']} vs {w['loss']}")
        if not abs(g["acc"] - w["acc"]) < 1e-6:
            fail(f"{what} step {t}: acc {g['acc']} vs {w['acc']}")
    err = max(float((a - b).abs().max())
              for a, b in zip(got["params"], want["params"]))
    if not err < 2e-5:
        fail(f"{what}: parameters differ by {err} (bound 2e-5)")
    for k in MESH_KERNELS:
        if got["launches"].get(k, 0) <= 0:
            fail(f"kernel {k} was not launched on the path {what}")
    P = got["ranks"]
    peer = got["peer_caps"][-1]
    warm = [s["seconds"] for s in got["steps"][1:]]
    rows = [s["feat_rows"] for s in got["steps"]]
    return {
        "ranks": P, "backend": got["backend"],
        "staged_through_host": got["staged"],
        "setup_seconds": got["setup_seconds"],
        "step_seconds": [s["seconds"] for s in got["steps"]],
        "warm_step_seconds": sum(warm) / len(warm),
        "losses": [s["loss"] for s in got["steps"]],
        "sampled_v": [s["sampled_v"] for s in got["steps"]],
        "single_device_sampled_v": [s["sampled_v"] for s in want["steps"]],
        "sampled_e": [s["sampled_e"] for s in got["steps"]],
        "frontier_sizes": [[int(f.numel()) for f in s["frontiers"]]
                           for s in got["steps"]],
        "feature_rows_per_step": rows,
        # live rows: a 4-byte request and a row of float32 features each
        "feature_live_bytes_per_step": [
            r * (4 + 4 * feat_dim) for r in rows],
        # what the fixed-capacity all-to-all pair moves over all ranks
        "feature_padded_bytes_per_step": P * P * peer * (4 + 4 * feat_dim),
        "params_max_abs_err": err, "replays": got["replays"],
        "retries": got["retries"], "caps": got["caps"],
        "peer_caps": got["peer_caps"], "launches": got["launches"]}


#: the keys of ``launch/perf.py``'s report that the phases print
PERF_KEYS = ("card", "flops_per_device", "bytes_per_device",
             "wire_bytes_per_device", "t_compute_s", "t_memory_s",
             "t_collective_s", "dominant", "step_time_lower_bound_s",
             "peak", "mfu", "roofline_fraction", "measured_s",
             "bound_share_of_measured", "model_flops_total")


def single_drive(ds, batches, seed):
    """The single-device engine on the card with the mesh's sampler
    geometry at the global batch (no per-peer caps), over the same
    batches, each step followed by a flush, through
    ``launch/perf.measure_gnn`` (its roofline terms and ``mfu`` beside
    the measured step); each step's frontier sets from a sampling pass
    with the same key."""
    from repro_torch.launch import perf
    out = perf.measure_gnn(dataset=ds, batches=batches, seed=seed,
                           global_batch=mesh_workload(ds).global_batch,
                           device=DEV, keep=True)
    return dict(steps=out["step_records"], params=out["params"],
                replays=out["replays"], perf={
                    **{k: out[k] for k in PERF_KEYS},
                    "model_flops_geometry": out["model_flops_geometry"],
                    "layer_sizes_step0": out["layer_sizes"][0],
                    "device_busy_ms": out["device_busy_ms"],
                    "device_idle_share": out["device_idle_share"],
                    "peak_memory_gib": out["peak_memory_gib"]})


def phase_mesh(ds, opts, card):
    """Phase ``train mesh``: the labor-gcn workload through
    ``launch/gnn_step.build_gnn_engine`` at world size 1 (an NCCL group
    of this process) and 2 (two spawned ranks on this one card in a
    gloo group over CUDA tensors; the kernels were built above, the
    graph is saved for them to load), each held to the single-device
    engine on the card (:func:`mesh_hold`). Returns the counted
    paths."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, spawn

    t_phase = time.perf_counter()
    cfg = mesh_workload(ds)
    batches = mesh_batches(ds, cfg, opts.seed)
    gc.collect()
    torch.cuda.empty_cache()
    single = single_drive(ds, batches, opts.seed)
    emit({"phase": "train mesh", "run": "single device",
          "step_seconds": [s["seconds"] for s in single["steps"]],
          "sampled_v": [s["sampled_v"] for s in single["steps"]],
          "losses": [s["loss"] for s in single["steps"]],
          "replays": single["replays"], "perf": single["perf"]})
    gc.collect()
    torch.cuda.empty_cache()

    mesh = make_mesh(1, DEV)
    try:
        ws1 = mesh_drive(mesh, ds, batches, opts.seed, check_plain=True,
                         profile=True)
    finally:
        dist.destroy_process_group()
    line1 = mesh_hold("train mesh", ws1, single, cfg.feature_dim)
    emit({"phase": "train mesh", "run": "world size 1", "card": card,
          "profile": ws1["profile"], **line1})
    del ws1
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        g = ds.graph
        for k, v in (("indptr", g.indptr.cpu().numpy()),
                     ("indices", g.indices.cpu().numpy()),
                     ("features", np.asarray(ds.features, np.float32)),
                     ("labels", np.asarray(ds.labels))):
            np.save(os.path.join(tmp, k + ".npy"), v)
        t0 = time.perf_counter()
        ws2 = spawn(_mesh_rank, 2, tmp, batches, opts.seed, device=DEV,
                    backend="gloo", timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
    line2 = mesh_hold("train mesh 2 ranks", ws2, single, cfg.feature_dim)
    emit({"phase": "train mesh", "run": "world size 2 on one card",
          "card": card, "spawn_seconds": spawn_s, **line2})
    emit({"phase": "train mesh",
          "seconds": time.perf_counter() - t_phase})
    return {"train mesh": line1["launches"],
            "train mesh 2 ranks": line2["launches"]}


def phase_serve_path(ds, opts, path, sampler, model_name, depth, requests):
    """Phase 3, a further serving path: ``requests`` requests with
    ``sampler`` and ``model_name`` at ``depth`` layers through the
    launcher's synchronous path, counts zeroed before and read after
    (every kernel of the model's forward must run); request 0 again with
    the plain versions on the card: blocks bit for bit, logits to
    rtol = atol = 1e-4; then torch.profiler over 5 warm requests (device
    busy ms, operations and idle share a request)."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.core.interface import pad_seeds
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import TrainEngine

    args = serve.parser().parse_args([
        "--workload", "gnn", "--driver", "off",
        "--device", DEV, "--dataset", "products",
        "--scale", str(opts.scale), "--sampler", sampler,
        "--model", model_name, "--fanouts", ",".join(["10"] * depth),
        "--hidden", "256", "--batch", "1024", "--requests", str(requests),
        "--seed", str(opts.seed)])
    built = serve.build_gnn_serving(args, ds)
    _, engine, data, model, _ = built
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    report = serve.serve_gnn_sync(args, built)
    torch.cuda.synchronize()
    launches = launch_counts()
    for name in SAMPLING + FORWARD_KERNELS[model_name]:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    if (report["requests_served"] != requests
            or report["exact"] != (sampler == "full")):
        fail(f"{path}: {report}")
    seeds = pad_seeds(serve.gnn_trace(args, ds)[0], args.batch, device=DEV)
    key = rng_lib.split(rng_lib.key(args.seed + 1))[1]
    engines = [TrainEngine(engine.sampler, device=DEV, backend=b)
               for b in ("cuda", "eager")]
    out = [e.infer_blocks(model, data, seeds, key) for e in engines]
    torch.cuda.synchronize()
    (logits_k, flags_k, blocks_k), (logits_e, flags_e, blocks_e) = out
    compare_blocks(blocks_k, blocks_e, f"{path} request 0")
    same(f"{path} request 0 overflow flags", flags_k, flags_e)
    if bool(flags_k.any()) or not bool(torch.isfinite(logits_k).all()):
        fail(f"{path} request 0: overflow at the final caps or non-finite "
             "logits")
    err = (logits_k - logits_e).abs().max().item()
    if not torch.allclose(logits_k, logits_e, rtol=1e-4, atol=1e-4):
        fail(f"{path} request 0 logits differ from the plain versions by "
             f"{err}")
    emit({"phase": path, "depth": depth, "model": model_name,
          "report": report, "launches": launches,
          "caps": [c.__dict__ for c in engine.sampler.caps],
          "logits_max_abs_err": err,
          "num_next": [int(b.num_next) for b in blocks_k],
          "num_edges": [int(b.num_edges) for b in blocks_k],
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    del out, logits_k, logits_e, blocks_k, blocks_e
    n_req = 5
    window = profile_window(
        lambda i: engines[0].infer(model, data, seeds, key), n_req)
    emit({"phase": path, "window_requests": n_req, **window})
    return launches


#: phase 3's weighted paths: sampler -> kernels only that sampler runs
WEIGHTED_SAMPLERS = {"labor-0": (), "ns": ("segment_select",),
                     "labor-1": (), "ladies": ("masked_cdf_draw",),
                     "pladies": ()}


def phase_weighted(ds, data, opts, seeds, key):
    """Phase 3, weighted graphs (LABOR §A.7): phase 3's CSR with one
    weight per edge from numpy at ``--seed``, uniform in [0.1, 2); each
    sampler of WEIGHTED_SAMPLERS samples 3 layers of the first request
    on the kernel path (counts zeroed before, read after: its own path)
    and on the plain path on the card: every integer block field bit for
    bit, the weights to rtol = atol = 1e-5. Prints the per-layer
    vertices and edges beside the unweighted ones and the loop
    conditions read on the host (none for LABOR-0)."""
    from repro_torch.core import cs_solve, samplers
    from repro_torch.core.interface import INT_FIELDS
    from repro_torch.graph.csr import Graph

    t0 = time.perf_counter()
    w = np.random.default_rng(opts.seed).uniform(
        0.1, 2.0, data.graph.num_edges).astype(np.float32)
    graph = Graph(data.graph.indptr, data.graph.indices,
                  torch.from_numpy(w).to(DEV))
    emit({"phase": "weighted", "weights": int(w.shape[0]),
          "weights_mib": w.nbytes / 2**20,
          "setup_seconds": time.perf_counter() - t0})
    paths = {}
    for name, own in WEIGHTED_SAMPLERS.items():
        sampler = samplers.from_dataset(name, ds, batch_size=1024,
                                        fanouts=(10, 10, 10), safety=2.0)
        salts = sampler.spec.salts(key)
        with torch.no_grad():
            sampler.sample(graph, seeds, salts)      # warm-up
            torch.cuda.synchronize()
            reset_launches()
            cs_solve.reset_host_reads()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            blocks_k = sampler.sample(graph, seeds, salts, backend="cuda")
            ev[1].record()
            torch.cuda.synchronize()
        launches = launch_counts()
        host_reads = dict(cs_solve.HOST_READS)
        if any(bool(b.overflow) for b in blocks_k):
            fail(f"weighted {name}: a cap overflowed")
        for k in SAMPLING + own:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the weighted {name} "
                     "path")
        if name == "labor-0" and sum(host_reads.values()):
            fail(f"weighted labor-0 read {host_reads} on the host")
        with torch.no_grad():
            blocks_e = sampler.sample(graph, seeds, salts, backend="eager")
            plain = sampler.sample(data.graph, seeds, salts, backend="cuda")
        torch.cuda.synchronize()
        for layer, (a, b) in enumerate(zip(blocks_k, blocks_e)):
            for f in INT_FIELDS:
                same(f"weighted {name} layer {layer} {f}", getattr(a, f),
                     getattr(b, f))
        err = max(allclose_or_fail(f"weighted {name} layer {i} weight",
                                   a.weight, b.weight)
                  for i, (a, b) in enumerate(zip(blocks_k, blocks_e)))
        emit({"phase": "weighted", "sampler": name, "launches": launches,
              "loop_host_reads": host_reads, "sample_ms":
              ev[0].elapsed_time(ev[1]), "weight_max_abs_err": err,
              "caps": [c.__dict__ for c in sampler.caps],
              "num_next": [int(b.num_next) for b in blocks_k],
              "num_edges": [int(b.num_edges) for b in blocks_k],
              "unweighted_num_next": [int(b.num_next) for b in plain],
              "unweighted_num_edges": [int(b.num_edges) for b in plain]})
        paths[f"weighted {name}"] = launches
        del blocks_k, blocks_e, plain
    del graph
    torch.cuda.empty_cache()
    return paths


#: phase 3's async traffic: 256 Zipfian requests of 64 seeds, coalesced
#: into 16 dispatches of 1024; the caches' flags of the cache-on run
ASYNC_TRAFFIC = ["--requests", "256", "--request-size", "64", "--trace",
                 "zipf", "--zipf-a", "1.1"]
ASYNC_CACHES = ["--feature-cache", "262144", "--hidden-cache", "16384",
                "--max-age", "0", "--cache-policy", "fifo"]


def phase_serve_async(built, opts):
    """Phase 3, the async driver: LABOR-0 GCN through
    ``serve_gnn_driver``'s path on ASYNC_TRAFFIC, once with the caches of
    ASYNC_CACHES (counts zeroed before, read after: the ``serve async``
    path) and once with both caches off. Every ticket's logits equal,
    cache-on against cache-off, bit for bit; the first dispatch
    recomputed on the kernel and the plain path on the card (blocks bit
    for bit, logits to rtol = atol = 1e-4, the tickets' logits equal to
    the kernel path's); then 5 warm dispatches under torch.profiler and
    one cache lookup at layer 2's shape timed with CUDA events beside
    its bytes bound."""
    from repro_torch.launch import roofline as rl
    from repro_torch.core import rng as rng_lib
    from repro_torch.kernels.frontier import ops as fk
    from repro_torch.kernels.frontier import ref as fr
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import TrainEngine
    from repro_torch.serving.metrics import ServingStats

    ds, engine, data, model, labels = built
    base = ["--workload", "gnn", "--driver", "async", "--device", DEV,
            "--dataset", "products", "--scale", str(opts.scale),
            "--sampler", "labor-0", "--fanouts", "10,10,10", "--hidden",
            "256", "--batch", "1024", "--seed", str(opts.seed)]
    runs = {}
    for name, flags in (("on", ASYNC_CACHES), ("off", [])):
        args = serve.parser().parse_args(base + ASYNC_TRAFFIC + flags)
        eng = TrainEngine(engine.sampler, device=DEV)
        run_built = (ds, eng, data, model, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        unique_misses = []
        record = ServingStats.record_cache

        def spy(self, m):
            unique_misses.append(int(m.get("unique_misses", 0)))
            record(self, m)

        ServingStats.record_cache = spy
        reset_launches()
        try:
            _, requests, driver, tickets = serve.run_gnn_driver(args,
                                                                run_built)
        finally:
            ServingStats.record_cache = record
        torch.cuda.synchronize()
        launches = launch_counts()
        report = serve.driver_report(args, run_built, requests, driver,
                                     tickets)
        runs[name] = (args, eng, driver, tickets, launches)
        emit({"phase": "serve async", "caches": name, "report": report,
              "launches": launches, "unique_misses": unique_misses,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
        if report["requests_served"] != 256 or any(
                t.status != "ok" for t in tickets):
            fail(f"serve async (caches {name}): {report}")
    args, eng, driver, tickets, launches = runs["on"]
    n_batch = driver.stats.batches
    for k in SAMPLING + ("spmm",):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serve async path")
    # the sampler's 3 a dispatch (grow retries included), and one lookup a
    # dispatch per cache
    attempts = n_batch + driver.stats.grow_events
    if launches["hash_dedup"] != 5 * attempts:
        fail(f"serve async: {launches['hash_dedup']} hash_dedup launches "
             f"in {attempts} dispatches, expected 5 a dispatch")
    for i, (a, b) in enumerate(zip(tickets, runs["off"][3])):
        if not np.array_equal(a.logits, b.logits):
            fail(f"serve async ticket {i}: cache-on and cache-off logits "
                 "differ")

    # the first dispatch again, on the kernel and the plain path
    first = [t for t in tickets if t.rid <= 1024 // 64]
    seeds = torch.from_numpy(np.concatenate([t.seeds for t in first])).to(
        DEV)
    key = rng_lib.fold_in(rng_lib.key(args.seed + 1), 1)
    engines = [TrainEngine(eng.sampler, device=DEV, backend=b)
               for b in ("cuda", "eager")]
    out = [e.infer_blocks(model, data, seeds, key) for e in engines]
    torch.cuda.synchronize()
    (logits_k, flags_k, blocks_k), (logits_e, flags_e, blocks_e) = out
    compare_blocks(blocks_k, blocks_e, "serve async dispatch 1")
    same("serve async dispatch 1 overflow flags", flags_k, flags_e)
    if bool(flags_k.any()) or not bool(torch.isfinite(logits_k).all()):
        fail("serve async dispatch 1: overflow or non-finite logits")
    err = (logits_k - logits_e).abs().max().item()
    if not torch.allclose(logits_k, logits_e, rtol=1e-4, atol=1e-4):
        fail(f"serve async dispatch 1 logits differ from the plain "
             f"versions by {err}")
    served = np.concatenate([t.logits for t in first])
    if not np.array_equal(served, logits_k.cpu().numpy()):
        fail("serve async dispatch 1: the tickets' logits differ from the "
             "kernel path's")
    st = driver.stats
    emit({"phase": "serve async", "recompute": "dispatch 1, plain path on "
          "the card", "blocks_bit_exact": True,
          "logits_max_abs_err": err, "tickets_equal_kernel_path": True,
          "cache_on_equals_off_tickets": len(tickets),
          "dispatches": n_batch, "latency_ms_p50": st.percentile_ms(50),
          "latency_ms_p99": st.percentile_ms(99),
          "nodes_per_sec": st.nodes_per_sec, "hit_rate": st.hit_rate,
          "feat_hits": st.feat_hits, "feat_misses": st.feat_misses,
          "num_next": [int(b.num_next) for b in blocks_k],
          "next_cap": [b.next_cap for b in blocks_k]})

    # 5 warm dispatches of the cache-aware request, under the profiler
    fn = eng.cached_infer_fn(driver.feature_cache, driver.hidden_cache)
    fc, hc = driver.cache_states
    metrics = []

    def dispatch(i):
        out = fn(model, data.graph, data.features, fc, hc, seeds, key)
        metrics.append(out[4])

    dispatch(0)
    metrics.clear()
    window = profile_window(dispatch, 5)
    emit({"phase": "serve async", "window_dispatches": 5,
          "unique_misses_per_dispatch": [int(m["unique_misses"])
                                         for m in metrics], **window})

    # one cache lookup at layer 2's shape: the deepest block's next_seeds
    # against the feature cache's key column
    ids = blocks_k[-1].next_seeds
    largs = (ids, ids >= 0, fc.keys, ids.shape[0])
    same("serve async cache lookup", tuple(fk.hash_dedup(*largs)),
         tuple(fr.hash_dedup(*largs)))
    T, C = ids.shape[0], fc.keys.shape[0]

    def unique_lookup():
        u = torch.unique(torch.cat([fc.keys, ids]))
        return torch.searchsorted(u, ids)

    emit({"phase": "serve async", "cache_lookup": {
        "T": T, "C": C, "live": int((ids >= 0).sum()),
        "ms": cuda_ms(lambda: fk.hash_dedup(*largs), opts.reps),
        "plain_ms": cuda_ms(lambda: fr.hash_dedup(*largs), opts.reps),
        "library_ms": cuda_ms(unique_lookup, opts.reps),
        # read ids and their mask, the keys; write new and slots
        "bound_ms": rl.hash_dedup(T, C, T, T).bound_ms(),
        "bound_by": "bytes"}})
    del runs, out, blocks_k, blocks_e, logits_k, logits_e
    torch.cuda.empty_cache()
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


def profile_window(run, n, share_of=None):
    """``launch/perf.py``'s torch.profiler window over ``run(0) ..
    run(n - 1)``: elapsed ms, the device's busy ms and operations a
    call, its idle share and top kernels (busy and idle None when the
    profile holds no device event)."""
    from repro_torch.launch import perf
    return perf.profile_window(run, n, share_of)


#: the LM serving paths: name -> (arch, decode batch, prompt, generated
#: tokens, depth or None for the arch's own). Phase 6, the dense archs:
#: gemma2-2b at the repo's prefill_32k prompt (its batch of 32 cut to 1
#: for one card) exercises every branch of B9: GQA 8/4, hd 256, the 4096
#: window and the softcap; stablelm-1.6b covers MHA at hd 64, no window,
#: no softcap, and is the one where a PyTorch call
#: (scaled_dot_product_attention) computes the kernel's function
LM_PATHS = {"serve lm gemma2-2b": ("gemma2-2b", 1, 32768, 32, None),
            "serve lm stablelm-1.6b": ("stablelm-1.6b", 4, 4096, 16, None)}
#: phase 8, the other blocks: Mamba2 alone (its conv and SSM states, no
#: attention), zamba2's Mamba2 backbone with one shared attention + MLP
#: (B9 as MHA of 32 heads of 80, an 8,192-token prompt), and qwen3-moe's
#: MoE (128 experts of 1,536, top-8) behind GQA 64/4 at hd 128 (a ratio
#: of 16), at its full width and one of its 94 layers; mamba2-370m cut to
#: 24 of its 48 layers and zamba2-2.7b to 18 of its 54 (3 uses of the
#: shared block) to fit the time limit with phase 9
LM_BLOCK_PATHS = {
    "serve lm mamba2-370m": ("mamba2-370m", 4, 4096, 16, 24),
    "serve lm zamba2-2.7b": ("zamba2-2.7b", 1, 8192, 16, 18),
    "serve lm qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", 1, 4096, 16, 1)}
#: phase 7, LM training: name -> (arch, batch, sequence, Adam steps,
#: layers), at full width, remat on (each attention layer's B9 runs in
#: the forward and again in the recompute). The depth is cut to fit the
#: time limit with the mesh phase: gemma2-2b to 4 of its 26 layers (two
#: local / global pairs, every branch of B9 still on the path), mamba2-370m
#: to 8 of its 48
LM_TRAIN_PATHS = {"train lm gemma2-2b": ("gemma2-2b", 1, 2048, 4, 4),
                  "train lm mamba2-370m": ("mamba2-370m", 4, 2048, 4, 8)}
#: phase 9, the encoder-decoder (cross-attention and an encoder; no
#: registered arch has either, so the config is ``encdec_cfg()``'s,
#: whisper-large-v3's widths): serving at full depth, batch 4, 1,500
#: frames, a 416-token prompt and 32 generated tokens (416 + 32 =
#: whisper's 448 target positions), as ``LM_PATHS``; then training from
#: the same weights, 4 x 448 tokens and 1,500 frames, 4 steps, as
#: ``LM_TRAIN_PATHS`` (layers: the decoder's, 8 of 64 to fit the time
#: limit: at full depth the path takes about 70 s; the encoder is cut to
#: the same fraction, 4 of 32)
ENCDEC_ARCH = "whisper-large-v3"
LM_ENCDEC_PATHS = {"serve lm whisper-large-v3": (ENCDEC_ARCH, 4, 416, 32,
                                                 None)}
LM_ENCDEC_TRAIN_PATHS = {"train lm whisper-large-v3": (ENCDEC_ARCH, 4, 448,
                                                       4, 8)}
#: the prompt of the fp64 yardstick (fp64 at 32k would run minutes)
FP64_PROMPT = 2048
#: the tokens of a training step's fp64 yardstick (batch 1): gemma2-2b's
#: fp64 parameters and gradients take 42 GB of the card
TRAIN_FP64_SEQ = 256
#: timed launches of B9 at the real inputs (a gemma2 global layer's
#: plain version takes ~0.3 s)
LM_REPS = 3
#: kernel vs plain path of the LM serving phases, per tensor (relative L2)
LM_TOL = 1e-4


def attention_chunked(q, k, v, chunk=1024, **kw):
    """The plain version one query chunk at a time: its (Sq, Sk) scores
    of a 32k prompt would not fit the card."""
    from repro_torch.kernels.flash_attention import ref as fr
    return torch.cat([fr.attention_ref(q[:, lo:lo + chunk], k, v,
                                       q_offset=lo, **kw)
                      for lo in range(0, q.shape[1], chunk)], 1)


def flash_check(name, q, k, v, kw, record=None, library=None):
    """B9 against its plain version on one input: fp32 within 2e-5 x
    max(1, max|v|) (the reference suite's bound on unit-scale inputs,
    scaled to the values averaged), bf16 within 3e-2. With ``record``,
    times the kernel, the plain version (chunked) and ``library`` (a
    PyTorch call computing the same function, or None) and adds them."""
    from repro_torch.launch import roofline as rl
    from repro_torch.kernels.flash_attention import ops as fa
    B, Sq, Hq, hd = q.shape
    Sk = k.shape[1]
    args = (kw["causal"], kw["window"], kw["softcap"], kw["scale"])
    got = fa.flash_attention_fwd(q, k, v, *args)
    want = attention_chunked(q, k, v, **kw)
    torch.cuda.synchronize()
    bf16 = q.dtype == torch.bfloat16
    tol = 3e-2 if bf16 else 2e-5 * max(1.0, v.abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        fail(f"flash_attention {name}: kernel and plain version differ by "
             f"{err} (tolerance {tol})")
    out = {"phase": "kernels", "kernel": "flash_attention", "case": name,
           "B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hkv": k.shape[2],
           "hd": hd, "dtype": str(q.dtype), **{n: kw[n] for n in kw},
           "max_abs_err": err, "tolerance": tol}
    if record is not None:
        lib_ms = None
        if library is not None:
            lib = library()
            torch.cuda.synchronize()
            out["library_max_abs_err"] = (lib.float()
                                          - want.float()).abs().max().item()
            lib_ms = cuda_ms(library, LM_REPS)
        del got, want
        pairs = rl.visible_pairs(Sq, Sk, kw["causal"], kw["window"])
        t = record.add(
            cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, *args), LM_REPS),
            cuda_ms(lambda: attention_chunked(q, k, v, **kw), LM_REPS),
            lib_ms, rl.flash_attention(B, Sq, Sk, Hq, k.shape[2], hd,
                                       q.element_size(), kw["causal"],
                                       kw["window"]), err=err)
        out.update(visible_pairs=pairs, **t)
    emit(out)
    return err


def adversarial_flash():
    """B9's edge cases against its plain version: Sq 1, 130 and 1000,
    window 1 and window >= S, no softcap, GQA ratios 1, 2, 8 and 16 (at
    hd 128), MHA of 32 heads of 80, every head dimension, bf16, a custom
    scale, non-causal with a ragged Sk, queries that see no key, q read
    through its strides, q misaligned (both read by the kernel's prologue
    into its aligned scratch)."""
    g = torch.Generator(device=DEV).manual_seed(7)
    # (B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, scale, dtype)
    cases = [
        (2, 1, 1, 4, 4, 64, True, None, None, None, torch.float32),
        (1, 130, 130, 8, 1, 128, True, None, 50.0, None, torch.float32),
        (1, 1000, 1000, 4, 2, 256, True, 1, None, None, torch.float32),
        (2, 1000, 1000, 2, 2, 80, True, 1000, None, None, torch.float32),
        (1, 130, 130, 8, 4, 16, True, 7, 30.0, 0.3, torch.float32),
        (1, 1000, 1000, 4, 2, 32, True, None, None, None, torch.bfloat16),
        (1, 1000, 1000, 8, 4, 256, True, 64, 50.0, 256 ** -0.5,
         torch.bfloat16),
        (1, 130, 333, 4, 4, 64, False, None, None, None, torch.float32),
        (1, 1, 1000, 2, 1, 64, True, None, None, None, torch.float32),
        (2, 200, 50, 2, 1, 64, False, 20, None, None, torch.float32),
        # zamba2's shared attention: MHA, 32 heads of 80
        (1, 1000, 1000, 32, 32, 80, True, None, None, None, torch.float32),
        # qwen3-moe: GQA 64/4, a ratio of 16, at hd 128
        (1, 1000, 1000, 64, 4, 128, True, None, None, None, torch.float32),
    ]
    worst = 0.0
    for n, (B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, scale,
            dtype) in enumerate(cases):
        for layout in ("contiguous", "strided q", "misaligned q"):
            q = torch.randn(B, Sq, 2, Hq, hd, generator=g, device=DEV)
            if layout == "strided q":     # a slice of a fused tensor
                q = q[:, :, 1].to(dtype)
            elif layout == "misaligned q":    # read by the prologue
                flat = torch.empty(B * Sq * Hq * hd + 1, dtype=dtype,
                                   device=DEV)
                q = flat[1:].view(B, Sq, Hq, hd).copy_(q[:, :, 0])
            else:
                q = q[:, :, 0].contiguous().to(dtype)
            k = torch.randn(B, Sk, Hkv, hd, generator=g, device=DEV).to(dtype)
            v = (torch.randn(B, Sk, Hkv, hd, generator=g, device=DEV)
                 * 3).to(dtype)
            kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
            worst = max(worst, flash_check(f"adversarial {n} {layout}", q, k,
                                           v, kw))
    emit({"phase": "kernels", "adversarial_flash_cases": 3 * len(cases),
          "max_abs_err": worst, "ok": True})


def rel_l2_or_fail(what, got, want, tol=LM_TOL):
    e = rel_l2(got, want)
    if not e <= tol:
        fail(f"{what}: {e} relative L2 apart (tolerance {tol})")
    return e


def encdec_cfg():
    """The encoder-decoder of phase 9 at whisper-large-v3's published
    widths (openai/whisper-large-v3 ``config.json``: d_model 1280, 32
    encoder and 32 decoder layers, 20 heads of 64, ffn 5120, vocab
    51866, 1,500 source positions, 448 target positions), in the
    reference's family: an ``is_encoder`` stack of 32 ``("attn",)``
    layers, and a decoder of ``("attn", "xattn")`` x 32 with mixers
    ``("none", "mlp")`` attending the encoder's 1,500 frames; MHA,
    ``qkv_bias``, layernorm, gelu, a non-gated MLP, tied embeddings,
    fp32. The stub frontend's frame embeddings are the encoder's input
    (the mel and convolution frontend is not modelled, as in the
    reference), so nothing is downloaded."""
    from repro_torch.models.transformer.config import TransformerConfig
    common = dict(d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
                  d_ff=5120, vocab=51866, qkv_bias=True, norm="layernorm",
                  activation="gelu", gated_mlp=False, tie_embeddings=True,
                  dtype="float32", remat=True)
    encoder = TransformerConfig(name="whisper-large-v3-encoder",
                                num_layers=32, layer_pattern=("attn",),
                                is_encoder=True, **common)
    return TransformerConfig(name=ENCDEC_ARCH, num_layers=64,
                             layer_pattern=("attn", "xattn"),
                             mixers=("none", "mlp"), encoder=encoder,
                             xattn_source_len=1500, xattn_source_dim=1280,
                             **common)


def self_attention_kinds(cfg):
    """The pattern entries that are causal self-attention (zamba2's
    shared block included), the ones B9 runs: not Mamba2, not
    cross-attention, and none of an encoder's."""
    if cfg.is_encoder:
        return []
    return [k for k in cfg.layer_pattern if k not in ("mamba", "xattn")]


def n_attention(cfg):
    """The causal self-attention layers of a config (zamba2's shared
    block once per use): B9's launches in one forward on the ``cuda``
    backend. Cross-attention and the encoder take the plain path."""
    return len(self_attention_kinds(cfg)) * cfg.repeats


def phase_lm(path, opts, records):
    """A further path: LM serving through ``repro_torch.launch.serve``'s
    ``serve_lm`` at full width (random weights from ``--seed``): counts
    zeroed before, read after (one B9 launch per causal self-attention
    layer); B9 held against its plain version on the real q, k and v of
    the first attention layers; the prefill recomputed on the plain
    path on the card (last logits and every cache tensor: K/V, the cross
    K/V, and Mamba2's conv and SSM states as the prefill left them), the
    decode teacher-forced from both caches with the kernel path's
    tokens; both fp32 paths against fp64 at a ``FP64_PROMPT`` prompt; 3
    decode steps and one prefill under the profiler. A config with
    cross-attention gets the launcher's source (``serve.source_frames``)
    in every prefill. Returns the counts and (config, parameters)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models.transformer import stack

    t_path = time.perf_counter()
    arch, batch, prompt, gen, depth = {**LM_PATHS, **LM_BLOCK_PATHS,
                                       **LM_ENCDEC_PATHS}[path]
    args = serve.parser().parse_args([
        "--workload", "lm", "--device", DEV, "--arch", arch, "--batch",
        str(batch), "--prompt-len", str(prompt), "--gen", str(gen),
        "--seed", str(opts.seed)])
    t0 = time.perf_counter()
    cfg, params, prompts = built = serve.build_lm(args, num_layers=depth,
                                                  cfg=unregistered(arch))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    n_attn = n_attention(cfg)
    # the launcher's source (None without cross-attention)
    xs = serve.source_frames(cfg, batch, opts.seed, DEV)
    # warm-up outside the counts: cuBLAS's shapes, the allocator's pools
    stack.prefill(params, prompts[:, :256], cfg, xsource=xs)
    torch.cuda.synchronize()

    # the main path, counted; the first attention layers' q, k, v kept
    # for the kernel check, and the Mamba2 states as the prefill left
    # them (the decode advances them in place)
    captured, states = [], []
    orig, orig_widen = fa.flash_attention, stack.widen_cache
    n_check = len(self_attention_kinds(cfg))

    def spy(q, k, v, *a):
        if len(captured) < n_check:
            captured.append((q, k, v, a))
        return orig(q, k, v, *a)

    def widen_spy(cache, extra):
        states.extend({n: t.clone() for n, t in c.items()
                       if n in ("conv", "ssm")} for c in cache)
        return orig_widen(cache, extra)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fa.flash_attention, stack.widen_cache = spy, widen_spy
    try:
        res = serve.serve_lm(args, built)
    finally:
        fa.flash_attention, stack.widen_cache = orig, orig_widen
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches["flash_attention"] != n_attn:
        fail(f"{path}: B9 launched {launches['flash_attention']} times for "
             f"{n_attn} causal self-attention layers")
    toks = res["tokens"]
    if (toks.shape != (batch, gen) or not bool(torch.isfinite(
            res["last_logits"]).all())
            or not bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        fail(f"{path}: tokens {tuple(toks.shape)} or non-finite logits")
    stages = {"init": init_s, "serve": time.perf_counter() - t0 - init_s}
    line = {"phase": path, "arch": arch, "params": n_params,
            "init_seconds": init_s, "batch": batch, "prompt": prompt,
            "gen": gen, "prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms_per_token": res["decode_s"] * 1e3 / max(gen - 1, 1),
            "decode_tokens_per_s": batch * (gen - 1) / res["decode_s"],
            "prefill_tokens_per_s": batch * prompt / res["prefill_s"],
            "launches": launches, "peak_memory_gib": peak,
            "sample": toks[0, :12].tolist()}
    if cfg.encoder is not None:
        line.update(frames=cfg.xattn_source_len,
                    encoder_layers=cfg.encoder.num_layers,
                    decoder_layers=cfg.num_layers)
    if depth is not None:
        line["reduced"] = [f"num_layers {get_config(arch).num_layers}"
                           f" -> {depth}"]
    lap = time.perf_counter()
    line["account"] = account_or_fail(path, cfg, "prefill", batch,
                                      prompt + gen, peak)
    stages["account"] = time.perf_counter() - lap
    emit(line)

    # B9 on the real inputs of the first attention layers (and SDPA where
    # it computes the same function: no window, no softcap; GQA through
    # its enable_gqa)
    for i, (q, k, v, (causal, window, softcap, scale)) in enumerate(
            captured):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        library = None
        if window is None and softcap is None and \
                q.shape[2] % k.shape[2] == 0:
            def library(q=q, k=k, v=v, scale=scale, causal=causal):
                return torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, scale=scale,
                    enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)
        flash_check(f"{arch} attention {i}", q, k, v, kw,
                    records["flash_attention"], library)
    del captured
    torch.cuda.empty_cache()
    lap = time.perf_counter()
    stages["B9 check"] = lap - t0 - sum(stages.values())

    # the prefill on the plain path from the same weights; the kernel
    # path's cache with its states as the prefill left them
    plain_logits, plain_cache = stack.prefill(params, prompts, cfg,
                                              xsource=xs, backend="eager")
    torch.cuda.synchronize()
    cache = [{**c, **st} for c, st in zip(res["cache"], states)]
    checks = {"last_logits_rel_l2": rel_l2_or_fail(
        f"{path} last logits, kernel vs plain path", res["last_logits"],
        plain_logits)}
    worst = {}
    for i, (kc, pc) in enumerate(zip(cache, plain_cache)):
        for n in pc:
            for r in range(cfg.repeats):
                got = kc[n][r, :, :prompt] if n in ("k", "v") else kc[n][r]
                worst[n] = max(worst.get(n, 0.0), rel_l2_or_fail(
                    f"{path} layer {r * len(cfg.layer_pattern) + i} {n}",
                    got, pc[n][r]))
    checks["cache_max_rel_l2"] = worst
    # decode teacher-forced with the kernel path's tokens from both caches
    plain_cache = stack.widen_cache(plain_cache, gen)
    worst, flips = 0.0, 0
    for j in range(gen - 1):
        tok = toks[:, j:j + 1]
        lk, _ = stack.decode_step(params, tok, cache, prompt + j, cfg)
        lp, _ = stack.decode_step(params, tok, plain_cache, prompt + j, cfg)
        if not torch.equal(lk.argmax(-1).to(torch.int32), toks[:, j + 1]):
            fail(f"{path}: decode step {j} does not repeat the served token")
        worst = max(worst, rel_l2_or_fail(f"{path} decode step {j} logits",
                                          lk, lp))
        flips += int((lk.argmax(-1) != lp.argmax(-1)).sum())
    checks.update(decode_logits_max_rel_l2=worst,
                  decode_argmax_differences=flips)
    stages["plain recompute"] = time.perf_counter() - lap
    lap = time.perf_counter()
    decode_window = profile_window(lambda j: stack.decode_step(
        params, toks[:, j:j + 1], cache, prompt + j, cfg), 3)
    del res, cache, states, plain_cache, plain_logits, lk, lp
    torch.cuda.empty_cache()
    stages["decode profile"] = time.perf_counter() - lap
    lap = time.perf_counter()

    # both fp32 paths against fp64 at a shorter prompt
    short = prompts[:, :FP64_PROMPT]
    lk, _ = stack.prefill(params, short, cfg, xsource=xs, backend="cuda")
    lp, _ = stack.prefill(params, short, cfg, xsource=xs, backend="eager")
    p64 = _to_double(params)
    l64, _ = stack.prefill(p64, short, cfg, backend="eager",
                           xsource=None if xs is None else xs.double())
    torch.cuda.synchronize()
    del p64
    torch.cuda.empty_cache()
    checks["fp64"] = {
        "prompt": FP64_PROMPT,
        "kernel_rel_l2": rel_l2_or_fail(f"{path} fp64 check, kernel path",
                                        lk, l64),
        "plain_rel_l2": rel_l2_or_fail(f"{path} fp64 check, plain path",
                                       lp, l64)}
    emit({"phase": path, "recompute": "plain path on the card", **checks})
    stages["fp64"] = time.perf_counter() - lap
    lap = time.perf_counter()

    emit({"phase": path, "profile": "3 decode steps", **decode_window})
    window = profile_window(lambda i: stack.prefill(params, prompts, cfg,
                                                    xsource=xs), 1,
                            share_of="flash")
    emit({"phase": path, "profile": "one prefill", **window})
    del prompts, built, xs
    torch.cuda.empty_cache()
    stages["prefill profile"] = time.perf_counter() - lap
    emit({"phase": path, "seconds": time.perf_counter() - t_path,
          "stage_seconds": stages})
    return launches, (cfg, params)


def to_host(tree):
    """A dict of card tensors copied to the host, the card's freed."""
    return {n: tree.pop(n).cpu() for n in list(tree)}


def on_card(host):
    """The host tensors back on the card one at a time, in order."""
    return (t.to(DEV) for t in host.values())


def updated(cfg, params, grads, opt_cfg):
    """Step 0's updated parameters: a copy of ``params`` after one Adam
    step (fresh moments) on ``grads`` (consumed), on the host."""
    from repro_torch.models.transformer import lm
    from repro_torch.optim import adam
    work = {n: t.clone() for n, t in lm.flatten_params(params).items()}
    opt = adam.init_state(work, opt_cfg)
    adam.apply_updates_(work, grads, opt, opt_cfg)
    del opt
    out = to_host(work)
    torch.cuda.empty_cache()
    return out


def exact_zero(cfg):
    """The flattened names of the gradients that are 0 in exact
    arithmetic: each cross-attention block's ``bk`` (no rotary, so bk
    shifts all of a query's keys alike, which leaves the softmax as it
    is). Computed, they are rounding noise (~1e-10 in fp32), so a
    relative distance between two of them measures nothing."""
    if not cfg.qkv_bias:
        return set()
    return {f"layers/{i}/{r}/mix/bk" for i, kind in
            enumerate(cfg.layer_pattern) if kind == "xattn"
            for r in range(cfg.repeats)}


def noise_or_fail(what, grads, zero, bound=1e-5):
    """Each gradient of ``zero`` (:func:`exact_zero`) at the noise level:
    its L2 norm at most ``bound`` of its block's ``bv`` gradient's.
    Returns the largest ratio."""
    worst = 0.0
    for n in sorted(zero):
        r = (grads[n].double().norm() / grads[n[:-2] + "bv"].double().norm()
             .clamp(min=1e-300)).item()
        if not r <= bound:
            fail(f"{what} {n}: {r} of its block's bv gradient (a gradient "
                 f"that is 0 in exact arithmetic; bound {bound})")
        worst = max(worst, r)
    return worst


def train_step0_checks(path, cfg, params, batch, opt_cfg):
    """Step 0 recomputed from ``params`` on the kernel path and on the
    plain path: the losses within 1e-5 relative, every gradient and
    every parameter after the step's Adam update within 1e-3 relative
    L2 per tensor; both fp32 paths' loss within 1e-5 and gradients
    within 1e-3 of an fp64 recompute at ``TRAIN_FP64_SEQ`` tokens. The
    fp64 recompute runs with remat off, so it also holds the fp32 paths'
    checkpointed gradients against a plain autograd. One path's
    gradients wait on the host while the other's are on the card
    (gemma2-2b's take 10.4 GB). The gradients of :func:`exact_zero`
    are held to the noise level in each path instead
    (:func:`noise_or_fail`), and their updated parameters, which Adam
    moves by up to lr along the noise's sign, within 2 lr of each other
    entrywise."""
    from repro_torch.models.transformer import lm

    def grads(backend, p, b, c=cfg):
        loss, g = lm.make_grad_fn(c, backend=backend)(p, b)
        return loss.item(), g

    out = {}
    # the fp64 yardstick on the batch's first TRAIN_FP64_SEQ tokens (and
    # all of its first row's frames)
    short = {k: v[:1] if k == "xsource" else v[:1, :TRAIN_FP64_SEQ]
             for k, v in batch.items()}
    lk, gk = grads("cuda", params, short)
    gk = to_host(gk)
    lp, gp = grads("eager", params, short)
    gp = to_host(gp)
    p64 = _to_double(params)
    l64, g64 = grads("eager", p64, {k: v.double() if v.is_floating_point()
                                    else v for k, v in short.items()},
                     dataclasses.replace(cfg, remat=False))
    del p64
    zero = exact_zero(cfg)
    names = [n for n in g64 if n not in zero]
    for what, loss in (("kernel", lk), ("plain", lp)):
        if not abs(loss - l64) <= 1e-5 * abs(l64):
            fail(f"{path} step 0 fp64 check: the {what} path's loss {loss} "
                 f"against {l64}")
    out["fp64"] = {"tokens": TRAIN_FP64_SEQ, "remat": False, "loss": l64,
                   "loss_kernel": lk, "loss_plain": lp,
                   "gradients": against_fp64(
                       f"{path} step 0 fp64 check, gradient",
                       (gk[n].to(DEV) for n in names),
                       (gp[n].to(DEV) for n in names),
                       (g64[n] for n in names), names)}
    if zero:
        out["fp64"]["exact_zero_gradient_max_ratio"] = {
            what: noise_or_fail(f"{path} step 0 fp64 check, {what} path",
                                g, zero)
            for what, g in (("kernel", gk), ("plain", gp), ("fp64", g64))}
    del gk, gp, g64
    torch.cuda.empty_cache()

    # step 0 at the path's batch: kernel path against plain path
    lk, gk = grads("cuda", params, batch)
    gk = to_host(gk)
    lp, gp = grads("eager", params, batch)
    if not abs(lk - lp) <= 1e-5 * abs(lp):
        fail(f"{path} step 0 loss: kernel path {lk}, plain path {lp}")
    names = [n for n in gp if n not in zero]
    out["loss_kernel"], out["loss_plain"] = lk, lp
    out["gradient_max_rel_l2"] = kernel_vs_plain(
        f"{path} step 0 gradient", (gk[n].to(DEV) for n in names),
        (gp[n] for n in names), names)
    if zero:
        out["exact_zero_gradient_max_ratio"] = {
            what: noise_or_fail(f"{path} step 0, {what} path", g, zero)
            for what, g in (("kernel", gk), ("plain", gp))}
    plain_new = updated(cfg, params, gp, opt_cfg)
    kernel_new = updated(cfg, params, {n: t.to(DEV) for n, t in gk.items()},
                         opt_cfg)
    del gk
    out["updated_max_rel_l2"] = kernel_vs_plain(
        f"{path} step 0 updated parameter",
        (kernel_new[n].to(DEV) for n in names),
        (plain_new[n].to(DEV) for n in names), names)
    for n in zero:
        d = (kernel_new[n] - plain_new[n]).abs().max().item()
        if not d <= 2 * opt_cfg.lr:
            fail(f"{path} step 0 updated parameter {n}: {d} apart (bound "
                 f"2 lr)")
    if cfg.encoder is not None:
        # the batch's loss after the kernel path's step on it
        stepped = lm.unflatten_params(
            {n: t.to(DEV) for n, t in kernel_new.items()}, params)
        with torch.no_grad():
            out["loss_after_one_step"] = lm.loss_fn(stepped, batch,
                                                    cfg).item()
        del stepped
    del kernel_new, plain_new
    torch.cuda.empty_cache()
    return out


def phase_lm_train(path, opts, built=None):
    """LM training at full width and depth through
    ``repro_torch.launch.train``'s ``--workload lm`` path (``train_lm``),
    from random weights of ``--seed`` (``built``: phase 6's, the same
    draw): step 0 held against the plain path and fp64
    (:func:`train_step0_checks`; for a path without B9 the two fp32 paths
    run the same operations), and for Mamba2 a 2-microbatch gradient
    against the 1-microbatch one on the same batch (loss within 1e-5,
    gradients within 1e-4 relative L2; the reference's own test); then
    the run's steps, counts zeroed before and read after (B9: 2 launches
    per causal self-attention layer a step, the forward's and the
    recompute's); finite losses, the last below the first; one more
    step and one forward under the profiler (B9's share of each).
    An encoder-decoder is held to one step on batch 0 lowering batch
    0's loss instead of the run's last loss below its first: on 1,500
    random frames the losses of 4 fresh bigram batches at lr 1e-3 stay
    within 11.10-11.23 at every depth from 8 to 64 (and at lr 3e-4), so
    the order of the first and the last is a coin toss, and batch 0's
    loss after the 4 steps moved to 12.15, 13.32 and 10.91 at depths 8,
    16 and 64: a measurement of Adam's first steps at lr 1e-3, printed,
    not gated.

    A config with cross-attention trains, and is checked, on the serving
    path's random frames (``serve.source_frames``), handed to
    ``train_lm``: its default, the reference's zero frames, makes a
    32-layer layernorm encoder's gradient overflow to NaN on step 0
    (ROADMAP C7), and gives the encoder's weights no gradient."""
    from repro_torch.data.tokens import BigramStream
    from repro_torch.launch import train
    from repro_torch.models.transformer import lm
    from repro_torch.optim import adam

    t_path = time.perf_counter()
    arch, batch, seq, steps, depth = {**LM_TRAIN_PATHS,
                                      **LM_ENCDEC_TRAIN_PATHS}[path]
    args = train.parser().parse_args([
        "--workload", "lm", "--device", DEV, "--arch", arch, "--batch",
        str(batch), "--seq", str(seq), "--steps", str(steps), "--seed",
        str(opts.seed)])
    t0 = time.perf_counter()
    reused = built is not None
    cfg, params = (cut_depth(*built, depth) if reused
                   else train.build_lm(args, num_layers=depth,
                                       cfg=unregistered(arch)))
    built = None    # the layers past the cut are freed
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not cfg.remat:
        fail(f"{path}: {arch}'s config does not set remat")
    n_params = sum(t.numel() for t in _tensors(params))
    n_attn = n_attention(cfg)
    opt_cfg = adam.AdamConfig(lr=args.lr)
    # the launcher's first batch, drawn again from the same stream
    toks, labels = BigramStream(cfg.vocab, seed=opts.seed).batch(
        batch, seq, device=DEV)
    b0 = {"tokens": toks, "labels": labels}
    if cfg.xattn_source_len:
        from repro_torch.launch import serve
        b0["xsource"] = serve.source_frames(cfg, batch, opts.seed, DEV)
    stages = {"init": init_s}
    lap = time.perf_counter()
    checks = train_step0_checks(path, cfg, params, b0, opt_cfg)
    stages["step 0 checks"] = time.perf_counter() - lap
    if batch > 1:
        l1, g1 = lm.make_grad_fn(cfg)(params, b0)
        l2, g2 = lm.make_grad_fn(cfg, num_microbatches=2)(params, b0)
        if not abs(l1.item() - l2.item()) <= 1e-5 * abs(l1.item()):
            fail(f"{path}: 2 microbatches' loss {l2.item()} against "
                 f"{l1.item()}")
        zero = exact_zero(cfg)
        names = [n for n in g1 if n not in zero]
        checks["microbatches"] = {
            "n": 2, "loss_1": l1.item(), "loss_2": l2.item(),
            "gradient_max_rel_l2": kernel_vs_plain(
                f"{path} 2 microbatches' gradient", (g2[n] for n in names),
                (g1[n] for n in names), names, tol=1e-4)}
        for k, g in (("1", g1), ("2", g2)):
            if zero:
                checks["microbatches"][f"exact_zero_ratio_{k}"] = \
                    noise_or_fail(f"{path} {k} microbatches", g, zero)
        del g1, g2
    emit({"phase": path, "recompute": "step 0, plain path and fp64 on the "
          "card", **checks})
    torch.cuda.empty_cache()
    stages["microbatches"] = (time.perf_counter() - lap
                              - stages["step 0 checks"])
    lap = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run = train.train_lm(args, (cfg, params), frames=b0.get("xsource"))
    torch.cuda.synchronize()
    stages["run"] = time.perf_counter() - lap
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = 2 * n_attn * steps
    if launches["flash_attention"] != want:
        fail(f"{path}: B9 launched {launches['flash_attention']} times, "
             f"not 2 x {n_attn} causal self-attention layers x {steps} "
             "steps")
    losses = run["losses"]
    with torch.no_grad():   # batch 0 again, after the run's steps
        held = lm.loss_fn(run["params"], b0, cfg).item()
    if not all(math.isfinite(x) for x in losses + [held]):
        fail(f"{path}: losses {losses}, batch 0 after the run {held}")
    if cfg.encoder is None and not losses[-1] < losses[0]:
        fail(f"{path}: losses {losses}")
    if cfg.encoder is not None and not (checks["loss_after_one_step"]
                                        < checks["loss_kernel"]):
        fail(f"{path}: batch 0's loss {checks['loss_kernel']}, after one "
             f"step on it {checks['loss_after_one_step']}")
    warm = run["step_seconds"][1:]
    step_ms = sum(warm) / len(warm) * 1e3
    full = get_config(arch)
    reduced = (f"depth {cfg.num_layers} of the arch's {full.num_layers} "
               "layers")
    if cfg.encoder is not None:
        reduced += (f", encoder {cfg.encoder.num_layers} of "
                    f"{full.encoder.num_layers}")
    line = {"phase": path, "arch": arch, "params": n_params,
            "layers": cfg.num_layers, "reduced": reduced + ", full width",
            "init_seconds": init_s, "params_reused_from_serving": reused,
            "batch": batch, "seq": seq, "steps": steps, "remat": cfg.remat,
            "losses": losses, "batch0_loss_before_after": [
                checks["loss_kernel"], held],
            "step_ms": [t * 1e3 for t in run["step_seconds"]],
            "warm_step_ms": step_ms,
            "tokens_per_s": batch * seq / step_ms * 1e3,
            "launches": launches, "peak_memory_gib": peak,
            "account": account_or_fail(path, cfg, "train", batch, seq, peak)}
    if cfg.xattn_source_len:
        line.update(frames=cfg.xattn_source_len,
                    frames_drawn_by="serve.source_frames")
    emit(line)
    lap = time.perf_counter()

    params, opt = run["params"], run["opt_state"]
    del run
    step = lm.make_train_step(cfg, opt_cfg)
    window = profile_window(lambda i: step(params, opt, b0), 1,
                            share_of="flash")
    emit({"phase": path, "profile": "one train step", **window})
    from repro_torch.launch import perf
    lap_perf = time.perf_counter()
    m = perf.measure_lm(arch, "train_4k", cfg=cfg, batch=batch, seq_len=seq,
                        device=DEV, measured={"seconds": step_ms / 1e3,
                                              "profile": window,
                                              "peak_memory_gib": peak})
    stages["counts"] = time.perf_counter() - lap_perf
    emit({"phase": path, "perf": {k: m[k] for k in PERF_KEYS}})
    with torch.no_grad():
        window = profile_window(lambda i: lm.loss_fn(params, b0, cfg), 1,
                                share_of="flash")
    emit({"phase": path, "profile": "one forward (no gradient)", **window})
    del params, opt, step, b0, toks, labels
    gc.collect()
    torch.cuda.empty_cache()
    stages["profiles"] = time.perf_counter() - lap - stages["counts"]
    emit({"phase": path, "seconds": time.perf_counter() - t_path,
          "stage_seconds": stages})
    return launches


def account_or_fail(path, cfg, kind, batch, seq, peak_gib):
    """``launch/dryrun.account`` of a path (fp32 state) beside its
    measured peak: its resident state (the parameters, and the optimizer
    state or the cache the path holds) must not exceed the peak."""
    from repro_torch.launch import dryrun
    acct = dryrun.account(cfg, kind, batch, seq)
    peak = peak_gib * 2**30
    if not acct["resident"] <= peak:
        fail(f"{path}: the dry run's resident {acct['resident'] / 2**30} "
             f"GiB exceeds the measured peak {peak_gib} GiB")
    return {"predicted_gib": {k: v / 2**30 for k, v in acct.items()},
            "measured_peak_gib": peak_gib,
            "resident_over_peak": acct["resident"] / peak}


def unregistered(arch):
    """The config of an arch this script builds itself (phase 9's
    encoder-decoder), else None: the launchers take ``--arch``'s."""
    return encdec_cfg() if arch == ENCDEC_ARCH else None


def get_config(arch):
    from repro_torch import configs
    return unregistered(arch) or configs.get_config(arch, dtype="float32")


def cut_depth(cfg, params, num_layers):
    """``cfg`` and ``params`` cut to their first ``num_layers`` layers (a
    multiple of the layer pattern) at full width: each pattern entry
    keeps its first repeats, the same tensors (no copy). An encoder is
    cut to the same fraction of its layers."""
    reps = num_layers // len(cfg.layer_pattern)
    if reps * len(cfg.layer_pattern) != num_layers:
        fail(f"{cfg.name}: {num_layers} layers is not a multiple of the "
             f"pattern of {len(cfg.layer_pattern)}")
    out_cfg = dataclasses.replace(cfg, num_layers=num_layers)
    out = {**params, "layers": [e[:reps] for e in params["layers"]]}
    if cfg.encoder is not None:
        enc_cfg, out["encoder"] = cut_depth(
            cfg.encoder, params["encoder"],
            cfg.encoder.num_layers * num_layers // cfg.num_layers)
        out_cfg = dataclasses.replace(out_cfg, encoder=enc_cfg)
    return out_cfg, out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def _to_double(tree):
    if isinstance(tree, dict):
        return {k: _to_double(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_double(v) for v in tree]
    return tree.double()


def phases_lm(opts, records, paths):
    """Phases 6-9: B9's adversarial cases; serving the dense archs
    (``LM_PATHS``); training (``LM_TRAIN_PATHS``, gemma2-2b from phase 6's
    weights, the same draw); serving the Mamba2, zamba2 and MoE archs
    (``LM_BLOCK_PATHS``); serving and then training the encoder-decoder
    (``LM_ENCDEC_PATHS``, ``LM_ENCDEC_TRAIN_PATHS``, one draw of the
    weights). Adds each path's counts to ``paths``."""
    records["flash_attention"] = Record(
        "flash_attention", "cuda", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:30",
        peak="3xtf32")
    adversarial_flash()
    trained = {arch for arch, *_ in LM_TRAIN_PATHS.values()}
    kept = {}
    for path in LM_PATHS:
        paths[path], built = phase_lm(path, opts, records)
        if built[0].name in trained:
            kept[built[0].name] = built
        del built
        gc.collect()
        torch.cuda.empty_cache()
    for path, (arch, *_) in LM_TRAIN_PATHS.items():
        paths[path] = phase_lm_train(path, opts, kept.pop(arch, None))
        gc.collect()
        torch.cuda.empty_cache()
    for path in LM_BLOCK_PATHS:
        paths[path], built = phase_lm(path, opts, records)
        del built
        gc.collect()
        torch.cuda.empty_cache()
    for path in LM_ENCDEC_PATHS:
        paths[path], built = phase_lm(path, opts, records)
        kept[built[0].name] = built
        del built
    for path, (arch, *_) in LM_ENCDEC_TRAIN_PATHS.items():
        paths[path] = phase_lm_train(path, opts, kept.pop(arch, None))
        gc.collect()
        torch.cuda.empty_cache()


def window_only(opts):
    """``--window-only``: build the kernels of the tree on ``sys.path``,
    make the dataset and print its serial LABOR-0 window (phase 4b's
    "off" window) as one JSON line."""
    from repro_torch.graph import paper_dataset
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ds = paper_dataset("products", scale=opts.scale, seed=opts.seed)
    window = train_window(ds, dict(batch_size=1024, fanouts=(10, 10, 10),
                                   lr=1e-3, seed=opts.seed, hidden=256),
                          "off")
    import repro_torch
    emit({"repro_torch": str(Path(repro_torch.__file__).parent), **window})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (no kernels or ok line)")
    ap.add_argument("--lm-only", action="store_true",
                    help="phase 1, then the LM phases 6-9 alone (no "
                         "kernels or ok line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phase 1, then the train mesh phase alone (no "
                         "kernels or ok line)")
    ap.add_argument("--parent-src", default=None,
                    help="the src directory of another tree of the port: "
                         "phase 4b also prints that tree's serial LABOR-0 "
                         "window, measured in a child process")
    ap.add_argument("--window-only", action="store_true",
                    help="print the serial LABOR-0 window of the port in "
                         "--src and stop (no kernels or ok line)")
    ap.add_argument("--src", default=None,
                    help="the src directory to import repro_torch from "
                         "(default: this tree's)")
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only "
             "on a CUDA card")
    sys.path.insert(0, opts.src or str(Path(__file__).resolve().parent
                                       / "src"))
    if opts.window_only:
        window_only(opts)
        return
    from repro_torch.core import rng as rng_lib
    from repro_torch.core.interface import pad_seeds
    from repro_torch.data.gnn_loader import SeedBatches
    from repro_torch.kernels import _build
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
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.BUILD_LOG.items()},
          "flash_attention_sass": tensor_core_sass(_build)})

    records = {}
    if opts.mesh_only:
        from repro_torch.graph import paper_dataset
        ds = paper_dataset("products", scale=opts.scale, seed=opts.seed)
        phase_mesh(ds, opts, card)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "mesh_only": True})
        return
    if opts.lm_only:
        phases_lm(opts, records, {})
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "lm_only": True})
        return

    args = serve.parser().parse_args([
        "--workload", "gnn", "--driver", "off",
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
    records.update({
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
        "scatter_rows": Record(
            "scatter_rows", "cuda", "src/repro_torch/csrc/spmm.cu",
            "src/repro/kernels/spmm/spmm.py:31 (per-edge values, "
            "scatter_sorted_block)"),
        "edge_softmax": Record(
            "edge_softmax", "cuda", "src/repro_torch/csrc/edge_softmax.cu",
            "src/repro/kernels/edge_softmax/edge_softmax.py:42",
            status="redesigned: edge-parallel over the live prefix, one "
                   "streaming fill, sums in double"),
    })
    trials = {"compact": [], "hash_dedup": [], "compact_perm": [],
              "spmm": [], "segment_select": [], "masked_cdf_draw": []}
    phase_kernels(engine, data, seeds0, key0, opts.reps, records, trials)

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
                                         opts.reps, records, trials)
    phase_trials(trials, opts.reps)
    del trials
    n_cls = int(ds.labels.max()) + 1
    phase_gatv2_kernels(samplers_["engine"], data, seeds_t, key_t, opts.reps,
                        records, n_cls, opts.seed)
    del samplers_
    if opts.kernels_only:
        emit({"phase": "done", "seconds": time.perf_counter() - t_start,
              "kernels_only": True})
        return

    # -- phase 3: serve through the launcher's synchronous path ------------
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    report = serve.serve_gnn_sync(args, built)
    torch.cuda.synchronize()
    launches = launch_counts()
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

    # exact inference: full neighbourhoods, at FULL_DEPTH layers; then
    # GATv2 on LABOR-0's blocks
    paths = {"serve": launches,
             "serve full": phase_serve_path(ds, opts, "serve full", "full",
                                            "gcn", FULL_DEPTH, 2),
             "serve gatv2": phase_serve_path(ds, opts, "serve gatv2",
                                             "labor-0", "gatv2", 3,
                                             opts.requests)}
    # weighted graphs in every sampler kind, then the async driver
    paths.update(phase_weighted(ds, data, opts, seeds0, key0))
    paths["serve async"] = phase_serve_async(built, opts)

    # -- phase 4: train every path through the launcher's path ------------
    paths.update({f"train {k}": v for k, v in phase_train(ds, opts).items()})
    paths[WGRAD_PATH] = wgrad_launches

    # -- phase 4b: checkpoints, the guardrail, faults, the pipeline ---------
    paths.update(phase_runtime(ds, opts))

    # -- phase 4c: the multi-device engine, world sizes 1 and 2 -------------
    paths.update(phase_mesh(ds, opts, card))

    # -- phase 5: where the serving time goes -------------------------------
    phase_profile(eng_k, data, model, seeds0, key0)

    # -- phases 6-9: LM serving and training, with B9 ----------------------
    # the GNN phases' tensors go first (GATv2 peaked at 56 GiB)
    del built, ds, engine, data, model, eng_k, eng_e, logits_k, logits_e
    del blocks_k, blocks_e, flags_k, flags_e, seeds0, seeds_t
    gc.collect()
    torch.cuda.empty_cache()
    phases_lm(opts, records, paths)
    for name, rec in records.items():
        by_path = {p: counts[name] for p, counts in paths.items()}
        rec.row["launches_by_path"] = by_path
        rec.row["launches"] = sum(by_path.values())

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [r.row for r in records.values()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
