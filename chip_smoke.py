#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py [--scale 0.25] [--requests 8] [--reps 20]

Phases, each printing JSON lines; any mismatch, build failure or launch
error exits non-zero:

  1. device + build: the card's name and power limit (nvidia-smi), the
     seconds to compile every ``csrc/*.cu`` (one nvcc each, in parallel);
  2. kernels against plain: each CUDA kernel and its plain PyTorch
     version on the same inputs on the card -- the real inputs of every
     layer of the first served request, rebuilt with the plain versions,
     plus adversarial cases. Integers must match bit for bit, the SpMM to
     rtol = atol = 1e-5 (summation order). Times with CUDA events, beside
     the bound (bytes over 3.35 TB/s or flops over 67 TFLOP/s fp32,
     whichever is larger, counting what these inputs need) and one
     PyTorch library call computing the same function;
  3. serve: ``--requests`` requests through ``repro_torch.launch.serve``'s
     synchronous path on products at ``--scale`` (0.25: 612,257
     vertices) with the paper's widths (100 features, hidden 256, 47
     classes, 3 layers, fanouts 10,10,10, LABOR-0, batch 1024). Launch
     counters are zeroed just before and read just after; every kernel
     must have run. The first request is then recomputed with the plain
     versions on the card: integer block fields bit for bit, logits to
     rtol = atol = 1e-4;
  4. where the time goes: one warm request split into sample / gather /
     forward with CUDA events; then torch.profiler over a window of warm
     requests gives the device's busy time, its idle share in that same
     window, and the top device kernels per request.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
INT_MAX = 2**31 - 1
DEV = "cuda"


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
                        replaces=replaces, launches=0, max_abs_err=0.0,
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
    torch.cuda.synchronize()
    emit({"phase": "kernels", "adversarial_cases": cases, "ok": True})


def compare_blocks(blocks_k, blocks_e):
    from repro_torch.core.interface import INT_FIELDS
    for layer, (a, b) in enumerate(zip(blocks_k, blocks_e)):
        for f in INT_FIELDS:
            same(f"request 0 layer {layer} {f}", getattr(a, f), getattr(b, f))
        if not torch.allclose(a.weight, b.weight, rtol=1e-6, atol=1e-7):
            fail(f"request 0 layer {layer} weight differs")


def phase_profile(engine, data, model, seeds, key):
    """Phase 4: one warm request split by stage, and its top kernels."""
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
    from torch.profiler import ProfilerActivity, profile
    n_req = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_req):
            engine.infer(model, data, seeds, key)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
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
    # busy and elapsed come from the same window of n_req warm requests
    # (one stream, so the sum of device events is the busy time). The
    # profiler's host overhead slows the launches, so the idle share is
    # an upper estimate of the unprofiled one. No device events -> the
    # idle share is not measured.
    emit({"phase": "profile", "window_requests": n_req,
          "window_ms": window_ms,
          "device_busy_ms_per_request": busy_ms / n_req or None,
          "device_ops_per_request": sum(r[2] for r in rows) / n_req,
          "device_idle_share": (max(0.0, 1.0 - busy_ms / window_ms)
                                if busy_ms else None),
          "top": [{"name": k[:80], "calls_per_request": c / n_req,
                   "device_ms_per_request": us / 1e3 / n_req}
                  for us, k, c in rows[:15]]})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only "
             "on a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import rng as rng_lib
    from repro_torch.core.interface import pad_seeds
    from repro_torch.kernels import _build
    from repro_torch.kernels.frontier import ops as fk
    from repro_torch.kernels.spmm import ops as sk
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import TrainEngine

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
    }
    phase_kernels(engine, data, seeds0, key0, opts.reps, records)

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
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
        records[name].row["launches"] = n
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

    # -- phase 4: where the time goes ---------------------------------------
    phase_profile(eng_k, data, model, seeds0, key0)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [r.row for r in records.values()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
