"""Roofline terms beside measured times, one cell at a time on the card
(twin of ``repro.launch.perf``).

The reference lowers a cell on a forced 512-device host and reads the
compiled program's cost. The port runs the cell on one card and sets
the three roofline terms (``launch/roofline.py``) beside what it
measured: the warm step's seconds (host clock, ending in a sync), the
device's busy ms and idle share (torch.profiler) and the peak memory.

* :func:`measure_gnn`: ``configs/labor_gcn.py``'s step, counted from the
  live sizes of the blocks it sampled (|V^l|, |E^l|, the expanded edges
  and the widths) through the per-kernel work functions, plus the dense
  products and Adam. ``mfu`` is those FLOPs over the measured seconds
  times the named peak. The reference's fanout-geometry count
  (``dryrun.gnn_geometry_flops``) is reported as
  ``model_flops_geometry``, never as ``mfu``'s numerator: it assumes
  ~4x the vertices LABOR-0 samples.
* :func:`measure_lm`: one train step or prefill at full width and a
  stated depth; its FLOPs from ``FlopCounterMode`` over the plain path
  on the ``meta`` device, causal attention counted over its visible
  pairs only; its bytes from the parameters', gradients', Adam moments'
  and activations' shapes (``dryrun.account``).

With ``device="cpu"`` both return the counts and terms and every time
field is None; a measurement without a card fails, it never falls back.
Variants whose only lever is a mesh option (``seq_shard_carry``,
``attn_parallelism="sequence"``, ``logits_gather``) have no one-card
meaning and are not in :data:`VARIANTS`.

  python -m repro_torch.launch.perf --cell gnn --variant labor0 --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.launch import roofline as rl

#: the seconds a rank may wait on another in the world-size-2 variant
RANK_TIMEOUT_S = 600.0


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require_card(device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a measurement on the card, but "
                           "torch.cuda.is_available() is false")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_rows(prof):
    """(self device us, name, count) of each of the device's own events
    (kernels, copies, memsets) in a finished profile; an operator's
    device time repeats its kernels' and is left out."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.key, evt.count))
    return rows


def profile_window(run, n, share_of=None):
    """torch.profiler over ``run(0) .. run(n - 1)``: the window's
    elapsed time, the device's busy time and operations per call, its
    idle share in that same window, the top device kernels per call and,
    with ``share_of``, the share of the busy time spent in kernels whose
    name holds that string.
    Busy and elapsed come from the same window (one stream, so the sum
    of device events is the busy time). The profiler's host overhead
    slows the launches, so the idle share is an upper estimate of the
    unprofiled one. No device events -> busy and idle are not measured
    (None)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    out = {}
    if share_of is not None:
        hit = sum(r[0] for r in rows if share_of in r[1]) / 1e3
        out[f"{share_of}_share_of_busy"] = hit / busy_ms if busy_ms else None
    return {**out, "window_ms": window_ms,
            "device_busy_ms_per_call": busy_ms / n or None,
            "device_ops_per_call": sum(r[2] for r in rows) / n,
            "device_idle_share": (max(0.0, 1.0 - busy_ms / window_ms)
                                  if busy_ms else None),
            "top": [{"name": k[:80], "calls_per_call": c / n,
                     "device_ms_per_call": us / 1e3 / n}
                    for us, k, c in rows[:15]]}


def report(work: rl.Work, model_flops: float, wire: rl.CollectiveStats,
           seconds: Optional[float], peak: str = "fp32") -> dict:
    """The roofline terms of counted ``work`` a device and step, with
    ``mfu`` (the counted FLOPs over ``seconds`` times the named peak;
    None unmeasured) and the bound's share of the measured step."""
    terms = rl.roofline_terms(work.flops, work.bytes, wire.wire_bytes,
                              wire.by_kind, model_flops_total=model_flops,
                              peak=peak)
    terms["measured_s"] = seconds
    terms["mfu"] = (work.flops / (seconds * rl.PEAKS[peak])
                    if seconds else None)
    terms["bound_share_of_measured"] = (
        terms["step_time_lower_bound_s"] / seconds if seconds else None)
    return terms


# ---------------------------------------------------------------------------
# the GNN cell
# ---------------------------------------------------------------------------

def gnn_layer_sizes(blocks, caps, deg) -> list:
    """Per block (seed side first): live seeds |V^l| (``V``), the next
    layer's vertices |V^{l+1}| (``T``), sampled edges |E^l| (``E``), the
    seeds' expanded in-edges capped at the expand cap (``X``), and the
    caps the kernels run at. ``deg``: the graph's in-degrees (numpy)."""
    out = []
    for blk, c in zip(blocks, caps):
        seeds = np.asarray(blk.seeds)
        live = seeds[seeds >= 0]
        out.append(dict(
            V=int(live.shape[0]), T=int(blk.num_next), E=int(blk.num_edges),
            X=int(min(int(deg[live].sum()), c.expand_cap)),
            seed_cap=int(seeds.shape[0]), edge_cap=int(c.edge_cap),
            vertex_cap=int(c.vertex_cap), expand_cap=int(c.expand_cap)))
    return out


def gnn_work(sizes, dims) -> tuple:
    """(work of one GCN train step, the model's own FLOPs) from
    :func:`gnn_layer_sizes` and the widths ``dims`` (features, hidden
    ..., classes). Sampling, per block: compact over the expanded edges
    and over the seeds' degree flags, hash_dedup, compact_perm. The
    model, GCN layer i on block L-1-i: the forward SpMM over |E| edges
    from |V^{l+1}| rows, two products (``w`` and the residual ``wr``)
    of |V^l| rows, their backward (2x), the transposed SpMM for every
    layer but the first; the deepest layer's feature rows gathered;
    Adam (p, g, m, v read; p, m, v written; ~12 operations an entry)."""
    L = len(sizes)
    w = rl.Work(0.0)
    model = 0.0
    for s in sizes:
        w += rl.compact(s["X"], s["edge_cap"])
        w += rl.compact(s["seed_cap"], s["seed_cap"])
        w += rl.hash_dedup(s["E"], s["seed_cap"],
                           s["vertex_cap"] - s["seed_cap"], s["edge_cap"])
        w += rl.compact_perm(s["E"], s["edge_cap"])
    for i in range(L):
        s = sizes[L - 1 - i]
        fi, fo = dims[i], dims[i + 1]
        dense = rl.gemm(s["V"], fi, fo)
        # forward: the SpMM, the products with w and wr; backward: each
        # product's two (the input's and the weight's gradient)
        layer = rl.spmm(s["E"], s["T"], s["V"], fi) + rl.Work(
            6 * dense.bytes, 6 * dense.flops)
        if i > 0:
            layer += rl.spmm_t(s["E"], s["V"], s["T"], fi)
        w += layer
        model += layer.flops
    deep = sizes[-1]
    w += rl.Work(2.0 * deep["T"] * dims[0] * 4)
    n = sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))
    w += rl.Work(7.0 * 4 * n, 12.0 * n)
    return w, model


def _gnn_config(ds, sampler, compression, cap_safety, global_batch):
    from repro_torch.configs import labor_gcn
    g = ds.graph
    kw = dict(sampler=sampler, grad_compression=compression,
              cap_safety=cap_safety, num_vertices=g.num_vertices,
              avg_degree=g.num_edges / g.num_vertices,
              feature_dim=int(np.asarray(ds.features).shape[1]),
              num_classes=int(np.asarray(ds.labels).max()) + 1)
    if global_batch is not None:
        kw["global_batch"] = global_batch
    return labor_gcn.config(**kw)


def _launcher_batches(ds, global_batch, seed, steps):
    """The train launcher's schedule: ``SeedBatches.at(t)`` and
    ``fold_in(key(seed + 1), t)``."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.data.gnn_loader import SeedBatches
    sb = SeedBatches(ds.train_idx, global_batch, seed=seed)
    return [(sb.at(t).numpy(), rng_lib.fold_in(rng_lib.key(seed + 1), t))
            for t in range(steps)]


def _drive_gnn(engine, ds, cfg, batches, seed, device, mesh=None,
               profile=True, count=True, before_steps=None,
               after_steps=None):
    """The engine's steps over ``batches``, each followed by a flush and
    a sync (an overflowed batch is replayed before the next one): each
    step's metrics, frontier sets (host) and seconds, with ``count``
    also its blocks' live sizes (one more sampling pass with the step's
    key), the counted collective payloads (a mesh), the peak memory, the
    final parameters (host) and, with ``profile`` on the card, one more
    step under the profiler. ``before_steps(engine, data, batches)``
    runs after the set-up and ``after_steps()`` right after the last
    step, before the profile; its value is returned as ``after``."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.models import gnn as gnn_models

    t_set = time.perf_counter()
    model = gnn_models.gcn_init(rng_lib.key(seed), cfg.feature_dim,
                                cfg.hidden, cfg.num_classes, cfg.num_layers,
                                device=device)
    data = engine.make_data_from_dataset(ds)
    state = engine.init_state(model)
    indptr = np.asarray(ds.graph.indptr.cpu() if torch.is_tensor(
        ds.graph.indptr) else ds.graph.indptr)
    deg = indptr[1:] - indptr[:-1]
    cuda = torch.device(device).type == "cuda"
    batches = [(torch.as_tensor(s, device=device), k) for s, k in batches]
    if before_steps is not None:
        before_steps(engine, data, batches)
    _sync(device)
    setup_s = time.perf_counter() - t_set
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if mesh is not None:
        mesh.moved.clear()
    steps = []
    for t, (seeds, key) in enumerate(batches):
        _sync(device)
        t0 = time.perf_counter()
        model, state, m = engine.step(model, state, data, seeds, key, tag=t)
        model, state, rm = engine.flush(model, state, data)
        _sync(device)
        dt = time.perf_counter() - t0
        m = rm if rm is not None else m
        rec = dict(seconds=dt, loss=float(m["loss"]), acc=float(m["acc"]),
                   sampled_v=int(m["sampled_v"]),
                   sampled_e=int(m["sampled_e"]),
                   overflow=bool(m["overflow"].any()))
        if mesh is not None:
            rec["feat_rows"] = int(m["feat_rows"])
            frontiers = m["frontiers"]
        if count or mesh is None:
            sampled = engine.sample_stage(data.graph, seeds, key)
            blocks = sampled if mesh is None else sampled.blocks
            if mesh is None:
                frontiers = [seeds] + [b.next_seeds for b in blocks]
        if count:
            rec["sizes"] = gnn_layer_sizes([_host(b) for b in blocks],
                                           engine.sampler.caps, deg)
        rec["frontiers"] = [torch.unique(f[f >= 0]).cpu() for f in frontiers]
        steps.append(rec)
    moved = dict(mesh.moved) if mesh is not None else {}
    after = after_steps() if after_steps is not None else None
    peak = (torch.cuda.max_memory_allocated(device) / 2**30 if cuda
            else None)
    params = [p.detach().cpu().clone() for p in model.parameters()]
    window = None
    if cuda and profile:
        seeds, key = batches[0]

        def warm(_i):
            engine.step(model, state, data, seeds, key)
            engine.flush(model, state, data)
        window = profile_window(warm, 1)
    return dict(steps=steps, moved=moved, peak_memory_gib=peak,
                params=params, profile=window, setup_seconds=setup_s,
                after=after, replays=engine.stats.overflow_replays,
                retries=engine.stats.overflow_retries)


def _host(blk):
    return dataclasses.replace(blk, seeds=blk.seeds.cpu(),
                               num_next=int(blk.num_next),
                               num_edges=int(blk.num_edges))


def _gnn_rank(mesh, ds_args, sampler, compression, cap_safety, global_batch,
              seed, steps):
    """One rank of a mesh run of :func:`measure_gnn` (the graph generated
    again from ``ds_args``)."""
    from repro_torch.graph import paper_dataset
    from repro_torch.launch.gnn_step import build_gnn_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = paper_dataset(*ds_args)
    cfg = _gnn_config(ds, sampler, compression, cap_safety, global_batch)
    engine, meta = build_gnn_engine(mesh, cfg)
    batches = _launcher_batches(ds, cfg.global_batch, seed, steps)
    out = _drive_gnn(engine, ds, cfg, batches, seed, mesh.device, mesh=mesh,
                     profile=False)
    out.pop("params")
    return dict(out, meta={k: str(v) for k, v in meta.items()},
                ranks=mesh.size)


@functools.lru_cache(maxsize=2)
def _products(scale: float, seed: int):
    """The products graph at ``scale``, generated once a process (the
    CLI's variants share it; nothing writes to it)."""
    from repro_torch.graph import paper_dataset
    return paper_dataset("products", scale=scale, seed=seed)


def measure_gnn(sampler: str = "labor-0", compression: str = "none",
                cap_safety: float = 1.6, *, device="cuda", steps: int = 3,
                scale: float = 0.25, global_batch: Optional[int] = None,
                dataset=None, world_size: int = 1, seed: int = 0,
                batches=None, keep: bool = False) -> dict:
    """labor-gcn's step (``configs/labor_gcn.py``: 3 GCN layers 100 /
    256 / 256 / 47, fanouts 10,10,10, Adam lr 1e-3, ``global_batch``
    32,768 by default) on products at ``scale`` (or ``dataset``), over
    ``steps`` of the launcher's batches (or ``batches``: (seeds, key)
    pairs). World size 1 is the single-device engine with the mesh's
    sampler geometry (no per-peer caps); a larger one spawns that many
    ranks (``launch/mesh.spawn``; on ``cuda`` a gloo group on the one
    card, as chip_smoke's phase 4c) through
    ``launch/gnn_step.build_gnn_engine``, rank 0 reporting. Returns the
    counts a step (per-layer live sizes, ``work``), the roofline terms
    with ``mfu``, ``model_flops_geometry``, and the measured seconds,
    busy ms, idle share and peak memory (None on the CPU). ``keep``:
    also each step's metrics and frontier sets and the final parameters
    (the single-device run)."""
    from repro_torch.core import samplers as sampler_registry
    from repro_torch.launch import dryrun
    from repro_torch.optim import adam
    from repro_torch.ops import autotune
    from repro_torch.runtime.engine import TrainEngine

    require_card(device)
    cuda = torch.device(device).type == "cuda"
    t_all = time.perf_counter()
    if world_size == 1:
        ds = dataset or _products(scale, seed)
        cfg = _gnn_config(ds, sampler, compression, cap_safety, global_batch)
        smp = sampler_registry.from_graph_stats(
            cfg.sampler, batch_size=cfg.global_batch, fanouts=cfg.fanouts,
            avg_degree=cfg.avg_degree,
            max_degree=int(min(cfg.avg_degree * 64, cfg.num_vertices - 1)),
            num_vertices=cfg.num_vertices,
            num_edges=int(cfg.num_vertices * cfg.avg_degree),
            safety=cfg.cap_safety)
        engine = TrainEngine(smp, adam.AdamConfig(lr=1e-3), device=device)
        batches = batches or _launcher_batches(ds, cfg.global_batch, seed,
                                               steps)
        run = _drive_gnn(engine, ds, cfg, batches, seed, device)
        ranks, local_batch = 1, cfg.global_batch
    else:
        if dataset is not None or batches is not None:
            raise ValueError("a mesh run generates its graph and batches "
                             "in each rank")
        from repro_torch.launch.mesh import spawn
        ds = _products(scale, seed)
        cfg = _gnn_config(ds, sampler, compression, cap_safety, global_batch)
        run = spawn(_gnn_rank, world_size, ("products", scale, seed),
                    sampler, compression, cap_safety, global_batch, seed,
                    steps, device=device,
                    backend="gloo", timeout_s=RANK_TIMEOUT_S)
        ranks = run["ranks"]
        local_batch = max(cfg.global_batch // ranks, 8)
    dims = [cfg.feature_dim] + [cfg.hidden] * (cfg.num_layers - 1) \
        + [cfg.num_classes]
    works = [gnn_work(s["sizes"], dims) for s in run["steps"]]
    n = len(works)
    work = rl.Work(sum(w.bytes for w, _ in works) / n,
                   sum(w.flops for w, _ in works) / n)
    model = sum(m for _, m in works) / n
    wire = rl.collective_stats(
        (kind, b / n, ranks) for kind, b in run["moved"].items())
    warm = [s["seconds"] for s in run["steps"][1:]] or None
    seconds = sum(warm) / len(warm) if (cuda and warm) else None
    out = {
        "cell": "gnn", "sampler": sampler, "compression": compression,
        "cap_safety": cap_safety, "world_size": ranks, "device": str(device),
        "card": card() if cuda else None,
        "num_vertices": cfg.num_vertices,
        "num_edges": int(ds.graph.num_edges),
        "global_batch": cfg.global_batch, "local_batch": local_batch,
        "steps": n, "layer_sizes": [s["sizes"] for s in run["steps"]],
        "sampled_v": [s["sampled_v"] for s in run["steps"]],
        "losses": [s["loss"] for s in run["steps"]],
        "replays": run["replays"],
        "work": {"bytes": work.bytes, "flops": work.flops,
                 "model_flops": model},
        "collective_payload_bytes_per_step": {
            k: b / n for k, b in run["moved"].items()},
        "model_flops_geometry": dryrun.gnn_geometry_flops(
            cfg, local_batch, ranks),
        **report(work, model, wire, seconds),
        "step_seconds": ([s["seconds"] for s in run["steps"]] if cuda
                         else None),
        "warm_step_seconds": seconds,
        "device_busy_ms": None, "device_idle_share": None,
        "peak_memory_gib": run["peak_memory_gib"],
        "frontier_tuning": autotune.cache_fingerprint(),
        "seconds": time.perf_counter() - t_all,
    }
    if run.get("profile"):
        out["device_busy_ms"] = run["profile"]["device_busy_ms_per_call"]
        out["device_idle_share"] = run["profile"]["device_idle_share"]
        out["device_ops"] = run["profile"]["device_ops_per_call"]
    if keep:
        out["step_records"] = run["steps"]
        out["params"] = run.get("params")
    return out


def measure_gnn_provisioned(sampler: str, *, device="cuda",
                            **kw) -> dict:
    """The reference's "provisioned" caps: the sampler's |V^3| a seed
    measured on a small products graph (scale 0.003, batch 128, 3 keys,
    safety 2.5), against NS's fanout-geometry 49 a seed, gives the cap
    safety of the full run (at least 0.2)."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.core import samplers
    from repro_torch.core.interface import pad_seeds
    from repro_torch.graph import paper_dataset

    ds = paper_dataset("products", scale=0.003, seed=0, feature_dim=8)
    B = 128
    smp = samplers.from_dataset(sampler, ds, batch_size=B,
                                fanouts=(10, 10, 10), safety=2.5)
    seeds = pad_seeds(torch.as_tensor(ds.train_idx[:B]), B)
    v3 = []
    for t in range(3):
        blocks = smp.sample(ds.graph, seeds, smp.spec.salts(rng_lib.key(t)),
                            backend="eager")
        v3.append(int(blocks[-1].num_next))
    per_seed = float(np.mean(v3)) / B
    safety = 1.6 * max(per_seed / 49.0, 0.05)
    out = measure_gnn(sampler, cap_safety=max(safety, 0.2), device=device,
                      **kw)
    out.update(measured_v3_per_seed=per_seed, cap_safety_used=safety)
    return out


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _attention_excess(cfg, batch: int, seq: int) -> float:
    """The plain path's full-square causal attention FLOPs in one
    forward minus the pairs the mask lets through: each causal
    self-attention layer (not Mamba2, not cross-attention, not an
    encoder's) runs two (Sq, Sk, hd) products per head."""
    if cfg.is_encoder:
        return 0.0
    excess = 0.0
    for kind in cfg.layer_pattern:
        if kind in ("mamba", "xattn"):
            continue
        window = cfg.window if kind == "attn_local" else None
        full = 4.0 * batch * cfg.n_heads * cfg.head_dim * seq * seq
        excess += cfg.repeats * (full - rl.flash_attention(
            batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 4,
            True, window).flops)
    return excess


def lm_counts(cfg, kind: str, batch: int, seq: int, *, n_mb: int = 1,
              opt_bytes: int = 4) -> dict:
    """Counted work of one train step (``kind`` "train") or prefill of
    ``cfg`` at ``batch`` x ``seq``, on the ``meta`` device: the FLOPs
    ``FlopCounterMode`` counts over the plain path (remat off: what the
    step needs, not its recompute) less the masked-out causal pairs;
    the bytes of a step (train: the parameters read by the forward and
    the backward, the gradients written and read, Adam's read and write
    of the parameters and both moments, the activations written and read
    again; prefill: the parameters and the activations once, the cache
    written). Also the model FLOPs (``roofline.model_flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import rng as rng_lib
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import lm, stack
    from repro_torch.models.transformer.config import ShapeSpec

    plain = dataclasses.replace(cfg, remat=False)
    params = stack.init_params(rng_lib.key(0), plain, device="meta")
    tok = torch.zeros(batch, seq, dtype=torch.int32, device="meta")
    xs = lm.input_specs(plain, ShapeSpec(kind, seq, batch, kind))[
        "batch"].get("xsource")
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            flat = {k: v.requires_grad_()
                    for k, v in lm.flatten_params(params).items()}
            b = {"tokens": tok, "labels": tok}
            if xs is not None:
                b["xsource"] = xs
            loss = lm.loss_fn(lm.unflatten_params(flat, params), b, plain,
                              backend="eager")
            torch.autograd.grad(loss, list(flat.values()),
                                allow_unused=True)
        else:
            with torch.no_grad():
                stack.prefill(params, tok, plain, xsource=xs,
                              backend="eager")
    mult = 3.0 if kind == "train" else 1.0
    flops = fc.get_total_flops() - mult * _attention_excess(cfg, batch, seq)
    acct = dryrun.account(cfg, kind, batch, seq, opt_bytes=opt_bytes,
                          n_mb=n_mb)
    pb = acct["params"]
    if kind == "train":
        nbytes = (2 * pb + 2 * acct["grads"]
                  + 2 * (pb + acct["opt_state"]) + 2 * acct["activations"])
    else:
        nbytes = pb + acct["activations"] + acct["cache"]
    n = dryrun._param_count(cfg)
    return {"work": rl.Work(float(nbytes), float(flops)), "params": n,
            "model_flops": rl.model_flops(n, batch * seq,
                                          dryrun._active_frac(cfg.name, cfg),
                                          kind == "train"),
            "account": acct}


def _lm_run(cfg, kind, batch, seq, steps, seed, device):
    """``steps`` warm train steps (after one more) or prefills of ``cfg``
    from random weights of ``seed`` on the card: the warm seconds, one
    more under the profiler, the peak memory."""
    from repro_torch.core import rng as rng_lib
    from repro_torch.data.tokens import BigramStream
    from repro_torch.models.transformer import lm, stack
    from repro_torch.optim import adam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    params = stack.init_params(rng_lib.key(seed), cfg, device=device)
    toks, labels = BigramStream(cfg.vocab, seed=seed).batch(batch, seq,
                                                            device=device)
    if kind == "train":
        opt_cfg = adam.AdamConfig(lr=1e-3)
        opt = lm.init_opt_state(params, opt_cfg)
        step = lm.make_train_step(cfg, opt_cfg)
        b = {"tokens": toks, "labels": labels}

        def run(_i):
            return step(params, opt, b)[2]["loss"].item()
    else:
        def run(_i):
            with torch.no_grad():
                return stack.prefill(params, toks, cfg)

    run(0)
    torch.cuda.synchronize()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    window = profile_window(run, 1, share_of="flash")
    return {"seconds": sum(times) / len(times), "step_seconds": times,
            "profile": window,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}


def measure_lm(arch: str, shape: str, *, layers: Optional[int] = None,
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               n_mb: int = 1, device="cuda", cfg=None, measured=None,
               steps: int = 3, seed: int = 0) -> dict:
    """One train step (``shape`` of kind "train") or prefill of ``arch``
    (or ``cfg``) at full width, ``layers`` deep, ``batch`` x
    ``seq_len`` (the shape's by default): the counted work and model
    FLOPs (:func:`lm_counts`), the roofline terms against fp32 (TF32
    is off) and, on the card, the measured warm seconds, busy ms, idle
    share and peak. ``measured``: a run the caller already made
    (``seconds``, ``profile``, ``peak_memory_gib``), so none is added."""
    from repro_torch import configs as cfgreg
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer.config import shape_by_name

    require_card(device)
    cuda = torch.device(device).type == "cuda"
    spec = shape_by_name(shape)
    kind = "train" if spec.kind == "train" else "prefill"
    if cfg is None:
        cfg = cfgreg.get_config(arch, dtype="float32")
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
    batch = batch or spec.global_batch
    seq_len = seq_len or spec.seq_len
    counts = lm_counts(cfg, kind, batch, seq_len, n_mb=n_mb,
                       opt_bytes=2 if arch in dryrun.BIG_ARCHS else 4)
    if measured is None and cuda:
        measured = _lm_run(cfg, kind, batch, seq_len, steps, seed, device)
    seconds = measured["seconds"] if measured else None
    prof = (measured or {}).get("profile") or {}
    return {"cell": arch, "shape": shape, "kind": kind, "layers":
            cfg.num_layers, "batch": batch, "seq_len": seq_len,
            "microbatches": n_mb, "device": str(device),
            "card": card() if cuda else None, "params": counts["params"],
            "work": {"bytes": counts["work"].bytes,
                     "flops": counts["work"].flops},
            "account": counts["account"],
            **report(counts["work"], counts["model_flops"],
                     rl.CollectiveStats(), seconds),
            "warm_step_seconds": seconds,
            "device_busy_ms": prof.get("device_busy_ms_per_call"),
            "device_idle_share": prof.get("device_idle_share"),
            "peak_memory_gib": (measured or {}).get("peak_memory_gib")}


VARIANTS = {
    # labor-gcn: the paper's technique as a roofline lever
    ("gnn", "ns"): lambda **kw: measure_gnn("ns", **kw),
    ("gnn", "labor0"): lambda **kw: measure_gnn("labor-0", **kw),
    ("gnn", "labor_star"): lambda **kw: measure_gnn("labor-*", **kw),
    ("gnn", "labor0_int8"): lambda **kw: measure_gnn(
        "labor-0", compression="int8", world_size=2, **kw),
    ("gnn", "labor0_tightcaps"): lambda **kw: measure_gnn(
        "labor-0", cap_safety=1.2, **kw),
    # caps sized from each sampler's measured |V^3|
    ("gnn", "ns_provisioned"): lambda **kw: measure_gnn_provisioned(
        "ns", **kw),
    ("gnn", "labor0_provisioned"): lambda **kw: measure_gnn_provisioned(
        "labor-0", **kw),
    ("gnn", "laborstar_provisioned"): lambda **kw: measure_gnn_provisioned(
        "labor-*", **kw),
    # the LM side at chip_smoke's batch and depth: gemma2-2b's train step
    # (phase 7: 4 of 26 layers, 1 x 2,048), qwen3-moe's prefill (phase 8:
    # 1 of 94 layers, 1 x 4,096)
    ("gemma2", "train"): lambda **kw: measure_lm(
        "gemma2-2b", "train_4k", layers=4, batch=1, seq_len=2048, **kw),
    ("qwen3", "prefill"): lambda **kw: measure_lm(
        "qwen3-moe-235b-a22b", "prefill_32k", layers=1, batch=1,
        seq_len=4096, **kw),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True,
                    choices=sorted({c for c, _ in VARIANTS}))
    ap.add_argument("--variant", required=True, nargs="+",
                    help="one or more of the cell's variants, run in turn "
                         "in this process (the graph generated once)")
    ap.add_argument("--out", default="results/perf")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for variant in args.variant:
        if (args.cell, variant) not in VARIANTS:
            ap.error(f"no variant {(args.cell, variant)}; known: "
                     f"{sorted(VARIANTS)}")
    if args.device != "cpu" and not torch.cuda.is_available():
        print("repro_torch.launch.perf: no CUDA card (measurements run on "
              "the card; --device cpu gives the counts alone)")
        return 1
    os.makedirs(args.out, exist_ok=True)
    for variant in args.variant:
        t0 = time.time()
        terms = VARIANTS[(args.cell, variant)](device=args.device)
        terms["run_s"] = round(time.time() - t0, 1)
        with open(os.path.join(args.out, f"{args.cell}__{variant}.json"),
                  "w") as f:
            json.dump({k: v for k, v in terms.items()
                       if k not in ("step_records", "params")}, f,
                      indent=1, default=str)
        print(json.dumps({"variant": variant, **{k: terms.get(k) for k in (
            "card", "t_compute_s", "t_memory_s", "t_collective_s",
            "dominant", "mfu", "roofline_fraction", "warm_step_seconds",
            "peak_memory_gib")}}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
