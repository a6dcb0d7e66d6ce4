"""What a cell needs on one card: a memory account against 80 GB (twin of
``repro.launch.dryrun``).

The reference lowers and compiles every (arch x shape) cell on 256- and
512-chip meshes and reads XLA's memory and cost analysis. On one card
the port counts instead, from shapes on the ``meta`` device (nothing is
allocated, nothing runs on a device, so it runs on any host): the
parameters, their gradients and Adam's two moments (bf16 for
``BIG_ARCHS``, as the reference), the activations of one microbatch (the
reference's ``act_bytes`` model at TP 1) and the decode cache. It says
whether the cell fits and, if not, the largest divisor of its batch and
the largest depth that do, beside the cell's ``model_flops`` and its
roofline lower bound.

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import torch

from repro_torch import configs as cfgreg
from repro_torch.configs.labor_gcn import GNNWorkloadConfig
from repro_torch.launch import roofline as rl
from repro_torch.models.transformer import lm, stack
from repro_torch.models.transformer.config import ShapeSpec, shape_by_name

BIG_ARCHS = {"qwen3-moe-235b-a22b"}  # bf16 optimizer state, as the reference

#: one H100's device memory
CARD_BYTES = 80 * 10**9
#: the reference's budget under a 16 GiB chip (``microbatches_for``)
REPRO_HBM_BUDGET = 14 * 2**30


def _meta_params(cfg):
    from repro_torch.core import rng as rng_lib
    return lm.flatten_params(stack.init_params(rng_lib.key(0), cfg,
                                               device="meta"))


def _param_count(cfg) -> float:
    """The parameters of ``cfg`` (``init_params`` on the ``meta``
    device)."""
    return param_counts(cfg)[0]


def param_counts(cfg):
    """(parameters, their bytes) of ``cfg``, from one ``meta`` init."""
    ts = _meta_params(cfg).values()
    return (float(sum(t.numel() for t in ts)),
            float(sum(t.numel() * t.element_size() for t in ts)))


def _by_depth(cfg):
    """``reps -> (parameters, bytes)`` of ``cfg`` cut to ``reps``
    repeats of its pattern: two ``meta`` inits (1 and 2 repeats),
    extrapolated (``roofline.extrapolate_depth``: exact, every repeat
    holds the same tensors)."""
    pat = len(cfg.layer_pattern)
    one = param_counts(dataclasses.replace(cfg, num_layers=pat))
    two = param_counts(dataclasses.replace(cfg, num_layers=2 * pat))
    return lambda reps: tuple(rl.extrapolate_depth(a, b, reps)
                              for a, b in zip(one, two))


def _active_frac(arch: str, cfg) -> float:
    """Active over total parameters: an MoE's experts count top_k /
    num_experts of theirs (the model FLOPs' N)."""
    if isinstance(cfg, GNNWorkloadConfig) or getattr(cfg, "moe", None) is None:
        return 1.0
    m = cfg.moe
    total = active = 0.0
    for path, t in _meta_params(cfg).items():
        n = float(t.numel())
        total += n
        names = path.split("/")
        if t.ndim >= 3 and t.shape[-3] == m.num_experts and any(
                nm in ("ewi", "ewg", "ewo") for nm in names):
            active += n * m.top_k / m.num_experts
        else:
            active += n
    return active / total


def act_bytes(cfg, tokens: float, tp: int = 1, esize: int = 2) -> float:
    """The reference's activation model for ``tokens`` tokens a device:
    the repeats' carries (``esize`` bytes), the logits' value and
    cotangent in fp32 over ``vocab / tp``, an MoE's three dispatch
    buffers."""
    b = cfg.repeats * tokens * cfg.d_model * esize
    b += tokens * cfg.vocab / tp * 4 * 2
    if cfg.moe is not None:
        b += tokens * cfg.moe.top_k * cfg.moe.capacity_factor * cfg.d_model \
            * esize * 3
    return b


def microbatches_for(cfg, shape, dp, chips=1, n_params=0.0, opt_bytes=4, *,
                     budget: float = CARD_BYTES, tp: int = 1) -> int:
    """The smallest microbatch count whose activations fit ``budget``
    next to the fully sharded state (the reference's rule; with its
    ``REPRO_HBM_BUDGET`` and ``tp=16`` its answers, by default one card's
    80 GB at TP 1)."""
    tokens_dev = shape.global_batch * shape.seq_len // max(dp, 1)
    state_dev = n_params * (2 + 2 + 2 * opt_bytes) / max(chips, 1)
    room = max((budget - state_dev) * 0.6, 2 * 2**30)
    for n_mb in sorted({d for d in range(1, shape.global_batch + 1)
                        if shape.global_batch % d == 0}):
        if act_bytes(cfg, tokens_dev / n_mb, tp) < room:
            return n_mb
    return shape.global_batch


def _cache_bytes(cfg, batch: int, seq: int) -> float:
    cache = lm.cache_specs(cfg, ShapeSpec("decode", seq, batch, "decode"))
    return float(sum(t.numel() * t.element_size()
                     for entry in cache for t in entry.values()))


def account(cfg, kind: str, batch: int, seq: int, *, opt_bytes: int = 4,
            n_mb: int = 1, counts: Optional[tuple] = None) -> dict:
    """Bytes a cell holds on one card. ``kind``: "train" (parameters,
    gradients in the parameters' dtype, two Adam moments of
    ``opt_bytes``, one microbatch's activations), "prefill" (parameters,
    the cache of ``seq`` positions, the forward's carries and the last
    position's logits) or "decode" (parameters, the cache, a step's
    logits). ``resident`` is what stays for the whole run: the
    parameters, and the optimizer state or the cache where the path
    holds them. ``counts``: :func:`param_counts` of ``cfg``, if known."""
    esize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    n, pb = counts or param_counts(cfg)
    out = {"params": pb, "grads": 0.0, "opt_state": 0.0, "cache": 0.0,
           "activations": 0.0}
    if kind == "train":
        out["grads"] = pb
        out["opt_state"] = 2.0 * n * opt_bytes
        out["activations"] = act_bytes(cfg, batch * seq / n_mb, 1, esize)
    else:
        out["cache"] = _cache_bytes(cfg, batch, seq)
        out["activations"] = (cfg.repeats * batch * seq * cfg.d_model * esize
                              if kind == "prefill" else 0.0) \
            + batch * cfg.vocab * 4
    out["resident"] = out["params"] + out["opt_state"] + out["cache"]
    out["total"] = sum(out[k] for k in ("params", "grads", "opt_state",
                                        "cache", "activations"))
    return out


def gnn_geometry_flops(cfg: GNNWorkloadConfig, local_batch: int,
                       num_devices: int) -> float:
    """The reference's labor-gcn model FLOPs (``lower_gnn_cell``): each
    layer's vertices from the fanout geometry, |V^{l+1}| = |V^l| (1 +
    min(fanout, avg degree)) with no deduplication, times the two dense
    products of each layer, times 3 for the backward. It counts ~4x the
    vertices LABOR-0 samples; kept under its own name."""
    lb = local_batch * num_devices
    sizes = [lb]
    for k in cfg.fanouts:
        sizes.append(sizes[-1] * (1 + min(k, cfg.avg_degree)))
    dims = [cfg.feature_dim] + [cfg.hidden] * (cfg.num_layers - 1) \
        + [cfg.num_classes]
    mf = 0.0
    for layer in range(cfg.num_layers):
        mf += 2 * sizes[cfg.num_layers - 1 - layer] * dims[layer] \
            * dims[layer + 1] * 2
    return mf * 3


def lm_cell(arch: str, shape_name: str, dtype: str = "bfloat16",
            budget: float = CARD_BYTES) -> dict:
    cfg = cfgreg.get_config(arch, dtype=dtype)
    shape = shape_by_name(shape_name)
    opt_bytes = 2 if arch in BIG_ARCHS else 4
    B, S = shape.global_batch, shape.seq_len
    depth = _by_depth(cfg)
    counts = depth(cfg.repeats)
    n = counts[0]
    n_mb = (microbatches_for(cfg, shape, 1, n_params=n, opt_bytes=opt_bytes,
                             budget=budget)
            if shape.kind == "train" else 1)

    def total(c, batch, reps):
        return account(c, shape.kind, batch, S, opt_bytes=opt_bytes,
                       n_mb=n_mb if batch == B else 1,
                       counts=depth(reps))["total"]

    acct = account(cfg, shape.kind, B, S, opt_bytes=opt_bytes, n_mb=n_mb,
                   counts=counts)
    fits = acct["total"] <= budget
    fit_batch = fit_layers = None
    if not fits:
        fit_batch = max((d for d in range(1, B + 1) if B % d == 0
                         and total(cfg, d, cfg.repeats) <= budget),
                        default=0)
        pat = len(cfg.layer_pattern)
        for reps in range(cfg.repeats, 0, -1):
            cut = dataclasses.replace(cfg, num_layers=reps * pat)
            if total(cut, max(fit_batch, 1), reps) <= budget:
                fit_layers = reps * pat
                break
    is_train = shape.kind == "train"
    tokens = B * S if shape.kind != "decode" else B
    mf = rl.model_flops(n, tokens, _active_frac(arch, cfg), is_train)
    peak = "bf16" if cfg.dtype == "bfloat16" else "fp32"
    terms = rl.roofline_terms(mf, acct["total"], 0.0,
                              model_flops_total=mf, peak=peak)
    return {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "dtype": cfg.dtype, "batch": B, "seq_len": S, "params": n,
            "microbatches": n_mb,
            "active_frac": _active_frac(arch, cfg), "account": acct,
            "budget": budget, "fits": fits, "fit_batch": fit_batch,
            "fit_layers": fit_layers, "layers": cfg.num_layers,
            "model_flops": mf, "roofline": terms}


def gnn_cell(arch: str = "labor-gcn", budget: float = CARD_BYTES) -> dict:
    """labor-gcn on one card: the graph (int64 row pointers, int32
    column indices), fp32 features and int32 labels, the model and its
    Adam state, and each layer's hidden rows at the sampler's vertex
    caps (forward value and gradient) at the global batch."""
    from repro_torch.core import samplers as sampler_registry

    cfg = cfgreg.get_config(arch)
    V, E = cfg.num_vertices, int(cfg.num_vertices * cfg.avg_degree)
    sampler = sampler_registry.from_graph_stats(
        cfg.sampler, batch_size=cfg.global_batch, fanouts=cfg.fanouts,
        avg_degree=cfg.avg_degree,
        max_degree=int(min(cfg.avg_degree * 64, V - 1)), num_vertices=V,
        num_edges=E, safety=cfg.cap_safety)
    dims = [cfg.feature_dim] + [cfg.hidden] * (cfg.num_layers - 1) \
        + [cfg.num_classes]
    n = sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))
    caps = [c.vertex_cap for c in sampler.caps]
    acct = {"graph": (V + 1) * 8.0 + E * 4.0,
            "features": V * cfg.feature_dim * 4.0 + V * 4.0,
            "params": n * 4.0, "opt_state": n * 8.0,
            "activations": sum(c * w * 4.0 * 2 for c, w in
                               zip(caps, reversed(dims[:-1])))}
    acct["resident"] = sum(acct[k] for k in ("graph", "features", "params",
                                             "opt_state"))
    acct["total"] = acct["resident"] + acct["activations"]
    mf = gnn_geometry_flops(cfg, cfg.global_batch, 1)
    return {"arch": arch, "shape": "train_batch", "kind": "train",
            "batch": cfg.global_batch, "params": n, "account": acct,
            "budget": budget, "fits": acct["total"] <= budget,
            "model_flops_geometry": mf,
            "roofline": rl.roofline_terms(mf, acct["total"], 0.0,
                                          model_flops_total=mf)}


def run_cell(arch: str, shape_name: str = "train_4k", out_dir=None,
             verbose: bool = True, dtype: str = "bfloat16") -> dict:
    """One cell's account (a GNN arch's ``train_batch``), printed and
    written to ``out_dir`` as JSON."""
    if arch in cfgreg.GNN_ARCHS:
        rec = gnn_cell(arch)
    else:
        rec = lm_cell(arch, shape_name, dtype)
    if verbose:
        a = rec["account"]
        print(f"[{arch} x {rec['shape']}] "
              f"{'fits' if rec['fits'] else 'does not fit'}: "
              f"{a['total'] / 2**30:.2f} GiB of {rec['budget'] / 2**30:.2f} "
              f"(resident {a['resident'] / 2**30:.2f}); "
              f"bound {rec['roofline']['step_time_lower_bound_s']:.4g} s "
              f"({rec['roofline']['dominant']})"
              + ("" if rec["fits"] or "fit_batch" not in rec else
                 f"; fits at batch {rec['fit_batch']}, depth "
                 f"{rec['fit_layers']}"))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{rec['shape']}__one_card.json".replace("/", "_")
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--all", action="store_true",
                    help="every registered LM cell and labor-gcn")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, c["shape"]) for a, c in cfgreg.all_lm_cells()
                 if c["run"]] + [("labor-gcn", "train_batch")]
    elif args.arch:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch or --all")
    recs = [run_cell(a, s, args.out, dtype=args.dtype) for a, s in cells]
    print(f"\n{sum(r['fits'] for r in recs)}/{len(recs)} cells fit one card")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
