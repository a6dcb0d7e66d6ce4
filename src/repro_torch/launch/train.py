"""Training on the card (twin of ``repro.launch.train``). ``--workload
gnn`` (the default): the paper's GCN, GraphSAGE or GATv2 (``--model``)
trained on sampled blocks with Adam, printing the reference launcher's
JSON report.

  PYTHONPATH=src python -m repro_torch.launch.train --workload gnn \\
      --dataset products --scale 0.25 --sampler labor-0 \\
      --fanouts 10,10,10 --batch-size 1024 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --list-samplers

``--sampler`` takes any registry entry (``ns``, ``labor-0``,
``labor-1``, ``labor-<i>``, ``labor-*``, ``labor-d``, ``ladies``,
``pladies``, ``full``); ``--layer-sizes`` sets the per-layer budgets of
``ladies``/``pladies`` (default batch size x fanout). ``--device cuda``
(the default) runs the CUDA kernels and fails if there is no card;
``--device cpu`` runs the plain versions on the CPU. With the same
``--seed`` the run starts from the reference's parameters and draws the
reference's batches and sampled sets. ``--model`` takes ``gcn`` (the
default), ``sage`` or ``gatv2`` (8 heads of 32); the hidden width is the
reference's 256.

``--workload lm``: any registered arch (``--arch``: gemma2-2b,
stablelm-1.6b, mamba2-370m, zamba2-2.7b, qwen3-moe-235b-a22b) at full
width, or shrunk with ``--reduce``, trained for ``--steps`` Adam steps
(lr ``--lr``, no schedule) on ``--batch`` x ``--seq`` tokens of the
reference's bigram stream, from ``init_params(key(seed))``; both bit for
bit the reference's. Prints ``step N loss`` every 10 steps and the
reference's final ``{"first_loss", "final_loss"}`` line:

  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
      --arch mamba2-370m --reduce --device cpu --steps 20 --batch 4 --seq 64

The reference's runtime flags: ``--ckpt-dir`` (resume from the newest
verified checkpoint, save every 100 steps and at the end; the format is
the reference's, so either package resumes the other's runs),
``--guard quarantine|rollback`` with ``--guard-warmup`` and
``--guard-spike-factor``, ``--inject`` (a fault plan, joined to
``$REPRO_INJECT``), ``--pipeline off|prefetch|full`` and
``--no-fused``:

  PYTHONPATH=src python -m repro_torch.launch.train --dataset products \
      --scale 0.25 --fanouts 10,10,10 --batch-size 1024 --steps 12 \
      --ckpt-dir ck --guard rollback --inject corrupt_feats@9=1e8 \
      --pipeline prefetch

``--mesh-devices N`` (N > 0) trains on the multi-device engine: the
launcher starts N ranks itself (one process each, a process group with
rendezvous on a free local port: NCCL on ``--device cuda``, rank r on
``cuda:r``; gloo on ``--device cpu``), each samples its partition of the
graph and they exchange features and gradients; ``--grad-compression
bf16|int8`` compresses the gradient all-reduce. ``--batch-size`` is the
global batch, divided over the ranks. Rank 0 prints the report, with
the same keys, and with the same ``--seed`` the same
``avg_sampled_vertices`` as the single-device run:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --dataset flickr --scale 0.02 --fanouts 5,5 --batch-size 128 \
      --steps 8 --seed 3 --mesh-devices 4
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.core import samplers
from repro_torch.models import gnn as gnn_models


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["gnn", "lm"], default="gnn")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dataset", default="products")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--sampler", default="labor-0",
                    type=samplers.sampler_arg_type,
                    help="any registered sampler (see --list-samplers)")
    ap.add_argument("--list-samplers",
                    action=samplers.make_list_samplers_action(),
                    help="print the sampler registry and exit")
    ap.add_argument("--model", default="gcn",
                    choices=sorted(gnn_models.MODELS))
    ap.add_argument("--fanouts", default="10,10,10")
    ap.add_argument("--layer-sizes", default=None,
                    help="comma-separated per-layer budgets for (p)ladies")
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the engine's gated step (--no-fused: the "
                         "unfused step after an eager sampling retry)")
    ap.add_argument("--pipeline", default="off",
                    choices=["off", "prefetch", "full"],
                    help="the pipelined driver (runtime/pipeline.py): "
                         "prefetch samples one batch ahead, full also "
                         "gathers one ahead")
    ap.add_argument("--guard", default="off",
                    choices=["off", "quarantine", "rollback"],
                    help="the guardrail: detect NaN/Inf and loss spikes "
                         "on the device (read one step late) and recover "
                         "by batch quarantine or checkpoint rollback")
    ap.add_argument("--guard-warmup", type=int, default=5,
                    help="clean batches before spike detection arms")
    ap.add_argument("--guard-spike-factor", type=float, default=4.0,
                    help="loss > factor x EMA flags a spike")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="> 0: train on the multi-device engine over this "
                         "many ranks, which the launcher starts (NCCL on "
                         "cuda, one card a rank; gloo on cpu)")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8"],
                    help="gradient all-reduce compression (mesh only)")
    ap.add_argument("--inject", default=None,
                    help="fault-injection plan (runtime/inject.py spec, "
                         "e.g. 'nan_grad@5,torn_ckpt@1'); joined to "
                         "$REPRO_INJECT")
    # lm
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduce", action="store_true",
                    help="shrink the arch for CPU-scale runs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def dataset(args):
    from repro_torch.graph import paper_dataset
    return paper_dataset(args.dataset, scale=args.scale, seed=args.seed)


def config(args):
    """The ``GNNTrainConfig`` the flags ask for."""
    from repro_torch.runtime import inject as inject_lib
    from repro_torch.runtime.trainer import GNNTrainConfig
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    layer_sizes = (tuple(int(x) for x in args.layer_sizes.split(","))
                   if args.layer_sizes else None)
    # --inject and $REPRO_INJECT are joined: the variable arms a whole
    # job, the flag one launch
    inject_spec = ",".join(
        s for s in (os.environ.get(inject_lib.ENV_VAR), args.inject) if s)
    return GNNTrainConfig(model=args.model, fanouts=fanouts,
                          sampler=args.sampler, layer_sizes=layer_sizes,
                          batch_size=args.batch_size, steps=args.steps,
                          lr=args.lr, seed=args.seed, device=args.device,
                          ckpt_dir=args.ckpt_dir, fused=args.fused,
                          pipeline=args.pipeline, guard=args.guard,
                          guard_warmup=args.guard_warmup,
                          guard_spike_factor=args.guard_spike_factor,
                          mesh_devices=args.mesh_devices,
                          grad_compression=args.grad_compression,
                          inject=inject_lib.parse(inject_spec))


def train_report(ds, cfg, evaluate: bool = True):
    """Train, evaluate on the validation split (unless ``evaluate`` is
    False: ``val_acc`` None); returns (the report, the output of
    ``train_gnn``)."""
    from repro_torch.runtime.trainer import evaluate_gnn, train_gnn
    out = train_gnn(ds, cfg)
    val = (evaluate_gnn(ds, out["params"], cfg, ds.val_idx) if evaluate
           else None)
    h = out["history"]
    report = {
        "final_loss": h[-1]["loss"], "val_acc": val,
        "wall_time_s": round(out["wall_time"], 1),
        "avg_sampled_vertices": sum(x["sampled_v"] for x in h) / len(h),
        "stragglers_skipped": out["stats"].stragglers_skipped,
        "overflow_retries": out["stats"].overflow_retries,
        "overflow_replays": out["stats"].overflow_replays,
    }
    if "guard_stats" in out:
        gs = out["guard_stats"]
        report.update(guard=cfg.guard, guard_quarantines=gs.quarantines,
                      guard_rollbacks=gs.rollbacks,
                      guard_nonfinite_batches=gs.nonfinite_batches,
                      guard_spike_batches=gs.spike_batches)
    if "inject_log" in out:
        report["inject_fired"] = [list(x) for x in out["inject_log"]]
    return report, out


def build_lm(args, num_layers=None, cfg=None):
    """Config and initial parameters of one LM run, training or serving
    (the reference's ``init_params(key(seed))``). ``cfg`` replaces
    ``--arch``'s registered config (an encoder-decoder built by the
    caller: no registered arch has one); ``num_layers`` cuts the depth
    (a multiple of the pattern) and keeps the width."""
    import dataclasses

    from repro_torch import configs as cfgreg
    from repro_torch.configs.reduce import reduce_cfg
    from repro_torch.core import rng as rng_lib
    from repro_torch.models.transformer import stack

    if cfg is None:
        cfg = cfgreg.get_config(args.arch, dtype="float32")
    if args.reduce:
        cfg = reduce_cfg(cfg)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg, stack.init_params(rng_lib.key(args.seed), cfg,
                                  device=args.device)


def train_lm(args, built=None, frames=None):
    """``--steps`` Adam steps of the LM from ``built`` (``build_lm``'s,
    updated in place) on the bigram stream of ``--seed``; a config with
    cross-attention gets ``frames`` as its source on every step, by
    default the reference's zeros of (batch, ``xattn_source_len``,
    :func:`source_dim`). Zero frames give a deep layernorm encoder a
    gradient that overflows (a zero-variance row's norm scales its
    gradient by 1/sqrt(eps), once a norm; ROADMAP C7), so a caller
    training an encoder of more than a few layers passes frames. Prints the
    reference's lines; returns the report with the run's losses, each
    step's host-clock seconds (each ends in the loss's read, a sync on
    the card), the parameters and the optimizer state."""
    from repro_torch.data.tokens import BigramStream
    from repro_torch.models.transformer import lm
    from repro_torch.optim import adam

    cfg, params = built or build_lm(args)
    opt_cfg = adam.AdamConfig(lr=args.lr)
    opt = lm.init_opt_state(params, opt_cfg)
    step = lm.make_train_step(cfg, opt_cfg)
    stream = BigramStream(cfg.vocab, seed=args.seed)
    extra = {}
    if cfg.xattn_source_len:
        extra["xsource"] = frames if frames is not None else torch.zeros(
            (args.batch, cfg.xattn_source_len, source_dim(cfg)),
            dtype=getattr(torch, cfg.dtype), device=args.device)
    losses, seconds = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        toks, labels = stream.batch(args.batch, args.seq, device=args.device)
        params, opt, m = step(params, opt, {"tokens": toks,
                                            "labels": labels, **extra})
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
        if (i + 1) % 10 == 0:
            print(f"step {i+1} loss {losses[-1]:.4f}")
    report = {"first_loss": losses[0], "final_loss": losses[-1]}
    print(json.dumps(report))
    return {**report, "losses": losses, "step_seconds": seconds,
            "params": params, "opt_state": opt}


def source_dim(cfg) -> int:
    """The width of a cross-attention config's source: the encoder's
    ``d_model`` (its input), else ``xattn_source_dim``, else
    ``d_model``."""
    if cfg.encoder is not None:
        return cfg.encoder.d_model
    return cfg.xattn_source_dim or cfg.d_model


def _no_tf32():
    # fp32 products stay fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_report(mesh, args):
    """One rank of ``--mesh-devices``: train; rank 0 evaluates, on its
    own device, and its report is the launcher's."""
    _no_tf32()
    cfg = config(args)
    if args.device == "cuda":
        import dataclasses
        cfg = dataclasses.replace(cfg, device=str(mesh.device))
    report, _ = train_report(dataset(args), cfg, evaluate=mesh.rank == 0)
    return report


def main(argv=None):
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but CUDA is not "
                           "available (use --device cpu)")
    _no_tf32()
    if args.workload == "lm":
        run = train_lm(args)
        return {k: run[k] for k in ("first_loss", "final_loss")}
    if args.mesh_devices:
        from repro_torch.launch.mesh import spawn
        report = spawn(_rank_report, args.mesh_devices, args,
                       device=args.device)
    else:
        report, _ = train_report(dataset(args), config(args))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
