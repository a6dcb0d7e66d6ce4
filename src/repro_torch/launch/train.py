"""GNN training on the card (twin of ``repro.launch.train``, ``--workload
gnn``): the paper's GCN, GraphSAGE or GATv2 (``--model``) trained on
sampled blocks with Adam, printing the reference launcher's JSON report.

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
reference's 256. ``--workload lm`` is not ported yet.

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
"""
from __future__ import annotations

import argparse
import json
import os
import sys

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
    ap.add_argument("--inject", default=None,
                    help="fault-injection plan (runtime/inject.py spec, "
                         "e.g. 'nan_grad@5,torn_ckpt@1'); joined to "
                         "$REPRO_INJECT")
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
                          inject=inject_lib.parse(inject_spec))


def train_report(ds, cfg):
    """Train, evaluate on the validation split; returns (the report,
    the output of ``train_gnn``)."""
    from repro_torch.runtime.trainer import evaluate_gnn, train_gnn
    out = train_gnn(ds, cfg)
    val = evaluate_gnn(ds, out["params"], cfg, ds.val_idx)
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


def main(argv=None):
    args = parser().parse_args(argv)
    if args.workload != "gnn":
        sys.exit("repro_torch.launch.train: --workload lm is not ported yet")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but CUDA is not "
                           "available (use --device cpu)")
    # fp32 products stay fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report, _ = train_report(dataset(args), config(args))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
