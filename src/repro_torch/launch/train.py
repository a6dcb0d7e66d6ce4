"""GNN training on the card (twin of ``repro.launch.train``, ``--workload
gnn``): the paper's GCN trained on sampled blocks with Adam, printing
the reference launcher's JSON report.

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
reference's batches and sampled sets. The hidden width is the
reference's 256. ``--workload lm`` is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.core import samplers


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
    ap.add_argument("--model", default="gcn", choices=["gcn"])
    ap.add_argument("--fanouts", default="10,10,10")
    ap.add_argument("--layer-sizes", default=None,
                    help="comma-separated per-layer budgets for (p)ladies")
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def dataset(args):
    from repro_torch.graph import paper_dataset
    return paper_dataset(args.dataset, scale=args.scale, seed=args.seed)


def config(args):
    """The ``GNNTrainConfig`` the flags ask for."""
    from repro_torch.runtime.trainer import GNNTrainConfig
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    layer_sizes = (tuple(int(x) for x in args.layer_sizes.split(","))
                   if args.layer_sizes else None)
    return GNNTrainConfig(model=args.model, fanouts=fanouts,
                          sampler=args.sampler, layer_sizes=layer_sizes,
                          batch_size=args.batch_size, steps=args.steps,
                          lr=args.lr, seed=args.seed, device=args.device)


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
