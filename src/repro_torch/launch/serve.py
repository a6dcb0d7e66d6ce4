"""GNN serving on the card (twin of ``repro.launch.serve``, synchronous
path): a stream of seed requests over the validation ids, each answered
by one sample -> gather -> GCN forward through ``TrainEngine``, with
the overflow-retry contract and the same JSON report as the reference's
``--driver off``:

  PYTHONPATH=src python -m repro_torch.launch.serve --workload gnn \\
      --dataset products --scale 0.25 --sampler labor-0 \\
      --fanouts 10,10,10 --hidden 256 --batch 1024 --requests 8

``--sampler`` takes any registry entry (``--list-samplers``); the
default is the reference's ``full``, the exact full-neighbourhood
aggregation. ``--device cuda`` (the default) runs the CUDA kernels and
fails if there is no card; ``--device cpu`` runs the plain versions on
the CPU. The model's weights come from ``gcn_init(key(seed))``, the
reference's initialisation bit for bit, and the sampled sets for a
given ``--seed`` are the same. ``--driver async`` and ``--workload lm``
are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core import samplers
from repro_torch.core.interface import pad_seeds
from repro_torch.graph import paper_dataset
from repro_torch.models import gnn as gnn_models
from repro_torch.runtime.engine import TrainEngine
from repro_torch.serving.metrics import ServingStats


def build_gnn_serving(args, ds=None):
    """Dataset (``ds``, or built from the flags), model, engine and
    device-resident data of one run."""
    if ds is None:
        ds = paper_dataset(args.dataset, scale=args.scale, seed=args.seed)
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    n_cls = int(ds.labels.max()) + 1
    sampler = samplers.from_dataset(args.sampler, ds, batch_size=args.batch,
                                    fanouts=fanouts, safety=2.0)
    engine = TrainEngine(sampler, device=args.device)
    model = gnn_models.gcn_init(rng_lib.key(args.seed), ds.features.shape[1],
                                args.hidden, n_cls, len(fanouts),
                                device=engine.device)
    data = engine.make_data_from_dataset(ds)
    return ds, engine, data, model, np.asarray(ds.labels)


def gnn_trace(args, ds):
    """``--requests`` requests of one full batch of seeds each: a
    sequential scan of the validation ids (the reference's ``--trace
    scan``)."""
    idx = np.asarray(ds.val_idx)
    size = args.batch
    out = []
    for r in range(args.requests):
        lo = (r * size) % max(len(idx) - size, 1)
        out.append(idx[lo:lo + size])
    return out


def _accuracy(requests, answers, labels):
    correct = total = 0
    for seeds, logits in zip(requests, answers):
        pred = np.argmax(logits, -1)
        correct += int((pred == labels[seeds]).sum())
        total += len(seeds)
    return correct / max(total, 1)


def serve_gnn_sync(args, built=None):
    """One synchronous dispatch per request. The first request (kernel
    build on first use, device warm-up) and every grow retry are tagged
    set-up events, never folded into p50/p99. ``built`` reuses the
    output of :func:`build_gnn_serving`."""
    ds, engine, data, model, labels = built or build_gnn_serving(args)
    requests = gnn_trace(args, ds)
    stats = ServingStats()
    key = rng_lib.key(args.seed + 1)
    answers = []
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    for seeds_np in requests:
        stats.submitted += 1
        seeds = pad_seeds(seeds_np, args.batch, device=engine.device)
        key, sk = rng_lib.split(key)
        gen_before = engine.generation
        first = stats.batches == 0
        sync()
        t0 = time.perf_counter()
        logits, grows = engine.infer_with_retry(model, data, seeds, sk)
        logits = logits[:len(seeds_np)].cpu().numpy()
        dt = time.perf_counter() - t0
        stats.grow_events += grows
        stats.record_batch(
            dt, len(seeds_np), 1,
            compile_event=first or engine.generation != gen_before,
            grows=grows)
        stats.served += 1
        answers.append(logits)
    report = stats.report()
    report.update(sampler=engine.sampler.name, backend=engine.backend,
                  exact=engine.sampler.name == "full", driver="off",
                  requests=args.requests, request_size=args.batch,
                  batch=args.batch,
                  accuracy=round(_accuracy(requests, answers, labels), 4))
    print(json.dumps(report, indent=1))
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["lm", "gnn"], default="gnn")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch", type=int, default=1024,
                    help="the seed-buffer shape of one dispatch")
    ap.add_argument("--dataset", default="products")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--sampler", default="full",
                    type=samplers.sampler_arg_type,
                    help="any registered sampler; 'full' = exact "
                         "inference (see --list-samplers)")
    ap.add_argument("--list-samplers",
                    action=samplers.make_list_samplers_action(),
                    help="print the sampler registry and exit")
    ap.add_argument("--fanouts", default="10,10,10")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--driver", default="off", choices=["async", "off"])
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.workload != "gnn":
        sys.exit("repro_torch.launch.serve: --workload lm is not ported yet")
    if args.driver != "off":
        sys.exit("repro_torch.launch.serve: --driver async is not ported "
                 "yet; use --driver off")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but CUDA is not "
                           "available (use --device cpu)")
    # fp32 products stay fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return serve_gnn_sync(args)


if __name__ == "__main__":
    main()
