"""Serving on the card (twin of ``repro.launch.serve``).

GNN node classification (``--workload gnn``): a stream of seed requests
over the validation ids (``--request-size`` seeds each; a scan, or a
Zipfian draw with ``--trace zipf --zipf-a``), answered by sample ->
gather -> model forward through ``TrainEngine``, with the
overflow-retry contract and the reference's JSON report. By default
(``--driver async``) the requests go through the async serving driver
(``repro_torch.serving``): they are coalesced into one fixed-shape
``--batch``-seed dispatch, with optional device-resident feature and
hidden-state caches (``--feature-cache``, ``--hidden-cache``,
``--max-age``, ``--cache-policy``) and deadline accounting
(``--deadline-ms``, ``--max-queue``):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload gnn \\
      --dataset products --scale 0.25 --sampler labor-0 \\
      --fanouts 10,10,10 --hidden 256 --batch 1024 --requests 256 \\
      --request-size 64 --trace zipf --feature-cache 262144

``--driver off`` is the synchronous path: one dispatch per request,
each request padded to ``--batch``. ``--sampler`` takes any registry
entry (``--list-samplers``); the default is the reference's ``full``,
the exact full-neighbourhood aggregation. ``--device cuda`` (the
default) runs the CUDA kernels and fails if there is no card;
``--device cpu`` runs the plain versions on the CPU. ``--model`` takes
``gcn`` (the default), ``sage`` or ``gatv2``; its weights come from the
model's init at ``key(seed)``, the reference's initialisation bit for
bit, and the sampled sets for a given ``--seed`` are the same.
``--ckpt-dir`` serves the trained parameters of the directory's newest
verified checkpoint instead (one written by either package's trainer),
and ``--inject`` hands a fault plan (``runtime/inject.py``:
``stall_stage``, ``cache_corrupt``, ``pump_death``) to the async driver.

LM serving (``--workload lm``, the default workload, as in the
reference): greedy decode of a batch of random prompts from a model
with random weights, the reference's ``serve_lm``, at the full width of
``--arch`` (any registered one: gemma2-2b, stablelm-1.6b, mamba2-370m,
zamba2-2.7b, qwen3-moe-235b-a22b; or ``--reduce``d):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
      --arch gemma2-2b --batch 1 --prompt-len 32768 --gen 32

The weights come from ``init_params(key(seed))`` and the prompts from
``randint`` with the same key, as in the reference, both bit for bit;
so does a cross-attention config's source (``normal`` of (batch,
``xattn_source_len``, the encoder's width or ``xattn_source_dim``): the
stub frontend's frame or patch embeddings, which the encoder, if any,
runs over once in the prefill). The prefill runs every causal
self-attention layer through the flash kernel (B9) on ``cuda``
(zamba2's shared attention once per use; the encoder and the
cross-attention take the plain path, as in the reference); the
self-attention K/V caches are widened by ``--gen`` after it (the cross
K/V stay as the prefill left them), and Mamba2's conv and SSM states
carried from the prefill into each decode step. Prints the
reference's two lines (``prefill ... tok/s``, ``sample: [...]``).
"""
from __future__ import annotations

import argparse
import json
import os
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
    init = gnn_models.MODELS[args.model][0]
    model = init(rng_lib.key(args.seed), ds.features.shape[1], args.hidden,
                 n_cls, len(fanouts), device=engine.device)
    if args.ckpt_dir:
        from repro_torch.runtime import checkpoint as ckpt_lib
        last = ckpt_lib.latest_step(args.ckpt_dir)
        if last is not None:
            like = {"params": ckpt_lib.nest(
                {k: p.detach() for k, p in model.named_parameters()})}
            params = ckpt_lib.unnest(ckpt_lib.restore(
                args.ckpt_dir, last, like)["params"])
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(params[k])
    data = engine.make_data_from_dataset(ds)
    return ds, engine, data, model, np.asarray(ds.labels)


def gnn_trace(args, ds):
    """The request stream, the reference's ``_gnn_trace``: ``--requests``
    requests of ``--request-size`` seeds each (0: one full ``--batch``)
    over the validation ids, a sequential scan or a Zipfian draw
    (``--trace zipf``, exponent ``--zipf-a``) from numpy's generator at
    ``seed + 7``, so every request holds the reference's seeds."""
    idx = np.asarray(ds.val_idx)
    size = args.request_size or args.batch
    rng = np.random.default_rng(args.seed + 7)
    out = []
    for r in range(args.requests):
        if args.trace == "zipf":
            ranks = np.arange(1, len(idx) + 1, dtype=np.float64)
            p = ranks ** -args.zipf_a
            out.append(rng.choice(idx, size=size, p=p / p.sum()))
        else:
            lo = (r * size) % max(len(idx) - size, 1)
            out.append(idx[lo:lo + size])
    return out


def _accuracy(requests, answers, labels):
    correct = total = 0
    for seeds, logits in zip(requests, answers):
        if logits is None:
            continue
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
                  requests=args.requests,
                  request_size=args.request_size or args.batch,
                  batch=args.batch,
                  accuracy=round(_accuracy(requests, answers, labels), 4))
    print(json.dumps(report, indent=1))
    return report


def run_gnn_driver(args, built=None):
    """The async path up to its answers: every request of the trace
    submitted to a :class:`~repro_torch.serving.ServingDriver` (caches
    from the flags, batch keys from ``key(seed + 1)``), then drained.
    Returns (built, requests, driver, tickets)."""
    from repro_torch.runtime import inject as inject_lib
    from repro_torch.serving import HiddenCache, ServingDriver, VertexCache

    built = built or build_gnn_serving(args)
    ds, engine, data, model, _ = built
    requests = gnn_trace(args, ds)
    fc = (VertexCache(args.feature_cache, args.cache_policy)
          if args.feature_cache else None)
    hc = (HiddenCache(args.hidden_cache, max_age=args.max_age,
                      policy=args.cache_policy)
          if args.hidden_cache else None)
    # --inject and $REPRO_INJECT are joined, as in the train launcher
    inject_spec = ",".join(
        s for s in (os.environ.get(inject_lib.ENV_VAR), args.inject) if s)
    driver = ServingDriver(engine, model, data, batch_size=args.batch,
                           feature_cache=fc, hidden_cache=hc,
                           deadline_ms=args.deadline_ms,
                           max_queue=args.max_queue, seed=args.seed + 1,
                           inject=inject_lib.parse(inject_spec),
                           cache_fault_limit=args.cache_fault_limit)
    tickets = [driver.submit(r) for r in requests]
    driver.drain()
    return built, requests, driver, tickets


def driver_report(args, built, requests, driver, tickets) -> dict:
    """The reference's report of the async path."""
    engine, labels = built[1], built[4]
    report = driver.stats.report()
    report.update(sampler=engine.sampler.name, backend=engine.backend,
                  exact=engine.sampler.name == "full", driver="async",
                  requests=args.requests,
                  request_size=args.request_size or args.batch,
                  batch=args.batch,
                  accuracy=round(_accuracy(
                      requests, [t.logits if t.status == "ok" else None
                                 for t in tickets], labels), 4))
    return report


def serve_gnn_driver(args, built=None):
    """The async serving path: the requests stream into the serving
    driver, which coalesces them into the engine's fixed-shape dispatch
    and scatters the per-seed logits back, the caches exploiting the
    requests' skew. Prints and returns the reference's report."""
    report = driver_report(args, *run_gnn_driver(args, built))
    print(json.dumps(report, indent=1))
    return report


def build_lm(args, num_layers=None, cfg=None):
    """Config, weights and prompts of one LM serving run: the training
    launcher's ``build_lm`` (``cfg``: a config to use instead of
    ``--arch``'s) and the prompts from the same key, as the reference
    does."""
    from repro_torch.launch import train

    cfg, params = train.build_lm(args, num_layers, cfg)
    prompts = rng_lib.randint(rng_lib.key(args.seed),
                              (args.batch, args.prompt_len), 0, cfg.vocab,
                              device=args.device)
    return cfg, params, prompts


def source_frames(cfg, batch: int, seed: int, device):
    """The cross-attention source of a serving run, the reference's
    ``normal(key(seed), (batch, xattn_source_len, dim))`` with ``dim``
    the train launcher's ``source_dim``; None for a config without
    cross-attention."""
    from repro_torch.launch import train

    if not cfg.xattn_source_len:
        return None
    return rng_lib.normal(rng_lib.key(seed), (batch, cfg.xattn_source_len,
                                              train.source_dim(cfg)),
                          device=device)


def serve_lm(args, built=None):
    """Prefill the prompts (with :func:`source_frames` as the
    cross-attention source, if the config has one), widen the cache by
    ``--gen``, decode ``--gen`` greedy tokens (the first from the
    prefill's logits). Prints the reference's two lines and returns the
    run's numbers and tensors: the tokens (B, gen), the prefill's last
    logits, the final cache, and the host-clock seconds of the prefill
    and of the decode loop (each ending in a synchronise on the card)."""
    from repro_torch.models.transformer import lm, stack

    cfg, params, prompts = built or build_lm(args)
    B, P, G = args.batch, args.prompt_len, args.gen
    xsource = source_frames(cfg, B, args.seed, prompts.device)
    sync = (torch.cuda.synchronize if prompts.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    last_logits, cache = stack.prefill(params, prompts, cfg, xsource=xsource)
    del xsource
    cache = stack.widen_cache(cache, G)
    sync()
    t_prefill = time.perf_counter() - t0

    serve_step = lm.make_serve_step(cfg)
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(G - 1):
        nxt, cache = serve_step(params, cache, tok, P + i)
        tok = nxt[:, None]
        out.append(tok)
    toks = torch.cat(out, 1)
    sync()
    dt = time.perf_counter() - t0
    print(f"prefill {B}x{P} in {t_prefill:.2f}s; "
          f"decoded {B}x{G} in {dt:.2f}s "
          f"({B * (G - 1) / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", toks[0, :12].tolist())
    return {"tokens": toks, "last_logits": last_logits, "cache": cache,
            "prefill_s": t_prefill, "decode_s": dt}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", choices=["lm", "gnn"], default="lm")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch", type=int, default=4,
                    help="lm: the decode batch; gnn: the seed-buffer shape "
                         "of one dispatch (the coalescing target)")
    # lm
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--dataset", default="products")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--sampler", default="full",
                    type=samplers.sampler_arg_type,
                    help="any registered sampler; 'full' = exact "
                         "inference (see --list-samplers)")
    ap.add_argument("--list-samplers",
                    action=samplers.make_list_samplers_action(),
                    help="print the sampler registry and exit")
    ap.add_argument("--model", default="gcn",
                    choices=sorted(gnn_models.MODELS))
    ap.add_argument("--fanouts", default="10,10,10")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--request-size", type=int, default=0,
                    help="seeds per request, each padded to --batch (0 = "
                         "one full batch per request)")
    ap.add_argument("--trace", default="scan", choices=["scan", "zipf"],
                    help="request stream: sequential scan of the "
                         "validation ids, or a Zipfian draw")
    ap.add_argument("--zipf-a", type=float, default=1.1,
                    help="Zipf exponent of --trace zipf")
    ap.add_argument("--driver", default="async", choices=["async", "off"],
                    help="async = the continuous-batching request driver "
                         "(repro_torch.serving); off = one synchronous "
                         "dispatch per request")
    ap.add_argument("--feature-cache", type=int, default=0,
                    help="device-resident feature-cache slots (0 = off; "
                         "the logits are the same either way)")
    ap.add_argument("--hidden-cache", type=int, default=0,
                    help="stale hidden-state cache slots (0 = off)")
    ap.add_argument("--max-age", type=int, default=0,
                    help="hidden-cache staleness bound in serve steps "
                         "(0 = never served stale)")
    ap.add_argument("--cache-policy", default="fifo",
                    choices=["fifo", "freq"],
                    help="cache slot eviction policy")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline for timeout and SLO "
                         "accounting (async driver)")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="pending requests before admission refuses "
                         "(backpressure)")
    ap.add_argument("--cache-fault-limit", type=int, default=2,
                    help="non-finite-logit faults under an enabled cache "
                         "before the driver turns the caches off")
    ap.add_argument("--inject", default=None,
                    help="fault-injection plan for the async driver "
                         "(runtime/inject.py spec, e.g. "
                         "'stall_stage@2=0.05,cache_corrupt@3'); joined "
                         "to $REPRO_INJECT")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the parameters of this directory's newest "
                         "verified checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for but CUDA is not "
                           "available (use --device cpu)")
    # fp32 products stay fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.workload == "lm":
        return serve_lm(args)
    if args.driver == "async":
        return serve_gnn_driver(args)
    return serve_gnn_sync(args)


if __name__ == "__main__":
    main()
