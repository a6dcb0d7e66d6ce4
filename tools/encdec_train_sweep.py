#!/usr/bin/env python3
"""How the encoder-decoder of ``chip_smoke.py``'s phase 9 (whisper-large-v3's
widths, ``chip_smoke.encdec_cfg``) trains in its first Adam steps, at
several depths and learning rates, from fresh copies of one draw of the
weights (``train.build_lm``, ``--seed``):

  python3 tools/encdec_train_sweep.py [--depths 8,16,32,64]
                                      [--lrs 1e-3,3e-4] [--seed 0]
                                      (on a CUDA card, from the root)

For each depth (decoder layer entries; the encoder cut to the same
fraction, as ``chip_smoke.cut_depth`` cuts it) and learning rate: the
losses of ``--steps`` steps of ``train_lm`` (4 x 448 bigram tokens, 1,500
random frames from ``serve.source_frames``, the batches of the stream of
``--seed``), their host-clock seconds, and batch 0's loss before and
after those steps; then, at the first learning rate, batch 0's loss
after 1, 2 and 3 Adam steps on batch 0 itself. Every line is one JSON
object; the first is the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="8,16,32,64")
    ap.add_argument("--lrs", default="1e-3,3e-4")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/encdec_train_sweep.py: no CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.data.tokens import BigramStream
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import lm
    from repro_torch.optim import adam

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    base = ["--workload", "lm", "--device", "cuda", "--batch", "4",
            "--seq", "448", "--steps", str(opts.steps), "--seed",
            str(opts.seed)]
    args = train.parser().parse_args(base)
    cfg, params = train.build_lm(args, cfg=chip_smoke.encdec_cfg())
    frames = serve.source_frames(cfg, 4, opts.seed, "cuda")
    toks, labels = BigramStream(cfg.vocab, seed=opts.seed).batch(
        4, 448, device="cuda")
    b0 = {"tokens": toks, "labels": labels, "xsource": frames}
    lrs = opts.lrs.split(",")
    for depth in (int(d) for d in opts.depths.split(",")):
        for lr in lrs:
            c, p = chip_smoke.cut_depth(cfg, params, depth)
            p = clone(p)
            with torch.no_grad():
                before = lm.loss_fn(p, b0, c).item()
            run = train.train_lm(train.parser().parse_args(
                base + ["--lr", lr]), (c, p), frames=frames)
            with torch.no_grad():
                after = lm.loss_fn(run["params"], b0, c).item()
            print(json.dumps({"depth": depth,
                              "encoder_layers": c.encoder.num_layers,
                              "lr": float(lr), "losses": run["losses"],
                              "step_seconds": run["step_seconds"],
                              "batch0_before_after": [before, after]}),
                  flush=True)
            del p, run
            torch.cuda.empty_cache()
        c, p = chip_smoke.cut_depth(cfg, params, depth)
        p = clone(p)
        opt_cfg = adam.AdamConfig(lr=float(lrs[0]))
        opt = lm.init_opt_state(p, opt_cfg)
        step = lm.make_train_step(c, opt_cfg)
        on_batch0 = []
        for _ in range(3):
            with torch.no_grad():
                on_batch0.append(lm.loss_fn(p, b0, c).item())
            p, opt, _ = step(p, opt, b0)
        with torch.no_grad():
            on_batch0.append(lm.loss_fn(p, b0, c).item())
        print(json.dumps({"depth": depth, "lr": float(lrs[0]),
                          "batch0_after_0_to_3_steps_on_it": on_batch0}),
              flush=True)
        del p, opt, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
