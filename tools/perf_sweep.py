#!/usr/bin/env python3
"""The one-card perf sweep: the autotune CLI (``--smoke``, then the
full grid), then every variant of
``repro_torch.launch.perf.VARIANTS`` through its CLI, one process a cell
(its variants in turn, the graph generated once), each reading the cache
the tuner wrote (a GNN variant's JSON carries the cache's fingerprint as
``frontier_tuning``), then one table.

  python3 tools/perf_sweep.py [--out chiprun_out/perf] [--only CELL/VARIANT ...]

Runs on the card only (the CLIs exit non-zero without one); ~15 min on
an H100, most of it the products graph generated again in each process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run(cmd, env):
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, capture_output=True, text=True)
    print(f"$ {' '.join(cmd)}  rc={p.returncode} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if p.returncode != 0:
        print(p.stdout[-3000:], p.stderr[-3000:], sep="\n", flush=True)
    return p


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/perf")
    ap.add_argument("--only", nargs="*", default=None,
                    help="CELL/VARIANT names (default: every variant)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.perf import VARIANTS

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cache = out / "frontier_autotune.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_AUTOTUNE_CACHE": str(cache)}
    smoke = run([sys.executable, "-m", "repro_torch.ops.autotune",
                 "--smoke", "--cache", str(out / "smoke_autotune.json")], env)
    print(smoke.stdout, flush=True)
    tune = run([sys.executable, "-m", "repro_torch.ops.autotune",
                "--cache", str(cache)], env)
    print(tune.stdout, flush=True)
    fingerprint = None
    for line in tune.stdout.splitlines():
        if line.startswith("round-trip:"):
            fingerprint = line.rsplit("fingerprint=", 1)[1]
    failed = smoke.returncode != 0 or tune.returncode != 0
    keys = [tuple(k.split("/")) for k in args.only] if args.only \
        else list(VARIANTS)
    cells = {}
    for cell, variant in keys:
        cells.setdefault(cell, []).append(variant)
    rows = []
    for cell, variants in cells.items():
        p = run([sys.executable, "-m", "repro_torch.launch.perf", "--cell",
                 cell, "--variant", *variants, "--out", str(out)], env)
        failed |= p.returncode != 0
        for variant in variants:
            path = out / f"{cell}__{variant}.json"
            if not path.exists():
                failed = True
                continue
            rec = json.loads(path.read_text())
            if ("frontier_tuning" in rec
                    and rec["frontier_tuning"] != fingerprint):
                print(f"{cell}/{variant}: read the cache "
                      f"{rec['frontier_tuning']}, the tuner wrote "
                      f"{fingerprint}", flush=True)
                failed = True
            rows.append({"cell": cell, "variant": variant, **{
                k: rec.get(k) for k in (
                    "card", "world_size", "warm_step_seconds", "t_compute_s",
                    "t_memory_s", "t_collective_s", "dominant", "mfu",
                    "roofline_fraction", "bound_share_of_measured",
                    "device_busy_ms", "device_idle_share", "peak_memory_gib",
                    "model_flops_geometry", "model_flops_total",
                    "frontier_tuning", "cap_safety", "sampled_v",
                    "replays")}})
    print(json.dumps({"autotune_fingerprint": fingerprint, "rows": rows}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
