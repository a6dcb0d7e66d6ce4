#!/usr/bin/env python3
"""B9 (``kernels/flash_attention``) timed on the six real calls that
``chip_smoke.py::flash_check`` times, for several source trees in turn on
one card:

  gemma2-2b  local and global layer: 1 x 32,768, GQA 8/4, hd 256,
             softcap 50, window 4,096 (local) or none
  stablelm-1.6b: 4 x 4,096, MHA 32 x 64
  zamba2-2.7b:   1 x 8,192, MHA 32 x 80
  qwen3-moe:     1 x 4,096, GQA 64/4, hd 128
  whisper-large-v3 (decoder self-attention): 4 x 416, MHA 20 x 64

all causal fp32, q, k and v from ``torch.randn`` with a fixed seed, the
same in every tree.

  python3 tools/flash_sweep.py [--tree NAME=DIR ...] [--variant NAME ...]
      [--reps N] [--calls gemma2-global,whisper] [--profile]

Each tree is a checkout's root (``DIR/src/repro_torch``); the default is
this repository as ``change``. To compare with a parent commit, unpack it
into a directory ``.gitignore`` lists and name it first::

  mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
  python3 tools/flash_sweep.py --tree parent=build/parent --tree change=.

Every tree runs in a child process of its own (its kernels built from its
own sources into its own ``build/kernels``), twice, in the order A B ..
.. B A, so that a drift of the card's clocks shows as a difference
between a tree's two rounds. A child warms each call once, then times
``--reps`` back-to-back calls with CUDA events (the time a call holds the
card when calls queue up; the host's time to enqueue one, ``enqueue_ms``,
beside it: where it is the larger, the events time the host), and holds the last 256 queries' rows to the
plain version (fp32: 2e-5 x max(1, max|v|)). ``--profile`` adds each
kernel's device time in one call by name (torch.profiler). One JSON line
per (tree, round, call), then a summary line per call.

``--variant NAME`` adds a tree: a copy of this repository's ``src`` under
``build/flash_sweep/NAME`` with :data:`VARIANTS`' edits to
``csrc/flash_attention.cu`` and ``kernels/flash_attention/ops.py``. The
ones marked inexact skip work to split the kernel's time, and give wrong
outputs (their error is printed, not held to the tolerance):

  half_bytes   fp32 K and V slabs carry only the big part (the small
               products read it again): what the split's extra bytes cost
  no_pingpong  (exact) two consumer warpgroups start Q K^T when their
               slab arrives, without taking turns
  no_softmax   P = the raw scores, no max, exp, rescale or row sum: what
               the softmax costs between the products
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "src/repro_torch/csrc/flash_attention.cu"
OPS = "src/repro_torch/kernels/flash_attention/ops.py"

#: name -> (exact, [(file, old, new), ...]); a regex ``old`` starts "re:"
VARIANTS = {
    "half_bytes": (False, [
        (CU, "mbar_expect_tx(full(slab), G::SLAB);",
         "mbar_expect_tx(full(slab), G::SLAB_PART);"),
        (CU, "            for (int part = 0; part < G::PARTS; ++part) {",
         "            for (int part = 0; part < 1; ++part) {"),
        (CU, "make_desc(ka + G::SLAB_PART, SW)", "make_desc(ka, SW)"),
        (CU, "make_desc(va + G::SLAB_PART, 128)", "make_desc(va, 128)"),
    ]),
    "no_pingpong": (True, [
        (CU, "    if constexpr (G::C == 2) named_sync(1 + w, 256);\n", ""),
        (CU, "    if constexpr (G::C == 2)\n      if (w == 0 || kb + 1 < kb_end)"
         " named_arrive(2 - w, 256);\n", ""),
        (CU, "  if constexpr (G::C == 2)\n    if (w == 1) named_arrive(1, 256);\n",
         ""),
    ]),
    "no_softmax": (False, [
        (CU, r"re:    float alpha\[2\];\n.*?(    // ---- P as wgmma)",
         "    const float alpha[2] = {1.f, 1.f};\n    l[0] += 1.f;\n"
         "    l[1] += 1.f;\n\\1"),
    ]),
}

#: name -> (B, S, Hq, Hkv, hd, window, softcap)
CALLS = {
    "gemma2-local": (1, 32768, 8, 4, 256, 4096, 50.0),
    "gemma2-global": (1, 32768, 8, 4, 256, None, 50.0),
    "stablelm": (4, 4096, 32, 32, 64, None, None),
    "zamba2": (1, 8192, 32, 32, 80, None, None),
    "qwen3-moe": (1, 4096, 64, 4, 128, None, None),
    "whisper": (4, 416, 20, 20, 64, None, None),
}


def make_variant(name):
    """A copy of this tree's ``src`` with the variant's edits; returns its
    root."""
    import re
    import shutil
    root = ROOT / "build" / "flash_sweep" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, old, new in VARIANTS[name][1]:
        f = root / path
        text = f.read_text()
        if old.startswith("re:"):
            edited = re.sub(old[3:], new, text, count=1, flags=re.S)
        else:
            edited = text.replace(old, new)
        if edited == text:
            sys.exit(f"flash_sweep: variant {name} does not apply to {path}")
        f.write_text(edited)
    return root


def child(tree, calls, reps, profile):
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import time

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fr
    t0 = time.perf_counter()
    _build.library("flash_attention")
    build_s = time.perf_counter() - t0
    out = []
    for name in calls:
        B, S, Hq, Hkv, hd, window, softcap = CALLS[name]
        g = torch.Generator(device="cuda").manual_seed(11)
        q = torch.randn(B, S, Hq, hd, generator=g, device="cuda")
        k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda")
        v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda")

        def call():
            return fa.flash_attention_fwd(q, k, v, True, window, softcap,
                                          None)

        got = call()
        lo = max(0, S - 256)
        want = fr.attention_ref(q[:, lo:], k, v, window=window,
                                softcap=softcap, q_offset=lo)
        err = (got[:, lo:] - want).abs().max().item()
        tol = 2e-5 * max(1.0, v.abs().max().item())
        del got, want
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
        e1.record()
        torch.cuda.synchronize()
        rec = {"call": name, "ms": e0.elapsed_time(e1) / reps,
               "enqueue_ms": enqueue_ms,
               "max_abs_err": err, "tolerance": tol, "ok": err <= tol,
               "build_s": build_s}
        if profile:
            from torch.profiler import ProfilerActivity, profile as prof
            with prof(activities=[ProfilerActivity.CUDA]) as p:
                call()
                torch.cuda.synchronize()
            rec["device_ms_by_kernel"] = {
                e.key[:60]: e.device_time_total / 1e3
                for e in p.key_averages() if e.device_time_total > 0}
        out.append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout's root (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", default=",".join(CALLS))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    calls = [c for c in a.calls.split(",") if c]
    if a.child:
        child(a.child, calls, a.reps, a.profile)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_sweep: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    trees = [t.split("=", 1) for t in (a.tree or [f"change={ROOT}"])]
    trees += [[v, str(make_variant(v))] for v in a.variant]
    inexact = {v for v in a.variant if not VARIANTS[v][0]}
    order = trees + trees[::-1]
    times = {}
    for rnd, (name, d) in enumerate(order):
        cmd = [sys.executable, __file__, "--child", d, "--reps",
               str(a.reps), "--calls", ",".join(calls)]
        if a.profile:
            cmd.append("--profile")
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONPATH=""))
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if r.returncode != 0 or not lines:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            sys.exit(f"flash_sweep: tree {name} failed")
        for rec in json.loads(lines[-1][7:]):
            print(json.dumps({"tree": name, "round": rnd, **rec}),
                  flush=True)
            times.setdefault(rec["call"], {}).setdefault(name, []).append(
                rec["ms"])
            if not rec["ok"] and name not in inexact:
                sys.exit(f"flash_sweep: {name} {rec['call']} wrong")
    for call, by in times.items():
        print(json.dumps({"summary": call, "card": card, "ms": by}),
              flush=True)


if __name__ == "__main__":
    main()
