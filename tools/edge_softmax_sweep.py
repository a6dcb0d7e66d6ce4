#!/usr/bin/env python3
"""Where the edge softmax's time goes (B8, ``csrc/edge_softmax.cu``), on
synthetic versions of the three GATv2 calls of a products-0.25 LABOR-0
batch (rows of Poisson(10) edges, dst-sorted, the rest of the edge cap
padding):

  layer 2: 86,803 rows of seed cap 470,656, edge cap 9,426,304, H = 8
  layer 1: 10,966 rows of seed cap 22,272, edge cap 448,384, H = 8
  layer 0: 1,024 rows of seed cap 1,024, edge cap 21,248, H = 1

  python3 tools/edge_softmax_sweep.py [--source PATH ...] [--rounds 5]
                                      (on a CUDA card, from the root)

Each ``--source`` (default: the package's ``csrc/edge_softmax.cu``; give
an older tree's copy to compare two versions in one run) is built with
nvcc into ``build/sweep`` as ``kernels/_build.py`` builds the package's,
and held to the plain version (``kernels/edge_softmax/ref.py``) at
every layer to 1e-6, and to itself bit for bit over two calls.

Part 1 splits each source's layer-2 call: the whole call, the live
prefix alone (the first n edges as the whole edge array, so nothing is
padding), the padding alone (``n_live`` = 0), and two probes built from
strings: one float4 streaming fill of the padded entries [n H, E H) (the
least the padding can cost), and a per-entry fill over all E H entries
that divides by H and reads the dst slot of each live edge (the fill
loop of a per-(row, head) design). Part 2 times the sources in turn, ROUNDS
rounds, each call's device ms from torch.profiler (over 20 calls) and
its CUDA-event ms. Every line is one JSON object; the first is the
card's name and power limit.
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.edge_softmax import ref as er  # noqa: E402

DEV = "cuda"
OUT = ROOT / "build" / "sweep"
REPS = 20

PROBES = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stream_fill(float* p, long a, long b) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nthreads = (long)gridDim.x * blockDim.x;
  long a4 = a + (long)(((16 - ((uintptr_t)(p + a) & 15)) & 15) >> 2);
  if (a4 > b) a4 = b;
  const long b4 = a4 + ((b - a4) & ~3L);
  if (tid < a4 - a) __stcs(p + a + tid, 0.f);
  for (long i = a4 + 4 * tid; i < b4; i += 4 * nthreads)
    __stcs((float4*)(p + i), make_float4(0.f, 0.f, 0.f, 0.f));
  if (tid < b - b4) __stcs(p + b4 + tid, 0.f);
}

__global__ void entry_fill(const int* dst, int E, const int* n_live, int H,
                           int S, float* alpha) {
  const int n = *n_live;
  const long items = (long)E * H;
  for (long j = (long)blockIdx.x * blockDim.x + threadIdx.x; j < items;
       j += (long)gridDim.x * blockDim.x) {
    const long e = j / H;
    if (e >= n) {
      alpha[j] = 0.f;
    } else {
      const int d = dst[e];
      if (d < 0 || d >= S) alpha[j] = 0.f;
    }
  }
}

extern "C" int probe_stream_fill(float* p, long a, long b, void* stream) {
  stream_fill<<<132 * 4, 256, 0, (cudaStream_t)stream>>>(p, a, b);
  return (int)cudaGetLastError();
}

extern "C" int probe_entry_fill(const int* dst, int E, const int* n_live,
                                int H, int S, float* alpha, void* stream) {
  long blocks = ((long)E * H + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  entry_fill<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      dst, E, n_live, H, S, alpha);
  return (int)cudaGetLastError();
}
"""


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(sources):
    """{label: ctypes function} of each source's ``edge_softmax``, and the
    probes' library; every nvcc started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    probe_cu = OUT / "probes.cu"
    probe_cu.write_text(PROBES)
    jobs = {}
    for label, path in list(sources.items()) + [("probes", probe_cu)]:
        digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()[:16]
        so = OUT / f"edge_softmax_{digest}.so"
        cmd = [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(so), str(path)]
        jobs[label] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {label}:\n{log}")
        emit({"build": label, "ptxas": [ln.strip() for ln in log.splitlines()
                                        if "registers" in ln
                                        or "spill" in ln]})
        libs[label] = ctypes.CDLL(str(so))
    fns = {}
    for label in sources:
        f = libs[label].edge_softmax
        f.argtypes = _build.SIGNATURES["edge_softmax"][1]
        fns[label] = f
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    libs["probes"].probe_stream_fill.argtypes = [P, L, L, P]
    libs["probes"].probe_entry_fill.argtypes = [P, I, P, I, I, P, P]
    return fns, libs["probes"]


def layer(g, rows, S, E, H):
    lens = torch.poisson(torch.full((rows,), 10.0, device=DEV),
                         generator=g).long()
    n = int(lens.sum())
    dst = torch.full((E,), -1, dtype=torch.int32, device=DEV)
    dst[:n] = torch.repeat_interleave(
        torch.arange(rows, device=DEV, dtype=torch.int32), lens)
    mask = torch.arange(E, device=DEV) < n
    logits = torch.randn(E, H, generator=g, device=DEV) * 3
    live = torch.tensor(n, dtype=torch.int32, device=DEV)
    return dict(dst=dst, mask=mask, logits=logits, live=live, S=S, n=n,
                rows=rows)


def caller(f, c, E=None, live=None):
    """A call of one source's kernel on layer ``c`` (the first ``E``
    edges; ``live``: the n_live tensor) and its output."""
    E = c["dst"].shape[0] if E is None else E
    H = c["logits"].shape[1]
    live = c["live"] if live is None else live
    out = torch.empty(E, H, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(f(c["dst"].data_ptr(), c["mask"].data_ptr(), E,
                       live.data_ptr(), c["logits"].data_ptr(), H, c["S"],
                       out.data_ptr(), stream), "edge_softmax")
    return call, out


def event_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=REPS):
    """torch.profiler: the device time of the call's own device
    operations per call, and their count per call (None: not seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", None)
             or e.self_cuda_time_total, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not rows:
        return None, None
    return (sum(r[0] for r in rows) / 1e3 / reps,
            sum(r[1] for r in rows) / reps)


def check(label, lname, c, call, out):
    call()
    want = er.edge_softmax_ref(c["dst"], c["mask"], c["logits"], c["S"])
    first = out.clone()
    call()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    if not torch.allclose(out, want, rtol=1e-6, atol=1e-6):
        sys.exit(f"{label} at {lname}: differs from the plain version by "
                 f"{err}")
    if not torch.equal(out.view(torch.int32), first.view(torch.int32)):
        sys.exit(f"{label} at {lname}: two calls differ")
    return err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=5)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()})
    paths = opts.source or [str(_build.CSRC / "edge_softmax.cu")]
    sources = {p: p for p in paths}
    fns, probes = build(sources)
    g = torch.Generator(device=DEV).manual_seed(0)
    layers = {"layer 2": layer(g, 86_803, 470_656, 9_426_304, 8),
              "layer 1": layer(g, 10_966, 22_272, 448_384, 8),
              "layer 0": layer(g, 1024, 1024, 21_248, 1)}
    stream = torch.cuda.current_stream().cuda_stream
    zero = torch.zeros((), dtype=torch.int32, device=DEV)

    c = layers["layer 2"]
    E, H, n = c["dst"].shape[0], c["logits"].shape[1], c["n"]
    pad = torch.empty(E, H, device=DEV)

    def stream_fill():
        _build.check(probes.probe_stream_fill(pad.data_ptr(), n * H, E * H,
                                              stream), "stream_fill")

    def entry_fill():
        _build.check(probes.probe_entry_fill(
            c["dst"].data_ptr(), E, c["live"].data_ptr(), H, c["S"],
            pad.data_ptr(), stream), "entry_fill")

    for label, f in fns.items():
        split = {"whole call": caller(f, c)[0],
                 "live prefix alone": caller(f, c, E=n)[0],
                 "padding alone": caller(f, c, live=zero)[0],
                 "probe: float4 streaming fill of [n H, E H)": stream_fill,
                 "probe: per-entry fill": entry_fill}
        emit({"part": "split", "source": label, "layer": "layer 2", "E": E,
              "H": H, "S": c["S"], "live": n,
              "ms": {k: {"event": event_ms(fn),
                         "device": device_ms(fn)[0]}
                     for k, fn in split.items()}})
    del pad

    calls = {}
    for lname, c in layers.items():
        for label, f in fns.items():
            call, out = caller(f, c)
            err = check(label, lname, c, call, out)
            calls[(lname, label)] = call
            emit({"part": "check", "source": label, "layer": lname,
                  "max_abs_err": err, "bit_identical_twice": True})
    times = {k: {"device_ms": [], "device_ops": [], "event_ms": []}
             for k in calls}
    for _ in range(opts.rounds):
        for k, call in calls.items():
            ms, ops = device_ms(call)
            times[k]["device_ms"].append(ms)
            times[k]["device_ops"].append(ops)
            times[k]["event_ms"].append(event_ms(call))
    for (lname, label), t in times.items():
        c = layers[lname]
        emit({"part": "rounds", "source": label, "layer": lname,
              "E": c["dst"].shape[0], "H": c["logits"].shape[1],
              "S": c["S"], "live": c["n"], "rows": c["rows"], **t})


if __name__ == "__main__":
    main()
