#!/usr/bin/env python3
"""Where the forward SpMM's time goes, and how its shape parameters move
it, on synthetic versions of the three layers of a products-0.25
LABOR-0 request (rows of Poisson(10) edges, random source rows):

  layer 2: 86,803 rows, seed cap 470,656, edge cap 9,426,304, sources
           over 335,907 of 1,083,008 rows, F = 100
  layer 1: 10,966 rows, seed cap 22,272, sources over 86,702, F = 256
  layer 0: 1,024 rows, sources over 10,902, F = 256

  python3 tools/spmm_forward_sweep.py     (on a CUDA card, from the root)

Part 1 splits the layer-2 call of the package's kernel: the whole call,
the call without the padded rows (S = live rows), the flat fill alone
(no live edge), a plain ``zero_`` of the padded rows, ``index_select`` of
the live edges' source rows, and sources with locality (each row's
sources near 3 x its index), all with CUDA events over 20 calls.

Part 2 builds edited copies of ``csrc/spmm.cu`` into ``build/sweep``
(nvcc, as ``kernels/_build.py`` builds the package's) that change the
forward kernel's launch bounds (minimum blocks an SM), its chunk of
edges a group (C) and its edges in flight (U) for the one-float4 (F <=
128) and two-float4 (F <= 256) layouts, or read the value rows through
L2 only (``__ldcg``), or zero the padded rows after the sums; each is
timed twice at every layer and held bit for bit to the first.
"""
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.spmm import ops as sk  # noqa: E402

DEV = "cuda"
SRC = (ROOT / "src/repro_torch/csrc/spmm.cu").read_text()
OUT = ROOT / "build" / "sweep"
FILL = "  zero_floats(out, (long)tail * F, (long)S * F, tid, nthreads);\n"
V1 = re.compile(r"launch_forward<32, 32, 1, \d+, true>")
V2 = re.compile(r"launch_forward<32, \d+, 2, \d+, true>")
LB = re.compile(r"__launch_bounds__\(kThreads, \d+\)\nspmm_forward_kernel")

#: name -> (min blocks an SM, "C, U" at F <= 128, "C, U" at F <= 256,
#: __ldcg, fill after the sums)
VARIANTS = {
    "lb4_v1c32u8_v2c16u4": (4, "32, 8", "16, 4", False, False),
    "lb3_v1c32u8_v2c16u4": (3, "32, 8", "16, 4", False, False),
    "lb2_v1c32u16_v2c16u8": (2, "32, 16", "16, 8", False, False),
    "lb4_v1c16u8_v2c16u4": (4, "16, 8", "16, 4", False, False),
    "lb4_v1c32u6_v2c16u3": (4, "32, 6", "16, 3", False, False),
    "lb4_v1c32u4_v2c16u2": (4, "32, 4", "16, 2", False, False),
    "lb4_v1c32u3_v2c32u2": (4, "32, 3", "32, 2", False, False),
    "lb4_v1c32u2_v2c16u2": (4, "32, 2", "16, 2", False, False),
    "lb4_v1c32u2_v2c16u1": (4, "32, 2", "16, 1", False, False),
    "lb4_v1c32u1_v2c32u1": (4, "32, 1", "32, 1", False, False),
    "lb4_v1c16u2_v2c32u2": (4, "16, 2", "32, 2", False, False),
    "lb8_v1c32u2_v2c16u1": (8, "32, 2", "16, 1", False, False),
    "lb4_v1c32u4_v2c16u2_ldcg": (4, "32, 4", "16, 2", True, False),
    "lb4_v1c32u2_v2c16u2_fill_after": (4, "32, 2", "16, 2", False, True),
}


def variant_source(lb, v1, v2, ldcg, fill_after):
    s = LB.sub(f"__launch_bounds__(kThreads, {lb})\nspmm_forward_kernel", SRC)
    s = V1.sub(f"launch_forward<32, {v1.replace(', ', ', 1, ')}, true>", s)
    s = V2.sub(f"launch_forward<32, {v2.replace(', ', ', 2, ')}, true>", s)
    if ldcg:
        s = s.replace("q = __ldg((const float4*)(row + col[v]));",
                      "q = __ldcg((const float4*)(row + col[v]));")
    if fill_after:
        s = s.replace(FILL, "").replace(
            "  // the queued heavy rows, each by the whole block",
            FILL + "  // the queued heavy rows, each by the whole block")
    return s


def build_variants():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, spec in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(*spec))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        f = ctypes.CDLL(str(OUT / f"{name}.so")).spmm_rows
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P, P, P, P, P, I, P, P, I, I, I, P, P, P]
        fns[name] = f
    return fns


def event_ms(fn, reps=20):
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


def layer(g, rows, S, E, T, sources, F):
    lens = torch.poisson(torch.full((rows,), 10.0, device=DEV),
                         generator=g).long()
    n = int(lens.sum())
    dst = torch.full((E,), -1, dtype=torch.int32, device=DEV)
    dst[:n] = torch.repeat_interleave(
        torch.arange(rows, device=DEV, dtype=torch.int32), lens)
    src = torch.randint(0, sources, (E,), generator=g, device=DEV,
                        dtype=torch.int32)
    w = torch.rand(E, generator=g, device=DEV)
    mask = torch.arange(E, device=DEV) < n
    live = torch.tensor(n, dtype=torch.int32, device=DEV)
    h = torch.randn(T, F, generator=g, device=DEV)
    return dict(dst=dst, src=src, w=w, mask=mask, live=live, h=h, S=S,
                rows=rows, n=n)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device=DEV).manual_seed(0)
    layers = {"layer 2, F 100": layer(g, 86_803, 470_656, 9_426_304,
                                      1_083_008, 335_907, 100),
              "layer 1, F 256": layer(g, 10_966, 22_272, 448_384, 470_656,
                                      86_702, 256),
              "layer 0, F 256": layer(g, 1024, 1024, 21_248, 22_272,
                                      10_902, 256)}
    c = layers["layer 2, F 100"]
    zero = torch.zeros((), dtype=torch.int32, device=DEV)
    args = (c["src"], c["dst"], c["w"], c["mask"], c["h"])
    n, rows, S, F = c["n"], c["rows"], c["S"], 100
    local = torch.where(c["mask"], (c["dst"].long() * 3 + torch.randint(
        0, 20, c["dst"].shape, generator=g, device=DEV)) % 335_907, 0
    ).to(torch.int32)
    split = {
        "whole call": lambda: sk.spmm_block(*args, S, n_live=c["live"]),
        "no padded rows": lambda: sk.spmm_block(*args, rows,
                                                n_live=c["live"]),
        "flat fill alone": lambda: sk.spmm_block(*args, S, n_live=zero),
        "zero_ of the padded rows": lambda: torch.empty(
            (S - rows) * F, device=DEV).zero_(),
        "index_select of the source rows": lambda: c["h"].index_select(
            0, c["src"][:n].long()),
        "local sources, no padded rows": lambda: sk.spmm_block(
            local, c["dst"], c["w"], c["mask"], c["h"], rows,
            n_live=c["live"]),
    }
    print({k: round(event_ms(f), 4) for k, f in split.items()}, flush=True)

    fns = build_variants()
    stream = torch.cuda.current_stream().cuda_stream
    for lname, c in layers.items():
        F = c["h"].shape[1]
        T = c["h"].shape[0]
        E = c["dst"].shape[0]
        ref, times = None, {}
        for _ in range(2):
            for name, f in fns.items():
                out = torch.empty(c["S"], F, device=DEV)
                ptrs = [t.data_ptr() for t in (c["dst"], c["src"], c["w"],
                                               c["mask"])]

                def call(f=f, out=out, ptrs=ptrs):
                    f(*ptrs, None, E, c["live"].data_ptr(),
                      c["h"].data_ptr(), T, F, c["S"], None, out.data_ptr(),
                      stream)

                times.setdefault(name, []).append(round(event_ms(call), 4))
                if ref is None:
                    ref = out.clone()
                elif not torch.equal(out.view(torch.int32),
                                     ref.view(torch.int32)):
                    sys.exit(f"{name} differs from the first variant at "
                             f"{lname}")
        print(lname, times, flush=True)


if __name__ == "__main__":
    main()
