"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/kernels/<name>-<source hash>.so`` at the repository
root (a directory ``.gitignore`` lists) the first time a wrapper needs
it, and loaded with ``ctypes``. A changed source has a new hash and is
rebuilt; nothing is built at import time. :func:`build_all` compiles
every source in parallel, one ``nvcc`` each.

Every exported C function takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launches; a
wrapper raises on a non-zero return (:func:`check`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
SOURCES = ("edge_softmax", "flash_attention", "frontier", "search",
           "select", "spmm")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
#: C signatures: name -> (library, argtypes)
SIGNATURES = {
    "frontier_compact": ("frontier", [_P, _I, _P, _I, _P, _P, _P, _P, _U,
                                      _P]),
    "frontier_compact_tile": ("frontier", []),
    "frontier_compact_perm": ("frontier", [_P, _P, _I, _P, _I, _I, _P, _P,
                                           _L, _P, _L, _U, _P]),
    "frontier_hash_dedup": ("frontier", [_P, _P, _I, _P, _P, _I, _I, _P,
                                         _P, _P, _P, _P, _L, _P, _L, _P, _L,
                                         _U, _P]),
    "frontier_sort_tile": ("frontier", []),
    "frontier_digit_bits": ("frontier", []),
    "frontier_cdf_search": ("search", [_P, _I, _P, _I, _P, _P]),
    "frontier_search_group": ("search", []),
    "frontier_segment_select": ("select", [_P, _P, _I, _P, _P, _P, _I, _P,
                                           _P, _P, _U, _P]),
    "spmm_rows": ("spmm", [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P,
                           _P, _P]),
    "scatter_rows": ("spmm", [_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P]),
    "spmm_row_offsets": ("spmm", [_P, _P, _I, _P, _I, _P, _P]),
    "gather_dst_rows": ("spmm", [_P, _P, _I, _P, _P, _I, _I, _P, _P]),
    "edge_softmax": ("edge_softmax", [_P, _P, _I, _P, _P, _I, _I, _P, _P]),
    "flash_attention_fwd": ("flash_attention", [_P, _P, _F, _F, _P]),
    "flash_attention_plan": ("flash_attention", [_I, _I, _P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, object] = {}
#: nvcc's -Xptxas -v report of each library built by this process
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch build only on "
            "a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start one nvcc for ``name`` if its library is missing; returns
    (final path, tmp path, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Optional[Path], proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = log


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds
    spent. Raises on the first failed compile."""
    t0 = time.perf_counter()
    with _LOCK:
        started = {n: _start(n) for n in SOURCES}
        for n, (out, tmp, proc) in started.items():
            _finish(n, out, tmp, proc)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out, tmp, proc = _start(name)
        _finish(name, out, tmp, proc)
        lib = ctypes.CDLL(str(out))
        for fn, (owner, argtypes) in SIGNATURES.items():
            if owner == name:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def function(fn: str):
    f = _FUNCS.get(fn)
    if f is None:
        f = _FUNCS[fn] = getattr(library(SIGNATURES[fn][0]), fn)
    return f


def check(status: int, fn: str) -> None:
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {status}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()
