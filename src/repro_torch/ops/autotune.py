"""Persistent autotuning cache of the frontier kernels (twin of
``repro.ops.autotune``).

The reference tunes the Pallas kernels' tile width and the serial or
grid-parallel variant. The port has one design per contract, and its
launch shapes are compile-time constants of the CUDA sources
(``kThreads``, ``kGridCap``, ``kCompactItems``, ``kChunk``): those stay
as they are. hash_dedup's table is sized by the kernel itself
(``dedup_table_cap`` in ``csrc/frontier.cu``, mirrored by
``kernels/frontier/ops.py::_dedup_table``): a power of two at least 1.5
slots an entry. That sizing, ``table_load`` 1.5, is the one parameter
and its only candidate: no kernel reads another, so no wrapper looks
the cache up at dispatch. A second candidate would need the kernel to
take its table size from the host, and has to show a gain on the
sampler's own per-layer inputs before it reaches the main path.

As in the reference, this module:

  * buckets shapes to powers of two (``E=7000`` and ``E=8191`` share an
    entry),
  * keys entries ``"<primitive>|<platform>|<bucket>"`` with platform
    ``cuda``,
  * times the candidates per key (:func:`autotune`, the CLI below, on
    the card) and keeps the winners in a JSON cache that
    :func:`get_params` reads.

Cache file format (the reference's)::

    {"version": 1,
     "entries": {"hash_dedup|cuda|E=16777216,S=524288":
                     {"table_load": 1.5, "us": 1234.5}, ...}}

The cache lives at ``$REPRO_AUTOTUNE_CACHE`` (or
``~/.cache/repro/frontier_autotune.json``); a missing or corrupt file
degrades to :data:`DEFAULT_PARAMS`. ``REPRO_FRONTIER_TABLE_LOAD=<load>``
wins over the cache (the reference's env overrides force its variant
and tile, which the port does not have); a value no candidate has is
ignored. :func:`cache_fingerprint` goes into checkpoints'
``engine_restore_meta`` as ``frontier_tuning``; a mismatch on restore
warns and never refuses.

  python -m repro_torch.ops.autotune [--smoke] [--cache PATH]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Any, Dict, Optional

PRIMITIVES = ("hash_dedup",)

#: slots an entry of hash_dedup's table: the kernel's own sizing, the
#: only candidate
TABLE_LOADS = (1.5,)

DEFAULT_PARAMS: Dict[str, Dict[str, Any]] = {
    "hash_dedup": {"table_load": 1.5},
}

#: keys a cache entry may override (the recorded time is carried, not
#: read)
_TUNABLE = ("table_load",)

PLATFORM = "cuda"
CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
LOAD_ENV = "REPRO_FRONTIER_TABLE_LOAD"
_VERSION = 1


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro", "frontier_autotune.json")


def _bucket(n: int) -> int:
    """Round up to a power of two, the shape-bucket granularity."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def bucket_key(primitive: str, platform: str, shapes: Dict[str, int]) -> str:
    dims = ",".join(f"{k}={_bucket(v)}" for k, v in sorted(shapes.items()))
    return f"{primitive}|{platform}|{dims}"


class TuneCache:
    """The JSON tuning cache: load-tolerant, atomically saved."""

    def __init__(self, path: str, entries: Optional[dict] = None):
        self.path = path
        self.entries: Dict[str, Dict[str, Any]] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "TuneCache":
        """Read ``path``; a missing, unreadable, corrupt or wrong-version
        file gives an empty cache (the defaults), never an exception."""
        try:
            with open(path) as f:
                doc = json.load(f)
            if (not isinstance(doc, dict) or doc.get("version") != _VERSION
                    or not isinstance(doc.get("entries"), dict)):
                raise ValueError("bad schema")
            entries = {k: v for k, v in doc["entries"].items()
                       if isinstance(k, str) and isinstance(v, dict)}
            return cls(path, entries)
        except FileNotFoundError:
            return cls(path)
        except (OSError, ValueError) as e:  # ValueError: JSONDecodeError
            print(f"repro_torch.ops.autotune: ignoring unusable tuning "
                  f"cache {path!r} ({e}); using defaults", file=sys.stderr)
            return cls(path)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self.entries.get(key)

    def put(self, key: str, params: Dict[str, Any]) -> None:
        self.entries[key] = dict(params)

    def save(self) -> str:
        """Atomic publish (tmp + rename), creating parent dirs."""
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _VERSION, "entries": self.entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        return self.path

    def fingerprint(self) -> Optional[str]:
        """Short digest of the entries, None when empty (the defaults)."""
        if not self.entries:
            return None
        blob = json.dumps(self.entries, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]


# the process-wide cache, loaded from the path the environment names at
# each lookup (so a test can point it elsewhere); the file is read again
# only when that path changes or after reload()
_STATE: Dict[str, Any] = {"path": None, "cache": None}


def _cache() -> TuneCache:
    path = default_cache_path()
    if _STATE["cache"] is None or _STATE["path"] != path:
        _STATE["path"] = path
        _STATE["cache"] = TuneCache.load(path)
    return _STATE["cache"]


def reload() -> None:
    """Drop the in-process cache so the next lookup reads the file."""
    _STATE["path"] = None
    _STATE["cache"] = None


def cache_fingerprint() -> Optional[str]:
    return _cache().fingerprint()


def get_params(primitive: str, **shapes: int) -> Dict[str, Any]:
    """The parameters for one shape: defaults <- cache entry <- env
    override; a value outside :data:`TABLE_LOADS` is ignored."""
    params = dict(DEFAULT_PARAMS[primitive])
    hit = _cache().get(bucket_key(primitive, PLATFORM, shapes))
    if hit:
        params.update({k: hit[k] for k in _TUNABLE if k in hit})
    load = os.environ.get(LOAD_ENV)
    if load:
        try:
            params["table_load"] = float(load)
        except ValueError:
            pass
    if params.get("table_load") not in TABLE_LOADS:
        params["table_load"] = DEFAULT_PARAMS[primitive]["table_load"]
    return params


# ---------------------------------------------------------------------------
# the tuner: synthetic inputs of a sampler's epilogue shapes (the CLI), or
# a caller's inputs (chip_smoke's phase 2: layer 2 of a real batch); every
# candidate held bit for bit to a first call and timed with CUDA events


def candidates(primitive: str):
    return [{"table_load": x} for x in TABLE_LOADS]


def _inputs(e: int, s: int, device):
    """``e`` edge endpoints (9 in 10 live) over a vertex space 8x larger
    and ``s`` distinct seeds, from numpy's generator at seed 0: a
    sampler's shapes, not its traffic (its layer 2 has about one value
    in ten live), so a pick made on them would need checking on a real
    batch."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    vspace = max(8 * e, 1024)
    values = rng.integers(0, vspace, size=e).astype(np.int32)
    mask = rng.random(e) < 0.9
    seeds = np.unique(rng.integers(0, vspace, size=s).astype(np.int32))
    return (torch.from_numpy(values).to(device),
            torch.from_numpy(mask).to(device),
            torch.from_numpy(seeds).to(device), e)


def _event_us(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def time_candidates(values, mask, seeds, new_cap, n_live=None, reps=20):
    """Each candidate's hash_dedup on these inputs on the card: its
    output against a first call's bit for bit (``ValueError`` if any
    differs: the table a call reuses, left by earlier calls with lower
    epochs, must not change a result) and its time in us (CUDA events
    over ``reps`` calls). Returns ``[(params, us), ...]``."""
    import torch

    from repro_torch.kernels.frontier import ops as fk

    def run():
        return fk.hash_dedup(values, mask, seeds, new_cap, n_live)

    want = run()
    out = []
    for cand in candidates("hash_dedup"):
        got = run()
        torch.cuda.synchronize()
        for name in ("new", "slots", "num_new", "overflow"):
            if not torch.equal(getattr(got, name), getattr(want, name)):
                raise ValueError(f"hash_dedup at table_load "
                                 f"{cand['table_load']}: {name} differs "
                                 "from the first call's")
        out.append((cand, _event_us(run, reps)))
    return out


def autotune(sizes=None, smoke: bool = False,
             cache: Optional[TuneCache] = None,
             verbose: bool = True) -> Dict[str, Dict[str, Any]]:
    """Time every candidate per (E, S) on the card, persist the winners
    (each with its time in ``us``; with one candidate, the default) and
    return them by key. Without a card it raises: a CPU time says
    nothing of the kernel."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("autotune times the CUDA kernels: no card")
    if sizes is None:
        # the serving path's layers at batch 1024 (edge caps, seeds):
        # smoke takes layer 1's, the full run layers 0-2
        sizes = ([(1_128_448, 22_272)] if smoke else
                 [(59_648, 1_024), (1_128_448, 22_272),
                  (9_426_304, 470_656)])
    reps = 5 if smoke else 20
    cache = cache if cache is not None else _cache()
    winners: Dict[str, Dict[str, Any]] = {}
    for e, s in sizes:
        values, mask, seeds, new_cap = _inputs(e, s, "cuda")
        timed = time_candidates(values, mask, seeds, new_cap, reps=reps)
        for cand, us in timed:
            if verbose:
                print(f"  hash_dedup E={e:<9d} S={s:<8d} {cand} {us:10.1f}us")
        best, best_us = min(timed, key=lambda t: t[1])
        key = bucket_key("hash_dedup", PLATFORM,
                         {"E": e, "S": seeds.shape[0]})
        winners[key] = {**best, "us": round(best_us, 1)}
        cache.put(key, winners[key])
        if verbose:
            print(f"* {key} -> {winners[key]}")
    cache.save()
    if verbose:
        print(f"wrote {len(winners)} entries to {cache.path}")
    return winners


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.ops.autotune",
        description="Time hash_dedup's candidates on the card and keep "
                    "the winners in the JSON tuning cache.")
    ap.add_argument("--smoke", action="store_true",
                    help="one size, 5 reps")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default ${CACHE_ENV} or "
                         f"{default_cache_path()})")
    args = ap.parse_args(argv)
    if args.cache:
        os.environ[CACHE_ENV] = args.cache
        reload()
    autotune(smoke=args.smoke, cache=_cache())
    reload()
    rb = _cache()
    print(f"round-trip: {len(rb.entries)} entries, "
          f"fingerprint={rb.fingerprint()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
