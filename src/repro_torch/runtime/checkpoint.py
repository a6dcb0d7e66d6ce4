"""Atomic, versioned, async, keep-k checkpoints with a CRC manifest (twin
of ``repro.runtime.checkpoint``), in the reference's on-disk format to
the byte, so that a checkpoint written by either package restores into
the other.

Layout: ``<dir>/step_<N:010d>/arrays.npz`` + ``meta.json``, written to a
``.tmp`` directory and renamed into place (a crash mid-write never
leaves a half-written step behind), the oldest pruned past ``keep``.
``arrays.npz`` holds one array per leaf of a nested tree of dicts and
lists, keyed by the leaf's path joined with ``///`` (dict keys in sorted
order, as ``jax.tree_util`` flattens them): ``params///layers///0///w``,
``opt///mu///layers///0///w``, ``opt///step``, ``guard///ema``,
``guard///steps``. A bfloat16 leaf is stored as its uint16 bits under
``<key>@bf16``. ``meta.json`` holds ``step``, ``time``, a CRC32 per array
(``integrity``, over the bytes of the C-ordered array) and the caller's
meta. :func:`verify` re-reads and checks every CRC; :func:`restore` and
:func:`latest_good_step` use it, so a torn or bit-rotted step is skipped
to the previous good one.

:func:`state_tree` turns the port's ``(model, EngineState)`` into that
tree (``named_parameters()``' ``layers.0.w`` becomes ``layers`` -> 0 ->
``w``) and :func:`load_state_tree` writes one back.

Engine metadata (:func:`engine_restore_meta`,
:func:`validate_restore_meta`) follows the reference's refusal rules:
the sampler's name, budgets and salt schedule, the mesh shape and the
gradient compression must match, and the caps are re-adopted from the
checkpoint. The backend has a rule of its own. The reference records
``"backend": "xla" | "pallas"`` and refuses to resume under another;
the port's backends are ``eager`` and ``cuda``, so the port records its
backend under ``"torch_backend"``, refuses to resume under another
``torch_backend``, and ignores ``"backend"``, which names the
reference's kernels (so each package resumes the other's checkpoints).
``frontier_tuning`` is the tuning cache's fingerprint
(``ops/autotune.py::cache_fingerprint``, None for the defaults), as in
the reference: a mismatch on restore warns and never refuses, since no
tuned knob changes a result. ``peer_caps`` is the sampler's per-peer
all-to-all caps (a list, or ``null`` off a mesh).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "///"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed CRC verification or could not be read: a torn
    write, truncation, or bit rot after publish."""


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[tuple]:
    """(path, leaf) in ``jax.tree_util``'s order: dict keys sorted, list
    entries by index; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, bool]:
    """A numpy copy of ``leaf`` that owns its memory (a CPU tensor's
    ``.numpy()`` would share the live storage) and whether it was
    bfloat16 (then its uint16 bits)."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in _leaves(tree):
        arr, bf16 = _host_array(leaf)
        out[_SEP.join(path) + ("@bf16" if bf16 else "")] = arr
    return out


def _unflatten_into(like: Any, arrays, path: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure (tensor leaves) with each leaf read from
    ``arrays``, as a tensor of the leaf's dtype on its device."""
    if isinstance(like, dict):
        return {k: _unflatten_into(v, arrays, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_into(v, arrays, path + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    key = _SEP.join(path)
    if key in arrays:
        t = torch.from_numpy(np.require(arrays[key], requirements="C"))
    elif key + "@bf16" in arrays:
        t = torch.from_numpy(np.require(arrays[key + "@bf16"],
                                        requirements="C").view(np.int16)
                             ).view(torch.bfloat16)
    else:
        raise KeyError(f"checkpoint missing leaf {key}")
    return t.to(device=like.device, dtype=like.dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def _armed(ckpt_dir: str, inject: Any) -> Tuple[Any, bool]:
    """The checkpoint faults that fire on the next write: the
    ``torn_ckpt`` spec (or None) and whether ``ckpt_error`` fires. It runs
    on the training thread, so the plan's log keeps the order of the
    loop's own faults whichever thread writes the checkpoint."""
    if inject is None:
        return None, False
    torn = inject.fires("torn_ckpt", _save_ordinal(ckpt_dir))
    error = inject.fires("ckpt_error", _save_ordinal(ckpt_dir)) is not None
    return torn, error


def _write(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray],
           meta: Optional[dict], keep: int, torn: Any, error: bool) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **arrays)
    integrity = {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                 for k, v in arrays.items()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(),
                   "integrity": integrity, **(meta or {})}, f)
    if torn is not None:
        size = os.path.getsize(npz_path)
        with open(npz_path, "r+b") as f:
            f.truncate(max(1, int(size * torn.effect)))
    if error:
        shutil.rmtree(tmp, ignore_errors=True)
        raise OSError(f"injected checkpoint write failure at step {step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None,
         keep: int = 3, inject: Any = None) -> str:
    """Write ``tree`` as step ``step``; keep the newest ``keep`` steps.
    ``inject`` (a ``runtime.inject.FaultPlan``) arms ``torn_ckpt``
    (truncate ``arrays.npz`` between write and publish) and
    ``ckpt_error`` (raise OSError before publish), both indexed by the
    count of published steps."""
    return _write(ckpt_dir, step, _flatten(tree), meta, keep,
                  *_armed(ckpt_dir, inject))


def _save_ordinal(ckpt_dir: str) -> int:
    return len(latest_steps(ckpt_dir))


def read_meta(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(_step_dir(ckpt_dir, step), "meta.json")) as f:
        return json.load(f)


def _read_arrays(ckpt_dir: str, step: int) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def verify(ckpt_dir: str, step: int) -> None:
    """Raise :class:`CheckpointCorruptError` unless every stored array
    has the CRC32 recorded at save time. A checkpoint without an
    ``integrity`` record passes if it can be read."""
    try:
        meta = read_meta(ckpt_dir, step)
        arrays = _read_arrays(ckpt_dir, step)
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint step {step} unreadable: {e}") from e
    integrity = meta.get("integrity")
    if integrity is None:
        return
    if set(integrity) != set(arrays):
        raise CheckpointCorruptError(
            f"checkpoint step {step}: array set differs from manifest "
            f"({sorted(set(integrity) ^ set(arrays))})")
    for k, want in integrity.items():
        got = zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes())
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: CRC mismatch on {k!r} "
                f"({got:#010x} != {want:#010x})")


def latest_steps(ckpt_dir: str):
    """Published steps (a ``meta.json`` present), oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_good_step(ckpt_dir: str) -> Optional[int]:
    """The newest step that passes :func:`verify` (the rollback
    target)."""
    for s in reversed(latest_steps(ckpt_dir)):
        try:
            verify(ckpt_dir, s)
            return s
        except CheckpointCorruptError:
            continue
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest verified step (:func:`latest_good_step`): every resume
    path skips a torn newest step."""
    return latest_good_step(ckpt_dir)


def _gc(ckpt_dir: str, keep: int):
    for s in latest_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Step ``step`` in the structure of ``like``, each leaf a tensor of
    ``like``'s dtype on its device. Verifies the CRCs first
    (:class:`CheckpointCorruptError`); a leaf of ``like`` that the
    checkpoint lacks raises ``KeyError``."""
    verify(ckpt_dir, step)
    return _unflatten_into(like, _read_arrays(ckpt_dir, step))


class AsyncSaver:
    """Overlaps checkpoint writes with training, one save in flight.

    :meth:`save` copies the tree to host memory on the calling thread
    (the engine updates parameters in place, so the save thread must not
    read live tensors), then writes it on a daemon thread. An exception
    in that thread is raised again on the training thread at the next
    :meth:`save` or :meth:`wait`."""

    def __init__(self, ckpt_dir: str, keep: int = 3, inject: Any = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.inject = inject
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, step, arrays, meta, faults):
        try:
            _write(self.ckpt_dir, step, arrays, meta, self.keep, *faults)
        except BaseException as e:  # raised again on the training thread
            self._error = e

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        arrays = _flatten(tree)  # the snapshot, before any later step
        faults = _armed(self.ckpt_dir, self.inject)
        self._thread = threading.Thread(
            target=self._run, args=(step, arrays, meta, faults), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# ----------------------------------------------------------------------
# the port's (model, EngineState) as the reference's tree
# ----------------------------------------------------------------------

def nest(flat: Dict[str, Any]) -> Any:
    """``{"layers.0.w": t}`` -> ``{"layers": [{"w": t}]}``: dotted names
    as nested dicts, an all-digit level as a list."""
    root: dict = {}
    for name, v in flat.items():
        *head, last = name.split(".")
        node = root
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def unnest(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`nest`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(unnest(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def state_tree(model, state) -> dict:
    """``{"params", "opt"[, "err"][, "guard"]}`` of a model and its
    ``EngineState``, the reference trainer's ``state_tree`` (the leaves
    are the live tensors: :func:`save` and :class:`AsyncSaver` copy
    them; ``err`` is the gradient compression's error feedback)."""
    opt = state.opt
    tree = {"params": nest({k: p.detach()
                            for k, p in model.named_parameters()}),
            "opt": {"mu": nest(opt["mu"]), "nu": nest(opt["nu"]),
                    "step": opt["step"]}}
    if state.err is not None:
        tree["err"] = nest(state.err)
    if state.guard is not None:
        tree["guard"] = dict(state.guard)
    return tree


def load_state_tree(model, state, tree: dict):
    """Write ``tree["params"]`` into ``model`` (in place) and return
    ``state`` with the tree's optimizer state and, where the tree has
    them, its error feedback and guard state."""
    names = [k for k, _ in model.named_parameters()]
    params = unnest(tree["params"])
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    opt = tree["opt"]
    mu, nu = unnest(opt["mu"]), unnest(opt["nu"])
    return dataclasses.replace(
        state, opt={"mu": {k: mu[k] for k in names},
                    "nu": {k: nu[k] for k in names}, "step": opt["step"]},
        guard=tree.get("guard", state.guard),
        err=(state.err if "err" not in tree
             else {k: v for k, v in unnest(tree["err"]).items()}))


# ----------------------------------------------------------------------
# engine metadata
# ----------------------------------------------------------------------

def engine_restore_meta(sampler, mesh_devices: int = 0,
                        grad_compression: str = "none",
                        backend: Optional[str] = None) -> dict:
    """The JSON record of the specialisation a run trains under: the
    sampler (name, budgets, caps, which may have grown through overflow
    replay, salt schedule, the per-peer all-to-all caps), the mesh shape,
    the gradient compression, the port's backend (``torch_backend``) and
    the tuning cache's fingerprint (``frontier_tuning``)."""
    from repro_torch.ops import autotune

    spec = sampler.spec
    return {
        **({} if backend is None else {"torch_backend": backend}),
        "frontier_tuning": autotune.cache_fingerprint(),
        "sampler": {
            "name": spec.name,
            "budgets": list(spec.budgets),
            "caps": [[c.expand_cap, c.edge_cap, c.vertex_cap]
                     for c in spec.caps],
            "shared_salts": bool(spec.shared_salts),
            "peer_caps": (None if spec.peer_caps is None
                          else list(spec.peer_caps)),
        },
        "mesh_devices": int(mesh_devices),
        "grad_compression": grad_compression,
    }


def validate_restore_meta(meta: dict, sampler, mesh_devices: int = 0,
                          grad_compression: str = "none",
                          backend: Optional[str] = None):
    """Check a checkpoint's engine record against the current run and
    return the sampler with the checkpoint's caps. A mismatch in the
    sampler's name, budgets or salt schedule, the mesh shape, the
    compression or (``backend`` not None) the ``torch_backend`` raises
    ``ValueError``; ``"backend"`` (the reference's kernels) is not
    checked. A ``frontier_tuning`` other than the current tuning cache's
    fingerprint warns. The caps and the per-peer caps are the
    checkpoint's. A checkpoint without a ``sampler`` record passes
    unchanged."""
    from repro_torch.core.interface import LayerCaps

    rec = meta.get("sampler")
    if rec is None:
        return sampler
    spec = sampler.spec
    problems = []
    if rec["name"] != spec.name:
        problems.append(f"sampler {rec['name']!r} != current {spec.name!r}")
    if tuple(rec["budgets"]) != tuple(spec.budgets):
        problems.append(f"budgets {rec['budgets']} != current "
                        f"{list(spec.budgets)}")
    if bool(rec["shared_salts"]) != bool(spec.shared_salts):
        problems.append("salt schedule (shared_salts) differs")
    ckpt_mesh = int(meta.get("mesh_devices", 0))
    if ckpt_mesh != int(mesh_devices):
        problems.append(f"mesh/partition shape {ckpt_mesh} devices != "
                        f"current {int(mesh_devices)}")
    ckpt_comp = meta.get("grad_compression", "none")
    if ckpt_comp != grad_compression:
        problems.append(f"gradient compression {ckpt_comp!r} != current "
                        f"{grad_compression!r}")
    ckpt_backend = meta.get("torch_backend")
    if (backend is not None and ckpt_backend is not None
            and ckpt_backend != backend):
        problems.append(f"backend {ckpt_backend!r} != current {backend!r}")
    if problems:
        raise ValueError(
            "checkpoint was trained under a different engine "
            "specialization — refusing to resume:\n  "
            + "\n  ".join(problems))
    if "frontier_tuning" in meta:
        import warnings

        from repro_torch.ops import autotune
        cur = autotune.cache_fingerprint()
        if meta["frontier_tuning"] != cur:
            warnings.warn(
                f"frontier tuning cache differs from the checkpoint's "
                f"({meta['frontier_tuning']} vs {cur}); results are "
                "unaffected (every table load gives the same output) but "
                "step times may differ: python -m repro_torch.ops.autotune "
                "tunes again", stacklevel=2)
    peer = rec.get("peer_caps")
    return sampler.with_caps(
        tuple(LayerCaps(*c) for c in rec["caps"])).with_peer_caps(
        None if peer is None else tuple(peer))
