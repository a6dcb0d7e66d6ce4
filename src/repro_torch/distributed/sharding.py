"""Parameter sharding rules: logical name -> mesh axes per dimension, and
their DTensor placements (twin of ``repro.distributed.sharding``).

The 2-D "FSDP x TP" layout (MaxText-style): for every weight matrix the
input (reduction-adjacent) dimension is sharded over the FSDP axes
("pod", "data") and the output (feature) dimension over the tensor axis
("model"); MoE experts are expert-parallel over "model". Rules describe
the trailing dimensions only: a leading stacked dimension, which the
reference has and the port's per-repeat tensors do not, gets None.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dimension
names ``("data", "model")`` or ``("pod", "data", "model")``
(:func:`make_mesh`). :func:`params_placements` turns the rules into one
``Shard``/``Replicate`` per mesh dimension: axes the mesh lacks are
dropped, and a tensor dimension that its axes' product does not divide
is replicated (whisper's odd vocabulary of 51,866). Optimizer state
takes its parameter's placements.

The reference's ``params_pspecs``, ``abstract_params`` and
``shard_params_specs`` serve its ahead-of-time lowering
(``shard_map`` in_specs, ``ShapeDtypeStruct`` trees), which the port
does not have.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

FSDP = ("pod", "data")
TP = "model"

# rules matched by parameter leaf name (the last key of its path)
_RULES: Tuple[Tuple[Tuple[str, ...], Tuple[Any, ...]], ...] = (
    # embeddings / head
    (("embed",), (TP, FSDP)),                  # (vocab, d)
    (("lm_head",), (FSDP, TP)),                # (d, vocab)
    # attention
    (("wq",), (FSDP, TP)),
    (("wk",), (FSDP, TP)),
    (("wv",), (FSDP, TP)),
    (("wo",), (TP, FSDP)),
    (("bq",), (TP,)),
    (("bk",), (TP,)),
    (("bv",), (TP,)),
    # dense mlp (also shared expert)
    (("wi",), (FSDP, TP)),
    (("wg",), (FSDP, TP)),
    (("shared_wi",), (FSDP, TP)),
    (("shared_wg",), (FSDP, TP)),
    (("shared_wo",), (TP, FSDP)),
    # moe experts: (E, d, f) / (E, f, d) — expert-parallel over model
    (("router",), (FSDP, None)),
    # mamba
    (("in_proj",), (FSDP, TP)),
    (("out_proj",), (TP, FSDP)),
    (("conv_w",), (None, TP)),
    (("conv_b",), (TP,)),
    # gnn dense layers
    (("w",), (FSDP, TP)),
    (("wr",), (FSDP, TP)),
)

_MOE_3D = {
    "ewi": (TP, FSDP, None),
    "ewg": (TP, FSDP, None),
    "ewo": (TP, None, FSDP),
}

# per-run rule overrides (sequence-parallel attention keeps the attention
# weights replicated over the TP axis), name -> entries
_OVERRIDES: Dict[str, Tuple[Any, ...]] = {}

SEQ_PARALLEL_ATTN_OVERRIDES = {
    "wq": (FSDP, None), "wk": (FSDP, None), "wv": (FSDP, None),
    "wo": (None, FSDP), "bq": (), "bk": (), "bv": (),
}


def set_rule_overrides(overrides):
    global _OVERRIDES
    _OVERRIDES = dict(overrides or {})


def spec_for(path: Tuple[str, ...], leaf) -> Tuple[Any, ...]:
    """Mesh axes per dimension of the parameter at ``path`` (its keys,
    the last one its name): an axis name, a tuple of them, or None."""
    name = path[-1]
    ndim = leaf.ndim if hasattr(leaf, "ndim") else len(leaf.shape)
    if name in _OVERRIDES:
        base = tuple(_OVERRIDES[name])[:ndim]
        return (None,) * (ndim - len(base)) + base
    if name in _MOE_3D and ndim >= 3:
        base = _MOE_3D[name]
    else:
        base = ()  # replicate (norm scales, biases, scalars)
        for (suffix, spec) in _RULES:
            if name == suffix[-1]:
                base = spec
                break
    base = tuple(base)[:ndim]
    return (None,) * (ndim - len(base)) + base


def _filter(entry, axis_names):
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in axis_names)
        return None if not kept else (kept if len(kept) > 1 else kept[0])
    return entry if entry in axis_names else None


def mesh_axes(mesh) -> Dict[str, int]:
    """{dimension name: size} of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``), in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_prod(entry, axes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= axes[a]
        return n
    return axes[entry]


def leaf_entries(path: Tuple[str, ...], leaf, mesh) -> Tuple[Any, ...]:
    """:func:`spec_for` on ``mesh``: axes the mesh lacks dropped, a
    dimension its axes' product does not divide replicated (None) —
    the reference's ``params_shardings`` entries."""
    axes = mesh_axes(mesh)
    out = []
    for dim, e in zip(leaf.shape, spec_for(path, leaf)):
        e = _filter(e, axes)
        if e is not None and dim % _axis_prod(e, axes) != 0:
            e = None
        out.append(e)
    return tuple(out)


def placements(entries: Tuple[Any, ...], mesh) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(d)`` on every
    mesh dimension that tensor dimension ``d``'s entry names (a tuple
    shards ``d`` over each of its axes, outer first), ``Replicate()``
    on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(entries):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def params_placements(params: Any, mesh) -> Any:
    """The tree of ``params`` (nested dicts and lists of tensors, or of
    anything with a ``shape``) with each leaf's placements on ``mesh``."""
    return _map_with_path(
        lambda path, leaf: placements(leaf_entries(path, leaf, mesh), mesh),
        params)


def distribute(params: Any, mesh) -> Any:
    """``params`` placed on ``mesh`` as DTensors by the rules. Every rank
    passes the same full tensors (as after a checkpoint's restore)."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, leaf):
        return distribute_tensor(
            leaf, mesh, placements(leaf_entries(path, leaf, mesh), mesh))
    return _map_with_path(one, params)


def full_tensors(tree: Any) -> Any:
    """Each DTensor of ``tree`` gathered whole (a collective over its
    mesh); plain tensors as they are."""
    from torch.distributed.tensor import DTensor

    return _map_with_path(
        lambda _p, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def constrain_like_params(tree: Any, mesh=None) -> Any:
    """The reference forces a gradient tree to the parameters' sharding
    inside its jitted step; here a tree is redistributed to the rules'
    placements on ``mesh``. Off a mesh (None) it is returned as it is."""
    if mesh is None:
        return tree
    from torch.distributed.tensor import DTensor

    def one(path, leaf):
        want = placements(leaf_entries(path, leaf, mesh), mesh)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, want)
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(leaf, mesh, want)
    return _map_with_path(one, tree)


def make_mesh(shape: Tuple[int, ...], device: str = "cuda",
              ranks=None):
    """A ``DeviceMesh`` of ``shape`` with dimensions ``("data",
    "model")`` (2-D) or ``("pod", "data", "model")`` (3-D) over the
    default process group, which must already be set up (with
    ``launch/mesh.py``). ``ranks``: the ranks it holds, in order
    (default ``0 .. prod(shape) - 1``, which must be the whole group for
    ``init_device_mesh``); a mesh over a subgroup is built by every rank
    of the group, and a rank outside it holds no shard."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    names = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    n = math.prod(shape)
    if ranks is None and n == dist.get_world_size():
        return init_device_mesh(torch.device(device).type, tuple(shape),
                                mesh_dim_names=names)
    ranks = list(range(n)) if ranks is None else list(ranks)
    return DeviceMesh(torch.device(device).type,
                      torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)
