"""Elastic re-scaling: move a checkpoint or live parameters onto another
mesh (twin of ``repro.runtime.elastic``).

Checkpoints hold whole host arrays keyed by tree path (no mesh in them),
so re-scaling is a restore followed by placement with the new mesh's
DTensor placements (``distributed/sharding.py``). The new mesh may span
a subgroup of the ranks (from (2, 2) onto (2, 1)): every rank takes part,
and a rank outside the new mesh holds no shard.
"""
from __future__ import annotations

from typing import Any

from repro_torch.distributed import sharding as sh
from repro_torch.runtime import checkpoint as ckpt_lib


def reshard_checkpoint(ckpt_dir: str, step: int, like: Any, new_mesh) -> Any:
    """Restore checkpoint ``step`` in the structure of ``like`` (whole
    tensors, on ``like``'s devices) and place it on ``new_mesh`` by the
    parameter rules."""
    return sh.distribute(ckpt_lib.restore(ckpt_dir, step, like), new_mesh)


def reshard_live(tree: Any, new_mesh) -> Any:
    """Live tensors or DTensors placed on ``new_mesh``: each gathered
    whole (a collective over its own mesh) and copied through the host,
    then placed by the rules."""
    host = _to_host(sh.full_tensors(tree))
    return sh.distribute(host, new_mesh)


def _to_host(tree: Any) -> Any:
    """``tree``'s tensors copied to host memory."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree.detach().cpu().clone()
