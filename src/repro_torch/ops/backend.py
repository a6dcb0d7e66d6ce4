"""Graph-ops backend registry (twin of ``repro.ops.backend``).

A backend is a namespace providing the primitives of ``repro_torch.ops``
(``aggregate``, ``gather_dst`` and the frontier family ``hash_dedup``,
``compact``, ``compact_perm``, ``segment_select``, ``masked_cdf_draw``).
Two ship:

  * ``"cuda"``  -- the hand-written Hopper kernels (``repro_torch.ops.cuda``);
  * ``"eager"`` -- the plain PyTorch versions (``repro_torch.ops.ref``), the
                   counterpart of the reference's ``"xla"`` backend.

``"auto"`` (or None) resolves by device: ``"cuda"`` for CUDA tensors,
``"eager"`` for CPU tensors. Asking for ``"eager"`` on the card runs the
plain versions there (how the kernels are checked); asking for
``"cuda"`` on the CPU is an error.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

#: names accepted wherever a backend is selected (``TrainEngine``, ``ops``)
BACKEND_CHOICES = ("auto", "cuda", "eager")


def resolve_backend(name: Optional[str], device) -> str:
    """Resolve a user-facing backend name for tensors on ``device``."""
    dev = torch.device(device)
    if name in (None, "auto"):
        return "cuda" if dev.type == "cuda" else "eager"
    if name not in BACKEND_CHOICES:
        raise ValueError(f"unknown graph-ops backend {name!r}; choose from "
                         f"{BACKEND_CHOICES}")
    if name == "cuda" and dev.type != "cuda":
        raise ValueError("backend 'cuda' runs the CUDA kernels and needs "
                         f"CUDA tensors, got device {dev}")
    return name


def get_backend(name: Optional[str], device) -> Any:
    from repro_torch.ops import cuda, ref
    return cuda if resolve_backend(name, device) == "cuda" else ref
