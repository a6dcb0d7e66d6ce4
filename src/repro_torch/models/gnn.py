"""The paper's GCN (§4: 3 layers, hidden 256, residual projections) over
sampled blocks (twin of ``repro.models.gnn``'s ``gcn_*``).

Each layer aggregates over its block with the sampler's Hajek weights
(``ops.aggregate`` -- the paper's estimator H''_s, eq. 6) and applies
``agg @ w + b + h[:seed_cap] @ wr``, ReLU on all but the last layer.
Weights use the reference's layout (``x @ w``), so
:func:`params_from_jax` loads the reference's parameters unchanged.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import ops as O
from repro_torch.core import rng as rng_lib


class GCNLayer(nn.Module):
    """``w``, ``b``, ``wr`` in the reference's layout, zero until
    :func:`gcn_init` or :func:`params_from_jax` fills them. The residual
    projection ``wr`` is on every layer: the paper's dims change at the
    first and last layer."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, device=device))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))
        self.wr = nn.Parameter(torch.zeros(d_in, d_out, device=device))

    def forward(self, blk, h: torch.Tensor, *, is_last: bool,
                backend: Optional[str] = None) -> torch.Tensor:
        """h over ``blk.next_seeds`` in, h over ``blk.seeds`` out."""
        agg = O.aggregate(blk, h, backend=backend)
        out = agg @ self.w + self.b + h[: blk.seed_cap] @ self.wr
        return out if is_last else torch.relu(out)


class GCN(nn.Module):
    """``gcn_apply`` over ``num_layers`` layers: dims in -> hidden ...
    -> out."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 3, *, device=None):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            GCNLayer(dims[i], dims[i + 1], device=device)
            for i in range(num_layers))

    def forward(self, blocks: Sequence, feats: torch.Tensor, *,
                backend: Optional[str] = None) -> torch.Tensor:
        """feats: features of ``blocks[-1].next_seeds``; returns logits
        for ``blocks[0].seeds``."""
        if len(blocks) != len(self.layers):
            raise ValueError(f"{len(blocks)} blocks for "
                             f"{len(self.layers)} layers")
        h = feats
        last = len(self.layers) - 1
        for i, (layer, blk) in enumerate(zip(self.layers, reversed(blocks))):
            h = layer(blk, h, is_last=i == last, backend=backend)
        return h


def gcn_init(key: rng_lib.Key, in_dim: int, hidden: int, out_dim: int,
             num_layers: int = 3, device="cuda") -> GCN:
    """The reference's ``gcn_init`` from the same threefry key: the same
    Glorot-uniform weights bit for bit, zero biases."""
    model = GCN(in_dim, hidden, out_dim, num_layers, device=device)
    keys = rng_lib.split(key, num_layers * 2)
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            d_in, d_out = layer.w.shape
            lim = math.sqrt(6.0 / (d_in + d_out))
            layer.w.copy_(rng_lib.uniform(keys[2 * i], (d_in, d_out), -lim,
                                          lim))
            layer.wr.copy_(rng_lib.uniform(keys[2 * i + 1], (d_in, d_out),
                                           -lim, lim))
    return model


def params_from_jax(tree, device="cuda") -> GCN:
    """Load the reference's GCN params (``{"layers": [{"w", "b", "wr"},
    ...]}`` as numpy arrays) into a :class:`GCN`, same layout."""
    layers = tree["layers"]
    dims = [np.shape(layers[0]["w"])[0]] + [np.shape(p["w"])[1]
                                           for p in layers]
    model = GCN(dims[0], dims[1], dims[-1], len(layers), device=device)
    if len(layers) > 1 and any(d != dims[1] for d in dims[1:-1]):
        raise ValueError(f"hidden widths differ: {dims}")
    with torch.no_grad():
        for layer, p in zip(model.layers, layers):
            for name in ("w", "b", "wr"):
                src = torch.from_numpy(np.array(p[name], np.float32))
                dst = getattr(layer, name)
                if dst.shape != src.shape:
                    raise ValueError(f"{name}: {tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    return model.eval()
