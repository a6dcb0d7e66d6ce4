"""GNN models over sampled blocks (twin of ``repro.models.gnn``): the
paper's GCN (§4: 3 layers, hidden 256, residual projections), GraphSAGE
(mean aggregator + self concat) and the multi-head GATv2 of §A.6.

Each layer takes h over ``blk.next_seeds`` and returns h over
``blk.seeds``. GCN and SAGE aggregate with the sampler's Hajek weights
(``ops.aggregate`` -- the paper's estimator H''_s, eq. 6); GATv2 scores
each edge (``ops.sddmm(op="add")``), normalises the scores per
destination (``ops.edge_softmax``) and sums the weighted messages
(``ops.scatter_edges``). All graph compute goes through ``repro_torch.ops``,
so one ``backend`` argument switches a model between the CUDA kernels
and the plain versions, forward and backward. Weights use the
reference's layout (``x @ w``), so :func:`params_from_jax` loads the
reference's parameters unchanged.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import ops as O
from repro_torch.core import rng as rng_lib


def _zeros(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, device=device))


def _dense_init(k: rng_lib.Key, d_in: int, d_out: int) -> torch.Tensor:
    """The reference's Glorot-uniform ``_dense_init``, bit for bit."""
    lim = math.sqrt(6.0 / (d_in + d_out))
    return rng_lib.uniform(k, (d_in, d_out), -lim, lim)


class _Stack(nn.Module):
    """Layers applied from the deepest block to the outermost:
    ``forward(blocks, feats)`` takes the features of
    ``blocks[-1].next_seeds`` and returns logits for ``blocks[0].seeds``;
    the last layer has no activation."""

    def forward(self, blocks: Sequence, feats: torch.Tensor, *,
                backend: Optional[str] = None) -> torch.Tensor:
        if len(blocks) != len(self.layers):
            raise ValueError(f"{len(blocks)} blocks for "
                             f"{len(self.layers)} layers")
        h = feats
        last = len(self.layers) - 1
        for i, (layer, blk) in enumerate(zip(self.layers, reversed(blocks))):
            h = layer(blk, h, is_last=i == last, backend=backend)
        return h


def _dims(in_dim, hidden, out_dim, num_layers):
    return [in_dim] + [hidden] * (num_layers - 1) + [out_dim]


# ---------------------------------------------------------------------------
# GCN (paper eq. 2) with residual projections
# ---------------------------------------------------------------------------

class GCNLayer(nn.Module):
    """``w``, ``b``, ``wr`` in the reference's layout, zero until
    :func:`gcn_init` or :func:`params_from_jax` fills them. The residual
    projection ``wr`` is on every layer: the paper's dims change at the
    first and last layer."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.w = _zeros(d_in, d_out, device=device)
        self.b = _zeros(d_out, device=device)
        self.wr = _zeros(d_in, d_out, device=device)

    def forward(self, blk, h: torch.Tensor, *, is_last: bool,
                backend: Optional[str] = None) -> torch.Tensor:
        agg = O.aggregate(blk, h, backend=backend)
        out = agg @ self.w + self.b + h[: blk.seed_cap] @ self.wr
        return out if is_last else torch.relu(out)


class GCN(_Stack):
    """``gcn_apply`` over ``num_layers`` layers: dims in -> hidden ...
    -> out."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 3, *, device=None):
        super().__init__()
        dims = _dims(in_dim, hidden, out_dim, num_layers)
        self.layers = nn.ModuleList(
            GCNLayer(dims[i], dims[i + 1], device=device)
            for i in range(num_layers))


def gcn_init(key: rng_lib.Key, in_dim: int, hidden: int, out_dim: int,
             num_layers: int = 3, device="cuda") -> GCN:
    """The reference's ``gcn_init`` from the same threefry key: the same
    Glorot-uniform weights bit for bit, zero biases."""
    model = GCN(in_dim, hidden, out_dim, num_layers, device=device)
    keys = rng_lib.split(key, num_layers * 2)
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            layer.w.copy_(_dense_init(keys[2 * i], *layer.w.shape))
            layer.wr.copy_(_dense_init(keys[2 * i + 1], *layer.wr.shape))
    return model


# ---------------------------------------------------------------------------
# GraphSAGE (mean aggregator + self concat)
# ---------------------------------------------------------------------------

class SAGELayer(nn.Module):
    """``relu([h[:seed_cap], aggregate(h)] @ w + b)``; ``w`` is
    (2 d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.w = _zeros(2 * d_in, d_out, device=device)
        self.b = _zeros(d_out, device=device)

    def forward(self, blk, h: torch.Tensor, *, is_last: bool,
                backend: Optional[str] = None) -> torch.Tensor:
        agg = O.aggregate(blk, h, backend=backend)
        z = torch.cat([h[: blk.seed_cap], agg], dim=-1) @ self.w + self.b
        return z if is_last else torch.relu(z)


class SAGE(_Stack):
    """``sage_apply`` over ``num_layers`` layers."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 3, *, device=None):
        super().__init__()
        dims = _dims(in_dim, hidden, out_dim, num_layers)
        self.layers = nn.ModuleList(
            SAGELayer(dims[i], dims[i + 1], device=device)
            for i in range(num_layers))


def sage_init(key: rng_lib.Key, in_dim: int, hidden: int, out_dim: int,
              num_layers: int = 3, device="cuda") -> SAGE:
    """The reference's ``sage_init``, bit for bit."""
    model = SAGE(in_dim, hidden, out_dim, num_layers, device=device)
    keys = rng_lib.split(key, num_layers)
    with torch.no_grad():
        for k, layer in zip(keys, model.layers):
            layer.w.copy_(_dense_init(k, *layer.w.shape))
    return model


# ---------------------------------------------------------------------------
# GATv2 (Brody et al. 2022), multi-head (paper §A.6)
# ---------------------------------------------------------------------------

class GATv2Layer(nn.Module):
    """``heads`` attention heads of width ``per_head``: ``ws`` transforms
    the destination side, ``wt`` the source side, ``attn`` (heads,
    per_head) scores them, ``b`` is added after aggregation; ELU on all
    but the last layer. ``leaky`` is the scores' LeakyReLU (slope 0.2), a
    module so that a hook can read its output."""

    def __init__(self, d_in: int, heads: int, per_head: int, *, device=None):
        super().__init__()
        d_out = heads * per_head
        self.ws = _zeros(d_in, d_out, device=device)
        self.wt = _zeros(d_in, d_out, device=device)
        self.attn = _zeros(heads, per_head, device=device)
        self.b = _zeros(d_out, device=device)
        self.leaky = nn.LeakyReLU(0.2)

    def forward(self, blk, h: torch.Tensor, *, is_last: bool,
                backend: Optional[str] = None) -> torch.Tensor:
        """``gatv2_layer``, step by step."""
        H, P = self.attn.shape
        hs = h[: blk.seed_cap] @ self.ws                       # (S, H*P)
        ht = h @ self.wt                                       # (T, H*P)
        e = O.sddmm(blk, hs, ht, op="add", backend=backend)    # (E, H*P)
        e = self.leaky(e.view(-1, H, P))
        # einsum("ehp,hp->eh", e, attn) as one product with attn's
        # block-diagonal (H*P, H) matrix: cuBLAS runs einsum's backward
        # for attn as one GEMV over every edge, two orders of magnitude
        # slower than this GEMM at 9.4 M edges on the H100 (chip_smoke.py
        # phase 2 times both)
        attn_diag = torch.block_diag(*self.attn[:, :, None].unbind(0))
        logit = e.reshape(-1, H * P) @ attn_diag               # (E, H)
        alpha = O.edge_softmax(blk, logit, backend=backend)    # (E, H)
        msg = (O.gather_src(blk, ht, backend=backend).view(-1, H, P)
               * alpha[..., None])
        out = O.scatter_edges(blk, msg.view(-1, H * P), backend=backend)
        out = out + self.b
        return out if is_last else F.elu(out)


def _gatv2_shapes(in_dim, hidden, out_dim, num_layers, heads):
    """(d_in, heads, per_head) per layer: ``heads`` heads of
    ``hidden // heads`` on the hidden layers, one head of ``out_dim`` on
    the last."""
    shapes, d_in = [], in_dim
    for i in range(num_layers):
        last = i == num_layers - 1
        h, p = (1, out_dim) if last else (heads, max(hidden // heads, 1))
        shapes.append((d_in, h, p))
        d_in = h * p
    return shapes


class GATv2(_Stack):
    """``gatv2_apply`` over ``num_layers`` layers."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 3, heads: int = 8, *, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            GATv2Layer(d, h, p, device=device)
            for d, h, p in _gatv2_shapes(in_dim, hidden, out_dim, num_layers,
                                         heads))


def gatv2_init(key: rng_lib.Key, in_dim: int, hidden: int, out_dim: int,
               num_layers: int = 3, heads: int = 8, device="cuda") -> GATv2:
    """The reference's ``gatv2_init``: per layer ``split(fold_in(key, l),
    4)``, Glorot-uniform ``ws``/``wt`` bit for bit, ``attn`` = 0.1 x
    ``normal`` (bit for bit too, :func:`rng_lib.normal`), zero bias."""
    model = GATv2(in_dim, hidden, out_dim, num_layers, heads, device=device)
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            ks = rng_lib.split(rng_lib.fold_in(key, i), 4)
            layer.ws.copy_(_dense_init(ks[0], *layer.ws.shape))
            layer.wt.copy_(_dense_init(ks[1], *layer.wt.shape))
            layer.attn.copy_(rng_lib.normal(ks[2], layer.attn.shape) * 0.1)
    return model


#: model name -> (init, class), as the reference's ``MODELS``
MODELS = {"gcn": (gcn_init, GCN), "sage": (sage_init, SAGE),
          "gatv2": (gatv2_init, GATv2)}


def _shape(a):
    return tuple(np.shape(a))


def params_from_jax(tree, device="cuda", model: str = "gcn") -> nn.Module:
    """Load the reference's params of ``model`` (``{"layers": [...]}``
    with its per-layer names -- gcn ``w``/``b``/``wr``, sage ``w``/``b``,
    gatv2 ``ws``/``wt``/``attn``/``b`` -- as numpy arrays) into the
    port's model of that family, same layout."""
    layers = tree["layers"]
    n = len(layers)
    if model == "gatv2":
        heads, per_head = _shape(layers[0]["attn"])
        out = GATv2(_shape(layers[0]["ws"])[0], heads * per_head,
                    _shape(layers[-1]["attn"])[1], n,
                    heads if n > 1 else 1, device=device)
    else:
        rows = 2 if model == "sage" else 1
        dims = [_shape(layers[0]["w"])[0] // rows] + [_shape(p["w"])[1]
                                                      for p in layers]
        if any(d != dims[1] for d in dims[1:-1]):
            raise ValueError(f"hidden widths differ: {dims}")
        cls = MODELS[model][1]
        out = cls(dims[0], dims[1], dims[-1], n, device=device)
    with torch.no_grad():
        for layer, p in zip(out.layers, layers):
            for name, dst in layer.named_parameters():
                src = torch.from_numpy(np.array(p[name], np.float32))
                if dst.shape != src.shape:
                    raise ValueError(f"{name}: {tuple(src.shape)} vs "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    return out.eval()
