"""Transformer building blocks of the dense families (twin of
``repro.models.transformer.layers``): norms, rotary embeddings, GQA
attention with a sliding window and a logit softcap, gated MLPs.
Parameters are plain dicts of tensors, the reference's layout.

Attention on the full-sequence paths (:func:`attn_apply`, and the
prefill of ``stack``) takes a graph-ops style backend: ``"cuda"`` runs
every causal self-attention through the flash kernel (B9,
``kernels/flash_attention``), ``"eager"`` through :func:`_attend_flags`,
the reference's plain path. One-token decode (:func:`attn_decode`) is
plain torch on both, as in the reference. MoE, Mamba, shared-attention
and cross-attention blocks are not ported yet (``ROADMAP.md``).

The math runs in float32 for float32 and bfloat16 inputs, as the
reference's, and in float64 for float64 inputs (the fp64 yardstick of
``chip_smoke.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import rng as rng_lib
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.transformer.config import TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (see ROADMAP.md §A)")


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _math(x: torch.Tensor) -> torch.dtype:
    """float32 math, float64 for float64 tensors."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def dense_init(key, d_in, d_out, dtype, scale=None, device="cpu"):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = rng_lib.normal(key, (d_in, d_out), device=device)
    return (w * torch.tensor(scale, dtype=torch.float32,
                             device=device)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: TransformerConfig, d=None, device="cpu"):
    d = d or cfg.d_model
    dt = _dtype(cfg)
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, dtype=dt, device=device),
                "bias": torch.zeros(d, dtype=dt, device=device)}
    # rmsnorm stores (scale - 1)
    return {"scale": torch.zeros(d, dtype=dt, device=device)}


def norm_apply(p, x, cfg: TransformerConfig, eps=1e-6):
    md = _math(x)
    xf = x.to(md)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].to(md) + p["bias"].to(md)).to(x.dtype)
    ms = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + p["scale"].to(md))).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta, fraction=1.0):
    """x: (..., S, H, hd); positions: (..., S) integers. Rotates the
    first ``fraction`` of the head dimension (stablelm's partial
    rotary), in two halves."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    md = _math(x)
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=md, device=x.device)
                      / half * math.log(theta))
    ang = positions.to(md)[..., None, None] * freqs   # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(key, cfg: TransformerConfig, device="cpu"):
    ks = rng_lib.split(key, 6)
    dt = _dtype(cfg)
    p = {
        "wq": dense_init(ks[0], cfg.d_model, cfg.q_dim, dt, device=device),
        "wk": dense_init(ks[1], cfg.d_model, cfg.kv_dim, dt, device=device),
        "wv": dense_init(ks[2], cfg.d_model, cfg.kv_dim, dt, device=device),
        "wo": dense_init(ks[3], cfg.q_dim, cfg.d_model, dt, device=device),
        "pre_norm": norm_init(cfg, device=device),
    }
    if cfg.qkv_bias:
        for n, d in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                     ("bv", cfg.kv_dim)):
            p[n] = torch.zeros(d, dtype=dt, device=device)
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, device=device)
    return p


def _qkv(p, x, kv_x, cfg: TransformerConfig):
    B = x.shape[0]
    q = x @ p["wq"]
    k = kv_x @ p["wk"]
    v = kv_x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, -1, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, -1, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


ATTN_CHUNK_Q = 1024  # q-chunked attention kicks in above this seq length


def _scale(cfg: TransformerConfig, hd: int) -> float:
    return cfg.query_scale if cfg.query_scale is not None else \
        1.0 / math.sqrt(hd)


def _attend_direct(q, k, v, cfg: TransformerConfig, mask):
    """q: (B,Sq,H,hd); k,v: (B,Sk,Hkv,hd); mask broadcastable to
    (B,1,Sq,Sk) or None. GQA via head grouping."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    md = _math(q)
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.to(md),
                          k.to(md)) * _scale(cfg, hd)
    if cfg.attn_softcap is not None:
        c = cfg.attn_softcap
        scores = torch.tanh(scores / c) * c
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores,
                             torch.tensor(-1e30, dtype=md, device=q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _attend_flags(q, k, v, cfg: TransformerConfig, *, causal, window,
                  chunk_q: int = ATTN_CHUNK_Q):
    """Mask-by-flags attention; q-chunked above ``chunk_q`` (when Sq is a
    multiple of it) so the (Sq, Sk) score tensor never materialises --
    the reference's XLA analogue of the flash kernel, and the plain
    version of the full-sequence paths."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def mask_for(q_lo, sq):
        if not causal and window is None:
            return None
        qpos = q_lo + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        m = torch.ones(sq, Sk, dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window is not None:
            m &= qpos - kpos < window
        return m[None, None]

    if Sq <= chunk_q or Sq % chunk_q != 0:
        return _attend_direct(q, k, v, cfg, mask_for(0, Sq))
    out = torch.empty_like(q)
    for lo in range(0, Sq, chunk_q):
        out[:, lo:lo + chunk_q] = _attend_direct(
            q[:, lo:lo + chunk_q], k, v, cfg, mask_for(lo, chunk_q))
    return out


def causal_mask(Sq, Sk, q_offset=0, window=None, device="cpu"):
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (qpos - kpos < window)
    return m[None, None]  # (1,1,Sq,Sk)


def self_attention(q, k, v, cfg: TransformerConfig, *, causal, window,
                   backend: str):
    """The full-sequence attention of one layer: the flash kernel on the
    ``cuda`` backend for a causal call, else :func:`_attend_flags`."""
    if backend == "cuda" and causal:
        return flash_ops.flash_attention(q, k, v, True, window,
                                         cfg.attn_softcap,
                                         _scale(cfg, cfg.head_dim))
    return _attend_flags(q, k, v, cfg, causal=causal, window=window)


def attn_apply(p, x, cfg: TransformerConfig, *, kind: str = "attn",
               positions=None, backend: str = "eager"):
    """Training/prefill path. x: (B,S,d)."""
    B, S, _ = x.shape
    h = norm_apply(p["pre_norm"], x, cfg)
    q, k, v = _qkv(p, h, h, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    window = cfg.window if kind == "attn_local" else None
    out = self_attention(q, k, v, cfg, causal=not cfg.is_encoder,
                         window=window, backend=backend)
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    if cfg.post_norms:
        out = norm_apply(p["post_norm"], out, cfg)
    return x + out


def attn_decode(p, x, cache, pos: int, cfg: TransformerConfig, *,
                kind="attn"):
    """One-token decode. x: (B,1,d); cache: {"k","v"}: (B,Smax,Hkv,hd);
    pos: the current position. Writes the new K/V into the cache in
    place (the reference returns an updated copy) and returns
    (x + attention, cache)."""
    B = x.shape[0]
    h = norm_apply(p["pre_norm"], x, cfg)
    q, k_new, v_new = _qkv(p, h, h, cfg)
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = rope(q, posv, cfg.rope_theta, cfg.rope_fraction)
    k_new = rope(k_new, posv, cfg.rope_theta, cfg.rope_fraction)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    kpos = torch.arange(k.shape[1], device=x.device)[None, None]  # (1,1,Sk)
    m = kpos <= pos
    if kind == "attn_local" and cfg.window is not None:
        m = m & (pos - kpos < cfg.window)
    out = _attend_direct(q, k, v, cfg, m[:, :, None])
    out = out.reshape(B, 1, cfg.q_dim) @ p["wo"]
    if cfg.post_norms:
        out = norm_apply(p["post_norm"], out, cfg)
    return x + out, cache


def attn_cache_spec(cfg: TransformerConfig, batch, seq, device="cpu"):
    dt = _dtype(cfg)
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------

def _act(cfg: TransformerConfig, x):
    if cfg.activation == "silu":
        return F.silu(x)
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if cfg.activation == "relu2":
        return F.relu(x).square()
    raise ValueError(cfg.activation)


def mlp_init(key, cfg: TransformerConfig, d_ff=None, device="cpu"):
    d_ff = d_ff or cfg.d_ff
    ks = rng_lib.split(key, 3)
    dt = _dtype(cfg)
    gated = cfg.gated_mlp and cfg.activation != "relu2"
    p = {
        "wi": dense_init(ks[0], cfg.d_model, d_ff, dt, device=device),
        "wo": dense_init(ks[1], d_ff, cfg.d_model, dt, device=device),
        "pre_norm": norm_init(cfg, device=device),
    }
    if gated:
        p["wg"] = dense_init(ks[2], cfg.d_model, d_ff, dt, device=device)
    if cfg.post_norms:
        p["post_norm"] = norm_init(cfg, device=device)
    return p


def mlp_apply(p, x, cfg: TransformerConfig):
    h = norm_apply(p["pre_norm"], x, cfg)
    up = h @ p["wi"]
    if "wg" in p:
        up = _act(cfg, h @ p["wg"]) * up
    else:
        up = _act(cfg, up)
    out = up @ p["wo"]
    if cfg.post_norms:
        out = norm_apply(p["post_norm"], out, cfg)
    return x + out
