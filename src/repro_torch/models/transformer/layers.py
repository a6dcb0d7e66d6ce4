"""Transformer building blocks (twin of
``repro.models.transformer.layers``): norms, rotary embeddings, GQA
attention with a sliding window and a logit softcap, gated MLPs,
scatter-dispatch MoE with the optional LABOR-style Poisson capacity, and
Mamba2's chunked SSD. Parameters are plain dicts of tensors, the
reference's layout.

Attention on the full-sequence paths (:func:`attn_apply`, and the
prefill of ``stack``) takes a graph-ops style backend: ``"cuda"`` runs
every causal self-attention through the flash kernel (B9,
``kernels/flash_attention``), ``"eager"`` through :func:`_attend_flags`,
the reference's plain path. Cross-attention (``kind="xattn"``: K/V from
the encoder's output or another source, no rotary, no mask) and an
encoder's self-attention (``cfg.is_encoder``: no causal mask) are not
causal, so they take the plain path on both backends, as the
reference's ``use_flash`` does. One-token decode (:func:`attn_decode`)
is plain torch on both, as in the reference. MoE and Mamba2 are plain
torch on both backends: the reference has no kernel for them.

The math runs in float32 for float32 and bfloat16 inputs, as the
reference's, and in float64 for float64 inputs (the fp64 yardstick of
``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import rng as rng_lib
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

def attn_init(key, cfg: TransformerConfig, cross: bool = False,
              device="cpu"):
    """One attention block's parameters; ``cross``: ``wk``/``wv`` take
    the source's width (``xattn_source_dim``, else ``d_model``)."""
    ks = rng_lib.split(key, 6)
    dt = _dtype(cfg)
    kv_in = (cfg.xattn_source_dim or cfg.d_model) if cross else cfg.d_model
    p = {
        "wq": dense_init(ks[0], cfg.d_model, cfg.q_dim, dt, device=device),
        "wk": dense_init(ks[1], kv_in, cfg.kv_dim, dt, device=device),
        "wv": dense_init(ks[2], kv_in, cfg.kv_dim, dt, device=device),
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
               positions=None, xsource=None, backend: str = "eager"):
    """Training/prefill path. x: (B,S,d). ``kind="xattn"``: K/V from
    ``xsource`` (B, Sx, source width), no rotary, no mask."""
    B, S, _ = x.shape
    h = norm_apply(p["pre_norm"], x, cfg)
    cross = kind == "xattn"
    if cross and xsource is None:
        raise ValueError(f"{cfg.name}: a cross-attention block needs "
                         "xsource")
    q, k, v = _qkv(p, h, xsource if cross else h, cfg)
    if not cross:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None]
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    window = cfg.window if kind == "attn_local" else None
    out = self_attention(q, k, v, cfg, causal=not (cross or cfg.is_encoder),
                         window=window, backend=backend)
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"]
    if cfg.post_norms:
        out = norm_apply(p["post_norm"], out, cfg)
    return x + out


def attn_decode(p, x, cache, pos: int, cfg: TransformerConfig, *,
                kind="attn", xkv=None):
    """One-token decode. x: (B,1,d); cache: {"k","v"}: (B,Smax,Hkv,hd);
    pos: the current position. Writes the new K/V into the cache in
    place (the reference returns an updated copy) and returns
    (x + attention, cache). ``kind="xattn"``: only q is projected, K/V
    are the prefill's cross K/V ``xkv`` (no mask) and ``cache`` is
    returned as it came."""
    B = x.shape[0]
    h = norm_apply(p["pre_norm"], x, cfg)
    if kind == "xattn":
        q = h @ p["wq"]
        if cfg.qkv_bias:
            q = q + p["bq"]
        q = q.reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k, v = xkv
        mask = None
    else:
        q, k_new, v_new = _qkv(p, h, h, cfg)
        posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        q = rope(q, posv, cfg.rope_theta, cfg.rope_fraction)
        k_new = rope(k_new, posv, cfg.rope_theta, cfg.rope_fraction)
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        kpos = torch.arange(k.shape[1], device=x.device)[None, None]
        m = kpos <= pos                                       # (1,1,Sk)
        if kind == "attn_local" and cfg.window is not None:
            m = m & (pos - kpos < cfg.window)
        mask = m[:, :, None]
    out = _attend_direct(q, k, v, cfg, mask)
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


# ---------------------------------------------------------------------------
# MoE: scatter dispatch with capacity; optional LABOR Poisson capacity
# ---------------------------------------------------------------------------

#: the reference's default salt of the Poisson capacity's per-(token,
#: expert) draws
MOE_SALT = 0x9E3779B9


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def moe_init(key, cfg: TransformerConfig, device="cpu"):
    m = cfg.moe
    ks = rng_lib.split(key, 6)
    dt = _dtype(cfg)
    E, d, f = m.num_experts, cfg.d_model, m.d_expert
    scale = _f32(1.0 / math.sqrt(d), device)
    # a 0-d device tensor as divisor: a Python one is a reciprocal
    # multiply on the card
    root_f = _f32(math.sqrt(f), device)
    p = {
        "router": dense_init(ks[0], d, E, torch.float32, device=device),
        "ewi": (rng_lib.normal(ks[1], (E, d, f), device) * scale).to(dt),
        "ewg": (rng_lib.normal(ks[2], (E, d, f), device) * scale).to(dt),
        "ewo": (rng_lib.normal(ks[3], (E, f, d), device) / root_f).to(dt),
        "pre_norm": norm_init(cfg, device=device),
    }
    if m.shared_expert:
        p["shared_wi"] = dense_init(ks[4], d, f, dt, device=device)
        p["shared_wg"] = dense_init(ks[5], d, f, dt, device=device)
        p["shared_wo"] = dense_init(rng_lib.fold_in(ks[4], 1), f, d, dt,
                                    device=device)
    return p


def _moe_capacity(m: MoEConfig, tokens: int) -> int:
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor) + 8
    return min(max(c - c % -8, 8), tokens)  # round up to 8


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` makes no
    promise on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(probs: torch.Tensor, m: MoEConfig, C: int,
              salt: int = MOE_SALT):
    """The reference's group-local routing of ``moe_apply`` on the router
    probabilities ``probs`` (B, S, E): per batch row, each token's top-k
    experts, the position of each (token, j) in its expert's queue by a
    cumsum along the sequence, and the capacity ``C``. With
    ``m.poisson_capacity`` an oversubscribed expert keeps each token
    with probability C / n_e (a hash draw per (token, expert), LABOR's
    variance-matched keep) and weights it by the inverse; else the first
    C in queue order are kept. Returns experts (B, S, k) int64, and
    slots (expert * C + position; int64), keep masks and weights
    (keep x gate x the Poisson correction), each (B, k, S)."""
    B, S, E = probs.shape
    k = m.top_k
    dev = probs.device
    gates, experts = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(B, E, dtype=torch.int64, device=dev)
    token_ids = torch.arange(B * S, device=dev).reshape(B, S)
    cap = torch.tensor(float(C), dtype=probs.dtype, device=dev)
    slots, keeps, ws = [], [], []
    for j in range(k):
        ex = experts[..., j]                                    # (B,S)
        oh = F.one_hot(ex, E)                                   # (B,S,E)
        pos_te = torch.cumsum(oh, 1) - oh + counts[:, None, :]
        pos_j = torch.gather(pos_te, -1, ex[..., None])[..., 0]
        counts = counts + oh.sum(1)
        if m.poisson_capacity:
            n_tok = torch.gather(counts.to(probs.dtype), 1, ex)
            p_keep = torch.clamp(cap / torch.clamp(n_tok, min=1.0), max=1.0)
            r = rng_lib.hash_uniform_edge(salt, token_ids, ex)
            sel = r < p_keep
            oh_kept = oh * sel[..., None]
            pos_te = torch.cumsum(oh_kept, 1) - oh_kept
            pos_j = torch.gather(pos_te, -1, ex[..., None])[..., 0]
            keep = sel & (pos_j < C)
            w = torch.where(keep, torch.ones_like(p_keep) / p_keep,
                            torch.zeros_like(p_keep))
        else:
            keep = pos_j < C
            w = keep.to(probs.dtype)
        slots.append(ex * C + pos_j)
        keeps.append(keep)
        ws.append(w * gates[..., j])
    return (experts, torch.stack(slots, 1), torch.stack(keeps, 1),
            torch.stack(ws, 1))


def moe_apply(p, x, cfg: TransformerConfig, salt: int = MOE_SALT):
    """Scatter-dispatch MoE with group-local routing (:func:`moe_route`).
    x: (B, S, d). Each kept (token, j) is added into its expert slot of a
    (B, E * C, d) buffer (``index_add``: each slot takes one token, the
    dropped ones add zeros to slot 0), the experts run as batched
    products over (E, C), and each token sums its k slots' outputs
    weighted by :func:`moe_route`'s weights, plus the shared expert."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    C = _moe_capacity(m, S)
    md = _math(x)
    h = norm_apply(p["pre_norm"], x, cfg)
    probs = torch.softmax(h.to(md) @ p["router"].to(md), dim=-1)
    _, slots, keeps, ws = moe_route(probs, m, C, salt)
    idx = torch.where(keeps, slots, 0)                          # (B,k,S)
    flat = (idx + torch.arange(B, device=x.device)[:, None, None]
            * (E * C)).reshape(-1)
    src = (h[:, None] * keeps[..., None].to(h.dtype)).reshape(-1, d)
    xd = torch.zeros(B * E * C, d, dtype=h.dtype,
                     device=x.device).index_add(0, flat, src)
    xe = xd.view(B, E, C, d)
    up = torch.einsum("becd,edf->becf", xe, p["ewi"])
    gate = torch.einsum("becd,edf->becf", xe, p["ewg"])
    ye = torch.einsum("becf,efd->becd", _act(cfg, gate) * up, p["ewo"])
    got = ye.reshape(B * E * C, d)[flat].view(B, k, S, d)
    out = torch.einsum("bksd,bks->bsd", got.to(md), ws.to(md))
    if m.shared_expert:
        sup = _act(cfg, h @ p["shared_wg"]) * (h @ p["shared_wi"])
        out = out + (sup @ p["shared_wo"]).to(md)
    return x + out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked -- Dao & Gu 2024 state-space duality form)
# ---------------------------------------------------------------------------

def _a_log(nh: int, device) -> torch.Tensor:
    """``log(jnp.linspace(1, 16, nh))`` in float32 as the reference
    computes it on the CPU, bit for bit (checked for every nh up to 352;
    the registry's are 8 reduced, 32 and 80). XLA simplifies jnp's
    ``1 * (1 - i / div) + 16 * (i / div)`` into ``fma(i, 16 r, 1 - i r)``
    with ``r = 1 / div`` in float32 (a division by a constant becomes a
    product by its reciprocal, and LLVM contracts the last product into
    the add), the end point 16 appended; XLA's log is :func:`rng.log`
    (``torch.log`` is correctly rounded and differs in the last bit).
    Computed on the CPU, then moved."""
    if nh == 1:
        lin = torch.ones(1)
    else:
        i = torch.arange(nh - 1, dtype=torch.float32)
        r = _f32(1.0, "cpu") / _f32(nh - 1, "cpu")
        lin = torch.cat([rng_lib.fma(i, (16.0 * r).expand_as(i), 1.0 - i * r),
                         torch.full((1,), 16.0)])
    return rng_lib.log(lin).to(device)


def mamba_init(key, cfg: TransformerConfig, device="cpu"):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    ks = rng_lib.split(key, 4)
    dt = _dtype(cfg)
    return {
        "in_proj": dense_init(ks[0], d,
                              2 * d_in + 2 * s.n_groups * s.d_state + nh, dt,
                              device=device),
        "conv_w": (rng_lib.normal(ks[1], (s.d_conv, conv_dim), device)
                   * _f32(0.2, device)).to(dt),
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "A_log": _a_log(nh, device),
        "D": torch.ones(nh, dtype=torch.float32, device=device),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=device),
        "out_proj": dense_init(ks[2], d_in, d, dt, device=device),
        "pre_norm": norm_init(cfg, device=device),
        "gate_norm": {"scale": torch.zeros(d_in, dtype=dt, device=device)},
    }


def _segsum(x):
    """log-space segment sums: out[..., i, j] = sum_{j<m<=i} x[..., m],
    -inf above the diagonal (its exp is 0, and so is its gradient)."""
    T = x.shape[-1]
    xc = torch.cumsum(x, -1)
    out = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return torch.where(mask, out, torch.tensor(-math.inf, dtype=x.dtype,
                                               device=x.device))


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dtv, A, Bm, Cm, chunk, init_state=None):
    """SSD forward. x: (b, s, h, p); dtv: (b, s, h) after softplus; A:
    (h,) negative; Bm, Cm: (b, s, g, n). Returns y (b, s, h, p) and the
    final state (b, h, p, n). A length that is no multiple of ``chunk``
    is padded with dt = 0 steps (decay 1, no contribution to the state).
    The reference's scan over chunks is a loop here."""
    b, s, h, pdim = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    md = dtv.dtype      # float32, float64 on the fp64 yardstick
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk
    rep = h // g

    xr = x.reshape(b, nc, chunk, h, pdim)
    dtr = dtv.reshape(b, nc, chunk, h)
    Br = Bm.reshape(b, nc, chunk, g, n)
    Cr = Cm.reshape(b, nc, chunk, g, n)
    dA = dtr * A[None, None, None, :]             # (b,nc,Q,h) negative
    dA_cum = torch.cumsum(dA, 2)

    # intra-chunk (diagonal blocks): Y[i] += C_i . B_j^T exp(seg) dt_j x_j
    Lm = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))          # (b,nc,h,Q,Q)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cr, Br)          # (b,nc,g,Q,Q)
    CB = CB.repeat_interleave(rep, dim=2)                    # (b,nc,h,Q,Q)
    dtx = xr * dtr[..., None]                                # (b,nc,Q,h,p)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", (CB * Lm).to(x.dtype), dtx)

    # chunk states: S_c = sum_j exp(dA_cum[end] - dA_cum[j]) dt_j B_j x_j^T
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (b,nc,Q,h)
    Brep = Br.repeat_interleave(rep, dim=3).to(md)           # groups -> heads
    SB = torch.einsum("bcqhn,bcqhp->bchpn",
                      Brep * (dtr * decay_to_end).to(md)[..., None],
                      xr.to(md))                             # (b,nc,h,p,n)

    # inter-chunk recurrence; each chunk reads the state at its start
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])             # (b,nc,h)
    state = (torch.zeros(b, h, pdim, n, dtype=md, device=x.device)
             if init_state is None else init_state)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, c, :, None, None] + SB[:, c]
    prev_states = torch.stack(starts, 1)                     # (b,nc,h,p,n)

    # inter-chunk output: C_i . state_start * exp(dA_cum[i])
    Crep = Cr.repeat_interleave(rep, dim=3).to(md)
    y_inter = (torch.einsum("bcqhn,bchpn->bcqhp", Crep, prev_states)
               * torch.exp(dA_cum)[..., None])
    y = y_intra.to(md) + y_inter
    return y.reshape(b, s, h, pdim)[:, :s_orig], state


def dataclass_rms(cfg):
    """cfg view forcing rmsnorm (the Mamba gate norm is always RMS)."""
    return (dataclasses.replace(cfg, norm="rmsnorm")
            if cfg.norm != "rmsnorm" else cfg)


def mamba_apply(p, x, cfg: TransformerConfig, conv_state=None,
                ssm_state=None, decode: bool = False):
    """Mamba2 block. Train/prefill: x (B, S, d), returns (y, (conv_state,
    ssm_state)). Decode: x (B, 1, d) with both states given."""
    s = cfg.ssm
    B = x.shape[0]
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    gdim = s.n_groups * s.d_state
    md = _math(x)
    h = norm_apply(p["pre_norm"], x, cfg)
    zxbcdt = h @ p["in_proj"]
    z, xbc, dtv = torch.split(zxbcdt, [d_in, d_in + 2 * gdim, nh], dim=-1)
    A = -torch.exp(p["A_log"].to(md))

    if not decode:
        S = x.shape[1]
        # causal depthwise conv over (B, S, conv_dim)
        pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
        conv_state_out = pad[:, -(s.d_conv - 1):] if s.d_conv > 1 else None
        xbc_c = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(s.d_conv))
        xbc_c = F.silu(xbc_c + p["conv_b"])
        xs, Bm, Cm = torch.split(xbc_c, [d_in, gdim, gdim], dim=-1)
        xs = xs.reshape(B, S, nh, s.head_dim)
        Bm = Bm.reshape(B, S, s.n_groups, s.d_state)
        Cm = Cm.reshape(B, S, s.n_groups, s.d_state)
        dtv = _softplus(dtv.to(md) + p["dt_bias"].to(md))
        y, fin = ssd_chunked(xs, dtv, A, Bm, Cm, s.chunk, ssm_state)
        y = y + xs.to(md) * p["D"].to(md)[None, None, :, None]
        y = y.reshape(B, S, d_in).to(x.dtype)
        y = norm_apply({"scale": p["gate_norm"]["scale"]}, y * F.silu(z),
                       dataclass_rms(cfg))
        return x + y @ p["out_proj"], (conv_state_out, fin)

    # single-token decode
    conv_in = torch.cat([conv_state.to(xbc.dtype), xbc], 1)  # (B,d_conv,C)
    new_conv_state = conv_in[:, 1:]
    xbc_c = torch.sum(conv_in * p["conv_w"][None], 1, keepdim=True)
    xbc_c = F.silu(xbc_c + p["conv_b"])
    xs, Bm, Cm = torch.split(xbc_c[:, 0], [d_in, gdim, gdim], dim=-1)
    xs = xs.reshape(B, nh, s.head_dim)
    Bm = Bm.reshape(B, s.n_groups, s.d_state)
    Cm = Cm.reshape(B, s.n_groups, s.d_state)
    dtv = _softplus(dtv[:, 0].to(md) + p["dt_bias"].to(md))     # (B,nh)
    rep = nh // s.n_groups
    dec = torch.exp(dtv * A[None])                               # (B,nh)
    Brep = Bm.repeat_interleave(rep, dim=1).to(md)               # (B,nh,n)
    Bx = ((Brep * dtv[..., None])[:, :, None, :]
          * xs.to(md)[..., None])                                # (B,nh,p,n)
    new_ssm = ssm_state.to(md) * dec[..., None, None] + Bx
    Crep = Cm.repeat_interleave(rep, dim=1).to(md)
    y = torch.einsum("bhn,bhpn->bhp", Crep, new_ssm)
    y = y + xs.to(md) * p["D"].to(md)[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = norm_apply({"scale": p["gate_norm"]["scale"]}, y * F.silu(z),
                   dataclass_rms(cfg))
    return x + y @ p["out_proj"], (new_conv_state, new_ssm)


def mamba_cache_spec(cfg: TransformerConfig, batch, device="cpu"):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=_dtype(cfg),
                            device=device),
        "ssm": torch.zeros(batch, nh, s.head_dim, s.d_state,
                           dtype=torch.float32, device=device),
    }
