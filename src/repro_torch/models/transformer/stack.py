"""Layer-stack assembly (twin of ``repro.models.transformer.stack``):
init / forward / prefill / decode over the repeating ``layer_pattern``.

The layers run as a Python loop over the pattern's repeats (no scan, no
remat). Parameters are ``{"embed", "final_norm", ["lm_head"], "layers"}``
with ``layers[i][r]`` the parameter dict of pattern entry ``i`` in repeat
``r``; :func:`params_from_jax` carries the reference's parameters
(either of its layouts) into it. The decode cache is the reference's:
one ``{"k", "v"}`` per pattern entry, each (repeats, B, S, Hkv, hd).

``backend`` selects the attention of the full-sequence paths
(``forward``, ``prefill``): ``"cuda"`` the flash kernel, ``"eager"`` the
plain version; ``None``/``"auto"`` resolves by the tokens' device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.ops.backend import resolve_backend

ATTN_KINDS = ("attn", "attn_local", "attn_global")


def _check_ported(cfg: TransformerConfig) -> None:
    for i, kind in enumerate(cfg.layer_pattern):
        if kind not in ATTN_KINDS:
            raise L.not_ported(f"the {kind!r} block of {cfg.name}")
        if cfg.mixer_for(i) not in ("mlp", "none"):
            raise L.not_ported(f"the {cfg.mixer_for(i)!r} mixer of "
                               f"{cfg.name}")
    if cfg.encoder is not None or cfg.is_encoder:
        raise L.not_ported(f"the encoder of {cfg.name}")


def _entry_init(key, cfg: TransformerConfig, kind: str, mixer: str, device):
    p: Dict[str, Any] = {
        "mix": L.attn_init(rng_lib.fold_in(key, 1), cfg, device=device)}
    if mixer == "mlp":
        p["ffn"] = L.mlp_init(rng_lib.fold_in(key, 2), cfg, device=device)
    return p


def init_params(key, cfg: TransformerConfig, device="cpu") -> Dict[str, Any]:
    """The reference's ``init_params(key, cfg)`` on ``device``, with its
    key schedule: per pattern entry ``ek = fold_in(keys[2], i)``, repeat
    ``r`` drawn from ``split(ek, repeats)[r]`` when ``cfg.scan_layers``
    (the reference vmaps over those keys) and from ``fold_in(ek, r)``
    otherwise. Every draw is bit for bit the reference's."""
    _check_ported(cfg)
    dt = L._dtype(cfg)
    keys = rng_lib.split(key, 8)
    embed = rng_lib.normal(keys[0], (cfg.vocab, cfg.d_model), device=device)
    embed.mul_(torch.tensor(0.02, dtype=torch.float32, device=device))
    params: Dict[str, Any] = {"embed": embed.to(dt),
                              "final_norm": L.norm_init(cfg, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(keys[1], cfg.d_model, cfg.vocab, dt,
                                         device=device)
    entries = []
    for i, kind in enumerate(cfg.layer_pattern):
        ek = rng_lib.fold_in(keys[2], i)
        rkeys = (rng_lib.split(ek, cfg.repeats) if cfg.scan_layers
                 else [rng_lib.fold_in(ek, r) for r in range(cfg.repeats)])
        entries.append([_entry_init(k, cfg, kind, cfg.mixer_for(i), device)
                        for k in rkeys])
    params["layers"] = entries
    return params


def params_from_jax(params_np, cfg: TransformerConfig, device="cpu"):
    """The reference's parameters, as nested dicts/lists of numpy arrays,
    in the port's layout. Takes both of the reference's layouts of
    ``layers``: per pattern entry a dict of leaves stacked over repeats
    (``scan_layers=True``) or a list of per-repeat dicts."""
    _check_ported(cfg)

    def conv(tree, r=None):
        if isinstance(tree, dict):
            return {k: conv(v, r) for k, v in tree.items()}
        a = np.asarray(tree)
        return torch.from_numpy(np.array(a if r is None else a[r])).to(device)

    out = {k: conv(v) for k, v in params_np.items() if k != "layers"}
    out["layers"] = [
        [conv(e) for e in entry] if isinstance(entry, (list, tuple))
        else [conv(entry, r) for r in range(cfg.repeats)]
        for entry in params_np["layers"]]
    return out


def _layers(params, cfg: TransformerConfig):
    """(repeat, pattern index, kind, params) in the order of the stack."""
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.layer_pattern):
            yield r, i, kind, params["layers"][i][r]


# ---------------------------------------------------------------------------
# forward (training / full-sequence)
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: TransformerConfig):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model), dtype=x.dtype,
                             device=x.device) ** 0.5
    return x


def logits_head(params, x, cfg: TransformerConfig):
    x = L.norm_apply(params["final_norm"], x, cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.final_softcap is not None:
        c = cfg.final_softcap
        logits = torch.tanh(logits.to(L._math(logits)) / c) * c
    if logits.dtype == torch.float64:   # the fp64 yardstick stays fp64
        return logits
    return logits.to(L._DTYPES[cfg.logit_dtype])


def forward(params, tokens, cfg: TransformerConfig,
            backend: Optional[str] = None):
    """tokens: integer (B, S) -> logits (B, S, V)."""
    _check_ported(cfg)
    backend = resolve_backend(backend, tokens.device)
    x = embed_tokens(params, tokens, cfg)
    for _, i, kind, p in _layers(params, cfg):
        x = L.attn_apply(p["mix"], x, cfg, kind=kind, backend=backend)
        if cfg.mixer_for(i) == "mlp":
            x = L.mlp_apply(p["ffn"], x, cfg)
    return logits_head(params, x, cfg)


# ---------------------------------------------------------------------------
# kv caches, prefill & decode
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device="cpu") -> List[Dict[str, torch.Tensor]]:
    """Zero K/V caches, one {"k", "v"} of (repeats, B, max_seq, Hkv, hd)
    per pattern entry."""
    _check_ported(cfg)
    dt = L._dtype(cfg)
    shape = (cfg.repeats, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in cfg.layer_pattern]


def widen_cache(cache, extra: int):
    """The cache with ``extra`` zero positions appended (room for the
    tokens to generate); each entry's old tensors are freed as it goes."""
    out = []
    for entry in cache:
        out.append({n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra))
                    for n, t in entry.items()})
        entry.clear()
    return out


def prefill(params, tokens, cfg: TransformerConfig,
            backend: Optional[str] = None):
    """Full-sequence forward that also fills the decode caches. Returns
    (last_logits (B, V), cache). On ``cuda`` every layer's attention is
    one launch of the flash kernel."""
    _check_ported(cfg)
    backend = resolve_backend(backend, tokens.device)
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)[None]
    cache = init_cache(cfg, B, S, device=tokens.device)
    for r, i, kind, p in _layers(params, cfg):
        mix = p["mix"]
        h = L.norm_apply(mix["pre_norm"], x, cfg)
        q, k, v = L._qkv(mix, h, h, cfg)
        q = L.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = L.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        window = cfg.window if kind == "attn_local" else None
        out = L.self_attention(q, k, v, cfg, causal=True, window=window,
                               backend=backend)
        del q, h
        out = out.reshape(B, S, cfg.q_dim) @ mix["wo"]
        if cfg.post_norms:
            out = L.norm_apply(mix["post_norm"], out, cfg)
        x = x + out
        del out
        cache[i]["k"][r] = k
        cache[i]["v"][r] = v
        del k, v
        if cfg.mixer_for(i) == "mlp":
            x = L.mlp_apply(p["ffn"], x, cfg)
    logits = logits_head(params, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, tokens, cache, pos: int, cfg: TransformerConfig):
    """One decode step. tokens: (B, 1); pos: the write position (attends
    to cache[<= pos]). Updates ``cache`` in place and returns
    (logits (B, V), cache)."""
    _check_ported(cfg)
    x = embed_tokens(params, tokens, cfg)
    for r, i, kind, p in _layers(params, cfg):
        entry = {n: t[r] for n, t in cache[i].items()}
        x, _ = L.attn_decode(p["mix"], x, entry, pos, cfg, kind=kind)
        if cfg.mixer_for(i) == "mlp":
            x = L.mlp_apply(p["ffn"], x, cfg)
    logits = logits_head(params, x, cfg)
    return logits[:, 0], cache
