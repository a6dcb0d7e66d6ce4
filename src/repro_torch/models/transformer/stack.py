"""Layer-stack assembly (twin of ``repro.models.transformer.stack``):
init / forward / prefill / decode over the repeating ``layer_pattern``:
attention (``attn``, ``attn_local``, ``attn_global``), cross-attention
(``xattn``), Mamba2 (``mamba``) and zamba2's shared attention
(``shared_attn``), each followed by its mixer (``mlp``, ``moe`` or
none). An encoder-decoder (whisper) carries its encoder's config in
``cfg.encoder`` (``is_encoder``: no causal mask, no decode step):
:func:`encode` runs it over ``xsource``, the precomputed frame
embeddings (the frontend is a stub, as in the reference), and its output
is every ``xattn`` block's source. Without an encoder ``xsource`` is
the source itself (a VLM's patch embeddings).

The layers run as a Python loop over the pattern's repeats (no scan).
Parameters are ``{"embed", "final_norm", ["lm_head"], "layers",
["shared"], ["encoder"]}`` with ``layers[i][r]`` the parameter dict of
pattern entry ``i`` in repeat ``r``; ``shared`` is zamba2's one
``{"attn", "mlp"}`` set, used by every ``shared_attn`` entry (its
gradient sums over the uses); ``encoder`` is the encoder's own tree of
this layout. :func:`params_from_jax` carries the reference's parameters
(either of its layouts) into it. The decode cache is the reference's:
per pattern entry ``{"k", "v"}`` of (repeats, B, S, Hkv, hd), the cross
K/V ``{"xk", "xv"}`` of (repeats, B, source length, Hkv, hd), filled by
the prefill and read by every decode step, or Mamba2's ``{"conv",
"ssm"}`` of (repeats, B, d_conv - 1, conv_dim) and (repeats, B, heads,
head_dim, d_state).

With ``cfg.remat`` and gradients on, :func:`forward` runs each repeat's
group under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` over ``group_fn``): its activations are recomputed in
the backward, so each attention layer runs twice a step. The
reference's ``remat_policy="dots"`` (keep the products' outputs) saves
memory traffic, not results; it is treated as ``"full"`` here.

``backend`` selects the causal self-attention of the full-sequence
paths (``forward``, ``prefill``): ``"cuda"`` the flash kernel,
``"eager"`` the plain version; ``None``/``"auto"`` resolves by the
tokens' device. Cross-attention and the encoder are not causal and run
the plain version on both, as in the reference. The encoder runs with no
remat, as the reference's ``encode``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import rng as rng_lib
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.ops.backend import resolve_backend

ATTN_KINDS = ("attn", "attn_local", "attn_global")
KINDS = ATTN_KINDS + ("xattn", "mamba", "shared_attn")


def _check_kinds(cfg: TransformerConfig) -> None:
    for kind in cfg.layer_pattern:
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r} "
                             f"(known: {', '.join(KINDS)})")
    if cfg.encoder is not None:
        _check_kinds(cfg.encoder)


def _entry_init(key, cfg: TransformerConfig, kind: str, mixer: str, device):
    p: Dict[str, Any] = {}
    if kind == "mamba":
        p["mix"] = L.mamba_init(key, cfg, device=device)
    elif kind == "shared_attn":
        p["mix"] = {}  # parameters live unstacked in params["shared"]
    else:
        p["mix"] = L.attn_init(rng_lib.fold_in(key, 1), cfg,
                               cross=kind == "xattn", device=device)
    if mixer == "mlp":
        p["ffn"] = L.mlp_init(rng_lib.fold_in(key, 2), cfg, device=device)
    elif mixer == "moe":
        p["ffn"] = L.moe_init(rng_lib.fold_in(key, 2), cfg, device=device)
    return p


def init_params(key, cfg: TransformerConfig, device="cpu") -> Dict[str, Any]:
    """The reference's ``init_params(key, cfg)`` on ``device``, with its
    key schedule: per pattern entry ``ek = fold_in(keys[2], i)``, repeat
    ``r`` drawn from ``split(ek, repeats)[r]`` when ``cfg.scan_layers``
    (the reference vmaps over those keys) and from ``fold_in(ek, r)``
    otherwise; zamba2's shared attention from ``keys[3]`` and its MLP
    from ``keys[4]``; the encoder's whole tree from ``keys[5]``. Every
    draw is bit for bit the reference's."""
    _check_kinds(cfg)
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
    if cfg.has_block("shared_attn"):
        params["shared"] = {
            "attn": L.attn_init(keys[3], cfg, device=device),
            "mlp": L.mlp_init(keys[4], cfg, device=device)}
    if cfg.encoder is not None:
        params["encoder"] = init_params(keys[5], cfg.encoder, device=device)
    return params


def params_from_jax(params_np, cfg: TransformerConfig, device="cpu"):
    """The reference's parameters, as nested dicts/lists of numpy arrays,
    in the port's layout. Takes both of the reference's layouts of
    ``layers``: per pattern entry a dict of leaves stacked over repeats
    (``scan_layers=True``) or a list of per-repeat dicts; the encoder's
    tree (``"encoder"``) by the encoder's config."""
    _check_kinds(cfg)

    def conv(tree, r=None):
        if isinstance(tree, dict):
            return {k: conv(v, r) for k, v in tree.items()}
        a = np.asarray(tree)
        return torch.from_numpy(np.array(a if r is None else a[r])).to(device)

    out = {k: conv(v) for k, v in params_np.items()
           if k not in ("layers", "encoder")}
    if cfg.encoder is not None:
        out["encoder"] = params_from_jax(params_np["encoder"], cfg.encoder,
                                         device)
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


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return tree.requires_grad


# ---------------------------------------------------------------------------
# forward (training / full-sequence)
# ---------------------------------------------------------------------------

def _mixer(p, x, cfg: TransformerConfig, mixer: str):
    if mixer == "mlp":
        return L.mlp_apply(p["ffn"], x, cfg)
    if mixer == "moe":
        return L.moe_apply(p["ffn"], x, cfg)
    return x


def _apply_entry(p, x, cfg: TransformerConfig, kind, mixer, shared,
                 xsource, backend):
    if kind == "mamba":
        x, _ = L.mamba_apply(p["mix"], x, cfg)
    elif kind == "shared_attn":
        x = L.attn_apply(shared["attn"], x, cfg, kind="attn",
                         backend=backend)
        x = L.mlp_apply(shared["mlp"], x, cfg)
    elif kind == "xattn":
        x = L.attn_apply(p["mix"], x, cfg, kind="xattn", xsource=xsource)
    else:
        x = L.attn_apply(p["mix"], x, cfg, kind=kind, backend=backend)
    return _mixer(p, x, cfg, mixer)


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


def encode(params, x, cfg: TransformerConfig):
    """The encoder stack over precomputed frame/patch embeddings (the
    reference's stub frontend): x (B, N, d) -> (B, N, d), ending in the
    encoder's ``final_norm``. No logits head; its attention is not
    causal (``cfg.is_encoder``), so it runs the plain path on every
    backend, as the reference's ``use_flash=False``."""
    shared = params.get("shared")
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.layer_pattern):
            x = _apply_entry(params["layers"][i][r], x, cfg, kind,
                             cfg.mixer_for(i), shared, None, "eager")
    return L.norm_apply(params["final_norm"], x, cfg)


def _resolve_xsource(params, cfg: TransformerConfig, xsource):
    """Encoder-decoder (whisper): the encoder over the frame embeddings
    gives the decoder's cross-attention source; otherwise ``xsource`` is
    the source."""
    if cfg.encoder is not None and xsource is not None:
        return encode(params["encoder"], xsource, cfg.encoder)
    return xsource


def forward(params, tokens, cfg: TransformerConfig, xsource=None,
            backend: Optional[str] = None):
    """tokens: integer (B, S) -> logits (B, S, V). ``xsource``: the
    cross-attention source (B, Sx, width), or the encoder's input."""
    _check_kinds(cfg)
    backend = resolve_backend(backend, tokens.device)
    shared = params.get("shared")
    xsource = _resolve_xsource(params, cfg, xsource)
    x = embed_tokens(params, tokens, cfg)

    def group_fn(x, r):
        for i, kind in enumerate(cfg.layer_pattern):
            x = _apply_entry(params["layers"][i][r], x, cfg, kind,
                             cfg.mixer_for(i), shared, xsource, backend)
        return x

    remat = cfg.remat and torch.is_grad_enabled() and _needs_grad(params)
    for r in range(cfg.repeats):
        if remat:
            x = checkpoint(group_fn, x, r, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = group_fn(x, r)
    return logits_head(params, x, cfg)


# ---------------------------------------------------------------------------
# kv / state caches, prefill & decode
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device="cpu", source_len: Optional[int] = None
               ) -> List[Dict[str, torch.Tensor]]:
    """Zero caches, one per pattern entry, stacked over repeats: K/V
    ``{"k", "v"}`` of (repeats, B, max_seq, Hkv, hd), the cross K/V
    ``{"xk", "xv"}`` of (repeats, B, source_len, Hkv, hd)
    (``source_len`` defaults to ``cfg.xattn_source_len``), or Mamba2's
    ``{"conv", "ssm"}`` states."""
    _check_kinds(cfg)
    dt = L._dtype(cfg)
    out = []
    for kind in cfg.layer_pattern:
        if kind == "mamba":
            one = L.mamba_cache_spec(cfg, batch, device="meta")
            out.append({n: torch.zeros((cfg.repeats,) + tuple(t.shape),
                                       dtype=t.dtype, device=device)
                        for n, t in one.items()})
            continue
        names, seq = ("k", "v"), max_seq
        if kind == "xattn":
            names = ("xk", "xv")
            seq = cfg.xattn_source_len if source_len is None else source_len
        shape = (cfg.repeats, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        out.append({n: torch.zeros(shape, dtype=dt, device=device)
                    for n in names})
    return out


def widen_cache(cache, extra: int):
    """The cache with ``extra`` zero positions appended to every
    self-attention K/V (room for the tokens to generate); the cross K/V
    (whatever its length) and the Mamba2 states stay as they are. Each
    entry's old tensors are freed as it goes."""
    out = []
    for entry in cache:
        out.append({n: (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra))
                        if n in ("k", "v") else t)
                    for n, t in entry.items()})
        entry.clear()
    return out


def _prefill_attention(mix, x, cfg: TransformerConfig, *, window, positions,
                       backend, post_norm: bool):
    """One self-attention block of the prefill: (x + attention, k, v)."""
    B, S, _ = x.shape
    h = L.norm_apply(mix["pre_norm"], x, cfg)
    q, k, v = L._qkv(mix, h, h, cfg)
    q = L.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = L.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    out = L.self_attention(q, k, v, cfg, causal=not cfg.is_encoder,
                           window=window, backend=backend)
    del q, h
    out = out.reshape(B, S, cfg.q_dim) @ mix["wo"]
    if post_norm:
        out = L.norm_apply(mix["post_norm"], out, cfg)
    return x + out, k, v


def _cross_kv(mix, xsource, cfg: TransformerConfig):
    """The cross K/V a prefill caches for the decode steps.

    C6 (``ROADMAP.md`` §C): the reference caches ``xsource @ wk`` and
    ``xsource @ wv`` without ``bk``/``bv``, while its forward adds them
    (``_qkv``); with nonzero biases its decode disagrees with its
    forward. The port mirrors it here, and only here, so that its
    answers stay the reference's: adding the biases is this one line."""
    B = xsource.shape[0]
    shape = (B, -1, cfg.n_kv_heads, cfg.head_dim)
    return (xsource @ mix["wk"]).reshape(shape), \
        (xsource @ mix["wv"]).reshape(shape)


def prefill(params, tokens, cfg: TransformerConfig, xsource=None,
            backend: Optional[str] = None):
    """Full-sequence forward that also fills the decode caches. Returns
    (last_logits (B, V), cache). On ``cuda`` every causal self-attention
    layer, the shared one's uses included, is one launch of the flash
    kernel; the encoder (run once, over ``xsource``) and the
    cross-attention blocks take the plain path."""
    _check_kinds(cfg)
    backend = resolve_backend(backend, tokens.device)
    B, S = tokens.shape
    shared = params.get("shared")
    xsource = _resolve_xsource(params, cfg, xsource)
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, device=tokens.device)[None]
    cache = init_cache(cfg, B, S, device=tokens.device,
                       source_len=None if xsource is None
                       else xsource.shape[1])
    for r, i, kind, p in _layers(params, cfg):
        c = cache[i]
        if kind == "mamba":
            x, (conv, ssm) = L.mamba_apply(p["mix"], x, cfg)
            if conv is not None:
                c["conv"][r] = conv
            c["ssm"][r] = ssm
        elif kind == "shared_attn":
            # the reference's prefill: no post-norm on the shared block
            x, c["k"][r], c["v"][r] = _prefill_attention(
                shared["attn"], x, cfg, window=None, positions=positions,
                backend=backend, post_norm=False)
            x = L.mlp_apply(shared["mlp"], x, cfg)
        elif kind == "xattn":
            x = L.attn_apply(p["mix"], x, cfg, kind="xattn", xsource=xsource)
            c["xk"][r], c["xv"][r] = _cross_kv(p["mix"], xsource, cfg)
        else:
            window = cfg.window if kind == "attn_local" else None
            x, c["k"][r], c["v"][r] = _prefill_attention(
                p["mix"], x, cfg, window=window, positions=positions,
                backend=backend, post_norm=cfg.post_norms)
        x = _mixer(p, x, cfg, cfg.mixer_for(i))
    logits = logits_head(params, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, tokens, cache, pos: int, cfg: TransformerConfig):
    """One decode step. tokens: (B, 1); pos: the write position (attends
    to cache[<= pos]). Updates ``cache`` in place and returns
    (logits (B, V), cache)."""
    _check_kinds(cfg)
    shared = params.get("shared")
    x = embed_tokens(params, tokens, cfg)
    for r, i, kind, p in _layers(params, cfg):
        entry = {n: t[r] for n, t in cache[i].items()}
        if kind == "mamba":
            x, (conv, ssm) = L.mamba_apply(
                p["mix"], x, cfg, conv_state=entry["conv"],
                ssm_state=entry["ssm"], decode=True)
            entry["conv"].copy_(conv)
            entry["ssm"].copy_(ssm)
        elif kind == "shared_attn":
            x, _ = L.attn_decode(shared["attn"], x, entry, pos, cfg)
            x = L.mlp_apply(shared["mlp"], x, cfg)
        elif kind == "xattn":
            x, _ = L.attn_decode(p["mix"], x, None, pos, cfg, kind="xattn",
                                 xkv=(entry["xk"], entry["xv"]))
        else:
            x, _ = L.attn_decode(p["mix"], x, entry, pos, cfg, kind=kind)
        x = _mixer(p, x, cfg, cfg.mixer_for(i))
    logits = logits_head(params, x, cfg)
    return logits[:, 0], cache
