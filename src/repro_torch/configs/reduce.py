"""Reduced-config factory: shrink any assigned arch to CPU scale while
keeping its structural family (used by smoke tests and the CPU demo
launchers)."""
import dataclasses

from repro_torch.models.transformer.config import SSMConfig, TransformerConfig


def reduce_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """Shrink every dimension while keeping the family's structure
    (pattern, mixers, norms, softcaps, GQA ratio, MoE/SSM/enc-dec)."""
    kw = dict(
        num_layers=len(cfg.layer_pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=257,
        dtype="float32",
        scan_layers=False,
        remat=False,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8,
                                        top_k=min(cfg.moe.top_k, 2),
                                        d_expert=48)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=16)
    if cfg.window:
        kw["window"] = 16
    if cfg.xattn_source_len:
        kw["xattn_source_len"] = 24
        kw["xattn_source_dim"] = 32
    if cfg.encoder is not None:
        kw["encoder"] = reduce_cfg(cfg.encoder)
        kw["xattn_source_dim"] = 64  # encoder d_model after reduction
    return dataclasses.replace(cfg, **kw)


