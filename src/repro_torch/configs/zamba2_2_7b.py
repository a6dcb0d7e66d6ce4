"""zamba2-2.7b [hybrid] — 54L d2560, Mamba2 backbone (ssm_state=64) with
a SHARED attention+MLP block applied every 6th layer (one parameter set
reused; the real model adds per-use LoRA which we omit — DESIGN.md §4).
[arXiv:2411.15242; hf]"""
from repro_torch.models.transformer.config import SSMConfig, TransformerConfig

def config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="zamba2-2.7b",
        num_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000,
        layer_pattern=("mamba", "mamba", "mamba", "mamba", "mamba",
                       "shared_attn"),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        activation="gelu", tie_embeddings=True, **kw)
