"""stablelm-1.6b [dense] — 24L d2048 32H (MHA kv=32) ff5632 vocab 100352,
partial rotary 25%, LayerNorm. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.transformer.config import TransformerConfig

def config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-1.6b",
        num_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=5632, vocab=100352, rope_fraction=0.25, norm="layernorm",
        activation="silu", tie_embeddings=False, **kw)
