"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) expert-ff 1536
vocab 151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

def config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-moe-235b-a22b",
        num_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936,
        layer_pattern=("attn",), mixers=("moe",),
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
        rope_theta=1000000.0, activation="silu", tie_embeddings=False, **kw)
