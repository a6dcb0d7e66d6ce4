"""gemma2-2b [dense] — 26L d2304 8H (GQA kv=4, hd 256) ff9216 vocab
256000; local(4096)/global alternating, logit softcaps, post-norms,
sqrt(d) embed scale. [arXiv:2408.00118; hf]"""
from repro_torch.models.transformer.config import TransformerConfig

def config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-2b",
        num_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab=256000,
        layer_pattern=("attn_local", "attn_global"), window=4096,
        attn_softcap=50.0, final_softcap=30.0, post_norms=True,
        embed_scale=True, query_scale=256 ** -0.5,
        activation="gelu", tie_embeddings=True, **kw)
