"""mamba2-370m [ssm] — 48L d1024 attn-free, ssm_state=128, vocab 50280.
SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.models.transformer.config import SSMConfig, TransformerConfig

def config(**kw) -> TransformerConfig:
    return TransformerConfig(
        name="mamba2-370m",
        num_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=0, vocab=50280,
        layer_pattern=("mamba",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        tie_embeddings=True, **kw)
