"""Gemma 2B [arXiv:2403.08295].

18L, d_model=2048, 8 heads with MQA (kv=1), head_dim=256, GeGLU d_ff=16384,
vocab=256000, tied embeddings, Gemma-style (1+w) RMSNorm, sqrt(d) embed scale.
"""

from repro_torch.models.config import AttentionConfig, LayerSpec, ModelConfig

ARCH_ID = "gemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=18,
        d_model=2048,
        vocab_size=256000,
        d_ff=16384,
        attn=AttentionConfig(n_heads=8, n_kv_heads=1, head_dim=256,
                             rope_theta=10000.0),
        pattern=(LayerSpec(kind="attn", mlp="mlp"),),
        act="gelu_tanh",            # GeGLU
        tie_embeddings=True,
        zero_centered_norm=True,
        embed_scale=True,
        source="arXiv:2403.08295",
    )
