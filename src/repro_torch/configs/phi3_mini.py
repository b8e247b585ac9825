"""Phi-3-mini 3.8B [arXiv:2404.14219].

32L, d_model=3072, 32 heads (kv=32, i.e. full MHA), SwiGLU d_ff=8192,
vocab=32064, RoPE.
"""

from repro_torch.models.config import AttentionConfig, LayerSpec, ModelConfig

ARCH_ID = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=3072,
        vocab_size=32064,
        d_ff=8192,
        attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=96,
                             rope_theta=10000.0),
        pattern=(LayerSpec(kind="attn", mlp="mlp"),),
        act="silu",
        source="arXiv:2404.14219",
    )
