"""DeepSeek-LLM 7B [arXiv:2401.02954] — Llama architecture.

30L, d_model=4096, 32 heads (kv=32), SwiGLU d_ff=11008, vocab=102400.
"""

from repro_torch.models.config import AttentionConfig, LayerSpec, ModelConfig

ARCH_ID = "deepseek-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=30,
        d_model=4096,
        vocab_size=102400,
        d_ff=11008,
        attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=128,
                             rope_theta=10000.0),
        pattern=(LayerSpec(kind="attn", mlp="mlp"),),
        act="silu",
        source="arXiv:2401.02954",
    )
