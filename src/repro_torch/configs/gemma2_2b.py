"""Gemma-2 2B [arXiv:2408.00118].

26L, d_model=2304, 8 heads (GQA kv=4), head_dim=256, GeGLU d_ff=9216,
vocab=256000.  Alternating local (sliding window 4096) and global attention,
attention logit softcap 50, final logit softcap 30, sandwich (post) norms,
tied embeddings.
"""

from repro_torch.models.config import AttentionConfig, LayerSpec, ModelConfig

ARCH_ID = "gemma2-2b"
LOCAL_WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=26,
        d_model=2304,
        vocab_size=256000,
        d_ff=9216,
        attn=AttentionConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                             rope_theta=10000.0, softcap=50.0),
        pattern=(
            LayerSpec(kind="attn", mlp="mlp", window=LOCAL_WINDOW, full_attention=False),
            LayerSpec(kind="attn", mlp="mlp"),   # global
        ),
        act="gelu_tanh",
        logit_softcap=30.0,
        post_norms=True,
        zero_centered_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        source="arXiv:2408.00118",
    )
