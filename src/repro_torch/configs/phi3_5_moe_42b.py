"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=6400, vocab=32064,
16 experts top-2, every layer MoE.
"""

from repro_torch.models.config import AttentionConfig, LayerSpec, ModelConfig, MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        vocab_size=32064,
        d_ff=6400,
        attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                             rope_theta=10000.0),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400, score_fn="softmax"),
        pattern=(LayerSpec(kind="attn", mlp="moe"),),
        act="silu",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
