"""Jamba-1.5-Large 398B [arXiv:2403.19887, arXiv:2408.12570].

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536.
Hybrid Mamba+attention at 1:7 (one attention layer per 8-layer period) and
MoE (16 experts, top-2) on every other layer.

:func:`config` is the published model (``repro.configs.jamba_1_5_large``).
:func:`config_without_experts` is the form that fits one card at fp32; it
differs from the published model in exactly two ways:

* every ``mlp="moe"`` layer is the dense SwiGLU MLP at d_ff 24576, the
  width of one expert;
* the depth is 8 layers: one period of the 72.

Every width is the published one.
"""

from repro_torch.models.config import (AttentionConfig, LayerSpec, MambaConfig,
                                       ModelConfig, MoEConfig)

ARCH_ID = "jamba-1.5-large-398b"


def config() -> ModelConfig:
    # 8-layer period: attention at index 2 (interior placement, as in Jamba's
    # published block layout); MoE replaces the MLP on every other layer.
    pattern = tuple(
        LayerSpec(kind="attn" if i == 2 else "mamba",
                  mlp="moe" if i % 2 == 1 else "mlp")
        for i in range(8)
    )
    return ModelConfig(
        name=ARCH_ID,
        n_layers=72,
        d_model=8192,
        vocab_size=65536,
        d_ff=24576,
        attn=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                             rope_theta=10000.0),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=24576),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        pattern=pattern,
        source="arXiv:2403.19887",
    )


def config_without_experts() -> ModelConfig:
    pattern = tuple(LayerSpec(kind="attn" if i == 2 else "mamba", mlp="mlp")
                    for i in range(8))
    return ModelConfig(
        name=f"{ARCH_ID}-no-experts",
        n_layers=8,
        d_model=8192,
        vocab_size=65536,
        d_ff=24576,
        attn=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                             rope_theta=10000.0),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        pattern=pattern,
        source="arXiv:2403.19887",
    )
