"""Jamba-1.5-Large without experts [arXiv:2403.19887, arXiv:2408.12570].

The published model (``repro.configs.jamba_1_5_large``): 72 layers,
d_model 8192, 64 heads (GQA kv 8) x 128, d_ff 24576, vocab 65536, Mamba
d_state 16, d_conv 4, expand 2; an 8-layer period of seven Mamba layers and
one attention layer (index 2), and MoE (16 experts x 24576, top-2) on every
other layer.

The port has no MoE yet, so :func:`config_without_experts` differs from the
published model in exactly two ways:

* every ``mlp="moe"`` layer is the dense SwiGLU MLP at d_ff 24576, the
  width of one expert;
* the depth is 8 layers: one period of the 72.

Every width is the published one.  The published id stays refused by
``repro_torch.configs.get_config`` (its MoE layers are not ported).
"""

from repro_torch.models.config import AttentionConfig, LayerSpec, MambaConfig, ModelConfig

ARCH_ID = "jamba-1.5-large-398b"


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
