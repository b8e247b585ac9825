"""DeepSeek-V3 671B [arXiv:2412.19437].

61L, d_model=7168, 128 heads with MLA (q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v=128), MoE: 1 shared + 256 routed experts top-8
(sigmoid scores), expert d_ff=2048, vocab=129280, MTP depth 1.

As in ``repro.configs.deepseek_v3``, every layer is MoE (the published
model's first 3 layers are dense), so the body stays one repeated period.
"""

from repro_torch.models.config import (AttentionConfig, LayerSpec, MLAConfig,
                                       ModelConfig, MoEConfig)

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=61,
        d_model=7168,
        vocab_size=129280,
        d_ff=2048,
        attn=AttentionConfig(
            n_heads=128, n_kv_heads=128, head_dim=128, rope_theta=10000.0,
            mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                          qk_rope_dim=64, v_head_dim=128)),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared_experts=1,
                      score_fn="sigmoid"),
        pattern=(LayerSpec(kind="attn", mlp="moe"),),
        mtp_depth=1,
        source="arXiv:2412.19437",
    )
