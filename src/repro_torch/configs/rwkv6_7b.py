"""RWKV-6 "Finch" 7B [arXiv:2404.05892].

32L, d_model=4096 (attention-free), channel-mix d_ff=14336 (3.5x),
vocab=65536; data-dependent decay WKV6 time-mix, head_dim=64.
"""

from repro_torch.models.config import LayerSpec, ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        vocab_size=65536,
        d_ff=14336,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
        pattern=(LayerSpec(kind="rwkv", mlp="rwkv_cm"),),
        source="arXiv:2404.05892",
    )
