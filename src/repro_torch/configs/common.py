"""Shared helpers for architecture configs, incl. the smoke-test reducer."""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import MLAConfig, ModelConfig


def smoke_reduce(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 periods, d_model 256, 4 heads x 64
    (MLA: ranks 64 / 32, heads 32 + 16 wide, values 32), 4 experts.

    Keeps the pattern (so alternating structure is exercised) while
    shrinking every dimension for a CPU-speed forward step.  Same values as
    ``repro.configs.common.smoke_reduce`` for the families ported here.
    """
    kw: dict = {
        "n_layers": len(cfg.pattern) * max(1, 2 // len(cfg.pattern)),
        "d_model": 256,
        "d_ff": 512,
        "vocab_size": min(cfg.vocab_size, 512),
        "param_dtype": "float32",
        "compute_dtype": "float32",
    }
    if cfg.attn is not None:
        a = cfg.attn
        n_heads = 4
        n_kv = max(1, min(a.n_kv_heads, n_heads * a.n_kv_heads // a.n_heads))
        mla = None
        if a.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                            qk_rope_dim=16, v_head_dim=32)
        kw["attn"] = dataclasses.replace(
            a, n_heads=n_heads, n_kv_heads=n_kv, head_dim=64,
            window=None if a.window is None else 64, mla=mla)
        kw["pattern"] = tuple(
            dataclasses.replace(s, window=None if s.window is None else 64)
            for s in cfg.pattern)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=256)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=32)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32, decay_lora=16,
                                         mix_lora=8, chunk=16)
    return cfg.replace(**kw)
