"""Model configuration schema (the attn / MLA / MoE / Mamba / RWKV / MTP subset
of ``repro``'s).

``LayerSpec``, ``ModelConfig``, ``AttentionConfig``, ``MLAConfig``,
``MoEConfig``, ``MambaConfig`` and ``RWKVConfig`` carry the same field names
and defaults as ``repro.models``.
Left out: the fields of families this port does not have yet
(multi-codebook heads, frontend prefixes), which
``repro_torch.configs.get_config`` refuses, and
``AttentionConfig.q_chunk``/``kv_chunk``, the block sizes of ``repro``'s
XLA attention (the port's flash kernel tiles by its own), and
``RWKVConfig.ffn_mult``, which nothing reads (configs set ``d_ff``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims (per head unless noted;
    ``repro.models.attention.MLAConfig``)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = full)
    softcap: float | None = None       # attn logit softcapping (Gemma2)
    mla: MLAConfig | None = None       # DeepSeek-V3 latent attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed experts (``repro.models.moe.MoEConfig``); the layer is
    :mod:`repro_torch.models.moe`."""

    n_experts: int                 # routed experts (global)
    top_k: int
    d_ff: int                      # per-expert hidden dim (global)
    n_shared_experts: int = 0      # DeepSeek shared expert(s)
    score_fn: str = "softmax"      # "softmax" | "sigmoid"
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    act: str = "silu"
    n_experts_global: int | None = None   # set by .local(); None => n_experts

    def local(self, ep: int, tp: int) -> "MoEConfig":
        assert self.n_experts % ep == 0, (self.n_experts, ep)
        assert self.d_ff % tp == 0, (self.d_ff, tp)
        return dataclasses.replace(
            self, n_experts=self.n_experts // ep, d_ff=self.d_ff // tp,
            n_experts_global=self.n_experts_global or self.n_experts)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM widths (``repro.models.ssm.MambaConfig``).

    ``chunk`` is ``repro``'s scan chunk; the port's scan kernel needs no
    chunking, but both packages accept only ``S % min(chunk, S) == 0``."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None      # default: ceil(d_model / 16)
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def get_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 widths (``repro.models.rwkv.RWKVConfig``).

    ``chunk`` is ``repro``'s WKV chunk; the port's kernel runs the
    recurrence step by step, but both packages accept only
    ``S % min(chunk, S) == 0``."""

    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating block pattern.

    kind:   'attn' | 'mamba' | 'rwkv' (the mixers ported so far)
    mlp:    'mlp' (dense, uses cfg.act/d_ff) | 'moe' | 'rwkv_cm' | 'none'
    window: sliding-window override for this layer (None = cfg default).
    """

    kind: str = "attn"
    mlp: str = "mlp"
    window: int | None = None
    full_attention: bool = True      # False => use `window`


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    d_ff: int
    attn: AttentionConfig | None = None
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    act: str = "silu"                # dense MLP activation ('gelu_tanh' => GeGLU)
    norm_eps: float = 1e-6
    zero_centered_norm: bool = False # Gemma-style (1 + w) RMSNorm
    post_norms: bool = False         # Gemma2 sandwich norms
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    embed_scale: bool = False        # Gemma multiplies embeddings by sqrt(d)
    mtp_depth: int = 0               # DeepSeek-V3 multi-token prediction heads
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    source: str = ""

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of "
                             f"the pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_param_count(self, spec: LayerSpec) -> int:
        d, n = self.d_model, 0
        if spec.kind == "attn" and self.attn.mla is not None:
            a, m = self.attn, self.attn.mla
            n += d * m.q_lora_rank + m.q_lora_rank * a.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            n += d * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * a.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += a.n_heads * m.v_head_dim * d
        elif spec.kind == "attn":
            a = self.attn
            n += d * a.n_heads * a.head_dim * 2
            n += d * a.n_kv_heads * a.head_dim * 2
        elif spec.kind == "mamba":
            # repro's formula, which leaves out conv_b, dt_bias, A_log and D
            di = self.mamba.d_inner(d)
            dtr = self.mamba.get_dt_rank(d)
            n += d * 2 * di + self.mamba.d_conv * di
            n += di * (dtr + 2 * self.mamba.d_state) + dtr * di + di * d
        elif spec.kind == "rwkv":
            # repro's formula, which leaves out mix_base, w0, u and ln_x
            n += 4 * d * d + d * d  # r,k,v,g,out
            n += d * self.rwkv.decay_lora + self.rwkv.decay_lora * d
            n += 5 * d * self.rwkv.mix_lora * 2
        if spec.mlp == "mlp":
            n += 3 * d * self.d_ff
        elif spec.mlp == "moe" and self.moe is not None:
            n += d * self.moe.n_experts
            n += self.moe.n_experts * 3 * d * self.moe.d_ff
            n += self.moe.n_shared_experts * 3 * d * self.moe.d_ff
        elif spec.mlp == "rwkv_cm":
            n += d * self.d_ff + self.d_ff * d + d * d
        return n + 2 * d  # norms

    def layer_active_param_count(self, spec: LayerSpec) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if spec.mlp != "moe" or self.moe is None:
            return self.layer_param_count(spec)
        n = self.layer_param_count(spec)
        n -= self.moe.n_experts * 3 * self.d_model * self.moe.d_ff
        n += (self.moe.top_k + self.moe.n_shared_experts) * 3 * self.d_model * self.moe.d_ff
        return n

    def param_count(self) -> int:
        n = sum(self.layer_param_count(s) for s in self.pattern) * self.n_periods
        n += self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        return n
