"""CausalLM assembly: embedding -> stacked periods -> norm -> head.

The text-LM subset of ``repro.models.model`` (single codebook, no frontend
prefix, no MTP head), with ``repro``'s parameter names and layout.
"""

from __future__ import annotations

import torch

from .blocks import apply_periods, decode_periods, init_period_states, init_periods
from .config import ModelConfig
from .module import dense_init, embed_init
from .norms import init_rmsnorm, rmsnorm


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random weights from ``gen`` (which must live on ``device``: the card
    unless the caller passes ``"cpu"``)."""
    d, v, dtype = cfg.d_model, cfg.vocab_size, cfg.pdtype
    params = {
        "embed": embed_init(gen, (v, d), dtype, device),
        "periods": init_periods(gen, cfg, device),
        "final_norm": init_rmsnorm(d, dtype, cfg.zero_centered_norm, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (d, v), d, dtype, device)
    return params


def embed_tokens(params, tokens, cfg: ModelConfig):
    """tokens: (B, S) or (B,) int -> (B, S, D) or (B, D) in the compute dtype."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x.to(cfg.cdtype)


def _head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def head_logits(params, h, cfg: ModelConfig):
    """final norm -> LM head -> optional softcap, as float32 logits."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps, cfg.zero_centered_norm)
    logits = (h @ _head_weight(params, cfg)).float()
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def model_forward(params, tokens, cfg: ModelConfig):
    """Backbone forward.  tokens (B, S).  Returns (h (B, S, D), positions)."""
    x = embed_tokens(params, tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return apply_periods(params["periods"], x, positions, cfg), positions


def init_decode_states(batch: int, max_len: int, cfg: ModelConfig, device="cuda"):
    return init_period_states(batch, max_len, cfg, cfg.cdtype, device)


def decode_step(params, token, position, states, cfg: ModelConfig):
    """One decode step.

    token: (B,) int; position: Python int (lockstep) or (B,) int32 tensor.
    Returns (logits (B, V) float32, states); the caches are updated in place.
    """
    x = embed_tokens(params, token, cfg)
    h, states = decode_periods(params["periods"], x, position, states, cfg)
    return head_logits(params, h, cfg), states
