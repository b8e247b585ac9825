"""Block assembly: the repeating layer pattern, looped over stacked periods.

A model is ``n_periods`` repetitions of ``cfg.pattern``.  As in ``repro``,
period parameters (and decode states) are stacked along a leading axis; the
scan over periods becomes a Python loop over views ``leaf[i]`` of the
stacked tensors, which copies nothing.  The attention and Mamba mixers
and the dense MLP are ported (not MoE, not RWKV).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention_decode, attention_forward, init_attention, init_attention_cache
from .config import AttentionConfig, LayerSpec, ModelConfig
from .mlp import init_mlp, mlp
from .norms import init_rmsnorm, rmsnorm
from .ssm import init_mamba, init_mamba_state, mamba_decode, mamba_forward


def _attn_cfg(cfg: ModelConfig, spec: LayerSpec) -> AttentionConfig:
    a = cfg.attn
    if not spec.full_attention or spec.window is not None:
        a = dataclasses.replace(a, window=spec.window)
    return a


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind not in ("attn", "mamba") or spec.mlp not in ("mlp", "none"):
        raise NotImplementedError(f"layer {spec} is not ported yet "
                                  "(only attn / mamba + dense mlp)")


def tree_index(tree, i: int):
    """The i-th slice of every leaf of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_index(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, device="cuda", lead: tuple = ()):
    """One layer's params (with ``lead`` stacking axes)."""
    _check_spec(spec)
    d, dtype, zc = cfg.d_model, cfg.pdtype, cfg.zero_centered_norm
    p = {"norm1": init_rmsnorm(d, dtype, zc, device, lead)}
    if spec.kind == "attn":
        p["attn"] = init_attention(gen, d, cfg.attn, dtype, device, lead)
    else:
        p["mamba"] = init_mamba(gen, d, cfg.mamba, dtype, device, lead)
    if spec.mlp != "none":
        p["norm2"] = init_rmsnorm(d, dtype, zc, device, lead)
        gated = cfg.act in ("silu", "gelu_tanh", "gelu")
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, gated, dtype, device, lead)
    if cfg.post_norms:
        p["norm1_post"] = init_rmsnorm(d, dtype, zc, device, lead)
        if spec.mlp != "none":
            p["norm2_post"] = init_rmsnorm(d, dtype, zc, device, lead)
    return p


def init_period(gen, cfg: ModelConfig, device="cuda", lead: tuple = ()):
    return {"layers": tuple(init_layer(gen, cfg, s, device, lead) for s in cfg.pattern)}


def init_periods(gen, cfg: ModelConfig, device="cuda"):
    """Stacked params for all periods: leaves have leading dim n_periods."""
    return init_period(gen, cfg, device, lead=(cfg.n_periods,))


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def apply_layer(params, x, positions, cfg: ModelConfig, spec: LayerSpec):
    """x: (B, S, D) -> (B, S, D)."""
    eps, zc = cfg.norm_eps, cfg.zero_centered_norm
    h = rmsnorm(params["norm1"], x, eps, zc)
    if spec.kind == "attn":
        h = attention_forward(params["attn"], h, positions, _attn_cfg(cfg, spec))
    else:
        h = mamba_forward(params["mamba"], h, cfg.mamba)
    if cfg.post_norms:
        h = rmsnorm(params["norm1_post"], h, eps, zc)
    x = x + h.to(x.dtype)
    if spec.mlp == "none":
        return x
    h = mlp(params["mlp"], rmsnorm(params["norm2"], x, eps, zc), act=cfg.act)
    if cfg.post_norms:
        h = rmsnorm(params["norm2_post"], h, eps, zc)
    return x + h.to(x.dtype)


def apply_period(params, x, positions, cfg: ModelConfig):
    for p, spec in zip(params["layers"], cfg.pattern):
        x = apply_layer(p, x, positions, cfg, spec)
    return x


def apply_periods(stacked, x, positions, cfg: ModelConfig, remat: bool = False):
    """Loop over the stacked periods (``repro``'s scan).  ``remat`` recomputes
    each period in the backward (one ``torch.utils.checkpoint`` per period,
    ``repro``'s ``jax.checkpoint(body)``); it applies only while autograd
    records."""
    for i in range(cfg.n_periods):
        x = apply_period_remat(tree_index(stacked, i), x, positions, cfg, remat)
    return x


def apply_period_remat(params, x, positions, cfg: ModelConfig, remat: bool):
    """:func:`apply_period`, checkpointed when ``remat`` and grad mode is on."""
    if remat and torch.is_grad_enabled():
        return checkpoint(apply_period, params, x, positions, cfg, use_reentrant=False)
    return apply_period(params, x, positions, cfg)


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------


def decode_layer(params, x, position, state, cfg: ModelConfig, spec: LayerSpec):
    """x: (B, D) one position.  Returns (x, state); the KV cache or Mamba
    state in ``state`` is updated in place."""
    eps, zc = cfg.norm_eps, cfg.zero_centered_norm
    h = rmsnorm(params["norm1"], x, eps, zc)
    if spec.kind == "attn":
        h, state_m = attention_decode(params["attn"], h, position, state["mixer"],
                                      _attn_cfg(cfg, spec))
    else:
        h, state_m = mamba_decode(params["mamba"], h, cfg.mamba, state["mixer"])
    if cfg.post_norms:
        h = rmsnorm(params["norm1_post"], h, eps, zc)
    x = x + h.to(x.dtype)
    if spec.mlp != "none":
        h = mlp(params["mlp"], rmsnorm(params["norm2"], x, eps, zc), act=cfg.act)
        if cfg.post_norms:
            h = rmsnorm(params["norm2_post"], h, eps, zc)
        x = x + h.to(x.dtype)
    return x, {"mixer": state_m}


def decode_period(params, x, position, states, cfg: ModelConfig):
    new_states = []
    for p, spec, st in zip(params["layers"], cfg.pattern, states):
        x, ns = decode_layer(p, x, position, st, cfg, spec)
        new_states.append(ns)
    return x, tuple(new_states)


def decode_periods(stacked, x, position, states, cfg: ModelConfig):
    """Decode over stacked periods; ``states`` is stacked the same way and
    updated in place (the returned tree holds the same tensors)."""
    for i in range(cfg.n_periods):
        x, _ = decode_period(tree_index(stacked, i), x, position,
                             tree_index(states, i), cfg)
    return x, states


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_layer_state(batch: int, max_len: int, cfg: ModelConfig, spec: LayerSpec,
                     dtype, device="cuda", lead: tuple = ()):
    _check_spec(spec)
    if spec.kind == "mamba":
        return {"mixer": init_mamba_state(batch, cfg.d_model, cfg.mamba, dtype, device, lead)}
    # Sliding-window layers only need `window` cache slots.
    a = _attn_cfg(cfg, spec)
    eff_len = max_len if a.window is None else min(max_len, a.window)
    return {"mixer": init_attention_cache(batch, max(eff_len, 1), a, dtype, device, lead)}


def init_period_states(batch: int, max_len: int, cfg: ModelConfig, dtype, device="cuda"):
    """Stacked decode states: leaves get leading dim n_periods."""
    return tuple(init_layer_state(batch, max_len, cfg, s, dtype, device, (cfg.n_periods,))
                 for s in cfg.pattern)
