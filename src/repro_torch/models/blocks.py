"""Block assembly: the repeating layer pattern, looped over stacked periods.

A model is ``n_periods`` repetitions of ``cfg.pattern``.  As in ``repro``,
period parameters (and decode states) are stacked along a leading axis; the
scan over periods becomes a Python loop over views ``leaf[i]`` of the
stacked tensors, which copies nothing.  The attention, Mamba and RWKV-6
mixers, the dense MLP, the MoE layer and the RWKV channel mix are ported.
As in ``repro``, the forward functions return ``(x, aux)``: the MoE layers'
load-balance loss summed over layers and periods (a Python ``0.0`` where no
layer is MoE, so a dense model runs no extra op).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention_decode, attention_forward, init_attention, init_attention_cache
from .config import AttentionConfig, LayerSpec, ModelConfig
from .mlp import init_mlp, mlp
from .moe import init_moe, moe
from .norms import init_rmsnorm, rmsnorm
from .rwkv import (init_rwkv_channel_mix, init_rwkv_state, init_rwkv_time_mix,
                   rwkv_channel_mix, rwkv_channel_mix_decode, rwkv_time_mix,
                   rwkv_time_mix_decode)
from .ssm import init_mamba, init_mamba_state, mamba_decode, mamba_forward


def _attn_cfg(cfg: ModelConfig, spec: LayerSpec) -> AttentionConfig:
    a = cfg.attn
    if not spec.full_attention or spec.window is not None:
        a = dataclasses.replace(a, window=spec.window)
    return a


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind not in ("attn", "mamba", "rwkv") \
            or spec.mlp not in ("mlp", "moe", "rwkv_cm", "none"):
        raise NotImplementedError(f"layer {spec} is not ported yet "
                                  "(only attn / mamba / rwkv + dense mlp / moe / rwkv_cm)")


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
    elif spec.kind == "mamba":
        p["mamba"] = init_mamba(gen, d, cfg.mamba, dtype, device, lead)
    else:
        p["rwkv_tm"] = init_rwkv_time_mix(gen, d, cfg.rwkv, dtype, device, lead)
    if spec.mlp != "none":
        p["norm2"] = init_rmsnorm(d, dtype, zc, device, lead)
    if spec.mlp == "mlp":
        gated = cfg.act in ("silu", "gelu_tanh", "gelu")
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, gated, dtype, device, lead)
    elif spec.mlp == "moe":
        p["moe"] = init_moe(gen, d, cfg.moe, dtype, device, lead)
    elif spec.mlp == "rwkv_cm":
        p["rwkv_cm"] = init_rwkv_channel_mix(gen, d, cfg.d_ff, dtype, device, lead)
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


def apply_layer(params, x, positions, cfg: ModelConfig, spec: LayerSpec, sets: int = 1):
    """x: (B, S, D) -> (x (B, S, D), aux): the MoE aux loss, 0.0 for a layer
    without experts.  ``sets``: the number of equal MoE token sets of the
    B * S tokens (``models.moe.moe``)."""
    eps, zc = cfg.norm_eps, cfg.zero_centered_norm
    aux = 0.0
    h = rmsnorm(params["norm1"], x, eps, zc)
    if spec.kind == "attn":
        h = attention_forward(params["attn"], h, positions, _attn_cfg(cfg, spec))
    elif spec.kind == "mamba":
        h = mamba_forward(params["mamba"], h, cfg.mamba)
    else:
        h = rwkv_time_mix(params["rwkv_tm"], h, cfg.rwkv)
    if cfg.post_norms:
        h = rmsnorm(params["norm1_post"], h, eps, zc)
    x = x + h.to(x.dtype)
    if spec.mlp == "none":
        return x, aux
    h = rmsnorm(params["norm2"], x, eps, zc)
    if spec.mlp == "mlp":
        h = mlp(params["mlp"], h, act=cfg.act)
    elif spec.mlp == "moe":
        h, aux = moe(params["moe"], h, cfg.moe, sets)
    else:
        h = rwkv_channel_mix(params["rwkv_cm"], h)
    if cfg.post_norms:
        h = rmsnorm(params["norm2_post"], h, eps, zc)
    return x + h.to(x.dtype), aux


def apply_period(params, x, positions, cfg: ModelConfig, sets: int = 1):
    """Returns (x, the period's summed aux loss)."""
    aux = 0.0
    for p, spec in zip(params["layers"], cfg.pattern):
        x, a = apply_layer(p, x, positions, cfg, spec, sets)
        aux = aux + a
    return x, aux


def apply_periods(stacked, x, positions, cfg: ModelConfig, remat: bool = False,
                  sets: int = 1):
    """Loop over the stacked periods (``repro``'s scan); returns (x, total
    aux).  ``remat`` recomputes each period in the backward (one
    ``torch.utils.checkpoint`` per period, ``repro``'s
    ``jax.checkpoint(body)``); it applies only while autograd records."""
    aux = 0.0
    for i in range(cfg.n_periods):
        x, a = apply_period_remat(tree_index(stacked, i), x, positions, cfg, remat, sets)
        aux = aux + a
    return x, aux


def apply_period_remat(params, x, positions, cfg: ModelConfig, remat: bool, sets: int = 1):
    """:func:`apply_period`, checkpointed when ``remat`` and grad mode is on."""
    if remat and torch.is_grad_enabled():
        return checkpoint(apply_period, params, x, positions, cfg, sets, use_reentrant=False)
    return apply_period(params, x, positions, cfg, sets)


# ---------------------------------------------------------------------------
# Decode (one token)
# ---------------------------------------------------------------------------


def decode_layer(params, x, position, state, cfg: ModelConfig, spec: LayerSpec,
                 sets: int = 1):
    """x: (B, D) one position.  Returns (x, state); the KV cache, Mamba or
    RWKV states in ``state`` are updated in place.  ``sets``: the number of
    equal MoE token sets of the B rows (``models.moe.moe``)."""
    eps, zc = cfg.norm_eps, cfg.zero_centered_norm
    h = rmsnorm(params["norm1"], x, eps, zc)
    if spec.kind == "attn":
        h, state_m = attention_decode(params["attn"], h, position, state["mixer"],
                                      _attn_cfg(cfg, spec))
    elif spec.kind == "mamba":
        h, state_m = mamba_decode(params["mamba"], h, cfg.mamba, state["mixer"])
    else:
        h, state_m = rwkv_time_mix_decode(params["rwkv_tm"], h, cfg.rwkv, state["mixer"])
    if cfg.post_norms:
        h = rmsnorm(params["norm1_post"], h, eps, zc)
    x = x + h.to(x.dtype)
    new_state = {"mixer": state_m}
    if spec.mlp != "none":
        h = rmsnorm(params["norm2"], x, eps, zc)
        if spec.mlp == "mlp":
            h = mlp(params["mlp"], h, act=cfg.act)
        elif spec.mlp == "moe":
            h, _ = moe(params["moe"], h, cfg.moe, sets)   # the aux loss is a training term
        else:
            h, new_state["cm"] = rwkv_channel_mix_decode(params["rwkv_cm"], h, state["cm"])
        if cfg.post_norms:
            h = rmsnorm(params["norm2_post"], h, eps, zc)
        x = x + h.to(x.dtype)
    return x, new_state


def decode_period(params, x, position, states, cfg: ModelConfig, sets: int = 1):
    new_states = []
    for p, spec, st in zip(params["layers"], cfg.pattern, states):
        x, ns = decode_layer(p, x, position, st, cfg, spec, sets)
        new_states.append(ns)
    return x, tuple(new_states)


def decode_periods(stacked, x, position, states, cfg: ModelConfig, sets: int = 1):
    """Decode over stacked periods; ``states`` is stacked the same way and
    updated in place (the returned tree holds the same tensors)."""
    for i in range(cfg.n_periods):
        x, _ = decode_period(tree_index(stacked, i), x, position,
                             tree_index(states, i), cfg, sets)
    return x, states


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_layer_state(batch: int, max_len: int, cfg: ModelConfig, spec: LayerSpec,
                     dtype, device="cuda", lead: tuple = ()):
    _check_spec(spec)
    if spec.kind == "mamba":
        return {"mixer": init_mamba_state(batch, cfg.d_model, cfg.mamba, dtype, device, lead)}
    if spec.kind == "rwkv":
        full = init_rwkv_state(batch, cfg.d_model, cfg.rwkv, dtype, device, lead)
        st = {"mixer": full["tm"]}
        if spec.mlp == "rwkv_cm":
            st["cm"] = full["cm"]
        return st
    # Sliding-window layers only need `window` cache slots.
    a = _attn_cfg(cfg, spec)
    eff_len = max_len if a.window is None else min(max_len, a.window)
    return {"mixer": init_attention_cache(batch, max(eff_len, 1), a, dtype, device, lead)}


def init_period_states(batch: int, max_len: int, cfg: ModelConfig, dtype, device="cuda"):
    """Stacked decode states: leaves get leading dim n_periods."""
    return tuple(init_layer_state(batch, max_len, cfg, s, dtype, device, (cfg.n_periods,))
                 for s in cfg.pattern)
