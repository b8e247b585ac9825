"""Attention: GQA/MQA, sliding window, logit softcap (MLA is not ported yet).

Two execution paths, as in ``repro.models.attention``:

* ``blocked_causal_attention`` — prefill.  Exact causal (optionally
  sliding-window) attention; on the card it is the hand-written flash
  kernel, which tiles q and kv and never materialises the S×S scores.
* ``decode_attention`` — one query token against a KV cache, per-row or
  shared ``cache_len``; on the card it is the hand-written decode kernel.

Both go through :mod:`repro_torch.kernels.ops`, which runs the plain
versions for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .config import AttentionConfig
from .module import dense_init
from .rotary import apply_rope, rope_cos_sin


def init_attention(gen, d_model: int, cfg: AttentionConfig, dtype=torch.float32,
                   device="cuda", lead: tuple = ()):
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (*lead, d_model, h * d), d_model, dtype, device),
        "wk": dense_init(gen, (*lead, d_model, kvh * d), d_model, dtype, device),
        "wv": dense_init(gen, (*lead, d_model, kvh * d), d_model, dtype, device),
        "wo": dense_init(gen, (*lead, h * d, d_model), h * d, dtype, device),
    }


def blocked_causal_attention(q, k, v, *, scale: float, window: int | None = None,
                             softcap: float | None = None):
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D), causal."""
    return ops.flash_attention_op(q, k, v, scale=scale, causal=True,
                                  window=window, softcap=softcap)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float,
                     window: int | None = None, softcap: float | None = None):
    """q: (B, Hq, D); caches (B, S, Hkv, D); cache_len int or (B,) int32."""
    return ops.flash_decode_op(q, k_cache, v_cache, cache_len, scale=scale,
                               window=window, softcap=softcap)


def attention_forward(params, x, positions, cfg: AttentionConfig):
    """Prefill attention over a full sequence (causal).

    x: (B, S, d_model); positions: (B, S) int32 -> (B, S, d_model).
    """
    B, S, _ = x.shape
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, h, d)
    k = (x @ params["wk"]).reshape(B, S, kvh, d)
    v = (x @ params["wv"]).reshape(B, S, kvh, d)
    cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = blocked_causal_attention(q, k, v, scale=d ** -0.5, window=cfg.window,
                                 softcap=cfg.softcap)
    return o.reshape(B, S, h * d) @ params["wo"]


def attention_decode(params, x, position, cache: dict, cfg: AttentionConfig):
    """One decode step.  Returns (out (B, d_model), cache).

    x: (B, d_model).  ``position`` is a Python int (the whole batch decodes
    in lockstep) or a (B,) int32 tensor (each row at its own position).
    The cache ``{"k", "v"}: (B, S, Hkv, D)`` is updated in place.
    """
    B, _ = x.shape
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, h, d)
    k = (x @ params["wk"]).reshape(B, kvh, d)
    v = (x @ params["wv"]).reshape(B, kvh, d)
    cos, sin = rope_cos_sin(position, d, cfg.rope_theta, x.device)
    cos, sin = cos.reshape(-1, 1, d // 2), sin.reshape(-1, 1, d // 2)
    q = apply_rope(q[:, None], cos, sin)[:, 0]
    k = apply_rope(k[:, None], cos, sin)[:, 0]

    eff_len = cache["k"].shape[1]
    if cfg.window is not None and eff_len <= cfg.window:
        # Ring-buffer cache holding exactly the window: eviction enforces the
        # window, so no position mask beyond "slot already written" is needed.
        _cache_insert(cache, {"k": k, "v": v}, position % eff_len)
        if isinstance(position, torch.Tensor):
            cache_len = torch.clamp(position + 1, max=eff_len).to(torch.int32)
        else:
            cache_len = min(position + 1, eff_len)
        win = None
    else:
        _cache_insert(cache, {"k": k, "v": v}, position)
        cache_len = position + 1
        if isinstance(cache_len, torch.Tensor):
            cache_len = cache_len.to(torch.int32)     # flash_decode's (B,) int32
        win = cfg.window
    o = decode_attention(q, cache["k"], cache["v"], cache_len, scale=d ** -0.5,
                         window=win, softcap=cfg.softcap)
    return o.reshape(B, h * d) @ params["wo"], cache


def _cache_insert(cache: dict, new: dict, position):
    """Write this step's K/V into the cache **in place** and return it.

    ``repro``'s version returns an updated copy (JAX arrays are immutable);
    here the (B, S, ...) buffers, usually views into the period-stacked
    cache, are written directly: a scalar ``position`` writes one seq slot
    for the whole batch, a (B,) tensor writes row b at ``position[b]``.
    """
    for name, val in new.items():
        buf = cache[name]
        if isinstance(position, torch.Tensor):
            rows = torch.arange(buf.shape[0], device=buf.device)
            buf[rows, position.long()] = val.to(buf.dtype)
        else:
            buf[:, position] = val.to(buf.dtype)
    return cache


def init_attention_cache(batch: int, max_len: int, cfg: AttentionConfig, dtype,
                         device="cuda", lead: tuple = ()) -> dict:
    """Empty decode cache ``{"k", "v"}: (*lead, B, max_len, Hkv, D)``."""
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
