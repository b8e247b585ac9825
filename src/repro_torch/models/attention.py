"""Attention: GQA/MQA, sliding window, logit softcap, MLA.

Two execution paths, as in ``repro.models.attention``:

* ``blocked_causal_attention`` — prefill.  Exact causal (optionally
  sliding-window) attention; on the card it is the hand-written flash
  kernel, which tiles q and kv and never materialises the S×S scores.
* ``decode_attention`` — one query token against a KV cache, per-row or
  shared ``cache_len``; on the card it is the hand-written decode kernel.

DeepSeek-V3's MLA (``attn.mla``) prefills as ``repro`` does, with the latent
expanded to per-head K/V (q, k at qk_nope + qk_rope wide, v at v_head_dim,
zero-padded to the q/k width for the flash kernel and sliced back), and
decodes from the latent cache ``{"c_kv", "k_rope"}`` with the absorbed
products: the latent route of the decode kernel
(``ops.flash_decode_latent_op``).

All go through :mod:`repro_torch.kernels.ops`, which runs the plain
versions for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .config import AttentionConfig
from .module import dense_init
from .norms import init_rmsnorm, rmsnorm
from .rotary import apply_rope, apply_rope_partial, rope_cos_sin


def init_attention(gen, d_model: int, cfg: AttentionConfig, dtype=torch.float32,
                   device="cuda", lead: tuple = ()):
    if cfg.mla is not None:
        return init_mla_attention(gen, d_model, cfg, dtype, device, lead)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (*lead, d_model, h * d), d_model, dtype, device),
        "wk": dense_init(gen, (*lead, d_model, kvh * d), d_model, dtype, device),
        "wv": dense_init(gen, (*lead, d_model, kvh * d), d_model, dtype, device),
        "wo": dense_init(gen, (*lead, h * d, d_model), h * d, dtype, device),
    }


def init_mla_attention(gen, d_model: int, cfg: AttentionConfig, dtype=torch.float32,
                       device="cuda", lead: tuple = ()):
    """MLA params with ``repro``'s names and shapes: the query's down-projection,
    norm and up-projection to per-head nope ‖ rope; the joint KV
    down-projection to the latent and the shared rope key; the latent's
    norm and up-projections to per-head keys and values; the output."""
    m, h = cfg.mla, cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    rank = m.kv_lora_rank
    return {
        "wq_a": dense_init(gen, (*lead, d_model, m.q_lora_rank), d_model, dtype, device),
        "q_norm": init_rmsnorm(m.q_lora_rank, dtype, False, device, lead),
        "wq_b": dense_init(gen, (*lead, m.q_lora_rank, h * qk_dim), m.q_lora_rank, dtype,
                           device),
        "wkv_a": dense_init(gen, (*lead, d_model, rank + m.qk_rope_dim), d_model, dtype,
                            device),
        "kv_norm": init_rmsnorm(rank, dtype, False, device, lead),
        "wk_b": dense_init(gen, (*lead, rank, h * m.qk_nope_dim), rank, dtype, device),
        "wv_b": dense_init(gen, (*lead, rank, h * m.v_head_dim), rank, dtype, device),
        "wo": dense_init(gen, (*lead, h * m.v_head_dim, d_model), h * m.v_head_dim, dtype,
                         device),
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
    if cfg.mla is not None:
        return mla_forward(params, x, positions, cfg)
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
    The cache ``{"k", "v"}: (B, S, Hkv, D)`` (MLA: ``{"c_kv", "k_rope"}``)
    is updated in place.
    """
    if cfg.mla is not None:
        return mla_decode(params, x, position, cache, cfg)
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
        cache_len = _cache_len(position)
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


def _cache_len(position):
    """Keys valid after writing ``position``: an int, or (B,) int32 (the
    decode kernels' per-row lengths)."""
    if isinstance(position, torch.Tensor):
        return (position + 1).to(torch.int32)
    return position + 1


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _pad_last(t, width: int):
    return t if t.shape[-1] == width else torch.nn.functional.pad(
        t, (0, width - t.shape[-1]))


def mla_forward(params, x, positions, cfg: AttentionConfig):
    """MLA prefill: the latent expanded to per-head K/V (``repro``'s naive
    path).  q and k are qk_nope + qk_rope wide, v v_head_dim; the narrower
    of the two widths is zero-padded for the flash kernel (which takes one
    head_dim) and the output sliced to v_head_dim.  Autograd carries the
    gradient through the pad and the slice."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim

    cq = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (cq @ params["wq_b"]).reshape(B, S, h, qk_dim)

    kv_a = x @ params["wkv_a"]                               # (B, S, rank + rope)
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :m.kv_lora_rank])
    k_rope = kv_a[..., m.kv_lora_rank:]                      # shared across heads

    cos, sin = rope_cos_sin(positions, m.qk_rope_dim, cfg.rope_theta)
    q = apply_rope_partial(q, cos, sin, m.qk_rope_dim)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)     # (B, S, 1, rope)

    k_nope = (c_kv @ params["wk_b"]).reshape(B, S, h, m.qk_nope_dim)
    v = (c_kv @ params["wv_b"]).reshape(B, S, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_dim)], dim=-1)

    width = max(qk_dim, m.v_head_dim)
    o = blocked_causal_attention(_pad_last(q, width), _pad_last(k, width),
                                 _pad_last(v, width), scale=qk_dim ** -0.5,
                                 softcap=cfg.softcap)
    o = o[..., :m.v_head_dim].reshape(B, S, h * m.v_head_dim)
    return o @ params["wo"]


def mla_decode(params, x, position, cache: dict, cfg: AttentionConfig):
    """MLA decode from the *latent* cache with absorbed projections.

    The cache holds ``{"c_kv": (B, S, rank), "k_rope": (B, S, rope)}`` only
    (the paper's memory saving), written in place.  wk_b is absorbed into the
    query and wv_b into the output, as in ``repro`` (plain einsums); the
    attention in latent space is the decode kernel's latent route.
    """
    m = cfg.mla
    B, _ = x.shape
    h, rank, dr = cfg.n_heads, m.kv_lora_rank, m.qk_rope_dim

    cq = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (cq @ params["wq_b"]).reshape(B, h, m.qk_nope_dim + dr)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]

    kv_a = x @ params["wkv_a"]
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :rank])      # (B, rank)
    cos, sin = rope_cos_sin(position, dr, cfg.rope_theta, x.device)
    cos, sin = cos.reshape(-1, 1, dr // 2), sin.reshape(-1, 1, dr // 2)
    q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]
    k_rope = apply_rope(kv_a[:, None, None, rank:], cos, sin)[:, 0, 0]

    _cache_insert(cache, {"c_kv": c_kv, "k_rope": k_rope}, position)

    # absorb wk_b into q:  q_lat[b, h, r] = sum_d q_nope[b, h, d] * wk_b[r, h*d]
    wk_b = params["wk_b"].reshape(rank, h, m.qk_nope_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope.float(), wk_b.float())
    o_lat = ops.flash_decode_latent_op(q_lat, q_rope.float(), cache["c_kv"],
                                       cache["k_rope"], _cache_len(position),
                                       scale=(m.qk_nope_dim + dr) ** -0.5)
    # absorb wv_b:  o[b, h, dv] = sum_r o_lat[b, h, r] * wv_b[r, h*dv]
    wv_b = params["wv_b"].reshape(rank, h, m.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", o_lat, wv_b.float())
    return o.reshape(B, h * m.v_head_dim).to(x.dtype) @ params["wo"], cache


def init_attention_cache(batch: int, max_len: int, cfg: AttentionConfig, dtype,
                         device="cuda", lead: tuple = ()) -> dict:
    """Empty decode cache ``{"k", "v"}: (*lead, B, max_len, Hkv, D)``; for
    MLA the latent cache ``{"c_kv": (*lead, B, max_len, kv_lora_rank),
    "k_rope": (*lead, B, max_len, qk_rope_dim)}``."""
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((*lead, batch, max_len, m.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros((*lead, batch, max_len, m.qk_rope_dim), dtype=dtype,
                                      device=device)}
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
