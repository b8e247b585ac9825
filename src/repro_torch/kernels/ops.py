"""Layout wrappers, dispatch and launch counts for the ported kernels.

Each ``*_op`` takes the model layout (the counterparts of
``repro.kernels.ops``).  For a CUDA tensor it launches the hand-written
kernel; for a CPU tensor it runs the plain version (``plain_*`` below, the
layout wrappers of :mod:`repro_torch.kernels.ref`), which autograd
differentiates.  On the card, attention and SwiGLU go through
``autograd.Function``s whose backward is a kernel too whenever a gradient
may be needed; the Mamba scan and the RWKV WKV serve only and have no
backward kernel.
Nothing falls back: a kernel that cannot launch raises, and a gradient that
no kernel covers raises ``NotImplementedError``.

:data:`LAUNCHES` counts the calls of each kernel's C entry point; the
Python function that makes the call adds the one (``_build.LAUNCHES``).

Unlike ``repro.kernels.ops``, the kernels read (B, S, H, D) and (B, S, Hkv,
D) by strides, so the CUDA path makes no transposed copy of q/k/v or of the
KV cache; only the plain versions transpose.
"""

from __future__ import annotations

import torch

from ._build import LAUNCHES
from .decode_attention import check_cache_len, flash_decode, flash_decode_latent
from .flash_attention import FlashAttentionFn, flash_attention
from .fused_swiglu import FusedSwigluFn, fused_swiglu
from .mamba_scan import mamba_scan
from .quant_transfer import dequantize_tiles_op, quantize_tiles_op  # noqa: F401
from .ref import (naive_attention, naive_decode, naive_latent_decode, naive_mamba_scan,
                  naive_swiglu, naive_wkv6)
from .rwkv6_wkv import rwkv6_wkv

__all__ = ["LAUNCHES", "reset_launches", "flash_attention_op", "flash_decode_op",
           "flash_decode_latent_op", "fused_swiglu_op", "mamba_scan_op", "rwkv6_wkv_op",
           "quantize_tiles_op", "dequantize_tiles_op", "plain_flash_attention",
           "plain_flash_attention_bwd",
           "plain_flash_decode", "plain_fused_swiglu", "plain_rwkv6_wkv"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_flash_attention(q, k, v, **kw):
    """(B, S, H, D) layout around ``naive_attention`` (heads into the batch)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, S, D)
    kf = k.transpose(1, 2).reshape(B * Hkv, S, D)
    vf = v.transpose(1, 2).reshape(B * Hkv, S, v.shape[-1])
    out = naive_attention(qf, kf, vf, **kw)
    return out.reshape(B, H, S, -1).transpose(1, 2)


def plain_flash_attention_bwd(q, k, v, dout, **kw):
    """(dq, dk, dv) of :func:`plain_flash_attention`, by autograd."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        return torch.autograd.grad(plain_flash_attention(qq, kk, vv, **kw),
                                   (qq, kk, vv), dout)


def plain_flash_decode(q, k_cache, v_cache, cache_len, **kw):
    """q: (B, H, D); caches (B, S, Hkv, D); cache_len int or (B,)."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    kf = k_cache.transpose(1, 2).reshape(B * Hkv, S, D)
    vf = v_cache.transpose(1, 2).reshape(B * Hkv, S, v_cache.shape[-1])
    if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
        cache_len = cache_len.repeat_interleave(Hkv)     # per-slot -> per-kv-row
    out = naive_decode(q.reshape(B * H, D), kf, vf, cache_len, **kw)
    return out.reshape(B, H, -1)


def plain_fused_swiglu(x, wg, wu, wd, act: str = "silu"):
    shape = x.shape
    return naive_swiglu(x.reshape(-1, shape[-1]), wg, wu, wd, act).reshape(shape)


def plain_rwkv6_wkv(r, k, v, w, u):
    """(B, H, S, d) layout around ``naive_wkv6`` (heads into the batch);
    u (H, d) is shared by the batch."""
    B, H, S, d = r.shape
    flat = (t.reshape(B * H, S, d) for t in (r, k, v, w))
    return naive_wkv6(*flat, u.repeat(B, 1)).reshape(B, H, S, d)


def flash_attention_op(q, k, v, *, scale=None, causal=True, window=None, softcap=None):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) -> (B, S, H, D)."""
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, **kw)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, scale, causal, window, softcap)
    return flash_attention(q, k, v, **kw)


def flash_decode_op(q, k_cache, v_cache, cache_len, **kw):
    """q: (B, H, D); caches: (B, S, Hkv, D); cache_len: int or (B,) int32.
    Forward only: decoding is never differentiated.  The kernel's contract
    on a tensor ``cache_len`` is checked on both routes, so a CPU caller that
    would fail on the card fails here too."""
    check_cache_len(q, cache_len)
    if q.device.type == "cpu":
        return plain_flash_decode(q, k_cache, v_cache, cache_len, **kw)
    return flash_decode(q, k_cache, v_cache, cache_len, **kw)


def flash_decode_latent_op(q_lat, q_rope, c_kv, k_rope, cache_len, *, scale: float):
    """MLA's latent decode: q_lat (B, H, R) ‖ q_rope (B, H, Dr) against the
    caches c_kv (B, S, R) ‖ k_rope (B, S, Dr), values c_kv -> (B, H, R)
    float32; cache_len int or (B,) int32.  Forward only, as
    :func:`flash_decode_op`."""
    check_cache_len(q_lat, cache_len)
    if q_lat.device.type == "cpu":
        return naive_latent_decode(q_lat, q_rope, c_kv, k_rope, cache_len, scale=scale)
    return flash_decode_latent(q_lat, q_rope, c_kv, k_rope, cache_len, scale=scale)


def fused_swiglu_op(x, wg, wu, wd, act: str = "silu"):
    """(..., D) layout wrapper."""
    if x.device.type == "cpu":
        return plain_fused_swiglu(x, wg, wu, wd, act)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _needs_grad(x, wg, wu, wd):
        return FusedSwigluFn.apply(x2, wg, wu, wd, act).reshape(shape)
    return fused_swiglu(x2, wg, wu, wd, act=act).reshape(shape)


def mamba_scan_op(dt, b, c, x, a):
    """dt/x: (B, S, d); b/c: (B, S, N); a: (d, N) -> y (B, S, d), the C·h
    readout from h = 0.  Forward only on the card: a call that needs a
    gradient raises ``NotImplementedError``."""
    if dt.device.type == "cpu":
        return naive_mamba_scan(dt, b, c, x, a)
    if _needs_grad(dt, b, c, x, a):
        raise NotImplementedError("mamba_scan has no backward kernel: the port "
                                  "serves Mamba layers and does not train them")
    return mamba_scan(dt, b, c, x, a)


def rwkv6_wkv_op(r, k, v, w, u):
    """r/k/v/w: (B, H, S, d), w the per-step decay; u: (H, d) -> (B, H, S, d)
    float32, the WKV output from zero state.  Forward only on the card: a
    call that needs a gradient raises ``NotImplementedError``."""
    if r.device.type == "cpu":
        return plain_rwkv6_wkv(r, k, v, w, u)
    if _needs_grad(r, k, v, w, u):
        raise NotImplementedError("rwkv6_wkv has no backward kernel: the port serves "
                                  "RWKV layers and does not train them")
    return rwkv6_wkv(r, k, v, w, u)
