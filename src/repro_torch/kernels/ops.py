"""Layout wrappers, dispatch and launch counts for the ported kernels.

Each ``*_op`` takes the model layout (the counterparts of
``repro.kernels.ops``).  For a CUDA tensor it launches the hand-written
kernel and adds one to that kernel's count in :data:`LAUNCHES`; for a CPU
tensor it runs the plain version (``plain_*`` below, the layout wrappers of
:mod:`repro_torch.kernels.ref`).  Nothing falls back: a kernel that cannot
launch raises.

Unlike ``repro.kernels.ops``, the kernels read (B, S, H, D) and (B, S, Hkv,
D) by strides, so the CUDA path makes no transposed copy of q/k/v or of the
KV cache; only the plain versions transpose.
"""

from __future__ import annotations

import torch

from .decode_attention import flash_decode
from .flash_attention import flash_attention
from .fused_swiglu import fused_swiglu
from .ref import naive_attention, naive_decode, naive_swiglu

#: launches of each kernel since the last :func:`reset_launches` (one per
#: op call; fused_swiglu's two launches count as one call)
LAUNCHES = {"flash_decode": 0, "flash_attention": 0, "fused_swiglu": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plain_flash_attention(q, k, v, **kw):
    """(B, S, H, D) layout around ``naive_attention`` (heads into the batch)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, S, D)
    kf = k.transpose(1, 2).reshape(B * Hkv, S, D)
    vf = v.transpose(1, 2).reshape(B * Hkv, S, v.shape[-1])
    out = naive_attention(qf, kf, vf, **kw)
    return out.reshape(B, H, S, -1).transpose(1, 2)


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


def flash_attention_op(q, k, v, **kw):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) -> (B, S, H, D)."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, **kw)
    LAUNCHES["flash_attention"] += 1
    return flash_attention(q, k, v, **kw)


def flash_decode_op(q, k_cache, v_cache, cache_len, **kw):
    """q: (B, H, D); caches: (B, S, Hkv, D); cache_len: int or (B,) int32."""
    if q.device.type == "cpu":
        return plain_flash_decode(q, k_cache, v_cache, cache_len, **kw)
    LAUNCHES["flash_decode"] += 1
    return flash_decode(q, k_cache, v_cache, cache_len, **kw)


def fused_swiglu_op(x, wg, wu, wd, act: str = "silu"):
    """(..., D) layout wrapper."""
    if x.device.type == "cpu":
        return plain_fused_swiglu(x, wg, wu, wd, act)
    LAUNCHES["fused_swiglu"] += 1
    shape = x.shape
    return fused_swiglu(x.reshape(-1, shape[-1]), wg, wu, wd, act=act).reshape(shape)
