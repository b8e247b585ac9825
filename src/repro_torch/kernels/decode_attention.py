"""Decode attention on the card: one query token vs a KV cache.

Python side of ``csrc/decode_attention.cu`` (which carries the design note),
the port of ``repro.kernels.decode_attention.flash_decode``.  The kernel
reads the cache in its model layout ``(B, S, Hkv, D)`` by strides, so the
caller makes no transposed or padded copy of it.
"""

from __future__ import annotations

import torch

from . import _build


def check_cache_len(q, cache_len) -> None:
    """A tensor ``cache_len`` must be (B,) int32 on q's device; raises
    ``ValueError`` otherwise (an int is any length)."""
    if isinstance(cache_len, torch.Tensor) and (
            cache_len.shape != (q.shape[0],) or cache_len.dtype != torch.int32
            or cache_len.device != q.device):
        raise ValueError("flash_decode: a tensor cache_len is (B,) int32 on q's device, "
                         f"got {tuple(cache_len.shape)} {cache_len.dtype} on "
                         f"{cache_len.device}")


def flash_decode(q, k_cache, v_cache, cache_len, *, scale: float | None = None,
                 window: int | None = None, softcap: float | None = None):
    """q: (B, H, D); k/v_cache: (B, S, Hkv, D); cache_len: int or (B,) int32.

    Returns (B, H, D).  q head h reads kv head h // (H // Hkv); row b sees
    keys ``[max(0, len_b - window), len_b)``.  CUDA tensors only.
    """
    code = _build.dtype_code("flash_decode", q, k_cache, v_cache)
    B, H, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or Dk != D or H % Hkv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if D > 256 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("flash_decode: head_dim must be <= 256 with unit stride")
    check_cache_len(q, cache_len)
    if isinstance(cache_len, torch.Tensor):
        lens, len_scalar = cache_len.contiguous(), 0
    else:
        lens, len_scalar = None, int(cache_len)
    q = q.contiguous()
    out = torch.empty_like(q)
    _build.LAUNCHES["flash_decode"] += 1
    with torch.cuda.device(q.device):
        _build.launch(
            "decode_attention", code, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), out.data_ptr(),
            None if lens is None else lens.data_ptr(), len_scalar,
            B, H, Hkv, S, D, _build.strides3(k_cache), _build.strides3(v_cache),
            D ** -0.5 if scale is None else scale,
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _build.stream_of(q))
    return out
