"""Decode attention on the card: one query token vs a KV cache.

Python side of ``csrc/decode_attention.cu`` (which carries the design note),
the port of ``repro.kernels.decode_attention.flash_decode``.  The kernel
reads the cache in its model layout ``(B, S, Hkv, D)`` by strides, so the
caller makes no transposed or padded copy of it.  Its latent route
(:func:`flash_decode_latent`) is the same function for MLA's latent
cache: one key of two strided pieces, and values narrower than the key.
"""

from __future__ import annotations

import functools

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


#: query heads a CTA of the latent route serves, and keys a chunk
#: (``csrc/decode_attention.cu``'s ``kLatHeads`` / ``kLatKeys``; the C entry
#: point refuses a split count above its ``kLatMaxSplits``, 16)
LATENT_HEADS, LATENT_KEYS = 16, 32
#: the latent route's widths: c_kv at most 512 wide, c_kv ‖ k_rope at most 576
LATENT_MAX_R, LATENT_MAX_WIDTH = 512, 576


def latent_splits(B: int, H: int, S: int, n_sm: int) -> int:
    """Splits of each row's keys for the latent route: doubled (to 16 at
    most) while the grid of B * ceil(H / 16) * splits CTAs (one an SM: each
    holds 185 KB of shared memory at the published widths) still fits the
    card's SMs and each split keeps 2 chunks of 32 keys of the longest row."""
    rows = B * -(-H // LATENT_HEADS)
    chunks = -(-S // LATENT_KEYS)
    P = 1
    while P < 16 and rows * 2 * P <= n_sm and chunks >= 4 * P:
        P *= 2
    return P


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in t.stride()[:-1])


def flash_decode_latent(q_lat, q_rope, c_kv, k_rope, cache_len, *, scale: float):
    """MLA's latent decode (``repro.models.attention.mla_decode``'s softmax
    in latent space): q_lat (B, H, R) ‖ q_rope (B, H, Dr) against one key
    shared by the H heads, c_kv (B, S, R) ‖ k_rope (B, S, Dr), read by
    strides from the two caches (no concatenated copy), values c_kv.
    ``cache_len``: int or (B,) int32.  Returns (B, H, R) float32.

    The scale is the caller's (MLA's (qk_nope + qk_rope) ** -0.5, not the
    key width's).  CUDA float32 tensors only; R <= 512 and R + Dr <= 576,
    multiples of 4; cache rows with unit stride, 16-byte aligned."""
    for t in (q_lat, q_rope, c_kv, k_rope):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_decode_latent takes float32, not {t.dtype}")
    _build.check_cuda("flash_decode_latent", q_lat, q_rope, c_kv, k_rope)
    B, H, R = q_lat.shape
    Bc, S, Rc = c_kv.shape
    Dr = q_rope.shape[-1]
    if q_rope.shape != (B, H, Dr) or Bc != B or Rc != R or k_rope.shape != (B, S, Dr):
        raise ValueError(f"flash_decode_latent: q {tuple(q_lat.shape)} ‖ "
                         f"{tuple(q_rope.shape)} does not fit caches {tuple(c_kv.shape)} "
                         f"‖ {tuple(k_rope.shape)}")
    if R % 4 or Dr % 4 or R > LATENT_MAX_R or R + Dr > LATENT_MAX_WIDTH:
        raise ValueError(f"flash_decode_latent: widths {R} + {Dr}: each a multiple of 4, "
                         f"R <= {LATENT_MAX_R}, R + Dr <= {LATENT_MAX_WIDTH}")
    if c_kv.stride(-1) != 1 or k_rope.stride(-1) != 1 \
            or not (_aligned(c_kv) and _aligned(k_rope)):
        raise ValueError("flash_decode_latent: cache rows need unit stride and "
                         "16-byte aligned rows")
    check_cache_len(q_lat, cache_len)
    if isinstance(cache_len, torch.Tensor):
        lens, len_scalar = cache_len.contiguous(), 0
    else:
        lens, len_scalar = None, int(cache_len)
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_lat.device)
    P = latent_splits(B, H, S, _sm_count(q_lat.device))
    part = (torch.empty(B * H * P * (R + 2), dtype=torch.float32, device=q_lat.device)
            if P > 1 else None)
    _build.LAUNCHES["flash_decode_latent"] += 1
    with torch.cuda.device(q_lat.device):
        _build.launch(
            "decode_latent", q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
            k_rope.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
            None if lens is None else lens.data_ptr(), len_scalar, B, H, S, R, Dr,
            c_kv.stride(0), c_kv.stride(1), k_rope.stride(0), k_rope.stride(1),
            float(scale), P, _build.stream_of(q_lat))
    return out
