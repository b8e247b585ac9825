"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Same layouts and arithmetic as ``repro.kernels.ref``.  They run on any
device: the kernel wrappers in :mod:`repro_torch.kernels.ops` take them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _softcap(s, softcap):
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def naive_attention(q, k, v, *, scale=None, causal=True, window=None,
                    softcap=None):
    """q: (BH, S, D); k/v: (BHkv, S, D).  Full-softmax reference; q row i
    reads kv row i // (BH // BHkv)."""
    BH, S, D = q.shape
    G = BH // k.shape[0]
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(G, dim=0).float()
    vv = v.repeat_interleave(G, dim=0).float()
    s = _softcap(torch.einsum("bqd,bkd->bqk", q.float(), kk) * scale, softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)


def naive_decode(q, k_cache, v_cache, cache_len, *, scale=None, window=None,
                 softcap=None):
    """q: (BH, D); caches (BHkv, S, D); one-token attention.

    ``cache_len`` is an int, a 0-d tensor, or a (BHkv,) tensor of per-kv-row
    lengths (as ``repro``'s Pallas kernel takes them); q row i uses the
    length of kv row i // G.  ``softcap`` is the tanh logit cap that
    ``repro.models.attention.decode_attention`` applies.
    """
    BH, D = q.shape
    BHkv, S, _ = k_cache.shape
    G = BH // BHkv
    if scale is None:
        scale = D ** -0.5
    kk = k_cache.repeat_interleave(G, dim=0).float()
    vv = v_cache.repeat_interleave(G, dim=0).float()
    s = _softcap(torch.einsum("bd,bkd->bk", q.float(), kk) * scale, softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.ndim == 1:
        clen = clen.repeat_interleave(G)[:, None]
    mask = pos < clen
    if window is not None:
        mask &= pos >= clen - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", p, vv).to(q.dtype)


def naive_swiglu(x, wg, wu, wd, act: str = "silu"):
    """x: (T, D); wg/wu: (D, F); wd: (F, D) -> (T, D), f32 accumulation."""
    xf = x.float()
    g = xf @ wg.float()
    uu = xf @ wu.float()
    if act == "silu":
        h = F.silu(g) * uu
    elif act == "gelu_tanh":
        h = F.gelu(g, approximate="tanh") * uu
    else:
        raise ValueError(f"fused_swiglu has no activation {act!r}")
    return (h @ wd.float()).to(x.dtype)
