"""The RWKV-6 WKV recurrence on the card.

Python side of ``csrc/rwkv6_wkv.cu`` (which carries the design note), the
port of ``repro.kernels.rwkv6_wkv.rwkv6_wkv``: out_t = r_t (S_{t-1} +
diag(u) k_tᵀ v_t) with S_t = diag(w_t) S_{t-1} + k_tᵀ v_t from S = 0.
Serving only: there is no backward kernel.
"""

from __future__ import annotations

import torch

from . import _build

#: the head sizes the kernel is compiled for
D_HEADS = (32, 64)


def rwkv6_wkv(r, k, v, w, u):
    """r/k/v/w: (B, H, S, d) float32 CUDA tensors with d contiguous and rows
    16-byte aligned (head views of (B, S, H·d) projections, or contiguous);
    w is the per-step decay; u: (H, d); d in :data:`D_HEADS`.  Returns the
    (B, H, S, d) float32 WKV output, before ``ln_x``."""
    _build.check_cuda("rwkv6_wkv", r, k, v, w, u)
    B, H, S, d = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, d):
        raise ValueError(f"rwkv6_wkv: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise ValueError("rwkv6_wkv takes float32 inputs")
    if d not in D_HEADS:
        raise ValueError(f"rwkv6_wkv: head size {d} not in {D_HEADS}")
    for t in (r, k, v, w):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
            raise ValueError("rwkv6_wkv reads rows of d contiguous floats at 16-byte "
                             f"aligned addresses; got strides {t.stride()}")
    u = u.contiguous()
    out = torch.empty((B, H, S, d), dtype=torch.float32, device=r.device)
    _build.LAUNCHES["rwkv6_wkv"] += 1
    with torch.cuda.device(r.device):
        _build.launch("rwkv6_wkv", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), out.data_ptr(), B, H, S, d, _build.strides3(r),
                      _build.strides3(k), _build.strides3(v), _build.strides3(w),
                      _build.stream_of(r))
    return out
