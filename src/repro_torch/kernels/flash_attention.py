"""Flash attention forward on the card: causal / window / softcap / GQA.

Python side of ``csrc/flash_attention.cu`` (which carries the design note),
the port of ``repro.kernels.flash_attention.flash_attention``.  The kernel
reads q/k/v in the model layout ``(B, S, H, D)`` by strides and masks the
ragged tail of S instead of padding it.
"""

from __future__ import annotations

import torch

from . import _build


def flash_attention(q, k, v, *, scale: float | None = None, causal: bool = True,
                    window: int | None = None, softcap: float | None = None):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) -> (B, S, H, D) contiguous.

    q head h reads kv head h // (H // Hkv).  CUDA tensors only.
    """
    code = _build.dtype_code("flash_attention", q, k, v)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > 256 or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be <= 256 with unit stride")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch(
            "flash_attention", code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, Hkv, D, _build.strides3(q),
            _build.strides3(k), _build.strides3(v),
            D ** -0.5 if scale is None else scale, int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _build.stream_of(q))
    return out
