"""Fused SwiGLU MLP on the card: act(x·Wg) ⊙ (x·Wu) · Wd.

Python side of ``csrc/fused_swiglu.cu`` (which carries the design note),
the port of ``repro.kernels.fused_swiglu.fused_swiglu``.  Two launches with
a (T, F) float32 hidden tensor between them; any T, D and F (edges masked).
"""

from __future__ import annotations

import torch

from . import _build

ACTS = {"silu": 0, "gelu_tanh": 1}


def fused_swiglu(x, wg, wu, wd, *, act: str = "silu"):
    """x: (T, D); wg/wu: (D, F); wd: (F, D) -> (T, D).  CUDA tensors only."""
    code = _build.dtype_code("fused_swiglu", x, wg, wu, wd)
    if act not in ACTS:
        raise ValueError(f"fused_swiglu has no activation {act!r}")
    T, D = x.shape
    F = wg.shape[1]
    if wg.shape != (D, F) or wu.shape != (D, F) or wd.shape != (F, D):
        raise ValueError(f"fused_swiglu: x {tuple(x.shape)}, wg {tuple(wg.shape)}, "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if not all(w.is_contiguous() for w in (wg, wu, wd)):
        raise ValueError("fused_swiglu: weights must be contiguous")
    x = x.contiguous()
    h = torch.empty((T, F), dtype=torch.float32, device=x.device)
    out = torch.empty((T, D), dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    with torch.cuda.device(x.device):
        _build.launch("fused_swiglu", code, ACTS[act], x.data_ptr(), wg.data_ptr(),
                      wu.data_ptr(), wd.data_ptr(), h.data_ptr(), out.data_ptr(),
                      T, D, F, _build.stream_of(x))
    return out
