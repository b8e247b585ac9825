"""Fused SwiGLU MLP on the card: act(x·Wg) ⊙ (x·Wu) · Wd, and its backward.

Python side of ``csrc/fused_swiglu.cu`` and ``csrc/fused_swiglu_bwd.cu``
(which carry the design notes), the port of
``repro.kernels.fused_swiglu.fused_swiglu``.  The forward is two launches
with a (T, F) float32 hidden tensor between them; any T, D and F (edges
masked).  The backward recomputes g = x·Wg and u = x·Wu with
``torch.matmul`` (nothing of size (T, F) is saved between forward and
backward), runs the elementwise kernel ``swiglu_bwd`` for dg, du and h, and
leaves the weight and input gradient products to ``torch.matmul``, as
``repro`` leaves its MLP gradient products to XLA.
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
    _build.LAUNCHES["fused_swiglu"] += 1
    with torch.cuda.device(x.device):
        _build.launch("fused_swiglu", code, ACTS[act], x.data_ptr(), wg.data_ptr(),
                      wu.data_ptr(), wd.data_ptr(), h.data_ptr(), out.data_ptr(),
                      T, D, F, _build.stream_of(x))
    return out


def swiglu_bwd(g, u, dh, act: str = "silu"):
    """Elementwise SwiGLU backward on the card: float32 (T, F) g, u, dh ->
    (dg, du, h) with h = act(g)·u, du = dh·act(g), dg = dh·u·act'(g)."""
    _build.check_cuda("swiglu_bwd", g, u, dh)
    if act not in ACTS:
        raise ValueError(f"fused_swiglu has no activation {act!r}")
    if not (g.shape == u.shape == dh.shape) or any(t.dtype != torch.float32
                                                   for t in (g, u, dh)):
        raise ValueError("swiglu_bwd takes float32 g, u, dh of one shape")
    g, u, dh = g.contiguous(), u.contiguous(), dh.contiguous()
    dg, du, h = (torch.empty_like(g) for _ in range(3))
    _build.LAUNCHES["swiglu_bwd"] += 1
    with torch.cuda.device(g.device):
        _build.launch("swiglu_bwd", ACTS[act], g.data_ptr(), u.data_ptr(),
                      dh.data_ptr(), dg.data_ptr(), du.data_ptr(), h.data_ptr(),
                      g.numel(), _build.stream_of(g))
    return dg, du, h


class FusedSwigluFn(torch.autograd.Function):
    """Forward: the fused kernel; backward: recomputed g, u (matmuls), the
    ``swiglu_bwd`` kernel, then the gradient products (matmuls), in float32;
    a weight that takes no gradient (the profiler's input-only backward)
    skips its product."""

    @staticmethod
    def forward(ctx, x, wg, wu, wd, act):
        ctx.save_for_backward(x, wg, wu, wd)
        ctx.act = act
        return fused_swiglu(x, wg, wu, wd, act=act)

    @staticmethod
    def backward(ctx, dout):
        x, wg, wu, wd = ctx.saved_tensors
        xf, wgf, wuf, wdf, df = (t.float() for t in (x, wg, wu, wd, dout))
        g, u = xf @ wgf, xf @ wuf
        dg, du, h = swiglu_bwd(g, u, df @ wdf.T, ctx.act)
        del g, u
        dx = dg @ wgf.T + du @ wuf.T
        need = ctx.needs_input_grad
        return (dx.to(x.dtype),
                (xf.T @ dg).to(wg.dtype) if need[1] else None,
                (xf.T @ du).to(wu.dtype) if need[2] else None,
                (h.T @ df).to(wd.dtype) if need[3] else None, None)
