"""The Mamba selective scan on the card.

Python side of ``csrc/mamba_scan.cu`` (which carries the design note), the
port of ``repro.kernels.mamba_scan.mamba_scan``: y = C·h with
h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t x_t) ⊗ B_t from h = 0.  Serving only:
there is no backward kernel.
"""

from __future__ import annotations

import torch

from . import _build

#: the state sizes the kernel is compiled for
D_STATES = (8, 16)


def mamba_scan(dt, b, c, x, a):
    """dt/x: (B, S, d); b/c: (B, S, N); a: (d, N) = -exp(A_log); float32
    CUDA tensors, N in :data:`D_STATES`.  Returns y (B, S, d) float32 (the
    C·h readout; the D·x skip stays with the caller)."""
    _build.check_cuda("mamba_scan", dt, b, c, x, a)
    B, S, d = dt.shape
    N = b.shape[-1]
    if x.shape != dt.shape or b.shape != (B, S, N) or c.shape != b.shape \
            or a.shape != (d, N):
        raise ValueError(f"mamba_scan: shapes dt {tuple(dt.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}, x {tuple(x.shape)}, a {tuple(a.shape)}")
    if any(t.dtype != torch.float32 for t in (dt, b, c, x, a)):
        raise ValueError("mamba_scan takes float32 inputs")
    if N not in D_STATES:
        raise ValueError(f"mamba_scan: d_state {N} not in {D_STATES}")
    dt, b, c, x, a = (t.contiguous() for t in (dt, b, c, x, a))
    y = torch.empty_like(dt)
    _build.LAUNCHES["mamba_scan"] += 1
    with torch.cuda.device(dt.device):
        _build.launch("mamba_scan", dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                      x.data_ptr(), a.data_ptr(), y.data_ptr(), B, S, d, N,
                      _build.stream_of(dt))
    return y
