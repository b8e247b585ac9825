"""Normalization layers (RMSNorm family)."""

from __future__ import annotations

import torch

from .module import ones_init, zeros_init


def init_rmsnorm(dim: int, dtype=torch.float32, zero_centered: bool = False,
                 device="cuda", lead: tuple = ()):
    """RMSNorm params; ``zero_centered`` (Gemma-style) stores ``w`` with
    effective scale ``1 + w`` — pass the same flag to :func:`rmsnorm`."""
    init = zeros_init if zero_centered else ones_init
    return {"scale": init((*lead, dim), dtype, device)}


def rmsnorm(params, x, eps: float = 1e-6, zero_centered: bool = False):
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * (var + eps) ** -0.5
    scale = params["scale"].float()
    if zero_centered:
        scale = 1.0 + scale
    return (xf * scale).to(dtype)
