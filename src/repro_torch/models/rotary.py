"""Rotary position embeddings (RoPE), split-half convention, including
partial-dim RoPE for MLA."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0, device=None):
    """cos/sin tables for given positions.

    positions: int32 tensor (...,) -> cos, sin: (..., head_dim // 2) float32.
    A Python int position gives (head_dim // 2,) tables computed on
    ``device`` without a host-to-device copy.
    """
    if isinstance(positions, torch.Tensor):
        freqs = rope_freqs(head_dim, theta, positions.device)
        angles = positions[..., None].float() * freqs
    else:
        angles = float(positions) * rope_freqs(head_dim, theta, device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) with cos/sin (..., S, D//2); broadcast over heads."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos_b = cos[..., None, :]
    sin_b = sin[..., None, :]
    out1 = x1 * cos_b - x2 * sin_b
    out2 = x2 * cos_b + x1 * sin_b
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rope_partial(x: torch.Tensor, cos, sin, rope_dim: int) -> torch.Tensor:
    """RoPE on the *last* ``rope_dim`` channels only (DeepSeek MLA layout)."""
    if rope_dim == x.shape[-1]:
        return apply_rope(x, cos, sin)
    pass_dim = x.shape[-1] - rope_dim
    return torch.cat([x[..., :pass_dim], apply_rope(x[..., pass_dim:], cos, sin)], dim=-1)
