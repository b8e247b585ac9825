"""Parameter initialisers (the counterparts of ``repro.models.module``'s).

Every initialiser draws from an explicit ``torch.Generator``, which must
live on the same device as the tensor it fills.  ``lead`` prepends stacking
axes (periods) to the shape: the draws are i.i.d., so a stacked init has
the same distribution as stacking per-period inits, without the copy.
"""

from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, in_dim: int | None = None,
               dtype=torch.float32, device="cuda", scale: float = 1.0):
    """Truncated-normal fan-in init: std ``scale / sqrt(in_dim)``, cut at 3σ."""
    if in_dim is None:
        in_dim = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(in_dim)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std, generator=gen)
    return t.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32, device="cuda"):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 0.02, generator=gen)
    return t.to(dtype)


def zeros_init(shape, dtype=torch.float32, device="cuda"):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype=torch.float32, device="cuda"):
    return torch.ones(shape, dtype=dtype, device=device)
