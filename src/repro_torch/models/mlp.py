"""Dense MLP blocks: SwiGLU / GeGLU through the fused kernel, GELU / ReLU plain.

The gated ``silu`` and ``gelu_tanh`` cases are what ``repro``'s Pallas
``fused_swiglu`` computes, and go through :mod:`repro_torch.kernels.ops`.
The other activations have no kernel in ``repro`` and stay plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .module import dense_init

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default

    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
FUSED_ACTS = ("silu", "gelu_tanh")


def init_mlp(gen, d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.float32, device="cuda", lead: tuple = ()):
    # same draw order as repro's split_keys: gate, up, down
    gate = dense_init(gen, (*lead, d_model, d_ff), d_model, dtype, device) if gated else None
    params = {
        "up": dense_init(gen, (*lead, d_model, d_ff), d_model, dtype, device),
        "down": dense_init(gen, (*lead, d_ff, d_model), d_ff, dtype, device),
    }
    if gated:
        params["gate"] = gate
    return params


def mlp(params, x, act: str = "silu"):
    """x: (..., d_model) -> (..., d_model)."""
    if "gate" in params and act in FUSED_ACTS:
        return ops.fused_swiglu_op(x, params["gate"], params["up"], params["down"], act)
    a = ACTIVATIONS[act]
    up = x @ params["up"]
    h = a(x @ params["gate"]) * up if "gate" in params else a(up)
    return h @ params["down"]
