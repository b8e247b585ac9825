"""Mamba (S6 selective SSM) block, as the Jamba hybrid uses it.

The port of ``repro.models.ssm`` on one card (no tensor parallelism): the
Mamba-1 block in-proj -> (x, z); causal depthwise conv; selective scan
h_t = exp(Δ_t ⊙ A) h_{t-1} + Δ_t B_t x_t, y_t = C_t h_t + D x_t; gated by
silu(z); out-proj.  Same parameter names and layouts as ``repro``.

The scan goes through :func:`repro_torch.kernels.ops.mamba_scan_op`: the
hand-written kernel on the card, the step-by-step plain version on the CPU.
``repro``'s only caller of ``mamba_forward`` passes no state and drops the
state it returns, so here prefill starts from zero state and returns only
its output; decoding carries ``{"conv", "ssm"}`` states, updated in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import MambaConfig
from .module import dense_init


def init_mamba(gen: torch.Generator, d_model: int, cfg: MambaConfig,
               dtype=torch.float32, device="cuda", lead: tuple = ()):
    """Params of one Mamba block (with ``lead`` stacking axes).  A is the
    S4D-real init (A_log = log n), dt_bias the inverse softplus of a
    log-uniform draw in [1e-3, 1e-1], as ``repro.models.ssm.init_mamba``."""
    d_in, n, k = cfg.d_inner(d_model), cfg.d_state, cfg.d_conv
    dt_rank = cfg.get_dt_rank(d_model)
    u = torch.empty((*lead, d_in), dtype=torch.float32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device).expand(*lead, d_in, n)
    return {
        "in_x": dense_init(gen, (*lead, d_model, d_in), d_model, dtype, device),
        "in_z": dense_init(gen, (*lead, d_model, d_in), d_model, dtype, device),
        "conv_w": dense_init(gen, (*lead, k, d_in), k, dtype, device),
        "conv_b": torch.zeros((*lead, d_in), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (*lead, d_in, dt_rank + 2 * n), d_in, dtype, device),
        "dt_proj": dense_init(gen, (*lead, dt_rank, d_in), dt_rank, dtype, device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "A_log": torch.log(a),
        "D": torch.ones((*lead, d_in), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (*lead, d_in, d_model), d_in, dtype, device),
    }


def _ssm_params(params, xc, cfg: MambaConfig, d_model: int):
    """xc: (B, S, d_inner) post-conv -> (dt, b, c) per-step SSM params, float32."""
    dt_rank = cfg.get_dt_rank(d_model)
    proj = xc @ params["x_proj"]
    dt = proj[..., :dt_rank] @ params["dt_proj"] + params["dt_bias"]
    dt = F.softplus(dt.float())                                    # (B, S, d_inner)
    b_t = proj[..., dt_rank: dt_rank + cfg.d_state].float()
    c_t = proj[..., dt_rank + cfg.d_state:].float()                # (B, S, N)
    return dt, b_t, c_t


def mamba_scan(params, xc, cfg: MambaConfig, d_model: int):
    """Selective scan over xc (B, S, d_inner) from zero state, plus the D·x
    skip (outside the kernel, as in ``repro``)."""
    S = xc.shape[1]
    chunk = min(cfg.chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the scan "
                         f"chunk {chunk} (repro's constraint)")
    dt, b_t, c_t = _ssm_params(params, xc, cfg, d_model)
    a = -torch.exp(params["A_log"])                                # (d_inner, N)
    xf = xc.float()
    y = ops.mamba_scan_op(dt, b_t, c_t, xf, a)
    return (y + xf * params["D"]).to(xc.dtype)


def mamba_forward(params, x, cfg: MambaConfig):
    """Full-sequence Mamba block from zero state.  x: (B, S, d_model) ->
    (B, S, d_model)."""
    B, S, _ = x.shape
    xs = x @ params["in_x"]
    z = x @ params["in_z"]
    # causal depthwise conv along S: K shifted multiply-adds
    K = params["conv_w"].shape[0]
    xp = torch.cat([xs.new_zeros((B, K - 1, xs.shape[-1])), xs], dim=1)
    xc = sum(xp[:, i: i + S] * params["conv_w"][i] for i in range(K)) + params["conv_b"]
    xc = F.silu(xc)
    y = mamba_scan(params, xc, cfg, x.shape[-1])
    return (y * F.silu(z)) @ params["out_proj"]


def mamba_decode(params, x, cfg: MambaConfig, state: dict):
    """Single-token Mamba step.  x: (B, d_model).  Returns (out (B, d_model),
    state); ``state`` {"conv": (B, d_conv-1, d_inner), "ssm": (B, d_inner, N)
    f32} is updated in place.  Plain torch: ``repro`` has no kernel here."""
    xs = x @ params["in_x"]
    z = x @ params["in_z"]
    conv_buf = torch.cat([state["conv"], xs[:, None]], dim=1)
    xc = torch.einsum("bkd,kd->bd", conv_buf, params["conv_w"]) + params["conv_b"]
    xc = F.silu(xc)

    dt, b_t, c_t = _ssm_params(params, xc[:, None], cfg, x.shape[-1])
    dt, b_t, c_t = dt[:, 0], b_t[:, 0], c_t[:, 0]
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt[..., None] * a)                           # (B, d_inner, N)
    xf = xc.float()
    h = state["ssm"] * decay + (dt * xf)[..., None] * b_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t) + xf * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    state["conv"].copy_(conv_buf[:, 1:])
    state["ssm"].copy_(h)
    return y @ params["out_proj"], state


def init_mamba_state(batch: int, d_model: int, cfg: MambaConfig, dtype=torch.float32,
                     device="cuda", lead: tuple = ()) -> dict:
    """Zero decode state ``{"conv": (*lead, B, d_conv-1, d_inner) dtype,
    "ssm": (*lead, B, d_inner, N) float32}``."""
    d_in = cfg.d_inner(d_model)
    return {"conv": torch.zeros((*lead, batch, cfg.d_conv - 1, d_in), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((*lead, batch, d_in, cfg.d_state), dtype=torch.float32,
                               device=device)}
