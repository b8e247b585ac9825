"""RWKV-6 "Finch" block: time mix (WKV-6 with data-dependent decay) and
channel mix.

The port of ``repro.models.rwkv`` on one card (no tensor parallelism), with
``repro``'s parameter names and layouts:

* token shift with a data-dependent lerp (ddlerp) whose low-rank part gives
  the five mix coefficients of r, k, v, w and g;
* per-channel data-dependent decay ``w_t = exp(-exp(w0 + lora_w(x_t)))``;
* per-head WKV state ``S`` (d × d): ``out_t = r_t (S + diag(u) k_tᵀ v_t)``,
  ``S <- diag(w_t) S + k_tᵀ v_t``;
* per-head RMS norm ``ln_x`` (``rmsnorm``'s own eps 1e-6, not zero-centred,
  whatever the model config says), the silu gate g and the output product;
* channel mix: token shift and a squared-relu MLP gated by sigmoid(r).

The sequence form reaches the WKV through
:func:`repro_torch.kernels.ops.rwkv6_wkv_op`: the hand-written kernel on the
card, the step-by-step plain version on the CPU.  As in ``repro`` it clamps
the decay logit to [-20, 0] and the one-token decode step does not, so the
two forms differ wherever a logit exceeds 0.  ``repro``'s only callers of
the sequence forms pass no state and drop the state they return, so here
they start from zero state and return only their output; decoding carries
``{"shift", "wkv"}`` and ``{"shift"}`` states, updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import RWKVConfig
from .module import dense_init
from .norms import init_rmsnorm, rmsnorm


def _uniform(gen, shape, lo, hi, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(lo, hi, generator=gen)


def init_rwkv_time_mix(gen: torch.Generator, d_model: int, cfg: RWKVConfig,
                       dtype=torch.float32, device="cuda", lead: tuple = ()):
    """Params of one time mix (with ``lead`` stacking axes), as
    ``repro.models.rwkv.init_rwkv_time_mix``: the LoRA up-projections
    ``mix_lora_b`` and ``w_lora_b`` start at zero and ``w0`` in [-8, -4]."""
    if d_model % cfg.head_dim:
        raise ValueError(f"d_model {d_model} is not a multiple of head_dim {cfg.head_dim}")
    d = d_model

    def dense(shape, in_dim):
        return dense_init(gen, (*lead, *shape), in_dim, dtype, device)

    return {
        "mix_base": _uniform(gen, (*lead, 5, d), 0.0, 0.5, device),
        "mix_lora_a": dense((d, cfg.mix_lora * 5), d),
        "mix_lora_b": torch.zeros((*lead, 5, cfg.mix_lora, d), dtype=dtype, device=device),
        "wr": dense((d, d), d),
        "wk": dense((d, d), d),
        "wv": dense((d, d), d),
        "wg": dense((d, d), d),
        "w0": _uniform(gen, (*lead, d), -8.0, -4.0, device),
        "w_lora_a": dense((d, cfg.decay_lora), d),
        "w_lora_b": torch.zeros((*lead, cfg.decay_lora, d), dtype=dtype, device=device),
        "u": _uniform(gen, (*lead, d), 0.0, 0.5, device),
        "ln_x": init_rmsnorm(cfg.head_dim, dtype, False, device, lead),
        "out": dense((d, d), d),
    }


def _token_shift(x, prev):
    """x: (B, S, D); prev: (B, 1, D) the token before x[:, 0]."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(params, x, xs):
    """Data-dependent lerp between x and the shifted xs -> (..., 5, D): the
    r, k, v, w and g streams."""
    delta = xs - x
    lora = torch.tanh((x + delta * 0.5) @ params["mix_lora_a"])
    lora = lora.reshape(*x.shape[:-1], 5, -1)
    adj = torch.einsum("...fl,fld->...fd", lora, params["mix_lora_b"])
    mix = torch.clamp(params["mix_base"] + adj, 0.0, 1.0)
    return x[..., None, :] + delta[..., None, :] * mix


def _project(params, x, xs):
    """r, k, v, the gate g and the float32 decay logit, each (..., D)."""
    xr, xk, xv, xw, xg = _ddlerp(params, x, xs).unbind(-2)
    logit = params["w0"] + torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    return (xr @ params["wr"], xk @ params["wk"], xv @ params["wv"],
            F.silu(xg @ params["wg"]), logit.float())


def rwkv_time_mix(params, x, cfg: RWKVConfig):
    """Sequence form from zero state.  x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    d = cfg.head_dim
    H = D // d
    chunk = min(cfg.chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the WKV chunk "
                         f"{chunk} (repro's constraint)")
    r, k, v, g, logit = _project(params, x, _token_shift(x, x.new_zeros((B, 1, D))))
    # repro clamps here so that its chunked matmul form stays in fp32 range;
    # the decode step does not clamp
    w = torch.exp(-torch.exp(torch.clamp(logit, -20.0, 0.0)))

    def heads(t):  # (B, S, H*d) -> (B, H, S, d), a view
        return t.float().view(B, S, H, d).transpose(1, 2)

    o = ops.rwkv6_wkv_op(heads(r), heads(k), heads(v), heads(w),
                         params["u"].float().view(H, d))
    o = rmsnorm(params["ln_x"], o)
    o = o.transpose(1, 2).reshape(B, S, D).to(x.dtype)
    return (o * g) @ params["out"]


def rwkv_time_mix_decode(params, x, cfg: RWKVConfig, state: dict):
    """One-token step.  x: (B, D).  Returns (out (B, D), state); ``state``
    {"shift": (B, 1, D), "wkv": (B, H, d, d) float32} is updated in place.
    Plain torch: ``repro`` has no kernel here."""
    B, D = x.shape
    d = cfg.head_dim
    H = D // d
    r, k, v, g, logit = _project(params, x, state["shift"][:, 0])
    w = torch.exp(-torch.exp(logit))
    rh, kh, vh, wh = (t.float().view(B, H, d) for t in (r, k, v, w))
    s = state["wkv"]
    kv = kh[..., :, None] * vh[..., None, :]
    u = params["u"].float().view(H, d)
    out = torch.einsum("bhi,bhij->bhj", rh, s + u[None, :, :, None] * kv)
    s.mul_(wh[..., None]).add_(kv)
    state["shift"].copy_(x[:, None])
    o = rmsnorm(params["ln_x"], out).reshape(B, D).to(x.dtype)
    return (o * g) @ params["out"], state


def init_rwkv_channel_mix(gen: torch.Generator, d_model: int, d_ff: int,
                          dtype=torch.float32, device="cuda", lead: tuple = ()):
    return {
        "mix_k": _uniform(gen, (*lead, d_model), 0.0, 0.5, device),
        "mix_r": _uniform(gen, (*lead, d_model), 0.0, 0.5, device),
        "wk": dense_init(gen, (*lead, d_model, d_ff), d_model, dtype, device),
        "wr": dense_init(gen, (*lead, d_model, d_model), d_model, dtype, device),
        "wv": dense_init(gen, (*lead, d_ff, d_model), d_ff, dtype, device),
    }


def _channel_mix(params, x, xs):
    xk = x + (xs - x) * params["mix_k"]
    xr = x + (xs - x) * params["mix_r"]
    kv = torch.square(F.relu(xk @ params["wk"])) @ params["wv"]
    return torch.sigmoid(xr @ params["wr"]) * kv


def rwkv_channel_mix(params, x):
    """Sequence form from zero shift.  x: (B, S, D) -> (B, S, D)."""
    return _channel_mix(params, x, _token_shift(x, x.new_zeros((x.shape[0], 1, x.shape[2]))))


def rwkv_channel_mix_decode(params, x, state: dict):
    """One-token step.  x: (B, D).  Returns (out (B, D), state); ``state``
    {"shift": (B, 1, D)} is updated in place."""
    out = _channel_mix(params, x, state["shift"][:, 0])
    state["shift"].copy_(x[:, None])
    return out, state


def init_rwkv_state(batch: int, d_model: int, cfg: RWKVConfig, dtype=torch.float32,
                    device="cuda", lead: tuple = ()) -> dict:
    """Zero decode state ``{"tm": {"shift": (*lead, B, 1, D) dtype, "wkv":
    (*lead, B, H, d, d) float32}, "cm": {"shift": (*lead, B, 1, D) dtype}}``."""
    h = d_model // cfg.head_dim
    return {
        "tm": {"shift": torch.zeros((*lead, batch, 1, d_model), dtype=dtype, device=device),
               "wkv": torch.zeros((*lead, batch, h, cfg.head_dim, cfg.head_dim),
                                  dtype=torch.float32, device=device)},
        "cm": {"shift": torch.zeros((*lead, batch, 1, d_model), dtype=dtype, device=device)},
    }
