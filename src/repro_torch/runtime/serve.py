"""Serving on one card: lockstep decode step and prefill step.

The one-card case of ``repro.runtime.serve`` (stage 1, tp 1, no
``shard_map``): ``build_serve_step`` returns a step that computes what
``spmd_decode_fn``'s body computes at stage 1, and ``build_prefill_step``
one that returns last-position logits as ``repro``'s prefill does.  With one
stage and tp 1 nothing is padded, so ``repro``'s ``prepare_params`` is
``init_model`` here.  Pipelined decode, per-slot decode and continuous
batching are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed.mesh import SINGLE, MeshPlan
from repro_torch.models.blocks import init_period_states
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, head_logits, model_forward


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    cfg: ModelConfig
    plan: MeshPlan
    cache_len: int
    batch_global: int


@dataclasses.dataclass
class ServeStep:
    spec: ServeSpec
    step_fn: Callable


def prepare_serve_states(cfg: ModelConfig, plan: MeshPlan, batch_global: int,
                         cache_len: int, device="cuda"):
    """Decode state tree, one ``{"mixer": ...}`` per pattern slot, leaves
    stacked on a leading n_periods axis: an attention slot holds ``{"k",
    "v"}`` (n_periods, B, cache_len, Hkv, D), a Mamba slot ``{"conv"}``
    (n_periods, B, d_conv - 1, d_inner) and ``{"ssm"}`` (n_periods, B,
    d_inner, d_state) float32, an RWKV slot ``{"shift"}`` (n_periods, B, 1,
    D) and ``{"wkv"}`` (n_periods, B, H, head_dim, head_dim) float32, and
    beside it ``"cm": {"shift"}`` (n_periods, B, 1, D) for the channel mix."""
    if plan.stage != 1:
        raise NotImplementedError("pipelined decode is not ported yet")
    return init_period_states(batch_global, cache_len, cfg, cfg.cdtype, device)


def build_serve_step(cfg: ModelConfig, *, batch_global: int,
                     cache_len: int) -> ServeStep:
    """``step_fn(params, token (B,), position, states) -> (logits (B, V),
    states)``; ``position`` is a Python int shared by the batch (lockstep).
    Runs where ``params`` and ``states`` live; the caches, Mamba and RWKV
    states in ``states`` are updated in place."""
    spec = ServeSpec(cfg=cfg, plan=SINGLE, cache_len=cache_len,
                     batch_global=batch_global)

    @torch.inference_mode()
    def step_fn(params, token, position, states):
        return decode_step(params, token, position, states, cfg)

    return ServeStep(spec=spec, step_fn=step_fn)


def build_prefill_step(cfg: ModelConfig, *, batch_global: int,
                       seq_len: int) -> ServeStep:
    """``step_fn(params, {"tokens": (B, S)}) -> last-position logits (B, V)``.

    ``repro`` streams micro-batches through its stage pipeline; on one stage
    that splits only the batch of the same products, so the whole batch runs
    at once here.
    """
    spec = ServeSpec(cfg=cfg, plan=SINGLE, cache_len=seq_len,
                     batch_global=batch_global)

    @torch.inference_mode()
    def step_fn(params, batch):
        h, _ = model_forward(params, batch["tokens"], cfg)
        return head_logits(params, h[:, -1], cfg)

    return ServeStep(spec=spec, step_fn=step_fn)
