"""Serving on one card: lockstep, per-slot and pipelined decode, and prefill.

The one-card case of ``repro.runtime.serve`` (no ``shard_map``):

* ``build_serve_step`` returns a step that computes what
  ``spmd_decode_fn``'s body computes: lockstep decode, one position shared
  by the batch.
* ``build_slot_serve_step`` returns ``repro``'s per-slot step (``slot_fn``):
  each row decodes at its own position, rows flagged in ``reset`` have
  every state leaf zeroed first (slot admission), and the logits of padded
  rows are exactly 0.  ``repro``'s data shards are row blocks of the one
  batch here, shard-major as in ``repro``'s global layout; its SPMD step
  advances every shard in one step too, so each row is computed as there.
  The lockstep step takes a data axis too (``data``), as ``repro``'s
  batch-sharded step has one.
* **Virtual stages.**  With P > 1 stages, ``_pipelined_decode`` streams the
  batch through P stages run in turn on the card, in ``repro``'s tick
  order: at tick t stage p runs group t - p (bubble ticks skipped).  Group
  g is the g-th slice of every data shard's rows, the shard's rows cut into
  n_g groups as ``repro`` cuts its local batch.  The
  periods stay in model order, unpadded (``runtime.pipeline.stage_ranges``);
  a stage with no period passes its input through, as ``repro``'s zero
  periods do.  Tensor parallelism is a label (``MeshPlan.tp``): nothing is
  split on one card.
* **Token sets.**  Dense, Mamba and RWKV rows are independent; an MoE
  layer's capacity couples the rows it routes together.  ``repro`` routes
  one data shard's rows of one group together (its ``shard_map`` over
  ``data``, ``ep_axis="data"``), so each MoE layer here routes a group's
  rows as one token set a data shard (``models.moe.moe``'s ``sets``).
  With more than one shard and group, the state rows are kept group-major
  (``ServeSpec.row_order``), so that a group's rows are one block of every
  state leaf; the step's tokens, positions, resets and logits stay
  shard-major.
* ``build_prefill_step`` returns last-position logits as ``repro``'s
  prefill does.

With tp 1 nothing is padded, so ``repro``'s ``prepare_params`` is
``init_model`` here (on a config with ``mtp_depth`` 0, as the serve
launcher's: no serve step reads an MTP head).  Sequence-sharded decode (``seq_shard``: the cache sharded over the data
axis) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.planner import serve_stage_candidates
from repro_torch.distributed.mesh import SINGLE, MeshPlan, refine
from repro_torch.models.blocks import decode_period, init_period_states, tree_index
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, embed_tokens, head_logits,
                                      model_forward)
from repro_torch.optim import tree_leaves, tree_map

from .pipeline import stage_ranges
from .train import default_n_micro


def serve_head_count(cfg: ModelConfig) -> int:
    """Head count that caps tensor parallelism for decode."""
    return cfg.attn.n_heads if cfg.attn is not None else (
        cfg.d_model // cfg.rwkv.head_dim if cfg.rwkv is not None else 1)


def pick_serve_stage(cfg: ModelConfig, model_axis: int) -> int:
    """Serve prefers TP: the smallest stage count whose tp divides the query
    head count (``repro``'s choice over the divisors of ``model_axis``;
    ``core.planner.plan_serve`` makes the latency-priced one)."""
    return serve_stage_candidates(model_axis, serve_head_count(cfg))[0]


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    cfg: ModelConfig
    plan: MeshPlan
    cache_len: int
    batch_global: int
    n_groups: int = 1          # decode pipelining groups (stage > 1)
    # live decode slots per data shard; every shard is padded to
    # max(shard_alloc) rows.  Setting it switches to the per-slot step.
    shard_alloc: tuple[int, ...] | None = None

    @property
    def per_slot(self) -> bool:
        return self.shard_alloc is not None

    @property
    def slot_mask(self) -> torch.Tensor:
        """(dp_shards, B_max) bool validity of each padded slot row."""
        assert self.shard_alloc is not None
        b_max = self.batch_global // self.plan.dp_shards
        return torch.tensor([[i < y for i in range(b_max)] for y in self.shard_alloc])

    @property
    def groups(self) -> int:
        """The decode groups each data shard's rows are cut into: ``n_groups``
        where it splits the shard's rows evenly (``repro``'s rule, on the
        local batch), and 1 at one stage."""
        if self.plan.stage == 1:
            return 1
        return _group_count(self.batch_global // self.plan.dp_shards, self.n_groups)

    @property
    def row_order(self) -> tuple[int, ...] | None:
        """The batch row (shard-major) that each state row holds, or None
        where they are the same.  Group g is the g-th slice of every
        shard's rows; with more than one shard and group the state rows are
        kept group-major, so that a group's rows, and their cache rows, are
        one contiguous block."""
        data, n_g = self.plan.dp_shards, self.groups
        if data == 1 or n_g == 1:
            return None
        b_loc = self.batch_global // data
        bg = b_loc // n_g
        return tuple(d * b_loc + g * bg + i
                     for g in range(n_g) for d in range(data) for i in range(bg))

    def state_rows(self, rows) -> list[int]:
        """The state rows that hold batch rows ``rows``."""
        order = self.row_order
        if order is None:
            return list(rows)
        where = {r: j for j, r in enumerate(order)}
        return [where[r] for r in rows]


@dataclasses.dataclass
class ServeStep:
    spec: ServeSpec
    step_fn: Callable


def prepare_serve_states(cfg: ModelConfig, plan: MeshPlan, batch_global: int,
                         cache_len: int, device="cuda"):
    """Decode state tree, one ``{"mixer": ...}`` per pattern slot, leaves
    stacked on a leading n_periods axis (in model order, for any stage
    count: the port never pads the stack): an attention slot holds ``{"k",
    "v"}`` (n_periods, B, cache_len, Hkv, D) (MLA: the latent ``{"c_kv"}``
    (n_periods, B, cache_len, kv_lora_rank) and ``{"k_rope"}`` (n_periods,
    B, cache_len, qk_rope_dim)), a Mamba slot ``{"conv"}``
    (n_periods, B, d_conv - 1, d_inner) and ``{"ssm"}`` (n_periods, B,
    d_inner, d_state) float32, an RWKV slot ``{"shift"}`` (n_periods, B, 1,
    D) and ``{"wkv"}`` (n_periods, B, H, head_dim, head_dim) float32, and
    beside it ``"cm": {"shift"}`` (n_periods, B, 1, D) for the channel mix.
    Row j holds batch row ``ServeSpec.row_order[j]`` (row j itself unless
    the step has more than one data shard and decode group)."""
    return init_period_states(batch_global, cache_len, cfg, cfg.cdtype, device)


def _group_count(rows: int, n_groups: int) -> int:
    """``n_groups`` where it splits ``rows`` evenly, else 1 (``repro``'s rule)."""
    return n_groups if (rows % n_groups == 0 and rows >= n_groups) else 1


def zero_rows(states, rows) -> None:
    """Zero batch rows ``rows`` (host indices) of every state leaf in place
    (leaves are (n_periods, B, ...)): slot admission."""
    if rows:
        leaves = tree_leaves(states)
        idx = torch.tensor(list(rows), device=leaves[0].device)
        for leaf in leaves:
            leaf.index_fill_(1, idx, 0)


def _pipelined_decode(periods, x, position, states, cfg: ModelConfig,
                      ranges, n_g: int, sets: int = 1):
    """Stream the batch through the virtual stages in ``n_g`` groups of
    B / n_g consecutive rows.

    Stage p owns periods ``ranges[p]``.  A group's state rows are views of
    ``states`` (batch on axis 1), written in place by the decode code, so
    they reach the base tensors as ``repro``'s ``update_b`` writes them
    back; per-row positions travel with their group.  ``sets``: the number
    of equal MoE token sets of a group's rows."""
    bg = x.shape[0] // n_g
    acts = list(x.split(bg))
    for t in range(n_g + len(ranges) - 1):
        for p, (i, j) in enumerate(ranges):
            g = t - p
            if not 0 <= g < n_g:
                continue
            rows = slice(g * bg, (g + 1) * bg)
            pos = position[rows] if isinstance(position, torch.Tensor) else position
            st = tree_map(lambda s: s[:, rows], states)
            h = acts[g]
            for k in range(i, j):
                h, _ = decode_period(tree_index(periods, k), h, pos,
                                     tree_index(st, k), cfg, sets)
            acts[g] = h
    return torch.cat(acts)


def _decode_fn(spec: ServeSpec):
    """``fn(params, token (B,), position, states) -> (logits (B, V), states)``
    at ``spec.plan.stage`` virtual stages, every MoE layer routing each
    data shard's rows of a group as one token set (``repro``'s
    ``shard_map`` over ``data`` with ``ep_axis="data"``).  Rows are
    shard-major in ``token``, ``position`` and the logits, and stored in
    ``spec.row_order`` in ``states``."""
    cfg, sets, n_g = spec.cfg, spec.plan.dp_shards, spec.groups
    if spec.plan.stage == 1:
        def body(params, token, position, states):
            return decode_step(params, token, position, states, cfg, sets)
    else:
        ranges = stage_ranges(cfg.n_periods, spec.plan.stage)

        def body(params, token, position, states):
            x = embed_tokens(params, token, cfg)
            h = _pipelined_decode(params["periods"], x, position, states, cfg, ranges,
                                  n_g, sets)
            return head_logits(params, h, cfg), states
    order = spec.row_order
    if order is None:
        return body
    back = spec.state_rows(range(spec.batch_global))
    index: dict = {}

    def fn(params, token, position, states):
        if token.device not in index:
            index[token.device] = (torch.tensor(order, device=token.device),
                                   torch.tensor(back, device=token.device))
        to_state, to_batch = index[token.device]
        if isinstance(position, torch.Tensor):
            position = position[to_state]
        logits, states = body(params, token[to_state], position, states)
        return logits[to_batch], states
    return fn


def build_serve_step(cfg: ModelConfig, *, batch_global: int, cache_len: int,
                     stage: int = 1, n_groups: int | None = None, data: int = 1,
                     model_axis: int | None = None) -> ServeStep:
    """``step_fn(params, token (B,), position, states) -> (logits (B, V),
    states)``; ``position`` is a Python int shared by the batch (lockstep).
    Runs where ``params`` and ``states`` live; the caches, Mamba and RWKV
    states in ``states`` are updated in place.  ``stage`` > 1 streams each
    data shard's rows through that many virtual stages in ``n_groups``
    groups.  The batch is ``data`` shards of equal rows, shard-major, as
    ``repro``'s batch-sharded step: an MoE layer routes each shard's rows of
    a group on their own.  ``model_axis`` (default ``stage``) is split into
    ``stage`` x tp as ``repro``'s mesh is; tp is a label on one card."""
    if data < 1 or batch_global % data:
        raise ValueError(f"batch {batch_global} does not split into {data} data shards")
    stage, tp = refine(stage if model_axis is None else model_axis, stage)
    if n_groups is None:
        n_groups = _group_count(batch_global // data, stage)
    spec = ServeSpec(cfg=cfg, plan=MeshPlan(data=data, stage=stage, tp=tp),
                     cache_len=cache_len, batch_global=batch_global, n_groups=n_groups)
    body = _decode_fn(spec)

    @torch.inference_mode()
    def step_fn(params, token, position, states):
        return body(params, token, position, states)

    return ServeStep(spec=spec, step_fn=step_fn)


def build_slot_serve_step(cfg: ModelConfig, *, cache_len: int, shard_alloc,
                          stage: int | None = None, n_groups: int | None = None,
                          model_axis: int | None = None) -> ServeStep:
    """Continuous-batching decode step with heterogeneous slot splits.

    ``shard_alloc[d]`` live decode slots run on data shard ``d``.  Every
    shard is padded to ``B_max = max(shard_alloc)`` rows; the step is

        ``step_fn(params, token (B,), position (B,), reset (B,), states)``

    with ``B = len(shard_alloc) * B_max`` rows in shard-major order (rows
    ``[d*B_max, d*B_max + shard_alloc[d])`` are live).  ``position`` is
    per-row (int32 on the card).  ``reset`` is a host mask (numpy, a list or
    a CPU tensor): its rows have every state leaf zeroed in place before the
    step.  Padded rows return logits of exactly 0; they are decoded, and
    routed by the MoE layers, as ``repro`` decodes them.  ``model_axis``
    (default ``stage``, or 1) is split into ``stage`` x tp as ``repro``'s
    mesh is; tp is a label on one card.  Each MoE layer routes one data
    shard's rows of one decode group as a token set (``_decode_fn``).
    """
    if model_axis is None:
        model_axis = stage or 1
    if stage is None:
        stage = pick_serve_stage(cfg, model_axis)
    stage, tp = refine(model_axis, stage)
    shard_alloc = tuple(int(y) for y in shard_alloc)
    if not shard_alloc or min(shard_alloc) < 0 or max(shard_alloc) < 1:
        raise ValueError(f"shard_alloc {shard_alloc} holds no live slot")
    b_max = max(shard_alloc)
    batch_global = b_max * len(shard_alloc)
    if n_groups is None:
        n_groups = _group_count(b_max, stage)
    spec = ServeSpec(cfg=cfg, plan=MeshPlan(data=len(shard_alloc), stage=stage, tp=tp),
                     cache_len=cache_len, batch_global=batch_global,
                     n_groups=n_groups, shard_alloc=shard_alloc)
    body = _decode_fn(spec)
    pad = [r for r in range(batch_global) if r % b_max >= shard_alloc[r // b_max]]
    pad_idx: dict = {}
    state_row = spec.state_rows(range(batch_global))

    @torch.inference_mode()
    def step_fn(params, token, position, reset, states):
        zero_rows(states, [state_row[r] for r in np.flatnonzero(np.asarray(reset))])
        logits, states = body(params, token, position, states)
        if pad:
            if logits.device not in pad_idx:
                pad_idx[logits.device] = torch.tensor(pad, device=logits.device)
            logits.index_fill_(0, pad_idx[logits.device], 0.0)
        return logits, states

    return ServeStep(spec=spec, step_fn=step_fn)


def build_prefill_step(cfg: ModelConfig, *, batch_global: int,
                       seq_len: int) -> ServeStep:
    """``step_fn(params, {"tokens": (B, S)}) -> last-position logits (B, V)``.

    ``repro`` streams its micro-batches (``runtime.train.default_n_micro``
    of them on one device) through its stage pipeline; on one stage that
    splits only the batch of the same products, so the whole batch runs at
    once here, and each micro-batch's tokens are an MoE token set of their
    own, as there.
    """
    spec = ServeSpec(cfg=cfg, plan=SINGLE, cache_len=seq_len,
                     batch_global=batch_global)
    M = default_n_micro(cfg, SINGLE, batch_global)

    @torch.inference_mode()
    def step_fn(params, batch):
        h, _, _ = model_forward(params, batch["tokens"], cfg, sets=M)
        return head_logits(params, h[:, -1], cfg)

    return ServeStep(spec=spec, step_fn=step_fn)
