"""Mixture-of-Experts layer on one card (``repro.models.moe`` without expert
parallelism).

* The router runs in float32 whatever the dtype: softmax or sigmoid scores,
  top-k, the k weights renormalised to sum to 1.  The switch-style
  load-balance loss is taken from each token's first choice before any
  capacity drop, as ``repro`` takes it.
* Dispatch is sort-free, into an ``(E, C, D)`` capacity buffer with
  ``C = int(capacity_factor * T * k / E) + 1``: a pair's slot is the count
  of earlier pairs (token-major) routed to its expert (a cumsum of one-hot
  rows).  A pair past the capacity is dropped: its weight is 0 and it adds
  a zero row at slot C - 1, so every kept slot is written exactly once and
  the accumulating write is exact.
* Each expert runs on its whole capacity buffer, empty or not, as
  ``repro``'s ``vmap`` runs it, through :func:`repro_torch.models.mlp.mlp`:
  the ``fused_swiglu`` kernel for silu / gelu_tanh, so E launches a layer
  and forward.  The expert views come from one ``unbind`` of each stacked
  weight, so the backward builds one stacked gradient per weight (indexing
  ``w[e]`` per expert would build a zero-filled stack-sized gradient per
  expert).
* The combine gathers each pair's output row and adds the k weighted rows
  of a token in k order (no atomics).  Shared experts are a dense MLP
  added on top.

The capacity couples rows: C depends on the call's token count T, so a
prefill and a lockstep decode of the same tokens agree only where nothing
drops.

**Token sets.**  ``repro`` routes the tokens of one data shard's one
pipeline group on their own: each shard dispatches its rows into its own
``(E, C_s, D)`` buffer, and the ``all_to_all`` over ``ctx.ep_axis`` hands
each expert the rows of every shard.  ``moe(..., sets=n)`` does the same
on one card for n equal consecutive row blocks of the call (``repro``'s
sets in one call are equal: shards are padded to one size, groups and
micro-batches split evenly): each block is routed, given its own capacity
and dispatched into its own buffer; the buffers are concatenated along the
slot axis, so each expert is still one ``fused_swiglu`` launch, on its
``n * C_s`` rows, whatever n is.  The aux loss is the sum of the sets'
own, as ``repro`` sums its shards' before dividing by ``dp_shards * M``.
Expert parallelism across cards and tensor parallelism are not ported.

``torch.topk`` and ``lax.top_k`` both sort in descending order; their order
on exactly tied scores may differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MoEConfig
from .mlp import init_mlp, mlp
from .module import dense_init

__all__ = ["MoEConfig", "Routing", "capacity", "dispatch_slots", "init_moe", "moe", "route"]


def init_moe(gen, d_model: int, cfg: MoEConfig, dtype=torch.float32, device="cuda",
             lead: tuple = ()):
    """The router (float32, over the global expert count), the stacked
    experts ``gate``/``up`` (E, D, F) and ``down`` (E, F, D), and the shared
    MLP when ``cfg.n_shared_experts`` > 0; ``lead`` prepends stacking axes."""
    e_global = cfg.n_experts_global or cfg.n_experts
    E, F_ = cfg.n_experts, cfg.d_ff
    params = {
        "router": dense_init(gen, (*lead, d_model, e_global), d_model, torch.float32, device),
        "experts": {
            "gate": dense_init(gen, (*lead, E, d_model, F_), d_model, dtype, device),
            "up": dense_init(gen, (*lead, E, d_model, F_), d_model, dtype, device),
            "down": dense_init(gen, (*lead, E, F_, d_model), F_, dtype, device),
        },
    }
    if cfg.n_shared_experts:
        params["shared"] = init_mlp(gen, d_model, F_ * cfg.n_shared_experts, True,
                                    dtype, device, lead)
    return params


class Routing(NamedTuple):
    top_w: torch.Tensor       # (T, k) float32, renormalised
    top_e: torch.Tensor       # (T, k) int64, descending score
    aux: torch.Tensor         # () float32 load-balance loss
    scores: torch.Tensor      # (T, E) float32


def _one_hot(idx, n: int):
    """(..., n) bool; unlike ``F.one_hot``, never reads the indices on the
    host, so a decode step does not wait for the card."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def route(params, x2d, cfg: MoEConfig, e_global: int, sets: int = 1) -> Routing:
    """x2d: (T, D) -> the routing decision and the aux loss, summed over
    ``sets`` equal consecutive token sets.  A token's experts and weights
    are its own; only the aux loss depends on the sets."""
    logits = x2d.float() @ params["router"].float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    scores = torch.sigmoid(logits) if cfg.score_fn == "sigmoid" else probs
    top_w, top_e = torch.topk(scores, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # switch-style load balance per set: E * sum_e(frac_tokens_e * mean_prob_e)
    frac_tokens = _one_hot(top_e[:, 0], e_global).float().view(sets, -1, e_global).mean(dim=1)
    mean_prob = probs.view(sets, -1, e_global).mean(dim=1)
    aux = e_global * torch.sum(frac_tokens * mean_prob) * cfg.aux_loss_weight
    return Routing(top_w, top_e, aux, scores)


def capacity(cfg: MoEConfig, n_tokens: int, e_global: int) -> int:
    """Rows of each expert's buffer for a call on ``n_tokens`` tokens."""
    return int(cfg.capacity_factor * n_tokens * cfg.top_k / e_global) + 1


def dispatch_slots(top_e, cap: int, e_global: int, sets: int = 1):
    """top_e (T, k) -> (keep, slot), each (T*k,): whether the pair fits its
    expert's buffer, and its row there (C - 1 for a dropped pair).  With
    ``sets`` equal consecutive token sets, a pair counts only the earlier
    pairs of its own set, each set has capacity ``cap``, and ``slot`` is
    the row in the concatenated buffer (set s's rows from ``s * cap``)."""
    flat_e = top_e.reshape(sets, -1)                                # (sets, pairs)
    onehot = _one_hot(flat_e, e_global).long()                     # (sets, pairs, E)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat_e[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, pos, cap - 1)
    if sets > 1:
        slot = slot + torch.arange(0, sets * cap, cap, device=slot.device)[:, None]
    return keep.reshape(-1), slot.reshape(-1)


def moe(params, x, cfg: MoEConfig, sets: int = 1):
    """x: (..., D) -> (out (..., D), aux_loss () float32).  ``sets``: the
    number of equal consecutive token sets of the call's T =
    prod(shape[:-1]) tokens, each routed on its own (module docstring)."""
    e_global = cfg.n_experts_global or cfg.n_experts
    if cfg.n_experts != e_global:
        raise NotImplementedError(f"{cfg.n_experts} local of {e_global} experts: expert "
                                  "parallelism (repro's all_to_all over ctx.ep_axis) "
                                  "is not ported")
    shape, D, k = x.shape, x.shape[-1], cfg.top_k
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    if sets < 1 or T % sets:
        raise ValueError(f"{T} tokens do not split into {sets} equal token sets")
    r = route(params, x2d, cfg, e_global, sets)

    # --- dispatch: scatter each set's (token, expert) pairs into its
    # (E, C, D) block of the (E, sets * C, D) buffer
    cap = capacity(cfg, T // sets, e_global)
    keep, slot = dispatch_slots(r.top_e, cap, e_global, sets)
    flat_e = r.top_e.reshape(-1)
    flat_w = torch.where(keep, r.top_w.reshape(-1), 0.0)
    rows = x2d.unsqueeze(1).expand(T, k, D).reshape(T * k, D)       # token-major pairs
    rows = torch.where(keep[:, None], rows, 0.0)
    buf = x2d.new_zeros((e_global, sets * cap, D))
    buf.index_put_((flat_e, slot), rows, accumulate=True)

    # --- the experts, each on its whole buffer
    ex = params["experts"]
    out_rows = torch.stack([
        mlp({"gate": g, "up": u, "down": d}, b, act=cfg.act)
        for g, u, d, b in zip(ex["gate"].unbind(0), ex["up"].unbind(0),
                              ex["down"].unbind(0), buf.unbind(0))])

    # --- combine: each token's k weighted rows, added in k order
    gathered = out_rows[flat_e, slot].reshape(T, k, D).float()
    w = flat_w.reshape(T, k, 1)
    out = gathered[:, 0] * w[:, 0]
    for j in range(1, k):
        out = out + gathered[:, j] * w[:, j]
    out = out.to(x.dtype)

    if "shared" in params:
        out = out + mlp(params["shared"], x2d, act=cfg.act)
    return out.reshape(shape), r.aux
