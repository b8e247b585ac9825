"""CausalLM assembly: embedding -> stacked periods -> norm -> head (+MTP), and
the next-token loss.

The text-LM subset of ``repro.models.model`` (single codebook, no frontend
prefix), with ``repro``'s parameter names and layout; the MoE layers' aux
loss is added to the loss as there, and so is DeepSeek-V3's multi-token
prediction term (``mtp_depth`` 1: one extra period predicting token t+2
from [emb(t+1); h_t], sharing the embedding and the head, weighted by
``MTP_WEIGHT``).  The
loss is computed in sequence chunks, so the (B, S, V) logits exist one
chunk at a time.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .blocks import (apply_period, apply_periods, decode_periods, init_period,
                     init_period_states, init_periods)
from .config import ModelConfig
from .module import dense_init, embed_init
from .norms import init_rmsnorm, rmsnorm

MTP_WEIGHT = 0.3


def init_model(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random weights from ``gen`` (which must live on ``device``: the card
    unless the caller passes ``"cpu"``).  With ``cfg.mtp_depth`` > 0 the
    tree holds ``repro``'s ``"mtp"`` head (``combine``, ``norm_h``,
    ``norm_e``, one period ``block``, ``final_norm``), drawn last, so the
    other leaves are drawn the same with ``mtp_depth`` 0 (the serve
    launcher's: at deepseek-v3's widths the head is another 46 GB)."""
    d, v, dtype = cfg.d_model, cfg.vocab_size, cfg.pdtype
    zc = cfg.zero_centered_norm
    params = {
        "embed": embed_init(gen, (v, d), dtype, device),
        "periods": init_periods(gen, cfg, device),
        "final_norm": init_rmsnorm(d, dtype, zc, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (d, v), d, dtype, device)
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "combine": dense_init(gen, (2 * d, d), 2 * d, dtype, device),
            "norm_h": init_rmsnorm(d, dtype, zc, device),
            "norm_e": init_rmsnorm(d, dtype, zc, device),
            "block": init_period(gen, cfg, device),
            "final_norm": init_rmsnorm(d, dtype, zc, device),
        }
    return params


def embed_tokens(params, tokens, cfg: ModelConfig):
    """tokens: (B, S) or (B,) int -> (B, S, D) or (B, D) in the compute dtype."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x.to(cfg.cdtype)


def _head_weight(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def head_logits(params, h, cfg: ModelConfig):
    """final norm -> LM head -> optional softcap, as float32 logits."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps, cfg.zero_centered_norm)
    logits = (h @ _head_weight(params, cfg)).float()
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def model_forward(params, tokens, cfg: ModelConfig, remat: bool = True, sets: int = 1):
    """Backbone forward.  tokens (B, S).  Returns (h (B, S, D), aux_loss,
    positions): ``aux_loss`` is the MoE layers' summed load-balance loss (a
    Python ``0.0`` without MoE layers).  ``remat`` checkpoints each period
    while autograd records.  ``sets``: the number of equal MoE token sets
    of the B * S tokens, batch-major (``models.moe.moe``)."""
    x = embed_tokens(params, tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    h, aux = apply_periods(params["periods"], x, positions, cfg, remat, sets)
    return h, aux, positions


def aux_tensor(aux, device) -> torch.Tensor:
    """A summed aux loss as a float32 scalar tensor on ``device``."""
    if isinstance(aux, torch.Tensor):
        return aux
    return torch.full((), float(aux), dtype=torch.float32, device=device)


def _ce_chunk(hi, head_w, ti, mi, softcap):
    """One chunk's (masked loss sum, masked correct count)."""
    logits = (hi @ head_w).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ti[..., None])[..., 0]
    loss = (lse - gold) * mi
    acc = (logits.argmax(-1) == ti) * mi
    return loss.sum(), acc.sum()


def chunked_ce_loss(h, head_w, targets, mask, softcap=None, chunk: int = 2048):
    """Cross entropy without materialising the full logits.

    h: (B, S, D); head_w: (D, V); targets/mask: (B, S).  Returns (sum_loss,
    sum_count, sum_correct) as float32 scalars.  S is zero-padded to whole
    chunks, as ``repro`` pads it.  While autograd records, each chunk is one
    checkpoint: its backward recomputes the chunk's logits, so no chunk's
    logits outlive it (at a vocabulary of 256000 and 16384 tokens, the
    softcap's and the logsumexp's saved copies would take 33.6 GB).
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    remat = torch.is_grad_enabled() and (h.requires_grad or head_w.requires_grad)
    s_loss = s_cnt = s_acc = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (h[:, sl], head_w, targets[:, sl].long(), mask[:, sl], softcap)
        loss, acc = (checkpoint(_ce_chunk, *args, use_reentrant=False) if remat
                     else _ce_chunk(*args))
        s_loss, s_cnt, s_acc = s_loss + loss, s_cnt + mask[:, sl].sum(), s_acc + acc
    return s_loss, s_cnt, s_acc


def loss_fn(params, batch, cfg: ModelConfig, remat: bool = True, ce_chunk: int = 2048):
    """Next-token LM loss.  batch: {"tokens" (B, S), optional "mask" (B, S)}.

    Returns (loss, metrics): the mean cross entropy plus the MoE aux loss,
    plus ``MTP_WEIGHT`` times the MTP term (``metrics["mtp"]``) where
    ``cfg.mtp_depth`` > 0, as ``repro.models.model.loss_fn`` returns it;
    multi-codebook tokens and frontend prefixes are refused.
    """
    if "prefix" in batch:
        raise NotImplementedError("frontend prefix embeddings are not ported yet")
    tokens = batch["tokens"]
    if tokens.ndim != 2:
        raise NotImplementedError(f"tokens {tuple(tokens.shape)}: multi-codebook "
                                  "batches are not ported yet")
    h, aux, _ = model_forward(params, tokens, cfg, remat)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps, cfg.zero_centered_norm)
    mask = batch.get("mask", torch.ones_like(tokens))[:, 1:].float()
    total, count, correct = chunked_ce_loss(h[:, :-1], _head_weight(params, cfg),
                                            tokens[:, 1:], mask, cfg.logit_softcap,
                                            ce_chunk)
    loss = total / torch.clamp(count, min=1.0)
    aux = aux_tensor(aux, h.device)
    metrics = {"ce": loss, "aux": aux, "acc": correct / torch.clamp(count, min=1.0),
               "tokens": count}
    loss = loss + aux
    if cfg.mtp_depth > 0:
        l2, c2 = mtp_loss_sums(params, h, tokens, cfg, batch.get("mask"), ce_chunk)
        metrics["mtp"] = l2 / torch.clamp(c2, min=1.0)
        loss = loss + MTP_WEIGHT * metrics["mtp"]
    return loss, metrics


def mtp_loss_sums(params, h, tokens, cfg: ModelConfig, mask=None, ce_chunk: int = 2048,
                  sets: int = 1):
    """DeepSeek-V3's multi-token prediction (depth 1), ``repro``'s
    ``_mtp_loss`` before its division: position t predicts token t+2 from
    [norm_e(emb(t+1)); norm_h(h_t)] -> combine -> one period -> final norm
    -> the shared head.  ``h``: (B, S, D), the backbone's final-normed
    output.  Returns (masked loss sum, count); the last two positions and
    ``mask``'s zeros count nothing.  The period's MoE aux loss is dropped,
    as there; ``sets``: its MoE token sets (``models.moe.moe``)."""
    m, zc, eps = params["mtp"], cfg.zero_centered_norm, cfg.norm_eps
    B, S = tokens.shape
    emb = embed_tokens(params, tokens, cfg)
    e = torch.cat([emb[:, 1:], torch.zeros_like(emb[:, :1])], dim=1)
    hh = torch.cat([rmsnorm(m["norm_e"], e, eps, zc), rmsnorm(m["norm_h"], h, eps, zc)],
                   dim=-1)
    hh = (hh @ m["combine"]).to(cfg.cdtype)
    positions = torch.arange(S, dtype=torch.int32, device=hh.device).expand(B, S)
    hh, _ = apply_period(m["block"], hh, positions, cfg, sets)
    hh = rmsnorm(m["final_norm"], hh, eps, zc)
    tgt = torch.cat([tokens[:, 2:], torch.zeros_like(tokens[:, :2])], dim=1)
    msk = torch.ones((B, S), dtype=torch.float32, device=hh.device) if mask is None \
        else mask.float()
    msk = msk * (torch.arange(S, device=hh.device) < S - 2)
    l2, c2, _ = chunked_ce_loss(hh, _head_weight(params, cfg), tgt, msk, cfg.logit_softcap,
                                ce_chunk)
    return l2, c2


def init_decode_states(batch: int, max_len: int, cfg: ModelConfig, device="cuda"):
    return init_period_states(batch, max_len, cfg, cfg.cdtype, device)


def decode_step(params, token, position, states, cfg: ModelConfig, sets: int = 1):
    """One decode step.

    token: (B,) int; position: Python int (lockstep) or (B,) int32 tensor.
    Returns (logits (B, V) float32, states); the caches, Mamba and RWKV
    states are updated in place.  ``sets``: the number of equal MoE token
    sets of the B rows (``models.moe.moe``; default all rows one set, as
    ``repro``'s mesh-free ``decode_step``).
    """
    x = embed_tokens(params, token, cfg)
    h, states = decode_periods(params["periods"], x, position, states, cfg, sets)
    return head_logits(params, h, cfg), states
