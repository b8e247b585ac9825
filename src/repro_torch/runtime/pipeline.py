"""The HPP training runtime on one card: a pipeline of virtual stages.

The one-card counterpart of ``repro.runtime.pipeline``.  There the decoder
body (stacked periods) is sharded over a ``stage`` mesh axis and a
``lax.scan`` of M + P - 1 ticks runs one stage forward per device per tick,
``ppermute``-ing each output to the next stage; ``jax.grad`` of the scan is
the reverse pipeline.  Here the P stages are *virtual* and run in turn on
the one card:

* **Virtual stages.**  The period stack is kept unpadded, in model order,
  and stage p owns its rows ``[i_p, j_p)``: a planner split
  ``stage_periods``, or else the uniform split :func:`stage_ranges`.
  ``repro`` pads the stack with zero periods instead, to a multiple of P
  for the uniform split (``pad_periods``) and to P times the longest range
  for a planner split (``arrange_periods``): the same function, since a
  zero period is an identity whose gradient it masks, but on one card those
  periods would hold parameters, gradients and AdamW moments for nothing.
  Micro-batch m passes stages 0 .. P-1.  Only the real (stage, micro-batch) pairs are computed, tick by
  tick (``scan_ticks(P, M)`` ticks; at tick t stage p runs micro-batch
  t - p): the bubble ticks that the SPMD scan computes and masks are
  skipped; their outputs never reached ``outs`` and their aux was masked,
  so nothing changes.  The MoE layers' aux loss is summed over the real
  (stage, micro-batch) pairs, as ``repro`` sums it over its unmasked ticks
  and real periods.
* **Backward.**  Autograd's reverse of this forward, as ``jax.grad`` of the
  scan is.  Remat is one ``torch.utils.checkpoint(..., use_reentrant=False)``
  per period, as ``jax.checkpoint(body)`` is in ``repro``'s stage scan.
* **Compressed boundary.**  With ``compress`` in {int8, fp8} and P > 1, every
  stage-to-stage hop goes through :class:`CompressedBoundary`, which stands
  in for ``compressed_ppermute``: the forward is
  ``dequantize_op(quantize_op(x))`` on the stage's own (mb, S, D) output,
  packed into tiles per stage tensor as each device packs its local tensor
  in ``repro``; the backward is the same round trip on the cotangent (the
  transpose ``repro`` routes through the inverse permutation).  M (P - 1)
  hops forward and as many backward per step.
* **Double buffering** (``double_buffer``, ``repro``'s 2-tick stage hop).
  ``repro`` moves the ``ppermute`` of micro-batch m onto XLA's comm stream
  while m+1 computes.  On one card the hop is the compressed boundary's
  round trip, and it goes on a second CUDA stream: the side stream waits
  for the stage output, runs the quantize and dequantize kernels, records
  an event, and the next stage's main-stream compute waits for that event
  only where it reads the value.  Autograd runs each backward op on its
  forward op's stream, so the cotangent's round trip goes on the side
  stream too, ordered by the engine's own events.  Tensors that cross
  streams carry ``record_stream``.  The stages run in the synchronous
  pipeline's tick order (``repro``'s 2-tick hop would record the forwards
  in another order, and autograd adds each micro-batch's period gradients
  into the bound ``.grad`` buffers in the reverse of that order), so every
  value and every gradient is bit for bit the synchronous pipeline's; only
  the stream a round trip runs on moves.  An uncompressed boundary moves
  nothing on one card, so there the flag changes nothing, as it does on
  the CPU.
* **Loss.**  ``repro`` redistributes the last stage's outputs so each stage
  computes the head and cross entropy on M / P micro-batches, then sums
  over stages; on one card the head runs once over all M.  The sums are the
  same up to float reassociation.  The loss is ``ce + aux``, the aux summed
  over stages and divided by M (``repro``'s ``dp_shards * M``, with one
  data shard), plus ``MTP_WEIGHT`` times the MTP term where
  ``cfg.mtp_depth`` > 0: ``repro`` runs the MTP block on each stage's M / P
  micro-batches of the last stage's outputs, so its MoE layers route those
  rows as one token set; here the block runs once over all M with P token
  sets (``models.moe.moe``'s ``sets``).  Where P does not divide M,
  ``repro`` pads the last stages' chunks with zero rows that take expert
  capacity; that is not reproduced (one set).

Tensor parallelism, vocab padding and heterogeneous per-shard allocations
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.schedule import scan_ticks
from repro_torch.distributed.mesh import MeshPlan
from repro_torch.kernels.quant_transfer import roundtrip
from repro_torch.models.blocks import apply_period_remat, tree_index
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (MTP_WEIGHT, _head_weight, aux_tensor, chunked_ce_loss,
                                      embed_tokens, mtp_loss_sums)
from repro_torch.models.norms import rmsnorm
from repro_torch.optim import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Stage body and the compressed boundary
# ---------------------------------------------------------------------------


def _stage_fn(period_params, x, positions, cfg: ModelConfig, remat: bool):
    """Apply one stage's periods in order (``period_params``: one tree per
    period).  Returns (x, the periods' summed aux loss)."""
    aux = 0.0
    for pp in period_params:
        x, a = apply_period_remat(tree_map(_leaf_per_use, pp), x, positions, cfg, remat)
        aux = aux + a
    return x, aux


def _leaf_per_use(t):
    """A fresh leaf for a parameter leaf whose ``.grad`` is preset to a
    buffer (``runtime.train`` binds them so): it shares the storage and the
    ``.grad`` buffer, so each micro-batch's gradient is added into the
    buffer as soon as it is computed.  Were the M micro-batches to share one
    leaf, autograd would first sum their contributions in its input buffers,
    which at full width held a transient second copy of most of the period
    gradients.  Any other tensor is returned as it is."""
    if not (t.is_leaf and t.requires_grad and t.grad is not None):
        return t
    fresh = t.detach().requires_grad_(True)
    fresh.grad = t.grad
    return fresh


class CompressedBoundary(torch.autograd.Function):
    """quantize -> (the hop) -> dequantize, forward and backward.

    Stands in for ``repro``'s ``compressed_ppermute``: the carried value
    stays full precision (quantization error enters once per hop), and
    all-zero tiles round-trip exactly."""

    @staticmethod
    def forward(ctx, x, fmt: str, tile: int):
        ctx.fmt, ctx.tile = fmt, tile
        return roundtrip(x, fmt=fmt, tile=tile)

    @staticmethod
    def backward(ctx, g):
        return roundtrip(g, fmt=ctx.fmt, tile=ctx.tile), None, None


def stage_ranges(n_periods: int, n_stages: int):
    """The uniform split: stage p owns the real periods of ``repro``'s slice
    ``[p*k, (p+1)*k)``, k = ceil(n_periods / n_stages), of the stack padded
    to a multiple of ``n_stages``.  Where the periods do not divide, the last
    ranges are shorter, and may be empty (an identity stage, as an all-zero
    slice is in ``repro``)."""
    k = -(-n_periods // n_stages)
    return tuple((min(p * k, n_periods), min((p + 1) * k, n_periods))
                 for p in range(n_stages))


#: one side stream per card, for the process: the caching allocator keeps a
#: pool of blocks per stream, so a new stream per step would strand its
#: blocks in a fresh pool each time
_SIDE_STREAMS: dict = {}


def _side_stream(x, compress: str, P: int, double_buffer: bool):
    """The stream a double-buffered boundary round trip runs on, or None
    (synchronous: no boundary wire, one stage, or CPU tensors)."""
    if not double_buffer or compress == "none" or P == 1 or x.device.type != "cuda":
        return None
    if x.device not in _SIDE_STREAMS:
        _SIDE_STREAMS[x.device] = torch.cuda.Stream(x.device)
    return _SIDE_STREAMS[x.device]


def pipeline_apply(period_params, x_micro, positions, cfg: ModelConfig,
                   ranges, remat: bool = True, compress: str = "none",
                   quant_tile: int = 256, double_buffer: bool = False):
    """Run M micro-batches through P virtual stages.

    period_params: list of per-period param trees; stage p owns the rows
    ``ranges[p]`` = ``[i_p, j_p)``.  x_micro: (M, mb, S, D).  Returns (outs
    (M, mb, S, D), the aux loss summed over every stage and micro-batch
    computed).  ``double_buffer`` runs each boundary round trip on a
    second stream (module docstring); the values are the same.
    """
    M, P = x_micro.shape[0], len(ranges)
    if compress != "none" and P > 1:
        def boundary(x):
            return CompressedBoundary.apply(x, compress, quant_tile)
    else:
        def boundary(x):
            return x
    side = _side_stream(x_micro, compress, P, double_buffer)

    def send(x):
        """The hop of one stage output: (value, event it is ready at)."""
        if side is None:
            return boundary(x), None
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            y = boundary(x)
            ready = torch.cuda.Event()
            ready.record(side)
        x.record_stream(side)
        return y, ready

    def arrive(hop):
        y, ready = hop
        if ready is not None:
            main = torch.cuda.current_stream(y.device)
            main.wait_event(ready)
            y.record_stream(main)
        return y

    inflight: dict[int, tuple] = {}               # micro-batch -> its hop to the next stage
    outs: list = [None] * M
    aux = 0.0
    for t in range(scan_ticks(P, M)):
        for p in range(P):
            m = t - p
            if not 0 <= m < M:
                continue                         # bubble tick: nothing to compute
            inp = x_micro[m] if p == 0 else arrive(inflight.pop(m))
            i, j = ranges[p]
            out, a = _stage_fn(period_params[i:j], inp, positions, cfg, remat)
            aux = aux + a
            if p < P - 1:
                inflight[m] = send(out)
            else:
                outs[m] = out
    return torch.stack(outs), aux


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Static configuration of the one-card train step (the fields of
    ``repro``'s ``TrainSpec`` that this slice runs)."""

    cfg: ModelConfig
    plan: MeshPlan
    n_micro: int
    remat: bool = True
    # per-stage period ranges [i, j) of the unpadded stack (None = the
    # uniform split, ``stage_ranges``)
    stage_periods: tuple[tuple[int, int], ...] | None = None
    ce_chunk: int = 1024
    # compressed transfers: "none" | "int8" | "fp8" (boundaries and gradient buckets)
    compress: str = "none"
    quant_tile: int = 256
    # gradient-bucket size bound in MiB; None = one bucket per free-axes group
    bucket_mb: float | None = None
    # carry the per-bucket quantization residual across steps
    error_feedback: bool = True
    # 1 = round r's update is applied at the r+1 boundary (runtime.train's
    # async_step_fn); the loss and gradient functions do not read it
    staleness: int = 0
    # boundary round trips on a second stream (pipeline_apply)
    double_buffer: bool = False

    @property
    def ranges(self) -> tuple:
        """Each stage's rows of the period stack."""
        return self.stage_periods or stage_ranges(self.cfg.n_periods, self.plan.stage)

    @property
    def bucketed(self) -> bool:
        """True when the gradient path runs per bucket (and the step
        functions thread an error-feedback tree)."""
        return self.compress != "none" or self.bucket_mb is not None


def period_list(periods) -> list:
    """The per-period param trees of a stacked tree (views), or ``periods``
    itself when it is already a list."""
    if isinstance(periods, list):
        return periods
    return [tree_index(periods, i) for i in range(tree_leaves(periods)[0].shape[0])]


def spmd_loss_fn(spec: TrainSpec):
    """Returns ``f(params, batch) -> (loss, metrics)`` on one card.

    params: the model's tree (``periods`` stacked in model order, or a list
    of per-period trees).  batch: ``{"tokens": (B, S)}`` on the params'
    device.
    """
    cfg, M = spec.cfg, spec.n_micro

    def fn(params, batch):
        if "prefix" in batch:
            raise NotImplementedError("frontend prefix embeddings are not ported yet")
        tokens = batch["tokens"]
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} micro-batches")
        mb = B // M
        x = embed_tokens(params, tokens, cfg)
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(mb, S)
        periods = period_list(params["periods"])
        outs, aux = pipeline_apply(periods, x.reshape(M, mb, S, cfg.d_model), positions,
                                   cfg, spec.ranges, spec.remat, spec.compress,
                                   spec.quant_tile, spec.double_buffer)
        h = rmsnorm(params["final_norm"], outs.reshape(B, S, cfg.d_model),
                    cfg.norm_eps, cfg.zero_centered_norm)
        tgt = tokens[:, 1:]
        msk = torch.ones(tgt.shape, dtype=torch.float32, device=x.device)
        loss_sum, cnt_sum, _ = chunked_ce_loss(h[:, :-1], _head_weight(params, cfg), tgt,
                                               msk, cfg.logit_softcap, spec.ce_chunk)
        ce = loss_sum / torch.clamp(cnt_sum, min=1.0)
        aux = aux_tensor(aux / M, x.device)       # summed over stages, mean over M
        loss = ce + aux
        if cfg.mtp_depth > 0:
            P = len(spec.ranges)
            l2, c2 = mtp_loss_sums(params, h, tokens, cfg, None, spec.ce_chunk,
                                   sets=P if M % P == 0 else 1)
            mtp = l2 / torch.clamp(c2, min=1.0)
            loss = loss + MTP_WEIGHT * mtp
        else:
            mtp = torch.zeros((), dtype=torch.float32, device=x.device)
        return loss, {"ce": ce, "aux": aux, "mtp": mtp, "tokens": cnt_sum}

    return fn
