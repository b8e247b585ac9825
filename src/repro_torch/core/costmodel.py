"""Asteroid cost models: Eq. 1/2 (comm volume), Eq. 3 (memory), Eq. 5
(AllReduce time), and the dominant-step HPP-Round latency (Eqs. 4, 6, 11)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .hardware import Cluster
from .profiler import GRAD_BYTES, LayerTable, Profile

OPT_STATE_BYTES_PER_PARAM = 8      # Adam m+v fp32 (per fp32 param)


# ---------------------------------------------------------------------------
# §2.3 communication-volume analysis
# ---------------------------------------------------------------------------


def hdp_volume(model_param_bytes: float, groups: Sequence[dict]) -> float:
    """Eq. (1): HetPipe-style Hybrid Data Parallelism volume per mini-batch.

    groups: [{"batch": beta_i, "act_bytes": [a_{i,1}..a_{i,|g|-1}]}, ...]
    """
    G = len(groups)
    intra = sum(2.0 * g["batch"] * sum(g["act_bytes"]) for g in groups)
    if G == 1:
        return intra
    return 2.0 * G * model_param_bytes + intra


def hpp_volume(stage_param_bytes: Sequence[float], group_sizes: Sequence[int],
               boundary_act_bytes: Sequence[float], global_batch: int) -> float:
    """Eq. (2): Hybrid Pipeline Parallelism volume per mini-batch."""
    G = len(stage_param_bytes)
    allreduce = sum(2.0 * (g - 1) * p for p, g in zip(stage_param_bytes, group_sizes))
    if G == 1:
        return allreduce
    pipe = 2.0 * global_batch * sum(boundary_act_bytes)
    return allreduce + pipe


# ---------------------------------------------------------------------------
# Eq. 3 memory model
# ---------------------------------------------------------------------------


def kp_policy(P: int, p: int, policy: str = "ours") -> int:
    """Warm-up depth K_p for stage p (0-indexed) in a P-stage pipeline.

    'ours'  : 2*(P-p)-1   (the paper's choice)
    'a'     : 2*(P-p)
    'b'     : P-p
    'c'     : 2*(P-p)+1
    'gpipe' : M  (caller substitutes — returns a sentinel large value)
    """
    if policy == "ours":
        return 2 * (P - p) - 1
    if policy == "a":
        return 2 * (P - p)
    if policy == "b":
        return P - p
    if policy == "c":
        return 2 * (P - p) + 1
    if policy == "gpipe":
        return 1 << 30
    raise ValueError(policy)


def stage_memory(table: LayerTable, i: int, j: int, beta: int, k_p: int,
                 n_microbatches: int | None = None) -> float:
    """Eq. (3): Mem_p = MOD + OPT + K_p * ACT(beta) for layers [i, j)."""
    w = table.param_bytes(i, j)
    mod = w + w * (GRAD_BYTES / 4.0)            # params + accumulated grads
    opt = w / 4.0 * OPT_STATE_BYTES_PER_PARAM
    act = table.act_bytes_sum(i, j) * beta
    k = k_p if n_microbatches is None else min(k_p, n_microbatches)
    return mod + opt + k * act


# ---------------------------------------------------------------------------
# Steps & the dominant-step latency model (Eqs. 4, 6, 11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Step:
    """One pipeline step: an execution step (stage) or a communication step."""

    kind: str                      # 'exec' | 'comm'
    ef: float                      # forward time of this step per micro-batch
    eb: float                      # backward time per micro-batch
    ta: float = 0.0                # AllReduce phase time (exec steps only)
    group: tuple[int, ...] = ()    # device ranks (exec)
    layers: tuple[int, int] = (0, 0)
    alloc: tuple[int, ...] = ()    # micro-batch sample allocation across group

    @property
    def e_total(self) -> float:
        return self.ef + self.eb


def allreduce_time(param_bytes: float, group, cluster: Cluster) -> float:
    """Eq. (5) AllReduce phase: ring over the min intra-group bandwidth."""
    g = len(group)
    if g <= 1:
        return 0.0
    return 2.0 * (g - 1) * param_bytes / (g * cluster.min_bw(group))


def dominant_index(steps: Sequence[Step], M: int) -> int:
    """The step with the fewest Execution-Phase bubbles == the largest
    aligned total M*(Ef+Eb)_s + sum_{i<s}(Ef+Eb)_i (Eq. 11 generalized)."""
    best, best_val = 0, -1.0
    acc = 0.0
    for s, st in enumerate(steps):
        val = M * st.e_total + acc
        if val > best_val:
            best, best_val = s, val
        acc += st.e_total
    return best


def round_latency(steps: Sequence[Step], M: int) -> float:
    """HPP-Round latency, Eq. (4) with T_w (Eq. 5) and T_e (Eq. 6)."""
    if not steps:
        return 0.0
    dm = dominant_index(steps, M)
    e_dm = M * steps[dm].e_total
    # prefix sums
    worst = 0.0
    tw = 0.0
    for s, st in enumerate(steps):
        if s < dm:
            shift = sum(x.e_total for x in steps[s:dm])
            te = e_dm + shift
        else:
            shift = sum(x.e_total for x in steps[dm:s])
            te = e_dm - shift
        worst = max(worst, tw + te + st.ta)
        tw += st.ef
    return worst


# ---------------------------------------------------------------------------
# Two-stream (compute / comm) round models — the async 1F1B variant
# ---------------------------------------------------------------------------


def exec_phase_latency(steps: Sequence[Step], M: int) -> float:
    """Execution-Phase makespan only: Eqs. (4)/(6) with every AllReduce
    phase stripped.  The compute-stream half of the two-stream model."""
    return round_latency(tuple(dataclasses.replace(s, ta=0.0)
                               for s in steps), M)


def max_allreduce(steps: Sequence[Step]) -> float:
    """Largest per-stage AllReduce phase (Eq. 5) across the pipeline."""
    return max((s.ta for s in steps if s.kind == "exec"), default=0.0)


def round_latency_async(steps: Sequence[Step], M: int) -> float:
    """Steady-state HPP-Round latency of the *overlapped* pipeline.

    Two-resource model: stage compute and boundary P2P transfers pipeline
    as before (comm steps are pipeline steps in Eq. 4 already — the
    double-buffered runtime realizes that assumption), while the gradient
    AllReduce of round r runs on the comm stream during round r+1
    (staleness 1: round r's gradients are applied at the r+1 boundary, so
    the AllReduce has a full Execution Phase to hide in).  Only un-hidden
    comm is charged: a round cannot complete faster than its Execution
    Phase, nor faster than the slowest stage's AllReduce drains.
    """
    return max(exec_phase_latency(steps, M), max_allreduce(steps))


def unhidden_allreduce(steps: Sequence[Step], M: int) -> float:
    """AllReduce seconds the Execution Phase cannot hide (0 when the
    gradient sync leaves the critical path entirely)."""
    return max(0.0, max_allreduce(steps) - exec_phase_latency(steps, M))


def hpp_round_latency(steps: Sequence[Step], M: int,
                      staleness: int = 0) -> float:
    """Round latency under the chosen gradient-sync semantics: Eq. (4)
    synchronous rounds at staleness 0, the two-stream overlapped model at
    staleness >= 1."""
    if staleness >= 1:
        return round_latency_async(steps, M)
    return round_latency(steps, M)


def round_latency_serialized(steps: Sequence[Step], M: int) -> float:
    """Round latency when boundary transfers SERIALIZE with stage compute
    (the pre-double-buffer tick scan: the ppermute of micro-batch m sits
    between the compute of m and m+1 on every device).

    Modeled by folding each comm step's per-micro cost into the downstream
    exec step, leaving no independent comm resource to pipeline on — the
    one-stream lower bound that ``round_latency_async`` /
    ``round_latency`` improve on.
    """
    merged: list[Step] = []
    pending_f = pending_b = 0.0
    for s in steps:
        if s.kind == "comm":
            pending_f, pending_b = s.ef, s.eb
            continue
        merged.append(dataclasses.replace(s, ef=s.ef + pending_f,
                                          eb=s.eb + pending_b))
        pending_f = pending_b = 0.0
    return round_latency(tuple(merged), M)


# ---------------------------------------------------------------------------
# Compressed-transfer pricing (DESIGN.md §10)
# ---------------------------------------------------------------------------

#: (de)quantization arithmetic per element (abs, max-reduce, divide, round
#: on the sender; multiply on the receiver) — charged against each
#: endpoint's device flops.  Deliberately coarse: the kernels are
#: bandwidth-bound single-pass maps, so a handful of flops/elem bounds
#: them from above.
QUANT_FLOPS_PER_ELEM = 8.0

#: payload bits per fp32 element for each wire format (per-tile scale
#: amortized separately via ``CompressionConfig.wire_ratio``)
_FMT_BITS = {"int8": 8.0, "fp8": 8.0}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Planner-visible compressed-transfer configuration.

    Mirrors the runtime knobs (``TrainSpec.compress`` / ``quant_tile`` /
    ``bucket_mb`` / ``error_feedback``) so a ``Plan`` carries the choice
    through replay replans and ``reprice_plan`` re-applies it on fresh
    profiles.
    """

    fmt: str = "int8"              # 'int8' | 'fp8'
    tile: int = 256                # elements per scale tile
    bucket_mb: float | None = None # gradient bucket bound (None = per-group)
    error_feedback: bool = True

    def __post_init__(self):
        if self.fmt not in _FMT_BITS:
            raise ValueError(f"unknown compression format {self.fmt!r}")
        if self.tile <= 0:
            raise ValueError(f"quant tile must be positive, got {self.tile}")

    @property
    def wire_ratio(self) -> float:
        """Compressed bytes / fp32 bytes: payload bits plus one fp32 scale
        per ``tile`` elements ((8 + 32/tile) / 32 ≈ 0.254 for int8@256)."""
        return (_FMT_BITS[self.fmt] + 32.0 / self.tile) / 32.0


def parse_compress(compress) -> CompressionConfig | None:
    """Normalize the planner knob: None/'none' -> None, 'int8'/'fp8' -> a
    default config, a ``CompressionConfig`` passes through."""
    if compress is None or compress == "none":
        return None
    if isinstance(compress, CompressionConfig):
        return compress
    if isinstance(compress, str):
        return CompressionConfig(fmt=compress)
    raise TypeError(f"compress must be None, a format string or a "
                    f"CompressionConfig, got {type(compress)}")


def quant_endpoint_cost(nbytes: float, flops: float) -> float:
    """Seconds to (de)quantize an ``nbytes`` fp32 buffer on a device with
    ``flops`` peak throughput — the compute toll each endpoint pays for
    the cheaper wire."""
    if flops <= 0:
        return 0.0
    return (nbytes / 4.0) * QUANT_FLOPS_PER_ELEM / flops


def compressed_comm_time(nbytes: float, bw: float, compress,
                         flops_a: float, flops_b: float) -> float:
    """One boundary transfer under (optional) compression: compressed
    bytes over the link plus quantize on the sender and dequantize on the
    receiver.  ``compress=None`` prices the raw fp32 transfer."""
    cc = parse_compress(compress)
    if cc is None:
        return nbytes / bw
    return (nbytes * cc.wire_ratio / bw
            + quant_endpoint_cost(nbytes, flops_a)
            + quant_endpoint_cost(nbytes, flops_b))


def compressed_allreduce_time(param_bytes: float, group, cluster: Cluster,
                              compress, min_flops: float) -> float:
    """Eq. (5) over the compressed gradient stream: the ring moves
    ``wire_ratio`` of the bytes, and every rank quantizes its local
    contribution + dequantizes the result once per round."""
    cc = parse_compress(compress)
    if cc is None:
        return allreduce_time(param_bytes, group, cluster)
    t = allreduce_time(param_bytes * cc.wire_ratio, group, cluster)
    if len(group) > 1:
        t += 2.0 * quant_endpoint_cost(param_bytes, min_flops)
    return t


# ---------------------------------------------------------------------------
# Serve-mode pricing (DESIGN.md §11): one-token decode steps, slot memory,
# and the open-loop latency-percentile objective
# ---------------------------------------------------------------------------


def decode_step_time(profile: Profile, dev: int, beta: int, i: int, j: int,
                     seq_len: int) -> float:
    """Predicted seconds for ONE decode step of layers [i, j) at batch beta.

    The profile's ``(tf)`` rows measure a full ``seq_len``-token forward;
    a decode step runs the same layers over a single token, so we charge
    the per-token slice ``t_fwd / seq_len``.  Deliberately coarse — it
    ignores the worse arithmetic intensity of single-token GEMVs — but it
    is *measured* (device-specific, batch-specific, layer-specific), which
    is what makes heterogeneous stage/split choices comparable.
    """
    if seq_len <= 0:
        raise ValueError(f"seq_len must be positive, got {seq_len}")
    return profile.t_fwd(dev, max(beta, 1), i, j) / seq_len


def decode_boundary_bytes(table: LayerTable, j: int, beta: int,
                          seq_len: int) -> float:
    """Wire bytes of one decode-step boundary hop after layer ``j``: the
    profiled full-sequence boundary activation scaled to a single token."""
    return table.boundary_act(j) / max(seq_len, 1) * beta


def decode_boundary_time(table: LayerTable, j: int, beta: int, seq_len: int,
                         bw: float, compress, flops_a: float,
                         flops_b: float) -> float:
    """One-token boundary transfer after layer ``j`` at batch ``beta``,
    priced with the §10 compression-aware link model."""
    nbytes = decode_boundary_bytes(table, j, beta, seq_len)
    return compressed_comm_time(nbytes, bw, compress, flops_a, flops_b)


def slot_cache_bytes(table: LayerTable, i: int, j: int,
                     cache_len: int, seq_len: int) -> float:
    """Per-slot KV/state cache bytes for layers [i, j).

    The layer table's activation bytes are per-sample at ``seq_len``
    tokens; the decode cache holds per-token K/V (or recurrent state) for
    ``cache_len`` positions, so the per-token activation footprint is the
    planner's proxy for per-token cache bytes.
    """
    return table.act_bytes_sum(i, j) / max(seq_len, 1) * cache_len


def serve_stage_slots(table: LayerTable, i: int, j: int, mem_bytes: float,
                      cache_len: int, seq_len: int,
                      mem_fraction: float = 0.9) -> int:
    """Admission-control cap: how many decode slots fit on a device serving
    layers [i, j) — Eq. 3 with the training terms (grads, opt state, warm-up
    activations) replaced by params + slots × per-slot cache."""
    budget = mem_bytes * mem_fraction - table.param_bytes(i, j)
    per_slot = slot_cache_bytes(table, i, j, cache_len, seq_len)
    if budget <= 0 or per_slot <= 0:
        return 0
    return int(budget // per_slot)


def queue_wait_quantile(arrival_rate: float, service_rate: float,
                        p: float) -> float:
    """M/M/1 waiting-time quantile: P(W > t) = rho * exp(-mu (1-rho) t).

    Returns the smallest t with P(W <= t) >= p (0 when the tail is already
    below 1-p at t=0), or +inf when the queue is unstable (rho >= 1).
    """
    import math

    if service_rate <= 0:
        return math.inf
    rho = arrival_rate / service_rate
    if rho >= 1.0:
        return math.inf
    if rho <= 0.0:
        return 0.0
    t = math.log(rho / (1.0 - p)) / (service_rate * (1.0 - rho))
    return max(0.0, t)


def serve_latency_quantile(step_time: float, slots: int,
                           arrival_rate: float, p: float = 0.99) -> float:
    """Predicted per-token latency percentile of an open-loop decode server.

    The engine retires ``slots`` tokens every ``step_time`` seconds — an
    M/M/1 approximation with service rate mu = slots/step_time serving
    Poisson arrivals at ``arrival_rate`` tokens/s.  A token's latency is
    its queueing delay plus the step that computes it.
    """
    import math

    if step_time <= 0 or slots <= 0:
        return math.inf
    mu = slots / step_time
    return step_time + queue_wait_quantile(arrival_rate, mu, p)


def bucketed_allreduce_residual(ta: float, backward_s: float,
                                param_bytes: float, compress) -> float:
    """Un-hidden AllReduce seconds under DDP-style bucketed overlap.

    With the gradient tree split into size-bounded buckets, each bucket's
    psum launches as soon as its layers' backward completes — only the
    part of the total AllReduce that outlasts the remaining backward stays
    on the critical path, and the LAST bucket can never be hidden (its
    layers finish when the backward does).  Mirrors ``plan_dp``'s
    ``max(ta - eb*M, 0.1*ta)`` overlap pricing, with the floor set by the
    actual bucket count instead of a fixed 10%.
    """
    cc = parse_compress(compress)
    if cc is None or ta <= 0.0:
        return ta
    if cc.bucket_mb is None:
        n_buckets = 1
    else:
        n_buckets = max(1, -(-param_bytes * cc.wire_ratio
                             // (cc.bucket_mb * (1 << 20))))
    return max(ta - backward_s, ta / n_buckets)
