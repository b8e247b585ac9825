"""Algorithm 2: dynamic-programming HPP planning (+ baseline planners).

``Q(l, n, p)`` = HPP-Round latency of the optimal plan slicing the *last* l
layers into p stages across the *last* n devices (devices pre-sorted by
descending memory — earlier stages hold more activations, §3.3).  The
transition (Eq. 10) extends an optimal sub-pipeline with one new head stage
replicated over the remaining devices, re-evaluating the dominant step
(Eq. 11) and the full HPP-Round latency (Eqs. 4–6).

Baselines implemented for the paper's comparisons: pure DP (EDDL-style with
heterogeneous batch allocation), GPipe-style PP (compute-balanced, ignores
boundary activations), PipeDream / Dapple planners (homogeneous-cluster
assumptions, no memory budget), and a HetPipe-style HDP arrangement.

A copy of ``repro.core.planner``: the training half, with
``replan_for_membership``, and the serving half (``serve_stage_candidates``,
``ServePlan``, ``plan_serve``, ``plan_serve_uniform`` and their pricing).
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache

from .allocation import Allocation, AllocationError, allocate_microbatch
from .costmodel import (CompressionConfig, Step, allreduce_time,
                        bucketed_allreduce_residual,
                        compressed_allreduce_time, compressed_comm_time,
                        decode_boundary_time, decode_step_time,
                        hpp_round_latency, hpp_volume,
                        kp_policy, parse_compress, queue_wait_quantile,
                        round_latency, serve_stage_slots, stage_memory)
from .profiler import Profile


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One pipeline stage of a ``Plan``: the unit Algorithms 1+2 decide.

    ``alloc`` is Algorithm 1's heterogeneous intra-stage micro-batch split
    (Eq. 9 capacity-proportional, Eq. 3 memory-capped); ``k_p`` is the
    1F1B warm-up depth ``2(P-p)-1`` that bounds resident activations
    (Eq. 3, DESIGN.md §4).
    """

    layers: tuple[int, int]        # [i, j)
    group: tuple[int, ...]         # device ranks (into profile.cluster order)
    alloc: tuple[int, ...]         # micro-batch samples per device
    k_p: int                       # warm-up depth (2*(P-p)-1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A complete HPP training configuration (Algorithm 2 output).

    ``steps`` interleave exec and comm ``costmodel.Step``s in pipeline
    order; ``latency`` is the HPP-Round estimate from Eqs. (4)–(6) on the
    profile the plan was made with (``core.simulator.reprice_plan``
    re-prices it under another profile, e.g. measured).  Consumed by
    ``core.lowering.lower_plan`` (execution) and ``core.replay`` (failure
    recovery).
    """

    arch: str
    stages: tuple[StagePlan, ...]
    steps: tuple[Step, ...]
    micro_batch: int
    n_micro: int
    latency: float                 # predicted HPP-Round latency (s)
    planner: str = "asteroid"
    plan_time: float = 0.0
    # Gradient-sync semantics the plan was priced under: 0 = synchronous
    # rounds (Eq. 4 charges every AllReduce), 1 = bounded-stale overlap
    # (``costmodel.round_latency_async`` charges only un-hidden comm); the
    # runtime knob ``TrainSpec.staleness`` should match.
    staleness: int = 0
    # Compressed-transfer configuration the plan was priced under
    # (``costmodel.CompressionConfig`` or None = full-precision wire); the
    # runtime knobs ``TrainSpec.compress``/``quant_tile``/``bucket_mb``
    # should match.  ``dataclasses.replace``-based replay replans carry it
    # automatically; ``simulator.reprice_plan`` re-applies it.
    compress: CompressionConfig | None = None

    @property
    def global_batch(self) -> int:
        return self.micro_batch * self.n_micro

    @property
    def throughput(self) -> float:
        """Training throughput estimate (samples/s): B / T_round (Eq. 4)."""
        return self.global_batch / self.latency if self.latency > 0 else 0.0

    def memory_per_device(self, profile: Profile) -> dict[int, float]:
        """Eq. (3) peak bytes per device rank under this plan's K_p."""
        out = {}
        for st in self.stages:
            for d, y in zip(st.group, st.alloc):
                out[d] = stage_memory(profile.table, *st.layers, y, st.k_p,
                                      self.n_micro)
        return out

    def comm_volume(self, profile: Profile) -> float:
        """Eq. (2) for this plan."""
        sp = [profile.table.param_bytes(*st.layers) for st in self.stages]
        gs = [len(st.group) for st in self.stages]
        ba = [profile.table.boundary_act(st.layers[1])
              for st in self.stages[:-1]]
        return hpp_volume(sp, gs, ba, self.global_batch)


# ---------------------------------------------------------------------------
# Asteroid DP planner
# ---------------------------------------------------------------------------


def _group_flops(profile: Profile, group) -> float:
    return min(profile.cluster.devices[d].flops for d in group)


def _comm_step(profile: Profile, micro_batch: int, boundary_layer: int,
               g_left, g_right, compress=None) -> Step:
    """Inter-stage activation transfer: one micro-batch's boundary tensor
    over the slowest link between the two device groups.  Under
    compression the wire moves the quantized payload and each endpoint is
    charged its (de)quantization time (DESIGN.md §10) — both directions,
    since the custom VJP compresses the backward cotangent identically."""
    nbytes = micro_batch * profile.table.boundary_act(boundary_layer)
    bw = min(profile.cluster.bw(a, b) for a in g_left for b in g_right)
    t = compressed_comm_time(nbytes, bw, compress,
                             _group_flops(profile, g_left),
                             _group_flops(profile, g_right))
    return Step("comm", ef=t, eb=t)


def _stage_ta(profile: Profile, i: int, j: int, group, compress,
              backward_s: float) -> float:
    """Gradient-sync seconds charged to one stage: Eq. (5) over the
    (possibly compressed) gradient bytes, minus what DDP-style bucketed
    overlap hides behind the stage's own backward."""
    pb = profile.table.param_bytes(i, j)
    ta = compressed_allreduce_time(pb, group, profile.cluster, compress,
                                   _group_flops(profile, group))
    return bucketed_allreduce_residual(ta, backward_s, pb, compress)


def plan_hpp(profile: Profile, global_batch: int, micro_batch: int,
             max_stages: int | None = None, arch: str = "",
             check_memory: bool = True, intra_opt=True,
             allowed_stages=None, staleness: int = 0,
             compress=None) -> Plan:
    """Run Algorithm 2: DP over ``Q(l, n, p)`` with the Eq. 10 transition.

    Each candidate head stage is priced by Algorithm 1
    (``allocate_microbatch``: Eq. 8 lockstep stage time at the Eq. 9
    allocation, Eq. 3 memory-feasible given warm-up depth ``kp_policy``)
    and the extended pipeline re-evaluated with the full HPP-Round latency
    (Eqs. 4–6) rather than only the Eq. 11 dominant step.  ``profile`` may
    be analytic or measured — the DP only ever reads the prefix-sum time
    tables.

    ``allowed_stages``: optional collection restricting the final stage
    count (e.g. divisors of a runtime mesh's model axis, so the plan can be
    lowered — see ``core.lowering``).  ``intra_opt=False`` disables
    Algorithm 1 Phase 2 (straggler offloading) — the Fig. 15a ablation;
    ``intra_opt="auto"`` keeps Phase 2's heterogeneous allocation only when
    it strictly improves the predicted latency (a hetero allocation pads
    every data shard to B_max at runtime, so offloading with no predicted
    gain costs real throughput — the fig15a_runtime regression).

    ``staleness=1`` prices candidates with the two-stream overlapped round
    model (``costmodel.round_latency_async``): the gradient AllReduce
    leaves the critical path, which shifts stage cuts toward splits that
    balance the Execution Phase instead of amortizing T_a.

    ``compress``: None, 'int8'/'fp8', a ``costmodel.CompressionConfig``,
    or 'auto'.  A set format prices every boundary transfer and gradient
    AllReduce over the quantized wire (ratio + (de)quant endpoint cost —
    Algorithm 2's cuts then chase the cheaper links harder), and the
    resulting plan records the choice for the runtime and replay.
    'auto' is the error/time trade made explicit: price both, keep the
    compressed plan only when it is strictly faster — otherwise the
    quantization error buys nothing and full precision wins."""
    if compress == "auto":
        kw = dict(max_stages=max_stages, arch=arch, check_memory=check_memory,
                  intra_opt=intra_opt, allowed_stages=allowed_stages,
                  staleness=staleness)
        comp = plan_hpp(profile, global_batch, micro_batch,
                        compress="int8", **kw)
        base = plan_hpp(profile, global_batch, micro_batch,
                        compress=None, **kw)
        return comp if comp.latency < base.latency * (1.0 - 1e-9) else base
    compress = parse_compress(compress)
    if intra_opt == "auto":
        kw = dict(max_stages=max_stages, arch=arch, check_memory=check_memory,
                  allowed_stages=allowed_stages, staleness=staleness,
                  compress=compress)
        full = plan_hpp(profile, global_batch, micro_batch,
                        intra_opt=True, **kw)
        if all(len(set(st.alloc)) <= 1 for st in full.stages):
            return full                  # Phase 2 changed nothing
        base = plan_hpp(profile, global_batch, micro_batch,
                        intra_opt=False, **kw)
        return full if full.latency < base.latency * (1.0 - 1e-9) else base
    t_start = time.perf_counter()
    table = profile.table
    L, N = table.L, len(profile.cluster.devices)
    M = global_batch // micro_batch
    assert M >= 1, (global_batch, micro_batch)
    P_max = min(max_stages or N, N, L)

    @lru_cache(maxsize=None)
    def stage_eval(i: int, j: int, a: int, b: int, k_p: int) -> Allocation | None:
        """T(i->j, G) for device ranks [a, b) with warm-up depth k_p."""
        group = tuple(range(a, b))
        try:
            return allocate_microbatch(
                profile, group, micro_batch, i, j,
                k_p if check_memory else 0,
                block=max(1, micro_batch // 16), offload=intra_opt)
        except AllocationError:
            return None

    # Q[(l, n, p)] = (steps tuple, latency) ; l = layers from the end,
    # n = devices from the end.
    Q: dict[tuple[int, int, int], tuple[tuple[Step, ...], float]] = {}

    for p in range(1, P_max + 1):
        for n in range(p, N + 1):
            for l in range(p, L + 1):
                i = L - l                     # head stage starts at layer i
                best = None
                if p == 1:
                    alloc = stage_eval(i, L, N - n, N, kp_policy(1, 0))
                    if alloc is None:
                        continue
                    ta = _stage_ta(profile, i, L, tuple(range(N - n, N)),
                                   compress, alloc.eb * M)
                    steps = (Step("exec", alloc.ef, alloc.eb, ta,
                                  tuple(range(N - n, N)), (i, L), alloc.y),)
                    best = (steps, hpp_round_latency(steps, M, staleness))
                else:
                    for l2 in range(p - 1, l):        # sub-pipeline layer count
                        for n2 in range(p - 1, n):    # sub-pipeline device count
                            sub = Q.get((l2, n2, p - 1))
                            if sub is None:
                                continue
                            j = L - l2                # head stage covers [i, j)
                            a, b = N - n, N - n2      # head stage device ranks
                            alloc = stage_eval(i, j, a, b, kp_policy(p, 0))
                            if alloc is None:
                                continue
                            ta = _stage_ta(profile, i, j, tuple(range(a, b)),
                                           compress, alloc.eb * M)
                            head = Step("exec", alloc.ef, alloc.eb, ta,
                                        tuple(range(a, b)), (i, j), alloc.y)
                            comm = _comm_step(profile, micro_batch, j,
                                              tuple(range(a, b)), sub[0][0].group,
                                              compress)
                            steps = (head, comm) + sub[0]
                            lat = hpp_round_latency(steps, M, staleness)
                            if best is None or lat < best[1]:
                                best = (steps, lat)
                if best is not None:
                    Q[(l, n, p)] = best

    feasible = [p for p in range(1, P_max + 1) if (L, N, p) in Q]
    candidates = [(Q[(L, N, p)][1], p) for p in feasible
                  if allowed_stages is None or p in allowed_stages]
    if not candidates:
        if feasible:
            raise AllocationError(
                f"no feasible plan with allowed_stages={sorted(allowed_stages)} "
                f"(feasible stage counts: {feasible})")
        raise AllocationError("no feasible HPP plan (memory budgets too tight)")
    lat, p_best = min(candidates)
    steps = Q[(L, N, p_best)][0]
    stages = _stages_from_steps(steps, p_best)
    return Plan(arch, stages, steps, micro_batch, M, lat, "asteroid",
                time.perf_counter() - t_start, staleness=staleness,
                compress=compress)


def _stages_from_steps(steps, P: int) -> tuple[StagePlan, ...]:
    stages = []
    p = 0
    for st in steps:
        if st.kind == "exec":
            stages.append(StagePlan(st.layers, st.group, st.alloc,
                                    kp_policy(P, p)))
            p += 1
    return tuple(stages)


def replan_for_membership(profile: Profile, incumbent: Plan,
                          allowed_stages=None) -> Plan:
    """Full Algorithm-2 re-plan after a membership change, keeping the
    incumbent's batch geometry and gradient-sync semantics.

    This is the FTPipeHD-style fallback the membership controller reaches
    for when incremental candidates (``replay.admission_replay`` /
    ``replay.departure_replay``) are infeasible: ``profile`` is the
    cluster *after* the change (see ``profiler.extend_profile`` for
    joins), and every weight placement is up for grabs."""
    return plan_hpp(profile, incumbent.global_batch, incumbent.micro_batch,
                    arch=incumbent.arch, allowed_stages=allowed_stages,
                    staleness=getattr(incumbent, "staleness", 0),
                    compress=getattr(incumbent, "compress", None))


def auto_microbatch(profile: Profile, global_batch: int,
                    candidates=(1, 2, 4, 8, 16, 32, 64), arch: str = "",
                    **kw) -> Plan:
    """Sweep micro-batch sizes; return the fastest feasible plan.

    The paper fixes the micro-batch per experiment; this outer sweep makes
    the trade explicit — smaller micro-batches shrink bubbles (Eq. 6) but
    pay more per-layer launch overhead and lower batch efficiency
    (Fig. 6), and Eq. 3 memory feasibility can cut either way."""
    best = None
    for mb in candidates:
        if global_batch % mb:
            continue
        try:
            plan = plan_hpp(profile, global_batch, mb, arch=arch, **kw)
        except AllocationError:
            continue
        if best is None or plan.latency < best.latency:
            best = plan
    if best is None:
        raise AllocationError("no feasible plan for any micro-batch size")
    return best


# ---------------------------------------------------------------------------
# Baseline planners (paper's comparison systems)
# ---------------------------------------------------------------------------


def plan_dp(profile: Profile, global_batch: int, micro_batch: int,
            arch: str = "", heterogeneous: bool = True,
            overlap: bool = True) -> Plan:
    """Pure data parallelism (EDDL-style when heterogeneous=True) — the
    paper's DP baseline in Table 4 / Fig. 13.

    One stage spanning all layers on every device; latency is Eq. 4 with a
    single exec step and the Eq. 5 full-model AllReduce.  ``overlap``:
    DDP-style bucketed gradient AllReduce overlapped with the backward
    pass (the AllReduce only charges the part the backward can't hide) —
    without this the DP baseline would be unrealistically weak."""
    t0 = time.perf_counter()
    table = profile.table
    N = len(profile.cluster.devices)
    group = tuple(range(N))
    M = global_batch // micro_batch
    if heterogeneous:
        alloc = allocate_microbatch(profile, group, micro_batch, 0, table.L,
                                    k_p=1, block=max(1, micro_batch // 16))
    else:
        share = micro_batch // N
        y = [share] * N
        for r in range(micro_batch - share * N):
            y[r] += 1
        ef = max(profile.t_fwd(d, y[d], 0, table.L) for d in group)
        eb = max(profile.t_bwd(d, y[d], 0, table.L) for d in group)
        alloc = Allocation(tuple(y), ef, eb)
    ta = allreduce_time(table.param_bytes(0, table.L), group, profile.cluster)
    if overlap:
        ta = max(ta - alloc.eb * M, 0.1 * ta)
    steps = (Step("exec", alloc.ef, alloc.eb, ta, group, (0, table.L), alloc.y),)
    lat = round_latency(steps, M)
    stages = (StagePlan((0, table.L), group, alloc.y, 1),)
    return Plan(arch, stages, steps, micro_batch, M, lat,
                "eddl" if heterogeneous else "dp", time.perf_counter() - t0)


def plan_gpipe(profile: Profile, global_batch: int, micro_batch: int,
               arch: str = "", n_stages: int | None = None) -> Plan:
    """GPipe-style PP: equal-FLOPs contiguous split, one device per stage,
    ignores boundary activation sizes and device heterogeneity (the
    paper's PP baseline in Table 4) — its Eq. 11 dominant step is whatever
    stage happens to land on the slowest device."""
    t0 = time.perf_counter()
    table = profile.table
    N = len(profile.cluster.devices)
    P = n_stages or N
    M = global_batch // micro_batch
    total = table.flops(0, table.L)
    cuts, acc, target = [0], 0.0, total / P
    for li in range(table.L):
        acc += table.layers[li].flops_fwd
        if acc >= target * len(cuts) and len(cuts) < P:
            cuts.append(li + 1)
    while len(cuts) < P + 1:
        cuts.append(table.L)
    cuts[-1] = table.L

    steps = []
    stages = []
    for p in range(P):
        i, j = cuts[p], cuts[p + 1]
        d = p  # device rank p
        ef = profile.t_fwd(d, micro_batch, i, j)
        eb = profile.t_bwd(d, micro_batch, i, j)
        steps.append(Step("exec", ef, eb, 0.0, (d,), (i, j), (micro_batch,)))
        stages.append(StagePlan((i, j), (d,), (micro_batch,), kp_policy(P, p)))
        if p < P - 1:
            steps.append(_comm_step(profile, micro_batch, j, (d,), (d + 1,)))
    lat = round_latency(tuple(steps), M)
    return Plan(arch, tuple(stages), tuple(steps), micro_batch, M, lat,
                "gpipe", time.perf_counter() - t0)


def plan_homogeneous_hpp(profile: Profile, global_batch: int, micro_batch: int,
                         arch: str = "", include_allreduce: bool = False,
                         name: str = "pipedream") -> Plan:
    """PipeDream / Dapple-style planning: treats the cluster as homogeneous
    (mean capacity), ignores per-device memory budgets; Dapple additionally
    models the synchronous AllReduce cost (include_allreduce=True).

    The chosen configuration is then re-priced on the REAL heterogeneous
    profile (Eq. 8 at the actual device times) — the gap between the two
    is what deploying a homogeneity-assuming plan costs (Fig. 13)."""
    import numpy as np

    from .hardware import Cluster, DeviceProfile

    t0 = time.perf_counter()
    devs = profile.cluster.devices
    mean_flops = float(np.mean([d.flops for d in devs]))
    mean_mem = float(np.mean([d.mem_bytes for d in devs]))
    homog = Cluster(tuple(
        DeviceProfile(f"homog{i}", mem_bytes=mean_mem, flops=mean_flops,
                      sat_batch=devs[i].sat_batch, overhead=devs[i].overhead)
        for i in range(len(devs))), profile.cluster.bandwidth,
        profile.cluster.bw_matrix)
    homog_profile = Profile.analytic(profile.table, homog, profile.max_batch)

    plan = plan_hpp(homog_profile, global_batch, micro_batch, arch=arch,
                    check_memory=False)
    # Re-evaluate the chosen configuration on the REAL cluster (this is what
    # deploying a homogeneity-assuming plan on heterogeneous devices costs).
    steps = []
    for st in plan.steps:
        if st.kind == "comm":
            steps.append(st)
            continue
        i, j = st.layers
        ef = max(profile.t_fwd(d, y, i, j) for d, y in zip(st.group, st.alloc))
        eb = max(profile.t_bwd(d, y, i, j) for d, y in zip(st.group, st.alloc))
        # Dapple charges the synchronous AllReduce re-priced on the real
        # devices; PipeDream's async weight updates keep it off the round's
        # critical path entirely.
        ta = (_stage_ta(profile, i, j, st.group, None, eb * plan.n_micro)
              if include_allreduce else 0.0)
        steps.append(Step("exec", ef, eb, ta, st.group, st.layers, st.alloc))
    lat = round_latency(tuple(steps), plan.n_micro)
    return Plan(arch, plan.stages, tuple(steps), micro_batch, plan.n_micro,
                lat, name, time.perf_counter() - t0)


def plan_hetpipe_hdp(profile: Profile, global_batch: int, micro_batch: int,
                     arch: str = "", n_groups: int = 2):
    """HetPipe-style HDP: devices split into virtual workers (intra-group PP,
    inter-group DP through a parameter server).  Returns (per-round latency,
    comm volume per Eq. 1) for the Table 2 comm-volume comparison — the
    bidirectional full-model PS sync is the term Eq. 2's HPP avoids."""
    from .costmodel import hdp_volume

    table = profile.table
    N = len(profile.cluster.devices)
    n_groups = min(n_groups, N)
    ranks = list(range(N))
    groups = [tuple(ranks[i::n_groups]) for i in range(n_groups)]
    batches = [global_batch // n_groups] * n_groups
    batches[0] += global_batch - sum(batches)

    # per-group pipeline: equal-FLOPs split over group devices
    lat = 0.0
    vol_groups = []
    for g, beta in zip(groups, batches):
        sub = plan_gpipe_sub(profile, g, beta, micro_batch)
        lat = max(lat, sub)
        bounds = [table.boundary_act(table.L * (k + 1) // len(g))
                  for k in range(len(g) - 1)]
        vol_groups.append({"batch": beta, "act_bytes": bounds})
    # PS bidirectional full-model sync through the slowest link
    p_bytes = table.param_bytes(0, table.L)
    ps_time = 2.0 * p_bytes / profile.cluster.bandwidth if n_groups > 1 else 0.0
    lat += ps_time
    vol = hdp_volume(p_bytes, vol_groups)
    return lat, vol


def plan_gpipe_sub(profile: Profile, group, global_batch: int,
                   micro_batch: int) -> float:
    """Round latency of an equal-FLOPs pipeline over a device subset."""
    table = profile.table
    P = len(group)
    M = max(1, global_batch // micro_batch)
    total = table.flops(0, table.L)
    cuts, acc, target = [0], 0.0, total / P
    for li in range(table.L):
        acc += table.layers[li].flops_fwd
        if acc >= target * len(cuts) and len(cuts) < P:
            cuts.append(li + 1)
    while len(cuts) < P + 1:
        cuts.append(table.L)
    cuts[-1] = table.L
    steps = []
    for p in range(P):
        i, j = cuts[p], cuts[p + 1]
        d = group[p]
        steps.append(Step("exec", profile.t_fwd(d, micro_batch, i, j),
                          profile.t_bwd(d, micro_batch, i, j), 0.0, (d,),
                          (i, j), (micro_batch,)))
        if p < P - 1:
            steps.append(_comm_step(profile, micro_batch, j, (d,), (group[p + 1],)))
    return round_latency(tuple(steps), M)


# ---------------------------------------------------------------------------
# Serve-mode planning (DESIGN.md §11): stage/tp/split candidates priced by
# predicted per-token latency percentiles under a target offered load
# ---------------------------------------------------------------------------


def serve_stage_candidates(model_axis: int, n_heads: int) -> list[int]:
    """Lowerable stage counts for decode: every divisor of ``model_axis``
    whose tensor-parallel width divides the query head count.

    Replaces the old hard-coded {1, 2, 4, 8, 16} probe — a 6-device model
    axis now yields (1, 2, 3, 6) instead of falling through to the
    worst case.  Smallest-first: serve prefers TP (stage=1) when feasible.
    """
    out = [s for s in range(1, model_axis + 1)
           if model_axis % s == 0 and n_heads % (model_axis // s) == 0]
    return out or [model_axis]


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """A planner-driven decode configuration (the serving analogue of
    ``Plan``): mesh refinement (stage × tp), the heterogeneous slot split
    across data shards, and the latency percentiles it was priced at.

    Consumed by ``runtime.serve.build_slot_serve_step`` (``stage`` +
    ``shard_alloc``) and ``runtime.continuous.ContinuousBatcher``
    (``shard_alloc`` + ``cache_len`` as the admission-control cap).
    """

    arch: str
    stage: int
    tp: int
    cuts: tuple[int, ...]           # layer cut points, len == stage + 1
    shard_alloc: tuple[int, ...]    # decode slots per dp shard (unbalanced)
    max_slots: tuple[int, ...]      # per-shard admission cap (memory model)
    cache_len: int
    seq_len: int                    # profile row the per-token times divide
    arrival_rate: float             # offered load priced against (tokens/s)
    step_time: float                # engine-step service period (s)
    token_latency: float            # one token's pipeline traversal (s)
    predicted_p50: float
    predicted_p95: float
    predicted_p99: float
    planner: str = "asteroid-serve"
    plan_time: float = 0.0
    compress: CompressionConfig | None = None

    @property
    def slots(self) -> int:
        return sum(self.shard_alloc)

    @property
    def throughput(self) -> float:
        """Decode capacity (tokens/s): every engine step retires one token
        from each live slot."""
        return self.slots / self.step_time if self.step_time > 0 else 0.0

    @property
    def utilization(self) -> float:
        return self.arrival_rate / self.throughput if self.throughput else float("inf")


def _serve_cuts(L: int, stage: int) -> tuple[int, ...]:
    """Equal contiguous layer split — what the serve runtime lowers (periods
    padded to the stage count and divided evenly)."""
    return tuple(round(p * L / stage) for p in range(stage + 1))


def _shard_stage_groups(shard: int, model_axis: int, stage: int,
                        tp: int) -> list[tuple[int, ...]]:
    """Device ranks of each pipeline stage of one dp shard: shards occupy
    consecutive ``model_axis``-sized blocks of the cluster order, stages
    consecutive ``tp``-sized sub-blocks."""
    base = shard * model_axis
    return [tuple(range(base + p * tp, base + (p + 1) * tp))
            for p in range(stage)]


def _price_serve_shard(profile: Profile, shard: int, y: int, *, stage: int,
                       tp: int, cuts, seq_len: int, compress,
                       pipelined: bool) -> tuple[float, float]:
    """(service period, token traversal latency) of one dp shard running
    ``y`` decode slots through its stage × tp device block.

    Stage compute is the measured per-token forward slice divided by the
    tensor-parallel width (TP collectives are not charged — decode moments
    are bandwidth-bound on the boundary hops, not the intra-stage psum);
    boundary hops move one token's activation under the §10 link model.
    When the runtime group-streams the local batch (``pipelined``), stages
    overlap across groups and the service period is the slowest step; the
    traversal latency always sums the full path.
    """
    groups = _shard_stage_groups(shard, model_axis=stage * tp, stage=stage,
                                 tp=tp)
    table = profile.table
    comp, hops = [], []
    for p in range(stage):
        i, j = cuts[p], cuts[p + 1]
        t = max(decode_step_time(profile, d, y, i, j, seq_len)
                for d in groups[p]) / tp
        comp.append(t)
        if p < stage - 1:
            bw = min(profile.cluster.bw(a, b)
                     for a in groups[p] for b in groups[p + 1])
            hops.append(decode_boundary_time(
                table, j, y, seq_len, bw, compress,
                _group_flops(profile, groups[p]),
                _group_flops(profile, groups[p + 1])))
    token_latency = sum(comp) + sum(hops)
    period = max(comp + hops) if (pipelined and stage > 1) else token_latency
    return period, token_latency


def _serve_percentiles(step_time: float, token_latency: float, slots: int,
                       arrival_rate: float, levels=(0.5, 0.95, 0.99)):
    """M/M/1 tail on the aggregate service rate: a token waits for a free
    slot, then traverses the pipeline once."""
    if step_time <= 0 or slots <= 0:
        return tuple(float("inf") for _ in levels)
    mu = slots / step_time
    return tuple(token_latency + queue_wait_quantile(arrival_rate, mu, p)
                 for p in levels)


def _shard_slot_cap(profile: Profile, shard: int, *, stage: int, tp: int,
                    cuts, cache_len: int, seq_len: int,
                    mem_fraction: float) -> int:
    """Admission-control cap for one dp shard: every stage must fit its
    params plus the per-slot cache slice (both 1/tp per device)."""
    groups = _shard_stage_groups(shard, model_axis=stage * tp, stage=stage,
                                 tp=tp)
    cap = profile.max_batch
    for p in range(stage):
        i, j = cuts[p], cuts[p + 1]
        mem = min(profile.cluster.devices[d].mem_bytes for d in groups[p])
        cap = min(cap, serve_stage_slots(profile.table, i, j, mem * tp,
                                         cache_len, seq_len,
                                         mem_fraction=mem_fraction))
    return max(cap, 0)


def _price_serve_alloc(profile, alloc, *, stage, tp, cuts, seq_len,
                       arrival_rate, compress, pipelined=True):
    """(step_time, token_latency, (p50, p95, p99)) for a full slot split."""
    periods, lats = [], []
    for g, y in enumerate(alloc):
        if y <= 0:
            continue
        per, lat = _price_serve_shard(profile, g, y, stage=stage, tp=tp,
                                      cuts=cuts, seq_len=seq_len,
                                      compress=compress, pipelined=pipelined)
        periods.append(per)
        lats.append(lat)
    if not periods:
        inf = float("inf")
        return inf, inf, (inf, inf, inf)
    # SPMD lockstep: one jitted step advances every shard concurrently, so
    # the engine period is the slowest shard's; a token's traversal is its
    # own shard's path but the planner reports the worst case.
    step_time = max(periods)
    token_latency = max(lats)
    pct = _serve_percentiles(step_time, token_latency, sum(alloc),
                             arrival_rate)
    return step_time, token_latency, pct


def plan_serve(profile: Profile, arrival_rate: float, *, dp_shards: int,
               model_axis: int, n_heads: int, cache_len: int, seq_len: int,
               arch: str = "", compress=None, mem_fraction: float = 0.9,
               allowed_stages=None, uniform: bool = False,
               legacy_stage_probe: bool = False) -> ServePlan:
    """Serve-mode Algorithm 2: enumerate (stage, tp, slot split) candidates
    and keep the one minimizing predicted per-token p99 latency under the
    offered load.

    For each lowerable stage count (divisors of ``model_axis`` whose tp
    divides the head count) the slot split across dp shards is grown
    greedily — each new slot goes to the shard that minimizes the resulting
    p99 — under the Eq.-3-style admission cap (params + slots × per-token
    cache per device).  Faster shards absorb more slots: the serving
    analogue of Algorithm 1's capacity-proportional micro-batch split.

    ``uniform=True`` restricts the split to equal per-shard counts (the
    pre-planner baseline the bench compares against);
    ``legacy_stage_probe=True`` additionally restores the old
    {1, 2, 4, 8, 16} stage sweep.
    """
    t0 = time.perf_counter()
    compress = parse_compress(compress)
    if legacy_stage_probe:
        cands = [s for s in (1, 2, 4, 8, 16)
                 if model_axis % s == 0 and n_heads % (model_axis // s) == 0]
        cands = cands[:1] or [model_axis]
    else:
        cands = serve_stage_candidates(model_axis, n_heads)
    if allowed_stages is not None:
        cands = [s for s in cands if s in allowed_stages] or cands
    n_dev = len(profile.cluster.devices)
    if dp_shards * model_axis > n_dev:
        raise AllocationError(
            f"serve mesh needs {dp_shards * model_axis} devices, cluster "
            f"has {n_dev}")

    best = None
    for stage in cands:
        tp = model_axis // stage
        cuts = _serve_cuts(profile.table.L, stage)
        caps = [_shard_slot_cap(profile, g, stage=stage, tp=tp, cuts=cuts,
                                cache_len=cache_len, seq_len=seq_len,
                                mem_fraction=mem_fraction)
                for g in range(dp_shards)]
        if sum(caps) == 0:
            continue
        price = lambda a: _price_serve_alloc(
            profile, a, stage=stage, tp=tp, cuts=cuts, seq_len=seq_len,
            arrival_rate=arrival_rate, compress=compress)
        if uniform:
            cap = min(c for c in caps)
            cand_alloc, cand_cost = None, None
            for y in range(1, cap + 1):
                alloc = [y] * dp_shards
                st, lat, pct = price(alloc)
                if cand_cost is None or pct[2] < cand_cost[2][2]:
                    cand_alloc, cand_cost = alloc, (st, lat, pct)
            if cand_alloc is None:
                continue
            alloc, (st, lat, pct) = cand_alloc, cand_cost
        else:
            alloc = [0] * dp_shards
            st, lat, pct = price(alloc)
            while True:
                step = None
                for g in range(dp_shards):
                    if alloc[g] >= caps[g]:
                        continue
                    trial = list(alloc)
                    trial[g] += 1
                    cost = price(trial)
                    if step is None or cost[2][2] < step[1][2][2]:
                        step = (trial, cost)
                if step is None:
                    break
                trial, cost = step
                if cost[2][2] >= pct[2] and pct[2] < float("inf"):
                    break                     # adding slots no longer helps
                alloc, (st, lat, pct) = trial, cost
            if sum(alloc) == 0:
                continue
        plan = ServePlan(
            arch=arch, stage=stage, tp=tp, cuts=cuts,
            shard_alloc=tuple(alloc), max_slots=tuple(caps),
            cache_len=cache_len, seq_len=seq_len,
            arrival_rate=arrival_rate, step_time=st,
            token_latency=lat, predicted_p50=pct[0], predicted_p95=pct[1],
            predicted_p99=pct[2],
            planner="uniform-serve" if uniform else "asteroid-serve",
            compress=compress)
        if best is None or plan.predicted_p99 < best.predicted_p99:
            best = plan
    if best is None:
        raise AllocationError("no feasible serve plan (memory caps exhaust "
                              "every stage candidate)")
    return dataclasses.replace(best, plan_time=time.perf_counter() - t0)


def plan_serve_uniform(profile: Profile, arrival_rate: float,
                       **kw) -> ServePlan:
    """The pre-planner baseline: legacy power-of-two stage probe and an
    equal slot count on every dp shard."""
    return plan_serve(profile, arrival_rate, uniform=True,
                      legacy_stage_probe=True, **kw)
