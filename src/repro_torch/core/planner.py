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

A copy of ``repro.core.planner``'s training half.  Its serving half
(``plan_serve``, ``ServePlan`` and their pricing) comes with planned
serving, and ``replan_for_membership`` with the session slice, later
slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from functools import lru_cache

from .allocation import Allocation, AllocationError, allocate_microbatch
from .costmodel import (CompressionConfig, Step, allreduce_time,
                        bucketed_allreduce_residual,
                        compressed_allreduce_time, compressed_comm_time,
                        hpp_round_latency, hpp_volume,
                        kp_policy, parse_compress, round_latency,
                        stage_memory)
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
    ``core.lowering.lower_plan`` (execution).
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
