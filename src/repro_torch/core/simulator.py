"""Discrete-event simulator for HPP training rounds.

Executes a ``Plan`` under a micro-batch schedule (1F1B with K_p, or GPipe)
with explicit inter-stage communication channels, producing:

* the HPP-Round makespan (validates the planner's dominant-step estimate),
* per-device peak memory (validates Eq. 3 and the K_p policies, Fig. 15b),
* per-stage utilization / bubble fractions,
* a step-level trace for visualization.

The model: each stage executes its op order sequentially (the device group
acts in lockstep; intra-group DP runs concurrently so an op costs the max
over members, which is exactly the planner's Ef/Eb).  Each adjacent-stage
link carries one transfer at a time per direction.

A copy of ``repro.core.simulator`` less its serving half
(``reprice_serve_plan``, ``serve_prediction_gap``), which needs the serving
planner, a later slice of the port.  ``reprice_plan`` refuses a profile
with fewer devices than the plan names with a ``ValueError`` where
``repro``'s copy fails with an ``IndexError`` deep in the pricing.
"""

from __future__ import annotations

import dataclasses
import heapq

from .costmodel import Step, hpp_round_latency, stage_memory
from .planner import Plan
from .profiler import Profile
from .schedule import Op, schedule_orders


@dataclasses.dataclass
class SimResult:
    makespan: float
    peak_mem: dict[int, float]          # device rank -> bytes
    stage_busy: list[float]             # busy seconds per stage (lockstep max)
    bubble_frac: list[float]
    trace: list[tuple]                  # (t_start, t_end, stage, op)
    # per-device compute seconds at the *allocated* sample count y_d — the
    # Eq. (8) decomposition of each stage's lockstep op time (a device whose
    # allocation is below the stage max idles for the difference)
    device_busy: dict[int, float] = dataclasses.field(default_factory=dict)
    # two-stream decomposition (DESIGN.md §8): the Execution-Phase span
    # (compute stream), the largest stage AllReduce (comm stream), and the
    # AllReduce seconds the round actually charges after overlap.  Under
    # staleness 0 every AllReduce is charged (sync semantics); under
    # staleness >= 1 only the part exceeding the Execution Phase is.
    exec_span_s: float = 0.0
    allreduce_s: float = 0.0
    charged_allreduce_s: float = 0.0
    staleness: int = 0

    @property
    def max_peak_mem(self) -> float:
        return max(self.peak_mem.values())

    @property
    def hidden_comm_s(self) -> float:
        """AllReduce seconds the overlap removed from the critical path."""
        return self.allreduce_s - self.charged_allreduce_s

    def device_util(self, d: int) -> float:
        """Fraction of the round this device computes (vs idles/bubbles)."""
        return self.device_busy[d] / self.makespan if self.makespan else 0.0


def simulate(plan: Plan, profile: Profile, policy: str = "ours", *,
             staleness: int | None = None,
             serialize_p2p: bool = False) -> SimResult:
    """Discrete-event execution of ``plan``.

    Two resources per boundary: each stage's compute stream and each
    adjacent-stage link (one transfer at a time per direction).

    ``serialize_p2p=True`` additionally charges each boundary transfer to
    the *sending stage's compute stream* — the pre-double-buffer runtime,
    whose tick scan holds the stage while the ppermute drains.  The default
    models the double-buffered runtime, where a send only occupies the
    link.

    ``staleness`` (default: ``plan.staleness``) selects how the gradient
    AllReduce phases are charged: 0 appends each stage's T_a to its
    execution span (sync rounds); >= 1 runs them on the comm stream during
    the next round's warm-up, so the makespan only grows past the
    Execution Phase when the slowest AllReduce outlasts a whole round.
    """
    stages = plan.stages
    P, M = len(stages), plan.n_micro
    if staleness is None:
        staleness = getattr(plan, "staleness", 0)
    exec_steps = [s for s in plan.steps if s.kind == "exec"]
    comm_steps = [s for s in plan.steps if s.kind == "comm"]
    assert len(exec_steps) == P and len(comm_steps) == P - 1

    orders = schedule_orders(P, M, policy)

    # per-device op times at the allocated sample counts (Eq. 8 terms)
    dev_times: list[tuple[tuple[int, float, float], ...]] = []
    for st in stages:
        i, j = st.layers
        dev_times.append(tuple(
            (d, profile.t_fwd(d, y, i, j), profile.t_bwd(d, y, i, j))
            for d, y in zip(st.group, st.alloc)))
    device_busy = {d: 0.0 for st in stages for d in st.group}

    # --- readiness state -------------------------------------------------
    f_done = [[False] * M for _ in range(P)]        # F(p, m) finished
    b_done = [[False] * M for _ in range(P)]
    f_arrived = [[False] * M for _ in range(P)]     # activations available
    b_arrived = [[False] * M for _ in range(P)]     # gradient available
    for m in range(M):
        f_arrived[0][m] = True                      # stage 0 reads input
    op_idx = [0] * P
    stage_free_at = [0.0] * P
    link_free_fwd = [0.0] * (P - 1)
    link_free_bwd = [0.0] * (P - 1)

    trace: list[tuple] = []
    busy = [0.0] * P

    # event heap: (time, seq, kind, payload)
    heap: list[tuple] = []
    seq = 0

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    def ready(p: int, op: Op) -> bool:
        if op.kind == "F":
            return f_arrived[p][op.micro]
        if p == P - 1:
            return f_done[p][op.micro]
        return b_arrived[p][op.micro]

    def try_start(p: int, now: float):
        if op_idx[p] >= len(orders[p]):
            return
        op = orders[p][op_idx[p]]
        if not ready(p, op):
            return
        start = max(now, stage_free_at[p])
        dur = exec_steps[p].ef if op.kind == "F" else exec_steps[p].eb
        end = start + dur
        stage_free_at[p] = end
        op_idx[p] += 1
        busy[p] += dur
        for d, tf, tb in dev_times[p]:
            device_busy[d] += tf if op.kind == "F" else tb
        trace.append((start, end, p, f"{op.kind}{op.micro}"))
        push(end, "exec_done", (p, op))

    now = 0.0
    for p in range(P):
        try_start(p, 0.0)

    while heap:
        now, _, kind, payload = heapq.heappop(heap)
        if kind == "exec_done":
            p, op = payload
            if op.kind == "F":
                f_done[p][op.micro] = True
                if p < P - 1:   # send activation forward
                    t0 = max(now, link_free_fwd[p])
                    t1 = t0 + comm_steps[p].ef
                    link_free_fwd[p] = t1
                    if serialize_p2p:   # the tick scan holds the stage too
                        stage_free_at[p] = max(stage_free_at[p], t1)
                    push(t1, "fwd_arrive", (p + 1, op.micro))
            else:
                b_done[p][op.micro] = True
                if p > 0:       # send gradient backward
                    t0 = max(now, link_free_bwd[p - 1])
                    t1 = t0 + comm_steps[p - 1].eb
                    link_free_bwd[p - 1] = t1
                    if serialize_p2p:
                        stage_free_at[p] = max(stage_free_at[p], t1)
                    push(t1, "bwd_arrive", (p - 1, op.micro))
            try_start(p, now)
        elif kind == "fwd_arrive":
            p, m = payload
            f_arrived[p][m] = True
            try_start(p, now)
        elif kind == "bwd_arrive":
            p, m = payload
            b_arrived[p][m] = True
            try_start(p, now)

    # AllReduce phases: appended to each stage's span (sync), or drained on
    # the comm stream during the next round's warm-up (staleness >= 1) —
    # then only an AllReduce outlasting the whole Execution Phase extends
    # the steady-state round.
    exec_span = max(stage_free_at)
    ar_max = max((s.ta for s in exec_steps), default=0.0)
    if staleness >= 1:
        makespan = max(exec_span, ar_max)
        charged_ar = makespan - exec_span
    else:
        makespan = 0.0
        for p in range(P):
            stage_end = stage_free_at[p] + exec_steps[p].ta
            makespan = max(makespan, stage_end)
        charged_ar = makespan - exec_span

    # peak resident activations per stage, from the executed trace: a
    # micro-batch is resident from its F's *start* (not scheduling time —
    # an op can be queued behind a still-running one) until its B's end.
    act_peak = [0] * P
    events: list[list[tuple]] = [[] for _ in range(P)]
    for (t0, t1, p, op) in trace:
        if op[0] == "F":
            events[p].append((t0, 1))
        else:
            events[p].append((t1, -1))
    for p in range(P):
        live = 0
        for _, delta in sorted(events[p]):      # (-1) sorts before (+1) at ties
            live += delta
            act_peak[p] = max(act_peak[p], live)

    # memory accounting (per device)
    peak_mem: dict[int, float] = {}
    for p, st in enumerate(stages):
        w = profile.table.param_bytes(*st.layers)
        for d, y in zip(st.group, st.alloc):
            share = w  # each replica holds the full stage model
            static = stage_memory(profile.table, *st.layers, 0, 0)  # MOD+OPT
            act = profile.table.act_bytes_sum(*st.layers) * y
            peak_mem[d] = static + act_peak[p] * act

    bubble = [1.0 - busy[p] / exec_span if exec_span > 0 else 0.0
              for p in range(P)]
    return SimResult(makespan, peak_mem, busy, bubble, trace, device_busy,
                     exec_span_s=exec_span, allreduce_s=ar_max,
                     charged_allreduce_s=charged_ar, staleness=staleness)


# ---------------------------------------------------------------------------
# Cross-profile evaluation: predicted vs measured gap
# ---------------------------------------------------------------------------


def reprice_plan(plan: Plan, profile: Profile) -> Plan:
    """Re-price ``plan``'s steps under a (possibly different) ``Profile``.

    Keeps the plan's *decisions* — stage layer ranges, device groups,
    per-device allocations, micro-batch structure — and recomputes the step
    costs from ``profile``: Eq. (8) stage times at the allocated counts,
    Eq. (5) AllReduce over the stage group, boundary-activation transfer
    over the slowest inter-group link.  ``latency`` is re-evaluated with
    Eqs. (4)–(6).  The plan's compression choice (``plan.compress``) is
    re-applied, so a compressed plan stays priced over the quantized wire
    on the new profile.  This is how "what would this plan actually cost
    on the measured device times" is asked of an analytically-planned
    pipeline.
    """
    from .planner import _comm_step, _stage_ta

    exec_in = [s for s in plan.steps if s.kind == "exec"]
    n_dev = len(profile.cluster.devices)
    top = max((d for s in exec_in for d in s.group), default=-1)
    if top >= n_dev:
        raise ValueError(
            f"plan names {top + 1} devices (ranks up to {top}) but the "
            f"profile has {n_dev}: re-plan on this profile")
    compress = getattr(plan, "compress", None)
    steps: list[Step] = []
    for k, s in enumerate(exec_in):
        i, j = s.layers
        ef = max(profile.t_fwd(d, y, i, j) for d, y in zip(s.group, s.alloc))
        eb = max(profile.t_bwd(d, y, i, j) for d, y in zip(s.group, s.alloc))
        ta = _stage_ta(profile, i, j, s.group, compress, eb * plan.n_micro)
        steps.append(Step("exec", ef, eb, ta, s.group, s.layers, s.alloc))
        if k < len(exec_in) - 1:
            steps.append(_comm_step(profile, plan.micro_batch, j, s.group,
                                    exec_in[k + 1].group, compress))
    lat = hpp_round_latency(tuple(steps), plan.n_micro,
                            getattr(plan, "staleness", 0))
    return dataclasses.replace(plan, steps=tuple(steps), latency=lat)


def prediction_gap(plan: Plan, reference: Profile,
                   policy: str = "ours") -> dict:
    """Quantify how well ``plan``'s own latency estimate predicts its cost
    under ``reference`` (typically the *measured* profile).

    Returns a record with the planner's dominant-step estimate
    (``predicted_s``, Eqs. 4–6 on the profile the plan was made with), the
    same estimate re-priced on ``reference`` (``reference_s``), the
    event-accurate simulation of the re-priced plan
    (``reference_sim_s``), and ``gap_ratio = reference_s / predicted_s`` —
    the factor by which the planning profile misprices reality.  A plan
    made *on* the reference profile has gap_ratio 1 by construction; an
    analytically-planned pipeline evaluated against measured tables shows
    the error the paper's measured profiler exists to remove.
    """
    repriced = reprice_plan(plan, reference)
    sim = simulate(repriced, reference, policy)
    return {
        "reference_source": reference.source,
        "predicted_s": plan.latency,
        "reference_s": repriced.latency,
        "reference_sim_s": sim.makespan,
        "gap_ratio": (repriced.latency / plan.latency
                      if plan.latency > 0 else float("inf")),
    }


def observed_gap(plan: Plan, reference: Profile, observed_s: float) -> dict:
    """``prediction_gap``'s closed-loop sibling: compare a *measured* round
    latency against the plan re-priced on ``reference``.

    Where ``prediction_gap`` compares two analytic pricings (planning
    profile vs reference profile), this compares the reference pricing
    against what the live mesh actually measured — the quantity the
    portfolio drift watchdog (DESIGN.md §12) tracks.  ``gap_ratio`` is
    observed/predicted; host wall-seconds and simulated-cluster seconds
    live on different scales, so consumers should track *drift* of this
    ratio, not its absolute value.
    """
    repriced = reprice_plan(plan, reference)
    return {
        "reference_source": reference.source,
        "predicted_s": repriced.latency,
        "observed_s": observed_s,
        "gap_ratio": (observed_s / repriced.latency
                      if repriced.latency > 0 else float("inf")),
    }
