"""Lower an Asteroid ``Plan`` (Algorithm 2 output) into the pipeline runtime.

The planner reasons about an edge cluster in *layer-table* coordinates:
stages are layer ranges ``[i, j)`` over ``embed + n_layers + head`` pseudo
layers, device groups are ranks into the profiled cluster, and micro-batch
allocations are per-device sample counts.  The runtime executes in *mesh*
coordinates: a ``(pod, data, stage, tp)`` plan whose ``stage`` axis splits
the stacked period params, with ``M`` micro-batches streamed through the
pipeline.  On one card the ``model`` axis is virtual (P stages run in turn,
tp = model_axis / P is a label) and the data axis is 1.

``lower_plan`` translates between the two worlds:

* stage count        -> ``MeshPlan.stage`` (must divide the model axis),
* layer ranges       -> per-stage *period* ranges, cuts snapped to period
                        boundaries (periods are the runtime's atomic unit),
* ``Plan.n_micro``   -> the runtime's micro-batch count ``M``,
* per-stage warm-up  -> K_p from ``core.schedule`` (validated against the
                        plan's own ``StagePlan.k_p``),
* ``micro_alloc``    -> per-data-shard sample counts (``lower_micro_alloc``):
                        Algorithm 1's heterogeneous intra-stage allocation
                        collapsed onto the data shards (one on one card).

``plan_to_train_step`` then builds the runnable train step, and
``check_against_simulator`` cross-checks the lowered schedule against the
discrete-event simulator: per-stage op counts, the unit-cost makespan in
ticks, and the O(K_p) resident-activation bound.

A copy of ``repro.core.lowering``'s framework-free part.  Its replay half
(``relower``, ``snap_plan``, ``period_owner``, ``period_positions``,
``migration_index`` and the parameter migration) comes with the session
slice of the port, which calls it: ``repro``'s indices address its
zero-padded arranged stack, and the port's runtime keeps the period stack
in model order, stage p owning the rows ``stage_periods[p]``
(``runtime.pipeline``).
"""

from __future__ import annotations

import dataclasses

from .costmodel import kp_policy, stage_memory
from .planner import Plan
from .profiler import Profile
from .schedule import max_inflight, schedule_orders
from .simulator import SimResult, simulate


class LoweringError(RuntimeError):
    """The plan cannot be realized on the requested runtime mesh."""


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """Runtime-coordinate view of an Asteroid ``Plan``."""

    arch: str
    stage: int                                  # pipeline depth P
    n_micro: int                                # micro-batches per round M
    micro_batch: int                            # samples per micro-batch
    global_batch: int
    n_periods: int                              # real periods in the model
    stage_periods: tuple[tuple[int, int], ...]  # period range [i, j) per stage
    stage_layers: tuple[tuple[int, int], ...]   # original table layer ranges
    device_groups: tuple[tuple[int, ...], ...]  # edge-cluster ranks (Plan)
    micro_alloc: tuple[tuple[int, ...], ...]    # per-device sample allocation
    warmup: tuple[int, ...]                     # K_p per stage

    @property
    def forward_ticks(self) -> int:
        """Scan length of the runtime's circular forward pipeline."""
        return self.n_micro + self.stage - 1

    @property
    def total_ticks(self) -> int:
        """Forward scan + its grad-reversed backward scan."""
        return 2 * self.forward_ticks

    def orders(self, policy: str = "ours"):
        """Per-stage 1F1B op orders for this plan's (P, M)."""
        return schedule_orders(self.stage, self.n_micro, policy)

    def peak_inflight(self, policy: str = "ours") -> tuple[int, ...]:
        """Peak resident micro-batches per stage under the op orders."""
        return tuple(max_inflight(o) for o in self.orders(policy))

    def memory_bound(self, profile: Profile) -> dict[int, float]:
        """Eq. (3) per-device peak bytes implied by the lowered schedule."""
        out: dict[int, float] = {}
        for st_layers, group, alloc, k in zip(self.stage_layers,
                                              self.device_groups,
                                              self.micro_alloc, self.warmup):
            for d, y in zip(group, alloc):
                out[d] = stage_memory(profile.table, *st_layers, y, k,
                                      self.n_micro)
        return out

    def tick_makespan(self, policy: str = "ours") -> int:
        """Schedule completion time in unit ticks (ef = eb = 1, zero comm).

        An independent list-scheduling implementation of the simulator's
        dependency rules, used to cross-validate the two.
        """
        P, M = self.stage, self.n_micro
        orders = self.orders(policy)
        f_done = [[None] * M for _ in range(P)]
        b_done = [[None] * M for _ in range(P)]
        idx = [0] * P
        free = [0] * P
        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for p in range(P):
                while idx[p] < len(orders[p]):
                    op = orders[p][idx[p]]
                    if op.kind == "F":
                        dep = 0 if p == 0 else f_done[p - 1][op.micro]
                    elif p == P - 1:
                        dep = f_done[p][op.micro]
                    else:
                        dep = b_done[p + 1][op.micro]
                    if dep is None:
                        break
                    end = max(free[p], dep) + 1
                    free[p] = end
                    (f_done if op.kind == "F" else b_done)[p][op.micro] = end
                    idx[p] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                raise LoweringError("deadlocked schedule (invalid op orders)")
        return max(free)


# ---------------------------------------------------------------------------
# Plan -> runtime coordinates
# ---------------------------------------------------------------------------


def _snap_to_periods(stage_layers, n_layers: int, pattern_len: int,
                     n_periods: int) -> tuple[tuple[int, int], ...]:
    """Snap table-coordinate layer cuts to period boundaries.

    Table layout: index 0 = embed, 1..n_layers = real layers, L-1 = head.
    Interior cuts land on the nearest period boundary, kept strictly
    monotone so every stage owns >= 1 period.
    """
    P = len(stage_layers)
    if P > n_periods:
        raise LoweringError(
            f"plan has {P} stages but the model only has {n_periods} periods")
    cuts = [0]
    for s, (i, j) in enumerate(stage_layers[:-1]):
        r = min(max(j - 1, 0), n_layers)           # cut in real-layer coords
        per = round(r / pattern_len)
        # strictly monotone, leaving >= 1 period for each remaining stage
        per = max(per, cuts[-1] + 1)
        per = min(per, n_periods - (P - 1 - s))
        cuts.append(per)
    cuts.append(n_periods)
    return tuple((cuts[p], cuts[p + 1]) for p in range(P))


def lower_plan(plan: Plan, cfg, model_axis: int | None = None) -> LoweredPlan:
    """Translate ``plan`` into runtime coordinates for ``cfg``.

    ``model_axis``: size of the production mesh's model axis; when given the
    stage count must divide it (tp = model_axis / stage).

    Validates the plan's internal contract before anything compiles: stage
    ranges contiguous, per-stage warm-ups equal to the schedule's
    ``kp_policy`` K_p (the Eq. 3 memory bound assumes them), allocations
    summing to the micro-batch, ``n_micro * micro_batch == global_batch``.
    """
    P = len(plan.stages)
    if model_axis is not None and model_axis % P != 0:
        raise LoweringError(
            f"stage count {P} does not divide the mesh model axis "
            f"{model_axis}; re-plan with max_stages set to a divisor")
    if cfg.n_layers % len(cfg.pattern) != 0:
        raise LoweringError(
            f"n_layers {cfg.n_layers} not a multiple of the pattern "
            f"({len(cfg.pattern)})")
    n_periods = cfg.n_layers // len(cfg.pattern)

    stage_layers = tuple(st.layers for st in plan.stages)
    for (a, b), (c, _) in zip(stage_layers[:-1], stage_layers[1:]):
        if b != c:
            raise LoweringError(f"stage layer ranges not contiguous: {b} != {c}")

    stage_periods = _snap_to_periods(stage_layers, cfg.n_layers,
                                     len(cfg.pattern), n_periods)

    warmup = tuple(kp_policy(P, p) for p in range(P))
    for p, st in enumerate(plan.stages):
        if st.k_p != warmup[p]:
            raise LoweringError(
                f"stage {p} warm-up {st.k_p} != schedule K_p {warmup[p]}")
        if sum(st.alloc) != plan.micro_batch:
            raise LoweringError(
                f"stage {p} allocation {st.alloc} does not sum to the "
                f"micro-batch {plan.micro_batch}")
    if plan.n_micro * plan.micro_batch != plan.global_batch:
        raise LoweringError("n_micro * micro_batch != global_batch")

    return LoweredPlan(
        arch=plan.arch, stage=P, n_micro=plan.n_micro,
        micro_batch=plan.micro_batch, global_batch=plan.global_batch,
        n_periods=n_periods, stage_periods=stage_periods,
        stage_layers=stage_layers,
        device_groups=tuple(st.group for st in plan.stages),
        micro_alloc=tuple(st.alloc for st in plan.stages), warmup=warmup)


# ---------------------------------------------------------------------------
# Micro-batch allocation -> data-shard coordinates
# ---------------------------------------------------------------------------


def _project_alloc(alloc: tuple[int, ...], dp: int) -> tuple[int, ...]:
    """Project one stage's per-device allocation onto ``dp`` data shards.

    Devices keep the planner's order.  With more devices than shards,
    contiguous device blocks aggregate onto one shard; with fewer, each
    device's share is split evenly across its block of shards (that device's
    work is data-parallel over several mesh columns).
    """
    G = len(alloc)
    if G == dp:
        return tuple(alloc)
    if G > dp:
        bounds = [s * G // dp for s in range(dp + 1)]
        return tuple(sum(alloc[bounds[s]:bounds[s + 1]]) for s in range(dp))
    out = [0] * dp
    for g, y in enumerate(alloc):
        lo, hi = g * dp // G, (g + 1) * dp // G
        q, r = divmod(y, hi - lo)
        for k in range(hi - lo):
            out[lo + k] = q + (1 if k < r else 0)
    return tuple(out)


def lower_micro_alloc(lowered: LoweredPlan, dp_shards: int) -> tuple[int, ...]:
    """Collapse the plan's per-stage device allocations (Algorithm 1 /
    Eq. 9) into the single per-data-shard sample allocation the shard_map
    runtime executes.

    In mesh coordinates every stage's intra-stage group is the *same* set of
    ``dp_shards`` data columns (the mesh is rectangular), and the circular
    pipeline never re-splits samples across the data axis between stages —
    so Algorithm 1's per-stage allocations are projected onto ``dp_shards``
    slots (``_project_alloc``) and, when stages disagree, combined by
    largest-remainder rounding of their mean.  When every stage projects to
    the same vector the result is exact; the returned counts always sum to
    ``lowered.micro_batch``.
    """
    if dp_shards < 1:
        raise LoweringError(f"dp_shards must be >= 1, got {dp_shards}")
    mb = lowered.micro_batch
    projs = [_project_alloc(a, dp_shards) for a in lowered.micro_alloc]
    if all(p == projs[0] for p in projs):
        out = projs[0]
    else:
        mean = [sum(p[d] for p in projs) / len(projs)
                for d in range(dp_shards)]
        base = [int(x) for x in mean]
        rem = mb - sum(base)
        order = sorted(range(dp_shards), key=lambda d: (base[d] - mean[d], d))
        for d in order[:rem]:
            base[d] += 1
        out = tuple(base)
    if sum(out) != mb or any(y < 0 for y in out):
        raise LoweringError(
            f"collapsed allocation {out} does not partition the micro-batch "
            f"{mb} over {dp_shards} data shards")
    return out


# ---------------------------------------------------------------------------
# Simulator cross-check
# ---------------------------------------------------------------------------


def _unitize(plan: Plan) -> Plan:
    """Copy of ``plan`` with unit exec cost and free communication."""
    steps = tuple(
        dataclasses.replace(s, ef=1.0, eb=1.0, ta=0.0) if s.kind == "exec"
        else dataclasses.replace(s, ef=0.0, eb=0.0) for s in plan.steps)
    return dataclasses.replace(plan, steps=steps)


def check_against_simulator(lowered: LoweredPlan, plan: Plan,
                            profile: Profile, policy: str = "ours",
                            rel_tol: float = 1e-6) -> SimResult:
    """Assert the lowered schedule agrees with the discrete-event simulator.

    1. every stage executes exactly M forwards + M backwards,
    2. the simulator's makespan on a unit-cost copy of the plan equals the
       lowered schedule's tick count (two independent implementations of
       the same dependency rules),
    3. peak resident activations per stage equal ``min(max(1, K_p), M)`` —
       the O(K_p) 1F1B memory bound — and the simulator's per-device peak
       bytes stay within the Eq. (3) budget the lowering derives,
    4. the plan's stage latencies are Eq. (8): the max over the group of
       per-device times priced at the *allocated* sample counts (catches
       plans whose steps went stale against their allocations),
    5. the simulator's per-device busy times scale with allocated samples —
       ``M * (t_f(d, y_d) + t_b(d, y_d))`` exactly — and never exceed the
       lockstep stage busy time.
    Returns the (real-cost) simulation for further inspection.
    """
    M, P = lowered.n_micro, lowered.stage
    sim = simulate(plan, profile, policy)

    ops_per_stage = [0] * P
    for (_, _, p, _) in sim.trace:
        ops_per_stage[p] += 1
    assert ops_per_stage == [2 * M] * P, (ops_per_stage, M)

    unit = simulate(_unitize(plan), profile, policy)
    ticks = lowered.tick_makespan(policy)
    assert abs(unit.makespan - ticks) <= rel_tol * ticks, \
        (unit.makespan, ticks)

    inflight = lowered.peak_inflight(policy)
    expected = tuple(min(max(1, k), M) for k in lowered.warmup)
    assert inflight == expected, (inflight, expected)

    bound = lowered.memory_bound(profile)
    for d, peak in sim.peak_mem.items():
        assert peak <= bound[d] * (1 + rel_tol), (d, peak, bound[d])

    exec_steps = [s for s in plan.steps if s.kind == "exec"]
    for p, st in enumerate(exec_steps):
        i, j = st.layers
        ef = max(profile.t_fwd(d, y, i, j) for d, y in zip(st.group, st.alloc))
        eb = max(profile.t_bwd(d, y, i, j) for d, y in zip(st.group, st.alloc))
        assert abs(st.ef - ef) <= rel_tol * max(ef, 1e-12), (p, st.ef, ef)
        assert abs(st.eb - eb) <= rel_tol * max(eb, 1e-12), (p, st.eb, eb)
        for d, y in zip(st.group, st.alloc):
            t_dev = M * (profile.t_fwd(d, y, i, j) + profile.t_bwd(d, y, i, j))
            assert abs(sim.device_busy[d] - t_dev) <= \
                rel_tol * max(t_dev, 1e-12), (d, sim.device_busy[d], t_dev)
            assert sim.device_busy[d] <= sim.stage_busy[p] * (1 + rel_tol), \
                (d, p, sim.device_busy[d], sim.stage_busy[p])
    return sim


# ---------------------------------------------------------------------------
# Runtime bridge
# ---------------------------------------------------------------------------


def plan_to_train_step(plan: Plan, profile: Profile | None, cfg,
                       model_axis: int | None = None, *, check: bool = True,
                       **kw):
    """Build a runnable one-card train step from an Asteroid ``Plan``.

    Returns ``(TrainStep, LoweredPlan)``.  ``model_axis`` is the size of the
    virtual model axis the plan was made for (``repro`` reads it off its
    production mesh); it defaults to the plan's stage count.  When
    ``profile`` is given and ``check`` is True, the lowered schedule is
    cross-checked against the simulator before anything is built.  ``kw``
    goes to ``runtime.train.build_train_step_from_lowered`` (``optimizer``,
    ``compress``, ``device``, ...).
    """
    from repro_torch.runtime.train import build_train_step_from_lowered

    if model_axis is None:
        model_axis = len(plan.stages)
    lowered = lower_plan(plan, cfg, model_axis)
    if check and profile is not None:
        check_against_simulator(lowered, plan, profile)

    try:
        ts = build_train_step_from_lowered(cfg, model_axis, lowered, **kw)
    except ValueError as e:
        raise LoweringError(str(e)) from e
    return ts, lowered
