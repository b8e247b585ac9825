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

The *replay* half makes a lowered pipeline re-lowerable while training:
``relower`` lowers a replacement ``Plan`` against an existing
``LoweredPlan``, ``migrate_params`` / ``migrate_opt_state`` carry the
period stack (and the optimizer moments, by the same index map) from the
old stage split to the new one, and ``reconcile_migration`` checks the
per-boundary bytes against the analytical ``RecoveryReport`` a
``lightweight_replay`` produced.

A copy of ``repro.core.lowering``'s framework-free part and its replay
half.  ``repro``'s replay indices address its zero-padded arranged stack
(stage p's slice ``[p*k, (p+1)*k)``); the port's runtime keeps the period
stack in model order under every split, stage p owning the rows
``stage_periods[p]`` (``runtime.pipeline``), so a period's row is its
canonical index, the migration gather is the identity, and on one card a
migration moves no rows.  Its report still names the periods and bytes
that change owner: what a run over several cards would move.
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
# Live replay: re-lowering and parameter migration
# ---------------------------------------------------------------------------


def relower(old: LoweredPlan, new_plan: Plan, cfg,
            model_axis: int | None = None) -> LoweredPlan:
    """Lower ``new_plan`` as a replacement for ``old`` on the same runtime.

    Beyond ``lower_plan``'s own checks, validates that the two lowered plans
    describe the same model and micro-batch structure, so the period stack
    (and optimizer state) can be migrated rather than re-initialized.
    """
    if old.arch and new_plan.arch and old.arch != new_plan.arch:
        raise LoweringError(f"arch changed across replay: {old.arch!r} -> "
                            f"{new_plan.arch!r}")
    new = lower_plan(new_plan, cfg, model_axis)
    if new.n_periods != old.n_periods:
        raise LoweringError(f"period count changed: {old.n_periods} -> "
                            f"{new.n_periods}")
    if new.global_batch != old.global_batch or new.n_micro != old.n_micro:
        raise LoweringError(
            f"batch structure changed: (B={old.global_batch}, M={old.n_micro})"
            f" -> (B={new.global_batch}, M={new.n_micro})")
    return new


def snap_plan(plan: Plan, lowered: LoweredPlan, L: int) -> Plan:
    """``plan`` with stage layer ranges snapped to what was deployed.

    Lowering snaps layer cuts to period boundaries; the plan the runtime
    actually executes therefore owns the *snapped* ranges.  The returned
    plan (stage ranges and exec-step ranges rewritten; costs kept as the
    planner's estimates) is what a session should feed back into
    ``lightweight_replay`` so old-ownership accounting matches reality.
    """
    plen = (L - 2) // lowered.n_periods
    cuts = [0] + [1 + j * plen for _, j in lowered.stage_periods[:-1]] + [L]
    ranges = [(cuts[p], cuts[p + 1]) for p in range(lowered.stage)]
    stages = tuple(dataclasses.replace(st, layers=r)
                   for st, r in zip(plan.stages, ranges))
    ex = iter(ranges)
    steps = tuple(dataclasses.replace(s, layers=next(ex))
                  if s.kind == "exec" else s for s in plan.steps)
    return dataclasses.replace(plan, stages=stages, steps=steps)


def period_owner(lp: LoweredPlan) -> tuple[int, ...]:
    """Owning stage of each canonical period under ``lp``'s split."""
    out = [0] * lp.n_periods
    for p, (i, j) in enumerate(lp.stage_periods):
        for t in range(i, j):
            out[t] = p
    return tuple(out)


def period_positions(lp: LoweredPlan) -> dict[int, int]:
    """canonical period -> row in ``lp``'s period stack.

    The single source of truth for the stack's layout: migration, backup
    restore and the bit-identity checks index through it.  The port's stack
    is in model order under every split (stage p owns rows
    ``stage_periods[p]``), so the row is the period itself.
    """
    return {t: t for i, j in lp.stage_periods for t in range(i, j)}


def migration_index(old: LoweredPlan, new: LoweredPlan):
    """Gather index mapping the OLD period stack onto the NEW one.

    Returns ``(take, mask)`` such that
    ``new_leaf = where(mask, old_leaf[take], 0)`` (``repro``'s form, whose
    mask zeroes its padding rows).  With both stacks in model order, take is
    ``0 .. n_periods-1`` and the mask all ones.
    """
    pos = period_positions(old)
    take = [pos[t] for i, j in new.stage_periods for t in range(i, j)]
    return take, [1.0] * len(take)


def _check_identity(old: LoweredPlan, new: LoweredPlan) -> None:
    take, _ = migration_index(old, new)
    if take != list(range(new.n_periods)):
        raise LoweringError(f"stage splits {old.stage_periods} -> "
                            f"{new.stage_periods} do not keep the periods in "
                            "model order")


# ``old_owner`` sentinel for migrate_params: the period's old holder is not
# any stage of the new plan — it streams *directly* from an off-plan source
# (a draining/evicted leaver pushing its layers out, symmetric to a restore
# but from live state) instead of hopping adjacent-stage boundaries.
DIRECT_SOURCE = -1


@dataclasses.dataclass(frozen=True)
class MigrationReport:
    """What ``migrate_params`` moved, per boundary of the NEW plan."""

    moved_periods: tuple[int, ...]            # canonical indices that moved
    restored_periods: tuple[int, ...]         # restored from backup instead
    boundary_periods: tuple[tuple[int, ...], ...]   # per new-plan boundary
    boundary_bytes: tuple[float, ...]         # actual array bytes crossing
    period_bytes: float                       # bytes of one period's params
    total_bytes: float
    direct_periods: tuple[int, ...] = ()      # streamed off an off-plan source
    direct_bytes: float = 0.0


def migrate_params(params, old: LoweredPlan, new: LoweredPlan, *,
                   old_owner=None):
    """Migration of the period stack across a plan swap.

    ``old_owner``: per-canonical-period owner in the NEW plan's stage
    coordinates; ``None`` entries mark periods restored from a backup and
    ``DIRECT_SOURCE`` entries periods streamed off an off-plan source (a
    draining leaver) — both excluded from boundary accounting.  Defaults to
    the old plan's own stage indices, which is exact when the stage count
    is unchanged.

    Returns ``(migrated_params, MigrationReport)``.  The stack is in model
    order on both sides, so the gather is the identity and the returned
    tree holds the same tensors (no row is copied on one card); the report
    counts, per boundary of the new plan, the periods whose owner changed
    and their bytes, as ``repro``'s does.
    """
    from repro_torch.optim import tree_leaves

    _check_identity(old, new)
    out = dict(params)

    if old_owner is None:
        old_owner = period_owner(old)
    new_own = period_owner(new)
    moved = tuple(t for t in range(new.n_periods)
                  if old_owner[t] is not None
                  and old_owner[t] != DIRECT_SOURCE
                  and old_owner[t] != new_own[t])
    direct = tuple(t for t in range(new.n_periods)
                   if old_owner[t] == DIRECT_SOURCE)
    restored = tuple(t for t in range(new.n_periods) if old_owner[t] is None)
    period_bytes = sum(leaf.numel() * leaf.element_size() / leaf.shape[0]
                       for leaf in tree_leaves(params["periods"]))
    boundary_periods: list[tuple[int, ...]] = []
    boundary_bytes: list[float] = []
    for p in range(new.stage - 1):
        crossing = tuple(t for t in moved
                         if min(old_owner[t], new_own[t]) <= p
                         < max(old_owner[t], new_own[t]))
        boundary_periods.append(crossing)
        boundary_bytes.append(period_bytes * len(crossing))
    report = MigrationReport(moved, restored, tuple(boundary_periods),
                             tuple(boundary_bytes), period_bytes,
                             period_bytes * len(moved)
                             + period_bytes * len(direct),
                             direct, period_bytes * len(direct))
    return out, report


def migrate_opt_state(opt_state, old: LoweredPlan, new: LoweredPlan):
    """Optimizer moments follow the params through the SAME index map (the
    identity: the state is returned as it is)."""
    from repro_torch.optim import AdamWState, SGDState

    _check_identity(old, new)
    if not isinstance(opt_state, (AdamWState, SGDState)):
        raise TypeError(type(opt_state))
    return opt_state


def reconcile_migration(mig: MigrationReport, report, new: LoweredPlan,
                        table, pattern_len: int,
                        rel_tol: float = 1e-6) -> dict:
    """Assert ``migrate_params``'s moved bytes match the analytical
    ``RecoveryReport`` migration inputs (a replay run with
    ``layer_quantum=pattern_len`` so its cuts are period-aligned).

    Prices both directions: boundary crossings are checked per boundary of
    the new plan whether the periods flowed toward a survivor (scale-in) or
    onto a freshly admitted stage (scale-out) — the crossing predicate is
    symmetric in old/new owner.  Reports carrying ``direct_moves`` (a
    draining leaver streaming its layers straight to their new owners) are
    additionally reconciled against ``mig.direct_periods``.

    Returns per-boundary ``{analytic_bytes, table_bytes, runtime_bytes}``
    (plus a ``"direct"`` entry when direct streams were priced) where
    ``table_bytes`` re-prices the runtime's moved periods with the
    profiler's layer table — the quantity that must equal the analytical
    bytes exactly.
    """
    def period_table_bytes(periods):
        return sum(
            table.param_bytes(1 + t * pattern_len, 1 + (t + 1) * pattern_len)
            for t in periods)

    analytic = {bm.boundary: bm for bm in report.boundary_moves}
    out: dict = {}
    for p in range(new.stage - 1):
        periods = mig.boundary_periods[p]
        bm = analytic.get(p)
        if bm is None:
            assert not periods, (
                f"runtime moved periods {periods} across boundary {p} but "
                f"the recovery report shows no migration there")
            continue
        hull = set(range((bm.lo - 1) // pattern_len,
                         -(-(bm.hi - 1) // pattern_len)))
        assert set(periods) <= hull, (p, periods, sorted(hull))
        table_bytes = period_table_bytes(periods)
        assert abs(table_bytes - bm.nbytes) <= rel_tol * max(table_bytes, 1.0), (
            f"boundary {p}: runtime periods {periods} price to "
            f"{table_bytes:.0f} B in the layer table, but the recovery "
            f"report migrated {bm.nbytes:.0f} B")
        out[p] = {"analytic_bytes": bm.nbytes, "table_bytes": table_bytes,
                  "runtime_bytes": mig.boundary_bytes[p]}

    direct_moves = getattr(report, "direct_moves", ())
    if mig.direct_periods or direct_moves:
        hull = set()
        for dm in direct_moves:
            hull |= set(range((dm.lo - 1) // pattern_len,
                              -(-(dm.hi - 1) // pattern_len)))
        assert set(mig.direct_periods) <= hull, (
            f"runtime direct-streamed periods {mig.direct_periods} outside "
            f"the report's direct-move hull {sorted(hull)}")
        table_bytes = period_table_bytes(mig.direct_periods)
        # the analytic moves may also carry the leaver's embed/head bytes
        # (table edge pseudo-layers); compare on the real-layer span only
        L = table.L
        analytic_bytes = sum(
            table.param_bytes(max(dm.lo, 1), min(dm.hi, L - 1))
            for dm in direct_moves)
        assert abs(table_bytes - analytic_bytes) <= \
            rel_tol * max(table_bytes, 1.0), (
            f"direct streams: runtime periods {mig.direct_periods} price to "
            f"{table_bytes:.0f} B, but the report streams "
            f"{analytic_bytes:.0f} B of real layers off the leaver")
        out["direct"] = {"analytic_bytes": analytic_bytes,
                         "table_bytes": table_bytes,
                         "runtime_bytes": mig.direct_bytes}
    return out


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
