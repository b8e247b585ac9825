"""§3.4 pipeline replay, generalized to elastic membership.

The paper's replay only shrinks the mesh: a device fails and survivors
absorb its layers.  Real edge fleets are elastic — phones land on chargers
and join, throttled boards drain gracefully, preempted devices leave with
warning — so the failure-specific coordinator is one *event handler* of a
general ``MembershipController`` driven by typed membership events:

* ``DeviceFailed``   — the paper's §3.4 crash path: heartbeat-guided
  detection (missed deadline -> probe -> confirm), lightweight layer-wise
  re-planning, concurrent boundary migration, backup restore of the fully
  failed stage.
* ``DeviceJoined``   — scale-out admission: the newcomer (profiled on
  arrival, analytic fallback) is priced into incremental candidate
  placements (``admission_replay``) and accepted only when the re-priced
  plan beats the incumbent by a hysteresis margin.  FTPipeHD handles
  dynamic membership by periodic *full* weight redistribution; here the
  pure-gather migration moves only what the new cuts displace.
* ``DeviceDraining`` — graceful departure: the leaver keeps serving while
  its layers stream off (``departure_replay``), so the pipeline stalls only
  for the re-plan — no detection latency, no backup restore.
* ``DeviceEvicted``  — immediate planned removal: same re-plan as a drain
  but the pipeline pauses for the migration.

Mechanisms shared by the handlers, faithful to the paper:

1. **Heartbeat-guided failure detection** — every device emits heartbeats;
   a missed deadline triggers a probe; an unanswered probe confirms.
2. **Topology-driven model replication** — single-device stages back up
   their stage model to a *backup node* in the next stage (last stage wraps
   to the first); multi-device stages are implicitly replicated by their DP
   peers.  Periodic checkpoint traffic is charged to the D2D links.
3. **Layer-wise lightweight re-planning** — instead of rerunning
   Algorithm 2, the (remaining or extended) stages re-split the layer range
   proportionally to their aggregate computing capacity (FLOPs-based), and
   adjacent stages migrate boundary layers *concurrently*.

The controller drives a live executor
(``repro_torch.runtime.session.PipelineSession``) through the same
transitions the analytical model charges time for.  The heavy-rescheduling
baseline (aggregate → re-plan → redistribute) is also implemented for the
Fig. 16/17 comparison.  ``ReplayCoordinator`` remains as a compatibility
alias of ``MembershipController``.

A whole copy of ``repro.core.replay`` (framework-free), its imports
pointing at the port's own ``core/``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from .allocation import AllocationError, allocate_microbatch
from .costmodel import Step, allreduce_time, hpp_round_latency, kp_policy
from .hardware import DeviceProfile
from .lowering import DIRECT_SOURCE
from .planner import Plan, StagePlan, _comm_step, plan_hpp
from .profiler import Profile

HEARTBEAT_PERIOD = 0.5        # s
HEARTBEAT_TIMEOUT = 2.0       # missed-deadline threshold
PROBE_TIMEOUT = 1.0

# A join is admitted only when the re-priced plan beats the incumbent's
# HPP-Round latency by this margin — churn whose gain is smaller than the
# re-plan + migration it triggers is rejected.
ADMISSION_HYSTERESIS = 0.05

# Heavy rescheduling re-plans on the strongest *surviving* edge device; our
# planner executes on this host, so its wall time is scaled to Jetson-NX
# speed (calibrated at 8x host/NX planner throughput) for derived ratios.
JETSON_REPLAN_SCALE = 8.0


# ---------------------------------------------------------------------------
# Typed membership events
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """Base class for the controller's typed membership events."""


@dataclasses.dataclass(frozen=True)
class DeviceFailed(MembershipEvent):
    """Unplanned crash: detection latency + backup restore apply."""

    rank: int


@dataclasses.dataclass(frozen=True)
class DeviceJoined(MembershipEvent):
    """A newcomer offers itself; admission is hysteresis-gated.

    ``arrival``: the newcomer's measured on-arrival sweep (a
    ``core.profiler.MeasuredProfile``); ``None`` means price it with the
    analytic FLOP model of ``device``."""

    device: DeviceProfile
    arrival: object | None = None
    hysteresis: float = ADMISSION_HYSTERESIS


@dataclasses.dataclass(frozen=True)
class DeviceDraining(MembershipEvent):
    """Graceful departure: the leaver serves while its layers stream off."""

    rank: int


@dataclasses.dataclass(frozen=True)
class DeviceEvicted(MembershipEvent):
    """Immediate planned removal: the pipeline pauses for the migration."""

    rank: int


@dataclasses.dataclass(frozen=True)
class BackupAssignment:
    """stage -> backup device rank holding its replica."""

    backup_of_stage: dict[int, int]
    checkpoint_bytes: dict[int, float]


def assign_backups(plan: Plan, profile: Profile) -> BackupAssignment:
    """Topology-driven replication (Fig. 9 left)."""
    stages = plan.stages
    P = len(stages)
    backup: dict[int, int] = {}
    ckpt: dict[int, float] = {}
    for p, st in enumerate(stages):
        if len(st.group) > 1:
            continue                       # DP peers already replicate
        nxt = stages[(p + 1) % P]
        backup[p] = nxt.group[0]
        ckpt[p] = profile.table.param_bytes(*st.layers)
    return BackupAssignment(backup, ckpt)


def checkpoint_cost(assign: BackupAssignment, profile: Profile) -> float:
    """Seconds to push one round of stage-model checkpoints."""
    if not assign.checkpoint_bytes:
        return 0.0
    return max(b / profile.cluster.bandwidth for b in assign.checkpoint_bytes.values())


# ---------------------------------------------------------------------------
# Failure detection (simulated clock)
# ---------------------------------------------------------------------------


def detection_latency(fail_time: float, heartbeat_period: float = HEARTBEAT_PERIOD,
                      timeout: float = HEARTBEAT_TIMEOUT,
                      probe_timeout: float = PROBE_TIMEOUT) -> float:
    """Time from failure to confirmed detection."""
    # last heartbeat was at the period boundary before the failure
    last_beat = math.floor(fail_time / heartbeat_period) * heartbeat_period
    deadline = last_beat + heartbeat_period + timeout
    return (deadline - fail_time) + probe_timeout


class MembershipController:
    """Membership state machine over a simulated clock.

    Crash path (the paper's §3.4 replay, one event handler among four):

    monitoring --missed deadline--> probing --probe timeout--> confirmed
    --> replanning --> migrating --> resuming --> monitoring

    Planned transitions take the same spine without detection:

    monitoring --DeviceJoined-->   admitting (--> rejected) --> migrating
    monitoring --DeviceDraining--> draining                 --> migrating
    monitoring --DeviceEvicted-->  evicting                 --> migrating
                ... --> resuming --> monitoring

    Callers feed ``heartbeat(rank, now)`` and advance failure detection
    with ``poll(now)``; ``handle(event, executor, now)`` dispatches a typed
    ``MembershipEvent`` to its handler, which drives an *executor* through
    plan -> migrate -> resume, stamping each transition with the report's
    own component costs.  The executor protocol: ``replan(failed_rank)``
    (crash), ``admit_replan(event) -> AdmissionDecision``,
    ``drain_replan(rank)`` / ``evict_replan(rank)`` -> ``RecoveryReport``,
    plus ``migrate(report)`` and ``resume(report, migration)`` shared by
    every path.  The live executor is
    ``repro_torch.runtime.session.PipelineSession``; tests drive the machine with
    a scripted clock.
    """

    def __init__(self, ranks, heartbeat_period: float = HEARTBEAT_PERIOD,
                 timeout: float = HEARTBEAT_TIMEOUT,
                 probe_timeout: float = PROBE_TIMEOUT, now: float = 0.0):
        self.heartbeat_period = heartbeat_period
        self.timeout = timeout
        self.probe_timeout = probe_timeout
        self.last_beat = {r: now for r in ranks}
        self.state = "monitoring"
        self.suspect: int | None = None
        self._probe_sent = 0.0
        self.events: list[tuple[str, float, int | None]] = [
            ("monitoring", now, None)]
        # called as auction_hook(kind, rank) after every COMPLETED plan swap
        # (crash recovery, accepted join, drain, evict) — rejected
        # admissions change nothing, so they don't fire.  The portfolio
        # session registers a callback here to re-arbitrate the post-churn
        # analytic replan against the runner-up with a cheap 2-candidate
        # probation (DESIGN.md §12) instead of trusting the cost model.
        self.auction_hook = None

    def _post_swap(self, kind: str, rank: int | None) -> None:
        if self.auction_hook is not None:
            self.auction_hook(kind, rank)

    def _transition(self, state: str, now: float, rank: int | None = None):
        self.state = state
        self.events.append((state, now, rank))

    def heartbeat(self, rank: int, now: float) -> None:
        if rank in self.last_beat:
            self.last_beat[rank] = max(self.last_beat[rank], now)

    def poll(self, now: float) -> int | None:
        """Advance failure detection; returns a rank once it is confirmed."""
        if self.state == "monitoring":
            for r, t in sorted(self.last_beat.items()):
                if now - t > self.heartbeat_period + self.timeout:
                    self.suspect, self._probe_sent = r, now
                    self._transition("probing", now, r)
                    break
        if self.state == "probing":
            if self.last_beat[self.suspect] > self._probe_sent:
                self._transition("monitoring", now)   # probe answered
                self.suspect = None
            elif now - self._probe_sent >= self.probe_timeout:
                rank = self.suspect
                self._transition("confirmed", now, rank)
                return rank
        return None

    # -- event dispatch ------------------------------------------------------

    def handle(self, event: MembershipEvent, executor, now: float = 0.0):
        """Dispatch a typed membership event to its handler.

        Returns what the handler returns: ``(RecoveryReport, migration)``
        for failures and departures, ``(AdmissionDecision, migration |
        None)`` for joins."""
        if isinstance(event, DeviceFailed):
            return self.run_recovery(event.rank, executor, now=now)
        if isinstance(event, DeviceJoined):
            return self._on_joined(event, executor, now)
        if isinstance(event, DeviceDraining):
            return self._on_departing(event.rank, executor, now,
                                      graceful=True)
        if isinstance(event, DeviceEvicted):
            return self._on_departing(event.rank, executor, now,
                                      graceful=False)
        raise TypeError(f"unknown membership event {type(event).__name__}")

    def run_recovery(self, failed_rank: int, executor, now: float = 0.0):
        """DeviceFailed handler: drive replan -> migrate -> resume.

        Requires a *confirmed* failure (heartbeat -> probe walked first).
        Returns ``(RecoveryReport, migration)`` where ``migration`` is
        whatever ``executor.migrate`` produced.
        """
        if self.state != "confirmed":
            raise RuntimeError(f"recovery requires a confirmed failure "
                               f"(state={self.state})")
        self.last_beat.pop(failed_rank, None)
        self.suspect = None
        self._transition("replanning", now, failed_rank)
        report = executor.replan(failed_rank)
        t = now + report.replan_s
        self._transition("migrating", t, failed_rank)
        migration = executor.migrate(report)
        t += report.migration_s + report.restore_s
        self._transition("resuming", t, failed_rank)
        executor.resume(report, migration)
        self._transition("monitoring", t, None)
        self._post_swap("failed", failed_rank)
        return report, migration

    def _on_joined(self, event: DeviceJoined, executor, now: float):
        """DeviceJoined handler: hysteresis-gated admission.

        A rejection returns to monitoring after the pricing work alone; an
        accepted join migrates (boundary moves + any DP-peer replica push)
        and registers the new plan's ranks for heartbeats."""
        if self.state != "monitoring":
            raise RuntimeError(f"admission requires a quiet controller "
                               f"(state={self.state})")
        self._transition("admitting", now, None)
        decision = executor.admit_replan(event)
        t = now + decision.replan_s
        if not decision.accepted:
            self._transition("rejected", t, None)
            self._transition("monitoring", t, None)
            return decision, None
        report = decision.report
        self._transition("migrating", t, None)
        migration = executor.migrate(report)
        t += report.migration_s + report.replicate_s
        self._transition("resuming", t, None)
        executor.resume(report, migration)
        for st in report.new_plan.stages:
            for d in st.group:
                self.last_beat.setdefault(d, t)
        self._transition("monitoring", t, None)
        self._post_swap("joined", None)
        return decision, migration

    def _on_departing(self, rank: int, executor, now: float, *,
                      graceful: bool):
        """DeviceDraining / DeviceEvicted handler.

        No detection and no restore — the leaver is alive.  A graceful
        drain's migration overlaps continued serving, so the resuming
        timestamp advances by the re-plan only; an evict pauses for the
        migration like the crash path does."""
        if self.state != "monitoring":
            raise RuntimeError(f"departure requires a quiet controller "
                               f"(state={self.state})")
        self._transition("draining" if graceful else "evicting", now, rank)
        report = (executor.drain_replan(rank) if graceful
                  else executor.evict_replan(rank))
        t = now + report.replan_s
        self._transition("migrating", t, rank)
        migration = executor.migrate(report)
        if not report.overlapped:
            t += report.migration_s + report.restore_s
        self._transition("resuming", t, rank)
        executor.resume(report, migration)
        self.last_beat.pop(rank, None)
        self._transition("monitoring", t, None)
        self._post_swap("drained" if graceful else "evicted", rank)
        return report, migration


# The failure-only coordinator this controller generalizes; kept as an
# alias so existing imports and the paper-facing §3.4 name keep working.
ReplayCoordinator = MembershipController


# ---------------------------------------------------------------------------
# Lightweight layer-wise re-planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoundaryMove:
    """Weights crossing one boundary of the *new* plan during migration."""

    boundary: int                  # between new stages boundary, boundary+1
    lo: int                        # table-layer hull [lo, hi) of moved layers
    hi: int
    nbytes: float                  # exact bytes crossing this boundary
    link_bw: float                 # D2D bandwidth of the boundary link


@dataclasses.dataclass(frozen=True)
class DirectMove:
    """Weights streamed straight from an off-plan source (a draining or
    evicted leaver) to one new owner stage — no boundary hops."""

    src_rank: int                  # the leaver's cluster rank
    dst_rank: int                  # the receiving stage's lead device
    lo: int                        # table-layer range [lo, hi) streamed
    hi: int
    nbytes: float
    link_bw: float                 # bw(src_rank, dst_rank)


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """Analytical timing of one membership transition.

    ``mode``: "lightweight" | "heavy" (crash paths), "admission" (join),
    "drain" | "evict" (planned departures).  ``overlapped`` marks a
    graceful drain whose migration streams while the pipeline keeps
    serving; ``replicate_s`` charges the stage-model replica a DP-peer
    admission pushes onto the newcomer."""

    detection_s: float
    replan_s: float
    migration_s: float
    restore_s: float
    new_plan: Plan
    mode: str
    boundary_moves: tuple[BoundaryMove, ...] = ()
    direct_moves: tuple[DirectMove, ...] = ()
    replicate_s: float = 0.0
    overlapped: bool = False

    @property
    def total_s(self) -> float:
        return (self.detection_s + self.replan_s + self.migration_s
                + self.restore_s + self.replicate_s)

    @property
    def stall_s(self) -> float:
        """Time the pipeline is not producing.  An overlapped (graceful
        drain) migration streams concurrently with serving, so only the
        re-plan and any restore stall the round."""
        if self.overlapped:
            return self.detection_s + self.replan_s + self.restore_s
        return self.total_s


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of pricing a ``DeviceJoined`` event.

    ``report`` is set only when the join was accepted; a rejection still
    records how close the best candidate came, so churn benchmarks and the
    session's membership log can account for admission work."""

    accepted: bool
    report: RecoveryReport | None
    incumbent_latency: float
    candidate_latency: float
    hysteresis: float
    replan_s: float
    reason: str


def _stage_capacity(profile: Profile, group, i: int, j: int, mb: int) -> float:
    """Aggregate computing capacity sum_d v_d (Eq. 9) of a group."""
    return sum(1.0 / max(profile.t_both(d, mb, i, j), 1e-12) for d in group)


def _snap_cuts(cuts: list[int], quantum: int, L: int) -> list[int]:
    """Snap interior table-layer cuts to period boundaries.

    Mirrors ``lowering._snap_to_periods`` (table layer 1 + r*quantum is the
    boundary after real-layer period r) so a snapped plan lowers to exactly
    these cuts.  Kept strictly monotone with >= 1 period per stage.
    """
    n_layers = L - 2                       # embed + real layers + head
    n_per = n_layers // quantum
    P = len(cuts) - 1
    if P > n_per:
        raise AllocationError(f"{P} stages but only {n_per} periods")
    pers = [0]
    for p in range(P - 1):
        r = min(max(cuts[p + 1] - 1, 0), n_layers)
        per = round(r / quantum)
        per = max(per, pers[-1] + 1)
        per = min(per, n_per - (P - 1 - p))
        pers.append(per)
    return [0] + [1 + per * quantum for per in pers[1:]] + [L]


def _capacity_cuts(profile: Profile, groups, mb: int,
                   layer_quantum: int | None = None) -> list[int]:
    """FLOPs-proportional layer cuts over the groups' aggregate capacities
    (step 2 of lightweight re-planning, Eq. 9 capacities)."""
    table = profile.table
    L = table.L
    P = len(groups)
    caps = [_stage_capacity(profile, g, 0, L, mb) for g in groups]
    total_cap = sum(caps)
    total_flops = table.flops(0, L)
    cuts = [0]
    acc = 0.0
    li = 0
    for p in range(P - 1):
        acc += total_flops * caps[p] / total_cap
        while li < L and table.flops(0, li) < acc:
            li += 1
        cuts.append(min(li, L - (P - 1 - p)))
    cuts.append(L)
    if layer_quantum:
        cuts = _snap_cuts(cuts, layer_quantum, L)
    return cuts


def _boundary_moves(profile: Profile, old_owner, new_owner,
                    groups) -> tuple[float, tuple[BoundaryMove, ...]]:
    """Concurrent adjacent-boundary migration: a layer's weights cross
    boundary p iff its old->new owner path does.

    ``old_owner[l]`` of ``None`` (no surviving owner: restored from backup)
    or a negative sentinel (streamed directly from an off-plan leaver) is
    excluded — those layers never ride the boundary links."""
    table = profile.table
    L = table.L
    P = len(groups)
    migration = 0.0
    moves: list[BoundaryMove] = []
    for p in range(P - 1):
        crossing = [l for l in range(L)
                    if old_owner[l] is not None and old_owner[l] >= 0
                    and min(old_owner[l], new_owner[l]) <= p
                    < max(old_owner[l], new_owner[l])]
        link_bw = profile.cluster.bw(groups[p][0], groups[p + 1][0])
        if crossing:
            nbytes = sum(table.layers[l].param_bytes for l in crossing)
            moves.append(BoundaryMove(p, min(crossing), max(crossing) + 1,
                                      nbytes, link_bw))
            migration = max(migration, nbytes / link_bw)   # concurrent
    return migration, tuple(moves)


def _plan_from_cuts(plan: Plan, profile: Profile, groups, cuts,
                    planner: str = "replay") -> Plan:
    """Re-run Algorithm 1 within each stage and price the new chain.

    The rebuilt pipeline inherits the incumbent plan's gradient-sync
    semantics (a replayed async session stays async)."""
    table = profile.table
    mb = plan.micro_batch
    P = len(groups)
    new_stages = []
    steps: list[Step] = []
    for p in range(P):
        i, j = cuts[p], cuts[p + 1]
        alloc = allocate_microbatch(profile, groups[p], mb, i, j,
                                    kp_policy(P, p))
        ta = allreduce_time(table.param_bytes(i, j), groups[p],
                            profile.cluster)
        steps.append(Step("exec", alloc.ef, alloc.eb, ta, groups[p],
                          (i, j), alloc.y))
        new_stages.append(StagePlan((i, j), groups[p], alloc.y,
                                    kp_policy(P, p)))
        if p < P - 1:
            steps.append(_comm_step(profile, mb, j, groups[p],
                                    groups[p + 1]))
    lat = hpp_round_latency(tuple(steps), plan.n_micro,
                            getattr(plan, "staleness", 0))
    return Plan(plan.arch, tuple(new_stages), tuple(steps), mb,
                plan.n_micro, lat, planner,
                staleness=getattr(plan, "staleness", 0))


def _drop_rank(stages, rank: int):
    """Remove ``rank`` from every stage group; returns the surviving
    stages and a map from original stage index to survivor index (missing
    = the whole stage left with ``rank``)."""
    survivors: list[StagePlan] = []
    surv_of_orig: dict[int, int] = {}
    for q, st in enumerate(stages):
        group = tuple(d for d in st.group if d != rank)
        if group:
            surv_of_orig[q] = len(survivors)
            survivors.append(StagePlan(st.layers, group, st.alloc, st.k_p))
    return survivors, surv_of_orig


def lightweight_replay(plan: Plan, profile: Profile, failed_rank: int,
                       fail_time: float = 10.0,
                       layer_quantum: int | None = None) -> RecoveryReport:
    """Layer-wise lightweight re-planning after ``failed_rank`` crashes.

    ``layer_quantum``: when re-planning for the period-granular runtime
    (``core.lowering``), snap the new cuts to period boundaries (= the
    model's pattern length in table layers) so the analytical migration
    inputs coincide exactly with what ``migrate_params`` moves.
    """
    t0 = time.perf_counter()
    table = profile.table
    stages = list(plan.stages)
    mb = plan.micro_batch
    L = table.L

    # 1) drop the failed device, remembering each original stage's survivor
    #    index (None = the whole stage failed: restored, not migrated).
    survivors, surv_of_orig = _drop_rank(stages, failed_rank)
    P = len(survivors)
    if P == 0:
        raise RuntimeError("no surviving devices")
    groups = [st.group for st in survivors]

    # 2) FLOPs-proportional re-partition over surviving stages' capacities
    cuts = _capacity_cuts(profile, groups, mb, layer_quantum)

    # 3) per-layer ownership among the *survivors*.  Old ownership follows
    #    the ORIGINAL plan partition (so a fully-failed stage's range is not
    #    silently attributed to a neighbour); its layers have no surviving
    #    owner — they are restored from backup, not migrated.
    old_owner: list[int | None] = [None] * L
    for q, st in enumerate(stages):
        so = surv_of_orig.get(q)
        for l in range(*st.layers):
            old_owner[l] = so
    new_owner = [0] * L
    for p in range(P):
        for l in range(cuts[p], cuts[p + 1]):
            new_owner[l] = p

    # 4) concurrent layer migration between adjacent stages
    migration, moves = _boundary_moves(profile, old_owner, new_owner, groups)

    # 5) restore a fully-failed single-device stage's weights from its
    #    backup node *directly to their new owners*, over the actual backup
    #    links (concurrent pushes; a push to the backup holder's own new
    #    stage is local and free).
    assign = assign_backups(plan, profile)
    restore = 0.0
    for q, st in enumerate(stages):
        if failed_rank in st.group and len(st.group) == 1:
            backup_rank = assign.backup_of_stage.get(q)
            if backup_rank is None:
                continue
            for p in range(P):
                lo = max(st.layers[0], cuts[p])
                hi = min(st.layers[1], cuts[p + 1])
                if lo >= hi or backup_rank in survivors[p].group:
                    continue
                nbytes = table.param_bytes(lo, hi)
                bw = profile.cluster.bw(backup_rank, survivors[p].group[0])
                restore = max(restore, nbytes / bw)

    # 6) build the new plan (re-run Algorithm 1 within each stage)
    new_plan = _plan_from_cuts(plan, profile, groups, cuts)
    replan_s = time.perf_counter() - t0
    return RecoveryReport(detection_latency(fail_time), replan_s, migration,
                          restore, new_plan, "lightweight", moves)


def departure_replay(plan: Plan, profile: Profile, rank: int, *,
                     graceful: bool,
                     layer_quantum: int | None = None) -> RecoveryReport:
    """Planned departure of ``rank`` (drain when ``graceful``, else evict).

    Same FLOPs-proportional re-split as the crash path, but the leaver is
    *alive*: no detection latency, and a fully-departed stage's layers
    stream straight off the leaver to their new owners (``DirectMove``)
    instead of being restored from a backup node.  A graceful drain's
    migration overlaps continued serving (``overlapped=True``), so only
    the re-plan stalls the pipeline; an evict pauses like a crash does.
    """
    t0 = time.perf_counter()
    table = profile.table
    stages = list(plan.stages)
    mb = plan.micro_batch
    L = table.L

    survivors, surv_of_orig = _drop_rank(stages, rank)
    P = len(survivors)
    if P == 0:
        raise RuntimeError("no surviving devices")
    groups = [st.group for st in survivors]
    cuts = _capacity_cuts(profile, groups, mb, layer_quantum)

    # Old ownership follows the ORIGINAL partition; a fully-departed
    # stage's layers carry the DIRECT_SOURCE sentinel — they ride
    # leaver->owner links, not the boundary chain.
    old_owner: list[int | None] = [None] * L
    for q, st in enumerate(stages):
        so = surv_of_orig.get(q)
        for l in range(*st.layers):
            old_owner[l] = so if so is not None else DIRECT_SOURCE
    new_owner = [0] * L
    for p in range(P):
        for l in range(cuts[p], cuts[p + 1]):
            new_owner[l] = p

    migration, moves = _boundary_moves(profile, old_owner, new_owner, groups)

    # Direct streams off the leaver (only a stage it held alone needs them;
    # a DP peer's replicas already live on the survivors).  Concurrent with
    # each other and with the boundary moves.
    direct: list[DirectMove] = []
    for q, st in enumerate(stages):
        if rank in st.group and len(st.group) == 1:
            for p in range(P):
                lo = max(st.layers[0], cuts[p])
                hi = min(st.layers[1], cuts[p + 1])
                if lo >= hi:
                    continue
                nbytes = table.param_bytes(lo, hi)
                bw = profile.cluster.bw(rank, survivors[p].group[0])
                direct.append(DirectMove(rank, survivors[p].group[0],
                                         lo, hi, nbytes, bw))
                migration = max(migration, nbytes / bw)

    new_plan = _plan_from_cuts(plan, profile, groups, cuts)
    replan_s = time.perf_counter() - t0
    return RecoveryReport(0.0, replan_s, migration, 0.0, new_plan,
                          "drain" if graceful else "evict", moves,
                          direct_moves=tuple(direct), overlapped=graceful)


def admission_replay(plan: Plan, profile: Profile, new_rank: int, *,
                     hysteresis: float = ADMISSION_HYSTERESIS,
                     layer_quantum: int | None = None,
                     allowed_stages=None) -> AdmissionDecision:
    """Price a newcomer into the pipeline; accept only past hysteresis.

    ``profile`` must already include the newcomer as rank ``new_rank``
    (see ``profiler.extend_profile``).  Two incremental candidate families
    are priced — FTPipeHD would instead redistribute every weight:

    * **DP peer**: the newcomer joins an existing stage's data-parallel
      group; its stage model is *replicated* onto it from an incumbent
      member (``replicate_s``), and the FLOPs-proportional re-cut may
      shift boundaries (priced as boundary moves).
    * **Own stage**: the newcomer becomes a fresh stage at each insert
      position; it owns no layers yet, so everything it picks up rides
      the boundary chain onto it.

    ``allowed_stages`` restricts candidate stage counts (e.g. divisors of
    a runtime mesh's model axis, so the result stays lowerable).
    """
    t0 = time.perf_counter()
    table = profile.table
    stages = list(plan.stages)
    mb = plan.micro_batch
    L = table.L
    P0 = len(stages)

    def price(groups, old_to_new, newcomer_stage):
        """Price one candidate arrangement; returns (latency, report)."""
        cuts = _capacity_cuts(profile, groups, mb, layer_quantum)
        old_owner: list[int | None] = [None] * L
        for q, st in enumerate(stages):
            for l in range(*st.layers):
                old_owner[l] = old_to_new[q]
        new_owner = [0] * L
        for p in range(len(groups)):
            for l in range(cuts[p], cuts[p + 1]):
                new_owner[l] = p
        migration, moves = _boundary_moves(profile, old_owner, new_owner,
                                           groups)
        replicate = 0.0
        if newcomer_stage is not None:
            i, j = cuts[newcomer_stage], cuts[newcomer_stage + 1]
            src = next(d for d in groups[newcomer_stage] if d != new_rank)
            replicate = table.param_bytes(i, j) / profile.cluster.bw(
                src, new_rank)
        cand = _plan_from_cuts(plan, profile, groups, cuts)
        report = RecoveryReport(0.0, 0.0, migration, 0.0, cand,
                                "admission", moves, replicate_s=replicate)
        return cand.latency, report

    candidates: list[tuple[float, RecoveryReport, str]] = []
    # DP peer of each existing stage
    if allowed_stages is None or P0 in allowed_stages:
        for p in range(P0):
            groups = [st.group + ((new_rank,) if q == p else ())
                      for q, st in enumerate(stages)]
            try:
                lat, rep = price(groups, {q: q for q in range(P0)}, p)
                candidates.append((lat, rep, f"dp-peer of stage {p}"))
            except (AllocationError, RuntimeError):
                continue
    # Own stage at each insert position
    if allowed_stages is None or P0 + 1 in allowed_stages:
        for q_ins in range(P0 + 1):
            groups = ([st.group for st in stages[:q_ins]] + [(new_rank,)]
                      + [st.group for st in stages[q_ins:]])
            old_to_new = {q: (q if q < q_ins else q + 1) for q in range(P0)}
            try:
                lat, rep = price(groups, old_to_new, None)
                candidates.append((lat, rep,
                                   f"own stage at position {q_ins}"))
            except (AllocationError, RuntimeError):
                continue

    replan_s = time.perf_counter() - t0
    if not candidates:
        return AdmissionDecision(False, None, plan.latency, math.inf,
                                 hysteresis, replan_s,
                                 "no feasible candidate placement")
    lat, report, desc = min(candidates, key=lambda c: c[0])
    threshold = plan.latency * (1.0 - hysteresis)
    if lat >= threshold:
        return AdmissionDecision(
            False, None, plan.latency, lat, hysteresis, replan_s,
            f"best candidate ({desc}) at {lat:.4f}s does not beat the "
            f"incumbent's {plan.latency:.4f}s by the {hysteresis:.0%} "
            f"hysteresis margin")
    report = dataclasses.replace(report, replan_s=replan_s)
    return AdmissionDecision(True, report, plan.latency, lat, hysteresis,
                             replan_s, f"accepted as {desc}")


def heavy_rescheduling(plan: Plan, profile: Profile, failed_rank: int,
                       fail_time: float = 10.0,
                       replan_compute_scale: float = JETSON_REPLAN_SCALE,
                       allowed_stages=None) -> RecoveryReport:
    """Straw-man baseline: aggregate stage models to the coordinator, re-run
    Algorithm 2 from scratch, redistribute all weights.

    ``allowed_stages`` restricts the re-planned stage count (e.g. divisors
    of a runtime mesh's model axis, so the result stays lowerable)."""
    from .hardware import Cluster

    table = profile.table
    bw = profile.cluster.bandwidth

    # 1) aggregate every stage model to the coordinator (serialized in/out)
    aggregate = sum(table.param_bytes(*st.layers) for st in plan.stages) / bw

    # 2) full re-planning on the strongest surviving device
    devs = [d for i, d in enumerate(profile.cluster.devices) if i != failed_rank]
    sub_cluster = Cluster(tuple(devs), profile.cluster.bandwidth)
    sub_profile = Profile.analytic(table, sub_cluster, profile.max_batch)
    t0 = time.perf_counter()
    new_plan = plan_hpp(sub_profile, plan.global_batch, plan.micro_batch,
                        arch=plan.arch, allowed_stages=allowed_stages,
                        staleness=getattr(plan, "staleness", 0))
    replan = (time.perf_counter() - t0) * replan_compute_scale

    # sub-cluster ranks -> the original cluster's rank space, so the new
    # plan stays addressable by the same device identities as the old one
    remap = {i: r for i, r in enumerate(
        r for r in range(len(profile.cluster.devices)) if r != failed_rank)}
    stages = tuple(dataclasses.replace(st, group=tuple(remap[g] for g in st.group))
                   for st in new_plan.stages)
    steps = tuple(dataclasses.replace(s, group=tuple(remap[g] for g in s.group))
                  if s.group else s for s in new_plan.steps)
    new_plan = dataclasses.replace(new_plan, stages=stages, steps=steps)

    # 3) redistribute all stage weights
    redistribute = sum(table.param_bytes(*st.layers) for st in new_plan.stages) / bw

    return RecoveryReport(detection_latency(fail_time), replan,
                          aggregate + redistribute, 0.0, new_plan, "heavy")
