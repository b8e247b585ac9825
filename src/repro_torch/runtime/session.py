"""Live pipeline replay, elastic membership and the plan portfolio on one
card (paper §3.4, DESIGN.md §12).

The port of ``repro.runtime.session``.  ``PipelineSession`` makes a running
pipeline a re-lowerable object.  It owns the chain

    Plan -> LoweredPlan -> TrainStep -> (params, opt_state)

and keeps training through a membership change without restarting:

1. every ``step()`` advances a simulated cluster clock and feeds heartbeats
   to a ``core.replay.MembershipController``;
2. on a failure (``fail(rank)``), the controller walks its state machine
   (missed heartbeat -> probe -> confirm) and then drives this session as
   its executor: ``replan`` (lightweight layer-wise replay, falling back to
   heavy rescheduling when the survivor stage count is not lowerable),
   ``migrate`` (``core.lowering.migrate_params`` of the period stack and
   the optimizer moments, plus the restore of a failed single-device stage
   from its ``StageBackupStore`` replica), ``resume``;
3. planned transitions take the same barrier: ``admit`` prices a
   hysteresis-gated join (a rejected join changes nothing: plan, step and
   profile stay the same objects), ``drain(rank)`` lets a leaver keep
   serving while its layers stream to the survivors, ``evict(rank)``
   removes it at once; every transition is appended to ``memberships``;
4. single-device stages push their period rows to their topology-assigned
   backup node every ``backup_every`` steps, and every transition re-seeds
   the backups for the *new* arrangement;
5. with ``portfolio_k`` the session auctions plans (``probe_portfolio``):
   every strategy family of ``core.portfolio`` priced on the session
   profile, the top-k lowerable finalists each adopted and timed over a
   short live probation window, the measured winner installed.  A
   completed membership swap queues a 2-candidate auction, and a
   ``DriftWatchdog`` trip a ``portfolio_k``-candidate one, for the next
   ``step()``.

The ``Profile`` handed to the constructor (analytic, or measured from a
``launch.profile`` artifact) is kept for the session's lifetime and reused
by every replan.

On one card the devices of the plan are virtual: the model axis is a label
(``runtime.train.train_spec_from_lowered``), the period stack stays in
model order under every split, so a migration moves no rows
(``core.lowering``), and its report's bytes are what a run over several
cards would move.  A failed device's state is "lost" by contract: the
restore overwrites the failed stage's period rows (parameters only, as in
``repro``) and its edge leaves with the host backup, taken fewer than
``backup_every`` steps earlier.  The step is rebuilt only when the re-lowered
``TrainSpec`` differs (``step_cache_hits`` counts the reuses).

Staleness 1: the session holds the parameter half of the last round's
update (``runtime.train``), where ``repro`` holds its gradient buffer.
Every recovery and transition, and ``_install`` itself, first applies it
(``flush_gradients``): a staleness barrier.  So every path that reads or
moves the optimizer state (migration, backup, ``canonical_leaves``) runs
after a flush, where the port's state equals ``repro``'s.

A probation round times ``grad_fn`` for every finalist, where ``repro``
runs ``step_fn`` for a synchronous one and drops its output
(``_probe_rounds``): the port's optimizer writes parameters and moments in
place, so a literal port would train during probation, and a clone of the
state to probe on is as large as the state (46 GB at full width).  On one
card AdamW costs the same under every finalist, so the ranking among
synchronous finalists is unchanged; what goes is ``repro``'s charge of the
optimizer to synchronous finalists alone.  A compressed finalist brings
its own wire settings (``_plan_spec_kw``): ``CompressionConfig``'s
defaults are error feedback on and one unbounded bucket per free-axes
group, so its probe holds a residual as large as the gradients and copies
of the whole period stack's gradient in the wire, memory that the
planner's check does not price (neither does ``repro``'s).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time as _time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.checkpoint import StageBackupStore
from repro_torch.core.allocation import AllocationError
from repro_torch.core.hardware import DeviceProfile
from repro_torch.core.lowering import (DIRECT_SOURCE, LoweredPlan, LoweringError,
                                       MigrationReport, check_against_simulator,
                                       lower_plan, migrate_opt_state, migrate_params,
                                       period_owner, period_positions,
                                       reconcile_migration, relower, snap_plan)
from repro_torch.core.planner import Plan
from repro_torch.core.portfolio import (PlanPortfolio, ProbeReport, ProbeResult, pick_winner,
                                        plan_key, robust_latency)
from repro_torch.core.profiler import Profile, ProfileError, extend_profile, subset_profile
from repro_torch.core.replay import (ADMISSION_HYSTERESIS, AdmissionDecision,
                                     DeviceDraining, DeviceEvicted, DeviceFailed,
                                     DeviceJoined, MembershipController,
                                     MembershipEvent, RecoveryReport, admission_replay,
                                     assign_backups, departure_replay, heavy_rescheduling,
                                     lightweight_replay)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW, AdamWState, SGDState, tree_leaves, tree_map

from .train import _assemble_train_step, _check_device, init_train_state, train_spec_from_lowered


@dataclasses.dataclass(frozen=True)
class RecoveryOutcome:
    """Everything one membership transition produced.  A rejected
    admission records the pricing work alone: ``accepted=False`` with
    ``report``/``migration`` of ``None``."""

    report: RecoveryReport | None       # analytical timings + new plan
    migration: MigrationReport | None   # what migrate_params moved
    reconciliation: dict | None         # per-boundary byte agreement
    restored_stage: int | None          # old stage restored from backup
    restored_periods: tuple[int, ...]   # canonical periods it covered
    mode: str                           # "lightweight"|"heavy"|"admission"|"drain"|"evict"
    detection_observed_s: float         # coordinator clock vs report.detection_s
    missing_backup_stages: tuple[int, ...] = ()   # lost with no replica yet
    event: MembershipEvent | None = None
    accepted: bool = True               # False = admission rejected
    stall_s: float = 0.0                # pipeline stall charged (report.stall_s)
    decision: AdmissionDecision | None = None


class PipelineSession:
    """A re-lowerable training pipeline with live failure recovery.

    ``model_axis`` stands in for ``repro``'s production mesh: the stage
    counts a plan may lower to are its divisors."""

    def __init__(self, cfg: ModelConfig, model_axis: int, plan: Plan,
                 profile: Profile, *, optimizer: AdamW | None = None,
                 backup_every: int = 5, check: bool = True,
                 portfolio_k: int = 0, probation_window: int = 2,
                 drift_watchdog=None, device="cuda", **spec_kw):
        self.cfg = cfg
        self.model_axis = int(model_axis)
        self.profile = profile
        self.optimizer = optimizer or AdamW(lr=1e-3)
        self.backup_every = backup_every
        self.spec_kw = spec_kw
        self.device = _check_device(device)
        # -- portfolio auctions (DESIGN.md §12) --------------------------
        # portfolio_k > 0 arms the closed loop: a drift-watchdog trip or a
        # completed membership swap marks an auction pending, and the next
        # step() (which has a batch to probe with) runs it before training
        self.portfolio_k = portfolio_k
        self.probation_window = probation_window
        self.watchdog = drift_watchdog
        self.auctions: list = []           # ProbeReports, in order
        self._auction_pending = False
        self._auction_k = portfolio_k

        self.ts = None
        self.step_cache_hits = 0
        # error-feedback residuals of the compressed gradient stream
        # (spec.bucketed); zeroed by _install on every (re-)lowering
        self._ef = None
        lowered = lower_plan(plan, cfg, self.model_axis)
        if check:
            check_against_simulator(lowered, plan, profile)
        self._install(plan, lowered)

        self.store = StageBackupStore()
        self.params = None
        self.opt_state = None
        # staleness 1: the parameter half of the last round's update
        self._held = None
        self.step_count = 0
        self.clock = 0.0
        self._failed: set[int] = set()
        self._departed: set[int] = set()
        self._pending_failure: int | None = None
        self.coordinator = MembershipController(sorted(
            d for st in self.plan.stages for d in st.group))
        if self.portfolio_k:
            # post-churn replans re-arbitrate analytic-vs-runner-up with a
            # cheap 2-candidate probation at the next step
            self.coordinator.auction_hook = self._on_membership_swap
        if self.watchdog is not None:
            self.watchdog.install(self.plan, self.profile)
        self.recoveries: list[RecoveryOutcome] = []    # crash recoveries
        self.memberships: list[RecoveryOutcome] = []   # every transition
        # transition-in-flight scratch (set by *_replan, read by migrate)
        self._recovering_rank: int | None = None
        self._next_lowered: LoweredPlan | None = None
        self._next_mode = ""
        self._detect_wall = 0.0
        self._transition_event: MembershipEvent | None = None
        self._transition_lost = False      # crash: lost stages restore
        self._pending_profile: Profile | None = None   # extended, on join

    # -- installation ------------------------------------------------------

    def _install(self, plan: Plan, lowered: LoweredPlan) -> None:
        # a held update belongs to the OLD step: apply it before anything
        # about the runtime changes (getattr: __init__ installs before the
        # attribute exists)
        if getattr(self, "_held", None) is not None:
            self.flush_gradients()
        self.lowered = lowered
        # the deployed plan owns the *snapped* layer ranges — replaying from
        # it keeps the analytical old ownership aligned with the runtime
        self.plan = snap_plan(plan, lowered, self.profile.table.L)
        spec = train_spec_from_lowered(self.cfg, self.model_axis, lowered, **self.spec_kw)
        if self.ts is not None and spec == self.ts.spec:
            # same runtime shape: the step is still valid
            self.step_cache_hits += 1
            if self.ts.spec.bucketed and self._ef is None:
                self._ef = self.ts.init_ef()
            return
        self._ef = None             # free the old residuals before the new ones
        self.ts = _assemble_train_step(spec, self.optimizer, self.device)
        # a rebuilt step re-buckets the gradient tree, so carried
        # quantization residuals no longer line up: drop them
        self._ef = self.ts.init_ef() if self.ts.spec.bucketed else None

    def init(self, seed: int = 0):
        self.params, self.opt_state = init_train_state(seed, self.ts, self.optimizer)
        self._held = None
        return self.params

    # -- training loop -----------------------------------------------------

    @property
    def live_ranks(self) -> tuple[int, ...]:
        return tuple(sorted(d for st in self.plan.stages for d in st.group
                            if d not in self._failed))

    def step(self, batch_np: dict):
        """One training step (recovering first if a failure is pending).

        A pending auction (queued by a membership swap or a watchdog trip)
        runs next, on this step's batch.  Advances the simulated cluster
        clock by at least one HPP round (the deployed plan's Eq. 4 latency)
        and feeds survivor heartbeats to the coordinator; with a watchdog
        armed, the step's wall time (after a synchronize) is its
        observation."""
        if self._pending_failure is not None:
            self.recover_now()
        if self._auction_pending and self.portfolio_k:
            # a watchdog trip or membership swap re-opened the auction;
            # this step's batch doubles as the probe batch
            self._auction_pending = False
            self.probe_portfolio(batch_np, k=self._auction_k,
                                 window=self.probation_window)
        t0 = _time.perf_counter() if self.watchdog is not None else 0.0
        batch = self.ts.shard_batch(batch_np)
        bucketed = self.ts.spec.bucketed
        if self.ts.spec.staleness >= 1:
            # bounded-stale round: this round's gradients at the current
            # parameters, then the held update (none in the first round)
            if bucketed:
                (self.params, self.opt_state, self._held, self._ef, loss,
                 metrics) = self.ts.async_step_fn(self.params, self.opt_state,
                                                  self._held, self._ef, batch)
            else:
                (self.params, self.opt_state, self._held, loss,
                 metrics) = self.ts.async_step_fn(self.params, self.opt_state,
                                                  self._held, batch)
        elif bucketed:
            (self.params, self.opt_state, self._ef, loss,
             metrics) = self.ts.step_fn(self.params, self.opt_state, self._ef, batch)
        else:
            self.params, self.opt_state, loss, metrics = self.ts.step_fn(
                self.params, self.opt_state, batch)
        if self.watchdog is not None:
            self._sync()
            if self.watchdog.observe(_time.perf_counter() - t0):
                self._auction_pending = True
                self._auction_k = self.portfolio_k or 2
        self.step_count += 1
        self.clock += max(self.plan.latency, self.coordinator.heartbeat_period)
        for r in self.live_ranks:
            self.coordinator.heartbeat(r, self.clock)
        if self.backup_every and self.step_count % self.backup_every == 0:
            self.backup_now()
        return float(loss), metrics

    def flush_gradients(self) -> bool:
        """Apply the held bounded-staleness update synchronously.

        A recovery (and the end of training) is a staleness barrier: the
        held round is applied with the *current* step before anything
        migrates.  Returns True when an update was held."""
        if self._held is None:
            return False
        self.params, self.opt_state = self.ts.flush_fn(self.params, self.opt_state,
                                                       self._held)
        self._held = None
        return True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- portfolio auctions (DESIGN.md §12) --------------------------------

    def _on_membership_swap(self, kind: str, rank: int | None) -> None:
        """``MembershipController.auction_hook``: a completed churn swap
        installed an analytically replanned pipeline; queue a cheap
        2-candidate auction so the measured card, not the cost model,
        confirms (or overturns) that choice at the next step."""
        self._auction_pending = True
        self._auction_k = 2

    def _plan_spec_kw(self, plan: Plan) -> dict:
        """Spec kwargs with ``plan``'s gradient-sync and wire semantics
        merged in: a portfolio candidate carries its own staleness and
        compression, which win over the constructor's ``spec_kw``.  A
        compressed candidate's ``CompressionConfig`` brings its own
        ``bucket_mb`` and ``error_feedback`` too (by default one unbounded
        bucket per free-axes group, with error feedback), overriding a
        launcher's ``--bucket-mb`` / ``--no-error-feedback``, as in
        ``repro``."""
        kw = dict(self.spec_kw)
        kw["staleness"] = getattr(plan, "staleness", 0)
        comp = getattr(plan, "compress", None)
        if comp is not None:
            kw.update(compress=comp.fmt, quant_tile=comp.tile,
                      bucket_mb=comp.bucket_mb, error_feedback=comp.error_feedback)
        else:
            # uncompressed candidate: raw wire, but keep any bucketing the
            # caller configured
            kw["compress"] = "none"
        return kw

    def _adopt_plan(self, plan: Plan, *, reseed: bool = True) -> None:
        """Swap the session onto ``plan`` with no membership event: apply a
        held update, migrate the period stack and the optimizer moments by
        the gather a churn transition uses (the identity on one card),
        merge the plan's sync and wire semantics into the spec, and
        re-install (the step is reused when the spec is unchanged).  The
        probation primitive, called k times in a row by
        ``probe_portfolio``.  ``repro``'s re-padding of the vocab leaves
        and its ``device_put`` have no counterpart: tp is a label here and
        the stack carries no vocab padding."""
        self.flush_gradients()
        old_lp = self.lowered
        new_lp = relower(old_lp, plan, self.cfg, self.model_axis)
        new_params, _ = migrate_params(self.params, old_lp, new_lp)
        new_opt = migrate_opt_state(self.opt_state, old_lp, new_lp)
        self.spec_kw = self._plan_spec_kw(plan)
        self._install(plan, new_lp)
        self.params, self.opt_state = new_params, new_opt
        if reseed:
            self._reseed_backups(old_lp)

    def _probe_rounds(self, batch_np: dict, window: int):
        """Time ``window + 1`` rounds of the installed plan's gradient
        function, committing nothing: parameters, moments, error-feedback
        residuals and a held update are left as they were (the bit-identity
        invariant).  The first round absorbs a cold step;
        ``portfolio.robust_latency`` trims it.

        ``repro`` runs ``step_fn`` for a synchronous finalist and drops its
        output.  The port's ``step_fn`` updates parameters and moments in
        place, so every finalist is timed on ``grad_fn`` (its wire
        included): the residual tree ``wire_buckets`` returns is a new
        dict, so ``self._ef`` stays untouched.  Each round's outputs are
        freed before the next one starts.  Returns the wall seconds per
        round and, on the card, the CUDA-event seconds per round (empty on
        the CPU)."""
        batch = self.ts.shard_batch(batch_np)
        cuda = self.device.type == "cuda"
        times, device_times = [], []
        for _ in range(window + 1):
            self._sync()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = _time.perf_counter()
            if self.ts.spec.bucketed:
                out = self.ts.grad_fn(self.params, batch, self._ef)
            else:
                out = self.ts.grad_fn(self.params, batch)
            if cuda:
                end.record()
            self._sync()
            times.append(_time.perf_counter() - t0)
            if cuda:
                device_times.append(start.elapsed_time(end) / 1e3)
            del out
        return times, device_times

    def probe_portfolio(self, batch_np: dict | None = None, k: int = 3, window: int = 2, *,
                        hysteresis: float = 0.0, measure=None) -> ProbeReport:
        """Run one portfolio auction (DESIGN.md §12): enumerate every
        strategy family on the session profile, take the top-``k``
        lowerable finalists by predicted round latency, give each a live
        ``window``-round probation, and install the measured winner.

        Finalists probe in predicted order under ``portfolio.pick_winner``'s
        strict comparison, so ties keep the analytically best plan and a
        measurement matching the predictions never churns.  ``measure``
        overrides the live probe with ``measure(candidate) -> seconds |
        [rounds]`` (the full adopt/migrate cycle still runs).  After churn
        the enumeration is restricted to the surviving ranks through
        ``profiler.subset_profile``.  Backups are re-seeded once, at the
        end, against the layout before the auction.  Returns the
        ``ProbeReport`` (also kept in ``self.auctions``)."""
        if batch_np is None and measure is None:
            raise ValueError("probe_portfolio needs a probe batch (or a measure= override)")
        if self._pending_failure is not None:
            self.recover_now()
        self.flush_gradients()
        # the auction's pool is membership-derived (the profile's cluster
        # less crashed and departed ranks), not the installed plan's groups:
        # a winner that idles a device must not shrink later auctions
        pool = tuple(sorted(set(range(len(self.profile.cluster.devices)))
                            - self._failed - self._departed))
        prof, ranks = self.profile, None
        if len(pool) < len(self.profile.cluster.devices):
            ranks = pool
            prof = subset_profile(self.profile, pool)
        portfolio = PlanPortfolio.enumerate(
            prof, self.lowered.global_batch, self.lowered.micro_batch,
            arch=self.plan.arch or self.cfg.name,
            allowed_stages=self._lowerable_stages, ranks=ranks)

        def _lowerable(c) -> bool:
            try:
                relower(self.lowered, c.plan, self.cfg, self.model_axis)
                return True
            except (LoweringError, AllocationError):
                return False

        finalists = portfolio.finalists(k, runnable=_lowerable)
        if not finalists:
            raise RuntimeError("portfolio produced no lowerable finalist for this session")
        incumbent_key = plan_key(self.plan)
        pre_lp = self.lowered       # backups in the store are keyed by this
        results: list[ProbeResult] = []
        keys = []
        for c in finalists:
            self._adopt_plan(c.plan, reseed=False)
            keys.append(plan_key(self.plan))       # snapped, like the incumbent
            device_rounds: tuple = ()
            if measure is not None:
                m = measure(c)
                rounds = (tuple(float(x) for x in m)
                          if isinstance(m, (list, tuple)) else (float(m),))
                measured = robust_latency(list(rounds), warmup=1 if len(rounds) > 1 else 0)
            else:
                wall, dev = self._probe_rounds(batch_np, window)
                rounds, device_rounds = tuple(wall), tuple(dev)
                measured = robust_latency(list(rounds))
            results.append(ProbeResult(c.family, c.predicted_s, measured, rounds,
                                       device_rounds=device_rounds))
        best = pick_winner([r.measured_s for r in results], hysteresis)
        if keys[best] != plan_key(self.plan):
            # probation ended on a finalist that lost: swap back
            self._adopt_plan(finalists[best].plan, reseed=False)
        self._reseed_backups(pre_lp)
        results[best] = dataclasses.replace(results[best], installed=True)
        if self.watchdog is not None:
            self.watchdog.install(self.plan, self.profile)
        report = ProbeReport(tuple(results), best, len(portfolio.candidates),
                             portfolio.n_enumerated, window,
                             churned=keys[best] != incumbent_key)
        self.auctions.append(report)
        return report

    # -- canonical state ---------------------------------------------------

    def _canonical_trees(self) -> dict:
        trees = {"params": self.params}
        if isinstance(self.opt_state, AdamWState):
            trees["m"] = self.opt_state.m
            trees["v"] = self.opt_state.v
        elif isinstance(self.opt_state, SGDState):
            trees["mom"] = self.opt_state.mom
        return trees

    def canonical_leaves(self, as_numpy: bool = True) -> dict:
        """Training state in plan-independent canonical form (``params``,
        and ``m``/``v`` or ``mom``): numpy trees, or with ``as_numpy=False``
        the tensors themselves where they lie (to compare on the card).
        The port's period stack is already in canonical (model) order and
        carries no vocab padding.  Two sessions hold bit-identical training
        state iff these are equal.  Read it after a flush: a held update is
        not part of it."""
        def leaf(t):
            return t.detach().cpu().numpy() if as_numpy else t.detach()

        return {k: tree_map(leaf, v) for k, v in self._canonical_trees().items()}

    def canonical_digests(self) -> list[str]:
        """SHA-256 of each leaf of ``canonical_leaves``' trees (its shape,
        dtype and bytes), in their order.  Each leaf is copied to the host
        on its own, one per CPU core at a time (at most 8 in flight): at
        full width the state is tens of GB, and two host copies of it to
        compare before and after would double that.  Equal lists mean
        bit-identical state."""
        def digest(t):
            t = t.detach().contiguous()
            h = hashlib.sha256(f"{tuple(t.shape)} {t.dtype}".encode())
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy())
            return h.hexdigest()

        leaves = [t for tree in self._canonical_trees().values() for t in tree_leaves(tree)]
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            return list(pool.map(digest, leaves))

    # -- replication -------------------------------------------------------

    def backup_now(self) -> None:
        """Push single-device stages' period rows, plus the edge leaves the
        first/last stage own, to their topology-assigned backup nodes (DP
        peers replicate the rest)."""
        assign = assign_backups(self.plan, self.profile)
        for p, backup_rank in assign.backup_of_stage.items():
            i, j = self.lowered.stage_periods[p]
            rows = tree_map(lambda x: x[i:j], self.params["periods"])
            self.store.backup(p, {"rows": rows, "extras": self._edge_extras(p)},
                              meta={"periods": (i, j), "step": self.step_count,
                                    "backup_rank": backup_rank})

    def _edge_extras(self, p: int) -> dict:
        """Non-period leaves owned by an edge stage: the embedding for stage
        0, the head side for the last stage (the layer table charges their
        bytes to those stages)."""
        out: dict = {}
        if p == 0:
            out["embed"] = self.params["embed"]
        if p == len(self.plan.stages) - 1:
            if "head" in self.params:
                out["head"] = self.params["head"]
            out["final_norm"] = self.params["final_norm"]
        return out

    # -- failure injection + recovery --------------------------------------

    def fail(self, rank: int) -> None:
        """Simulate ``rank`` dying: its heartbeats stop; the next ``step()``
        (or ``recover_now()``) detects and recovers through the replay."""
        if rank not in self.live_ranks:
            raise ValueError(f"rank {rank} is not a live device ({self.live_ranks})")
        self._failed.add(rank)
        self._pending_failure = rank

    def recover_now(self) -> RecoveryOutcome:
        """Drive the §3.4 recovery for the pending failure: detect (missed
        heartbeats -> probe -> confirm, on the simulated clock), then replan
        -> migrate -> resume through the coordinator, with this session as
        executor.  Returns the outcome (also appended to ``recoveries``)."""
        failed = self._pending_failure
        if failed is None:
            raise RuntimeError("no pending failure")
        self._pending_failure = None
        self.flush_gradients()
        self._fail_time = self.clock
        t = self.clock
        confirmed = None
        while confirmed is None:
            t += self.coordinator.heartbeat_period
            for r in self.live_ranks:
                self.coordinator.heartbeat(r, t)
            confirmed = self.coordinator.poll(t)
        assert confirmed == failed, (confirmed, failed)
        self._detect_wall = t - self._fail_time
        self._recovering_rank = failed
        self._transition_event = DeviceFailed(failed)
        self._transition_lost = True
        _, outcome = self.coordinator.run_recovery(failed, self, now=t)
        self.clock = self.coordinator.events[-1][1]
        self._recovering_rank = None
        self._transition_event = None
        self._transition_lost = False
        self.recoveries.append(outcome)
        self.memberships.append(outcome)
        return outcome

    # -- elastic membership entry points ------------------------------------

    def admit(self, device: DeviceProfile | None = None, *, arrival=None,
              hysteresis: float = ADMISSION_HYSTERESIS) -> RecoveryOutcome:
        """Offer a newcomer to the pipeline (hysteresis-gated admission).
        ``arrival`` is its on-arrival measured sweep (a
        ``core.profiler.MeasuredProfile``), which prices the admission when
        given.  ``accepted=False`` leaves the incumbent plan untouched."""
        if device is None:
            if arrival is None:
                raise ValueError("admit() needs a DeviceProfile, an on-arrival "
                                 "measured sweep, or both")
            device = arrival.cluster().devices[0]
        return self._membership_transition(DeviceJoined(device, arrival, hysteresis))

    def drain(self, rank: int) -> RecoveryOutcome:
        """Gracefully remove ``rank``: it keeps serving while its layers
        stream off, so the pipeline stalls only for the re-plan."""
        return self._membership_transition(DeviceDraining(self._live(rank)))

    def evict(self, rank: int) -> RecoveryOutcome:
        """Remove ``rank`` at once (planned: no detection, no restore, but
        the pipeline pauses for the migration)."""
        return self._membership_transition(DeviceEvicted(self._live(rank)))

    def _live(self, rank: int) -> int:
        if rank not in self.live_ranks:
            raise ValueError(f"rank {rank} is not a live device ({self.live_ranks})")
        return rank

    def _membership_transition(self, event: MembershipEvent) -> RecoveryOutcome:
        """Drive one planned membership event through the controller.  A
        pending crash recovers first, and a held update is applied before
        the plan swap."""
        if self._pending_failure is not None:
            self.recover_now()
        self.flush_gradients()
        self._detect_wall = 0.0
        self._transition_event = event
        self._transition_lost = False
        self._recovering_rank = getattr(event, "rank", None)
        result, outcome = self.coordinator.handle(event, self, now=self.clock)
        self.clock = self.coordinator.events[-1][1]
        self._recovering_rank = None
        self._transition_event = None
        if isinstance(result, AdmissionDecision):
            if not result.accepted:
                outcome = RecoveryOutcome(None, None, None, None, (), "admission", 0.0,
                                          event=event, accepted=False,
                                          stall_s=result.replan_s, decision=result)
            else:
                outcome = dataclasses.replace(outcome, decision=result)
        else:
            self._departed.add(event.rank)
        self.memberships.append(outcome)
        return outcome

    # -- MembershipController executor protocol ----------------------------

    @property
    def _lowerable_stages(self) -> set[int]:
        """Stage counts the model axis can lower (its divisors, with at
        least one period per stage)."""
        return {d for d in range(1, self.model_axis + 1)
                if self.model_axis % d == 0 and d <= self.lowered.n_periods}

    def replan(self, failed_rank: int) -> RecoveryReport:
        """Executor step 1 (crash): plan the survivors' pipeline.

        Lightweight layer-wise replay first, priced on ``self.profile``,
        falling back to heavy rescheduling (Algorithm 2 restricted to
        lowerable stage counts) when the survivor stage count is not
        lowerable or the allocation is infeasible."""
        quantum = len(self.cfg.pattern)
        try:
            rep = lightweight_replay(self.plan, self.profile, failed_rank,
                                     fail_time=self._fail_time, layer_quantum=quantum)
            self._next_lowered = relower(self.lowered, rep.new_plan, self.cfg,
                                         self.model_axis)
            self._next_mode = "lightweight"
            return rep
        except (LoweringError, AllocationError):
            rep = heavy_rescheduling(self.plan, self.profile, failed_rank,
                                     fail_time=self._fail_time,
                                     allowed_stages=self._lowerable_stages)
            self._next_lowered = relower(self.lowered, rep.new_plan, self.cfg,
                                         self.model_axis)
            self._next_mode = "heavy"
            return rep

    def admit_replan(self, event: DeviceJoined) -> AdmissionDecision:
        """Executor step 1 (join): price the newcomer into the pipeline.
        Its measured sweep extends the session profile when usable
        (analytic fallback otherwise); the extended profile is installed
        only if the join is accepted and lowers."""
        quantum = len(self.cfg.pattern)
        new_rank = len(self.profile.cluster.devices)
        tf = tb = None
        if event.arrival is not None:
            try:
                tf, tb = event.arrival.device_rows(self.profile.table,
                                                   self.profile.max_batch)
            except ProfileError as e:
                warnings.warn(f"on-arrival sweep unusable ({e}); pricing "
                              f"{event.device.name} with the analytic FLOP model instead")
                tf = tb = None
        ext = extend_profile(self.profile, event.device, tf, tb)
        decision = admission_replay(self.plan, ext, new_rank,
                                    hysteresis=event.hysteresis, layer_quantum=quantum,
                                    allowed_stages=self._lowerable_stages)
        if not decision.accepted:
            return decision
        try:
            self._next_lowered = relower(self.lowered, decision.report.new_plan,
                                         self.cfg, self.model_axis)
        except LoweringError as e:
            return dataclasses.replace(
                decision, accepted=False, report=None,
                reason=f"accepted candidate is not lowerable: {e}")
        self._next_mode = "admission"
        self._pending_profile = ext
        return decision

    def drain_replan(self, rank: int) -> RecoveryReport:
        """Executor step 1 (graceful drain)."""
        return self._departure_replan(rank, graceful=True)

    def evict_replan(self, rank: int) -> RecoveryReport:
        """Executor step 1 (planned evict)."""
        return self._departure_replan(rank, graceful=False)

    def _departure_replan(self, rank: int, graceful: bool) -> RecoveryReport:
        """Plan a departure: ``departure_replay`` first, heavy rescheduling
        when the survivor stage count is not lowerable, with detection
        zeroed (the leaver announced itself) and the drain's overlap kept."""
        quantum = len(self.cfg.pattern)
        try:
            rep = departure_replay(self.plan, self.profile, rank, graceful=graceful,
                                   layer_quantum=quantum)
            self._next_lowered = relower(self.lowered, rep.new_plan, self.cfg,
                                         self.model_axis)
            self._next_mode = rep.mode
            return rep
        except (LoweringError, AllocationError):
            rep = heavy_rescheduling(self.plan, self.profile, rank, fail_time=self.clock,
                                     allowed_stages=self._lowerable_stages)
            rep = dataclasses.replace(rep, detection_s=0.0, overlapped=graceful)
            self._next_lowered = relower(self.lowered, rep.new_plan, self.cfg,
                                         self.model_axis)
            self._next_mode = "heavy"
            return rep

    def migrate(self, report: RecoveryReport) -> RecoveryOutcome:
        """Executor step 2: move the training state onto the new plan.

        ``migrate_params`` / ``migrate_opt_state`` of the period stack and
        the moments (the identity on one card), the backup restore of a
        fully *lost* single-device stage (crashes only: a draining or
        evicted leaver streams its layers off), and the byte reconciliation
        of the moved periods against the analytical report for every
        layer-wise mode (the heavy fallback redistributes everything, so it
        has no per-move prediction to reconcile)."""
        old_lp, new_lp = self.lowered, self._next_lowered
        departing = self._recovering_rank
        lost = self._transition_lost
        old_owner = self._device_owner(departing, report.new_plan, new_lp, lost=lost)
        new_params, mig = migrate_params(self.params, old_lp, new_lp, old_owner=old_owner)
        new_opt = migrate_opt_state(self.opt_state, old_lp, new_lp)

        # a fully-failed single-device stage: overwrite its (lost) period
        # rows with the backup replica, stale by < backup_every steps
        restored_stage = None
        restored_periods: tuple[int, ...] = ()
        missing: list[int] = []
        if lost:
            for q, st in enumerate(self.plan.stages):
                if departing in st.group and len(st.group) == 1:
                    if self.store.has(q):
                        restored_periods = self._restore_stage(new_params, q, new_lp)
                        restored_stage = q
                    else:
                        missing.append(q)
        if missing:
            warnings.warn(
                f"stage(s) {missing} failed before any backup was pushed: no "
                "replica to restore from — continuing with the in-process values "
                "(on real hardware this state would be lost; lower backup_every "
                "or call backup_now() earlier)")

        reconciliation = None
        if self._next_mode in ("lightweight", "admission", "drain", "evict"):
            reconciliation = reconcile_migration(mig, report, new_lp, self.profile.table,
                                                 len(self.cfg.pattern))

        self._install(report.new_plan, new_lp)
        if self._pending_profile is not None:
            # an accepted join extends the cluster the session plans over
            self.profile = self._pending_profile
            self._pending_profile = None
        self.params, self.opt_state = new_params, new_opt
        self._reseed_backups(old_lp)
        return RecoveryOutcome(report, mig, reconciliation, restored_stage,
                               restored_periods, self._next_mode, self._detect_wall,
                               tuple(missing), event=self._transition_event,
                               accepted=True, stall_s=report.stall_s)

    def _reseed_backups(self, old_lp: LoweredPlan) -> None:
        """Backups are keyed by the stage split, which every transition
        changes: drop the old arrangement's replicas and re-seed the NEW
        single-device stages at once, so a follow-up failure never restores
        rows of a split that no longer exists.  Sessions that replicate by
        hand (``backup_every=0`` with ``backup_now()`` calls) are re-seeded
        too."""
        had_replicas = any(self.store.has(q) for q in range(len(old_lp.stage_periods)))
        for q in range(len(old_lp.stage_periods)):
            self.store.drop(q)
        if self.backup_every or had_replicas:
            self.backup_now()

    def resume(self, report: RecoveryReport, outcome: RecoveryOutcome) -> None:
        """Executor step 3: nothing left to do — ``migrate`` installed the
        step and re-seeded the backups before handing control back."""

    # -- helpers -----------------------------------------------------------

    def _device_owner(self, departing_rank: int | None, new_plan: Plan,
                      new_lp: LoweredPlan, lost: bool = True):
        """Per-canonical-period owner in NEW-plan stage coordinates, by
        device identity: a period stays resident when a surviving device of
        its old stage is in its new owner's group; otherwise its owner is
        the new stage holding a surviving old holder.  A stage departing
        whole leaves no holder: ``None`` when it is lost (crashed: restored
        from backup), ``DIRECT_SOURCE`` when the leaver is alive (drain /
        evict: its rows stream straight to their new owners).
        ``departing_rank=None`` (a join) keeps every incumbent a holder."""
        new_of_rank = {d: p for p, st in enumerate(new_plan.stages) for d in st.group}
        new_own = period_owner(new_lp)
        owner: list[int | None] = []
        for q, (i, j) in enumerate(self.lowered.stage_periods):
            holders = [d for d in self.plan.stages[q].group if d != departing_rank]
            for t in range(i, j):
                if any(d in new_plan.stages[new_own[t]].group for d in holders):
                    owner.append(new_own[t])     # already resident
                elif holders:
                    owner.append(new_of_rank.get(holders[0]))
                else:
                    owner.append(None if lost else DIRECT_SOURCE)
        return owner

    def _restore_stage(self, tree: dict, q: int, new_lp: LoweredPlan):
        """Copy stage ``q``'s host backup into its period rows (at their
        positions in ``new_lp``'s stack) and its edge leaves, in place.
        Returns the periods restored."""
        snap = self.store.restore(q)
        rows, extras = snap["rows"], snap["extras"]
        i, j = self.store.meta(q)["periods"]
        pos = period_positions(new_lp)
        rows_at = [pos[t] for t in range(i, j)]
        if rows_at != list(range(rows_at[0], rows_at[0] + (j - i))):
            raise LoweringError(f"periods {i}..{j} are not contiguous rows of the stack")
        lo, hi = rows_at[0], rows_at[-1] + 1

        def scatter(dest, src):
            dest[lo:hi].copy_(src, non_blocking=True)
            return dest

        tree_map(scatter, tree["periods"], rows)
        for key, leaf in extras.items():
            tree_map(lambda d, s: d.copy_(s, non_blocking=True), tree[key], leaf)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return tuple(range(i, j))
