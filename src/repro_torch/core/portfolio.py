"""Plan portfolio: closed-loop strategy selection over live probation
windows (DESIGN.md §12).

The analytic cost model can misprice a measured round by 25% and more, so
no single open-loop strategy (sync HPP, async staleness 1, DP, compressed
variants) plans best on every cluster.  This module turns the planner into
an *algorithm portfolio*: every priced strategy family in ``core.planner``
contributes a candidate, structural duplicates are folded, and the top-K
by predicted round latency become *finalists* that the session auctions
over short live probation windows (``PipelineSession.probe_portfolio``).
Measured round latency, not the model, picks the winner; the
``DriftWatchdog`` re-opens the auction when the observed/predicted ratio
(via ``simulator.reprice_plan``) drifts.

A copy of ``repro.core.portfolio``: the families, their name strings, the
staleness x compression grid, the dedupe and the sort key are ``repro``'s.
``ProbeResult`` also carries the probe's device time per round
(``device_rounds``, read with CUDA events on the card; empty on the CPU and
under ``measure=``); the winner is still picked on the wall rounds.
``reprice_plan`` refuses a profile with fewer devices than a plan names
with a ``ValueError`` where ``repro``'s copy fails with an ``IndexError``:
``DriftWatchdog.install`` and ``PlanPortfolio.on_profile`` raise it there.

Everything here is pure planning and bookkeeping; the session layer owns
the probation runs.
"""

from __future__ import annotations

import dataclasses

from .allocation import AllocationError
from .planner import (Plan, plan_dp, plan_gpipe, plan_hetpipe_hdp,
                      plan_homogeneous_hpp, plan_hpp)
from .profiler import Profile
from .simulator import reprice_plan

#: plan_hpp axes enumerated as distinct families.  'auto' variants are not
#: enumerated separately: auto returns one of its constituents, so the
#: structural dedupe would fold it anyway.
HPP_STALENESS = (0, 1)
HPP_COMPRESS = (None, "int8", "fp8")


def plan_key(plan: Plan) -> tuple:
    """Structural identity of a plan: the *decisions* that determine what
    the runtime executes — stage layer ranges, device groups, per-device
    allocations, batch geometry, gradient-sync semantics, wire format.

    Deliberately excludes every priced quantity (step costs, latency,
    plan_time, planner name), so the key is stable under
    ``simulator.reprice_plan`` — re-pricing a plan on another profile
    never changes which candidate it *is*.
    """
    comp = getattr(plan, "compress", None)
    ckey = ((comp.fmt, comp.tile, comp.bucket_mb, comp.error_feedback)
            if comp is not None else None)
    return (plan.arch,
            tuple((st.layers, st.group, st.alloc) for st in plan.stages),
            plan.micro_batch, plan.n_micro,
            getattr(plan, "staleness", 0), ckey)


def renumber_plan(plan: Plan, ranks: tuple[int, ...]) -> Plan:
    """Map a plan's device ranks from subset-profile order back to the
    parent cluster's numbering (``ranks[i]`` is the parent rank of subset
    device ``i``) — the inverse of planning on ``profiler.subset_profile``.
    """
    stages = tuple(dataclasses.replace(st, group=tuple(ranks[d]
                                                       for d in st.group))
                   for st in plan.stages)
    steps = tuple(dataclasses.replace(s, group=tuple(ranks[d]
                                                     for d in s.group))
                  if s.group else s for s in plan.steps)
    return dataclasses.replace(plan, stages=stages, steps=steps)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One enumerated strategy: a priced plan, or a reference-only entry
    (``plan=None``) for families that price a latency but produce no
    runnable ``Plan`` — HetPipe's HDP arrangement prices the parameter
    server round but its virtual-worker layout has no HPP lowering."""

    family: str                 # e.g. "hpp/async/int8", "dp/eddl"
    plan: Plan | None
    predicted_s: float
    note: str = ""

    @property
    def runnable(self) -> bool:
        return self.plan is not None

    @property
    def key(self) -> tuple:
        return (plan_key(self.plan) if self.plan is not None
                else ("reference", self.family))


@dataclasses.dataclass(frozen=True)
class PlanPortfolio:
    """The deduped candidate set of every strategy family, priced on one
    profile."""

    candidates: tuple[Candidate, ...]   # deduped, sorted by predicted_s
    n_enumerated: int                   # before structural dedupe

    @classmethod
    def enumerate(cls, profile: Profile, global_batch: int, micro_batch: int,
                  *, arch: str = "", allowed_stages=None, intra_opt="auto",
                  ranks: tuple[int, ...] | None = None) -> "PlanPortfolio":
        """Collect candidates from every planner family.

        Families that are infeasible on this cluster (memory caps,
        stage-count restrictions) are skipped, not fatal.  ``ranks``: when
        ``profile`` is a ``subset_profile`` of a larger session cluster,
        the parent ranks of its devices — every candidate plan is
        renumbered back into parent coordinates (post-churn auctions plan
        over the survivors but execute on the original mesh numbering).
        """
        cands: list[Candidate] = []

        def add(family: str, fn, note: str = ""):
            try:
                plan = fn()
            except AllocationError:
                return
            if ranks is not None:
                plan = renumber_plan(plan, ranks)
            cands.append(Candidate(family, plan, plan.latency, note))

        for staleness in HPP_STALENESS:
            for comp in HPP_COMPRESS:
                add(f"hpp/{'async' if staleness else 'sync'}/"
                    f"{comp or 'raw'}",
                    lambda s=staleness, c=comp: plan_hpp(
                        profile, global_batch, micro_batch, arch=arch,
                        allowed_stages=allowed_stages, intra_opt=intra_opt,
                        staleness=s, compress=c))
        add("dp/eddl", lambda: plan_dp(profile, global_batch, micro_batch,
                                       arch=arch, heterogeneous=True))
        n_dev = len(profile.cluster.devices)
        pp_stages = (min(n_dev, max(allowed_stages))
                     if allowed_stages else None)
        add("pp/gpipe", lambda: plan_gpipe(profile, global_batch,
                                           micro_batch, arch=arch,
                                           n_stages=pp_stages))
        add("hpp/pipedream", lambda: plan_homogeneous_hpp(
            profile, global_batch, micro_batch, arch=arch))
        add("hpp/dapple", lambda: plan_homogeneous_hpp(
            profile, global_batch, micro_batch, arch=arch,
            include_allreduce=True, name="dapple"))
        n_enumerated = len(cands)
        try:
            lat, vol = plan_hetpipe_hdp(profile, global_batch, micro_batch,
                                        arch=arch)
            cands.append(Candidate("hdp/hetpipe", None, lat,
                                   note=f"ps_volume={vol:.3g}B"))
            n_enumerated += 1
        except (AllocationError, ZeroDivisionError):
            pass

        # structural dedupe: identical decisions keep one entry — the
        # cheapest pricing (families can reach the same configuration with
        # different cost assumptions; probation measures it once either way)
        best: dict[tuple, Candidate] = {}
        for c in cands:
            k = c.key
            if k not in best or c.predicted_s < best[k].predicted_s:
                best[k] = c
        deduped = tuple(sorted(best.values(),
                               key=lambda c: (c.predicted_s, c.family)))
        return cls(deduped, n_enumerated)

    def finalists(self, k: int, runnable=None) -> list[Candidate]:
        """Top-``k`` runnable candidates by predicted round latency.

        ``runnable``: optional extra predicate (the session passes "does it
        relower on my mesh"); reference-only candidates never qualify."""
        out = []
        for c in self.candidates:
            if not c.runnable:
                continue
            if runnable is not None and not runnable(c):
                continue
            out.append(c)
            if len(out) == k:
                break
        return out

    def on_profile(self, profile: Profile) -> "PlanPortfolio":
        """Every runnable candidate re-priced on ``profile`` (decisions
        kept, costs recomputed — ``simulator.reprice_plan``)."""
        out = []
        for c in self.candidates:
            if c.plan is None:
                out.append(c)
                continue
            p = reprice_plan(c.plan, profile)
            out.append(dataclasses.replace(c, plan=p, predicted_s=p.latency))
        return PlanPortfolio(tuple(sorted(
            out, key=lambda c: (c.predicted_s, c.family))), self.n_enumerated)

    def records(self) -> list[dict]:
        """Benchmark-friendly rows, one per candidate."""
        return [{"family": c.family, "predicted_s": c.predicted_s,
                 "runnable": c.runnable,
                 "stages": len(c.plan.stages) if c.plan else 0,
                 "staleness": getattr(c.plan, "staleness", 0) if c.plan else 0,
                 "compress": (c.plan.compress.fmt
                              if c.plan is not None and c.plan.compress
                              else "none")}
                for c in self.candidates]


# ---------------------------------------------------------------------------
# probation statistics + report
# ---------------------------------------------------------------------------


def robust_latency(rounds, warmup: int = 1) -> float:
    """Warmup-trimmed median of per-round wall times.

    The first ``warmup`` rounds carry jit compilation (or a cold step
    cache) and are dropped; the median of the rest resists the one-off
    scheduler hiccups short probation windows cannot average away.  Falls
    back to the full median when trimming would leave nothing."""
    kept = sorted(rounds[warmup:]) if len(rounds) > warmup else sorted(rounds)
    if not kept:
        raise ValueError("robust_latency needs at least one round")
    n = len(kept)
    return (kept[n // 2] if n % 2
            else 0.5 * (kept[n // 2 - 1] + kept[n // 2]))


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """One finalist's probation outcome."""

    family: str
    predicted_s: float
    measured_s: float
    rounds: tuple[float, ...]        # raw per-round wall times (incl. warmup)
    installed: bool = False
    device_rounds: tuple[float, ...] = ()   # per-round CUDA-event seconds


@dataclasses.dataclass(frozen=True)
class ProbeReport:
    """One full portfolio auction: finalists in predicted-latency order
    (index 0 is the analytic first choice), with the measured winner."""

    results: tuple[ProbeResult, ...]
    winner_index: int
    n_candidates: int               # deduped portfolio size
    n_enumerated: int               # before dedupe
    window: int                     # probation rounds per finalist
    churned: bool                   # False = winner was already installed

    @property
    def winner(self) -> ProbeResult:
        return self.results[self.winner_index]

    @property
    def first_choice(self) -> ProbeResult:
        return self.results[0]

    def to_record(self) -> dict:
        w, f = self.winner, self.first_choice
        return {
            "finalists": len(self.results),
            "candidates": self.n_candidates,
            "enumerated": self.n_enumerated,
            "window": self.window,
            "churned": self.churned,
            "first_choice": f.family,
            "first_choice_predicted_s": f.predicted_s,
            "first_choice_measured_s": f.measured_s,
            "winner": w.family,
            "winner_predicted_s": w.predicted_s,
            "winner_measured_s": w.measured_s,
            # >= 1.0 by construction (the winner is the measured argmin)
            "measured_winner_gain": (f.measured_s / w.measured_s
                                     if w.measured_s > 0 else 1.0),
        }


def pick_winner(measured, hysteresis: float = 0.0) -> int:
    """Index of the measured winner among finalists listed in
    predicted-latency order.

    Strictly-less-than comparison *is* the tie hysteresis: a later
    finalist must measure genuinely faster to displace an earlier
    (analytically better) one, so measurements equal to predictions keep
    the analytic first choice and ties never churn the installed plan.
    ``hysteresis`` widens the margin: a challenger must beat the incumbent
    by that fraction."""
    best = 0
    for i in range(1, len(measured)):
        if measured[i] < measured[best] * (1.0 - hysteresis):
            best = i
    return best


# ---------------------------------------------------------------------------
# drift watchdog
# ---------------------------------------------------------------------------


class DriftWatchdog:
    """EWMA drift detector on the observed/predicted round-latency ratio.

    On ``install`` the incumbent plan is re-priced on the session profile
    (``simulator.reprice_plan``) to fix ``predicted_s``.  Observed step
    wall times then feed an EWMA of ``observed / predicted``; the first
    post-warmup observation sets the *baseline* ratio (host seconds and
    simulated-cluster seconds live on different scales, so only relative
    drift is meaningful).  When the EWMA drifts more than ``threshold``
    away from the baseline the watchdog trips — the session re-opens the
    auction — and re-arms on a fresh baseline."""

    def __init__(self, threshold: float = 0.25, alpha: float = 0.3,
                 warmup: int = 1):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.predicted_s: float | None = None
        self.baseline: float | None = None
        self.ewma: float | None = None
        self._skip = 0
        self.observations = 0
        self.trips = 0

    def install(self, plan: Plan, profile: Profile) -> None:
        """Arm for a freshly installed plan: re-price it on ``profile`` and
        restart the warmup/baseline cycle."""
        self.predicted_s = reprice_plan(plan, profile).latency
        self.baseline = None
        self.ewma = None
        self._skip = self.warmup

    @property
    def drift(self) -> float:
        if self.baseline is None or self.ewma is None or self.baseline <= 0:
            return 0.0
        return abs(self.ewma / self.baseline - 1.0)

    def observe(self, observed_s: float) -> bool:
        """Feed one measured round; returns True when the auction should
        re-open."""
        if self.predicted_s is None or self.predicted_s <= 0:
            return False
        if self._skip > 0:
            self._skip -= 1
            return False
        ratio = observed_s / self.predicted_s
        self.observations += 1
        if self.baseline is None:
            self.baseline = ratio
            self.ewma = ratio
            return False
        self.ewma = self.alpha * ratio + (1.0 - self.alpha) * self.ewma
        if self.drift > self.threshold:
            self.trips += 1
            # re-arm on a fresh baseline so one drifted regime fires once,
            # not on every subsequent step
            self.baseline = None
            self.ewma = None
            self._skip = self.warmup
            return True
        return False
