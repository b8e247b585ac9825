"""The port's pipeline replay against ``repro``'s, on the CPU.

``repro_torch.core.replay`` is a whole copy of ``repro.core.replay``, and
``replan_for_membership``, ``prediction_gap`` and ``observed_gap`` are
copies too, so on the same plans and profiles they must make the same
decisions with the same arithmetic: every field of every report, plan and
decision is compared, floats to 1e-12 relative (``replan_s`` and
``plan_time``, wall-clock readings, excepted).  The inputs are
``tests/test_replay.py``'s: a 12-layer toy model on edge cluster C, three
single-device stages over identical boards (uniform bandwidth and a
bandwidth matrix), and the analytic clusters A–D on smoke phi3.  Where
``repro`` raises, the port raises the same error.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.costmodel as jcm
import repro.core.hardware as jhw
import repro.core.lowering as jlo
import repro.core.planner as jpl
import repro.core.profiler as jpr
import repro.core.replay as jrp
import repro.core.simulator as jsi
import repro.models as jmodels
import repro_torch.core.costmodel as tcm
import repro_torch.core.hardware as thw
import repro_torch.core.lowering as tlo
import repro_torch.core.planner as tpl
import repro_torch.core.profiler as tpr
import repro_torch.core.replay as trp
import repro_torch.core.simulator as tsi
import repro_torch.models.config as tmodels
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import get_config, get_smoke_config

REL = 1e-12
SKIP = ("replan_s", "plan_time")


def canon(x):
    """Dataclasses of either package as nested plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: canon(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name not in SKIP}
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def assert_same(got, want, path=""):
    got, want = canon(got), canon(want)
    _same(got, want, path)


def _same(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool) and np.isfinite(want):
        assert abs(got - want) <= REL * max(abs(want), 1e-300), (path, got, want)
    else:
        assert got == want, (path, got, want)


def both(fj, ft):
    """(repro's result, the port's); where repro raises, the port raises the
    same kind of error with the same message (``(None, None)``)."""
    try:
        want = fj()
    except Exception as e:              # noqa: BLE001
        with pytest.raises(Exception) as got:
            ft()
        assert type(got.value).__name__ == type(e).__name__, (got.value, e)
        assert str(got.value) == str(e)
        return None, None
    return want, ft()


# ---------------------------------------------------------------------------
# the inputs: test_replay.py's plans and profiles, in both packages
# ---------------------------------------------------------------------------


def _toy(mod, n_layers, d_model, vocab, d_ff, heads):
    return mod.ModelConfig(name="toy", n_layers=n_layers, d_model=d_model,
                           vocab_size=vocab, d_ff=d_ff,
                           attn=mod.AttentionConfig(n_heads=heads, n_kv_heads=heads,
                                                    head_dim=64),
                           pattern=(mod.LayerSpec(),))


@pytest.fixture(scope="module")
def env_c_setup():
    """A 12-layer toy model planned on edge cluster C (test_replay's
    ``setup``), in both packages."""
    out = []
    for mod, hw, pr, pl in ((jmodels, jhw, jpr, jpl), (tmodels, thw, tpr, tpl)):
        table = pr.LayerTable.from_model_config(_toy(mod, 12, 512, 32000, 2048, 8), 128)
        prof = pr.Profile.analytic(table, hw.env_c().sorted_by_memory(), max_batch=64)
        out.append((prof, pl.plan_hpp(prof, 128, 16, arch="toy")))
    return out


def _single_device(mod, hw, pr, pl, cm, bw_matrix=None, bandwidth=None):
    """3 single-device stages over 3 identical boards, 12 real layers."""
    table = pr.LayerTable.from_model_config(_toy(mod, 12, 256, 8000, 1024, 4), 64)
    kw = {} if bandwidth is None else {"bandwidth": bandwidth}
    prof = pr.Profile.analytic(table, hw.Cluster((hw.JETSON_NX,) * 3, bw_matrix=bw_matrix,
                                                 **kw), max_batch=16)
    stages = tuple(pl.StagePlan(r, (p,), (16,), cm.kp_policy(3, p))
                   for p, r in enumerate(((0, 5), (5, 10), (10, 14))))
    return prof, pl.Plan("t", stages, (), 16, 4, 1.0)


BW = ((0.0, 1e6, 2e6), (1e6, 0.0, 4e6), (5e5, 4e6, 0.0))


@pytest.fixture(scope="module", params=["uniform", "matrix"])
def single_setup(request):
    kw = {} if request.param == "uniform" else {"bw_matrix": BW, "bandwidth": 1e9}
    return (_single_device(jmodels, jhw, jpr, jpl, jcm, **kw),
            _single_device(tmodels, thw, tpr, tpl, tcm, **kw))


def test_plans_are_the_same(env_c_setup, single_setup):
    (jprof, jplan), (tprof, tplan) = env_c_setup
    assert_same(tplan, jplan)
    assert_same(single_setup[1][1], single_setup[0][1])


# ---------------------------------------------------------------------------
# replays
# ---------------------------------------------------------------------------


def test_assign_backups_and_checkpoint_cost(env_c_setup, single_setup):
    for (jprof, jplan), (tprof, tplan) in (env_c_setup, single_setup):
        want = jrp.assign_backups(jplan, jprof)
        got = trp.assign_backups(tplan, tprof)
        assert got.backup_of_stage == want.backup_of_stage
        assert got.checkpoint_bytes == want.checkpoint_bytes
        assert trp.checkpoint_cost(got, tprof) == jrp.checkpoint_cost(want, jprof)
    for t in (0.0, 0.3, 10.0, 17.74):
        assert trp.detection_latency(t) == jrp.detection_latency(t)


@pytest.mark.parametrize("quantum", [None, 1])
def test_lightweight_and_heavy_replays_match(env_c_setup, single_setup, quantum):
    for (jprof, jplan), (tprof, tplan) in (env_c_setup, single_setup):
        ranks = sorted({d for st in jplan.stages for d in st.group})
        for r in ranks:
            want, got = both(
                lambda: jrp.lightweight_replay(jplan, jprof, r, layer_quantum=quantum),
                lambda: trp.lightweight_replay(tplan, tprof, r, layer_quantum=quantum))
            assert_same(got, want, f"lightweight fail {r}")
            want, got = both(lambda: jrp.heavy_rescheduling(jplan, jprof, r),
                             lambda: trp.heavy_rescheduling(tplan, tprof, r))
            assert_same(got, want, f"heavy fail {r}")


@pytest.mark.parametrize("graceful", [True, False])
def test_departure_replays_match(env_c_setup, single_setup, graceful):
    for (jprof, jplan), (tprof, tplan) in (env_c_setup, single_setup):
        for r in sorted({d for st in jplan.stages for d in st.group}):
            want, got = both(
                lambda: jrp.departure_replay(jplan, jprof, r, graceful=graceful,
                                             layer_quantum=1),
                lambda: trp.departure_replay(tplan, tprof, r, graceful=graceful,
                                             layer_quantum=1))
            assert_same(got, want, f"departure {r}")


@pytest.mark.parametrize("preset", ["nano", "tx2", "a100"])
@pytest.mark.parametrize("hysteresis", [0.05, -10.0, 0.99])
def test_admission_replays_match(single_setup, preset, hysteresis):
    (jprof, jplan), (tprof, tplan) = single_setup
    jdev = {"nano": jhw.JETSON_NANO, "tx2": jhw.JETSON_TX2, "a100": jhw.A100}[preset]
    tdev = {"nano": thw.JETSON_NANO, "tx2": thw.JETSON_TX2, "a100": thw.A100}[preset]
    jext, text = jpr.extend_profile(jprof, jdev), tpr.extend_profile(tprof, tdev)
    for allowed in (None, {3}, {4}, {1, 2, 4}):
        want, got = both(
            lambda: jrp.admission_replay(jplan, jext, 3, hysteresis=hysteresis,
                                         layer_quantum=1, allowed_stages=allowed),
            lambda: trp.admission_replay(tplan, text, 3, hysteresis=hysteresis,
                                         layer_quantum=1, allowed_stages=allowed))
        assert_same(got, want, f"admission {allowed}")


def test_replays_raise_where_repro_raises():
    """One device, one stage: a failure leaves no survivor (RuntimeError in
    both); a replay on too few periods for its stages fails alike."""
    jprof, jplan = _single_device(jmodels, jhw, jpr, jpl, jcm)
    tprof, tplan = _single_device(tmodels, thw, tpr, tpl, tcm)
    jone = dataclasses.replace(jplan, stages=(jpl.StagePlan((0, 14), (0,), (16,), 1),))
    tone = dataclasses.replace(tplan, stages=(tpl.StagePlan((0, 14), (0,), (16,), 1),))
    with pytest.raises(RuntimeError, match="no surviving devices"):
        jrp.lightweight_replay(jone, jprof, 0)
    with pytest.raises(RuntimeError, match="no surviving devices"):
        trp.lightweight_replay(tone, tprof, 0)
    both(lambda: jrp.departure_replay(jone, jprof, 0, graceful=True),
         lambda: trp.departure_replay(tone, tprof, 0, graceful=True))
    both(lambda: jrp.lightweight_replay(jplan, jprof, 1, layer_quantum=12),
         lambda: trp.lightweight_replay(tplan, tprof, 1, layer_quantum=12))


# ---------------------------------------------------------------------------
# the membership controller
# ---------------------------------------------------------------------------


class _Exec:
    """A scripted executor: each call is logged, the report is the replay's."""

    def __init__(self, rp, report, decision=None):
        self.rp, self.report, self.decision, self.calls = rp, report, decision, []

    def replan(self, rank):
        self.calls.append(("replan", rank))
        return self.report

    def drain_replan(self, rank):
        self.calls.append(("drain", rank))
        return self.report

    def evict_replan(self, rank):
        self.calls.append(("evict", rank))
        return self.report

    def admit_replan(self, event):
        self.calls.append(("admit",))
        return self.decision

    def migrate(self, report):
        self.calls.append(("migrate",))
        return "mig"

    def resume(self, report, migration):
        self.calls.append(("resume", migration))


def _drive(rp, report, decision, device):
    c = rp.MembershipController([0, 1, 2])
    log = []
    t = 0.0
    while t < 1.0:
        t = round(t + 0.5, 3)
        for r in (0, 1, 2):
            c.heartbeat(r, t)
        log.append(c.poll(t))
    confirmed = None
    while confirmed is None:            # rank 2 dies
        t = round(t + 0.5, 3)
        for r in (0, 1):
            c.heartbeat(r, t)
        confirmed = c.poll(t)
    ex = _Exec(rp, report, decision)
    c.run_recovery(confirmed, ex, now=t)
    c.handle(rp.DeviceDraining(1), ex, now=t + 1)
    c.handle(rp.DeviceEvicted(0), ex, now=t + 2)
    c.handle(rp.DeviceJoined(device, None, 0.05), ex, now=t + 3)
    with pytest.raises(RuntimeError, match="confirmed failure"):
        c.run_recovery(1, ex)
    return log, c.events, ex.calls, dict(c.last_beat), c.state


@pytest.mark.parametrize("accepted", [True, False])
def test_controller_transitions_match(single_setup, accepted):
    (jprof, jplan), (tprof, tplan) = single_setup
    # the same replan time on both sides (it is a wall-clock reading)
    jrep = dataclasses.replace(jrp.lightweight_replay(jplan, jprof, 2, layer_quantum=1),
                               replan_s=0.25)
    trep = dataclasses.replace(trp.lightweight_replay(tplan, tprof, 2, layer_quantum=1),
                               replan_s=0.25)
    jdec = jrp.AdmissionDecision(accepted, jrep if accepted else None, 1.0, 0.5, 0.05,
                                 0.01, "r")
    tdec = trp.AdmissionDecision(accepted, trep if accepted else None, 1.0, 0.5, 0.05,
                                 0.01, "r")
    want = _drive(jrp, jrep, jdec, jhw.JETSON_NX)
    got = _drive(trp, trep, tdec, thw.JETSON_NX)
    assert got == want
    assert [s for s, _, _ in got[1]][:3] == ["monitoring", "probing", "confirmed"]
    assert trp.ReplayCoordinator is trp.MembershipController


def test_probe_answered_resumes_monitoring():
    out = []
    for rp in (jrp, trp):
        c = rp.MembershipController([0, 1], heartbeat_period=0.5, timeout=1.0,
                                    probe_timeout=1.0)
        c.heartbeat(0, 3.0)
        first = c.poll(3.0)
        suspect = (c.state, c.suspect)
        c.heartbeat(1, 3.5)
        out.append((first, suspect, c.poll(3.6), c.state, c.suspect, c.events))
    assert out[0] == out[1]
    assert out[1][1] == ("probing", 1) and out[1][3] == "monitoring"


# ---------------------------------------------------------------------------
# replan_for_membership and the gap reports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", "ABCD")
def test_replan_for_membership_and_gaps_match(env):
    jcfg, tcfg = jget_smoke("phi3-mini-3.8b"), get_smoke_config("phi3-mini-3.8b")
    jt, tt = (jpr.LayerTable.from_model_config(jcfg, 64),
              tpr.LayerTable.from_model_config(tcfg, 64))
    jprof = jpr.Profile.analytic(jt, jhw.ENVS[env]().sorted_by_memory(), 16)
    tprof = tpr.Profile.analytic(tt, thw.ENVS[env]().sorted_by_memory(), 16)
    for staleness, comp in ((0, None), (1, "int8")):
        jplan = jpl.plan_hpp(jprof, 16, 4, arch=jcfg.name, staleness=staleness,
                             compress=comp and jcm.CompressionConfig(fmt=comp))
        tplan = tpl.plan_hpp(tprof, 16, 4, arch=tcfg.name, staleness=staleness,
                             compress=comp and tcm.CompressionConfig(fmt=comp))
        n = len(jprof.cluster.devices)
        for ranks in (range(n), range(n - 1), (0,)):
            jsub, tsub = jpr.subset_profile(jprof, ranks), tpr.subset_profile(tprof, ranks)
            want, got = both(lambda: jpl.replan_for_membership(jsub, jplan, {1, 2, 4}),
                             lambda: tpl.replan_for_membership(tsub, tplan, {1, 2, 4}))
            assert_same(got, want, f"replan {list(ranks)}")
        ext_j = jpr.extend_profile(jprof, jhw.A100)
        ext_t = tpr.extend_profile(tprof, thw.A100)
        assert_same(tpl.replan_for_membership(ext_t, tplan),
                    jpl.replan_for_membership(ext_j, jplan))
        for jref, tref in ((jprof, tprof), (ext_j, ext_t)):
            assert_same(tsi.prediction_gap(tplan, tref), jsi.prediction_gap(jplan, jref))
            assert_same(tsi.observed_gap(tplan, tref, 0.37),
                        jsi.observed_gap(jplan, jref, 0.37))
        # a profile with fewer devices than the plan names: repro fails with
        # an IndexError in the pricing, the port with reprice_plan's ValueError
        used = 1 + max(d for st in tplan.stages for d in st.group)
        if used > 1:
            small_t = tpr.subset_profile(tprof, range(used - 1))
            with pytest.raises(IndexError):
                jsi.prediction_gap(jplan, jpr.subset_profile(jprof, range(used - 1)))
            with pytest.raises(ValueError, match="plan names"):
                tsi.prediction_gap(tplan, small_t)
            with pytest.raises(ValueError, match="plan names"):
                tsi.observed_gap(tplan, small_t, 1.0)


# ---------------------------------------------------------------------------
# the replay half of the lowering
# ---------------------------------------------------------------------------


def _lp(mod, stage_periods, n_periods=8):
    P = len(stage_periods)
    return mod.LoweredPlan(arch="t", stage=P, n_micro=4, micro_batch=2, global_batch=8,
                           n_periods=n_periods, stage_periods=stage_periods,
                           stage_layers=tuple((0, 0) for _ in range(P)),
                           device_groups=tuple((p,) for p in range(P)),
                           micro_alloc=tuple((2,) for _ in range(P)),
                           warmup=tuple(jcm.kp_policy(P, p) for p in range(P)))


@pytest.mark.parametrize("splits", [(((0, 5), (5, 8)), ((0, 3), (3, 8))),
                                    (((0, 4), (4, 8)), ((0, 2), (2, 5), (5, 8))),
                                    (((0, 2), (2, 3), (3, 8)), ((0, 8),))])
def test_period_owner_and_snap_match(splits):
    for sp in splits:
        assert tlo.period_owner(_lp(tlo, sp)) == jlo.period_owner(_lp(jlo, sp))
        # the port's rows are the canonical periods; repro's, its arranged slots
        assert tlo.period_positions(_lp(tlo, sp)) == {t: t for t in range(8)}
    take, mask = tlo.migration_index(_lp(tlo, splits[0]), _lp(tlo, splits[1]))
    assert take == list(range(8)) and mask == [1.0] * 8


def test_full_width_failure_cluster_replays_lightweight():
    """The virtual cluster chip_smoke.py's phase 6d (c) fails a device of:
    3 devices of 36 GB on a model axis of 6, at phi3-mini's full width.
    The plan has 3 single-device stages; losing any one leaves 2 stages
    that hold the 61.1 GB of state under Eq. 3 and lower on the model axis
    (a lightweight replay, no heavy fallback).  4 x 20 GB (phase 6c) cannot
    survive a failure."""
    cfg = get_config("phi3-mini-3.8b")
    table = tpr.LayerTable.from_model_config(cfg, 256)
    comp = tcm.CompressionConfig(fmt="int8", bucket_mb=256, error_feedback=False)

    def cluster(n, gb):
        devs = tuple(thw.DeviceProfile(f"cuda:0/v{k}", mem_bytes=gb * 1e9, flops=2.5e13,
                                       sat_batch=0.0, sat_flops=0.0, overhead=0.0)
                     for k in range(n))
        return tpr.Profile.analytic(table, thw.Cluster(devs, bandwidth=thw.MBPS_1000), 8)

    prof = cluster(3, 36)
    plan = tpl.plan_hpp(prof, 8, 2, arch=cfg.name, allowed_stages={1, 2, 3, 6},
                        staleness=1, compress=comp)
    lp = tlo.lower_plan(plan, cfg, 6)
    plan = tlo.snap_plan(plan, lp, table.L)
    assert [st.group for st in plan.stages] == [(0,), (1,), (2,)]
    for r in range(3):
        rep = trp.lightweight_replay(plan, prof, r, layer_quantum=1)
        new = tlo.relower(lp, rep.new_plan, cfg, 6)
        assert new.stage == 2 and r not in {d for g in new.device_groups for d in g}
    small = cluster(4, 20)
    plan4 = tpl.plan_hpp(small, 8, 2, arch=cfg.name, allowed_stages={1, 2, 4},
                         staleness=1, compress=comp)
    with pytest.raises(trp.AllocationError):
        trp.lightweight_replay(plan4, small, plan4.stages[-1].group[0], layer_quantum=1)
