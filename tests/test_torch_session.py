"""The port's session layer against ``repro``'s, on the CPU: migration,
backups and recovery, membership transitions, checkpoints, the launcher.

* ``migrate_params`` / ``migrate_opt_state`` on one card: the period stack
  stays in model order under every split, so a migration is the identity
  (the same tensors; A -> B -> A bit for bit), and its report (moved,
  restored and direct periods, per-boundary bytes) equals ``repro``'s on
  its arranged stack; ``reconcile_migration`` agrees with ``repro``'s on
  a lightweight replay's report.
* A failure at step k restores the failed stage's rows and edge leaves
  from the last backup bit for bit, and leaves every other row as it was.
* A rejected join changes nothing (the same plan, step and profile
  objects, the state bit for bit); a join then an evict of the newcomer
  gives the state back bit for bit.
* Every membership transition, and ``_install`` itself, applies a held
  staleness-1 update first (as ``tests/test_session.py`` holds ``repro``).
* A single-stage session through a drain and an evict, from ``repro``'s
  weights: the same transitions, modes and clock as ``repro``'s
  ``_membership_session`` and the loss of every step within 1e-4 relative
  (``tests/test_torch_train.py``'s stage-1 tolerance).
* Checkpoints cross between the packages: the port's restore with
  ``repro.checkpoint.restore`` and ``repro``'s with the port's, bit for
  bit, bf16 leaves and optimizer states included.
"""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.checkpoint as jck
import repro.core.costmodel as jcm
import repro.core.hardware as jhw
import repro.core.lowering as jlo
import repro.core.planner as jpl
import repro.core.profiler as jpr
import repro.core.replay as jrp
import repro.models as jmodels
import repro_torch.checkpoint as tck
import repro_torch.core.costmodel as tcm
import repro_torch.core.hardware as thw
import repro_torch.core.lowering as tlo
import repro_torch.core.planner as tpl
import repro_torch.core.profiler as tpr
import repro_torch.core.replay as trp
import repro_torch.models.config as tmodels
from repro.configs import get_smoke_config as jget_smoke
from repro.models.model import init_model as jinit_model
from repro.runtime.pipeline import arrange_periods
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launcher
from repro_torch.models.model import init_model
from repro_torch.optim import AdamW, AdamWState, tree_leaves, tree_map
from repro_torch.runtime.session import PipelineSession


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _bits(t) -> np.ndarray:
    t = t.detach().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()]).numpy()


def _same_bits(ta, tb) -> bool:
    la, lb = tree_leaves(ta), tree_leaves(tb)
    return len(la) == len(lb) and all(np.array_equal(_bits(a), _bits(b))
                                      for a, b in zip(la, lb))


def _assert_same_canonical(got, want):
    """``PipelineSession.canonical_leaves`` trees bit for bit."""
    assert set(got) == set(want) == {"params", "m", "v"}
    for k in want:
        gl, wl = tree_leaves(got[k]), tree_leaves(want[k])
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _snapshot(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


@pytest.fixture(autouse=True)
def deterministic():
    """Bitwise comparisons of two runs of a step: the CPU's accumulating
    ``index_put_`` (the embedding's gradient) is summed in a varying order
    otherwise."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke shapes: one intra-op thread is as fast, and test workers that
    share the cores do not spin against each other."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ---------------------------------------------------------------------------
# migration on one card, and the reconciliation
# ---------------------------------------------------------------------------


def _lp(mod, stage_periods, n_periods=8):
    P = len(stage_periods)
    return mod.LoweredPlan(arch="t", stage=P, n_micro=4, micro_batch=2, global_batch=8,
                           n_periods=n_periods, stage_periods=stage_periods,
                           stage_layers=tuple((0, 0) for _ in range(P)),
                           device_groups=tuple((p,) for p in range(P)),
                           micro_alloc=tuple((2,) for _ in range(P)),
                           warmup=tuple(jcm.kp_policy(P, p) for p in range(P)))


@pytest.fixture(scope="module")
def eight_periods():
    jcfg = jget_smoke("phi3-mini-3.8b").replace(n_layers=8)
    jparams = jinit_model(jax.random.PRNGKey(0), jcfg)
    return jparams, params_from_numpy(_np(jparams), "cpu")


def _report_fields(rep):
    return {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}


@pytest.mark.parametrize("splits", [(((0, 3), (3, 8)), ((0, 6), (6, 8))),
                                    (((0, 4), (4, 8)), ((0, 2), (2, 5), (5, 8))),
                                    (((0, 5), (5, 8)), ((0, 3), (3, 8)))])
def test_migration_is_identity_and_reports_as_repro(eight_periods, splits):
    jparams, params = eight_periods
    (ja, jb), (ta, tb) = ((_lp(jlo, s) for s in splits), (_lp(tlo, s) for s in splits))
    before = _snapshot(params)
    pB, trep = tlo.migrate_params(params, ta, tb)
    pA, _ = tlo.migrate_params(pB, tb, ta)
    assert all(a is b for a, b in zip(tree_leaves(pA["periods"]),
                                      tree_leaves(params["periods"])))
    assert _same_bits(pA, before) and pA["embed"] is params["embed"]
    opt = AdamW().init(params)
    assert tlo.migrate_opt_state(opt, ta, tb) is opt
    arranged = dict(jparams)
    arranged["periods"], _ = arrange_periods(jparams["periods"], ja.stage_periods)
    owners = [None, [None if t in (3, 4) else o for t, o in enumerate(tlo.period_owner(ta))],
              [tlo.DIRECT_SOURCE if t == 0 else o
               for t, o in enumerate(tlo.period_owner(ta))]]
    for owner in owners:
        _, jrep = jlo.migrate_params(arranged, ja, jb, old_owner=owner)
        _, trep = tlo.migrate_params(params, ta, tb, old_owner=owner)
        assert _report_fields(trep) == _report_fields(jrep)


def _toy_plan(mod, hw, pr, pl, cm):
    """test_session.py's ``replayable``: 3 stages (one of two devices) of a
    12-layer model whose periods are single layers."""
    cfg = mod.ModelConfig(name="t", n_layers=12, d_model=64, vocab_size=256, d_ff=128,
                          attn=mod.AttentionConfig(n_heads=2, n_kv_heads=2, head_dim=32),
                          pattern=(mod.LayerSpec(),))
    table = pr.LayerTable.from_model_config(cfg, seq_len=32)
    prof = pr.Profile.analytic(table, hw.Cluster((hw.JETSON_NX,) * 4), max_batch=16)
    stages = (pl.StagePlan((0, 5), (0, 1), (8, 8), cm.kp_policy(3, 0)),
              pl.StagePlan((5, 10), (2,), (16,), cm.kp_policy(3, 1)),
              pl.StagePlan((10, 14), (3,), (16,), cm.kp_policy(3, 2)))
    return cfg, table, prof, pl.Plan("t", stages, (), 16, 4, 1.0)


@pytest.mark.parametrize("failed", [0, 1, 2, 3])
def test_reconcile_migration_agrees_with_repro(failed):
    out = []
    for mod, hw, pr, pl, cm, lo, rp in ((jmodels, jhw, jpr, jpl, jcm, jlo, jrp),
                                        (tmodels, thw, tpr, tpl, tcm, tlo, trp)):
        cfg, table, prof, plan = _toy_plan(mod, hw, pr, pl, cm)
        old = lo.lower_plan(plan, cfg)
        plan = lo.snap_plan(plan, old, table.L)
        rep = rp.lightweight_replay(plan, prof, failed, layer_quantum=1)
        new = lo.relower(old, rep.new_plan, cfg)
        if lo is jlo:
            params = jinit_model(jax.random.PRNGKey(0), cfg)
            params = dict(params, periods=arrange_periods(params["periods"],
                                                          old.stage_periods)[0])
        else:
            params = init_model(torch.Generator().manual_seed(0), cfg, "cpu")
        # each old stage's periods owned by its survivor (None: the stage
        # died whole and restores from its backup), as the session passes
        surv = [q for q, st in enumerate(plan.stages) if st.group != (failed,)]
        owner = [surv.index(q) if q in surv else None
                 for q, (i, j) in enumerate(old.stage_periods) for _ in range(i, j)]
        _, mig = lo.migrate_params(params, old, new, old_owner=owner)
        recon = lo.reconcile_migration(mig, rep, new, table, pattern_len=1)
        out.append((_report_fields(mig), recon, new.stage_periods))
    assert out[1] == out[0]
    for rec in out[1][1].values():
        assert rec["table_bytes"] == rec["analytic_bytes"]


# ---------------------------------------------------------------------------
# sessions on the CPU
# ---------------------------------------------------------------------------

B, S = 8, 32


def _three_stage_session(staleness=0, backup_every=2):
    """Smoke phi3 at 4 layers planned into 3 single-device stages over 3
    identical boards, on a model axis of 6 (so 2 survivors still lower)."""
    cfg = get_smoke_config("phi3-mini-3.8b").replace(n_layers=4)
    table = tpr.LayerTable.from_model_config(cfg, S)
    prof = tpr.Profile.analytic(table, thw.Cluster((thw.JETSON_NX,) * 3, 1e9 / 8),
                                max_batch=B)
    plan = tpl.plan_hpp(prof, B, 2, arch=cfg.name, allowed_stages={3})
    session = PipelineSession(cfg, 6, plan, prof, backup_every=backup_every,
                              staleness=staleness, compress="int8", bucket_mb=0.25,
                              error_feedback=False, device="cpu")
    session.init(0)
    return cfg, session, SyntheticLM(cfg.vocab_size, S)


@pytest.mark.parametrize("staleness", [0, 1])
def test_failure_restores_the_last_backup(staleness):
    cfg, session, ds = _three_stage_session(staleness)
    assert [st.group for st in session.plan.stages] == [(0,), (1,), (2,)]
    q = 2                                        # the last stage: rows and head side
    for s in range(3):
        session.step(ds.batch(s, B))
        if s == 1:                               # step_count 2: backed up
            backup = _snapshot(session.store.restore(q))
            assert session.store.meta(q)["step"] == 2
    i, j = session.lowered.stage_periods[q]
    seen = {}
    migrate = session.migrate

    def watched(report):
        seen["before"] = _snapshot(session.params)   # after the flush
        assert session._held is None
        return migrate(report)

    session.migrate = watched
    session.fail(q)
    out = session.recover_now()
    assert out.mode == "lightweight" and out.restored_stage == q
    assert out.restored_periods == tuple(range(i, j))
    assert session.lowered.stage == 2 and session.live_ranks == (0, 1)
    assert out.reconciliation is not None
    rows = tree_map(lambda x: x[i:j], session.params["periods"])
    assert _same_bits(rows, backup["rows"])
    assert _same_bits({k: session.params[k] for k in backup["extras"]}, backup["extras"])
    kept = tree_map(lambda x: x[:i], session.params["periods"])
    assert _same_bits(kept, tree_map(lambda x: x[:i], seen["before"]["periods"]))
    assert _same_bits(session.params["embed"], seen["before"]["embed"])
    # the optimizer state is untouched by the migration
    assert int(session.opt_state.step) == 3
    # the backups were re-seeded for the new split
    assert session.store.meta(1)["periods"] == session.lowered.stage_periods[1]
    for s in range(3, 5):
        loss, _ = session.step(ds.batch(s, B))
        assert np.isfinite(loss)


def _membership_session(staleness=0, backup_every=0):
    """The port's counterpart of test_session.py's ``_membership_session``:
    a single-stage plan over 3 boards, model axis 1."""
    cfg = get_smoke_config("phi3-mini-3.8b")
    cfg = cfg.replace(n_layers=2 * len(cfg.pattern))
    table = tpr.LayerTable.from_model_config(cfg, S)
    prof = tpr.Profile.analytic(table, thw.Cluster((thw.JETSON_NX,) * 3, 1e9 / 8),
                                max_batch=B)
    plan = tpl.plan_hpp(prof, B, micro_batch=4, arch=cfg.name, allowed_stages={1})
    session = PipelineSession(cfg, 1, plan, prof, backup_every=backup_every,
                              staleness=staleness, device="cpu")
    session.init(0)
    return cfg, session, SyntheticLM(cfg.vocab_size, S)


def test_rejected_join_changes_nothing():
    cfg, session, ds = _membership_session()
    session.step(ds.batch(0, B))
    plan0, ts0, prof0 = session.plan, session.ts, session.profile
    before = session.canonical_leaves()
    out = session.admit(thw.JETSON_TX2, hysteresis=0.99)
    assert not out.accepted and out.mode == "admission"
    assert "hysteresis" in out.decision.reason
    assert out.stall_s == pytest.approx(out.decision.replan_s)
    assert session.plan is plan0 and session.ts is ts0 and session.profile is prof0
    assert session.live_ranks == (0, 1, 2) and session.memberships[-1] is out
    _assert_same_canonical(session.canonical_leaves(), before)


def test_join_then_evict_is_bitwise():
    cfg, session, ds = _membership_session()
    for s in range(2):
        session.step(ds.batch(s, B))
    before = session.canonical_leaves()
    out = session.admit(thw.A100, hysteresis=-10.0)
    assert out.accepted
    new_rank = len(session.profile.cluster.devices) - 1
    assert new_rank in session.live_ranks
    out = session.evict(new_rank)
    assert out.accepted and new_rank not in session.live_ranks
    assert int(session.opt_state.step) == 2
    _assert_same_canonical(session.canonical_leaves(), before)
    assert np.isfinite(session.step(ds.batch(2, B))[0])


@pytest.mark.parametrize("transition", ["drain", "evict", "fail", "join", "install"])
def test_transitions_flush_held_update(transition):
    """Each transition (and ``_install`` itself) applies the held update
    first: the state equals a twin that flushed by hand and then did the
    same."""
    cfg, session, ds = _membership_session(staleness=1)
    _, twin, _ = _membership_session(staleness=1)
    for s in range(2):
        session.step(ds.batch(s, B))
        twin.step(ds.batch(s, B))
    assert session._held is not None
    assert twin.flush_gradients() and not twin.flush_gradients()
    for sess in (session, twin):
        if transition == "install":
            sess._install(sess.plan, sess.lowered)
        elif transition == "fail":
            sess.fail(2)
            sess.recover_now()
        elif transition == "join":
            assert sess.admit(thw.A100, hysteresis=-10.0).accepted
        else:
            getattr(sess, transition)(2)
        assert sess._held is None
    if transition == "install":
        assert session.step_cache_hits == 1
    assert _same_bits((session.params, session.opt_state.m, session.opt_state.v),
                      (twin.params, twin.opt_state.m, twin.opt_state.v))
    assert int(session.opt_state.step) == int(twin.opt_state.step) == 2
    assert np.isfinite(session.step(ds.batch(2, B))[0])


def test_install_rebuilds_only_on_spec_change():
    cfg, session, _ = _membership_session()
    old = session.ts
    session._install(session.plan, session.lowered)
    assert session.step_cache_hits == 1 and session.ts is old
    session.spec_kw["staleness"] = 1
    session._install(session.plan, session.lowered)
    assert session.step_cache_hits == 1 and session.ts is not old
    assert session.ts.async_step_fn is not None
    # a portfolio session builds (no refusal) and arms the churn auction
    armed = PipelineSession(session.cfg, 1, session.plan, session.profile, portfolio_k=2,
                            device="cpu")
    assert armed.coordinator.auction_hook == armed._on_membership_swap
    assert armed.portfolio_k == 2 and not armed._auction_pending


def test_drain_evict_losses_match_repro():
    """repro's ``_membership_session`` and the port's, from repro's weights:
    steps, a drain, a step, an evict, a step."""
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.runtime.session import PipelineSession as JSession

    jcfg = jget_smoke("phi3-mini-3.8b")
    jcfg = jcfg.replace(n_layers=2 * len(jcfg.pattern))
    jtable = jpr.LayerTable.from_model_config(jcfg, S)
    jprof = jpr.Profile.analytic(jtable, jhw.Cluster((jhw.JETSON_NX,) * 3, 1e9 / 8),
                                 max_batch=B)
    jplan = jpl.plan_hpp(jprof, B, micro_batch=4, arch=jcfg.name, allowed_stages={1})
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jsess = JSession(jcfg, mesh, jplan, jprof, backup_every=1)
    jsess.init(jax.random.PRNGKey(0))
    cfg, sess, _ = _membership_session(backup_every=1)
    sess.params = params_from_numpy(_np(jsess.params), "cpu")
    sess.opt_state = sess.optimizer.init(sess.params)
    ds = JSyntheticLM(jcfg.vocab_size, S)
    script = ["step", "step", "drain", "step", "evict", "step"]
    for sessn in (jsess, sess):
        sessn.losses = []
        for k, what in enumerate(script):
            if what == "step":
                sessn.losses.append(sessn.step(ds.batch(k, B))[0])
            else:
                getattr(sessn, what)(1 if what == "drain" else 2)
    for a, b in zip(sess.losses, jsess.losses):
        assert abs(a - b) <= 1e-4 * abs(b), (sess.losses, jsess.losses)
    assert [(o.mode, o.report.mode, o.restored_periods, o.accepted)
            for o in sess.memberships] == [
        (o.mode, o.report.mode, o.restored_periods, o.accepted) for o in jsess.memberships]
    assert sess.live_ranks == jsess.live_ranks == (0,)
    assert [s for s, _, _ in sess.coordinator.events] == \
        [s for s, _, _ in jsess.coordinator.events]
    assert sess.store.has(0) and jsess.store.has(0)
    assert sess.step_count == jsess.step_count == 4


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _bf16_tree(rng):
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "h": {"b": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16),
                  "a": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "f8": rng.standard_normal((8,)).astype(ml_dtypes.float8_e4m3fn)}


def test_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(4)
    tree_np = _bf16_tree(rng)
    params = params_from_numpy({k: v for k, v in tree_np.items() if k != "f8"}, "cpu")
    params["f8"] = torch.from_numpy(tree_np["f8"].view(np.uint8).copy()).view(
        torch.float8_e4m3fn)
    opt = AdamW().init({"w": params["w"], "h": {"b": params["h"]["b"].float()}})
    opt.m["w"].normal_()
    # port -> repro
    tck.save(str(tmp_path), "p", params)
    tck.save(str(tmp_path), "o", opt)
    got = jck.restore(str(tmp_path), "p", jax.tree.map(jax.numpy.asarray, tree_np))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree_np)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a).view(np.uint8),
                                                     b.view(np.uint8))
    jopt = jck.restore(str(tmp_path), "o", tuple(jax.tree.map(np.asarray, (
        int(opt.step), params_to_numpy(opt.m), params_to_numpy(opt.v)))))
    assert np.array_equal(np.asarray(jopt[1]["w"]), opt.m["w"].numpy())
    # repro -> port
    jck.save(str(tmp_path), "j", tree_np)
    back = tck.restore(str(tmp_path), "j", params)
    assert _same_bits(back, params)
    assert back["h"]["b"].dtype == torch.bfloat16 and back["f8"].dtype == torch.float8_e4m3fn
    restored = tck.restore(str(tmp_path), "o", opt)
    assert isinstance(restored, AdamWState) and _same_bits(restored, opt)
    with pytest.raises(ValueError, match="leaves"):
        tck.restore(str(tmp_path), "j", {"w": params["w"]})


def test_stage_backup_store_reuses_its_buffer():
    store = tck.StageBackupStore()
    rows = {"a": torch.randn(3, 4), "b": {"c": torch.randn(3, 2).bfloat16()}}
    store.backup(0, rows, meta={"periods": (0, 3), "step": 1})
    first = tree_leaves(store.restore(0))
    assert _same_bits(store.restore(0), rows)
    rows2 = tree_map(lambda t: t * 2, rows)
    store.backup(0, rows2, meta={"periods": (0, 3), "step": 2})
    assert all(a is b for a, b in zip(tree_leaves(store.restore(0)), first))
    assert _same_bits(store.restore(0), rows2) and store.meta(0)["step"] == 2
    assert store.bytes_transferred == 2 * (12 * 4 + 6 * 2)
    store.drop(0)
    assert not store.has(0)
    with pytest.raises(KeyError):
        store.restore(0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--devices", "2", "--staleness", "1",
                                        "--compress", "int8", "--backup-every", "1"]],
                         ids=["one-stage", "two-stage-stale-int8"])
def test_launcher_recovers_from_a_failure(capsys, tmp_path, flags):
    res = launcher.main(["--smoke", "--device", "cpu", "--plan", "--fail-at", "2",
                         "--steps", "4", "--global-batch", "8", "--seq", "32",
                         "--log-every", "1", "--checkpoint-dir", str(tmp_path), *flags])
    out = capsys.readouterr().out
    assert "killing rank" in out and "recovered (" in out
    assert "FINAL sim_tok_s=" in out and "FINAL tok_s=" in out
    assert len(res["losses"]) == 4 and all(np.isfinite(res["losses"]))
    session = res["session"]
    assert len(session.recoveries) == 1 and session._held is None
    assert int(session.opt_state.step) == 4
    assert _same_bits(tck.restore(str(tmp_path), "final", session.params), session.params)


def test_launcher_runs_an_event_schedule(capsys):
    launcher.main(["--smoke", "--device", "cpu", "--plan", "--devices", "2", "--steps", "4",
                   "--global-batch", "8", "--seq", "32", "--events",
                   "join@1:a100,drain@2:1,evict@3", "--hysteresis", "-10"])
    out = capsys.readouterr().out
    assert "step 1: join event" in out and "joined (" in out
    assert "drain rank 1" in out and "evict rank" in out
    with pytest.raises(SystemExit, match="kind@step"):
        launcher.main(["--smoke", "--device", "cpu", "--plan", "--events", "boom@1"])
