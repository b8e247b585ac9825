"""The port's plan portfolio (``core/portfolio.py``, the session's auctions,
``launch.train --portfolio``) against ``repro``'s, on the CPU.

* Pure level, on seeded analytic profiles of 2-4 devices: the same
  candidates (families, ``plan_key``s, ``predicted_s`` to 1e-9 relative),
  ``n_enumerated`` and finalist order; ``renumber_plan``,
  ``robust_latency``, ``pick_winner`` (ties and hysteresis) and
  ``DriftWatchdog`` on the same inputs; repricing on a smaller pool, where
  ``repro`` fails with an ``IndexError`` and the port raises its
  ``ValueError``.
* Session level, with ``repro``'s weights carried over by ``interop``:
  auctions under ``measure=`` (tie, strict win, hysteresis) pick the same
  finalists and winner and install the same plan; a live auction leaves
  ``canonical_leaves`` bit for bit those of a twin never probed, and the
  next step's loss is ``repro``'s to 1e-4 relative
  (``tests/test_torch_session.py``'s tolerance); after a failure the next
  step auctions 2 candidates planned on the survivors only; a watchdog trip
  queues an auction for the next step.
* The launcher's opening auction, and the per-leaf digests it compares.
"""

import json
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core.hardware as jhw
import repro.core.planner as jpl
import repro.core.portfolio as jpf
import repro.core.profiler as jpr
import repro.core.simulator as jsi
import repro_torch.core.hardware as thw
import repro_torch.core.planner as tpl
import repro_torch.core.portfolio as tpf
import repro_torch.core.profiler as tpr
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as launcher
from repro_torch.optim import tree_leaves
from repro_torch.runtime.session import PipelineSession

B, S = 8, 32
POOL = ("JETSON_NX", "JETSON_TX2", "A100")
REL = 1e-9


@pytest.fixture(autouse=True)
def deterministic():
    """Bitwise comparisons of two runs of a step (the embedding's gradient
    is an accumulating ``index_put_``)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ---------------------------------------------------------------------------
# pure level
# ---------------------------------------------------------------------------


def _cfgs():
    jcfg = jget_smoke("phi3-mini-3.8b")
    cfg = get_smoke_config("phi3-mini-3.8b")
    return (jcfg.replace(n_layers=2 * len(jcfg.pattern)),
            cfg.replace(n_layers=2 * len(cfg.pattern)))


def _profiles(seed, n_dev=None, names=None):
    """The same seeded analytic profile in both packages: 2-4 devices drawn
    from ``POOL`` (or ``names``), a random link bandwidth."""
    rng = random.Random(seed)
    names = names or [rng.choice(POOL) for _ in range(n_dev or rng.randint(2, 4))]
    bw = rng.uniform(1e7, 1e9)
    out = []
    for cfg, hw, pr in zip(_cfgs(), (jhw, thw), (jpr, tpr)):
        table = pr.LayerTable.from_model_config(cfg, S)
        cluster = hw.Cluster(tuple(getattr(hw, n) for n in names), bw)
        out.append(pr.Profile.analytic(table, cluster, max_batch=B))
    return out


def _assert_same_candidates(got, want):
    assert [c.family for c in got] == [c.family for c in want]
    assert [c.key for c in got] == [c.key for c in want]
    assert [c.runnable for c in got] == [c.runnable for c in want]
    assert [c.note for c in got] == [c.note for c in want]
    for a, b in zip(got, want):
        assert a.predicted_s == pytest.approx(b.predicted_s, rel=REL)


@pytest.mark.parametrize("seed", range(6))
def test_enumerate_and_finalists_match_repro(seed):
    jprof, tprof = _profiles(seed)
    stages = None if seed % 2 else {1, 2}
    kw = dict(arch="phi3-mini-3.8b", allowed_stages=stages)
    want = jpf.PlanPortfolio.enumerate(jprof, B, 2, **kw)
    got = tpf.PlanPortfolio.enumerate(tprof, B, 2, **kw)
    assert got.n_enumerated == want.n_enumerated
    _assert_same_candidates(got.candidates, want.candidates)
    for k in (1, 3, 20):
        _assert_same_candidates(got.finalists(k), want.finalists(k))
    # an extra predicate (the session's "does it lower") filters alike
    def odd(c):
        return len(c.plan.stages) % 2 == 1

    _assert_same_candidates(got.finalists(2, runnable=odd), want.finalists(2, runnable=odd))
    assert got.records() == want.records()


@pytest.mark.parametrize("seed", range(3))
def test_on_profile_and_renumber_match_repro(seed):
    """Repricing every candidate on another pool of the same size, and a
    portfolio planned on a subset mapped back to the parent's ranks."""
    jprof, tprof = _profiles(seed, n_dev=4)
    jother, tother = _profiles(seed + 100, n_dev=4)
    want = jpf.PlanPortfolio.enumerate(jprof, B, 2).on_profile(jother)
    got = tpf.PlanPortfolio.enumerate(tprof, B, 2).on_profile(tother)
    _assert_same_candidates(got.candidates, want.candidates)
    ranks = (3, 1, 2)
    want = jpf.PlanPortfolio.enumerate(jpr.subset_profile(jprof, ranks), B, 2, ranks=ranks)
    got = tpf.PlanPortfolio.enumerate(tpr.subset_profile(tprof, ranks), B, 2, ranks=ranks)
    _assert_same_candidates(got.candidates, want.candidates)
    for c in got.candidates:
        if c.plan is not None:
            assert {d for st in c.plan.stages for d in st.group} <= set(ranks)
    plan = tpf.PlanPortfolio.enumerate(tprof, B, 2).finalists(1)[0].plan
    jplan = jpf.PlanPortfolio.enumerate(jprof, B, 2).finalists(1)[0].plan
    perm = (2, 0, 3, 1)
    got, want = tpf.renumber_plan(plan, perm), jpf.renumber_plan(jplan, perm)
    assert tpf.plan_key(got) == jpf.plan_key(want)
    assert [s.group for s in got.steps] == [s.group for s in want.steps]


ROUNDS = [[50.0, 1.0, 1.2, 1.1], [2.0], [3.0, 1.0], [5.0, 2.0, 1.0, 4.0, 3.0], [1.0, 1.0, 1.0]]
#: (measured rounds in predicted order, hysteresis, the winner): exact ties
#: keep the analytic first choice, a 5% faster challenger loses under a 10%
#: margin and a 15% faster one wins
MEASURED = [([1.0, 1.0, 1.0], 0.0, 0), ([1.0, 0.95], 0.10, 0), ([1.0, 0.85], 0.10, 1),
            ([2.0, 1.5, 1.5, 3.0], 0.0, 1), ([0.3, 0.2, 0.25, 0.2], 0.0, 1), ([1.0], 0.5, 0)]


@pytest.mark.parametrize("rounds", ROUNDS)
def test_robust_latency_matches_repro(rounds):
    for warmup in (0, 1, 2):
        assert tpf.robust_latency(rounds, warmup) == jpf.robust_latency(rounds, warmup)
    with pytest.raises(ValueError):
        tpf.robust_latency([])


@pytest.mark.parametrize("measured,hysteresis,winner", MEASURED)
def test_pick_winner_matches_repro(measured, hysteresis, winner):
    assert tpf.pick_winner(measured, hysteresis) == jpf.pick_winner(measured, hysteresis) \
        == winner


@pytest.mark.parametrize("seed", range(3))
def test_drift_watchdog_trips_as_repro(seed):
    jprof, tprof = _profiles(seed, n_dev=3)
    jplan = jpl.plan_hpp(jprof, B, 2, arch="phi3-mini-3.8b")
    tplan = tpl.plan_hpp(tprof, B, 2, arch="phi3-mini-3.8b")
    rng = random.Random(seed)
    obs = [rng.uniform(0.5, 1.0) * (3.0 if 6 <= k < 12 else 1.0) for k in range(24)]
    wj = jpf.DriftWatchdog(threshold=0.25, warmup=1)
    wt = tpf.DriftWatchdog(threshold=0.25, warmup=1)
    wj.install(jplan, jprof)
    wt.install(tplan, tprof)
    assert wt.predicted_s == pytest.approx(wj.predicted_s, rel=REL)
    trips = []
    for x in obs:
        a, b = wt.observe(x), wj.observe(x)
        assert a == b and wt.drift == pytest.approx(wj.drift, rel=REL, abs=1e-12)
        trips.append(a)
    assert any(trips) and wt.trips == wj.trips and wt.observations == wj.observations


@pytest.mark.parametrize("seed", range(3))
def test_reprice_on_a_smaller_pool_raises_value_error(seed):
    """Where a plan names more devices than the target profile has, repro
    fails with an IndexError and the port raises its ValueError: in
    ``DriftWatchdog.install`` and ``PlanPortfolio.on_profile``."""
    jprof, tprof = _profiles(seed, names=["JETSON_NX"] * 4)
    jplan = jpl.plan_dp(jprof, B, 2, arch="phi3-mini-3.8b", heterogeneous=True)
    tplan = tpl.plan_dp(tprof, B, 2, arch="phi3-mini-3.8b", heterogeneous=True)
    used = 1 + max(d for st in jplan.stages for d in st.group)
    assert used == 1 + max(d for st in tplan.stages for d in st.group) == 4
    n = 1 + seed
    jsub, tsub = jpr.subset_profile(jprof, range(n)), tpr.subset_profile(tprof, range(n))
    with pytest.raises(IndexError):
        jsi.reprice_plan(jplan, jsub)
    with pytest.raises(IndexError):
        jpf.DriftWatchdog().install(jplan, jsub)
    with pytest.raises(ValueError, match="plan names"):
        tpf.DriftWatchdog().install(tplan, tsub)
    with pytest.raises(ValueError, match="plan names"):
        tpf.PlanPortfolio.enumerate(tprof, B, 2).on_profile(tsub)
    with pytest.raises(IndexError):
        jpf.PlanPortfolio.enumerate(jprof, B, 2).on_profile(jsub)


# ---------------------------------------------------------------------------
# session level
# ---------------------------------------------------------------------------


def _plan_recipe(mod_hw, mod_pr, mod_pl, cfg):
    """test_portfolio_props.py's ``_make_session``: one stage over 3 boards."""
    table = mod_pr.LayerTable.from_model_config(cfg, S)
    prof = mod_pr.Profile.analytic(table, mod_hw.Cluster((mod_hw.JETSON_NX,) * 3, 1e9 / 8),
                                   max_batch=B)
    return mod_pl.plan_hpp(prof, B, micro_batch=4, arch=cfg.name, allowed_stages={1}), prof


@pytest.fixture(scope="module")
def repro_weights():
    """repro's initial weights for the smoke session, as numpy."""
    from repro.models.model import init_model as jinit_model
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jinit_model(jax.random.PRNGKey(0), jcfg))


def _repro_session(**kw):
    from repro.runtime.session import PipelineSession as JSession
    jcfg, _ = _cfgs()
    plan, prof = _plan_recipe(jhw, jpr, jpl, jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    sess = JSession(jcfg, mesh, plan, prof, backup_every=1, **kw)
    sess.init(jax.random.PRNGKey(0))
    return sess


def _port_session(weights, **kw):
    _, cfg = _cfgs()
    plan, prof = _plan_recipe(thw, tpr, tpl, cfg)
    sess = PipelineSession(cfg, 1, plan, prof, backup_every=1, device="cpu", **kw)
    sess.init(0)
    sess.params = params_from_numpy(weights, "cpu")
    sess.opt_state = sess.optimizer.init(sess.params)
    return sess


def _batches(n, start=0):
    from repro.data import SyntheticLM
    jcfg, _ = _cfgs()
    ds = SyntheticLM(jcfg.vocab_size, S)
    return [ds.batch(k, B) for k in range(start, start + n)]


def _sequence(values):
    """``measure=`` returning ``values`` in call order (finalists probe in
    predicted order in both packages)."""
    it = iter(values)
    return lambda c: next(it)


MEASURES = {"tie": (lambda c: c.predicted_s, 0.0),
            "strict": ([3.0, 2.0, 1.0], 0.0),
            "hysteresis": ([1.0, 0.95, 0.97], 0.10)}


@pytest.mark.parametrize("case", list(MEASURES))
def test_measured_auctions_match_repro(repro_weights, case):
    fn, hysteresis = MEASURES[case]
    jsess, sess = _repro_session(), _port_session(repro_weights)
    reports = []
    for s in (jsess, sess):
        measure = fn if callable(fn) else _sequence(fn)
        reports.append(s.probe_portfolio(k=3, measure=measure, hysteresis=hysteresis))
    want, got = reports
    assert [r.family for r in got.results] == [r.family for r in want.results]
    assert [r.measured_s for r in got.results] == [r.measured_s for r in want.results]
    assert [r.installed for r in got.results] == [r.installed for r in want.results]
    assert got.winner_index == want.winner_index and got.churned == want.churned
    assert (got.n_candidates, got.n_enumerated) == (want.n_candidates, want.n_enumerated)
    rec_g, rec_w = got.to_record(), want.to_record()
    assert rec_g.keys() == rec_w.keys()
    for k in rec_w:
        if isinstance(rec_w[k], float):
            assert rec_g[k] == pytest.approx(rec_w[k], rel=REL)
        else:
            assert rec_g[k] == rec_w[k]
    assert tpf.plan_key(sess.plan) == jpf.plan_key(jsess.plan)
    assert sess.ts.spec.staleness == jsess.ts.spec.staleness
    assert sess.ts.spec.compress == jsess.ts.spec.compress
    if case == "hysteresis":
        assert got.winner_index == 0
    if case == "strict":
        assert got.winner_index == len(got.results) - 1 and got.churned


def test_live_auction_is_bit_identical_and_next_loss_matches_repro(repro_weights):
    """k=2, window=1 between steps 2 and 3: the probed session's state bit
    for bit a never-probed twin's; the next step's loss repro's."""
    batches = _batches(3)
    jsess = _repro_session()
    sess, twin = _port_session(repro_weights), _port_session(repro_weights)
    for b in batches[:2]:
        for s in (jsess, sess, twin):
            s.step(b)
    report = sess.probe_portfolio(batches[2], k=2, window=1)
    assert report.winner.installed and len(report.results) == 2
    assert all(len(r.rounds) == 2 and r.device_rounds == () for r in report.results)
    got, want = sess.canonical_leaves(), twin.canonical_leaves()
    assert got.keys() == want.keys() == {"params", "m", "v"}
    for k in want:
        for a, b in zip(tree_leaves(got[k]), tree_leaves(want[k]), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert sess.canonical_digests() == twin.canonical_digests()
    jsess.probe_portfolio(k=2, measure=lambda c: c.predicted_s)
    loss, want_loss = sess.step(batches[2])[0], jsess.step(batches[2])[0]
    assert np.isfinite(loss) and abs(loss - want_loss) <= 1e-4 * abs(want_loss)


def test_post_churn_auction_plans_on_the_survivors(repro_weights):
    """After ``fail(2)`` the next ``step()`` recovers, then runs a
    2-candidate auction planned on ``subset_profile`` of ranks (0, 1), as
    repro's does (probe rounds stubbed to equal times on both sides, so the
    decision is the planner's order)."""
    jsess = _repro_session(portfolio_k=3)
    sess = _port_session(repro_weights, portfolio_k=3)
    jsess._probe_rounds = lambda batch, window: [1.0] * (window + 1)
    sess._probe_rounds = lambda batch, window: ([1.0] * (window + 1), [])
    batches = _batches(3)
    for s in (jsess, sess):
        s.step(batches[0])
        s.fail(2)
        assert not s.auctions
        s.step(batches[1])
        assert len(s.recoveries) == 1 and len(s.auctions) == 1
    want, got = jsess.auctions[0], sess.auctions[0]
    assert len(got.results) == 2 and got.window == sess.probation_window == 2
    assert [r.family for r in got.results] == [r.family for r in want.results]
    assert got.winner_index == want.winner_index and got.churned == want.churned
    assert (got.n_candidates, got.n_enumerated) == (want.n_candidates, want.n_enumerated)
    assert tpf.plan_key(sess.plan) == jpf.plan_key(jsess.plan)
    assert sess.live_ranks == jsess.live_ranks
    assert set(d for st in sess.plan.stages for d in st.group) <= {0, 1}
    assert not sess._auction_pending and np.isfinite(sess.step(batches[2])[0])
    assert len(sess.auctions) == 1


def test_watchdog_trip_queues_an_auction(repro_weights):
    """Synthetic step times: the baseline, then a 3x slower regime; the
    trip at step 1 queues a ``portfolio_k``-candidate auction that step 2
    runs before training."""
    dog = tpf.DriftWatchdog(threshold=0.25, warmup=0)
    sess = _port_session(repro_weights, portfolio_k=2, probation_window=1,
                         drift_watchdog=dog)
    assert dog.predicted_s is not None
    feed = iter([1.0, 3.0, 3.0])
    observe = dog.observe
    dog.observe = lambda _wall: observe(next(feed))
    batches = _batches(3)
    sess.step(batches[0])
    assert not sess._auction_pending and dog.trips == 0
    sess.step(batches[1])
    assert sess._auction_pending and sess._auction_k == 2 and dog.trips == 1
    assert not sess.auctions
    sess.step(batches[2])
    assert len(sess.auctions) == 1 and not sess._auction_pending
    assert len(sess.auctions[0].results) == 2
    assert all(len(r.rounds) == 2 for r in sess.auctions[0].results)
    # the auction re-armed the watchdog: step 2's time set a new baseline
    assert dog.trips == 1 and dog.observations == 3 and dog.baseline is not None


def test_portfolio_session_builds_without_refusal(repro_weights):
    sess = _port_session(repro_weights, portfolio_k=2)
    assert sess.coordinator.auction_hook == sess._on_membership_swap
    assert _port_session(repro_weights).coordinator.auction_hook is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_opening_auction(capsys):
    res = launcher.main(["--smoke", "--device", "cpu", "--plan", "--portfolio", "2",
                         "--probation-rounds", "1", "--steps", "2", "--global-batch", "8",
                         "--seq", "32", "--log-every", "1"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("portfolio: ")]
    assert len(lines) == 2
    assert lines[0].startswith("portfolio: winner installed ")
    assert lines[1] == "portfolio: probation state bit-identical: True"
    rec = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("PORTFOLIO "))[len("PORTFOLIO "):])
    assert rec["bit_identical"] is True and rec["window"] == 1
    report, identical = res["portfolio"]
    assert identical and rec["finalists"] == len(report.results) <= 2
    assert out.count("  finalist ") == len(report.results)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["session"].auctions == [report]


def test_digests_see_one_flipped_bit(repro_weights):
    sess = _port_session(repro_weights)
    before = sess.canonical_digests()
    assert len(before) == sum(len(tree_leaves(t)) for t in (
        sess.params, sess.opt_state.m, sess.opt_state.v))
    leaf = tree_leaves(sess.params["periods"])[1]
    bits = leaf.view(torch.int32).view(-1)
    bits[7] ^= 1 << 3
    after = sess.canonical_digests()
    assert after != before
    assert sum(a != b for a, b in zip(after, before)) == 1
    bits[7] ^= 1 << 3
    assert sess.canonical_digests() == before


def test_cut_layers_serves_a_shallower_model():
    """``launch.profile.cut_layers``: the embedding, the first n block
    layers and the head of an artifact, restamped so that the cut model
    plans on it (not stale)."""
    from repro_torch.launch.profile import cut_layers

    deep = get_smoke_config("phi3-mini-3.8b").replace(n_layers=6)
    table = tpr.LayerTable.from_model_config(deep, S)
    rng = np.random.default_rng(0)
    tf = rng.uniform(1e-3, 2e-3, (2, 3, table.L))
    mp = tpr.MeasuredProfile(
        arch=deep.name, seq_len=S, batch_sizes=(1, 2, 4),
        layer_names=tuple(layer.name for layer in table.layers), tf=tf, tb=2 * tf,
        device_names=("cpu:0/v0", "cpu:0/v1"), config_hash=tpr.config_fingerprint(deep, S),
        device_hash=tpr.device_fingerprint("cpu"), mem_bytes=(1e9, 1e9),
        est_flops=(1e10, 1e10))
    cfg = deep.replace(n_layers=2)
    cut = cut_layers(mp, cfg)
    assert cut.layer_names == mp.layer_names[:3] + mp.layer_names[-1:]
    assert np.array_equal(cut.tf, tf[:, :, [0, 1, 2, table.L - 1]])
    assert np.array_equal(cut.tb, 2 * cut.tf)
    small = tpr.LayerTable.from_model_config(cfg, S)
    assert mp.compatibility_issues(cfg, S, device="cpu")
    prof = tpr.resolve_profile(cut, cfg, S, small, B, device="cpu")
    assert prof is not None and prof.source == "measured" and prof.table.L == small.L
    with pytest.raises(ValueError, match="not a cut"):
        cut_layers(mp, deep.replace(n_layers=8))
