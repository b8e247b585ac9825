"""Continuous and planned serving: the port against ``repro``.

``repro`` is the reference: its serve planner and gap reports
(``repro.core.planner``, ``repro.core.simulator``), its mesh-free
``decode_step`` decoding in lockstep, its ``engine_from_decode_step`` and
its ``ContinuousBatcher``.  Weights are ``repro``'s ``init_model`` from a
seed, carried over with ``repro_torch.interop``; inputs are numpy from a
seed.  The port runs on the CPU (plain kernel versions).

Tolerances:
* planner fields 1e-12 relative (the same arithmetic, ``plan_time``, a
  wall-clock reading, excepted), as ``tests/test_torch_plan.py``;
* logits 1e-4 abs, as ``tests/test_torch_serve.py`` (fp32 logits of order
  1; the sums run in other orders on the two sides); padded rows exactly 0;
* batcher completions exact: under a fake timer and a step whose rows
  each have one finite logit, both samplers are forced, so the two
  batchers make the same float operations on the same clock.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hardware as jhw
import repro.core.planner as jpl
import repro.core.profiler as jpr
import repro.core.simulator as jsi
import repro_torch.core.hardware as thw
import repro_torch.core.planner as tpl
import repro_torch.core.profiler as tpr
import repro_torch.core.simulator as tsi
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models.model import decode_step as jdecode_step
from repro.models.model import init_decode_states as jinit_states
from repro.models.model import init_model as jinit_model
from repro.runtime import continuous as jcont
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.common import smoke_reduce
from repro_torch.configs.jamba_1_5_large import ARCH_ID as JAMBA, config_without_experts
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.attention import attention_decode, init_attention_cache
from repro_torch.runtime import continuous as tcont
from repro_torch.runtime import serve as tserve
from test_torch_plan import assert_same, both

TOL = 1e-4
ALLOC, CACHE, STEPS, DELAY = (3, 1), 64, 6, (0, 1, 2, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the serve planner
# ---------------------------------------------------------------------------


def _cluster_profiles(name, dp, model_axis, max_batch, seq, first=0):
    """(repro's, the port's) analytic profile of ``repro``'s launcher
    cluster: data shard d is ``model_axis`` Jetson NX (d + first even) or
    TX2 (odd)."""
    out = []
    for hw, pr, cfg in ((jhw, jpr, (jget_smoke if name == "smoke" else jget_config)),
                        (thw, tpr, (get_smoke_config if name == "smoke" else get_config))):
        devs = sum(((hw.JETSON_NX if (d + first) % 2 == 0 else hw.JETSON_TX2,) * model_axis
                    for d in range(dp)), ())
        table = pr.LayerTable.from_model_config(cfg("phi3-mini-3.8b"), seq_len=seq)
        out.append(pr.Profile.analytic(table, hw.Cluster(devs, bandwidth=hw.MBPS_100),
                                       max_batch))
    return out


@pytest.mark.parametrize("name", ["smoke", "full"])
@pytest.mark.parametrize("dp,model_axis", [(1, 1), (2, 4), (4, 6), (1, 6), (2, 1), (4, 4)])
def test_serve_planner_matches_repro(name, dp, model_axis):
    jprof, tprof = _cluster_profiles(name, dp, model_axis, 8, 48)
    for axis in range(1, 9):
        for heads in (1, 3, 4, 32):
            assert tpl.serve_stage_candidates(axis, heads) == \
                jpl.serve_stage_candidates(axis, heads)
    kw = dict(dp_shards=dp, model_axis=model_axis, n_heads=32, cache_len=48, seq_len=48,
              arch="phi3")
    for load in (0.0, 5.0, 200.0, 5e4):
        for fn in ("plan_serve", "plan_serve_uniform"):
            want, got = both(lambda: getattr(jpl, fn)(jprof, load, **kw),
                             lambda: getattr(tpl, fn)(tprof, load, **kw))
            if want is None:
                continue
            assert_same(got, want, f"{fn}@{load}")
            assert (got.slots, got.throughput, got.utilization) == \
                (want.slots, want.throughput, want.utilization)
            # re-priced on the other cluster order (TX2 first), and the gap
            jref, tref = _cluster_profiles(name, dp, model_axis, 8, 48, first=1)
            assert_same(tsi.reprice_serve_plan(got, tref), jsi.reprice_serve_plan(want, jref))
            assert_same(tsi.serve_prediction_gap(got, tref),
                        jsi.serve_prediction_gap(want, jref))
    for stages in ([2], [1, 3]):
        want, got = both(lambda: jpl.plan_serve(jprof, 50.0, allowed_stages=stages, **kw),
                         lambda: tpl.plan_serve(tprof, 50.0, allowed_stages=stages, **kw))
        assert_same(got, want, f"allowed {stages}")


def test_serve_planner_refuses_as_repro():
    """An infeasible memory cap and a mesh larger than the cluster raise
    ``AllocationError`` with the same message on both sides."""
    jprof, tprof = _cluster_profiles("full", 2, 4, 8, 48)
    kw = dict(dp_shards=2, model_axis=4, n_heads=32, seq_len=48)
    for case in (dict(cache_len=48, mem_fraction=0.05),        # params alone overflow
                 dict(cache_len=48, dp_shards=3),               # 12 devices of 8
                 dict(cache_len=10 ** 9)):                      # no slot fits
        args = {**kw, **case}
        with pytest.raises(jpl.AllocationError) as want:
            jpl.plan_serve(jprof, 10.0, **args)
        with pytest.raises(tpl.AllocationError) as got:
            tpl.plan_serve(tprof, 10.0, **args)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the per-slot step, plain and on virtual stages
# ---------------------------------------------------------------------------


def _dense(pattern):
    return tuple(dataclasses.replace(s, mlp="mlp") for s in pattern)


def _configs(name):
    """(repro's, the port's) smoke config."""
    if name == "jamba":
        j = jget_smoke(JAMBA)
        return (j.replace(pattern=_dense(j.pattern), moe=None),
                smoke_reduce(config_without_experts()))
    arch = "rwkv6-7b" if name == "rwkv" else "phi3-mini-3.8b"
    j, t = jget_smoke(arch), get_smoke_config(arch)
    if name == "phi3_window":          # a ring-buffer cache that wraps within STEPS
        kw = dict(window=4, softcap=50.0)
        j = j.replace(attn=dataclasses.replace(j.attn, **kw))
        t = t.replace(attn=dataclasses.replace(t.attn, **kw))
    return j, t


@functools.lru_cache(maxsize=None)
def _weights(name):
    """``repro``'s weights from a seed as numpy (its initialiser, compiled
    whole); the windowed phi3 has smoke phi3's."""
    jcfg, _ = _configs("phi3" if name == "phi3_window" else name)
    return jax.device_get(jax.jit(lambda k: jinit_model(k, jcfg))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The weights, ``repro``'s lockstep decode logits over STEPS positions
    of ``len(slot_rows(ALLOC))`` rows, and the tokens."""
    jcfg, _ = _configs(name)
    jparams = _weights(name)
    n = sum(ALLOC)
    tokens = np.random.RandomState(0).randint(0, jcfg.vocab_size, size=(n, STEPS))
    step = jax.jit(lambda p, t, pos, st: jdecode_step(p, t, pos, st, jcfg))
    states, logits = jinit_states(n, CACHE, jcfg), []
    for t in range(STEPS):
        lg, states = step(jparams, jnp.asarray(tokens[:, t], jnp.int32), jnp.int32(t),
                          states)
        logits.append(np.asarray(lg))
    return jparams, tokens, logits


def _staggered(ss, params, tokens, states=None):
    """``repro``'s ``run_serve_hetero`` schedule through the port's slot step:
    slot s is admitted at wall step DELAY[s] and decodes position p at wall
    step DELAY[s] + p; idle slots stay reset.  Returns {(s, p): logits row}
    and the largest |logit| of a padded row."""
    rows = tcont.slot_rows(ss.spec.shard_alloc)
    B = ss.spec.batch_global
    if states is None:
        states = tserve.prepare_serve_states(ss.spec.cfg, ss.spec.plan, B, CACHE, "cpu")
    out, pad_max = {}, 0.0
    for w in range(STEPS + max(DELAY)):
        tok, pos, reset = np.zeros(B, np.int32), np.zeros(B, np.int32), np.zeros(B, bool)
        live = {}
        for s, row in enumerate(rows):
            p = w - DELAY[s]
            if not 0 <= p < STEPS:
                reset[row] = True
                continue
            tok[row], pos[row], reset[row] = tokens[s, p], p, p == 0
            live[s] = (row, p)
        logits, states = ss.step_fn(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                    torch.from_numpy(reset), states)
        logits = logits.numpy()
        out.update({(s, p): logits[row].copy() for s, (row, p) in live.items()})
        pads = [r for r in range(B) if r not in rows]
        if pads:
            pad_max = max(pad_max, float(np.abs(logits[pads]).max()))
    return out, pad_max


SLOT_CASES = [("phi3", 1, None), ("phi3", 2, 2), ("phi3", 4, 2), ("phi3", 3, None),
              ("phi3_window", 1, None), ("phi3_window", 2, 2),
              ("jamba", 1, None), ("jamba", 2, 2), ("rwkv", 1, None), ("rwkv", 2, 2)]


@pytest.mark.parametrize("name,stage,n_groups", SLOT_CASES,
                         ids=[f"{n}-s{s}-g{g}" for n, s, g in SLOT_CASES])
def test_slot_step_matches_repro_lockstep(name, stage, n_groups):
    """Staggered admission at ALLOC through ``build_slot_serve_step`` matches
    ``repro``'s lockstep decode row for row; padded rows are exactly 0.
    Stage 3 and 4 exceed smoke phi3's 2 periods (stages with no period);
    Jamba's Mamba and RWKV's recurrent rows would diverge without the reset,
    and their states reach the base tensors from a group's views."""
    jparams, tokens, want = _reference(name)
    _, tcfg = _configs(name)
    ss = tserve.build_slot_serve_step(tcfg, cache_len=CACHE, shard_alloc=ALLOC,
                                      stage=stage, n_groups=n_groups)
    assert ss.spec.batch_global == 6 and ss.spec.plan.stage == stage
    assert ss.spec.slot_mask.tolist() == [[True, True, True], [True, False, False]]
    got, pad_max = _staggered(ss, params_from_numpy(jparams, "cpu"), tokens)
    assert len(got) == sum(ALLOC) * STEPS
    for (s, p), row in got.items():
        np.testing.assert_allclose(row, want[p][s], atol=TOL, rtol=0,
                                   err_msg=f"slot {s} position {p}")
    assert pad_max == 0.0


def test_virtual_stages_match_one_stage():
    """Stages 2 and 4 (n_groups 2) give stage 1's logits, and the lockstep
    step at stage 2 its stage-1 logits, on smoke phi3 and Jamba."""
    for name in ("phi3", "jamba"):
        jparams, tokens, _ = _reference(name)
        _, tcfg = _configs(name)
        params = params_from_numpy(jparams, "cpu")
        base, _ = _staggered(tserve.build_slot_serve_step(
            tcfg, cache_len=CACHE, shard_alloc=ALLOC), params, tokens)
        for stage in (2, 4):
            ss = tserve.build_slot_serve_step(tcfg, cache_len=CACHE, shard_alloc=ALLOC,
                                              stage=stage, n_groups=2)
            got, _ = _staggered(ss, params, tokens)
            for k in base:
                np.testing.assert_allclose(got[k], base[k], atol=TOL, rtol=0)
        lock = [tserve.build_serve_step(tcfg, batch_global=4, cache_len=CACHE, stage=st)
                for st in (1, 2)]
        assert lock[1].spec.n_groups == 2
        states = [tserve.prepare_serve_states(tcfg, ls.spec.plan, 4, CACHE, "cpu")
                  for ls in lock]
        for t in range(3):
            tok = torch.from_numpy(tokens[:4, t])
            a, _ = lock[0].step_fn(params, tok, t, states[0])
            b, _ = lock[1].step_fn(params, tok, t, states[1])
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL, rtol=0)


def test_serve_stage_helpers_match_repro():
    from repro.runtime import serve as jserve
    for name in ("phi3", "jamba", "rwkv"):
        jcfg, tcfg = _configs(name)
        assert tserve.serve_head_count(tcfg) == jserve.serve_head_count(jcfg)
        for axis in (1, 2, 4, 6, 8):
            assert tserve.pick_serve_stage(tcfg, axis) == jserve.pick_serve_stage(jcfg, axis)
    ss = tserve.build_slot_serve_step(_configs("phi3")[1], cache_len=8,
                                      shard_alloc=(4, 0), model_axis=4)
    assert (ss.spec.plan.data, ss.spec.plan.stage, ss.spec.plan.tp) == (2, 1, 4)
    assert ss.spec.batch_global == 8 and ss.spec.per_slot
    with pytest.raises(ValueError):
        tserve.build_slot_serve_step(_configs("phi3")[1], cache_len=8, shard_alloc=(0, 0))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def test_engines_match_repro_engine():
    """One scripted (tokens, positions, reset) sequence, with re-admissions,
    through ``repro``'s ``engine_from_decode_step`` and the port's two
    engines (the slot engine at ALLOC: its live rows, its pads zero)."""
    jparams, _, _ = _reference("jamba")
    jcfg, tcfg = _configs("jamba")
    params = params_from_numpy(jparams, "cpu")
    B = 6
    jeng = jcont.engine_from_decode_step(jparams, jcfg, batch=B, cache_len=CACHE)
    teng = tcont.engine_from_decode_step(params, tcfg, batch=B, cache_len=CACHE,
                                         device="cpu")
    ss = tserve.build_slot_serve_step(tcfg, cache_len=CACHE, shard_alloc=ALLOC)
    seng = tcont.engine_from_serve_step(ss, params, device="cpu")
    live = tcont.slot_rows(ALLOC)
    rng = np.random.RandomState(1)
    pos = np.zeros(B, np.int32)
    for step in range(7):
        reset = (rng.rand(B) < 0.3) | (step == 0)
        pos = np.where(reset, 0, pos + 1).astype(np.int32)
        tok = rng.randint(0, jcfg.vocab_size, B).astype(np.int32)
        want = np.asarray(jeng(jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(reset)))
        got = teng(tok, pos, reset)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"step {step}")
        slot = seng(tok, pos, reset)
        np.testing.assert_allclose(slot[live], want[live], atol=TOL, rtol=0)
        assert not slot[[r for r in range(B) if r not in live]].any()


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

VOCAB = 17


def forced_step(tokens, positions, reset):
    """Each row one finite logit, a function of the row's (token, position):
    both samplers must draw it."""
    tok, pos = np.asarray(tokens)[:, None], np.asarray(positions)[:, None]
    hot = (tok * 31 + pos * 7) % VOCAB
    return np.where(np.arange(VOCAB)[None, :] == hot, 0.0, -np.inf).astype(np.float32)


def make_timer(dt):
    t = [0.0]

    def timer():
        t[0] += dt / 2
        return t[0]

    return timer


def _requests(mod, n=9, rate=50.0, n_tokens=5):
    rng = np.random.RandomState(3)
    t, out = 0.0, []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append(mod.Request(rid=rid, arrival=t, prompt_token=int(rng.randint(VOCAB)),
                               n_tokens=n_tokens))
    return out


def _completions(done):
    return [(c.rid, c.arrival, c.finish, tuple(c.tokens), tuple(c.token_latencies))
            for c in done]


@pytest.mark.parametrize("slots,dt,cache", [([0, 1, 2, 3], 0.01, 16), ([3, 1, 0, 2], 2.0, 16),
                                            ([5, 2], 0.05, 16), ([0, 1], 0.01, 2),
                                            ([0], 0.3, 16)])
def test_batcher_matches_repro_under_forced_sampling(slots, dt, cache):
    runs = []
    for mod in (jcont, tcont):
        bat = mod.ContinuousBatcher(forced_step, slots=slots, batch=8, cache_len=cache,
                                    seed=0, timer=make_timer(dt))
        runs.append((_completions(bat.run(_requests(mod, n_tokens=5))), bat.steps,
                     bat.step_seconds, bat.clock))
    assert runs[1] == runs[0]
    assert all(len(c[3]) == min(5, cache) for c in runs[1][0])


def test_draws_on_clock_add_the_host_draws_to_the_clock():
    """With ``draws_on_clock`` each step's clock advance is the engine call and
    the draws after it (one more timer reading); the tokens do not change.
    Arrivals at 0 and one slot, so every time is a count of steps."""
    reqs = [tcont.Request(rid=i, arrival=0.0, prompt_token=i, n_tokens=3) for i in range(4)]
    runs = []
    for on_clock in (False, True):
        bat = tcont.ContinuousBatcher(forced_step, slots=[2], batch=4, cache_len=16, seed=0,
                                      timer=make_timer(0.5), draws_on_clock=on_clock)
        runs.append((bat, bat.run(reqs)))
    (plain, a), (drawn, b) = runs
    assert [c.tokens for c in b] == [c.tokens for c in a]
    assert drawn.step_seconds == plain.step_seconds == [0.25] * 12
    assert drawn.draw_seconds == [0.25] * 12 and plain.draw_seconds == []
    assert drawn.clock == 2 * plain.clock == 6.0
    assert [c.token_latencies for c in b] == [[2 * t for t in c.token_latencies] for c in a]


def test_poisson_requests_and_slot_rows_match_repro():
    for rate, horizon, seed, vocab in ((20.0, 1.0, 7, 256), (3.5, 9.0, 0, 32064)):
        want = jcont.poisson_requests(rate, horizon, n_tokens=4, seed=seed, vocab=vocab)
        got = tcont.poisson_requests(rate, horizon, n_tokens=4, seed=seed, vocab=vocab)
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
    for alloc in ((3, 1), (2, 2), (1, 3), (4,), (4, 0), (0, 2, 1)):
        assert tcont.slot_rows(alloc) == jcont.slot_rows(alloc)


# ---------------------------------------------------------------------------
# the port's own properties: invariance with real sampling
# ---------------------------------------------------------------------------


def test_real_engine_tokens_invariant_to_slots_and_timing():
    """``tests/test_continuous.py``'s determinism property on the port's
    decode path with its real sampler: the same tokens under other slot
    lists, step timings, the slot engine with padded rows, and with an
    unrelated request added."""
    jparams, _, _ = _reference("phi3")
    _, tcfg = _configs("phi3")
    params = params_from_numpy(jparams, "cpu")
    reqs = [tcont.Request(rid=i, arrival=0.02 * i, prompt_token=(7 * i + 3) % 512,
                          n_tokens=4) for i in range(6)]
    runs = []
    for slots, dt, extra in (([0, 1, 2, 3], 0.01, 0), ([2, 0], 1.0, 0), ([3], 0.05, 1)):
        eng = tcont.engine_from_decode_step(params, tcfg, batch=4, cache_len=16,
                                            device="cpu")
        more = [tcont.Request(rid=99, arrival=0.0, prompt_token=5, n_tokens=3)] * extra
        bat = tcont.ContinuousBatcher(eng, slots=slots, batch=4, cache_len=16, seed=0,
                                      timer=make_timer(dt))
        runs.append({c.rid: tuple(c.tokens) for c in bat.run(reqs + more)
                     if c.rid != 99})
    ss = tserve.build_slot_serve_step(tcfg, cache_len=16, shard_alloc=ALLOC)
    bat = tcont.ContinuousBatcher(tcont.engine_from_serve_step(ss, params, device="cpu"),
                                  slots=tcont.slot_rows(ALLOC)[::-1], batch=6,
                                  cache_len=16, seed=0, timer=make_timer(0.01))
    runs.append({c.rid: tuple(c.tokens) for c in bat.run(reqs)})
    assert len(runs[0]) == 6 and all(len(t) == 4 for t in runs[0].values())
    for other in runs[1:]:
        assert other == runs[0]
    assert len({t for toks in runs[0].values() for t in toks}) > 4    # not one token


def test_token_is_a_function_of_seed_rid_pos():
    """The draw depends on (seed, rid, pos) and the row's logits alone: not on
    the global generator, and each of the three integers moves it."""
    row = np.zeros(64, np.float32)               # uniform: every token possible
    draws = {}
    for seed, rid, pos in [(0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0), (0, 5, 7)]:
        torch.manual_seed(seed * 11 + 3)
        a = tcont.sample_token(row, seed, rid, pos)
        torch.manual_seed(12345)
        np.random.seed(7)
        assert tcont.sample_token(row, seed, rid, pos) == a
        draws[(seed, rid, pos)] = tcont.sample_seed(seed, rid, pos)
    assert len(set(draws.values())) == len(draws)
    tokens = [tcont.sample_token(row, 0, rid, pos) for rid in range(8) for pos in range(8)]
    assert len(set(tokens)) > 20
    hot = np.full(64, -np.inf, np.float32)
    hot[17] = 0.0
    assert {tcont.sample_token(hot, 0, r, p) for r in range(4) for p in range(4)} == {17}


# ---------------------------------------------------------------------------
# int32 lengths, and the launcher
# ---------------------------------------------------------------------------


def test_decode_lengths_are_int32_on_every_route():
    """An int64 per-row position gives the int32 output; a tensor cache_len
    that the card would refuse (not int32, not (B,)) raises on the CPU."""
    from repro_torch.models.config import AttentionConfig
    cfg = AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16)
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(32, n, generator=g) * 0.2
              for k, n in (("wq", 64), ("wk", 32), ("wv", 32))}
    params["wo"] = torch.randn(64, 32, generator=g) * 0.2
    x = torch.randn(3, 32, generator=g)
    outs = []
    for dtype in (torch.int32, torch.int64):
        cache = init_attention_cache(3, 8, cfg, torch.float32, "cpu")
        for p in range(3):
            pos = torch.tensor([p, max(p - 1, 0), 0], dtype=dtype)
            o, cache = attention_decode(params, x, pos, cache, cfg)
        outs.append(o)
    torch.testing.assert_close(outs[1], outs[0], atol=0, rtol=0)
    q, k = torch.zeros(3, 4, 16), torch.zeros(3, 8, 2, 16)
    for bad in (torch.tensor([1, 2, 3]), torch.tensor([1, 2], dtype=torch.int32),
                torch.tensor(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32"):
            ops.flash_decode_op(q, k, k, bad)
    ops.flash_decode_op(q, k, k, torch.tensor([1, 2, 3], dtype=torch.int32))


def test_continuous_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    res = main(["--smoke", "--device", "cpu", "--continuous", "--devices", "8",
                "--requests", "4", "--gen", "4"])
    out = capsys.readouterr().out
    assert "serve plan: stage=1 tp=4 alloc=(4, 0) caps=(4, 4) modeled p99=" in out
    assert "served " in out and "token latency p50/p95/p99" in out
    assert "admission wait p50/p95/p99" in out and "first token p50/p95/p99" in out
    assert out.rstrip().endswith("done")
    done = res["completions"]
    assert done and all(len(c.tokens) == 4 for c in done)
    assert all(0 <= t < 512 for c in done for t in c.tokens)
    assert res["steps"] == len(res["step_seconds"]) == len(res["draw_seconds"])
    assert res["slots"] == [0, 1, 2, 3]
    assert res["plan"].shard_alloc == (4, 0) and res["slot_step"].spec.batch_global == 8
