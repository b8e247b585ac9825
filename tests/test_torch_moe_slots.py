"""phi3.5-moe beyond lockstep: the per-slot step, the engines and the
serving launcher against ``repro``, on the CPU at smoke size.

``repro`` routes the tokens of one data shard's one pipeline group as a set
of their own: its slot and lockstep steps run inside ``shard_map`` over
``data`` with ``ep_axis="data"``, and ``_pipelined_decode`` cuts each
shard's rows into groups.  The capacity C = int(f·T·k/E) + 1 of a set
depends on its size, so where pairs drop, a row's logits depend on which
rows share its set.  Each case here runs at a capacity factor where pairs
drop, asserts that some do, and, as a check of the test itself, that
routing all rows as one set gives other logits.

* (a) The slot step at shard_alloc (3, 1) (stages 1, 2, 4) and (4, 2)
  (stage 2, and stage 4 in 2 groups: a group is the g-th slice of every
  shard) against ``repro``'s mesh-free ``decode_step`` run on each (shard,
  group) set's rows alone, with their own positions and resets.  That is
  ``repro``'s result: its ``shard_map`` routes each set alone, and its
  experts act row by row on the exchanged buffers.
* (b) One subprocess anchors (a): ``repro``'s own ``build_slot_serve_step``
  on 8 CPU host devices (data 2 x model 4, stage 2, 2 groups).
* (c) At factor 64 nothing drops: the engines' logits match ``repro``'s
  engine, and the tokens are invariant to slots and timing.
* (d) ``launch.serve --devices 4`` and ``--devices 8`` in lockstep: the
  tokens are what ``repro``'s launcher step (``build_serve_step`` on its
  data x model mesh; at ``--devices 8`` in a subprocess) gives along the
  same tokens, sampled as the port samples.

Weights are ``repro``'s ``init_model`` from a seed, carried over with
``repro_torch.interop`` ((d): the launcher's own, carried the other way).
Tolerances as ``tests/test_torch_continuous.py``: logits 1e-4 abs, padded
rows exactly 0.
"""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.model import decode_step as jdecode_step
from repro.models.model import init_decode_states as jinit_states
from repro.models.model import init_model as jinit_model
from repro.runtime import continuous as jcont
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import moe as tmoe
from repro_torch.models.blocks import tree_index
from repro_torch.runtime import continuous as tcont
from repro_torch.runtime import serve as tserve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "phi3.5-moe-42b-a6.6b"
TOL = 1e-4
DROPS = 0.5            # C = 1 for the 2- and 3-row sets below: pairs drop
CACHE, STEPS = 16, 5
DELAY = (0, 1, 2, 1, 0, 2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def drops(monkeypatch):
    """Counts the dropped pairs of every MoE call, and the calls that route
    more than one token set."""
    seen = {"dropped": 0, "set_calls": 0}
    real = tmoe.dispatch_slots

    def dispatch_slots(top_e, cap, e_global, sets=1):
        keep, slot = real(top_e, cap, e_global, *((sets,) if sets > 1 else ()))
        seen["dropped"] += int((~keep).sum())
        seen["set_calls"] += sets > 1
        return keep, slot

    monkeypatch.setattr(tmoe, "dispatch_slots", dispatch_slots)
    return seen


def _configs(factor):
    j, t = jget_smoke(ARCH), get_smoke_config(ARCH)
    return (j.replace(moe=dataclasses.replace(j.moe, capacity_factor=factor)),
            t.replace(moe=dataclasses.replace(t.moe, capacity_factor=factor)))


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, _ = _configs(DROPS)
    return jax.device_get(jax.jit(lambda k: jinit_model(k, jcfg))(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jstep(factor):
    """``repro``'s mesh-free decode with the engine's admission reset."""
    jcfg, _ = _configs(factor)

    def step(p, tok, pos, reset, st):
        st = jax.tree.map(lambda s: jnp.where(
            reset.reshape((1, -1) + (1,) * (s.ndim - 2)), jnp.zeros_like(s), s), st)
        return jdecode_step(p, tok, pos, st, jcfg)

    return jax.jit(step)


def _schedule(alloc, steps=STEPS):
    """Staggered admission over the padded shard-major batch of ``alloc``:
    slot s decodes position p at wall step DELAY[s] + p, idle slots stay
    reset, padded rows decode token 0 at position 0 unreset (as
    ``tests/test_torch_continuous.py``'s ``_staggered``).  Returns the rows,
    [(tok, pos, reset)] per wall step and the live (row -> p) of each."""
    B = max(alloc) * len(alloc)
    rows = tcont.slot_rows(alloc)
    tokens = np.random.RandomState(1).randint(0, 512, size=(len(rows), steps))
    out = []
    for w in range(steps + max(DELAY[:len(rows)])):
        tok, pos, reset = np.zeros(B, np.int32), np.zeros(B, np.int32), np.zeros(B, bool)
        for s, row in enumerate(rows):
            p = w - DELAY[s]
            if 0 <= p < steps:
                tok[row], pos[row], reset[row] = tokens[s, p], p, p == 0
            else:
                reset[row] = True
        out.append((tok, pos, reset))
    return rows, out


def _set_rows(alloc, n_g):
    """Each (shard, group) token set's rows, shard-major indices."""
    b_max = max(alloc)
    bg = b_max // n_g
    return [[d * b_max + g * bg + i for i in range(bg)]
            for d in range(len(alloc)) for g in range(n_g)]


def _reference(jparams, sched, sets, factor=DROPS):
    """``repro``'s decode run on each set's rows alone: logits (W, B, V)."""
    step = _jstep(factor)
    jcfg, _ = _configs(factor)
    B = len(sched[0][0])
    out = np.zeros((len(sched), B, jcfg.vocab_size), np.float32)
    for rows in sets:
        st = jinit_states(len(rows), CACHE, jcfg)
        for w, (tok, pos, reset) in enumerate(sched):
            lg, st = step(jparams, jnp.asarray(tok[rows]), jnp.asarray(pos[rows]),
                          jnp.asarray(reset[rows]), st)
            out[w, rows] = np.asarray(lg)
    return out


def _run_slot_step(ss, params, sched):
    states = tserve.prepare_serve_states(ss.spec.cfg, ss.spec.plan, ss.spec.batch_global,
                                         CACHE, "cpu")
    out = []
    for tok, pos, reset in sched:
        lg, states = ss.step_fn(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                torch.from_numpy(reset), states)
        out.append(lg.numpy().copy())
    return np.stack(out)


def _assert_rows(got, want, alloc):
    """Every slot row (live or idle) within TOL; padded rows exactly 0."""
    rows = tcont.slot_rows(alloc)
    pads = [r for r in range(got.shape[1]) if r not in rows]
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=TOL, rtol=0)
    assert not got[:, pads].any()


# ---------------------------------------------------------------------------
# (a) the slot step against repro, set by set
# ---------------------------------------------------------------------------

SLOT_CASES = [((3, 1), 1, None, 1), ((3, 1), 2, None, 1), ((3, 1), 4, None, 1),
              ((4, 2), 2, None, 2), ((4, 2), 4, 2, 2)]


@pytest.mark.parametrize("alloc,stage,n_groups,groups", SLOT_CASES,
                         ids=[f"{a[0]}{a[1]}-s{s}-g{g}" for a, s, _, g in SLOT_CASES])
def test_slot_step_routes_each_shard_group_apart(alloc, stage, n_groups, groups, drops):
    jparams = _weights()
    _, cfg = _configs(DROPS)
    ss = tserve.build_slot_serve_step(cfg, cache_len=CACHE, shard_alloc=alloc,
                                      stage=stage, n_groups=n_groups)
    assert ss.spec.groups == groups and ss.spec.plan.data == len(alloc)
    _, sched = _schedule(alloc)
    got = _run_slot_step(ss, params_from_numpy(jparams, "cpu"), sched)
    assert drops["dropped"] >= 1 and drops["set_calls"] >= 1
    want = _reference(jparams, sched, _set_rows(alloc, groups))
    _assert_rows(got, want, alloc)
    # the test sees the sets: all rows routed as one set give other logits
    whole = _reference(jparams, sched, [list(range(got.shape[1]))])
    rows = tcont.slot_rows(alloc)
    assert np.abs(whole[:, rows] - want[:, rows]).max() > 100 * TOL


def test_token_sets_share_one_expert_launch(drops, monkeypatch):
    """Two sets: each expert is one call on the two sets' concatenated
    buffers; the output equals each set routed alone, and the aux loss is
    the sum of the sets' own."""
    from repro_torch.kernels import ops
    _, cfg = _configs(DROPS)
    mcfg = cfg.moe
    params = tree_index(params_from_numpy(_weights(), "cpu")["periods"]["layers"][0]["moe"], 0)
    x = torch.from_numpy(np.random.RandomState(2).standard_normal((6, cfg.d_model))
                         .astype(np.float32))
    calls = []
    real = ops.plain_fused_swiglu
    monkeypatch.setattr(ops, "plain_fused_swiglu",
                        lambda xx, *a, **kw: calls.append(xx.shape[0]) or real(xx, *a, **kw))
    out, aux = tmoe.moe(params, x, mcfg, sets=2)
    E = mcfg.n_experts
    assert calls == [2 * tmoe.capacity(mcfg, 3, E)] * E and drops["dropped"] >= 1
    a, aux_a = tmoe.moe(params, x[:3], mcfg)
    b, aux_b = tmoe.moe(params, x[3:], mcfg)
    torch.testing.assert_close(out, torch.cat([a, b]), atol=1e-6, rtol=0)
    assert abs(float(aux) - float(aux_a + aux_b)) <= 1e-7
    with pytest.raises(ValueError, match="token sets"):
        tmoe.moe(params, x, mcfg, sets=4)


# ---------------------------------------------------------------------------
# (b) repro's own slot step on 8 host devices
# ---------------------------------------------------------------------------

REPRO_SCRIPT = r"""
import dataclasses, pickle, sys, time
t0 = time.perf_counter()
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
inp = pickle.load(open(sys.argv[1], "rb"))
cfg = get_smoke_config(inp["arch"])
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=inp["factor"]))
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
params = jax.tree.map(jnp.asarray, inp["params"])
out = {}
if inp["kind"] == "slot":
    from repro.runtime.serve import build_slot_serve_step, prepare_serve_states
    ss = build_slot_serve_step(cfg, mesh, cache_len=inp["cache"], shard_alloc=inp["alloc"],
                               stage=inp["stage"])
    states = prepare_serve_states(cfg, ss.spec.plan, ss.spec.batch_global, inp["cache"])
    logits = []
    for tok, pos, reset in inp["schedule"]:
        lg, states = ss.step_fn(params, jnp.asarray(tok), jnp.asarray(pos),
                                jnp.asarray(reset), states)
        logits.append(np.asarray(lg))
    out["n_groups"] = ss.spec.n_groups
else:
    from repro.runtime.serve import build_serve_step, prepare_serve_states
    tokens = inp["tokens"]
    ss = build_serve_step(cfg, mesh, batch_global=tokens.shape[1], cache_len=inp["cache"])
    states = prepare_serve_states(cfg, ss.spec.plan, tokens.shape[1], inp["cache"])
    logits = []
    for pos in range(inp["cache"] - 1):
        lg, states = ss.step_fn(params, jnp.asarray(tokens[pos]), jnp.int32(pos), states)
        logits.append(np.asarray(lg))
out.update(logits=np.stack(logits), stage=ss.spec.plan.stage, tp=ss.spec.plan.tp,
           data=ss.spec.plan.data, seconds=time.perf_counter() - t0)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _run_repro(tmp_path, payload):
    """``REPRO_SCRIPT`` on 8 CPU host devices (the XLA flag must be set
    before JAX starts, so in a process of its own)."""
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps({"arch": ARCH, **payload}))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", REPRO_SCRIPT, str(src), str(dst)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = pickle.loads(dst.read_bytes())
    out["wall"] = time.perf_counter() - t0
    return out


def test_slot_step_matches_repro_on_eight_host_devices(tmp_path, drops):
    alloc, stage = (4, 2), 2
    jparams = _weights()
    _, cfg = _configs(DROPS)
    _, sched = _schedule(alloc, steps=2)
    sched = sched[:3]
    ref = _run_repro(tmp_path, {"kind": "slot", "factor": DROPS, "cache": CACHE,
                                "alloc": alloc, "stage": stage, "params": jparams,
                                "schedule": sched})
    assert (ref["data"], ref["stage"], ref["tp"], ref["n_groups"]) == (2, 2, 2, 2)
    ss = tserve.build_slot_serve_step(cfg, cache_len=CACHE, shard_alloc=alloc, stage=stage,
                                      model_axis=4)
    assert (ss.spec.plan.data, ss.spec.plan.tp, ss.spec.groups) == (2, 2, 2)
    got = _run_slot_step(ss, params_from_numpy(jparams, "cpu"), sched)
    assert drops["dropped"] >= 1
    _assert_rows(got, ref["logits"], alloc)
    print(f"repro's slot step on 8 host devices: {ref['wall']:.1f} s "
          f"(in its process {ref['seconds']:.1f} s)")


# ---------------------------------------------------------------------------
# (c) nothing drops: the engines and the batcher
# ---------------------------------------------------------------------------


def test_engines_at_factor_64_match_repro_and_are_invariant(drops):
    """A scripted sequence with re-admissions through ``repro``'s
    ``engine_from_decode_step`` and the port's two engines; then real
    sampling through ``ContinuousBatcher`` under other slot lists, timings,
    the slot engine and an unrelated request: the same tokens."""
    jcfg, cfg = _configs(64.0)
    jparams = _weights()
    params = params_from_numpy(jparams, "cpu")
    alloc, B = (3, 1), 6
    jeng = jcont.engine_from_decode_step(jparams, jcfg, batch=B, cache_len=CACHE)
    teng = tcont.engine_from_decode_step(params, cfg, batch=B, cache_len=CACHE, device="cpu")
    seng = tcont.engine_from_serve_step(
        tserve.build_slot_serve_step(cfg, cache_len=CACHE, shard_alloc=alloc), params,
        device="cpu")
    live = tcont.slot_rows(alloc)
    rng = np.random.RandomState(1)
    pos = np.zeros(B, np.int32)
    for step in range(5):
        reset = (rng.rand(B) < 0.3) | (step == 0)
        pos = np.where(reset, 0, pos + 1).astype(np.int32)
        tok = rng.randint(0, jcfg.vocab_size, B).astype(np.int32)
        want = np.asarray(jeng(jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(reset)))
        np.testing.assert_allclose(teng(tok, pos, reset), want, atol=TOL, rtol=0)
        slot = seng(tok, pos, reset)
        np.testing.assert_allclose(slot[live], want[live], atol=TOL, rtol=0)
        assert not slot[[r for r in range(B) if r not in live]].any()
    assert drops["dropped"] == 0

    reqs = [tcont.Request(rid=i, arrival=0.02 * i, prompt_token=(7 * i + 3) % 512,
                          n_tokens=3) for i in range(5)]
    runs = []
    for slots, dt, extra in (([0, 1, 2, 3], 0.01, 0), ([2, 0], 1.0, 0), ([3], 0.05, 1)):
        eng = tcont.engine_from_decode_step(params, cfg, batch=4, cache_len=CACHE,
                                            device="cpu")
        more = [tcont.Request(rid=99, arrival=0.0, prompt_token=5, n_tokens=2)] * extra
        bat = tcont.ContinuousBatcher(eng, slots=slots, batch=4, cache_len=CACHE, seed=0,
                                      timer=_timer(dt))
        runs.append({c.rid: tuple(c.tokens) for c in bat.run(reqs + more) if c.rid != 99})
    seng = tcont.engine_from_serve_step(
        tserve.build_slot_serve_step(cfg, cache_len=CACHE, shard_alloc=alloc), params,
        device="cpu")
    bat = tcont.ContinuousBatcher(seng, slots=live[::-1], batch=B, cache_len=CACHE,
                                  seed=0, timer=_timer(0.01))
    runs.append({c.rid: tuple(c.tokens) for c in bat.run(reqs)})
    assert len(runs[0]) == 5 and all(len(t) == 3 for t in runs[0].values())
    for other in runs[1:]:
        assert other == runs[0]
    assert drops["dropped"] == 0


def _timer(dt):
    t = [0.0]

    def timer():
        t[0] += dt / 2
        return t[0]

    return timer


# ---------------------------------------------------------------------------
# (d) the lockstep launcher on repro's mesh
# ---------------------------------------------------------------------------


def _resample(logits, prompt_len: int, temperature: float = 0.8):
    """The launcher's draws (a CPU ``torch.Generator`` seeded 0,
    ``multinomial(softmax(logits / T))``) on another step's logits."""
    gen = torch.Generator().manual_seed(0)
    out = []
    for pos in range(prompt_len - 1, logits.shape[0]):
        probs = torch.softmax(torch.from_numpy(logits[pos]) / temperature, dim=-1)
        out.append(torch.multinomial(probs, 1, generator=gen)[:, 0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("devices", [4, 8])
def test_lockstep_launcher_matches_repro_mesh(devices, tmp_path, drops):
    """The launcher's tokens are what ``repro``'s launcher step gives along
    them (at ``--devices 4`` a 1 x 4 mesh at one stage, which is
    ``repro``'s mesh-free ``decode_step``; at 8 a 2 x 4 mesh, whose data
    shards route 4 rows each), sampled as the launcher samples.  On a port
    that routed all 8 rows as one set the draws differ."""
    prompt, gen = 8, 16
    res = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--devices", str(devices), "--batch", "8",
                               "--prompt-len", str(prompt), "--gen", str(gen)])
    tokens = res["tokens"]
    assert tokens.shape == (prompt + gen, 8) and drops["dropped"] >= 1
    jcfg = jget_smoke(ARCH)
    jparams = params_to_numpy(_launcher_weights())
    if devices == 8:
        ref = _run_repro(tmp_path, {"kind": "lockstep", "factor": jcfg.moe.capacity_factor,
                                    "cache": prompt + gen, "params": jparams,
                                    "tokens": tokens.astype(np.int32)})
        assert (ref["data"], ref["stage"], ref["tp"]) == (2, 1, 4)
        want = ref["logits"]
        sets = [list(range(4)), list(range(4, 8))]
    else:
        step = jax.jit(lambda p, t, pos, st: jdecode_step(p, t, pos, st, jcfg))
        st, want = jinit_states(8, prompt + gen, jcfg), []
        for pos in range(prompt + gen - 1):
            lg, st = step(jparams, jnp.asarray(tokens[pos], jnp.int32), jnp.int32(pos), st)
            want.append(np.asarray(lg))
        want = np.stack(want)
        sets = [list(range(8))]
    np.testing.assert_array_equal(tokens[prompt:], _resample(want, prompt))
    ss = res["serve_step"]
    assert ss.spec.plan.data == len(sets) and ss.spec.groups == 1
    # the port's own logits along the same tokens, and the check of the test
    params = res["params"]
    states = tserve.prepare_serve_states(ss.spec.cfg, ss.spec.plan, 8, prompt + gen, "cpu")
    one = tserve.build_serve_step(ss.spec.cfg, batch_global=8, cache_len=prompt + gen)
    st1 = tserve.prepare_serve_states(one.spec.cfg, one.spec.plan, 8, prompt + gen, "cpu")
    worst_one = 0.0
    for pos in range(prompt + gen - 1):
        tok = torch.from_numpy(tokens[pos])
        lg, states = ss.step_fn(params, tok, pos, states)
        np.testing.assert_allclose(lg.numpy(), want[pos], atol=TOL, rtol=0)
        lg1, st1 = one.step_fn(params, tok, pos, st1)
        worst_one = max(worst_one, float(np.abs(lg1.numpy() - want[pos]).max()))
    if devices == 8:
        assert worst_one > 100 * TOL
    else:
        assert worst_one <= TOL


@functools.lru_cache(maxsize=None)
def _launcher_weights():
    """The launcher's weights: ``init_model`` from a CPU generator seeded 0."""
    from repro_torch.models.model import init_model
    return init_model(torch.Generator().manual_seed(0), get_smoke_config(ARCH), "cpu")


# ---------------------------------------------------------------------------
# prefill: a token set per micro-batch
# ---------------------------------------------------------------------------


def test_prefill_routes_each_micro_batch_apart(drops):
    """``repro``'s ``build_prefill_step`` on one device streams 2
    micro-batches of a batch of 4, each routed on its own: the port's
    prefill gives its logits; the whole batch as one set does not."""
    from jax.sharding import Mesh

    from repro.runtime import serve as jserve
    from repro_torch.models.model import head_logits, model_forward

    jcfg, cfg = _configs(DROPS)
    jparams = _weights()
    params = params_from_numpy(jparams, "cpu")
    B, S = 4, 8
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jps = jserve.build_prefill_step(jcfg, mesh, batch_global=B, seq_len=S)
    assert jps.spec.n_groups == 2                     # repro's micro-batch count
    want = np.asarray(jps.step_fn(jparams, {"tokens": jnp.asarray(tokens)}))
    got = tserve.build_prefill_step(cfg, batch_global=B, seq_len=S).step_fn(
        params, {"tokens": torch.from_numpy(tokens)})
    assert drops["dropped"] >= 1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert drops["set_calls"] == cfg.n_layers                  # 2 sets a layer
    with torch.no_grad():
        h, _, _ = model_forward(params, torch.from_numpy(tokens), cfg)
        whole = head_logits(params, h[:, -1], cfg).numpy()
    assert np.abs(whole - want).max() > 100 * TOL
