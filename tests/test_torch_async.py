"""Staleness 1 and double buffering: the port against ``repro``, on the CPU.

The same numpy-seeded weights (``repro``'s initialisers, carried across by
``repro_torch.interop``) and the same ``SyntheticLM`` batches go through
``repro``'s bounded-stale step on a 1x1 mesh and the port's.  Tolerances,
fp32, from ``tests/test_torch_train.py``:

* the split optimizer (``take_grads`` then ``apply_held``) against
  ``update``, and the port's fold of round r-1's update against a literal
  gradient buffer written here (``repro``'s ``update(grad_buf, ...)`` after
  round r's gradients): bit for bit;
* staleness 1 against ``repro``'s over 3 rounds and a flush: the loss of
  every round 1e-4 relative and the parameters after every round 1e-4
  absolute (the gradients agree to 1e-4, and AdamW's first steps move a
  parameter by about lr whatever the gradient's size); after the flush the
  step counter equal and the moments to 1e-4.  With the int8 bucket wire a
  rounding flip moves a code by a whole step, so there the losses are held
  to 1e-3 relative and the parameters to 3e-3 (three steps of lr = 1e-3);
* double buffering against the synchronous pipeline: the loss and every
  gradient bit for bit, at P = 2 and 4, without and with the int8 wire.

The bitwise comparisons run with ``torch.use_deterministic_algorithms``: on
the CPU the embedding's gradient (an accumulating ``index_put_``) is summed
by threads in a varying order otherwise, so two calls of the same step can
differ in its last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.runtime.train import build_train_step as jbuild_train_step
from repro.runtime.train import init_train_state as jinit_train_state
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLM
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as launcher
from repro_torch.optim import SGD, AdamW, cosine_schedule, tree_leaves, tree_map
from repro_torch.runtime.train import build_train_step, init_train_state

B, S, M = 4, 32, 2


@pytest.fixture(autouse=True)
def deterministic():
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


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _bits(t) -> np.ndarray:
    return t.detach().contiguous().view(torch.int32).numpy()


def _assert_bitwise(ta, tb):
    la, lb = tree_leaves(ta), tree_leaves(tb)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# the split optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", [
    AdamW(lr=cosine_schedule(1e-2, warmup=1, total=5), weight_decay=0.01),
    AdamW(lr=3e-3, grad_clip=None),
    SGD(lr=0.05, grad_clip=1.0)], ids=["adamw-wd-clip", "adamw-noclip", "sgd"])
def test_split_optimizer_is_update_bitwise(opt):
    rng = np.random.default_rng(21)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (4, 2, 3)}}
    p0 = params_from_numpy(tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                                    shapes), "cpu")
    p1, p2 = _clone(p0), _clone(p0)
    s1, s2 = opt.init(p1), opt.init(p2)
    for step in range(3):
        g = params_from_numpy(tree_map(
            lambda s: (rng.standard_normal(s) * (3.0 if step == 2 else 0.1))
            .astype(np.float32), shapes), "cpu")
        p1, s1 = opt.update(_clone(g), s1, p1)
        s2, held = opt.take_grads(_clone(g), s2)
        p2 = opt.apply_held(held, s2, p2)
    _assert_bitwise(p1, p2)
    _assert_bitwise(s1[1:], s2[1:])
    assert int(s1.step) == int(s2.step) == 3


# ---------------------------------------------------------------------------
# staleness 1 against repro
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stale_refs():
    """repro's staleness-1 train steps on a 1x1 mesh (plain and int8
    bucketed), its initial state, and the batches of 3 rounds."""
    jcfg = jax_smoke_config("phi3-mini-3.8b")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    steps = {c: jbuild_train_step(jcfg, mesh, global_batch=B, stage=1, n_micro=M,
                                  staleness=1, compress=c,
                                  bucket_mb=0.25 if c != "none" else None)
             for c in ("none", "int8")}
    params, opt_state = jinit_train_state(jax.random.PRNGKey(0), steps["none"])
    ds = JSyntheticLM(jcfg.vocab_size, S)
    return steps, _np(params), _np(opt_state), [ds.batch(r, B) for r in range(3)]


def _repro_rounds(ts, params_np, opt_np, batches):
    """repro's bounded-stale loop (launch/train.py): grad_fn alone in round
    0, async_step_fn after, flush_fn at the end.  Parameters after every
    round, the losses, and the state after the flush."""
    p = jax.tree.map(jnp.asarray, params_np)
    o = jax.tree.map(jnp.asarray, opt_np)
    bucketed = ts.spec.bucketed
    ef = ts.init_ef() if bucketed else None
    buf, losses, after = None, [], []
    for batch_np in batches:
        batch = ts.shard_batch(batch_np)
        if buf is None:
            if bucketed:
                (loss, _), buf, ef = ts.grad_fn(p, batch, ef)
            else:
                (loss, _), buf = ts.grad_fn(p, batch)
        elif bucketed:
            p, o, buf, ef, loss, _ = ts.async_step_fn(p, o, buf, ef, batch)
        else:
            p, o, buf, loss, _ = ts.async_step_fn(p, o, buf, batch)
        losses.append(float(loss))
        after.append(_np(p))
    p, o = ts.flush_fn(p, o, buf)
    return losses, after, _np(p), _np(o)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_staleness1_matches_repro(stale_refs, compress):
    steps, params_np, opt_np, batches = stale_refs
    j_losses, j_after, j_final, j_opt = _repro_rounds(steps[compress], params_np, opt_np,
                                                      batches)
    ts = build_train_step(get_smoke_config("phi3-mini-3.8b"), B, stage=1, n_micro=M,
                          staleness=1, compress=compress,
                          bucket_mb=0.25 if compress != "none" else None, device="cpu")
    assert ts.spec.staleness == 1 and ts.spec.double_buffer
    p = params_from_numpy(params_np, "cpu")
    o = AdamW(lr=1e-3).init(p)
    ef = ts.init_ef() if ts.spec.bucketed else None
    held = None
    loss_tol, param_tol = (1e-4, 1e-4) if compress == "none" else (1e-3, 3e-3)
    for r, batch_np in enumerate(batches):
        batch = ts.shard_batch(batch_np)
        if ts.spec.bucketed:
            p, o, held, ef, loss, _ = ts.async_step_fn(p, o, held, ef, batch)
        else:
            p, o, held, loss, _ = ts.async_step_fn(p, o, held, batch)
        assert abs(float(loss) - j_losses[r]) <= loss_tol * abs(j_losses[r])
        # round 0 applies nothing: the parameters are the initial ones
        for t, j in zip(tree_leaves(p), jax.tree.leaves(j_after[r])):
            np.testing.assert_allclose(t.numpy(), j, atol=param_tol, rtol=0)
        # the port's counter already counts round r (repro's lags by one)
        assert int(o.step) == r + 1
    p, o = ts.flush_fn(p, o, held)
    assert int(o.step) == int(j_opt[0]) == len(batches)
    for t, j in zip(tree_leaves(p), jax.tree.leaves(j_final)):
        np.testing.assert_allclose(t.numpy(), j, atol=param_tol, rtol=0)
    for t, j in zip(tree_leaves((o.m, o.v)), jax.tree.leaves(j_opt[1:])):
        np.testing.assert_allclose(t.numpy(), j, atol=param_tol, rtol=1e-4)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_fold_is_a_literal_grad_buffer_bitwise(compress):
    """The port's fold against ``repro``'s arithmetic written out: round r's
    gradients at p_r, then ``update`` with round r-1's kept gradients."""
    cfg = get_smoke_config("phi3-mini-3.8b")
    kw = dict(stage=2, n_micro=M, compress=compress, error_feedback=False,
              bucket_mb=0.25 if compress != "none" else None, device="cpu")
    opt = AdamW(lr=cosine_schedule(1e-2, warmup=1, total=4), weight_decay=0.01)
    ts = build_train_step(cfg, B, staleness=1, optimizer=opt, **kw)
    ts0 = build_train_step(cfg, B, optimizer=opt, **kw)
    p, o = init_train_state(3, ts, opt)
    q, oq = _clone(p), opt.init(p)
    ds = SyntheticLM(cfg.vocab_size, S)
    ef = {} if ts.spec.bucketed else None
    held, buf = None, None
    for r in range(4):
        batch = ts.shard_batch(ds.batch(r, B))
        if ts.spec.bucketed:
            p, o, held, ef, loss, _ = ts.async_step_fn(p, o, held, ef, batch)
            (lq, _), grads, _ = ts0.grad_fn(q, batch, {})
        else:
            p, o, held, loss, _ = ts.async_step_fn(p, o, held, batch)
            (lq, _), grads = ts0.grad_fn(q, batch)
        if buf is not None:
            q, oq = opt.update(buf, oq, q)
        buf = grads
        assert float(loss) == float(lq)
        _assert_bitwise(p, q)
    p, o = ts.flush_fn(p, o, held)
    q, oq = opt.update(buf, oq, q)
    _assert_bitwise(p, q)
    _assert_bitwise((o.m, o.v), (oq.m, oq.v))
    assert int(o.step) == int(oq.step) == 4


# ---------------------------------------------------------------------------
# double buffering
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_layers():
    cfg = get_smoke_config("phi3-mini-3.8b").replace(n_layers=4)
    batch = SyntheticLM(cfg.vocab_size, S).batch(0, B)
    params, _ = init_train_state(0, build_train_step(cfg, B, stage=1, n_micro=M,
                                                     device="cpu"))
    return cfg, params, batch


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("P", [2, 4])
def test_double_buffer_gradients_bitwise(four_layers, P, compress):
    cfg, params, batch = four_layers
    out = []
    for db in (False, True):
        ts = build_train_step(cfg, B, stage=P, n_micro=M, compress=compress,
                              bucket_mb=0.25 if compress != "none" else None,
                              error_feedback=False, double_buffer=db, device="cpu")
        assert ts.spec.double_buffer is db
        b = ts.shard_batch(batch)
        if ts.spec.bucketed:
            (loss, _), grads, _ = ts.grad_fn(params, b, ts.init_ef())
        else:
            (loss, _), grads = ts.grad_fn(params, b)
        out.append((loss, grads, ts.loss_fn(params, b)[0]))
    (l0, g0, e0), (l1, g1, e1) = out
    assert float(l0) == float(l1) and float(e0) == float(e1)
    _assert_bitwise(g0, g1)


def test_default_double_buffer_follows_staleness():
    cfg = get_smoke_config("phi3-mini-3.8b")
    assert not build_train_step(cfg, B, device="cpu").spec.double_buffer
    assert build_train_step(cfg, B, staleness=1, device="cpu").spec.double_buffer
    assert not build_train_step(cfg, B, staleness=1, double_buffer=False,
                                device="cpu").spec.double_buffer
    with pytest.raises(ValueError, match="staleness"):
        build_train_step(cfg, B, staleness=2, device="cpu")
    assert build_train_step(cfg, B, device="cpu").async_step_fn is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--stage", "2", "--staleness", "1", "--double-buffer"],
                                   ["--stage", "2", "--double-buffer", "--compress", "int8"],
                                   ["--plan", "--devices", "2", "--staleness", "1",
                                    "--compress", "int8"]],
                         ids=["staleness-db", "sync-db-int8", "plan-staleness"])
def test_launcher_trains_stale_and_double_buffered(capsys, flags):
    res = launcher.main(["--smoke", "--device", "cpu", "--steps", "3", "--global-batch", "4",
                         "--seq", "32", "--log-every", "1", *flags])
    out = capsys.readouterr().out
    stale = "--staleness" in flags
    assert f"staleness={int(stale)} double_buffer=True" in out
    assert out.count("\nstep ") == 3 and "FINAL tok_s=" in out
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["timed_steps"] == (1 if stale else 2)
    # every round's update applied: the flush at the end makes it 3
    assert int(res["opt_state"].step) == 3


@pytest.mark.parametrize("flags", [["--events", "fail@2"], ["--fail-at", "3"]])
def test_launcher_events_need_plan(flags):
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--smoke", "--device", "cpu", *flags])
    assert "require --plan" in str(exc.value.code)


@pytest.mark.parametrize("flags", [["--plan", "--probation-rounds", "3"],
                                   ["--plan", "--drift-threshold", "0.2"]])
def test_launcher_refuses_portfolio_flags(flags):
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--smoke", "--device", "cpu", *flags])
    assert "later slice" in str(exc.value.code)
