"""The port's training slice against ``repro``'s, on the CPU.

The same inputs, made with numpy from a seed (weights with ``repro``'s
initialisers, carried across by ``repro_torch.interop``), go through the
JAX function and its counterpart in the port; the port runs its plain
kernel versions on CPU tensors.  Tolerances, fp32:

* gradients of the plain attention / SwiGLU versions against ``jax.grad``
  of ``repro``'s: 2e-5 / 1e-4 (the two sides sum in different orders);
* ``loss_fn`` and every gradient leaf on smoke phi3: 1e-4;
* ``AdamW.update`` on the same gradients: 1e-6;
* ``SyntheticLM`` batches: bit-identical;
* the stage-1 train step against ``repro``'s on a 1x1 mesh: loss and
  gradients 1e-4.  int8 is held in parts, since one rounding flip moves a
  code by a whole step: the bucket partition equal, the wire bitwise on the
  same gradients, the loss after 3 steps within 1e-3 relative;
* virtual stages P = 2, 3 (the uneven split (0,2),(2,4),(4,4), which is
  ``repro``'s padded one less its zero periods) and 4 against the port's
  P = 1, on the same unpadded parameter tree: 1e-5
  relative (autograd accumulates in another order); with int8 boundaries
  and buckets, within ``repro``'s pinned ``INT8_TOL`` = 5e-2 of the
  uncompressed gradients (``launch/dist_selftest.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import pack_batch as jpack_batch
from repro.kernels import ref as jref
from repro.kernels.quant_transfer import roundtrip as jroundtrip
from repro.kernels.quant_transfer import roundtrip_ef as jroundtrip_ef
from repro.models import attention as jatt
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro.runtime.train import build_train_step as jbuild_train_step
from repro.runtime.train import init_train_state as jinit_train_state
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLM, pack_batch
from repro_torch.interop import (ef_from_numpy, ef_to_numpy, opt_state_from_numpy,
                                 opt_state_to_numpy, params_from_numpy, params_to_numpy)
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launcher
from repro_torch.models.model import loss_fn
from repro_torch.optim import AdamW, cosine_schedule, tree_leaves, tree_map
from repro_torch.runtime.train import (build_train_step, init_train_state, value_and_grad,
                                       wire_buckets)

INT8_TOL = 5e-2          # repro's pinned compressed-vs-raw gradient bound


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _rel(a, b) -> float:
    """max |a - b| / max |b| (dist_selftest's per-leaf measure)."""
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _worst_rel(ta, tb) -> float:
    return max(_rel(a, b) for a, b in zip(tree_leaves(ta), tree_leaves(tb)))


# ---------------------------------------------------------------------------
# plain backward versions against jax.grad
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (BH, BHkv, S, D, window, causal)
    (4, 4, 128, 64, None, True),
    (8, 2, 96, 64, None, True),       # GQA, ragged S
    (4, 1, 128, 96, 32, True),        # MQA + window
    (2, 2, 64, 32, None, False),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_naive_attention_grad_matches_jax(case):
    BH, BHkv, S, D, win, causal = case
    rng = np.random.default_rng(BH * S)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.5
               for s in ((BH, S, D), (BHkv, S, D), (BHkv, S, D)))
    dout = rng.standard_normal((BH, S, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref.naive_attention(a, b, c, causal=causal, window=win),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = ref.naive_attention_bwd(*map(torch.from_numpy, (q, k, v, dout)),
                                  causal=causal, window=win)
    for t, j in zip(got, want):
        _close(t, j, 2e-5)


def test_model_layout_attention_grad_matches_blocked_causal():
    """The (B, S, H, D) plain backward against jax.grad of the model's XLA
    attention path (``blocked_causal_attention``), GQA."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 2, 96, 4, 2, 64
    q = rng.standard_normal((B, S, H, D)).astype(np.float32) * 0.5
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) * 0.5 for _ in range(2))
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jatt.blocked_causal_attention(
        a, b, c, scale=D ** -0.5, q_chunk=32, kv_chunk=32), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    got = ops.plain_flash_attention_bwd(*map(torch.from_numpy, (q, k, v, dout)))
    for t, j in zip(got, want):
        _close(t, j, 2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_naive_swiglu_grad_matches_jax(act):
    rng = np.random.default_rng(7)
    T, D, F = 24, 64, 160
    x = rng.standard_normal((T, D)).astype(np.float32)
    ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
          for s in ((D, F), (D, F), (F, D))]
    dout = rng.standard_normal((T, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jref.naive_swiglu(*a, act), *map(jnp.asarray, (x, *ws)))
    want = vjp(jnp.asarray(dout))
    got = ref.naive_swiglu_bwd(*map(torch.from_numpy, (x, *ws, dout)), act)
    for t, j in zip(got, want):
        _close(t, j, 1e-4)
    # the elementwise part the CUDA kernel computes, against jax.vjp of
    # act(g)*u: values of order 10, act' written out vs autodiff's order
    g, u, dh = (rng.standard_normal((T, F)).astype(np.float32) * 2 for _ in range(3))
    jact = jax.nn.silu if act == "silu" else (lambda z: jax.nn.gelu(z, approximate=True))
    h, vjp = jax.vjp(lambda a, b: jact(a) * b, jnp.asarray(g), jnp.asarray(u))
    dg, du = vjp(jnp.asarray(dh))
    got = ref.naive_swiglu_act_bwd(*map(torch.from_numpy, (g, u, dh)), act)
    for t, j in zip(got, (dg, du, h)):
        _close(t, j, 1e-4)


# ---------------------------------------------------------------------------
# loss, optimizer, data
# ---------------------------------------------------------------------------


def test_loss_fn_value_and_grad_match_repro():
    jcfg, cfg = jax_smoke_config("phi3-mini-3.8b"), get_smoke_config("phi3-mini-3.8b")
    jparams = jinit_model(jax.random.PRNGKey(0), jcfg)
    tokens = JSyntheticLM(jcfg.vocab_size, 48).batch(0, 3)["tokens"]
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg), has_aux=True)(jparams)
    params = params_from_numpy(_np(jparams), device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg, ce_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jl, 1e-4)
    for key in ("ce", "acc", "tokens"):
        _close(metrics[key], jm[key], 1e-4)
    for t, j in zip(grads, jax.tree.leaves(jg)):
        _close(t, j, 1e-4)


def test_loss_fn_refuses_what_is_not_ported():
    cfg = get_smoke_config("phi3-mini-3.8b")
    params = init_train_state(0, build_train_step(cfg, 2, device="cpu"))[0]
    with pytest.raises(NotImplementedError, match="prefix"):
        loss_fn(params, {"tokens": torch.zeros(2, 8, dtype=torch.long),
                         "prefix": torch.zeros(2, 1, 4)}, cfg)
    with pytest.raises(NotImplementedError, match="codebook"):
        loss_fn(params, {"tokens": torch.zeros(2, 4, 8, dtype=torch.long)}, cfg)


def test_adamw_update_matches_repro():
    rng = np.random.default_rng(11)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (4, 2, 3)}}
    params_np = tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    jopt = JAdamW(lr=jcosine(1e-2, warmup=1, total=5), weight_decay=0.01)
    opt = AdamW(lr=cosine_schedule(1e-2, warmup=1, total=5), weight_decay=0.01)
    jp, js = params_np, jopt.init(params_np)
    tp = params_from_numpy(params_np, device="cpu")
    ts = opt.init(tp)
    for step in range(3):
        # the third step's gradients are large enough to be clipped
        g_np = tree_map(lambda s: (rng.standard_normal(s) * (3.0 if step == 2 else 0.1))
                        .astype(np.float32), shapes)
        jp, js = jopt.update(g_np, js, jp)
        tp, ts = opt.update(params_from_numpy(g_np, device="cpu"), ts, tp)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(t, j, 1e-6)
    step, m, v = opt_state_to_numpy(ts)
    assert int(step) == int(js.step) == 3
    for t, j in zip(jax.tree.leaves((m, v)), jax.tree.leaves((js.m, js.v))):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-6, rtol=1e-6)


def test_sgd_update_matches_repro():
    from repro.optim import SGD as JSGD
    from repro_torch.optim import SGD
    rng = np.random.default_rng(12)
    shapes = {"w": (6, 4), "b": (4,)}
    params_np = tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    jopt, opt = JSGD(lr=0.05, grad_clip=1.0), SGD(lr=0.05, grad_clip=1.0)
    jp, js = params_np, jopt.init(params_np)
    tp = params_from_numpy(params_np, device="cpu")
    ts = opt.init(tp)
    for _ in range(3):
        g_np = tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
        jp, js = jopt.update(g_np, js, jp)
        tp, ts = opt.update(params_from_numpy(g_np, device="cpu"), ts, tp)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(t, j, 1e-6)
    assert int(ts.step) == int(js.step) == 3


def test_stage_arithmetic_matches_repro():
    from repro.distributed.mesh import pick_stage_count as jpick
    from repro_torch.distributed.mesh import mesh_plan, pick_stage_count, refine
    for n_layers, pat, model, heads in [(32, 1, 1, 32), (32, 1, 16, 32), (30, 1, 8, 32),
                                        (26, 2, 16, 8), (4, 1, 4, 4), (7, 1, 16, 12)]:
        assert pick_stage_count(n_layers, pat, model, heads) == jpick(n_layers, pat, model, heads)
    assert refine(16, 4) == (4, 4) and mesh_plan(4).stage == 4 and mesh_plan(4).tp == 1
    assert mesh_plan(2, model=8).tp == 4
    with pytest.raises(ValueError):
        refine(16, 3)


def test_synthetic_batches_bit_identical():
    for seed, vocab, seq, batch in [(0, 512, 48, 3), (5, 32064, 256, 8)]:
        a, b = SyntheticLM(vocab, seq, seed=seed), JSyntheticLM(vocab, seq, seed=seed)
        for step in (0, 1, 17):
            np.testing.assert_array_equal(a.batch(step, batch)["tokens"],
                                          b.batch(step, batch)["tokens"])
    toks = {"tokens": np.arange(14 * 3).reshape(14, 3)}
    np.testing.assert_array_equal(pack_batch(toks, (3, 4), 2)["tokens"],
                                  jpack_batch(toks, (3, 4), 2)["tokens"])


# ---------------------------------------------------------------------------
# the train step against repro's on a 1x1 mesh
# ---------------------------------------------------------------------------

B, S, M = 4, 32, 2


@pytest.fixture(scope="module")
def ref_steps():
    """repro's stage-1 train steps on a 1x1 mesh, its initial state, and a
    batch, shared by the parity tests below."""
    jcfg = jax_smoke_config("phi3-mini-3.8b")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    steps = {c: jbuild_train_step(jcfg, mesh, global_batch=B, stage=1, n_micro=M,
                                  compress=c, bucket_mb=0.25 if c != "none" else None)
             for c in ("none", "int8")}
    params, opt_state = jinit_train_state(jax.random.PRNGKey(0), steps["none"])
    batch = JSyntheticLM(jcfg.vocab_size, S).batch(0, B)
    return steps, _np(params), _np(opt_state), batch


def _port_step(compress, **kw):
    cfg = get_smoke_config("phi3-mini-3.8b")
    return build_train_step(cfg, B, stage=kw.pop("stage", 1), n_micro=M, compress=compress,
                            bucket_mb=0.25 if compress != "none" else None,
                            device="cpu", **kw)


def test_stage1_grad_matches_repro(ref_steps):
    steps, params_np, _, batch = ref_steps
    ts_j = steps["none"]
    (jl, jm), jg = ts_j.grad_fn(jax.tree.map(jnp.asarray, params_np), ts_j.shard_batch(batch))
    ts = _port_step("none")
    (loss, metrics), grads = ts.grad_fn(params_from_numpy(params_np, "cpu"),
                                        ts.shard_batch(batch))
    _close(loss, jl, 1e-4)
    _close(metrics["tokens"], jm["tokens"], 0)
    for t, j in zip(tree_leaves(grads), jax.tree.leaves(jg)):
        _close(t, j, 1e-4)


def test_stage1_int8_wire_bitwise_and_buckets(ref_steps):
    """Same bucket partition as repro's; on the same gradients, the port's
    bucket wire (error feedback on) is repro's ``roundtrip_ef`` bit for bit."""
    steps, params_np, _, batch = ref_steps
    ts_j = steps["int8"]
    ts = _port_step("int8")
    assert [(f, i, s) for f, i, s in ts.buckets] == [tuple(b) for b in ts_j.buckets]
    assert len(ts.buckets) > 1
    (_, _), g0 = steps["none"].grad_fn(jax.tree.map(jnp.asarray, params_np),
                                       steps["none"].shard_batch(batch))
    g0 = _np(g0)
    jleaves = jax.tree.leaves(g0)
    grads = params_from_numpy(g0, "cpu")
    ef = ts.init_ef()
    new_ef = wire_buckets(ts.spec, grads, ef, ts.buckets)
    leaves = tree_leaves(grads)
    for bi, (_, idxs, _) in enumerate(ts.buckets):
        flat = jnp.concatenate([jnp.asarray(jleaves[i]).reshape(-1) for i in idxs])
        want, res = jroundtrip_ef(flat, jnp.zeros_like(flat), fmt="int8", tile=256)
        got = torch.cat([leaves[i].reshape(-1) for i in idxs])
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
        np.testing.assert_array_equal(new_ef[f"bucket{bi}"][0].numpy().view(np.uint32),
                                      np.asarray(res).view(np.uint32))
    # without error feedback the wire is the plain round trip
    ts_nef = _port_step("int8", error_feedback=False)
    grads = params_from_numpy(g0, "cpu")
    assert wire_buckets(ts_nef.spec, grads, {}, ts_nef.buckets) == {}
    for bi, (_, idxs, _) in enumerate(ts_nef.buckets):
        flat = jnp.concatenate([jnp.asarray(jleaves[i]).reshape(-1) for i in idxs])
        got = torch.cat([tree_leaves(grads)[i].reshape(-1) for i in idxs])
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(jroundtrip(flat, fmt="int8")).view(np.uint32))


def test_stage1_int8_three_steps_and_state_carry(ref_steps):
    """Three int8 steps (error feedback on) on both sides: the loss on the
    first batch afterwards agrees within 1e-3 relative.  repro's state after
    step 1 (params, AdamW moments, error feedback) carried into the port
    gives repro's step-2 loss."""
    steps, params_np, opt_np, batch0 = ref_steps
    ts_j, ts = steps["int8"], _port_step("int8")
    ds = JSyntheticLM(jax_smoke_config("phi3-mini-3.8b").vocab_size, S)
    jp, jo, jef = jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, opt_np), \
        ts_j.init_ef()
    tp, to, tef = params_from_numpy(params_np, "cpu"), opt_state_from_numpy(opt_np, "cpu"), \
        ts.init_ef()
    carried = None
    jlosses, tlosses = [], []
    for step in range(3):
        batch = ds.batch(step, B)
        if step == 1:
            carried = (params_from_numpy(_np(jp), "cpu"), opt_state_from_numpy(_np(jo), "cpu"),
                       ef_from_numpy(_np(jef), "cpu"), batch)
        jp, jo, jef, jl, _ = ts_j.step_fn(jp, jo, jef, ts_j.shard_batch(batch))
        tp, to, tef, tl, _ = ts.step_fn(tp, to, tef, ts.shard_batch(batch))
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    assert all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(tlosses, jlosses)), (tlosses, jlosses)
    assert any(float(t.abs().max()) > 0 for t in tree_leaves(tef))
    jl_after, _ = ts_j.loss_fn(jp, ts_j.shard_batch(batch0))
    tl_after, _ = ts.loss_fn(tp, ts.shard_batch(batch0))
    assert abs(float(tl_after) - float(jl_after)) <= 1e-3 * abs(float(jl_after))
    assert float(tl_after) < tlosses[0]
    # state carried from repro after step 1 reproduces repro's step-2 loss,
    # and the port's state carried back gives repro the port's loss
    cp, co, cef, cbatch = carried
    cp2, co2, cef2, cl, _ = ts.step_fn(cp, co, cef, ts.shard_batch(cbatch))
    assert abs(float(cl) - jlosses[1]) <= 1e-4 * abs(jlosses[1])
    assert int(co2.step) == 2 and set(cef2) == set(_np(jef))
    copy = lambda tree: jax.tree.map(lambda a: jnp.array(a, copy=True), tree)  # noqa: E731
    jp3, jo3, jef3 = (copy(params_to_numpy(cp2)), type(jo)(*copy(opt_state_to_numpy(co2))),
                      copy(ef_to_numpy(cef2)))
    jl3 = float(ts_j.step_fn(jp3, jo3, jef3, ts_j.shard_batch(ds.batch(2, B)))[3])
    tl3 = float(ts.step_fn(cp2, co2, cef2, ts.shard_batch(ds.batch(2, B)))[3])
    assert abs(jl3 - tl3) <= 1e-4 * abs(tl3)


# ---------------------------------------------------------------------------
# virtual stages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_layers():
    cfg = get_smoke_config("phi3-mini-3.8b").replace(n_layers=4)
    batch = SyntheticLM(cfg.vocab_size, S).batch(0, B)
    ts1 = build_train_step(cfg, B, stage=1, n_micro=M, device="cpu")
    params, _ = init_train_state(0, ts1)
    (loss, _), grads = ts1.grad_fn(params, ts1.shard_batch(batch))
    return cfg, params, batch, loss, grads


@pytest.mark.parametrize("P", [2, 3, 4])
def test_virtual_stages_match_one_stage(four_layers, P):
    cfg, params, batch, loss1, grads1 = four_layers
    ts = build_train_step(cfg, B, stage=P, n_micro=M, device="cpu")
    if P == 3:
        assert ts.spec.ranges == ((0, 2), (2, 4), (4, 4))
    (loss, _), grads = ts.grad_fn(params, ts.shard_batch(batch))
    assert _rel(loss, loss1) <= 1e-5
    assert _worst_rel(grads, grads1) <= 1e-5


@pytest.mark.parametrize("P", [2, 4])
def test_int8_boundaries_within_repro_tolerance(four_layers, P):
    cfg, params, batch, loss1, grads1 = four_layers
    ts = build_train_step(cfg, B, stage=P, n_micro=M, compress="int8", bucket_mb=0.25,
                          device="cpu")
    before = dict(ops.LAUNCHES)
    (loss, _), grads, ef = ts.grad_fn(params, ts.shard_batch(batch), ts.init_ef())
    assert ops.LAUNCHES == before               # CPU tensors: plain versions only
    assert _worst_rel(grads, grads1) < INT8_TOL
    assert 0 < _rel(loss, loss1) < 1e-2
    assert all(bool(torch.isfinite(e).all()) for e in ef.values())


def test_step_call_counts(monkeypatch, four_layers):
    """What one step calls, as ``chip_smoke.py`` counts kernel launches on
    the card: M (P - 1) boundary round trips forward and as many backward,
    plus one per gradient bucket; attention and the MLP twice per layer and
    micro-batch (the forward, and its recompute under remat)."""
    import repro_torch.runtime.pipeline as pipe
    import repro_torch.runtime.train as rt
    calls = []

    def counting(name, real):
        def fn(x, *a, **kw):
            calls.append((name, tuple(x.shape)))
            return real(x, *a, **kw)
        return fn

    monkeypatch.setattr(pipe, "roundtrip", counting("wire", pipe.roundtrip))
    monkeypatch.setattr(rt, "roundtrip", counting("wire", rt.roundtrip))
    monkeypatch.setattr(ops, "plain_flash_attention",
                        counting("attn", ops.plain_flash_attention))
    monkeypatch.setattr(ops, "plain_fused_swiglu", counting("mlp", ops.plain_fused_swiglu))
    cfg, params, batch, _, _ = four_layers
    P = 4
    ts = build_train_step(cfg, B, stage=P, n_micro=M, compress="int8", bucket_mb=0.25,
                          error_feedback=False, device="cpu")
    ts.grad_fn(params, ts.shard_batch(batch), ts.init_ef())
    names = [n for n, _ in calls]
    mb_shape = (B // M, S, cfg.d_model)
    assert calls.count(("wire", mb_shape)) == 2 * M * (P - 1)
    assert names.count("wire") == 2 * M * (P - 1) + len(ts.buckets)
    assert names.count("attn") == names.count("mlp") == 2 * cfg.n_layers * M
    calls.clear()
    ts.loss_fn(params, ts.shard_batch(batch))
    names = [n for n, _ in calls]
    assert names.count("attn") == names.count("mlp") == cfg.n_layers * M
    assert names.count("wire") == M * (P - 1)


def test_value_and_grad_matches_autograd_on_stacked_leaves(four_layers):
    """Binding per-period views with preset ``.grad`` buffers gives what plain
    autograd through the stacked leaves gives."""
    cfg, params, batch, _, grads1 = four_layers
    from repro_torch.runtime.pipeline import TrainSpec, spmd_loss_fn
    from repro_torch.distributed.mesh import mesh_plan
    fn = spmd_loss_fn(TrainSpec(cfg=cfg, plan=mesh_plan(2), n_micro=M))
    bound = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(bound)
    loss, _ = fn(bound, {"tokens": torch.from_numpy(batch["tokens"])})
    want = torch.autograd.grad(loss, leaves)
    (_, _), got = value_and_grad(fn, params, {"tokens": torch.from_numpy(batch["tokens"])})
    for a, b in zip(tree_leaves(got), want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert _worst_rel(got, grads1) <= 1e-5


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_cpu(capsys):
    res = launcher.main(["--smoke", "--device", "cpu", "--stage", "2", "--steps", "2",
                         "--compress", "int8", "--global-batch", "4", "--seq", "32",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert "plan: stage=2 tp=1 M=4" in out and "compress=int8 ef" in out
    assert out.count("\nstep ") == 2 and "FINAL tok_s=" in out
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["ts"].device.type == "cpu"


REFUSED = [pytest.param(["--plan", "--portfolio", "2"], id="--plan --portfolio"),
           ["--portfolio", "2"], ["--devices", "8"], ["--data-axis", "2"]]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: f[0])
def test_launcher_refuses_later_slices(flags):
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--smoke", "--device", "cpu", *flags])
    assert exc.value.code not in (0, None) and "slice" in str(exc.value.code)


def test_launcher_needs_a_card_unless_told_cpu():
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--smoke", "--steps", "1"])
    assert "no CUDA card" in str(exc.value.code)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_train_step(get_smoke_config("phi3-mini-3.8b"), 2)
