"""The MoE layer (``repro_torch.models.moe``) and the MoE models against
``repro``, on the CPU.

Weights come from ``repro``'s initialisers through ``repro_torch.interop``;
inputs are numpy from a seed, with a shared direction added to every token
so that the routing is skewed and the published capacity factor drops
pairs.  The routing decisions (each token's experts and whether each pair
keeps its slot) must be equal, not close: a different expert is not a
rounding error.  The draws are continuous, so exactly tied scores (whose
order ``torch.topk`` and ``lax.top_k`` may break differently) do not occur.
Tolerances, fp32 with TF32 off: outputs, losses and gradients 1e-4
(``ROADMAP.md``'s SwiGLU tolerance), the aux loss 1e-6.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import moe as jmoe
from repro.models.model import decode_step as jdecode_step
from repro.models.model import init_decode_states as jinit_decode_states
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_forward as jmodel_forward
from repro.runtime.train import build_train_step as jbuild_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.models.model import (decode_step, head_logits, init_decode_states,
                                      init_model, loss_fn, model_forward)
from repro_torch.optim import tree_leaves
from repro_torch.runtime.train import build_train_step

ARCH = "phi3.5-moe-42b-a6.6b"
JAMBA = "jamba-1.5-large-398b"
D, E, FF = 64, 4, 128
TOL, TOL_AUX = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread is as fast, and test workers that
    share the cores do not spin against each other; TF32 stays off."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(was)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _rel(a, b) -> float:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _tokens_x(rng, shape, skew=1.5):
    """Normal rows plus one shared direction: skewed routing."""
    return (rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])).astype(np.float32)


def _leaf_index(tree, key: str) -> int:
    """Index of the top-level leaf ``key`` in :func:`tree_leaves` order."""
    from repro_torch.runtime.train import tree_paths
    return [p[-1] for p in tree_paths(tree)].index(key)


def _keep_by_counting(top_e, cap: int) -> np.ndarray:
    """Pairs in token-major order; a pair keeps its slot while fewer than
    ``cap`` earlier pairs went to its expert (written apart from either
    package's cumsum)."""
    seen: dict = {}
    keep = []
    for e in np.asarray(top_e).reshape(-1).tolist():
        keep.append(seen.get(e, 0) < cap)
        seen[e] = seen.get(e, 0) + 1
    return np.array(keep)


def _check_routing(scores, top_e, jtop_e, keep, cap: int, k: int) -> None:
    """Equal experts and equal keep flags; on a difference, the smallest gap
    between a token's k-th and (k+1)-th scores goes into the message."""
    s = np.sort(scores.detach().numpy(), axis=-1)[:, ::-1]
    gap = float((s[:, k - 1] - s[:, k]).min()) if k < s.shape[1] else float("inf")
    assert np.array_equal(top_e.numpy(), np.asarray(jtop_e)), \
        f"expert choice differs; smallest k-th/(k+1)-th score gap {gap:.3e}"
    want = _keep_by_counting(jtop_e, cap)
    assert np.array_equal(keep.numpy(), want), f"keep differs; smallest gap {gap:.3e}"


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

MOE_CASES = [
    pytest.param(dict(capacity_factor=1.25), True, id="cap1.25-drops"),
    pytest.param(dict(capacity_factor=0.25), True, id="cap0.25"),
    pytest.param(dict(capacity_factor=64.0), False, id="cap64"),
    pytest.param(dict(top_k=1), True, id="top1"),
    pytest.param(dict(top_k=3), None, id="top3"),
    pytest.param(dict(score_fn="sigmoid", n_shared_experts=1), True, id="sigmoid-shared"),
]


@pytest.mark.parametrize("kw,drops", MOE_CASES)
def test_moe_matches_repro(kw, drops):
    """Routing decisions equal; the output, the aux loss and the gradients
    of ``sum(out²) + aux`` (every weight and the input) against
    ``jax.grad``; two runs bitwise equal."""
    fields = {"n_experts": E, "top_k": 2, "d_ff": FF, **kw}
    jcfg, cfg = jmoe.MoEConfig(**fields), MoEConfig(**fields)
    pj = _np(jmoe.init_moe(jax.random.PRNGKey(1), D, jcfg))
    pt = params_from_numpy(pj, "cpu")
    assert ("shared" in pt) == bool(cfg.n_shared_experts)
    x = _tokens_x(np.random.default_rng(2), (2, 32, D))
    T = 64

    jtop_w, jtop_e, jaux = jmoe._router(pj, jnp.asarray(x.reshape(T, D)), jcfg, E)
    r = tmoe.route(pt, torch.from_numpy(x).reshape(T, D), cfg, E)
    cap = tmoe.capacity(cfg, T, E)
    keep, slot = tmoe.dispatch_slots(r.top_e, cap, E)
    _check_routing(r.scores, r.top_e, jtop_e, keep, cap, cfg.top_k)
    if drops is not None:
        assert bool((~keep).any()) == drops
    assert int(slot.max()) < cap

    def jloss(p, xx):
        out, aux = jmoe.moe(p, xx, jcfg, E)
        return jnp.sum(out * out) + aux, (out, aux)

    (_, (jout, jaux2)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(pj, jnp.asarray(x))
    leaves = tree_leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe(pt, xt, cfg)
    loss = (out * out).sum() + aux
    grads = torch.autograd.grad(loss, [*leaves, xt])
    assert _rel(out, jout) <= TOL
    aux = float(aux.detach())
    assert abs(aux - float(jaux2)) <= TOL_AUX and aux > 0
    assert float(jaux) == float(jaux2)
    jleaves = jax.tree.leaves(_np(jgp))
    assert len(jleaves) == len(leaves)
    if cfg.top_k == 1:
        # one expert: its renormalised weight is identically 1, so the
        # output's path into the router carries only the cancellation
        # noise of d(s/s)/ds (a few 1e-5 a token, rounded differently by
        # autograd and by JAX); the router's exact gradient is the aux
        # loss's, held on its own
        jrouter = _np(jax.jit(jax.grad(lambda p: jmoe.moe(p, jnp.asarray(x), jcfg, E)[1]))(
            pj))["router"]
        grads = list(grads)
        grads[_leaf_index(pt, "router")] = torch.autograd.grad(
            tmoe.moe(pt, xt, cfg)[1], pt["router"])[0]
        jleaves[_leaf_index(pt, "router")] = jrouter
    for t, j in zip(grads[:-1], jleaves):
        assert _rel(t, j) <= TOL
    assert _rel(grads[-1], jgx) <= TOL

    with torch.no_grad():
        again, aux2 = tmoe.moe(pt, xt, cfg)
    assert torch.equal(again, out.detach()) and float(aux2) == aux


def test_each_expert_is_one_fused_swiglu_call(monkeypatch):
    """E calls of ``fused_swiglu_op`` a layer and forward, each on its
    expert's whole (C, D) buffer with that expert's weights; through the
    stage-2 train step, 2 E per layer and micro-batch (forward and remat)
    in the gradient, E in the loss alone."""
    calls = []
    real = ops.plain_fused_swiglu

    def counting(x, wg, *a, **kw):
        calls.append((tuple(x.shape), tuple(wg.shape)))
        return real(x, wg, *a, **kw)

    monkeypatch.setattr(ops, "plain_fused_swiglu", counting)
    cfg = MoEConfig(n_experts=E, top_k=2, d_ff=FF)
    pt = params_from_numpy(_np(jmoe.init_moe(jax.random.PRNGKey(1), D, jmoe.MoEConfig(
        n_experts=E, top_k=2, d_ff=FF))), "cpu")
    x = torch.from_numpy(_tokens_x(np.random.default_rng(2), (3, 8, D)))
    tmoe.moe(pt, x, cfg)
    cap = tmoe.capacity(cfg, 24, E)
    assert calls == [((cap, D), (D, FF))] * E

    mcfg = get_smoke_config(ARCH)
    B, M, P = 4, 2, 2
    ts = build_train_step(mcfg, B, stage=P, n_micro=M, device="cpu")
    params = init_model(torch.Generator().manual_seed(0), mcfg, "cpu")
    batch = ts.shard_batch({"tokens": np.zeros((B, 16), np.int32)})
    calls.clear()
    ts.grad_fn(params, batch)
    n_exp = mcfg.moe.n_experts
    assert len(calls) == 2 * n_exp * mcfg.n_layers * M
    assert set(c[0] for c in calls) == {(tmoe.capacity(mcfg.moe, B // M * 16, n_exp),
                                         mcfg.d_model)}
    calls.clear()
    ts.loss_fn(params, batch)
    assert len(calls) == n_exp * mcfg.n_layers * M


# ---------------------------------------------------------------------------
# the model: phi3.5-moe's smoke config
# ---------------------------------------------------------------------------


def _jcfg():
    return jget_smoke_config(ARCH)


@pytest.fixture(scope="module")
def phi_ref():
    """repro's smoke phi3.5-moe weights, a batch, its loss, metrics and
    gradients (one compiled call)."""
    jcfg, cfg = _jcfg(), get_smoke_config(ARCH)
    jparams = _np(jax.jit(jinit_model, static_argnums=1)(jax.random.PRNGKey(3), jcfg))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    (loss, metrics), grads = _np(jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg, ce_chunk=8),
        has_aux=True))(jparams))
    return SimpleNamespace(jcfg=jcfg, cfg=cfg, jparams=jparams, tokens=tokens,
                           loss=float(loss), metrics=metrics, grads=grads)


def test_loss_fn_matches_repro(phi_ref):
    """The smoke phi3.5-moe's loss (ce + aux), its metrics and every
    gradient leaf against ``repro``'s."""
    ref, cfg = phi_ref, phi_ref.cfg
    assert cfg.moe is not None and all(s.mlp == "moe" for s in cfg.pattern)
    params = params_from_numpy(ref.jparams, "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_fn(params, {"tokens": torch.from_numpy(ref.tokens)}, cfg, ce_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - ref.loss) <= TOL * abs(ref.loss)
    aux, ce = float(metrics["aux"].detach()), float(metrics["ce"].detach())
    assert abs(aux - float(ref.metrics["aux"])) <= TOL_AUX and aux > 0
    assert abs(ce + aux - loss.item()) <= 1e-6
    jleaves = jax.tree.leaves(ref.grads)
    assert len(grads) == len(jleaves)
    for t, j in zip(grads, jleaves):
        assert _rel(t, j) <= TOL


def test_spmd_loss_divides_aux_by_micro_batches(phi_ref):
    """The port's pipeline loss at 2 virtual stages x 2 micro-batches
    against ``repro``'s pipeline loss (stage 1 on a 1 x 1 mesh, 2
    micro-batches): the aux summed over layers and divided by M, each
    micro-batch routed on its own tokens (the capacity couples only its
    rows), so not the whole batch's aux."""
    ref, cfg = phi_ref, phi_ref.cfg
    B, M = ref.tokens.shape[0], 2
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jts = jbuild_train_step(ref.jcfg, mesh, global_batch=B, stage=1, n_micro=M)
    (jl, jm), jg = jts.grad_fn(jax.tree.map(jnp.asarray, ref.jparams),
                               jts.shard_batch({"tokens": ref.tokens}))
    ts = build_train_step(cfg, B, stage=2, n_micro=M, device="cpu")
    assert ts.spec.ranges == ((0, 1), (1, 2))
    (loss, metrics), grads = ts.grad_fn(params_from_numpy(ref.jparams, "cpu"),
                                        ts.shard_batch({"tokens": ref.tokens}))
    assert abs(float(loss) - float(jl)) <= TOL * abs(float(jl))
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= TOL_AUX
    for t, j in zip(tree_leaves(grads), jax.tree.leaves(_np(jg))):
        assert _rel(t, j) <= TOL
    # the mean of the micro-batches' own aux losses, which differs from
    # the whole batch's
    mb = B // M
    per_mb = [float(jmodel_forward(ref.jparams, jnp.asarray(ref.tokens[m * mb:(m + 1) * mb]),
                                   ref.jcfg, remat=False)[1]) for m in range(M)]
    assert abs(float(metrics["aux"]) - sum(per_mb) / M) <= TOL_AUX
    assert abs(float(metrics["aux"]) - float(ref.metrics["aux"])) > 10 * TOL_AUX


def test_decode_step_matches_repro(phi_ref):
    """Lockstep decode at batch 4 and the default capacity (C = 3 of 4
    experts at top 2: pairs drop) against ``repro``'s ``decode_step``."""
    ref, cfg = phi_ref, phi_ref.cfg
    params = params_from_numpy(ref.jparams, "cpu")
    B, S = ref.tokens.shape[0], 6
    assert tmoe.capacity(cfg.moe, B, cfg.moe.n_experts) == 3
    jstates = jinit_decode_states(B, S, ref.jcfg)
    states = init_decode_states(B, S, cfg, device="cpu")
    jstep = jax.jit(lambda p, t, pos, st: jdecode_step(p, t, pos, st, ref.jcfg))
    with torch.no_grad():
        for t in range(S):
            jlogits, jstates = jstep(ref.jparams, jnp.asarray(ref.tokens[:, t]), t, jstates)
            logits, states = decode_step(params, torch.from_numpy(ref.tokens[:, t]), t,
                                         states, cfg)
            assert _rel(logits, jlogits) <= TOL, t


def test_jamba_with_experts_forward_matches_repro():
    """The published Jamba's smoke form (8 layers: 7 Mamba, 1 attention, MoE
    on the odd layers) as a forward: logits at every position and the aux
    loss.  The weights are the port's ``init_model``'s (repro's initialiser
    takes 8 s here), handed to ``repro`` through ``interop``: the tree has
    repro's structure, shapes and dtypes."""
    jcfg, cfg = jget_smoke_config(JAMBA), get_smoke_config(JAMBA)
    assert [s.mlp for s in cfg.pattern] == ["mlp", "moe"] * 4
    params = init_model(torch.Generator().manual_seed(5), cfg, "cpu")
    jparams = params_to_numpy(params)
    want = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(5), jcfg))
    assert jax.tree.structure(want) == jax.tree.structure(jparams)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: a.shape == b.shape and a.dtype == b.dtype, want, jparams)))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 32)).astype(np.int32)

    def jfwd(p):
        from repro.models.model import _head_weight
        from repro.models.norms import rmsnorm
        h, aux, _ = jmodel_forward(p, jnp.asarray(tokens), jcfg, remat=False)
        h = rmsnorm(p["final_norm"], h, jcfg.norm_eps, jcfg.zero_centered_norm)
        return h @ _head_weight(p, jcfg), aux

    jlogits, jaux = _np(jax.jit(jfwd)(jparams))
    with torch.no_grad():
        h, aux, _ = model_forward(params, torch.from_numpy(tokens), cfg, remat=False)
        logits = head_logits(params, h, cfg)
    assert _rel(logits, jlogits) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL_AUX and float(aux) > 0


# ---------------------------------------------------------------------------
# serving paths and launchers
# ---------------------------------------------------------------------------


def test_launchers_serve_phi35_moe_continuously_on_the_cpu(capsys):
    """``launch.serve --continuous --devices 8`` on smoke phi3.5-moe: the
    planned slot step routes each data shard's rows apart and the stream
    finishes (``tests/test_torch_moe_slots.py`` holds its logits to
    ``repro``'s)."""
    res = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--continuous",
                               "--devices", "8", "--requests", "2", "--gen", "2"])
    out = capsys.readouterr().out
    assert "serve plan: stage=" in out and out.rstrip().endswith("done")
    spec = res["slot_step"].spec
    assert spec.plan.data == 2 and spec.groups == 1      # a token set a data shard
    done = res["completions"]
    assert len(done) == len(res["requests"]) >= 1 and all(len(c.tokens) == 2 for c in done)
    assert all(0 <= t < 512 for c in done for t in c.tokens)


def test_launchers_run_phi35_moe_on_the_cpu(capsys):
    """``launch.serve`` and ``launch.train --stage 2`` at phi3.5-moe's smoke
    size; the train launcher reports each step's ce and aux."""
    res = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--prompt-len", "4", "--gen", "4", "--batch", "2"])
    assert res["tokens"].shape == (8, 2)
    res = train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--stage", "2",
                               "--steps", "2", "--global-batch", "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "FINAL tok_s=" in out and "done" in out
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    for loss, m in zip(res["losses"], res["metrics"]):
        assert m["aux"] > 0 and abs(m["ce"] + m["aux"] - loss) <= 1e-5
