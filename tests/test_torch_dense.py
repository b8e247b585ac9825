"""The dense families (gemma-2b, gemma2-2b, deepseek-7b) against ``repro``,
on the CPU.

The configs are ``repro``'s own, cut for the CPU to one period of the
pattern (two layers for gemma-2b, one local and one global for gemma2),
d_model 256, 2 query heads x 256 (Gemma's head_dim: ``smoke_reduce``'s 64
would not reach it), kv 1 or 2, d_ff 512, vocab 512, the local window 16,
softcaps as published.  Weights come from ``repro``'s initialisers through
``repro_torch.interop``; inputs are numpy from a seed.  Tolerances, fp32:
attention outputs 1e-4 and their gradients 2e-5 relative to the largest
value (``tests/test_torch_models.py``, ``tests/test_torch_train.py``);
logits, loss and every gradient 1e-4; prefill against decode 1e-4.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jatt
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.models.model import model_forward as jmodel_forward
from repro.runtime.session import PipelineSession as JSession
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as tatt
from repro_torch.models.config import AttentionConfig
from repro_torch.models.model import (decode_step, head_logits, init_decode_states,
                                      loss_fn, model_forward)
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.runtime.session import PipelineSession
from repro_torch.runtime.train import build_train_step

WINDOW = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread is as fast, and test workers that
    share the cores do not spin against each other."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _rel(a, b) -> float:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _reduce(cfg, kv: int, **attn_kw):
    """``cfg`` cut for the CPU: one period of its pattern (two layers where
    the pattern has one), d_model 256, 2 heads x 256, ``kv`` kv heads, d_ff
    512, vocab 512, local windows 16."""
    return cfg.replace(
        n_layers=max(2, len(cfg.pattern)), d_model=256, d_ff=512, vocab_size=512,
        attn=dataclasses.replace(cfg.attn, n_heads=2, n_kv_heads=kv, head_dim=256,
                                 **attn_kw),
        pattern=tuple(dataclasses.replace(s, window=None if s.window is None else WINDOW)
                      for s in cfg.pattern))


def _pair(arch: str):
    kv = 1 if arch == "gemma-2b" else 2
    return (_reduce(jget_config(arch), kv, q_chunk=16, kv_chunk=16),
            _reduce(get_config(arch), kv))


def _tokens(rng, vocab, B, S):
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# attention at head_dim 256 with Gemma2's softcap
# ---------------------------------------------------------------------------


def test_attention_d256_softcap_window():
    """Forward, ``jax.grad`` (of every weight and the input) and decode at
    head_dim 256, softcap 50, window 16, MQA (gemma2's local layer at
    gemma-2b's kv count): the decode cache is a ring of 16 slots that wraps
    after 16 of the 24 steps."""
    jcfg = jatt.AttentionConfig(n_heads=2, n_kv_heads=1, head_dim=256, softcap=50.0,
                                window=WINDOW, q_chunk=16, kv_chunk=16)
    tcfg = AttentionConfig(n_heads=2, n_kv_heads=1, head_dim=256, softcap=50.0, window=WINDOW)
    pj = _np(jax.jit(jatt.init_attention, static_argnums=(1, 2))(jax.random.PRNGKey(1), 256,
                                                                  jcfg))
    pt = params_from_numpy(pj, "cpu")
    rng = np.random.default_rng(11)
    B, S = 2, 32
    # inputs scaled up so that the scores reach the cap's bend (|s| ~ 30)
    x = (rng.standard_normal((B, S, 256)) * 4).astype(np.float32)
    dout = rng.standard_normal((B, S, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    def fwd(p, xx):
        return jatt.attention_forward(p, xx, jnp.asarray(pos), jcfg)

    want_out, (gp, gx) = jax.jit(lambda p, xx: (fwd(p, xx), jax.grad(
        lambda a, b: jnp.sum(fwd(a, b) * dout), argnums=(0, 1))(p, xx)))(pj, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_(True) for k, v in pt.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tatt.attention_forward(leaves, xt, torch.from_numpy(pos), tcfg)
    _close(out, want_out, 1e-4)
    grads = torch.autograd.grad(out, [*leaves.values(), xt], torch.from_numpy(dout))
    for name, g in zip(leaves, grads):
        assert _rel(g, gp[name]) <= 2e-5, name
    assert _rel(grads[-1], gx) <= 2e-5

    steps = 24
    cj = jatt.init_attention_cache(B, WINDOW, jcfg, jnp.float32)
    ct = tatt.init_attention_cache(B, WINDOW, tcfg, torch.float32, "cpu")
    jdecode = jax.jit(lambda p, xx, t, c: jatt.attention_decode(p, xx, t, c, jcfg))
    for t in range(steps):
        oj, cj = jdecode(pj, jnp.asarray(x[:, t]), jnp.int32(t), cj)
        ot, ct = tatt.attention_decode(pt, torch.from_numpy(x[:, t]), t, ct, tcfg)
        _close(ot, oj, 1e-4)
    _close(ct["k"], cj["k"], 1e-5)
    _close(ct["v"], cj["v"], 1e-5)


# ---------------------------------------------------------------------------
# the whole model: logits, prefill against decode, loss and every gradient
# ---------------------------------------------------------------------------

B, S = 2, 24


def _jax_logits(jparams, jh, jcfg):
    """``repro``'s head on a hidden state: final norm, the (tied) head, the
    final logit softcap (``decode_step``'s head)."""
    from repro.models.model import _head_weight
    from repro.models.norms import rmsnorm
    h = rmsnorm(jparams["final_norm"], jh, jcfg.norm_eps, jcfg.zero_centered_norm)
    logits = (h @ _head_weight(jparams, jcfg)).astype(jnp.float32)
    if jcfg.logit_softcap is not None:
        logits = jcfg.logit_softcap * jnp.tanh(logits / jcfg.logit_softcap)
    return logits


def _reference(arch):
    """``repro``'s weights, a batch, and (one compiled call) its logits at
    every position, loss and gradients."""
    jcfg, cfg = _pair(arch)
    jparams = _np(jax.jit(jinit_model, static_argnums=1)(jax.random.PRNGKey(3), jcfg))
    tokens = _tokens(np.random.default_rng(4), cfg.vocab_size, B, S)
    tj = jnp.asarray(tokens)

    def both(p):
        logits = _jax_logits(p, jmodel_forward(p, tj, jcfg, remat=False)[0], jcfg)
        (loss, _), grads = jax.value_and_grad(
            lambda q: jloss_fn(q, {"tokens": tj}, jcfg, ce_chunk=8), has_aux=True)(p)
        return logits, loss, grads

    logits, loss, grads = _np(jax.jit(both)(jparams))
    return SimpleNamespace(jcfg=jcfg, cfg=cfg, jparams=jparams, tokens=tokens,
                           logits=logits, loss=float(loss), grads=grads)


@pytest.fixture(scope="module")
def gemma2_ref():
    return _reference("gemma2-2b")


@pytest.fixture(scope="module")
def gemma_ref():
    return _reference("gemma-2b")


@pytest.mark.parametrize("which", ["gemma_ref", "gemma2_ref"], ids=["gemma-2b", "gemma2-2b"])
def test_dense_model_matches_repro(which, request):
    """Logits at every position (the embedding scale, (1 + w) norms,
    sandwich norms, the tied head and the final softcap as configured), the
    loss and every gradient leaf (the tied embedding's: its lookup's and the
    head's uses summed) against ``repro``; the port's decode, step by step,
    against its prefill at every position, past the local window (the local
    layer's ring of 16 slots wraps at step 16)."""
    ref = request.getfixturevalue(which)
    cfg = ref.cfg
    params = params_from_numpy(ref.jparams, "cpu")
    assert cfg.tie_embeddings and "head" not in params
    tokens = torch.from_numpy(ref.tokens)
    with torch.no_grad():
        h, _, _ = model_forward(params, tokens, cfg, remat=False)
        logits = head_logits(params, h, cfg)
    assert _rel(logits, ref.logits) <= 1e-4

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = loss_fn(params, {"tokens": tokens}, cfg, ce_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - ref.loss) <= 1e-4 * abs(ref.loss)
    jleaves = jax.tree.leaves(ref.grads)
    assert len(grads) == len(jleaves)
    for t, j in zip(grads, jleaves):
        assert _rel(t, j) <= 1e-4
    assert float(np.abs(ref.grads["embed"]).max()) > 0

    states = init_decode_states(B, S, cfg, device="cpu")
    with torch.no_grad():
        for t in range(S):
            step, states = decode_step(params, tokens[:, t], t, states, cfg)
            assert _rel(step, logits[:, t].numpy()) <= 1e-4, t


def test_stage2_pipeline_step_matches_repro(gemma2_ref):
    """The port's training step on 2 virtual stages x 2 micro-batches
    (remat, chunked cross entropy) against ``repro``'s single-device loss and
    gradients: the tied embedding's gradient sums its use at stage 0 and at
    the last stage's head; then one AdamW step on it."""
    ref, cfg = gemma2_ref, gemma2_ref.cfg
    ts = build_train_step(cfg, B, stage=2, n_micro=2, device="cpu")
    assert ts.spec.ranges == ((0, 1), (1, 1))
    params = params_from_numpy(ref.jparams, "cpu")
    batch = ts.shard_batch({"tokens": ref.tokens})
    (loss, metrics), grads = ts.grad_fn(params, batch)
    assert abs(float(loss) - ref.loss) <= 1e-4 * abs(ref.loss)
    for t, j in zip(tree_leaves(grads), jax.tree.leaves(ref.grads)):
        assert _rel(t, j) <= 1e-4
    opt_state = AdamW(lr=1e-3).init(params)
    before = params["embed"].clone()
    step_loss = ts.step_fn(params, opt_state, batch)[2]
    assert float(step_loss) == float(loss)
    assert not torch.equal(params["embed"], before)


def test_edge_extras_on_a_tied_model(gemma2_ref):
    """A tied model has no ``head`` leaf: the first stage backs up the
    embedding, the last the final norm, as ``repro``'s session does."""
    ref = gemma2_ref
    params = params_from_numpy(ref.jparams, "cpu")
    for P in (1, 2, 3):
        plan = SimpleNamespace(stages=list(range(P)))
        for p in range(P):
            want = JSession._edge_extras(
                SimpleNamespace(cfg=ref.jcfg, params=ref.jparams, plan=plan), p)
            got = PipelineSession._edge_extras(SimpleNamespace(params=params, plan=plan), p)
            assert set(got) == set(want), (P, p)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy() if k != "final_norm" else
                                              got[k]["scale"].numpy(),
                                              np.asarray(want[k] if k != "final_norm" else
                                                         want[k]["scale"]))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-2b", "deepseek-7b"])
def test_launchers_run_dense_archs_on_the_cpu(arch, capsys):
    """``launch.serve`` and ``launch.train --stage 2`` at each dense arch's
    smoke size (head_dim 64, gemma2's window 64)."""
    serve_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--prompt-len", "4", "--gen", "4", "--batch", "2"])
    res = train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--stage", "2", "--steps", "2", "--global-batch", "4",
                               "--seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "FINAL tok_s=" in out
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
