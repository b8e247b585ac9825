"""DeepSeek-V3's MLA and MTP in the port against ``repro``, on the CPU.

At ``repro``'s smoke size of ``deepseek-v3-671b`` (2 layers, d_model 256,
4 heads, MLA ranks 64 / 32, heads 32 + 16 wide, values 32, 4 experts top 2
with a shared one, MTP depth 1), fp32 with TF32 off.  Weights come from
``repro``'s initialisers through ``repro_torch.interop``; inputs are numpy
from a seed.  The port runs its plain kernel versions on CPU tensors.
Tolerances: MLA prefill and decode outputs and caches 2e-5 (``test_torch_
models.py``'s: the sums run in other orders, XLA's blocked online softmax
against a full one); the latent plain version against ``repro``'s einsums
1e-5; losses, the MTP term and every gradient leaf 1e-4 relative
(``test_torch_moe.py``'s), the MoE aux loss 1e-6; the slot step's logits
1e-4 relative.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import attention as jatt
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.models.module import NO_PARALLEL
from repro.runtime.serve import build_slot_serve_step as jbuild_slot_serve_step
from repro.runtime.serve import prepare_serve_states as jprepare_serve_states
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import decode_attention, ops, ref
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as tatt
from repro_torch.models.model import MTP_WEIGHT, init_model, loss_fn
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.runtime import serve as tserve
from repro_torch.runtime.train import build_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCH = "deepseek-v3-671b"
TOL_ATTN, TOL_LATENT, TOL, TOL_AUX = 2e-5, 1e-5, 1e-4, 1e-6


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


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _rel(a, b) -> float:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _attn_cfgs():
    return jget_smoke_config(ARCH).attn, get_smoke_config(ARCH).attn


# ---------------------------------------------------------------------------
# the attention layer
# ---------------------------------------------------------------------------


def test_mla_forward_matches_repro():
    """Prefill over 80 positions (past ``repro``'s 64-position chunk): the
    latent expanded per head, v zero-padded from 32 to q/k's 48 and sliced
    back, against ``repro``'s ``mla_forward``; ``attention_forward``
    dispatches to it."""
    jcfg, cfg = _attn_cfgs()
    assert cfg.mla is not None and cfg.mla.v_head_dim < cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
    pj = _np(jatt.init_mla_attention(jax.random.PRNGKey(1), 256, jcfg))
    pt = params_from_numpy(pj, "cpu")
    assert sorted(pt) == sorted(tatt.init_mla_attention(None, 256, cfg, device="meta"))
    x = np.random.default_rng(2).standard_normal((2, 80, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80))
    want = jax.jit(lambda p, xx: jatt.mla_forward(p, xx, jnp.asarray(pos), jcfg,
                                                  NO_PARALLEL))(pj, jnp.asarray(x))
    with torch.no_grad():
        got = tatt.attention_forward(pt, torch.from_numpy(x), torch.from_numpy(pos.copy()), cfg)
    _close(got, want, TOL_ATTN)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_mla_decode_matches_repro(per_row):
    """Seven decode steps from an empty latent cache, lockstep (a scalar
    position) or each row at its own position: every step's output and the
    cache ``{"c_kv", "k_rope"}`` name for name against ``repro``'s
    ``mla_decode`` (the absorbed products, then the latent attention)."""
    jcfg, cfg = _attn_cfgs()
    B, S = 3, 16
    pj = _np(jatt.init_mla_attention(jax.random.PRNGKey(3), 256, jcfg))
    pt = params_from_numpy(pj, "cpu")
    jcache = jatt.init_attention_cache(B, S, jcfg, jnp.float32)
    cache = tatt.init_attention_cache(B, S, cfg, torch.float32, "cpu")
    assert {k: v.shape for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    step = jax.jit(lambda p, xx, ps, c: jatt.mla_decode(p, xx, ps, c, jcfg, NO_PARALLEL))
    rng = np.random.default_rng(4)
    for t in range(7):
        x = rng.standard_normal((B, 256)).astype(np.float32)
        pos = np.array([t, t + 3, t + 8], np.int32) if per_row else np.int32(t)
        jout, jcache = step(pj, jnp.asarray(x), jnp.asarray(pos), jcache)
        with torch.no_grad():
            out, cache = tatt.attention_decode(
                pt, torch.from_numpy(x), torch.from_numpy(pos) if per_row else t, cache, cfg)
        _close(out, jout, TOL_ATTN)
        for name in ("c_kv", "k_rope"):
            _close(cache[name], jcache[name], TOL_ATTN)


def _repro_latent(q_lat, q_rope, ckv, krope, cache_len, scale):
    """``repro.models.attention.mla_decode``'s latent attention, its lines
    as they are there (one data shard)."""
    S = ckv.shape[1]
    pos = jnp.arange(S)
    if jnp.ndim(cache_len) == 1:
        vmask = (pos[None, :] < cache_len[:, None])[:, None]
    else:
        vmask = (pos < cache_len)[None, None]
    s = jnp.einsum("bhr,bkr->bhk", q_lat, ckv)
    s += jnp.einsum("bhd,bkd->bhk", q_rope, krope)
    s = jnp.where(vmask, s * scale, jatt.NEG_INF)
    p = jnp.exp(s - s.max(axis=-1)[..., None])
    o_lat = jnp.einsum("bhk,bkr->bhr", p, ckv)
    return o_lat / jnp.maximum(p.sum(axis=-1), 1e-37)[..., None]


@pytest.mark.parametrize("lens", [40, (40, 1, 17)], ids=["scalar", "per-row"])
def test_latent_plain_version_matches_repro(lens):
    """``ref.naive_latent_decode`` (the latent route's plain version, which
    ``ops.flash_decode_latent_op`` runs for CPU tensors) against
    ``repro``'s einsums at the published widths (c_kv 512, k_rope 64) and
    MLA's scale, 192^-0.5."""
    B, H, S, R, Dr = 3, 8, 48, 512, 64
    rng = np.random.default_rng(5)
    q_lat, q_rope, ckv, krope = (rng.standard_normal(s).astype(np.float32)
                                 for s in ((B, H, R), (B, H, Dr), (B, S, R), (B, S, Dr)))
    scale = 192 ** -0.5
    clen = np.asarray(lens, np.int32)
    want = _repro_latent(*(jnp.asarray(a) for a in (q_lat, q_rope, ckv, krope, clen)), scale)
    t = [torch.from_numpy(a) for a in (q_lat, q_rope, ckv, krope)]
    got = ops.flash_decode_latent_op(*t, torch.from_numpy(clen) if clen.ndim else int(clen),
                                     scale=scale)
    assert got.shape == (B, H, R) and got.dtype == torch.float32
    _close(got, want, TOL_LATENT)
    _close(ref.naive_latent_decode(*t, torch.from_numpy(clen) if clen.ndim else int(clen),
                                   scale=scale), want, TOL_LATENT)


def test_latent_route_refuses_cpu_tensors_and_splits():
    """The kernel wrapper launches or raises: CPU tensors are refused (the
    op takes the plain version for them, by device alone).  The split count
    at this slice's shapes on the H100's 132 SMs: 2 at the decode step (64
    CTAs of 16 heads), 16 at batch 1 over 4096 keys."""
    t = [torch.zeros(s) for s in ((1, 16, 512), (1, 16, 64), (1, 8, 512), (1, 8, 64))]
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.flash_decode_latent(*t, 8, scale=1.0)
    assert decode_attention.latent_splits(8, 128, 256, 132) == 2
    assert decode_attention.latent_splits(1, 128, 4096, 132) == 16
    assert decode_attention.latent_splits(8, 128, 32, 132) == 1
    assert decode_attention.latent_splits(64, 128, 4096, 132) == 1


# ---------------------------------------------------------------------------
# the model: loss with MTP, the pipelined step, the slot step, launchers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ds_ref():
    """repro's smoke deepseek-v3 weights (with the MTP head), a batch, and
    its loss, metrics and gradients (one compiled call)."""
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    jparams = _np(jax.jit(jinit_model, static_argnums=1)(jax.random.PRNGKey(6), jcfg))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    (loss, metrics), grads = _np(jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg, ce_chunk=8),
        has_aux=True))(jparams))
    return SimpleNamespace(jcfg=jcfg, cfg=cfg, jparams=jparams, tokens=tokens,
                           loss=float(loss), metrics=metrics, grads=grads)


def test_loss_fn_with_mtp_matches_repro(ds_ref):
    """``loss_fn`` = ce + aux + 0.3 mtp: each part and every gradient leaf,
    the MTP head's (``params["mtp"]``) among them, against ``repro``'s."""
    ref_, cfg = ds_ref, ds_ref.cfg
    params = params_from_numpy(ref_.jparams, "cpu")
    assert set(params["mtp"]) == {"combine", "norm_h", "norm_e", "block", "final_norm"}
    mine = params_to_numpy(init_model(torch.Generator().manual_seed(0), cfg, "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(ref_.jparams)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: a.shape == b.shape and a.dtype == b.dtype, mine, ref_.jparams)))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_fn(params, {"tokens": torch.from_numpy(ref_.tokens)}, cfg, ce_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - ref_.loss) <= TOL * abs(ref_.loss)
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    for k in ("ce", "mtp"):
        assert abs(metrics[k] - float(ref_.metrics[k])) <= TOL * float(ref_.metrics[k])
    assert abs(metrics["aux"] - float(ref_.metrics["aux"])) <= TOL_AUX
    parts = metrics["ce"] + metrics["aux"] + MTP_WEIGHT * metrics["mtp"]
    assert abs(parts - loss.item()) <= 1e-6 and metrics["mtp"] > 0
    jleaves = jax.tree.leaves(ref_.grads)
    assert len(grads) == len(jleaves)
    for t, j in zip(grads, jleaves):
        assert _rel(t, j) <= TOL


REPRO_STEP = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.optim import AdamW
from repro.runtime.train import build_train_step
inp = pickle.load(open(sys.argv[1], "rb"))
cfg = get_smoke_config(inp["arch"])
stage = inp["stage"]
mesh = Mesh(np.array(jax.devices()[:stage]).reshape(1, stage), ("data", "model"))
ts = build_train_step(cfg, mesh, global_batch=inp["tokens"].shape[0], stage=stage, n_micro=2,
                      optimizer=AdamW(lr=1e-3))
assert ts.spec.plan.stage == stage
params = jax.tree.map(jnp.asarray, inp["params"])
p, opt, loss, metrics = ts.step_fn(params, AdamW(lr=1e-3).init(params),
                                   ts.shard_batch({"tokens": inp["tokens"]}))
out = jax.tree.map(np.asarray, jax.device_get(
    {"loss": loss, "metrics": metrics, "params": p, "m": opt.m, "v": opt.v}))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def ds_steps(ds_ref, tmp_path_factory):
    """repro's train step (2 micro-batches, AdamW lr 1e-3) on the fixture's
    weights and tokens at 1 and 2 stages: its loss parts, updated
    parameters and AdamW moments after one step.  The 2-stage step needs a
    model axis of 2 devices, so both run in a process of their own on
    ``repro``'s CPU host devices (the XLA flag must be set before JAX
    starts)."""
    tmp = tmp_path_factory.mktemp("ds_steps")
    procs = {}
    for stage in (1, 2):                      # both processes at once
        src = tmp / f"in{stage}.pkl"
        src.write_bytes(pickle.dumps({"arch": ARCH, "stage": stage, "tokens": ds_ref.tokens,
                                      "params": ds_ref.jparams}))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={stage}")
        procs[stage] = subprocess.Popen(
            [sys.executable, "-c", REPRO_STEP, str(src), str(tmp / f"out{stage}.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    out = {}
    for stage, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        out[stage] = SimpleNamespace(**pickle.loads((tmp / f"out{stage}.pkl").read_bytes()))
    return out


@pytest.mark.parametrize("stage", [1, 2])
def test_pipelined_step_with_mtp_matches_repro(ds_ref, ds_steps, stage):
    """The port's train step at 1 and 2 virtual stages (2 micro-batches,
    the smoke config's capacity factor 1.25) against ``repro``'s at the
    same stage count: ce, aux and mtp, and after one AdamW step every
    moment leaf and the parameters where the step is well-conditioned.  At
    2 stages ``repro`` runs the MTP block on each stage's micro-batch, so
    its MoE routes one micro-batch's rows as a token set; the port's block
    runs once with 2 token sets."""
    ref_, cfg, want = ds_ref, ds_ref.cfg, ds_steps[stage]
    ts = build_train_step(cfg, 4, stage=stage, n_micro=2, optimizer=AdamW(lr=1e-3),
                          device="cpu")
    assert ts.spec.plan.stage == stage
    params = params_from_numpy(ref_.jparams, "cpu")
    opt = AdamW(lr=1e-3).init(params)
    params, opt, loss, metrics = ts.step_fn(params, opt, ts.shard_batch(
        {"tokens": ref_.tokens}))
    assert abs(float(loss) - float(want.loss)) <= TOL * abs(float(want.loss))
    for k in ("ce", "mtp"):
        assert abs(float(metrics[k]) - float(want.metrics[k])) <= TOL * float(want.metrics[k])
    assert abs(float(metrics["aux"]) - float(want.metrics["aux"])) <= TOL_AUX
    for t, j in zip(tree_leaves(opt.m), jax.tree.leaves(want.m)):
        assert _rel(t, j) <= TOL
    for t, j in zip(tree_leaves(opt.v), jax.tree.leaves(want.v)):
        assert _rel(t, j) <= TOL
    # AdamW's first step moves a weight by lr * g / (|g| + eps): where |g|
    # is within rounding of eps (1e-8) the step is anywhere in [-lr, lr], so
    # the weights are held where |g| >= 1e-5 (the clipped gradient, from
    # the first moment (1 - b1) g)
    for t, j, jm in zip(tree_leaves(params), jax.tree.leaves(want.params),
                        jax.tree.leaves(want.m)):
        well = np.abs(jm) / (1 - 0.9) >= 1e-5
        diff = np.abs(t.numpy() - j)[well]
        assert diff.size == 0 or diff.max() <= TOL * np.abs(j).max()


def test_slot_step_on_mla_matches_repro(ds_ref):
    """``build_slot_serve_step`` at shard_alloc (3,) on the latent caches,
    slots admitted at steps 0, 1 and 2 (per-row positions, resets), against
    ``repro``'s on a 1 x 1 mesh, logits step by step; no MTP head is read."""
    ref_ = ds_ref
    jcfg = ref_.jcfg.replace(mtp_depth=0)
    jparams = {k: v for k, v in ref_.jparams.items() if k != "mtp"}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cache = 8
    jss = jbuild_slot_serve_step(jcfg, mesh, cache_len=cache, shard_alloc=(3,), stage=1)
    jstates = jprepare_serve_states(jcfg, jss.spec.plan, 3, cache)
    ss = tserve.build_slot_serve_step(ref_.cfg, cache_len=cache, shard_alloc=(3,), stage=1)
    states = tserve.prepare_serve_states(ref_.cfg, ss.spec.plan, 3, cache, "cpu")
    assert {k: v.shape for k, v in states[0]["mixer"].items()} == \
        {k: tuple(v.shape) for k, v in jstates[0]["mixer"].items()}
    params = params_from_numpy(jparams, "cpu")
    start = np.array([0, 1, 2])
    for t in range(6):
        pos = np.maximum(t - start, 0).astype(np.int32)
        reset = (t == start)
        tok = ref_.tokens[:3, t].astype(np.int32)
        jlg, jstates = jss.step_fn(jax.tree.map(jnp.asarray, jparams), jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(reset), jstates)
        lg, states = ss.step_fn(params, torch.from_numpy(tok), torch.from_numpy(pos),
                                reset, states)
        assert _rel(lg, np.asarray(jlg)) <= TOL, t


def test_launchers_run_deepseek_v3_on_the_cpu(capsys):
    """``launch.serve --arch deepseek-v3-671b --smoke --device cpu`` (no MTP
    head allocated) and ``launch.train --stage 2 --n-experts 2`` (the routed
    experts cut from 4, as the card's training cell cuts 256 to 16), whose
    steps report a finite, positive ``mtp`` term in the loss; a cut below
    top-k is refused."""
    res = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--prompt-len", "4", "--gen", "4", "--batch", "2"])
    assert res["tokens"].shape == (8, 2) and "mtp" not in res["params"]
    assert all(0 <= t < 512 for t in res["tokens"].reshape(-1))
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--stage", "2", "--steps", "2",
            "--global-batch", "4", "--seq", "32", "--compress", "int8", "--n-experts"]
    res = train_launcher.main(argv + ["2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "FINAL tok_s=" in out and "done" in out
    assert "mtp" in res["params"] and res["ts"].spec.cfg.moe.n_experts == 2
    assert res["params"]["mtp"]["block"]["layers"][0]["moe"]["experts"]["gate"].shape[0] == 2
    with pytest.raises(SystemExit, match="n-experts 1"):
        train_launcher.main(argv + ["1"])
    for loss, m in zip(res["losses"], res["metrics"]):
        assert np.isfinite(m["mtp"]) and m["mtp"] > 0 and m["aux"] > 0
        assert abs(m["ce"] + m["aux"] + MTP_WEIGHT * m["mtp"] - loss) <= 1e-5
