"""The paper's loop on an MoE model, against ``repro``, on the CPU: smoke
phi3.5-moe profiled, planned, lowered, trained, and a session through a
failure.

* ``build_layer_fns`` on an attention + MoE layer (routing, the capacity
  buffers, the experts and the combine) equals ``repro``'s, output and
  input gradient, to 2e-5 (``tests/test_torch_profile.py``'s tolerance).
* ``launch.profile`` -> ``launch.train --plan --profile``: the plan and its
  lowering equal ``repro``'s ``plan_hpp`` + ``lower_plan`` on the same
  measured artifact, every field to 1e-12 relative
  (``tests/test_torch_plan.py``'s ``assert_same``).
* The lowered plan's loss on ``repro``'s weights and a batch equals
  ``repro``'s ``build_train_step_from_lowered`` on a 1 x 4 mesh of CPU host
  devices (a subprocess: the XLA flag must precede JAX) to 1e-4 relative.
  Each micro-batch is a token set on both sides: the port runs one data
  shard, ``repro``'s plan lowers onto one.
* ``PipelineSession`` steps, fails a device, recovers and steps on, from
  ``repro``'s weights: the same recovery and every loss within 1e-4
  relative of ``repro``'s session (``tests/test_torch_session.py``'s
  ``test_drain_evict_losses_match_repro`` tolerance).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core.costmodel as jcm
import repro.core.hardware as jhw
import repro.core.planner as jpl
import repro.core.profiler as jpr
import repro_torch.core.hardware as thw
import repro_torch.core.planner as tpl
import repro_torch.core.profiler as tpr
from repro.configs import get_smoke_config as jget_smoke
from repro.core.lowering import lower_plan as jlower_plan
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.profile import build_layer_fns as jbuild_layer_fns
from repro.models.model import init_model as jinit_model
from repro.runtime.session import PipelineSession as JSession
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import profile as profiler_cli
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as launcher
from repro_torch.runtime.session import PipelineSession
from repro_torch.runtime.train import build_train_step_from_lowered
from test_torch_plan import assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "phi3.5-moe-42b-a6.6b"
SEQ, GB = 32, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_moe_layer_fns_match_repro():
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    B = 2
    key = jax.random.PRNGKey(0)
    jfns, _ = jbuild_layer_fns(jcfg, SEQ, key)
    params = params_from_numpy(_np(jax.jit(lambda k: jinit_model(k, jcfg))(key)), device="cpu")
    fns, _ = profiler_cli.build_layer_fns(cfg, SEQ, device="cpu", params=params)
    assert len(fns) == len(jfns) == cfg.n_layers + 2
    x = np.random.default_rng(5).standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
    for li in range(1, cfg.n_layers + 1):
        y, dx = jax.jit(lambda xx, f=jfns[li]: _value_and_input_grad(f, xx))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = fns[li](xt)
        (dxt,) = torch.autograd.grad(yt, xt, torch.ones_like(yt))
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(dxt.numpy(), np.asarray(dx), atol=2e-5, rtol=2e-5)


def _value_and_input_grad(f, x):
    y, vjp = jax.vjp(f, x)
    return y, vjp(jnp.ones_like(y))[0]


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """The profile artifact and the ``--plan --profile`` launcher's run."""
    path = str(tmp_path_factory.mktemp("moe_prof") / "prof.json")
    profiler_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--replicate", "4",
                       "--seq", str(SEQ), "--batches", "1,2,4", "--repeats", "1",
                       "-o", path])
    res = launcher.main(["--arch", ARCH, "--plan", "--profile", path, "--device", "cpu",
                         "--devices", "4", "--global-batch", str(GB), "--n-micro", "4",
                         "--compress", "int8", "--seq", str(SEQ), "--steps", "2",
                         "--log-every", "1"])
    return path, res


def test_plan_matches_repro_on_the_measured_table(planned):
    path, res = planned
    assert res["profile"].source == "measured" and all(np.isfinite(res["losses"]))
    assert all(m["aux"] > 0 for m in res["metrics"])
    jcfg = jget_smoke(ARCH)
    jtable = jpr.LayerTable.from_model_config(jcfg, SEQ)
    assert_same(tpr.LayerTable.from_model_config(get_smoke_config(ARCH), SEQ), jtable)
    jprof = jpr.load_profile(path).to_profile(jtable, GB)
    jplan = jpl.plan_hpp(jprof, GB, GB // 4, arch=jcfg.name, allowed_stages={1, 2},
                         intra_opt="auto", staleness=0,
                         compress=jcm.CompressionConfig(fmt="int8", tile=256, bucket_mb=None,
                                                        error_feedback=True))
    assert_same(res["profile"].tf_prefix, jprof.tf_prefix)
    assert_same(res["plan"], jplan)
    assert_same(res["lowered"], jlower_plan(jplan, jcfg, 4))


REPRO_TRAIN = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.core.lowering import LoweredPlan
from repro.runtime.train import build_train_step_from_lowered, prepare_params
from repro.models.model import init_model
inp = pickle.load(open(sys.argv[1], "rb"))
cfg = get_smoke_config(inp["arch"])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
lowered = LoweredPlan(**inp["lowered"])
ts = build_train_step_from_lowered(cfg, mesh, lowered)
key = jax.random.PRNGKey(inp["seed"])
params = prepare_params(key, cfg, ts.spec.plan, lowered.stage_periods)
loss, metrics = ts.loss_fn(params, ts.shard_batch({"tokens": inp["tokens"]}))
pickle.dump({"params": jax.tree.map(np.asarray, init_model(key, cfg)), "loss": float(loss),
             "aux": float(metrics["aux"]), "stage": ts.spec.plan.stage,
             "n_micro": ts.spec.n_micro}, open(sys.argv[2], "wb"))
"""


def test_planned_loss_matches_repro_lowered_step(planned, tmp_path):
    _, res = planned
    lowered = res["lowered"]
    tokens = np.random.default_rng(7).integers(0, 512, (GB, SEQ)).astype(np.int32)
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps({"arch": ARCH, "seed": 3, "tokens": tokens,
                                  "lowered": dataclasses.asdict(lowered)}))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REPRO_TRAIN, str(src), str(dst)],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = pickle.loads(dst.read_bytes())
    assert (ref["stage"], ref["n_micro"]) == (lowered.stage, lowered.n_micro)
    ts = build_train_step_from_lowered(get_smoke_config(ARCH), 4, lowered, device="cpu")
    loss, metrics = ts.loss_fn(params_from_numpy(ref["params"], "cpu"),
                               ts.shard_batch({"tokens": tokens}))
    assert abs(float(loss) - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert abs(float(metrics["aux"]) - ref["aux"]) <= 1e-6 and ref["aux"] > 0


B, S = 8, 32


def _sessions():
    """``repro``'s single-stage session over 3 boards and the port's, on
    ``repro``'s weights (``tests/test_torch_session.py``'s
    ``_membership_session``)."""
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    jtable = jpr.LayerTable.from_model_config(jcfg, S)
    jprof = jpr.Profile.analytic(jtable, jhw.Cluster((jhw.JETSON_NX,) * 3, 1e9 / 8),
                                 max_batch=B)
    jplan = jpl.plan_hpp(jprof, B, micro_batch=4, arch=jcfg.name, allowed_stages={1})
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jsess = JSession(jcfg, mesh, jplan, jprof, backup_every=1)
    jsess.init(jax.random.PRNGKey(0))
    table = tpr.LayerTable.from_model_config(cfg, S)
    prof = tpr.Profile.analytic(table, thw.Cluster((thw.JETSON_NX,) * 3, 1e9 / 8),
                                max_batch=B)
    plan = tpl.plan_hpp(prof, B, micro_batch=4, arch=cfg.name, allowed_stages={1})
    sess = PipelineSession(cfg, 1, plan, prof, backup_every=1, device="cpu")
    sess.init(0)
    sess.params = params_from_numpy(_np(jsess.params), "cpu")
    sess.opt_state = sess.optimizer.init(sess.params)
    return jcfg, jsess, sess


def test_session_fail_recover_losses_match_repro():
    jcfg, jsess, sess = _sessions()
    ds = JSyntheticLM(jcfg.vocab_size, S)
    runs = []
    for s in (jsess, sess):
        losses = [float(s.step(ds.batch(k, B))[0]) for k in range(2)]
        s.fail(1)
        out = s.recover_now()
        losses += [float(s.step(ds.batch(k, B))[0]) for k in range(2, 4)]
        runs.append((losses, out.mode, out.restored_periods, s.live_ranks,
                     s.lowered.micro_alloc, s.lowered.n_micro, s.step_count))
    (jl, *jrest), (tl, *trest) = runs
    assert trest == jrest and jrest[0] == "lightweight" and jrest[2] == (0, 2)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-4 * abs(b), (tl, jl)


def test_launchers_cut_the_model_in_depth(tmp_path, capsys):
    """``--n-layers`` of ``launch.profile`` and ``launch.serve`` (as
    ``launch.train``'s): the profile times the cut's layers only, under the
    cut's config fingerprint; the server runs the cut."""
    cfg = get_smoke_config(ARCH).replace(n_layers=1)
    path = str(tmp_path / "cut.json")
    profiler_cli.main(["--arch", ARCH, "--smoke", "--n-layers", "1", "--device", "cpu",
                       "--seq", "16", "--batches", "1", "--repeats", "1", "-o", path])
    mp = tpr.load_profile(path)
    assert mp.L == 3 and mp.compatibility_issues(cfg, 16, device="cpu") == []
    res = serve_launcher.main(["--arch", ARCH, "--smoke", "--n-layers", "1", "--device", "cpu",
                               "--prompt-len", "2", "--gen", "2", "--batch", "2"])
    assert res["serve_step"].spec.cfg.n_layers == 1 and res["tokens"].shape == (4, 2)
