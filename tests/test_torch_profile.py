"""The paper's loop in the port, on the CPU: the measured profiler, its
artifact, the ``--plan`` launcher and the planner's stage split in the
runtime, against ``repro``.

* ``build_layer_fns`` on ``repro``'s weights (carried across by
  ``repro_torch.interop``): each layer's output and its input gradient
  under a ones cotangent (what the profiler times as the backward) equal
  ``repro``'s to 2e-5;
* an ``asteroid-profile`` artifact written by either package, loaded by
  the other, gives the same ``to_profile`` arrays (each package's
  fingerprints mark the other's artifact stale, by design);
* the launcher's ``asteroid plan:`` line on env D equals what ``repro``'s
  ``plan_hpp`` + ``lower_plan`` give in-process; with ``--profile`` it
  plans on a port-written ``--replicate 4`` artifact, and falls back to the
  analytic profile, with ``repro``'s warning, on a stale one;
* a split with unequal stages, ((0, 1), (1, 4)), trains on the 4 periods
  unpadded: its gradient equals the stage-1 step's (itself held to
  ``repro``'s) to 1e-5 without compression, and stays within ``repro``'s
  pinned ``INT8_TOL`` = 5e-2 with int8 boundaries and buckets.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core.profiler as jpr
import repro_torch.core.profiler as tpr
from repro.configs import get_smoke_config as jget_smoke
from repro.core.hardware import ENVS as JENVS
from repro.core.lowering import lower_plan as jlower_plan
from repro.core.planner import plan_hpp as jplan_hpp
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.profile import build_layer_fns as jbuild_layer_fns
from repro.launch.profile import measure_model as jmeasure_model
from repro.models.model import init_model as jinit_model
from repro.runtime.train import build_train_step as jbuild_train_step
from repro.runtime.train import init_train_state as jinit_train_state
from repro_torch.configs import get_smoke_config
from repro_torch.core.lowering import LoweredPlan, LoweringError, plan_to_train_step
from repro_torch.core.planner import plan_hpp
from repro_torch.interop import params_from_numpy
from repro_torch.launch import profile as profiler_cli
from repro_torch.launch import train as launcher
from repro_torch.optim import tree_leaves
from repro_torch.runtime.train import (_check_shard_alloc, build_train_step,
                                       build_train_step_from_lowered, init_train_state)

ARCH = "phi3-mini-3.8b"
INT8_TOL = 5e-2          # repro's pinned compressed-vs-raw gradient bound


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _rel(a, b) -> float:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _worst_rel(ta, tb) -> float:
    return max(_rel(a, b) for a, b in zip(tree_leaves(ta), tree_leaves(tb)))


# ---------------------------------------------------------------------------
# the profiler's layer functions and its measurement
# ---------------------------------------------------------------------------


def test_build_layer_fns_match_repro():
    jcfg, cfg = jget_smoke(ARCH), get_smoke_config(ARCH)
    S, B = 32, 3
    key = jax.random.PRNGKey(0)
    jfns, _ = jbuild_layer_fns(jcfg, S, key)
    params = params_from_numpy(_np(jinit_model(key, jcfg)), device="cpu")
    fns, make_input = profiler_cli.build_layer_fns(cfg, S, device="cpu", params=params)
    assert len(fns) == len(jfns) == tpr.LayerTable.from_model_config(cfg, S).L
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(fns[0](torch.from_numpy(tokens).long()).numpy(),
                               np.asarray(jfns[0](jnp.asarray(tokens))), atol=2e-5, rtol=2e-5)
    for li, (f, jf) in enumerate(zip(fns[1:], jfns[1:]), start=1):
        y, vjp = jax.vjp(jf, jnp.asarray(x))
        (dx,) = vjp(jnp.ones_like(y))
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = f(xt)
        (dxt,) = torch.autograd.grad(yt, xt, torch.ones_like(yt))
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), atol=2e-5, rtol=2e-5,
                                   err_msg=f"layer {li}")
        np.testing.assert_allclose(dxt.numpy(), np.asarray(dx), atol=2e-5, rtol=2e-5,
                                   err_msg=f"layer {li} input gradient")
    assert make_input(2, 0).shape == (2, S) and make_input(2, 0).dtype == torch.long
    assert make_input(2, 1).shape == (2, S, cfg.d_model)


def test_build_layer_fns_makes_one_period():
    """By default only the embedding, one period and the head are built,
    on the device asked for."""
    cfg = get_smoke_config(ARCH).replace(n_layers=6)
    fns, make_input = profiler_cli.build_layer_fns(cfg, 16, device="cpu")
    assert len(fns) == cfg.n_layers + 2
    x = make_input(2, 3)
    assert fns[3](x).shape == x.shape and fns[-1](x).shape == (2, 16, cfg.vocab_size)
    layer_params = [f.__defaults__[0] for f in fns[1:-1]]       # each block's weights
    assert all(p is layer_params[0] for p in layer_params)        # period 0's, shared
    assert tree_leaves(layer_params[0])[0].device.type == "cpu"


def test_measure_layer_times_shapes_and_fallback():
    cfg = get_smoke_config(ARCH)
    fns, make_input = profiler_cli.build_layer_fns(cfg, 16, device="cpu")
    tf, tb = tpr.measure_layer_times(fns, make_input, (1, 2), repeats=1)
    assert tf.shape == tb.shape == (2, len(fns))
    assert (tf > 0).all() and (tb > 0).all()
    # the embedding's input is token ids: its backward is charged 2x forward
    np.testing.assert_array_equal(tb[:, 0], tpr.BWD_FLOP_RATIO * tf[:, 0])


# ---------------------------------------------------------------------------
# the artifact across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("prof") / "port.json")
    profiler_cli.main(["--smoke", "--device", "cpu", "--replicate", "4", "--seq", "32",
                       "--batches", "1,2,4", "--repeats", "1", "-o", path])
    return path


def test_port_artifact_loads_in_repro(port_artifact):
    mp, jmp = tpr.load_profile(port_artifact), jpr.load_profile(port_artifact)
    assert mp.D == jmp.D == 4 and mp.meta["smoke"] and mp.meta["platform"] == "cpu"
    np.testing.assert_array_equal(jmp.tf, mp.tf)
    table = tpr.LayerTable.from_model_config(get_smoke_config(ARCH), 32)
    jtable = jpr.LayerTable.from_model_config(jget_smoke(ARCH), 32)
    for max_batch in (4, 8):
        p, jp = mp.to_profile(table, max_batch), jmp.to_profile(jtable, max_batch)
        np.testing.assert_array_equal(p.tf_prefix, jp.tf_prefix)
        np.testing.assert_array_equal(p.tb_prefix, jp.tb_prefix)
        assert [d.mem_bytes for d in p.cluster.devices] == \
            [d.mem_bytes for d in jp.cluster.devices]
        assert p.source == jp.source == "measured"
    # fresh for the port on this host and config, stale for repro
    assert mp.compatibility_issues(get_smoke_config(ARCH), 32, device="cpu") == []
    assert mp.compatibility_issues(get_smoke_config(ARCH), 64, device="cpu")
    assert jmp.compatibility_issues(jget_smoke(ARCH), 32)


def test_repro_artifact_loads_in_port(tmp_path):
    jmp = jmeasure_model(jget_smoke(ARCH), 32, (1, 2), 1, replicate=2, mem_bytes=4e9)
    path = str(tmp_path / "repro.json")
    jpr.save_profile(path, jmp)
    mp = tpr.load_profile(path)
    assert mp.D == 2
    table = tpr.LayerTable.from_model_config(get_smoke_config(ARCH), 32)
    jtable = jpr.LayerTable.from_model_config(jget_smoke(ARCH), 32)
    p, jp = mp.to_profile(table, 6), jmp.to_profile(jtable, 6)
    np.testing.assert_array_equal(p.tf_prefix, jp.tf_prefix)
    np.testing.assert_array_equal(p.tb_prefix, jp.tb_prefix)
    # bit-exact round trip through the port's writer
    again = str(tmp_path / "again.json")
    tpr.save_profile(again, mp)
    back = tpr.load_profile(again)
    assert (back.tf.view(np.uint64) == jmp.tf.view(np.uint64)).all()
    for f in dataclasses.fields(back):
        if f.name not in ("tf", "tb"):
            assert getattr(back, f.name) == getattr(mp, f.name), f.name
    # its config fingerprint hashes repro's config: stale to the port
    assert any("fingerprint" in i for i in
               mp.compatibility_issues(get_smoke_config(ARCH), 32, device="cpu"))


def test_device_fingerprint_is_stable_on_the_cpu():
    assert tpr.device_fingerprint("cpu") == tpr.device_fingerprint(torch.device("cpu"))
    assert len(tpr.device_fingerprint("cpu")) == 16


# ---------------------------------------------------------------------------
# the --plan launcher
# ---------------------------------------------------------------------------


def _plan_line(out: str) -> str:
    return next(line for line in out.splitlines() if line.startswith("asteroid plan:"))


def test_launcher_plan_line_matches_repro(capsys):
    gb, seq, devices = 8, 32, 4
    res = launcher.main(["--plan", "--smoke", "--device", "cpu", "--devices", str(devices),
                         "--env", "D", "--steps", "2", "--global-batch", str(gb),
                         "--seq", str(seq), "--log-every", "1"])
    out = capsys.readouterr().out
    assert "profile=analytic(env D)" in out and "mesh=(data=1, model=4)" in out
    jcfg = jget_smoke(ARCH)
    table = jpr.LayerTable.from_model_config(jcfg, seq)
    prof = jpr.Profile.analytic(table, JENVS["D"]().sorted_by_memory(), max_batch=gb)
    n_periods = jcfg.n_layers // len(jcfg.pattern)
    divisors = {d for d in range(1, devices + 1) if devices % d == 0 and d <= n_periods}
    plan = jplan_hpp(prof, gb, gb // 4, arch=jcfg.name, allowed_stages=divisors,
                     intra_opt="auto", staleness=0, compress=None)
    lowered = jlower_plan(plan, jcfg, devices)
    want = (f"asteroid plan: {lowered.stage} stages periods={lowered.stage_periods} "
            f"M={lowered.n_micro} K_p={lowered.warmup} alloc={lowered.micro_alloc} "
            f"predicted latency {plan.latency:.3f}s")
    assert _plan_line(out) == want
    spec = res["ts"].spec
    assert spec.stage_periods == lowered.stage_periods and spec.n_micro == lowered.n_micro
    assert spec.plan.stage * spec.plan.tp == devices
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))


def test_launcher_plans_on_a_measured_artifact(port_artifact, capsys):
    res = launcher.main(["--plan", "--profile", port_artifact, "--device", "cpu",
                         "--devices", "4", "--steps", "2", "--global-batch", "8",
                         "--n-micro", "4", "--compress", "int8", "--bucket-mb", "0.25",
                         "--no-error-feedback", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "adopting --smoke" in out
    assert f"profile=measured({port_artifact}, 4 devices, batches<=4 measured)" in out
    assert res["profile"].source == "measured" and res["plan"].compress.fmt == "int8"
    assert "compress=int8 bucket_mb=0.25" in out
    lw = res["lowered"]
    assert _plan_line(out).startswith(f"asteroid plan: {lw.stage} stages periods="
                                      f"{lw.stage_periods} M=4")
    assert all(np.isfinite(res["losses"]))


def test_launcher_falls_back_on_a_stale_artifact(port_artifact, capsys):
    with pytest.warns(UserWarning, match="stale or incompatible .* analytic profile "
                                         r"\(env C\).*seq_len=32"):
        res = launcher.main(["--plan", "--profile", port_artifact, "--seq", "16",
                             "--device", "cpu", "--devices", "2", "--env", "C",
                             "--steps", "1", "--global-batch", "4"])
    out = capsys.readouterr().out
    assert "profile=analytic(env C)" in out and res["profile"].source == "analytic"


@pytest.mark.parametrize("flags", [["--profile", "p.json"], ["--compress", "auto"],
                                   ["--devices", "4"]], ids=lambda f: f[0])
def test_launcher_flags_that_need_plan(flags):
    """The planner's inputs are refused without ``--plan``, which alone reads
    them."""
    with pytest.raises(SystemExit, match="requires --plan"):
        launcher.main(["--smoke", "--device", "cpu", "--steps", "1", *flags])


def test_plan_to_train_step_checks_the_model_axis():
    cfg = get_smoke_config(ARCH)
    table = tpr.LayerTable.from_model_config(cfg, 32)
    from repro_torch.core.hardware import ENVS
    prof = tpr.Profile.analytic(table, ENVS["D"]().sorted_by_memory(), 8)
    plan = plan_hpp(prof, 8, 2, arch=cfg.name, allowed_stages={2})
    ts, lowered = plan_to_train_step(plan, prof, cfg, 4, device="cpu")
    assert lowered.stage == 2 and ts.spec.plan.tp == 2
    with pytest.raises(LoweringError, match="does not divide"):
        plan_to_train_step(plan, prof, cfg, 3, device="cpu")


# ---------------------------------------------------------------------------
# a planner split in the runtime
# ---------------------------------------------------------------------------

B, S, M = 4, 32, 2
SPLIT = ((0, 1), (1, 4))


def _lowered(split=SPLIT, B=B, M=M):
    P = len(split)
    return LoweredPlan(arch=ARCH, stage=P, n_micro=M, micro_batch=B // M, global_batch=B,
                       n_periods=split[-1][1], stage_periods=split,
                       stage_layers=tuple((i + 1, j + 1) for i, j in split),
                       device_groups=tuple((p,) for p in range(P)),
                       micro_alloc=tuple((B // M,) for _ in split),
                       warmup=tuple(2 * (P - p) - 1 for p in range(P)))


@pytest.fixture(scope="module")
def four_layers():
    """Stage-1 loss and gradients at 4 smoke layers: repro's (1x1 mesh) and
    the port's on the same weights and batch."""
    jcfg = jget_smoke(ARCH).replace(n_layers=4)
    cfg = get_smoke_config(ARCH).replace(n_layers=4)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jts = jbuild_train_step(jcfg, mesh, global_batch=B, stage=1, n_micro=M)
    jparams, _ = jinit_train_state(jax.random.PRNGKey(0), jts)
    batch = JSyntheticLM(jcfg.vocab_size, S).batch(0, B)
    (jl, _), jg = jts.grad_fn(jparams, jts.shard_batch(batch))
    ts1 = build_train_step(cfg, B, stage=1, n_micro=M, device="cpu")
    params = params_from_numpy(_np(jparams), "cpu")
    (loss1, _), grads1 = ts1.grad_fn(params, ts1.shard_batch(batch))
    return cfg, params, batch, loss1, grads1, float(jl), _np(jg)


def test_stage1_at_four_layers_matches_repro(four_layers):
    _, _, _, loss1, grads1, jl, jg = four_layers
    assert abs(float(loss1) - jl) <= 1e-4 * abs(jl)
    for t, j in zip(tree_leaves(grads1), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, rtol=1e-4)


def test_split_trains_unpadded_and_matches_stage1(four_layers):
    cfg, params, batch, loss1, grads1, _, _ = four_layers
    ts = build_train_step_from_lowered(cfg, 4, _lowered(), device="cpu")
    assert ts.spec.stage_periods == SPLIT and ts.spec.plan.stage == 2 and ts.spec.plan.tp == 2
    fresh, _ = init_train_state(0, ts)
    assert tree_leaves(fresh["periods"])[0].shape[0] == cfg.n_periods == 4
    (loss, _), grads = ts.grad_fn(params, ts.shard_batch(batch))
    assert _rel(loss, loss1) <= 1e-5
    assert all(g.shape == h.shape for g, h in zip(tree_leaves(grads), tree_leaves(grads1)))
    assert _worst_rel(grads, grads1) <= 1e-5


@pytest.mark.parametrize("split", [((0, 3), (3, 4)), ((0, 1), (1, 2), (2, 4))])
def test_other_splits_match_stage1(four_layers, split):
    cfg, params, batch, loss1, grads1, _, _ = four_layers
    ts = build_train_step_from_lowered(cfg, len(split), _lowered(split), device="cpu")
    (loss, _), grads = ts.grad_fn(params, ts.shard_batch(batch))
    assert _rel(loss, loss1) <= 1e-5 and _worst_rel(grads, grads1) <= 1e-5


def test_split_int8_within_repro_tolerance(four_layers):
    cfg, params, batch, loss1, grads1, _, _ = four_layers
    ts = build_train_step_from_lowered(cfg, 2, _lowered(), compress="int8", bucket_mb=0.25,
                                       device="cpu")
    (loss, _), grads, ef = ts.grad_fn(params, ts.shard_batch(batch), ts.init_ef())
    assert _worst_rel(grads, grads1) < INT8_TOL
    assert 0 < _rel(loss, loss1) < 1e-2
    assert all(bool(torch.isfinite(e).all()) for e in ef.values())


def test_split_step_calls_boundaries_per_stage(monkeypatch, four_layers):
    """M (P - 1) boundary round trips forward and as many backward, and every
    period applied once per micro-batch (twice with the remat recompute)."""
    import repro_torch.runtime.pipeline as pipe
    from repro_torch.kernels import ops
    calls = []
    real_rt, real_mlp = pipe.roundtrip, ops.plain_fused_swiglu
    monkeypatch.setattr(pipe, "roundtrip",
                        lambda x, *a, **kw: calls.append("wire") or real_rt(x, *a, **kw))
    monkeypatch.setattr(ops, "plain_fused_swiglu",
                        lambda x, *a, **kw: calls.append("mlp") or real_mlp(x, *a, **kw))
    cfg, params, batch, _, _, _, _ = four_layers
    ts = build_train_step_from_lowered(cfg, 2, _lowered(), compress="int8",
                                       error_feedback=False, device="cpu")
    ts.grad_fn(params, ts.shard_batch(batch), ts.init_ef())
    assert calls.count("wire") == 2 * M * (2 - 1)
    assert calls.count("mlp") == 2 * cfg.n_layers * M


def test_split_and_shard_checks():
    cfg = get_smoke_config(ARCH).replace(n_layers=4)
    for bad, why in ((((0, 2), (3, 4)), "contiguous"), (((0, 1), (1, 3)), "covers"),
                     (((0, 4),), "1 ranges for 2 stages")):
        low = dataclasses.replace(_lowered(), stage_periods=bad)
        with pytest.raises(ValueError, match=why):
            build_train_step_from_lowered(cfg, 2, low, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        build_train_step_from_lowered(cfg, 3, _lowered(), device="cpu")
    with pytest.raises(NotImplementedError, match="real data parallelism"):
        _check_shard_alloc((3, 1))
    _check_shard_alloc((2, 2))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_train_step_from_lowered(cfg, 2, _lowered())


def test_profile_cli_needs_a_card_unless_told_cpu():
    with pytest.raises(SystemExit) as exc:
        profiler_cli.main(["--smoke"])
    assert "no CUDA card" in str(exc.value.code)


def test_no_warning_on_a_fresh_artifact(port_artifact):
    mp = tpr.load_profile(port_artifact)
    cfg = get_smoke_config(ARCH)
    table = tpr.LayerTable.from_model_config(cfg, 32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        prof = tpr.resolve_profile(mp, cfg, 32, table, 8, device="cpu")
    assert prof.source == "measured" and len(prof.cluster.devices) == 4
