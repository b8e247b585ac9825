"""The port's planner, cost model, schedules, simulator and lowering against
``repro``'s, on the CPU.

``repro_torch.core`` is a copy of ``repro.core``'s framework-free planning
half, so on the same inputs it must make the same decisions with the same
arithmetic: every field of every ``Plan``, ``SimResult`` and
``LoweredPlan`` is compared, floats to 1e-12 relative (``plan_time``, a
wall-clock reading, excepted).  The inputs are the paper's four evaluation
models (cost tables) and smoke phi3 on the edge clusters A–D, plus
hypothesis draws for Algorithm 1, the K_p policies, Eq. 3 and the
round-latency functions.  The one intended difference: ``reprice_plan``
raises ``ValueError`` where ``repro``'s raises ``IndexError`` (a profile
with fewer devices than the plan names).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need the 'test' extra")
import hypothesis.strategies as st
from hypothesis import given, settings

import repro.configs.paper_models as jpm
import repro.core.allocation as jal
import repro.core.costmodel as jcm
import repro.core.hardware as jhw
import repro.core.lowering as jlo
import repro.core.planner as jpl
import repro.core.profiler as jpr
import repro.core.schedule as jsc
import repro.core.simulator as jsi
import repro.models as jmodels
import repro_torch.configs.paper_models as tpm
import repro_torch.core.allocation as tal
import repro_torch.core.costmodel as tcm
import repro_torch.core.hardware as thw
import repro_torch.core.lowering as tlo
import repro_torch.core.planner as tpl
import repro_torch.core.profiler as tpr
import repro_torch.core.schedule as tsc
import repro_torch.core.simulator as tsi
import repro_torch.models.config as tmodels
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.jamba_1_5_large import ARCH_ID as JAMBA, config_without_experts

REL = 1e-12
SEQ = 64


def canon(x, skip=("plan_time",)):
    """Dataclasses of either package as nested plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: canon(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name not in skip}
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return [canon(v) for v in x.tolist()]
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def assert_same(got, want, path="", rel=REL):
    got, want = canon(got), canon(want)
    _same(got, want, path, rel)


def _same(got, want, path, rel):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", rel)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]", rel)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), (path, got, want)
        if want in (float("inf"), float("-inf")) or want != want:
            assert got == want or (got != got and want != want), (path, got, want)
        else:
            assert abs(got - want) <= rel * max(abs(want), 1e-300), (path, got, want)
    else:
        assert got == want, (path, got, want)


def both(fj, ft):
    """(repro's result, the port's) or, where repro raises, that the port
    raises the same kind of error with the same message (``None``s)."""
    try:
        want = fj()
    except Exception as e:              # noqa: BLE001
        with pytest.raises(Exception) as got:
            ft()
        assert type(got.value).__name__ == type(e).__name__, (got.value, e)
        assert str(got.value) == str(e)
        return None, None
    return want, ft()


# ---------------------------------------------------------------------------
# the planning inputs: cost tables and profiles
# ---------------------------------------------------------------------------

MODELS = [*jpm.PAPER_MODELS, "phi3-mini-3.8b", "gemma2-2b"]
ENVS = "ABCD"


def _stand_in_cfg(mod, L):
    """A ModelConfig of ``L - 2`` one-layer periods for a cost table (the
    lowering reads its period structure only)."""
    return mod.ModelConfig(name="stand-in", n_layers=L - 2, d_model=8, vocab_size=8,
                           d_ff=8, pattern=(mod.LayerSpec(),))


def tables(name):
    """(repro's table, the port's, repro's cfg, the port's cfg, global batch,
    micro-batch)."""
    if name in ("phi3-mini-3.8b", "gemma2-2b"):
        jc, tc = jget_smoke(name), get_smoke_config(name)
        if name == "gemma2-2b":     # 2 periods of a local and a global layer
            jc, tc = jc.replace(n_layers=4), tc.replace(n_layers=4)
        return (jpr.LayerTable.from_model_config(jc, SEQ),
                tpr.LayerTable.from_model_config(tc, SEQ), jc, tc, 16, 4)
    jt, tt = jpm.PAPER_MODELS[name](), tpm.PAPER_MODELS[name]()
    return (jt, tt, _stand_in_cfg(jmodels, jt.L), _stand_in_cfg(tmodels, tt.L),
            jpm.PAPER_BATCH[name], 32)


def test_paper_tables_match_repro():
    for name in jpm.PAPER_MODELS:
        assert_same(tpm.PAPER_MODELS[name](), jpm.PAPER_MODELS[name](), name)
    assert tpm.PAPER_BATCH == jpm.PAPER_BATCH
    assert_same(tpm.efficientnet_b1_fine(), jpm.efficientnet_b1_fine())
    assert_same(tpm.bert_small(512), jpm.bert_small(512))


def test_hardware_presets_match_repro():
    for env in ENVS:
        assert_same(thw.ENVS[env](), jhw.ENVS[env]())
        assert_same(thw.ENVS[env]().sorted_by_memory(), jhw.ENVS[env]().sorted_by_memory())
    assert_same(thw.env_b(thw.MBPS_1000), jhw.env_b(jhw.MBPS_1000))
    for beta in (0, 1, 3, 64):
        assert thw.JETSON_NX.eff(beta) == jhw.JETSON_NX.eff(beta)


def _full_width_pairs():
    j_jamba = jget_config(JAMBA)
    j_jamba = j_jamba.replace(
        name=config_without_experts().name, n_layers=8, moe=None,
        pattern=tuple(dataclasses.replace(s, mlp="mlp") for s in j_jamba.pattern))
    return [(jget_config("phi3-mini-3.8b"), get_config("phi3-mini-3.8b")),
            *((jget_config(a), get_config(a)) for a in ("gemma-2b", "gemma2-2b", "deepseek-7b")),
            (jget_config("rwkv6-7b"), get_config("rwkv6-7b")),
            (j_jamba, config_without_experts())]


@pytest.mark.parametrize("pair", _full_width_pairs(), ids=lambda p: p[1].name)
def test_layer_table_from_model_config_matches_repro(pair):
    """Full-width tables (the port's configs have the MoE-free active
    parameter count), and the analytic profiles on env D."""
    jc, tc = pair
    for spec_j, spec_t in zip(jc.pattern, tc.pattern):
        assert tc.layer_active_param_count(spec_t) == jc.layer_active_param_count(spec_j)
    for seq in (128, 256):
        jt = jpr.LayerTable.from_model_config(jc, seq)
        tt = tpr.LayerTable.from_model_config(tc, seq)
        assert_same(tt, jt)
        jp = jpr.Profile.analytic(jt, jhw.env_d().sorted_by_memory(), 8)
        tp = tpr.Profile.analytic(tt, thw.env_d().sorted_by_memory(), 8)
        np.testing.assert_array_equal(tp.tf_prefix, jp.tf_prefix)
        np.testing.assert_array_equal(tp.tb_prefix, jp.tb_prefix)


# ---------------------------------------------------------------------------
# plan -> simulate -> lower, every model x env
# ---------------------------------------------------------------------------


def _compress(mod, kind):
    if kind == "int8":
        return mod.CompressionConfig(fmt="int8", tile=256, bucket_mb=256.0,
                                     error_feedback=False)
    return kind


def _check_plan(jplan, tplan, jprof, tprof, jcfg, tcfg):
    assert_same(tplan, jplan)
    for policy in ("ours", "gpipe", "a"):
        jsim, tsim = both(lambda: jsi.simulate(jplan, jprof, policy),
                          lambda: tsi.simulate(tplan, tprof, policy))
        assert_same(tsim, jsim)
    for axis in (None, len(jplan.stages), 2 * len(jplan.stages), 3):
        jl, tl = both(lambda: jlo.lower_plan(jplan, jcfg, axis),
                      lambda: tlo.lower_plan(tplan, tcfg, axis))
        if jl is None:
            continue
        assert_same(tl, jl)
        assert tl.tick_makespan() == jl.tick_makespan()
        assert tl.peak_inflight() == jl.peak_inflight()
        assert_same(tl.memory_bound(tprof), jl.memory_bound(jprof))
        for dp in (1, 2, 3, 5):
            assert tlo.lower_micro_alloc(tl, dp) == jlo.lower_micro_alloc(jl, dp)
        jc, tc = both(lambda: jlo.check_against_simulator(jl, jplan, jprof),
                      lambda: tlo.check_against_simulator(tl, tplan, tprof))
        assert_same(tc, jc)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("name", MODELS)
def test_planners_match_repro(name, env):
    """``plan_hpp`` at intra_opt True / False / "auto" x compress none / int8
    / "auto", ``plan_dp`` and ``plan_gpipe``; each plan simulated under
    three schedules and lowered on four model axes."""
    jt, tt, jcfg, tcfg, gb, mb = tables(name)
    assert_same(tt, jt)
    jprof = jpr.Profile.analytic(jt, jhw.ENVS[env]().sorted_by_memory(), mb)
    tprof = tpr.Profile.analytic(tt, thw.ENVS[env]().sorted_by_memory(), mb)
    np.testing.assert_array_equal(tprof.tf_prefix, jprof.tf_prefix)
    np.testing.assert_array_equal(tprof.tb_prefix, jprof.tb_prefix)
    planned = 0
    for intra in (True, False, "auto"):
        for comp in ("none", "int8", "auto"):
            kw = dict(arch=name, intra_opt=intra)
            jplan, tplan = both(
                lambda: jpl.plan_hpp(jprof, gb, mb, compress=_compress(jcm, comp), **kw),
                lambda: tpl.plan_hpp(tprof, gb, mb, compress=_compress(tcm, comp), **kw))
            if jplan is not None:
                planned += 1
                _check_plan(jplan, tplan, jprof, tprof, jcfg, tcfg)
    for fn in ("plan_dp", "plan_gpipe"):
        jplan, tplan = both(lambda: getattr(jpl, fn)(jprof, gb, mb),
                            lambda: getattr(tpl, fn)(tprof, gb, mb))
        if jplan is not None:
            assert_same(tplan, jplan)
            jsim, tsim = both(lambda: jsi.simulate(jplan, jprof),
                              lambda: tsi.simulate(tplan, tprof))
            assert_same(tsim, jsim)
    assert planned > 0


@pytest.mark.parametrize("env", ENVS)
def test_plan_variants_match_repro(env):
    """The planner's other entry points on EfficientNet-B1: allowed stage
    sets, a stage cap, staleness 1, ``auto_microbatch``, a plan on a subset
    of the cluster, and the homogeneous and HetPipe baselines."""
    jt, tt, _, _, gb, mb = tables("efficientnet-b1")
    jprof = jpr.Profile.analytic(jt, jhw.ENVS[env]().sorted_by_memory(), 64)
    tprof = tpr.Profile.analytic(tt, thw.ENVS[env]().sorted_by_memory(), 64)
    for kw in (dict(allowed_stages={1, 2, 4}), dict(max_stages=2), dict(staleness=1),
               dict(allowed_stages={3}, compress="auto")):
        jplan, tplan = both(lambda: jpl.plan_hpp(jprof, gb, mb, **kw),
                            lambda: tpl.plan_hpp(tprof, gb, mb, **kw))
        assert_same(tplan, jplan)
    assert_same(tpl.auto_microbatch(tprof, 256, candidates=(8, 16, 32)),
                jpl.auto_microbatch(jprof, 256, candidates=(8, 16, 32)))
    for fn in ("plan_homogeneous_hpp", "plan_hetpipe_hdp"):
        jplan, tplan = both(lambda: getattr(jpl, fn)(jprof, gb, mb),
                            lambda: getattr(tpl, fn)(tprof, gb, mb))
        assert_same(tplan, jplan)
    D = len(jprof.cluster.devices)
    ranks = tuple(range(D - 1))
    jsub, tsub = jpr.subset_profile(jprof, ranks), tpr.subset_profile(tprof, ranks)
    jplan, tplan = both(lambda: jpl.plan_hpp(jsub, gb, mb, arch="efficientnet-b1"),
                        lambda: tpl.plan_hpp(tsub, gb, mb, arch="efficientnet-b1"))
    assert_same(tplan, jplan)


@pytest.mark.parametrize("env", ENVS)
def test_reprice_plan_refuses_where_repro_fails(env):
    """``reprice_plan`` on every prefix of the cluster: where the profile
    has the devices the plan names, the port's result is repro's; where it
    has fewer, repro fails with an ``IndexError`` deep in the pricing and
    the port raises a ``ValueError`` naming both counts."""
    jt, tt, _, _, gb, mb = tables("mobilenetv2")
    jprof = jpr.Profile.analytic(jt, jhw.ENVS[env]().sorted_by_memory(), mb)
    tprof = tpr.Profile.analytic(tt, thw.ENVS[env]().sorted_by_memory(), mb)
    for comp in ("none", "int8"):
        jplan = jpl.plan_hpp(jprof, gb, mb, compress=_compress(jcm, comp))
        tplan = tpl.plan_hpp(tprof, gb, mb, compress=_compress(tcm, comp))
        used = 1 + max(d for st in jplan.stages for d in st.group)
        failed = 0
        for n in range(1, len(jprof.cluster.devices) + 1):
            jsub = jpr.subset_profile(jprof, range(n))
            tsub = tpr.subset_profile(tprof, range(n))
            try:
                want = jsi.reprice_plan(jplan, jsub)
            except IndexError:
                failed += 1
                with pytest.raises(ValueError, match=f"plan names {used} devices .* "
                                                     f"the profile has {n}"):
                    tsi.reprice_plan(tplan, tsub)
                continue
            assert n >= used
            got = tsi.reprice_plan(tplan, tsub)
            assert_same(got, want)
            assert_same(tsi.simulate(got, tsub), jsi.simulate(want, jsub))
        assert failed == used - 1


# ---------------------------------------------------------------------------
# properties: Algorithm 1, Eq. 3, K_p, round latencies, schedules
# ---------------------------------------------------------------------------

_J_TABLE = jpr.LayerTable.from_model_config(jget_smoke("phi3-mini-3.8b"), 64)
_T_TABLE = tpr.LayerTable.from_model_config(get_smoke_config("phi3-mini-3.8b"), 64)

devices = st.lists(st.tuples(st.floats(0.001, 2.0),      # memory (GB)
                             st.floats(0.05, 4.0),       # TFLOP/s
                             st.floats(1.0, 32.0)),      # half-saturation batch
                   min_size=1, max_size=5)


@st.composite
def alloc_cases(draw):
    devs = draw(devices)
    L = _J_TABLE.L
    i = draw(st.integers(0, L - 1))
    j = draw(st.integers(i + 1, L))
    return (devs, i, j, draw(st.integers(1, 24)), draw(st.integers(1, 7)),
            draw(st.integers(1, 4)), draw(st.booleans()))


def _profiles(devs, max_batch):
    out = []
    for hw, pr, table in ((jhw, jpr, _J_TABLE), (thw, tpr, _T_TABLE)):
        cluster = hw.Cluster(tuple(hw.DeviceProfile(f"d{i}", mem_bytes=m * 1e9,
                                                    flops=f * 1e12, sat_batch=k)
                                   for i, (m, f, k) in enumerate(devs)))
        out.append(pr.Profile.analytic(table, cluster, max_batch))
    return out


@given(alloc_cases())
@settings(max_examples=60, deadline=None)
def test_allocate_microbatch_matches_repro(case):
    devs, i, j, mb, k_p, block, offload = case
    jprof, tprof = _profiles(devs, mb)
    group = tuple(range(len(devs)))
    jres, tres = both(
        lambda: jal.allocate_microbatch(jprof, group, mb, i, j, k_p, block, offload),
        lambda: tal.allocate_microbatch(tprof, group, mb, i, j, k_p, block, offload))
    assert_same(tres, jres)


@given(st.integers(1, 12), st.integers(0, 63), st.integers(1, 64), st.integers(0, 64))
@settings(max_examples=60, deadline=None)
def test_kp_policy_and_stage_memory_match_repro(P, i, beta, M):
    for p in range(P):
        for policy in ("ours", "a", "b", "c", "gpipe"):
            jk, tk = both(lambda: jcm.kp_policy(P, p, policy),
                          lambda: tcm.kp_policy(P, p, policy))
            assert tk == jk
    L = _J_TABLE.L
    i = i % L
    for j in range(i + 1, L + 1):
        k = jcm.kp_policy(P, P - 1)
        assert tcm.stage_memory(_T_TABLE, i, j, beta, k, M) == \
            jcm.stage_memory(_J_TABLE, i, j, beta, k, M)


@st.composite
def step_lists(draw):
    n = draw(st.integers(1, 6))
    t = st.floats(0.0, 5.0, allow_nan=False)
    out = []
    for s in range(2 * n - 1):
        if s % 2 == 0:
            out.append(("exec", draw(t), draw(t), draw(t)))
        else:
            out.append(("comm", draw(t), draw(t), 0.0))
    return out, draw(st.integers(1, 16))


@given(step_lists())
@settings(max_examples=80, deadline=None)
def test_round_latencies_match_repro(case):
    raw, M = case
    jsteps = tuple(jcm.Step(k, ef, eb, ta) for k, ef, eb, ta in raw)
    tsteps = tuple(tcm.Step(k, ef, eb, ta) for k, ef, eb, ta in raw)
    for fn in ("round_latency", "round_latency_async", "round_latency_serialized",
               "exec_phase_latency", "unhidden_allreduce", "dominant_index"):
        assert getattr(tcm, fn)(tsteps, M) == getattr(jcm, fn)(jsteps, M), fn
    assert tcm.max_allreduce(tsteps) == jcm.max_allreduce(jsteps)
    for s in (0, 1):
        assert tcm.hpp_round_latency(tsteps, M, s) == jcm.hpp_round_latency(jsteps, M, s)


@given(st.integers(1, 10), st.integers(1, 24))
@settings(max_examples=60, deadline=None)
def test_schedules_match_repro(P, M):
    for policy in ("ours", "a", "b", "c", "gpipe"):
        jo, to = both(lambda: jsc.schedule_orders(P, M, policy),
                      lambda: tsc.schedule_orders(P, M, policy))
        assert_same(to, jo)
        if jo is None:
            continue
        assert [tsc.max_inflight(o) for o in to] == [jsc.max_inflight(o) for o in jo]
        for s in (0, 1):
            assert_same(tsc.two_stream_orders(P, M, policy, s),
                        jsc.two_stream_orders(P, M, policy, s))
    for db in (False, True):
        assert tsc.scan_ticks(P, M, db) == jsc.scan_ticks(P, M, db)
    assert tsc.scan_ticks(P, M) == M + P - 1


def test_compression_pricing_matches_repro():
    jc, tc = _compress(jcm, "int8"), _compress(tcm, "int8")
    assert_same(tc, jc)
    assert tc.wire_ratio == jc.wire_ratio
    for comp in (None, "int8", "fp8", "none"):
        assert_same(tcm.parse_compress(comp), jcm.parse_compress(comp))
    cluster_j, cluster_t = jhw.env_c(), thw.env_c()
    for nbytes in (0.0, 1e3, 6.3e6):
        assert tcm.compressed_comm_time(nbytes, 1.25e8, tc, 1e12, 2e12) == \
            jcm.compressed_comm_time(nbytes, 1.25e8, jc, 1e12, 2e12)
        for group in ((0,), (0, 1), (0, 2, 3)):
            assert tcm.compressed_allreduce_time(nbytes, group, cluster_t, tc, 1e12) == \
                jcm.compressed_allreduce_time(nbytes, group, cluster_j, jc, 1e12)
            assert tcm.allreduce_time(nbytes, group, cluster_t) == \
                jcm.allreduce_time(nbytes, group, cluster_j)
