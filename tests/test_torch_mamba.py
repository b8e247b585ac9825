"""The Jamba slice (Mamba mixer, no experts): the port against ``repro``.

``repro`` is the reference: its Pallas scan in interpret mode and its plain
scan (``repro.kernels``), its Mamba block (``repro.models.ssm``), its layers
and its one-card serving steps on a 1x1 mesh.  The JAX side's no-experts
Jamba is ``repro``'s smoke config with every MoE MLP made dense
(``.replace(pattern=..., moe=None)``), which is what the port's
``config_without_experts`` is at full width.  Inputs are numpy from a seed;
weights are ``repro``'s, carried over with ``repro_torch.interop``.  The
port runs on the CPU, where the scan is its step-by-step plain version.

Tolerances, all on float32 values of order 1-10:
* scan 2e-4 abs + rel, ``tests/test_kernels.py``'s for the Pallas scan;
* Mamba block, layers and logits 1e-4 abs: the two sides take the same
  sums in other orders (XLA's associative scan over chunks against the
  serial scan; other matmul kernels), through 8 layers at most;
* the port's decode against its own prefill 1e-4: the serial scan against
  the one-step recurrence, flash against decode attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.runtime import serve as jserve
from repro.runtime.train import prepare_params
from repro_torch.configs import get_config
from repro_torch.configs.common import smoke_reduce
from repro_torch.configs.jamba_1_5_large import ARCH_ID, config_without_experts
from repro_torch.interop import params_from_numpy, params_to_numpy, states_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm
from repro_torch.models.model import decode_step, head_logits, init_decode_states, \
    init_model, model_forward
from repro_torch.runtime import serve as tserve

TOL_SCAN = 2e-4
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=0)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _dense(pattern):
    return tuple(dataclasses.replace(s, mlp="mlp") for s in pattern)


def _configs():
    """(repro's, the port's) smoke no-experts Jamba: 8 layers, d_model 256,
    4 heads x 64 (kv 1), d_ff 512, d_state 8, chunk 32, vocab 512."""
    j = jax_smoke_config(ARCH_ID)
    j = j.replace(pattern=_dense(j.pattern), moe=None)
    return j, smoke_reduce(config_without_experts())


def _scan_inputs(rng, B, S, d, N):
    """repro's scan test inputs (tests/test_kernels.py), from numpy."""
    def randn(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return [t.numpy() for t in ref.mamba_scan_inputs(randn, B, S, d, N)]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_config_matches_repro(size):
    """Published widths, pattern (attention at index 2) and Mamba config;
    only the MLPs differ from repro's Jamba (dense in place of MoE), and the
    depth is one period.  param_count equals repro's for the same config."""
    j = jax_get_config(ARCH_ID)
    j = j.replace(pattern=_dense(j.pattern), moe=None, n_layers=8)
    t = config_without_experts()
    if size == "smoke":
        j, t = _configs()
    assert t.name.startswith(ARCH_ID) and t.n_layers == 8
    assert [s.kind for s in t.pattern] == ["mamba", "mamba", "attn"] + ["mamba"] * 5
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "name":
            continue
        if f.name == "attn":          # the port's AttentionConfig has fewer fields
            got = dataclasses.asdict(got)
            want = {k: getattr(want, k) for k in got}
        elif f.name == "mamba":
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        elif f.name == "pattern":
            got = [dataclasses.asdict(s) for s in got]
            want = [dataclasses.asdict(s) for s in want]
        assert got == want, f.name
    assert t.param_count() == j.param_count()
    if size == "full":
        assert (t.d_model, t.d_ff, t.vocab_size, t.mamba.d_inner(t.d_model)) == \
            (8192, 24576, 65536, 16384)


def test_published_jamba_is_refused_naming_moe():
    """The published id is ported, its MoE layers included.  Continuous
    serving refused it once, naming MoE (expert capacity couples the rows of
    a step); each MoE layer now routes one data shard's rows as a token set
    of its own, as ``repro`` does, so nothing refuses it any more: its smoke
    form serves continuously, every request to its end."""
    cfg = get_config(ARCH_ID)
    assert cfg.moe is not None and cfg.n_layers == 72
    from repro_torch.launch.serve import main
    res = main(["--arch", ARCH_ID, "--smoke", "--device", "cpu", "--continuous",
                "--devices", "8", "--requests", "2", "--gen", "2"])
    assert any(s.mlp == "moe" for s in res["slot_step"].spec.cfg.pattern)
    done = res["completions"]
    assert len(done) == len(res["requests"]) >= 1 and all(len(c.tokens) == 2 for c in done)


# ---------------------------------------------------------------------------
# the scan: plain version against repro's kernel and reference
# ---------------------------------------------------------------------------

MAMBA_CASES = [          # tests/test_kernels.py: (B, S, d, N, chunk)
    (2, 128, 64, 16, 64),
    (1, 256, 128, 16, 128),
    (2, 64, 32, 8, 32),
]


@pytest.mark.parametrize("reference", ["pallas_interpret", "repro_ref"])
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_naive_mamba_scan_matches_repro(case, reference):
    B, S, d, N, chunk = case
    dt, b, c, x, a = _scan_inputs(np.random.default_rng(7), B, S, d, N)
    j_in = [jnp.asarray(v) for v in (dt, b, c, x, a)]
    if reference == "pallas_interpret":
        want = pallas_mamba_scan(*j_in, chunk=chunk, interpret=True)
    else:
        want = jref.naive_mamba_scan(*j_in)
    t_in = [torch.from_numpy(v) for v in (dt, b, c, x, a)]
    got = ref.naive_mamba_scan(*t_in)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_SCAN, rtol=TOL_SCAN)
    # the dispatching op takes the plain version for CPU tensors
    assert torch.equal(ops.mamba_scan_op(*t_in), got)


def test_cpu_scan_launches_nothing_and_kernel_refuses_cpu():
    from repro_torch.kernels.mamba_scan import mamba_scan
    t_in = [torch.from_numpy(v) for v in _scan_inputs(np.random.default_rng(1), 1, 4, 8, 8)]
    ops.reset_launches()
    ops.mamba_scan_op(*t_in)
    assert ops.LAUNCHES["mamba_scan"] == 0
    with pytest.raises(ValueError, match="CUDA kernel"):
        mamba_scan(*t_in)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------


def _block_params(seed=3):
    jcfg, tcfg = _configs()
    pj = _np(jssm.init_mamba(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.mamba))
    return jcfg, tcfg, pj, params_from_numpy(pj, "cpu")


def test_init_mamba_layout_matches_repro():
    """Same leaf names, shapes and dtypes as repro's init; the deterministic
    leaves equal (A_log = log n to the last bit of the two libraries' log),
    dt_bias in repro's range."""
    jcfg, tcfg, pj, _ = _block_params()
    pt = tssm.init_mamba(torch.Generator().manual_seed(0), tcfg.d_model, tcfg.mamba,
                         device="cpu", lead=(3,))
    assert sorted(pt) == sorted(pj)
    for k, v in pj.items():
        assert tuple(pt[k].shape) == (3, *v.shape) and str(pt[k].dtype) == f"torch.{v.dtype}", k
    for k in ("D", "conv_b"):
        np.testing.assert_array_equal(pt[k][1].numpy(), pj[k])
    np.testing.assert_allclose(pt["A_log"][1].numpy(), pj["A_log"], rtol=2 ** -23, atol=0)
    dt0 = torch.nn.functional.softplus(pt["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5) and float(dt0.max()) <= 1e-1 * (1 + 1e-5)
    st = tssm.init_mamba_state(2, tcfg.d_model, tcfg.mamba, device="cpu")
    sj = jssm.init_mamba_state(2, jcfg.d_model, jcfg.mamba)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in sj.items()}


def test_mamba_scan_matches_repro_model_scan():
    """The port's model-level scan (ops -> plain serial scan, + D·x) against
    repro's chunked associative scan, over 4 chunks."""
    jcfg, tcfg, pj, pt = _block_params()
    d_in = jcfg.mamba.d_inner(jcfg.d_model)
    xj, xt = _pair(np.random.default_rng(3), (2, 128, d_in), 0.5)
    want, _ = jssm.mamba_scan(pj, xj, jcfg.mamba, jcfg.d_model)
    _close(tssm.mamba_scan(pt, xt, tcfg.mamba, tcfg.d_model), want)


def test_mamba_scan_refuses_lengths_repro_refuses():
    _, tcfg, _, pt = _block_params()
    d_in = tcfg.mamba.d_inner(tcfg.d_model)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        tssm.mamba_scan(pt, torch.zeros(1, 48, d_in), tcfg.mamba, tcfg.d_model)


def test_mamba_forward_matches_repro():
    jcfg, tcfg, pj, pt = _block_params()
    xj, xt = _pair(np.random.default_rng(4), (2, 64, jcfg.d_model))
    want, _ = jssm.mamba_forward(pj, xj, jcfg.mamba)
    _close(tssm.mamba_forward(pt, xt, tcfg.mamba), want)


def test_mamba_decode_matches_repro():
    """Six steps from zero state; the states are updated in place and equal
    repro's returned states."""
    jcfg, tcfg, pj, pt = _block_params()
    B = 2
    sj = jssm.init_mamba_state(B, jcfg.d_model, jcfg.mamba)
    st = states_from_numpy(_np(sj), "cpu")
    leaves = dict(st)
    rng = np.random.default_rng(5)
    for _ in range(6):
        xj, xt = _pair(rng, (B, jcfg.d_model))
        yj, sj = jssm.mamba_decode(pj, xj, jcfg.mamba, sj)
        yt, st = tssm.mamba_decode(pt, xt, tcfg.mamba, st)
        _close(yt, yj)
    assert all(st[k] is leaves[k] for k in leaves)
    _close(st["conv"], sj["conv"])
    _close(st["ssm"], sj["ssm"])


# ---------------------------------------------------------------------------
# layers: both kinds of the no-experts Jamba
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", [0, 2], ids=["mamba_mlp", "attn_mlp"])
def test_layer_matches_repro(index):
    jcfg, tcfg = _configs()
    spec_j, spec_t = jcfg.pattern[index], tcfg.pattern[index]
    assert spec_t.kind == ("attn" if index == 2 else "mamba")
    pj = _np(jblocks.init_layer(jax.random.PRNGKey(6), jcfg, spec_j))
    pt = params_from_numpy(pj, "cpu")
    assert sorted(tblocks.init_layer(torch.Generator().manual_seed(0), tcfg, spec_t,
                                     "cpu")) == sorted(pj)
    rng = np.random.default_rng(6)
    B, S = 2, 32
    xj, xt = _pair(rng, (B, S, jcfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj, _ = jblocks.apply_layer(pj, xj, jnp.asarray(pos), jcfg, spec_j)
    _close(tblocks.apply_layer(pt, xt, torch.from_numpy(pos.copy()), tcfg, spec_t)[0], yj)

    sj = jblocks.init_layer_state(B, 8, jcfg, spec_j, jnp.float32)
    st = states_from_numpy(_np(sj), "cpu")
    for t in range(8):
        xj, xt = _pair(rng, (B, jcfg.d_model))
        yj, sj = jblocks.decode_layer(pj, xj, jnp.int32(t), sj, jcfg, spec_j)
        yt, st = tblocks.decode_layer(pt, xt, t, st, tcfg, spec_t)
        _close(yt, yj)
    assert jax.tree.structure(params_to_numpy(st)) == jax.tree.structure(_np(sj))
    for a, b in zip(jax.tree.leaves(params_to_numpy(st)), jax.tree.leaves(_np(sj))):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_serve_and_prefill_match_repro():
    """build_prefill_step (64 tokens: two of repro's scan chunks) and 8
    build_serve_step steps, logits and final states, against repro's
    one-card serving steps on the same weights."""
    jcfg, tcfg = _configs()
    B, S, L = 2, 64, 8
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jss = jserve.build_serve_step(jcfg, mesh, batch_global=B, cache_len=L)
    jparams = jax.device_get(prepare_params(jax.random.PRNGKey(0), jcfg, jss.spec.plan))
    jstates = jserve.prepare_serve_states(jcfg, jss.spec.plan, B, L)
    tss = tserve.build_serve_step(tcfg, batch_global=B, cache_len=L)
    tparams = params_from_numpy(jparams, "cpu")
    tstates = tserve.prepare_serve_states(tcfg, tss.spec.plan, B, L, device="cpu")
    assert jax.tree.structure(params_to_numpy(tstates)) == jax.tree.structure(
        jax.device_get(jstates))

    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    for pos in range(L):
        lj, jstates = jss.step_fn(jparams, jnp.asarray(tokens[:, pos]), jnp.int32(pos),
                                  jstates)
        lt, tstates = tss.step_fn(tparams, torch.from_numpy(tokens[:, pos]).long(), pos,
                                  tstates)
        _close(lt, lj)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tstates)),
                    jax.tree.leaves(jax.device_get(jstates))):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)

    jps = jserve.build_prefill_step(jcfg, mesh, batch_global=B, seq_len=S)
    tps = tserve.build_prefill_step(tcfg, batch_global=B, seq_len=S)
    want = jps.step_fn(jparams, {"tokens": jnp.asarray(tokens)})
    got = tps.step_fn(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (B, tcfg.vocab_size)
    _close(got, want)


def test_decode_matches_forward():
    """Inside the port: decoding token by token reproduces the full-sequence
    forward's logits at every position (tests/test_decode_parity.py)."""
    _, cfg = _configs()
    B, S = 2, 32
    params = init_model(torch.Generator().manual_seed(1), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        h, _, _ = model_forward(params, tokens, cfg)
        full = head_logits(params, h, cfg)
        states = init_decode_states(B, S, cfg, "cpu")
        for t in range(S):
            logits, states = decode_step(params, tokens[:, t], t, states, cfg)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), atol=TOL, rtol=0,
                                       err_msg=f"position {t}")


def test_params_round_trip_bit_exact():
    """repro's Jamba smoke tree -> torch -> numpy, and the port's own tree
    -> numpy -> torch, leaf for leaf bit-exact (the Mamba leaves cross the
    generic mapping unchanged)."""
    jcfg, tcfg = _configs()
    from repro.models.model import init_model as jax_init_model
    tree = jax.device_get(jax_init_model(jax.random.PRNGKey(1), jcfg))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    mine = init_model(torch.Generator().manual_seed(3), tcfg, "cpu")
    again = params_from_numpy(params_to_numpy(mine), "cpu")
    assert jax.tree.structure(params_to_numpy(again)) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(params_to_numpy(mine)), jax.tree.leaves(params_to_numpy(again))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
