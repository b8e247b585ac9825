"""The RWKV-6 slice: the port against ``repro`` on the CPU.

``repro`` is the reference: its Pallas WKV kernel in interpret mode and its
plain recurrence (``repro.kernels``), its time and channel mix
(``repro.models.rwkv``), its layers and its one-card serving steps on a
1x1 mesh, all at the smoke size of ``rwkv6-7b`` (2 layers, d_model 256, 8
heads x 32, d_ff 512, decay LoRA 16, mix LoRA 8, chunk 16, vocab 512).
Inputs are numpy from a seed; weights are ``repro``'s, carried over with
``repro_torch.interop``.  The port runs on the CPU, where the WKV is its
step-by-step plain version.

The tests are built around what a port gets wrong quietly and what
init weights cannot show: prefill clamps the decay logit to [-20, 0] and
decode does not; the LoRA up-projections start at zero; ``ln_x`` keeps
``rmsnorm``'s eps 1e-6 and is not zero-centred whatever the model config
says; and decode states, the channel mix's ``"cm"`` too, are updated in
place (the port's ``decode_periods`` drops the states it is returned).

Tolerances, on float32 values of order 1-10:
* WKV 3e-4 abs + rel, ``tests/test_kernels.py``'s for the Pallas kernel;
* time mix, channel mix, layers and logits 1e-4 abs: the two sides take
  the same sums in other orders (repro's chunked matmul form against the
  serial recurrence; other matmul kernels), through 2 layers;
* the port's decode against its own prefill 1e-4: the serial recurrence
  against the one-step update.
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
from repro.kernels.rwkv6_wkv import rwkv6_wkv as pallas_wkv
from repro.models import blocks as jblocks
from repro.models import rwkv as jrwkv
from repro.models.model import init_model as jax_init_model
from repro.runtime import serve as jserve
from repro.runtime.train import prepare_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy, states_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks as tblocks
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import decode_step, head_logits, init_decode_states, \
    init_model, model_forward
from repro_torch.runtime import serve as tserve

ARCH = "rwkv6-7b"
TOL_WKV = 3e-4
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


def _configs(**changes):
    """(repro's, the port's) smoke rwkv6-7b, both with ``changes``."""
    return (jax_smoke_config(ARCH).replace(**changes),
            get_smoke_config(ARCH).replace(**changes))


def _leaves_close(t_tree, j_tree, tol=TOL):
    t_np, j_np = params_to_numpy(t_tree), _np(j_tree)
    assert jax.tree.structure(t_np) == jax.tree.structure(j_np)
    for a, b in zip(jax.tree.leaves(t_np), jax.tree.leaves(j_np)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# config and bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_config_matches_repro(size):
    """The published config and its smoke form equal repro's field for field,
    and param_count() equals repro's."""
    j = jax_smoke_config(ARCH) if size == "smoke" else jax_get_config(ARCH)
    t = get_smoke_config(ARCH) if size == "smoke" else get_config(ARCH)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "rwkv":
            got = dataclasses.asdict(got)
            want = {k: getattr(want, k) for k in got}
        elif f.name == "pattern":
            got = [dataclasses.asdict(s) for s in got]
            want = [dataclasses.asdict(s) for s in want]
        assert got == want, f.name
    assert t.param_count() == j.param_count()
    if size == "full":
        assert (t.n_layers, t.d_model, t.d_ff, t.vocab_size, t.rwkv.head_dim) == \
            (32, 4096, 14336, 65536, 64)
        assert t.param_count() == 7_575_175_168


def test_params_round_trip_bit_exact():
    """repro's smoke tree -> torch -> numpy, and the port's own tree -> numpy
    -> torch, leaf for leaf bit-exact, with repro's tree structure."""
    jcfg, tcfg = _configs()
    tree = jax.device_get(jax_init_model(jax.random.PRNGKey(1), jcfg))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    mine = params_to_numpy(init_model(torch.Generator().manual_seed(3), tcfg, "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    again = params_to_numpy(params_from_numpy(mine, "cpu"))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(again)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_init_time_mix_layout_matches_repro():
    """Same leaf names, shapes and dtypes as repro's init (with a stacking
    axis); the LoRA up-projections start at zero, ln_x at one, and w0, u
    and mix_base in repro's ranges."""
    jcfg, tcfg = _configs()
    pj = _np(jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(0), jcfg.d_model, jcfg.rwkv))
    pt = trwkv.init_rwkv_time_mix(torch.Generator().manual_seed(0), tcfg.d_model,
                                  tcfg.rwkv, device="cpu", lead=(3,))
    assert jax.tree.structure(params_to_numpy(pt)) == jax.tree.structure(
        jax.tree.map(lambda a: np.stack([a] * 3), pj))
    for a, b in zip(jax.tree.leaves(params_to_numpy(pt)), jax.tree.leaves(pj)):
        assert a.shape == (3, *b.shape) and a.dtype == b.dtype
    for k in ("mix_lora_b", "w_lora_b"):
        assert not pt[k].any()
    assert bool((pt["ln_x"]["scale"] == 1).all())
    assert -8 <= float(pt["w0"].min()) and float(pt["w0"].max()) <= -4
    for k in ("u", "mix_base"):
        assert 0 <= float(pt[k].min()) and float(pt[k].max()) <= 0.5


def test_wkv_op_on_cpu_launches_nothing_and_kernel_refuses_cpu():
    from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
    g = torch.Generator().manual_seed(1)
    inp = ref.wkv6_inputs(lambda s: torch.randn(s, generator=g), 1, 2, 4, 32)
    ops.reset_launches()
    ops.rwkv6_wkv_op(*inp)
    assert ops.LAUNCHES["rwkv6_wkv"] == 0
    with pytest.raises(ValueError, match="CUDA kernel"):
        rwkv6_wkv(*inp)


# ---------------------------------------------------------------------------
# the WKV: plain version against repro's kernel and reference
# ---------------------------------------------------------------------------

WKV_CASES = [          # tests/test_kernels.py: (BH, S, d, chunk)
    (2, 128, 64, 32),
    (4, 256, 64, 64),
    (1, 64, 32, 16),
    (2, 192, 64, 64),
]


def _randn(rng):
    return lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("reference", ["pallas_interpret", "repro_ref"])
@pytest.mark.parametrize("case", WKV_CASES)
def test_naive_wkv6_matches_repro(case, reference):
    """The shared input maker at B = 1, so its BH heads are the rows of
    repro's (BH, S, d) layout and u is (BH, d)."""
    BH, S, d, chunk = case
    r, k, v, w, u = ref.wkv6_inputs(_randn(np.random.default_rng(2)), 1, BH, S, d)
    inp = [t.reshape(BH, S, d) for t in (r, k, v, w)] + [u]
    j_in = [jnp.asarray(t.numpy()) for t in inp]
    if reference == "pallas_interpret":
        want = pallas_wkv(*j_in, chunk=chunk, interpret=True)
    else:
        want = jref.naive_wkv6(*j_in)
    got = ref.naive_wkv6(*inp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_WKV, rtol=TOL_WKV)


@pytest.mark.parametrize("case", [c for c in ref.WKV_EDGE_CASES if c[0][2] <= 256],
                         ids=lambda c: c[2])
def test_wkv_op_layout_matches_repro_on_edge_cases(case):
    """The card's edge cases (all but the full prefill shape) through the
    dispatching op on the CPU: the (B, H, S, d) head views and the u shared by
    the batch, against repro's recurrence on the flattened rows."""
    (B, H, S, d), logit_max, _ = case
    inp = ref.wkv6_inputs(_randn(np.random.default_rng(3)), B, H, S, d, logit_max)
    r, k, v, w, u = inp
    assert r.stride()[1:] == (d, H * d, 1)          # views of (B, S, H*d)
    if logit_max > 0:
        assert float(w.min()) < np.exp(-1.0)         # logits above 0 drawn
    got = ops.rwkv6_wkv_op(*inp)
    flat = [jnp.asarray(t.reshape(B * H, S, d).numpy()) for t in (r, k, v, w)]
    want = jref.naive_wkv6(*flat, jnp.asarray(u.repeat(B, 1).numpy()))
    np.testing.assert_allclose(got.reshape(B * H, S, d).numpy(), np.asarray(want),
                               atol=TOL_WKV, rtol=TOL_WKV)


# ---------------------------------------------------------------------------
# the time mix and channel mix
# ---------------------------------------------------------------------------


def _time_mix_params(jcfg, seed=4, w0_range=None):
    """repro's time-mix weights with both LoRA up-projections made non-zero
    (N(0, 0.1^2) and N(0, 0.5^2)), and w0 redrawn in ``w0_range`` if given;
    numpy tree and its torch copy."""
    pj = _np(jrwkv.init_rwkv_time_mix(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.rwkv))
    rng = np.random.default_rng(seed)
    pj["mix_lora_b"] = (0.1 * rng.standard_normal(pj["mix_lora_b"].shape)).astype(np.float32)
    pj["w_lora_b"] = (0.5 * rng.standard_normal(pj["w_lora_b"].shape)).astype(np.float32)
    if w0_range is not None:
        pj["w0"] = rng.uniform(*w0_range, pj["w0"].shape).astype(np.float32)
    return pj, params_from_numpy(pj, "cpu")


def _logits_above_zero(pj, x):
    """Share of the decay logits above 0 over the inputs x (B, S, D)."""
    xs = jrwkv._token_shift(x, jnp.zeros_like(x[:, :1]))
    xw = jrwkv._ddlerp(pj, x, xs)[:, :, 3]
    logit = pj["w0"] + jnp.tanh(xw @ pj["w_lora_a"]) @ pj["w_lora_b"]
    return float(jnp.mean(logit > 0))


def test_time_mix_prefill_matches_repro_with_lora():
    """The sequence form over 4 of repro's chunks, with non-zero LoRA
    factors; the LoRA parts move the output far beyond the tolerance, so
    the einsums are held."""
    jcfg, tcfg = _configs()
    pj, pt = _time_mix_params(jcfg)
    xj, xt = _pair(np.random.default_rng(5), (2, 64, jcfg.d_model))
    want, _ = jrwkv.rwkv_time_mix(pj, xj, jcfg.rwkv)
    _close(trwkv.rwkv_time_mix(pt, xt, tcfg.rwkv), want)
    no_lora = dict(pj, mix_lora_b=0 * pj["mix_lora_b"], w_lora_b=0 * pj["w_lora_b"])
    base, _ = jrwkv.rwkv_time_mix(no_lora, xj, jcfg.rwkv)
    assert float(jnp.abs(base - want).max()) > 100 * TOL


def test_time_mix_refuses_lengths_repro_refuses():
    jcfg, tcfg = _configs()
    _, pt = _time_mix_params(jcfg)
    with pytest.raises(ValueError, match="multiple of the WKV chunk"):
        trwkv.rwkv_time_mix(pt, torch.zeros(1, 24, tcfg.d_model), tcfg.rwkv)


def test_time_mix_decode_matches_repro_in_place():
    """Eight steps from zero state with non-zero LoRA factors: outputs equal
    repro's, and the state tensors passed in hold repro's returned states."""
    jcfg, tcfg = _configs()
    pj, pt = _time_mix_params(jcfg)
    B = 2
    sj = jrwkv.init_rwkv_state(B, jcfg.d_model, jcfg.rwkv)["tm"]
    st = states_from_numpy(_np(sj), "cpu")
    held = dict(st)
    rng = np.random.default_rng(6)
    for _ in range(8):
        xj, xt = _pair(rng, (B, jcfg.d_model))
        yj, sj = jrwkv.rwkv_time_mix_decode(pj, xj, jcfg.rwkv, sj)
        yt, _ = trwkv.rwkv_time_mix_decode(pt, xt, tcfg.rwkv, st)
        _close(yt, yj)
    _leaves_close(held, sj)


def test_decay_clamp_in_prefill_not_in_decode():
    """w0 in [-1, 2], so a large share of the decay logits exceed 0: repro's
    prefill clamps them and its decode does not, so its two paths disagree
    by far more than the tolerance.  Each port path matches its own repro
    counterpart there."""
    jcfg, tcfg = _configs()
    pj, pt = _time_mix_params(jcfg, seed=7, w0_range=(-1.0, 2.0))
    B, S = 2, 32
    xj, xt = _pair(np.random.default_rng(8), (B, S, jcfg.d_model))
    assert _logits_above_zero(pj, xj) > 0.3

    prefill_j, _ = jrwkv.rwkv_time_mix(pj, xj, jcfg.rwkv)
    _close(trwkv.rwkv_time_mix(pt, xt, tcfg.rwkv), prefill_j)

    sj = jrwkv.init_rwkv_state(B, jcfg.d_model, jcfg.rwkv)["tm"]
    st = states_from_numpy(_np(sj), "cpu")
    decode_j = []
    for t in range(S):
        yj, sj = jrwkv.rwkv_time_mix_decode(pj, xj[:, t], jcfg.rwkv, sj)
        yt, _ = trwkv.rwkv_time_mix_decode(pt, xt[:, t], tcfg.rwkv, st)
        _close(yt, yj)
        decode_j.append(yj)
    gap = float(jnp.abs(jnp.stack(decode_j, axis=1) - prefill_j).max())
    assert gap > 100 * TOL, f"repro's prefill and decode agree ({gap}): the clamp never bound"


def test_channel_mix_matches_repro_in_place():
    """Sequence form against repro's, and eight decode steps whose "cm" shift
    is written in place and equals repro's returned state."""
    jcfg, tcfg = _configs()
    pj = _np(jrwkv.init_rwkv_channel_mix(jax.random.PRNGKey(9), jcfg.d_model, jcfg.d_ff))
    pt = params_from_numpy(pj, "cpu")
    rng = np.random.default_rng(9)
    xj, xt = _pair(rng, (2, 32, jcfg.d_model))
    want, _ = jrwkv.rwkv_channel_mix(pj, xj)
    _close(trwkv.rwkv_channel_mix(pt, xt), want)

    sj = jrwkv.init_rwkv_state(2, jcfg.d_model, jcfg.rwkv)["cm"]
    st = states_from_numpy(_np(sj), "cpu")
    shift = st["shift"]
    for _ in range(8):
        xj, xt = _pair(rng, (2, jcfg.d_model))
        yj, sj = jrwkv.rwkv_channel_mix_decode(pj, xj, sj)
        yt, _ = trwkv.rwkv_channel_mix_decode(pt, xt, st)
        _close(yt, yj)
    assert st["shift"] is shift
    _close(shift, sj["shift"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norms", ["default", "eps_1e-1_zero_centered"])
def test_layer_matches_repro(norms):
    """apply_layer on (2, 32) tokens and 8 decode_layer steps of the rwkv +
    rwkv_cm layer, with non-zero LoRA factors.  With norm_eps 0.1 and
    zero-centred norms, norm1 and norm2 change and ln_x must not: it keeps
    rmsnorm's eps 1e-6 and its plain scale.  The decode states passed in,
    "mixer" and "cm", hold repro's returned states."""
    changes = {} if norms == "default" else {"norm_eps": 0.1, "zero_centered_norm": True}
    jcfg, tcfg = _configs(**changes)
    spec_j, spec_t = jcfg.pattern[0], tcfg.pattern[0]
    assert (spec_t.kind, spec_t.mlp) == ("rwkv", "rwkv_cm")
    pj = _np(jblocks.init_layer(jax.random.PRNGKey(10), jcfg, spec_j))
    pj["rwkv_tm"] = _time_mix_params(jcfg, seed=10)[0]
    pj["norm1"]["scale"] = np.full_like(pj["norm1"]["scale"], 0.2)   # zero-centred: 1.2
    pt = params_from_numpy(pj, "cpu")
    assert jax.tree.structure(params_to_numpy(tblocks.init_layer(
        torch.Generator().manual_seed(0), tcfg, spec_t, "cpu"))) == jax.tree.structure(pj)
    rng = np.random.default_rng(10)
    B, S = 2, 32
    xj, xt = _pair(rng, (B, S, jcfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj, _ = jblocks.apply_layer(pj, xj, jnp.asarray(pos), jcfg, spec_j)
    _close(tblocks.apply_layer(pt, xt, torch.from_numpy(pos.copy()), tcfg, spec_t)[0], yj)

    sj = jblocks.init_layer_state(B, 8, jcfg, spec_j, jnp.float32)
    st = tblocks.init_layer_state(B, 8, tcfg, spec_t, torch.float32, "cpu")
    assert jax.tree.structure(params_to_numpy(st)) == jax.tree.structure(_np(sj))
    assert sorted(st) == ["cm", "mixer"]
    held = {k: dict(v) for k, v in st.items()}
    for t in range(8):
        xj, xt = _pair(rng, (B, jcfg.d_model))
        yj, sj = jblocks.decode_layer(pj, xj, jnp.int32(t), sj, jcfg, spec_j)
        yt, _ = tblocks.decode_layer(pt, xt, t, st, tcfg, spec_t)
        _close(yt, yj)
    _leaves_close(held, sj)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_serve_and_prefill_match_repro():
    """build_prefill_step (32 tokens: two of repro's WKV chunks) and 8
    build_serve_step steps, logits and the final states (the tree that
    prepare_serve_states made, written in place), against repro's one-card
    serving steps on the same weights."""
    jcfg, tcfg = _configs()
    B, S, L = 2, 32, 8
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
        lt, _ = tss.step_fn(tparams, torch.from_numpy(tokens[:, pos]).long(), pos, tstates)
        _close(lt, lj)
    _leaves_close(tstates, jax.device_get(jstates))

    jps = jserve.build_prefill_step(jcfg, mesh, batch_global=B, seq_len=S)
    tps = tserve.build_prefill_step(tcfg, batch_global=B, seq_len=S)
    want = jps.step_fn(jparams, {"tokens": jnp.asarray(tokens)})
    got = tps.step_fn(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (B, tcfg.vocab_size)
    _close(got, want)


def test_decode_matches_forward():
    """Inside the port, at init weights (no logit above 0, so the prefill
    clamp does not bind): decoding token by token reproduces the
    full-sequence forward's logits at every position."""
    cfg = get_smoke_config(ARCH)
    B, S = 2, 32
    params = init_model(torch.Generator().manual_seed(1), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        h, _, _ = model_forward(params, tokens, cfg)
        full = head_logits(params, h, cfg)
        states = init_decode_states(B, S, cfg, "cpu")
        for t in range(S):
            logits, _ = decode_step(params, tokens[:, t], t, states, cfg)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), atol=TOL, rtol=0,
                                       err_msg=f"position {t}")


def test_launcher_serves_rwkv_on_cpu():
    from repro_torch.launch.serve import main
    res = main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "3", "--gen", "4"])
    assert res["tokens"].shape == (7, 2) and res["device"] == "cpu"
    assert 0 <= res["tokens"].min() and res["tokens"].max() < get_smoke_config(ARCH).vocab_size
