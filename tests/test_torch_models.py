"""Module parity: the port's model functions against ``repro``'s on the same
weights and inputs, on the CPU (the port runs its plain kernel versions).

Weights come from ``repro``'s initialisers and reach torch through
``repro_torch.interop``; inputs are numpy from a seed.  Tolerance 2e-5 abs
on fp32 activations of order 1 (attention outputs 1e-4): the two sides sum
in different orders (XLA's blocked online softmax vs. the port's full
softmax, different matmul kernels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jatt
from repro.models import blocks as jblocks
from repro.models import mlp as jmlp
from repro.models import norms as jnorms
from repro.models import rotary as jrot
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy, states_from_numpy
from repro_torch.models import attention as tatt
from repro_torch.models import blocks as tblocks
from repro_torch.models import mlp as tmlp
from repro_torch.models import norms as tnorms
from repro_torch.models import rotary as trot
from repro_torch.models.config import AttentionConfig, MLAConfig


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _port_attn_cfg(a) -> AttentionConfig:
    mla = None if a.mla is None else MLAConfig(**dataclasses.asdict(a.mla))
    return AttentionConfig(n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
                           head_dim=a.head_dim, rope_theta=a.rope_theta,
                           window=a.window, softcap=a.softcap, mla=mla)


CONFIG_CASES = [pytest.param("phi3-mini-3.8b", "smoke", id="smoke"),
                pytest.param("phi3-mini-3.8b", "full", id="full")] + [
    pytest.param(arch, size, id=f"{arch}-{size}")
    for arch in ("gemma-2b", "gemma2-2b", "deepseek-7b", "phi3.5-moe-42b-a6.6b",
                 "jamba-1.5-large-398b", "deepseek-v3-671b") for size in ("smoke", "full")]


@pytest.mark.parametrize("arch,arch_fn", CONFIG_CASES)
def test_config_matches_repro(arch, arch_fn):
    """The port's config of each dense, MoE and MLA arch equals repro's,
    field for field (the family configs as dicts), at smoke and full size;
    so do param_count() and each layer's active parameter count."""
    from repro.configs import get_config as jax_get_config
    j = (jax_smoke_config if arch_fn == "smoke" else jax_get_config)(arch)
    t = (get_smoke_config if arch_fn == "smoke" else get_config)(arch)
    for f in dataclasses.fields(t):
        if f.name == "attn":
            assert _port_attn_cfg(j.attn) == t.attn
        elif f.name == "pattern":
            assert [dataclasses.asdict(s) for s in j.pattern] == \
                   [dataclasses.asdict(s) for s in t.pattern]
        elif dataclasses.is_dataclass(getattr(t, f.name)):
            assert dataclasses.asdict(getattr(j, f.name)) == \
                   dataclasses.asdict(getattr(t, f.name)), f.name
        else:
            assert getattr(j, f.name) == getattr(t, f.name), f.name
    assert t.param_count() == j.param_count()
    for js, ts in zip(j.pattern, t.pattern):
        assert t.layer_active_param_count(ts) == j.layer_active_param_count(js)


def test_unported_arch_is_refused():
    for arch in ("musicgen-large", "internvl2-2b"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm(zero_centered):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 64))
    sj, st = _pair(rng, (64,), 0.3)
    want = jnorms.rmsnorm({"scale": sj}, xj, 1e-6, zero_centered)
    _close(tnorms.rmsnorm({"scale": st}, xt, 1e-6, zero_centered), want, 1e-6)


@pytest.mark.parametrize("head_dim", [64, 96])
def test_rope(head_dim):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    cj, sj = jrot.rope_cos_sin(jnp.asarray(pos), head_dim, 10000.0)
    ct, st = trot.rope_cos_sin(torch.from_numpy(pos), head_dim, 10000.0)
    # angles reach 4096 rad: cos/sin of an fp32 angle of that size differ by
    # a few ulp of the angle (~2e-4) between XLA's and torch's pow/cos
    _close(ct, cj, 1e-3)
    _close(st, sj, 1e-3)
    xj, xt = _pair(rng, (2, 7, 4, head_dim))
    _close(trot.apply_rope(xt, ct, st), jrot.apply_rope(xj, cj, sj), 1e-3)
    # at small positions the tables agree to fp32 rounding
    small = jnp.arange(64, dtype=jnp.int32)
    _close(trot.rope_cos_sin(torch.arange(64, dtype=torch.int32), head_dim)[0],
           jrot.rope_cos_sin(small, head_dim)[0], 2e-5)
    _close(trot.rope_cos_sin(63, head_dim)[1],
           jrot.rope_cos_sin(jnp.int32(63), head_dim)[1], 2e-5)


ATTN_VARIANTS = {
    "mha": dict(n_heads=4, n_kv_heads=4, head_dim=64),
    "gqa_d96": dict(n_heads=4, n_kv_heads=2, head_dim=96),
    "window": dict(n_heads=4, n_kv_heads=2, head_dim=64, window=16),
    "softcap": dict(n_heads=4, n_kv_heads=1, head_dim=64, softcap=5.0),
}


def _attn_setup(name, seed=0, d_model=128):
    jcfg = jatt.AttentionConfig(q_chunk=16, kv_chunk=16, **ATTN_VARIANTS[name])
    params = _np(jatt.init_attention(jax.random.PRNGKey(seed), d_model, jcfg))
    return jcfg, _port_attn_cfg(jcfg), params, params_from_numpy(params, "cpu")


@pytest.mark.parametrize("name", list(ATTN_VARIANTS))
def test_attention_forward(name):
    jcfg, tcfg, pj, pt = _attn_setup(name)
    rng = np.random.default_rng(2)
    B, S = 2, 40
    xj, xt = _pair(rng, (B, S, 128))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jatt.attention_forward(pj, xj, jnp.asarray(pos), jcfg)
    got = tatt.attention_forward(pt, xt, torch.from_numpy(pos.copy()), tcfg)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name,cache_len,per_row", [
    ("gqa_d96", 24, False),
    ("window", 8, False),        # ring buffer: cache holds exactly the window
    ("window", 24, False),       # window mask on a full cache
    ("softcap", 24, False),
    ("gqa_d96", 24, True),       # per-row positions
])
def test_attention_decode(name, cache_len, per_row):
    jcfg, tcfg, pj, pt = _attn_setup(name)
    rng = np.random.default_rng(3)
    B, steps = 3, 20
    cj = jatt.init_attention_cache(B, cache_len, jcfg, jnp.float32)
    ct = tatt.init_attention_cache(B, cache_len, tcfg, torch.float32, "cpu")
    offs = np.array([0, 2, 3], np.int32)
    for t in range(steps):
        xj, xt = _pair(rng, (B, 128))
        if per_row:
            pj_pos = jnp.asarray(offs + t)
            pt_pos = torch.from_numpy(offs + t)
        else:
            pj_pos, pt_pos = jnp.int32(t), t
        oj, cj = jatt.attention_decode(pj, xj, pj_pos, cj, jcfg)
        ot, ct = tatt.attention_decode(pt, xt, pt_pos, ct, tcfg)
        _close(ot, oj, 1e-4)
    _close(ct["k"], cj["k"], 1e-5)
    _close(ct["v"], cj["v"], 1e-5)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu_tanh", True),
                                       ("gelu", True), ("relu", False)])
def test_mlp(act, gated):
    pj = _np(jmlp.init_mlp(jax.random.PRNGKey(4), 64, 256, act=act, gated=gated))
    pt = params_from_numpy(pj, "cpu")
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng, (2, 5, 64))
    _close(tmlp.mlp(pt, xt, act), jmlp.mlp(pj, xj, act), 2e-5)


@pytest.mark.parametrize("post_norms", [False, True])
def test_decode_layer(post_norms):
    jcfg = jax_smoke_config("phi3-mini-3.8b").replace(post_norms=post_norms)
    tcfg = get_smoke_config("phi3-mini-3.8b").replace(post_norms=post_norms)
    spec_j, spec_t = jcfg.pattern[0], tcfg.pattern[0]
    pj = _np(jblocks.init_layer(jax.random.PRNGKey(5), jcfg, spec_j))
    pt = params_from_numpy(pj, "cpu")
    B, L = 2, 12
    sj = jblocks.init_layer_state(B, L, jcfg, spec_j, jnp.float32)
    st = states_from_numpy(_np(sj), "cpu")
    rng = np.random.default_rng(5)
    for t in range(6):
        xj, xt = _pair(rng, (B, jcfg.d_model))
        yj, sj = jblocks.decode_layer(pj, xj, jnp.int32(t), sj, jcfg, spec_j)
        yt, st = tblocks.decode_layer(pt, xt, t, st, tcfg, spec_t)
        _close(yt, yj, 1e-4)
    assert jax.tree.structure(params_to_numpy(st)) == jax.tree.structure(_np(sj))
    _close(st["mixer"]["k"], sj["mixer"]["k"], 1e-5)
