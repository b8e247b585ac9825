"""The serving slice as a whole: the port against ``repro.runtime.serve``.

Reference: ``build_serve_step`` / ``build_prefill_step`` on a 1×1
("data", "model") mesh with ``prepare_params`` weights.  Port: the same
weights through ``interop``, on the CPU (plain kernel versions).  Logits are
compared at every teacher-forced decode step and at prefill, with 1e-4 abs
(fp32 logits of order 1; the sums run in other orders on the two sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_smoke_config as jax_smoke_config
from repro.runtime import serve as jserve
from repro.runtime.train import prepare_params
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.runtime import serve as tserve

TOL = 1e-4


# Variants of smoke phi3-mini, applied to both sides.  "dense_opts" turns on
# every dense-family option the port's model code carries (sliding window
# with a ring-buffer cache shorter than the run, attention and logit
# softcaps, tied and scaled embeddings, zero-centred sandwich norms, GeGLU).
VARIANTS = {
    "mha": ({}, {}),
    "gqa_d96": ({}, dict(n_kv_heads=2, head_dim=96)),
    "dense_opts": (dict(tie_embeddings=True, logit_softcap=30.0, embed_scale=True,
                        zero_centered_norm=True, post_norms=True, act="gelu_tanh"),
                   dict(n_kv_heads=2, window=8, softcap=50.0)),
}


def _configs(variant):
    model_kw, attn_kw = VARIANTS[variant]
    jcfg = jax_smoke_config("phi3-mini-3.8b")
    tcfg = get_smoke_config("phi3-mini-3.8b")
    jcfg = jcfg.replace(attn=dataclasses.replace(jcfg.attn, **attn_kw), **model_kw)
    tcfg = tcfg.replace(attn=dataclasses.replace(tcfg.attn, **attn_kw), **model_kw)
    return jcfg, tcfg


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_and_prefill_match_repro(variant):
    jcfg, tcfg = _configs(variant)
    B, L = 2, 12
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jss = jserve.build_serve_step(jcfg, mesh, batch_global=B, cache_len=L)
    jparams = jax.device_get(prepare_params(jax.random.PRNGKey(0), jcfg, jss.spec.plan))
    jstates = jserve.prepare_serve_states(jcfg, jss.spec.plan, B, L)

    tss = tserve.build_serve_step(tcfg, batch_global=B, cache_len=L)
    tparams = params_from_numpy(jparams, "cpu")
    tstates = tserve.prepare_serve_states(tcfg, tss.spec.plan, B, L, device="cpu")
    assert jax.tree.structure(params_to_numpy(tstates)) == jax.tree.structure(
        jax.device_get(jstates))

    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    for pos in range(L):
        lj, jstates = jss.step_fn(jparams, jnp.asarray(tokens[:, pos]), jnp.int32(pos),
                                  jstates)
        lt, tstates = tss.step_fn(tparams, torch.from_numpy(tokens[:, pos]).long(), pos,
                                  tstates)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=0,
                                   err_msg=f"decode step {pos}")
    np.testing.assert_allclose(tstates[0]["mixer"]["k"].numpy(),
                               np.asarray(jstates[0]["mixer"]["k"]), atol=1e-5)

    jps = jserve.build_prefill_step(jcfg, mesh, batch_global=B, seq_len=L)
    tps = tserve.build_prefill_step(tcfg, batch_global=B, seq_len=L)
    want = jps.step_fn(jparams, {"tokens": jnp.asarray(tokens)})
    got = tps.step_fn(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (B, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    # prefill's last position is the last teacher-forced decode step
    np.testing.assert_allclose(got.numpy(), lt.numpy(), atol=TOL, rtol=0)


def test_params_round_trip_bit_exact():
    jcfg, _ = _configs("mha")
    from repro.models.model import init_model
    tree = jax.device_get(init_model(jax.random.PRNGKey(1), jcfg))
    tree["bf16"] = (np.asarray(jnp.linspace(-3, 3, 37, dtype=jnp.bfloat16)),
                    np.asarray(jnp.arange(5, dtype=jnp.int32)))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    t = params_from_numpy(tree, "cpu")
    assert t["bf16"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["bf16"][0].float().numpy(),
                                  np.asarray(tree["bf16"][0], np.float32))


def _default_device_call(entry):
    """Call one entry point without a device argument."""
    from repro_torch.configs.common import smoke_reduce
    from repro_torch.configs.jamba_1_5_large import config_without_experts
    from repro_torch.interop import states_from_numpy
    from repro_torch.models.model import init_decode_states, init_model
    from repro_torch.models.ssm import init_mamba, init_mamba_state
    from repro_torch.runtime.continuous import engine_from_decode_step
    cfg = get_smoke_config("phi3-mini-3.8b")
    jamba = smoke_reduce(config_without_experts())
    tree = {"w": (np.ones((2, 3), np.float32),)}
    gen = torch.Generator(device="cuda" if torch.cuda.is_available() else "cpu")
    return {
        "params_from_numpy": lambda: params_from_numpy(tree),
        "states_from_numpy": lambda: states_from_numpy(tree),
        "init_model": lambda: init_model(gen.manual_seed(0), cfg),
        "init_decode_states": lambda: init_decode_states(2, 4, cfg),
        "init_model_jamba": lambda: init_model(gen.manual_seed(0), jamba),
        "init_decode_states_jamba": lambda: init_decode_states(2, 4, jamba),
        "init_mamba": lambda: init_mamba(gen.manual_seed(0), jamba.d_model, jamba.mamba),
        "init_mamba_state": lambda: init_mamba_state(2, jamba.d_model, jamba.mamba),
        "prepare_serve_states": lambda: tserve.prepare_serve_states(
            cfg, tserve.build_serve_step(cfg, batch_global=2, cache_len=4).spec.plan, 2, 4),
        "prepare_serve_states_slot_stage2": lambda: tserve.prepare_serve_states(
            cfg, tserve.build_slot_serve_step(cfg, cache_len=4, shard_alloc=(1, 1),
                                              stage=2).spec.plan, 2, 4),
        "engine_from_decode_step": lambda: engine_from_decode_step(
            None, cfg, batch=2, cache_len=4).holder["states"],
    }[entry]()


@pytest.mark.parametrize("entry", ["params_from_numpy", "states_from_numpy", "init_model",
                                   "init_decode_states", "prepare_serve_states",
                                   "init_model_jamba", "init_decode_states_jamba",
                                   "init_mamba", "init_mamba_state",
                                   "prepare_serve_states_slot_stage2",
                                   "engine_from_decode_step"])
def test_entry_points_default_to_card(entry):
    """Without a device argument, tensors go to the card, never to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
            _default_device_call(entry)
        return
    leaves = jax.tree.leaves(_default_device_call(entry))
    assert leaves and all(t.is_cuda for t in leaves)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    res = main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "3",
                "--gen", "4"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("done")
    assert "device=cpu" in out
    assert res["tokens"].shape == (7, 2) and res["steps"] == 6
    assert (res["tokens"] >= 0).all() and (res["tokens"] < 512).all()


def test_launcher_without_card_refuses_cpu():
    """Without --device cpu the launcher runs on the card or not at all."""
    from repro_torch.launch.serve import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    with pytest.raises(SystemExit) as e:
        main(["--smoke", "--batch", "2", "--prompt-len", "2", "--gen", "2"])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        main(["--smoke", "--device", "cpu", "--seq-shard"])
    assert e.value.code != 0
