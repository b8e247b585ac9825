"""The port's plain kernel versions against ``repro``'s Pallas kernels.

``repro``'s kernels run in interpret mode on the CPU (as in
``tests/test_kernels.py``); the port's ``kernels/ref.py`` versions and the
``kernels/ops.py`` layout wrappers run on CPU tensors.  Inputs are made with
numpy from a seed and handed to both.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 fp32 / 2e-2 bf16 for attention and decode,
1e-4 fp32 / 3e-2 bf16 for SwiGLU.  The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.fused_swiglu import fused_swiglu as pallas_swiglu
from repro_torch.kernels import ops, ref


def _pair(rng, shape, dtype="float32", scale=0.5):
    """The same values as a jax array and a torch tensor (bf16 rounded from
    the same f32 numbers by both, round-to-nearest-even)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _tol(dtype, fp32=2e-5, bf16=2e-2):
    return bf16 if dtype == "bfloat16" else fp32


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (BH, BHkv, S, D, window, softcap, bq, bk, dtype)
    (4, 4, 256, 64, None, None, 128, 128, "float32"),
    (8, 2, 192, 64, None, None, 64, 64, "float32"),     # GQA, ragged S
    (4, 1, 256, 128, 64, None, 128, 64, "float32"),     # MQA + window
    (2, 2, 128, 64, None, 50.0, 64, 128, "float32"),    # softcap
    (2, 2, 160, 64, None, None, 64, 64, "bfloat16"),    # bf16, ragged
    (2, 2, 64, 32, 32, 30.0, 32, 32, "float32"),        # window + cap
    (4, 2, 160, 96, None, None, 64, 64, "float32"),     # phi3 head_dim 96
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_naive_attention_matches_pallas(case):
    BH, BHkv, S, D, win, cap, bq, bk, dtype = case
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (BH, S, D), dtype)
    kj, kt = _pair(rng, (BHkv, S, D), dtype)
    vj, vt = _pair(rng, (BHkv, S, D), dtype)
    want = pallas_attention(qj, kj, vj, window=win, softcap=cap, block_q=bq,
                            block_k=bk, interpret=True)
    got = ref.naive_attention(qt, kt, vt, window=win, softcap=cap)
    assert got.dtype == qt.dtype
    _close(got, want, _tol(dtype))


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------

DECODE_CASES = [
    (4, 4, 512, 64, None, 128, "float32"),
    (8, 2, 1024, 64, None, 256, "float32"),
    (4, 1, 512, 128, 128, 128, "float32"),   # windowed
    (2, 2, 384, 64, None, 128, "bfloat16"),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("fill", [0.3, 1.0])
def test_naive_decode_matches_pallas(case, fill):
    """Per-kv-row cache lengths: row r holds ``fill * S * (r + 1) / BHkv``."""
    BH, BHkv, S, D, win, bk, dtype = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (BH, D), dtype)
    kj, kt = _pair(rng, (BHkv, S, D), dtype)
    vj, vt = _pair(rng, (BHkv, S, D), dtype)
    lens = np.array([max(1, int(S * fill * (r + 1) / BHkv)) for r in range(BHkv)],
                    np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens), window=win, block_k=bk,
                         interpret=True)
    got = ref.naive_decode(qt, kt, vt, torch.from_numpy(lens), window=win)
    _close(got, want, _tol(dtype))
    # a shared (scalar) length gives the same as broadcasting it
    got1 = ref.naive_decode(qt, kt, vt, int(lens[-1]), window=win)
    want1 = pallas_decode(qj, kj, vj, jnp.int32(lens[-1]), window=win,
                          block_k=bk, interpret=True)
    _close(got1, want1, _tol(dtype))


def test_naive_decode_softcap_matches_model_decode():
    """The Pallas kernel has no softcap; the model function the port's
    kernel stands in for (``repro.models.attention.decode_attention``) does."""
    from repro.models.attention import decode_attention
    rng = np.random.default_rng(2)
    B, H, Hkv, S, D = 2, 4, 2, 64, 32
    qj, qt = _pair(rng, (B, H, D))
    kj, kt = _pair(rng, (B, S, Hkv, D), scale=3.0)
    vj, vt = _pair(rng, (B, S, Hkv, D))
    lens = np.array([17, 64], np.int32)
    want = decode_attention(qj, kj, vj, jnp.asarray(lens), scale=D ** -0.5,
                            window=12, softcap=5.0)
    got = ops.plain_flash_decode(qt, kt, vt, torch.from_numpy(lens),
                                 scale=D ** -0.5, window=12, softcap=5.0)
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# fused swiglu
# ---------------------------------------------------------------------------

SWIGLU_CASES = [
    (128, 64, 256, 128, 128, "silu", "float32"),
    (256, 128, 512, 128, 256, "silu", "float32"),
    (128, 64, 256, 64, 128, "gelu_tanh", "float32"),
    (128, 64, 512, 128, 256, "silu", "bfloat16"),
]


@pytest.mark.parametrize("case", SWIGLU_CASES)
def test_naive_swiglu_matches_pallas(case):
    T, D, F, bm, bf, act, dtype = case
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (T, D), dtype)
    gj, gt = _pair(rng, (D, F), dtype, scale=0.1)
    uj, ut = _pair(rng, (D, F), dtype, scale=0.1)
    dj, dt = _pair(rng, (F, D), dtype, scale=0.1)
    want = pallas_swiglu(xj, gj, uj, dj, block_m=bm, block_f=bf, act=act,
                         interpret=True)
    got = ref.naive_swiglu(xt, gt, ut, dt, act)
    _close(got, want, _tol(dtype, 1e-4, 3e-2))


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_naive_swiglu_ragged_t(act):
    """The port's kernel takes any T (decode batches); the Pallas kernel
    asserts T % block_m == 0, so a ragged T is held against repro's oracle."""
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng, (7, 64))
    gj, gt = _pair(rng, (64, 200), scale=0.1)
    uj, ut = _pair(rng, (64, 200), scale=0.1)
    dj, dt = _pair(rng, (200, 64), scale=0.1)
    _close(ref.naive_swiglu(xt, gt, ut, dt, act),
           jref.naive_swiglu(xj, gj, uj, dj, act), 1e-4)


# ---------------------------------------------------------------------------
# layout wrappers (ops) against repro.kernels.ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_flash_attention_op_matches_repro_ops(heads):
    H, Hkv = heads
    rng = np.random.default_rng(5)
    B, S, D = 2, 96, 64
    qj, qt = _pair(rng, (B, S, H, D))
    kj, kt = _pair(rng, (B, S, Hkv, D))
    vj, vt = _pair(rng, (B, S, Hkv, D))
    want = jops.flash_attention_op(qj, kj, vj, block_q=32, block_k=32)
    _close(ops.flash_attention_op(qt, kt, vt), want, 2e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_flash_decode_op_matches_repro_ops(per_slot):
    rng = np.random.default_rng(6)
    B, H, Hkv, S, D = 3, 4, 2, 128, 64
    qj, qt = _pair(rng, (B, H, D))
    kj, kt = _pair(rng, (B, S, Hkv, D))
    vj, vt = _pair(rng, (B, S, Hkv, D))
    if per_slot:
        lens = np.array([5, 128, 77], np.int32)
        lj, lt = jnp.asarray(lens), torch.from_numpy(lens)
    else:
        lj, lt = jnp.int32(40), 40
    want = jops.flash_decode_op(qj, kj, vj, lj, block_k=64)
    _close(ops.flash_decode_op(qt, kt, vt, lt), want, 2e-5)


def test_fused_swiglu_op_matches_repro_ops():
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (2, 64, 64))
    gj, gt = _pair(rng, (64, 256), scale=0.1)
    uj, ut = _pair(rng, (64, 256), scale=0.1)
    dj, dt = _pair(rng, (256, 64), scale=0.1)
    want = jops.fused_swiglu_op(xj, gj, uj, dj, block_m=64, block_f=128)
    _close(ops.fused_swiglu_op(xt, gt, ut, dt), want, 1e-4)


def test_cpu_path_counts_no_launch_and_kernels_refuse_cpu():
    """CPU tensors take the plain version and launch nothing; the kernel
    wrappers themselves never run on CPU tensors."""
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_swiglu import fused_swiglu

    ops.reset_launches()
    q, k = torch.zeros(1, 2, 64), torch.zeros(1, 8, 2, 64)
    ops.flash_decode_op(q, k, k, 4)
    ops.flash_attention_op(k, k, k)
    ops.fused_swiglu_op(torch.zeros(3, 8), torch.zeros(8, 16), torch.zeros(8, 16),
                        torch.zeros(16, 8))
    assert {"flash_decode", "flash_attention", "fused_swiglu"} <= set(ops.LAUNCHES)
    assert all(n == 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_decode(q, k, k, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        flash_attention(k, k, k)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fused_swiglu(torch.zeros(3, 8), torch.zeros(8, 16), torch.zeros(8, 16),
                     torch.zeros(16, 8))
