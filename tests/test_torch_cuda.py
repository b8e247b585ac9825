"""Card-only checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``; each test skips with a reason when no CUDA card is present
(decided inside the fixture, never at import or collection time).  Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 abs+rel.  Kernel and plain version sum over head_dim,
keys and d_model/d_ff in different orders on the card (the plain version
through full-fp32 cuBLAS products, TF32 off), so they agree to fp32
rounding of those sums, not bitwise.  bf16 outputs are rounded to bf16
(relative step 2^-8): 2e-2 for attention, 3e-2 for SwiGLU, as in
``tests/test_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import build_all

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()
    return torch.device("cuda")


def _rand(rng, shape, dev, dtype=torch.float32, scale=0.5):
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return t.to(device=dev, dtype=dtype)


def _tol(dtype, fp32=1e-4, bf16=2e-2):
    return bf16 if dtype == torch.bfloat16 else fp32


DECODE_CASES = [
    # (B, H, Hkv, S, D, window, softcap, per_row, dtype)
    (8, 32, 32, 256, 96, None, None, True, torch.float32),     # slice shape
    (4, 8, 2, 300, 64, None, None, True, torch.float32),       # GQA, ragged S
    (2, 4, 1, 512, 128, 100, None, False, torch.float32),      # MQA + window
    (2, 4, 4, 128, 96, None, 30.0, True, torch.float32),       # softcap
    (2, 4, 2, 384, 64, None, None, True, torch.bfloat16),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, case):
    B, H, Hkv, S, D, win, cap, per_row, dtype = case
    rng = np.random.default_rng(1)
    q = _rand(rng, (B, H, D), dev, dtype)
    k = _rand(rng, (B, S, Hkv, D), dev, dtype)
    v = _rand(rng, (B, S, Hkv, D), dev, dtype)
    if per_row:
        clen = torch.from_numpy(rng.integers(1, S + 1, B).astype(np.int32)).to(dev)
    else:
        clen = S // 3
    before = ops.LAUNCHES["flash_decode"]
    out = ops.flash_decode_op(q, k, v, clen, window=win, softcap=cap)
    assert ops.LAUNCHES["flash_decode"] == before + 1
    ref = ops.plain_flash_decode(q, k, v, clen, window=win, softcap=cap)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


ATTN_CASES = [
    # (B, S, H, Hkv, D, window, softcap, causal, dtype)
    (2, 512, 8, 8, 96, None, None, True, torch.float32),       # slice head_dim
    (2, 192, 8, 2, 64, None, None, True, torch.float32),       # GQA, ragged S
    (1, 256, 4, 1, 128, 64, None, True, torch.float32),        # MQA + window
    (2, 130, 2, 2, 64, None, 50.0, True, torch.float32),       # softcap, ragged
    (1, 100, 2, 2, 32, None, None, False, torch.float32),      # non-causal
    (2, 160, 2, 2, 64, None, None, True, torch.bfloat16),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_kernel_matches_plain(dev, case):
    B, S, H, Hkv, D, win, cap, causal, dtype = case
    rng = np.random.default_rng(2)
    q = _rand(rng, (B, S, H, D), dev, dtype)
    k = _rand(rng, (B, S, Hkv, D), dev, dtype)
    v = _rand(rng, (B, S, Hkv, D), dev, dtype)
    kw = dict(window=win, softcap=cap, causal=causal)
    out = ops.flash_attention_op(q, k, v, **kw)
    ref = ops.plain_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


SWIGLU_CASES = [
    # (T, D, F, act, dtype)
    (8, 3072, 8192, "silu", torch.float32),       # slice decode shape
    (5, 96, 200, "silu", torch.float32),          # ragged everything
    (300, 256, 512, "gelu_tanh", torch.float32),  # large-T tiles, ragged T
    (64, 128, 256, "silu", torch.bfloat16),
]


@pytest.mark.parametrize("case", SWIGLU_CASES)
def test_swiglu_kernel_matches_plain(dev, case):
    T, D, F, act, dtype = case
    rng = np.random.default_rng(3)
    x = _rand(rng, (T, D), dev, dtype, scale=1.0)
    wg = _rand(rng, (D, F), dev, dtype, scale=D ** -0.5)
    wu = _rand(rng, (D, F), dev, dtype, scale=D ** -0.5)
    wd = _rand(rng, (F, D), dev, dtype, scale=F ** -0.5)
    out = ops.fused_swiglu_op(x, wg, wu, wd, act)
    ref = ops.plain_fused_swiglu(x, wg, wu, wd, act)
    torch.cuda.synchronize()
    tol = _tol(dtype, bf16=3e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)

