"""Card-only checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``; each test skips with a reason when no CUDA card is present
(decided inside the fixture, never at import or collection time).  Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 abs+rel.  Kernel and plain version sum over head_dim,
keys and d_model/d_ff in different orders on the card (the plain version
through full-fp32 cuBLAS products, TF32 off; SwiGLU at T > 16 and flash
attention at head_dims that are multiples of 8 through 3xTF32 tensor-core
products, fp32-accurate as ``tests/test_torch_swiglu_split.py`` and
``tests/test_torch_attention_tf32.py`` show), so they agree to fp32
rounding of those sums, not bitwise.  bf16 outputs are rounded to bf16
(relative step 2^-8): 2e-2 for attention, 3e-2 for SwiGLU, as in
``tests/test_kernels.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import build_all
from repro_torch.kernels.flash_attention import FWD_ROUTES, flash_attention_fwd_route

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
    (1, 64, 8, 4096, 128, None, None, True, torch.float32),    # 16 splits in a cluster
    (2, 16, 1, 2048, 96, 700, None, True, torch.float32),      # G = 16: two head tiles
    (1, 32, 4, 1000, 256, None, 50.0, False, torch.float32),   # head_dim 256, softcap
    (2, 12, 4, 777, 80, None, None, True, torch.bfloat16),     # G = 3, head_dim 80
    (3, 8, 2, 500, 50, 64, None, True, torch.float32),         # rows of 200 bytes: element copies
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


def test_decode_kernel_splits_past_valid_keys_and_strided_caches(dev):
    """A 16-split cluster over a cache holding 3 and 40 valid keys (whole
    splits empty), a row of length 0 (0 out, as the kernel documents), the
    same answer for 1 and 16 splits, and caches read by strides from a wider
    buffer (period-stacked, offset by one element: not 16-byte aligned)."""
    rng = np.random.default_rng(5)
    q = _rand(rng, (2, 64, 128), dev)
    k, v = (_rand(rng, (2, 4096, 8, 128), dev) for _ in range(2))
    for lens in ([3, 40], [0, 40]):
        clen = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = ops.flash_decode_op(q, k, v, clen)
        want = ops.plain_flash_decode(q, k, v, clen)
        rows = [b for b, n in enumerate(lens) if n > 0]
        torch.testing.assert_close(out[rows], want[rows], atol=1e-4, rtol=1e-4)
        if 0 in lens:
            assert torch.equal(out[lens.index(0)], torch.zeros_like(out[0]))
    # short cache: one split; the same keys in a long cache: 16 splits
    short = ops.flash_decode_op(q, k[:, :64].contiguous(), v[:, :64].contiguous(),
                                torch.tensor([30, 64], dtype=torch.int32, device=dev))
    long = ops.flash_decode_op(q, k, v, torch.tensor([30, 64], dtype=torch.int32, device=dev))
    torch.testing.assert_close(short, long, atol=1e-5, rtol=1e-5)
    wide = _rand(rng, (2, 2, 300, 4, 97), dev)            # (period, B, S, Hkv, D + 1)
    kk, vv = wide[0, ..., 1:], wide[1, ..., :96]
    qq = _rand(rng, (2, 8, 96), dev)
    clen = torch.tensor([300, 123], dtype=torch.int32, device=dev)
    out = ops.flash_decode_op(qq, kk, vv, clen, window=100)
    want = ops.plain_flash_decode(qq, kk, vv, clen, window=100)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


ATTN_CASES = [
    # (B, S, H, Hkv, D, window, softcap, causal, dtype)
    (2, 512, 8, 8, 96, None, None, True, torch.float32),       # slice head_dim
    (2, 192, 8, 2, 64, None, None, True, torch.float32),       # GQA, ragged S
    (1, 256, 4, 1, 128, 64, None, True, torch.float32),        # MQA + window
    (2, 130, 2, 2, 64, None, 50.0, True, torch.float32),       # softcap, ragged
    (1, 100, 2, 2, 32, None, None, False, torch.float32),      # non-causal
    (2, 160, 2, 2, 64, None, None, True, torch.bfloat16),
    (2, 256, 32, 32, 96, None, None, True, torch.float32),     # the training shape
    (1, 512, 16, 2, 128, None, None, True, torch.float32),     # Jamba's head_dim, GQA 8
    (3, 1, 8, 2, 32, None, None, True, torch.float32),         # S = 1
    (2, 63, 8, 2, 64, None, None, True, torch.float32),        # both sides of a
    (2, 65, 16, 4, 128, None, None, True, torch.float32),      # 64-row tile
    (1, 200, 4, 2, 160, None, None, True, torch.float32),      # clusters: rank 1 holds 32 columns
    (2, 200, 8, 2, 128, None, None, True, torch.bfloat16),     # bf16 on the tensor cores
    (2, 512, 8, 4, 256, None, 50.0, True, torch.float32),      # gemma2: head_dim 256, softcap
    (2, 512, 8, 1, 256, None, None, True, torch.float32),      # gemma-2b: head_dim 256, MQA
    (1, 100, 2, 2, 256, None, None, True, torch.float32),      # clusters: S not a multiple of 64
    (1, 300, 4, 2, 256, 100, 50.0, True, torch.float32),       # window + softcap, ragged
    (2, 130, 4, 2, 256, None, None, False, torch.float32),     # non-causal at 256, ragged
    (2, 200, 8, 2, 256, None, 30.0, True, torch.bfloat16),     # bf16 on the clusters
    (1, 150, 4, 2, 192, 50, None, True, torch.float32),        # head_dim 192, window
    (1, 150, 4, 2, 252, None, None, True, torch.float32),      # head_dim 252: the SIMT route
]


def _route_of(D):
    return "simt" if D % 8 else "tc" if D <= 128 else "tc_cluster"


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_kernel_matches_plain(dev, case):
    B, S, H, Hkv, D, win, cap, causal, dtype = case
    rng = np.random.default_rng(2)
    q = _rand(rng, (B, S, H, D), dev, dtype)
    k = _rand(rng, (B, S, Hkv, D), dev, dtype)
    v = _rand(rng, (B, S, Hkv, D), dev, dtype)
    kw = dict(window=win, softcap=cap, causal=causal)
    route = _route_of(D)
    assert flash_attention_fwd_route(q, k, v) == route
    routes = dict(FWD_ROUTES)
    out = ops.flash_attention_op(q, k, v, **kw)
    assert {n: FWD_ROUTES[n] - routes[n] for n in routes} == {n: int(n == route) for n in routes}
    ref = ops.plain_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_kernel_long_row_one_sign(dev):
    """A causal row of 16384 keys, q/k uniform in [0, 1), V in [1, 1.1):
    sums of one sign over 256 key tiles, where an output that the tensor
    core carried across tiles (it truncates its sums) would drift."""
    rng = np.random.default_rng(20)
    S, D = 16384, 128

    def u(shape, lo=0.0, width=1.0):
        return torch.from_numpy((lo + width * rng.random(shape)).astype(np.float32)).to(dev)

    q, k, v = u((1, S, 2, D)), u((1, S, 1, D)), u((1, S, 1, D), 1.0, 0.1)
    out = ops.flash_attention_op(q, k, v)
    ref = ops.plain_flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_flash_kernel_deterministic(dev, shape=(2, 512, 32, 32, 96)):
    """No atomics: two runs on the same inputs give the same bits."""
    B, S, H, Hkv, D = shape
    rng = np.random.default_rng(21)
    q, k, v = (_rand(rng, (B, S, n, D), dev) for n in (H, Hkv, Hkv))
    a, b = (ops.flash_attention_op(q, k, v) for _ in range(2))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_flash_kernel_deterministic_mqa_256(dev):
    """The same at gemma-2b's MQA prefill on the clusters (the partial
    scores exchanged and added in one order), and the output the same bits
    with and without the logsumexp."""
    test_flash_kernel_deterministic(dev, shape=(2, 512, 8, 1, 256))
    rng = np.random.default_rng(25)
    q, k, v = (_rand(rng, (2, 512, n, 256), dev) for n in (8, 1, 1))
    assert flash_attention_fwd_route(q, k, v) == "tc_cluster"
    out, lse = flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(-1, -1, 8, -1)) * 256 ** -0.5
    mask = torch.ones(512, 512, dtype=torch.bool, device=dev).tril()
    want = torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


def test_flash_kernel_long_one_sign_256(dev):
    """Causal rows of 8192 keys at head_dim 256 on the clusters, q/k uniform
    in [0, 1), V in [1, 1.1): each CTA's partial scores are one-sign sums
    over its 128 columns (q . k ~ 64 in all), where one truncating
    accumulator would drift; held to the plain version and to float64."""
    rng = np.random.default_rng(26)
    S, D = 8192, 256

    def u(shape, lo=0.0, width=1.0):
        return torch.from_numpy((lo + width * rng.random(shape)).astype(np.float32)).to(dev)

    q, k, v = u((1, S, 2, D)), u((1, S, 1, D)), u((1, S, 1, D), 1.0, 0.1)
    assert flash_attention_fwd_route(q, k, v) == "tc_cluster"
    out = ops.flash_attention_op(q, k, v)
    torch.testing.assert_close(out, ops.plain_flash_attention(q, k, v), atol=1e-4, rtol=1e-4)
    qd, kd, vd = (t.double().expand(-1, -1, 2, -1) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * D ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1)
    exact = torch.einsum("bhqk,bkhd->bqhd", p, vd)
    torch.testing.assert_close(out.double(), exact, atol=1e-4, rtol=0)


SWIGLU_CASES = [
    # (T, D, F, act, dtype)
    (8, 3072, 8192, "silu", torch.float32),       # slice decode shape
    (5, 96, 200, "silu", torch.float32),          # ragged everything
    (300, 256, 512, "gelu_tanh", torch.float32),  # large-T tiles, ragged T
    (64, 128, 256, "silu", torch.bfloat16),
    (16, 3072, 8192, "silu", torch.float32),      # the two sides of the T = 16
    (17, 3072, 8192, "silu", torch.float32),      # path switch
    (512, 3072, 8192, "silu", torch.float32),     # the training micro-batch
    (8, 8192, 24576, "silu", torch.float32),      # Jamba decode, 2.4 GB of weights
    (7, 130, 250, "gelu_tanh", torch.float32),    # rows off 16 bytes, decode path
    (33, 100, 202, "silu", torch.float32),        # rows off 16 bytes, tensor cores
    (3, 130, 1000, "gelu_tanh", torch.float32),   # decode, rows off 16 bytes, F split in 3
    (9, 136, 1024, "silu", torch.bfloat16),       # decode bf16, F split in 4
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


@pytest.mark.parametrize("T", [8, 512])
def test_swiglu_kernel_long_k_one_sign(dev, T):
    """x >= 0 and every weight > 0: the down product sums 24576 terms of one
    sign, where a sum that the tensor core truncates would drift.  Compared
    relative to max |plain|, on the decode path (T = 8) and the tensor-core
    path (T = 512)."""
    D, F = 1024, 24576
    rng = np.random.default_rng(18)
    x = _rand(rng, (T, D), dev, scale=1.0).abs()
    wg, wu = (_rand(rng, (D, F), dev, scale=D ** -0.5).abs() for _ in range(2))
    wd = _rand(rng, (F, D), dev, scale=F ** -0.5).abs()
    out = ops.fused_swiglu_op(x, wg, wu, wd)
    ref = ops.plain_fused_swiglu(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= _tol(torch.float32) * float(ref.abs().max())


@pytest.mark.parametrize("T", [8, 512])
def test_swiglu_kernel_deterministic(dev, T):
    """No atomics: two runs on the same inputs give the same bits, on the
    decode path (its down product split over F across a cluster) and the
    tensor-core path."""
    D, F = 3072, 8192
    rng = np.random.default_rng(19)
    x = _rand(rng, (T, D), dev, scale=1.0)
    w = [_rand(rng, s, dev, scale=s[0] ** -0.5) for s in ((D, F), (D, F), (F, D))]
    a, b = (ops.fused_swiglu_op(x, *w) for _ in range(2))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# Training slice: the compressed wire's kernels, the backward kernels, and
# gradients through the model on the card.
# ---------------------------------------------------------------------------

from repro_torch.kernels import quant_transfer as qt  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_ROUTES, flash_attention, flash_attention_bwd, flash_attention_bwd_route)
from repro_torch.kernels.fused_swiglu import swiglu_bwd  # noqa: E402


def wire_rows(rng, R, tile, fmt):
    """(R, tile) float32 rows with the cases that decide rounding: all-zero
    rows, exact halves of the int8 step, fp8 subnormals and their ties, and
    random data at several scales."""
    x = (rng.standard_normal((R, tile)) * rng.choice([1e-3, 1.0, 50.0], (R, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0
    top = 128.0 if fmt == "int8" else 256.0          # amax -> scale 1.0
    halves = np.arange(tile, dtype=np.float32) % 64 - 32 + 0.5
    x[1] = halves
    x[1, 0] = top
    sub = np.float32(2.0 ** -9) * (np.arange(tile, dtype=np.float32) % 9) * 0.5
    x[2] = sub * np.where(np.arange(tile) % 2, 1, -1)
    x[2, 0] = top
    x[3] = -x[3]
    return x


def _bits_equal(a, b):
    if a.dtype == torch.float8_e4m3fn:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("fmt", qt.QUANT_FORMATS)
@pytest.mark.parametrize("R,tile", [(6144, 256), (19, 64), (40, 384), (8, 1024)])
def test_quant_kernels_bitwise(dev, fmt, R, tile):
    rng = np.random.default_rng(R + tile)
    x = torch.from_numpy(wire_rows(rng, R, tile, fmt))
    before = dict(ops.LAUNCHES)
    q, s = qt.quantize_tiles(x.to(dev), fmt=fmt)
    qr, sr = ref.naive_quantize_tiles(x, fmt=fmt)
    assert q.dtype == qr.dtype and _bits_equal(q, qr) and _bits_equal(s, sr)
    back = qt.dequantize_tiles(q, s)
    assert _bits_equal(back, ref.naive_dequantize_tiles(qr, sr))
    assert ops.LAUNCHES["quantize_tiles"] == before["quantize_tiles"] + 1
    assert ops.LAUNCHES["dequantize_tiles"] == before["dequantize_tiles"] + 1


@pytest.mark.parametrize("fmt", qt.QUANT_FORMATS)
def test_roundtrip_ef_card_equals_cpu(dev, fmt):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32))
    err = torch.from_numpy((rng.standard_normal(1 << 20) * 1e-3).astype(np.float32))
    xh, e2 = qt.roundtrip_ef(x.to(dev), err.to(dev), fmt=fmt)
    xr, er = qt.roundtrip_ef(x, err, fmt=fmt)
    assert _bits_equal(xh, xr) and _bits_equal(e2, er)


BWD_CASES = [
    # (B, S, H, Hkv, D, window, softcap, causal, dtype); head_dim <= 128 and
    # a multiple of 8 takes the tensor-core route, 128 < head_dim <= 256 and
    # a multiple of 8 the two-CTA clusters on the tensor cores, other
    # head_dims the SIMT one (64-row tiles to 128, 32-row tiles above)
    (2, 256, 32, 32, 96, None, None, True, torch.float32),     # the slice's training shape
    (2, 192, 8, 2, 64, None, None, True, torch.float32),       # GQA, ragged S
    (1, 256, 4, 1, 128, 64, None, True, torch.float32),        # MQA + window
    (2, 130, 2, 2, 64, None, None, False, torch.float32),      # non-causal, ragged
    (1, 100, 4, 2, 32, 40, None, False, torch.float32),        # non-causal window
    (2, 160, 4, 2, 64, None, None, True, torch.bfloat16),
    (2, 200, 8, 2, 32, None, None, True, torch.float32),       # head_dim 32, GQA 4
    (1, 300, 8, 2, 96, None, None, True, torch.float32),       # head_dim 96, GQA 4, ragged
    (1, 256, 16, 2, 128, None, None, True, torch.float32),     # Jamba's head_dim, GQA 8
    (1, 200, 4, 2, 40, None, None, True, torch.float32),       # head_dim 40: padded to 64
    (1, 190, 4, 4, 96, 70, None, False, torch.float32),        # non-causal window, head_dim 96
    (3, 1, 8, 2, 64, None, None, True, torch.float32),         # S = 1
    (2, 63, 8, 2, 96, None, None, True, torch.float32),        # both sides of a
    (2, 65, 4, 4, 128, None, None, True, torch.float32),       # 64-row tile
    (1, 150, 4, 2, 100, None, None, True, torch.float32),      # head_dim 100: the SIMT route
    (2, 128, 4, 1, 96, 50, None, True, torch.bfloat16),        # bf16 on the tensor cores, window
    (2, 512, 8, 1, 256, None, None, True, torch.float32),      # gemma-2b: head_dim 256, MQA
    (2, 300, 8, 4, 256, None, 50.0, True, torch.float32),      # gemma2's global layer, ragged
    (1, 200, 8, 4, 256, 64, 50.0, True, torch.float32),        # gemma2's local layer: window
    (2, 33, 4, 2, 256, None, None, True, torch.float32),       # both sides of a 32-row tile
    (2, 96, 4, 2, 256, 40, 30.0, False, torch.bfloat16),       # bf16 at 256, non-causal window
    (2, 130, 8, 2, 96, None, 50.0, True, torch.float32),       # softcap on the tensor cores
    (1, 190, 4, 4, 64, 70, 30.0, True, torch.float32),         # softcap + window there
    (1, 150, 4, 2, 100, None, 50.0, True, torch.float32),      # softcap on the 64-row SIMT
    (1, 100, 2, 2, 256, None, None, True, torch.float32),      # clusters: S not a multiple of 64
    (1, 128, 4, 1, 256, None, None, True, torch.float32),      # MQA, dK/dV split g = 4
    (1, 300, 4, 2, 256, 100, 50.0, True, torch.float32),       # window + softcap, ragged
    (2, 130, 8, 1, 256, None, 30.0, True, torch.bfloat16),     # bf16 on the clusters, g > 1
    (1, 150, 4, 2, 136, None, None, True, torch.float32),      # rank 1 holds 8 columns
    (1, 120, 4, 4, 192, 50, None, False, torch.float32),       # head_dim 192, non-causal window
    (1, 150, 4, 2, 252, None, None, True, torch.float32),      # head_dim 252: the SIMT route
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(dev, case):
    B, S, H, Hkv, D, win, cap, causal, dtype = case
    rng = np.random.default_rng(4)
    q = _rand(rng, (B, S, H, D), dev, dtype).requires_grad_(True)
    k = _rand(rng, (B, S, Hkv, D), dev, dtype).requires_grad_(True)
    v = _rand(rng, (B, S, Hkv, D), dev, dtype).requires_grad_(True)
    dout = _rand(rng, (B, S, H, D), dev, dtype, scale=1.0)
    kw = dict(causal=causal, window=win, softcap=cap)
    route = _route_of(D)
    assert flash_attention_bwd_route(q, k, v, dout) == route
    before, routes = ops.LAUNCHES["flash_attention_bwd"], dict(BWD_ROUTES)
    out = ops.flash_attention_op(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    assert {n: BWD_ROUTES[n] - routes[n] for n in routes} == {
        n: int(n == route) for n in routes}
    ref_grads = ops.plain_flash_attention_bwd(q, k, v, dout, **kw)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    for name, a, b in zip("qkv", grads, ref_grads):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m, n=name: f"d{n}: {m}")


def test_flash_bwd_kernel_unaligned_rows(dev, D=64):
    """q/k/v/dO as views whose rows are not 4-element aligned (a stride of D
    + 1): the tensor-core routes copy rows 4 elements at a time, so these
    take the SIMT kernels, and agree with the plain version all the same."""
    rng = np.random.default_rng(24)
    B, S, H, Hkv = 2, 150, 4, 2

    def view(heads, scale=0.5):
        return _rand(rng, (B, S, heads, D + 1), dev, scale=scale)[..., 1:]

    q, k, v = view(H), view(Hkv), view(Hkv)
    dout = view(H, scale=1.0)
    assert flash_attention_bwd_route(q, k, v, dout) == "simt"
    out, lse = flash_attention(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    want = ops.plain_flash_attention_bwd(q, k, v, dout)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=name: f"d{n}: {m}")


def test_flash_bwd_kernel_unaligned_rows_head_dim_256(dev):
    """The same at head_dim 256: unaligned rows leave the clusters for the
    SIMT kernels."""
    test_flash_bwd_kernel_unaligned_rows(dev, D=256)


def test_flash_bwd_kernel_deterministic(dev, shape=(2, 256, 32, 32, 96)):
    """No atomics: two backward runs on the same inputs give the same bits."""
    B, S, H, Hkv, D = shape
    rng = np.random.default_rng(22)
    q, k, v = (_rand(rng, (B, S, n, D), dev) for n in (H, Hkv, Hkv))
    dout = _rand(rng, (B, S, H, D), dev, scale=1.0)
    out, lse = flash_attention(q, k, v, return_lse=True)
    a, b = (flash_attention_bwd(q, k, v, out, lse, dout) for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_flash_bwd_kernel_deterministic_mqa_256(dev):
    """The same at gemma-2b's MQA prefill on the clusters, where the dK/dV
    pass's parts (g = 8 on 132 SMs) are summed in order."""
    test_flash_bwd_kernel_deterministic(dev, shape=(2, 512, 8, 1, 256))


def test_flash_bwd_kernel_long_one_sign(dev):
    """A causal case of 8192 rows, q/k uniform in [0, 1), dO and V in [1,
    1.1): dV's sums over the queries of each key (and dK's, dQ's over keys)
    have one sign and run over up to 128 tiles, where a sum that the tensor
    core carried across tiles (it truncates its sums) would drift; and dP
    and Dvec (~141 each) cancel in dS.  Held to the plain version and to the
    float64 gradient (autograd), whose dV the plain fp32 sums over 8192
    queries miss by more than 1e-4 absolute."""
    rng = np.random.default_rng(23)
    S, D = 8192, 128

    def u(shape, lo=0.0, width=1.0):
        return torch.from_numpy((lo + width * rng.random(shape)).astype(np.float32)).to(dev)

    q, k, v = u((1, S, 2, D)), u((1, S, 1, D)), u((1, S, 1, D), 1.0, 0.1)
    dout = u((1, S, 2, D), 1.0, 0.1)
    out, lse = flash_attention(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    want = ops.plain_flash_attention_bwd(q, k, v, dout)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=name: f"d{n}: {m}")
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd.repeat_interleave(2, 2)) * D ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vd.repeat_interleave(2, 2))
    exact = torch.autograd.grad(o, (qd, kd, vd), dout.double())
    for name, a, b in zip("qkv", got, exact):
        torch.testing.assert_close(a.double(), b, atol=1e-4, rtol=0,
                                   msg=lambda m, n=name: f"d{n} against float64: {m}")


def test_flash_forward_lse_leaves_output_unchanged(dev):
    """Serving passes no logsumexp buffer; asking for one changes nothing
    else, and the logsumexp is that of the scaled, masked scores."""
    rng = np.random.default_rng(6)
    q, k, v = (_rand(rng, (2, 200, 8, 96), dev) for _ in range(3))
    plain_out = flash_attention(q, k, v)
    out, lse = flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out, plain_out)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 96 ** -0.5
    mask = torch.ones(200, 200, dtype=torch.bool, device=dev).tril()
    want = torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


def test_softcap_gradient_raises(dev):
    """A softcapped gradient no longer raises: it launches the backward
    kernel (on the tensor cores at head_dim 64) and matches the plain
    version; what still raises is a head_dim above the kernels' 256."""
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, (1, 64, 2, 64), dev).requires_grad_(True) for _ in range(3))
    before = ops.LAUNCHES["flash_attention_bwd"]
    grads = torch.autograd.grad(ops.flash_attention_op(q, k, v, softcap=30.0).sum(), (q, k, v))
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    want = ops.plain_flash_attention_bwd(q, k, v, torch.ones_like(q), softcap=30.0)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    wide = _rand(rng, (1, 16, 1, 264), dev).requires_grad_(True)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_op(wide, wide, wide)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_swiglu_bwd_kernel_matches_plain(dev, act):
    rng = np.random.default_rng(8)
    T, D, F = 512, 256, 1024
    g, u, dh = (_rand(rng, (T, F), dev, scale=2.0) for _ in range(3))
    before = ops.LAUNCHES["swiglu_bwd"]
    got = swiglu_bwd(g, u, dh, act)
    assert ops.LAUNCHES["swiglu_bwd"] == before + 1
    for a, b in zip(got, ref.naive_swiglu_act_bwd(g, u, dh, act)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # the whole backward (kernel + products) against autograd of the plain MLP
    x = _rand(rng, (T, D), dev, scale=1.0).requires_grad_(True)
    ws = [_rand(rng, s, dev, scale=s[0] ** -0.5).requires_grad_(True)
          for s in ((D, F), (D, F), (F, D))]
    dout = _rand(rng, (T, D), dev, scale=1.0)
    grads = torch.autograd.grad(ops.fused_swiglu_op(x, *ws, act), (x, *ws), dout)
    for a, b in zip(grads, ref.naive_swiglu_bwd(x, *ws, dout, act)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_apply_layer_gradients_reach_every_parameter(dev):
    """Autograd through the kernels on the card: every parameter of a layer
    gets a gradient, equal to the CPU's (plain versions) within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.blocks import apply_layer, init_layer

    cfg = get_smoke_config("phi3-mini-3.8b")
    spec = cfg.pattern[0]
    params = init_layer(torch.Generator().manual_seed(0), cfg, spec, device="cpu")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32))
    pos = torch.arange(64, dtype=torch.int32).expand(2, 64)
    res = {}
    for device in ("cpu", dev):
        p = {k: {n: t.to(device).requires_grad_(True) for n, t in sub.items()}
             for k, sub in params.items()}
        leaves = [t for sub in p.values() for t in sub.values()]
        out, _ = apply_layer(p, x.to(device), pos.to(device), cfg, spec)
        res[str(device)] = torch.autograd.grad(out.square().mean(), leaves,
                                               allow_unused=True)
    for a, b in zip(res["cpu"], res[str(dev)]):
        assert b is not None
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)


def test_moe_layer_card_matches_cpu(dev):
    """The MoE layer at smoke width (4 experts x 256, top 2, drops at the
    published capacity factor) on the card against the CPU: the same
    routing, the output, the aux loss (1e-6) and every gradient (1e-4 of
    the leaf's largest value: an expert's weight gradient sums up to 81
    rows of products of order 1, so single entries cancel); E
    ``fused_swiglu`` launches a forward and E ``swiglu_bwd`` a backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as tmoe

    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    mc, E, D = cfg.moe, cfg.moe.n_experts, cfg.d_model
    params = tmoe.init_moe(torch.Generator().manual_seed(0), D, mc, device="cpu")
    rng = np.random.default_rng(10)
    x = torch.from_numpy((rng.standard_normal((2, 64, D)) + 1.5 * rng.standard_normal(D))
                         .astype(np.float32))
    res = {}
    for device in ("cpu", dev):
        p = {k: ({n: t.to(device).requires_grad_(True) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(device).requires_grad_(True))
             for k, v in params.items()}
        leaves = [p["router"], *p["experts"].values()]
        r = tmoe.route(p, x.to(device).reshape(-1, D), mc, E)
        keep, _ = tmoe.dispatch_slots(r.top_e, tmoe.capacity(mc, 128, E), E)
        ops.reset_launches()
        out, aux = tmoe.moe(p, x.to(device), mc)
        grads = torch.autograd.grad(out.square().sum() + aux, leaves)
        res[str(device)] = (r.top_e.cpu(), keep.cpu(), out.detach().cpu(),
                            float(aux.detach()), [g.cpu() for g in grads], dict(ops.LAUNCHES))
    (e0, k0, o0, a0, g0, _), (e1, k1, o1, a1, g1, n1) = res["cpu"], res[str(dev)]
    assert torch.equal(e0, e1) and torch.equal(k0, k1) and not bool(k0.all())
    torch.testing.assert_close(o1, o0, atol=1e-4, rtol=1e-4)
    assert abs(a1 - a0) <= 1e-6
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    assert n1["fused_swiglu"] == E and n1["swiglu_bwd"] == E


def test_int8_ef_train_step_card_matches_cpu(dev):
    """One int8 step with error feedback through ``step_fn`` on the card and
    on the CPU, held part by part: the loss; the gradient before the wire
    (the written-back leaves plus the first step's residual, exact for
    int8), in the 2-norm per leaf; the CPU wire on the card's pre-wire gradient, bitwise; AdamW on
    the card's post-wire gradients."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW, tree_leaves, tree_map
    from repro_torch.runtime.train import (build_train_step, ef_zeros, init_train_state,
                                           wire_buckets)

    cfg = get_smoke_config("phi3-mini-3.8b").replace(n_layers=4)
    batch_np = SyntheticLM(cfg.vocab_size, 32).batch(0, 4)
    seen = {}

    class RecordingAdamW(AdamW):
        def update(self, grads, state, params):
            seen["post"] = [g.detach().to("cpu", copy=True) for g in tree_leaves(grads)]
            return super().update(grads, state, params)

    params = None
    out = {}
    for device in (dev, torch.device("cpu")):
        opt = RecordingAdamW(lr=1e-3)
        ts = build_train_step(cfg, 4, stage=2, n_micro=2, compress="int8", bucket_mb=0.25,
                              optimizer=opt, device=device)
        if params is None:
            params = tree_map(lambda t: t.cpu(), init_train_state(3, ts)[0])
        p = tree_map(lambda t: t.to(device, copy=True), params)
        p, st, ef, loss, _ = ts.step_fn(p, opt.init(p), ts.init_ef(), ts.shard_batch(batch_np))
        pre = [t.clone() for t in seen["post"]]
        for bi, (_, idxs, sizes) in enumerate(ts.buckets):
            r, off = ef[f"bucket{bi}"][0].cpu(), 0
            for i, n in zip(idxs, sizes):
                pre[i].view(-1).add_(r[off:off + n])
                off += n
        out[device.type] = dict(loss=loss.cpu(), pre=pre, post=seen["post"],
                                ef={k: e.cpu() for k, e in ef.items()},
                                state=[t.cpu() for t in tree_leaves((p, st.m, st.v))])
    card, host = out["cuda"], out["cpu"]
    assert len(ts.buckets) > 2
    torch.testing.assert_close(card["loss"], host["loss"], atol=0, rtol=1e-5)
    for a, b in zip(card["pre"], host["pre"]):      # boundary code flips: 2-norm
        assert float((a - b).norm()) <= 2e-2 * float(b.norm())
    wired = [t.clone() for t in card["pre"]]
    ef_cpu = wire_buckets(ts.spec, wired, ef_zeros(ts.buckets, "cpu"), ts.buckets)
    for a, b in zip(wired, card["post"]):
        assert torch.equal(a, b)
    for k, e in card["ef"].items():
        assert torch.equal(ef_cpu[k], e)
    opt = AdamW(lr=1e-3)
    p = tree_map(torch.clone, params)
    p, st = opt.update([g.clone() for g in card["post"]], opt.init(p), p)
    for a, b in zip(card["state"], tree_leaves((p, st.m, st.v))):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


# ---------------------------------------------------------------------------
# Mamba selective scan and the no-experts Jamba slice
# ---------------------------------------------------------------------------

def _mamba_inputs(rng, B, S, d, N, dev):
    return ref.mamba_scan_inputs(lambda s: _rand(rng, s, dev, scale=1.0), B, S, d, N)


@pytest.mark.parametrize("case", [shape for shape, _ in ref.MAMBA_EDGE_CASES],
                         ids=[what for _, what in ref.MAMBA_EDGE_CASES])
def test_mamba_scan_kernel_matches_plain(dev, case):
    """2e-4 abs + rel, tests/test_kernels.py's tolerance for the scan."""
    inp = _mamba_inputs(np.random.default_rng(9), *case, dev)
    before = ops.LAUNCHES["mamba_scan"]
    out = ops.mamba_scan_op(*inp)
    assert ops.LAUNCHES["mamba_scan"] == before + 1
    want = ref.naive_mamba_scan(*inp)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=2e-4, rtol=2e-4)


def test_mamba_scan_kernel_long_memory(dev):
    """The model's init decays at the Jamba prefill's shape (memories of
    ~1000 steps, over which the kernel's ex2.approx decays compound): 2e-4
    abs + rel against the plain version, and against float64 on 256
    channels."""
    rng = np.random.default_rng(12)
    inp = ref.mamba_long_memory_inputs(lambda s: _rand(rng, s, dev, scale=1.0),
                                       *ref.MAMBA_LONG_MEMORY_SHAPE)
    out = ops.mamba_scan_op(*inp)
    torch.testing.assert_close(out, ref.naive_mamba_scan(*inp), atol=2e-4, rtol=2e-4)
    k = 256
    want = ref.naive_mamba_scan(*(t[..., :k].double() for t in inp[:4]), inp[4][:k].double())
    torch.testing.assert_close(out[..., :k].double(), want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", [(2, 200, 1000, 16), (1, 77, 333, 8)])
def test_mamba_scan_kernel_deterministic(dev, case):
    inp = _mamba_inputs(np.random.default_rng(13), *case, dev)
    a, b = ops.mamba_scan_op(*inp), ops.mamba_scan_op(*inp)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mamba_scan_gradient_raises(dev):
    dt, b, c, x, a = _mamba_inputs(np.random.default_rng(10), 1, 8, 128, 16, dev)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.mamba_scan_op(dt.requires_grad_(True), b, c, x, a)


def test_jamba_smoke_serve_card_matches_cpu(dev):
    """The smoke no-experts Jamba (8 layers, d_state 8) on the card against
    the CPU: prefill logits and 8 decode steps, 1e-4 abs (fp32 sums in other
    orders), with the prefill's and each step's launches."""
    from repro_torch.configs.common import smoke_reduce
    from repro_torch.configs.jamba_1_5_large import config_without_experts
    from repro_torch.models.model import init_model
    from repro_torch.optim import tree_map
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    cfg = smoke_reduce(config_without_experts())
    B, S, steps = 2, 64, 8
    params = init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S)))
    out = {}
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        ops.reset_launches()
        pre = build_prefill_step(cfg, batch_global=B, seq_len=S).step_fn(
            p, {"tokens": tokens.to(device)})
        after_prefill = dict(ops.LAUNCHES)
        ss = build_serve_step(cfg, batch_global=B, cache_len=steps)
        st = prepare_serve_states(cfg, ss.spec.plan, B, steps, device)
        dec = [ss.step_fn(p, tokens[:, t].to(device), t, st)[0].cpu() for t in range(steps)]
        out[str(device)] = (pre.cpu(), dec, after_prefill, dict(ops.LAUNCHES))
    pre_cpu, dec_cpu, _, _ = out["cpu"]
    pre_card, dec_card, after_prefill, after_all = out[str(dev)]
    torch.testing.assert_close(pre_card, pre_cpu, atol=1e-4, rtol=0)
    for a, b in zip(dec_card, dec_cpu):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    want = {name: 0 for name in ops.LAUNCHES}
    want.update(mamba_scan=7, flash_attention=1, fused_swiglu=8)
    assert after_prefill == want
    want.update(flash_decode=steps, fused_swiglu=8 * (steps + 1))
    assert after_all == want


# ---------------------------------------------------------------------------
# RWKV-6 WKV and the rwkv6-7b slice
# ---------------------------------------------------------------------------

def _wkv_inputs(rng, B, H, S, d, logit_max, dev):
    return ref.wkv6_inputs(lambda s: _rand(rng, s, dev, scale=1.0), B, H, S, d, logit_max)


@pytest.mark.parametrize("case", ref.WKV_EDGE_CASES,
                         ids=[what for _, _, what in ref.WKV_EDGE_CASES])
def test_rwkv6_wkv_kernel_matches_plain(dev, case):
    """5e-5 abs + rel (chip_smoke.py's TOL_WKV, 3.3x the largest error read
    on an H100 from the chunked 3xTF32 kernel; tests/test_kernels.py's 3e-4
    for the Pallas kernel is 20x it); head views of (B, S, H*d)
    projections, as the model hands them over."""
    shape, logit_max, _ = case
    inp = _wkv_inputs(np.random.default_rng(12), *shape, logit_max, dev)
    before = ops.LAUNCHES["rwkv6_wkv"]
    out = ops.rwkv6_wkv_op(*inp)
    assert ops.LAUNCHES["rwkv6_wkv"] == before + 1
    want = ops.plain_rwkv6_wkv(*inp)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=5e-5, rtol=5e-5)


def test_rwkv6_wkv_hot_chunk_and_two_runs_bitwise(dev):
    """Logits above 0 in one 64-step chunk only: the kernel runs that chunk
    step by step and the others on the tensor cores, on one state; 5e-5 as
    above.  Two runs give the same bits (no atomics)."""
    shape, hot, logit_max = ref.WKV_HOT_CHUNK_CASE
    rng = np.random.default_rng(15)
    inp = ref.wkv6_hot_inputs(lambda s: _rand(rng, s, dev, scale=1.0), *shape, hot, logit_max)
    out = ops.rwkv6_wkv_op(*inp)
    torch.testing.assert_close(out, ops.plain_rwkv6_wkv(*inp), atol=5e-5, rtol=5e-5)
    assert torch.equal(out, ops.rwkv6_wkv_op(*inp))


def test_rwkv6_wkv_long_memory_against_float64(dev):
    """The model's init decays and one-sign r, k, v (|out| ~ 1e4) at the
    prefill's shape; 16 rows against the recurrence in float64, 5e-5 as
    above (the tensor core truncates its sums, so an error that compounds
    over the memory would show here)."""
    rng = np.random.default_rng(16)
    r, k, v, w, u = ref.wkv6_long_memory_inputs(lambda s: _rand(rng, s, dev, scale=1.0),
                                                *ref.WKV_LONG_MEMORY_SHAPE)
    out = ops.rwkv6_wkv_op(r, k, v, w, u)
    B, H, S, d = r.shape
    rows = [t.reshape(B * H, S, d)[:16].double() for t in (r, k, v, w)]
    want = ref.naive_wkv6(*rows, u.repeat(B, 1)[:16].double())
    torch.testing.assert_close(out.reshape(B * H, S, d)[:16].double(), want,
                               atol=5e-5, rtol=5e-5)


def test_rwkv6_wkv_contiguous_inputs_and_refusals(dev):
    """Contiguous (B, H, S, d) inputs give what their head views give; the
    kernel refuses a head size it is not built for and a gradient."""
    r, k, v, w, u = _wkv_inputs(np.random.default_rng(13), 2, 4, 70, 64, 0.0, dev)
    got = ops.rwkv6_wkv_op(*(t.contiguous() for t in (r, k, v, w)), u)
    torch.testing.assert_close(got, ops.rwkv6_wkv_op(r, k, v, w, u), atol=0, rtol=0)
    odd = _wkv_inputs(np.random.default_rng(14), 1, 2, 8, 48, 0.0, dev)
    with pytest.raises(ValueError, match="head size 48"):
        ops.rwkv6_wkv_op(*odd)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.rwkv6_wkv_op(r.detach().requires_grad_(True), k, v, w, u)


def test_rwkv_smoke_serve_card_matches_cpu_in_place(dev):
    """The smoke rwkv6-7b (2 layers, head_dim 32) on the card against the CPU:
    prefill logits and 8 decode steps, 8e-5 abs (fp32 sums in other orders;
    under 15x the largest difference an H100 showed, on logits of order 3);
    the decode states that prepare_serve_states made, "mixer" and "cm", are
    written in place on both; the prefill launches the WKV once per layer
    and decoding launches no kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_model
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    cfg = get_smoke_config("rwkv6-7b")
    B, S, steps = 2, 32, 8
    params = init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(15).integers(0, cfg.vocab_size, (B, S)))
    out = {}
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        ops.reset_launches()
        pre = build_prefill_step(cfg, batch_global=B, seq_len=S).step_fn(
            p, {"tokens": tokens.to(device)})
        after_prefill = dict(ops.LAUNCHES)
        ss = build_serve_step(cfg, batch_global=B, cache_len=steps)
        st = prepare_serve_states(cfg, ss.spec.plan, B, steps, device)
        dec = [ss.step_fn(p, tokens[:, t].to(device), t, st)[0].cpu() for t in range(steps)]
        out[str(device)] = (pre.cpu(), dec, tree_map(lambda t: t.cpu(), st), after_prefill,
                            dict(ops.LAUNCHES))
    pre_cpu, dec_cpu, st_cpu, _, _ = out["cpu"]
    pre_card, dec_card, st_card, after_prefill, after_all = out[str(dev)]
    torch.testing.assert_close(pre_card, pre_cpu, atol=8e-5, rtol=0)
    for a, b in zip(dec_card, dec_cpu):
        torch.testing.assert_close(a, b, atol=8e-5, rtol=0)
    (slot,) = st_card
    assert sorted(slot) == ["cm", "mixer"]
    for name, leaf in [("tm shift", slot["mixer"]["shift"]), ("wkv", slot["mixer"]["wkv"]),
                       ("cm shift", slot["cm"]["shift"])]:
        assert bool(leaf.abs().sum() > 0), f"{name} state never written"
    for a, b in zip(tree_leaves(st_card), tree_leaves(st_cpu)):
        torch.testing.assert_close(a, b, atol=8e-5, rtol=0)
    want = {name: 0 for name in ops.LAUNCHES}
    want.update(rwkv6_wkv=cfg.n_layers)
    assert after_prefill == want and after_all == want


# ---------------------------------------------------------------------------
# DeepSeek-V3's MLA: the latent route of flash_decode, attention at D = 192
# ---------------------------------------------------------------------------

LATENT_CASES = [
    # (B, H, S, R, Dr, lens): lens None = a shared length of S
    (8, 128, 256, 512, 64, (256, 1, 17, 64, 128, 200, 255, 100)),   # the decode step
    (1, 128, 4096, 512, 64, None),                                   # 16 splits
    (3, 20, 300, 512, 64, (300, 33, 250)),     # a partial head tile, ragged S
    (2, 4, 70, 32, 16, (70, 5)),               # the smoke widths: R of 32
]


@pytest.mark.parametrize("case", LATENT_CASES)
def test_latent_decode_kernel_matches_plain(dev, case):
    """The latent route against ``ref.naive_latent_decode``, on caches
    read by strides out of stacked (periods, B, S, ...) buffers, as the
    model hands them over."""
    from repro_torch.kernels import ref
    B, H, S, R, Dr, lens = case
    rng = np.random.default_rng(2)
    q_lat, q_rope = _rand(rng, (B, H, R), dev), _rand(rng, (B, H, Dr), dev)
    ckv = _rand(rng, (2, B, S, R), dev)[1]
    krope = _rand(rng, (2, B, S, Dr), dev)[1]
    clen = S if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 192 ** -0.5
    before = ops.LAUNCHES["flash_decode_latent"]
    out = ops.flash_decode_latent_op(q_lat, q_rope, ckv, krope, clen, scale=scale)
    assert ops.LAUNCHES["flash_decode_latent"] == before + 1
    want = ref.naive_latent_decode(q_lat, q_rope, ckv, krope, clen, scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    again = ops.flash_decode_latent_op(q_lat, q_rope, ckv, krope, clen, scale=scale)
    assert torch.equal(out, again)


def test_latent_decode_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.decode_attention import flash_decode_latent
    rng = np.random.default_rng(3)
    q_lat, q_rope = _rand(rng, (1, 16, 512), dev), _rand(rng, (1, 16, 64), dev)
    ckv, krope = _rand(rng, (1, 8, 512), dev), _rand(rng, (1, 8, 64), dev)
    with pytest.raises(ValueError, match="float32"):
        flash_decode_latent(q_lat.bfloat16(), q_rope, ckv, krope, 8, scale=1.0)
    with pytest.raises(ValueError, match="widths"):
        flash_decode_latent(_rand(rng, (1, 16, 640), dev), q_rope,
                            _rand(rng, (1, 8, 640), dev), krope, 8, scale=1.0)
    with pytest.raises(ValueError, match="aligned"):
        flash_decode_latent(q_lat, q_rope, _rand(rng, (1, 8, 516), dev)[..., 1:513],
                            krope, 8, scale=1.0)


@pytest.mark.parametrize("shape", [(2, 256, 8, 192), (1, 512, 4, 192)])
def test_flash_at_head_dim_192_with_padded_values(dev, shape):
    """MLA's prefill and training attention: q/k at 192, v of 128 zero-padded
    to 192 (``models.attention.mla_forward``), forward and backward on the
    two-CTA cluster route, against the plain version; the padding's columns
    come out 0 and its gradient is cut by the slice."""
    B, S, H, D = shape
    rng = np.random.default_rng(4)
    q, k = _rand(rng, (B, S, H, D), dev), _rand(rng, (B, S, H, D), dev)
    v = _rand(rng, (B, S, H, 128), dev)
    assert flash_attention_fwd_route(q, k, torch.nn.functional.pad(v, (0, 64))) == "tc_cluster"
    dout = _rand(rng, (B, S, H, 128), dev)
    grads = {}
    for name, fn in (("kernel", ops.flash_attention_op), ("plain", ops.plain_flash_attention)):
        qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        o = fn(qq, kk, torch.nn.functional.pad(vv, (0, D - 128)), scale=D ** -0.5)
        assert float(o[..., 128:].abs().max()) == 0.0
        o = o[..., :128]
        o.backward(dout)
        grads[name] = (o.detach(), qq.grad, kk.grad, vv.grad)
    torch.cuda.synchronize()
    for got, want in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
