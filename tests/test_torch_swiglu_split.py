"""Why ``csrc/fused_swiglu.cu`` takes three TF32 passes on fp32 data.

At T > 16 the kernel computes its products on the tensor cores, whose
operands are TF32 (10 explicit mantissa bits).  It splits each fp32 value v
into hi = tf32(v) and lo = tf32(v - hi) and sums lo·hi + hi·lo + hi·hi
(3xTF32).  Here, on the CPU, the same rounding and split, with the products
summed in float64 so that only the operands' rounding counts, show at
phi3's width (D = 3072, F = 8192) that one pass misses the port's fp32
tolerance of the float64 result and three passes meet it, and that bf16
operands, exact in TF32, lose nothing in one pass.

The tensor core also truncates its fp32 sums, which this emulation does not
model; the kernel sums each 32-deep K slice from zero and adds it to its
accumulator in fp32 (the long one-sign case of ``tests/test_torch_cuda.py``
holds it on the card).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

# chip_smoke.py's TOL_FP32 and tests/test_torch_cuda.py's fp32 tolerance
TOL_FP32 = 1e-4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (low 13 mantissa bits cleared), ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds; inf and nan stay."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b from TF32 parts, summed in float64: hi·hi (one pass), or
    lo·hi + hi·lo + hi·hi (three passes); b taken 2048 columns at a time."""
    ah, al = (t.double() for t in tf32_split(a))
    cols = []
    for b_blk in b.split(2048, dim=1):
        bh, bl = (t.double() for t in tf32_split(b_blk))
        out = ah @ bh
        if passes == 3:
            out += al @ bh + ah @ bl
        cols.append(out)
    return torch.cat(cols, dim=1)


def _swiglu(x, wg, wu, wd, passes):
    """passes 0: float64 throughout; 1 or 3: each product through
    ``tf32_matmul``, h rounded to fp32 as the kernel stores it."""
    if passes == 0:
        x, wg, wu, wd = (t.double() for t in (x, wg, wu, wd))
        return (F.silu(x @ wg) * (x @ wu)) @ wd
    h = (F.silu(tf32_matmul(x, wg, passes)) * tf32_matmul(x, wu, passes)).float()
    return tf32_matmul(h, wd, passes)


def _inputs(T, D, Fd, seed):
    """x ~ N(0, 1), weights scaled by their fan-in, as float32."""
    rng = np.random.default_rng(seed)

    def f32(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return f32((T, D)), f32((D, Fd), D ** -0.5), f32((D, Fd), D ** -0.5), f32((Fd, D), Fd ** -0.5)


def test_tf32_round_keeps_ten_bits_ties_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -12,
                      1 + 2 ** -10, 0.0, float("inf"), float("nan")])
    got = tf32_round(x)
    assert got[:7].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0,
                                1 + 2 ** -10, 0.0, float("inf")]
    assert torch.isnan(got[7])


def test_split_parts_are_tf32_and_keep_fp32():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = x * torch.logspace(-20, 20, 4096)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert torch.all(part.view(torch.int32) & 0x1FFF == 0)
    # lo·lo, which 3xTF32 drops, is below 2^-22 of |x|; so is what hi + lo misses
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(rest <= 2.0 ** -22 * x.double().abs())


@pytest.mark.parametrize("passes", [1, 3])
def test_swiglu_needs_three_tf32_passes(passes):
    """One TF32 pass misses 1e-4 at phi3's width (T = 4); three meet it."""
    x, wg, wu, wd = _inputs(4, 3072, 8192, seed=1)
    err = float((_swiglu(x, wg, wu, wd, passes) - _swiglu(x, wg, wu, wd, 0)).abs().max())
    if passes == 1:
        assert err > 5 * TOL_FP32
    else:
        assert err <= TOL_FP32 / 20


def test_bf16_operands_lose_nothing_in_one_pass():
    """A bf16 value is exact in TF32: its lo part is 0, so one pass of a
    product of bf16 operands is the float64 product itself."""
    x, wg, _, _ = (t.bfloat16().float() for t in _inputs(4, 3072, 8192, seed=2))
    for t in (x, wg):
        hi, lo = tf32_split(t)
        assert torch.equal(hi, t) and not lo.any()
    assert torch.equal(tf32_matmul(x, wg, 1), tf32_matmul(x, wg, 3))
    assert torch.equal(tf32_matmul(x, wg, 1), torch.cat(
        [x.double() @ blk.double() for blk in wg.split(2048, dim=1)], dim=1))
