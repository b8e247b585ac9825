"""Why ``csrc/flash_attention.cu`` takes three TF32 passes on both products.

The tensor-core route computes S = Q Kᵀ and O = P V on the tensor cores,
whose operands are TF32 (10 explicit mantissa bits).  Each fp32 operand v,
the probability tile P included, splits into hi = tf32(v) and lo =
tf32(v - hi), and each product sums lo·hi + hi·lo + hi·hi (3xTF32).  Here,
on the CPU, the same rounding and split, with the products summed in
float64 so that only the operands' rounding counts, show against a float64
reference of causal attention (q/k/v = 0.5·N(0, 1), as ``chip_smoke.py``
draws them) that:

- one pass on both products misses the port's fp32 tolerance at phi3's
  width (head_dim 96, S = 512) and at Jamba's (128, S = 1024);
- one pass on either product alone misses it too: three passes on Q Kᵀ
  with one on P V at both widths, and one on Q Kᵀ with three on P V at a
  score scale of 1 (at the default scale, D^-0.5, that pair reads 0.7e-4 to
  1.2e-4 here depending on the draw: no margin either way);
- three passes on both meet it with a margin of 100;
- a row of 16384 keys with one-sign values around 1 holds with three
  passes (one pass holds there too: over that many keys the operands'
  rounding errors average out);
- at Gemma's head_dim 256, the route that splits head_dim over a cluster of
  two CTAs (S formed as two 128-column partials, each summed in fp32 from
  32-column chunks, added in fp32; P V on each CTA's columns) meets it with
  the same margin of 100.

The tensor core also truncates its fp32 sums, which this emulation does not
model; the kernel sums each key tile's P V from zero and adds it to the
running output in fp32 (the long one-sign row of ``tests/test_torch_cuda.py``
holds it on the card).
"""

import numpy as np
import pytest
import torch

# chip_smoke.py's TOL_FP32 and tests/test_torch_cuda.py's fp32 tolerance
TOL_FP32 = 1e-4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (low 13 mantissa bits cleared), ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b (batched) from TF32 parts, summed in float64: hi·hi (one
    pass), or lo·hi + hi·lo + hi·hi (three passes)."""
    ah = tf32_round(a)
    bh = tf32_round(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = tf32_round(a - ah), tf32_round(b - bh)
        out += al.double() @ bh.double() + ah.double() @ bl.double()
    return out


def chunk_sum(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b over the contraction in 32-wide chunks, each chunk's product
    (``tf32_matmul``) rounded to fp32 and summed in fp32, as a kernel sums
    a partial product chunk by chunk from zero."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c in range(0, a.shape[-1], 32):
        acc = acc + tf32_matmul(a[..., c:c + 32], b[..., c:c + 32, :], passes).float()
    return acc


def attention(q, k, v, qk_passes, pv_passes, scale=None, causal=True, split=None):
    """Attention of (H, Sq, D) queries over (H, Sk, D) keys and values,
    causal over the last Sq keys.  Passes 0: float64 throughout; else each
    product through ``tf32_matmul``, P rounded to fp32 as the kernel holds
    it before its split.  split (with passes): head_dim over two CTAs, as
    the cluster route forms it: S as the fp32 sum of the partials over
    columns :split and split: (each by ``chunk_sum``), P V on each part's
    columns of V."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[2]
    scale = D ** -0.5 if scale is None else scale
    if qk_passes == 0:
        s = q.double() @ k.double().transpose(1, 2)
    elif split is not None:
        kt = k.transpose(1, 2)
        s = (chunk_sum(q[..., :split], kt[:, :split], qk_passes)
             + chunk_sum(q[..., split:], kt[:, split:], qk_passes)).double()
    else:
        s = tf32_matmul(q, k.transpose(1, 2), qk_passes)
    s = s * scale
    if causal:
        keep = torch.arange(Sk)[None, :] <= torch.arange(Sk - Sq, Sk)[:, None]
        s = torch.where(keep, s, -1e300)
    p = torch.softmax(s, dim=-1)
    if pv_passes == 0:
        return p @ v.double()
    if split is not None:
        return torch.cat([tf32_matmul(p.float(), v[..., :split], pv_passes),
                          tf32_matmul(p.float(), v[..., split:], pv_passes)], dim=-1)
    return tf32_matmul(p.float(), v, pv_passes)


def _qkv(H, S, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((0.5 * rng.standard_normal((H, S, D))).astype(np.float32))
                 for _ in range(3))


def _err(q, k, v, qk, pv, **kw):
    return float((attention(q, k, v, qk, pv, **kw) - attention(q, k, v, 0, 0, **kw)).abs().max())


def test_tf32_round_keeps_ten_bits_ties_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -12, 0.0])
    assert tf32_round(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0, 0.0]


WIDTHS = {"phi3": (4, 512, 96), "jamba": (2, 1024, 128)}   # (heads, S, head_dim)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_one_pass_on_both_products_misses(width):
    q, k, v = _qkv(*WIDTHS[width], seed=1)
    assert _err(q, k, v, 1, 1) > 3 * TOL_FP32


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_three_passes_on_qk_alone_miss(width):
    """P V in one pass loses P's and V's low bits: three passes on Q Kᵀ do
    not make up for it."""
    q, k, v = _qkv(*WIDTHS[width], seed=2)
    assert _err(q, k, v, 3, 1) > 3 * TOL_FP32


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_three_passes_on_pv_alone_miss(width):
    """Q Kᵀ in one pass errs in the scores by ~2^-11 of |q||k|, which the
    softmax passes on to the output; at a score scale of 1 that is past the
    tolerance."""
    q, k, v = _qkv(*WIDTHS[width], seed=3)
    assert _err(q, k, v, 1, 3, scale=1.0) > 3 * TOL_FP32


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("scale", [None, 1.0])
def test_three_passes_on_both_meet_the_tolerance(width, scale):
    q, k, v = _qkv(*WIDTHS[width], seed=4)
    assert _err(q, k, v, 3, 3, scale=scale) <= TOL_FP32 / 100


def test_long_one_sign_row():
    """The last query of a causal row of 16384 keys, q/k uniform in [0, 1),
    V in [1, 1.1) (the card test's draw): three passes hold.  On the card
    this row guards against the tensor core's truncated sums, which this
    emulation does not model."""
    rng = np.random.default_rng(5)
    S, D = 16384, 128
    q = torch.from_numpy(rng.random((2, 1, D), dtype=np.float32))
    k = torch.from_numpy(rng.random((2, S, D), dtype=np.float32))
    v = torch.from_numpy((1 + 0.1 * rng.random((2, S, D))).astype(np.float32))
    assert _err(q, k, v, 3, 3) <= TOL_FP32 / 100


def test_cluster_halves_meet_the_tolerance():
    """Head_dim 256 over a cluster of two CTAs (the forward's route at 128 <
    head_dim <= 256): S from two 128-column partials, three passes each,
    summed in fp32 by 32-column chunks and added in fp32; P V in three
    passes on each CTA's 128 columns of V; at the model's score scale, as
    the backward's cluster case holds it."""
    q, k, v = _qkv(4, 256, 256, seed=6)
    assert _err(q, k, v, 3, 3, split=128) <= TOL_FP32 / 100
