"""Why ``csrc/flash_attention_bwd.cu`` takes three TF32 passes on all five
products.

The tensor-core route of the backward computes S = Q Kᵀ, dP = dO Vᵀ, dV =
Pᵀ dO, dK = scale·dSᵀ Q and dQ = scale·dS K on the tensor cores, whose
operands are TF32 (10 explicit mantissa bits).  Each fp32 operand v, the
probability tile P and dS = P ∘ (dP − Dvec) included, splits into hi =
tf32(v) and lo = tf32(v − hi), and each product sums lo·hi + hi·lo + hi·hi
(3xTF32).  Here, on the CPU, the same rounding and split (the rounding and
products of ``tests/test_torch_attention_tf32.py``, summed in float64 so
that only the operands' rounding counts) show against the float64 gradient
of causal attention (q/k/v = 0.5·N(0, 1) and dO = N(0, 1), as
``chip_smoke.py`` draws them, at the training shape's S = 256 and phi3's
and Jamba's head dims) that:

- one pass on all five products misses the port's fp32 tolerance;
- one pass on any one product alone misses it too, the dS side included:
  dP (whose error dS passes on to dK and dQ through the cancelling dP −
  Dvec), and the split of dS in dK and dQ;
- three passes on all five meet it with a margin of 100;
- at Gemma's head_dim 256, the route that splits head_dim over a cluster of
  two CTAs (each contracting product, S and dP, formed as two 128-column
  3xTF32 halves added in fp32) meets it with the same margin.

``bwd_kv_split``, the wrapper's choice of the MQA split of that route's
dK/dV pass, and the scratch it allocates for the parts, are checked here
too.

The kernel's other inputs are the forward's fp32 outputs (O and the
logsumexp) and Dvec = rowsum(dO ∘ O) summed in fp32; the emulation rounds
them, P and dS to fp32 where the kernel holds them so.  The tensor core also
truncates its fp32 sums, which this emulation does not model; the kernel
sums each tile's contribution from zero and adds it in fp32 (the long
one-sign case of ``tests/test_torch_cuda.py`` holds it on the card).
"""

import numpy as np
import pytest
import torch

from test_torch_attention_tf32 import TOL_FP32, tf32_matmul

from repro_torch.kernels.flash_attention import bwd_kv_split, bwd_parts

PRODUCTS = ("s", "dp", "dv", "dk", "dq")
WIDTHS = {"phi3": (4, 256, 96), "jamba": (4, 256, 128),
          "gemma": (4, 256, 256)}   # (heads, S, head_dim)


def attention_grads(q, k, v, do, passes=None, split=None):
    """(dq, dk, dv) of causal attention over (H, S, D) inputs.  passes None:
    float64 throughout.  Else passes[name] TF32 passes (1 or 3) on each of
    the five products, with the kernel's fp32 roundings.  split: the
    contracting products S and dP formed as two halves of head_dim (columns
    :split and split:), each rounded to fp32 as a CTA's accumulator holds
    it, then added in fp32, as the two-CTA cluster route forms them."""
    S, D = q.shape[1], q.shape[2]
    scale = D ** -0.5
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s64 = torch.where(keep, q.double() @ k.double().transpose(1, 2) * scale, -torch.inf)
    lse64 = torch.logsumexp(s64, dim=-1)
    p64 = torch.exp(s64 - lse64[..., None])
    o64 = p64 @ v.double()
    if passes is None:
        ds = p64 * (do.double() @ v.double().transpose(1, 2)
                    - (do.double() * o64).sum(-1)[..., None])
        return (ds @ k.double() * scale, ds.transpose(1, 2) @ q.double() * scale,
                p64.transpose(1, 2) @ do.double())
    lse, o = lse64.float(), o64.float()                     # the forward's outputs
    dvec = (do.double() * o.double()).sum(-1).float()

    def mm(name, a, b):
        if split is not None and name in ("s", "dp"):
            halves = (tf32_matmul(a[..., :split], b[..., :split, :], passes[name]),
                      tf32_matmul(a[..., split:], b[..., split:, :], passes[name]))
            return (halves[0].float() + halves[1].float()).double()
        return tf32_matmul(a, b, passes[name])

    s = mm("s", q, k.transpose(1, 2)) * scale
    p = torch.where(keep, torch.exp(s - lse.double()[..., None]), 0.0).float()
    dp = mm("dp", do, v.transpose(1, 2))
    ds = (p.double() * (dp - dvec.double()[..., None])).float()
    return (mm("dq", ds, k) * scale, mm("dk", ds.transpose(1, 2), q) * scale,
            mm("dv", p.transpose(1, 2), do))


def _inputs(H, S, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy((0.5 * rng.standard_normal((H, S, D))).astype(np.float32))
               for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((H, S, D)).astype(np.float32))
    return q, k, v, do


def _err(width, one_pass, seed):
    """Max abs error of dq/dk/dv with one pass on the products in
    ``one_pass`` and three on the others."""
    args = _inputs(*WIDTHS[width], seed)
    got = attention_grads(*args, passes={n: 1 if n in one_pass else 3 for n in PRODUCTS})
    ref = attention_grads(*args)
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_one_pass_on_all_products_misses(width):
    assert _err(width, PRODUCTS, seed=1) > 3 * TOL_FP32


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("one_pass", [("s",), ("dp",), ("dv",), ("dk",), ("dq",), ("dk", "dq")],
                         ids=lambda p: "+".join(p))
def test_one_pass_on_any_product_misses(width, one_pass):
    """Each product in one pass with the other four in three: every choice
    misses, the dS side (dP, and the split of dS in dK and dQ) included."""
    assert _err(width, one_pass, seed=2) > TOL_FP32


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_three_passes_on_all_products_meet_the_tolerance(width):
    assert _err(width, (), seed=3) <= TOL_FP32 / 100


def test_cluster_halves_meet_the_tolerance():
    """Head_dim 256 over a cluster of two CTAs: S and dP from two 128-column
    halves, three passes each, added in fp32; the other products in three
    passes on the CTAs' own columns (the same arithmetic as one CTA)."""
    args = _inputs(*WIDTHS["gemma"], seed=5)
    got = attention_grads(*args, passes=dict.fromkeys(PRODUCTS, 3), split=128)
    ref = attention_grads(*args)
    assert max(float((a - b).abs().max()) for a, b in zip(got, ref)) <= TOL_FP32 / 100


def test_kv_split_and_its_scratch():
    """The dK/dV pass's split of the GQA group at head_dim 256: a block an
    SM or more at gemma-2b's MQA prefill (2, 512, 8/1) on an H100's 132 SMs,
    g = 1 at gemma2's training micro-batch (1, 8192, 8/4: 512 clusters), g
    dividing the group, and the scratch the wrapper allocates holding the
    (2, g, B, S, Hkv, D) float32 parts (none at g = 1, or off the route)."""
    n_sm = 132
    for B, S, H, Hkv in ((2, 512, 8, 1), (2, 512, 8, 4), (1, 100, 4, 1), (1, 8192, 8, 1)):
        g = bwd_kv_split(B, S, H, Hkv, n_sm)
        blocks = 2 * -(-S // 64) * Hkv * B
        assert (H // Hkv) % g == 0
        assert blocks * g >= n_sm or g == H // Hkv
        assert all(blocks * d < n_sm for d in range(1, g) if (H // Hkv) % d == 0)   # the least
    assert bwd_kv_split(2, 512, 8, 1, n_sm) == 8
    assert bwd_kv_split(1, 8192, 8, 4, n_sm) == 1
    g, parts = bwd_parts(2, 512, 8, 1, 256, "tc_cluster", n_sm, "cpu")
    assert g == 8 and parts.dtype == torch.float32
    assert parts.numel() == 2 * g * 2 * 512 * 1 * 256
    assert bwd_parts(1, 8192, 8, 4, 256, "tc_cluster", n_sm, "cpu") == (1, None)
    assert bwd_parts(2, 512, 8, 1, 128, "tc", n_sm, "cpu") == (1, None)


def test_float64_reference_is_autograd():
    """The closed-form float64 gradient above is attention's gradient."""
    q, k, v, do = (t.double() for t in _inputs(2, 40, 16, seed=4))
    keep = torch.ones(40, 40, dtype=torch.bool).tril()
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    s = torch.where(keep, qq @ kk.transpose(1, 2) * 16 ** -0.5, -torch.inf)
    want = torch.autograd.grad(torch.softmax(s, dim=-1) @ vv, (qq, kk, vv), do)
    for a, b in zip(attention_grads(q, k, v, do), want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)
