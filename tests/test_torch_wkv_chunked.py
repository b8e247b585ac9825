"""The arithmetic of ``csrc/rwkv6_wkv.cu``'s tensor-core route, emulated on the CPU.

At d = 64 the kernel runs the WKV in 64-step chunks in matmul form.  With
P(a..b) the product of a key's decays over steps a..b, it forms rq_t = r_t /
P(t..31) (t < 32) or r_t P(32..t-1), and kq_s = k_s P(s+1..31) (s < 32) or
k_s / P(32..s), running products from the chunk's middle outwards, so that
rq_t kq_s is the pair's decay P(s+1..t-1) and every factor lies within the
product of a half chunk and its inverse.  Then

    out = (mask(rq kq^T) + diag(bonus)) V + rq (P(0..31) S)
    S   = P(0..63) S + P(32..63) kq^T V

with every product in three TF32 passes (lo*hi + hi*lo + hi*hi).  A chunk in
which a key's half-chunk product falls below 2^-96 runs the recurrence step
by step instead (the exact branch).

Here the same order of work in float32, each product's TF32 parts summed in
float64 (the tensor core's own sums, which it truncates, are not modelled:
``chip_smoke.py`` holds the kernel to float64 on a long one-sign draw for
that), is held to ``repro``'s WKV (its Pallas kernel in interpret mode and
its reference) and to the port's plain recurrence at the port's card
tolerance, and shown to need what it has: three passes, the exact branch at
the unclamped decays, none of it at the model's clamp, and products where
the TPU kernel takes exp(+-cumsum(log w)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ref as jref
from repro.kernels.rwkv6_wkv import rwkv6_wkv as pallas_wkv
from repro_torch.kernels import ref
from test_torch_attention_tf32 import tf32_round
from test_torch_rwkv import WKV_CASES, _randn

#: chip_smoke.py's TOL_WKV: |diff| <= TOL * (1 + |want|)
TOL_WKV = 5e-5
C = 64                                  # steps a chunk
MIN_HALF_DECAY = 2.0 ** -96             # the kernel's kMinHalfDecay


def tf32_mm(a, b, passes):
    """a @ b (batched, float32) from TF32 parts summed in float64, rounded
    to float32 once: hi·hi, or lo·hi + hi·lo + hi·hi."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = tf32_round(a - ah), tf32_round(b - bh)
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out


def _factors(w):
    """Running products of (BH, 64, d) decays from the middle, as the kernel
    forms them (a thread a key and half chunk; each reciprocal rounded to
    float32, a model of rcp.approx, then multiplied): returns (rf, kf, b0,
    f63) with rq = r * rf and kq = k * kf, and P(0..31), P(32..63)."""
    rf, kf = torch.empty_like(w), torch.empty_like(w)
    p = torch.ones_like(w[:, 0])
    for t in range(31, -1, -1):
        kf[:, t] = p
        p = p * w[:, t]
        rf[:, t] = 1.0 / p
    b0, p = p, torch.ones_like(w[:, 0])
    for t in range(32, 64):
        rf[:, t] = p
        p = p * w[:, t]
        kf[:, t] = 1.0 / p
    return rf, kf, b0, p


def _log_factors(w):
    """The same factors as exp(+-cumsum(log w)) referenced to the chunk's
    middle, as the TPU kernel and repro's model form them (for comparison)."""
    cum = torch.cumsum(torch.log(torch.clamp(w, min=1e-20)), dim=1)
    m = cum[:, 31:32]
    c = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    return torch.exp(c - m), torch.exp(m - cum), torch.exp(m[:, 0]), torch.exp(cum[:, 63] - m[:, 0])


def kernel_wkv(r, k, v, w, u, passes=3, branch=True, factors=_factors):
    """The d = 64 route's order of work on float32 CPU tensors: r/k/v/w (BH,
    S, d), u (BH, d).  Returns (out (BH, S, d), which chunks ran exactly)."""
    BH, S, d = r.shape
    out = torch.empty((BH, S, d))
    st = torch.zeros((BH, d, d))
    exact_chunks = []
    keep = torch.arange(C)[None, :] < torch.arange(C)[:, None]     # s < t
    for t0 in range(0, S, C):
        n = min(C, S - t0)

        def chunk(x, fill):
            return torch.cat([x[:, t0:t0 + n], torch.full((BH, C - n, d), fill)], dim=1)

        rr, kk, vv, ww = chunk(r, 0.0), chunk(k, 0.0), chunk(v, 0.0), chunk(w, 1.0)
        bonus = (rr * u[:, None] * kk).sum(-1)
        rf, kf, b0, f63 = factors(ww)
        exact = branch and not bool(((b0 >= MIN_HALF_DECAY) & (f63 >= MIN_HALF_DECAY)).all())
        exact_chunks.append(exact)
        if exact:
            for t in range(n):
                out[:, t0 + t] = (torch.einsum("bi,bij->bj", rr[:, t], st)
                                  + bonus[:, t, None] * vv[:, t])
                st = st * ww[:, t, :, None] + kk[:, t, :, None] * vv[:, t, None, :]
            continue
        rq, kq = rr * rf, kk * kf
        a = torch.where(keep, tf32_mm(rq, kq.transpose(1, 2), passes).float(), 0.0)
        a = a + torch.diag_embed(bonus)                # the bonus on the diagonal
        o = (tf32_mm(rq, b0[:, :, None] * st, passes) + tf32_mm(a, vv, passes)).float()
        upd = tf32_mm(kq.transpose(1, 2), vv, passes).float()
        st = (st.double() * (b0 * f63)[:, :, None].double()
              + (upd * f63[:, :, None]).double()).float()                   # fmaf
        out[:, t0:t0 + n] = o[:, :n]
    return out, exact_chunks


def _rows(inp):
    """(B, H, S, d) head views and u (H, d) -> (B·H, S, d) rows, u per row."""
    r, k, v, w, u = inp
    B, H, S, d = r.shape
    return [t.reshape(B * H, S, d) for t in (r, k, v, w)] + [u.repeat(B, 1)]


def _wkv64(*inp):
    """The recurrence in float64."""
    return ref.naive_wkv6(*(t.double() for t in inp))


def _err(got, want):
    """max |got - want| / (1 + |want|)."""
    want = want.double()
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


def _inputs(seed, B, H, S, d, logit_max=0.0):
    return _rows(ref.wkv6_inputs(_randn(np.random.default_rng(seed)), B, H, S, d, logit_max))


@pytest.mark.parametrize("reference", ["pallas_interpret", "repro_ref"])
@pytest.mark.parametrize("case", WKV_CASES)
def test_emulation_matches_repro(case, reference):
    BH, S, d, chunk = case
    r, k, v, w, u = _inputs(2, 1, BH, S, d)
    j_in = [jnp.asarray(t.numpy()) for t in (r, k, v, w, u)]
    if reference == "pallas_interpret":
        want = pallas_wkv(*j_in, chunk=chunk, interpret=True)
    else:
        want = jref.naive_wkv6(*j_in)
    got, exact = kernel_wkv(r, k, v, w, u)
    assert not any(exact)
    assert _err(got, torch.from_numpy(np.array(want))) <= TOL_WKV


@pytest.mark.parametrize("case", [c for c in ref.WKV_EDGE_CASES if c[0][2] <= 256],
                         ids=lambda c: c[2])
def test_emulation_matches_plain_on_edge_cases(case):
    (B, H, S, d), logit_max, _ = case
    inp = _inputs(3, B, H, S, d, logit_max)
    got, exact = kernel_wkv(*inp)
    assert _err(got, ref.naive_wkv6(*inp)) <= TOL_WKV
    assert any(exact) == (logit_max > 0)


def test_hot_chunk_alternates_branches_on_one_state():
    """Logits above 0 in the second chunk only: that chunk runs exactly, the
    others on the tensor cores, all on one state."""
    shape, hot, logit_max = ref.WKV_HOT_CHUNK_CASE
    inp = _rows(ref.wkv6_hot_inputs(_randn(np.random.default_rng(4)), *shape, hot, logit_max))
    got, exact = kernel_wkv(*inp)
    assert exact == [False, True, False, False]
    assert _err(got, _wkv64(*inp)) <= TOL_WKV / 10


def test_one_tf32_pass_misses():
    """One pass on every product loses each operand's low bits: ~3.9e-3."""
    inp = _inputs(5, 1, 4, 512, 64)
    assert _err(kernel_wkv(*inp, passes=1)[0], _wkv64(*inp)) > 30 * TOL_WKV
    assert _err(kernel_wkv(*inp, passes=3)[0], _wkv64(*inp)) <= TOL_WKV / 10


def test_unclamped_decays_overflow_the_factored_form_and_take_the_branch():
    """Logits up to 3 (log w down to -20 a step, as decode's unclamped step
    sees them): the half-chunk products underflow, their inverses overflow,
    and the factored form gives non-finite outputs; every chunk there takes
    the exact branch."""
    inp = _inputs(6, 2, 4, 256, 64, logit_max=3.0)
    got, _ = kernel_wkv(*inp, branch=False)
    assert not bool(torch.isfinite(got).all())
    got, exact = kernel_wkv(*inp)
    assert all(exact)
    assert _err(got, _wkv64(*inp)) <= TOL_WKV / 10


@pytest.mark.parametrize("draw", ["log w = -1 every step", "logits clamped to [-20, 0]"])
def test_model_clamp_never_takes_the_branch(draw):
    """The prefill clamps the decay logit to [-20, 0], so log w >= -1 a step
    and a half chunk's product is >= e^-32 ~ 2^-46, 2^50 above the
    threshold, even where every step sits at the clamp's edge."""
    r, k, v, w, u = _inputs(7, 2, 4, 512, 64)
    if draw == "log w = -1 every step":
        w = torch.full_like(w, float(np.exp(np.float32(-1.0))))
    else:
        logit = torch.from_numpy(np.random.default_rng(8).uniform(-6.0, 3.0, w.shape))
        w = torch.exp(-torch.exp(torch.clamp(logit, -20.0, 0.0))).float()
    for t0 in range(0, w.shape[1], C):
        _, _, b0, f63 = _factors(w[:, t0:t0 + C])
        assert float(torch.minimum(b0, f63).min()) >= MIN_HALF_DECAY * 2.0 ** 49
    got, exact = kernel_wkv(r, k, v, w, u)
    assert not any(exact)
    assert _err(got, _wkv64(r, k, v, w, u)) <= TOL_WKV / 10


def test_long_memory_draw_against_float64():
    """The model's init decays (memories of 50-3000 steps) and one-sign r,
    k, v: |out| ~ 1e4; the emulation holds to float64 as the recurrence in
    float32 does."""
    inp = _rows(ref.wkv6_long_memory_inputs(_randn(np.random.default_rng(9)), 1, 4, 512, 64))
    want = _wkv64(*inp)
    assert float(want.abs().max()) > 1e3
    got, exact = kernel_wkv(*inp)
    assert not any(exact)
    assert _err(got, want) <= TOL_WKV / 10


def test_running_products_beat_exp_of_cumsum():
    """At the prefill's draw the factors as running products of w err less
    than exp(+-cumsum(log w)), whose rounding grows with the sum's size."""
    inp = _inputs(10, 1, 8, 512, 64)
    want = _wkv64(*inp)
    products = _err(kernel_wkv(*inp)[0], want)
    logs = _err(kernel_wkv(*inp, factors=_log_factors)[0], want)
    assert products < logs / 1.5
