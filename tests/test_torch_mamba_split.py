"""The arithmetic of ``csrc/mamba_scan.cu``, emulated on the CPU.

The kernel takes each decay as ``ex2.approx.ftz(dt * (a log2 e))`` (one SFU
op, a few ulp from expf), splits a channel's N states across L = N / 4
lanes that each sum a partial readout over their four states by fused
multiply-adds, and adds the L partials when it stores y: (p0 + p2) +
(p1 + p3) at L = 4, p0 + p1 at L = 2.  Here the same order of work in
float32 (each fused multiply-add as a float64 product and sum rounded once
to float32) is held to ``repro``'s scan (its Pallas kernel in
interpret mode and its reference) at repro's tolerance, and, on a draw with
the model's own long memory, to float64 with every decay as it is and
pushed 2 ulp up or down (a model of ``ex2.approx``'s error, which a memory
of ~1000 steps compounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan
from repro_torch.kernels import ref
from test_torch_mamba import MAMBA_CASES, TOL_SCAN, _scan_inputs

#: a log2 e as the kernel rounds it (kLog2e, a float constant)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
KPER = 4          # states a lane owns


def _fma(a, b, c):
    """fmaf(a, b, c) in float32: a·b is exact in float64, the sum rounds
    once more before the cast (a double rounding in rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _nudge(e, ulps):
    """e (float32, in [0, 1]) moved ``ulps`` units in the last place."""
    if ulps == 0:
        return e
    return (e.view(torch.int32) + ulps).view(torch.float32).clamp_min(0.0)


def kernel_scan(dt, b, c, x, a, ulps=0):
    """The kernel's order of work on float32 CPU tensors: dt/x (B, S, d),
    b/c (B, S, N), a (d, N); returns y (B, S, d) float32."""
    B, S, d = dt.shape
    N = b.shape[-1]
    L = N // KPER
    a2 = a * LOG2E
    h = torch.zeros((B, d, N), dtype=torch.float32)
    ys = []
    for t in range(S):
        dtv = dt[:, t, :, None]
        dtx = dtv * x[:, t, :, None]
        e = torch.exp2(dtv * a2)
        e = _nudge(torch.where(e < 2.0 ** -126, torch.zeros_like(e), e), ulps)   # ftz
        h = _fma(h, e, dtx * b[:, t, None, :])
        hc = h.view(B, d, L, KPER)
        cc = c[:, t, None, :].expand(B, d, N).reshape(B, d, L, KPER)
        p = hc[..., 0] * cc[..., 0]
        for i in range(1, KPER):
            p = _fma(hc[..., i], cc[..., i], p)
        ys.append((p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3]) if L == 4
                  else p[..., 0] + p[..., 1])
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("reference", ["pallas_interpret", "repro_ref"])
@pytest.mark.parametrize("case", MAMBA_CASES)
def test_kernel_arithmetic_matches_repro(case, reference):
    B, S, d, N, chunk = case
    dt, b, c, x, a = _scan_inputs(np.random.default_rng(7), B, S, d, N)
    j_in = [jnp.asarray(v) for v in (dt, b, c, x, a)]
    if reference == "pallas_interpret":
        want = pallas_mamba_scan(*j_in, chunk=chunk, interpret=True)
    else:
        want = jref.naive_mamba_scan(*j_in)
    got = kernel_scan(*(torch.from_numpy(v) for v in (dt, b, c, x, a)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_SCAN, rtol=TOL_SCAN)


def _long_memory(N, seed):
    rng = np.random.default_rng(seed)

    def randn(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return ref.mamba_long_memory_inputs(randn, 1, 1024, 48, N)


@pytest.mark.parametrize("ulps", [0, 2, -2])
@pytest.mark.parametrize("N", [16, 8])
def test_long_memory_against_float64(N, ulps):
    """S = 1024, 48 channels, the model's init decays: within TOL_SCAN ·
    (1 + |y|) of float64, decays as computed or biased by 2 ulp."""
    inp = _long_memory(N, seed=21 + N)
    dt = inp[0]
    assert float(dt.min()) < 2e-3 and float(dt.max()) < 1.0   # memories of ~1000 steps
    want = ref.naive_mamba_scan(*(t.double() for t in inp))
    assert float(want.abs().max()) > 1.0                       # |y| ~ 1, not ~ 0
    got = kernel_scan(*inp, ulps=ulps).double()
    excess = float(((got - want).abs() - TOL_SCAN * (1 + want.abs())).max())
    assert excess <= 0.0


def test_long_memory_bias_shows():
    """The check above can fail: a decay biased by 64 ulp, ~32x the model of
    ex2.approx's error, leaves float64's tolerance over the same memory."""
    inp = _long_memory(16, seed=37)
    want = ref.naive_mamba_scan(*(t.double() for t in inp))
    got = kernel_scan(*inp, ulps=64).double()
    assert float(((got - want).abs() - TOL_SCAN * (1 + want.abs())).max()) > 0.0


def test_lane_split_matches_plain_float32():
    """At the long draw, the kernel's arithmetic with unbiased decays agrees
    with the plain float32 version (torch.exp, one sum over N) as the card
    check holds them: within TOL_SCAN · (1 + |plain|)."""
    inp = _long_memory(16, seed=5)
    got, want = kernel_scan(*inp), ref.naive_mamba_scan(*inp)
    assert float(((got - want).abs() - TOL_SCAN * (1 + want.abs())).max()) <= 0.0
