"""The order of work of ``csrc/decode_attention.cu``, emulated on the CPU.

The kernel serves a (b, KV head) group's G query heads in one CTA, stages
the keys in chunks of 32, each warp taking 4 keys of a chunk with its own
(m, l, acc) rescaled once per block, merges the warps' partials, divides
the row's valid range over the CTAs of a thread-block cluster (the splits)
and merges their partials through distributed shared memory, an empty
split weighted by exactly 0.  ``repro_torch.kernels.ref.decode_split_emulated``
does the same in float32; here it is held to ``repro``'s ``flash_decode``
(its Pallas kernel in interpret mode; no softcap there), ``repro``'s
reference and model ``decode_attention`` (which has the softcap), and the
port's plain version, at 2e-5 in fp32 (the attention tolerance of
``tests/test_kernels.py``; 2e-2 in bf16), over group sizes, split counts,
head dims, windows, softcaps, scalar and per-row lengths and ragged caches.
It also shows that empty splits contribute exactly nothing (16 splits of
which 15 are empty give the 1-split output bit for bit), and that the
merge's guard is needed: without it a row with an empty split is NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.models.attention import decode_attention as model_decode
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

CASES = {
    # id: (B, H, Hkv, S, D, window, softcap, lens (list: per row), splits, dtype)
    "G1-D64-split3": (2, 4, 4, 200, 64, None, None, [200, 77], 3, "float32"),
    "G2-D96-scalar-split8": (2, 8, 4, 300, 96, None, None, 250, 8, "float32"),
    "G8-D128-ragged-split16": (1, 16, 2, 520, 128, None, None, [517], 16, "float32"),
    "G8-D256-split1": (1, 8, 1, 160, 256, None, None, [130], 1, "float32"),
    "len1": (2, 8, 1, 64, 64, None, None, [1, 1], 8, "float32"),
    "whole-splits-empty": (2, 4, 2, 512, 64, None, None, [40, 500], 16, "float32"),
    "window-inside-one-split": (2, 4, 2, 512, 96, 20, None, [300, 450], 3, "float32"),
    "window-wider-than-row": (2, 8, 2, 256, 64, 1000, None, [100, 256], 8, "float32"),
    "softcap": (2, 8, 2, 192, 128, None, 20.0, [150, 33], 3, "float32"),
    "window-softcap-scalar": (2, 8, 8, 96, 96, 40, 30.0, 90, 16, "float32"),
    "bf16-G4-split8": (2, 8, 2, 300, 128, None, None, [290, 64], 8, "bfloat16"),
}


def _inputs(rng, B, H, Hkv, S, D, dtype="float32"):
    """q, k, v as numpy float32 (rounded to bf16 where asked, so the
    float32 copies hold exactly the bf16 values both sides see)."""
    arrs = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]
    return arrs


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _repro_outputs(q, k, v, lens, window, softcap, dtype):
    """(name, output as float32 numpy) of each ``repro`` reference that
    computes this case: the Pallas kernel in interpret mode and
    ``ref.naive_decode`` (no softcap), and the model's ``decode_attention``."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    jdt = getattr(jnp, dtype)
    qj = jnp.asarray(q).astype(jdt)
    kj, vj = (jnp.asarray(t).astype(jdt) for t in (k, v))
    per_row = isinstance(lens, list)
    lens_j = jnp.asarray(np.array(lens, np.int32)) if per_row else jnp.int32(lens)
    outs = [("model decode_attention",
             model_decode(qj, kj, vj, lens_j, scale=D ** -0.5, window=window, softcap=softcap))]
    if softcap is None:
        qf = qj.reshape(B * H, D)
        kf, vf = (t.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D) for t in (kj, vj))
        kv_lens = (jnp.asarray(np.repeat(np.array(lens, np.int32), Hkv)) if per_row
                   else jnp.int32(lens))
        outs.append(("pallas flash_decode (interpret)",
                     pallas_decode(qf, kf, vf, kv_lens, window=window, interpret=True)
                     .reshape(B, H, D)))
        G = H // Hkv
        rows = [jref.naive_decode(qf[b * H:(b + 1) * H], kf[b * Hkv:(b + 1) * Hkv],
                                  vf[b * Hkv:(b + 1) * Hkv],
                                  jnp.int32(lens[b] if per_row else lens), window=window)
                for b in range(B)]
        assert all(r.shape == (G * Hkv, D) for r in rows)
        outs.append(("repro.kernels.ref.naive_decode", jnp.stack(rows)))
    return [(name, np.asarray(o.astype(jnp.float32))) for name, o in outs]


def _check(got, q, k, v, lens, window, softcap, dtype):
    tol = TOL[dtype]
    qt, kt, vt = (_torch(a, dtype) for a in (q, k, v))
    clen = torch.tensor(lens, dtype=torch.int32) if isinstance(lens, list) else lens
    plain = ops.plain_flash_decode(qt, kt, vt, clen, window=window, softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=tol, rtol=tol,
                               err_msg="against the port's plain_flash_decode")
    for name, want in _repro_outputs(q, k, v, lens, window, softcap, dtype):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol,
                                   err_msg=f"against repro's {name}")


def _emulate(q, k, v, lens, window, softcap, splits, dtype="float32", guard=True):
    clen = torch.tensor(lens, dtype=torch.int32) if isinstance(lens, list) else lens
    return ref.decode_split_emulated(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), clen,
                                     splits=splits, window=window, softcap=softcap, guard=guard)


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_emulation_matches_references(case):
    B, H, Hkv, S, D, window, softcap, lens, splits, dtype = CASES[case]
    q, k, v = _inputs(np.random.default_rng(7), B, H, Hkv, S, D, dtype)
    got = _emulate(q, k, v, lens, window, softcap, splits, dtype)
    _check(got, q, k, v, lens, window, softcap, dtype)


@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("splits", [1, 3, 8, 16])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_split_sweep(G, splits, D):
    """Every group size and split count at each head-dim class, on a ragged
    cache (S = 300, not a multiple of the chunk) with per-row lengths."""
    B, Hkv, S, lens = 2, 2, 300, [300, 83]
    q, k, v = _inputs(np.random.default_rng(G * 1000 + splits * 10 + D), B, G * Hkv, Hkv, S, D)
    got = _emulate(q, k, v, lens, None, None, splits)
    _check(got, q, k, v, lens, None, None, "float32")


@pytest.mark.parametrize("lens,window", [([32, 5, 17], None), ([300, 1, 64], 32),
                                         (20, None)])
def test_empty_splits_contribute_nothing(lens, window):
    """At most 32 valid keys a row: with 16 splits, 15 are empty, and the
    output equals the 1-split output bit for bit."""
    q, k, v = _inputs(np.random.default_rng(3), 3, 8, 2, 320, 96)
    one = _emulate(q, k, v, lens, window, None, 1)
    sixteen = _emulate(q, k, v, lens, window, None, 16)
    assert torch.equal(one, sixteen)
    _check(sixteen, q, k, v, lens, window, None, "float32")


def test_merge_guard_is_needed():
    """Row 0 has no valid key (cache_len 0), so all its splits are empty:
    the guarded merge gives the kernel's 0 / max(l, 1e-30) = 0; a merge
    that weights an empty partial by exp(-inf - (-inf)) gives NaN there.
    Row 1 (150 keys) is the same either way with one split; over 8 splits,
    3 of them empty, the unguarded merge makes it NaN too."""
    q, k, v = _inputs(np.random.default_rng(4), 2, 8, 2, 200, 64)
    for splits in (1, 8):
        guarded = _emulate(q, k, v, [0, 150], None, None, splits)
        bare = _emulate(q, k, v, [0, 150], None, None, splits, guard=False)
        assert torch.equal(guarded[0], torch.zeros_like(guarded[0]))
        assert torch.isnan(bare[0]).all()
        if splits == 1:
            assert torch.equal(guarded[1], bare[1])
        else:
            assert torch.isnan(bare[1]).all()
        _check(guarded[1:], q[1:], k[1:], v[1:], [150], None, None, "float32")
