"""The port's compressed wire against ``repro``'s, bit for bit, on the CPU.

``repro``'s Pallas quantize/dequantize kernels run in interpret mode, beside
its ``kernels/ref.py`` oracles; the port's plain versions
(``repro_torch.kernels.ref``) and its packing and round trips
(``repro_torch.kernels.quant_transfer``) run on CPU tensors.  The same
float32 inputs, made with numpy, go to both.  Every comparison is bitwise:
int8 payloads as integers, fp8 payloads as their bytes, scales and
reconstructions as float32 bit patterns.  Inputs cover the cases that
decide rounding: all-zero rows, exact halves of the int8 step (half to
even), fp8 subnormals and the ties between them, and random data at
several scales.  The CUDA kernels are held against the same plain versions
on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import quant_transfer as jqt
from repro.kernels import ref as jref
from repro_torch.kernels import quant_transfer as tqt
from repro_torch.kernels import ref as tref


def wire_rows(rng, R, tile, fmt, scales=(1e-3, 1.0, 50.0)):
    """(R, tile) float32 rows: random data at several scales, and (when R
    allows) an all-zero row, a row of exact int8 halves, a row of fp8
    subnormals and their ties, each scaled so that its scale is 1.0."""
    x = rng.standard_normal((R, tile)) * rng.choice(scales, (R, 1))
    x = x.astype(np.float32)
    top = np.float32(128.0 if fmt == "int8" else 256.0)
    special = [
        np.zeros(tile, np.float32),
        (np.arange(tile) % 64 - 32 + 0.5).astype(np.float32),
        (np.float32(2.0 ** -10) * (np.arange(tile) % 9)
         * np.where(np.arange(tile) % 2, 1, -1)).astype(np.float32),
    ]
    for r, row in enumerate(special[:R]):
        x[r] = row
        if r and tile > 1:
            x[r, 0] = top
    return x


def _bits(a) -> np.ndarray:
    """An array's bit pattern as unsigned integers (jax or torch, any dtype)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _assert_same_wire(fmt, x):
    qj, sj = jref.naive_quantize_tiles(jnp.asarray(x), fmt=fmt)
    qk, sk = jqt.quantize_tiles(jnp.asarray(x), fmt=fmt, interpret=True)
    qt, stt = tref.naive_quantize_tiles(torch.from_numpy(x), fmt=fmt)
    assert qt.dtype == tqt.quant_dtype(fmt)
    for a in (qj, qk):
        np.testing.assert_array_equal(_bits(qt), _bits(a))
    for a in (sj, sk):
        np.testing.assert_array_equal(_bits(stt), _bits(a))
    dj = jref.naive_dequantize_tiles(qj, sj)
    dk = jqt.dequantize_tiles(qk, sk, interpret=True)
    dt = tref.naive_dequantize_tiles(qt, stt)
    for a in (dj, dk):
        np.testing.assert_array_equal(_bits(dt), _bits(a))


@pytest.mark.parametrize("fmt", tqt.QUANT_FORMATS)
@pytest.mark.parametrize("R,tile", [(16, 256), (19, 64), (3, 32), (8, 384)])
def test_quantize_bitwise_vs_pallas_and_ref(fmt, R, tile):
    _assert_same_wire(fmt, wire_rows(np.random.default_rng(R * tile), R, tile, fmt))


@settings(max_examples=25, deadline=None)
@given(R=st.integers(1, 24), tile=st.sampled_from([8, 32, 64, 256]),
       fmt=st.sampled_from(tqt.QUANT_FORMATS),
       scale=st.sampled_from([1e-6, 1e-2, 1.0, 1e3]), seed=st.integers(0, 2 ** 16))
def test_quantize_bitwise_property(R, tile, fmt, scale, seed):
    x = wire_rows(np.random.default_rng(seed), R, tile, fmt, scales=(scale,))
    qj, sj = jref.naive_quantize_tiles(jnp.asarray(x), fmt=fmt)
    qt, stt = tref.naive_quantize_tiles(torch.from_numpy(x), fmt=fmt)
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(_bits(stt), _bits(sj))
    np.testing.assert_array_equal(_bits(tref.naive_dequantize_tiles(qt, stt)),
                                  _bits(jref.naive_dequantize_tiles(qj, sj)))


def test_round_half_to_even_and_clip():
    """int8 rounds x.5 to the even neighbour and clips to +-127, as jnp.round
    does (roundf would send 0.5 to 1 and -2.5 to -3)."""
    x = np.array([[128.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.5]], np.float32)
    q, s = tref.naive_quantize_tiles(torch.from_numpy(x), fmt="int8")
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126, 127]]


@pytest.mark.parametrize("fmt", tqt.QUANT_FORMATS)
def test_scale_is_exact_power_of_two_division(fmt):
    assert tqt.QDIV == dict(jqt.QDIV)
    amax = torch.tensor([[3.7], [0.0]], dtype=torch.float32)
    s = tref.quant_scale(amax, fmt)
    assert float(s[0, 0]) == float(np.float32(3.7)) / tqt.QDIV[fmt]
    assert float(s[1, 0]) == 1.0


@pytest.mark.parametrize("shape", [(5, 7, 33), (256,), (4, 64), (1, 1)])
def test_pack_unpack_match_repro(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    pj = jqt.pack_tiles(jnp.asarray(x), 64)
    pt = tqt.pack_tiles(torch.from_numpy(x), 64)
    np.testing.assert_array_equal(_bits(pt), _bits(pj))
    back = tqt.unpack_tiles(pt, shape, torch.float32)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("fmt", tqt.QUANT_FORMATS)
@pytest.mark.parametrize("tile", [64, 256])
def test_roundtrip_and_ef_bitwise(fmt, tile):
    rng = np.random.default_rng(tile)
    x = (rng.standard_normal((3, 5, 77)) * 3).astype(np.float32)
    err = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    packed = tqt.quantize_op(torch.from_numpy(x), fmt=fmt, tile=tile)
    packed_j = jqt.quantize_op(jnp.asarray(x), fmt=fmt, tile=tile)
    assert set(packed) == set(packed_j) == {"q", "scale"}
    for k in packed:
        np.testing.assert_array_equal(_bits(packed[k]), _bits(packed_j[k]))
    np.testing.assert_array_equal(
        _bits(tqt.roundtrip(torch.from_numpy(x), fmt=fmt, tile=tile)),
        _bits(jqt.roundtrip(jnp.asarray(x), fmt=fmt, tile=tile)))
    xh, e2 = tqt.roundtrip_ef(torch.from_numpy(x), torch.from_numpy(err), fmt=fmt, tile=tile)
    xhj, e2j = jqt.roundtrip_ef(jnp.asarray(x), jnp.asarray(err), fmt=fmt, tile=tile)
    np.testing.assert_array_equal(_bits(xh), _bits(xhj))
    np.testing.assert_array_equal(_bits(e2), _bits(e2j))


def test_error_feedback_exact_sum_identity():
    """sum_t x_hat_t + e_T == sum_t x_t + e_0, to fp accuracy (the identity of
    tests/test_quant_transfer.py), and the port's stream is repro's."""
    x = (np.random.default_rng(4).standard_normal(100)).astype(np.float32)
    err, tot = torch.zeros(100), torch.zeros(100)
    err_j, tot_j = jnp.zeros(100), jnp.zeros(100)
    for _ in range(5):
        xh, err = tqt.roundtrip_ef(torch.from_numpy(x), err, fmt="int8", tile=32)
        xhj, err_j = jqt.roundtrip_ef(jnp.asarray(x), err_j, fmt="int8", tile=32)
        tot, tot_j = tot + xh, tot_j + xhj
    np.testing.assert_allclose((tot + err).numpy(), x * 5, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(_bits(tot), _bits(tot_j))
    np.testing.assert_array_equal(_bits(err), _bits(err_j))


def test_zero_input_roundtrips_exactly():
    for fmt in tqt.QUANT_FORMATS:
        z = tqt.roundtrip(torch.zeros(3, 5), fmt=fmt, tile=16)
        assert torch.equal(z, torch.zeros(3, 5))


def test_wire_bits_and_unknown_format():
    assert tqt.wire_bits("int8", 256) == jqt.wire_bits("int8", 256) == pytest.approx(8.125)
    with pytest.raises(ValueError):
        tqt.quant_dtype("int4")
    with pytest.raises(ValueError):
        tref.naive_quantize_tiles(torch.ones(2, 4), fmt="int4")
    with pytest.raises(ValueError):
        tqt.wire_bits("int4", 256)


def test_cpu_dispatch_runs_the_plain_versions():
    """On CPU tensors the row ops are the plain versions and launch nothing."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    x = torch.from_numpy(wire_rows(np.random.default_rng(2), 4, 64, "int8"))
    q, s = ops.quantize_tiles_op(x, "int8")
    qr, sr = tref.naive_quantize_tiles(x, fmt="int8")
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(ops.dequantize_tiles_op(q, s), tref.naive_dequantize_tiles(qr, sr))
    assert ops.LAUNCHES == before
