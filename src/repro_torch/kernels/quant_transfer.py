"""The compressed wire: quantize / dequantize kernels, packing and round trips.

The port of ``repro.kernels.quant_transfer``.  A float tensor is flattened,
zero-padded to a multiple of ``tile`` elements and viewed as ``(R, tile)``,
one scale tile per row; ``quantize_op`` turns it into the wire pytree
``{"q": (R, tile) int8 / float8_e4m3fn, "scale": (R, 1) float32}`` and
``dequantize_op`` rebuilds it.  int8 moves ``(1 + 4/tile) / 4`` of the
fp32 bytes.

For CUDA tensors the two row kernels are the hand-written
``csrc/quant_transfer.cu`` (:func:`quantize_tiles`, :func:`dequantize_tiles`,
each counted in ``LAUNCHES``); for CPU tensors they are the plain versions
``naive_quantize_tiles`` / ``naive_dequantize_tiles`` of ``ref.py``.  Both
are bitwise equal to ``repro``'s.

``roundtrip_ef`` is the error-feedback form used on the gradient buckets:
the residual of round t is added to round t+1's tensor before quantizing,
so the running sum of what was sent telescopes to the true sum up to one
residual.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import _QDIV, naive_dequantize_tiles, naive_quantize_tiles

QUANT_FORMATS = ("int8", "fp8")
#: power-of-two scale divisor per format (``ref.quant_scale``)
QDIV = dict(_QDIV)
_FMT_CODE = {"int8": 0, "fp8": 1}


def quant_dtype(fmt: str) -> torch.dtype:
    if fmt == "int8":
        return torch.int8
    if fmt == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantization format {fmt!r} "
                     f"(expected one of {QUANT_FORMATS})")


def wire_bits(fmt: str, tile: int) -> float:
    """Payload bits per element including the amortised per-tile scale."""
    quant_dtype(fmt)
    return 8.0 + 32.0 / tile


# ---------------------------------------------------------------------------
# Kernels (CUDA tensors only)
# ---------------------------------------------------------------------------


def quantize_tiles(x, *, fmt: str = "int8"):
    """x: (R, tile) float32 on the card -> (q (R, tile), scales (R, 1) f32)."""
    dtype = quant_dtype(fmt)
    _build.check_cuda("quantize_tiles", x)
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"quantize_tiles takes (R, tile) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    R, tile = x.shape
    q = torch.empty((R, tile), dtype=dtype, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    _build.LAUNCHES["quantize_tiles"] += 1
    with torch.cuda.device(x.device):
        _build.launch("quantize_tiles", _FMT_CODE[fmt], x.data_ptr(), q.data_ptr(),
                      scale.data_ptr(), R, tile, QDIV[fmt], _build.stream_of(x))
    return q, scale


def dequantize_tiles(q, scales):
    """(q (R, tile) int8/fp8, scales (R, 1) f32) on the card -> (R, tile) f32."""
    _build.check_cuda("dequantize_tiles", q, scales)
    fmt = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(q.dtype)
    if fmt is None or q.ndim != 2 or scales.shape != (q.shape[0], 1) \
            or scales.dtype != torch.float32:
        raise ValueError(f"dequantize_tiles: q {tuple(q.shape)} {q.dtype}, "
                         f"scales {tuple(scales.shape)} {scales.dtype}")
    q, scales = q.contiguous(), scales.contiguous()
    R, tile = q.shape
    out = torch.empty((R, tile), dtype=torch.float32, device=q.device)
    _build.LAUNCHES["dequantize_tiles"] += 1
    with torch.cuda.device(q.device):
        _build.launch("dequantize_tiles", _FMT_CODE[fmt], q.data_ptr(),
                      scales.data_ptr(), out.data_ptr(), R, tile, _build.stream_of(q))
    return out


def quantize_tiles_op(x2d, fmt: str = "int8"):
    """The row quantizer: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x2d.device.type == "cpu":
        return naive_quantize_tiles(x2d, fmt=fmt)
    return quantize_tiles(x2d, fmt=fmt)


def dequantize_tiles_op(q, scales):
    if q.device.type == "cpu":
        return naive_dequantize_tiles(q, scales)
    return dequantize_tiles(q, scales)


# ---------------------------------------------------------------------------
# Packing and the runtime entry points
# ---------------------------------------------------------------------------


def pack_tiles(x, tile: int):
    """Flatten and zero-pad ``x`` to the (R, tile) float32 wire layout (a
    view of ``x`` when it is contiguous float32 and fills whole tiles)."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    R = -(-n // tile)
    pad = R * tile - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(R, tile)


def unpack_tiles(x2d, shape, dtype):
    """Inverse of :func:`pack_tiles`: strip padding, restore shape/dtype."""
    n = 1
    for d in shape:
        n *= d
    return x2d.reshape(-1)[:n].reshape(shape).to(dtype)


def quantize_op(x, *, fmt: str = "int8", tile: int = 256):
    """Quantize an arbitrary-shape tensor into the wire pytree
    ``{"q": (R, tile), "scale": (R, 1) f32}``."""
    q, s = quantize_tiles_op(pack_tiles(x, tile), fmt)
    return {"q": q, "scale": s}


def dequantize_op(packed, shape, dtype, *, tile: int = 256):
    """Rebuild the tensor from the wire pytree."""
    return unpack_tiles(dequantize_tiles_op(packed["q"], packed["scale"]), shape, dtype)


def roundtrip(x, *, fmt: str = "int8", tile: int = 256):
    """quantize -> dequantize (what the receiver sees of ``x``)."""
    return dequantize_op(quantize_op(x, fmt=fmt, tile=tile), x.shape, x.dtype,
                         tile=tile)


def roundtrip_ef(x, err, *, fmt: str = "int8", tile: int = 256):
    """Error-feedback round trip: returns ``(x_hat, new_err)`` with
    ``sum_t x_hat_t = sum_t x_t + e_0 - e_T``."""
    comp = x.float() + err.float()
    x_hat = roundtrip(comp, fmt=fmt, tile=tile)
    return x_hat.to(x.dtype), (comp - x_hat).to(err.dtype)
