"""Flash attention on the card: forward and backward kernels, and the
``autograd.Function`` that joins them.

Python side of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
(which carry the design notes), the port of
``repro.kernels.flash_attention.flash_attention``.  The kernels read q/k/v
in the model layout ``(B, S, H, D)`` by strides and mask the ragged tail of
S instead of padding it.  Under autograd the forward also writes each row's
logsumexp, and the backward recomputes the probabilities from it.
"""

from __future__ import annotations

import functools

import torch

from . import _build


def _check(name, q, k, v):
    code = _build.dtype_code(name, q, k, v)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D > 256 or any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: head_dim must be <= 256 with unit stride")
    return code


#: the kernels' routes, by the code their C entries ``flash_attention_route``
#: and ``flash_attention_bwd_route`` return: SIMT, the tensor cores at
#: head_dim <= 128, two-CTA clusters on them at 128 < head_dim <= 256
ROUTE_NAMES = ("simt", "tc", "tc_cluster")
#: calls of :func:`flash_attention` by route since the last
#: :func:`reset_fwd_routes` (kept apart from ``_build.LAUNCHES``, which counts
#: one launch a call whatever its route)
FWD_ROUTES = dict.fromkeys(ROUTE_NAMES, 0)


def reset_fwd_routes() -> None:
    for name in FWD_ROUTES:
        FWD_ROUTES[name] = 0


def flash_attention_fwd_route(q, k, v) -> str:
    """The route :func:`flash_attention` takes for these operands, as the C
    side decides it (by head_dim alone: the tensor-core routes read rows of
    any alignment): ``"tc"`` (the tensor cores, head_dim <= 128),
    ``"tc_cluster"`` (two-CTA clusters splitting head_dim, 128 < head_dim <=
    256), both for head_dims that are multiples of 8, else ``"simt"``.  CUDA
    tensors only."""
    _check("flash_attention_fwd_route", q, k, v)
    return _fwd_route(q.shape[3])


@functools.cache
def _fwd_route(D: int) -> str:
    """The forward's route at head_dim D, asked of the library once a D:
    it depends on D alone."""
    return ROUTE_NAMES[_build.load("flash_attention").flash_attention_route(D)]


def flash_attention(q, k, v, *, scale: float | None = None, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    return_lse: bool = False):
    """q: (B, S, H, D); k/v: (B, S, Hkv, D) -> (B, S, H, D) contiguous
    (and, with ``return_lse``, the (B, H, S) float32 logsumexp of each row's
    scaled scores).  q head h reads kv head h // (H // Hkv).  CUDA tensors
    only; head_dim <= 256: the tensor cores to 128, two-CTA clusters on them
    above (each CTA on half of head_dim), at head_dims that are multiples of
    8; the SIMT kernel otherwise (:func:`flash_attention_fwd_route`)."""
    code = _check("flash_attention", q, k, v)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    FWD_ROUTES[_fwd_route(D)] += 1
    _build.LAUNCHES["flash_attention"] += 1
    with torch.cuda.device(q.device):
        _build.launch(
            "flash_attention", code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, S, H, Hkv, D, _build.strides3(q), _build.strides3(k),
            _build.strides3(v), D ** -0.5 if scale is None else scale, int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _build.stream_of(q))
    return (out, lse) if return_lse else out


#: calls of :func:`flash_attention_bwd` by route since the last
#: :func:`reset_bwd_routes`, as :data:`FWD_ROUTES`
BWD_ROUTES = dict.fromkeys(ROUTE_NAMES, 0)


def reset_bwd_routes() -> None:
    for name in BWD_ROUTES:
        BWD_ROUTES[name] = 0


def bwd_kv_split(B: int, S: int, H: int, Hkv: int, n_sm: int) -> int:
    """g: the parts into which the head_dim-256 route's dK/dV pass splits
    each GQA group's H // Hkv q heads, one two-CTA cluster a part.  The
    least divisor g of the group for which the pass's 2·ceil(S/64)·Hkv·B·g
    blocks reach ``n_sm`` (a block an SM), else the whole group; 1 where
    the pass fills the card already (gemma2's training micro-batch: 512
    clusters)."""
    G = H // Hkv
    blocks = 2 * -(-S // 64) * Hkv * B
    for g in range(1, G + 1):
        if G % g == 0 and blocks * g >= n_sm:
            return g
    return G


def bwd_parts(B: int, S: int, H: int, Hkv: int, D: int, route: str, n_sm: int, device):
    """(g, scratch) as :func:`flash_attention_bwd` passes them to its
    kernel: :func:`bwd_kv_split`'s g on the ``tc_cluster`` route (1 on the
    others, which ignore it), and at g > 1 an uninitialised float32 scratch
    for the dK/dV parts, (2, g, B, S, Hkv, D) flat, on ``device`` (else
    None)."""
    g = bwd_kv_split(B, S, H, Hkv, n_sm) if route == "tc_cluster" else 1
    if g == 1:
        return 1, None
    return g, torch.empty(2 * g * B * S * Hkv * D, dtype=torch.float32, device=device)


def flash_attention_bwd_route(q, k, v, dout) -> str:
    """The route :func:`flash_attention_bwd` takes for these operands, as
    the C side decides it: ``"tc"`` (the tensor cores, head_dim <= 128),
    ``"tc_cluster"`` (two-CTA clusters, 128 < head_dim <= 256), both for
    head_dims that are multiples of 8 and 4-element aligned rows, else
    ``"simt"``.  CUDA tensors only."""
    code = _check("flash_attention_bwd_route", q, k, v)
    _build.dtype_code("flash_attention_bwd_route", q, dout)
    lib = _build.load("flash_attention_bwd")
    r = lib.flash_attention_bwd_route(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), q.shape[3],
        _build.strides3(q), _build.strides3(k), _build.strides3(v), _build.strides3(dout))
    return ROUTE_NAMES[r]


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale: float | None = None,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` for the cotangent ``dout``,
    from the forward's ``out`` and ``lse`` (the forward called with the same
    ``scale``, ``causal``, ``window`` and ``softcap``).  dk/dv are summed
    over the q heads of each GQA group.  CUDA tensors only; head_dim <= 256:
    the tensor cores to 128, two-CTA clusters on them above (each CTA on
    half of head_dim; the dK/dV pass split over :func:`bwd_kv_split`'s parts
    of the GQA group, their fp32 partials summed in order from the scratch
    :func:`bwd_parts` allocates), at head_dims that are multiples of 8 and
    aligned rows; the SIMT kernels otherwise
    (:func:`flash_attention_bwd_route`)."""
    code = _check("flash_attention_bwd", q, k, v)
    _build.dtype_code("flash_attention_bwd", q, out, dout)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, H, S) \
            or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: out/dout must match q and lse "
                         "be (B, H, S) float32")
    out, lse = out.contiguous(), lse.contiguous()
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dvec = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    route = flash_attention_bwd_route(q, k, v, dout)
    g, parts = bwd_parts(B, S, H, Hkv, D, route,
                         torch.cuda.get_device_properties(q.device).multi_processor_count,
                         q.device)
    BWD_ROUTES[route] += 1
    _build.LAUNCHES["flash_attention_bwd"] += 1
    with torch.cuda.device(q.device):
        _build.launch(
            "flash_attention_bwd", code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if parts is None else parts.data_ptr(), g, B, S, H, Hkv, D,
            _build.strides3(q), _build.strides3(k), _build.strides3(v),
            _build.strides3(dout), D ** -0.5 if scale is None else scale,
            int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), _build.stream_of(q))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Forward: the flash kernel, writing the logsumexp too; backward: the
    backward kernel, with the same scale, mask and softcap."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out, lse = flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (scale, causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        scale, causal, window, softcap = ctx.cfg
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, scale=scale,
                                         causal=causal, window=window, softcap=softcap)
        return dq, dk, dv, None, None, None, None
