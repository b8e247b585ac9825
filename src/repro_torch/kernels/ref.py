"""Plain PyTorch versions of the ported kernels (the correctness ground truth).

Same layouts and arithmetic as ``repro.kernels.ref``.  They run on any
device: the kernel wrappers in :mod:`repro_torch.kernels.ops` take them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  The backward versions (``naive_*_bwd``) are autograd of the
forward ones; ``repro`` has no backward kernel (it differentiates its XLA
paths), so they have no counterpart there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _softcap(s, softcap):
    return s if softcap is None else softcap * torch.tanh(s / softcap)


def naive_attention(q, k, v, *, scale=None, causal=True, window=None,
                    softcap=None):
    """q: (BH, S, D); k/v: (BHkv, S, D).  Full-softmax reference; q row i
    reads kv row i // (BH // BHkv)."""
    BH, S, D = q.shape
    G = BH // k.shape[0]
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(G, dim=0).float()
    vv = v.repeat_interleave(G, dim=0).float()
    s = _softcap(torch.einsum("bqd,bkd->bqk", q.float(), kk) * scale, softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)


def naive_decode(q, k_cache, v_cache, cache_len, *, scale=None, window=None,
                 softcap=None):
    """q: (BH, D); caches (BHkv, S, D); one-token attention.

    ``cache_len`` is an int, a 0-d tensor, or a (BHkv,) tensor of per-kv-row
    lengths (as ``repro``'s Pallas kernel takes them); q row i uses the
    length of kv row i // G.  ``softcap`` is the tanh logit cap that
    ``repro.models.attention.decode_attention`` applies.
    """
    BH, D = q.shape
    BHkv, S, _ = k_cache.shape
    G = BH // BHkv
    if scale is None:
        scale = D ** -0.5
    kk = k_cache.repeat_interleave(G, dim=0).float()
    vv = v_cache.repeat_interleave(G, dim=0).float()
    s = _softcap(torch.einsum("bd,bkd->bk", q.float(), kk) * scale, softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.ndim == 1:
        clen = clen.repeat_interleave(G)[:, None]
    mask = pos < clen
    if window is not None:
        mask &= pos >= clen - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", p, vv).to(q.dtype)


def naive_latent_decode(q_lat, q_rope, c_kv, k_rope, cache_len, *, scale):
    """MLA's latent decode attention (``repro.models.attention.mla_decode``'s
    einsums): MQA over one shared key ``c_kv ‖ k_rope`` with values
    ``c_kv``, from the absorbed query ``q_lat ‖ q_rope``.

    q_lat: (B, H, R); q_rope: (B, H, Dr); c_kv: (B, S, R); k_rope: (B, S,
    Dr); ``cache_len`` an int or a (B,) tensor of per-row lengths.  Returns
    (B, H, R) float32, in ``repro``'s order: both score sums, then the
    scale, the masked softmax's exponentials, P c_kv, and the division.
    """
    S = c_kv.shape[1]
    ckv = c_kv.float()
    s = torch.einsum("bhr,bkr->bhk", q_lat.float(), ckv)
    s = s + torch.einsum("bhd,bkd->bhk", q_rope.float(), k_rope.float())
    s = s * scale
    pos = torch.arange(S, device=s.device)
    clen = torch.as_tensor(cache_len, device=s.device)
    mask = (pos[None, :] < clen[:, None])[:, None] if clen.ndim == 1 else pos < clen
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhk,bkr->bhr", p, ckv)
    return o / torch.clamp(p.sum(dim=-1), min=1e-37)[..., None]


def decode_chunk(G: int, D: int, elem: int) -> int:
    """Keys a stage of ``csrc/decode_attention.cu`` holds for a group of G
    query heads at head_dim D in ``elem``-byte values: 64 for 1-2 heads at
    rows of the head-dim class (64, 128 or 256) up to 512 bytes, else 32."""
    dmax = 64 if D <= 64 else 128 if D <= 128 else 256
    return 64 if G <= 2 and dmax * elem <= 512 else 32


def decode_split_emulated(q, k_cache, v_cache, cache_len, *, splits: int,
                          scale=None, window=None, softcap=None, guard=True):
    """``csrc/decode_attention.cu``'s order of work, in float32 on the CPU.

    q: (B, H, D); caches (B, S, Hkv, D); cache_len int or (B,).  For each
    (b, KV head) the group's G query heads go together.  The row's valid
    range [lo, len) is divided over ``splits`` (the CTAs of a cluster) in
    even whole chunks (:func:`decode_chunk` keys).  In a split, each of 8
    warps takes an eighth of every chunk and keeps its own online softmax per
    head: the block's scores (softcapped, keys past the range at -inf), one
    max and one exponent a score, (m, l, acc) rescaled once a block.  The
    warps' partials are merged into the split's, and the splits' into the
    output, each with weights exp(m_r - m_all), exactly 0 for an empty warp
    or split when ``guard`` (without it, an empty one makes its row NaN), l
    and the output as running fused sums in rank order, then times
    1 / max(l, 1e-30).  Sums over head_dim and a block's keys run in torch's
    order, not lane by lane.
    """
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G, W = H // Hkv, 8
    C = decode_chunk(G, D, q.element_size())
    KW = C // W
    if scale is None:
        scale = D ** -0.5
    qs = q.float().reshape(B, Hkv, G, D) * scale
    kf, vf = (t.float().transpose(1, 2) for t in (k_cache, v_cache))   # (B, Hkv, S, D)
    lens = torch.as_tensor(cache_len, dtype=torch.int64).expand(B).clamp(max=S)
    lo = (lens - window).clamp(min=0) if window is not None and window > 0 else lens * 0
    n = (lens - lo).clamp(min=0)
    per = ((n + splits - 1) // splits + C - 1) // C * C
    neg_inf = torch.tensor(-math.inf)

    def merge(ms, ls, accs):
        """Rank-ordered merge of partials stacked on dim 0."""
        m_all = ms[0]
        for m in ms[1:]:
            m_all = torch.maximum(m_all, m)
        l_all, o = torch.zeros_like(ls[0]), torch.zeros_like(accs[0])
        for m, l, acc in zip(ms, ls, accs):
            w = torch.exp(m - m_all)
            if guard:
                w = torch.where(m == -math.inf, 0.0, w)
            l_all = w * l + l_all
            o = w[..., None] * acc + o
        return m_all, l_all, o

    parts = []
    for r in range(splits):
        k0 = lo + r * per
        k1 = torch.minimum(lens, k0 + per)
        nch = ((k1 - k0).clamp(min=0) + C - 1) // C
        m = torch.full((W, B, Hkv, G), -math.inf)
        l = torch.zeros((W, B, Hkv, G))
        acc = torch.zeros((W, B, Hkv, G, D))
        for c in range(int(nch.max()) if B else 0):
            active = (c < nch)[None, :, None, None]
            key = k0[:, None] + c * C + torch.arange(C)            # (B, C)
            valid = key < k1[:, None]
            idx = torch.where(valid, key, 0).clamp(0, max(S - 1, 0))[:, None, :, None]
            idx = idx.expand(B, Hkv, C, D)
            rows = valid[:, None, :, None]
            kc = torch.where(rows, torch.gather(kf, 2, idx), 0.0)   # rows past the range: 0
            vc = torch.where(rows, torch.gather(vf, 2, idx), 0.0)
            s = _softcap(torch.einsum("bhgd,bhkd->bhgk", qs, kc), softcap)
            s = torch.where(valid[:, None, None, :], s, neg_inf)
            s = s.reshape(B, Hkv, G, W, KW).permute(3, 0, 1, 2, 4)   # (W, B, Hkv, G, KW)
            m_new = torch.maximum(m, s.amax(-1))
            seen = m_new != -math.inf                               # a valid key so far
            corr = torch.where(seen, torch.exp(m - m_new), 1.0)
            pr = torch.where(seen[..., None], torch.exp(s - m_new[..., None]), 0.0)
            l_new = l * corr + pr.sum(-1)
            pv = torch.einsum("wbhgk,wbhkd->wbhgd", pr,
                              vc.reshape(B, Hkv, W, KW, D).permute(2, 0, 1, 3, 4))
            acc_new = acc * corr[..., None] + pv
            m = torch.where(active, m_new, m)
            l = torch.where(active, l_new, l)
            acc = torch.where(active[..., None], acc_new, acc)
        parts.append(merge(m, l, acc))                              # the warps' merge

    _, l_all, o = merge(*(torch.stack(t) for t in zip(*parts)))     # the cluster's merge
    out = o * (1.0 / torch.clamp(l_all, min=1e-30))[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def naive_swiglu(x, wg, wu, wd, act: str = "silu"):
    """x: (T, D); wg/wu: (D, F); wd: (F, D) -> (T, D), f32 accumulation."""
    xf = x.float()
    g = xf @ wg.float()
    uu = xf @ wu.float()
    if act == "silu":
        h = F.silu(g) * uu
    elif act == "gelu_tanh":
        h = F.gelu(g, approximate="tanh") * uu
    else:
        raise ValueError(f"fused_swiglu has no activation {act!r}")
    return (h @ wd.float()).to(x.dtype)


def naive_attention_bwd(q, k, v, dout, **kw):
    """(dq, dk, dv) of :func:`naive_attention` for the cotangent ``dout``."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = naive_attention(qq, kk, vv, **kw)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def naive_swiglu_bwd(x, wg, wu, wd, dout, act: str = "silu"):
    """(dx, dwg, dwu, dwd) of :func:`naive_swiglu` for the cotangent ``dout``."""
    with torch.enable_grad():
        ts = tuple(t.detach().requires_grad_(True) for t in (x, wg, wu, wd))
        out = naive_swiglu(*ts, act)
        return torch.autograd.grad(out, ts, dout)


def naive_swiglu_act_bwd(g, u, dh, act: str = "silu"):
    """The elementwise part of the SwiGLU backward, in float32 (or, given
    float64, in float64: a reference to the float32 versions): from the
    gate and up products g = x·Wg, u = x·Wu and the hidden cotangent dh,
    returns (dg, du, h) with h = act(g)·u, du = dh·act(g) and
    dg = dh·u·act'(g)."""
    if g.dtype != torch.float64:
        g, u, dh = g.float(), u.float(), dh.float()
    if act == "silu":
        s = torch.sigmoid(g)
        a = g * s
        da = s * (1.0 + g * (1.0 - s))
    elif act == "gelu_tanh":
        c = 0.7978845608028654                       # sqrt(2 / pi)
        t = torch.tanh(c * (g + 0.044715 * g * g * g))
        a = 0.5 * g * (1.0 + t)
        da = 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * g * g)
    else:
        raise ValueError(f"fused_swiglu has no activation {act!r}")
    return dh * u * da, dh * a, a * u


def naive_mamba_scan(dt, b, c, x, a):
    """Step-by-step selective scan, from h = 0.  dt/x: (B, S, d); b/c:
    (B, S, N); a: (d, N) = -exp(A_log); all float32 (or all float64, for a
    reference to the float32 versions).  Returns y (B, S, d) with
    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t and y_t = h_t . c_t."""
    B, S, d = dt.shape
    h = torch.zeros((B, d, a.shape[1]), dtype=dt.dtype, device=dt.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t]
        h = h * torch.exp(dt_t[:, :, None] * a) \
            + (dt_t * x[:, t])[:, :, None] * b[:, t, None, :]
        ys.append(torch.sum(h * c[:, t, None, :], dim=2))
    return torch.stack(ys, dim=1)


#: (B, S, d, N) shapes at which the scan kernel is held against
#: :func:`naive_mamba_scan` on the card, each with what it exercises.
MAMBA_EDGE_CASES = (
    ((2, 1024, 16384, 16), "the served Jamba prefill's shape"),
    ((2, 256, 512, 8), "d_state 8"),
    ((2, 200, 1000, 16), "d not a multiple of the 64-channel block"),
    ((3, 1, 256, 16), "S = 1"),
    ((2, 100, 384, 8), "S not a multiple of the 8-step tile at d_state 8"),
    ((1, 130, 640, 16), "B = 1, a 2-step last tile"),
    ((1, 77, 333, 8), "d not a multiple of 4 (4-byte copies), S odd"),
    ((2, 45, 130, 16), "d not a multiple of 4 at d_state 16, 2 channels in the last block"),
)

#: (B, S, d, N) of the long-memory draw (:func:`mamba_long_memory_inputs`)
#: that the scan kernel is held to on the card: the Jamba prefill's shape.
MAMBA_LONG_MEMORY_SHAPE = (2, 1024, 16384, 16)


def mamba_scan_inputs(randn, B, S, d, N):
    """Scan inputs drawn as ``repro``'s scan tests draw them: dt =
    softplus(N(0, 0.5^2)), b/c/x ~ N(0, 0.5^2), a = -exp(N(0, 0.2^2)).
    ``randn(shape)`` gives float32 N(0, 1) tensors (from a seeded generator
    on the device the inputs should lie on)."""
    dt = F.softplus(0.5 * randn((B, S, d)))
    b, c, x = (0.5 * randn(s) for s in ((B, S, N), (B, S, N), (B, S, d)))
    return dt, b, c, x, -torch.exp(0.2 * randn((d, N)))


def mamba_long_memory_inputs(randn, B, S, d, N):
    """Scan inputs with the model's own init decays (``models/ssm.py``
    ``init_mamba``): a = -(1 .. N) in every channel and dt = softplus(dt_bias
    + 0.5 z), dt_bias the inverse softplus of a per-channel log-uniform draw
    in [1e-3, 1e-1] and z ~ N(0, 1) per step (the input-dependent part), so
    the slowest states decay by ~exp(-1e-3) a step and remember ~1000 steps.
    x, b and c are 1 + 0.25 z: mostly one-sign, so h sums coherently over
    that memory, |y| reaches several units, and an error of the decay that
    compounds over the memory shows in y.  ``randn(shape)`` gives float32 N(0, 1)
    tensors; the uniform draw is the normal CDF of such a draw."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.exp(lo + (hi - lo) * torch.special.ndtr(randn((d,))))
    dt = F.softplus(torch.log(torch.expm1(u)) + 0.5 * randn((B, S, d)))
    b, c, x = (1.0 + 0.25 * randn(s) for s in ((B, S, N), (B, S, N), (B, S, d)))
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=dt.device).expand(d, N)
    return dt, b, c, x, a.contiguous()


def naive_wkv6(r, k, v, w, u):
    """Step-by-step WKV-6 recurrence from S = 0.  r/k/v/w: (BH, S, d) with w
    the per-step decay; u: (BH, d).  Returns (BH, S, d) float32 (float64
    for float64 inputs, a reference to the float32 versions) with
    out_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t) and S_t = diag(w_t) S_{t-1} + k_tᵀ v_t."""
    dtype = torch.promote_types(r.dtype, torch.float32)
    r, k, v, w, u = (t.to(dtype) for t in (r, k, v, w, u))
    BH, S, d = r.shape
    s = torch.zeros((BH, d, d), dtype=dtype, device=r.device)
    outs = []
    for t in range(S):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bi,bij->bj", r[:, t], s + u[:, :, None] * kv))
        s = s * w[:, t, :, None] + kv
    return torch.stack(outs, dim=1)


#: ((B, H, S, d), largest decay logit, what it exercises): the shapes at
#: which the WKV kernel is held against :func:`naive_wkv6` on the card.
WKV_EDGE_CASES = (
    ((8, 64, 512, 64), 0.0, "the served rwkv6-7b prefill's shape"),
    ((3, 4, 1, 64), 0.0, "S = 1"),
    ((2, 4, 100, 64), 0.0, "S not a multiple of the 16-step staging run"),
    ((2, 4, 64, 32), 0.0, "d = 32, the smoke config's head size"),
    ((1, 3, 77, 64), 0.0, "B = 1"),
    ((2, 4, 256, 64), 3.0, "logits up to 3, decays as decode's unclamped step sees them"),
)


def wkv6_inputs(randn, B, H, S, d, logit_max=0.0):
    """WKV inputs as ``rwkv_time_mix`` hands them to the kernel: r, k, v, w
    (B, H, S, d) head views of (B, S, H·d) projections, and u (H, d).  Drawn
    as ``repro``'s kernel tests draw them: r/k/v ~ N(0, 0.5^2), u ~
    N(0, 0.3^2), w = exp(-exp(logit)) with the logit uniform in [-6,
    ``logit_max``].  ``randn(shape)`` gives float32 N(0, 1) tensors (from a
    seeded generator on the device the inputs should lie on); the uniform
    draws are the normal CDF of such draws."""
    def heads(t):
        return t.view(B, S, H, d).transpose(1, 2)

    r, k, v = (heads(0.5 * randn((B, S, H * d))) for _ in range(3))
    logit = -6.0 + (logit_max + 6.0) * torch.special.ndtr(randn((B, S, H * d)))
    return r, k, v, heads(torch.exp(-torch.exp(logit))), 0.3 * randn((H, d))


#: ((B, H, S, d), hot steps, largest logit there): logits above 0 in one
#: 64-step chunk only, so that the WKV kernel's exact chunks and its
#: tensor-core chunks follow each other on one state (:func:`wkv6_hot_inputs`)
WKV_HOT_CHUNK_CASE = ((2, 4, 256, 64), (64, 128), 3.0)
#: (B, H, S, d) of the long-memory draw (:func:`wkv6_long_memory_inputs`)
#: that the WKV kernel is held to on the card: the rwkv6-7b prefill's shape
WKV_LONG_MEMORY_SHAPE = (8, 64, 512, 64)


def wkv6_hot_inputs(randn, B, H, S, d, hot, logit_max):
    """:func:`wkv6_inputs` with the decay logit uniform in [-6, ``logit_max``]
    at steps ``hot[0]`` .. ``hot[1] - 1`` and in [-6, 0] elsewhere."""
    r, k, v, w, u = wkv6_inputs(randn, B, H, S, d)
    logit = -6.0 + (logit_max + 6.0) * torch.special.ndtr(randn((B, H, S, d)))
    t = torch.arange(S, device=w.device)[:, None]
    hot_steps = (t >= hot[0]) & (t < hot[1])
    return r, k, v, torch.where(hot_steps, torch.exp(-torch.exp(logit)), w), u


def wkv6_long_memory_inputs(randn, B, H, S, d):
    """WKV inputs with the model's own init decays (``models/rwkv.py``
    ``init_rwkv_time_mix``): the logit is w0 + 0.5 z, w0 uniform in [-8, -4]
    per (head, key) and z ~ N(0, 1) per step (the LoRA's part), so the decays
    lie within ~e^-0.03 of 1 and a key remembers 50-3000 steps.  r, k and v
    are 1 + 0.25 z: mostly one-sign, so the state sums coherently over that
    memory, |out| reaches ~1e4, and an error that compounds over the memory
    (the tensor core's truncated sums, a factor's rounding) shows.  Head views
    of (B, S, H·d) as :func:`wkv6_inputs` gives them; u ~ N(0, 0.3^2)."""
    def heads(t):
        return t.view(B, S, H, d).transpose(1, 2)

    r, k, v = (heads(1.0 + 0.25 * randn((B, S, H * d))) for _ in range(3))
    w0 = -8.0 + 4.0 * torch.special.ndtr(randn((H * d,)))
    logit = w0 + 0.5 * randn((B, S, H * d))
    return r, k, v, heads(torch.exp(-torch.exp(logit))), 0.3 * randn((H, d))


# ---------------------------------------------------------------------------
# Quantized wire (the counterparts of repro.kernels.ref's)
# ---------------------------------------------------------------------------

#: power-of-two scale divisor per format: amax / QDIV is exact in fp32, so
#: the kernel, the plain version and ``repro`` agree bitwise.  int8: amax
#: maps to +-128, clipped to the symmetric [-127, 127] payload; fp8 (e4m3,
#: max finite 448): amax maps to +-256.
_QDIV = {"int8": 128.0, "fp8": 256.0}


def quant_scale(amax, fmt: str):
    """Per-tile scale from the row abs-max; 1.0 for all-zero tiles."""
    if fmt not in _QDIV:
        raise ValueError(f"unknown quantization format {fmt!r}")
    return torch.where(amax > 0, amax / _QDIV[fmt], torch.ones_like(amax))


def naive_quantize_tiles(x, *, fmt: str = "int8"):
    """x: (R, tile) float -> (q (R, tile) int8/fp8 e4m3fn, scales (R, 1) f32).

    The same ops in the same order as ``repro.kernels.ref``:
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    scale = quant_scale(amax, fmt)
    y = xf / scale
    if fmt == "int8":
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    elif fmt == "fp8":
        q = y.to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown quantization format {fmt!r}")
    return q, scale


def naive_dequantize_tiles(q, scales, *, out_dtype=torch.float32):
    """(q (R, tile), scales (R, 1)) -> (R, tile) ``out_dtype``."""
    return (q.float() * scales).to(out_dtype)
