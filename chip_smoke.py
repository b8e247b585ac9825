#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path at the full width of ``phi3-mini-3.8b``
(32 layers, d_model 3072, 32 heads x 96, d_ff 8192, vocab 32064, fp32,
random weights from a seeded ``torch.Generator`` on the card):

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. builds the three CUDA kernels from ``src/repro_torch/csrc`` with nvcc
   for ``sm_90a`` (one nvcc per source, in parallel);
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at GQA / window / softcap / ragged /
   bf16 edge cases, and times kernel, plain version and (where one PyTorch
   call computes the same function) that library call with CUDA events;
4. parity at full width and 2 layers: seeded weights on the card (kernels)
   and a CPU copy (plain versions), prefill and decode logits compared;
5. serves at full width: one ``build_prefill_step`` call over 8 x 512
   tokens, then the launcher (batch 8, prompt 128, gen 128), with every
   kernel's launch count checked against what the path implies;
6. prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

Every phase raises on failure, so the script exits non-zero; nothing is
caught.  Without a CUDA card, or run outside the repository (no ``src/``),
it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet at 700 W: HBM bandwidth and fp32 rate outside the
# tensor cores (the kernels are SIMT fp32 FMA).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# fp32: kernel and plain version sum in different orders (TF32 off), so they
# agree to fp32 rounding of sums over head_dim, keys, d_model and d_ff.
# bf16: outputs are rounded to bf16 (relative step 2^-8).
TOL_FP32 = 1e-4
TOL_BF16 = {"attention": 2e-2, "swiglu": 3e-2}
# full-width 2-layer logits, card (kernels, cuBLAS) vs CPU (plain versions):
# fp32 sums over 3072 and 8192 terms in other orders through 2 layers
TOL_LOGITS = 1e-3


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for the work, and which of bytes/operations sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fns, torch, target_s: float = 0.4) -> float:
    """Mean ms per call over a warmed-up run of ``fns`` cycled in turn
    (distinct input sets, so repeated calls do not find them in L2)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-5)
    iters = int(min(200, max(3, target_s / one)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(err: float, tol: float, what: str) -> None:
    print(f"  {what}: max abs err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{what}: kernel and plain version disagree: {err} > {tol}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_decode(torch, ops, F, dev) -> dict:
    B, H, S, D = 8, 32, 256, 96
    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype)

    lens = torch.tensor([256, 1, 17, 64, 128, 200, 255, 100], dtype=torch.int32, device=dev)
    sets = [(rnd(B, H, D), rnd(B, S, H, D), rnd(B, S, H, D)) for _ in range(3)]
    q, k, v = sets[0]
    err = max_err(ops.flash_decode_op(q, k, v, lens), ops.plain_flash_decode(q, k, v, lens))
    check(err, TOL_FP32, f"flash_decode B*H={B * H} D={D} cache {S} mixed lengths")

    # edge cases: GQA, window, softcap, shared length, ragged S, bf16
    for (b, h, hkv, s, d, win, cap, per_row, dt) in [
            (4, 32, 8, 300, 96, None, None, True, torch.float32),
            (2, 8, 1, 512, 128, 100, None, False, torch.float32),
            (2, 8, 8, 128, 96, None, 30.0, True, torch.float32),
            (2, 8, 2, 384, 64, 50, 20.0, True, torch.bfloat16)]:
        qq, kk, vv = rnd(b, h, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt)
        ln = (torch.randint(1, s + 1, (b,), generator=g, device=dev, dtype=torch.int32)
              if per_row else s // 3)
        kw = dict(window=win, softcap=cap)
        e = max_err(ops.flash_decode_op(qq, kk, vv, ln, **kw),
                    ops.plain_flash_decode(qq, kk, vv, ln, **kw))
        check(e, TOL_FP32 if dt == torch.float32 else TOL_BF16["attention"],
              f"flash_decode edge B={b} H={h} Hkv={hkv} S={s} D={d} window={win} "
              f"softcap={cap} per_row={per_row} {dt}")

    ms = time_ms([lambda s=s: ops.flash_decode_op(s[0], s[1], s[2], lens) for s in sets], torch)
    plain_ms = time_ms([lambda s=s: ops.plain_flash_decode(s[0], s[1], s[2], lens)
                        for s in sets], torch)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib_ms = time_ms([lambda s=s: F.scaled_dot_product_attention(
        s[0][:, :, None], s[1].transpose(1, 2), s[2].transpose(1, 2), attn_mask=mask)
        for s in sets], torch)
    total_len = int(lens.sum())
    nbytes = 4 * (2 * B * H * D + 2 * total_len * H * D) + 4 * B
    flops = 4 * D * H * total_len
    bms, by = bound(nbytes, flops)
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:22",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"q ({B},{H},{D}) cache ({B},{S},{H},{D}) lens sum {total_len} fp32"}


def phase_flash(torch, ops, F, dev) -> dict:
    B, S, H, D = 8, 512, 32, 96
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype)

    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    err = max_err(ops.flash_attention_op(q, k, v), ops.plain_flash_attention(q, k, v))
    check(err, TOL_FP32, f"flash_attention ({B}*{H}, {S}, {D}) causal")

    for (b, s, h, hkv, d, win, cap, causal, dt) in [
            (2, 300, 32, 8, 96, None, None, True, torch.float32),
            (1, 256, 8, 1, 128, 64, None, True, torch.float32),
            (2, 130, 8, 8, 96, None, 50.0, True, torch.float32),
            (1, 100, 4, 4, 64, None, None, False, torch.float32),
            (2, 160, 4, 2, 64, 40, 30.0, True, torch.bfloat16)]:
        qq, kk, vv = rnd(b, s, h, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt)
        kw = dict(window=win, softcap=cap, causal=causal)
        e = max_err(ops.flash_attention_op(qq, kk, vv, **kw),
                    ops.plain_flash_attention(qq, kk, vv, **kw))
        check(e, TOL_FP32 if dt == torch.float32 else TOL_BF16["attention"],
              f"flash_attention edge B={b} S={s} H={h} Hkv={hkv} D={d} window={win} "
              f"softcap={cap} causal={causal} {dt}")

    ms = time_ms([lambda: ops.flash_attention_op(q, k, v)], torch)
    plain_ms = time_ms([lambda: ops.plain_flash_attention(q, k, v)], torch)
    lib_ms = time_ms([lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)], torch)
    nbytes = 4 * 4 * B * S * H * D
    flops = 4 * D * B * H * (S * (S + 1) // 2)
    bms, by = bound(nbytes, flops)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"q/k/v ({B},{S},{H},{D}) causal fp32"}


def phase_swiglu(torch, ops, dev) -> dict:
    D, Fd = 3072, 8192
    g = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(scale).to(dtype)

    w = (rnd(D, Fd, scale=D ** -0.5), rnd(D, Fd, scale=D ** -0.5), rnd(Fd, D, scale=Fd ** -0.5))
    res = {}
    for T in (8, 4096):
        x = rnd(T, D)
        err = max_err(ops.fused_swiglu_op(x, *w), ops.plain_fused_swiglu(x, *w))
        check(err, TOL_FP32, f"fused_swiglu T={T} D={D} F={Fd}")
        ms = time_ms([lambda: ops.fused_swiglu_op(x, *w)], torch)
        plain_ms = time_ms([lambda: ops.plain_fused_swiglu(x, *w)], torch)
        nbytes = 4 * (3 * D * Fd + 2 * T * D)
        bms, by = bound(nbytes, 6 * T * D * Fd)
        res[T] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                  "bound_by": by, "library_ms": None,
                  "shape": f"x ({T},{D}) wg/wu ({D},{Fd}) wd ({Fd},{D}) fp32"}
        print(f"  fused_swiglu T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")

    for (T, d, f, act, dt) in [(5, 96, 200, "silu", torch.float32),
                               (300, 256, 512, "gelu_tanh", torch.float32),
                               (64, 128, 256, "silu", torch.bfloat16)]:
        x = rnd(T, d, dtype=dt)
        ww = (rnd(d, f, scale=d ** -0.5, dtype=dt), rnd(d, f, scale=d ** -0.5, dtype=dt),
              rnd(f, d, scale=f ** -0.5, dtype=dt))
        e = max_err(ops.fused_swiglu_op(x, *ww, act), ops.plain_fused_swiglu(x, *ww, act))
        check(e, TOL_FP32 if dt == torch.float32 else TOL_BF16["swiglu"],
              f"fused_swiglu edge T={T} D={d} F={f} {act} {dt}")

    entry = {"name": "fused_swiglu", "route": "cuda",
             "source": "src/repro_torch/csrc/fused_swiglu.cu",
             "replaces": "src/repro/kernels/fused_swiglu.py:19", **res[8]}
    entry["prefill"] = res[4096]
    return entry


# ---------------------------------------------------------------------------
# Phase 4: full-width parity at 2 layers, card vs CPU
# ---------------------------------------------------------------------------


def phase_parity(torch, dev) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    cfg = get_config("phi3-mini-3.8b").replace(n_layers=2)
    B, S, steps = 2, 64, 4
    params = init_model(torch.Generator(device=dev).manual_seed(1), cfg, dev)
    cpu = torch.device("cpu")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to_cpu(v) for v in tree)
        return tree.to(cpu)

    params_cpu = to_cpu(params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(2))
    worst = 0.0
    for device, p in ((dev, params), (cpu, params_cpu)):
        pf = build_prefill_step(cfg, batch_global=B, seq_len=S)
        logits = pf.step_fn(p, {"tokens": tokens.to(device)}).cpu()
        ss = build_serve_step(cfg, batch_global=B, cache_len=steps)
        states = prepare_serve_states(cfg, ss.spec.plan, B, steps, device)
        dec = [ss.step_fn(p, tokens[:, t].to(device), t, states)[0].cpu()
               for t in range(steps)]
        if device == dev:
            ref = (logits, dec)
            if not all(bool(torch.isfinite(x).all()) for x in (logits, *dec)):
                raise AssertionError("non-finite logits on the card")
        else:
            worst = max([max_err(ref[0], logits)] +
                        [max_err(a, b) for a, b in zip(ref[1], dec)])
    check(worst, TOL_LOGITS, f"full-width 2-layer logits card vs CPU "
                             f"(prefill {B}x{S}, {steps} decode steps)")
    del params, params_cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: serve at full width
# ---------------------------------------------------------------------------


def phase_serve(torch, ops, dev, card: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import init_model
    from repro_torch.runtime.serve import build_prefill_step

    cfg = get_config("phi3-mini-3.8b")
    B, S = 8, 512
    prompt, gen = 128, 128
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  weights {n_bytes / 1e9:.3f} GB ({cfg.param_count()} params) made on the "
          f"card in {time.perf_counter() - t0:.2f}s")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    pf = build_prefill_step(cfg, batch_global=B, seq_len=S)
    pf.step_fn(params, {"tokens": tokens[:1, :64]})          # warm-up (cuBLAS)
    torch.cuda.synchronize()
    device_ms = profile_decode(torch, cfg, params, tokens[:, 0], B, prompt + gen, dev)

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits = pf.step_fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if logits.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite/shaped")
    del params, logits
    torch.cuda.empty_cache()

    res = launcher.main(["--arch", cfg.name, "--batch", str(B), "--prompt-len", str(prompt),
                         "--gen", str(gen)])
    toks = res["tokens"]
    if toks.shape != (prompt + gen, B) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"launcher tokens {toks.shape} out of range")
    steps = res["steps"]
    expect = {"flash_decode": cfg.n_layers * steps,
              "fused_swiglu": cfg.n_layers * (steps + 1),
              "flash_attention": cfg.n_layers}
    launches = dict(ops.LAUNCHES)
    print(f"  launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = res["seconds"] / steps * 1e3
    print(f"serve phi3-mini-3.8b full width fp32: prefill {B}x{S} {prefill_ms:.3f} ms; "
          f"decode {step_ms:.3f} ms/step over {steps} steps "
          f"(batch {B}); {res['tok_per_s']:.1f} tok/s; peak memory {peak / 1e9:.3f} GB; "
          f"card {card}")
    if device_ms is not None:
        print(f"  device busy {device_ms:.3f} ms of the {step_ms:.3f} ms decode step "
              f"({device_ms / step_ms:.1%}; idle {1 - device_ms / step_ms:.1%})")
    return launches


def profile_decode(torch, cfg, params, token, B, cache_len, dev, n_steps=8):
    """Device kernel time per decode step from a ``torch.profiler`` trace of
    ``n_steps`` steps at half the cache length (after 2 untraced ones);
    prints the top kernels.
    Returns None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve import build_serve_step, prepare_serve_states

    ss = build_serve_step(cfg, batch_global=B, cache_len=cache_len)
    states = prepare_serve_states(cfg, ss.spec.plan, B, cache_len, dev)
    start = cache_len // 2            # mid-run cache length
    for pos in range(start - 2, start):
        ss.step_fn(params, token, pos, states)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for pos in range(start, start + n_steps):
            ss.step_fn(params, token, pos, states)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        print("  profiler trace holds no device time: device busy share not measured")
        return None
    print(f"  decode-step trace ({n_steps} steps): top kernels by device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n_steps / 1e3:8.3f} ms/step "
              f"{e.count // n_steps:5d} launches/step  {e.key[:90]}")
    del states
    return total_us / n_steps / 1e3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's smoke run needs one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}; count {torch.cuda.device_count()}")
    print(card)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"built kernels {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f}s")

    print("phase 3: kernels against their plain versions")
    entries = [phase_decode(torch, ops, F, dev), phase_flash(torch, ops, F, dev),
               phase_swiglu(torch, ops, dev)]
    print("phase 4: full-width parity, 2 layers")
    phase_parity(torch, dev)
    print("phase 5: serve at full width")
    launches = phase_serve(torch, ops, dev, card)
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["card"] = card
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
