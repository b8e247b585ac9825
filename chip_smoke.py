#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving, training and planned training paths at the
full width of ``phi3-mini-3.8b`` (32 layers, d_model 3072, 32 heads x 96,
d_ff 8192, vocab 32064, fp32, random weights from a seeded
``torch.Generator`` on the card), serves one 8-layer period of Jamba-1.5-Large without experts at
its published widths (d_model 8192, 64/8 heads x 128, d_ff 24576, Mamba
d_inner 16384 and d_state 16, vocab 65536), and serves the published
``rwkv6-7b`` whole (32 layers, d_model 4096, 64 heads x 64, d_ff 14336,
vocab 65536):

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc for
   ``sm_90a`` (one nvcc per source, in parallel);
3. holds each serving kernel against its plain PyTorch version on the card,
   at the shapes the serving path gives it and at GQA / window / softcap / ragged /
   bf16 edge cases, and times kernel, plain version and (where one PyTorch
   call computes the same function) that library call with CUDA events;
   flash decode also at two long caches at batch 1 (phi3-mini's 4096-token
   context, a 32768-key slice of Jamba's; fp32 and bf16), where the split
   over a thread-block cluster runs, and with more splits than valid keys;
   flash attention at the prefill and at the training micro-batch
   (2, 256) beside SDPA and its 3xTF32 bound, two runs bitwise equal, S =
   1, 63 and 65, head_dim 160 (the SIMT route), and a causal row of 16384
   keys with one-sign values; SwiGLU at decode, the training micro-batch
   (T = 512) and the prefill,
   beside the cuBLAS route (three fp32 products and the activation) and its
   3xTF32 / byte bound, two runs bitwise equal, both sides of the T = 16
   path switch, unaligned widths, and one-sign sums over F = 24576;
3b. holds the training slice's kernels against their plain versions:
   quantize / dequantize (int8 and fp8) bitwise at the boundary shape and
   at the largest gradient leaf, ``roundtrip_ef`` bitwise at a bucket's
   size, the flash-attention backward and the SwiGLU backward at the
   training shapes; the backward also two runs bitwise equal, at GQA /
   window / non-causal / ragged / bf16 edges on both of its routes (head_dim
   32-128 on the tensor cores, 100 on the SIMT kernels) and on 8192 causal
   rows with one-sign dO and V; times each beside its bound, its plain
   version and (attention) SDPA forward + backward;
3c. holds the Mamba selective-scan kernel against its plain version at the
   Jamba prefill's shape (2, 1024, 16384, 16), two runs bitwise equal, at
   edges (d_state 8, ragged d and S, S = 1, B = 1, d not a multiple of 4)
   and on a long-memory draw at that shape with the model's init decays
   (also against float64 on 512 channels a row), timed beside its bound
   (its device time in phase 9);
3d. holds the serving kernels against their plain versions at Jamba's
   shapes (flash attention and decode at head_dim 128, GQA 8; SwiGLU at
   8192 x 24576, T = 8 and 2048, beside the cuBLAS route), timed;
3e. holds the RWKV-6 WKV kernel against its plain version at the rwkv6-7b
   prefill's shape (8, 64, 512, 64), on head views as the model hands them
   over, two runs bitwise equal, at the shared edge cases (S = 1, S off the
   staging run, d = 32, B = 1, decay logits above 0), on a row whose logits
   exceed 0 in one 64-step chunk only (the kernel's exact chunks and its
   tensor-core chunks on one state) and on a long-memory draw at the
   prefill's shape with the model's init decays (also against float64 on
   16 rows), timed beside its bound (its device time in phase 9c);
4. parity at full width and 2 layers: seeded weights on the card (kernels)
   and a CPU copy (plain versions), prefill and decode logits compared;
5. serves at full width: one ``build_prefill_step`` call over 8 x 512
   tokens, then the launcher (batch 8, prompt 128, gen 128), with every
   kernel's launch count checked against what the path implies;
6a. training parity at full width and 2 layers (2 virtual stages), card vs
   CPU: one uncompressed gradient (loss and every leaf); one int8 step with
   error feedback through ``step_fn`` on both sides, taken apart: the loss
   (tighter than the boundary quantization's own effect on it), the
   gradient before the wire, the wire bitwise on the card's pre-wire
   gradient (written-back gradient leaves and residual), and the updated
   parameters and AdamW moments leaf by leaf;
6b. trains at full width through ``launch/train``'s path in-process: 32
   layers, 4 virtual stages x 4 micro-batches, batch 8 x 256, int8 wire,
   1 warm-up + 4 timed steps, every step's launch counts checked, the loss
   on step 0's batch lower after one step, peak memory, and a profiler
   table of one more step;
6c. the paper's loop at full width, after 6b's state is freed: (a)
   ``launch.profile`` measures phi3 at seq 256, batches 1, 2, 4, 8 into an
   artifact of 4 virtual devices of 20 GB (``profiles/``), each layer's
   forward and backward ms printed; (b) ``launch.train --plan --profile``
   plans it with ``plan_hpp`` over the divisors of a model axis of 4,
   lowers it and trains 4 steps (1 warm-up) of 8 x 256 on the planner's
   period split, M = 4, int8 wire; (c) prints the split, the plan's
   predicted round latency and summed device work beside the measured
   ms/step, and the peak memory; (d) checks the launch counts of every step
   and of one forward-only evaluation, M (P - 1) boundary round trips each
   way; (e) holds a split with unequal stages, ((0, 1), (1, 4)), at 4
   full-width layers card vs CPU (loss and every gradient leaf);
6d. the paper's pipeline replay at full width, after 6c's state is freed:
   (a) double buffering on a split with unequal stages, ((0, 1), (1, 4)),
   at 4 full-width layers: the loss and every gradient leaf bit for bit
   the synchronous pipeline's, without and with the int8 wire, the launch
   counts unchanged (the synchronous gradient taken twice first: the card's
   step is deterministic); (b) ``launch.train --plan --profile <6c's
   artifact> --staleness 1`` (int8 wire, 256 MiB buckets, double buffered
   by default) for 4 steps at 32 layers: every step's launch counts as the
   plan implies, round 0 leaving the parameters as they were (the loss of
   an evaluation on its batch equal to its own), the update of round 0
   lowering that loss after round 1, the flush at the end (the step counter
   at 4), the peak memory beside 6c's; (c) the same flags on a virtual
   cluster that survives a failure (6c's measurement retiled into 3
   devices of 36 GB, model axis 6) with ``--fail-at 3 --fail-rank <the
   last stage's device> --backup-every 2`` for 5 steps: the plan before
   and after, the ``RecoveryReport``'s figures, the wall time of
   ``recover_now`` split into replan, restore from host, migration and
   re-seeded backups, and the first step after; the time and bytes of one
   ``backup_now``; the restored rows and edge leaves bitwise the step-2
   backup, every other row bitwise untouched, the reconciliation, finite
   losses and every step's launch counts;
7a. Jamba layer parity at full width, card vs CPU: a Mamba+MLP layer and
   the attention+MLP layer, ``apply_layer`` on (1, 256) tokens, then 8
   ``decode_layer`` steps from fresh states;
7b. the 8-layer Jamba period on the card: the last-position logits of
   ``build_prefill_step`` on (2, 256) tokens against 256 lockstep
   ``build_serve_step`` steps (the scan kernel against the plain decode
   recurrence);
7c. serves the Jamba period at full width: prefill 2 x 1024 timed after a
   warm-up; lockstep decode at batch 8, prompt 64 + gen 64 (the serve
   launcher's loop); every kernel's launch count checked; device-busy share
   of a decode step from a profiler trace;
8a. rwkv6-7b layer parity at full width, card vs CPU, with the LoRA
   up-projections drawn non-zero: ``apply_layer`` on (1, 256) tokens, then
   8 ``decode_layer`` steps from fresh states, and the states written in
   place;
8b. all 32 rwkv6-7b layers on the card, prefill against lockstep decode
   (the WKV kernel against the one-step recurrence; at init no decay logit
   exceeds 0, so the prefill's clamp does not bind, which the phase checks
   and prints): each layer's ``apply_layer`` on (2, 256) tokens against 256
   ``decode_layer`` steps on the same input; the last-position logits of
   ``build_prefill_step`` against 256 lockstep ``build_serve_step`` steps;
8c. serves rwkv6-7b at full width: prefill 8 x 512 timed after a warm-up;
   lockstep decode at batch 8, prompt 64 + gen 64 (the serve launcher's
   loop); every kernel's launch count checked; device-busy share of a
   decode step from a profiler trace;
9. reads device times at the training shape from profiler traces (last,
   because tracing slows later launches): the flash forward beside SDPA's
   forward, the flash backward alone, and the port's forward with the
   logsumexp plus its backward beside SDPA's forward plus backward; 9b
   reads ``mamba_scan``'s device time at the Jamba prefill's shape, 9c
   ``rwkv6_wkv``'s at the rwkv6-7b prefill's and 9d ``flash_decode``'s at
   the four ``DECODE_SHAPES`` beside SDPA's (and, at GQA shapes, the heads'
   ``repeat_interleave``'s) device time, each over input sets called in
   turn until their caches span 4x the L2 (so they come from HBM); prints
   a ``{"kernels": [...]}`` line (all nine kernels, with their launches on
   the phi3 serving, phi3 training, phi3 planned training, staleness-1 and
   failure-recovery training, Jamba serving and rwkv6-7b serving paths) and,
   last, ``{"ok": true, ...}``.

Every phase raises on failure, so the script exits non-zero; nothing is
caught.  Without a CUDA card, or run outside the repository (no ``src/``),
it exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet at 700 W: HBM bandwidth and fp32 rate outside the
# tensor cores (the SIMT fp32 FMA kernels), and the dense TF32 tensor-core
# rate (fused_swiglu's and flash_attention's products, taken as 3xTF32:
# three TF32 passes).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# exponentials per second on the special-function units (132 SMs x 16 per
# clock at the 1.98 GHz boost clock): the scan's operation bound
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
# the card's L2 (data sheet): timed inputs that must come from HBM span 4x it
L2_BYTES = 50 * 2 ** 20

# fp32: kernel and plain version sum in different orders (TF32 off), so they
# agree to fp32 rounding of sums over head_dim, keys, d_model and d_ff.
# bf16: outputs are rounded to bf16 (relative step 2^-8).
TOL_FP32 = 1e-4
TOL_BF16 = {"attention": 2e-2, "swiglu": 3e-2}
# full-width 2-layer logits, card (kernels, cuBLAS) vs CPU (plain versions):
# fp32 sums over 3072 and 8192 terms in other orders through 2 layers
TOL_LOGITS = 1e-3
# elementwise SwiGLU backward, kernel vs plain on the card: the same
# expression; expf/tanhf and fused multiply-adds differ in the last bits of
# values of order 10
TOL_ELEMENTWISE = 1e-5
# full-width 2-layer training, card (kernels, cuBLAS) vs CPU (plain
# versions): fp32 sums in other orders through 2 layers, the head and the
# backward.  Loss: relative.  Gradients: per leaf, max |diff| / max |value|.
# Gradients through int8 boundaries: per leaf, |diff| / |value| in the
# 2-norm; a boundary code that flips between card and CPU moves a value by
# a quantization step, and the stages after it densely.  10x the 1.87e-3
# measured on an H100; a wrong gradient is off by order 1.
# int8 loss: a boundary value that lands on a rounding edge may quantize
# one step apart on the two sides; 10x the 1.5e-6 measured on an H100.  The
# phase also requires the int8 boundaries' own effect on the loss to exceed
# it, so that a card path that skipped the boundary quantization fails.
# AdamW on the same gradients: elementwise IEEE ops, the clip norm's sum in
# another order.
TOL_TRAIN_LOSS = 1e-4
TOL_GRAD_REL = 1e-3
TOL_INT8_LOSS = 1.5e-5
TOL_INT8_GRAD = 2e-2
TOL_ADAMW_REL = 1e-6
# Mamba scan, kernel vs plain on the card: |diff| <= TOL_SCAN * (1 + |plain|),
# repro's tolerance for its scan (tests/test_kernels.py); the same sums with
# expf against torch.exp and fused multiply-adds.
TOL_SCAN = 2e-4
# Jamba at full width, max |diff| / max |value|.  Layers card vs CPU (7a):
# fp32 sums over 8192-24576 terms and the scan's 256 steps in other orders;
# 15x the 3.3e-06 read on an H100.  Prefill vs lockstep decode on the card
# (7b), on the logits: the serial scan kernel against the one-step
# recurrence, flash against decode attention, products at other batch
# shapes, through 8 layers; 12x the 1.6e-05 read on an H100.
TOL_JAMBA_LAYER = 5e-5
TOL_JAMBA_DECODE = 2e-4
# RWKV-6 WKV, kernel vs plain on the card: |diff| <= TOL_WKV * (1 + |plain|);
# at d = 64 the chunked form in 3xTF32 on the tensor cores against the
# step-by-step recurrence (at d = 32 the same recurrence with the bonus term
# summed apart).  3.3x the largest max abs error read on an H100 (1.5e-05, at
# the prefill's shape; 3.8e-06 for the step-by-step kernel it replaced;
# repro's own tolerance, 3e-4, is 20x it).
TOL_WKV = 5e-5
# rwkv6-7b at full width, max |diff| / max |value|.  A layer card vs CPU
# (8a): fp32 sums over 4096-14336 terms and the recurrence in other orders;
# 15x the 1.3e-06 (apply_layer) and 10x the 2.1e-06 (decode steps) read on
# an H100, the states 14x the 6.9e-07 read.  Prefill vs lockstep decode on
# the card (8b): the WKV kernel against the one-step update and products at
# other batch shapes, each layer on the same input (14x the 6.3e-06 read),
# then on the logits through 32 layers, which compound the per-layer
# rounding differences (3.6x the 1.39e-02 read).
TOL_RWKV_LAYER = 2e-5
TOL_RWKV_STATE = 1e-5
TOL_RWKV_LAYER_DECODE = 9e-5
TOL_RWKV_DECODE = 5e-2


def bound(nbytes: float, flops: float, exps: float = 0,
          tf32x3: float = 0) -> tuple[float, str]:
    """Least time in ms for the work, and which of bytes/operations sets it:
    ``flops`` fp32 operations, ``exps`` exponentials on the SFU and
    ``tf32x3`` flops of fp32 matrix products on the tensor cores, three
    TF32 passes each."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FP32_FLOPS, exps / PEAK_SFU_PER_S,
                3 * tf32x3 / PEAK_TF32_FLOPS) * 1e3
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


def device_ms(fn, torch, n: int = 100) -> float:
    """Mean device time per call of the kernels ``fn`` launches, from a
    ``torch.profiler`` trace of ``n`` calls: the card's own time, which
    ``time_ms`` reads only when the card, not the host's launch path, is the
    slower of the two.  Tracing, once started, slows later launches: call
    it after the timed phases.  A trace can come back without its kernels;
    it is then taken again, up to three times.  A trace can also keep only
    some of them: each kernel's launches a call are its records over ``n``,
    rounded, and its mean over the records kept counts that many times (a
    shortfall is printed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count > 0]
        if sum(e.self_device_time_total for e in kernels) > 0:
            us, lost = 0.0, 0
            for e in kernels:
                per_call = max(1, round(e.count / n))
                lost += max(0, per_call * n - e.count)
                us += e.self_device_time_total / e.count * per_call
            if lost:
                print(f"  profiler trace kept {sum(e.count for e in kernels)} kernel records "
                      f"of {sum(e.count for e in kernels) + lost} ({n} calls)")
            return us / 1e3
        print(f"  profiler trace {attempt} holds no device time; tracing again")
    raise AssertionError("three profiler traces held no device time")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def max_err_rel(a, b) -> float:
    """max |a - b| / (1 + |b|): within tol, a and b agree to tol absolute
    and relative, as ``torch.testing.assert_close(a, b, atol=tol,
    rtol=tol)`` holds the card tests' results (within a factor below 2)."""
    b = b.float()
    return float(((a.float() - b).abs() / (1 + b.abs())).max())


def check(err: float, tol: float, what: str, kind: str = "max abs err") -> None:
    print(f"  {what}: {kind} {err:.3e} (tol {tol:g})")
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


# flash_decode's timed shapes, fp32: phi3's and Jamba's serving steps (the
# lengths phases 3 and 3d have always used), phi3-mini-4k's full context
# (arXiv:2404.14219) and a 32K slice of Jamba-1.5's context at batch 1:
# name -> (B, H, Hkv, S, D, per-row lengths)
DECODE_SHAPES = {
    "phi3": (8, 32, 32, 256, 96, (256, 1, 17, 64, 128, 200, 255, 100)),
    "jamba": (8, 64, 8, 128, 128, (128, 1, 17, 64, 100, 127, 90, 33)),
    "phi3_long": (1, 32, 32, 4096, 96, (4096,)),
    "jamba_long": (1, 64, 8, 32768, 128, (32768,)),
}


def decode_inputs(torch, dev, g, name, dtype=None):
    """q, k, v, lens of ``DECODE_SHAPES[name]``, values N(0, 0.25) from ``g``."""
    B, H, Hkv, S, D, lens = DECODE_SHAPES[name]
    q, k, v = (torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype or torch.float32)
               for shape in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


def decode_sets(torch, dev, g, name):
    """``decode_inputs`` sets of ``DECODE_SHAPES[name]`` (fp32), as many as
    make their valid K and V rows span 4x the card's 50 MB L2 when called in
    turn: a timed call then reads its cache from HBM, as a decode step does
    (each layer's weights stream between its attention calls)."""
    B, H, Hkv, S, D, lens = DECODE_SHAPES[name]
    n = -(-4 * L2_BYTES // (2 * sum(lens) * Hkv * D * 4))
    return [decode_inputs(torch, dev, g, name) for _ in range(n)]


def in_turns(fns):
    """One callable that calls ``fns`` in turn, one of them a call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def decode_bound(name, elem=4):
    """``flash_decode``'s least time at ``DECODE_SHAPES[name]``: q read and
    the output written once, each valid K and V row read once, the lengths;
    or 4·D fp32 flops a (query head, valid key)."""
    B, H, Hkv, S, D, lens = DECODE_SHAPES[name]
    total = sum(lens)
    return bound(elem * (2 * B * H * D + 2 * total * Hkv * D) + 4 * B, 4 * D * H * total)


def sdpa_decode_args(torch, q, k, v, lens):
    """SDPA's operands for a decode step: q as one query token, the caches'
    heads repeated to q's (GQA) and moved before S, a mask where a row's
    length is below S (none at full length)."""
    G = q.shape[1] // k.shape[2]
    kt, vt = ((t.repeat_interleave(G, dim=2) if G > 1 else t).transpose(1, 2) for t in (k, v))
    S = k.shape[1]
    mask = None
    if bool((lens < S).any()):
        mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    return q[:, :, None], kt, vt, mask


def phase_decode(torch, ops, F, dev) -> dict:
    B, H, S, D = 8, 32, 256, 96
    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype)

    lens = torch.tensor(DECODE_SHAPES["phi3"][5], dtype=torch.int32, device=dev)
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
    lib_ms = time_ms([lambda a=sdpa_decode_args(torch, *s, lens): F.scaled_dot_product_attention(
        a[0], a[1], a[2], attn_mask=a[3]) for s in sets], torch)
    bms, by = decode_bound("phi3")
    entry = {"name": "flash_decode", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention.py:22",
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": by, "library_ms": lib_ms,
             "shape": f"q ({B},{H},{D}) cache ({B},{S},{H},{D}) lens sum {int(lens.sum())} fp32"}

    # long caches at batch 1: the split over a thread-block cluster
    for name in ("phi3_long", "jamba_long"):
        Bl, Hl, Hkvl, Sl, Dl, _ = DECODE_SHAPES[name]
        q, k, v, ln = decode_inputs(torch, dev, g, name)
        e = max_err(ops.flash_decode_op(q, k, v, ln), ops.plain_flash_decode(q, k, v, ln))
        check(e, TOL_FP32, f"flash_decode {name} q ({Bl}, {Hl}, {Dl}) cache ({Bl}, {Sl}, "
                           f"{Hkvl}, {Dl}) full length")
        a = sdpa_decode_args(torch, q, k, v, ln)
        lms = time_ms([lambda: ops.flash_decode_op(q, k, v, ln)], torch)
        lplain = time_ms([lambda: ops.plain_flash_decode(q, k, v, ln)], torch)
        llib = time_ms([lambda: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                               attn_mask=a[3])], torch)
        lb, lby = decode_bound(name)
        entry[name] = {"max_abs_err": e, "ms": lms, "plain_ms": lplain, "bound_ms": lb,
                       "bound_by": lby, "library_ms": llib,
                       "shape": f"q ({Bl},{Hl},{Dl}) cache ({Bl},{Sl},{Hkvl},{Dl}) full fp32"}
        print(f"  flash_decode {name}: kernel {lms:.4f} ms, plain {lplain:.4f} ms, SDPA "
              f"{llib:.4f} ms (heads repeated outside the call), bound {lb:.4f} ms ({lby})")
        del q, k, v, a
    # the Jamba long cache in bf16.  Its outputs are means over 32768 keys
    # (|out| about 0.003, at most about 0.011), far below TOL_BF16, so the
    # limit follows their size: two bf16 steps (2^-7) of the largest plain
    # output, plus 1e-6.  An output of zeros, or one that leaves out one
    # split's keys (2048 of 32768), must miss it, or the check could not fail.
    q, k, v, ln = decode_inputs(torch, dev, g, "jamba_long", torch.bfloat16)
    want = ops.plain_flash_decode(q, k, v, ln)
    tol = 2 ** -7 * float(want.float().abs().max()) + 1e-6
    e = max_err(ops.flash_decode_op(q, k, v, ln), want)
    check(e, tol, "flash_decode jamba_long bf16 full length (limit 2^-7 max |plain| + 1e-6)")
    part = k.shape[1] // 16
    for what, wrong in (("zeros", torch.zeros_like(want)),
                        ("the last split left out", ops.plain_flash_decode(q, k, v, ln - part)),
                        ("the first split left out",
                         ops.plain_flash_decode(q, k, v, ln, window=k.shape[1] - part))):
        miss = max_err(wrong, want)
        print(f"  flash_decode jamba_long bf16: {what} would err by {miss:.3e} (limit {tol:.3e})")
        if not miss > tol:
            raise AssertionError(f"flash_decode jamba_long bf16: {what} passes the limit {tol}")
    del q, k, v, want, wrong
    # 16 splits over a 32768-key cache holding 5 and 40 valid keys (all
    # but one or two splits empty)
    q, k, v = rnd(2, 64, 128), rnd(2, 32768, 8, 128), rnd(2, 32768, 8, 128)
    ln = torch.tensor([5, 40], dtype=torch.int32, device=dev)
    for kw in ({}, {"window": 3}):
        e = max_err(ops.flash_decode_op(q, k, v, ln, **kw), ops.plain_flash_decode(q, k, v, ln, **kw))
        check(e, TOL_FP32, f"flash_decode splits past the valid keys: B=2 cache 32768, "
                           f"lengths 5 and 40, {kw or 'no window'}")
    del q, k, v
    torch.cuda.empty_cache()
    return entry


def flash_bound(B, S, H, Hkv, D, causal=True):
    """``flash_attention``'s least time: q/out read and written once, k/v
    read once, or 4·D flops a (query, valid key) pair as 3xTF32 products on
    the tensor cores."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return bound(4 * (2 * B * S * H * D + 2 * B * S * Hkv * D), 0, tf32x3=4 * D * B * H * pairs)


def phase_flash(torch, ops, F, dev) -> dict:
    B, S, H, D = 8, 512, 32, 96
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype)

    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    err = max_err(ops.flash_attention_op(q, k, v), ops.plain_flash_attention(q, k, v))
    check(err, TOL_FP32, f"flash_attention ({B}*{H}, {S}, {D}) causal")
    same = bitwise_equal(torch, ops.flash_attention_op(q, k, v), ops.flash_attention_op(q, k, v))
    print(f"  flash_attention ({B}, {S}, {H}, {D}): two runs bitwise {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("flash_attention: not deterministic")

    # GQA, window, softcap, ragged S, non-causal, bf16; S = 1 and both sides
    # of a 64-row tile; D = 160 (the SIMT route)
    for (b, s, h, hkv, d, win, cap, causal, dt) in [
            (2, 300, 32, 8, 96, None, None, True, torch.float32),
            (1, 256, 8, 1, 128, 64, None, True, torch.float32),
            (2, 130, 8, 8, 96, None, 50.0, True, torch.float32),
            (1, 100, 4, 4, 64, None, None, False, torch.float32),
            (2, 160, 4, 2, 64, 40, 30.0, True, torch.bfloat16),
            (3, 1, 8, 2, 32, None, None, True, torch.float32),
            (2, 63, 8, 2, 64, None, None, True, torch.float32),
            (2, 65, 16, 4, 128, None, None, True, torch.float32),
            (1, 200, 4, 2, 160, None, None, True, torch.float32)]:
        qq, kk, vv = rnd(b, s, h, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt), rnd(b, s, hkv, d, dtype=dt)
        kw = dict(window=win, softcap=cap, causal=causal)
        e = max_err(ops.flash_attention_op(qq, kk, vv, **kw),
                    ops.plain_flash_attention(qq, kk, vv, **kw))
        check(e, TOL_FP32 if dt == torch.float32 else TOL_BF16["attention"],
              f"flash_attention edge B={b} S={s} H={h} Hkv={hkv} D={d} window={win} "
              f"softcap={cap} causal={causal} {dt}")

    # a causal row of 16384 keys, q/k in [0, 1) and V in [1, 1.1): one-sign
    # sums that the tensor core, which truncates, would drift on
    qq, kk = (torch.rand((1, 16384, n, 128), generator=g, device=dev) for n in (2, 1))
    vv = torch.rand((1, 16384, 1, 128), generator=g, device=dev).mul_(0.1).add_(1.0)
    e = max_err(ops.flash_attention_op(qq, kk, vv), ops.plain_flash_attention(qq, kk, vv))
    check(e, TOL_FP32, "flash_attention long row (1, 16384, 2/1, 128), values around 1")
    del qq, kk, vv

    ms = time_ms([lambda: ops.flash_attention_op(q, k, v)], torch)
    plain_ms = time_ms([lambda: ops.plain_flash_attention(q, k, v)], torch)
    lib_ms = time_ms([lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)], torch)
    bms, by = flash_bound(B, S, H, H, D)
    print(f"  flash_attention ({B}, {S}, {H}, {D}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:27",
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": by, "library_ms": lib_ms,
             "shape": f"q/k/v ({B},{S},{H},{D}) causal fp32"}

    # the training step's shape (a micro-batch of 2 x 256 tokens)
    B, S = 2, 256
    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    err = max_err(ops.flash_attention_op(q, k, v), ops.plain_flash_attention(q, k, v))
    check(err, TOL_FP32, f"flash_attention training shape ({B}, {S}, {H}, {D}) causal")
    ms = time_ms([lambda: ops.flash_attention_op(q, k, v)], torch)
    plain_ms = time_ms([lambda: ops.plain_flash_attention(q, k, v)], torch)
    lib_ms = time_ms([lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)], torch)
    bms, by = flash_bound(B, S, H, H, D)
    print(f"  flash_attention ({B}, {S}, {H}, {D}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    entry["train"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                      "bound_by": by, "library_ms": lib_ms,
                      "shape": f"q/k/v ({B},{S},{H},{D}) causal fp32"}
    return entry


def phase_flash_device(torch, ops, F, dev, entries: dict) -> None:
    """Device times at the training shape from profiler traces, where a
    call from Python can spend as long on the host as its kernels take (the
    CUDA-event time then reads the host): the flash forward beside SDPA's
    forward kernels, into the forward's entry's ``"train"``; the backward
    alone, and the port's forward with the logsumexp plus its backward
    beside SDPA's forward plus backward, into the backward's entry.  Run
    last: the profiler's tracing, once started, slows the launches of every
    later phase."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    B, S, H, D = 2, 256, 32, 96
    g = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).mul_(0.5) for _ in range(3))
    dout = torch.randn((B, S, H, D), generator=g, device=dev)
    dev_ms = device_ms(lambda: ops.flash_attention_op(q, k, v), torch)
    lib_dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True), torch)
    print(f"  flash_attention ({B}, {S}, {H}, {D}) device time: kernel {dev_ms:.4f} ms, "
          f"SDPA {lib_dev_ms:.4f} ms")
    entries["flash_attention"]["train"].update(device_ms=dev_ms, library_device_ms=lib_dev_ms)

    out, lse = flash_attention(q, k, v, return_lse=True)
    bwd_ms = device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout), torch)

    def port():
        o, ls = flash_attention(q, k, v, return_lse=True)
        flash_attention_bwd(q, k, v, o, ls, dout)

    qt_, kt_, vt_ = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        o = F.scaled_dot_product_attention(qt_, kt_, vt_, is_causal=True)
        torch.autograd.grad(o, (qt_, kt_, vt_), dout.transpose(1, 2))

    port_ms, sdpa_ms = device_ms(port, torch), device_ms(sdpa, torch)
    print(f"  flash_attention_bwd ({B}, {S}, {H}, {D}) device time: backward {bwd_ms:.4f} ms; "
          f"forward with logsumexp + backward {port_ms:.4f} ms, SDPA forward + backward "
          f"{sdpa_ms:.4f} ms")
    entries["flash_attention_bwd"].update(device_ms=bwd_ms, fwd_bwd_device_ms=port_ms,
                                          library_device_ms=sdpa_ms)


def phase_scan_device(torch, ops, dev, entries: dict) -> None:
    """``mamba_scan``'s device time at the Jamba prefill's shape from a
    profiler trace, beside the CUDA-event time of phase 3c, into its entry.
    Run last, as ``phase_flash_device``."""
    from repro_torch.kernels.ref import MAMBA_EDGE_CASES, mamba_scan_inputs

    g = torch.Generator(device=dev).manual_seed(17)
    (B, S, d, N), _ = MAMBA_EDGE_CASES[0]
    inp = mamba_scan_inputs(lambda s: torch.randn(s, generator=g, device=dev), B, S, d, N)
    dev_ms = device_ms(lambda: ops.mamba_scan_op(*inp), torch)
    e = entries["mamba_scan"]
    print(f"  mamba_scan ({B}, {S}, {d}, {N}) device time: {dev_ms:.4f} ms (CUDA events "
          f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, {e['bound_ms'] / dev_ms:.1%} of it)")
    e["device_ms"] = dev_ms


def phase_wkv_device(torch, ops, dev, entries: dict) -> None:
    """``rwkv6_wkv``'s device time at the rwkv6-7b prefill's shape from a
    profiler trace, beside the CUDA-event time of phase 3e, into its entry.
    Run last, as ``phase_flash_device``."""
    from repro_torch.kernels.ref import WKV_EDGE_CASES, wkv6_inputs

    g = torch.Generator(device=dev).manual_seed(19)
    (B, H, S, d), logit_max, _ = WKV_EDGE_CASES[0]
    inp = wkv6_inputs(lambda s: torch.randn(s, generator=g, device=dev), B, H, S, d, logit_max)
    dev_ms = device_ms(lambda: ops.rwkv6_wkv_op(*inp), torch)
    e = entries["rwkv6_wkv"]
    print(f"  rwkv6_wkv ({B}, {H}, {S}, {d}) device time: {dev_ms:.4f} ms (CUDA events "
          f"{e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms, {e['bound_ms'] / dev_ms:.1%} of it)")
    e["device_ms"] = dev_ms


def phase_decode_device(torch, ops, F, dev, entries: dict) -> None:
    """``flash_decode``'s device time at the four ``DECODE_SHAPES`` (phase 3's
    phi3 step, phase 3d's Jamba step, the two long caches) from profiler
    traces, beside its CUDA-event times (which at 1.5-8 µs of bound read the
    Python launch path) and SDPA's device time by the same ``device_ms``:
    the SDPA call alone, and at GQA shapes the ``repeat_interleave`` of the
    caches to q's heads apart from it.  Into its entry.  Run last, as
    ``phase_flash_device``."""
    g = torch.Generator(device=dev).manual_seed(11)
    e = entries["flash_decode"]
    subs = {"phi3": e, "jamba": e["jamba"], "phi3_long": e["phi3_long"],
            "jamba_long": e["jamba_long"]}
    for name, sub in subs.items():
        B, H, Hkv, S, D, _ = DECODE_SHAPES[name]
        sets = decode_sets(torch, dev, g, name)
        dev_ms = device_ms(in_turns([lambda s=s: ops.flash_decode_op(*s) for s in sets]), torch)
        args = [sdpa_decode_args(torch, *s) for s in sets]
        sdpa_ms = device_ms(in_turns([lambda a=a: F.scaled_dot_product_attention(
            a[0], a[1], a[2], attn_mask=a[3]) for a in args]), torch)
        del args
        rep_ms = None
        if H != Hkv:
            rep_ms = device_ms(in_turns([lambda s=s: (s[1].repeat_interleave(H // Hkv, dim=2),
                                                      s[2].repeat_interleave(H // Hkv, dim=2))
                                         for s in sets]), torch)
        sub.update(device_ms=dev_ms, library_device_ms=sdpa_ms, repeat_device_ms=rep_ms,
                   device_sets=len(sets))
        print(f"  flash_decode {name} q ({B}, {H}, {D}) cache ({B}, {S}, {Hkv}, {D}) device "
              f"time over {len(sets)} input sets in turn: {dev_ms:.4f} ms (CUDA events "
              f"{sub['ms']:.4f} ms, bound {sub['bound_ms']:.4f} ms, "
              f"{sub['bound_ms'] / dev_ms:.1%} of it); SDPA {sdpa_ms:.4f} ms"
              + ("" if rep_ms is None else f" + the heads' repeat_interleave {rep_ms:.4f} ms"))
        del sets
    torch.cuda.empty_cache()


def cublas_swiglu(F, x, wg, wu, wd):
    """SwiGLU as a PyTorch user writes it: three fp32 cuBLAS products (TF32
    off) and the activation.  No one PyTorch call computes the fused MLP, so
    this route is ``fused_swiglu``'s library yardstick; written out here so
    that a change to the plain version cannot move it."""
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def time_swiglu(torch, ops, F, x, w, what: str) -> dict:
    """``fused_swiglu`` at x (silu, fp32) against its plain version, then
    timed beside the plain version, the cuBLAS route and its bound: the
    products as 3xTF32 on the tensor cores, or the weights and x, out read
    or written once."""
    T, D = x.shape
    Fd = w[0].shape[1]
    err = max_err(ops.fused_swiglu_op(x, *w), ops.plain_fused_swiglu(x, *w))
    check(err, TOL_FP32, f"fused_swiglu {what} T={T} D={D} F={Fd}")
    ms = time_ms([lambda: ops.fused_swiglu_op(x, *w)], torch)
    plain_ms = time_ms([lambda: ops.plain_fused_swiglu(x, *w)], torch)
    lib_ms = time_ms([lambda: cublas_swiglu(F, x, *w)], torch)
    bms, by = bound(4 * (3 * D * Fd + 2 * T * D), 0, tf32x3=6 * T * D * Fd)
    print(f"  fused_swiglu {what} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cuBLAS route {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"x ({T},{D}) wg/wu ({D},{Fd}) wd ({Fd},{D}) fp32"}


def phase_swiglu(torch, ops, F, dev) -> dict:
    D, Fd = 3072, 8192
    g = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(scale).to(dtype)

    w = (rnd(D, Fd, scale=D ** -0.5), rnd(D, Fd, scale=D ** -0.5), rnd(Fd, D, scale=Fd ** -0.5))
    # decode, a training micro-batch (2 x 256), the prefill (8 x 512)
    res = {T: time_swiglu(torch, ops, F, rnd(T, D), w, "phi3") for T in (8, 512, 4096)}
    for T in (8, 512):                     # no atomics: the same bits twice
        x = rnd(T, D)
        same = bitwise_equal(torch, ops.fused_swiglu_op(x, *w), ops.fused_swiglu_op(x, *w))
        print(f"  fused_swiglu T={T}: two runs bitwise {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"fused_swiglu T={T}: not deterministic")

    # both sides of the skinny / tensor-core switch at phi3's width; D and F
    # off the 16-byte chunks (staged element by element); the decode down
    # product split over F; gelu_tanh; bf16 on both paths
    for (T, d, f, act, dt) in [(16, D, Fd, "silu", torch.float32),
                               (17, D, Fd, "silu", torch.float32),
                               (5, 96, 200, "silu", torch.float32),
                               (7, 130, 250, "gelu_tanh", torch.float32),
                               (33, 100, 202, "silu", torch.float32),
                               (3, 130, 1000, "gelu_tanh", torch.float32),
                               (300, 256, 512, "gelu_tanh", torch.float32),
                               (64, 128, 256, "silu", torch.bfloat16),
                               (9, 136, 1024, "silu", torch.bfloat16)]:
        x = rnd(T, d, dtype=dt)
        ww = w if d == D else (rnd(d, f, scale=d ** -0.5, dtype=dt),
                               rnd(d, f, scale=d ** -0.5, dtype=dt),
                               rnd(f, d, scale=f ** -0.5, dtype=dt))
        e = max_err(ops.fused_swiglu_op(x, *ww, act), ops.plain_fused_swiglu(x, *ww, act))
        check(e, TOL_FP32 if dt == torch.float32 else TOL_BF16["swiglu"],
              f"fused_swiglu edge T={T} D={d} F={f} {act} {dt}")

    # sums of one sign over F = 24576 (Jamba's d_ff), on both paths: a sum
    # that the tensor core truncates would drift past the tolerance
    d, f = 1024, 24576
    ww = (rnd(d, f).abs_().mul_(d ** -0.5), rnd(d, f).abs_().mul_(d ** -0.5),
          rnd(f, d).abs_().mul_(f ** -0.5))
    for T in (8, 512):
        x = rnd(T, d).abs_()
        ref = ops.plain_fused_swiglu(x, *ww)
        e = max_err(ops.fused_swiglu_op(x, *ww), ref) / float(ref.abs().max())
        check(e, TOL_FP32, f"fused_swiglu one-sign T={T} D={d} F={f}, relative to max |plain|")
    del ww

    entry = {"name": "fused_swiglu", "route": "cuda",
             "source": "src/repro_torch/csrc/fused_swiglu.cu",
             "replaces": "src/repro/kernels/fused_swiglu.py:19", **res[8]}
    entry["prefill"] = res[4096]
    entry["train"] = res[512]
    return entry


# ---------------------------------------------------------------------------
# Phase 3b: the training slice's kernels against their plain versions
# ---------------------------------------------------------------------------


def wire_rows(torch, g, R, tile, fmt, dev):
    """(R, tile) float32 rows on the card: normal data at three scales, and
    the rows that decide rounding: all zero, exact int8 halves, fp8
    subnormals and their ties (each scaled so its scale is 1.0)."""
    x = torch.randn((R, tile), generator=g, device=dev)
    x.mul_(torch.tensor([1e-3, 1.0, 50.0], device=dev)[torch.arange(R, device=dev) % 3, None])
    top = 128.0 if fmt == "int8" else 256.0
    col = torch.arange(tile, device=dev, dtype=torch.float32)
    x[0] = 0.0
    x[1] = col % 64 - 32 + 0.5
    x[2] = 2.0 ** -10 * (col % 9) * torch.where(col % 2 == 1, 1.0, -1.0)
    x[1:3, 0] = top
    return x


def bitwise_equal(torch, a, b) -> bool:
    view = {1: torch.uint8, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def phase_quant(torch, dev) -> list:
    """quantize_tiles / dequantize_tiles, int8 and fp8, bitwise against the
    plain versions at the boundary shape and at the largest gradient leaf;
    roundtrip_ef at a bucket's size.  Timed at the largest leaf, int8."""
    from repro_torch.kernels import quant_transfer as qt
    from repro_torch.kernels.ref import naive_dequantize_tiles, naive_quantize_tiles

    g = torch.Generator(device=dev).manual_seed(14)
    tile = 256
    shapes = {"boundary": 2 * 256 * 3072 // tile,        # one (mb, S, D) stage output
              "largest_leaf": 32 * 3072 * 8192 // tile}   # stacked MLP weight gradient
    res = {"quantize_tiles": {}, "dequantize_tiles": {}}
    for fmt in qt.QUANT_FORMATS:
        for where, R in shapes.items():
            x = wire_rows(torch, g, R, tile, fmt, dev)
            q, s = qt.quantize_tiles(x, fmt=fmt)
            qr, sr = naive_quantize_tiles(x, fmt=fmt)
            back = qt.dequantize_tiles(q, s)
            ok = (bitwise_equal(torch, q, qr) and bitwise_equal(torch, s, sr)
                  and bitwise_equal(torch, back, naive_dequantize_tiles(qr, sr)))
            print(f"  quantize/dequantize {fmt} {where} ({R}, {tile}): bitwise "
                  f"{'equal' if ok else 'DIFFERENT'}")
            if not ok:
                raise AssertionError(f"quant kernels differ from the plain versions: "
                                     f"{fmt} {where}")
            if fmt == "int8" and where == "largest_leaf":
                n = R * tile
                qb = n + 4 * R
                for name, fn, plain, nbytes in [
                        ("quantize_tiles", lambda: qt.quantize_tiles(x, fmt=fmt),
                         lambda: naive_quantize_tiles(x, fmt=fmt), 4 * n + qb),
                        ("dequantize_tiles", lambda: qt.dequantize_tiles(q, s),
                         lambda: naive_dequantize_tiles(q, s), qb + 4 * n)]:
                    ms = time_ms([fn], torch)
                    plain_ms = time_ms([plain], torch)
                    bms, by = bound(nbytes, 0)
                    res[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bms, "bound_by": by, "library_ms": None,
                                 "shape": f"({R}, {tile}) f32 <-> int8 (largest gradient leaf)"}
                    print(f"  {name} int8 ({R}, {tile}): kernel {ms:.4f} ms, plain "
                          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
            if fmt == "int8" and where == "boundary":
                for name, fn in [("quantize_tiles", lambda: qt.quantize_tiles(x, fmt=fmt)),
                                 ("dequantize_tiles", lambda: qt.dequantize_tiles(q, s))]:
                    res[name]["boundary_ms"] = time_ms([fn], torch)
            del x, q, s, qr, sr, back
    # the error-feedback round trip at a bucket's size (256 MiB of float32)
    n = 256 * (1 << 20) // 4
    x = torch.randn(n, generator=g, device=dev)
    err = torch.randn(n, generator=g, device=dev).mul_(1e-3)
    for fmt in qt.QUANT_FORMATS:
        xh, e2 = qt.roundtrip_ef(x, err, fmt=fmt)
        comp = x + err
        qr, sr = naive_quantize_tiles(qt.pack_tiles(comp, tile), fmt=fmt)
        want = naive_dequantize_tiles(qr, sr).reshape(-1)
        ok = bitwise_equal(torch, xh, want) and bitwise_equal(torch, e2, comp - want)
        print(f"  roundtrip_ef {fmt} at {n} elements: bitwise {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise AssertionError(f"roundtrip_ef {fmt} differs from the plain versions")
    del x, err, xh, e2, comp, qr, sr, want
    torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda", "source": "src/repro_torch/csrc/quant_transfer.cu",
             "replaces": f"src/repro/kernels/quant_transfer.py:{line}", **res[name]}
            for name, line in (("quantize_tiles", 70), ("dequantize_tiles", 81))]


BWD_EDGES = [
    # (B, S, H, Hkv, D, window, causal, dtype): GQA, window, non-causal; the
    # tensor-core route at head_dim 32, 64, 96, 128 (and 40, padded to 64);
    # S = 1 and both sides of a 64-row tile; head_dim 100 (the SIMT route);
    # bf16 (held absolute and relative, as tests/test_torch_cuda.py holds it:
    # a bf16 gradient of 4 or more is 2^-5 or more a step)
    (2, 192, 8, 2, 64, None, True, "float32"),
    (1, 256, 4, 1, 128, 64, True, "float32"),
    (2, 130, 4, 4, 96, None, False, "float32"),
    (2, 200, 8, 2, 32, None, True, "float32"),
    (1, 300, 8, 2, 96, None, True, "float32"),
    (1, 256, 16, 2, 128, None, True, "float32"),
    (1, 200, 4, 2, 40, None, True, "float32"),
    (1, 190, 4, 4, 96, 70, False, "float32"),
    (3, 1, 8, 2, 64, None, True, "float32"),
    (2, 63, 8, 2, 96, None, True, "float32"),
    (2, 65, 4, 4, 128, None, True, "float32"),
    (1, 150, 4, 2, 100, None, True, "float32"),
    (2, 160, 4, 2, 64, None, True, "bfloat16"),
    (2, 128, 4, 1, 96, 50, True, "bfloat16"),
]


def flash_bwd_bound(B, S, H, D):
    """``flash_attention_bwd``'s least time: q, k, v, o and dO read once,
    dq, dk and dv written once, the logsumexp read (fp32), or its five
    products, 10·D flops a (query, valid key) pair, as 3xTF32 on the tensor
    cores."""
    pairs = B * H * (S * (S + 1) // 2)
    nbytes = 4 * (8 * B * S * H * D + B * H * S)
    return bound(nbytes, 0, tf32x3=10 * D * pairs)


def attention_bwd_float64(torch, q, k, v, dout):
    """(dq, dk, dv) of causal attention (B, S, H, D) with GQA, in float64:
    the closed form (dS = P (dP - rowsum(dO O))), a reference for sums too
    long for fp32."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qd, dd = (t.double().transpose(1, 2) for t in (q, dout))
    kd, vd = (t.double().repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = (qd @ kd.transpose(-1, -2) * D ** -0.5).masked_fill_(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    ds = p * (dd @ vd.transpose(-1, -2) - (dd * (p @ vd)).sum(-1, keepdim=True))
    dq = (ds @ kd * D ** -0.5).transpose(1, 2)
    dk = (ds.transpose(-1, -2) @ qd * D ** -0.5).transpose(1, 2)
    dv = (p.transpose(-1, -2) @ dd).transpose(1, 2)
    return dq, dk.reshape(B, S, Hkv, G, D).sum(3), dv.reshape(B, S, Hkv, G, D).sum(3)


def phase_flash_bwd(torch, ops, F, dev) -> dict:
    """The flash-attention backward at the training shape, causal, against
    autograd of the plain version, at edge cases, on a long one-sign case
    and for determinism; SDPA forward + backward as yardstick."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    B, S, H, D = 2, 256, 32, 96
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).mul_(0.5) for _ in range(3))
    dout = torch.randn((B, S, H, D), generator=g, device=dev)
    out, lse = flash_attention(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    want = ops.plain_flash_attention_bwd(q, k, v, dout)
    err = max(max_err(a, b) for a, b in zip(got, want))
    check(err, TOL_FP32, f"flash_attention_bwd ({B}, {S}, {H}, {D}) causal dq/dk/dv")
    same = all(bitwise_equal(torch, a, b) for a, b in
               zip(got, flash_attention_bwd(q, k, v, out, lse, dout)))
    print(f"  flash_attention_bwd ({B}, {S}, {H}, {D}): two runs bitwise "
          f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("flash_attention_bwd: not deterministic")

    for (b, s, h, hkv, d, win, causal, dtype) in BWD_EDGES:
        dt = getattr(torch, dtype)
        qq = torch.randn((b, s, h, d), generator=g, device=dev).mul_(0.5).to(dt)
        kk, vv = (torch.randn((b, s, hkv, d), generator=g, device=dev).mul_(0.5).to(dt)
                  for _ in range(2))
        do = torch.randn((b, s, h, d), generator=g, device=dev).to(dt)
        o, ls = flash_attention(qq, kk, vv, causal=causal, window=win, return_lse=True)
        pairs = list(zip(flash_attention_bwd(qq, kk, vv, o, ls, do, causal=causal, window=win),
                         ops.plain_flash_attention_bwd(qq, kk, vv, do, causal=causal,
                                                       window=win)))
        what = (f"flash_attention_bwd edge B={b} S={s} H={h} Hkv={hkv} D={d} window={win} "
                f"causal={causal} {dtype}")
        if dt == torch.float32:
            check(max(max_err(x, y) for x, y in pairs), TOL_FP32, what)
        else:
            check(max(max_err_rel(x, y) for x, y in pairs), TOL_BF16["attention"], what,
                  "max |err| / (1 + |plain|)")

    # 8192 causal rows, q/k in [0, 1), dO and V in [1, 1.1): one-sign sums
    # over up to 128 tiles (dV's over queries, dK's and dQ's too), which
    # the tensor core, which truncates, would drift on.  dV reaches ~20
    # here, where the plain version's own fp32 sums over 8192 queries are
    # off by more than 1e-4: the kernel is held to it absolute and relative
    # (as tests/test_torch_cuda.py holds it), and to a float64 evaluation of
    # the same function absolute.
    qq, kk = (torch.rand((1, 8192, n, 128), generator=g, device=dev) for n in (2, 1))
    vv = torch.rand((1, 8192, 1, 128), generator=g, device=dev).mul_(0.1).add_(1.0)
    do = torch.rand((1, 8192, 2, 128), generator=g, device=dev).mul_(0.1).add_(1.0)
    o, ls = flash_attention(qq, kk, vv, return_lse=True)
    got = flash_attention_bwd(qq, kk, vv, o, ls, do)
    what = "flash_attention_bwd long causal (1, 8192, 2/1, 128), dO and V around 1"
    check(max(max_err_rel(x, y) for x, y in zip(got, ops.plain_flash_attention_bwd(
        qq, kk, vv, do))), TOL_FP32, what, "max |err| / (1 + |plain|)")
    check(max(max_err(x, y) for x, y in zip(got, attention_bwd_float64(torch, qq, kk, vv, do))),
          TOL_FP32, what + ", against float64")
    del qq, kk, vv, do, o, ls, got

    ms = time_ms([lambda: flash_attention_bwd(q, k, v, out, lse, dout)], torch)
    plain_ms = time_ms([lambda: ops.plain_flash_attention_bwd(q, k, v, dout)], torch)
    qt_, kt_, vt_ = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dt_ = dout.transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(qt_, kt_, vt_, is_causal=True)
        torch.autograd.grad(o, (qt_, kt_, vt_), dt_)

    lib_ms = time_ms([sdpa], torch)
    bms, by = flash_bwd_bound(B, S, H, D)
    print(f"  flash_attention_bwd: kernel {ms:.4f} ms, plain (autograd) {plain_ms:.4f} ms, "
          f"SDPA fwd+bwd {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "note": "the gradient of that kernel's function; repro takes it by XLA autodiff",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"q/k/v/dO ({B},{S},{H},{D}) causal fp32"}


def phase_swiglu_bwd(torch, ops, dev) -> dict:
    """The SwiGLU backward at the training shape (T = 2 x 256): the
    elementwise kernel against its plain version, and the whole backward
    (kernel + products) against autograd of the plain MLP."""
    from repro_torch.kernels.fused_swiglu import swiglu_bwd
    from repro_torch.kernels.ref import naive_swiglu_act_bwd, naive_swiglu_bwd

    T, D, Fd = 512, 3072, 8192
    g = torch.Generator(device=dev).manual_seed(16)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    x = rnd(T, D)
    w = (rnd(D, Fd, scale=D ** -0.5), rnd(D, Fd, scale=D ** -0.5), rnd(Fd, D, scale=Fd ** -0.5))
    dout = rnd(T, D)
    gg, uu = x @ w[0], x @ w[1]
    dh = dout @ w[2].T
    got = swiglu_bwd(gg, uu, dh)
    err = max(max_err(a, b) for a, b in zip(got, naive_swiglu_act_bwd(gg, uu, dh)))
    check(err, TOL_ELEMENTWISE, f"swiglu_bwd elementwise ({T}, {Fd}) silu")
    xs = x.detach().requires_grad_(True)
    ws = [t.detach().requires_grad_(True) for t in w]
    full = torch.autograd.grad(ops.fused_swiglu_op(xs, *ws), (xs, *ws), dout)
    e_full = max(max_err(a, b) for a, b in zip(full, naive_swiglu_bwd(x, *w, dout)))
    check(e_full, TOL_FP32, f"SwiGLU backward (kernel + products) T={T} dx/dWg/dWu/dWd")
    gg2, uu2, dh2 = (rnd(300, 1000, scale=2.0) for _ in range(3))
    e = max(max_err(a, b) for a, b in zip(swiglu_bwd(gg2, uu2, dh2, "gelu_tanh"),
                                           naive_swiglu_act_bwd(gg2, uu2, dh2, "gelu_tanh")))
    check(e, TOL_ELEMENTWISE, "swiglu_bwd elementwise edge (300, 1000) gelu_tanh")

    ms = time_ms([lambda: swiglu_bwd(gg, uu, dh)], torch)
    plain_ms = time_ms([lambda: naive_swiglu_act_bwd(gg, uu, dh)], torch)
    full_ms = time_ms([lambda: torch.autograd.grad(ops.fused_swiglu_op(xs, *ws), (xs, *ws),
                                                   dout)], torch)
    plain_full_ms = time_ms([lambda: naive_swiglu_bwd(x, *w, dout)], torch)
    bms, by = bound(6 * 4 * T * Fd, 0)
    print(f"  swiglu_bwd ({T}, {Fd}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}); whole MLP fwd+bwd through the kernels {full_ms:.4f} ms, "
          f"plain autograd {plain_full_ms:.4f} ms")
    return {"name": "swiglu_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_swiglu_bwd.cu",
            "replaces": "src/repro/kernels/fused_swiglu.py:19",
            "note": "the gradient of that kernel's function; repro takes it by XLA autodiff",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "shape": f"g/u/dh ({T},{Fd}) fp32 silu",
            "mlp_fwd_bwd_ms": full_ms, "mlp_fwd_bwd_plain_ms": plain_full_ms}


# ---------------------------------------------------------------------------
# Phase 3c: the Mamba scan kernel against its plain version
# ---------------------------------------------------------------------------


def check_scan(got, want, what, tol=TOL_SCAN) -> float:
    """``|got - want| <= tol * (1 + |want|)`` everywhere (a recurrence
    kernel against its plain version); returns the max abs error."""
    diff = (got - want).abs()
    err = float(diff.max())
    excess = float((diff - tol * want.abs()).max())
    print(f"  {what}: max abs err {err:.3e}, max(|diff| - {tol:g} |plain|) "
          f"{excess:.3e} (tol {tol:g})")
    if not excess <= tol:
        raise AssertionError(f"{what}: kernel and plain version disagree")
    return err


def phase_mamba(torch, ops, F, dev) -> dict:
    """The scan at the Jamba prefill's shape, two runs bitwise equal, at
    edges, and on the long-memory draw (also against float64), then timed."""
    from repro_torch.kernels.ref import (MAMBA_EDGE_CASES, MAMBA_LONG_MEMORY_SHAPE,
                                         mamba_long_memory_inputs, mamba_scan_inputs,
                                         naive_mamba_scan)

    g = torch.Generator(device=dev).manual_seed(17)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    (B, S, d, N), _ = MAMBA_EDGE_CASES[0]
    inp = mamba_scan_inputs(randn, B, S, d, N)
    got = ops.mamba_scan_op(*inp)
    err = check_scan(got, naive_mamba_scan(*inp), f"mamba_scan ({B}, {S}, {d}, {N})")
    same = bitwise_equal(torch, got, ops.mamba_scan_op(*inp))
    print(f"  mamba_scan ({B}, {S}, {d}, {N}): two runs bitwise {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("mamba_scan: not deterministic")
    del got
    for shape, what in MAMBA_EDGE_CASES[1:]:
        e_in = mamba_scan_inputs(randn, *shape)
        check_scan(ops.mamba_scan_op(*e_in), naive_mamba_scan(*e_in),
                   f"mamba_scan edge {shape} {what}")
    # the model's init decays, memories of ~1000 steps, where an error of
    # the kernel's ex2.approx decay compounds; float64 on 512 channels a row
    lm = mamba_long_memory_inputs(randn, *MAMBA_LONG_MEMORY_SHAPE)
    got = ops.mamba_scan_op(*lm)
    what = f"mamba_scan long memory {MAMBA_LONG_MEMORY_SHAPE}"
    check_scan(got, naive_mamba_scan(*lm), what)
    k = 512
    want64 = naive_mamba_scan(*(t[..., :k].double() for t in lm[:4]), lm[4][:k].double())
    check_scan(got[..., :k].double(), want64, what + f", first {k} channels against float64")
    del lm, got, want64

    ms = time_ms([lambda: ops.mamba_scan_op(*inp)], torch)
    plain_ms = time_ms([lambda: naive_mamba_scan(*inp)], torch)
    nbytes = 4 * (3 * B * S * d + 2 * B * S * N + d * N)
    bms, by = bound(nbytes, 6 * B * S * d * N, exps=B * S * d * N)
    print(f"  mamba_scan: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}: bytes {bound(nbytes, 0)[0]:.4f}, exponentials on the SFU "
          f"{bound(0, 0, exps=B * S * d * N)[0]:.4f})")
    del inp
    return {"name": "mamba_scan", "route": "cuda", "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:25",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "shape": f"dt/x ({B},{S},{d}) b/c ({B},{S},{N}) a ({d},{N}) fp32"}


# ---------------------------------------------------------------------------
# Phase 3e: the RWKV-6 WKV kernel against its plain version
# ---------------------------------------------------------------------------


def phase_wkv(torch, ops, dev) -> dict:
    """The WKV at the rwkv6-7b prefill's shape, two runs bitwise equal, at
    edges, on a row whose logits exceed 0 in one chunk only (exact and
    tensor-core chunks on one state), and on the long-memory draw at the
    prefill's shape (also against float64 on 16 rows), then timed."""
    from repro_torch.kernels.ref import (WKV_EDGE_CASES, WKV_HOT_CHUNK_CASE,
                                         WKV_LONG_MEMORY_SHAPE, naive_wkv6, wkv6_hot_inputs,
                                         wkv6_inputs, wkv6_long_memory_inputs)

    g = torch.Generator(device=dev).manual_seed(19)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    for shape, logit_max, what in WKV_EDGE_CASES[1:]:
        e_in = wkv6_inputs(randn, *shape, logit_max)
        check_scan(ops.rwkv6_wkv_op(*e_in), ops.plain_rwkv6_wkv(*e_in),
                   f"rwkv6_wkv edge {shape} {what}", TOL_WKV)
    shape, hot, logit_max = WKV_HOT_CHUNK_CASE
    e_in = wkv6_hot_inputs(randn, *shape, hot, logit_max)
    check_scan(ops.rwkv6_wkv_op(*e_in), ops.plain_rwkv6_wkv(*e_in),
               f"rwkv6_wkv {shape}, logits up to {logit_max} at steps {hot[0]}..{hot[1] - 1} "
               "only (exact and tensor-core chunks on one state)", TOL_WKV)
    (B, H, S, d), logit_max, what = WKV_EDGE_CASES[0]
    inp = wkv6_inputs(randn, B, H, S, d, logit_max)
    got = ops.rwkv6_wkv_op(*inp)
    err = check_scan(got, ops.plain_rwkv6_wkv(*inp),
                     f"rwkv6_wkv ({B}, {H}, {S}, {d}) {what}, head views", TOL_WKV)
    same = bitwise_equal(torch, got, ops.rwkv6_wkv_op(*inp))
    print(f"  rwkv6_wkv ({B}, {H}, {S}, {d}): two runs bitwise {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("rwkv6_wkv: not deterministic")
    del got
    # the model's init decays (memories of 50-3000 steps) and one-sign r, k,
    # v: |out| ~ 1e4, where the tensor core's truncated sums would compound;
    # float64 on the first 16 (b, h) rows
    lm = wkv6_long_memory_inputs(randn, *WKV_LONG_MEMORY_SHAPE)
    got = ops.rwkv6_wkv_op(*lm)
    what = f"rwkv6_wkv long memory {WKV_LONG_MEMORY_SHAPE}"
    check_scan(got, ops.plain_rwkv6_wkv(*lm), what, TOL_WKV)
    rows = 16
    flat = [t.reshape(-1, *t.shape[2:])[:rows].double() for t in lm[:4]]
    want64 = naive_wkv6(*flat, lm[4].repeat(lm[0].shape[0], 1)[:rows].double())
    check_scan(got.reshape(-1, *got.shape[2:])[:rows].double(), want64,
               what + f", first {rows} rows against float64", TOL_WKV)
    del lm, got, flat, want64

    ms = time_ms([lambda: ops.rwkv6_wkv_op(*inp)], torch)
    plain_ms = time_ms([lambda: ops.plain_rwkv6_wkv(*inp)], torch)
    bms, by = wkv_bound(B, H, S, d)
    print(f"  rwkv6_wkv: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}; the 3xTF32 products {bound(0, 0, tf32x3=8 * B * H * S * d * d)[0]:.4f})")
    del inp
    return {"name": "rwkv6_wkv", "route": "cuda", "source": "src/repro_torch/csrc/rwkv6_wkv.cu",
            "replaces": "src/repro/kernels/rwkv6_wkv.py:27",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "shape": f"r/k/v/w ({B},{H},{S},{d}) head views of ({B},{S},{H * d}), "
                     f"u ({H},{d}) fp32"}


def wkv_bound(B, H, S, d):
    """``rwkv6_wkv``'s least time: r, k, v, w read and out written once, u
    read once; or, at d = 64, the chunked form's four 64^3 products per
    (row, 64-step chunk) as 3xTF32 on the tensor cores (at d = 32 the
    step-by-step form's ~4 d^2 fp32 operations a step)."""
    nbytes = 4 * (5 * B * H * S * d + H * d)
    if d == 64:
        return bound(nbytes, 0, tf32x3=8 * B * H * -(-S // 64) * 64 * d * d)
    return bound(nbytes, 4 * B * H * S * d * d)


# ---------------------------------------------------------------------------
# Phase 3d: the serving kernels at Jamba's shapes
# ---------------------------------------------------------------------------


def phase_jamba_kernels(torch, ops, F, dev, entries: dict) -> None:
    """Flash attention (2, 1024, 64, 128) GQA 8 causal, decode attention
    q (8, 64, 128) over a (8, 128, 8, 128) cache, SwiGLU 8192 x 24576 at
    T = 8 and 2048: each against its plain version, timed beside its bound
    (and SDPA, with the kv heads repeated outside the timed call); added to
    the kernel's entry under ``"jamba"``."""
    g = torch.Generator(device=dev).manual_seed(18)

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    B, S, H, Hkv, D = 2, 1024, 64, 8, 128
    q, k, v = rnd(B, S, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    err = max_err(ops.flash_attention_op(q, k, v), ops.plain_flash_attention(q, k, v))
    check(err, TOL_FP32, f"flash_attention Jamba ({B}, {S}, {H}/{Hkv}, {D}) causal")
    kt, vt = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for t in (k, v))
    ms = time_ms([lambda: ops.flash_attention_op(q, k, v)], torch)
    plain_ms = time_ms([lambda: ops.plain_flash_attention(q, k, v)], torch)
    lib_ms = time_ms([lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kt, vt, is_causal=True)], torch)
    bms, by = flash_bound(B, S, H, Hkv, D)
    entries["flash_attention"]["jamba"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "shape": f"q ({B},{S},{H},{D}) kv {Hkv} heads causal fp32"}
    print(f"  flash_attention Jamba: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    del q, k, v, kt, vt

    B, H, Hkv, S, D, _ = DECODE_SHAPES["jamba"]
    lens = torch.tensor(DECODE_SHAPES["jamba"][5], dtype=torch.int32, device=dev)
    q, k, v = rnd(B, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    err = max_err(ops.flash_decode_op(q, k, v, lens), ops.plain_flash_decode(q, k, v, lens))
    check(err, TOL_FP32, f"flash_decode Jamba q ({B}, {H}, {D}) cache ({B}, {S}, {Hkv}, {D})")
    a = sdpa_decode_args(torch, q, k, v, lens)
    ms = time_ms([lambda: ops.flash_decode_op(q, k, v, lens)], torch)
    plain_ms = time_ms([lambda: ops.plain_flash_decode(q, k, v, lens)], torch)
    lib_ms = time_ms([lambda: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                             attn_mask=a[3])], torch)
    total_len = int(lens.sum())
    bms, by = decode_bound("jamba")
    entries["flash_decode"]["jamba"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms,
        "shape": f"q ({B},{H},{D}) cache ({B},{S},{Hkv},{D}) lens sum {total_len} fp32"}
    print(f"  flash_decode Jamba: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    del q, k, v, a

    Dm, Fd = 8192, 24576
    w = (rnd(Dm, Fd, scale=Dm ** -0.5), rnd(Dm, Fd, scale=Dm ** -0.5), rnd(Fd, Dm, scale=Fd ** -0.5))
    entries["fused_swiglu"]["jamba"] = {
        "decode" if T == 8 else "prefill": time_swiglu(torch, ops, F, rnd(T, Dm, scale=1.0), w,
                                                       "Jamba")
        for T in (8, 2048)}
    del w
    torch.cuda.empty_cache()


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
    params_cpu = _tree_to(params, cpu)
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
    expect = {name: 0 for name in ops.LAUNCHES}      # training kernels: none
    expect.update({"flash_decode": cfg.n_layers * steps,
                   "fused_swiglu": cfg.n_layers * (steps + 1),
                   "flash_attention": cfg.n_layers})
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


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------


def _rel(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-12))


def _rel_l2(torch, a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-12))


def phase_train_parity(torch, dev) -> None:
    """Full width, 2 layers, 2 virtual stages x 2 micro-batches, card vs CPU:
    one uncompressed gradient, then one int8 step with error feedback through
    ``step_fn``, held against the CPU part by part (loss, gradient before the
    wire, the wire bitwise, the AdamW update)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW, tree_leaves, tree_map
    from repro_torch.runtime.train import (build_train_step, ef_zeros, init_train_state,
                                           wire_buckets)

    cfg = get_config("phi3-mini-3.8b").replace(n_layers=2)
    B, S, P, M = 2, 64, 2, 2
    batch_np = SyntheticLM(cfg.vocab_size, S).batch(0, B)
    cpu = torch.device("cpu")
    ts_card = build_train_step(cfg, B, stage=P, n_micro=M, device=dev)
    params, _ = init_train_state(1, ts_card)
    params_cpu = tree_map(lambda t: t.to(cpu), params)
    out = []
    for device, p in ((dev, params), (cpu, params_cpu)):
        ts = build_train_step(cfg, B, stage=P, n_micro=M, device=device)
        (loss, _), grads = ts.grad_fn(p, ts.shard_batch(batch_np))
        out.append((loss.cpu(), [t.cpu() for t in tree_leaves(grads)]))
        del grads
    (l_card, g_card), (l_cpu, g_cpu) = out
    if not bool(torch.isfinite(l_card)) or not all(bool(torch.isfinite(g).all()) for g in g_card):
        raise AssertionError("non-finite loss or gradient on the card")
    check(_rel(torch, l_card, l_cpu), TOL_TRAIN_LOSS,
          f"full-width 2-layer loss card vs CPU (P={P}, M={M}, {B}x{S}), relative")
    check(max(_rel(torch, a, b) for a, b in zip(g_card, g_cpu)), TOL_GRAD_REL,
          f"full-width 2-layer gradients card vs CPU, {len(g_card)} leaves, worst relative")
    del out, g_card, g_cpu

    # one int8 step with error feedback through step_fn on each side; the
    # optimizer records the (post-wire) gradients it is given
    seen = {}

    class RecordingAdamW(AdamW):
        def update(self, grads, state, params):
            seen["grads"] = [g.detach().to("cpu", copy=True) for g in tree_leaves(grads)]
            return super().update(grads, state, params)

    res = {}
    for side, device, p0 in (("card", dev, params), ("cpu", cpu, params_cpu)):
        opt = RecordingAdamW(lr=1e-3)
        ts = build_train_step(cfg, B, stage=P, n_micro=M, compress="int8", bucket_mb=256,
                              optimizer=opt, device=device)
        p = tree_map(torch.clone, p0)
        p, st, ef, loss, _ = ts.step_fn(p, opt.init(p), ts.init_ef(), ts.shard_batch(batch_np))
        res[side] = {"loss": loss.cpu(), "post": seen.pop("grads"),
                     "ef": {k: e.cpu() for k, e in ef.items()},
                     "params": [t.cpu() for t in tree_leaves(p)],
                     "m": [t.cpu() for t in tree_leaves(st.m)],
                     "v": [t.cpu() for t in tree_leaves(st.v)]}
        buckets, wire_spec = ts.buckets, ts.spec
        del p, st, ef
    card, host = res["card"], res["cpu"]
    live = all(bool(torch.isfinite(e).all()) for e in card["ef"].values()) and \
        any(float(e.abs().max()) > 0 for e in card["ef"].values())
    print(f"  int8 step, error feedback on: {len(card['ef'])} residual buckets on the card, "
          f"non-zero and finite: {live}")
    if not live:
        raise AssertionError("error-feedback residual is zero or not finite on the card")

    effect = _rel(torch, card["loss"], l_card)
    print(f"  int8 boundaries' effect on the card's loss, relative: {effect:.3e}")
    if not effect > TOL_INT8_LOSS:
        raise AssertionError(f"int8 boundaries moved the loss by {effect:.3e}, not more "
                             f"than TOL_INT8_LOSS {TOL_INT8_LOSS:g}: the loss check "
                             "could not tell a skipped boundary quantization")
    check(_rel(torch, card["loss"], host["loss"]), TOL_INT8_LOSS,
          "full-width 2-layer int8 step loss card vs CPU, relative")

    pre_card = _prewire(torch, card["post"], card["ef"], buckets)
    pre_cpu = _prewire(torch, host["post"], host["ef"], buckets)
    print("  int8 step gradients before the wire card vs CPU, worst leaf max|diff| / "
          f"max|value|: {max(_rel(torch, a, b) for a, b in zip(pre_card, pre_cpu)):.3e}")
    check(max(_rel_l2(torch, a, b) for a, b in zip(pre_card, pre_cpu)), TOL_INT8_GRAD,
          "int8 step gradients before the wire card vs CPU, worst leaf |diff| / |value| "
          "(2-norm)")

    # the CPU wire on the card's own pre-wire gradient gives the card's
    # written-back gradient leaves and residual, bit for bit
    wired = [t.clone() for t in pre_card]
    ef_cpu = wire_buckets(wire_spec, wired, ef_zeros(buckets, cpu), buckets)
    same = all(torch.equal(a, b) for a, b in zip(wired, card["post"])) and \
        all(torch.equal(ef_cpu[k], card["ef"][k]) for k in card["ef"])
    print(f"  int8 bucket wire ({len(buckets)} buckets) card vs CPU on the card's "
          f"pre-wire gradient: written-back gradients and residuals bitwise equal: {same}")
    if not same:
        raise AssertionError("the card's bucket wire disagrees with the CPU's")

    # AdamW on the CPU from the same start on the card's post-wire gradients
    opt = AdamW(lr=1e-3)
    p = tree_map(torch.clone, params_cpu)
    p, st = opt.update([g.clone() for g in card["post"]], opt.init(p), p)
    for name, mine, theirs in (("parameters", tree_leaves(p), card["params"]),
                               ("AdamW m", tree_leaves(st.m), card["m"]),
                               ("AdamW v", tree_leaves(st.v), card["v"])):
        check(max(_rel(torch, a, b) for a, b in zip(theirs, mine)), TOL_ADAMW_REL,
              f"int8 step updated {name} card vs CPU AdamW on the same gradients, "
              f"{len(mine)} leaves, worst relative")
    del params, params_cpu, res, card, host, pre_card, pre_cpu, wired, p, st
    torch.cuda.empty_cache()


def _prewire(torch, post, ef, buckets) -> list:
    """The gradient leaves before the wire, from those after it and the
    residual of a first error-feedback step (zero carried residual): per
    element ``g = x_hat + (g - x_hat)``, exact for int8, since the quantized
    value is 0 or within a factor 2 of ``g`` (Sterbenz)."""
    pre = [t.clone() for t in post]
    for bi, (_, idxs, sizes) in enumerate(buckets):
        r = ef[f"bucket{bi}"][0]
        off = 0
        for i, n in zip(idxs, sizes):
            pre[i].view(-1).add_(r[off:off + n])
            off += n
    return pre


def phase_train(torch, ops, dev, card: str) -> dict:
    """The slice at full width: ``launch/train``'s path in-process, 1 warm-up
    step and 4 timed steps, with the launch counts of every step held
    against what the path implies, the loss on step 0's batch re-measured
    after one step, peak memory, and a profiler table of one more step."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launcher

    cfg = get_config("phi3-mini-3.8b")
    L, P, M, B, S, steps = cfg.n_layers, 4, 4, 8, 256, 5
    argv = ["--arch", cfg.name, "--stage", str(P), "--n-micro", str(M), "--global-batch",
            str(B), "--seq", str(S), "--steps", str(steps), "--compress", "int8",
            "--bucket-mb", "256", "--no-error-feedback", "--log-every", "1"]
    marks = []
    loss_after = {}
    peaks, resident = [], []

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES)))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        resident.append(torch.cuda.memory_allocated(dev))
        if step == 0:
            loss_after[0] = float(ts.loss_fn(params, batch)[0])
            marks.append(("eval", dict(ops.LAUNCHES)))
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    peak = max(peaks + [torch.cuda.max_memory_allocated(dev)])
    print(f"  card memory: peak of each step {[round(x / 1e9, 3) for x in peaks]} GB; "
          f"held between steps (params, AdamW m and v) {resident[-1] / 1e9:.3f} GB")

    ts = res["ts"]
    hops, nb = M * (P - 1), len(ts.buckets)
    per_step = {"flash_decode": 0, "flash_attention": 2 * L * M, "flash_attention_bwd": L * M,
                "fused_swiglu": 2 * L * M, "swiglu_bwd": L * M,
                "quantize_tiles": 2 * hops + nb, "dequantize_tiles": 2 * hops + nb,
                "mamba_scan": 0, "rwkv6_wkv": 0}
    per_eval = {"flash_decode": 0, "flash_attention": L * M, "flash_attention_bwd": 0,
                "fused_swiglu": L * M, "swiglu_bwd": 0, "quantize_tiles": hops,
                "dequantize_tiles": hops, "mamba_scan": 0, "rwkv6_wkv": 0}
    prev = {k: 0 for k in launches}
    for label, snap in marks:
        delta = {k: snap[k] - prev[k] for k in snap}
        want = per_eval if label == "eval" else per_step
        print(f"  launches in {label}: {delta}")
        if delta != want:
            raise AssertionError(f"launch counts in {label} {delta} != {want}")
        prev = snap
    if prev != launches:
        raise AssertionError("kernels launched outside the counted steps")

    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(loss_after[0]):
        raise AssertionError(f"non-finite training loss {losses}")
    print(f"  loss on step 0's batch: {losses[0]:.6f} before the first step, "
          f"{loss_after[0]:.6f} after it")
    if not loss_after[0] < losses[0]:
        raise AssertionError("one step did not lower the loss on its own batch")
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    print(f"train phi3-mini-3.8b full width fp32, {P} virtual stages x {M} micro-batches, "
          f"batch {B}x{S}, int8 wire ({nb} gradient buckets): {ms_step:.1f} ms/step over "
          f"{res['timed_steps']} timed steps, {res['tok_s']:.1f} tok/s; peak memory "
          f"{peak / 1e9:.3f} GB (reckoned 66-68 GB); losses "
          f"{[round(x, 6) for x in losses]}; card {card}")

    params, opt_state = res["params"], res["opt_state"]
    del res
    batch = ts.shard_batch(SyntheticLM(cfg.vocab_size, S).batch(steps, B))
    step_memory(torch, ts, params, opt_state, batch, dev)
    busy_ms, wall_ms = profile_train_step(torch, ts, params, opt_state, batch)
    del params, opt_state, ts, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": peak / 1e9,
            "busy_ms": busy_ms, "wall_ms": wall_ms, "n_buckets": nb}


def step_memory(torch, ts, params, opt_state, batch, dev) -> None:
    """One more training step taken apart (the body of ``step_fn``), with
    the card's allocated and peak memory above the held state after each
    part: where the step's peak comes from."""
    from repro_torch.optim import AdamW, tree_map
    from repro_torch.runtime.pipeline import spmd_loss_fn
    from repro_torch.runtime.train import _bind_grads, wire_buckets

    gb = 1e9
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    parts = []

    def mark(name):
        torch.cuda.synchronize()
        parts.append(f"{name} {(torch.cuda.memory_allocated(dev) - base) / gb:.3f} "
                     f"(peak {(torch.cuda.max_memory_allocated(dev) - base) / gb:.3f})")
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    grads = tree_map(torch.zeros_like, params)
    bound = _bind_grads(params, grads)
    mark("gradient buffers")
    with torch.enable_grad():
        loss, _ = spmd_loss_fn(ts.spec)(bound, batch)
        mark("forward")
        loss.backward()
    del loss, bound
    mark("backward")
    wire_buckets(ts.spec, grads, {}, ts.buckets)
    mark("bucket wire")
    AdamW(lr=1e-3).update(grads, opt_state, params)
    mark("AdamW update")
    del grads
    mark("after")
    print(f"  step memory above the held {base / gb:.3f} GB, GB after each part: "
          + "; ".join(parts))


def profile_train_step(torch, ts, params, opt_state, batch):
    """``torch.profiler`` trace of one training step: the top kernels by
    device time and the device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.step_fn(params, opt_state, {}, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        print("  profiler trace holds no device time: busy share not measured")
        return None, wall_ms
    busy_ms = total_us / 1e3
    print(f"  train-step trace: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({busy_ms / wall_ms:.1%}; the profiler's own overhead included); top kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} launches  "
              f"{e.key[:90]}")
    # the port's own kernels, by the CUDA function names in csrc/
    ours = {"flash_attention_wgmma_kernel": "flash_attention",
            "flash_attention_simt_kernel": "flash_attention",
            "flash_bwd_row_dot_kernel": "flash_attention_bwd",
            "flash_bwd_dkdv_wgmma_kernel": "flash_attention_bwd",
            "flash_bwd_dq_wgmma_kernel": "flash_attention_bwd",
            "flash_bwd_dkdv_simt_kernel": "flash_attention_bwd",
            "flash_bwd_dq_simt_kernel": "flash_attention_bwd",
            "wgmma_gemm_kernel": "fused_swiglu", "skinny_kernel": "fused_swiglu",
            "swiglu_bwd_": "swiglu_bwd", "dequantize_": "dequantize_tiles",
            "quantize_": "quantize_tiles"}
    by_kernel: dict = {}
    for e in kernels:
        for tag, name in ours.items():
            if f"(anonymous namespace)::{tag}" in e.key:
                ms, n = by_kernel.get(name, (0.0, 0))
                by_kernel[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
                break
    print("  the port's kernels in that step: " + "; ".join(
        f"{name} {ms:.2f} ms / {n} CUDA launches" for name, (ms, n) in sorted(by_kernel.items())))
    return busy_ms, wall_ms


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


# ---------------------------------------------------------------------------
# Phase 6c: the paper's loop: profile -> plan -> lower -> train
# ---------------------------------------------------------------------------


def phase_plan_train(torch, ops, dev, card: str) -> dict:
    """Full width: ``launch.profile`` measures phi3 into an artifact (4
    virtual devices of 20 GB), ``launch.train --plan --profile`` plans it
    (``plan_hpp``), lowers it and trains 4 steps (1 warm-up) on the
    planner's period split, with the launch counts of every step and of one
    forward-only evaluation held against what the plan implies; the plan's
    prediction beside the measured step."""
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import simulate
    from repro_torch.launch import profile as profiler_cli
    from repro_torch.launch import train as launcher
    from repro_torch.optim import tree_leaves

    cfg = get_config("phi3-mini-3.8b")
    L, M, B, S, steps, n_dev = cfg.n_layers, 4, 8, 256, 4, 4
    out_dir = ROOT / "profiles"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "phase6c_profile.json")
    print("phase 6c (a): profile full-width phi3 on the card")
    t0 = time.perf_counter()
    profiler_cli.main(["--arch", cfg.name, "--seq", str(S), "--batches", "1,2,4,8",
                       "--replicate", str(n_dev), "--mem-gb", "20", "-o", path])
    print(f"  profiled in {time.perf_counter() - t0:.1f}s; card {card}")
    torch.cuda.empty_cache()

    print("phase 6c (b): plan, lower and train through launch.train --plan --profile")
    argv = ["--plan", "--profile", path, "--devices", str(n_dev), "--global-batch", str(B),
            "--n-micro", str(M), "--seq", str(S), "--compress", "int8", "--bucket-mb", "256",
            "--no-error-feedback", "--steps", str(steps), "--log-every", "1"]
    marks, peaks, loss_after = [], [], {}

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES)))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        if step == 0:
            loss_after[0] = float(ts.loss_fn(params, batch)[0])
            marks.append(("eval", dict(ops.LAUNCHES)))
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    plan, lowered, prof, ts = res["plan"], res["lowered"], res["profile"], res["ts"]
    if prof.source != "measured":
        raise AssertionError(f"the plan was made on the {prof.source} profile, not the "
                             "measured artifact")
    held = tree_leaves(res["params"]["periods"])[0].shape[0]
    if ts.spec.stage_periods != lowered.stage_periods or held != cfg.n_periods:
        raise AssertionError(f"the step runs the split {ts.spec.stage_periods} on {held} "
                             f"periods; the plan lowered to {lowered.stage_periods} of "
                             f"{cfg.n_periods}")

    P = lowered.stage
    hops, nb = M * (P - 1), len(ts.buckets)
    per_step = {"flash_decode": 0, "flash_attention": 2 * L * M, "flash_attention_bwd": L * M,
                "fused_swiglu": 2 * L * M, "swiglu_bwd": L * M,
                "quantize_tiles": 2 * hops + nb, "dequantize_tiles": 2 * hops + nb,
                "mamba_scan": 0, "rwkv6_wkv": 0}
    per_eval = {"flash_decode": 0, "flash_attention": L * M, "flash_attention_bwd": 0,
                "fused_swiglu": L * M, "swiglu_bwd": 0, "quantize_tiles": hops,
                "dequantize_tiles": hops, "mamba_scan": 0, "rwkv6_wkv": 0}
    prev = {k: 0 for k in launches}
    for label, snap in marks:
        delta = {k: snap[k] - prev[k] for k in snap}
        want = per_eval if label == "eval" else per_step
        print(f"  launches in {label}: {delta}")
        if delta != want:
            raise AssertionError(f"launch counts in {label} {delta} != {want}")
        prev = snap
    if prev != launches:
        raise AssertionError("kernels launched outside the counted steps")
    print(f"  boundary round trips: {hops} forward (the evaluation's quantize launches) and "
          f"{hops} backward per step (M (P - 1) = {M} x {P - 1}), {nb} gradient buckets")

    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(loss_after[0]):
        raise AssertionError(f"non-finite training loss {losses}")
    if not loss_after[0] < losses[0]:
        raise AssertionError("one step did not lower the loss on its own batch")
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    peak = max(peaks)
    sim = simulate(plan, prof)
    work_s = sum(sim.device_busy.values())
    bounds = plan.memory_per_device(prof)
    print(f"  plan: {P} stages, periods {lowered.stage_periods}, groups "
          f"{lowered.device_groups}, alloc {lowered.micro_alloc}, K_p {lowered.warmup}; "
          f"Eq. 3 bounds {[round(bounds[d] / 1e9, 3) for d in sorted(bounds)]} GB")
    print(f"plan_train phi3-mini-3.8b full width fp32 from the measured profile: "
          f"predicted round latency {plan.latency * 1e3:.1f} ms ({n_dev} devices in "
          f"parallel), simulated {sim.makespan * 1e3:.1f} ms, summed device work "
          f"{work_s * 1e3:.1f} ms (one card runs it in turn); measured {ms_step:.1f} ms/step "
          f"over {res['timed_steps']} timed steps, {res['tok_s']:.1f} tok/s; peak memory "
          f"{peak / 1e9:.3f} GB; losses {[round(x, 6) for x in losses]}, "
          f"{loss_after[0]:.6f} on step 0's batch after it; card {card}")
    del res, ts, held
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": peak / 1e9,
            "predicted_ms": plan.latency * 1e3, "work_ms": work_s * 1e3,
            "stage_periods": lowered.stage_periods}


def phase_split_parity(torch, dev) -> None:
    """A planner split with unequal stages, ((0, 1), (1, 4)), at full width
    and 4 layers, card vs CPU: the stack holds the 4 periods unpadded; one
    uncompressed gradient (loss and every leaf) with phase 6a's tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.core.lowering import LoweredPlan
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.runtime.train import build_train_step_from_lowered, init_train_state

    cfg = get_config("phi3-mini-3.8b").replace(n_layers=4)
    B, S, M = 2, 64, 2
    lowered = LoweredPlan(arch=cfg.name, stage=2, n_micro=M, micro_batch=B // M,
                          global_batch=B, n_periods=4, stage_periods=((0, 1), (1, 4)),
                          stage_layers=((0, 2), (2, 6)), device_groups=((0,), (1,)),
                          micro_alloc=((B // M,), (B // M,)), warmup=(3, 1))
    batch_np = SyntheticLM(cfg.vocab_size, S).batch(0, B)
    cpu = torch.device("cpu")
    ts_card = build_train_step_from_lowered(cfg, 2, lowered, device=dev)
    params, _ = init_train_state(2, ts_card)
    held = tree_leaves(params["periods"])[0].shape[0]
    if held != 4:
        raise AssertionError(f"the split's period stack holds {held} periods, not 4")
    params_cpu = tree_map(lambda t: t.to(cpu), params)
    out = []
    for device, p in ((dev, params), (cpu, params_cpu)):
        ts = build_train_step_from_lowered(cfg, 2, lowered, device=device)
        (loss, _), grads = ts.grad_fn(p, ts.shard_batch(batch_np))
        out.append((loss.cpu(), [t.cpu() for t in tree_leaves(grads)]))
        del grads
    (l_card, g_card), (l_cpu, g_cpu) = out
    if not bool(torch.isfinite(l_card)) or not all(bool(torch.isfinite(g).all()) for g in g_card):
        raise AssertionError("non-finite loss or gradient on the card")
    check(_rel(torch, l_card, l_cpu), TOL_TRAIN_LOSS,
          f"full-width 4-layer split {lowered.stage_periods} loss card vs CPU, relative")
    check(max(_rel(torch, a, b) for a, b in zip(g_card, g_cpu)), TOL_GRAD_REL,
          f"full-width 4-layer split gradients card vs CPU, {len(g_card)} leaves, worst relative")
    del params, params_cpu, out, g_card, g_cpu
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6d: the pipeline replay: double buffering, staleness 1, a failure
# ---------------------------------------------------------------------------


def _bits_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _split_lowered(cfg, B, M):
    from repro_torch.core.lowering import LoweredPlan
    return LoweredPlan(arch=cfg.name, stage=2, n_micro=M, micro_batch=B // M,
                       global_batch=B, n_periods=4, stage_periods=((0, 1), (1, 4)),
                       stage_layers=((0, 2), (2, 6)), device_groups=((0,), (1,)),
                       micro_alloc=((B // M,), (B // M,)), warmup=(3, 1))


def phase_double_buffer(torch, ops, dev) -> None:
    """6d (a): on phase 6c (e)'s split at 4 full-width layers, the gradient
    with the boundary round trips on a second stream against the
    synchronous pipeline's: loss and every leaf bit for bit, the same
    kernel launches, without and with the int8 wire."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.train import build_train_step_from_lowered, init_train_state

    cfg = get_config("phi3-mini-3.8b").replace(n_layers=4)
    B, S, M = 4, 256, 4
    lowered = _split_lowered(cfg, B, M)
    batch_np = SyntheticLM(cfg.vocab_size, S).batch(0, B)
    params = None
    for compress in ("none", "int8"):
        kw = dict(compress=compress, bucket_mb=256 if compress != "none" else None,
                  error_feedback=False, device=dev)
        runs = []
        for db in (False, False, True):
            ts = build_train_step_from_lowered(cfg, 2, lowered, double_buffer=db, **kw)
            if params is None:
                params, _ = init_train_state(4, ts)
            batch = ts.shard_batch(batch_np)
            before = dict(ops.LAUNCHES)
            if ts.spec.bucketed:
                (loss, _), grads, _ = ts.grad_fn(params, batch, ts.init_ef())
            else:
                (loss, _), grads = ts.grad_fn(params, batch)
            torch.cuda.synchronize(dev)
            launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
            runs.append((loss.view(1), tree_leaves(grads), launches))
        (l0, g0, n0), (l1, g1, n1), (l2, g2, n2) = runs
        if not (_bits_equal(torch, l0, l1) and all(_bits_equal(torch, a, b)
                                                   for a, b in zip(g0, g1))):
            raise AssertionError(f"{compress}: two synchronous gradients differ on the card")
        same = _bits_equal(torch, l0, l2) and all(_bits_equal(torch, a, b)
                                                  for a, b in zip(g0, g2))
        print(f"  {compress} wire, split {lowered.stage_periods}, M {M}: double-buffered "
              f"loss and {len(g2)} gradient leaves bitwise the synchronous: {same}; "
              f"launches {n2} (synchronous {n0})")
        if not same:
            raise AssertionError(f"{compress}: double-buffered gradient != synchronous")
        if n2 != n0 or n1 != n0:
            raise AssertionError(f"{compress}: launches {n2} with double buffering, {n0} "
                                 "without")
        if compress == "int8" and n2["quantize_tiles"] != 2 * M + len(ts.buckets):
            raise AssertionError(f"int8: {n2['quantize_tiles']} quantize launches, not "
                                 f"2 M (P - 1) + buckets = {2 * M + len(ts.buckets)}")
        del runs, g0, g1, g2, grads
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _train_counts(L, M, P, nb):
    hops = M * (P - 1)
    return {"flash_decode": 0, "flash_attention": 2 * L * M, "flash_attention_bwd": L * M,
            "fused_swiglu": 2 * L * M, "swiglu_bwd": L * M,
            "quantize_tiles": 2 * hops + nb, "dequantize_tiles": 2 * hops + nb,
            "mamba_scan": 0, "rwkv6_wkv": 0}


def _check_marks(marks, launches, want_of):
    prev = {k: 0 for k in launches}
    for label, snap, extra in marks:
        delta = {k: snap[k] - prev[k] for k in snap}
        want = want_of(label, extra)
        print(f"  launches in {label}: {delta}")
        if delta != want:
            raise AssertionError(f"launch counts in {label} {delta} != {want}")
        prev = snap
    if prev != launches:
        raise AssertionError("kernels launched outside the counted steps")


def phase_stale_train(torch, ops, dev, card: str, plan_train: dict) -> dict:
    """6d (b): ``launch.train --plan --profile <6c's artifact> --staleness 1``
    at 32 layers: launch counts, round 0 without an update, the flush, the
    peak memory beside 6c's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher

    cfg = get_config("phi3-mini-3.8b")
    L, M, B, S, steps = cfg.n_layers, 4, 8, 256, 4
    path = str(ROOT / "profiles" / "phase6c_profile.json")
    argv = ["--plan", "--profile", path, "--devices", "4", "--global-batch", str(B),
            "--n-micro", str(M), "--seq", str(S), "--compress", "int8", "--bucket-mb", "256",
            "--no-error-feedback", "--staleness", "1", "--steps", str(steps),
            "--log-every", "1"]
    marks, peaks, evals = [], [], {}

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES), None))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        if step == 0:
            evals["batch"] = batch
        if step in (0, 1):
            evals[step] = float(ts.loss_fn(params, evals["batch"])[0])
            marks.append((f"eval after step {step}", dict(ops.LAUNCHES), "eval"))
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    ts, lowered = res["ts"], res["lowered"]
    if ts.spec.staleness != 1 or not ts.spec.double_buffer:
        raise AssertionError(f"the step runs staleness {ts.spec.staleness}, double buffer "
                             f"{ts.spec.double_buffer}")
    P, nb = lowered.stage, len(ts.buckets)
    step_counts = _train_counts(L, M, P, nb)
    hops = M * (P - 1)
    eval_counts = {"flash_decode": 0, "flash_attention": L * M, "flash_attention_bwd": 0,
                   "fused_swiglu": L * M, "swiglu_bwd": 0, "quantize_tiles": hops,
                   "dequantize_tiles": hops, "mamba_scan": 0, "rwkv6_wkv": 0}
    _check_marks(marks, launches, lambda label, extra: eval_counts if extra else step_counts)
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    # round 0 takes gradients only: the parameters after it are the initial
    # ones, so an evaluation on its batch reads its own loss
    if abs(evals[0] - losses[0]) > 1e-6 * abs(losses[0]):
        raise AssertionError(f"round 0 changed the parameters: loss {losses[0]}, "
                             f"{evals[0]} after it")
    if not evals[1] < losses[0]:
        raise AssertionError("round 1's update (round 0's gradients) did not lower the "
                             "loss on round 0's batch")
    if int(res["opt_state"].step) != steps:
        raise AssertionError(f"{int(res['opt_state'].step)} updates after {steps} rounds "
                             "and the flush")
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    peak = max(peaks)
    print(f"  round 0: loss {losses[0]:.6f}, evaluation after it {evals[0]:.6f} (no "
          f"update); after round 1 {evals[1]:.6f}; {int(res['opt_state'].step)} updates "
          f"after the flush")
    print(f"stale_train phi3-mini-3.8b full width fp32, staleness 1, double-buffered "
          f"boundaries, plan periods {lowered.stage_periods}: {ms_step:.1f} ms/step over "
          f"{res['timed_steps']} timed steps (6c sync: {plan_train['ms_per_step']:.1f}); "
          f"peak memory {peak / 1e9:.3f} GB (6c sync: {plan_train['peak_gb']:.3f} GB); "
          f"losses {[round(x, 6) for x in losses]}; card {card}")
    if peak / 1e9 > plan_train["peak_gb"] + 1.0:
        raise AssertionError(f"staleness-1 peak {peak / 1e9:.3f} GB is more than 1 GB above "
                             f"the synchronous step's {plan_train['peak_gb']:.3f} GB")
    del res, ts
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": peak / 1e9}


def _host_rows(tree, lo, hi):
    from repro_torch.optim import tree_leaves
    return [t[lo:hi].cpu() for t in tree_leaves(tree)]


def phase_fail_train(torch, ops, dev, card: str) -> dict:
    """6d (c): a failure at full width.  6c's measurement retiled into 3
    virtual devices of 36 GB (two survivors hold the 61.1 GB of state),
    model axis 6; ``launch.train --plan --staleness 1 --fail-at 3`` of the
    last stage's device with backups every 2 steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiler import load_profile, save_profile
    from repro_torch.launch import profile as profiler_cli
    from repro_torch.launch import train as launcher
    from repro_torch.optim import tree_leaves

    cfg = get_config("phi3-mini-3.8b")
    L, M, B, S, steps, n_dev, axis, gb = cfg.n_layers, 4, 8, 256, 5, 3, 6, 36
    src = str(ROOT / "profiles" / "phase6c_profile.json")
    path = str(ROOT / "profiles" / "phase6d_profile.json")
    t0 = time.perf_counter()
    save_profile(path, profiler_cli.retile(load_profile(src), n_dev, gb * 1e9))
    print(f"  6c's measurement retiled into {n_dev} devices of {gb} GB in "
          f"{time.perf_counter() - t0:.2f}s (no layer timed again)")
    base = ["--plan", "--profile", path, "--devices", str(axis), "--global-batch", str(B),
            "--n-micro", str(M), "--seq", str(S), "--compress", "int8", "--bucket-mb", "256",
            "--no-error-feedback", "--staleness", "1"]
    plan0, _ = launcher._plan(launcher._parse(base), cfg, load_profile(path), axis, dev)
    last = plan0.stages[-1]
    if len(last.group) != 1:
        raise AssertionError(f"the plan's last stage {last} is not a single device")
    rank = last.group[0]
    argv = base + ["--fail-at", "3", "--fail-rank", str(rank), "--backup-every", "2",
                   "--steps", str(steps), "--log-every", "1"]
    marks, peaks, wall, got = [], [], {}, {}
    stamps = []

    def timed(session, name, record=None):
        fn = getattr(session, name)

        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            wall.setdefault(name, []).append(time.perf_counter() - t)
            if record is not None:
                record(out, *a)
            return out
        setattr(session, name, run)

    def on_session(session):
        got["session"] = session
        got["plan_before"] = [(st.layers, st.group) for st in session.plan.stages]
        got["periods_before"] = session.lowered.stage_periods

        def backed_up(_out):
            got.setdefault("backups", []).append(
                (session.step_count, session.store.bytes_transferred))

        timed(session, "backup_now", lambda out, *a: backed_up(out))
        timed(session, "replan")
        timed(session, "recover_now")
        timed(session, "flush_gradients")

        migrate = session.migrate

        def migrate_watched(report):
            # after the flush, before anything moves: the rows of every
            # stage that survives, on the host (the checks' own copies are
            # timed apart, and left out of the recovery's split)
            t = time.perf_counter()
            q = next(p for p, st in enumerate(session.plan.stages) if rank in st.group)
            i, j = session.lowered.stage_periods[q]
            got["lost"] = (q, i, j, session.store.meta(q)["step"])
            got["kept"] = [(lo, hi, _host_rows(session.params["periods"], lo, hi))
                           for lo, hi in ((0, i), (j, cfg.n_periods)) if hi > lo]
            got["embed"] = session.params["embed"].cpu()
            snap = session.store.restore(q)
            got["backup"] = ([t.clone() for t in tree_leaves(snap["rows"])],
                             {k: [t.clone() for t in tree_leaves(v)]
                              for k, v in snap["extras"].items()})
            wall["checks"] = [time.perf_counter() - t]
            result = migrate(report)
            t = time.perf_counter()
            got["kept_ok"] = all(
                _bits_equal(torch, a[lo:hi].cpu(), b) for lo, hi, rows in got["kept"]
                for a, b in zip(tree_leaves(session.params["periods"]), rows))
            if "embed" not in got["backup"][1]:
                got["kept_ok"] &= _bits_equal(torch, session.params["embed"].cpu(),
                                              got["embed"])
            wall["checks"].append(time.perf_counter() - t)
            return result

        session.migrate = migrate_watched
        restore = session._restore_stage

        def restore_watched(tree, q, new_lp):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = restore(tree, q, new_lp)
            wall.setdefault("restore", []).append(time.perf_counter() - t)
            t = time.perf_counter()
            _, i, j, _ = got["lost"]
            rows, extras = got["backup"]
            got["restored_rows_equal"] = all(
                _bits_equal(torch, a[i:j].cpu(), b)
                for a, b in zip(tree_leaves(tree["periods"]), rows))
            got["restored_extras_equal"] = all(
                _bits_equal(torch, a.cpu(), b) for k, v in extras.items()
                for a, b in zip(tree_leaves(tree[k]), v))
            wall["checks"].append(time.perf_counter() - t)
            return out

        session._restore_stage = restore_watched

    def after_step(step, ts, params, batch):
        torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())
        session = got["session"]
        marks.append((f"step {step}", dict(ops.LAUNCHES),
                      (session.lowered.stage, len(ts.buckets))))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    res = launcher.main(argv, after_step=after_step, on_session=on_session)
    launches = dict(ops.LAUNCHES)
    session = res["session"]
    _check_marks(marks, launches, lambda label, extra: _train_counts(L, M, *extra))
    if len(session.recoveries) != 1:
        raise AssertionError(f"{len(session.recoveries)} recoveries, not 1")
    out = session.recoveries[0]
    rep = out.report
    q, i, j, backup_step = got["lost"]
    print(f"  plan before: {got['plan_before']}, periods {got['periods_before']}; "
          f"failed rank {rank} (stage {q}, periods [{i}, {j}), backed up at step "
          f"{backup_step})")
    print(f"  plan after: {[(st.layers, st.group) for st in session.plan.stages]}, "
          f"periods {session.lowered.stage_periods}, mode {out.mode}")
    print(f"  RecoveryReport: detection {rep.detection_s:.3f} s, replan "
          f"{rep.replan_s * 1e3:.3f} ms, migration {rep.migration_s:.3f} s, restore "
          f"{rep.restore_s:.3f} s (the virtual cluster's links, 1000 Mbps), boundary moves "
          f"{[(m.boundary, m.lo, m.hi, m.nbytes) for m in rep.boundary_moves]}; "
          f"moved periods {out.migration.moved_periods}, restored {out.restored_periods}, "
          f"migration bytes {out.migration.total_bytes:.0f}; reconciliation "
          f"{out.reconciliation}")
    print(f"  restored rows and edge leaves bitwise the step-{backup_step} backup: "
          f"{got['restored_rows_equal'] and got['restored_extras_equal']}; every other "
          f"row bitwise untouched by the migration: {got['kept_ok']}")
    if backup_step != 2:
        raise AssertionError(f"the restored backup was taken at step {backup_step}, not 2")
    if out.mode != "lightweight" or out.restored_stage != q:
        raise AssertionError(f"recovery mode {out.mode}, restored stage {out.restored_stage}")
    if not (got["restored_rows_equal"] and got["restored_extras_equal"]):
        raise AssertionError("the restored rows or edge leaves differ from the backup")
    if not got["kept_ok"]:
        raise AssertionError("a surviving row changed in the migration")
    if out.reconciliation is None or any(
            r["table_bytes"] != r["analytic_bytes"] for r in out.reconciliation.values()):
        raise AssertionError(f"reconciliation {out.reconciliation}")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    checks = sum(wall["checks"])
    recover = wall["recover_now"][0] - checks
    flush = wall["flush_gradients"][0]
    backups = got["backups"]
    # backups at step 2, the re-seed inside the recovery, and step 4
    if [b[0] for b in backups] != [2, 3, 4]:
        raise AssertionError(f"backups at steps {[b[0] for b in backups]}, not 2, 3 "
                             "(the re-seed) and 4")
    reseed = wall["backup_now"][1]
    per_step = [b - a for a, b in zip([t_start] + stamps[:-1], stamps)]
    first_after = stamps[3] - stamps[2] - wall["recover_now"][0]
    one_backup_s = wall["backup_now"][0]
    one_backup_bytes = backups[0][1]
    rest = recover - flush - wall["replan"][0] - wall["restore"][0] - reseed
    print(f"  recover_now wall {recover * 1e3:.1f} ms (less {checks * 1e3:.1f} ms of this "
          f"phase's own copies and checks): staleness flush {flush * 1e3:.1f} ms, replan "
          f"{wall['replan'][0] * 1e3:.1f} ms, restore from host {wall['restore'][0] * 1e3:.1f} "
          f"ms, re-seeded backups {reseed * 1e3:.1f} ms, the rest (detection on the "
          f"simulated clock, migration, reconciliation, install) {rest * 1e3:.1f} ms; first "
          f"step after {first_after * 1e3:.1f} ms")
    print(f"  backup_now: {one_backup_s * 1e3:.1f} ms for {one_backup_bytes / 1e9:.3f} GB "
          f"({one_backup_bytes / one_backup_s / 1e9:.2f} GB/s into pinned host memory); "
          f"all backups (step, cumulative bytes) {backups}, wall {[round(x * 1e3, 1) for x in wall['backup_now']]} ms")
    print(f"fail_train phi3-mini-3.8b full width fp32, {n_dev} x {gb} GB virtual devices, "
          f"staleness 1: step wall {[round(x * 1e3, 1) for x in per_step]} ms (step 3 "
          f"holds the recovery); peak memory {max(peaks) / 1e9:.3f} GB; losses "
          f"{[round(x, 6) for x in losses]}; card {card}")
    got.clear()
    del res, session, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "recover_ms": recover * 1e3, "peak_gb": max(peaks) / 1e9,
            "first_step_after_ms": first_after * 1e3,
            "backup_ms": one_backup_s * 1e3, "backup_gb": one_backup_bytes / 1e9,
            "step_ms": [x * 1e3 for x in per_step]}


# ---------------------------------------------------------------------------
# Phase 7: Jamba-1.5-Large without experts, one 8-layer period
# ---------------------------------------------------------------------------


def phase_jamba_layers(torch, dev) -> None:
    """Full width, card vs CPU: the Mamba+MLP layer (index 0) and the
    attention+MLP layer (index 2), made on the card from a seed and copied to
    the CPU; ``apply_layer`` on (1, 256) tokens, then 8 ``decode_layer``
    steps at batch 2 from fresh states."""
    from repro_torch.configs.jamba_1_5_large import config_without_experts
    from repro_torch.models.blocks import apply_layer, decode_layer, init_layer, init_layer_state

    cfg = config_without_experts()
    cpu = torch.device("cpu")
    S, B, steps = 256, 2, 8
    g = torch.Generator().manual_seed(20)
    x = torch.randn((1, S, cfg.d_model), generator=g)
    xs = [torch.randn((B, cfg.d_model), generator=g) for _ in range(steps)]
    positions = torch.arange(S, dtype=torch.int32)[None]
    for index in (0, 2):
        spec = cfg.pattern[index]
        p_card = init_layer(torch.Generator(device=dev).manual_seed(21 + index), cfg, spec, dev)
        p_cpu = _tree_to(p_card, cpu)
        with torch.inference_mode():
            y_card = apply_layer(p_card, x.to(dev), positions.to(dev), cfg, spec).cpu()
            y_cpu = apply_layer(p_cpu, x, positions, cfg, spec)
            if not bool(torch.isfinite(y_card).all()):
                raise AssertionError(f"non-finite {spec.kind} layer output on the card")
            check(_rel(torch, y_card, y_cpu), TOL_JAMBA_LAYER,
                  f"Jamba {spec.kind}+mlp layer apply_layer (1, {S}) card vs CPU, "
                  "max|diff| / max|value|")
            st_card = init_layer_state(B, steps, cfg, spec, torch.float32, dev)
            st_cpu = init_layer_state(B, steps, cfg, spec, torch.float32, cpu)
            worst = 0.0
            for t in range(steps):
                yc, st_card = decode_layer(p_card, xs[t].to(dev), t, st_card, cfg, spec)
                yh, st_cpu = decode_layer(p_cpu, xs[t], t, st_cpu, cfg, spec)
                worst = max(worst, _rel(torch, yc.cpu(), yh))
            check(worst, TOL_JAMBA_LAYER, f"Jamba {spec.kind}+mlp layer {steps} decode_layer "
                                          f"steps (batch {B}) card vs CPU, worst step")
        del p_card, p_cpu, st_card, st_cpu
        torch.cuda.empty_cache()


def phase_jamba_serve(torch, ops, dev, card: str) -> dict:
    """The 8-layer period at full width on the card: 7b, prefill against
    lockstep decode; 7c, serving (timed prefill 2 x 1024, lockstep decode at
    batch 8, launch counts, peak memory, device-busy share)."""
    from repro_torch.configs.jamba_1_5_large import config_without_experts
    from repro_torch.launch.serve import lockstep_decode
    from repro_torch.models.model import init_model
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    cfg = config_without_experts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  weights {n_bytes / 1e9:.3f} GB ({cfg.param_count()} params by repro's count) "
          f"made on the card in {time.perf_counter() - t0:.2f}s")
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))

    print("phase 7b: Jamba prefill vs lockstep decode on the card, 8 layers")
    B, S = 2, 256
    want = build_prefill_step(cfg, batch_global=B, seq_len=S).step_fn(
        params, {"tokens": tokens[:B, :S]})
    ss = build_serve_step(cfg, batch_global=B, cache_len=S)
    states = prepare_serve_states(cfg, ss.spec.plan, B, S, dev)
    for t in range(S):
        logits, states = ss.step_fn(params, tokens[:B, t], t, states)
    if not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(want).all()):
        raise AssertionError("non-finite Jamba logits on the card")
    print(f"  max |logit| {float(want.abs().max()):.4f}")
    check(_rel(torch, logits, want), TOL_JAMBA_DECODE,
          f"Jamba prefill ({B}, {S}) last-position logits vs {S} lockstep decode steps, "
          "max|diff| / max|logit|")
    del states, logits, want

    print("phase 7c: serve the Jamba period at full width")
    B, S = 2, 1024
    pf = build_prefill_step(cfg, batch_global=B, seq_len=S)
    pf.step_fn(params, {"tokens": tokens[:B]})                    # warm-up
    torch.cuda.synchronize()
    batch, prompt, gen = 8, 64, 64
    device_ms = profile_decode(torch, cfg, params, tokens[:batch, 0], batch, prompt + gen, dev)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = pf.step_fn(params, {"tokens": tokens[:B]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = dict(ops.LAUNCHES)
    res = lockstep_decode(cfg, params, batch=batch, prompt_len=prompt, gen=gen,
                          temperature=0.8, device=dev)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    if logits.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"Jamba prefill logits {tuple(logits.shape)} not finite/shaped")
    toks = res["tokens"]
    if toks.shape != (prompt + gen, batch) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"Jamba decode tokens {toks.shape} out of range")
    n_mamba = sum(s.kind == "mamba" for s in cfg.pattern) * cfg.n_periods
    n_attn = cfg.n_layers - n_mamba
    steps = res["steps"]
    want_prefill = {name: 0 for name in ops.LAUNCHES}
    want_prefill.update(mamba_scan=n_mamba, flash_attention=n_attn, fused_swiglu=cfg.n_layers)
    want_all = dict(want_prefill, flash_decode=n_attn * steps,
                    fused_swiglu=cfg.n_layers * (steps + 1))
    print(f"  launches: prefill {after_prefill} (expected {want_prefill}); prefill + "
          f"{steps} decode steps {launches} (expected {want_all})")
    if after_prefill != want_prefill or launches != want_all:
        raise AssertionError("Jamba serving launch counts differ from the path's")
    step_ms = res["seconds"] / steps * 1e3
    print(f"serve Jamba-1.5-Large no-experts 8-layer period full width fp32: prefill "
          f"{B}x{S} {prefill_ms:.3f} ms; decode {step_ms:.3f} ms/step over {steps} steps "
          f"(batch {batch}, cache {prompt + gen}); {res['tok_per_s']:.1f} tok/s; peak memory "
          f"{peak / 1e9:.3f} GB; card {card}")
    if device_ms is not None:
        print(f"  device busy {device_ms:.3f} ms of the {step_ms:.3f} ms decode step "
              f"({device_ms / step_ms:.1%}; idle {1 - device_ms / step_ms:.1%})")
    del params, logits
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 8: rwkv6-7b, all 32 layers at the published widths
# ---------------------------------------------------------------------------


def phase_rwkv_layer(torch, dev) -> None:
    """Full width, card vs CPU: the rwkv + rwkv_cm layer, made on the card
    from a seed with both LoRA up-projections drawn non-zero (they start at
    zero) and copied to the CPU; ``apply_layer`` on (1, 256) tokens, then 8
    ``decode_layer`` steps at batch 2 from fresh states."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import apply_layer, decode_layer, init_layer, init_layer_state

    cfg = get_config("rwkv6-7b")
    spec = cfg.pattern[0]
    cpu = torch.device("cpu")
    S, B, steps = 256, 2, 8
    g = torch.Generator().manual_seed(22)
    x = torch.randn((1, S, cfg.d_model), generator=g)
    xs = [torch.randn((B, cfg.d_model), generator=g) for _ in range(steps)]
    positions = torch.arange(S, dtype=torch.int32)[None]
    gd = torch.Generator(device=dev).manual_seed(23)
    p_card = init_layer(gd, cfg, spec, dev)
    p_card["rwkv_tm"]["mix_lora_b"].normal_(0.0, 0.1, generator=gd)
    p_card["rwkv_tm"]["w_lora_b"].normal_(0.0, 0.5, generator=gd)
    p_cpu = _tree_to(p_card, cpu)
    with torch.inference_mode():
        y_card = apply_layer(p_card, x.to(dev), positions.to(dev), cfg, spec).cpu()
        y_cpu = apply_layer(p_cpu, x, positions, cfg, spec)
        if not bool(torch.isfinite(y_card).all()):
            raise AssertionError("non-finite rwkv layer output on the card")
        check(_rel(torch, y_card, y_cpu), TOL_RWKV_LAYER,
              f"rwkv6-7b layer apply_layer (1, {S}) card vs CPU, max|diff| / max|value|")
        st_card = init_layer_state(B, steps, cfg, spec, torch.float32, dev)
        st_cpu = init_layer_state(B, steps, cfg, spec, torch.float32, cpu)
        worst = 0.0
        for t in range(steps):
            yc, _ = decode_layer(p_card, xs[t].to(dev), t, st_card, cfg, spec)
            yh, _ = decode_layer(p_cpu, xs[t], t, st_cpu, cfg, spec)
            worst = max(worst, _rel(torch, yc.cpu(), yh))
        worst_state = max(_rel(torch, a.cpu(), b) for a, b in zip(_leaves(st_card),
                                                                   _leaves(st_cpu)))
        check(worst, TOL_RWKV_LAYER, f"rwkv6-7b layer {steps} decode_layer steps (batch {B}) "
                                     "card vs CPU, worst step")
        check(worst_state, TOL_RWKV_STATE, "rwkv6-7b layer decode states (mixer shift and "
                                           "wkv, cm shift, written in place) card vs CPU")
    del p_card, p_cpu, st_card, st_cpu
    torch.cuda.empty_cache()


def phase_rwkv_serve(torch, ops, dev, card: str) -> dict:
    """All 32 layers at full width on the card: 8b, prefill against lockstep
    decode; 8c, serving (timed prefill 8 x 512, lockstep decode at batch 8,
    launch counts, peak memory, device-busy share)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import lockstep_decode
    from repro_torch.models.blocks import apply_layer, decode_layer, init_layer_state, tree_index
    from repro_torch.models.model import embed_tokens, init_model
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    cfg = get_config("rwkv6-7b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  weights {n_bytes / 1e9:.3f} GB ({cfg.param_count()} params by repro's count) "
          f"made on the card in {time.perf_counter() - t0:.2f}s")
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))

    print(f"phase 8b: rwkv6-7b prefill vs lockstep decode on the card, {cfg.n_layers} layers")
    tm = params["periods"]["layers"][0]["rwkv_tm"]
    w0_max = float(tm["w0"].max())
    if bool(tm["w_lora_b"].any()) or not w0_max < 0:
        raise AssertionError("init weights put a decay logit above 0")
    print(f"  precondition: w_lora_b is 0 and w0 <= {w0_max:.4f} in every layer, so every "
          "decay logit is w0 < 0 and the prefill clamp to [-20, 0] does not bind")
    B, S = 2, 256
    spec = cfg.pattern[0]
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    with torch.inference_mode():
        # layer by layer, on the prefill's own hidden states: the two forms
        # of each layer meet the same input, so errors do not compound
        x, worst = embed_tokens(params, tokens[:B, :S], cfg), 0.0
        for i in range(cfg.n_layers):
            p = tree_index(params["periods"], i)["layers"][0]
            y = apply_layer(p, x, positions, cfg, spec)
            st = init_layer_state(B, S, cfg, spec, cfg.cdtype, dev)
            ys = torch.stack([decode_layer(p, x[:, t], t, st, cfg, spec)[0]
                              for t in range(S)], dim=1)
            worst, x = max(worst, _rel(torch, ys, y)), y
        check(worst, TOL_RWKV_LAYER_DECODE,
              f"rwkv6-7b each of the {cfg.n_layers} layers, apply_layer ({B}, {S}) vs {S} "
              "decode_layer steps on the same input, worst layer, max|diff| / max|value|")
        del x, y, ys, st
    want = build_prefill_step(cfg, batch_global=B, seq_len=S).step_fn(
        params, {"tokens": tokens[:B, :S]})
    ss = build_serve_step(cfg, batch_global=B, cache_len=S)
    states = prepare_serve_states(cfg, ss.spec.plan, B, S, dev)
    for t in range(S):
        logits, _ = ss.step_fn(params, tokens[:B, t], t, states)
    if not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(want).all()):
        raise AssertionError("non-finite rwkv6-7b logits on the card")
    print(f"  max |logit| {float(want.abs().max()):.4f}")
    check(_rel(torch, logits, want), TOL_RWKV_DECODE,
          f"rwkv6-7b prefill ({B}, {S}) last-position logits vs {S} lockstep decode steps "
          f"through {cfg.n_layers} layers, max|diff| / max|logit|")
    del states, logits, want

    print("phase 8c: serve rwkv6-7b at full width")
    B, S = 8, 512
    pf = build_prefill_step(cfg, batch_global=B, seq_len=S)
    pf.step_fn(params, {"tokens": tokens})                        # warm-up
    torch.cuda.synchronize()
    batch, prompt, gen = 8, 64, 64
    device_ms = profile_decode(torch, cfg, params, tokens[:batch, 0], batch, prompt + gen, dev)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = pf.step_fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = dict(ops.LAUNCHES)
    res = lockstep_decode(cfg, params, batch=batch, prompt_len=prompt, gen=gen,
                          temperature=0.8, device=dev)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    if logits.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"rwkv6-7b prefill logits {tuple(logits.shape)} not finite/shaped")
    toks = res["tokens"]
    if toks.shape != (prompt + gen, batch) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"rwkv6-7b decode tokens {toks.shape} out of range")
    steps = res["steps"]
    want_launches = {name: 0 for name in ops.LAUNCHES}
    want_launches["rwkv6_wkv"] = cfg.n_layers
    print(f"  launches: prefill {after_prefill}; prefill + {steps} decode steps {launches} "
          f"(expected {want_launches} for both: the WKV once per layer in the prefill, no "
          "kernel in the plain-torch decode step)")
    if after_prefill != want_launches or launches != want_launches:
        raise AssertionError("rwkv6-7b serving launch counts differ from the path's")
    step_ms = res["seconds"] / steps * 1e3
    print(f"serve rwkv6-7b full width fp32: prefill {B}x{S} {prefill_ms:.3f} ms; decode "
          f"{step_ms:.3f} ms/step over {steps} steps (batch {batch}, prompt {prompt} + gen "
          f"{gen}); {res['tok_per_s']:.1f} tok/s; peak memory {peak / 1e9:.3f} GB; card {card}")
    if device_ms is not None:
        print(f"  device busy {device_ms:.3f} ms of the {step_ms:.3f} ms decode step "
              f"({device_ms / step_ms:.1%}; idle {1 - device_ms / step_ms:.1%})")
    del params, logits
    torch.cuda.empty_cache()
    return launches


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


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
               phase_swiglu(torch, ops, F, dev)]
    print("phase 3b: training kernels against their plain versions")
    entries += [*phase_quant(torch, dev), phase_flash_bwd(torch, ops, F, dev),
                phase_swiglu_bwd(torch, ops, dev)]
    print("phase 3c: the Mamba scan kernel against its plain version")
    entries.append(phase_mamba(torch, ops, F, dev))
    print("phase 3e: the RWKV-6 WKV kernel against its plain version")
    entries.append(phase_wkv(torch, ops, dev))
    print("phase 3d: serving kernels at Jamba's shapes")
    phase_jamba_kernels(torch, ops, F, dev, {e["name"]: e for e in entries})
    print("phase 4: full-width parity, 2 layers")
    phase_parity(torch, dev)
    print("phase 5: serve at full width")
    serve = phase_serve(torch, ops, dev, card)
    print("phase 6a: full-width training parity, 2 layers, card vs CPU")
    phase_train_parity(torch, dev)
    print("phase 6b: train at full width")
    train = phase_train(torch, ops, dev, card)
    gc.collect()                      # phase 6b's state is gone before 6c starts
    torch.cuda.empty_cache()
    plan_train = phase_plan_train(torch, ops, dev, card)
    print("phase 6c (e): a planner split at full width, 4 layers, card vs CPU")
    phase_split_parity(torch, dev)
    print("phase 6d (a): double-buffered boundaries at full width, 4 layers")
    phase_double_buffer(torch, ops, dev)
    print("phase 6d (b): staleness 1 through launch.train --plan at full width")
    stale_train = phase_stale_train(torch, ops, dev, card, plan_train)
    print("phase 6d (c): a failure and its recovery through launch.train --plan --fail-at")
    fail_train = phase_fail_train(torch, ops, dev, card)
    print("phase 7a: Jamba layers at full width, card vs CPU")
    phase_jamba_layers(torch, dev)
    jamba = phase_jamba_serve(torch, ops, dev, card)
    print("phase 8a: an rwkv6-7b layer at full width, card vs CPU")
    phase_rwkv_layer(torch, dev)
    rwkv = phase_rwkv_serve(torch, ops, dev, card)
    print("phase 9: flash attention's device times at the training shape")
    phase_flash_device(torch, ops, F, dev, {e["name"]: e for e in entries})
    print("phase 9b: the Mamba scan's device time at the Jamba prefill's shape")
    phase_scan_device(torch, ops, dev, {e["name"]: e for e in entries})
    print("phase 9c: the RWKV-6 WKV's device time at the rwkv6-7b prefill's shape")
    phase_wkv_device(torch, ops, dev, {e["name"]: e for e in entries})
    print("phase 9d: flash_decode's device time at phase 3's and 3d's and the long shapes")
    phase_decode_device(torch, ops, F, dev, {e["name"]: e for e in entries})
    for e in entries:
        by_path = {"serve": serve[e["name"]], "train": train["launches"][e["name"]],
                   "plan_train": plan_train["launches"][e["name"]],
                   "stale_train": stale_train["launches"][e["name"]],
                   "fail_train": fail_train["launches"][e["name"]],
                   "jamba_serve": jamba[e["name"]], "rwkv_serve": rwkv[e["name"]]}
        if not any(by_path.values()):
            raise AssertionError(f"{e['name']} was launched on no main path")
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path
        e["card"] = card
    print(f"smoke run took {time.perf_counter() - t0:.1f}s (build included)")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
