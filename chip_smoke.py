#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving, training and planned training paths at the
full width of ``phi3-mini-3.8b`` (32 layers, d_model 3072, 32 heads x 96,
d_ff 8192, vocab 32064, fp32, random weights from a seeded
``torch.Generator`` on the card), serves one 8-layer period of Jamba-1.5-Large without experts at
its published widths (d_model 8192, 64/8 heads x 128, d_ff 24576, Mamba
d_inner 16384 and d_state 16, vocab 65536), serves the published
``rwkv6-7b`` whole (32 layers, d_model 4096, 64 heads x 64, d_ff 14336,
vocab 65536), and serves ``gemma-2b``, ``gemma2-2b`` and ``deepseek-7b``
whole and trains ``gemma2-2b`` whole (26 layers, d_model 2304, 8/4 heads x
256, d_ff 9216, vocab 256000, tied embeddings, softcaps 50 and 30, a local
window of 4096 on every other layer), serves 12 and trains 2 of the 32
layers of ``phi3.5-moe-42b-a6.6b`` (16 experts x 6400, top 2), and serves 1
of the 61 layers of ``deepseek-v3-671b`` with all 256 routed experts (MLA
with a latent cache, d_model 7168, 128 heads, no MTP head) and trains 1
layer with its MTP block (the routed experts cut to 16):

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
5b. continuous and planned serving at full width, after phase 5's state is
   freed: (a) ``build_slot_serve_step`` at shard_alloc (3, 1) (6 rows, 4
   live, 2 padded), slots admitted at wall steps (0, 1, 2, 1) for 6
   positions each (``repro``'s ``run_serve_hetero`` schedule): every
   (slot, position)'s logits against lockstep ``build_serve_step`` at batch
   4 on the same weights and tokens, padded rows exactly 0, 32
   ``flash_decode`` and 32 ``fused_swiglu`` launches a step and no other;
   (b) the same schedule on 2 and 4 virtual stages in 2 groups against (a),
   64 launches of each a step; (c) ``launch.serve --continuous --devices 8
   --requests 12 --prompt-len 16 --gen 32 --max-slots 4`` in process: the
   serve plan on the modeled Jetson cluster, the engine step and the
   offered load, requests, tokens, steps and tok/s served, token-latency
   p50/p95/p99 beside those predicted from the measured step; every request
   32 tokens in the vocabulary, launch counts 32 x (warm-up calls + engine
   steps) of each kernel; (d) (c)'s requests through a fresh engine on the
   same weights with the slot list reversed, every token identical; the
   engine step's device-busy share from a profiler trace beside phase 5's
   lockstep ms/step, and its host parts (row arrays to the card, logits
   back, host draws) timed alone;
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
6e. the plan portfolio at full width and 16 layers, after 6d's state is
   freed (a compressed finalist's error-feedback residual and unbounded
   buckets do not fit beside the 32-layer state): (a) ``launch.train --plan
   --portfolio 3 --probation-rounds 2`` on 6c's artifact cut to 16 layers
   (4 virtual devices of 20 GB, model axis 4), batch 8 x 256, 4 steps: each
   finalist's family, predicted round, wall and CUDA-event rounds, its
   reckoned (``reckon_probe``) and measured peak memory and allocator
   retries, the winner and whether it churned, the digest identity line
   (which must read True), every probe round's and step's launch counts as
   the installed plan implies, the ms/step after the auction and the
   auction's wall split into adoptions, probe rounds and the closing
   re-seed of backups; (b) 6d (c)'s artifact cut to 16 layers (3 devices
   of 36 GB, model axis 6), ``--portfolio 2 --fail-at 3`` (the installed
   plan's last stage's device): the step that recovers runs a
   2-candidate auction planned on the survivors, whose report is printed;
   every installed rank live, finite losses, launch counts; (c) 4 layers:
   a session probed (k = 3, window 1) between steps 2 and 3 and a twin
   never probed hold equal canonical leaves under ``torch.equal``;
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
10a. (after 8c, before phase 9's traces) holds the kernels at the dense
   families' shapes against their plain versions, timed beside bound,
   plain version and SDPA ("none" under a softcap): the flash forward and
   backward (dq, dk, dv) at gemma-2b's prefill (2, 512, 8/1, 256), gemma2's
   (2, 512, 8/4, 256, softcap 50), the training micro-batches of gemma-2b
   (1, 8192, 8/1, 256) and gemma2 (1, 8192, 8/4, 256, window 4096, softcap
   50; both also against float64; at gemma-2b's, where the plain version
   is itself about the tolerance from float64, held to it within the
   tolerance plus that distance) and a
   softcapped head_dim 96 (the tensor cores), within ``TOL_DENSE_ATTN``; at
   head_dim 256 the backward's route (the two-CTA clusters) and two runs
   bitwise, phase 3b's one-sign case at (1, 8192, 2/1, 256), and the port's
   forward plus backward beside SDPA's at gemma-2b's shape;
   ``flash_decode`` at gemma-2b's and gemma2's decode steps (batch 8, cache
   256, per-row lengths); ``fused_swiglu`` with ``gelu_tanh`` at gemma2's
   widths (T = 8 and 4096) and ``swiglu_bwd`` at (8192, 9216);
10b. one gemma2 period (a local and a global layer) at published widths,
   card vs CPU: logits at every position, 16 lockstep decode steps (and
   prefill vs decode on the card), the loss and every gradient leaf of an
   uncompressed step on 2 virtual stages, the tied embedding's named;
10c. that period at batch 1 decodes 4160 positions one at a time (the
   local layer's 4096-slot ring wraps), the last 8 logits against one
   prefill;
10d. serves each of gemma-2b (18 layers), gemma2-2b (26) and deepseek-7b
   (30) whole as phase 5 serves phi3: prefill 8 x 512, ``launch.serve``
   batch 8, prompt 128 + gen 128, launch counts, busy share, peak memory;
10e. trains gemma2-2b, then gemma-2b (MQA), whole through ``launch.train
   --stage 2 --seq 8192 --global-batch 2 --n-micro 2 --compress int8
   --bucket-mb 256 --no-error-feedback``, 1 warm-up + 2 steps, every step's
   launch counts, every forward and backward on the two-CTA clusters, a
   traced step;
10f. the paper's loop on gemma2-2b as 6c runs it on phi3 (``launch.profile``
   at seq 256, batches 1-8, 4 x 20 GB; ``launch.train --plan --profile``
   at 6b's batch flags, 4 steps): the split, the predicted round and the
   summed work beside the measured ms/step, launch counts, every forward on
   the two-CTA clusters (6c's on the tensor-core route);
11. (after 10f, before phase 9's traces) phi3.5-moe-42b-a6.6b (d_model 4096,
   32/8 heads x 128, 16 experts x 6400 at top 2, vocab 32064) at full width:
   every kernel of its paths at their shapes against its plain version,
   timed beside the plain version, the library call and the bound:
   ``fused_swiglu`` at one expert (W 4096 x 6400; x (641, 4096), a
   training micro-batch's capacity buffer, and (2, 4096), a decode
   step's), ``swiglu_bwd`` at (641, 6400), the flash forward and
   backward at the prefill (8, 512) and the micro-batch (2, 2048),
   ``flash_decode`` at a decode step, the wire kernels at a stage boundary
   and the largest gradient bucket;
11a. one MoE layer on (1, 64) tokens, card vs CPU on the same weights: the
   routing decisions (experts, kept slots) equal first (else the smallest
   k-th/(k+1)-th score gap is printed and the phase fails), then the
   output, the aux loss and the gradients of ``sum(out * r) + aux`` for
   every leaf and the input; two card runs bitwise equal;
11b. a 2-layer cut at capacity factor 64 (nothing drops at either token
   count): prefill (2, 256) last-position logits against 256 lockstep decode
   steps, within 7b's tolerance;
11c. 12 of the 32 layers served (63.5 GB of weights): a prefill 8 x 512,
   warmed up at that shape and timed 4 times (median and range), then
   ``launch.serve.lockstep_decode`` at batch 8, prompt 128 + gen 128; the
   exact launch counts (16 ``fused_swiglu`` a layer and forward), the
   device-busy share of a decode step, the experts' share of the
   prefill's and a decode step's device time, the peak memory;
11d. 2 layers trained through ``launch.train --n-layers 2 --stage 2
   --n-micro 4 --global-batch 8 --seq 2048 --compress int8 --bucket-mb 256
   --no-error-feedback``, 1 warm-up + 2 steps: each step's ``ce`` and
   ``aux`` (finite, aux > 0), launch counts, ms/step, peak memory;
11e. MoE beyond lockstep, each MoE layer routing one data shard's rows of
   one decode group as a token set: (a) a 2-layer cut at capacity factor
   1.25 through the slot step (shard_alloc (3, 1) at stages 1 and 2, (4, 2)
   at stage 2 in 2 groups), card vs CPU row for row with equal routing and
   dropped pairs (some must drop), padded rows exactly 0, each step's
   launches; at factor 64 the engine's tokens under the slot list reversed
   and another timing; (b) ``launch.serve --continuous`` (5b (c)'s cell)
   at 5 layers, the most the launcher's modeled cluster admits: launch
   counts, the engine and draw ms/step, tok/s, token percentiles, the busy
   share; then lockstep ``--devices 8`` on that cut (2 data shards) and
   the CUDA kernels a step with 2 token sets against 1;
11f. the paper's loop on phi3.5-moe at 2 layers (``launch.profile
   --n-layers 2`` at seq 2048 on 4 virtual devices of 40 GB; ``launch.train
   --plan --profile``, 1 + 2 steps): the split, the predicted round split
   into execution and AllReduce beside the measured ms/step, launch counts
   of every step, the peak memory;
12a. (after 11f, before phase 9's traces) the latent route of
   ``flash_decode`` (``flash_decode_latent``: MLA's decode, one key head of
   c_kv 512 ‖ k_rope 64 read by strides, values c_kv, scale 192^-0.5) at a
   decode step (8, 128 heads, 256 keys, per-row lengths) and at (1, 128,
   4096) against its plain version, two runs bitwise, timed beside its
   bound, plain version and SDPA; the flash forward and backward at q/k 192
   with v 128 zero-padded to 192 (the cluster route) at the prefill (8, 512,
   128 heads), the training micro-batch (1, 1024) and the MTP block's call
   (2, 1024), against the plain version and float64, the padded columns 0,
   SDPA at v 128 beside them; ``fused_swiglu`` at an expert (W 7168 x
   2048) on the rows of the decode step, the prefill and 12d's micro-batch
   and MTP block, routed and shared, ``swiglu_bwd`` on 12d's, and the wire
   kernels (int8, bitwise) at 12d's expert and largest gradient buckets,
   each against its plain version, timed beside it, its bound and cuBLAS;
12b. card vs CPU at full width: (i) the MLA block, a prefill on (1, 64)
   tokens and 8 decode steps at batch 4, lockstep and per-row, outputs and
   latent caches; (ii) one MoE layer at deepseek-v3's widths with 16 routed
   experts (phase 11a's checks); (iii) on 1 layer with all 256 experts at
   capacity factor 64, prefill (2, 32) against 32 lockstep decode steps;
12c. serves that layer (53.4 GB of weights, no MTP head): prefill 8 x 512,
   a decode step's busy share, then ``launch.serve --arch deepseek-v3-671b
   --n-layers 1`` (batch 8, prompt 128 + gen 128) with exact launch counts
   (a step: 1 ``flash_decode_latent`` and 257 ``fused_swiglu``), decode
   ms/step beside the 49.7 GB a step reads, peak memory;
12d. trains 1 layer and the MTP block through ``launch.train --n-layers 1
   --n-experts 16 --stage 1 --n-micro 2 --global-batch 2 --seq 1024
   --compress int8 --bucket-mb 256 --no-error-feedback``, 1 + 2 steps, the
   state reckoned first: ``ce``, ``aux`` and ``mtp`` each step, launch
   counts, ms/step, peak memory;
9. reads device times at the training shape from profiler traces (last,
   because tracing slows later launches): the flash forward beside SDPA's
   forward, the flash backward alone, and the port's forward with the
   logsumexp plus its backward beside SDPA's forward plus backward; 9b
   reads ``mamba_scan``'s device time at the Jamba prefill's shape, 9c
   ``rwkv6_wkv``'s at the rwkv6-7b prefill's and 9d ``flash_decode``'s at
   the four ``DECODE_SHAPES`` beside SDPA's (and, at GQA shapes, the heads'
   ``repeat_interleave``'s) device time, each over input sets called in
   turn until their caches span 4x the L2 (so they come from HBM); prints
   a ``{"kernels": [...]}`` line (every kernel, with their launches on
   the phi3 serving, phi3 continuous serving (5b (c)), phi3 training, phi3
   planned training, staleness-1 and
   failure-recovery training, portfolio (6e (a), (b)), Jamba serving,
   rwkv6-7b serving, the three dense serving paths, gemma2-2b training and
   planned training, gemma-2b training (10d-10f), phi3.5-moe serving and
   training (11c, 11d), continuous and lockstep ``--devices 8`` serving
   and planned training (11e (b), 11f), deepseek-v3 serving and training
   (12c, 12d), phase 10a's rows under ``dense``, phase 11's under
   ``phi35_moe`` and phase 12a's under ``deepseek_v3``; the latent route
   is an entry of its own) and, last, ``{"ok": true, ...}``.

Every phase raises on failure, so the script exits non-zero; nothing is
caught.  Without a CUDA card, or run outside the repository (no ``src/``),
it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import statistics
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
# full-width per-slot decode on the card against lockstep decode on the card
# (5b (a)), and virtual stages against one stage (5b (b)): the same kernels
# at batch 6 against batch 4 or groups of 3 rows (cuBLAS picks other
# kernels), per-row against shared cache lengths; max |diff| / max |logit|,
# 10x the 1.16e-06 read on an H100 for (b) (5.7e-07 for (a))
TOL_SLOT_LOGITS = 1.2e-5
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


def decode_inputs(torch, dev, g, name, dtype=None, shapes=None):
    """q, k, v, lens of ``DECODE_SHAPES[name]`` (or ``shapes[name]``),
    values N(0, 0.25) from ``g``."""
    B, H, Hkv, S, D, lens = (shapes or DECODE_SHAPES)[name]
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


def decode_bound(name, elem=4, shapes=None):
    """``flash_decode``'s least time at ``DECODE_SHAPES[name]`` (or
    ``shapes[name]``): q read and the output written once, each valid K and V
    row read once, the lengths; or 4·D fp32 flops a (query head, valid
    key)."""
    B, H, Hkv, S, D, lens = (shapes or DECODE_SHAPES)[name]
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


def causal_pairs(S: int, window=None) -> int:
    """(query, visible key) pairs of one head, causal, under a window."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_bound(B, S, H, Hkv, D, causal=True, window=None, softcap=None):
    """``flash_attention``'s least time: q/out read and written once, k/v
    read once, or 4·D flops a (query, visible key) pair as 3xTF32 products
    on the tensor cores and an exponential (and a tanh under a softcap) a
    pair on the SFU."""
    pairs = B * H * (causal_pairs(S, window) if causal else S * S)
    return bound(4 * (2 * B * S * H * D + 2 * B * S * Hkv * D), 0,
                 pairs * (2 if softcap else 1), tf32x3=4 * D * pairs)


def fwd_route_of(D: int) -> str:
    """The forward's route at head_dim D, as ``flash_attention_route`` decides."""
    return "simt" if D % 8 else "tc" if D <= 128 else "tc_cluster"


def check_route(route: str, want: str, what: str) -> None:
    if route != want:
        raise AssertionError(f"{what} takes the {route} route, not {want}")


def phase_flash(torch, ops, F, dev) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_fwd_route

    B, S, H, D = 8, 512, 32, 96
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).mul_(0.5).to(dtype)

    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    check_route(flash_attention_fwd_route(q, k, v), "tc", "flash_attention phi3 prefill")
    err = max_err(ops.flash_attention_op(q, k, v), ops.plain_flash_attention(q, k, v))
    check(err, TOL_FP32, f"flash_attention ({B}*{H}, {S}, {D}) causal")
    same = bitwise_equal(torch, ops.flash_attention_op(q, k, v), ops.flash_attention_op(q, k, v))
    print(f"  flash_attention ({B}, {S}, {H}, {D}): two runs bitwise {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("flash_attention: not deterministic")

    # GQA, window, softcap, ragged S, non-causal, bf16; S = 1 and both sides
    # of a 64-row tile; D = 160 (the two-CTA clusters, rank 1 on 32 columns)
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
        check_route(flash_attention_fwd_route(qq, kk, vv), fwd_route_of(d),
                    f"flash_attention edge D={d}")
        e = max_err(ops.flash_attention_op(qq, kk, vv, **kw),
                    ops.plain_flash_attention(qq, kk, vv, **kw))
        check(e, TOL_FP32 if dt == torch.float32 else TOL_BF16["attention"],
              f"flash_attention edge B={b} S={s} H={h} Hkv={hkv} D={d} window={win} "
              f"softcap={cap} causal={causal} {dt}")

    # head_dim not a multiple of 8: the SIMT kernel, causal and under a
    # window and softcap, at D = 100 and at its widest, 252; drawn from a
    # generator of its own, so that the draws of this phase stay as they were
    gs = torch.Generator(device=dev).manual_seed(40)
    for (b, s, h, hkv, d, win, cap) in [(1, 200, 4, 2, 100, None, None),
                                        (1, 150, 4, 2, 252, None, None),
                                        (2, 130, 8, 4, 252, 64, 50.0)]:
        qq, kk, vv = (torch.randn((b, s, n, d), generator=gs, device=dev).mul_(0.5)
                      for n in (h, hkv, hkv))
        kw = dict(window=win, softcap=cap)
        check_route(flash_attention_fwd_route(qq, kk, vv), "simt", f"flash_attention edge D={d}")
        e = max_err(ops.flash_attention_op(qq, kk, vv, **kw),
                    ops.plain_flash_attention(qq, kk, vv, **kw))
        check(e, TOL_FP32, f"flash_attention SIMT B={b} S={s} H={h} Hkv={hkv} D={d} "
                           f"window={win} softcap={cap} causal fp32")

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
    check_route(flash_attention_fwd_route(q, k, v), "tc", "flash_attention training shape")
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


def cublas_swiglu(F, x, wg, wu, wd, act="silu"):
    """SwiGLU (GeGLU for ``gelu_tanh``) as a PyTorch user writes it: three
    fp32 cuBLAS products (TF32 off) and the activation.  No one PyTorch call
    computes the fused MLP, so this route is ``fused_swiglu``'s library
    yardstick; written out here so that a change to the plain version cannot
    move it."""
    a = F.silu(x @ wg) if act == "silu" else F.gelu(x @ wg, approximate="tanh")
    return (a * (x @ wu)) @ wd


def time_swiglu(torch, ops, F, x, w, what: str, act: str = "silu") -> dict:
    """``fused_swiglu`` at x (fp32) against its plain version, then timed
    beside the plain version, the cuBLAS route and its bound: the products
    as 3xTF32 on the tensor cores, or the weights and x, out read or written
    once."""
    T, D = x.shape
    Fd = w[0].shape[1]
    err = max_err(ops.fused_swiglu_op(x, *w, act), ops.plain_fused_swiglu(x, *w, act))
    check(err, TOL_FP32, f"fused_swiglu {what} T={T} D={D} F={Fd} {act}")
    ms = time_ms([lambda: ops.fused_swiglu_op(x, *w, act)], torch)
    plain_ms = time_ms([lambda: ops.plain_fused_swiglu(x, *w, act)], torch)
    lib_ms = time_ms([lambda: cublas_swiglu(F, x, *w, act)], torch)
    bms, by = bound(4 * (3 * D * Fd + 2 * T * D), 0, tf32x3=6 * T * D * Fd)
    print(f"  fused_swiglu {what} T={T} {act}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cuBLAS route {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms,
            "shape": f"x ({T},{D}) wg/wu ({D},{Fd}) wd ({Fd},{D}) fp32 {act}"}


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


def flash_bwd_bound(B, S, H, D, Hkv=None, window=None, softcap=None):
    """``flash_attention_bwd``'s least time, causal: q, o and dO (H heads)
    and k, v (Hkv) read once, dq (H) and dk, dv (Hkv) written once, the
    logsumexp read (fp32), or its five products, 10·D flops a (query,
    visible key) pair, as 3xTF32 on the tensor cores, and the exponentials
    (and tanhs) on the SFU."""
    Hkv = Hkv or H
    pairs = B * H * causal_pairs(S, window)
    nbytes = 4 * (4 * B * S * H * D + 4 * B * S * Hkv * D + B * H * S)
    return bound(nbytes, 0, pairs * (2 if softcap else 1), tf32x3=10 * D * pairs)


def attention_float64(torch, q, k, v):
    """Causal attention (B, S, H, D) with GQA in float64: a reference for
    sums too long for fp32."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qd = q.double().transpose(1, 2)
    kd, vd = (t.double().repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = qd @ kd.transpose(-1, -2) * D ** -0.5
    p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1)
    del s
    return (p @ vd).transpose(1, 2)


def attention_bwd_float64(torch, q, k, v, dout, window=None, softcap=None):
    """(dq, dk, dv) of causal attention (B, S, H, D) with GQA, a sliding
    window and a tanh softcap c, in float64: the closed form (dS = P (dP -
    rowsum(dO O)), times 1 - (S / c)^2 under the cap), a reference for sums
    too long for fp32."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qd, dd = (t.double().transpose(1, 2) for t in (q, dout))
    kd, vd = (t.double().repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if window is not None:
        keep &= ~torch.ones((S, S), dtype=torch.bool, device=q.device).tril(-window)
    s = qd @ kd.transpose(-1, -2) * D ** -0.5
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        dcap = 1 - t * t
        s = softcap * t
        del t
    p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1)
    del s
    ds = p * (dd @ vd.transpose(-1, -2) - (dd * (p @ vd)).sum(-1, keepdim=True))
    if dcap is not None:
        ds *= dcap
        del dcap
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
    from repro_torch.kernels.flash_attention import flash_attention_fwd_route

    g = torch.Generator(device=dev).manual_seed(18)

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    B, S, H, Hkv, D = 2, 1024, 64, 8, 128
    q, k, v = rnd(B, S, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    check_route(flash_attention_fwd_route(q, k, v), "tc", "flash_attention Jamba")
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


def phase_serve(torch, ops, dev, card: str, arch: str = "phi3-mini-3.8b") -> dict:
    """``arch`` whole at its published widths: the prefill step on 8 x 512
    tokens, then ``launch.serve``'s lockstep loop (batch 8, prompt 128 + gen
    128), every kernel's launch count checked, the decode step's device-busy
    share from a profiler trace, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import init_model
    from repro_torch.runtime.serve import build_prefill_step

    cfg = get_config(arch)
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
    device_ms, _ = profile_decode(torch, cfg, params, tokens[:, 0], B, prompt + gen, dev)

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
    print(f"serve {cfg.name} full width fp32 ({cfg.n_layers} layers): prefill {B}x{S} "
          f"{prefill_ms:.3f} ms; decode {step_ms:.3f} ms/step over {steps} steps "
          f"(batch {B}), {cfg.n_layers} flash_decode and {cfg.n_layers} fused_swiglu "
          f"launches a step; {res['tok_per_s']:.1f} tok/s; peak memory {peak / 1e9:.3f} GB; "
          f"card {card}")
    if device_ms is not None:
        print(f"  device busy {device_ms:.3f} ms of the {step_ms:.3f} ms decode step "
              f"({device_ms / step_ms:.1%}; idle {1 - device_ms / step_ms:.1%})")
    return {"launches": launches, "step_ms": step_ms, "prefill_ms": prefill_ms,
            "peak_gb": peak / 1e9, "busy_ms": device_ms}


# ---------------------------------------------------------------------------
# Phase 5b: continuous and planned serving at full width
# ---------------------------------------------------------------------------

# the per-slot schedule of repro's run_serve_hetero: live slots at
# shard_alloc (3, 1) (6 rows, rows 0-2 and 3 live), slot s admitted at wall
# step SLOT_DELAY[s], SLOT_STEPS positions each, cache 64
SLOT_ALLOC, SLOT_DELAY, SLOT_STEPS, SLOT_CACHE = (3, 1), (0, 1, 2, 1), 6, 64
CONTINUOUS_ARGS = ["--continuous", "--devices", "8", "--requests", "12", "--prompt-len", "16",
                   "--gen", "32", "--max-slots", "4"]


def staggered_logits(torch, ops, ss, params, tokens, dev, per_step: dict,
                     delay=SLOT_DELAY):
    """``tokens`` (slots, SLOT_STEPS) through the slot step ``ss`` on the
    staggered schedule, slot s admitted at wall step ``delay[s]`` (idle
    slots reset each wall step).  Returns {(slot, position): logits row}
    and the largest |logit| of a padded row; checks each step's launch
    counts against ``per_step``."""
    from repro_torch.runtime.continuous import slot_rows
    from repro_torch.runtime.serve import prepare_serve_states

    rows = slot_rows(ss.spec.shard_alloc)
    B, cfg = ss.spec.batch_global, ss.spec.cfg
    pads = [r for r in range(B) if r not in rows]
    states = prepare_serve_states(cfg, ss.spec.plan, B, SLOT_CACHE, dev)
    out, pad_max = {}, 0.0
    for w in range(SLOT_STEPS + max(delay)):
        tok, pos, reset = ([0] * B, [0] * B, [False] * B)
        live = {}
        for s, row in enumerate(rows):
            p = w - delay[s]
            if not 0 <= p < SLOT_STEPS:
                reset[row] = True
                continue
            tok[row], pos[row], reset[row] = int(tokens[s, p]), p, p == 0
            live[s] = (row, p)
        args = [torch.tensor(v, dtype=torch.int32, device=dev) for v in (tok, pos)]
        ops.reset_launches()
        logits, states = ss.step_fn(params, *args, reset, states)
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        if got != per_step:
            raise AssertionError(f"slot step launches {got} != {per_step} (wall step {w})")
        out.update({(s, p): logits[row].clone() for s, (row, p) in live.items()})
        if pads:
            pad_max = max(pad_max, float(logits[pads].abs().max()))
    del states
    return out, pad_max


def profile_engine(torch, engine, B, rows, cache_len, dev, n_steps=8):
    """Device busy time per engine step from a ``torch.profiler`` trace of
    ``n_steps`` steps with every live row mid-cache (after 2 untraced
    ones), the wall ms per step of ``n_steps`` untraced ones, and the host's
    parts of a step timed alone: the row arrays to the card, the (B, V)
    logits back, one host draw for each live row."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.continuous import _to_device, sample_token

    tok, pos, reset = np.zeros(B, np.int32), np.zeros(B, np.int32), np.zeros(B, bool)
    start = cache_len // 2
    for p in range(start - 2, start):
        pos[rows] = p
        engine(tok, pos, reset)
    t0 = time.perf_counter()
    for p in range(start, start + n_steps):
        pos[rows] = p
        logits = engine(tok, pos, reset)
    wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for p in range(start, start + n_steps):
            pos[rows] = p
            engine(tok, pos, reset)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    on_card = torch.from_numpy(logits).to(dev)
    torch.cuda.synchronize()
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        _to_device(tok, pos, dev)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        on_card.cpu().numpy()
    d2h_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for i in range(n):
        for r in rows:
            sample_token(logits[r], 0, i, r)
    sample_ms = (time.perf_counter() - t0) / n * 1e3
    if busy_us <= 0:
        print("  profiler trace holds no device time: device busy share not measured")
    else:
        print(f"  engine-step trace ({n_steps} steps): top kernels by device time")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    {e.self_device_time_total / n_steps / 1e3:8.3f} ms/step "
                  f"{e.count // n_steps:5d} launches/step  {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_us / n_steps / 1e3 if busy_us > 0 else None,
            "h2d_ms": h2d_ms, "d2h_ms": d2h_ms, "sample_ms": sample_ms,
            "logits_bytes": logits.nbytes,
            "kernels_per_step": sum(e.count for e in kernels) / n_steps}


def check_continuous_kernels(torch, ops, dev) -> None:
    """flash_decode and fused_swiglu against their plain versions at the
    shapes phase 5b gives them: the launcher's engine (8 rows, cache 48, 4
    live rows mid-cache, 4 padded at length 1) and the slot step of (a)
    (6 rows, cache 64, 2 padded); the MLP at 6 rows and at (b)'s groups of
    2 (a row of each shard)."""
    H, D, Fd, W = 32, 96, 8192, 3072
    g = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    for B, S, lens in ((8, 48, [48, 30, 17, 5, 1, 1, 1, 1]),
                       (6, 64, [64, 33, 6, 2, 1, 1])):
        q, k, v = rnd(B, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = max_err(ops.flash_decode_op(q, k, v, ln), ops.plain_flash_decode(q, k, v, ln))
        check(err, TOL_FP32, f"flash_decode B={B} H={H} cache {S} lengths {lens}")
    w = (rnd(W, Fd, scale=W ** -0.5), rnd(W, Fd, scale=W ** -0.5), rnd(Fd, W, scale=Fd ** -0.5))
    for T in (6, 2):
        x = rnd(T, W, scale=1.0)
        err = max_err(ops.fused_swiglu_op(x, *w), ops.plain_fused_swiglu(x, *w))
        check(err, TOL_FP32, f"fused_swiglu T={T} D={W} F={Fd}")


def phase_continuous(torch, ops, dev, card: str, lockstep_ms: float) -> dict:
    """5b: (a) staggered admission through the slot step at (3, 1) against
    lockstep decode, (b) the same at 2 and 4 virtual stages, (c)
    ``launch.serve --continuous`` in process, (d) its requests replayed with
    the slot list reversed; the engine step's device-busy share and host
    parts.  Returns the launcher run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import init_model
    from repro_torch.runtime.continuous import ContinuousBatcher, engine_from_serve_step
    from repro_torch.runtime.serve import build_serve_step, build_slot_serve_step, \
        prepare_serve_states

    cfg = get_config("phi3-mini-3.8b")
    L = cfg.n_layers
    none = {name: 0 for name in ops.LAUNCHES}
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tokens = torch.randint(0, cfg.vocab_size, (sum(SLOT_ALLOC), SLOT_STEPS),
                           generator=torch.Generator().manual_seed(5))

    print("phase 5b: the path's kernels against their plain versions at its shapes")
    check_continuous_kernels(torch, ops, dev)

    print(f"phase 5b (a): staggered admission at shard_alloc {SLOT_ALLOC} vs lockstep decode")
    ref = build_serve_step(cfg, batch_global=sum(SLOT_ALLOC), cache_len=SLOT_CACHE)
    states = prepare_serve_states(cfg, ref.spec.plan, sum(SLOT_ALLOC), SLOT_CACHE, dev)
    want = []
    for t in range(SLOT_STEPS):
        lg, states = ref.step_fn(params, tokens[:, t].to(dev), t, states)
        want.append(lg.clone())
    del states
    scale = max(float(w.abs().max()) for w in want)
    ss = build_slot_serve_step(cfg, cache_len=SLOT_CACHE, shard_alloc=SLOT_ALLOC)
    base, pad_max = staggered_logits(torch, ops, ss, params, tokens, dev,
                                     dict(none, flash_decode=L, fused_swiglu=L))
    err = max(float((row - want[p][s]).abs().max()) for (s, p), row in base.items()) / scale
    check(err, TOL_SLOT_LOGITS, f"{len(base)} (slot, position) logits rows vs lockstep "
          f"batch {sum(SLOT_ALLOC)}, max|diff| / max|logit| ({scale:.4f})")
    print(f"  padded rows: max |logit| {pad_max} (must be 0); launches per step "
          f"{L} flash_decode, {L} fused_swiglu: held")
    if pad_max != 0.0:
        raise AssertionError(f"padded slot rows carry logits up to {pad_max}")

    print("phase 5b (b): the same schedule on 2 and 4 virtual stages, 3 groups (each "
          "shard's 3 rows one at a time)")
    for stage in (2, 4):
        vs = build_slot_serve_step(cfg, cache_len=SLOT_CACHE, shard_alloc=SLOT_ALLOC,
                                   stage=stage, n_groups=3)
        G = vs.spec.groups
        got, pad_max = staggered_logits(torch, ops, vs, params, tokens, dev,
                                        dict(none, flash_decode=G * L, fused_swiglu=G * L))
        err = max(float((got[k] - base[k]).abs().max()) for k in base) / scale
        check(err, TOL_SLOT_LOGITS, f"stage {stage} x {G} groups vs stage 1, "
              "max|diff| / max|logit|")
        if pad_max != 0.0:
            raise AssertionError(f"stage {stage}: padded slot rows carry logits {pad_max}")
    del params, want, base, got
    gc.collect()
    torch.cuda.empty_cache()

    print("phase 5b (c): python -m repro_torch.launch.serve " + " ".join(CONTINUOUS_ARGS))
    ops.reset_launches()
    res = launcher.main(CONTINUOUS_ARGS)
    launches = dict(ops.LAUNCHES)
    plan, done, reqs = res["plan"], res["completions"], res["requests"]
    calls = res["warmup_calls"] + res["steps"]
    expect = dict(none, flash_decode=L * calls, fused_swiglu=L * calls)
    print(f"  launches {launches} (expected {expect}: {res['warmup_calls']} warm-up calls + "
          f"{res['steps']} engine steps)")
    if launches != expect:
        raise AssertionError(f"continuous serving launch counts {launches} != {expect}")
    gen = int(CONTINUOUS_ARGS[CONTINUOUS_ARGS.index("--gen") + 1])
    if len(done) != len(reqs) or any(len(c.tokens) != gen for c in done):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests completed with "
                             f"{sorted({len(c.tokens) for c in done})} tokens, not {gen}")
    if any(not 0 <= t < cfg.vocab_size for c in done for t in c.tokens):
        raise AssertionError("a served token lies outside the vocabulary")
    step_ms = sum(res["step_seconds"]) / res["steps"] * 1e3
    draw_ms = sum(res["draw_seconds"]) / res["steps"] * 1e3
    p50, p95, p99 = (v * 1e3 for v in res["latency_pct"])
    q50, q95, q99 = (v * 1e3 for v in res["predicted_pct"])
    print(f"continuous serve phi3-mini-3.8b full width fp32: plan stage {plan.stage} tp "
          f"{plan.tp} alloc {plan.shard_alloc} caps {plan.max_slots}, modeled p99 "
          f"{plan.predicted_p99 * 1e3:.3f} ms (Jetson NX/TX2 model); {len(done)} requests / "
          f"{sum(len(c.tokens) for c in done)} tokens in {res['steps']} engine steps; engine "
          f"{step_ms:.3f} ms/step (probe {res['probe_step_s'] * 1e3:.3f}) against lockstep "
          f"{lockstep_ms:.3f} ms/step (phase 5), host draws {draw_ms:.3f} ms/step (probe "
          f"{res['probe_draw_s'] * 1e3:.3f}); on the clock of engine and draws: offered "
          f"{res['rate']:.1f} tok/s, served {res['tok_per_s']:.1f} tok/s; a smoke trace, "
          f"its token latency p50/p95/p99 {p50:.3f}/{p95:.3f}/{p99:.3f} ms (predicted "
          f"{q50:.3f}/{q95:.3f}/{q99:.3f} ms); card {card}")

    print("phase 5b (d): the same requests through a fresh engine, slot list reversed")
    ss = res["slot_step"]
    engine = engine_from_serve_step(ss, res["params"], dev)
    bat = ContinuousBatcher(engine, slots=res["slots"][::-1], batch=ss.spec.batch_global,
                            cache_len=ss.spec.cache_len, seed=0)
    again = {c.rid: c.tokens for c in bat.run(reqs)}
    first = {c.rid: c.tokens for c in done}
    differ = [rid for rid in first if again.get(rid) != first[rid]]
    print(f"  {len(first)} requests, {bat.steps} engine steps (first run {res['steps']}): "
          f"{len(first) - len(differ)} token streams identical")
    if differ or set(again) != set(first):
        raise AssertionError(f"requests {differ} drew other tokens with the slots reversed")

    prof = profile_engine(torch, engine, ss.spec.batch_global, res["slots"],
                          ss.spec.cache_len, dev)
    busy = prof["busy_ms"]
    print(f"  engine step {prof['wall_ms']:.3f} ms wall with {len(res['slots'])} live rows; "
          + (f"device busy {busy:.3f} ms ({busy / prof['wall_ms']:.1%}; idle "
             f"{1 - busy / prof['wall_ms']:.1%}); " if busy is not None else "")
          + f"host parts: row arrays to the card {prof['h2d_ms']:.3f} ms, logits "
          f"({prof['logits_bytes'] / 1e6:.3f} MB) back {prof['d2h_ms']:.3f} ms, "
          f"{len(res['slots'])} host draws {prof['sample_ms']:.3f} ms; card {card}")
    del res, engine, bat, ss
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


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
                "mamba_scan": 0, "rwkv6_wkv": 0,
                "flash_decode_latent": 0}
    per_eval = {"flash_decode": 0, "flash_attention": L * M, "flash_attention_bwd": 0,
                "fused_swiglu": L * M, "swiglu_bwd": 0, "quantize_tiles": hops,
                "dequantize_tiles": hops, "mamba_scan": 0, "rwkv6_wkv": 0,
                "flash_decode_latent": 0}
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
            "flash_attention_cluster_kernel": "flash_attention",
            "flash_attention_simt_kernel": "flash_attention",
            "flash_bwd_row_dot_kernel": "flash_attention_bwd",
            "flash_bwd_dkdv_wgmma_kernel": "flash_attention_bwd",
            "flash_bwd_dq_wgmma_kernel": "flash_attention_bwd",
            "flash_bwd_dkdv_simt_kernel": "flash_attention_bwd",
            "flash_bwd_dq_simt_kernel": "flash_attention_bwd",
            "flash_bwd_dkdv_cluster_kernel": "flash_attention_bwd",
            "flash_bwd_dq_cluster_kernel": "flash_attention_bwd",
            "flash_bwd_sum_parts_kernel": "flash_attention_bwd",
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


def trace_cuda(torch, fn, n: int):
    """(device ms a call, or None when the trace holds no device time; the
    CUDA kernels' ``key_averages`` rows) of a ``torch.profiler`` trace of
    ``n`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    return (total_us / n / 1e3 if total_us > 0 else None), kernels


def profile_decode(torch, cfg, params, token, B, cache_len, dev, n_steps=8, ss=None):
    """Device kernel time per decode step from a ``torch.profiler`` trace of
    ``n_steps`` steps at half the cache length (after 2 untraced ones) of
    the lockstep step ``ss`` (default ``build_serve_step``'s, one data
    shard); prints the top kernels.  Returns (that time, or None when the
    trace holds no device time; the trace's CUDA kernel rows)."""
    from repro_torch.runtime.serve import build_serve_step, prepare_serve_states

    if ss is None:
        ss = build_serve_step(cfg, batch_global=B, cache_len=cache_len)
    states = prepare_serve_states(cfg, ss.spec.plan, B, cache_len, dev)
    start = cache_len // 2            # mid-run cache length
    for pos in range(start - 2, start):
        ss.step_fn(params, token, pos, states)
    positions = iter(range(start, start + n_steps))
    busy_ms, kernels = trace_cuda(
        torch, lambda: ss.step_fn(params, token, next(positions), states), n_steps)
    del states
    if busy_ms is None:
        print("  profiler trace holds no device time: device busy share not measured")
        return None, kernels
    print(f"  decode-step trace ({n_steps} steps): top kernels by device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n_steps / 1e3:8.3f} ms/step "
              f"{e.count // n_steps:5d} launches/step  {e.key[:90]}")
    return busy_ms, kernels


# ---------------------------------------------------------------------------
# Phase 6c: the paper's loop: profile -> plan -> lower -> train
# ---------------------------------------------------------------------------


def phase_plan_train(torch, ops, dev, card: str, arch: str = "phi3-mini-3.8b",
                     label: str = "6c", n_layers: int | None = None, seq: int = 256,
                     steps: int = 4, mem_gb: float = 20, batches: str = "1,2,4,8") -> dict:
    """Full width: ``launch.profile`` measures ``arch`` (cut to its first
    ``n_layers`` layers when given) into an artifact (4 virtual devices of
    ``mem_gb`` GB), ``launch.train --plan
    --profile`` plans it (``plan_hpp``), lowers it and trains ``steps``
    steps (1 warm-up) on the planner's period split, with the launch counts
    of every step and of one forward-only evaluation held against what the
    plan implies (an MoE layer runs each expert where a dense layer runs
    one MLP); the plan's prediction beside the measured step."""
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import simulate
    from repro_torch.kernels.flash_attention import FWD_ROUTES, reset_fwd_routes
    from repro_torch.launch import profile as profiler_cli
    from repro_torch.launch import train as launcher
    from repro_torch.optim import tree_leaves

    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    L, M, B, S, n_dev, tag = cfg.n_layers, 4, 8, seq, 4, label
    E = cfg.moe.n_experts if any(sp.mlp == "moe" for sp in cfg.pattern) else 1
    out_dir = ROOT / "profiles"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / f"phase{label}_profile.json")
    print(f"phase {label} (a): profile full-width {arch} on the card")
    t0 = time.perf_counter()
    cut = ["--n-layers", str(L)] if n_layers else []
    profiler_cli.main(["--arch", cfg.name, *cut, "--seq", str(S), "--batches", batches,
                       "--replicate", str(n_dev), "--mem-gb", str(mem_gb), "-o", path])
    print(f"  profiled {L} layers in {time.perf_counter() - t0:.1f}s ({n_dev} virtual "
          f"devices of {mem_gb} GB); card {card}")
    torch.cuda.empty_cache()

    print(f"phase {label} (b): plan, lower and train through launch.train --plan --profile")
    argv = ["--plan", "--profile", path, "--devices", str(n_dev), "--global-batch", str(B),
            "--n-micro", str(M), "--seq", str(S), "--compress", "int8", "--bucket-mb", "256",
            "--no-error-feedback", "--steps", str(steps), "--log-every", "1"]
    argv += cut
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
    reset_fwd_routes()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    route = fwd_route_of(cfg.attn.head_dim)
    if FWD_ROUTES != {n: launches["flash_attention"] * (n == route) for n in FWD_ROUTES}:
        raise AssertionError(f"{arch}'s forward routes {FWD_ROUTES}: not all on {route}")
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
    per_step = _train_counts(L, M, P, nb, E)
    per_eval = {"flash_decode": 0, "flash_attention": L * M, "flash_attention_bwd": 0,
                "fused_swiglu": E * L * M, "swiglu_bwd": 0, "quantize_tiles": hops,
                "dequantize_tiles": hops, "mamba_scan": 0, "rwkv6_wkv": 0,
                "flash_decode_latent": 0}
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
    print(f"plan_train ({tag}) {cfg.name} full width fp32, {L} layers, seq {S}, from the "
          f"measured profile: "
          f"predicted round latency {plan.latency * 1e3:.1f} ms ({n_dev} devices in "
          f"parallel), simulated {sim.makespan * 1e3:.1f} ms (execution phase "
          f"{sim.exec_span_s * 1e3:.1f} ms, stage AllReduce charged "
          f"{sim.charged_allreduce_s * 1e3:.1f} ms over the artifact's modeled "
          f"{prof.cluster.bandwidth * 8 / 1e6:.0f} Mbps link), summed device work "
          f"{work_s * 1e3:.1f} ms (one card runs it in turn); measured {ms_step:.1f} ms/step "
          f"over {res['timed_steps']} timed steps, {res['tok_s']:.1f} tok/s; peak memory "
          f"{peak / 1e9:.3f} GB; losses {[round(x, 6) for x in losses]}, "
          f"{loss_after[0]:.6f} on step 0's batch after it; card {card}")
    del res, ts, held
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": peak / 1e9,
            "predicted_ms": plan.latency * 1e3, "work_ms": work_s * 1e3,
            "stage_periods": lowered.stage_periods, "per_step": per_step,
            "exec_ms": sim.exec_span_s * 1e3, "allreduce_ms": sim.charged_allreduce_s * 1e3}


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


def _train_counts(L, M, P, nb, experts: int = 1):
    """One step's launches: L layers, M micro-batches, P stages, nb buckets;
    each MoE layer runs ``experts`` MLPs where a dense layer runs one."""
    hops = M * (P - 1)
    return {"flash_decode": 0, "flash_attention": 2 * L * M, "flash_attention_bwd": L * M,
            "fused_swiglu": 2 * experts * L * M, "swiglu_bwd": experts * L * M,
            "quantize_tiles": 2 * hops + nb, "dequantize_tiles": 2 * hops + nb,
            "mamba_scan": 0, "rwkv6_wkv": 0,
            "flash_decode_latent": 0}


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
                   "dequantize_tiles": hops, "mamba_scan": 0, "rwkv6_wkv": 0,
                   "flash_decode_latent": 0}
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
# Phase 6e: the plan portfolio: the opening auction, a churn auction, and a
# probation's bit-identity
# ---------------------------------------------------------------------------

# the portfolio's auctions run phi3 at full width and 16 of its 32 layers:
# a compressed finalist brings error feedback and one unbounded bucket per
# free-axes group (CompressionConfig's defaults), whose residual and wire
# copies (reckon_probe) do not fit beside the 32-layer state
PORTFOLIO_LAYERS = 16


def _step_counts(L, ts):
    """Kernel launches of one training step, or of one probe round (the
    gradient function launches every kernel of the step), of ``ts`` at
    ``L`` layers: quantize and dequantize only where ``ts`` has a wire."""
    spec = ts.spec
    M, P = spec.n_micro, spec.plan.stage
    q = 2 * M * (P - 1) + len(ts.buckets) if spec.compress != "none" else 0
    return {"flash_decode": 0, "flash_attention": 2 * L * M, "flash_attention_bwd": L * M,
            "fused_swiglu": 2 * L * M, "swiglu_bwd": L * M, "quantize_tiles": q,
            "dequantize_tiles": q, "mamba_scan": 0, "rwkv6_wkv": 0,
            "flash_decode_latent": 0}


def reckon_probe(ts, params) -> dict:
    """Bytes a probe round of ``ts`` holds at its peak, activations left
    out, from the code: the parameters, AdamW's m and v, one round's
    gradients, the session's residual tree (``init_ef``: one float per
    parameter with error feedback), and the wire's transients at its worst
    bucket (``runtime.train.wire_buckets``, ``quant_transfer.roundtrip_ef``):
    the residuals of the buckets before it, the bucket's flattened copy
    (more than one leaf), the compensated sum and the new residual (error
    feedback), the dequantized copy, and the payload with its scales
    (gone before the new residual is taken)."""
    from repro_torch.optim import tree_leaves

    spec = ts.spec
    n_par = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    wire = spec.compress != "none"
    ef = wire and spec.error_feedback
    worst, done = 0, 0
    if wire:
        for _, idxs, sizes in ts.buckets:
            n = sum(sizes)
            payload = n + 4 * -(-n // spec.quant_tile)
            here = (done + (4 * n if len(idxs) > 1 else 0) + (4 * n if ef else 0)
                    + 4 * n + max(payload, 4 * n if ef else 0))
            worst = max(worst, here)
            done += 4 * n if ef else 0
    out = {"params": n_par, "moments": 2 * n_par, "grads": n_par,
           "residual": n_par if ef else 0, "wire": worst}
    out["total"] = sum(out.values())
    return out


def _timed(torch, dev, obj, name, wall, before=None, after=None):
    """Replace ``obj.name`` by a wrapper that synchronizes the card around
    the call and appends its wall seconds to ``wall[name]``; ``before()``
    and ``after(out)`` run outside the timed span."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        if before is not None:
            before()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize(dev)
        wall.setdefault(name, []).append(time.perf_counter() - t)
        if after is not None:
            after(out)
        return out
    setattr(obj, name, run)


def _portfolio_cut(cfg, src: str, name: str) -> str:
    """``src``'s artifact cut to ``cfg``'s depth (``launch.profile.cut_layers``)
    under ``profiles/``."""
    from repro_torch.core.profiler import load_profile, save_profile
    from repro_torch.launch.profile import cut_layers

    path = str(ROOT / "profiles" / name)
    save_profile(path, cut_layers(load_profile(str(ROOT / "profiles" / src)), cfg))
    return path


def _run_portfolio(torch, ops, dev, argv, L):
    """``launch.train`` with ``argv`` in process, every auction watched:
    the probe rounds' launches and peak memory, the wall time of each
    auction split into adoptions, probe rounds, the closing re-seed of the
    backups and the rest, the digests' wall; every step's launches."""
    from repro_torch.launch import train as launcher

    zeros = {k: 0 for k in ops.LAUNCHES}
    marks, probes, auctions, wall, got = [], [], [], {}, {}

    def probe_before():
        s = got["session"]
        marks.append((f"before probe {len(probes)}", dict(ops.LAUNCHES), zeros))
        torch.cuda.reset_peak_memory_stats(dev)
        probes.append({"spec": s.ts.spec, "reckoned": reckon_probe(s.ts, s.params),
                       "counts": _step_counts(L, s.ts),
                       "retries": torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)})

    def probe_after(out):
        p = probes[-1]
        p["peak"] = torch.cuda.max_memory_allocated(dev)
        p["retries"] = (torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
                        - p["retries"])
        n = len(out[0])
        marks.append((f"probe {len(probes) - 1} ({n} rounds)", dict(ops.LAUNCHES),
                      {k: n * v for k, v in p["counts"].items()}))

    def auction_before():
        got["at"] = {k: len(v) for k, v in wall.items()}
        got["first_probe"] = len(probes)

    def auction_after(report):
        at = got["at"]

        def new(name):
            return wall.get(name, [])[at.get(name, 0):]

        auctions.append({"report": report, "wall": wall["probe_portfolio"][-1],
                         "adopt": sum(new("_adopt_plan")), "n_adopt": len(new("_adopt_plan")),
                         "probe": sum(new("_probe_rounds")),
                         "reseed": sum(new("_reseed_backups")),
                         "probes": probes[got["first_probe"]:],
                         "step": got["session"].step_count,
                         "live": got["session"].live_ranks})

    def on_session(session):
        got["session"] = session
        for name in ("_adopt_plan", "_reseed_backups", "canonical_digests"):
            _timed(torch, dev, session, name, wall)
        _timed(torch, dev, session, "_probe_rounds", wall, probe_before, probe_after)
        _timed(torch, dev, session, "probe_portfolio", wall, auction_before, auction_after)
        fail = session.fail

        def fail_watched(rank):
            got["failed"] = rank
            return fail(rank)
        session.fail = fail_watched

    peaks = []

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES), _step_counts(L, ts)))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = launcher.main(argv, after_step=after_step, on_session=on_session)
    launches = dict(ops.LAUNCHES)
    _check_marks(marks, launches, lambda label, want: want)
    return res, launches, auctions, wall, got, peaks


def _print_auction(a, card: str) -> None:
    rep = a["report"]
    for i, (r, p) in enumerate(zip(rep.results, a["probes"])):
        spec, rk = p["spec"], p["reckoned"]
        print(f"  finalist {i} {r.family}: P {spec.plan.stage}, M {spec.n_micro}, staleness "
              f"{spec.staleness}, wire {spec.compress}"
              + (f" (error feedback {spec.error_feedback}, bucket_mb {spec.bucket_mb})"
                 if spec.compress != "none" else f" (bucket_mb {spec.bucket_mb})")
              + f"; predicted round {r.predicted_s * 1e3:.1f} ms; wall rounds "
              f"{[round(x * 1e3, 1) for x in r.rounds]} ms, CUDA-event rounds "
              f"{[round(x * 1e3, 1) for x in r.device_rounds]} ms, measured "
              f"{r.measured_s * 1e3:.1f} ms; peak reckoned {rk['total'] / 1e9:.3f} GB "
              f"(params {rk['params'] / 1e9:.3f}, m+v {rk['moments'] / 1e9:.3f}, grads "
              f"{rk['grads'] / 1e9:.3f}, residual {rk['residual'] / 1e9:.3f}, wire "
              f"{rk['wire'] / 1e9:.3f}; activations left out), measured "
              f"{p['peak'] / 1e9:.3f} GB, {p['retries']} allocator retries (a cache flush and "
              f"a new cudaMalloc each)" + ("  <- installed" if r.installed else ""))
    rest = a["wall"] - a["adopt"] - a["probe"] - a["reseed"]
    print(f"  winner {rep.winner.family} (finalist {rep.winner_index}), churned "
          f"{rep.churned}; {len(rep.results)} finalists of {rep.n_candidates} candidates "
          f"({rep.n_enumerated} enumerated), {rep.window}-round probation; auction wall "
          f"{a['wall'] * 1e3:.1f} ms: adoptions {a['adopt'] * 1e3:.1f} ms ({a['n_adopt']}), "
          f"probe rounds {a['probe'] * 1e3:.1f} ms, closing re-seed of backups "
          f"{a['reseed'] * 1e3:.1f} ms, the rest (enumeration, lowering checks) "
          f"{rest * 1e3:.1f} ms; card {card}")


def phase_portfolio(torch, ops, dev, card: str) -> dict:
    """6e (a): the opening auction.  ``launch.train --plan --portfolio 3
    --probation-rounds 2`` at full width and 16 layers on 6c's artifact cut
    to that depth (4 virtual devices of 20 GB, model axis 4), batch 8 x
    256, 4 steps."""
    from repro_torch.configs import get_config

    L = PORTFOLIO_LAYERS
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=L)
    path = _portfolio_cut(cfg, "phase6c_profile.json", "phase6e_profile.json")
    argv = ["--plan", "--profile", path, "--n-layers", str(L), "--devices", "4",
            "--global-batch", "8", "--n-micro", "4", "--seq", "256", "--compress", "int8",
            "--bucket-mb", "256", "--no-error-feedback", "--portfolio", "3",
            "--probation-rounds", "2", "--steps", "4", "--log-every", "1"]
    res, launches, auctions, wall, got, peaks = _run_portfolio(torch, ops, dev, argv, L)
    report, identical = res["portfolio"]
    if len(auctions) != 1 or auctions[0]["report"] is not report:
        raise AssertionError(f"{len(auctions)} auctions, not the opening one alone")
    _print_auction(auctions[0], card)
    digests = wall["canonical_digests"]
    print(f"  portfolio: probation state bit-identical: {identical} (per-leaf SHA-256 "
          f"digests before and after, {[round(x, 2) for x in digests]} s)")
    if not identical:
        raise AssertionError("the opening auction changed the training state")
    if len(report.results) < 2:
        raise AssertionError(f"{len(report.results)} finalists: nothing was auctioned")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    print(f"portfolio_train phi3-mini-3.8b full width, {L} layers, fp32: winner "
          f"{report.winner.family} installed; {ms_step:.1f} ms/step after the auction over "
          f"{res['timed_steps']} timed steps; peak memory of the steps "
          f"{max(peaks) / 1e9:.3f} GB; losses {[round(x, 6) for x in losses]}; card {card}")
    got.clear()
    del res, report
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "auction_s": auctions[0]["wall"]}


def phase_portfolio_churn(torch, ops, dev, card: str) -> dict:
    """6e (b): the churn auction.  6d (c)'s cluster (3 virtual devices of
    36 GB, model axis 6) at 16 layers with ``--portfolio 2 --fail-at 3``:
    the last stage's device of the installed plan fails, and the step that
    recovers runs a 2-candidate auction planned on the survivors."""
    from repro_torch.configs import get_config

    L = PORTFOLIO_LAYERS
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=L)
    path = _portfolio_cut(cfg, "phase6d_profile.json", "phase6e_churn_profile.json")
    argv = ["--plan", "--profile", path, "--n-layers", str(L), "--devices", "6",
            "--global-batch", "8", "--n-micro", "4", "--seq", "256", "--compress", "int8",
            "--bucket-mb", "256", "--no-error-feedback", "--staleness", "1",
            "--portfolio", "2", "--fail-at", "3", "--backup-every", "2", "--steps", "5",
            "--log-every", "1"]
    res, launches, auctions, wall, got, _ = _run_portfolio(torch, ops, dev, argv, L)
    session = res["session"]
    if len(auctions) != 2 or len(session.recoveries) != 1:
        raise AssertionError(f"{len(auctions)} auctions and {len(session.recoveries)} "
                             "recoveries, not the opening auction, one recovery and the "
                             "churn auction")
    churn = auctions[1]
    rank = got["failed"]
    survivors = tuple(d for d in range(3) if d != rank)
    print(f"  opening auction: winner {auctions[0]['report'].winner.family}")
    print(f"  rank {rank} failed before step 3; recovery "
          f"{session.recoveries[0].mode}; churn auction at step {churn['step']} on the "
          f"survivors {survivors}:")
    _print_auction(churn, card)
    installed = tuple(sorted({d for st in session.plan.stages for d in st.group}))
    print(f"  installed plan {[(st.layers, st.group) for st in session.plan.stages]}: ranks "
          f"{installed}, live {session.live_ranks}")
    if (churn["step"] != 3 or len(churn["report"].results) > 2
            or churn["live"] != session.live_ranks):
        raise AssertionError(f"churn auction after step {churn['step']} of "
                             f"{len(churn['report'].results)} finalists with live ranks "
                             f"{churn['live']}")
    if rank in installed or not set(installed) <= set(survivors):
        raise AssertionError(f"the installed plan uses ranks {installed}; rank {rank} failed")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    print(f"portfolio_churn phi3-mini-3.8b full width, {L} layers, fp32, 3 x 36 GB virtual "
          f"devices: losses {[round(x, 6) for x in losses]}; card {card}")
    got.clear()
    del res, session
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "auction_s": churn["wall"]}


def phase_portfolio_identity(torch, ops, dev, card: str) -> None:
    """6e (c): at 4 full-width layers, a session probed with k = 3, window
    1 between steps 2 and 3 and a twin never probed, on the same batches:
    their canonical leaves equal leaf by leaf under ``torch.equal`` on the
    card."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiler import load_profile
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.session import PipelineSession

    cfg = get_config("phi3-mini-3.8b").replace(n_layers=4)
    path = _portfolio_cut(cfg, "phase6c_profile.json", "phase6e_identity_profile.json")
    argv = ["--plan", "--profile", path, "--n-layers", "4", "--devices", "4",
            "--global-batch", "8", "--n-micro", "4", "--seq", "256", "--compress", "int8",
            "--bucket-mb", "256", "--no-error-feedback"]
    plan, prof = launcher._plan(launcher._parse(argv), cfg, load_profile(path), 4, dev)
    if prof.source != "measured":
        raise AssertionError(f"planned on the {prof.source} profile")
    kw = dict(compress="int8", bucket_mb=256, error_feedback=False, device=dev)
    probed, twin = (PipelineSession(cfg, 4, plan, prof, backup_every=0, **kw)
                    for _ in range(2))
    for s in (probed, twin):
        s.init(4)
    ds = SyntheticLM(cfg.vocab_size, 256)
    for k in range(2):
        for s in (probed, twin):
            s.step(ds.batch(k, 8))
    report = probed.probe_portfolio(ds.batch(2, 8), k=3, window=1)
    a = probed.canonical_leaves(as_numpy=False)
    b = twin.canonical_leaves(as_numpy=False)
    pairs = [(x, y) for k in b for x, y in zip(tree_leaves(a[k]), tree_leaves(b[k]))]
    same = a.keys() == b.keys() and all(torch.equal(x, y) for x, y in pairs)
    print(f"  {len(report.results)} finalists {[r.family for r in report.results]}, winner "
          f"{report.winner.family}; {len(pairs)} canonical leaves (params, m, v) of the "
          f"probed session equal to the never-probed twin's under torch.equal: {same}")
    if not same:
        raise AssertionError("the probation changed the training state")
    losses = [s.step(ds.batch(2, 8))[0] for s in (probed, twin)]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    del probed, twin, a, b, pairs
    gc.collect()
    torch.cuda.empty_cache()


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
            y_card = apply_layer(p_card, x.to(dev), positions.to(dev), cfg, spec)[0].cpu()
            y_cpu = apply_layer(p_cpu, x, positions, cfg, spec)[0]
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
    device_ms, _ = profile_decode(torch, cfg, params, tokens[:batch, 0], batch, prompt + gen, dev)

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
        y_card = apply_layer(p_card, x.to(dev), positions.to(dev), cfg, spec)[0].cpu()
        y_cpu = apply_layer(p_cpu, x, positions, cfg, spec)[0]
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
            y = apply_layer(p, x, positions, cfg, spec)[0]
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
    device_ms, _ = profile_decode(torch, cfg, params, tokens[:batch, 0], batch, prompt + gen, dev)

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


# ---------------------------------------------------------------------------
# Phases 10a-10f: the dense families (gemma-2b, gemma2-2b, deepseek-7b)
# ---------------------------------------------------------------------------

# flash attention at the dense families' shapes, fp32, causal: name -> (B,
# S, H, Hkv, D, window, softcap): gemma-2b's prefill (MQA), gemma2's
# (GQA 2, softcap 50), the training micro-batches at the published context
# (gemma-2b's: the dK/dV pass unsplit, g = 1, so a cluster sums over 8 q
# heads x 8192 queries; gemma2's: the local layers' window of 4096 binds),
# and a softcapped head_dim 96 (the tensor-core route)
DENSE_ATTN = {
    "gemma_prefill": (2, 512, 8, 1, 256, None, None),
    "gemma2_prefill": (2, 512, 8, 4, 256, None, 50.0),
    "gemma_train": (1, 8192, 8, 1, 256, None, None),
    "gemma2_train": (1, 8192, 8, 4, 256, 4096, 50.0),
    "softcap_d96": (2, 256, 8, 2, 96, None, 50.0),
}
# flash_decode at gemma-2b's and gemma2's decode steps (batch 8, cache 256,
# phase 3's per-row lengths), as DECODE_SHAPES
DENSE_DECODE_SHAPES = {
    "gemma": (8, 8, 1, 256, 256, DECODE_SHAPES["phi3"][5]),
    "gemma2": (8, 8, 4, 256, 256, DECODE_SHAPES["phi3"][5]),
}
# attention kernels at those shapes against their plain versions, fp32 (the
# forward, the backward's dq/dk/dv, decode): sums over head_dim 256 and up to
# 8 heads x 8192 queries in other orders.  1.5x the 1.29e-05 read on an H100
# at the 8192-row backward (dV; the kernel is 4.8e-06 from float64 there,
# the plain version 1.19e-05).
TOL_DENSE_ATTN = 2e-5
# gemma2 at full width, max |diff| / max |value|: prefill against lockstep
# decode on the card (10b, 10c), phase 7b's tolerance
TOL_PREFILL_DECODE = TOL_JAMBA_DECODE
DENSE_ARCHS = ("gemma-2b", "gemma2-2b", "deepseek-7b")


def swiglu_bwd_check(torch, kernel, plain_fn, gg, uu, dh, draw: str) -> float:
    """``swiglu_bwd``'s gelu_tanh gradient (dg, du, h) on one draw, held to a
    float64 evaluation of the same expression and to its float32 plain
    version, each within TOL_ELEMENTWISE plus the plain version's distance
    from float64, and no farther from float64 than the plain version;
    distances max |err| / (1 + |reference|).  Returns the max abs err
    against the plain version."""
    def dist(a, b):
        return float(((a.double() - b.double()).abs() / (1 + b.double().abs())).max())

    got = kernel(gg, uu, dh, "gelu_tanh")
    plain = plain_fn(gg, uu, dh, "gelu_tanh")
    exact = plain_fn(gg.double(), uu.double(), dh.double(), "gelu_tanh")
    k64 = max(dist(a, b) for a, b in zip(got, exact))
    p64 = max(dist(a, b) for a, b in zip(plain, exact))
    kp = max(dist(a, b) for a, b in zip(got, plain))
    err = max(max_err(a, b) for a, b in zip(got, plain))
    del got, plain, exact
    what = f"swiglu_bwd elementwise {tuple(gg.shape)} gelu_tanh, {draw}"
    print(f"  {what}: from float64 kernel {k64:.3e}, plain {p64:.3e}; max abs err against "
          f"the plain version {err:.3e}")
    check(k64, TOL_ELEMENTWISE + p64, what + ", against float64", "max |err| / (1 + |float64|)")
    check(kp, TOL_ELEMENTWISE + p64, what, "max |err| / (1 + |plain|)")
    if not k64 <= p64:
        raise AssertionError(f"{what}: the kernel is farther from float64 ({k64}) than the "
                             f"plain version ({p64})")
    return err


def attn_rows(torch, ops, F, dev, name, shape, gen, rows: dict,
              tol: float = TOL_DENSE_ATTN) -> None:
    """``flash_attention`` and ``flash_attention_bwd`` at ``shape`` = (B, S,
    H, Hkv, D, window, softcap), causal, fp32, inputs drawn from ``gen``:
    each against its plain version within ``tol`` (and, at head_dim 256, two
    runs bitwise on the clusters; from 2048 rows, the backward against
    float64 too), then
    timed beside its bound, plain version and SDPA (where there is no
    window or softcap); one row each appended to ``rows`` under ``name``."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_route,
                                                     flash_attention_fwd_route)

    B, S, H, Hkv, D, win, cap = shape

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    q, k, v = (rnd(B, S, n, D) for n in (H, Hkv, Hkv))
    dout = rnd(B, S, H, D, scale=1.0)
    kw = dict(window=win, softcap=cap)
    what = f"({B}, {S}, {H}, {Hkv}, {D}) causal window={win} softcap={cap}"
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    f_err = max_err(out, ops.plain_flash_attention(q, k, v, **kw))
    check(f_err, tol, f"flash_attention {name} {what}")
    f_route = flash_attention_fwd_route(q, k, v)
    check_route(f_route, fwd_route_of(D), f"flash_attention {name}")
    if D > 128:
        # head_dim 256: the two-CTA clusters, deterministic, and the
        # output the same bits without the logsumexp
        again, lse2 = flash_attention(q, k, v, return_lse=True, **kw)
        same = bitwise_equal(torch, out, again) and bitwise_equal(torch, lse, lse2)
        bare = bitwise_equal(torch, out, flash_attention(q, k, v, **kw))
        del again, lse2
        print(f"  flash_attention {name}: route {f_route}, two runs bitwise "
              f"{'equal' if same else 'DIFFERENT'}, without the logsumexp "
              f"{'equal' if bare else 'DIFFERENT'}")
        if not (same and bare):
            raise AssertionError(f"flash_attention {name}: two runs bitwise {same}, "
                                 f"with and without the logsumexp {bare}")
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    plain = ops.plain_flash_attention_bwd(q, k, v, dout, **kw)
    b_err = max(max_err(a, b) for a, b in zip(got, plain))
    b_tol = tol
    if S >= 2048:
        exact = attention_bwd_float64(torch, q, k, v, dout, **kw)
        check(max(max_err(a, b) for a, b in zip(got, exact)),
              tol, f"flash_attention_bwd {name} against float64")
        p64 = max(max_err(a, b) for a, b in zip(plain, exact))
        print(f"  plain flash_attention_bwd {name} against float64: max abs err {p64:.3e}")
        if name == "gemma_train":
            # there the plain version is itself about TOL_DENSE_ATTN from
            # the exact answer (2.623e-05 on draws of seed 29 on an H100:
            # dV sums 8 heads x 8192 queries in two fp32 stages), so the
            # kernel, held to TOL_DENSE_ATTN from float64 above, is held
            # to the plain version within TOL_DENSE_ATTN plus that distance
            b_tol += p64
        del exact
    del plain
    check(b_err, b_tol, f"flash_attention_bwd {name} {what} dq/dk/dv")
    route = flash_attention_bwd_route(q, k, v, dout)
    if D > 128:
        # head_dim 256: the two-CTA clusters, deterministic
        same = all(bitwise_equal(torch, a, b) for a, b in
                   zip(got, flash_attention_bwd(q, k, v, out, lse, dout, **kw)))
        print(f"  flash_attention_bwd {name}: route {route}, two runs bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
        if route != "tc_cluster" or not same:
            raise AssertionError(f"flash_attention_bwd {name}: route {route}, two runs "
                                 f"bitwise {'equal' if same else 'different'}")
    del got
    torch.cuda.empty_cache()
    f_ms = time_ms([lambda: ops.flash_attention_op(q, k, v, **kw)], torch)
    f_plain = time_ms([lambda: ops.plain_flash_attention(q, k, v, **kw)], torch)
    b_ms = time_ms([lambda: flash_attention_bwd(q, k, v, out, lse, dout, **kw)], torch)
    b_plain = time_ms([lambda: ops.plain_flash_attention_bwd(q, k, v, dout, **kw)], torch)
    f_lib = b_lib = None
    if cap is None and win is None:
        # SDPA on the heads expanded to q's beforehand (outside the timing)
        qt, kt, vt = (t.repeat_interleave(H // t.shape[2], 2).transpose(1, 2).detach()
                      .requires_grad_(True) for t in (q, k, v))
        dt = dout.transpose(1, 2)
        f_lib = time_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                is_causal=True)], torch)

        def sdpa():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.autograd.grad(o, (qt, kt, vt), dt)

        b_lib = time_ms([sdpa], torch)

        def port():
            o, ls = flash_attention(q, k, v, return_lse=True)
            flash_attention_bwd(q, k, v, o, ls, dout)

        fb_ms = time_ms([port], torch)
        print(f"  flash attention forward + backward {name}: port {fb_ms:.4f} ms, SDPA "
              f"{b_lib:.4f} ms")
        del qt, kt, vt, dt
    fb, fby = flash_bound(B, S, H, Hkv, D, window=win, softcap=cap)
    bb, bby = flash_bwd_bound(B, S, H, D, Hkv, win, cap)
    lib = "none" if f_lib is None else f"{f_lib:.4f} ms"
    print(f"  flash_attention {name} ({f_route}): kernel {f_ms:.4f} ms, plain "
          f"{f_plain:.4f} ms, SDPA {lib}, bound {fb:.4f} ms ({fby}, {fb / f_ms:.1%} of it)")
    lib = "none" if b_lib is None else f"{b_lib:.4f} ms (fwd+bwd)"
    print(f"  flash_attention_bwd {name}: kernel {b_ms:.4f} ms, plain (autograd) "
          f"{b_plain:.4f} ms, SDPA {lib}, bound {bb:.4f} ms ({bby}, {bb / b_ms:.1%} of it)")
    shape = f"q/k/v ({B},{S},{H},{D}) kv {Hkv} causal window {win} softcap {cap} fp32"
    rows["flash_attention"].append(
        {"row": name, "route": f_route, "max_abs_err": f_err, "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": fb, "bound_by": fby, "library_ms": f_lib,
         "shape": shape})
    rows["flash_attention_bwd"].append(
        {"row": name, "route": route, "max_abs_err": b_err, "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": bb, "bound_by": bby, "library_ms": b_lib,
         "shape": shape})
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()


def decode_row(torch, ops, F, dev, g, name, shapes, cap=None) -> dict:
    """``flash_decode`` at ``shapes[name]`` (as ``DECODE_SHAPES``), fp32,
    inputs from ``g``, under softcap ``cap``: against its plain version,
    then timed beside its bound, plain version and SDPA (none under a
    softcap); its row."""
    B, H, Hkv, S, D, lens = shapes[name]
    q, k, v, clen = decode_inputs(torch, dev, g, name, shapes=shapes)
    err = max_err(ops.flash_decode_op(q, k, v, clen, softcap=cap),
                  ops.plain_flash_decode(q, k, v, clen, softcap=cap))
    check(err, TOL_DENSE_ATTN, f"flash_decode {name} q ({B}, {H}, {D}) cache "
                               f"({B}, {S}, {Hkv}, {D}) per-row lengths softcap={cap}")
    ms = time_ms([lambda: ops.flash_decode_op(q, k, v, clen, softcap=cap)], torch)
    plain = time_ms([lambda: ops.plain_flash_decode(q, k, v, clen, softcap=cap)], torch)
    lib = None
    if cap is None:
        a = sdpa_decode_args(torch, q, k, v, clen)
        lib = time_ms([lambda: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                              attn_mask=a[3])], torch)
    bms, by = decode_bound(name, shapes=shapes)
    print(f"  flash_decode {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA "
          f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms ({by})")
    return {"row": name, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": lib,
            "shape": f"q ({B},{H},{D}) cache ({B},{S},{Hkv},{D}) lens sum {sum(lens)} "
                     f"softcap {cap} fp32"}


def phase_dense_kernels(torch, ops, F, dev, entries: dict) -> None:
    """10a: the kernels at the dense families' shapes against their plain
    versions on the card, timed beside their bounds, plain versions and
    library calls (SDPA has no softcap: "none" there), into each kernel's
    entry as ``dense`` rows."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_route,
                                                     flash_attention_fwd_route)
    from repro_torch.kernels.fused_swiglu import swiglu_bwd
    from repro_torch.kernels.ref import naive_swiglu_act_bwd

    g = torch.Generator(device=dev).manual_seed(29)
    rows = {name: [] for name in ("flash_attention", "flash_attention_bwd", "flash_decode",
                                  "fused_swiglu", "swiglu_bwd")}

    def rnd(*shape, scale=0.5, gen=g):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    for name, shape in DENSE_ATTN.items():
        # gemma-2b's micro-batch, the last row added, draws from its own
        # generator: the draws of the rows and checks after it stay as they were
        gen = torch.Generator(device=dev).manual_seed(31) if name == "gemma_train" else g
        attn_rows(torch, ops, F, dev, name, shape, gen, rows)

    # phase 3b's one-sign case at head_dim 256, MQA: 8192 causal rows, q/k
    # in [0, 1), dO and V in [1, 1.1), on the clusters: one-sign sums over up
    # to 128 tiles, dP and Dvec (~282 each) cancelling in dS.  Its own
    # generator: the draws of the checks below stay as they were
    g1 = torch.Generator(device=dev).manual_seed(30)
    qq, kk = (torch.rand((1, 8192, n, 256), generator=g1, device=dev) for n in (2, 1))
    vv = torch.rand((1, 8192, 1, 256), generator=g1, device=dev).mul_(0.1).add_(1.0)
    do = torch.rand((1, 8192, 2, 256), generator=g1, device=dev).mul_(0.1).add_(1.0)
    o, ls = flash_attention(qq, kk, vv, return_lse=True)
    check_route(flash_attention_fwd_route(qq, kk, vv), "tc_cluster",
                "the one-sign case's forward at head_dim 256")
    what = "flash_attention long causal (1, 8192, 2/1, 256), V around 1"
    check(max_err(o, ops.plain_flash_attention(qq, kk, vv)), TOL_FP32, what)
    check(max_err(o, attention_float64(torch, qq, kk, vv)), TOL_FP32, what + ", against float64")
    check_route(flash_attention_bwd_route(qq, kk, vv, do), "tc_cluster",
                "the one-sign case at head_dim 256")
    got = flash_attention_bwd(qq, kk, vv, o, ls, do)
    plain = ops.plain_flash_attention_bwd(qq, kk, vv, do)
    exact = attention_bwd_float64(torch, qq, kk, vv, do)
    what = "flash_attention_bwd long causal (1, 8192, 2/1, 256), dO and V around 1"
    print(f"  {what}: dq/dk/dv from float64: kernel "
          f"{' '.join(f'{max_err(x, y):.3e}' for x, y in zip(got, exact))}, plain "
          f"{' '.join(f'{max_err(x, y):.3e}' for x, y in zip(plain, exact))}; largest |dq|/|dk|/"
          f"|dv| {' '.join(f'{float(y.abs().max()):.3f}' for y in exact)}")
    check(max(max_err_rel(x, y) for x, y in zip(got, plain)), TOL_FP32, what,
          "max |err| / (1 + |plain|)")
    check(max(max_err(x, y) for x, y in zip(got, exact)), TOL_FP32, what + ", against float64")
    del qq, kk, vv, do, o, ls, got, plain, exact
    torch.cuda.empty_cache()

    for name in DENSE_DECODE_SHAPES:
        rows["flash_decode"].append(decode_row(torch, ops, F, dev, g, name, DENSE_DECODE_SHAPES,
                                               50.0 if name == "gemma2" else None))

    # gemma2's MLP: GeGLU at d_model 2304, d_ff 9216, a decode step's 8 rows
    # and a 4096-row slice of its prefill
    D, Fd = 2304, 9216
    w = (rnd(D, Fd, scale=D ** -0.5), rnd(D, Fd, scale=D ** -0.5), rnd(Fd, D, scale=Fd ** -0.5))
    for T in (8, 4096):
        rows["fused_swiglu"].append({"row": f"gemma2_T{T}", **time_swiglu(
            torch, ops, F, rnd(T, D, scale=1.0), w, "gemma2", act="gelu_tanh")})
    del w
    # its elementwise gradient at the training micro-batch (8192 rows).  Its
    # 75.5 M draws of N(0, 4) reach products of order 1000 in the tails,
    # where the last bit of an fp32 value is above TOL_ELEMENTWISE: held by
    # max |err| / (1 + |reference|), as phase 3b holds its long sums.  There
    # the float32 plain version is itself about TOL_ELEMENTWISE or more from
    # a float64 evaluation of the same expression (its tanh's argument,
    # rounded to float32, reaches dg times |dh u|), so the kernel is held to
    # float64 and to the plain version within TOL_ELEMENTWISE plus the plain
    # version's own distance from float64, measured on each draw: 10a's, then
    # three of their own generators (seeds 32-34, so that no other draw
    # moves), on which it must also be no farther from float64 than the
    # plain version is
    T = 8192
    gg, uu, dh = (rnd(T, Fd, scale=2.0) for _ in range(3))
    err = swiglu_bwd_check(torch, swiglu_bwd, naive_swiglu_act_bwd, gg, uu, dh, "seed 29")
    for seed in (32, 33, 34):
        gen = torch.Generator(device=dev).manual_seed(seed)
        swiglu_bwd_check(torch, swiglu_bwd, naive_swiglu_act_bwd,
                         *(rnd(T, Fd, scale=2.0, gen=gen) for _ in range(3)), f"seed {seed}")
    ms = time_ms([lambda: swiglu_bwd(gg, uu, dh, "gelu_tanh")], torch)
    plain = time_ms([lambda: naive_swiglu_act_bwd(gg, uu, dh, "gelu_tanh")], torch)
    bms, by = bound(6 * 4 * T * Fd, 0)
    print(f"  swiglu_bwd ({T}, {Fd}) gelu_tanh: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    rows["swiglu_bwd"].append({"row": "gemma2_train", "max_abs_err": err, "ms": ms,
                               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                               "library_ms": None,
                               "shape": f"g/u/dh ({T},{Fd}) fp32 gelu_tanh"})
    del gg, uu, dh
    torch.cuda.empty_cache()
    for name, r in rows.items():
        entries[name]["dense"] = r


def phase_dense_parity(torch, dev) -> None:
    """10b: one gemma2 period (a local and a global layer) at published
    widths, card vs CPU: the logits at every position of 2 x 64 tokens, 16
    lockstep decode steps (and on the card against the prefill's logits at
    those positions), then the loss and every gradient leaf of an
    uncompressed step on 2 virtual stages x 2 micro-batches, the tied
    embedding's (its lookup's and the head's uses summed) named apart."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import head_logits, init_model, model_forward
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.runtime.serve import build_serve_step, prepare_serve_states
    from repro_torch.runtime.train import build_train_step

    cfg = get_config("gemma2-2b").replace(n_layers=2)
    B, S, steps, P, M = 2, 64, 16, 2, 2
    params = init_model(torch.Generator(device=dev).manual_seed(4), cfg, dev)
    cpu = torch.device("cpu")
    params_cpu = _tree_to(params, cpu)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(5))
    res = {}
    for side, device, p in (("card", dev, params), ("cpu", cpu, params_cpu)):
        with torch.inference_mode():
            h, _, _ = model_forward(p, tokens.to(device), cfg)
            logits = head_logits(p, h, cfg).cpu()
        ss = build_serve_step(cfg, batch_global=B, cache_len=steps)
        states = prepare_serve_states(cfg, ss.spec.plan, B, steps, device)
        dec = torch.stack([ss.step_fn(p, tokens[:, t].to(device), t, states)[0].cpu()
                           for t in range(steps)], 1)
        ts = build_train_step(cfg, B, stage=P, n_micro=M, device=device)
        (loss, _), grads = ts.grad_fn(p, ts.shard_batch(SyntheticLM(cfg.vocab_size, S)
                                                         .batch(0, B)))
        res[side] = (logits, dec, loss.cpu(), [t.cpu() for t in tree_leaves(grads)],
                     grads["embed"].cpu())
        del grads, states, h
    (lc, dc, l_card, g_card, e_card), (lh, dh, l_cpu, g_cpu, e_cpu) = res["card"], res["cpu"]
    if not all(bool(torch.isfinite(x).all()) for x in (lc, dc, l_card, *g_card)):
        raise AssertionError("non-finite logits, loss or gradient on the card")
    check(_rel(torch, lc, lh), TOL_GRAD_REL,
          f"gemma2 period full width logits card vs CPU ({B}x{S}, vocab {cfg.vocab_size}), "
          "relative", "max |diff| / max |value|")
    check(_rel(torch, dc, dh), TOL_GRAD_REL,
          f"gemma2 period full width {steps} lockstep decode steps card vs CPU",
          "max |diff| / max |value|")
    check(_rel(torch, dc, lc[:, :steps]), TOL_PREFILL_DECODE,
          f"gemma2 period full width prefill vs {steps} lockstep decode steps on the card",
          "max |diff| / max |value|")
    check(_rel(torch, l_card, l_cpu), TOL_TRAIN_LOSS,
          f"gemma2 period full width loss card vs CPU (P={P}, M={M}, {B}x{S}), relative")
    check(_rel(torch, e_card, e_cpu), TOL_GRAD_REL,
          "gemma2 period full width tied embedding's gradient card vs CPU, relative",
          "max |diff| / max |value|")
    check(max(_rel(torch, a, b) for a, b in zip(g_card, g_cpu)), TOL_GRAD_REL,
          f"gemma2 period full width gradients card vs CPU, {len(g_card)} leaves, worst "
          "relative", "max |diff| / max |value|")
    del params, params_cpu, res
    gc.collect()
    torch.cuda.empty_cache()


def phase_window_wrap(torch, ops, dev, card: str) -> None:
    """10c: one gemma2 period at full width and batch 1 decodes 4160
    positions one at a time (the local layer's cache is a ring of 4096
    slots, which wraps at position 4096; the global layer's holds all 4160);
    the logits of the last 8 against one prefill of the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import head_logits, init_model, model_forward
    from repro_torch.runtime.serve import build_serve_step, prepare_serve_states

    cfg = get_config("gemma2-2b").replace(n_layers=2)
    n, last = 4160, 8
    window = cfg.pattern[0].window
    params = init_model(torch.Generator(device=dev).manual_seed(6), cfg, dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    ss = build_serve_step(cfg, batch_global=1, cache_len=n)
    states = prepare_serve_states(cfg, ss.spec.plan, 1, n, dev)
    slots = [st["mixer"]["k"].shape[2] for st in states]
    if slots != [window, n]:
        raise AssertionError(f"cache slots {slots}, not a ring of {window} and {n}")
    dec = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits = ss.step_fn(params, tokens[:, t], t, states)[0]
        if t >= n - last:
            dec.append(logits)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    with torch.inference_mode():
        h, _, _ = model_forward(params, tokens, cfg)
        want = head_logits(params, h[:, -last:], cfg)
    got = torch.stack(dec, 1)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite decode logits")
    print(f"  decoded {n} positions at {ms:.3f} ms/step (batch 1, 2 layers); the local "
          f"layer's ring of {window} slots wrapped at position {window}, {n - window} "
          f"positions before the end; card {card}")
    check(_rel(torch, got, want), TOL_PREFILL_DECODE,
          f"gemma2 period full width: the last {last} of {n} decode steps vs one prefill",
          "max |diff| / max |value|")
    del params, states, h, want, got, dec
    torch.cuda.empty_cache()


# 10e's models and the uniform 2-stage split each must come out with
DENSE_TRAIN = {"gemma2-2b": ((0, 7), (7, 13)), "gemma-2b": ((0, 9), (9, 18))}


def phase_dense_train(torch, ops, dev, card: str, arch: str = "gemma2-2b") -> dict:
    """10e: gemma2-2b (26 layers) or gemma-2b (18 layers, MQA) whole
    at published widths through ``launch.train --stage 2 --seq 8192
    --global-batch 2 --n-micro 2 --compress int8 --bucket-mb 256
    --no-error-feedback``, 1 warm-up and 2 timed steps: at its published
    context gemma2's local layers' window binds; every step's launch counts
    held against what the path implies, and none outside the steps; every
    forward and backward on the two-CTA clusters, the backward's dK/dV pass
    unsplit (g = 1 at this shape on both models: the summed parts run in 10a
    and 10f); a profiler table of one more step."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import (BWD_ROUTES, FWD_ROUTES, reset_bwd_routes,
                                                     reset_fwd_routes)
    from repro_torch.launch import train as launcher

    cfg = get_config(arch)
    L, P, M, B, S, steps = cfg.n_layers, 2, 2, 2, 8192, 3
    argv = ["--arch", cfg.name, "--stage", str(P), "--n-micro", str(M), "--global-batch",
            str(B), "--seq", str(S), "--steps", str(steps), "--compress", "int8",
            "--bucket-mb", "256", "--no-error-feedback", "--log-every", "1"]
    marks, peaks = [], []

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES), None))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    reset_fwd_routes()
    reset_bwd_routes()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    ts = res["ts"]
    nb = len(ts.buckets)
    if ts.spec.ranges != DENSE_TRAIN[arch]:
        raise AssertionError(f"the uniform split {ts.spec.ranges} is not {DENSE_TRAIN[arch]}")
    _check_marks(marks, launches, lambda label, extra: _train_counts(L, M, P, nb))
    if FWD_ROUTES != {"simt": 0, "tc": 0, "tc_cluster": launches["flash_attention"]}:
        raise AssertionError(f"{arch}'s forward routes {FWD_ROUTES}: not all on the clusters")
    if BWD_ROUTES != {"simt": 0, "tc": 0, "tc_cluster": launches["flash_attention_bwd"]}:
        raise AssertionError(f"{arch}'s backward routes {BWD_ROUTES}: not all on the clusters")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    per = {k: v for k, v in _train_counts(L, M, P, nb).items() if v}
    win = cfg.pattern[0].window
    print(f"train {arch} full width fp32 ({L} layers), {P} virtual stages "
          f"{ts.spec.ranges} x {M} micro-batches, batch {B}x{S}"
          f"{f' (window {win} on the local layers)' if win else ''}, int8 wire ({nb} gradient "
          f"buckets): {ms_step:.1f} ms/step "
          f"over {res['timed_steps']} timed steps, {res['tok_s']:.1f} tok/s; peak memory "
          f"{max(peaks) / 1e9:.3f} GB (each step {[round(x / 1e9, 3) for x in peaks]}); "
          f"launches a step {per}; forward routes {FWD_ROUTES}, backward {BWD_ROUTES}; losses "
          f"{[round(x, 6) for x in losses]}; card {card}")
    params, opt_state = res["params"], res["opt_state"]
    del res
    batch = ts.shard_batch(SyntheticLM(cfg.vocab_size, S).batch(steps, B))
    busy_ms, wall_ms = profile_train_step(torch, ts, params, opt_state, batch)
    del params, opt_state, ts, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": max(peaks) / 1e9,
            "busy_ms": busy_ms, "wall_ms": wall_ms}


# ---------------------------------------------------------------------------
# Phase 11: the MoE layer and phi3.5-moe-42b-a6.6b at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# the depths that fit one card at fp32: serving 12 of the 32 layers (62.4 GB
# of layers, 1.05 GB of embedding and head); training 2 (11.45 GB of
# parameters, 45.8 GB with gradients and AdamW's moments); a 2-layer cut for
# prefill against decode
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_PARITY_LAYERS = 12, 2, 2
# 11e (b)'s depth: the continuous launcher plans on its modeled Jetson
# cluster (8 GB a device, 4 a data shard at --devices 8), which admits 5
# layers of 5.29 GB and no more (plan_serve raises AllocationError at 6)
MOE_CONTINUOUS_LAYERS = 5
# 11c's prefill 8 x 512 is timed this many times after a warm-up at that
# shape (the last the counted run of the path): median and range
MOE_PREFILL_TIMED = 4
# one MoE layer at full width, card (3xTF32 fused_swiglu, cuBLAS) vs CPU
# (plain versions), max |diff| / max |value|: the output, and per leaf the
# gradients of sum(out * r) + aux, which sum over 64 tokens and 4096-6400
# terms in other orders; the aux loss (router in fp32 on both sides) to
# 1e-6 absolute, the CPU tests' tolerance for it
TOL_MOE_OUT = 5e-5
TOL_MOE_AUX = 1e-6


# flash attention on phi3.5-moe's paths, as DENSE_ATTN: the prefill (8 x
# 512) and a training micro-batch (2 x 2048), 32 query and 8 KV heads of
# 128, causal; and flash_decode at a lockstep decode step, batch 8 over a
# 256-row cache, every row at 192 keys (generation's midpoint), as
# DECODE_SHAPES.  The flash rows are held to TOL_FP32, phase 3's tolerance
# for these kernels at head_dim <= 128: at the micro-batch the backward's
# dV sums 4 heads x 2048 queries, and read 2.003e-05 from the plain version
# on an H100, past 10a's TOL_DENSE_ATTN; it is held to float64 there too
MOE_ATTN = {"prefill": (8, 512, 32, 8, 128, None, None),
            "train": (2, 2048, 32, 8, 128, None, None)}
MOE_DECODE_SHAPES = {"phi35_moe": (8, 32, 8, 256, 128, (192,) * 8)}


def phase_moe_kernels(torch, ops, F, dev, entries: dict) -> None:
    """11: the kernels at phi3.5-moe's shapes against their plain versions
    on the card, timed beside their bounds, plain versions and library
    calls, into each kernel's entry as ``phi35_moe`` rows: ``fused_swiglu``
    at one expert (W 4096 x 6400, silu) on x (2, 4096), a decode step's
    capacity buffer at batch 8, and x (641, 4096), a full buffer of a
    training micro-batch (2 x 2048 tokens at top 2 of 16 experts, factor
    1.25; the prefill's 8 x 512 runs 2 such sets of 321 rows, 642 a call);
    ``swiglu_bwd`` on that buffer's
    (641, 6400) products; the flash forward and backward at ``MOE_ATTN``;
    ``flash_decode`` at ``MOE_DECODE_SHAPES``; ``quantize_tiles`` and
    ``dequantize_tiles`` (int8, bitwise) at a stage boundary (2, 2048,
    4096) and at the largest gradient bucket, a (2, 16, 4096, 6400) stacked
    expert weight."""
    g = torch.Generator(device=dev).manual_seed(32)
    rows = {name: [] for name in ("fused_swiglu", "swiglu_bwd", "flash_attention",
                                  "flash_attention_bwd", "flash_decode", "quantize_tiles",
                                  "dequantize_tiles")}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    Dm, Fd = 4096, 6400
    w = (rnd(Dm, Fd, scale=Dm ** -0.5), rnd(Dm, Fd, scale=Dm ** -0.5),
         rnd(Fd, Dm, scale=Fd ** -0.5))
    xs = {T: rnd(T, Dm) for T in (2, 641)}
    for name, T in (("decode", 2), ("prefill", 641)):
        rows["fused_swiglu"].append(
            {"row": name, **time_swiglu(torch, ops, F, xs[T], w, "phi3.5-moe expert")})

    T = 641
    gg, uu = xs[T] @ w[0], xs[T] @ w[1]
    dh = rnd(T, Dm) @ w[2].T
    rows["swiglu_bwd"].append(swiglu_bwd_row(torch, gg, uu, dh, "phi3.5-moe expert", "train"))
    del w, xs, gg, uu, dh

    for name, shape in MOE_ATTN.items():
        attn_rows(torch, ops, F, dev, name, shape, g, rows, TOL_FP32)
    rows["flash_decode"].append(decode_row(torch, ops, F, dev, g, "phi35_moe",
                                           MOE_DECODE_SHAPES))

    tile = 256
    quant_rows(torch, g, dev, "phi3.5-moe", (("boundary", 2 * 2048 * 4096 // tile),
                                            ("largest_bucket", 2 * 16 * 4096 * 6400 // tile)),
               tile, rows)
    for name, r in rows.items():
        entries[name]["phi35_moe"] = r


def swiglu_bwd_row(torch, gg, uu, dh, what: str, row: str) -> dict:
    """``swiglu_bwd`` (silu) on an expert's products ``gg``, ``uu`` and the
    cotangent ``dh``, each (T, F), against its plain version, timed beside
    it and its bound (the three read and two gradients written once): the
    row named ``row`` of the kernel's entry."""
    from repro_torch.kernels.fused_swiglu import swiglu_bwd
    from repro_torch.kernels.ref import naive_swiglu_act_bwd

    T, Fd = gg.shape
    err = max(max_err(a, b) for a, b in zip(swiglu_bwd(gg, uu, dh),
                                           naive_swiglu_act_bwd(gg, uu, dh)))
    check(err, TOL_ELEMENTWISE, f"swiglu_bwd {what} ({T}, {Fd}) silu")
    ms = time_ms([lambda: swiglu_bwd(gg, uu, dh)], torch)
    plain = time_ms([lambda: naive_swiglu_act_bwd(gg, uu, dh)], torch)
    bms, by = bound(6 * 4 * T * Fd, 0)
    print(f"  swiglu_bwd {what} ({T}, {Fd}) silu: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"row": row, "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "shape": f"g/u/dh ({T},{Fd}) fp32 silu"}


def quant_rows(torch, g, dev, what: str, cases, tile: int, rows: dict) -> None:
    """``quantize_tiles`` / ``dequantize_tiles`` (int8) on ``wire_rows``
    (R, ``tile``) for each (where, R) of ``cases``, bitwise against their
    plain versions, timed beside them and their bound (the float32 rows
    and the int8 payload and scales moved once), appended to ``rows``."""
    from repro_torch.kernels import quant_transfer as qt
    from repro_torch.kernels.ref import naive_dequantize_tiles, naive_quantize_tiles

    for where, R in cases:
        x = wire_rows(torch, g, R, tile, "int8", dev)
        q, sc = qt.quantize_tiles(x)
        qr, sr = naive_quantize_tiles(x)
        ok = (bitwise_equal(torch, q, qr) and bitwise_equal(torch, sc, sr)
              and bitwise_equal(torch, qt.dequantize_tiles(q, sc),
                                naive_dequantize_tiles(qr, sr)))
        print(f"  quantize/dequantize int8 {what} {where} ({R}, {tile}): bitwise "
              f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise AssertionError(f"quant kernels differ from the plain versions: {what} "
                                 f"{where}")
        del qr, sr
        n = R * tile
        for name, fn, plain_fn in (
                ("quantize_tiles", lambda: qt.quantize_tiles(x),
                 lambda: naive_quantize_tiles(x)),
                ("dequantize_tiles", lambda: qt.dequantize_tiles(q, sc),
                 lambda: naive_dequantize_tiles(q, sc))):
            ms = time_ms([fn], torch)
            plain = time_ms([plain_fn], torch)
            bms, by = bound(4 * n + n + 4 * R, 0)
            print(f"  {name} int8 {what} {where} ({R}, {tile}): kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bms:.4f} ms ({by})")
            rows[name].append({"row": where, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                               "bound_ms": bms, "bound_by": by, "library_ms": None,
                               "shape": f"({R}, {tile}) f32 <-> int8"})
        del x, q, sc
        torch.cuda.empty_cache()


def phase_moe_layer(torch, dev, arch: str = MOE_ARCH, **moe_kw) -> None:
    """11a: one full-width MoE layer of ``arch`` (phi3.5-moe: router 4096 x
    16, 16 experts 4096 x 6400, top 2; its MoE config replaced by
    ``moe_kw``) on (1, 64) tokens, made on the card from a seed and copied
    to the CPU: the routing decisions (experts and kept slots) equal first,
    then the output, the aux loss and the gradients of ``sum(out * r) +
    aux`` for every leaf and the input, card vs CPU; two card runs bitwise
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.runtime.train import tree_paths

    cfg = get_config(arch)
    mc, D = dataclasses.replace(cfg.moe, **moe_kw), cfg.d_model
    E = mc.n_experts
    cpu = torch.device("cpu")
    T = 64
    p_card = tmoe.init_moe(torch.Generator(device=dev).manual_seed(33), D, mc,
                           cfg.pdtype, dev)
    p_cpu = _tree_to(p_card, cpu)
    g = torch.Generator().manual_seed(34)
    x = torch.randn((1, T, D), generator=g)
    r = torch.randn((1, T, D), generator=g)
    cap = tmoe.capacity(mc, T, E)

    decided = {}
    for name, p, d in (("card", p_card, dev), ("CPU", p_cpu, cpu)):
        with torch.no_grad():
            rt = tmoe.route(p, x.to(d).reshape(T, D), mc, E)
            keep, slot = tmoe.dispatch_slots(rt.top_e, cap, E)
        decided[name] = (rt.top_e.cpu(), keep.cpu(), slot.cpu(), rt.scores.cpu())
    same = all(torch.equal(a, b) for a, b in zip(decided["card"][:3], decided["CPU"][:3]))
    top = decided["CPU"][3].sort(dim=-1, descending=True).values
    gap = float((top[:, mc.top_k - 1] - top[:, mc.top_k]).min())   # k-th less (k+1)-th
    kept = int(decided["card"][1].sum())
    print(f"  routing card vs CPU {'equal' if same else 'DIFFERENT'}: {T} tokens x top "
          f"{mc.top_k} of {E} experts, capacity {cap}, {kept} of {T * mc.top_k} pairs kept; "
          f"smallest k-th/(k+1)-th score gap {gap:.3e}")
    if not same:
        raise AssertionError(f"MoE routing differs between card and CPU (smallest gap {gap:.3e})")

    def run(p, d):
        pp = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xx = x.to(d).requires_grad_(True)
        out, aux = tmoe.moe(pp, xx, mc)
        grads = torch.autograd.grad((out * r.to(d)).sum() + aux, [*tree_leaves(pp), xx])
        return out.detach(), aux.detach(), grads

    names = [*(".".join(k) for k in tree_paths(p_card)), "x"]
    o1, a1, g1 = run(p_card, dev)
    o2, a2, g2 = run(p_card, dev)
    bitwise = (torch.equal(o1, o2) and torch.equal(a1, a2)
               and all(torch.equal(u, v) for u, v in zip(g1, g2)))
    print(f"  MoE layer: two card runs (output, aux, every gradient) bitwise "
          f"{'equal' if bitwise else 'DIFFERENT'}")
    if not bitwise:
        raise AssertionError("the MoE layer on the card is not deterministic")
    del o2, a2, g2
    oh, ah, gh = run(p_cpu, cpu)
    if not bool(torch.isfinite(o1).all()):
        raise AssertionError("non-finite MoE output on the card")
    check(_rel(torch, o1.cpu(), oh), TOL_MOE_OUT,
          f"MoE layer (1, {T}) output card vs CPU, max|diff| / max|value|")
    check(abs(float(a1) - float(ah)), TOL_MOE_AUX,
          f"MoE aux loss card vs CPU ({float(ah):.6f})", "abs err")
    worst = max(((_rel(torch, u.cpu(), v), n) for u, v, n in zip(g1, gh, names)))
    for u, v, n in zip(g1, gh, names):
        print(f"    grad {n}: max|diff| / max|value| {_rel(torch, u.cpu(), v):.3e}")
    check(worst[0], TOL_GRAD_REL, f"MoE layer gradients card vs CPU, worst leaf {worst[1]}",
          "max|diff| / max|value|")
    del p_card, p_cpu, g1, gh
    gc.collect()
    torch.cuda.empty_cache()


def _moe_cut(n_layers: int, **moe_kw):
    """phi3.5-moe at ``n_layers`` of its 32, its MoE config replaced by
    ``moe_kw``; every width the published one."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    return cfg.replace(n_layers=n_layers, moe=dataclasses.replace(cfg.moe, **moe_kw))


def swiglu_ms(kernels, n: int) -> float:
    """``fused_swiglu``'s device ms a call among a trace's CUDA kernel rows
    over ``n`` calls (its two routes' kernels)."""
    return sum(e.self_device_time_total for e in kernels
               if any(f"(anonymous namespace)::{tag}" in e.key
                      for tag in ("wgmma_gemm_kernel", "skinny_kernel"))) / n / 1e3


def phase_moe_serve(torch, ops, dev, card: str) -> dict:
    """11b: a 2-layer cut at capacity factor 64 (nothing drops), prefill (2,
    256) last-position logits against 256 lockstep decode steps; 11c: 12
    layers served as 7c serves Jamba: a prefill 8 x 512 warmed up at that
    shape and timed ``MOE_PREFILL_TIMED`` times, the last the path's counted
    run, then ``launch.serve.lockstep_decode`` at batch 8, prompt 128 + gen
    128, the
    exact launch counts, the device-busy share of a decode step, the
    experts' share of the prefill's and a decode step's device time, the
    peak memory."""
    from repro_torch.launch.serve import lockstep_decode
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import init_model
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    print("phase 11b: phi3.5-moe prefill vs lockstep decode on the card, 2 layers, "
          "capacity factor 64")
    cfg = _moe_cut(MOE_PARITY_LAYERS, capacity_factor=64.0)
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    B, S = 2, 256
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    # the prefill routes each of its micro-batches (1 x 256 tokens) as a set
    caps = (tmoe.capacity(cfg.moe, S, E), tmoe.capacity(cfg.moe, B, E))
    if caps[0] < S or caps[1] < B:
        raise AssertionError(f"capacities {caps} can drop pairs")
    want = build_prefill_step(cfg, batch_global=B, seq_len=S).step_fn(
        params, {"tokens": tokens[:B, :S]})
    ss = build_serve_step(cfg, batch_global=B, cache_len=S)
    states = prepare_serve_states(cfg, ss.spec.plan, B, S, dev)
    for t in range(S):
        logits, states = ss.step_fn(params, tokens[:B, t], t, states)
    if not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(want).all()):
        raise AssertionError("non-finite phi3.5-moe logits on the card")
    print(f"  capacities {caps[0]} (prefill) and {caps[1]} (decode) rows an expert: no pair "
          f"drops; max |logit| {float(want.abs().max()):.4f}")
    check(_rel(torch, logits, want), TOL_PREFILL_DECODE,
          f"phi3.5-moe prefill ({B}, {S}) last-position logits vs {S} lockstep decode steps, "
          "max|diff| / max|logit|")
    del params, states, logits, want
    gc.collect()
    torch.cuda.empty_cache()

    print(f"phase 11c: serve phi3.5-moe at full width, {MOE_SERVE_LAYERS} of 32 layers")
    cfg = _moe_cut(MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  weights {n_bytes / 1e9:.3f} GB ({cfg.param_count()} params) made on the card "
          f"in {time.perf_counter() - t0:.2f}s")
    B, S = 8, 512
    batch, prompt, gen = 8, 128, 128
    pf = build_prefill_step(cfg, batch_global=B, seq_len=S)

    def prefill():
        return pf.step_fn(params, {"tokens": tokens})

    def timed_prefill():
        t0 = time.perf_counter()
        out = prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    prefill()                                                      # warm-up
    prefill_ms = []
    for _ in range(MOE_PREFILL_TIMED - 1):
        timed_prefill()
    n_steps = 8
    busy_ms, dec_kernels = profile_decode(torch, cfg, params, tokens[:batch, 0], batch,
                                          prompt + gen, dev, n_steps)

    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    logits = timed_prefill()
    after_prefill = dict(ops.LAUNCHES)
    res = lockstep_decode(cfg, params, batch=batch, prompt_len=prompt, gen=gen,
                          temperature=0.8, device=dev)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    if logits.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phi3.5-moe prefill logits {tuple(logits.shape)} not finite/shaped")
    toks = res["tokens"]
    if toks.shape != (prompt + gen, batch) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"phi3.5-moe decode tokens {toks.shape} out of range")
    L, steps = cfg.n_layers, res["steps"]
    want_prefill = {name: 0 for name in ops.LAUNCHES}
    want_prefill.update(flash_attention=L, fused_swiglu=E * L)
    want_all = dict(want_prefill, flash_decode=L * steps, fused_swiglu=E * L * (steps + 1))
    print(f"  launches: prefill {after_prefill} (expected {want_prefill}); prefill + "
          f"{steps} decode steps {launches} (expected {want_all})")
    if after_prefill != want_prefill or launches != want_all:
        raise AssertionError("phi3.5-moe serving launch counts differ from the path's")
    step_ms = res["seconds"] / steps * 1e3
    print(f"serve phi3.5-moe-42b-a6.6b full width fp32, {L} of 32 layers: prefill {B}x{S} "
          f"median {statistics.median(prefill_ms):.3f} ms of {len(prefill_ms)} calls after a "
          f"warm-up ({', '.join(f'{x:.3f}' for x in prefill_ms)} in order; capacity "
          f"2 x {tmoe.capacity(cfg.moe, B // 2 * S, E)} rows an expert: a set per micro-batch "
          f"of 4 x 512); decode {step_ms:.3f} ms/step "
          f"over {steps} steps (batch {batch}, cache {prompt + gen}, capacity "
          f"{tmoe.capacity(cfg.moe, batch, E)}), {E * L} fused_swiglu and {L} flash_decode "
          f"launches a step; {res['tok_per_s']:.1f} tok/s; peak memory {peak / 1e9:.3f} GB; "
          f"card {card}")
    shares = {}
    if busy_ms is not None:
        print(f"  device busy {busy_ms:.3f} ms of the {step_ms:.3f} ms decode step "
              f"({busy_ms / step_ms:.1%}; idle {1 - busy_ms / step_ms:.1%})")
        shares["decode step"] = (busy_ms, swiglu_ms(dec_kernels, n_steps))
    total, kernels = trace_cuda(torch, prefill, 1)
    if total is None:
        print("  prefill: the profiler trace holds no device time; expert share not measured")
    else:
        shares["prefill"] = (total, swiglu_ms(kernels, 1))
    for name, (total, swiglu) in shares.items():
        print(f"  {name}: device {total:.3f} ms, of it the experts' fused_swiglu {swiglu:.3f} ms "
              f"({swiglu / total:.1%}), the rest (attention, router, dispatch, combine, "
              f"head) {total - swiglu:.3f} ms")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "peak_gb": peak / 1e9, "busy_ms": busy_ms, "shares": shares,
            "kernels_per_step": sum(e.count for e in dec_kernels) / n_steps}


def phase_moe_train(torch, ops, dev, card: str) -> dict:
    """11d: phi3.5-moe, 2 layers at full width, through ``launch.train
    --n-layers 2 --stage 2 --n-micro 4 --global-batch 8 --seq 2048
    --compress int8 --bucket-mb 256 --no-error-feedback``, 1 warm-up + 2
    timed steps: each step's ``ce`` and ``aux`` (finite, aux > 0), its
    launch counts against the path's (every expert's ``fused_swiglu`` and
    ``swiglu_bwd`` per layer and micro-batch), and none outside the steps;
    ms/step and the peak memory."""
    from repro_torch.launch import train as launcher

    L, P, M, B, S, steps = MOE_TRAIN_LAYERS, 2, 4, 8, 2048, 3
    argv = ["--arch", MOE_ARCH, "--n-layers", str(L), "--stage", str(P), "--n-micro", str(M),
            "--global-batch", str(B), "--seq", str(S), "--steps", str(steps), "--compress",
            "int8", "--bucket-mb", "256", "--no-error-feedback", "--log-every", "1"]
    marks, peaks = [], []

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES), None))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    ts = res["ts"]
    cfg, nb = ts.spec.cfg, len(ts.buckets)
    E = cfg.moe.n_experts
    _check_marks(marks, launches, lambda label, extra: _train_counts(L, M, P, nb, E))
    for i, m in enumerate(res["metrics"]):
        print(f"  step {i}: loss {res['losses'][i]:.6f} = ce {m['ce']:.6f} + aux {m['aux']:.6f}")
        if not (math.isfinite(m["ce"]) and math.isfinite(m["aux"]) and m["aux"] > 0):
            raise AssertionError(f"step {i}: ce {m['ce']} and aux {m['aux']} must be finite, "
                                 "aux > 0")
    n_state = sum(t.numel() * t.element_size() for t in _leaves(res["params"]))
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    per = {k: v for k, v in _train_counts(L, M, P, nb, E).items() if v}
    print(f"train phi3.5-moe-42b-a6.6b full width fp32 ({L} layers, {E} experts x "
          f"{cfg.moe.d_ff}), {P} virtual stages {ts.spec.ranges} x {M} micro-batches, batch "
          f"{B}x{S}, int8 wire ({nb} gradient buckets): {ms_step:.1f} ms/step over "
          f"{res['timed_steps']} timed steps, {res['tok_s']:.1f} tok/s; parameters "
          f"{n_state / 1e9:.3f} GB (x4 with gradients and AdamW's moments: "
          f"{4 * n_state / 1e9:.3f} GB); peak memory {max(peaks) / 1e9:.3f} GB (each step "
          f"{[round(x / 1e9, 3) for x in peaks]}); launches a step {per}; card {card}")
    del res, ts
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": max(peaks) / 1e9}


# 11e (a): the slot step's token sets card vs CPU at the published capacity
# factor: (shard_alloc, stage, n_groups, the slots' admission steps).  At
# (3, 1) a shard's 3 rows are one set (3 rows do not split into 2 groups);
# at (4, 2) and 2 stages each shard's rows are cut into 2 groups of 2, a set
# each: C = 1 row an expert either way, so pairs drop
MOE_SLOT_CASES = (((3, 1), 1, None, SLOT_DELAY), ((3, 1), 2, None, SLOT_DELAY),
                  ((4, 2), 2, None, (0, 1, 2, 1, 0, 2)))


@contextlib.contextmanager
def moe_dispatches():
    """Record every MoE call's (top_e, keep) on the host while it lasts
    (``models.moe``'s dispatch functions wrapped; each record waits for the
    card, so only untimed checks use it)."""
    from repro_torch.models import moe as tmoe

    seen = []
    real = tmoe.dispatch_slots

    def recording(top_e, *args):
        keep, slot = real(top_e, *args)
        seen.append((top_e.cpu(), keep.cpu()))
        return keep, slot

    tmoe.dispatch_slots = recording
    try:
        yield seen
    finally:
        tmoe.dispatch_slots = real


def _fake_timer(dt: float):
    t = [0.0]

    def timer():
        t[0] += dt / 2
        return t[0]
    return timer


def phase_moe_slots(torch, ops, dev, card: str) -> None:
    """11e (a): phi3.5-moe at 2 layers, full width, capacity factor 1.25,
    through ``build_slot_serve_step`` on ``MOE_SLOT_CASES``' staggered
    admission: the card against the port on the CPU row for row, with the
    same routing and the same dropped pairs (some must drop), padded rows
    exactly 0, each step's launches (every expert's ``fused_swiglu`` and
    one ``flash_decode`` a layer and group, whatever the shard count); the
    2-stage run at (3, 1) against the 1-stage one on the card.  Then at
    factor 64, where nothing drops, the engine's tokens under the slot list
    reversed and another timing are the same (5b (d))."""
    from repro_torch.models.model import init_model
    from repro_torch.runtime.continuous import (ContinuousBatcher, Request,
                                                engine_from_serve_step, slot_rows)
    from repro_torch.runtime.serve import build_slot_serve_step

    cpu = torch.device("cpu")
    cfg = _moe_cut(MOE_PARITY_LAYERS)
    L, E, V = cfg.n_layers, cfg.moe.n_experts, cfg.vocab_size
    none = {name: 0 for name in ops.LAUNCHES}
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    p_cpu = _tree_to(params, cpu)
    gen = torch.Generator().manual_seed(5)
    tokens = {alloc: torch.randint(0, V, (sum(alloc), SLOT_STEPS), generator=gen)
              for alloc in {c[0] for c in MOE_SLOT_CASES}}
    on_card, dropped_all = {}, 0
    for alloc, stage, n_groups, delay in MOE_SLOT_CASES:
        ss = build_slot_serve_step(cfg, cache_len=SLOT_CACHE, shard_alloc=alloc, stage=stage,
                                   n_groups=n_groups)
        G = ss.spec.groups
        sets = f"{len(alloc)} token sets of {max(alloc) // G} rows a group"
        per_step = dict(none, flash_decode=G * L, fused_swiglu=G * E * L)
        with moe_dispatches() as seen:
            got, pad_max = staggered_logits(torch, ops, ss, params, tokens[alloc], dev,
                                            per_step, delay)
        dropped = sum(int((~keep).sum()) for _, keep in seen)
        pairs = sum(keep.numel() for _, keep in seen)
        dropped_all += dropped
        what = f"shard_alloc {alloc}, stage {stage}, {G} group(s), {sets}"
        print(f"  {what}: {dropped} of {pairs} (token, expert) pairs dropped on the card; "
              f"padded rows max |logit| {pad_max} (must be 0); launches a step {per_step}")
        if pad_max != 0.0:
            raise AssertionError(f"{what}: padded slot rows carry logits up to {pad_max}")
        if not all(bool(torch.isfinite(r).all()) for r in got.values()):
            raise AssertionError(f"{what}: non-finite logits on the card")
        if (alloc, 1) in on_card:
            base = on_card[(alloc, 1)]
            scale = max(float(r.abs().max()) for r in base.values())
            err = max(float((got[k] - base[k]).abs().max()) for k in base) / scale
            check(err, TOL_SLOT_LOGITS, f"{what} vs stage 1 on the card, max|diff| / max|logit|")
            continue
        on_card[(alloc, stage)] = got
        with moe_dispatches() as seen_cpu:
            want, _ = staggered_logits(torch, ops, ss, p_cpu, tokens[alloc], cpu, none, delay)
        same = len(seen) == len(seen_cpu) and all(
            torch.equal(a, b) and torch.equal(k, m) for (a, k), (b, m) in zip(seen, seen_cpu))
        print(f"  {what}: routing and dropped pairs card vs CPU "
              f"{'equal' if same else 'DIFFERENT'} ({len(seen)} MoE calls)")
        if not same:
            raise AssertionError(f"{what}: the card routes or drops other pairs than the CPU")
        err = max(max_err(got[k].cpu(), want[k]) for k in got)
        check(err, TOL_LOGITS, f"{what}: {len(got)} (slot, position) logits rows card vs CPU")
    if dropped_all == 0:
        raise AssertionError("no pair dropped: the token sets were not exercised")
    del p_cpu, on_card
    gc.collect()

    print("  factor 64: the engine's tokens under other slot lists and timings")
    cfg64 = _moe_cut(MOE_PARITY_LAYERS, capacity_factor=64.0)
    reqs = [Request(rid=i, arrival=0.01 * i, prompt_token=(7919 * i + 3) % V, n_tokens=6)
            for i in range(6)]
    rows = slot_rows(SLOT_ALLOC)
    runs = []
    for slots, dt in ((rows, 0.01), (rows[::-1], 0.5)):
        ss = build_slot_serve_step(cfg64, cache_len=SLOT_CACHE, shard_alloc=SLOT_ALLOC)
        bat = ContinuousBatcher(engine_from_serve_step(ss, params, dev), slots=slots,
                                batch=ss.spec.batch_global, cache_len=SLOT_CACHE, seed=0,
                                timer=_fake_timer(dt))
        with moe_dispatches() as seen:
            done = bat.run(reqs)
        runs.append(({c.rid: c.tokens for c in done}, bat.steps,
                     sum(int((~keep).sum()) for _, keep in seen)))
    (first, s1, d1), (again, s2, d2) = runs
    print(f"  {len(first)} requests: {s1} and {s2} engine steps, {d1 + d2} pairs dropped; "
          f"token streams {'identical' if first == again else 'DIFFERENT'}")
    if d1 + d2 or first != again or len(first) != len(reqs):
        raise AssertionError("at factor 64 the tokens depend on the slots or the timing")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_continuous(torch, ops, dev, card: str) -> dict:
    """11e (b): ``launch.serve --continuous`` (5b (c)'s cell) on phi3.5-moe
    at ``MOE_CONTINUOUS_LAYERS``: exact launch counts, the engine and draw
    ms/step, tok/s and token percentiles, the engine step's device-busy
    share and CUDA kernels a step; then the lockstep launcher at
    ``--devices 8`` on the same cut (2 data shards, a token set each): its
    ms/step, and a traced step's busy time and kernels beside the same
    weights' lockstep step with one data shard (one set).  Returns the
    launches of each launcher run."""
    from repro_torch.launch import serve as launcher
    from repro_torch.runtime.continuous import engine_from_serve_step

    L = MOE_CONTINUOUS_LAYERS
    cut = ["--arch", MOE_ARCH, "--n-layers", str(L)]
    none = {name: 0 for name in ops.LAUNCHES}
    print("phase 11e (b): python -m repro_torch.launch.serve " + " ".join(CONTINUOUS_ARGS + cut))
    ops.reset_launches()
    res = launcher.main(CONTINUOUS_ARGS + cut)
    launches = dict(ops.LAUNCHES)
    ss, plan, done, reqs = res["slot_step"], res["plan"], res["completions"], res["requests"]
    cfg = ss.spec.cfg
    E, G = cfg.moe.n_experts, ss.spec.groups
    calls = res["warmup_calls"] + res["steps"]
    expect = dict(none, flash_decode=G * L * calls, fused_swiglu=G * E * L * calls)
    print(f"  launches {launches} (expected {expect}: {res['warmup_calls']} warm-up calls + "
          f"{res['steps']} engine steps, {G} group(s), {ss.spec.plan.data} token sets a group)")
    if launches != expect:
        raise AssertionError(f"phi3.5-moe continuous launch counts {launches} != {expect}")
    gen = int(CONTINUOUS_ARGS[CONTINUOUS_ARGS.index("--gen") + 1])
    if len(done) != len(reqs) or any(len(c.tokens) != gen for c in done):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests completed")
    if any(not 0 <= t < cfg.vocab_size for c in done for t in c.tokens):
        raise AssertionError("a served token lies outside the vocabulary")
    step_ms = sum(res["step_seconds"]) / res["steps"] * 1e3
    draw_ms = sum(res["draw_seconds"]) / res["steps"] * 1e3
    p50, p95, p99 = (v * 1e3 for v in res["latency_pct"])
    print(f"continuous serve phi3.5-moe-42b-a6.6b full width fp32, {L} of 32 layers: plan "
          f"stage {plan.stage} tp {plan.tp} alloc {plan.shard_alloc}; {len(done)} requests / "
          f"{sum(len(c.tokens) for c in done)} tokens in {res['steps']} engine steps; engine "
          f"{step_ms:.3f} ms/step (probe {res['probe_step_s'] * 1e3:.3f}), host draws "
          f"{draw_ms:.3f} ms/step; offered {res['rate']:.1f} tok/s, served "
          f"{res['tok_per_s']:.1f} tok/s; token latency p50/p95/p99 {p50:.3f}/{p95:.3f}/"
          f"{p99:.3f} ms; {G * E} fused_swiglu and {G} flash_decode launches a layer and "
          f"step; card {card}")
    engine = engine_from_serve_step(ss, res["params"], dev)
    prof = profile_engine(torch, engine, ss.spec.batch_global, res["slots"],
                          ss.spec.cache_len, dev)
    busy = prof["busy_ms"]
    print(f"  engine step {prof['wall_ms']:.3f} ms wall, "
          + (f"device busy {busy:.3f} ms ({busy / prof['wall_ms']:.1%}; idle "
             f"{1 - busy / prof['wall_ms']:.1%}), " if busy is not None else "")
          + f"{prof['kernels_per_step']:.0f} CUDA kernels a step; card {card}")
    del res, engine, ss
    gc.collect()
    torch.cuda.empty_cache()

    argv = cut + ["--devices", "8", "--batch", "8", "--prompt-len", "16", "--gen", "32"]
    print("phase 11e (b): python -m repro_torch.launch.serve " + " ".join(argv))
    ops.reset_launches()
    res = launcher.main(argv)
    lock = dict(ops.LAUNCHES)
    ls = res["serve_step"]
    G, steps = ls.spec.groups, res["steps"]
    want = dict(none, flash_decode=G * L * steps, fused_swiglu=G * E * L * steps)
    print(f"  launches {lock} (expected {want}: {steps} steps, {ls.spec.plan.data} data shards, "
          f"a token set each)")
    if lock != want:
        raise AssertionError(f"phi3.5-moe lockstep --devices 8 launch counts {lock} != {want}")
    toks = res["tokens"]
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("lockstep --devices 8 drew a token outside the vocabulary")
    lock_ms = res["seconds"] / steps * 1e3
    token = torch.from_numpy(toks[0]).to(dev)
    traced = {}
    for name, step in (("2 data shards", ls), ("1 data shard", None)):
        busy, kernels = profile_decode(torch, cfg, res["params"], token, 8, 48, dev, ss=step)
        traced[name] = (busy, sum(e.count for e in kernels) / 8)
    print(f"lockstep serve phi3.5-moe {L} layers --devices 8 (data {ls.spec.plan.data}, "
          f"stage {ls.spec.plan.stage}): {lock_ms:.3f} ms/step over {steps} steps, "
          f"{res['tok_per_s']:.1f} tok/s; traced steps, device busy and CUDA kernels a step: "
          + "; ".join(f"{name} (a token set each) "
                      + (f"{busy:.3f} ms, " if busy else "") + f"{n:.0f} kernels"
                      for name, (busy, n) in traced.items())
          + f"; card {card}")
    del res, ls
    gc.collect()
    torch.cuda.empty_cache()
    return {"continuous": launches, "lockstep_dp2": lock}

# ---------------------------------------------------------------------------
# Phase 12: deepseek-v3-671b, its MLA and its MTP head
# ---------------------------------------------------------------------------

DS_ARCH = "deepseek-v3-671b"
# the latent route of flash_decode at a lockstep decode step (batch 8 over a
# 256-row cache, phase 3's per-row lengths) and at batch 1 over 4096 keys:
# name -> (B, H, S, per-row lengths or None for a shared length of S)
DS_LATENT_SHAPES = {"decode": (8, 128, 256, DECODE_SHAPES["phi3"][5]),
                    "long": (1, 128, 4096, None)}
# MLA's widths: the latent c_kv and the shared rope key; q/k heads of
# qk_nope + qk_rope, values of v_head_dim (zero-padded to q/k's for flash)
DS_R, DS_DR, DS_QK, DS_V = 512, 64, 192, 128
# flash attention at MLA's prefill (8 x 512), training micro-batch (1 x
# 1024) and the MTP block's call on 12d's whole batch (2 x 1024), 128
# heads: name -> (B, S, H)
DS_ATTN = {"prefill": (8, 512, 128), "train": (1, 1024, 128), "train_mtp": (2, 1024, 128)}
# an expert of deepseek-v3 (W 7168 x 2048, silu; the shared one has the
# same widths): fused_swiglu's rows on the paths (capacity C = int(1.25 T k
# / E) + 1 a token set): name -> rows of x.  The decode step at batch 8 (C 1
# of 256 experts; the shared expert on the 8 rows); the prefill 8 x 512 (2
# sets of 4 x 512, 81 rows each; shared 4096); 12d's micro-batch of 1024
# tokens (top 8 of 16: 641; shared 1024) and the MTP block on both (1281;
# shared 2048)
DS_SWIGLU_ROWS = {"decode": 1, "decode_shared": 8, "prefill": 162, "prefill_shared": 4096,
                  "train": 641, "train_shared": 1024, "train_mtp": 1281,
                  "train_mtp_shared": 2048}
# swiglu_bwd on 12d's expert buffers: name -> rows (of 2048)
DS_SWIGLU_BWD_ROWS = {"train": 641, "train_shared": 1024, "train_mtp": 1281,
                      "train_mtp_shared": 2048}
# 12d's gradient buckets (--bucket-mb 256) on the wire, tiles of 256: one of
# the stacked expert weights (16 x 7168 x 2048) and the largest, the
# embedding's (129280 x 7168) and the head's
DS_WIRE_ROWS = (("expert_bucket", 16 * 7168 * 2048 // 256),
                ("largest_bucket", 129280 * 7168 // 256))
# serving holds 1 of the 61 layers with all 256 routed experts (53.4 GB of
# fp32 weights, no MTP head); training 1 layer and the MTP block with the
# routed experts cut to 16 (top 8 kept): 61.3 GB of state at 16 B a parameter
DS_SERVE_LAYERS, DS_TRAIN_LAYERS, DS_TRAIN_EXPERTS = 1, 1, 16
# 12b (iii): prefill vs lockstep decode on the 256-expert layer, a prompt of
# this many tokens at batch 2, capacity factor 64 (nothing drops)
DS_PARITY_PROMPT = 32
# the MLA block at full width card vs CPU (12b (i)), max |diff| / max
# |value|: fp32 sums over 7168, 1536, 16384 and the keys in other orders
# (cuBLAS, 3xTF32 flash and the SIMT latent route on the card; plain
# versions on the CPU); TOL_MOE_OUT's bound for a layer
TOL_MLA_LAYER = TOL_MOE_OUT


def latent_bound(B, H, valid, R=DS_R, Dr=DS_DR):
    """The latent route's least time: q_lat ‖ q_rope read and the (B, H, R)
    output written once, each of the ``valid`` cache rows (c_kv ‖ k_rope)
    read once, the lengths; or 2·(R + Dr) + 2·R flops a (head, valid key),
    the scores over the 576-wide key and P·c_kv, as fp32 products on the
    tensor cores (3xTF32), and an exponential a (head, valid key)."""
    return bound(4 * (B * H * (R + Dr) + B * H * R + valid * (R + Dr) + B), 0,
                 H * valid, tf32x3=2 * (2 * R + Dr) * H * valid)


def mla_flash_bound(B, S, H, Dqk=DS_QK, Dv=DS_V):
    """MLA's causal attention at q/k ``Dqk`` and v ``Dv`` wide (the function,
    without flash's padding): q, k, v read and the output written once, or
    2·Dqk + 2·Dv flops a (query, visible key) pair as 3xTF32 and an
    exponential a pair."""
    pairs = B * H * causal_pairs(S)
    return bound(4 * B * S * H * (2 * Dqk + 2 * Dv), 0, pairs, tf32x3=2 * (Dqk + Dv) * pairs)


def mla_flash_bwd_bound(B, S, H, Dqk=DS_QK, Dv=DS_V):
    """Its backward: q, k, dq, dk (``Dqk``) and v, o, dO, dv (``Dv``) moved
    once and the logsumexp read, or the five products (the scores again and
    dQ, dK over ``Dqk``; dP and dV over ``Dv``), 6·Dqk + 4·Dv flops a pair,
    as 3xTF32, and an exponential a pair."""
    pairs = B * H * causal_pairs(S)
    return bound(4 * (B * S * H * (4 * Dqk + 4 * Dv) + B * H * S), 0, pairs,
                 tf32x3=(6 * Dqk + 4 * Dv) * pairs)


def mla_attn_rows(torch, ops, F, dev, name, B, S, H, gen, rows: dict) -> None:
    """``flash_attention`` and its backward at MLA's widths, causal: q/k at
    ``DS_QK``, v of ``DS_V`` zero-padded to it (``models.attention.
    mla_forward``), the cotangent padded likewise; the padding's output
    columns exactly 0; each against its plain version and float64, on the
    two-CTA cluster route; timed beside the unpadded function's bound, the
    plain version and SDPA at the unpadded widths (its cost of padding)."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_route,
                                                     flash_attention_fwd_route)

    D, Dv = DS_QK, DS_V

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    q, k = rnd(B, S, H, D), rnd(B, S, H, D)
    v = F.pad(rnd(B, S, H, Dv), (0, D - Dv))
    dout = F.pad(rnd(B, S, H, Dv, scale=1.0), (0, D - Dv))
    what = f"({B}, {S}, {H}, {H}, {D}) causal, v {Dv} zero-padded to {D}"
    out, lse = flash_attention(q, k, v, return_lse=True)
    f_err = max_err(out, ops.plain_flash_attention(q, k, v))
    check(f_err, TOL_FP32, f"flash_attention deepseek_v3 {name} {what}")
    check(max_err(out, attention_float64(torch, q, k, v)), TOL_FP32,
          f"flash_attention deepseek_v3 {name} against float64")
    pad = float(out[..., Dv:].abs().max())
    f_route = flash_attention_fwd_route(q, k, v)
    print(f"  flash_attention deepseek_v3 {name}: route {f_route}, padded columns max |out| "
          f"{pad} (must be 0)")
    check_route(f_route, "tc_cluster", f"flash_attention deepseek_v3 {name}")
    if pad != 0.0:
        raise AssertionError(f"flash_attention deepseek_v3 {name}: padded columns not 0")
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    b_err = max(max_err(a, b) for a, b in zip(got, ops.plain_flash_attention_bwd(q, k, v, dout)))
    check(b_err, TOL_FP32, f"flash_attention_bwd deepseek_v3 {name} {what} dq/dk/dv")
    check(max(max_err(a, b) for a, b in zip(got, attention_bwd_float64(torch, q, k, v, dout))),
          TOL_FP32, f"flash_attention_bwd deepseek_v3 {name} against float64")
    route = flash_attention_bwd_route(q, k, v, dout)
    check_route(route, "tc_cluster", f"flash_attention_bwd deepseek_v3 {name}")
    del got
    torch.cuda.empty_cache()
    f_ms = time_ms([lambda: ops.flash_attention_op(q, k, v)], torch)
    f_plain = time_ms([lambda: ops.plain_flash_attention(q, k, v)], torch)
    b_ms = time_ms([lambda: flash_attention_bwd(q, k, v, out, lse, dout)], torch)
    b_plain = time_ms([lambda: ops.plain_flash_attention_bwd(q, k, v, dout)], torch)
    # SDPA on the unpadded widths (q/k 192, v 128), heads before S
    qt, kt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k))
    vt = v[..., :Dv].transpose(1, 2).detach().requires_grad_(True)
    dt = dout[..., :Dv].transpose(1, 2)
    f_lib = time_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)],
                    torch)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dt)

    b_lib = time_ms([sdpa], torch)
    del qt, kt, vt, dt
    fb, fby = mla_flash_bound(B, S, H)
    bb, bby = mla_flash_bwd_bound(B, S, H)
    print(f"  flash_attention deepseek_v3 {name} ({f_route}, v padded {Dv} -> {D}): kernel "
          f"{f_ms:.4f} ms, plain {f_plain:.4f} ms, SDPA at v {Dv} {f_lib:.4f} ms, bound of "
          f"the unpadded function {fb:.4f} ms ({fby}, {fb / f_ms:.1%} of it)")
    print(f"  flash_attention_bwd deepseek_v3 {name} ({route}): kernel {b_ms:.4f} ms, plain "
          f"(autograd) {b_plain:.4f} ms, SDPA fwd+bwd at v {Dv} {b_lib:.4f} ms, bound "
          f"{bb:.4f} ms ({bby}, {bb / b_ms:.1%} of it)")
    shape = f"q/k ({B},{S},{H},{D}) v ({B},{S},{H},{Dv}) padded to {D} causal fp32"
    rows["flash_attention"].append(
        {"row": f"deepseek_v3_{name}", "route": f_route, "max_abs_err": f_err, "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": fb, "bound_by": fby, "library_ms": f_lib,
         "shape": shape})
    rows["flash_attention_bwd"].append(
        {"row": f"deepseek_v3_{name}", "route": route, "max_abs_err": b_err, "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": bb, "bound_by": bby, "library_ms": b_lib,
         "shape": shape})
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()


def phase_ds_kernels(torch, ops, F, dev, entries: dict) -> dict:
    """12a: the latent route of ``flash_decode`` (``flash_decode_latent``)
    at ``DS_LATENT_SHAPES`` on caches read by strides out of stacked (2, B,
    S, ...) buffers, as the model hands them over, against its plain
    version (``ref.naive_latent_decode``), two runs bitwise, timed beside
    its bound, the plain version and SDPA (one key head of c_kv ‖ k_rope,
    concatenated and expanded outside the call, values c_kv); the flash
    forward and backward at ``DS_ATTN`` (``mla_attn_rows``) and the expert
    and wire kernels (``ds_expert_rows``), rows under ``deepseek_v3``.
    Returns the latent route's entry."""
    from repro_torch.kernels.ref import naive_latent_decode

    g = torch.Generator(device=dev).manual_seed(41)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).mul_(0.5)

    R, Dr, scale = DS_R, DS_DR, DS_QK ** -0.5
    entry = {"name": "flash_decode_latent", "route": "cuda",
             "source": "src/repro_torch/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention.py:65"}
    for name, (B, H, S, lens) in DS_LATENT_SHAPES.items():
        q_lat, q_rope = rnd(B, H, R), rnd(B, H, Dr)
        ckv, krope = rnd(2, B, S, R)[1], rnd(2, B, S, Dr)[1]
        clen = S if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q_lat, q_rope, ckv, krope, clen)
        got = ops.flash_decode_latent_op(*args, scale=scale)
        want = naive_latent_decode(*args, scale=scale)
        what = (f"flash_decode_latent {name} q ({B}, {H}, {R} + {Dr}) cache ({B}, {S}, {R} + "
                f"{Dr}) {'per-row lengths' if lens else 'full length'}")
        err = max_err(got, want)
        check(err, TOL_FP32, what)
        same = bitwise_equal(torch, got, ops.flash_decode_latent_op(*args, scale=scale))
        kk = torch.cat([ckv, krope], -1)[:, None].expand(B, H, S, R + Dr)
        qq = torch.cat([q_lat, q_rope], -1)[:, :, None]
        vv = ckv[:, None].expand(B, H, S, R)
        mask = None if lens is None else \
            (torch.arange(S, device=dev)[None, :] < clen[:, None])[:, None, None, :]

        def lib_call():
            return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=scale)

        lib_err = max_err(lib_call()[:, :, 0], want)
        print(f"  {what}: two runs bitwise {'equal' if same else 'DIFFERENT'}; SDPA's max abs "
              f"err {lib_err:.3e}")
        if not same:
            raise AssertionError(f"flash_decode_latent {name}: two runs differ")
        ms = time_ms([lambda: ops.flash_decode_latent_op(*args, scale=scale)], torch)
        plain = time_ms([lambda: naive_latent_decode(*args, scale=scale)], torch)
        lib = time_ms([lib_call], torch)
        valid = B * S if lens is None else sum(lens)
        bms, by = latent_bound(B, H, valid)
        print(f"  flash_decode_latent {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA "
              f"{lib:.4f} ms, bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it)")
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
               "bound_by": by, "library_ms": lib,
               "shape": f"q ({B},{H},{R}+{Dr}) cache ({B},{S},{R}+{Dr}) valid keys {valid} "
                        f"scale 192^-0.5 fp32"}
        if name == "decode":
            entry.update(row)
        else:
            entry[name] = row
        del q_lat, q_rope, ckv, krope, kk, qq, vv, got, want
    rows = {"flash_attention": [], "flash_attention_bwd": []}
    for name, (B, S, H) in DS_ATTN.items():
        mla_attn_rows(torch, ops, F, dev, name, B, S, H, g, rows)
    rows.update(ds_expert_rows(torch, ops, F, dev))
    for name, r in rows.items():
        entries[name]["deepseek_v3"] = r
    torch.cuda.empty_cache()
    return entry


def ds_expert_rows(torch, ops, F, dev) -> dict:
    """12a's rows of the expert and wire kernels at deepseek-v3's shapes,
    each against its plain version and timed beside it, its bound and the
    library call: ``fused_swiglu`` at ``DS_SWIGLU_ROWS``, ``swiglu_bwd`` at
    ``DS_SWIGLU_BWD_ROWS`` and ``quantize_tiles`` / ``dequantize_tiles`` at
    ``DS_WIRE_ROWS`` (int8, bitwise).  Returns kernel name -> rows."""
    g = torch.Generator(device=dev).manual_seed(44)
    rows = {name: [] for name in ("fused_swiglu", "swiglu_bwd", "quantize_tiles",
                                  "dequantize_tiles")}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    Dm, Fd = 7168, 2048
    w = (rnd(Dm, Fd, scale=Dm ** -0.5), rnd(Dm, Fd, scale=Dm ** -0.5),
         rnd(Fd, Dm, scale=Fd ** -0.5))
    for name, T in DS_SWIGLU_ROWS.items():
        rows["fused_swiglu"].append(
            {"row": name, **time_swiglu(torch, ops, F, rnd(T, Dm), w, "deepseek-v3 expert")})
    for name, T in DS_SWIGLU_BWD_ROWS.items():
        x = rnd(T, Dm)
        gg, uu, dh = x @ w[0], x @ w[1], rnd(T, Dm) @ w[2].T
        rows["swiglu_bwd"].append(swiglu_bwd_row(torch, gg, uu, dh, "deepseek-v3 expert", name))
        del x, gg, uu, dh
    del w
    torch.cuda.empty_cache()
    quant_rows(torch, g, dev, "deepseek-v3", DS_WIRE_ROWS, 256, rows)
    return rows


def phase_ds_mla(torch, dev) -> None:
    """12b (i): the MLA block alone at full width (d_model 7168, 128 heads,
    ranks 1536 / 512, heads 128 + 64 wide, values 128), made on the card
    from a seed and copied to the CPU: ``attention_forward`` on (1, 64)
    tokens, then 8 ``attention_decode`` steps from an empty latent cache at
    batch 4, lockstep and each row at its own position, card vs CPU: every
    output and the caches."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as tatt

    cfg = get_config(DS_ARCH)
    a, D = cfg.attn, cfg.d_model
    cpu = torch.device("cpu")
    p_card = tatt.init_mla_attention(torch.Generator(device=dev).manual_seed(42), D, a,
                                     cfg.pdtype, dev)
    p_cpu = _tree_to(p_card, cpu)
    g = torch.Generator().manual_seed(43)
    T = 64
    x = torch.randn((1, T, D), generator=g)
    pos = torch.arange(T, dtype=torch.int32)[None]
    with torch.no_grad():
        got = tatt.attention_forward(p_card, x.to(dev), pos.to(dev), a)
        want = tatt.attention_forward(p_cpu, x, pos, a)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite MLA prefill output on the card")
    check(_rel(torch, got.cpu(), want), TOL_MLA_LAYER,
          f"MLA prefill (1, {T}) card vs CPU, max|diff| / max|value|")
    B, S = 4, 16
    for per_row in (False, True):
        caches = {d: tatt.init_attention_cache(B, S, a, cfg.cdtype, d) for d in (dev, cpu)}
        worst = 0.0
        for t in range(8):
            xt = torch.randn((B, D), generator=g)
            outs = {}
            for d in (dev, cpu):
                p = p_card if d == dev else p_cpu
                pos_t = (torch.tensor([t, t + 2, t + 5, t + 7], dtype=torch.int32, device=d)
                         if per_row else t)
                with torch.no_grad():
                    outs[d], _ = tatt.attention_decode(p, xt.to(d), pos_t, caches[d], a)
            worst = max(worst, _rel(torch, outs[dev].cpu(), outs[cpu]))
        kind = "per-row positions" if per_row else "lockstep"
        check(worst, TOL_MLA_LAYER, f"MLA decode batch {B}, 8 steps, {kind}, card vs CPU, "
                                    "worst step max|diff| / max|value|")
        for name in ("c_kv", "k_rope"):
            check(_rel(torch, caches[dev][name].cpu(), caches[cpu][name]), TOL_MLA_LAYER,
                  f"MLA latent cache {name!r} after 8 steps, {kind}, card vs CPU")
    del p_card, p_cpu, caches
    gc.collect()
    torch.cuda.empty_cache()


def phase_ds_serve(torch, ops, dev, card: str) -> dict:
    """12b (iii) and 12c: 1 of the 61 layers of deepseek-v3 at full width
    with all 256 routed experts and no MTP head (53.4 GB of fp32 weights):
    (iii) at capacity factor 64 (nothing drops), the prefill's last-position
    logits on (2, ``DS_PARITY_PROMPT``) tokens against as many lockstep
    decode steps (flash at q/k 192 against the latent route); 12c the
    prefill 8 x 512 (warmed up at that shape, timed twice, the last the
    path's counted run), the decode step's device-busy share and top kernels
    from a trace, then ``launch.serve --arch deepseek-v3-671b --n-layers 1``
    (batch 8, prompt 128 + gen 128): exact launch counts (a layer and step:
    1 ``flash_decode_latent`` and 257 ``fused_swiglu``), decode ms/step
    beside the bytes it must read, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import moe as tmoe
    from repro_torch.models.model import init_model
    from repro_torch.runtime.serve import (build_prefill_step, build_serve_step,
                                           prepare_serve_states)

    # no MTP head, as launch.serve: mtp_depth 0
    cfg = get_config(DS_ARCH).replace(n_layers=DS_SERVE_LAYERS, mtp_depth=0)
    L, E = cfg.n_layers, cfg.moe.n_experts
    per_layer = E + cfg.moe.n_shared_experts            # fused_swiglu a layer and forward
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    if "mtp" in params:
        raise AssertionError("the serve path allocated an MTP head")
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    print(f"  weights {n_bytes / 1e9:.3f} GB ({cfg.param_count()} params, {L} of 61 layers, "
          f"{E} routed experts, no MTP head) made on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))

    print(f"phase 12b (iii): deepseek-v3 prefill vs lockstep decode on the card, {L} layer of "
          f"{E} experts, capacity factor 64")
    cfg64 = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    B, S = 2, DS_PARITY_PROMPT
    caps = (tmoe.capacity(cfg64.moe, S, E), tmoe.capacity(cfg64.moe, B, E))
    if caps[0] < S or caps[1] < B:
        raise AssertionError(f"capacities {caps} can drop pairs")
    want = build_prefill_step(cfg64, batch_global=B, seq_len=S).step_fn(
        params, {"tokens": tokens[:B, :S]})
    ss = build_serve_step(cfg64, batch_global=B, cache_len=S)
    states = prepare_serve_states(cfg64, ss.spec.plan, B, S, dev)
    for t in range(S):
        logits, states = ss.step_fn(params, tokens[:B, t], t, states)
    if not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(want).all()):
        raise AssertionError("non-finite deepseek-v3 logits on the card")
    check(_rel(torch, logits, want), TOL_PREFILL_DECODE,
          f"deepseek-v3 prefill ({B}, {S}) last-position logits vs {S} lockstep decode "
          f"steps (capacities {caps[0]} and {caps[1]} rows an expert), max|diff| / max|logit|")
    del states, logits, want

    print(f"phase 12c: serve deepseek-v3 at full width, {L} of 61 layers, all {E} experts")
    Bp, Sp = 8, 512
    batch, prompt, gen = 8, 128, 128
    pf = build_prefill_step(cfg, batch_global=Bp, seq_len=Sp)
    prefill_ms = []

    def timed_prefill():
        t0 = time.perf_counter()
        out = pf.step_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    pf.step_fn(params, {"tokens": tokens})                      # warm-up at the shape
    timed_prefill()
    n_steps = 4
    busy_ms, dec_kernels = profile_decode(torch, cfg, params, tokens[:batch, 0], batch,
                                          prompt + gen, dev, n_steps)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    logits = timed_prefill()
    after_prefill = dict(ops.LAUNCHES)
    if logits.shape != (Bp, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"deepseek-v3 prefill logits {tuple(logits.shape)} not finite/shaped")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    res = launcher.main(["--arch", DS_ARCH, "--n-layers", str(L), "--batch", str(batch),
                         "--prompt-len", str(prompt), "--gen", str(gen)])
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if "mtp" in res["params"]:
        raise AssertionError("launch.serve allocated an MTP head")
    toks = res["tokens"]
    if toks.shape != (prompt + gen, batch) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"deepseek-v3 launcher tokens {toks.shape} out of range")
    steps = res["steps"]
    want_prefill = {name: 0 for name in ops.LAUNCHES}
    want_prefill.update(flash_attention=L, fused_swiglu=per_layer * L)
    want_all = dict(want_prefill, flash_decode_latent=L * steps,
                    fused_swiglu=per_layer * L * (steps + 1))
    print(f"  launches: prefill {after_prefill} (expected {want_prefill}); prefill + {steps} "
          f"decode steps {launches} (expected {want_all})")
    if after_prefill != want_prefill or launches != want_all:
        raise AssertionError("deepseek-v3 serving launch counts differ from the path's")
    step_ms = res["seconds"] / steps * 1e3
    read_ms, _ = bound(n_bytes - embed_bytes, 0)
    print(f"serve deepseek-v3-671b full width fp32, {L} of 61 layers ({E} routed experts + "
          f"1 shared, MLA latent cache): prefill {Bp}x{Sp} {prefill_ms[-1]:.3f} ms (calls "
          f"{', '.join(f'{x:.3f}' for x in prefill_ms)} after a warm-up); decode "
          f"{step_ms:.3f} ms/step over {steps} steps (batch {batch}, cache {prompt + gen}); a "
          f"step reads {(n_bytes - embed_bytes) / 1e9:.2f} GB of weights, >= {read_ms:.3f} ms "
          f"at 3.35 TB/s ({read_ms / step_ms:.1%} of the step); {L} flash_decode_latent and "
          f"{per_layer * L} fused_swiglu launches a step; {res['tok_per_s']:.1f} tok/s; peak "
          f"memory {peak / 1e9:.3f} GB; card {card}")
    if busy_ms is not None:
        print(f"  device busy {busy_ms:.3f} ms of the {step_ms:.3f} ms decode step "
              f"({busy_ms / step_ms:.1%}; idle {1 - busy_ms / step_ms:.1%}); the experts' "
              f"fused_swiglu {swiglu_ms(dec_kernels, n_steps):.3f} ms of it")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_ms": prefill_ms, "step_ms": step_ms,
            "busy_ms": busy_ms, "peak_gb": peak / 1e9}


def _ds_train_counts(L, M, P, nb, experts: int):
    """One step's launches with the MTP block: ``_train_counts`` plus the
    block's one layer, run once over the whole batch and not recomputed (a
    forward and a backward of its attention and of its ``experts`` MLPs)."""
    want = _train_counts(L, M, P, nb, experts)
    want["flash_attention"] += 1
    want["flash_attention_bwd"] += 1
    want["fused_swiglu"] += experts
    want["swiglu_bwd"] += experts
    return want


def phase_ds_train(torch, ops, dev, card: str) -> dict:
    """12d: deepseek-v3, 1 layer and the MTP block at published widths, the
    routed experts cut to 16 (top 8 kept), through ``launch.train
    --n-layers 1 --n-experts 16 --stage 1 --n-micro 2 --global-batch 2
    --seq 1024 --compress int8 --bucket-mb 256 --no-error-feedback``, 1
    warm-up + 2 timed steps: the state reckoned first (16 B a parameter),
    each step's ``ce``, ``aux`` and ``mtp`` (finite, aux and mtp > 0, the
    loss their weighted sum), launch counts, ms/step, the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.models.model import MTP_WEIGHT, init_model

    L, P, M, B, S, steps, E = DS_TRAIN_LAYERS, 1, 2, 2, 1024, 3, DS_TRAIN_EXPERTS
    cfg = get_config(DS_ARCH)
    cfg = cfg.replace(n_layers=L, moe=dataclasses.replace(cfg.moe, n_experts=E))
    n_params = sum(t.numel() for t in _leaves(init_model(None, cfg, "meta")))
    reckoned = 16 * n_params
    free = torch.cuda.mem_get_info(dev)[0]
    print(f"  reckoned: {n_params} parameters ({L} layer + the MTP block, {E} routed experts "
          f"+ 1 shared each, every width published): {reckoned / 1e9:.2f} GB of state at 16 B "
          f"a parameter (fp32 weights, gradients, AdamW m and v); {free / 1e9:.2f} GB free")
    argv = ["--arch", DS_ARCH, "--n-layers", str(L), "--n-experts", str(E), "--stage", str(P),
            "--n-micro", str(M), "--global-batch", str(B), "--seq", str(S), "--steps",
            str(steps), "--compress", "int8", "--bucket-mb", "256", "--no-error-feedback",
            "--log-every", "1"]
    marks, peaks = [], []

    def after_step(step, ts, params, batch):
        marks.append((f"step {step}", dict(ops.LAUNCHES), None))
        peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    res = launcher.main(argv, after_step=after_step)
    launches = dict(ops.LAUNCHES)
    ts = res["ts"]
    nb = len(ts.buckets)
    per_layer = E + ts.spec.cfg.moe.n_shared_experts
    if "mtp" not in res["params"]:
        raise AssertionError("the training state holds no MTP head")
    _check_marks(marks, launches, lambda label, extra: _ds_train_counts(L, M, P, nb, per_layer))
    for i, m in enumerate(res["metrics"]):
        loss = res["losses"][i]
        print(f"  step {i}: loss {loss:.6f} = ce {m['ce']:.6f} + aux {m['aux']:.6f} + "
              f"{MTP_WEIGHT} x mtp {m['mtp']:.6f}")
        if not (all(math.isfinite(m[k]) for k in ("ce", "aux", "mtp"))
                and m["aux"] > 0 and m["mtp"] > 0):
            raise AssertionError(f"step {i}: ce, aux, mtp {m} must be finite, aux and mtp > 0")
        if abs(m["ce"] + m["aux"] + MTP_WEIGHT * m["mtp"] - loss) > 1e-4 * abs(loss):
            raise AssertionError(f"step {i}: the loss {loss} is not ce + aux + 0.3 mtp")
    ms_step = res["seconds"] / res["timed_steps"] * 1e3
    per = {k: v for k, v in _ds_train_counts(L, M, P, nb, per_layer).items() if v}
    print(f"train deepseek-v3-671b full width fp32 ({L} layer + the MTP block, {E} of 256 "
          f"routed experts, top {ts.spec.cfg.moe.top_k}), {P} stage x {M} micro-batches, "
          f"batch {B}x{S}, int8 wire ({nb} gradient buckets): {ms_step:.1f} ms/step over "
          f"{res['timed_steps']} timed steps, {res['tok_s']:.1f} tok/s; state reckoned "
          f"{reckoned / 1e9:.2f} GB, peak memory {max(peaks) / 1e9:.3f} GB (each step "
          f"{[round(x / 1e9, 3) for x in peaks]}); launches a step {per}; card {card}")
    del res, ts
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_step": ms_step, "peak_gb": max(peaks) / 1e9}


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
    gc.collect()                      # phase 5's state is gone before 5b starts
    torch.cuda.empty_cache()
    print("phase 5b: continuous and planned serving at full width")
    continuous = phase_continuous(torch, ops, dev, card, serve["step_ms"])
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
    print("phase 6e (a): the plan portfolio's opening auction at full width, 16 layers")
    portfolio = phase_portfolio(torch, ops, dev, card)
    print("phase 6e (b): a failure, then the churn auction on the survivors, 16 layers")
    churn = phase_portfolio_churn(torch, ops, dev, card)
    print("phase 6e (c): a probation is invisible to the training state, 4 layers")
    phase_portfolio_identity(torch, ops, dev, card)
    print("phase 7a: Jamba layers at full width, card vs CPU")
    phase_jamba_layers(torch, dev)
    jamba = phase_jamba_serve(torch, ops, dev, card)
    print("phase 8a: an rwkv6-7b layer at full width, card vs CPU")
    phase_rwkv_layer(torch, dev)
    rwkv = phase_rwkv_serve(torch, ops, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 10a: kernels at the dense families' shapes against their plain versions")
    phase_dense_kernels(torch, ops, F, dev, {e["name"]: e for e in entries})
    print("phase 10b: a gemma2 period at full width, card vs CPU")
    phase_dense_parity(torch, dev)
    print("phase 10c: the local window's ring wraps on the card (4160 decode steps)")
    phase_window_wrap(torch, ops, dev, card)
    dense_serve = {}
    for arch in DENSE_ARCHS:
        print(f"phase 10d: serve {arch} whole at full width")
        dense_serve[arch] = phase_serve(torch, ops, dev, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 10e: train gemma2-2b whole at seq 8192, uniform split")
    dense_train = phase_dense_train(torch, ops, dev, card)
    print("phase 10e: train gemma-2b whole at seq 8192, uniform split")
    gemma_train = phase_dense_train(torch, ops, dev, card, arch="gemma-2b")
    dense_plan = phase_plan_train(torch, ops, dev, card, arch="gemma2-2b", label="10f")
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 11: kernels at phi3.5-moe's shapes against their plain versions")
    phase_moe_kernels(torch, ops, F, dev, {e["name"]: e for e in entries})
    print("phase 11a: a phi3.5-moe MoE layer at full width, card vs CPU")
    phase_moe_layer(torch, dev)
    moe_serve = phase_moe_serve(torch, ops, dev, card)
    print(f"phase 11d: train phi3.5-moe at full width, {MOE_TRAIN_LAYERS} layers, uniform split")
    moe_train = phase_moe_train(torch, ops, dev, card)
    print("phase 11e (a): phi3.5-moe per slot, 2 layers, card vs CPU: a token set per shard "
          "and group")
    phase_moe_slots(torch, ops, dev, card)
    moe_cont = phase_moe_continuous(torch, ops, dev, card)
    moe_plan = phase_plan_train(torch, ops, dev, card, arch=MOE_ARCH, label="11f",
                                n_layers=MOE_TRAIN_LAYERS, seq=2048, steps=3, mem_gb=40,
                                batches="1,2,4")
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 12a: the latent route of flash_decode and flash attention at MLA's widths")
    entries.append(phase_ds_kernels(torch, ops, F, dev, {e["name"]: e for e in entries}))
    print("phase 12b (i): deepseek-v3's MLA block at full width, card vs CPU")
    phase_ds_mla(torch, dev)
    print(f"phase 12b (ii): a deepseek-v3 MoE layer at full width, {DS_TRAIN_EXPERTS} routed "
          "experts, card vs CPU")
    phase_moe_layer(torch, dev, DS_ARCH, n_experts=DS_TRAIN_EXPERTS)
    ds_serve = phase_ds_serve(torch, ops, dev, card)
    print(f"phase 12d: train deepseek-v3 at full width, {DS_TRAIN_LAYERS} layer + the MTP "
          f"block, {DS_TRAIN_EXPERTS} routed experts")
    ds_train = phase_ds_train(torch, ops, dev, card)
    print("phase 9: flash attention's device times at the training shape")
    phase_flash_device(torch, ops, F, dev, {e["name"]: e for e in entries})
    print("phase 9b: the Mamba scan's device time at the Jamba prefill's shape")
    phase_scan_device(torch, ops, dev, {e["name"]: e for e in entries})
    print("phase 9c: the RWKV-6 WKV's device time at the rwkv6-7b prefill's shape")
    phase_wkv_device(torch, ops, dev, {e["name"]: e for e in entries})
    print("phase 9d: flash_decode's device time at phase 3's and 3d's and the long shapes")
    phase_decode_device(torch, ops, F, dev, {e["name"]: e for e in entries})
    for e in entries:
        by_path = {"serve": serve["launches"][e["name"]],
                   "continuous_serve": continuous["launches"][e["name"]],
                   "train": train["launches"][e["name"]],
                   "plan_train": plan_train["launches"][e["name"]],
                   "stale_train": stale_train["launches"][e["name"]],
                   "fail_train": fail_train["launches"][e["name"]],
                   "portfolio_train": portfolio["launches"][e["name"]],
                   "portfolio_churn": churn["launches"][e["name"]],
                   "jamba_serve": jamba[e["name"]], "rwkv_serve": rwkv[e["name"]],
                   **{f"{arch}_serve": dense_serve[arch]["launches"][e["name"]]
                      for arch in DENSE_ARCHS},
                   "gemma2_train": dense_train["launches"][e["name"]],
                   "gemma_train": gemma_train["launches"][e["name"]],
                   "gemma2_plan_train": dense_plan["launches"][e["name"]],
                   "phi35_moe_serve": moe_serve["launches"][e["name"]],
                   "phi35_moe_train": moe_train["launches"][e["name"]],
                   "phi35_moe_continuous": moe_cont["continuous"][e["name"]],
                   "phi35_moe_lockstep_dp2": moe_cont["lockstep_dp2"][e["name"]],
                   "phi35_moe_plan_train": moe_plan["launches"][e["name"]],
                   "deepseek_v3_serve": ds_serve["launches"][e["name"]],
                   "deepseek_v3_train": ds_train["launches"][e["name"]]}
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
