#!/usr/bin/env python3
"""Where ``flash_decode``'s time goes, on one NVIDIA card.

    python3 chip_decode_ablation.py [--against OTHER.cu ...]
    python3 chip_decode_ablation.py --host-path [--src SRC_DIR]

The first form builds ``src/repro_torch/csrc/decode_attention.cu`` as it is
(with ``-Xptxas -v``, whose register and spill lines it prints) and in
copies that each change one thing, loads each build in place of the kernel
library, and reads the kernel's device time (``torch.profiler``) at the
four ``chip_smoke.DECODE_SHAPES`` (phi3's and Jamba's serving steps, the
phi3 and Jamba long caches at batch 1, fp32; ``chip_smoke.decode_sets``:
input sets called in turn until their caches span 4x the L2), in turns
(each build once forward, once backward through the list):

- ``as is``;
- ``no global loads``: every chunk's TMA box is the split's first (L2 hits);
- ``no staging copies``: no copy is issued and none awaited (the chunks
  compute on whatever shared memory holds);
- ``no scores`` (the partial dot products), ``no score shuffles`` (the
  reduce-scatter across lanes), ``no softmax`` (its shuffles and
  exponentials), ``no P V``: that step of each chunk left out; ``copies
  only``: all four;
- ``no chunk loop``: launch, q, the partials' sums and the merge alone;
- ``no cluster merge``: no distributed shared memory and no cluster
  barriers (each CTA merges its own partial as if it were every split's);
- ``at most 8 splits``: clusters of 16 not used;
- ``one split``: no split-KV (one CTA a row, its keys in sequence);
- ``8-head tiles only``: a group of 8 heads stays one CTA at short caches
  too (no 4-head tiles).

``--against`` adds other sources of the same C interface (the kernel this
one replaced, say, from ``git show <commit>:src/repro_torch/csrc/
decode_attention.cu`` written to a file), each built and timed in the same
turns under its path.  Only ``as is`` and the ``--against`` sources are held
to the plain version (``TOL_FP32``): the copies compute wrong outputs on
purpose (not ``at most 8 splits``, ``one split`` and ``8-head tiles only``,
which are also held).  The card's SM clock is read every 100 ms over each
shape's turns and printed with them.

The second form times the Python launch path of ``ops.flash_decode_op`` at
phase 3's shape (the phi3 step): host µs per call over 1000 calls without
a synchronize (``time.perf_counter``), beside the CUDA-event time per call;
``--src`` imports ``repro_torch`` from another tree's ``src`` (an earlier
commit unpacked with ``git archive``), so two wrappers can be timed in
turns, one run each.

Builds go to ``src/repro_torch/_build/`` (gitignored).  Needs a card and
nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"

NO_LOADS = [("tma_rows(kdst, &p.tk, hk, key0, b, bar);", "tma_rows(kdst, &p.tk, hk, k0, b, bar);"),
            ("tma_rows(vdst, &p.tv, hk, key0, b, bar);", "tma_rows(vdst, &p.tv, hk, k0, b, bar);")]
NO_COPIES = [("if (c + NS - 1 < nchunks) stage(c + NS - 1);", "if (c < 0) stage(c + NS - 1);"),
             ("if (s < nchunks) stage(s);", "if (s < 0) stage(s);"),
             ("if (p.vec) mbar_wait(", "if (c < 0) mbar_wait(")]
NO_SCORES = [("      float vals[NVAL];\n", "      float vals[NVAL] = {};\n"),
             ("for (int k = 0; k < KR; ++k) {\n        float kx[NV][VE];",
              "for (int k = 0; k < 0; ++k) {\n        float kx[NV][VE];")]
NO_REDUCE = [("vals[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);", "vals[i] = keep + send;"),
             ("s += __shfl_xor_sync(0xffffffffu, s, off);", "s += s;")]
NO_SOFTMAX = [("bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));", "bm += bm;"),
              ("ps += __shfl_xor_sync(0xffffffffu, ps, off);", "ps += ps;"),
              ("const float corr = any ? expf(m_run - m_new) : 1.f;", "const float corr = 1.f;"),
              ("const float pr = any ? expf(sc[rd] - m_new) : 0.f;", "const float pr = sc[rd];")]
NO_PV = [("for (int k = 0; k < KW; ++k) {\n      float pk[GT];",
          "for (int k = 0; k < 0; ++k) {\n      float pk[GT];")]
NO_LOOP = [("for (int c = 0; c < nchunks; ++c) {", "for (int c = 0; c < 0; ++c) {"),
           ("if (s < nchunks) stage(s);", "if (s < 0) stage(s);")]
NO_MERGE = [("return one ? ptr : cluster.map_shared_rank(ptr, rank);", "return ptr;"),
            ("if (one) __syncthreads(); else cluster.sync();", "__syncthreads();")]
AT_MOST_8 = [("clusters > 0 ? kMaxSplits : kMaxSplits / 2", "kMaxSplits / 2")]
ONE_SPLIT = [("return pick_splits(rows", "return 1 + 0 * pick_splits(rows")]
TILES_OF_8 = [("if (rows * P < sm_count(dev) && (p.S + ck - 1) / ck <= 2 * P)", "if (false)")]
BUILDS = {"as is": [], "no global loads": NO_LOADS, "no staging copies": NO_COPIES,
          "no scores": NO_SCORES, "no score shuffles": NO_REDUCE, "no softmax": NO_SOFTMAX,
          "no P V": NO_PV, "copies only": NO_SCORES + NO_REDUCE + NO_SOFTMAX + NO_PV,
          "no chunk loop": NO_LOOP, "no cluster merge": NO_MERGE,
          "at most 8 splits": AT_MOST_8, "one split": ONE_SPLIT, "8-head tiles only": TILES_OF_8}
#: builds held to the plain version
HELD = ("as is", "at most 8 splits", "one split", "8-head tiles only")


def sm_clock_sampler():
    """Start reading card 0's SM clock (MHz, ``nvidia-smi``) every 100 ms
    and wait for its first reading, which is dropped; returns a function
    that stops the reader and gives the later readings as (min, median,
    max, count), or None if there were none."""
    proc = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    proc.stdout.readline()

    def stop():
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        mhz = sorted(int(x) for x in out.split() if x.isdigit())
        return (mhz[0], mhz[len(mhz) // 2], mhz[-1], len(mhz)) if mhz else None
    return stop


def host_path(src: Path) -> int:
    import torch

    sys.path.insert(0, str(src))
    from chip_smoke import DECODE_SHAPES, card_line, decode_inputs, time_ms
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    _build.load("decode_attention")
    q, k, v, lens = decode_inputs(torch, dev, torch.Generator(device=dev).manual_seed(11), "phi3")
    for _ in range(50):
        ops.flash_decode_op(q, k, v, lens)
    torch.cuda.synchronize()
    n = 1000
    t0 = time.perf_counter()
    for _ in range(n):
        ops.flash_decode_op(q, k, v, lens)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    event_ms = time_ms([lambda: ops.flash_decode_op(q, k, v, lens)], torch)
    B, H, Hkv, S, D, _ = DECODE_SHAPES["phi3"]
    print(f"flash_decode host path ({_build.__file__}): q ({B}, {H}, {D}) cache ({B}, {S}, "
          f"{Hkv}, {D}): host {host_us:.2f} us per call over {n} calls without a "
          f"synchronize; CUDA events {event_ms * 1e3:.2f} us per call; {card_line()}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    args = sys.argv[1:]
    if args and args[0] == "--host-path":
        if len(args) not in (1, 3) or (len(args) == 3 and args[1] != "--src"):
            print("usage: chip_decode_ablation.py --host-path [--src SRC_DIR]", file=sys.stderr)
            return 2
        return host_path(Path(args[2]).resolve() if len(args) == 3 else ROOT / "src")
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import (DECODE_SHAPES, TOL_FP32, card_line, check, decode_bound,
                            decode_sets, device_ms, in_turns, max_err)
    from chip_wkv_ablation import print_sass_counts
    from repro_torch.kernels import _build, ops

    src = (CSRC / "decode_attention.cu").read_text()
    sources = {name: (src, subs) for name, subs in BUILDS.items()}
    if args:
        if len(args) < 2 or args[0] != "--against":
            print("usage: chip_decode_ablation.py [--against OTHER.cu ...]", file=sys.stderr)
            return 2
        for other in args[1:]:
            sources[other] = (Path(other).read_text(), [])
    tmp = _build.BUILD_DIR / "ablation_decode"
    shutil.rmtree(tmp, ignore_errors=True)
    procs = {}
    for i, (name, (text, subs)) in enumerate(sources.items()):
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        d = tmp / str(i)
        d.mkdir(parents=True)
        (d / "decode_attention.cu").write_text(text)
        flags = [*_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if name == "as is" else [])]
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(d / "lib.so"), str(d / "decode_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "as is":
            print("ptxas, as built:")
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print("  " + line.strip())
            print_sass_counts(_build, d / "lib.so")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.decode_attention.argtypes = _build.ARGTYPES["decode_attention"]
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    card = card_line()
    for shape in DECODE_SHAPES:
        B, H, Hkv, S, D, lens = DECODE_SHAPES[shape]
        sets = decode_sets(torch, dev, g, shape)
        want = ops.plain_flash_decode(*sets[0])
        calls = in_turns([lambda s=s: ops.flash_decode_op(*s) for s in sets])
        times = {name: [] for name in libs}
        clock = sm_clock_sampler()
        for name in list(libs) + list(libs)[::-1]:
            _build._LIBS["decode_attention"] = libs[name]
            got = ops.flash_decode_op(*sets[0])
            if name in HELD or name not in BUILDS:
                check(max_err(got, want), TOL_FP32, f"flash_decode {shape} {name}")
            times[name].append(device_ms(calls, torch))
        mhz = clock()
        bms, by = decode_bound(shape)
        print(f"flash_decode {shape}: q ({B}, {H}, {D}) cache ({B}, {S}, {Hkv}, {D}) lens sum "
              f"{sum(lens)} fp32, {len(sets)} input sets in turn, device ms per call (two "
              f"readings each; bound {bms:.4f} ms by {by}; SM clock over the turns, min, "
              f"median, max MHz, readings: {mhz}), {card}:")
        for name, ts in times.items():
            print(f"  {name:30s} {' '.join(f'{t:.4f}' for t in ts)}  "
                  f"({bms / min(ts):.1%} of the bound at best)")
        del sets, want, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
