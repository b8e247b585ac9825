#!/usr/bin/env python3
"""Where the Mamba scan kernel's time goes, on one NVIDIA card.

    python3 chip_mamba_scan_ablation.py [--against OTHER.cu ...]

Builds ``src/repro_torch/csrc/mamba_scan.cu`` as it is (with ``-Xptxas -v``,
whose register and spill lines it prints for every instance) and in copies
that each leave out one kind of work, loads each build in place of the
kernel library, and reads the scan's device time (``torch.profiler``) at the
Jamba prefill's shape, (2, 1024, 16384, 16) fp32, in turns (each build once
forward, once backward through the list):

- ``as is``;
- ``one channel a lane``: each lane owns one channel's four states, not
  two channels' (twice the threads, and each read of b and c from shared
  memory serves half the (t, j, n));
- ``no exponentials``: one fp32 add in place of each ``ex2.approx``;
- ``no global loads``: the staging copies fetch no bytes (zero-filled);
- ``no stores``: no y is written to device memory;
- ``no loads, no stores``: the recurrence on staged zeros, nothing written;
- ``no exponentials, loads or stores``: what is left of the recurrence;
- ``no b, c reads from shared memory``: b and c taken from registers;
- ``no sums across lanes``: one lane of a channel writes its partial
  readouts and y is that partial alone.

It also prints, from ``cuobjdump -sass`` of the build as it is, how many
instructions of each kind (``OPCODES``) each instance of the kernel holds:
the full tile's 16 steps are unrolled, so they dominate the counts.

``--against`` adds other sources of the same C interface (an earlier
version of the kernel, say from ``git show
<commit>:src/repro_torch/csrc/mamba_scan.cu``), each built and timed in the
same turns under its path.  The copies compute wrong outputs on purpose;
only ``as is`` and the ``--against`` sources are held to the plain version.  The gap between a copy and
``as is`` is what that work adds on the critical path.  The builds go to ``src/repro_torch/_build/ablation/``
(gitignored).  Needs a card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"

ONE_CHANNEL = [("constexpr int kCh = 2;", "constexpr int kCh = 1;")]
NO_EXPS = [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));', "r = 1.0f + v;")]
NO_BC_READS = [("const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][s][kPer * q]);",
                "const float4 b4 = make_float4(xv[0], dtv[0], xv[0], dtv[0]);"),
               ("const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[buf][s][kPer * q]);",
                "const float4 c4 = make_float4(dtv[0], xv[0], dtv[0], xv[0]);")]
NO_LANE_SUMS = [("store_row(&sm.part[s][q][ch0], p);", "if (q == 0) store_row(&sm.part[s][q][ch0], p);"),
                ("*reinterpret_cast<float4*>(dst) = lane_sum<L>(pv);",
                 "*reinterpret_cast<float4*>(dst) = pv[0];")]
NO_LOADS = [("const unsigned n = valid ? kBytes : 0;", "const unsigned n = 0;")]
NO_STORES = [("if (j0 + c >= d) continue;",
              "if (j0 + c >= d || sm.part[s][0][c] != 12345.f) continue;")]
BUILDS = {"as is": [], "one channel a lane": ONE_CHANNEL, "no exponentials": NO_EXPS,
          "no global loads": NO_LOADS, "no stores": NO_STORES,
          "no loads, no stores": NO_LOADS + NO_STORES,
          "no exponentials, loads or stores": NO_EXPS + NO_LOADS + NO_STORES,
          "no b, c reads from shared memory": NO_BC_READS, "no sums across lanes": NO_LANE_SUMS}
#: SASS opcodes counted in each instance of the kernel as built
OPCODES = ("MUFU.EX2", "FMUL", "FFMA", "FADD", "FSEL", "LDS", "SHFL", "STS", "LDGSTS", "BAR")


def print_sass_counts(_build, lib: Path) -> None:
    """Instructions of each kind in each kernel instance of ``lib``."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print(f"  (no {tool}: SASS not counted)")
        return
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(OPCODES + ("all",), 0)
        elif name and line.strip().startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1]
            if ";" not in body:
                continue
            words = body.split(";")[0].split()
            if not words:
                continue
            op = words[1] if words[0].startswith("@") else words[0]
            counts[name]["all"] += 1
            for kind in OPCODES:
                if op == kind or op.startswith(kind + "."):
                    counts[name][kind] += 1
    print("SASS instructions by kind, as built:")
    for name, c in counts.items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mamba_scan_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import TOL_SCAN, bound, card_line, check_scan, device_ms
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ref import MAMBA_EDGE_CASES, mamba_scan_inputs, naive_mamba_scan

    src = (CSRC / "mamba_scan.cu").read_text()
    sources = {name: (src, subs) for name, subs in BUILDS.items()}
    args = sys.argv[1:]
    if args:
        if len(args) < 2 or args[0] != "--against":
            print("usage: chip_mamba_scan_ablation.py [--against OTHER.cu ...]", file=sys.stderr)
            return 2
        for other in args[1:]:
            sources[other] = (Path(other).read_text(), [])
    tmp = _build.BUILD_DIR / "ablation"
    shutil.rmtree(tmp, ignore_errors=True)
    procs = {}
    for i, (name, (text, subs)) in enumerate(sources.items()):
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        d = tmp / str(i)
        d.mkdir(parents=True)
        (d / "mamba_scan.cu").write_text(text)
        flags = [*_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if name == "as is" else [])]
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(d / "lib.so"), str(d / "mamba_scan.cu")],
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
        lib.mamba_scan.argtypes = _build.ARGTYPES["mamba_scan"]
        lib.mamba_scan.restype = ctypes.c_int
        lib.mamba_scan_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    (B, S, d, N), _ = MAMBA_EDGE_CASES[0]
    inp = mamba_scan_inputs(lambda s: torch.randn(s, generator=g, device=dev), B, S, d, N)
    want = naive_mamba_scan(*inp)
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        _build._LIBS["mamba_scan"] = libs[name]
        got = ops.mamba_scan_op(*inp)
        if name == "as is" or name not in BUILDS:
            check_scan(got, want, f"mamba_scan {name}", TOL_SCAN)
        times[name].append(device_ms(lambda: ops.mamba_scan_op(*inp), torch))
    card = card_line()
    bms, by = bound(4 * (3 * B * S * d + 2 * B * S * N + d * N), 6 * B * S * d * N,
                    exps=B * S * d * N)
    print(f"mamba_scan ({B}, {S}, {d}, {N}) fp32, device ms per call (two readings each; "
          f"bound {bms:.4f} ms by {by}), {card}:")
    for name, ts in times.items():
        print(f"  {name:34s} {' '.join(f'{t:.4f}' for t in ts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
