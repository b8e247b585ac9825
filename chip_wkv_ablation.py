#!/usr/bin/env python3
"""Where the RWKV-6 WKV kernel's time goes, on one NVIDIA card.

    python3 chip_wkv_ablation.py [--against OTHER.cu ...]

Builds ``src/repro_torch/csrc/rwkv6_wkv.cu`` as it is (with ``-Xptxas -v``,
whose register and spill lines it prints for every instance) and in copies
that each leave out one kind of work, loads each build in place of the
kernel library, and reads the WKV's device time (``torch.profiler``) at the
rwkv6-7b prefill's shape, (8, 64, 512, 64) fp32 head views, in turns (each
build once forward, once backward through the list):

- ``as is``;
- ``no global loads``: the copies fetch no bytes (zero-filled), and every
  chunk is kept on the tensor cores (zero decays would send it to the exact
  branch);
- ``no stores``: no output is written to device memory;
- ``no loads, no stores``: what is left works on staged zeros;
- ``no wgmmas``: the tensor-core products of a chunk left out (their
  operands still staged and loaded into registers);
- ``no decay factors``: r and k are not scaled in place (no running
  products' multiplies and reciprocals);
- ``no wgmmas, no decay factors``.

It also prints, from ``cuobjdump -sass`` of the build as it is, how many
instructions of each kind (``OPCODES``) each kernel instance holds.

``--against`` adds other sources of the same C interface (an earlier
version of the kernel, say from ``git show
<commit>:src/repro_torch/csrc/rwkv6_wkv.cu``), each built and timed in the
same turns under its path.  The copies compute wrong outputs on purpose;
only ``as is`` and the ``--against`` sources are held to the plain version.
The gap between a copy and ``as is`` is what that work adds on the critical
path.  The builds go to ``src/repro_torch/_build/ablation/`` (gitignored).
Needs a card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"

NO_LOADS = [("const unsigned n = valid ? 16 : 0;", "const unsigned n = 0;"),
            ("bar_or(kBarWg2, 128, !(prod >= kMinHalfDecay))", "bar_or(kBarWg2, 128, 0)")]
NO_STORES = [("if (t >= steps) continue;", "if (t >= steps || o[0] != 12345.f) continue;")]
NO_WGMMAS = [("    wgmma_rs_n64(d, al[u], bh + 16 * u, u > 0);\n"
              "    wgmma_rs_n64(d, ah[u], bl + 16 * u, 1);\n"
              "    wgmma_rs_n64(d, ah[u], bh + 16 * u, 1);\n",
              "    d[u] += __uint_as_float(ah[u][0] ^ al[u][1] ^ ah[u][2] ^ al[u][3]) +\n"
              "            __uint_as_float(al[u][0] ^ ah[u][1] ^ al[u][2] ^ ah[u][3] ^ (uint32_t)(bh ^ bl));\n"),
             ("    wgmma_rs_n128(d0, d1, al[u], bh + 16 * u, u > 0);\n"
              "    wgmma_rs_n128(d0, d1, ah[u], bl + 16 * u, 1);\n"
              "    wgmma_rs_n128(d0, d1, ah[u], bh + 16 * u, 1);\n",
              "    d0[u] += __uint_as_float(ah[u][0] ^ al[u][1] ^ ah[u][2] ^ al[u][3]);\n"
              "    d1[u] += __uint_as_float(al[u][0] ^ ah[u][1] ^ al[u][2] ^ ah[u][3] ^ (uint32_t)(bh ^ bl));\n")]
NO_FACTORS = [(line, "") for line in (
    "rv[s] *= p;                              // r_t P(32..t-1)",
    "kv[s] *= rcp(p);                         // k_t / P(32..t)",
    "kv[s] *= p;                              // k_t P(t+1..31)",
    "rv[s] *= rcp(p);                         // r_t / P(t..31)")]
BUILDS = {"as is": [], "no global loads": NO_LOADS, "no stores": NO_STORES,
          "no loads, no stores": NO_LOADS + NO_STORES, "no wgmmas": NO_WGMMAS,
          "no decay factors": NO_FACTORS, "no wgmmas, no decay factors": NO_WGMMAS + NO_FACTORS}
#: SASS opcodes counted in each instance of the kernel as built
OPCODES = ("HGMMA", "FMUL", "FFMA", "FADD", "MUFU", "LDS", "STS", "LDGSTS", "STG", "SHFL",
           "BAR", "WARPSYNC", "LOP3", "IADD3")


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
        print("chip_wkv_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import TOL_WKV, bound, card_line, check_scan, device_ms
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ref import WKV_EDGE_CASES, wkv6_inputs

    src = (CSRC / "rwkv6_wkv.cu").read_text()
    sources = {name: (src, subs) for name, subs in BUILDS.items()}
    args = sys.argv[1:]
    if args:
        if len(args) < 2 or args[0] != "--against":
            print("usage: chip_wkv_ablation.py [--against OTHER.cu ...]", file=sys.stderr)
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
        (d / "rwkv6_wkv.cu").write_text(text)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        flags = [*_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if name == "as is" else [])]
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *flags, "-o", str(d / "lib.so"), str(d / "rwkv6_wkv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "as is":
            print("ptxas, as built:")
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line or "ptxas" in line:
                    print("  " + line.strip())
            print_sass_counts(_build, d / "lib.so")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.rwkv6_wkv.argtypes = _build.ARGTYPES["rwkv6_wkv"]
        lib.rwkv6_wkv.restype = ctypes.c_int
        lib.rwkv6_wkv_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    (B, H, S, d), logit_max, _ = WKV_EDGE_CASES[0]
    inp = wkv6_inputs(lambda s: torch.randn(s, generator=g, device=dev), B, H, S, d, logit_max)
    want = ops.plain_rwkv6_wkv(*inp)
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        _build._LIBS["rwkv6_wkv"] = libs[name]
        got = ops.rwkv6_wkv_op(*inp)
        if name == "as is" or name not in BUILDS:
            check_scan(got, want, f"rwkv6_wkv {name}", TOL_WKV)
        times[name].append(device_ms(lambda: ops.rwkv6_wkv_op(*inp), torch))
    card = card_line()
    nbytes = 4 * (5 * B * H * S * d + H * d)
    bms, by = bound(nbytes, 0, tf32x3=4 * 2 * B * H * S * d * d)
    print(f"rwkv6_wkv ({B}, {H}, {S}, {d}) fp32, device ms per call (two readings each; "
          f"bound {bms:.4f} ms by {by}), {card}:")
    for name, ts in times.items():
        print(f"  {name:30s} {' '.join(f'{t:.4f}' for t in ts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
