#!/usr/bin/env python3
"""Where the flash-attention backward's time goes, on one NVIDIA card.

    python3 chip_flash_bwd_ablation.py [--against <older flash_attention_bwd.cu>]

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as it is and in
copies that each leave out one kind of work, loads each build in place of
the kernel library, and reads the backward's device time (``torch.profiler``)
at the training shape, (2, 256, 32, 96) causal fp32, in turns (each build
once forward, once backward through the list):

- ``as is``;
- ``no global loads``: the stagers' copies fetch no bytes (zero-filled);
- ``no products``: the consumers issue no ``wgmma``;
- ``no stores``: the stagers split and store no chunk into the ring;
- ``no loads, no products``: both of the first two.

With ``--against``, an older source (its ``tc_tf32.cuh`` taken from beside
it where there is one) is built too and timed in the same turns as
``against``, held to the plain version and to ``as is`` bit for bit (a
source whose entry point predates the softcap argument is called without
it).

The copies compute wrong gradients on purpose; only ``as is`` (and
``against``) is held to the plain version.  The gap between a copy and ``as is`` is what that work adds
on the critical path.  The builds go to ``src/repro_torch/_build/ablation/``
(gitignored).  Needs a card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"

NO_LOADS = [("cp_async<4 * sizeof(E)>(raw + row * kPitch + col,\n"
             "                            valid ? c.src + (c.row0 + row) * c.rs + col : c.src, valid);",
             "cp_async<4 * sizeof(E)>(raw + row * kPitch + col, c.src, false);")]
NO_PRODUCTS = [("      wgmma_ss_n64(acc, dal", "      if (0) wgmma_ss_n64(acc, dal"),
               ("      wgmma_ss_n64(acc, dah + 16 * u, dbl", "      if (0) wgmma_ss_n64(acc, dah + 16 * u, dbl"),
               ("      wgmma_ss_n64(acc, dah + 16 * u, dbh", "      if (0) wgmma_ss_n64(acc, dah + 16 * u, dbh"),
               ("    pv_chunk<kCh, true>(tmp, h, l, ring + s * kChunk, ring + s * kChunk + kPart);",
                "    for (int i = 0; i < kCh / 2; ++i) tmp[i] = __uint_as_float(h[i % 8][i % 4]);")]
NO_STORES = [("      store_chunk(x, ring + s * kChunk, c.trans);",
              "      if (x[0].x == 12345.f) store_chunk(x, ring + s * kChunk, c.trans);")]
BUILDS = {"as is": [], "no global loads": NO_LOADS, "no products": NO_PRODUCTS,
          "no stores": NO_STORES, "no loads, no products": NO_LOADS + NO_PRODUCTS}


class _NoSoftcap:
    """An older library whose entry point takes no softcap: called with
    today's arguments less the softcap (which is 0 here)."""

    def __init__(self, lib):
        self.lib = lib

    def flash_attention_bwd(self, *args):
        return self.lib.flash_attention_bwd(*args[:-2], args[-1])

    def flash_attention_bwd_error_string(self, err):
        return self.lib.flash_attention_bwd_error_string(err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an older flash_attention_bwd.cu, timed in the same turns")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_flash_bwd_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import card_line, device_ms, max_err
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    tmp = _build.BUILD_DIR / "ablation"
    shutil.rmtree(tmp, ignore_errors=True)
    procs = {}
    builds = {name: (src, subs, CSRC / "tc_tf32.cuh") for name, subs in BUILDS.items()}
    if args.against is not None:
        beside = args.against.parent / "tc_tf32.cuh"
        builds["against"] = (args.against.read_text(), [],
                             beside if beside.exists() else CSRC / "tc_tf32.cuh")
    for i, (name, (text, subs, header)) in enumerate(builds.items()):
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        d = tmp / str(i)
        d.mkdir(parents=True)
        (d / "flash_attention_bwd.cu").write_text(text)
        (d / "tc_tf32.cuh").write_text(header.read_text())
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention_bwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        argtypes = list(_build.ARGTYPES["flash_attention_bwd"])
        old = "float softcap, void* stream" not in builds[name][0]
        lib.flash_attention_bwd.argtypes = argtypes[:-2] + argtypes[-1:] if old else argtypes
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        libs[name] = _NoSoftcap(lib) if old else lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    B, S, H, D = 2, 256, 32, 96
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).mul_(0.5) for _ in range(3))
    dout = torch.randn((B, S, H, D), generator=g, device=dev)
    out, lse = flash_attention(q, k, v, return_lse=True)
    want = ops.plain_flash_attention_bwd(q, k, v, dout)
    times = {name: [] for name in libs}
    first = {}
    for name in list(libs) + list(libs)[::-1]:
        _build._LIBS["flash_attention_bwd"] = libs[name]
        got = flash_attention_bwd(q, k, v, out, lse, dout)
        if name in ("as is", "against"):
            err = max(max_err(a, b) for a, b in zip(got, want))
            if not err <= 1e-4:
                raise AssertionError(f"the backward {name} disagrees with the plain version: {err}")
            first.setdefault(name, got)
        times[name].append(device_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout), torch))
    if "against" in first:
        same = all(torch.equal(a, b) for a, b in zip(first["as is"], first["against"]))
        print(f"as is and against: gradients bitwise {'equal' if same else 'DIFFERENT'}")
    card = card_line()
    print(f"flash_attention_bwd ({B}, {S}, {H}, {D}) causal fp32, device ms per call "
          f"(two readings each), {card}:")
    for name, ts in times.items():
        print(f"  {name:22s} {' '.join(f'{t:.4f}' for t in ts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
