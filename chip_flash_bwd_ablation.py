#!/usr/bin/env python3
"""Where the flash-attention backward's time goes, on one NVIDIA card.

    python3 chip_flash_bwd_ablation.py [--against <older flash_attention_bwd.cu>]
        [--shape training gemma_prefill gemma2_prefill gemma_train gemma2_train]

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as it is and in
copies that each leave out one kind of work, loads each build in place of
the kernel library, and reads the backward's device time (``torch.profiler``)
at each ``--shape`` in turns (each build once forward, once backward through
the list).  The shapes: ``training``, (2, 256, 32, 96) causal fp32 (the
default; the tensor-core route at head_dim <= 128), and chip_smoke.py's
head_dim-256 shapes of phase 10a (``DENSE_ATTN``: gemma-2b's MQA prefill,
gemma2's prefill with softcap 50, gemma-2b's training micro-batch, and
gemma2's with window 4096 and softcap 50), which take the two-CTA clusters.  The builds:

- ``as is``;
- ``no global loads``: the stagers' copies fetch no bytes (zero-filled);
- ``no products``: the consumers issue no ``wgmma``;
- ``no stores``: the stagers split and store no chunk into the ring;
- ``no loads, no products``: both of the first two.

With ``--against``, an older source (its ``tc_tf32.cuh`` taken from beside
it where there is one) is built too and timed in the same turns as
``against``, held to the plain version, and its gradients compared with
``as is`` bit for bit (a source whose entry point predates the softcap or
the dK/dV parts' arguments is called without them).  At gemma-2b's shape
the port's forward plus backward is timed beside SDPA's forward plus
backward (the yardstick; the port never calls SDPA).

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
               ("        wgmma_rs_n64(part, l[u]", "        if (0) wgmma_rs_n64(part, l[u]"),
               ("        wgmma_rs_n64(part, h[u], dbl", "        if (0) wgmma_rs_n64(part, h[u], dbl"),
               ("        wgmma_rs_n64(part, h[u], dbh", "        if (0) wgmma_rs_n64(part, h[u], dbh"),
               ("    pv_chunk<kCh, true>(tmp, h, l, ring + s * kChunk, ring + s * kChunk + kPart);",
                "    for (int i = 0; i < kCh / 2; ++i) tmp[i] = __uint_as_float(h[i % 8][i % 4]);")]
NO_STORES = [("      store_chunk(x, ring + s * kChunk, c.trans);",
              "      if (x[0].x == 12345.f) store_chunk(x, ring + s * kChunk, c.trans);")]
BUILDS = {"as is": [], "no global loads": NO_LOADS, "no products": NO_PRODUCTS,
          "no stores": NO_STORES, "no loads, no products": NO_LOADS + NO_PRODUCTS}


# the training shape and chip_smoke.py's DENSE_ATTN at head_dim 256:
# name -> (B, S, H, Hkv, D, window, softcap), causal fp32
SHAPES = {"training": (2, 256, 32, 32, 96, None, None),
          "gemma_prefill": (2, 512, 8, 1, 256, None, None),
          "gemma2_prefill": (2, 512, 8, 4, 256, None, 50.0),
          "gemma_train": (1, 8192, 8, 1, 256, None, None),
          "gemma2_train": (1, 8192, 8, 4, 256, 4096, 50.0)}
# arguments of today's entry point that older ones lack: the dK/dV parts
# and their count (after dv), the softcap (before the stream)
_PARTS, _SOFTCAP = slice(11, 13), -2


class _Older:
    """An older library: its entry point called with today's arguments less
    those it predates (``parts``: the dK/dV parts' scratch and count;
    ``softcap``: the softcap, which is 0 wherever such a source is timed);
    the route asked of today's build ``now``, whose choice of the dK/dV
    split the older entry ignores."""

    def __init__(self, lib, now, parts: bool, softcap: bool):
        self.lib, self.now, self.parts, self.softcap = lib, now, parts, softcap

    def flash_attention_bwd(self, *args):
        args = list(args)
        if not self.softcap:
            del args[_SOFTCAP]
        if not self.parts:
            del args[_PARTS]
        return self.lib.flash_attention_bwd(*args)

    def flash_attention_bwd_route(self, *args):
        return self.now.flash_attention_bwd_route(*args)

    def flash_attention_bwd_error_string(self, err):
        return self.lib.flash_attention_bwd_error_string(err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an older flash_attention_bwd.cu, timed in the same turns")
    ap.add_argument("--shape", nargs="+", choices=sorted(SHAPES), default=["training"],
                    help="the shapes to time (default: training)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_flash_bwd_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import TOL_DENSE_ATTN, TOL_FP32, card_line, device_ms, max_err, time_ms
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_route)

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
        text = builds[name][0]
        softcap = "float softcap, void* stream" in text
        parts = "void* parts, int g" in text
        if not softcap:
            del argtypes[_SOFTCAP]
        if not parts:
            del argtypes[_PARTS]
        lib.flash_attention_bwd.argtypes = argtypes
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        if parts:
            lib.flash_attention_bwd_route.argtypes = _build.ARGTYPES["flash_attention_bwd_route"]
            lib.flash_attention_bwd_route.restype = ctypes.c_int
        libs[name] = lib if parts and softcap else _Older(lib, None, parts, softcap)
    for lib in libs.values():
        if isinstance(lib, _Older):
            lib.now = libs["as is"]

    dev = torch.device("cuda")
    card = card_line()
    for shape in args.shape:
        B, S, H, Hkv, D, win, cap = SHAPES[shape]
        kw = dict(window=win, softcap=cap)
        tol = TOL_FP32 if D <= 128 else TOL_DENSE_ATTN
        g = torch.Generator(device=dev).manual_seed(15)
        q = torch.randn((B, S, H, D), generator=g, device=dev).mul_(0.5)
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev).mul_(0.5) for _ in range(2))
        dout = torch.randn((B, S, H, D), generator=g, device=dev)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        want = ops.plain_flash_attention_bwd(q, k, v, dout, **kw)
        torch.cuda.empty_cache()
        _build._LIBS["flash_attention_bwd"] = libs["as is"]
        route = flash_attention_bwd_route(q, k, v, dout)
        times = {name: [] for name in libs}
        first = {}
        for name in list(libs) + list(libs)[::-1]:
            _build._LIBS["flash_attention_bwd"] = libs[name]
            got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            if name in ("as is", "against"):
                err = max(max_err(a, b) for a, b in zip(got, want))
                if not err <= tol:
                    raise AssertionError(f"{shape}: the backward {name} disagrees with the "
                                         f"plain version: {err} > {tol}")
                if name not in first:
                    first[name] = got
                    print(f"{shape}: {name} max abs err against the plain version {err:.3e}")
            del got
            times[name].append(device_ms(
                lambda: flash_attention_bwd(q, k, v, out, lse, dout, **kw), torch))
        _build._LIBS["flash_attention_bwd"] = libs["as is"]
        if "against" in first:
            same = all(torch.equal(a, b) for a, b in zip(first["as is"], first["against"]))
            print(f"{shape}: as is and against: gradients bitwise "
                  f"{'equal' if same else 'DIFFERENT'}")
        del first, want
        print(f"flash_attention_bwd {shape} ({B}, {S}, {H}/{Hkv}, {D}) causal window={win} "
              f"softcap={cap} fp32, route {route}, device ms per call (two readings each), "
              f"{card}:")
        for name, ts in times.items():
            print(f"  {name:22s} {' '.join(f'{t:.4f}' for t in ts)}")
        if shape == "gemma_prefill":
            import torch.nn.functional as F

            qt, kt, vt = (t.repeat_interleave(H // t.shape[2], 2).transpose(1, 2).detach()
                          .requires_grad_(True) for t in (q, k, v))
            dt = dout.transpose(1, 2)

            def port():
                o, ls = flash_attention(q, k, v, return_lse=True)
                flash_attention_bwd(q, k, v, o, ls, dout)

            def sdpa():
                o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                torch.autograd.grad(o, (qt, kt, vt), dt)

            ms = {}
            for name, fn in (("port", port), ("SDPA", sdpa), ("SDPA", sdpa), ("port", port)):
                ms.setdefault(name, []).append(time_ms([fn], torch))
            print(f"  forward + backward at gemma_prefill, ms per call (two readings each): "
                  f"port {' '.join(f'{t:.4f}' for t in ms['port'])}, SDPA "
                  f"{' '.join(f'{t:.4f}' for t in ms['SDPA'])}; {card}")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
