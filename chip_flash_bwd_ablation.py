#!/usr/bin/env python3
"""Where the flash-attention backward's time goes, on one NVIDIA card.

    python3 chip_flash_bwd_ablation.py [--against <older flash_attention_bwd.cu>]
        [--shape training gemma_prefill gemma2_prefill gemma_train gemma2_train]
    python3 chip_flash_bwd_ablation.py --against-fwd <older flash_attention.cu>
        [--shape ...]

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
on the critical path.

With ``--against-fwd``, the forward instead: ``src/repro_torch/csrc/
flash_attention.cu`` as it is and an older one (its headers taken from
beside it where there are any) are built, held to the plain version, and
their outputs compared bit for bit (equal at head_dim <= 128, whose routes
are unchanged), beside copies of today's without the stager's K/V loads,
without the products, and (at head_dim 256) without the exchange of the
partial scores; each is timed in turns (forward through the list, then
back) at each ``--shape`` beside SDPA's forward where it applies (no
window, no softcap; the kv heads expanded beforehand).  At gemma-2b's prefill the
port's forward plus backward (with each forward) is timed beside SDPA's in
turns too.  The extra shapes ``phi3_prefill`` and ``jamba`` are phases 3's
and 3d's forwards.

The builds go to ``src/repro_torch/_build/ablation/`` (gitignored).  Needs a
card and nvcc; exits non-zero without them.
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
# the forward's copies (--against-fwd): the stager's K and V loads fetch
# nothing (rows past the end: zeros); no wgmma in the cluster route's S and
# P V (P's registers stand in for P V, so the softmax stays); the cluster
# route's partial S not exchanged
FWD_BUILDS = {
    "no global loads": [("load_rows<DP>(xk, k, krs, kv_lo, S, D, vec);",
                         "load_rows<DP>(xk, k, krs, kv_lo, 0, D, vec);"),
                        ("load_vt<DP>(xv, v, vrs, k0, S, D);", "load_vt<DP>(xv, v, vrs, k0, 0, D);"),
                        ("load_rows<DP>(xk, k, krs, k0 + kKeys, S, D, vec);",
                         "load_rows<DP>(xk, k, krs, k0 + kKeys, 0, D, vec);")],
    "no products": [("        wgmma_ss_n64(part, dql", "        if (0) wgmma_ss_n64(part, dql"),
                    ("        wgmma_ss_n64(part, dqh + 16 * u, dkl",
                     "        if (0) wgmma_ss_n64(part, dqh + 16 * u, dkl"),
                    ("      wgmma_ss_n64(part, dqh + 16 * u, dkh",
                     "      if (0) wgmma_ss_n64(part, dqh + 16 * u, dkh"),
                    *((f"pv_chunk<64, {lo}>(ot, ph, pl, Vh, Vl);",
                       "for (int i = 0; i < 32; ++i) ot[i] = __uint_as_float(ph[i % 8][i % 4]);")
                      for lo in ("true", "false"))],
    "no exchange": [("    exchange(sacc, xt, xb, 0, rank ^ 1u, j, j == nt - 1);",
                     "    if (nt < 0) exchange(sacc, xt, xb, 0, rank ^ 1u, j, j == nt - 1);")],
}


# the training shape and chip_smoke.py's DENSE_ATTN at head_dim 256:
# name -> (B, S, H, Hkv, D, window, softcap), causal fp32
SHAPES = {"training": (2, 256, 32, 32, 96, None, None),
          "gemma_prefill": (2, 512, 8, 1, 256, None, None),
          "gemma2_prefill": (2, 512, 8, 4, 256, None, 50.0),
          "gemma_train": (1, 8192, 8, 1, 256, None, None),
          "gemma2_train": (1, 8192, 8, 4, 256, 4096, 50.0),
          "phi3_prefill": (8, 512, 32, 32, 96, None, None),
          "jamba": (2, 1024, 64, 8, 128, None, None)}
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


def build(_build, source: str, builds: dict) -> dict:
    """Compile each of ``builds`` (name -> (source text, substitutions, the
    directory whose ``*.cuh`` headers go beside it)) as ``<source>.cu``, all
    nvcc processes at once, into ``_build/ablation/<i>/lib.so``; returns name
    -> that library's directory."""
    tmp = _build.BUILD_DIR / "ablation"
    shutil.rmtree(tmp, ignore_errors=True)
    procs = {}
    for i, (name, (text, subs, headers)) in enumerate(builds.items()):
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        d = tmp / str(i)
        d.mkdir(parents=True)
        (d / f"{source}.cu").write_text(text)
        for header in headers.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: d for name, (d, _) in procs.items()}


def headers_of(src: Path) -> Path:
    """The directory of the headers an older source is built with: its own,
    if it has any beside it, else today's."""
    return src.parent if any(src.parent.glob("*.cuh")) else CSRC


def forward_turns(args, torch) -> int:
    """``--against-fwd``: today's forward and an older one in turns."""
    import torch.nn.functional as F
    from chip_smoke import (TOL_DENSE_ATTN, TOL_FP32, card_line, device_ms, flash_bound,
                            max_err, time_ms)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_fwd_route)

    src = (CSRC / "flash_attention.cu").read_text()
    dirs = build(_build, "flash_attention", {
        "as is": (src, [], CSRC),
        "against": (args.against_fwd.read_text(), [], headers_of(args.against_fwd)),
        **{name: (src, subs, CSRC) for name, subs in FWD_BUILDS.items()}})
    libs = {}
    for name, d in dirs.items():
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.flash_attention.argtypes = _build.ARGTYPES["flash_attention"]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        if name != "against":
            lib.flash_attention_route.argtypes = _build.ARGTYPES["flash_attention_route"]
            lib.flash_attention_route.restype = ctypes.c_int
        libs[name] = lib
    _build.load("flash_attention_bwd")
    dev = torch.device("cuda")
    card = card_line()
    for shape in args.shape:
        B, S, H, Hkv, D, win, cap = SHAPES[shape]
        kw = dict(window=win, softcap=cap)
        tol = TOL_FP32 if D <= 128 else TOL_DENSE_ATTN
        g = torch.Generator(device=dev).manual_seed(15)
        q = torch.randn((B, S, H, D), generator=g, device=dev).mul_(0.5)
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device=dev).mul_(0.5) for _ in range(2))
        want = ops.plain_flash_attention(q, k, v, **kw)
        # the route, asked of today's build: the wrapper keeps it for this
        # head_dim, so the older library, which has no route entry, is not asked
        _build._LIBS["flash_attention"] = libs["as is"]
        route = flash_attention_fwd_route(q, k, v)
        outs, times = {}, {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            _build._LIBS["flash_attention"] = libs[name]
            if name in ("as is", "against"):
                out = flash_attention(q, k, v, **kw)
                err = max_err(out, want)
                if not err <= tol:
                    raise AssertionError(f"{shape}: the forward {name} disagrees with the "
                                         f"plain version: {err} > {tol}")
                if name not in outs:
                    outs[name] = out
                    print(f"{shape}: {name} max abs err against the plain version {err:.3e}")
            times[name].append(device_ms(lambda: flash_attention(q, k, v, **kw), torch))
        _build._LIBS["flash_attention"] = libs["as is"]
        same = torch.equal(outs["as is"], outs["against"])
        print(f"{shape}: as is and against: outputs bitwise {'equal' if same else 'different'}")
        if D <= 128 and not same:
            raise AssertionError(f"{shape}: head_dim {D}'s forward changed its bits")
        del want
        lib_ms = []
        if win is None and cap is None:
            qt, kt, vt = (t.repeat_interleave(H // t.shape[2], 2).transpose(1, 2)
                          for t in (q, k, v))
            lib_ms = [device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), torch) for _ in range(2)]
            del qt, kt, vt
        bms, by = flash_bound(B, S, H, Hkv, D, window=win, softcap=cap)
        print(f"flash_attention {shape} ({B}, {S}, {H}/{Hkv}, {D}) causal window={win} "
              f"softcap={cap} fp32, route {route}, device ms per "
              f"call (two readings each), bound {bms:.4f} ({by}), {card}:")
        for name, ts in times.items():
            print(f"  {name:22s} {' '.join(f'{t:.4f}' for t in ts)}"
                  + (f"  ({bms / min(ts):.1%} of the bound)" if name in outs else ""))
        print(f"  {'SDPA':22s} {' '.join(f'{t:.4f}' for t in lib_ms) or 'none (window or softcap)'}")
        if shape == "gemma_prefill":
            dout = torch.randn((B, S, H, D), generator=g, device=dev)
            fwd_bwd_turns(torch, F, q, k, v, dout, card,
                          {name: libs[name] for name in ("as is", "against")})
            del dout
        del q, k, v, outs
        torch.cuda.empty_cache()
    return 0


def fwd_bwd_turns(torch, F, q, k, v, dout, card, fwd_libs=None) -> None:
    """The port's forward (with the logsumexp) plus backward beside SDPA's
    forward plus backward at gemma-2b's prefill, in turns, by CUDA events
    and by device time (and with each forward library of ``fwd_libs``,
    where given)."""
    from chip_smoke import device_ms, time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    H = q.shape[2]
    qt, kt, vt = (t.repeat_interleave(H // t.shape[2], 2).transpose(1, 2).detach()
                  .requires_grad_(True) for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def port(lib=None):
        def run():
            if lib is not None:
                _build._LIBS["flash_attention"] = lib
            o, ls = flash_attention(q, k, v, return_lse=True)
            flash_attention_bwd(q, k, v, o, ls, dout)
        return run

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dt)

    runs = {"port": port()} if fwd_libs is None else {
        f"port ({name} forward)": port(lib) for name, lib in fwd_libs.items()}
    runs["SDPA"] = sdpa
    ms = {name: [] for name in runs}
    dev_ms = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms[name].append(time_ms([runs[name]], torch))
        dev_ms[name].append(device_ms(runs[name], torch))
    if fwd_libs is not None:
        _build._LIBS["flash_attention"] = fwd_libs["as is"]
    for what, readings in (("ms per call", ms), ("device ms per call", dev_ms)):
        print(f"  forward + backward at gemma_prefill, {what} (two readings each): "
              + ", ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)}"
                          for name, ts in readings.items())
              + f"; {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="an older flash_attention_bwd.cu, timed in the same turns")
    ap.add_argument("--against-fwd", type=Path, default=None,
                    help="an older flash_attention.cu: time the forward, in turns with it")
    ap.add_argument("--shape", nargs="+", choices=sorted(SHAPES), default=["training"],
                    help="the shapes to time (default: training)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_flash_bwd_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.against_fwd is not None:
        return forward_turns(args, torch)
    from chip_smoke import TOL_DENSE_ATTN, TOL_FP32, card_line, device_ms, max_err
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_route)

    src = (CSRC / "flash_attention_bwd.cu").read_text()
    builds = {name: (src, subs, CSRC) for name, subs in BUILDS.items()}
    if args.against is not None:
        builds["against"] = (args.against.read_text(), [], headers_of(args.against))
    libs = {}
    for name, d in build(_build, "flash_attention_bwd", builds).items():
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

            fwd_bwd_turns(torch, F, q, k, v, dout, card)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
