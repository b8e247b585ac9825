"""Build and load the CUDA kernels under ``csrc/`` (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface (one or more entry points,
listed in :data:`SOURCES`, each with ``argtypes`` in :data:`ARGTYPES`) and
is compiled on first use into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library is keyed by a hash of its source, of every header beside it
(``csrc/*.cuh``, which a source includes with ``#include "<name>.cuh"``) and
of the flags, so an edited kernel or header is rebuilt and an unchanged one
is reused.  The build directory ``_build/`` sits in the
package and is listed in ``.gitignore``.  :func:`build_all` starts one nvcc
per source at once, so the wall time of a cold build is that of the slowest
file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: source file -> its C entry points
SOURCES = {
    "decode_attention": ("decode_attention", "decode_latent"),
    "flash_attention": ("flash_attention", "flash_attention_route"),
    "flash_attention_bwd": ("flash_attention_bwd", "flash_attention_bwd_route"),
    "fused_swiglu": ("fused_swiglu",),
    "fused_swiglu_bwd": ("swiglu_bwd",),
    "mamba_scan": ("mamba_scan",),
    "quant_transfer": ("quantize_tiles", "dequantize_tiles"),
    "rwkv6_wkv": ("rwkv6_wkv",),
}
_SOURCE_OF = {entry: src for src, entries in SOURCES.items() for entry in entries}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_L3 = ctypes.POINTER(ctypes.c_longlong)
# argtypes of each C entry point, as declared in its .cu file.  Every
# pointer and the stream are c_void_p, or ctypes would cut them to int.
ARGTYPES = {
    "decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _L3, _L3, _F, _I, _F, _P],
    "decode_latent": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _LL, _LL, _LL, _LL, _F, _I, _P],
    "flash_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _L3, _L3, _L3, _F, _I, _I, _F, _P],
    "flash_attention_route": [_I],
    "flash_attention_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _L3, _L3, _L3, _L3,
                            _F, _I, _I, _F, _P],
    "flash_attention_bwd_route": [_I, _P, _P, _P, _P, _I, _L3, _L3, _L3, _L3],
    "fused_swiglu": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "swiglu_bwd": [_I, _P, _P, _P, _P, _P, _P, _LL, _P],
    "mamba_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "quantize_tiles": [_I, _P, _P, _P, _LL, _I, _F, _P],
    "dequantize_tiles": [_I, _P, _P, _P, _LL, _I, _P],
    "rwkv6_wkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L3, _L3, _L3, _L3, _P],
}

#: launches of each kernel wrapper since the last ``reset_launches`` (one per
#: call of a C entry point, however many CUDA launches it makes), counted
#: by the Python function that calls :func:`launch` for that kernel
LAUNCHES = {"flash_decode": 0, "flash_decode_latent": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "fused_swiglu": 0, "swiglu_bwd": 0, "quantize_tiles": 0,
            "dequantize_tiles": 0, "mamba_scan": 0, "rwkv6_wkv": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None) and the final library path."""
    out = _lib_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def _finish(name: str, proc, out: Path, log: str | None = None) -> None:
    if proc is not None:
        if log is None:
            log, _ = proc.communicate()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(out))
    for entry_name in SOURCES[name]:
        entry = getattr(lib, entry_name)
        entry.argtypes = ARGTYPES[entry_name]
        entry.restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    _LIBS[name] = lib


def build_all() -> None:
    """Compile (in parallel) and load every kernel library not loaded yet."""
    started = [(n, *_start(n)) for n in SOURCES if n not in _LIBS]
    # wait for every nvcc before raising on the first that failed
    logs = [proc.communicate()[0] if proc else None for _, proc, _ in started]
    for (name, proc, out), log in zip(started, logs):
        _finish(name, proc, out, log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        _finish(name, *_start(name))
    return _LIBS[name]


def launch(entry: str, *args) -> None:
    """Call the C entry point ``entry`` (building its source if needed) and
    raise on the ``cudaError_t`` it returns (a refused launch never runs,
    and a later synchronize would not report it)."""
    src = _SOURCE_OF[entry]
    lib = load(src)
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = getattr(lib, f"{src}_error_string")(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg}) at launch")


def dtype_code(name: str, *tensors) -> int:
    """Check that ``tensors`` are CUDA tensors of one device and one dtype
    the kernels take; returns that dtype's code (0 float32, 1 bfloat16)."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} launches a CUDA kernel; got a tensor on {t.device}")
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: inputs on {t.device}/{t.dtype} and {dev}/{dt}")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dt not in codes:
        raise ValueError(f"{name} takes float32 or bfloat16, not {dt}")
    return codes[dt]


def check_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                             f"{t.device} and {dev}")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def strides3(t) -> "ctypes.Array":
    """The strides of a 4-d tensor's first three dims, as a C long long[3]."""
    return (ctypes.c_longlong * 3)(*t.stride()[:3])
