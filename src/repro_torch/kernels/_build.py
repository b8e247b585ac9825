"""Build and load the CUDA kernels under ``csrc/`` (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into its own shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library is keyed by a hash of its source, so an edited kernel is rebuilt
and an unchanged one is reused.  The build directory ``_build/`` sits in the
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
SOURCES = ("decode_attention", "flash_attention", "fused_swiglu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L3 = ctypes.POINTER(ctypes.c_longlong)
# argtypes of each library's C entry point, as declared in its .cu file.
# Every pointer and the stream are c_void_p, or ctypes would cut them to int.
ARGTYPES = {
    "decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _L3, _L3, _F, _I, _F, _P],
    "flash_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _L3, _L3, _L3, _F, _I, _I, _F, _P],
    "fused_swiglu": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


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
    entry = getattr(lib, name)
    entry.argtypes = ARGTYPES[name]
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


def launch(name: str, *args) -> None:
    """Call the C entry point of ``csrc/<name>.cu`` and raise on the
    ``cudaError_t`` it returns (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = load(name)
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")


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


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def strides3(t) -> "ctypes.Array":
    """The strides of a 4-d tensor's first three dims, as a C long long[3]."""
    return (ctypes.c_longlong * 3)(*t.stride()[:3])
