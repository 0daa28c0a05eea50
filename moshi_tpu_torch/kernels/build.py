"""Build and load the hand-written CUDA kernels (``moshi_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library under ``build/moshi_tpu_torch/`` at the root of the checkout, then
loaded with ``ctypes``.  All sources are compiled together, one ``nvcc``
process each, the first time any kernel is asked for.  A library is named
after the hash of its source, so an edited kernel is rebuilt and a stale
one is never loaded.

Nothing here catches a build or launch failure: a kernel that does not
build, or a C entry that returns a CUDA error, raises.  ``COUNTS`` holds
one launch count per kernel; each wrapper adds one where it launches.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "moshi_tpu_torch"
SOURCES = ("int8_matvec", "dequant_matvec", "decode_attention", "ring_write",
           "attn_ffn_fused", "glu_matvec", "temporal_step", "dep_step",
           "split_matvec")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches per kernel since the last clear (chip_smoke.py zeroes it around
# the main path and reads it after)
COUNTS: collections.Counter = collections.Counter()

_LIBS: dict = {}
_ENTRIES: dict = {}
BUILD_LOG: dict = {}      # name -> nvcc's stderr (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, all in
    parallel; returns the wall time in seconds.  Raises on any failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _declare(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def load(name: str):
    """The ctypes library of ``csrc/<name>.cu``, building on first use."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def entry(lib_name: str, fn_name: str, argtypes):
    """A C entry point with its ctypes signature declared once."""
    key = (lib_name, fn_name)
    if key not in _ENTRIES:
        _ENTRIES[key] = _declare(load(lib_name), fn_name, argtypes)
    return _ENTRIES[key]


def check(err: int, lib_name: str, what: str):
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = load(lib_name).mt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t):
    """The current CUDA stream of tensor ``t``'s device, as a pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
