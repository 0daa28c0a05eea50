"""ctypes binding for the native C++ block quantizer (``native/quant.cpp``).

Counterpart of ``moshi_tpu/native_quant.py``.  The library is built from
the repository's ``native/quant.cpp`` at first use, with the host's C++
compiler (``$CXX``, else ``g++``) and ``native/Makefile``'s flags (``-O3
-march=native -fPIC -std=c++17 -Wall``, linked with ``-lpthread``), into
``build/moshi_tpu_torch/`` at the root of the checkout, named after the
hash of its source, its flags and the host CPU (its model and feature
flags), so a stale library, or one built on another CPU, is never
loaded.  The prebuilt ``native/libmoshi_quant.so`` is not used:
``-march=native`` ties a build to the CPU it was made on.

Unlike the JAX package, which falls back to numpy without a word when its
library is missing, a failed build raises here; ``quant/formats.py``
``quantize(..., native=False)`` is the one way to ask for numpy.  The
quantizer rounds half away from zero (``lround``) where numpy rounds half
to even, so its integer values differ from numpy's at exact ties only.

Scales come back as raw bf16 bits (uint16); the layouts are those of
``quant/formats.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "quant.cpp"
BUILD_DIR = _ROOT / "build" / "moshi_tpu_torch"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_LIB: Optional[ctypes.CDLL] = None


def _compiler() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


def _cpu_id() -> bytes:
    """The host CPU's model name and feature flags (what -march=native
    reads), or the machine type where /proc/cpuinfo is not there."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        import platform
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_compiler() + list(CXXFLAGS)).encode())
    h.update(_cpu_id())
    return BUILD_DIR / f"libmoshi_quant-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/quant.cpp`` unless an up-to-date library exists;
    returns its path.  Raises if the compiler fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = _compiler() + list(CXXFLAGS) + ["-shared", "-o", str(tmp),
                                          str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native quantizer cannot be built: "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native quantizer failed to build ({' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
        lib.moshi_quantize_q8_0.argtypes = [f32p, i64, i64, i8p, u16p]
        lib.moshi_quantize_q4_0.argtypes = [f32p, i64, i64, u8p, u16p]
        lib.moshi_quantize_q4_k.argtypes = [f32p, i64, i64, u8p, u8p, u8p,
                                            u16p, u16p]
        for fn in (lib.moshi_quantize_q8_0, lib.moshi_quantize_q4_0,
                   lib.moshi_quantize_q4_k):
            fn.restype = None
        _LIB = lib
    return _LIB


def quantize_native(w: np.ndarray, fmt: str) -> dict:
    """The packed numpy arrays of ``w`` [O, I] in ``fmt`` (q8_0, q4_0 or
    q4_k); scales as raw bf16 bits (uint16)."""
    lib = load()
    w = np.ascontiguousarray(w, np.float32)
    o, i = w.shape
    if fmt == "q8_0":
        q = np.empty((o, i), np.int8)
        d = np.empty((o, i // 32), np.uint16)
        lib.moshi_quantize_q8_0(w, o, i, q, d)
        return {"q": q, "d": d}
    if fmt == "q4_0":
        q = np.empty((o, i // 2), np.uint8)
        d = np.empty((o, i // 32), np.uint16)
        lib.moshi_quantize_q4_0(w, o, i, q, d)
        return {"q": q, "d": d}
    if fmt == "q4_k":
        nsb = i // 256
        q = np.empty((o, i // 2), np.uint8)
        sc = np.empty((o, nsb, 8), np.uint8)
        mn = np.empty((o, nsb, 8), np.uint8)
        d = np.empty((o, nsb), np.uint16)
        dmin = np.empty((o, nsb), np.uint16)
        lib.moshi_quantize_q4_k(w, o, i, q, sc, mn, d, dmin)
        return {"q": q, "sc": sc, "mn": mn, "d": d, "dmin": dmin}
    raise ValueError(f"no native quantizer for {fmt!r}")
