"""Zero-dependency safetensors reader/writer (mmap-backed, lazy).

Counterpart of ``moshi_tpu/io/safetensors.py``, a copy (pure numpy): the
header maps each name to {dtype, shape, byte range}; bf16 payloads are
widened to f32 on read (``bf16_to_f32``) and rounded to nearest even on
write (``f32_to_bf16_raw``).  Shapes stay in row-major numpy order.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # handled specially (numpy has no native bf16)
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "U32": np.uint32,
    "U16": np.uint16,
}

_INV_DTYPES = {
    np.dtype(np.float64): "F64",
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.uint16): "U16",
    np.dtype(np.uint32): "U32",
    np.dtype(np.bool_): "BOOL",
}


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """View uint16 bf16 payload as float32 (shift into high half)."""
    u32 = raw.astype(np.uint32) << 16
    return u32.view(np.float32)


def f32_to_bf16_raw(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 stored as uint16."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    rounding = 0x7FFF + ((u >> 16) & 1)
    return ((u + rounding) >> 16).astype(np.uint16)


class SafeTensors:
    """Lazy mmap-backed safetensors file.

    >>> st = SafeTensors("model.safetensors")
    >>> st.keys()
    >>> arr = st["transformer.layers.0.gating.linear_in.weight"]  # numpy f32
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        header_len = struct.unpack("<Q", self._fh.read(8))[0]
        header = json.loads(self._fh.read(header_len))
        self._meta = header.pop("__metadata__", {})
        self._data_start = 8 + header_len
        self._entries: Dict[str, Tuple[str, List[int], int, int]] = {}
        for name, ent in header.items():
            self._entries[name] = (
                ent["dtype"],
                list(ent["shape"]),
                ent["data_offsets"][0],
                ent["data_offsets"][1],
            )
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def dtype(self, name: str) -> str:
        return self._entries[name][0]

    def shape(self, name: str) -> List[int]:
        return self._entries[name][1]

    def raw(self, name: str) -> memoryview:
        _, _, lo, hi = self._entries[name]
        s = self._data_start
        return memoryview(self._mm)[s + lo : s + hi]

    def __getitem__(self, name: str) -> np.ndarray:
        """Return the tensor as numpy; bf16 is upcast to float32."""
        dt, shape, lo, hi = self._entries[name]
        buf = self.raw(name)
        if dt == "BF16":
            raw = np.frombuffer(buf, dtype=np.uint16)
            arr = bf16_to_f32(raw)
        else:
            npdt = _DTYPES[dt]
            if npdt is None:
                raise ValueError(f"unsupported dtype {dt} for {name}")
            # copy so the mmap can be closed independently of the arrays
            arr = np.frombuffer(buf, dtype=npdt).copy()
        return arr.reshape(shape)

    def close(self):
        self._mm.close()
        self._fh.close()


def save_safetensors(path: str, tensors: Dict[str, np.ndarray], metadata=None):
    """Write a safetensors file.  bf16 payloads may be passed as
    (uint16_array, "BF16") tuples."""
    header = {}
    if metadata:
        header["__metadata__"] = metadata
    blobs = []
    offset = 0
    for name, value in tensors.items():
        if isinstance(value, tuple):
            arr, dt = value
            arr = np.ascontiguousarray(arr)
        else:
            arr = np.ascontiguousarray(value)
            if arr.dtype.name == "bfloat16":  # ml_dtypes / jax bf16
                arr = arr.view(np.uint16)
                dt = "BF16"
            else:
                dt = _INV_DTYPES[arr.dtype]
        nbytes = arr.nbytes
        header[name] = {
            "dtype": dt,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        blobs.append(arr)
        offset += nbytes
    hjson = json.dumps(header).encode()
    pad = (-(len(hjson)) % 8)
    hjson += b" " * pad
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(hjson)))
        fh.write(hjson)
        for arr in blobs:
            fh.write(arr.tobytes())
