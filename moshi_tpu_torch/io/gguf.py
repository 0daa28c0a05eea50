"""GGUF v3 reader/writer and the ggml-block <-> planar QuantTensor repacks.

Counterpart of ``moshi_tpu/io/gguf.py``; a file either package writes
from the same tree holds the same bytes, and each reads the other's.

* ``GGUFReader``: mmap-backed GGUF v3 parser (every metadata value type,
  tensor infos, alignment).  ``get`` returns a plain tensor as numpy
  (f16/bf16 widened to f32); ``get_quant(name, device)`` a quantized one
  as the port's ``QuantTensor`` on ``device``.
* ``GGUFWriter``: GGUF v3 writer, tensor names CRC-mapped.
* The repacks: ggml stores 4-bit weights byte-interleaved within
  32/256-element blocks (block_q4_0 / block_q8_0 / block_q4_K); the port's
  ``QuantTensor`` stores them planar (the low nibbles are the first half of
  the row).  ``ggml_to_quant`` / ``quant_to_ggml`` convert losslessly, as
  integer tensor operations on the device the tensors are on (the card
  while a checkpoint is loaded or written there), with the JAX package's
  numpy results bit for bit.
* ``gguf_tensor_name``: the reference's CRC renaming of names of 64
  characters or more (standard CRC-32; its hex rendering keeps only the
  low nibble of each CRC byte and zero-fills characters 4..7).

Scales: ggml stores block scales as IEEE f16, the QuantTensor as bf16.
Reading a file written elsewhere snaps each f16 scale to bf16 (nearest
even, at most 2^-9 relative); q4_k's effective per-32 scales (es/em) are
computed from the full f16 value before the snap.  Files written here
from bf16 scales round-trip exactly where f16 holds the scale (bf16 ->
f16 is exact inside f16's range).
"""

from __future__ import annotations

import mmap
import struct
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.io.safetensors import bf16_to_f32
from moshi_tpu_torch.quant.formats import QK, QK_K, QuantTensor

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32
GGML_MAX_NAME = 64

# ggml_type enum values (the subset the reference uses)
GGML_F32 = 0
GGML_F16 = 1
GGML_Q4_0 = 2
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_I8 = 24
GGML_I16 = 25
GGML_I32 = 26
GGML_I64 = 27
GGML_F64 = 28
GGML_BF16 = 30

# type -> (block size, bytes per block)
_BLOCK = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_Q4_0: (32, 18),
    GGML_Q8_0: (32, 34),
    GGML_Q4_K: (256, 144),
    GGML_I8: (1, 1),
    GGML_I16: (1, 2),
    GGML_I32: (1, 4),
    GGML_I64: (1, 8),
    GGML_F64: (1, 8),
    GGML_BF16: (1, 2),
}

_PLAIN_NP = {
    GGML_F32: np.float32,
    GGML_F16: np.float16,
    GGML_I8: np.int8,
    GGML_I16: np.int16,
    GGML_I32: np.int32,
    GGML_I64: np.int64,
    GGML_F64: np.float64,
}

_NP_TO_GGML = {
    np.dtype(np.float32): GGML_F32,
    np.dtype(np.float16): GGML_F16,
    np.dtype(np.int8): GGML_I8,
    np.dtype(np.int16): GGML_I16,
    np.dtype(np.int32): GGML_I32,
    np.dtype(np.int64): GGML_I64,
    np.dtype(np.float64): GGML_F64,
}

GGML_TYPE_OF_FMT = {"q4_0": GGML_Q4_0, "q8_0": GGML_Q8_0, "q4_k": GGML_Q4_K}
FMT_OF_GGML_TYPE = {v: k for k, v in GGML_TYPE_OF_FMT.items()}

# GGUF metadata value types
_KV_U8, _KV_I8, _KV_U16, _KV_I16 = 0, 1, 2, 3
_KV_U32, _KV_I32, _KV_F32, _KV_BOOL = 4, 5, 6, 7
_KV_STR, _KV_ARR, _KV_U64, _KV_I64, _KV_F64 = 8, 9, 10, 11, 12

_KV_SCALAR_FMT = {
    _KV_U8: "<B", _KV_I8: "<b", _KV_U16: "<H", _KV_I16: "<h",
    _KV_U32: "<I", _KV_I32: "<i", _KV_F32: "<f", _KV_U64: "<Q",
    _KV_I64: "<q", _KV_F64: "<d",
}


def gguf_tensor_name(name: str) -> str:
    """The reference's tensor name in GGUF: names shorter than
    GGML_MAX_NAME pass through; longer ones become 8 hex characters of
    their CRC-32, for i in 0..7 hex[crc_byte_i & 0xf], so characters 4..7
    are '0'."""
    if len(name) < GGML_MAX_NAME:
        return name
    crc = zlib.crc32(name.encode())
    hexd = "0123456789abcdef"
    out = []
    for _ in range(8):
        out.append(hexd[crc & 0xF])
        crc >>= 8
    return "".join(out)


# ---------------------------------------------------------------------------
# ggml block layout <-> planar QuantTensor (integer tensor operations)
# ---------------------------------------------------------------------------


def bf16_from_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 rounded to nearest even by the bit rule the JAX
    package's numpy ``f32_to_bf16_raw`` applies (u + 0x7FFF + lsb, high
    half), on x's device."""
    u = x.contiguous().view(torch.int32)
    r = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    return (r & 0xFFFF).to(torch.int16).view(torch.bfloat16)


def _f16_field(b: torch.Tensor, lo: int) -> torch.Tensor:
    """The f16 stored at bytes [lo, lo + 2) of each block of b [O, nb,
    bytes] -> f32 [O, nb]."""
    return b[:, :, lo:lo + 2].contiguous().view(torch.float16)[..., 0] \
        .float()


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """bf16 scales [O, nb] -> their f16 bytes [O, nb, 2] (nearest even)."""
    return x.float().half().contiguous().view(torch.uint8) \
        .reshape(tuple(x.shape) + (2,))


def _planar(q: torch.Tensor) -> torch.Tensor:
    """Nibbles [O, I] (uint8 0..15) -> planar bytes [O, I/2]."""
    i = q.shape[-1]
    return q[:, : i // 2] | (q[:, i // 2:] << 4)


def _unplanar(packed: torch.Tensor) -> torch.Tensor:
    """Planar bytes [O, I/2] -> nibbles [O, I]."""
    return torch.cat([packed & 15, packed >> 4], dim=-1)


def _ggml_q8_0_to_planar(b: torch.Tensor, o: int, i: int):
    nb = i // QK
    b = b.reshape(o, nb, 34)
    d = bf16_from_f32(_f16_field(b, 0))
    q = b[:, :, 2:].contiguous().view(torch.int8).reshape(o, i)
    return {"q": q, "d": d}


def _planar_q8_0_to_ggml(qt: QuantTensor) -> torch.Tensor:
    o, i = qt.shape
    nb = i // QK
    out = torch.empty((o, nb, 34), dtype=torch.uint8, device=qt.q.device)
    out[:, :, :2] = _f16_bytes(qt.d.reshape(o, nb))
    out[:, :, 2:] = qt.q.reshape(o, nb, QK).view(torch.uint8)
    return out


def _ggml_q4_0_to_planar(b: torch.Tensor, o: int, i: int):
    nb = i // QK
    b = b.reshape(o, nb, 18)
    d = bf16_from_f32(_f16_field(b, 0))
    qs = b[:, :, 2:]                  # [O, nb, 16]: lo elem j, hi elem j+16
    q = torch.cat([qs & 15, qs >> 4], dim=-1).reshape(o, i)
    return {"q": _planar(q), "d": d}


def _planar_q4_0_to_ggml(qt: QuantTensor) -> torch.Tensor:
    o, i = qt.shape
    nb = i // QK
    q = _unplanar(qt.q.reshape(o, i // 2)).reshape(o, nb, QK)
    out = torch.empty((o, nb, 18), dtype=torch.uint8, device=qt.q.device)
    out[:, :, :2] = _f16_bytes(qt.d.reshape(o, nb))
    out[:, :, 2:] = q[:, :, :16] | (q[:, :, 16:] << 4)
    return out


def _decode_k4_scales(scales: torch.Tensor):
    """12-byte q4_K scale pack -> (sc, mn) uint8 [..., 8] (llama.cpp's
    get_scale_min_k4)."""
    sc = torch.cat([scales[..., 0:4] & 63,
                    (scales[..., 8:12] & 0xF) | ((scales[..., 0:4] >> 6) << 4)],
                   dim=-1)
    mn = torch.cat([scales[..., 4:8] & 63,
                    (scales[..., 8:12] >> 4) | ((scales[..., 4:8] >> 6) << 4)],
                   dim=-1)
    return sc, mn


def _encode_k4_scales(sc: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    return torch.cat([(sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6),
                      (mn[..., :4] & 63) | ((mn[..., 4:] >> 4) << 6),
                      (sc[..., 4:] & 0xF) | ((mn[..., 4:] & 0xF) << 4)],
                     dim=-1)


def _ggml_q4_k_to_planar(b: torch.Tensor, o: int, i: int):
    nsb = i // QK_K
    b = b.reshape(o, nsb, 144)
    df = _f16_field(b, 0)
    dmf = _f16_field(b, 2)
    sc, mn = _decode_k4_scales(b[:, :, 4:16])
    qs = b[:, :, 16:144].reshape(o, nsb, 4, 32)
    # chunk c: low nibbles are elements [64c, 64c+32), high [64c+32, 64c+64)
    q = torch.cat([qs & 15, qs >> 4], dim=-1).reshape(o, i)
    # the effective per-32 scales from the full f16 super-scales
    es = (df[..., None] * sc.float()).reshape(o, i // QK)
    em = (dmf[..., None] * mn.float()).reshape(o, i // QK)
    return {"q": _planar(q), "d": bf16_from_f32(df), "sc": sc, "mn": mn,
            "dmin": bf16_from_f32(dmf), "es": bf16_from_f32(es),
            "em": bf16_from_f32(em)}


def _planar_q4_k_to_ggml(qt: QuantTensor) -> torch.Tensor:
    o, i = qt.shape
    nsb = i // QK_K
    q = _unplanar(qt.q.reshape(o, i // 2)).reshape(o, nsb, 4, 64)
    out = torch.empty((o, nsb, 144), dtype=torch.uint8, device=qt.q.device)
    out[:, :, 0:2] = _f16_bytes(qt.d.reshape(o, nsb))
    out[:, :, 2:4] = _f16_bytes(qt.dmin.reshape(o, nsb))
    out[:, :, 4:16] = _encode_k4_scales(qt.sc.reshape(o, nsb, 8),
                                        qt.mn.reshape(o, nsb, 8))
    out[:, :, 16:144] = (q[..., :32] | (q[..., 32:] << 4)).reshape(o, nsb,
                                                                   128)
    return out


_TO_PLANAR = {GGML_Q8_0: _ggml_q8_0_to_planar, GGML_Q4_0: _ggml_q4_0_to_planar,
              GGML_Q4_K: _ggml_q4_k_to_planar}


def ggml_to_quant(ggml_type: int, raw, shape: Tuple[int, int],
                  device="cuda") -> QuantTensor:
    """ggml quantized blocks (bytes, a uint8 array or tensor) -> planar
    QuantTensor [O, I] on ``device``; the repack runs there."""
    if ggml_type not in _TO_PLANAR:
        raise ValueError(f"not a supported quant ggml type: {ggml_type}")
    o, i = int(shape[0]), int(shape[1])
    dev = resolve_device(device)
    if not isinstance(raw, torch.Tensor):
        raw = torch.from_numpy(np.array(np.frombuffer(raw, np.uint8)))
    f = _TO_PLANAR[ggml_type](raw.to(dev), o, i)
    return QuantTensor(FMT_OF_GGML_TYPE[ggml_type], (o, i), **f)


def quant_to_ggml(qt: QuantTensor) -> Tuple[int, np.ndarray]:
    """Planar QuantTensor -> (ggml_type, the ggml block bytes as a uint8
    numpy array); the repack runs on the tensor's device."""
    if qt.fmt == "q8_0":
        t, out = GGML_Q8_0, _planar_q8_0_to_ggml(qt)
    elif qt.fmt == "q4_0":
        t, out = GGML_Q4_0, _planar_q4_0_to_ggml(qt)
    elif qt.fmt == "q4_k":
        t, out = GGML_Q4_K, _planar_q4_k_to_ggml(qt)
    else:
        raise ValueError(qt.fmt)
    return t, out.reshape(-1).cpu().numpy()


# ---------------------------------------------------------------------------
# GGUF v3 container
# ---------------------------------------------------------------------------


class GGUFReader:
    """mmap-backed GGUF v3 file.  Tensor shapes are exposed row-major
    (numpy order): GGUF stores dims innermost-first (ggml's ne order),
    which this class reverses."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        magic = self._read(4)
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic!r})")
        version = self._u32()
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors = self._u64()
        n_kv = self._u64()
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._string()
            self.metadata[key] = self._value(self._u32())
        # name -> (ggml_type, shape row-major, data offset)
        self._infos: Dict[str, Tuple[int, Tuple[int, ...], int]] = {}
        order: List[str] = []
        for _ in range(n_tensors):
            name = self._string()
            n_dims = self._u32()
            ne = [self._u64() for _ in range(n_dims)]
            ggml_type = self._u32()
            offset = self._u64()
            self._infos[name] = (ggml_type, tuple(reversed(ne)), offset)
            order.append(name)
        self._order = order
        self.alignment = int(self.metadata.get("general.alignment",
                                               GGUF_DEFAULT_ALIGNMENT))
        self._data_start = -self._pos % self.alignment + self._pos

    def _read(self, n: int) -> bytes:
        b = self._mm[self._pos:self._pos + n]
        self._pos += n
        return b

    def _u32(self) -> int:
        return struct.unpack("<I", self._read(4))[0]

    def _u64(self) -> int:
        return struct.unpack("<Q", self._read(8))[0]

    def _string(self) -> str:
        n = self._u64()
        return self._read(n).decode("utf-8")

    def _value(self, vtype: int):
        if vtype in _KV_SCALAR_FMT:
            fmt = _KV_SCALAR_FMT[vtype]
            return struct.unpack(fmt, self._read(struct.calcsize(fmt)))[0]
        if vtype == _KV_BOOL:
            return bool(self._read(1)[0])
        if vtype == _KV_STR:
            return self._string()
        if vtype == _KV_ARR:
            etype = self._u32()
            n = self._u64()
            return [self._value(etype) for _ in range(n)]
        raise ValueError(f"unknown GGUF kv type {vtype}")

    def keys(self):
        return list(self._order)

    def __contains__(self, name: str) -> bool:
        return name in self._infos

    def ggml_type(self, name: str) -> int:
        return self._infos[name][0]

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._infos[name][1]

    def nbytes(self, name: str) -> int:
        t, shape, _ = self._infos[name]
        block, bpb = _BLOCK[t]
        n = int(np.prod(shape)) if shape else 1
        assert n % block == 0, (name, shape, t)
        return n // block * bpb

    def raw(self, name: str) -> np.ndarray:
        """The tensor's bytes, a read-only uint8 view into the mapping."""
        _, _, off = self._infos[name]
        return np.frombuffer(self._mm, np.uint8, self.nbytes(name),
                             self._data_start + off)

    def is_quantized(self, name: str) -> bool:
        return self._infos[name][0] in FMT_OF_GGML_TYPE

    def get(self, name: str) -> np.ndarray:
        """A plain tensor as numpy (f16/bf16 widened to f32)."""
        t, shape, _ = self._infos[name]
        raw = self.raw(name)
        if t == GGML_BF16:
            return bf16_to_f32(raw.view(np.uint16)).reshape(shape)
        if t == GGML_F16:
            return raw.view(np.float16).astype(np.float32).reshape(shape)
        if t in _PLAIN_NP:
            return raw.view(_PLAIN_NP[t]).reshape(shape).copy()
        raise ValueError(f"{name}: quantized ({t}); use get_quant()")

    def get_quant(self, name: str, device="cuda") -> QuantTensor:
        """A quantized tensor as a planar QuantTensor on ``device``: its
        bytes are copied there and repacked there."""
        t, shape, _ = self._infos[name]
        assert len(shape) == 2, (name, shape)
        raw = torch.from_numpy(np.array(self.raw(name)))
        return ggml_to_quant(t, raw, shape, device=device)

    def close(self):
        self._mm.close()
        self._fh.close()


class GGUFWriter:
    """GGUF v3 writer (tensor names CRC-mapped as the reference's, so its
    load_gguf resolves them)."""

    def __init__(self):
        self._kv: List[Tuple[str, int, Any]] = []
        self._tensors: List[Tuple[str, Tuple[int, ...], int, np.ndarray]] = []
        self.alignment = GGUF_DEFAULT_ALIGNMENT

    def add_kv(self, key: str, value: Any):
        if isinstance(value, bool):
            self._kv.append((key, _KV_BOOL, value))
        elif isinstance(value, int):
            self._kv.append((key, _KV_I64 if value < 0 else _KV_U64, value))
        elif isinstance(value, float):
            self._kv.append((key, _KV_F64, value))
        elif isinstance(value, str):
            self._kv.append((key, _KV_STR, value))
        elif isinstance(value, (list, tuple)):
            self._kv.append((key, _KV_ARR, list(value)))
        else:
            raise TypeError(f"unsupported kv value for {key}: {type(value)}")

    def add_tensor(self, name: str, value) -> str:
        """value: a QuantTensor, a tensor (bf16 is stored BF16) or a numpy
        array (f32/f16/ints).  Returns the (possibly CRC-mapped) stored
        name."""
        stored = gguf_tensor_name(name)
        if isinstance(value, QuantTensor):
            ggml_type, raw = quant_to_ggml(value)
            shape = tuple(value.shape)
        else:
            if isinstance(value, torch.Tensor):
                t = value.detach().contiguous().cpu()
                arr = (t.view(torch.int16).numpy().view(np.uint16)
                       if t.dtype == torch.bfloat16 else t.numpy())
                ggml_type = (GGML_BF16 if t.dtype == torch.bfloat16
                             else _NP_TO_GGML[arr.dtype])
            else:
                arr = np.ascontiguousarray(value)
                ggml_type = _NP_TO_GGML[arr.dtype]
            shape = tuple(arr.shape)
            raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        self._tensors.append((stored, shape, ggml_type, raw))
        return stored

    def write(self, path: str):
        def pstr(s: str) -> bytes:
            b = s.encode("utf-8")
            return struct.pack("<Q", len(b)) + b

        def pval(vtype: int, v) -> bytes:
            if vtype in _KV_SCALAR_FMT:
                return struct.pack(_KV_SCALAR_FMT[vtype], v)
            if vtype == _KV_BOOL:
                return struct.pack("<B", 1 if v else 0)
            if vtype == _KV_STR:
                return pstr(v)
            if vtype == _KV_ARR:
                if not v:
                    return struct.pack("<IQ", _KV_I64, 0)
                e = v[0]
                if isinstance(e, bool):
                    et = _KV_BOOL
                elif isinstance(e, int):
                    et = _KV_I64
                elif isinstance(e, float):
                    et = _KV_F64
                elif isinstance(e, str):
                    et = _KV_STR
                else:
                    raise TypeError(type(e))
                return (struct.pack("<I", et) + struct.pack("<Q", len(v))
                        + b"".join(pval(et, x) for x in v))
            raise ValueError(vtype)

        kvs = list(self._kv)
        if not any(k == "general.alignment" for k, _, _ in kvs):
            kvs.insert(0, ("general.alignment", _KV_U32, self.alignment))

        header = bytearray()
        header += GGUF_MAGIC
        header += struct.pack("<I", GGUF_VERSION)
        header += struct.pack("<Q", len(self._tensors))
        header += struct.pack("<Q", len(kvs))
        for key, vtype, v in kvs:
            header += pstr(key)
            header += struct.pack("<I", vtype)
            header += pval(vtype, v)
        offset = 0
        a = self.alignment
        for name, shape, ggml_type, raw in self._tensors:
            header += pstr(name)
            ne = tuple(reversed(shape))
            header += struct.pack("<I", len(ne))
            for d in ne:
                header += struct.pack("<Q", d)
            header += struct.pack("<I", ggml_type)
            header += struct.pack("<Q", offset)
            offset += raw.size + (-raw.size % a)
        header += b"\0" * (-len(header) % a)
        with open(path, "wb") as fh:
            fh.write(header)
            for _, _, _, raw in self._tensors:
                fh.write(raw.data)
                fh.write(b"\0" * (-raw.size % a))
