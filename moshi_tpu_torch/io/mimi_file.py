""".mimi token file format, byte-compatible with the reference and with
``moshi_tpu/io/mimi_file.py``.

Format (the reference's tools/mimi-encode.cpp writer and the mimi-decode
/ mimi-play readers): ``b"MIMI"`` magic, then a uint32 ``n_q``, then
int16 codes, frame-major ([T, n_q], one row per frame).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"MIMI"


def write_mimi_file(path: str, codes: np.ndarray):
    """codes: int array [T, n_q]."""
    codes = np.asarray(codes)
    assert codes.ndim == 2, "codes must be [frames, n_q]"
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<I", codes.shape[1]))
        fh.write(codes.astype("<i2").tobytes())


def read_mimi_file(path: str) -> np.ndarray:
    """Returns int16 codes [T, n_q]."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a .mimi file")
        (n_q,) = struct.unpack("<I", fh.read(4))
        body = fh.read()
    codes = np.frombuffer(body, dtype="<i2")
    t = len(codes) // n_q
    return codes[: t * n_q].reshape(t, n_q).copy()
