"""Minimal WAV I/O: 16-bit, 32-bit and f32 PCM read, 16-bit mono write.

A copy of ``moshi_tpu/io/wav.py`` (numpy only, byte for byte the same
output): the reference's mono 16-bit PCM read and write (src/wav.h),
with multi-channel and float32 input files downmixed to mono.
"""

from __future__ import annotations

import struct

import numpy as np


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (samples float32 in [-1,1] mono [T], sample_rate)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            audio_fmt, channels, rate = struct.unpack_from("<HHI", body, 0)
            bits = struct.unpack_from("<H", body, 14)[0]
            fmt = (audio_fmt, channels, rate, bits)
        elif cid == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, rate, bits = fmt
    if audio_fmt == 1 and bits == 16:
        x = np.frombuffer(samples, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt == 1 and bits == 32:
        x = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_fmt == 3 and bits == 32:
        x = np.frombuffer(samples, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}/{bits}bit")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).mean(axis=1)
    return x, rate


def save_wav(path: str, samples: np.ndarray, sample_rate: int = 24_000):
    """Write mono 16-bit PCM."""
    x = np.asarray(samples, dtype=np.float32).reshape(-1)
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as fh:
        fh.write(b"RIFF")
        fh.write(struct.pack("<I", 36 + len(data)))
        fh.write(b"WAVE")
        fh.write(b"fmt ")
        fh.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                             sample_rate * 2, 2, 16))
        fh.write(b"data")
        fh.write(struct.pack("<I", len(data)))
        fh.write(data)


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Simple linear resampler (``io/media.py`` ``resample_sinc`` is the
    tools' default)."""
    if src_rate == dst_rate:
        return x
    n_out = int(round(len(x) * dst_rate / src_rate))
    t = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    i0 = np.minimum(t.astype(np.int64), len(x) - 1)
    i1 = np.minimum(i0 + 1, len(x) - 1)
    frac = (t - i0).astype(np.float32)
    return (x[i0] * (1 - frac) + x[i1] * frac).astype(np.float32)
