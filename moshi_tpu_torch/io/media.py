"""Media-container audio I/O: the reference's common_av.h capability.

A copy of ``moshi_tpu/io/media.py`` (numpy and the standard library; the
same arithmetic, so the same samples).  The reference decodes and encodes
containers through the FFmpeg libraries and resamples with swresample
(tools/common_av.h).  Here the capability is layered:

  * native decoders: WAV (``io/wav.py``), AIFF/AIFC and AU/SND (the
    standard library's codecs);
  * everything else (mp3/ogg/flac/mp4/...) is decoded and encoded through
    an ``ffmpeg`` binary subprocess when one is on PATH, and raises when
    none is;
  * a windowed-sinc polyphase resampler (``resample_sinc``), the quality
    analog of swresample's default.

All decode paths return mono float32 in [-1, 1] at the requested rate.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from moshi_tpu_torch.io.wav import load_wav, save_wav

_FFMPEG = shutil.which("ffmpeg")

_NATIVE_EXTS = (".wav", ".wave", ".aiff", ".aif", ".aifc", ".au", ".snd")


def have_ffmpeg() -> bool:
    return _FFMPEG is not None


# ---------------------------------------------------------------------------
# windowed-sinc polyphase resampler
# ---------------------------------------------------------------------------


def resample_sinc(x: np.ndarray, src_rate: int, dst_rate: int,
                  taps: int = 32) -> np.ndarray:
    """Rational-ratio polyphase resampling with a Hann-windowed sinc
    anti-aliasing filter (cutoff at the lower Nyquist), `taps` zero
    crossings per side at the lower rate."""
    if src_rate == dst_rate:
        return np.asarray(x, np.float32)
    x = np.asarray(x, np.float64).reshape(-1)
    g = int(np.gcd(src_rate, dst_rate))
    up, down = dst_rate // g, src_rate // g
    # output sample n sits at input time t_n = n * down / up
    n_out = int(len(x) * up) // down
    n_idx = np.arange(n_out, dtype=np.int64)
    t = n_idx * down / up                         # fractional input index
    cutoff = min(1.0, up / down)                  # relative to src nyquist
    half = int(np.ceil(taps / cutoff))
    base = np.floor(t).astype(np.int64)
    frac = t - base
    # window of input samples around each output time: base - half + 1 ..
    # base + half  (gathered with edge padding)
    k = np.arange(-half + 1, half + 1, dtype=np.int64)     # [2*half]
    idx = np.clip(base[:, None] + k[None, :], 0, len(x) - 1)
    dt = (k[None, :] - frac[:, None]) * cutoff             # [n_out, 2half]
    sinc = np.sinc(dt)
    win = 0.5 * (1.0 + np.cos(np.pi * dt / (half * cutoff)))
    win = np.where(np.abs(dt) < half * cutoff, win, 0.0)
    h = sinc * win * cutoff
    y = np.einsum("nk,nk->n", h, x[idx])
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _load_aiff(path: str) -> Tuple[np.ndarray, int]:
    import aifc
    with aifc.open(path, "rb") as f:
        ch, sw, rate, n = (f.getnchannels(), f.getsampwidth(),
                           f.getframerate(), f.getnframes())
        raw = f.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.int8).astype(np.float32)) / 128.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype=">i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported AIFF sample width {sw}")
    if ch > 1:
        x = x[: len(x) // ch * ch].reshape(-1, ch).mean(axis=1)
    return x, int(rate)


def _load_au(path: str) -> Tuple[np.ndarray, int]:
    import sunau
    with sunau.open(path, "rb") as f:
        ch, sw, rate, n = (f.getnchannels(), f.getsampwidth(),
                           f.getframerate(), f.getnframes())
        raw = f.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"{path}: unsupported AU sample width {sw}")
    if ch > 1:
        x = x[: len(x) // ch * ch].reshape(-1, ch).mean(axis=1)
    return x, int(rate)


def _ffmpeg_decode(path: str, rate: Optional[int]) -> Tuple[np.ndarray, int]:
    if _FFMPEG is None:
        raise RuntimeError(
            f"cannot decode {path!r}: no native decoder for this format "
            "and no `ffmpeg` binary on PATH (the reference links FFmpeg "
            "for the same capability, common_av.h)")
    out_rate = rate or 24_000
    cmd = [_FFMPEG, "-nostdin", "-v", "error", "-i", path,
           "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1",
           "-ar", str(out_rate), "pipe:1"]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
    if res.returncode != 0:
        raise RuntimeError(f"ffmpeg decode failed for {path!r}: "
                           f"{res.stderr.decode(errors='replace')[:500]}")
    return np.frombuffer(res.stdout, dtype="<f4").copy(), out_rate


def load_audio(path: str, rate: Optional[int] = None,
               resampler: str = "sinc") -> Tuple[np.ndarray, int]:
    """Decode any supported audio file to mono float32; resample to
    `rate` when given.  Returns (samples, sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave"):
        x, src = load_wav(path)
    elif ext in (".aiff", ".aif", ".aifc"):
        x, src = _load_aiff(path)
    elif ext in (".au", ".snd"):
        x, src = _load_au(path)
    else:
        return _ffmpeg_decode(path, rate)
    if rate and src != rate:
        if resampler == "sinc":
            x = resample_sinc(x, src, rate)
        else:
            from moshi_tpu_torch.io.wav import resample_linear
            x = resample_linear(x, src, rate)
        src = rate
    return x.astype(np.float32), src


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def save_audio(path: str, samples: np.ndarray, rate: int = 24_000):
    """Encode mono audio: WAV natively, any other container/codec through
    ffmpeg (format inferred from the extension, like common_av.h's
    guess-format encoder)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave", ""):
        save_wav(path, samples, rate)
        return
    if _FFMPEG is None:
        raise RuntimeError(
            f"cannot encode {path!r}: non-WAV output needs an `ffmpeg` "
            "binary on PATH")
    x = np.asarray(samples, np.float32).reshape(-1)
    cmd = [_FFMPEG, "-nostdin", "-v", "error", "-y",
           "-f", "f32le", "-ar", str(rate), "-ac", "1", "-i", "pipe:0",
           path]
    res = subprocess.run(cmd, input=x.tobytes(), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
    if res.returncode != 0:
        raise RuntimeError(f"ffmpeg encode failed for {path!r}: "
                           f"{res.stderr.decode(errors='replace')[:500]}")
