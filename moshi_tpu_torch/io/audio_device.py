"""Live audio device backends: the reference's SDL capture/playback
layer.

A copy of ``moshi_tpu/io/audio_device.py`` (host code, no model) with
three of its faults fixed (ROADMAP C): ``run_device_loop`` closes the
capture stream only once its thread has ended, ``DeviceSink`` takes the
latency stamp before the blocking device write, and an xrun that ALSA
recovers from is retried a bounded number of times and then read as
silence instead of ending the session.

The reference's realtime tools open microphone and speaker streams
through SDL (tools/common_sdl.h: SDL_OpenAudioDevice for capture and
playback at the model rate, feeding the frame FIFO from the device
callbacks).  ``io/driver.py`` carries the FIFO, pacing and latency-budget
structure; this module supplies the hardware edge as pluggable backends
behind one small stream interface:

  * ``sounddevice`` (PortAudio) when the package is importable;
  * ALSA directly over ctypes (``libasound.so.2``, no Python package
    needed), using the simple ``snd_pcm_set_params`` blocking API;
  * any registered object implementing the same two methods (tests use
    a fake; a deployment can register an SDL or Jack shim the same way).

Frames are float32 mono at the model rate (24 kHz, 1920 samples = 80 ms
per frame).  The ALSA backend prefers FLOAT_LE and falls back to S16_LE
with conversion (the format every device supports).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, Dict, Optional

import numpy as np

from moshi_tpu_torch.io.driver import (FRAME_SAMPLES, CaptureDriver,
                                       FrameFIFO, PlaybackSink)

SAMPLERATE = 24000

# ---------------------------------------------------------------------------
# stream interface
# ---------------------------------------------------------------------------


class CaptureStream:
    """Blocking mono capture: ``read(n) -> float32[n]`` (None = ended)."""

    def read(self, frame_samples: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self):
        pass


class PlaybackStream:
    """Blocking mono playback: ``write(float32[n])``."""

    def write(self, frame: np.ndarray):
        raise NotImplementedError

    def close(self):
        pass


# ---------------------------------------------------------------------------
# sounddevice backend (PortAudio)
# ---------------------------------------------------------------------------


class _SdCapture(CaptureStream):
    def __init__(self, sd, samplerate):
        self._s = sd.InputStream(samplerate=samplerate, channels=1,
                                 dtype="float32")
        self._s.start()

    def read(self, n):
        data, _overflowed = self._s.read(n)
        return np.asarray(data, np.float32).reshape(-1)

    def close(self):
        self._s.stop()
        self._s.close()


class _SdPlayback(PlaybackStream):
    def __init__(self, sd, samplerate):
        self._s = sd.OutputStream(samplerate=samplerate, channels=1,
                                  dtype="float32")
        self._s.start()

    def write(self, frame):
        self._s.write(np.ascontiguousarray(frame, np.float32)
                      .reshape(-1, 1))

    def close(self):
        self._s.stop()
        self._s.close()


class SounddeviceBackend:
    name = "sounddevice"

    def __init__(self):
        import sounddevice as sd   # raises if absent
        self._sd = sd

    def open_capture(self, samplerate=SAMPLERATE):
        return _SdCapture(self._sd, samplerate)

    def open_playback(self, samplerate=SAMPLERATE):
        return _SdPlayback(self._sd, samplerate)


# ---------------------------------------------------------------------------
# ALSA backend (ctypes over libasound — no Python audio package needed)
# ---------------------------------------------------------------------------

_SND_PCM_STREAM_PLAYBACK = 0
_SND_PCM_STREAM_CAPTURE = 1
_SND_PCM_FORMAT_S16_LE = 2
_SND_PCM_FORMAT_FLOAT_LE = 14
_SND_PCM_ACCESS_RW_INTERLEAVED = 3
# recoverable errors (xruns) retried per read or write before the frame's
# missing samples are taken as silence
XRUN_RETRIES = 3
# seconds the live loop waits for its capture thread (a blocked read
# returns within one frame period) before it leaves the stream open
CAPTURE_JOIN_S = 2.0


def _load_alsa():
    lib = ctypes.CDLL("libasound.so.2")
    lib.snd_pcm_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int]
    lib.snd_pcm_open.restype = ctypes.c_int
    lib.snd_pcm_set_params.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_uint,
                                       ctypes.c_uint, ctypes.c_int,
                                       ctypes.c_uint]
    lib.snd_pcm_set_params.restype = ctypes.c_int
    for fn in ("snd_pcm_readi", "snd_pcm_writei"):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulong]
        f.restype = ctypes.c_long
    lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.snd_pcm_recover.restype = ctypes.c_int
    lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
    lib.snd_pcm_close.restype = ctypes.c_int
    return lib


class _AlsaPcm:
    """One ALSA PCM handle (capture or playback), FLOAT_LE with S16_LE
    fallback, 200 ms device buffer (~2.5 frames, the SDL depth)."""

    def __init__(self, lib, device: str, stream: int,
                 samplerate: int):
        self._lib = lib
        self._pcm = ctypes.c_void_p()
        err = lib.snd_pcm_open(ctypes.byref(self._pcm),
                               device.encode(), stream, 0)
        if err < 0:
            raise RuntimeError(f"snd_pcm_open({device!r}) failed: {err}")
        self.fmt = _SND_PCM_FORMAT_FLOAT_LE
        err = lib.snd_pcm_set_params(
            self._pcm, self.fmt, _SND_PCM_ACCESS_RW_INTERLEAVED, 1,
            samplerate, 1, 200_000)
        if err < 0:
            self.fmt = _SND_PCM_FORMAT_S16_LE
            err = lib.snd_pcm_set_params(
                self._pcm, self.fmt, _SND_PCM_ACCESS_RW_INTERLEAVED, 1,
                samplerate, 1, 200_000)
        if err < 0:
            lib.snd_pcm_close(self._pcm)
            raise RuntimeError(f"snd_pcm_set_params failed: {err}")

    def _io(self, fn, buf, frames: int) -> Optional[int]:
        """One readi/writei of up to ``frames`` frames: the frames moved,
        or a negative code once the PCM is closed or an error is not
        recoverable (``snd_pcm_recover`` fails).  An error it recovers
        from (an xrun) is retried, up to ``XRUN_RETRIES`` times; after
        that None: the device recovers but moves nothing, and the caller
        goes on without this frame's samples."""
        for _ in range(XRUN_RETRIES + 1):
            if self._pcm is None:
                return -1                  # closed from another thread
            n = fn(self._pcm, buf.ctypes.data_as(ctypes.c_void_p),
                   ctypes.c_ulong(frames))
            if n >= 0:
                return int(n)
            if self._pcm is None or \
                    self._lib.snd_pcm_recover(self._pcm, int(n), 1) < 0:
                return int(n)              # not recoverable: stream dead
        return None

    def close(self):
        if self._pcm:
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = None


class _AlsaCapture(_AlsaPcm, CaptureStream):
    def read(self, n):
        """Loop readi to a FULL frame: a short read (legitimate after an
        xrun recover) must not be zero-stuffed downstream — that would
        shift the audio timeline by the missing samples."""
        dt = (np.float32 if self.fmt == _SND_PCM_FORMAT_FLOAT_LE
              else np.int16)
        buf = np.empty(n, dt)
        pos = 0
        while pos < n:
            if self._pcm is None:
                return None                      # closed mid-session
            got = self._io(self._lib.snd_pcm_readi, buf[pos:], n - pos)
            if got is None:                      # xruns past the retries:
                buf[pos:] = 0                    # the rest of the frame is
                break                            # silence, the stream lives
            if got <= 0:
                return None                      # stream ended / dead
            pos += got
        if dt is np.float32:
            return buf
        return buf.astype(np.float32) / 32768.0


class _AlsaPlayback(_AlsaPcm, PlaybackStream):
    def write(self, frame):
        if self.fmt == _SND_PCM_FORMAT_FLOAT_LE:
            buf = np.ascontiguousarray(frame, np.float32)
        else:
            buf = (np.clip(frame, -1.0, 1.0)
                   * 32767.0).astype(np.int16)
        pos = 0
        while pos < len(buf):                    # flush partial writes
            if self._pcm is None:
                return
            put = self._io(self._lib.snd_pcm_writei, buf[pos:],
                           len(buf) - pos)
            if put is None or put <= 0:
                return                           # drop the rest
            pos += put


class AlsaBackend:
    name = "alsa"

    def __init__(self, device: str = "default"):
        self._lib = _load_alsa()   # raises OSError if libasound absent
        self._device = device

    def open_capture(self, samplerate=SAMPLERATE):
        return _AlsaCapture(self._lib, self._device,
                            _SND_PCM_STREAM_CAPTURE, samplerate)

    def open_playback(self, samplerate=SAMPLERATE):
        return _AlsaPlayback(self._lib, self._device,
                             _SND_PCM_STREAM_PLAYBACK, samplerate)


# ---------------------------------------------------------------------------
# registry / resolution
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], object]] = {
    "sounddevice": SounddeviceBackend,
    "alsa": AlsaBackend,
}


def register_backend(name: str, factory: Callable[[], object]):
    """Register an extra backend factory (tests register fakes; a
    deployment can register an SDL/Jack shim)."""
    _REGISTRY[name] = factory


def _probe(backend):
    """A backend is usable only if a capture stream actually OPENS —
    constructing AlsaBackend merely dlopens libasound, which succeeds on
    any Linux with the userspace installed but no sound device."""
    cap = backend.open_capture()
    cap.close()
    return backend


def available_backends():
    out = []
    for name, factory in _REGISTRY.items():
        try:
            _probe(factory())
        except Exception:
            continue
        out.append(name)
    return out


def resolve_backend(name: Optional[str] = None):
    """Return a constructed backend.  ``name=None`` probes each in
    registration order (construct + open a capture stream) and returns
    the first that works; a specific name must construct or the error
    propagates (so a user asking for --device alsa sees the real
    reason)."""
    if name is not None:
        if name not in _REGISTRY:
            raise RuntimeError(
                f"unknown audio backend {name!r}; registered: "
                + ", ".join(sorted(_REGISTRY)))
        return _REGISTRY[name]()
    errors = []
    for n, factory in _REGISTRY.items():
        try:
            return _probe(factory())
        except Exception as e:    # noqa: BLE001 — collect per-backend cause
            errors.append(f"{n}: {type(e).__name__}: {e}")
    raise RuntimeError(
        "no live audio backend available — install `sounddevice` or an "
        "ALSA userspace (libasound.so.2), or register_backend() a shim. "
        "Causes: " + "; ".join(errors))


# ---------------------------------------------------------------------------
# glue: device streams <-> the frame-FIFO driver
# ---------------------------------------------------------------------------


def device_capture_source(stream: CaptureStream,
                          frame_samples: int = FRAME_SAMPLES):
    """Adapt a CaptureStream into a ``CaptureDriver`` source.  The
    device's blocking read paces the producer, so drive it with
    ``pace=0`` (common_sdl.h's capture callback arrives at the hardware
    rate the same way)."""

    def src(_i):
        return stream.read(frame_samples)

    return src


class DeviceSink(PlaybackSink):
    """PlaybackSink that also writes each frame to a live device."""

    def __init__(self, stream: PlaybackStream, **kw):
        super().__init__(**kw)
        self._stream = stream

    def submit(self, frame, capture_stamp):
        # the latency is stamped before the blocking write: it measures
        # capture to computed frame, which the 80 ms budget is about,
        # and leaves out the device buffer's backpressure
        super().submit(frame, capture_stamp)
        self._stream.write(frame)


def _duplex(backend, samplerate: int):
    """(capture, playback) streams on ``backend``; the capture stream is
    closed again when the playback stream fails to open."""
    cap = backend.open_capture(samplerate)
    try:
        play = backend.open_playback(samplerate)
    except Exception:
        cap.close()
        raise
    return cap, play


def open_duplex(name: Optional[str] = None, samplerate: int = SAMPLERATE):
    """(capture, playback) streams on one resolved backend: the
    mimi-echo / moshi-sts device pair."""
    return _duplex(resolve_backend(name), samplerate)


def run_device_loop(step, name: Optional[str] = None, max_frames: int = 0,
                    frame_samples: int = FRAME_SAMPLES,
                    fifo_depth: int = 3) -> dict:
    """The full live loop: device capture -> FrameFIFO -> per-frame
    ``step`` -> device playback, with the driver's drop/latency
    accounting (the reference's mimi-echo.cpp main loop over common_sdl.h
    streams).  Returns the realtime report, with the resolved backend's
    ``name`` under "backend" and "capture_closed": False when the capture
    thread was still inside a device read ``CAPTURE_JOIN_S`` seconds after
    the loop ended, whose stream is then left open."""
    from moshi_tpu_torch.io.driver import realtime_loop

    backend = resolve_backend(name)
    cap, play = _duplex(backend, SAMPLERATE)
    fifo = FrameFIFO(frame_samples, depth=fifo_depth)
    sink = DeviceSink(play, keep_audio=False)
    drv = CaptureDriver(device_capture_source(cap, frame_samples), fifo,
                        pace=0)
    drv.start()
    try:
        rep = realtime_loop(fifo, step, sink, max_frames=max_frames)
    finally:
        # closing the FIFO stops the capture thread at its next loop
        # check; JOIN it (a blocked device read returns within one frame
        # period) BEFORE closing the capture stream: closing a PCM under
        # a read blocked in another thread is undefined in libasound, so
        # a thread still alive after the join keeps its stream open
        fifo.close()
        drv.join(CAPTURE_JOIN_S)
        closed = not drv.is_alive()
        if closed:
            cap.close()
        else:
            print(f"audio device: the capture thread is still in a device "
                  f"read {CAPTURE_JOIN_S:g} s after the loop ended; its "
                  f"stream is left open", file=sys.stderr, flush=True)
        play.close()
    rep["backend"] = getattr(backend, "name", name)
    rep["capture_closed"] = closed
    return rep
