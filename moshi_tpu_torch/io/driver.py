"""Async audio frame-FIFO driver: the reference's common_sdl.h frame
loop.

A copy of ``moshi_tpu/io/driver.py`` (host code, no model).  The
reference's realtime tools (mimi-echo, moshi-sts, moshi-tts interactive)
are built on a lock/condvar FIFO of recycled audio frames fed by SDL
capture/playback callbacks, 3 frames deep (tools/common_sdl.h).  The loop
structure (an asynchronous producer pacing frames at the hardware rate, a
consumer compute loop that must keep up, frame-drop and latency
accounting) is kept here with file and synthetic sources, and with the
live device streams of ``io/audio_device.py``.  Simulation can run faster
than realtime (``pace`` < frame duration) to stress the budget without
waiting wall clock.

Frames are recycled numpy buffers (no per-frame allocation in the steady
state, like common_sdl.h's free-list); the compute loop stays
single-threaded (the card's work is serialized anyway), and the producer
and consumer threads only move host buffers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

FRAME_SAMPLES = 1920          # 80 ms at 24 kHz
FRAME_SECONDS = 0.08


class FrameFIFO:
    """Bounded FIFO of recycled audio frames (common_sdl.h:17-110).

    Producers take a free buffer (``get_free``), fill it, and ``push``;
    consumers ``pop`` a filled frame and ``recycle`` it when done.  When
    the FIFO is full the OLDEST filled frame is dropped and counted —
    the reference's capture callback does the same by overwriting the
    ring (a realtime capture source cannot block).
    """

    def __init__(self, frame_samples: int = FRAME_SAMPLES,
                 depth: int = 3, dtype=np.float32):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._frame_samples = frame_samples
        self._dtype = dtype
        self._free = [np.zeros(frame_samples, dtype) for _ in range(depth)]
        self._filled: deque = deque()
        self.depth = depth
        self.drops = 0
        self._closed = False

    def get_free(self) -> np.ndarray:
        with self._lock:
            if self._free:
                return self._free.pop()
            # full: drop the oldest filled frame and recycle its buffer
            if self._filled:
                self.drops += 1
                return self._filled.popleft()[1]
        # all buffers checked out by the consumer; allocate (rare)
        return np.zeros(self._frame_samples, self._dtype)

    def push(self, frame: np.ndarray, stamp: Optional[float] = None):
        with self._cond:
            self._filled.append((time.perf_counter() if stamp is None
                                 else stamp, frame))
            self._cond.notify()

    def pop(self, timeout: Optional[float] = None):
        """-> (stamp, frame) or None on timeout/close."""
        with self._cond:
            deadline = (None if timeout is None
                        else time.perf_counter() + timeout)
            while not self._filled and not self._closed:
                rem = (None if deadline is None
                       else deadline - time.perf_counter())
                if rem is not None and rem <= 0:
                    return None
                self._cond.wait(rem)
            if self._filled:
                return self._filled.popleft()
            return None

    def recycle(self, frame: np.ndarray):
        with self._lock:
            self._free.append(frame)

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self):
        return self._closed


class CaptureDriver:
    """Paced frame producer thread (the SDL capture callback analog).

    ``source(i) -> np.ndarray | None`` supplies frame ``i`` (None ends
    the stream); frames are pushed into the FIFO every ``pace`` seconds
    (wall clock).  pace < FRAME_SECONDS simulates faster-than-realtime;
    pace=0 produces as fast as the consumer drains (throughput mode).
    """

    def __init__(self, source: Callable[[int], Optional[np.ndarray]],
                 fifo: FrameFIFO, pace: float = FRAME_SECONDS):
        self.source = source
        self.fifo = fifo
        self.pace = pace
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        i = 0
        nxt = time.perf_counter()
        while not self.fifo.closed:
            data = self.source(i)
            if data is None:
                self.fifo.close()
                return
            buf = self.fifo.get_free()
            n = min(len(buf), len(data))
            buf[:n] = data[:n]
            buf[n:] = 0
            self.fifo.push(buf)
            i += 1
            if self.pace:
                nxt += self.pace
                delay = nxt - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)

    def join(self, timeout=None):
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        """Whether the producer thread is still running (after a ``join``
        that timed out: still inside ``source``)."""
        return self._thread.is_alive()


def file_source(audio: np.ndarray, frame_samples: int = FRAME_SAMPLES,
                loop: bool = False):
    """Frame source over a loaded audio array (file backend)."""
    n = len(audio) // frame_samples

    def src(i):
        if n == 0:
            return None
        if i >= n:
            if not loop:
                return None
            i = i % n
        return audio[i * frame_samples:(i + 1) * frame_samples]
    return src


def synthetic_source(frame_samples: int = FRAME_SAMPLES, frames: int = 0,
                     amplitude: float = 0.01, seed: int = 0):
    """Dithered-silence source (synthetic backend).  Frames are DISTINCT
    buffers, so that no runtime can reuse one frame's result for
    another."""
    rng = np.random.default_rng(seed)

    def src(i):
        if frames and i >= frames:
            return None
        return (rng.standard_normal(frame_samples) * amplitude
                ).astype(np.float32)
    return src


@dataclass
class PlaybackSink:
    """Playback-side accounting (the SDL playback callback analog).

    Every ``submit`` is stamped; a frame is LATE when it arrives more
    than ``budget`` seconds after its stream deadline (capture stamp +
    budget = the 80 ms frame budget).  Optionally
    accumulates audio for writing out in file mode.
    """
    budget: float = FRAME_SECONDS
    keep_audio: bool = True
    frames: int = 0
    late: int = 0
    latencies: list = field(default_factory=list)
    chunks: list = field(default_factory=list)

    def submit(self, frame: np.ndarray, capture_stamp: float):
        now = time.perf_counter()
        lat = now - capture_stamp
        self.latencies.append(lat)
        self.frames += 1
        if lat > self.budget:
            self.late += 1
        if self.keep_audio:
            self.chunks.append(np.array(frame, copy=True))

    def audio(self) -> np.ndarray:
        return (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, np.float32))

    def report(self) -> dict:
        lat = np.asarray(self.latencies) if self.latencies else np.zeros(1)
        return {
            "frames": self.frames,
            "late": self.late,
            "drops_are_reported_by_fifo": True,
            "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
            "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
            "budget_ms": round(self.budget * 1e3, 1),
        }


def realtime_loop(fifo: FrameFIFO, step: Callable[[np.ndarray], np.ndarray],
                  sink: PlaybackSink, max_frames: int = 0,
                  timeout: float = 5.0) -> dict:
    """The realtime consumer loop (the reference's moshi-sts.cpp main loop):
    pop a captured frame, run the per-frame compute, submit the result.
    Returns the sink report + FIFO drop count + sustained fps."""
    n = 0
    t0 = None
    while not max_frames or n < max_frames:
        item = fifo.pop(timeout)
        if item is None:
            break
        stamp, frame = item
        out = step(frame)
        fifo.recycle(frame)
        sink.submit(out, stamp)
        if t0 is None:
            t0 = time.perf_counter()    # frame 0 excluded (compile)
            n0 = sink.frames
        n += 1
    rep = sink.report()
    rep["capture_drops"] = fifo.drops
    if t0 is not None and sink.frames - n0 > 0:
        dt = time.perf_counter() - t0
        rep["sustained_fps"] = round((sink.frames - n0) / dt, 2)
    return rep
