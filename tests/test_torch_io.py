"""The port's host-side ``io`` modules against the JAX package's: WAV,
.mimi token files, the media decoders and the sinc resampler give the
same bytes and the same samples (both are the same numpy arithmetic, so
every comparison is exact); the frame-FIFO driver and the live audio
device layer run the JAX tests' cases against the port's copies, through
a fake libasound and registered fake backends; and the three faults of
the reference's ``audio_device.py`` that the port fixes are each shown:
a capture thread still in a device read after the join keeps its stream
open, the latency stamp leaves out the blocking device write, and an
xrun that ALSA recovers from is retried and then read as silence."""

import ctypes
import struct
import sys
import threading
import time

import numpy as np
import pytest

from moshi_tpu.io import audio_device as jax_ad
from moshi_tpu.io import media as jax_media
from moshi_tpu.io import mimi_file as jax_mimi_file
from moshi_tpu.io import wav as jax_wav

from moshi_tpu_torch.io import audio_device as ad
from moshi_tpu_torch.io import media, mimi_file, wav
from moshi_tpu_torch.io.driver import (FRAME_SAMPLES, CaptureDriver,
                                       FrameFIFO, PlaybackSink, file_source,
                                       realtime_loop, synthetic_source)


def _write_wav(path, data: bytes, audio_fmt: int, channels: int, rate: int,
               bits: int):
    """A RIFF/WAVE file of raw ``data`` in any PCM layout, with an extra
    odd-sized chunk before the data (the readers skip it, padded)."""
    fmt = struct.pack("<HHIIHH", audio_fmt, channels, rate,
                      rate * channels * bits // 8, channels * bits // 8,
                      bits)
    extra = b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + extra
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)


_WAV_KINDS = {
    "int16": ("<i2", 1, 1, 16),
    "int32": ("<i4", 1, 1, 32),
    "f32": ("<f4", 3, 1, 32),
    "stereo16": ("<i2", 1, 2, 16),
}


@pytest.mark.parametrize("kind", sorted(_WAV_KINDS))
def test_load_wav_equal(tmp_path, kind):
    dtype, audio_fmt, ch, bits = _WAV_KINDS[kind]
    rng = np.random.default_rng(3)
    n = 1001 * ch
    if dtype == "<f4":
        x = rng.uniform(-1, 1, n).astype(dtype)
    else:
        info = np.iinfo(np.dtype(dtype))
        x = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    path = str(tmp_path / f"{kind}.wav")
    _write_wav(path, x.tobytes(), audio_fmt, ch, 22_050, bits)
    got, rate = wav.load_wav(path)
    ref, ref_rate = jax_wav.load_wav(path)
    assert rate == ref_rate == 22_050 and got.dtype == np.float32
    assert got.shape == (1001,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rate", [24_000, 16_000])
def test_save_wav_bytes_equal(tmp_path, rate):
    rng = np.random.default_rng(4)
    # past +-1 (clipped), ties at x * 32767 = k + 0.5, and zeros
    x = np.concatenate([rng.normal(size=997) * 0.7,
                        (np.arange(-8, 8) + 0.5) / 32767.0,
                        [0.0, 1.5, -1.5]]).astype(np.float32)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    wav.save_wav(a, x, rate)
    jax_wav.save_wav(b, x, rate)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(wav.load_wav(a)[0], jax_wav.load_wav(b)[0])


@pytest.mark.parametrize("src,dst", [(16_000, 24_000), (44_100, 24_000),
                                     (48_000, 24_000), (24_000, 16_000)])
def test_resamplers_equal(src, dst):
    x = np.random.default_rng(5).normal(size=src // 10).astype(np.float32)
    np.testing.assert_array_equal(media.resample_sinc(x, src, dst),
                                  jax_media.resample_sinc(x, src, dst))
    np.testing.assert_array_equal(wav.resample_linear(x, src, dst),
                                  jax_wav.resample_linear(x, src, dst))


def test_mimi_file_bytes_and_cross_read(tmp_path):
    codes = np.random.default_rng(6).integers(0, 2048, (13, 8))
    a, b = str(tmp_path / "port.mimi"), str(tmp_path / "jax.mimi")
    mimi_file.write_mimi_file(a, codes)
    jax_mimi_file.write_mimi_file(b, codes)
    raw = open(a, "rb").read()
    assert raw == open(b, "rb").read()
    assert raw[:4] == b"MIMI" and struct.unpack("<I", raw[4:8]) == (8,)
    got = mimi_file.read_mimi_file(b)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(got, jax_mimi_file.read_mimi_file(a))
    open(b, "wb").write(b"NOPE" + raw[4:])
    with pytest.raises(ValueError, match="not a .mimi file"):
        mimi_file.read_mimi_file(b)


def _write_aiff(path, x, rate):
    import aifc
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(">i2")
    with aifc.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


def _write_au(path, x, rate):
    import sunau
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype(">i2")
    with sunau.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("ext,writer", [(".aiff", _write_aiff),
                                        (".au", _write_au),
                                        (".wav", wav.save_wav)])
def test_load_audio_equal(tmp_path, ext, writer):
    t = np.arange(9_600) / 48_000
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = str(tmp_path / f"t{ext}")
    writer(path, x, 48_000)
    for rate in (None, 24_000):
        got, got_rate = media.load_audio(path, rate=rate)
        ref, ref_rate = jax_media.load_audio(path, rate=rate)
        assert got_rate == ref_rate == (rate or 48_000)
        np.testing.assert_array_equal(got, ref)


def test_unknown_format_raises_without_a_decoder(tmp_path, monkeypatch):
    """No silent fallback: a container with no native decoder needs an
    ffmpeg binary, and its absence raises, as in the JAX package."""
    p = str(tmp_path / "t.xyz")
    open(p, "wb").write(b"\x00" * 64)
    monkeypatch.setattr(media, "_FFMPEG", None)
    with pytest.raises(RuntimeError, match="no native decoder"):
        media.load_audio(p)
    with pytest.raises(RuntimeError, match="needs an `ffmpeg`"):
        media.save_audio(str(tmp_path / "o.mp3"), np.zeros(8), 24_000)


# ---------------------------------------------------------------------------
# the frame-FIFO driver (tests/test_driver.py's cases on the port's copy)
# ---------------------------------------------------------------------------


def test_fifo_roundtrip_drops_and_close():
    fifo = FrameFIFO(frame_samples=4, depth=3)
    b = fifo.get_free()
    b[:] = [1, 2, 3, 4]
    fifo.push(b, stamp=1.0)
    stamp, frame = fifo.pop(0.1)
    assert stamp == 1.0
    np.testing.assert_array_equal(frame, [1, 2, 3, 4])
    fifo.recycle(frame)
    assert fifo.drops == 0

    fifo = FrameFIFO(frame_samples=2, depth=2)
    for i in range(4):                    # 2 fit; 2 drop the oldest
        b = fifo.get_free()
        b[:] = i
        fifo.push(b)
    assert fifo.drops == 2
    vals = []
    while (item := fifo.pop(0.01)) is not None:
        vals.append(int(item[1][0]))
        fifo.recycle(item[1])
    assert vals == [2, 3]                 # newest survive

    t0 = time.perf_counter()
    assert fifo.pop(0.05) is None
    assert time.perf_counter() - t0 >= 0.04
    done = threading.Event()

    def consumer():
        assert fifo.pop(5.0) is None
        done.set()

    threading.Thread(target=consumer, daemon=True).start()
    time.sleep(0.02)
    fifo.close()                          # close releases the consumer
    assert done.wait(1.0)


def test_capture_driver_file_source_end_to_end():
    audio = np.arange(FRAME_SAMPLES * 5, dtype=np.float32)
    fifo = FrameFIFO(depth=8)     # deeper than the stream: no drops
    sink = PlaybackSink(budget=10.0)      # generous: no late frames
    cap = CaptureDriver(file_source(audio), fifo, pace=0).start()
    rep = realtime_loop(fifo, lambda f: f * 2.0, sink)
    cap.join(1.0)
    assert not cap.is_alive()
    assert rep["frames"] == 5 and rep["late"] == 0
    assert rep["capture_drops"] == 0
    np.testing.assert_allclose(sink.audio(), audio * 2.0)


def test_realtime_loop_reports_late_frames_and_drops():
    fifo = FrameFIFO(frame_samples=8, depth=2)
    sink = PlaybackSink(budget=0.001)
    cap = CaptureDriver(synthetic_source(frame_samples=8, frames=20),
                        fifo, pace=0.002).start()

    def slow_step(f):
        time.sleep(0.01)
        return f

    rep = realtime_loop(fifo, slow_step, sink, timeout=0.5)
    cap.join(2.0)
    assert rep["frames"] + rep["capture_drops"] == 20
    assert rep["capture_drops"] > 0 and rep["late"] > 0
    assert rep["latency_p99_ms"] >= rep["latency_p50_ms"]
    src = synthetic_source(frame_samples=16, frames=4)
    frames = [src(i) for i in range(5)]
    assert frames[4] is None
    assert not np.array_equal(frames[0], frames[1])   # distinct frames


# ---------------------------------------------------------------------------
# live device backends (tests/test_audio_device.py's cases on the port's
# copy) and the three fixes
# ---------------------------------------------------------------------------


class FakeCapture(ad.CaptureStream):
    def __init__(self, frames):
        self._frames = list(frames)
        self.closed = False

    def read(self, n):
        if not self._frames:
            return None
        f = self._frames.pop(0)
        assert len(f) == n
        return f

    def close(self):
        self.closed = True


class FakePlayback(ad.PlaybackStream):
    def __init__(self, delay=0.0):
        self.written = []
        self.delay = delay

    def write(self, frame):
        time.sleep(self.delay)
        self.written.append(np.array(frame, copy=True))


class FakeBackend:
    name = "fake"

    def __init__(self, frames, delay=0.0):
        self._frames = frames
        self.playback = FakePlayback(delay)
        self.capture = None

    def open_capture(self, samplerate=ad.SAMPLERATE):
        self.capture = FakeCapture(self._frames)
        return self.capture

    def open_playback(self, samplerate=ad.SAMPLERATE):
        return self.playback


@pytest.fixture
def clean_registry(monkeypatch):
    monkeypatch.setattr(ad, "_REGISTRY", dict(ad._REGISTRY))


def test_no_backend_raises_with_causes(clean_registry, monkeypatch):
    monkeypatch.setattr(ad, "_load_alsa",
                        lambda: (_ for _ in ()).throw(
                            OSError("libasound.so.2: not found")))
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    with pytest.raises(RuntimeError) as ei:
        ad.resolve_backend(None)
    msg = str(ei.value)
    assert "sounddevice" in msg and "alsa" in msg
    assert "libasound.so.2: not found" in msg
    assert ad.available_backends() == []
    with pytest.raises(RuntimeError, match="registered: alsa"):
        ad.resolve_backend("sounddevce")   # a typo must not KeyError


def test_resolution_probes_device_open(clean_registry):
    class Constructs:
        name = "constructs"

        def open_capture(self, samplerate=ad.SAMPLERATE):
            raise RuntimeError("snd_pcm_open failed: -2")

    fb = FakeBackend([])
    ad._REGISTRY.clear()
    ad.register_backend("constructs", Constructs)
    ad.register_backend("fake", lambda: fb)
    assert ad.resolve_backend(None) is fb
    assert ad.resolve_backend("fake") is fb
    assert ad.available_backends() == ["fake"]


def test_run_device_loop_end_to_end(clean_registry):
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal(FRAME_SAMPLES).astype(np.float32)
              for _ in range(5)]
    fb = FakeBackend(frames)
    ad.register_backend("fake", lambda: fb)
    rep = ad.run_device_loop(lambda f: f * 0.5, name=None, fifo_depth=8)
    assert rep["frames"] == 5 and len(fb.playback.written) == 5
    for src, out in zip(frames, fb.playback.written):
        np.testing.assert_allclose(out, src * 0.5, rtol=1e-6)
    assert "latency_p50_ms" in rep and "capture_drops" in rep
    # the backend resolved, not the name asked for (None: auto)
    assert rep["backend"] == "fake"
    assert rep["capture_closed"] and fb.capture.closed


def test_open_duplex_closes_capture_on_playback_failure(clean_registry):
    class Broken(FakeBackend):
        def open_playback(self, samplerate=ad.SAMPLERATE):
            raise RuntimeError("busy")

    b = Broken([])
    ad.register_backend("fake", lambda: b)
    with pytest.raises(RuntimeError, match="busy"):
        ad.open_duplex("fake")
    assert b.capture.closed
    with pytest.raises(RuntimeError, match="busy"):
        ad.run_device_loop(lambda f: f, name="fake")


def test_capture_alive_after_join_keeps_its_stream_open(clean_registry,
                                                        monkeypatch,
                                                        capsys):
    """Fixed (the reference's audio_device.py:373): when the capture
    thread is still blocked in a device read after the join, its stream
    is not closed under it; the report says so."""
    release = threading.Event()

    class Stuck(FakeCapture):
        def read(self, n):
            if self._frames:
                return self._frames.pop(0)
            release.wait(5.0)             # a read that does not return
            return None

    class StuckBackend(FakeBackend):
        def open_capture(self, samplerate=ad.SAMPLERATE):
            self.capture = Stuck(self._frames)
            return self.capture

    frames = [np.full(FRAME_SAMPLES, i, np.float32) for i in range(2)]
    fb = StuckBackend(frames)
    monkeypatch.setattr(ad, "CAPTURE_JOIN_S", 0.05)
    ad.register_backend("fake", lambda: fb)
    rep = ad.run_device_loop(lambda f: f, name="fake", max_frames=2,
                             fifo_depth=8)
    assert rep["frames"] == 2
    assert rep["capture_closed"] is False and not fb.capture.closed
    assert "left open" in capsys.readouterr().err
    release.set()


def test_latency_stamp_leaves_out_the_device_write():
    """Fixed (the reference's audio_device.py:331): a playback write that
    blocks 50 ms does not enter the frame's latency, where the
    reference's sink, stamping after the write, counts it."""
    frame = np.zeros(FRAME_SAMPLES, np.float32)
    for mod, slow in ((ad, False), (jax_ad, True)):
        play = FakePlayback(delay=0.05)
        sink = mod.DeviceSink(play, keep_audio=False)
        sink.submit(frame, time.perf_counter())
        assert len(play.written) == 1
        assert (sink.latencies[0] >= 0.05) == slow, (mod, sink.latencies)


class FakeAsound:
    """The ctypes surface ``_AlsaPcm`` uses.  FLOAT_LE is rejected, so the
    S16_LE fallback (and its f32 <-> i16 conversion) is the path under
    test; readi serves a scripted int16 signal, fails with EPIPE while
    ``xruns`` > 0, and writei records what it is given."""

    def __init__(self, capture_i16, recover_rc=0):
        self._cap = np.ascontiguousarray(capture_i16, np.int16)
        self._pos = 0
        self.written = []
        self.recovers = 0
        self.xruns = 0
        self.recover_rc = recover_rc

    def snd_pcm_open(self, pcmp, name, stream, mode):
        pcmp._obj.value = 0xBEEF
        return 0

    def snd_pcm_set_params(self, pcm, fmt, access, ch, rate, rs, lat):
        return -22 if fmt == ad._SND_PCM_FORMAT_FLOAT_LE else 0

    def snd_pcm_readi(self, pcm, buf, n):
        if self.xruns:
            self.xruns -= 1
            return -32                      # EPIPE xrun
        n = int(n.value if hasattr(n, "value") else n)
        take = min(n, len(self._cap) - self._pos)
        if take <= 0:
            return 0
        src = self._cap[self._pos:self._pos + take]
        ctypes.memmove(buf, src.ctypes.data, take * 2)
        self._pos += take
        return take

    def snd_pcm_writei(self, pcm, buf, n):
        n = int(n.value if hasattr(n, "value") else n)
        out = np.empty(n, np.int16)
        ctypes.memmove(out.ctypes.data, buf, n * 2)
        self.written.append(out)
        return n

    def snd_pcm_recover(self, pcm, err, silent):
        self.recovers += 1
        return self.recover_rc

    def snd_pcm_close(self, pcm):
        return 0


def _alsa_capture(lib):
    return ad._AlsaCapture(lib, "default", ad._SND_PCM_STREAM_CAPTURE,
                           ad.SAMPLERATE)


def test_alsa_s16_roundtrip_and_recover():
    sig = (np.sin(np.linspace(0, 20, 3 * FRAME_SAMPLES))
           * 20000).astype(np.int16)
    lib = FakeAsound(sig)
    cap = _alsa_capture(lib)
    assert cap.fmt == ad._SND_PCM_FORMAT_S16_LE   # FLOAT_LE fell back
    f1 = cap.read(FRAME_SAMPLES)
    np.testing.assert_allclose(
        f1, sig[:FRAME_SAMPLES].astype(np.float32) / 32768.0)
    lib.xruns = 1                                  # xrun: recover + retry
    f2 = cap.read(FRAME_SAMPLES)
    assert lib.recovers == 1
    np.testing.assert_allclose(
        f2, sig[FRAME_SAMPLES:2 * FRAME_SAMPLES].astype(np.float32)
        / 32768.0)
    play = ad._AlsaPlayback(lib, "default", ad._SND_PCM_STREAM_PLAYBACK,
                            ad.SAMPLERATE)
    play.write(f1)
    np.testing.assert_allclose(lib.written[-1], sig[:FRAME_SAMPLES], atol=1)
    cap.close()
    play.close()


def test_alsa_xrun_burst_reads_silence_and_goes_on():
    """Fixed (the reference's audio_device.py:204): xruns that ALSA
    recovers from past the retries give a silent frame, not the end of
    the stream; the next read goes on with the device's samples.  An
    error that does not recover still ends it."""
    sig = (np.arange(2 * FRAME_SAMPLES) % 1000 + 1).astype(np.int16)
    lib = FakeAsound(sig)
    cap = _alsa_capture(lib)
    lib.xruns = ad.XRUN_RETRIES + 1
    silent = cap.read(FRAME_SAMPLES)
    assert lib.recovers == ad.XRUN_RETRIES + 1
    np.testing.assert_array_equal(silent, np.zeros(FRAME_SAMPLES))
    nxt = cap.read(FRAME_SAMPLES)
    np.testing.assert_allclose(nxt, sig[:FRAME_SAMPLES] / 32768.0)
    lib.xruns, lib.recover_rc = 1, -5             # recover fails: dead
    assert cap.read(FRAME_SAMPLES) is None
