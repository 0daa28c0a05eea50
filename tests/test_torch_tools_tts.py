"""The port's moshi-tts (``moshi_tpu_torch.tools.moshi_tts``) against the
JAX package's, on the CPU, as ``tests/test_torch_tools.py`` holds the
other tools: the same small trees in both packages' tool modules, the
JAX Pallas kernels in interpret mode, the written audio compared up to
the first frame whose token JAX's top-1/top-2 gap does not decide.

The LM is ``tests/test_torch_tts.py``'s tiny TTS class (cross-attention,
dep_q = n_q = 4, delay_steps 3), q4_k.  Each generator runs against the
JAX tool's same generator: the host FSM, the device FSM (with a
cross-attention voice: a voice file with ``voice.speaker_wavs`` and the
conditioners read from the checkpoint file the config names), the
offline scan and the interactive stdin feed; a model without
cross-attention takes a voice prefix from a wav.  The scan's end-near-
chunk-tail top-up runs at chunks of 8, 4 and 1 frames, its audio the
device FSM's bit for bit.
"""

import sys

import numpy as np
import pytest

from moshi_tpu.runtime.pipeline import TTSPipeline as JaxTTSPipeline

from moshi_tpu_torch.io.safetensors import save_safetensors
from moshi_tpu_torch.runtime.synth import synth_conditioners
from tests.test_torch_tools import (FS, _one_thread, assert_frames_close,
                                    captured_audio, compared, frames_of,
                                    patch_tools, run_jax, run_port, tape,
                                    write_audio, write_config)

assert _one_thread
_TTS = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
            card=64, n_q=4, dep_q=4, text_card=512, delays=(0, 0, 2, 2, 2),
            depformer_dim=256, depformer_heads=4, depformer_layers=2,
            depformer_hidden=576, depformer_low_rank=32,
            cross_attention=True, delay_steps=3)
_PREFIX = dict(_TTS, cross_attention=False)
_S, _DW = 3, 48       # the synthetic voice: speaker rows, embedding width
_MAX = 16             # --max-frames of the comparisons
_WORDS = ["hello", "there", "quite", "a", "few", "more", "words", "to",
          "move", "the", "end", "boundary"]


def _modules():
    from moshi_tpu.tools import moshi_tts as jtts

    from moshi_tpu_torch.tools import moshi_tts as ptts
    return jtts, ptts


def _cross_voice(tmp_path):
    """(voice file, model dir holding the conditioners under the config's
    moshi_name)."""
    cond = synth_conditioners(_TTS["dim"], wav_dim=_DW, device="cpu",
                              seed=21)
    flat = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}.{k}")
        else:
            flat[name] = node.numpy().astype(np.float32)

    walk(cond, "lm.condition_provider.conditioners")
    for lut in ("cfg", "control"):
        base = f"lm.condition_provider.conditioners.{lut}.embed"
        flat[base + ".weight"] = flat.pop(base)
    save_safetensors(str(tmp_path / "model.safetensors"), flat)
    rng = np.random.default_rng(22)
    voice = str(tmp_path / "voice.safetensors")
    save_safetensors(voice, {"voice.speaker_wavs": rng.normal(
        size=(_S, _DW)).astype(np.float32)})
    return voice, str(tmp_path)


def _compare(tmp_path, monkeypatch, kw, argv, stdin=None):
    """One generator's run in each package: (frames compared, frames run,
    JAX's audio, the port's audio)."""
    jtts, ptts = _modules()
    patch_tools(monkeypatch, jtts, ptts, kw)
    monkeypatch.setattr(JaxTTSPipeline, "SCAN_CHUNKS", (1,))
    cfg = write_config(tmp_path / "config.json", "tts",
                       moshi_name="model.safetensors")
    argv = ["-c", cfg, "--synthetic", "--max-frames", str(_MAX)] + argv
    runs = []
    with captured_audio(monkeypatch, jtts, ptts) as got:
        for jax_side in (True, False):
            if stdin is not None:
                monkeypatch.setattr(sys, "stdin", iter(stdin))
            log = tape(monkeypatch, jax_side)
            run = run_jax if jax_side else run_port
            rc, out = run(jtts.main if jax_side else ptts.main,
                          argv + ["-o", str(tmp_path / "o.wav")])
            assert rc == 0
            runs.append((frames_of(log, kw["text_card"]), out))
    (ref, jout), (mine, pout) = runs
    if "--bench" in argv:                 # the warm-up run, then the timed
        assert len(ref) % 2 == 0 and len(mine) % 2 == 0
        ref, mine = ref[len(ref) // 2:], mine[len(mine) // 2:]
    if "--scan" in argv:                  # its two warm-up frames
        ref, mine = ref[2:], mine[2:]
    n = compared(ref, mine)
    jwav, pwav = got[-2], got[-1]
    frames = int(pout.splitlines()[0].split(" frames in")[0].split()[-1])
    return n, frames, len(ref), jwav, pwav, jout, pout


def _held(n, frames, run_frames, jwav, pwav, jout, pout):
    """The audio of the frames before the first undecided token equal to
    ``_AUDIO_TOL``: audio starts after the lead-in, so the wav's first
    frames are the run's last ones less the segments written."""
    assert n >= 8, f"token streams diverged at frame {n}"
    lead = frames - len(pwav) // FS
    assert len(pwav) % FS == 0 and 0 < len(pwav) // FS < frames
    if n == run_frames:
        assert len(pwav) == len(jwav)
        assert jout.splitlines()[0].split(",")[0] == \
            pout.splitlines()[0].split(",")[0]
    assert_frames_close(pwav, jwav, max(n - lead, 0))


@pytest.mark.parametrize("gen", ["host", "device_cross_voice", "scan"])
def test_moshi_tts_generators_match_jax(tmp_path, monkeypatch, gen):
    """--bench (temp 0, seed 0) in each generator: the written audio
    agrees with the JAX tool's."""
    argv = ["--bench"]
    if gen == "host":
        argv += ["--host-fsm"]
    elif gen == "scan":
        argv += ["--scan"]
    else:
        voice, model_dir = _cross_voice(tmp_path)
        argv += ["--voice", voice, "-d", model_dir]
    n, frames, run_frames, jwav, pwav, jout, pout = _compare(
        tmp_path, monkeypatch, _TTS, argv)
    assert frames == _MAX and run_frames == _MAX
    assert '"tts_frames_per_sec"' in pout
    _held(n, frames, run_frames, jwav, pwav, jout, pout)


def test_moshi_tts_interactive_matches_jax(tmp_path, monkeypatch):
    """--interactive: words arrive on stdin (monkeypatched) while the
    frame loop runs, greedy sampling; the audio agrees with the JAX
    tool's."""
    argv = ["--interactive", "--temp", "0", "--temp-text", "0"]
    n, frames, run_frames, jwav, pwav, jout, pout = _compare(
        tmp_path, monkeypatch, _TTS, argv,
        stdin=["hello there\n", "\n", "more words\n"])
    _held(n, frames, run_frames, jwav, pwav, jout, pout)


def test_moshi_tts_prefix_voice_matches_jax(tmp_path, monkeypatch):
    """A model without cross-attention: the voice is a wav, Mimi-encoded
    into text and audio prefixes forced before generation."""
    wav = write_audio(tmp_path / "voice.wav", 3, 23)
    argv = ["--voice", wav, "--temp", "0", "--temp-text", "0", "hello",
            "world"]
    n, frames, run_frames, jwav, pwav, jout, pout = _compare(
        tmp_path, monkeypatch, _PREFIX, argv)
    _held(n, frames, run_frames, jwav, pwav, jout, pout)


_DEVICE_RUNS = {}      # script length -> the device FSM's (line, audio)


@pytest.mark.parametrize("chunk", [8, 4, 1])
def test_moshi_tts_scan_end_near_chunk_tail(tmp_path, monkeypatch, chunk):
    """The end token can land near the tail of the last scan chunk, with
    end + delay_steps + final padding past the frames generated: the scan
    tops up through the delay window.  Short chunks and three script
    lengths move the end everywhere; each scan's audio is the device
    FSM's bit for bit (dense weights: the tool's logic is under test)."""
    jtts, ptts = _modules()
    patch_tools(monkeypatch, jtts, ptts, _TTS, fmt=None)
    monkeypatch.setattr(ptts, "SCAN_CHUNK", chunk)
    cfg = write_config(tmp_path / "config.json", "tts")
    for n in (3, 7, 12):
        argv = (_WORDS[:n] + ["-c", cfg, "-o", str(tmp_path / "t.wav"),
                              "--synthetic", "--max-frames", "150",
                              "--temp", "0", "--temp-text", "0"])
        with captured_audio(monkeypatch, ptts) as got:
            rc, out = run_port(ptts.main, argv + ["--scan"])
            assert rc == 0
            if n not in _DEVICE_RUNS:
                rc, dev_out = run_port(ptts.main, argv)
                assert rc == 0
                _DEVICE_RUNS[n] = (dev_out.splitlines()[0], got[-1])
        line, dev_wav = _DEVICE_RUNS[n]
        # "wrote <path>: <seconds> audio, <frames> frames in <time>"
        assert out.splitlines()[0].split(": ")[1].split(" in ")[0] == \
            line.split(": ")[1].split(" in ")[0]
        assert len(got[0]) > 0
        np.testing.assert_array_equal(got[0], dev_wav)


def test_moshi_tts_scan_within_the_lead_in_writes_silence(tmp_path,
                                                          monkeypatch):
    """Fixed (the reference's ``moshi_tpu/tools/moshi_tts.py:384``, which
    concatenates no chunks and raises): a --scan run whose --max-frames
    ends inside the depformer-replace lead-in writes one silent frame, as
    the frame loops do when no frame is valid."""
    jtts, ptts = _modules()
    patch_tools(monkeypatch, jtts, ptts, _TTS, fmt=None)
    cfg = write_config(tmp_path / "config.json", "tts")
    with captured_audio(monkeypatch, ptts) as got:
        for extra in (["--scan"], []):
            rc, out = run_port(ptts.main, [
                "hello", "-c", cfg, "-o", str(tmp_path / "t.wav"),
                "--synthetic", "--max-frames", "2"] + extra)
            assert rc == 0 and "0.08s audio, " in out
    assert len(got) == 2
    for wav in got:
        np.testing.assert_array_equal(wav, np.zeros(FS))
