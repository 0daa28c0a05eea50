"""The port's command-line tools (``moshi_tpu_torch.tools``) against the
JAX package's (``moshi_tpu.tools``), each run through ``main(argv)`` on
the same files, on the CPU (``--torch-device cpu``).

The JAX tools build the full-width Mimi (``MimiConfig(n_q=...)``) and
draw their own weights, so each test replaces the ``load_mimi``,
``load_lm`` and ``load_tokenizer`` names of the tool modules of both
packages (test side only, with pytest's monkeypatch) by the same small
trees: a Mimi with the real frame of 1920 samples (SEANet ratios 8, 6, 5,
4) but 4 filters and 32 dims, in f32, where the two packages' codes agree
exactly; the tiny LMs of the port's pipeline tests, carried across with
their bits; a SentencePiece vocabulary written with
``save_model_proto``.  JAX runs its Pallas kernels in interpret mode.

Outputs are held as ``tests/test_torch_pipeline.py`` holds the frames:
``.mimi`` bytes and codes exactly, decoded audio to ``_AUDIO_TOL`` of each
frame's largest magnitude, and tokens by the gap rule: every token equal
where JAX's top-1/top-2 logit gap exceeds ``_RTOL`` of the row's largest
magnitude, and each frame's outputs compared up to the first frame whose
token JAX's gap does not decide (later frames take other inputs).  The
logits come from a tape of every ``sample_token`` call in each package.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from moshi_tpu.models import lm as jax_lm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.tokenizer import SentencePieceTokenizer as JaxTokenizer
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.io import audio_device as ad
from moshi_tpu_torch.io.mimi_file import read_mimi_file
from moshi_tpu_torch.io.safetensors import save_safetensors
from moshi_tpu_torch.io.wav import save_wav
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.synth import synth_lm_params
from moshi_tpu_torch.tokenizer import SentencePieceTokenizer
from moshi_tpu_torch.tokenizer import save_model_proto
from tests.test_torch_gguf import jax_tree
from tests.test_torch_pipeline import _LM as _STS_LM
from tests.test_torch_pipeline import _AUDIO_TOL, _RTOL, _gap
from tests.test_torch_pipeline import _mimi_params, _np

FS = 1920
# the real frame (hop 960, two positions a frame), at a small width
_SEANET = dict(dimension=32, n_filters=4, ratios=(8, 6, 5, 4))
_MIMI = dict(total_codebooks=16, dim=32, codebook_dim=16,
             transformer_layers=2, transformer_heads=4,
             transformer_context=16, transformer_hidden=64)
# tests/test_torch_stt.py's tiny STT (dense, dep_q 0, the VAD heads)
_STT_LM = dict(dim=128, num_heads=4, num_layers=2, hidden_dim=256,
               context=24, card=64, n_q=4, dep_q=0, text_card=96,
               delays=(0,) * 5, extra_heads_num=4, extra_heads_dim=6,
               delay_steps=6)
# tests/test_torch_personaplex.py's PersonaPlex; its card holds the prompt
# frames' audio codes (models/personaplex.py PROMPT_TOKENS)
_PP_LM = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512,
              context=32, card=2048, n_q=16, dep_q=16, text_card=512,
              delays=(0, 0) + (1,) * 7 + (0,) + (1,) * 7,
              depformer_dim=256, depformer_heads=4, depformer_layers=2,
              depformer_hidden=576, depformer_context=8,
              depformer_low_rank=32, personaplex=True)
_TEMP0 = {"temp": 0.0, "temp_text": 0.0, "top_k": 250, "top_k_text": 25}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread: the tiny ops' thread hand-offs cost more than
    they give beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the same trees in both packages
# ---------------------------------------------------------------------------

_TREES = {}


def mimi_trees(card):
    """Mimi's trees with ``card`` codes a codebook: the LM's card, since
    its audio ids index Mimi's codebooks and Mimi's codes its
    embeddings."""
    if ("mimi", card) not in _TREES:
        jcfg = JaxMimiConfig(n_q=16, seanet=JaxSEANetConfig(**_SEANET),
                             codebook_size=card, **_MIMI)
        jp = _mimi_params(JaxMimiModel(jcfg), 4)
        _TREES["mimi", card] = (jp, params_from_numpy(_np(jp), device="cpu"))
    return _TREES["mimi", card]


def lm_trees(kw, fmt, seed):
    """(JAX cfg, JAX tree, port cfg, port tree): a port-drawn synthetic
    tree and the JAX package's tree of the same bits."""
    key = (tuple(sorted(kw.items())), fmt, seed)
    if key not in _TREES:
        cfg = LMConfig(**kw)
        pt = synth_lm_params(cfg, fmt, device="cpu", seed=seed)
        _TREES[key] = (JaxLMConfig(**kw), jax_tree(pt), cfg, pt)
    return _TREES[key]


def vocab(path, n):
    """A SentencePiece model of ``n`` pieces (the LM's text card)."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -2.0, 1)]
    pieces += [(f"▁w{i}", -1.0, 1) for i in range(n - len(pieces) - 26)]
    pieces += [(c, -5.0, 1) for c in "abcdefghijklmnopqrstuvwxyz"]
    path.write_bytes(save_model_proto(pieces))
    return str(path)


def patch_tools(monkeypatch, jmod, pmod, kw=None, fmt="q4_k", seed=3,
                vocab_path=None):
    """Both tool modules load the same small trees: Mimi at the n_q asked
    for, the LM of ``kw``, the tokenizer of ``vocab_path``."""
    card = (kw or {}).get("card", 64)
    jmimi, pmimi = mimi_trees(card)
    for mod, jax_side in ((jmod, True), (pmod, False)):
        if jax_side:
            def load_mimi(args, n_q=32):
                return JaxMimiModel(JaxMimiConfig(
                    n_q=n_q, seanet=JaxSEANetConfig(**_SEANET),
                    codebook_size=card, **_MIMI)), jmimi
        else:
            def load_mimi(args, n_q=32):
                return MimiModel(MimiConfig(
                    n_q=n_q, seanet=SEANetConfig(**_SEANET),
                    codebook_size=card, **_MIMI)), pmimi
        monkeypatch.setattr(mod, "load_mimi", load_mimi)
        if kw is not None:
            jcfg, jt, pcfg, pt = lm_trees(kw, fmt, seed)
            cfg, tree = (jcfg, jt) if jax_side else (pcfg, pt)
            monkeypatch.setattr(mod, "load_lm",
                                lambda args, config, c=cfg, t=tree: (c, t))
        if vocab_path is not None:
            cls = JaxTokenizer if jax_side else SentencePieceTokenizer
            monkeypatch.setattr(
                mod, "load_tokenizer",
                lambda args, config, c=cls: c.from_file(vocab_path))


def write_config(path, model_type, **extra):
    """A config.json whose sampling is greedy (temp 0)."""
    doc = {"model_type": model_type, "lm_gen_config": dict(_TEMP0)}
    doc.update(extra)
    path.write_text(json.dumps(doc))
    return str(path)


def write_audio(path, frames, seed, scale=0.1):
    x = (np.random.default_rng(seed).normal(size=frames * FS) * scale
         ).astype(np.float32)
    save_wav(str(path), x, 24_000)
    return str(path)


# ---------------------------------------------------------------------------
# running a tool in either package
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def captured_audio(monkeypatch, *modules):
    """The float samples each ``save_audio`` call is given (before the
    16-bit rounding), in order; the files are written as before."""
    import moshi_tpu.io.media as jax_media

    import moshi_tpu_torch.io.media as port_media
    got = []
    for m in (jax_media, port_media):
        real = m.save_audio

        def save(path, samples, rate=24_000, real=real):
            got.append(np.asarray(samples, np.float32).reshape(-1).copy())
            return real(path, samples, rate)

        monkeypatch.setattr(m, "save_audio", save)
        for mod in modules:
            if getattr(mod, "save_wav", None) is real:
                monkeypatch.setattr(mod, "save_wav", save)
    yield got


def tape(monkeypatch, jax_side):
    """Every sample_token call's logits (f32, [B, vocab]) in call order."""
    logged = []
    if jax_side:
        orig = jax_lm.sample_token

        def sample(logits, *a, **kw):
            jax.debug.callback(lambda v: logged.append(np.array(v)),
                               logits, ordered=True)
            return orig(logits, *a, **kw)

        monkeypatch.setattr(jax_lm, "sample_token", sample)
    else:
        orig = port_lm.sample_token

        def sample(logits, *a, **kw):
            logged.append(logits.float().numpy().copy())
            return orig(logits, *a, **kw)

        monkeypatch.setattr(port_lm, "sample_token", sample)
    return logged


def run_jax(main, argv):
    """A JAX tool's ``main(argv)`` with the Pallas kernels in interpret
    mode; returns (rc, stdout)."""
    buf = io.StringIO()
    enable_pallas(True)
    try:
        with pallas_interpret(), contextlib.redirect_stdout(buf):
            rc = main(argv)
            jax.effects_barrier()
    finally:
        enable_pallas(False)
    return rc, buf.getvalue()


def run_port(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--torch-device", "cpu"])
    return rc, buf.getvalue()


def frames_of(logged, text_card):
    """A tape split into frames: each frame starts at a text-logits call
    (width ``text_card``), followed by its depformer calls."""
    frames = []
    for lg in logged:
        lg = lg.reshape(lg.shape[0], -1)
        if lg.shape[-1] == text_card or not frames:
            frames.append([])
        frames[-1].append(lg)
    return frames


def compared(ref, got):
    """Frames before the first one whose token JAX's gap does not decide;
    every decided token before it (and in it) must be equal."""
    for f, (r, g) in enumerate(zip(ref, got)):
        assert len(r) == len(g), (f, len(r), len(g))
        stop = False
        for a, b in zip(r, g):
            ra, ga = np.argmax(a, -1), np.argmax(b, -1)
            decided = _gap(a) > _RTOL
            np.testing.assert_array_equal(ga[decided], ra[decided])
            stop |= bool(np.any((ra != ga) & ~decided))
        if stop:
            return f
    return min(len(ref), len(got))


def assert_frames_close(got, ref, n, lead=0):
    """The first ``n`` frames of two waveforms, after ``lead`` frames,
    each to ``_AUDIO_TOL`` of the reference frame's largest magnitude."""
    for f in range(lead, n):
        a, b = got[f * FS:(f + 1) * FS], ref[f * FS:(f + 1) * FS]
        assert a.shape == b.shape == (FS,), (f, a.shape, b.shape)
        assert np.all(np.isfinite(a))
        err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
        assert err < _AUDIO_TOL, (f, err)


# ---------------------------------------------------------------------------
# mimi-encode, mimi-decode, mimi-play
# ---------------------------------------------------------------------------

def test_mimi_encode_decode_match_jax(tmp_path, monkeypatch):
    """The port's .mimi file is the JAX tool's byte for byte; each package
    decodes the other's file to the same audio (``_AUDIO_TOL``), and
    mimi-play's frame-at-a-time decode and its --echo round trip agree
    with the JAX tool's."""
    from moshi_tpu.tools import mimi_decode as jdec
    from moshi_tpu.tools import mimi_encode as jenc
    from moshi_tpu.tools import mimi_play as jplay

    from moshi_tpu_torch.tools import mimi_decode as pdec
    from moshi_tpu_torch.tools import mimi_encode as penc
    from moshi_tpu_torch.tools import mimi_play as pplay
    for j, p in ((jenc, penc), (jdec, pdec), (jplay, pplay)):
        patch_tools(monkeypatch, j, p)
    wav = write_audio(tmp_path / "in.wav", 5, 7, scale=0.3)
    jm, pm = str(tmp_path / "jax.mimi"), str(tmp_path / "port.mimi")
    args = ["-i", wav, "-n", "8", "--synthetic", "--chunk-frames", "2"]
    assert run_jax(jenc.main, args + ["-o", jm])[0] == 0
    rc, out = run_port(penc.main, args + ["-o", pm])
    assert rc == 0 and "5 frames x 8 codebooks" in out
    assert open(pm, "rb").read() == open(jm, "rb").read()
    codes = read_mimi_file(pm)
    assert codes.shape == (5, 8) and len(np.unique(codes)) > 8
    with captured_audio(monkeypatch, jdec, pdec, jplay, pplay) as got:
        for src in (jm, pm):
            assert run_jax(jdec.main, ["-i", src, "-o", str(
                tmp_path / "j.wav"), "--synthetic"])[0] == 0
            assert run_port(pdec.main, ["-i", src, "-o", str(
                tmp_path / "p.wav"), "--synthetic", "--chunk-frames",
                "3"])[0] == 0
        assert run_jax(jplay.main, ["-i", pm, "-o", str(tmp_path / "j.wav"),
                                    "--synthetic"])[0] == 0
        rc, out = run_port(pplay.main, ["-i", pm, "-o", str(
            tmp_path / "p.wav"), "--synthetic"])
        assert rc == 0 and "play: 5 frames" in out
        echo = ["-i", wav, "--echo", "-n", "8", "--synthetic"]
        assert run_jax(jplay.main, echo + ["-o", str(tmp_path / "j.wav")]
                       )[0] == 0
        rc, out = run_port(pplay.main, echo + ["-o", str(tmp_path / "p.wav")])
        assert rc == 0 and "echo: 5 frames" in out
    assert len(got) == 8
    for ref, mine in zip(got[::2], got[1::2]):
        assert len(ref) == len(mine) == 5 * FS
        assert_frames_close(mine, ref, 5)
    # each package's file decodes to the same audio
    np.testing.assert_array_equal(got[1], got[3])


def test_mimi_play_realtime_sim_and_live_device(tmp_path, monkeypatch):
    """--echo --realtime-sim goes through the frame-FIFO driver; --echo
    --device through a registered backend, whose name the report gives
    when it was auto-resolved."""
    from moshi_tpu.tools import mimi_play as jplay

    from moshi_tpu_torch.tools import mimi_play as pplay
    patch_tools(monkeypatch, jplay, pplay)
    wav = write_audio(tmp_path / "in.wav", 4, 8)
    rc, out = run_port(pplay.main, [
        "-i", wav, "-o", str(tmp_path / "e.wav"), "--echo",
        "--realtime-sim", "--sim-speed", "100", "--synthetic", "-n", "8"])
    assert rc == 0
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["metric"] == "mimi_echo_realtime_sim" and rep["frames"] == 3
    monkeypatch.setattr(ad, "_REGISTRY", {})
    frames = [np.random.default_rng(1).normal(size=FS).astype(np.float32)
              * 0.1 for _ in range(3)]
    from tests.test_torch_io import FakeBackend
    fb = FakeBackend(frames)
    ad.register_backend("fake", lambda: fb)
    rc, out = run_port(pplay.main, ["--echo", "--device", "--synthetic",
                                    "--frames", "3", "-n", "8"])
    assert rc == 0 and len(fb.playback.written) == 3
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["metric"] == "mimi_echo_live" and rep["backend"] == "fake"
    assert rep["capture_closed"]
    for w in fb.playback.written:
        assert w.shape == (FS,) and np.isfinite(w).all()


# ---------------------------------------------------------------------------
# moshi-sts
# ---------------------------------------------------------------------------

def test_moshi_sts_file_mode_matches_jax(tmp_path, monkeypatch):
    """8 frames of file mode at temp 0: the written audio and the
    transcript agree with the JAX tool's up to the first undecided token
    (at least 6 frames compared)."""
    from moshi_tpu.tools import moshi_sts as jsts

    from moshi_tpu_torch.tools import moshi_sts as psts
    voc = vocab(tmp_path / "tok.model", _STS_LM["text_card"])
    patch_tools(monkeypatch, jsts, psts, _STS_LM, vocab_path=voc)
    cfg = write_config(tmp_path / "config.json", "moshi")
    wav = write_audio(tmp_path / "in.wav", 8, 5)
    argv = ["-c", cfg, "-i", wav, "--synthetic"]
    with captured_audio(monkeypatch, jsts, psts) as got:
        jt = tape(monkeypatch, True)
        rc, jout = run_jax(jsts.main, argv + ["-o", str(tmp_path / "j.wav")])
        assert rc == 0
        pt = tape(monkeypatch, False)
        rc, pout = run_port(psts.main, argv + ["-o", str(tmp_path / "p.wav")])
        assert rc == 0
    text_card = _STS_LM["text_card"]
    ref, mine = frames_of(jt, text_card), frames_of(pt, text_card)
    assert len(ref) == len(mine) == 8
    n = compared(ref, mine)
    assert n >= 6, f"token streams diverged at frame {n}"
    assert_frames_close(got[1], got[0], n)
    jlines = jout.replace("j.wav", "out.wav").splitlines()
    plines = pout.replace("p.wav", "out.wav").splitlines()
    assert plines[0] == jlines[0] == f"wrote {tmp_path / 'out.wav'}: 0.64s"
    if n == 8:
        assert plines[1] == jlines[1]          # the transcript
    assert plines[-1].endswith(", 8 frames")


def test_moshi_sts_bench_and_dump_frame(tmp_path, monkeypatch):
    """--bench prints the sts_frames_per_sec line; --dump-frame writes the
    JAX tool's tap names in the JAX tool's order; --bench with --device
    is refused."""
    from moshi_tpu.tools import moshi_sts as jsts

    from moshi_tpu_torch.tools import moshi_sts as psts
    patch_tools(monkeypatch, jsts, psts, _STS_LM)
    cfg = write_config(tmp_path / "config.json", "moshi")
    rc, out = run_port(psts.main, ["-c", cfg, "--synthetic", "--bench",
                                   "--frames", "8"])
    assert rc == 0
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["metric"] == "sts_frames_per_sec" and rep["value"] > 0
    assert "8 frames" in out
    wav = write_audio(tmp_path / "in.wav", 1, 6)
    jd, pd = str(tmp_path / "jax_dump"), str(tmp_path / "port_dump")
    assert run_jax(jsts.main, ["-c", cfg, "-i", wav, "--synthetic",
                               "--dump-frame", jd])[0] == 0
    rc, out = run_port(psts.main, ["-c", cfg, "-i", wav, "--synthetic",
                                   "--dump-frame", pd])
    assert rc == 0 and "taps" in out
    jorder = json.load(open(jd + ".json"))["order"]
    porder = json.load(open(pd + ".json"))["order"]
    assert len(porder) > 20
    assert [(o["name"], o["occurrence"]) for o in porder] == \
        [(o["name"], o["occurrence"]) for o in jorder]
    with np.load(pd + ".npz") as z:
        assert len(z.files) == len(porder)
    with pytest.raises(SystemExit):
        psts.main(["--synthetic", "--bench", "--device", "fake",
                   "--torch-device", "cpu"])


def test_moshi_sts_realtime_sim_and_live_device(tmp_path, monkeypatch):
    from moshi_tpu.tools import moshi_sts as jsts

    from moshi_tpu_torch.tools import moshi_sts as psts
    patch_tools(monkeypatch, jsts, psts, _STS_LM)
    cfg = write_config(tmp_path / "config.json", "moshi")
    wav = write_audio(tmp_path / "in.wav", 5, 9)
    rc, out = run_port(psts.main, ["-c", cfg, "-i", wav, "-o", str(
        tmp_path / "s.wav"), "--synthetic", "--realtime-sim", "--sim-speed",
        "100"])
    assert rc == 0
    rep = json.loads(out.splitlines()[0])
    assert rep["metric"] == "sts_realtime_sim" and "sustained_fps" in rep
    monkeypatch.setattr(ad, "_REGISTRY", {})
    from tests.test_torch_io import FakeBackend
    frames = [np.random.default_rng(2).normal(size=FS).astype(np.float32)
              * 1e-3 for _ in range(2)]
    fb = FakeBackend(frames)
    ad.register_backend("fake", lambda: fb)
    rc, out = run_port(psts.main, ["-c", cfg, "--synthetic", "--device",
                                   "--frames", "2"])
    assert rc == 0 and len(fb.playback.written) == 2
    rep = json.loads(out.splitlines()[-1])
    assert rep["metric"] == "sts_live_device" and rep["backend"] == "fake"


# ---------------------------------------------------------------------------
# moshi-stt
# ---------------------------------------------------------------------------

def test_moshi_stt_matches_jax_and_scan(tmp_path, monkeypatch):
    """Per-frame and --scan transcripts are equal, and equal the JAX
    tool's under the gap rule; the .srt text is the JAX tool's."""
    from moshi_tpu.tools import moshi_stt as jstt

    from moshi_tpu_torch.tools import moshi_stt as pstt
    voc = vocab(tmp_path / "tok.model", _STT_LM["text_card"])
    patch_tools(monkeypatch, jstt, pstt, _STT_LM, fmt=None, vocab_path=voc)
    cfg = write_config(tmp_path / "config.json", "stt", stt_config={
        "audio_delay_seconds": 0.5, "audio_silence_prefix_seconds": 0.16})
    wav = write_audio(tmp_path / "in.wav", 10, 11)
    srt = {k: str(tmp_path / f"{k}.srt") for k in ("jax", "port", "scan")}
    argv = ["-c", cfg, "-i", wav, "--synthetic", "--vad-threshold", "0.5"]
    jt = tape(monkeypatch, True)
    rc, jout = run_jax(jstt.main, argv + ["-s", srt["jax"]])
    assert rc == 0
    pt = tape(monkeypatch, False)
    rc, pout = run_port(pstt.main, argv + ["-s", srt["port"]])
    assert rc == 0
    rc, sout = run_port(pstt.main, argv + ["-s", srt["scan"], "--scan"])
    assert rc == 0
    text_card = _STT_LM["text_card"]
    ref, mine = frames_of(jt, text_card), frames_of(pt, text_card)
    n_frames = 2 + 10 + 8                  # prefix, input, flush
    assert len(ref) == n_frames and len(mine) == 3 * n_frames
    assert compared(ref, mine[:n_frames]) == n_frames
    assert pout.splitlines()[0] == sout.splitlines()[0] == \
        jout.splitlines()[0]
    assert len(pout.splitlines()[0]) > 0
    port_srt = open(srt["port"]).read()
    assert port_srt == open(srt["scan"]).read() == open(srt["jax"]).read()
    assert "-->" in port_srt


# ---------------------------------------------------------------------------
# personaplex
# ---------------------------------------------------------------------------

def test_personaplex_matches_jax(tmp_path, monkeypatch):
    """A voice .safetensors and -p: the primed frame count equals the JAX
    tool's, and the audio agrees under the gap rule."""
    from moshi_tpu.tools import personaplex as jpp

    from moshi_tpu_torch.tools import personaplex as ppp
    voc = vocab(tmp_path / "tok.model", _PP_LM["text_card"])
    patch_tools(monkeypatch, jpp, ppp, _PP_LM, seed=9, vocab_path=voc)
    cfg = write_config(tmp_path / "config.json", "personaplex")
    rng = np.random.default_rng(12)
    voice = str(tmp_path / "voice.safetensors")
    k = LMConfig(**_PP_LM).num_codebooks
    clen = LMConfig(**_PP_LM).cache_len
    save_safetensors(voice, {
        "voice.embeddings": (rng.normal(size=(3, _PP_LM["dim"])) * 0.05
                             ).astype(np.float32),
        "voice.cache": rng.integers(0, _PP_LM["card"], (k, clen),
                                    dtype=np.int32)})
    argv = ["-c", cfg, "--synthetic", "--voice", voice, "-p", "be nice",
            "--frames", "4"]
    with captured_audio(monkeypatch, jpp, ppp) as got:
        jt = tape(monkeypatch, True)
        rc, jout = run_jax(jpp.main, argv + ["-o", str(tmp_path / "j.wav")])
        assert rc == 0
        pt = tape(monkeypatch, False)
        rc, pout = run_port(ppp.main, argv + ["-o", str(tmp_path / "p.wav")])
        assert rc == 0
    assert pout.splitlines()[0] == jout.splitlines()[0]
    primed = int(pout.splitlines()[0].split()[1])
    assert primed == 3 + 2 * 6 + len(
        SentencePieceTokenizer.from_file(voc).encode(
            "<system> be nice <system>"))
    text_card = _PP_LM["text_card"]
    ref, mine = frames_of(jt, text_card), frames_of(pt, text_card)
    ref, mine = ref[-4:], mine[-4:]          # the session's frames
    n = compared(ref, mine)
    assert n >= 3, f"token streams diverged at frame {n}"
    assert_frames_close(got[1], got[0], n)


# ---------------------------------------------------------------------------
# no silent CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["mimi_encode", "mimi_decode", "mimi_play",
                                  "moshi_sts", "moshi_stt", "moshi_tts",
                                  "personaplex"])
def test_tools_raise_without_a_card(tool, tmp_path, monkeypatch):
    """Without --torch-device cpu a tool runs on the card, and raises when
    there is none."""
    import importlib
    mod = importlib.import_module(f"moshi_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = write_audio(tmp_path / "in.wav", 1, 1)
    mimi = str(tmp_path / "t.mimi")
    from moshi_tpu_torch.io.mimi_file import write_mimi_file
    write_mimi_file(mimi, np.zeros((2, 8), np.int16))
    argv = {"mimi_decode": ["-i", mimi], "mimi_play": ["-i", mimi],
            "moshi_tts": ["hello"]}.get(tool, ["-i", wav])
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main(argv + ["--synthetic"])


def test_moshi_sts_reads_mimi_from_the_config(tmp_path, monkeypatch):
    """Fixed (the reference's ``moshi_tpu/tools/common.py:91``): without
    --synthetic, moshi-sts reads Mimi's checkpoint from the config's
    ``mimi_name``; the JAX tool reads ``args.mimi_file``, which its
    parser never defines, and raises."""
    from moshi_tpu.tools import moshi_sts as jsts

    from moshi_tpu_torch.models import mimi as mimi_mod
    from moshi_tpu_torch.runtime.loader import save_mimi_gguf
    from moshi_tpu_torch.tools import moshi_sts as psts
    # the LMs as in patch_tools; Mimi through the tools' own loaders, at a
    # small width
    jcfg, jt, pcfg, pt = lm_trees(_STS_LM, "q4_k", 3)
    monkeypatch.setattr(jsts, "load_lm", lambda args, config: (jcfg, jt))
    monkeypatch.setattr(psts, "load_lm", lambda args, config: (pcfg, pt))
    small = dict(_MIMI, codebook_size=_STS_LM["card"],
                 seanet=SEANetConfig(**_SEANET))
    monkeypatch.setattr(mimi_mod, "MimiConfig",
                        lambda **kw: MimiConfig(**{**small, **kw}))
    _, pmimi = mimi_trees(_STS_LM["card"])
    save_mimi_gguf(str(tmp_path / "mimi.gguf"), pmimi,
                   MimiModel(MimiConfig(**small)))
    vocab(tmp_path / "tok.model", _STS_LM["text_card"])
    cfg = write_config(tmp_path / "config.json", "moshi",
                       mimi_name="mimi.gguf", tokenizer_name="tok.model")
    wav = write_audio(tmp_path / "in.wav", 2, 13)
    argv = ["-c", cfg, "-d", str(tmp_path), "-i", wav, "-o",
            str(tmp_path / "o.wav")]
    rc, out = run_port(psts.main, argv)
    assert rc == 0 and out.startswith(f"wrote {tmp_path / 'o.wav'}: 0.16s")
    with pytest.raises(AttributeError, match="mimi_file"):
        jsts.main(argv)
