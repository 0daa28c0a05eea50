"""The port's offline scans (``STSPipeline.scan_frames``,
``STTPipeline.scan_frames``, ``_grow_rings``) against the JAX package's,
and against the port's own frame loop, on the CPU.

Sizes as ``tests/test_scan_offline.py``: a tiny Mimi whose transformer
context of 8 positions makes a 4-frame Mimi chunk, so that 12 frames take
three encode (and decode) calls; the LMs are the tiny q4_k STS of
``test_torch_pipeline.py`` (its card the Mimi's codebook size) and the
tiny dense STT of ``test_torch_stt.py``.  Mimi runs in f32, where the two
packages' codes agree exactly.  The JAX side runs its Pallas kernels in
interpret mode; the port, every kernel's plain version.  Inputs are
seeded numpy draws, weights the JAX package's synthetic ones carried
across by ``runtime/convert.py``.

Tolerances:
- texts, tokens and codes: equal; ``_grow_rings``: every ring bit equal.
- the decoded audio of equal tokens, port against JAX: f32 Mimi, sums in
  another order; each frame within ``_AUDIO_TOL`` of its largest value
  (as ``test_torch_pipeline.py``'s frames; readings 7.0e-7 from a fresh
  state, 7.5e-7 mid-stream).
- the VAD against JAX: ``_VAD_TOL`` absolute (``test_torch_stt.py``'s).
- the scan against the frame loop (both the port): the offline rings
  keep the oldest window keys that a streaming ring of context slots
  evicts during its two-position inserts, so the audio differs by more
  than rounding: ``_LOOP_ATOL`` absolute, the JAX package's own test's
  (readings 5.2e-3 at temp 0, 7.7e-3 at temp 0.8).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.nn.transformer import \
    transformer_cross_kv as jax_transformer_cross_kv
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime import pipeline as jax_pipeline
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.nn.transformer import transformer_cross_kv
from moshi_tpu_torch.runtime import pipeline
from moshi_tpu_torch.runtime.convert import params_from_numpy, \
    tensor_from_numpy
from tests.test_torch_pipeline import _LM, _SEANET, _mimi_params, _np
from tests.test_torch_stt import _KW as _STT

# test_scan_offline.py's Mimi (context 8: a 4-frame chunk), with the
# codebooks of the LMs' card
_MIMI = dict(n_q=4, total_codebooks=8, dim=32, codebook_dim=16,
             codebook_size=64, transformer_layers=1, transformer_heads=4,
             transformer_context=8, transformer_hidden=64)
_N = 12          # three Mimi chunks
_LEAD = 3        # streaming frames before a mid-stream scan
_AUDIO_TOL = 1e-5
_VAD_TOL = 1e-6
_LOOP_ATOL = 5e-2
# no other stream: every LM stream is generated (n_q = dep_q)
_LM_OWN = dict(_LM, dep_q=4)
# the STS LM with cross-attention (a voice-conditioned STS frame)
_LM_CROSS = dict(_LM, cross_attention=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread hand-offs
    than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _jax_mode():
    """The JAX package with its Pallas kernels in interpret mode, in its
    default (fused) mid-layer form."""
    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    enable_pallas(True)
    try:
        with pallas_interpret():
            yield
    finally:
        enable_pallas(False)
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old


def _mimi_cfgs():
    return (JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI),
            MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))


@pytest.fixture(scope="module")
def weights():
    """(JAX Mimi params, port Mimi params, {name: (JAX LM params, port LM
    params)}) for the STS, STT, no-other-stream and cross-attention LMs,
    and the audio frames [_N, 1, frame_samples]."""
    jm, _ = _mimi_cfgs()
    mimi_np = _mimi_params(JaxMimiModel(jm), 4)
    lms = {}
    for name, kw, fmt, seed in (("sts", _LM, "q4_k", 3),
                                ("stt", _STT, None, 8),
                                ("own", _LM_OWN, "q4_k", 9),
                                ("cross", _LM_CROSS, "q4_k", 10)):
        jp = jax_synth_lm_params(jax.random.PRNGKey(seed), JaxLMConfig(**kw),
                                 fmt=fmt)
        lms[name] = (jp, params_from_numpy(_np(jp), device="cpu"))
    rng = np.random.default_rng(11)
    fs = jm.seanet.hop_length * jm.frames_per_step
    audio = (rng.normal(size=(_N, 1, fs)) * 0.1).astype(np.float32)
    return mimi_np, params_from_numpy(_np(mimi_np), device="cpu"), lms, \
        audio


def _np_out(*xs):
    return [np.asarray(x) for x in xs]


def _jax_sts_pipe(kw):
    jm, _ = _mimi_cfgs()
    with _jax_mode():
        return jax_pipeline.STSPipeline(JaxMimiModel(jm), JaxLMConfig(**kw),
                                        temp=0.0, temp_text=0.0,
                                        mimi_dtype=jnp.float32)


def _jax_sts(pipe, mimi_np, jp, audio, lead=0):
    """JAX's STSPipeline at temp 0: ``lead`` streaming steps, then
    scan_frames of the rest -> (texts, tokens, audio) over all frames."""
    with _jax_mode():
        state = pipe.init_state(1, jax.random.PRNGKey(0))
        head = []
        for f in range(lead):
            out, state = pipe.step(mimi_np, jp, state, jnp.asarray(audio[f]))
            head.append(_np_out(out["text"], out["audio_tokens"],
                                out["audio_out"]))
        t, k, a, _ = pipe.scan_frames(mimi_np, jp, state,
                                      jnp.asarray(audio[lead:]))
        t, k, a = _np_out(t, k, a)
    return _joined(head, (t, k, a))


def _joined(head, scanned):
    if not head:
        return scanned
    return tuple(np.concatenate([np.stack([h[i] for h in head]), s])
                 for i, s in enumerate(scanned))


def _port_sts(kw, mparams, pp, audio, lead=0, temp=0.0, seed=0):
    """The port's STSPipeline, as ``_jax_sts``."""
    _, mc = _mimi_cfgs()
    pipe = pipeline.STSPipeline(MimiModel(mc), port_lm.LMConfig(**kw),
                                temp=temp, temp_text=temp,
                                mimi_dtype=torch.float32, device="cpu")
    state = pipe.init_state(1, seed=seed)
    head = []
    for f in range(lead):
        out, state = pipe.step(mparams, pp, state, torch.from_numpy(audio[f]))
        head.append(_np_out(out["text"], out["audio_tokens"],
                            out["audio_out"]))
    t, k, a, _ = pipe.scan_frames(mparams, pp, state,
                                  torch.from_numpy(audio[lead:]))
    return _joined(head, _np_out(t, k, a))


def _port_sts_loop(kw, mparams, pp, audio, temp=0.0, seed=0):
    """The port's STSPipeline.step over every frame."""
    _, mc = _mimi_cfgs()
    pipe = pipeline.STSPipeline(MimiModel(mc), port_lm.LMConfig(**kw),
                                temp=temp, temp_text=temp,
                                mimi_dtype=torch.float32, device="cpu")
    state = pipe.init_state(1, seed=seed)
    outs = []
    for a in audio:
        out, state = pipe.step(mparams, pp, state, torch.from_numpy(a))
        outs.append(_np_out(out["text"], out["audio_tokens"],
                            out["audio_out"]))
    return tuple(np.stack([o[i] for o in outs]) for i in range(3))


def _audio_err(got, ref):
    """The largest per-frame error relative to the frame's largest
    value."""
    return max(float(np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-30))
               for g, r in zip(got.reshape(-1, got.shape[-1]),
                               ref.reshape(-1, ref.shape[-1])))


def _clip(lead):
    """The frames of a run: all _N from a fresh state; after ``_LEAD``
    streaming steps, a scan of 8 (two whole Mimi chunks: JAX compiles no
    program of another length)."""
    return _N if lead == 0 else lead + 8


@pytest.fixture(scope="module")
def sts_runs(weights):
    """JAX's and the port's STS scans, from a fresh state and after
    ``_LEAD`` streaming steps, at temp 0."""
    mimi_np, mparams, lms, audio = weights
    jp, pp = lms["sts"]
    pipe = _jax_sts_pipe(_LM)
    return {lead: (_jax_sts(pipe, mimi_np, jp, audio[:_clip(lead)], lead),
                   _port_sts(_LM, mparams, pp, audio[:_clip(lead)], lead))
            for lead in (0, _LEAD)}


@pytest.mark.parametrize("lead", [0, _LEAD], ids=["fresh", "mid_stream"])
def test_sts_scan_matches_jax(sts_runs, lead):
    """Texts and tokens equal, the audio within ``_AUDIO_TOL``; with a lead
    the scan enters a streaming state, its Mimi rings grown."""
    (rt, rk, ra), (gt, gk, ga) = sts_runs[lead]
    n = _clip(lead)
    assert gt.shape == (n, 1) and gk.shape == (n, 1, _LM["dep_q"])
    assert ga.shape == ra.shape == (n, 1, 96) and ga.dtype == np.float32
    np.testing.assert_array_equal(gt, rt)
    np.testing.assert_array_equal(gk, rk)
    assert (gk >= 0).any()              # past the delays, tokens come
    assert np.all(np.isfinite(ga))
    assert _audio_err(ga, ra) < _AUDIO_TOL


def test_sts_scan_without_an_other_stream_matches_jax(weights):
    """n_q = dep_q: both packages take the per-frame fused scan."""
    mimi_np, mparams, lms, audio = weights
    jp, pp = lms["own"]
    rt, rk, ra = _jax_sts(_jax_sts_pipe(_LM_OWN), mimi_np, jp, audio[:4])
    gt, gk, ga = _port_sts(_LM_OWN, mparams, pp, audio[:4])
    assert gk.shape == (4, 1, 4)
    np.testing.assert_array_equal(gt, rt)
    np.testing.assert_array_equal(gk, rk)
    assert _audio_err(ga, ra) < _AUDIO_TOL


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_sts_scan_matches_the_port_frame_loop(weights, temp):
    """The scan against ``step`` frame by frame, one seed: texts and tokens
    equal (at temp > 0 both draw from the state's generator in the same
    order), the audio within ``_LOOP_ATOL``."""
    _, mparams, lms, audio = weights
    pp = lms["sts"][1]
    gt, gk, ga = _port_sts(_LM, mparams, pp, audio, temp=temp, seed=5)
    lt, lk, la = _port_sts_loop(_LM, mparams, pp, audio, temp=temp, seed=5)
    np.testing.assert_array_equal(gt, lt)
    np.testing.assert_array_equal(gk, lk)
    np.testing.assert_allclose(ga, la, atol=_LOOP_ATOL)


def test_sts_scan_state_goes_on(weights):
    """A scan's state continues with another scan: the same outputs as one
    scan over both clips."""
    _, mparams, lms, audio = weights
    pp = lms["sts"][1]
    _, mc = _mimi_cfgs()
    pipe = pipeline.STSPipeline(MimiModel(mc), port_lm.LMConfig(**_LM),
                                temp=0.0, temp_text=0.0,
                                mimi_dtype=torch.float32, device="cpu")
    whole = pipe.scan_frames(mparams, pp, pipe.init_state(1),
                             torch.from_numpy(audio[:8]))
    state = pipe.init_state(1)
    parts = []
    for clip in (audio[:4], audio[4:8]):
        *out, state = pipe.scan_frames(mparams, pp, state,
                                       torch.from_numpy(clip))
        parts.append(out)
    for i in range(3):
        torch.testing.assert_close(torch.cat([p[i] for p in parts]),
                                   whole[i], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# STT
# ---------------------------------------------------------------------------

def _jax_stt(pipe, mimi_np, jp, audio, lead=0):
    with _jax_mode():
        state = pipe.init_state(1, jax.random.PRNGKey(0))
        head = []
        for f in range(lead):
            out, state = pipe.step(mimi_np, jp, state, jnp.asarray(audio[f]))
            head.append(_np_out(out["text"], out["vad"]))
        t, v, _ = pipe.scan_frames(mimi_np, jp, state,
                                   jnp.asarray(audio[lead:]))
    return _joined(head, _np_out(t, v))


def _port_stt(mparams, pp, audio, lead=0, loop=False, temp=0.0):
    _, mc = _mimi_cfgs()
    pipe = pipeline.STTPipeline(MimiModel(mc), port_lm.LMConfig(**_STT),
                                temp_text=temp, mimi_dtype=torch.float32,
                                device="cpu")
    state = pipe.init_state(1, seed=2)
    head = []
    for f in range(len(audio) if loop else lead):
        out, state = pipe.step(mparams, pp, state, torch.from_numpy(audio[f]))
        head.append(_np_out(out["text"], out["vad"]))
    if loop:
        return tuple(np.stack([h[i] for h in head]) for i in range(2))
    t, v, _ = pipe.scan_frames(mparams, pp, state,
                               torch.from_numpy(audio[lead:]))
    return _joined(head, _np_out(t, v))


@pytest.fixture(scope="module")
def jax_stt_pipe():
    jm, _ = _mimi_cfgs()
    with _jax_mode():
        return jax_pipeline.STTPipeline(JaxMimiModel(jm),
                                        JaxLMConfig(**_STT),
                                        mimi_dtype=jnp.float32)


@pytest.mark.parametrize("lead", [0, _LEAD], ids=["fresh", "mid_stream"])
def test_stt_scan_matches_jax(weights, jax_stt_pipe, lead):
    """Texts equal, the VAD [N, B] within ``_VAD_TOL``."""
    mimi_np, mparams, lms, audio = weights
    jp, pp = lms["stt"]
    audio = audio[:_clip(lead)]
    rt, rv = _jax_stt(jax_stt_pipe, mimi_np, jp, audio, lead)
    gt, gv = _port_stt(mparams, pp, audio, lead)
    assert gt.shape == gv.shape == (len(audio), 1)
    assert gv.dtype == np.float32
    np.testing.assert_array_equal(gt, rt)
    assert float(np.max(np.abs(gv - rv))) < _VAD_TOL


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_stt_scan_matches_the_port_frame_loop(weights, temp):
    _, mparams, lms, audio = weights
    pp = lms["stt"][1]
    gt, gv = _port_stt(mparams, pp, audio, temp=temp)
    lt, lv = _port_stt(mparams, pp, audio, loop=True, temp=temp)
    np.testing.assert_array_equal(gt, lt)
    np.testing.assert_allclose(gv, lv, atol=_LOOP_ATOL)


# ---------------------------------------------------------------------------
# _grow_rings, _offline_mimi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offsets", [(0, 3), (3, 21), (21, 0), (8, 16)],
                         ids=["fresh_and_below", "below_and_past",
                              "past_and_fresh", "full_and_twice"])
def test_grow_rings_matches_jax_bit_for_bit(offsets):
    """B = 2 sessions at their own offsets (never written, below the
    8-slot ring, past it): every slot of the 16-slot rings equal to JAX's,
    never-written slots zero."""
    rng = np.random.default_rng(sum(offsets))
    shape = (2, 2, 8, 3, 4)                      # [L, B, cap, H, hd]
    ring = {n: jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
            for n in ("k", "v")}
    off = np.asarray(offsets, np.int32)
    ref = jax_pipeline._grow_rings(ring, jnp.asarray(off), 16)
    got = pipeline._grow_rings(
        {n: tensor_from_numpy(np.asarray(a), "cpu") for n, a in ring.items()},
        torch.from_numpy(off), 16)
    for n in ("k", "v"):
        r = tensor_from_numpy(np.asarray(ref[n]), "cpu")
        assert got[n].shape == (2, 2, 16, 3, 4) and got[n].is_contiguous()
        assert torch.equal(got[n].view(torch.int16), r.view(torch.int16))
    for b, o in enumerate(offsets):
        # the slots of positions never written (and past the window) are 0
        held = {p % 16 for p in range(max(o - 8, 0), o)}
        for slot in set(range(16)) - held:
            assert not got["k"][:, b, slot].any()


def test_grow_rings_keeps_a_ring_of_that_size():
    ring = {"k": torch.ones(1, 1, 4, 1, 2), "v": torch.ones(1, 1, 4, 1, 2)}
    assert pipeline._grow_rings(ring, torch.tensor([9]), 4) is ring


def test_offline_mimi_and_chunk_match_jax():
    """The offline Mimi's capacity (context + chunk x frames_per_step) and
    the chunk, for the tiny Mimi and the real one (250 + 125 x 2)."""
    jm, mc = _mimi_cfgs()
    for jcfg, pcfg, chunk in ((jm, mc, 4),
                              (JaxMimiConfig(), MimiConfig(), 125)):
        off = pipeline._OfflineMimi(MimiModel(pcfg), torch.float32)
        ref = jax_pipeline._offline_mimi(JaxMimiModel(jcfg), chunk)
        assert off.chunk == chunk
        assert off.cap == ref.cfg.transformer.mha.cap == \
            pcfg.transformer_context + 2 * chunk
        assert pipeline._offline_mimi(MimiModel(pcfg), chunk).cfg \
            .transformer.mha.cap == off.cap
    assert off.cap == 500


# ---------------------------------------------------------------------------
# STSPipeline.step with cross-attention
# ---------------------------------------------------------------------------

def test_sts_step_with_cross_attention_matches_jax(weights):
    """``step``'s ``cross_kv`` (and ``condition_sum``) reach the LM frame:
    a cross-attention STS LM with a synthetic voice over 6 frames at temp
    0, against JAX's: texts and tokens equal, the audio within
    ``_AUDIO_TOL``; without the cross K/V the port's tokens change."""
    from tests.test_torch_tts import _voice
    mimi_np, mparams, lms, audio = weights
    jp, pp = lms["cross"]
    _, _, csum, cross = _voice(24)
    jm, mc = _mimi_cfgs()
    cfg = JaxLMConfig(**_LM_CROSS)
    ref = []
    with _jax_mode():
        pipe = jax_pipeline.STSPipeline(JaxMimiModel(jm), cfg, temp=0.0,
                                        temp_text=0.0,
                                        mimi_dtype=jnp.float32)
        state = pipe.init_state(1, jax.random.PRNGKey(0))
        ckv = jax_transformer_cross_kv(cfg.transformer, jp["transformer"],
                                       jnp.asarray(cross))
        for a in audio[:6]:
            out, state = pipe.step(mimi_np, jp, state, jnp.asarray(a),
                                   jnp.asarray(csum), ckv)
            ref.append(_np_out(out["text"], out["audio_tokens"],
                               out["audio_out"]))
    pcfg = port_lm.LMConfig(**_LM_CROSS)
    ckv = transformer_cross_kv(pcfg.transformer, pp["transformer"],
                               torch.from_numpy(cross.copy()))
    runs = {}
    for name, kv in (("voice", ckv), ("no cross K/V", None)):
        pipe = pipeline.STSPipeline(MimiModel(mc), pcfg, temp=0.0,
                                    temp_text=0.0, mimi_dtype=torch.float32,
                                    device="cpu")
        state = pipe.init_state(1)
        runs[name] = []
        for a in audio[:6]:
            out, state = pipe.step(mparams, pp, state, torch.from_numpy(a),
                                   condition_sum=torch.from_numpy(csum.copy()),
                                   cross_kv=kv)
            runs[name].append(_np_out(out["text"], out["audio_tokens"],
                                      out["audio_out"]))
    for r, g in zip(ref, runs["voice"]):
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])
        assert _audio_err(g[2], r[2]) < _AUDIO_TOL
    assert any(not np.array_equal(a[1], b[1]) or not np.array_equal(
        a[0], b[0]) for a, b in zip(runs["voice"], runs["no cross K/V"]))
