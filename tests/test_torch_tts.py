"""The port's voice-conditioned TTS frame against the JAX package's, on the
CPU, and its parts.

* K7 (``quant/matmul.py`` ``glu_matmul``): its plain version against
  ``glu_matmul_pallas`` in interpret mode at 2, 8 and 12 rows, q4_k and
  q8_0, with and without the fused rms pre-norm.  Both form the same
  exact products of bf16-rounded activations and weights and differ only
  in the order of the f32 sums: <= 7.9e-7 of the output's largest value
  here (limit 1e-5, K8's); the gate rounded to bf16 before the silu reads
  >= 1.5e-3.
* Cross-attention: ``cross_attention_kv``, ``cross_mha``,
  ``transformer_cross_kv`` and ``voice_condition`` against JAX.
* The B = 1 TTS frame (``TTSPipeline.step_device`` with the device FSM,
  ``condition_sum`` and the cross K/V) at temp 0 over enough frames to
  pass ``delay_steps`` and wrap the temporal ring, in q4_k (K1, K5, K2,
  K3, K9, K11) and in dense bf16, whose depformer takes the generic form
  (K9 and K11 at its ring).  Decided tokens must be equal; limits as the
  pool test's (``test_torch_serving.py``): text logits 1e-5, depformer
  logits 5e-3, audio 1e-5.  Readings: text logits 1.8e-7 in both forms,
  depformer logits 9.9e-4 (q4_k) and 1.3e-3 (bf16), audio 9.0e-7.
* A dense bf16 STS frame through the generic depformer against JAX's.
* ``TTSModel.generate_wav`` / ``generate_wavs`` (the host FSM) against
  JAX's on a vocabulary written with ``save_model_proto``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.attention import MHAConfig as JaxMHAConfig
from moshi_tpu.nn.attention import cross_attention_kv as jax_cross_kv
from moshi_tpu.nn.attention import cross_mha as jax_cross_mha
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.nn.transformer import \
    transformer_cross_kv as jax_transformer_cross_kv
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.quant.pallas_matmul import glu_matmul_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn.attention import MHAConfig, cross_attention_kv, \
    cross_mha
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.nn.transformer import transformer_cross_kv
from moshi_tpu_torch.quant import matmul as pm
from moshi_tpu_torch.runtime.convert import params_from_numpy
from tests.test_torch_pipeline import _SEANET, _gap, _mimi_params, _np
from tests.test_torch_quant import _port_qt, _rel, _stacked_qt

# the tiny TTS class: cross-attention on, dep_q = n_q = 4, a 2-layer
# depformer, delays and delay_steps of the TTS kind, a 16-slot ring
_TTS = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
            card=64, n_q=4, dep_q=4, text_card=512, delays=(0, 0, 2, 2, 2),
            depformer_dim=256, depformer_heads=4, depformer_layers=2,
            depformer_hidden=576, depformer_low_rank=32,
            cross_attention=True, delay_steps=3)
_MIMI = dict(n_q=4, total_codebooks=8, dim=32, codebook_dim=16,
             codebook_size=64, transformer_layers=2, transformer_heads=4,
             transformer_context=16, transformer_hidden=64)
_FRAMES = 20          # past delay_steps + max_delay, and the ring wraps
_S, _DW = 3, 48       # synthetic voice: speaker rows, embedding width
_TOL = (1e-5, 5e-3)   # text logits, depformer logits
_AUDIO_TOL = 1e-5
_TOL_K7 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread hand-offs
    than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 8, 12])
@pytest.mark.parametrize("fmt,norm", [("q4_k", True), ("q4_k", False),
                                      ("q8_0", True), ("q8_0", False)])
def test_k7_plain_matches_pallas(m, fmt, norm):
    rng = np.random.default_rng(20)
    qt, fields = _stacked_qt(rng, fmt, (), 512, 256)
    x = rng.normal(0, 1, (m, 256)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (256,)).astype(np.float32) if norm else None
    ref = np.asarray(glu_matmul_pallas(
        jnp.asarray(x), qt, alpha=None if alpha is None
        else jnp.asarray(alpha), interpret=True))
    pqt = _port_qt(fields)
    a = None if alpha is None else torch.from_numpy(alpha)
    got = pm.glu_matmul(torch.from_numpy(x), pqt, alpha=a)
    assert got.shape == ref.shape == (m, 256)
    assert _rel(got, ref) < _TOL_K7
    # control: the gate rounded to bf16 before the silu
    gv = pm._dequant_product(torch.from_numpy(x), pqt.with_eff_scales(), 0,
                             a)
    ctl = pm._silu(gv[:, :256].bfloat16().float()) * gv[:, 256:]
    assert _rel(ctl, ref) > _TOL_K7


def test_k7_refuses_what_it_cannot_take():
    rng = np.random.default_rng(21)
    _, f40 = _stacked_qt(rng, "q4_0", (), 512, 256)
    with pytest.raises(ValueError, match="K7"):
        pm.glu_matmul(torch.zeros((2, 256)), _port_qt(f40))
    _, fst = _stacked_qt(rng, "q4_k", (2,), 512, 256)
    with pytest.raises(ValueError, match="flat"):
        pm.glu_matmul(torch.zeros((2, 256)), _port_qt(fst))


# ---------------------------------------------------------------------------
# cross-attention and voice conditioning
# ---------------------------------------------------------------------------

def _cross_params(rng, fmt):
    """A cross-attention block's params in both packages: a q4_k or bf16
    fused in_proj [3D, D] and out_proj [D, D]."""
    d = 256
    if fmt is None:
        w_in = (rng.normal(size=(3 * d, d)) * d ** -0.5).astype(np.float32)
        w_out = (rng.normal(size=(d, d)) * d ** -0.5).astype(np.float32)
        jp = {"in_proj": {"weight": jnp.asarray(w_in, jnp.bfloat16)},
              "out_proj": {"weight": jnp.asarray(w_out, jnp.bfloat16)}}
        return jp, params_from_numpy(_np(jp), device="cpu")
    jin, fin = _stacked_qt(rng, fmt, (), 3 * d, d)
    jout, fout = _stacked_qt(rng, fmt, (), d, d)
    jp = {"in_proj": {"weight": jin}, "out_proj": {"weight": jout}}
    return jp, {"in_proj": {"weight": _port_qt(fin)},
                "out_proj": {"weight": _port_qt(fout)}}


@pytest.mark.parametrize("fmt", ["q4_k", None], ids=["q4_k", "bf16"])
def test_cross_attention_matches_jax(fmt):
    """cross_attention_kv (bf16 operands, the product rounded to bf16)
    and cross_mha at T = 1 and 2 rows of B = 2 sessions: K/V bit-exact,
    the attention's output within 1e-5 of its largest value (f32 sums in
    another order; a q4_k query projection at one row takes K1 in both)."""
    rng = np.random.default_rng(22)
    jp, pp = _cross_params(rng, fmt)
    cond = rng.normal(size=(2, 5, 256)).astype(np.float32)
    jcfg = JaxMHAConfig(dim=256, num_heads=4, context=16)
    pcfg = MHAConfig(dim=256, num_heads=4, context=16)
    enable_pallas(True)
    try:
        with pallas_interpret():
            jkv = jax_cross_kv(jcfg, jp, jnp.asarray(cond))
            outs = {}
            for t in (1, 2):
                x = rng.normal(size=(2, t, 256)).astype(np.float32)
                outs[t] = (x, np.asarray(jax_cross_mha(jcfg, jp,
                                                       jnp.asarray(x), jkv)))
    finally:
        enable_pallas(False)
    pkv = cross_attention_kv(pcfg, pp, torch.from_numpy(cond))
    for name in ("k", "v"):
        assert pkv[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pkv[name].float().numpy(),
            np.asarray(jkv[name].astype(jnp.float32)))
    for t, (x, ref) in outs.items():
        got = cross_mha(pcfg, pp, torch.from_numpy(x), pkv)
        assert got.shape == ref.shape
        assert _rel(got, ref) < 1e-5, t


def _conditioners(rng, dim):
    """The conditioner tree as load_conditioners returns it (f32), drawn
    with numpy at synthetic widths."""
    def lut(rows, cd=24):
        return {"embed": rng.normal(size=(rows, cd)).astype(np.float32),
                "learnt_padding": rng.normal(size=(1, dim))
                .astype(np.float32),
                "output_proj": {"weight": (rng.normal(size=(dim, cd))
                                           * cd ** -0.5).astype(np.float32)}}
    return {"cfg": lut(7), "control": lut(1),
            "speaker_wavs": {
                "learnt_padding": rng.normal(size=(1, dim))
                .astype(np.float32),
                "output_proj": {"weight": (rng.normal(size=(dim, _DW))
                                           * _DW ** -0.5)
                                .astype(np.float32)}}}


def _voice(seed, dim=256):
    from moshi_tpu.models.tts import voice_condition as jax_voice
    rng = np.random.default_rng(seed)
    cond = _conditioners(rng, dim)
    wavs = rng.normal(size=(_S, _DW)).astype(np.float32)
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)
    jsum, jcross = jax_voice(jcond, jnp.asarray(wavs))
    return cond, wavs, np.asarray(jsum), np.asarray(jcross)


def test_voice_condition_matches_jax():
    from moshi_tpu_torch.models.tts import sin_embedding, voice_condition
    cond, wavs, jsum, jcross = _voice(23)
    psum, pcross = voice_condition(params_from_numpy(cond, device="cpu"),
                                   torch.from_numpy(wavs))
    assert psum.shape == jsum.shape == (1, 256)
    assert pcross.shape == jcross.shape == (1, 5 * _S, 256)
    assert _rel(psum, jsum) < 1e-6
    assert _rel(pcross, jcross) < 1e-6
    from moshi_tpu.models.tts import sin_embedding as jax_sin
    np.testing.assert_allclose(
        sin_embedding(torch.arange(7), 16).numpy(),
        np.asarray(jax_sin(jnp.arange(7), 16)), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the B = 1 TTS frame
# ---------------------------------------------------------------------------

def _tts_params(fmt, seed=5):
    cfg = JaxLMConfig(**_TTS)
    jp = jax_synth_lm_params(jax.random.PRNGKey(seed), cfg, fmt=fmt)
    return cfg, jp, params_from_numpy(_np(jp), device="cpu")


def _machine():
    from moshi_tpu.models.state_machine import StateMachine as JaxMachine
    from moshi_tpu_torch.models.state_machine import StateMachine
    kw = dict(text_card=_TTS["text_card"] + 1, max_padding=4,
              initial_padding=1)
    return JaxMachine(**kw), StateMachine(**kw)


_SCRIPT = [([10, 11], "hi", 1), ([12], "yo", 0), ([], "<break>", 2),
           ([14, 15, 16], "zzz", 1)]


def _entries(module):
    return [module.Entry(list(t), w, p) for t, w, p in _SCRIPT]


def _run_jax_frames(cfg, jp, mimi_params, cond_sum, cross, frames):
    """JAX's step_device frames at temp 0, with its logits recorded."""
    from moshi_tpu.models import state_machine as jsm
    from moshi_tpu.models.device_machine import (compile_script,
                                                 init_device_state)
    from moshi_tpu.runtime.pipeline import TTSPipeline as JaxTTSPipeline
    logged = []
    orig_sample = jax_lm.sample_token

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    jax_lm.sample_token = sample
    enable_pallas(True)
    out_frames = []
    try:
        with pallas_interpret():
            mimi = JaxMimiModel(JaxMimiConfig(
                seanet=JaxSEANetConfig(**_SEANET), **_MIMI))
            pipe = JaxTTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                                  mimi_dtype=jnp.float32)
            dm = pipe.enable_device_fsm(_machine()[0])
            script = compile_script([_entries(jsm)], dm)
            state = pipe.init_state(1, jax.random.PRNGKey(0))
            mstate = init_device_state(dm, script)
            ckv = (None if cross is None else jax_transformer_cross_kv(
                cfg.transformer, jp["transformer"], jnp.asarray(cross)))
            csum = None if cond_sum is None else jnp.asarray(cond_sum)
            for _ in range(frames):
                out, state, mstate = pipe.step_device(
                    mimi_params, jp, state, mstate, script,
                    condition_sum=csum, cross_kv=ckv)
                out_frames.append({k: np.asarray(v) for k, v in out.items()})
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return out_frames, logged


def _run_port_frames(pp, mimi_params, cond_sum, cross, frames):
    from moshi_tpu_torch.models import state_machine as psm
    from moshi_tpu_torch.models.device_machine import (compile_script,
                                                       init_device_state)
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    logged = []
    orig_sample = port_lm.sample_token

    def sample(logits, *a, **kw):
        logged.append(logits.numpy().copy())
        return orig_sample(logits, *a, **kw)

    cfg = port_lm.LMConfig(**_TTS)
    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    port_lm.sample_token = sample
    out_frames = []
    try:
        mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
        pipe = TTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                           mimi_dtype=torch.float32, device="cpu")
        dm = pipe.enable_device_fsm(_machine()[1])
        script = compile_script([_entries(psm)], dm, device="cpu")
        state = pipe.init_state(1)
        mstate = init_device_state(dm, script)
        ckv = (None if cross is None else transformer_cross_kv(
            cfg.transformer, pp["transformer"],
            torch.from_numpy(np.array(cross))))
        csum = (None if cond_sum is None
                else torch.from_numpy(np.array(cond_sum)))
        for _ in range(frames):
            out, state, mstate = pipe.step_device(
                mimi_params, pp, state, mstate, script, condition_sum=csum,
                cross_kv=ckv)
            out_frames.append({k: v.numpy() for k, v in out.items()})
    finally:
        port_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return out_frames, logged


@pytest.fixture(scope="module", params=["q4_k", None], ids=["q4_k", "bf16"])
def tts_frames(request):
    fmt = request.param
    cfg, jp, pp = _tts_params(fmt)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    mimi_np = _mimi_params(JaxMimiModel(mcfg), 4)
    _, _, cond_sum, cross = _voice(24)
    ref = _run_jax_frames(cfg, jp, mimi_np, cond_sum, cross, _FRAMES)
    got = _run_port_frames(pp, params_from_numpy(_np(mimi_np), device="cpu"),
                           cond_sum, cross, _FRAMES)
    return fmt, ref, got


def test_tts_frame_logits_and_tokens_match_jax(tts_frames):
    fmt, (rframes, rlog), (gframes, glog) = tts_frames
    per = 1 + _TTS["dep_q"]
    assert len(rlog) == len(glog) == _FRAMES * per
    decided = 0
    for i, (lr, lg) in enumerate(zip(rlog, glog)):
        dep = i % per > 0
        assert lg.shape == lr.shape
        assert _rel(lg, lr) < _TOL[dep], (i, _rel(lg, lr))
        ok = _gap(lr) > _TOL[dep]
        np.testing.assert_array_equal(np.argmax(lg, -1)[ok],
                                      np.argmax(lr, -1)[ok])
        decided += int(ok.sum())
    assert decided >= _FRAMES * per - 2
    for r, g in zip(rframes, gframes):
        for key in ("machine_text", "audio_tokens", "valid", "end_step",
                    "text"):
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
        err = np.max(np.abs(g["audio_out"] - r["audio_out"])) / max(
            np.max(np.abs(r["audio_out"])), 1e-30)
        assert err < _AUDIO_TOL
    # the frames passed the delay and the script ran: valid audio, and the
    # machine drove the text
    assert sum(bool(f["valid"][0]) for f in rframes) >= _FRAMES - 8
    assert {int(f["machine_text"][0]) for f in rframes} >= {10, 11, 12}


def test_tts_frame_runs_the_generic_paths(tts_frames, monkeypatch):
    """With cross-attention the temporal stack takes the generic layer
    path in both forms; the q4_k depformer is stacked, the bf16 one
    generic (the repaired fault: the port's depformer read a quantized
    weight's fields unconditionally)."""
    fmt = tts_frames[0]
    cfg = port_lm.LMConfig(**_TTS)
    _, _, pp = _tts_params(fmt)
    step_w = port_lm._per_step_weights(cfg, pp["depformer"])
    assert port_lm._can_use_dep_stacked(cfg, step_w, 1) == (fmt == "q4_k")
    from moshi_tpu_torch.nn.transformer import can_use_stacked_decode
    x = torch.zeros((1, 1, cfg.dim))
    assert not can_use_stacked_decode(cfg.transformer,
                                      pp["transformer"], x)


# ---------------------------------------------------------------------------
# C1: a dense depformer in the STS frame
# ---------------------------------------------------------------------------

_STS_DENSE = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512,
                  context=16, card=64, n_q=4, dep_q=2, text_card=512,
                  delays=(0, 0, 1, 1, 2), depformer_dim=256,
                  depformer_heads=4, depformer_layers=2,
                  depformer_hidden=576, depformer_low_rank=32)


def test_dense_sts_frame_through_the_generic_depformer():
    """lm_gen_step of a dense bf16 STS config against JAX's over 12 frames
    at temp 0: the dense depformer takes the generic form in both."""
    cfg = JaxLMConfig(**_STS_DENSE)
    jp = jax_synth_lm_params(jax.random.PRNGKey(6), cfg, fmt=None)
    pp = params_from_numpy(_np(jp), device="cpu")
    rng = np.random.default_rng(25)
    others = [rng.integers(0, 64, (1, 2)).astype(np.int32)
              for _ in range(12)]
    logged = []
    orig_sample = jax_lm.sample_token

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    jax_lm.sample_token = sample
    enable_pallas(True)
    ref = []
    try:
        with pallas_interpret():
            step = jax.jit(lambda p, s, o: jax_lm.lm_gen_step(
                cfg, p, s, other_audio=o, temp=0.0, temp_text=0.0))
            state = jax_lm.init_gen_state(cfg, 1)
            for o in others:
                out, state = step(jp, state, jnp.asarray(o))
                ref.append({k: np.asarray(v) for k, v in out.items()})
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
    plog = []
    psample = port_lm.sample_token

    def rec(logits, *a, **kw):
        plog.append(logits.numpy().copy())
        return psample(logits, *a, **kw)

    port_lm.sample_token = rec
    try:
        pcfg = port_lm.LMConfig(**_STS_DENSE)
        state = port_lm.init_gen_state(pcfg, 1, device="cpu")
        got = []
        for o in others:
            out, state = port_lm.lm_gen_step(
                pcfg, pp, state, other_audio=torch.from_numpy(o).long(),
                temp=0.0, temp_text=0.0)
            got.append({k: v.numpy() for k, v in out.items()})
    finally:
        port_lm.sample_token = psample
    assert len(plog) == len(logged) == 12 * 3
    for i, (lr, lg) in enumerate(zip(logged, plog)):
        assert _rel(lg, lr) < _TOL[i % 3 > 0], (i, _rel(lg, lr))
    for r, g in zip(ref, got):
        for key in ("text", "audio", "valid"):
            np.testing.assert_array_equal(g[key], r[key])


# ---------------------------------------------------------------------------
# TTSModel (the host FSM)
# ---------------------------------------------------------------------------

def _vocab(path):
    from moshi_tpu_torch.tokenizer import save_model_proto
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -2.0, 1)]
    pieces += [(f"▁{w}", -1.0, 1) for w in
               ("hello", "world", "again", "the", "end")]
    pieces += [(c, -5.0, 1) for c in "abcdefghijklmnopqrstuvwxyz"]
    path.write_bytes(save_model_proto(pieces))
    return str(path)


def test_tts_model_generate_wav_matches_jax(tmp_path):
    """One script (generate_wav) and two diverging ones (generate_wavs) on
    the dense tiny TTS class at temp 0: the same frame counts and waveforms
    as JAX's TTSModel."""
    from moshi_tpu.config import MoshiConfig as JaxMoshiConfig
    from moshi_tpu.models.tts import TTSModel as JaxTTSModel
    from moshi_tpu.tokenizer import SentencePieceTokenizer as JaxTok
    from moshi_tpu_torch.config import MoshiConfig
    from moshi_tpu_torch.models.tts import TTSModel
    from moshi_tpu_torch.tokenizer import SentencePieceTokenizer
    vocab = _vocab(tmp_path / "v.model")
    cfg, jp, pp = _tts_params(None, seed=7)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    mimi_np = _mimi_params(JaxMimiModel(mcfg), 4)
    jconf, pconf = JaxMoshiConfig(), MoshiConfig()
    for c in (jconf, pconf):
        c.lm_gen_config.temp = c.lm_gen_config.temp_text = 0.0
    scripts = [["hello world"], ["the end", "hello again world"]]
    enable_pallas(True)
    try:
        with pallas_interpret():
            jm = JaxTTSModel(cfg, jp, JaxMimiModel(mcfg), mimi_np,
                             JaxTok.from_file(vocab), jconf,
                             mimi_dtype=jnp.float32)
            ref_one = jm.generate_wav(scripts[0], max_frames=40)
            ref_two = jm.generate_wavs(scripts, max_frames=40)
    finally:
        enable_pallas(False)
    pm_ = TTSModel(port_lm.LMConfig(**_TTS), pp,
                   MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET),
                                        **_MIMI)),
                   params_from_numpy(_np(mimi_np), device="cpu"),
                   SentencePieceTokenizer.from_file(vocab), pconf,
                   mimi_dtype=torch.float32, device="cpu")
    got_one = pm_.generate_wav(scripts[0], max_frames=40)
    got_two = pm_.generate_wavs(scripts, max_frames=40)
    for (gw, gn), (rw, rn) in zip([got_one] + got_two,
                                  [ref_one] + ref_two):
        assert gn == rn
        assert gw.shape == rw.shape and gw.shape[0] > 0
        # frame by frame, as the pipeline tests compare the audio; over
        # these ~30 frames of one f32 decoder state the sums' order moves
        # one quiet frame by 1.21e-5 of its largest value (the others
        # <= 1.3e-6), so the limit is twice the frame tests'
        fs = pm_.pipe.frame_samples
        for g, r in zip(gw.reshape(-1, fs), rw.reshape(-1, fs)):
            err = np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-30)
            assert err < 2 * _AUDIO_TOL
