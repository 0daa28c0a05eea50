"""The port's frames under ``MOSHI_TPU_MEGAKERNEL`` against the JAX
package's, on the CPU, beside ``test_torch_megakernel.py`` (whose helpers
and limits these share): ``lm_gen_step`` under ``all`` at temp > 0 with
JAX's Gumbel noise fed to both packages' samplers (K13 with K14c, and
with K14a at a card of 192), ``STSPipeline`` under ``all``, and the TTS
frame under ``dep``, which takes the frame kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.pipeline import STSPipeline as JaxSTSPipeline
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn import depformer as port_dep
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.pipeline import STSPipeline
from test_torch_lm import export_numpy
from test_torch_megakernel import _SAMPLED, check_lm_step
from test_torch_pipeline import _LM, _MIMI, _SEANET, _mimi_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", _SAMPLED)
def test_lm_step_under_megakernel_samples_as_jax(case):
    check_lm_step(case, "sampled")


def test_sts_pipeline_under_all_matches_jax(monkeypatch):
    """``STSPipeline.init_state(..., lm_params=)`` under ``all`` picks the
    flat layout, and 6 frames at temp 0 (Mimi encode, K13, K14a at this
    card of 64, Mimi decode) match JAX's."""
    monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", "all")
    cfg = JaxLMConfig(**_LM)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    lm_params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
    mimi_params = _mimi_params(JaxMimiModel(mcfg), 4)
    rng = np.random.default_rng(5)
    fs = mcfg.seanet.hop_length * mcfg.frames_per_step
    audio = [(rng.normal(size=(1, fs)) * 0.1).astype(np.float32)
             for _ in range(6)]
    ref = []
    jax.clear_caches()
    enable_pallas(True)
    try:
        with pallas_interpret():
            pipe = JaxSTSPipeline(JaxMimiModel(mcfg), cfg, temp=0.0,
                                  temp_text=0.0, mimi_dtype=jnp.float32)
            state = pipe.init_state(1, jax.random.PRNGKey(2),
                                    lm_params=lm_params)
            assert state["lm"]["transformer"]["k"].ndim == 3
            for a in audio:
                out, state = pipe.step(mimi_params, lm_params, state, a)
                ref.append({k: np.asarray(v) for k, v in out.items()})
    finally:
        enable_pallas(False)
        jax.clear_caches()
    pparams = params_from_numpy(export_numpy(lm_params), device="cpu")
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    pipe = STSPipeline(mimi, port_lm.LMConfig(**_LM), temp=0.0,
                       temp_text=0.0, mimi_dtype=torch.float32,
                       device="cpu")
    state = pipe.init_state(1, seed=2, lm_params=pparams)
    assert state["lm"]["transformer"]["k"].shape == (2, 128, 256)
    mparams = params_from_numpy(export_numpy(mimi_params), device="cpu")
    for f, a in enumerate(audio):
        out, state = pipe.step(mparams, pparams, state, torch.from_numpy(a))
        for key in ("text", "audio_tokens", "valid"):
            np.testing.assert_array_equal(out[key].numpy(), ref[f][key])
        err = (np.max(np.abs(out["audio_out"].numpy() - ref[f]["audio_out"]))
               / max(np.max(np.abs(ref[f]["audio_out"])), 1e-30))
        assert err < 1e-5, (f, err)


def test_tts_frame_under_dep_takes_the_frame_kernel(monkeypatch):
    """The TTS class meets the frame kernel's preconditions (card 2048,
    dep_q 32 over a 32-slot ring), so under ``dep`` its B = 1 frame takes
    K14c in both packages.  ``test_torch_tts.py``'s tiny TTS frame
    (``step_device`` with a voice and the device FSM) with card 256 (and
    Mimi's codebooks to match), 8 frames at temp 0: the text logits, the
    tokens and the audio as that test holds them, one K14c per frame."""
    import test_torch_tts as tts_t
    monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", "dep")
    monkeypatch.setattr(tts_t, "_TTS", {**tts_t._TTS, "card": 256})
    monkeypatch.setattr(tts_t, "_MIMI", {**tts_t._MIMI,
                                         "codebook_size": 256})
    cfg, jp, pp = tts_t._tts_params("q4_k")
    pcfg = port_lm.LMConfig(**tts_t._TTS)
    dep = pp["depformer"]
    assert port_lm._can_use_dep_frame_kernel(
        pcfg, dep, port_lm._per_step_weights(pcfg, dep), 1)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **tts_t._MIMI)
    mimi_np = _mimi_params(JaxMimiModel(mcfg), 4)
    _, _, cond_sum, cross = tts_t._voice(24)
    jax.clear_caches()
    try:
        rframes, rlog = tts_t._run_jax_frames(cfg, jp, mimi_np, cond_sum,
                                              cross, 8)
    finally:
        jax.clear_caches()
    calls = []
    plain = port_dep.dep_frame_step_plain
    monkeypatch.setattr(port_dep, "dep_frame_step_plain",
                        lambda *a, **k: (calls.append(1), plain(*a, **k))[1])
    gframes, glog = tts_t._run_port_frames(
        pp, params_from_numpy(export_numpy(mimi_np), device="cpu"), cond_sum,
        cross, 8)
    assert len(calls) == 8 and len(rlog) == len(glog) == 8
    for lr, lg in zip(rlog, glog):
        assert tts_t._rel(lg, lr) < tts_t._TOL[0]
    for r, g in zip(rframes, gframes):
        for key in ("machine_text", "audio_tokens", "valid", "text"):
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
        err = np.max(np.abs(g["audio_out"] - r["audio_out"])) / max(
            np.max(np.abs(r["audio_out"])), 1e-30)
        assert err < tts_t._AUDIO_TOL
