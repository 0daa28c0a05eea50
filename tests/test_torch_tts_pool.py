"""The port's batched TTS (``runtime/serving.py`` ``TTSSessionPool``) and its
device-side text StateMachine (``models/device_machine.py``) against the
JAX package's, on the CPU.

* ``device_machine_step`` against JAX's on three diverging scripts over
  40 steps, with and without the second-stream lookahead, with slots
  masked inactive at some steps: every output token and state row equal.
* ``TTSSessionPool`` at B = 3 on the tiny q4_k TTS class of
  ``test_torch_tts.py`` (cross-attention on, so the temporal stack takes
  the generic path and its GLUs K7 at three rows; the depformer the
  stacked dequant kernels), at temp 0, on the scripts of
  ``tests/test_serving.py``: per tick (``tick``) the text tokens the
  machine forced, the audio tokens, ``valid`` and ``done`` equal to JAX's
  and the audio within 1e-5 of its largest value; per chunk
  (``tick_chunk`` after ``attach_many``) the same audio, ``valid`` and
  completion frame as JAX's.  The logits sampled on the way read within
  5e-5 (text, see ``_TOL``) and 5e-3 (depformer) of JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
from moshi_tpu.models import device_machine as jdm
from moshi_tpu.models import state_machine as jsm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.pipeline import TTSPipeline as JaxTTSPipeline
from moshi_tpu.runtime.serving import TTSSessionPool as JaxTTSSessionPool
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import device_machine as pdm
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models import state_machine as psm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.pipeline import TTSPipeline
from moshi_tpu_torch.runtime.serving import TTSSessionPool
from tests.test_torch_pipeline import _SEANET, _mimi_params, _np
from tests.test_torch_tts import _MIMI, _TTS

_B = 3
# Text logits: every product of the B = 3 frame takes the dequant kernels
# (exact products, f32 sums in another order: <= 2.9e-6 here), but once
# in these ticks a slot's text logits read 1.3e-5 of their largest value.
# The cause is not isolated; one flipped bf16 activation rounding, which a
# last-bit difference in a fused rms norm causes in the normed dequant
# products (chip_smoke.py's dequant_norm class), moves a logit that much.
# Hence 5e-5.  Depformer logits as in test_torch_serving.py.
_TOL = (5e-5, 5e-3)       # text logits, depformer logits
_AUDIO_TOL = 1e-5
_TICKS = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread hand-offs
    than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the scripts of tests/test_serving.py
_SCRIPTS = {
    "a": [([10, 11], "hi", 1), ([12], "yo", 0)],
    "b": [([13], "x", 0), ([], "<break>", 2), ([14, 15, 16], "zzz", 1)],
}
_CHUNK_SCRIPTS = {
    "a": [([10, 11], "hi", 1), ([12], "yo", 0)],
    "b": [([13], "x", 0), ([14, 15], "zz", 1)],
}


def _entries(module, script):
    return [module.Entry(list(t), w, p) for t, w, p in script]


# ---------------------------------------------------------------------------
# the device StateMachine
# ---------------------------------------------------------------------------

_DM_SCRIPTS = [
    [([5, 6], "ab", 1), ([], "<break>", 3), ([7], "c", 0), ([8, 9, 10], "d", 2)],
    [([11], "e", 0)],
    [([12, 13, 14, 15], "f", 0), ([16], "g", 4), ([17, 18], "h", 1),
     ([], "<break>", 1), ([19], "i", 0)],
]


@pytest.mark.parametrize("ahead", [0, 2])
def test_device_machine_step_matches_jax(ahead):
    kw = dict(card=513, second_stream_ahead=ahead, max_padding=3,
              initial_padding=1)
    jcfg, pcfg = jdm.DeviceMachineConfig(**kw), pdm.DeviceMachineConfig(**kw)
    jscript = jdm.compile_script(
        [_entries(jsm, s) for s in _DM_SCRIPTS], jcfg, pad_to=(16, 8))
    pscript = pdm.compile_script(
        [_entries(psm, s) for s in _DM_SCRIPTS], pcfg, pad_to=(16, 8),
        device="cpu")
    for k, v in jscript.items():
        np.testing.assert_array_equal(pscript[k].numpy(), np.asarray(v),
                                      err_msg=k)
    jst, pst = jdm.init_device_state(jcfg, jscript), \
        pdm.init_device_state(pcfg, pscript)
    rng = np.random.default_rng(30)
    step_fn = jax.jit(lambda s, st, step, tok, act: jdm.device_machine_step(
        jcfg, s, st, step, tok, act))
    ends = set()
    for step in range(_TICKS):
        # mostly PAD, sometimes NEW_WORD or another token (sanitized)
        tok = rng.choice([3, 3, 3, 0, 42], size=_B).astype(np.int32)
        act = rng.random(_B) > 0.15
        steps = np.full((_B,), step, np.int32)
        jout, jst = step_fn(jscript, jst, jnp.asarray(steps),
                            jnp.asarray(tok), jnp.asarray(act))
        pout, pst = pdm.device_machine_step(
            pcfg, pscript, pst, torch.from_numpy(steps),
            torch.from_numpy(tok), torch.from_numpy(act))
        np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
        for k, v in jst.items():
            np.testing.assert_array_equal(pst[k].numpy(), np.asarray(v),
                                          err_msg=(step, k))
        ends.update(np.nonzero(np.asarray(jst["end_step"]) >= 0)[0])
    assert ends == {0, 1, 2}          # every script ran to its end


def test_compile_script_refuses_a_script_over_capacity():
    cfg = pdm.DeviceMachineConfig(card=513)
    with pytest.raises(ValueError, match="capacity"):
        pdm.compile_script([_entries(psm, _DM_SCRIPTS[2])], cfg,
                           pad_to=(4, 8), device="cpu")


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class _Recorder:
    """Wraps a pipeline's step_device to keep each frame's forced text and
    audio tokens (the pool returns neither)."""

    def __init__(self, pipe, to_np):
        self.frames = []
        step = pipe.step_device

        def recorded(*a, **kw):
            out, state, mstate = step(*a, **kw)
            self.frames.append({k: to_np(out[k]) for k in
                                ("machine_text", "audio_tokens")})
            return out, state, mstate

        pipe.step_device = recorded


def _drive(pool, module, logged, barrier=lambda: None):
    """``tick`` until both sessions are done: "a" attaches at tick 0, "b"
    at tick 3 (and "c", a script of one word, at tick 5 into the third
    slot).  Returns per tick the results and the logits sampled."""
    ticks = []
    for t in range(_TICKS):
        for tt, sid in ((0, "a"), (3, "b"), (5, "c")):
            if tt == t:
                script = _SCRIPTS.get(sid, [([17], "w", 0)])
                pool.attach(sid, _entries(module, script))
        n0 = len(logged)
        slots = list(pool._by_session.values())
        outs = pool.tick()
        barrier()
        ticks.append({"outs": outs, "logits": logged[n0:], "slots": slots})
        if not pool.active and t > 5:
            break
    return ticks


def _chunks(pool, module):
    pool.attach_many({sid: _entries(module, s)
                      for sid, s in _CHUNK_SCRIPTS.items()})
    got = {sid: {"audio": [], "valid": []} for sid in _CHUNK_SCRIPTS}
    done = {}
    for _ in range(12):
        if not pool.active:
            break
        for sid, r in pool.tick_chunk(4).items():
            got[sid]["audio"].extend(list(r["audio_out"]))
            got[sid]["valid"].extend(list(r["valid"]))
            if r["done"]:
                done[sid] = len(got[sid]["valid"])
    return got, done


def _machines():
    kw = dict(text_card=_TTS["text_card"] + 1, max_padding=4,
              initial_padding=1)
    return jsm.StateMachine(**kw), psm.StateMachine(**kw)


def _run_jax(cfg, lm_params, mimi_params):
    mimi = JaxMimiModel(JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET),
                                      **_MIMI))
    logged = []
    orig_sample = jax_lm.sample_token

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    jax_lm.sample_token = sample
    enable_pallas(True)
    try:
        with pallas_interpret():
            pipe = JaxTTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                                  mimi_dtype=jnp.float32)
            pool = JaxTTSSessionPool(pipe, _machines()[0], mimi_params,
                                     lm_params, batch=_B, max_tokens=32,
                                     max_entries=8)
            rec = _Recorder(pipe, np.asarray)
            ticks = _drive(pool, jsm, logged, jax.effects_barrier)
            frames = list(rec.frames)
            pool = JaxTTSSessionPool(pipe, _machines()[0], mimi_params,
                                     lm_params, batch=_B, max_tokens=32,
                                     max_entries=8)
            chunks = _chunks(pool, jsm)
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return ticks, frames, chunks


def _run_port(lm_params, mimi_params):
    cfg = port_lm.LMConfig(**_TTS)
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    logged = []
    orig_sample = port_lm.sample_token

    def sample(logits, *a, **kw):
        logged.append(logits.numpy().copy())
        return orig_sample(logits, *a, **kw)

    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    port_lm.sample_token = sample
    try:
        pipe = TTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                           mimi_dtype=torch.float32, device="cpu")
        pool = TTSSessionPool(pipe, _machines()[1], mimi_params, lm_params,
                              batch=_B, max_tokens=32, max_entries=8)
        rec = _Recorder(pipe, lambda t: t.numpy())
        ticks = _drive(pool, psm, logged)
        frames = list(rec.frames)      # tick_chunk's frames come next
        pool = TTSSessionPool(pipe, _machines()[1], mimi_params, lm_params,
                              batch=_B, max_tokens=32, max_entries=8)
        chunks = _chunks(pool, psm)
    finally:
        port_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return ticks, frames, chunks


@pytest.fixture(scope="module")
def pools():
    cfg = JaxLMConfig(**_TTS)
    jp = jax_synth_lm_params(jax.random.PRNGKey(8), cfg, fmt="q4_k")
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    mimi_np = _mimi_params(JaxMimiModel(mcfg), 4)
    ref = _run_jax(cfg, jp, mimi_np)
    got = _run_port(params_from_numpy(_np(jp), device="cpu"),
                    params_from_numpy(_np(mimi_np), device="cpu"))
    return ref, got


def test_tts_pool_ticks_match_jax(pools):
    (rticks, rframes, _), (gticks, gframes, _) = pools
    assert len(gticks) == len(rticks)
    assert len(gframes) == len(rframes) == len(rticks)
    for rf, gf in zip(rframes, gframes):
        for key in ("machine_text", "audio_tokens"):
            np.testing.assert_array_equal(gf[key], rf[key], err_msg=key)
    done = set()
    for t, (r, g) in enumerate(zip(rticks, gticks)):
        assert set(g["outs"]) == set(r["outs"]), t
        for sid, ro in r["outs"].items():
            go = g["outs"][sid]
            assert (go["valid"], go["done"]) == (ro["valid"], ro["done"]), \
                (t, sid)
            err = np.max(np.abs(go["audio_out"] - ro["audio_out"])) / max(
                np.max(np.abs(ro["audio_out"])), 1e-30)
            assert err < _AUDIO_TOL, (t, sid, err)
            if go["done"]:
                done.add(sid)
        per = 1 + _TTS["dep_q"]
        assert len(g["logits"]) == len(r["logits"]) == per
        live = r["slots"]                # a free slot's rows run on idle
        assert g["slots"] == live
        for i, (lr, lg) in enumerate(zip(r["logits"], g["logits"])):
            err = (np.max(np.abs(lg - lr), -1)
                   / np.max(np.abs(lr), -1))[live]
            assert np.all(err < _TOL[i > 0]), (t, i, err)
    assert done == {"a", "b", "c"}       # every session drained and left
    assert any(o["valid"] for tk in gticks for o in tk["outs"].values())


def test_tts_pool_chunks_match_jax(pools):
    (_, _, (rgot, rdone)), (_, _, (ggot, gdone)) = pools
    assert gdone == rdone and set(gdone) == set(_CHUNK_SCRIPTS)
    for sid in _CHUNK_SCRIPTS:
        np.testing.assert_array_equal(np.asarray(ggot[sid]["valid"], bool),
                                      np.asarray(rgot[sid]["valid"], bool))
        g, r = np.stack(ggot[sid]["audio"]), np.stack(rgot[sid]["audio"])
        assert g.shape == r.shape
        assert np.max(np.abs(g - r)) <= _AUDIO_TOL * max(
            np.max(np.abs(r)), 1e-30)


def test_tts_pool_capacity_guard():
    """A full pool refuses another session, and a script over the pool's
    capacity is refused at attach, with the pool unchanged."""
    cfg = port_lm.LMConfig(**_TTS)
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    from moshi_tpu_torch.runtime.synth import (synth_lm_params,
                                               synth_mimi_params)
    pipe = TTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                       mimi_dtype=torch.float32, device="cpu")
    pool = TTSSessionPool(pipe, _machines()[1],
                          synth_mimi_params(mimi.cfg, device="cpu"),
                          synth_lm_params(cfg, "q4_k", device="cpu"),
                          batch=2, max_tokens=4, max_entries=4)
    with pytest.raises(ValueError, match="capacity"):
        pool.attach("long", _entries(psm, _DM_SCRIPTS[2]))
    assert pool.active == 0
    pool.attach_many({"a": _entries(psm, _SCRIPTS["a"]),
                      "b": _entries(psm, [([1], "w", 0)])})
    with pytest.raises(RuntimeError, match="pool full"):
        pool.attach("c", _entries(psm, _SCRIPTS["a"]))
    with pytest.raises(ValueError, match="duplicate"):
        pool.detach("a")
        pool.attach_many({"b": _entries(psm, _SCRIPTS["a"])})
    assert pool.active == 1
