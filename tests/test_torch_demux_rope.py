"""The LM options that the port runs since its weights can come from
files: the demuxed text stream, depformer RoPE and gelu gating, against
the JAX package on the CPU (its Pallas kernels in interpret mode, the
port's plain versions).

* ``nn/layers.py`` ``demux_embedding`` against JAX's on ids below zero,
  0, N - 1, N, above N and at the top of the muxed range (N = text_card +
  1), dense and with q4_k ``out1`` / ``out2`` (K1 at one row): within
  1e-6 dense (f32 sums in another order) and 2e-3 on q4_k (an int8
  activation rounding may flip: one step of 1/127); ``embed_frame`` and
  the depformer's text embedding on the same ids.
* The depformer with ``depformer_pos_emb = "rope"``, stacked (q4_k) and
  generic (dense bf16), demuxed, its attention sharpened
  (``sharpen_depformer_qk``): the logits of every step within 5e-4 of the
  largest (the LM test's depformer limit; sound 1e-4 to 3e-4) and 1e-3
  in the generic form (sound 2.4e-4), every token equal; a control that
  rotates every step at one position in place of its step index breaks
  both limits.  The megakernel gates refuse rope.
* A gelu-gated ``TransformerConfig`` stack (rms norms, dense bf16, whose
  products are exact in f32) over four decode steps, within 1e-5; ``gating_mlp`` with a q4_k linear_in at
  one row (the unfused route), within 2e-3.
* 6 frames of the cross-attention TTS class with both options on, through
  ``TTSPipeline.step_device`` with the device FSM (second stream two
  words ahead): tokens equal at temp 0, logits within the TTS test's
  limits (text 1e-5, depformer 5e-3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.runtime.convert import params_from_numpy
from tests.test_torch_lm import export_numpy
from tests.test_torch_quantize import _weights

_KW = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
           card=256, n_q=4, dep_q=4, text_card=300, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=4, depformer_layers=2,
           depformer_hidden=576, depformer_low_rank=32,
           demux_second_stream=True, depformer_pos_emb="rope")
_DEP_TOL = {"q4_k": 5e-4, None: 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


_MODELS = {}


def sharpen_depformer_qk(tree, factor=8.0, alpha=32.0):
    """The depformer's norm1 alpha scaled by ``alpha`` and the q and k rows
    of every in_proj by ``factor``, powers of two, so every bf16 scale or
    weight stays exact.  The synthetic weights (alphas of 0.02) give q.k
    ~ 1e-5 and an attention output ~ 1e-3 of the residual: the scores
    would be flat and the rope, any rope, would not move the logits (here
    it moves them by 1e-2 to 3e-2)."""
    lay = tree["depformer"]["layers"]
    lay["norm1"]["alpha"] = np.array(lay["norm1"]["alpha"]) * alpha
    w = lay["self_attn"]["in_proj"]["weight"]
    qk = 2 * lay["norm1"]["alpha"].shape[-1]
    if isinstance(w, dict):               # a QuantTensor's fields
        for f in ("d", "dmin", "es", "em"):
            w[f] = np.array(w[f])
            w[f][..., :qk, :] *= factor
    else:
        w = tree["depformer"]["layers"]["self_attn"]["in_proj"]["weight"] = \
            np.array(w)
        w[..., :qk, :] *= factor
    return tree


def _model(fmt, **over):
    from tests.test_torch_gguf import export_port, jax_tree
    key = (fmt, tuple(sorted(over.items())))
    if key not in _MODELS:
        from moshi_tpu_torch.runtime.synth import synth_lm_params
        kw = dict(_KW, **over)
        pp = synth_lm_params(port_lm.LMConfig(**kw), fmt, device="cpu",
                             seed=11)
        pp = params_from_numpy(sharpen_depformer_qk(export_port(pp)),
                               device="cpu")
        _MODELS[key] = (JaxLMConfig(**kw), jax_tree(pp),
                        port_lm.LMConfig(**kw), pp)
    return _MODELS[key]


def _jax_pallas(fn):
    enable_pallas(True)
    try:
        with pallas_interpret():
            return fn()
    finally:
        enable_pallas(False)


# ---------------------------------------------------------------------------
# the demuxed embedding
# ---------------------------------------------------------------------------

def _demux_ids(n):
    return np.array([[-2, -1, 0, 5, n - 1, n, n + 7, 3 * n + 2, n * n - 1]],
                    np.int32)


@pytest.mark.parametrize("fmt", [None, "q4_k"])
def test_demux_embedding_matches_jax(fmt):
    from moshi_tpu.nn.layers import demux_embedding as jax_demux
    from moshi_tpu_torch.nn.layers import demux_embedding
    jcfg, jp, pcfg, pp = _model(fmt)
    n = jcfg.text_card + 1
    ids = _demux_ids(n)
    ref = np.asarray(_jax_pallas(lambda: jax_demux(
        jp["text_emb"], jnp.asarray(ids), n)))
    got = demux_embedding(pp["text_emb"], torch.from_numpy(ids).long(), n)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < (1e-6 if fmt is None else 2e-3)
    # ids below zero give no row at all; N alone is second stream 0 only
    e = got.numpy()[0]
    assert np.all(e[0] == 0) and np.all(e[1] == 0)
    assert not np.allclose(e[5], e[2])


@pytest.mark.parametrize("fmt", [None, "q4_k"])
def test_embed_frame_and_depformer_text_embed_match_jax(fmt):
    jcfg, jp, pcfg, pp = _model(fmt)
    n = jcfg.text_card + 1
    text = _demux_ids(n)[0]
    rng = np.random.default_rng(12)
    audio = rng.integers(-2, jcfg.card, (len(text), jcfg.n_q))
    tokens = np.concatenate([text[:, None], audio], 1)[None].astype(np.int32)
    ref = np.asarray(_jax_pallas(lambda: jax_lm.embed_frame(
        jcfg, jp, jnp.asarray(tokens))))
    got = port_lm.embed_frame(pcfg, pp, torch.from_numpy(tokens).long())
    tol = 1e-6 if fmt is None else 2e-3
    assert _rel(got, ref) < tol
    ref = np.asarray(_jax_pallas(lambda: jax_lm._depformer_text_embed(
        jcfg, jp["depformer"], jnp.asarray(text))))
    got = port_lm._depformer_text_embed(pcfg, pp["depformer"],
                                        torch.from_numpy(text).long())
    assert _rel(got, ref) < tol


# ---------------------------------------------------------------------------
# the depformer with rope
# ---------------------------------------------------------------------------

def _dep_inputs(jcfg, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(1, jcfg.dim)).astype(np.float32)
    text = np.array([rng.integers(0, (jcfg.text_card + 1) * 3)], np.int32)
    return h, text


def _jax_depformer(jcfg, jp, h, text):
    logged = []
    orig = jax_lm.sample_token

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig(logits, *a, **kw)

    jax_lm.sample_token = sample
    try:
        toks = _jax_pallas(lambda: jax_lm.depformer_generate(
            jcfg, jp, jnp.asarray(h), jnp.asarray(text),
            jax.random.PRNGKey(0), 0.0, 250))
        jax.effects_barrier()
    finally:
        jax_lm.sample_token = orig
    return np.asarray(toks), logged


def _port_depformer(pcfg, pp, h, text):
    logged = []
    orig = port_lm.sample_token

    def sample(logits, *a, **kw):
        logged.append(logits.numpy().copy())
        return orig(logits, *a, **kw)

    port_lm.sample_token = sample
    try:
        toks = port_lm.depformer_generate(
            pcfg, pp, torch.from_numpy(h), torch.from_numpy(text).long(),
            0.0, 250)
    finally:
        port_lm.sample_token = orig
    return toks.numpy(), logged


@pytest.mark.parametrize("fmt", ["q4_k", None], ids=["stacked", "generic"])
def test_depformer_rope_matches_jax(fmt):
    jcfg, jp, pcfg, pp = _model(fmt)
    step_w = port_lm._per_step_weights(pcfg, pp["depformer"])
    assert port_lm._can_use_dep_stacked(pcfg, step_w, 1) == (fmt == "q4_k")
    assert pcfg.depformer.rope_max_period
    for seed in (1, 2):
        h, text = _dep_inputs(jcfg, seed)
        rtok, rlog = _jax_depformer(jcfg, jp, h, text)
        gtok, glog = _port_depformer(pcfg, pp, h, text)
        assert len(rlog) == len(glog) == jcfg.dep_q
        for lr, lg in zip(rlog, glog):
            assert _rel(lg, lr) < _DEP_TOL[fmt], _rel(lg, lr)
        np.testing.assert_array_equal(gtok, rtok)


@pytest.mark.parametrize("fmt", ["q4_k", None], ids=["stacked", "generic"])
def test_depformer_rope_control_breaks_the_limit(monkeypatch, fmt):
    """Every step rotated at one position (a frame's single offset) in
    place of its step index moves the stacked depformer's logits beyond
    the limit.  (A shift of every position alike would not: the scores
    see only the positions' differences.)"""
    from moshi_tpu_torch.nn import attention, rope
    jcfg, jp, pcfg, pp = _model(fmt)
    h, text = _dep_inputs(jcfg, 1)
    _, rlog = _jax_depformer(jcfg, jp, h, text)
    orig = rope.rope_angles
    at_five = lambda pos, *a, **kw: orig(pos * 0 + 5, *a, **kw)  # noqa: E731
    monkeypatch.setattr(port_lm, "rope_angles", at_five)
    monkeypatch.setattr(attention, "rope_angles", at_five)
    _, glog = _port_depformer(pcfg, pp, h, text)
    assert max(_rel(lg, lr) for lr, lg in zip(rlog, glog)) > _DEP_TOL[fmt]


def test_megakernel_gates_refuse_depformer_rope(monkeypatch):
    monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", "all")
    _, _, pcfg, pp = _model("q4_k", depformer_hidden=512)
    step_w = port_lm._per_step_weights(pcfg, pp["depformer"])
    assert not port_lm._can_use_dep_megakernel(pcfg, pp["depformer"], 1)
    assert not port_lm._can_use_dep_frame_kernel(pcfg, pp["depformer"],
                                                 step_w, 1)
    none = dataclasses.replace(pcfg, depformer_pos_emb="none")
    assert port_lm._can_use_dep_megakernel(none, pp["depformer"], 1)


# ---------------------------------------------------------------------------
# gelu gating
# ---------------------------------------------------------------------------

def test_gelu_gated_stack_matches_jax():
    from moshi_tpu.nn import transformer as jt
    from moshi_tpu_torch.nn import transformer as pt
    kw = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=384,
              context=16, gating="gelu")
    jcfg, pcfg = jt.TransformerConfig(**kw), pt.TransformerConfig(**kw)
    jp = jt.init_transformer_params(jax.random.PRNGKey(2), jcfg,
                                    jnp.bfloat16)
    pp = params_from_numpy(export_numpy(jp), device="cpu")
    rng = np.random.default_rng(3)
    js = jt.init_transformer_state(jcfg, 1)
    ps = pt.init_transformer_state(pcfg, 1, "cpu")
    for step, t in enumerate((1, 1, 1, 1)):
        x = rng.normal(size=(1, t, 256)).astype(np.float32)
        off = np.array([step], np.int32)
        ry, js = _jax_pallas(lambda: jt.transformer_forward(
            jcfg, jp, js, jnp.asarray(x), jnp.asarray(off)))
        gy, ps = pt.transformer_forward(pcfg, pp, ps, torch.from_numpy(x),
                                        torch.from_numpy(off))
        assert _rel(gy, ry) < 1e-5, (step, _rel(gy, ry))


def test_gelu_gating_mlp_quantized_matches_jax():
    from moshi_tpu.nn.gating import gating_mlp as jax_gating
    from moshi_tpu.quant.formats import quantize as jq
    from moshi_tpu_torch.nn.gating import gating_mlp
    win, wout = _weights("f32", (1024, 256), seed=5), \
        _weights("f32", (256, 512), seed=6)
    jparams = {"linear_in": {"weight": jq(win, "q4_k", native=False)},
               "linear_out": {"weight": jq(wout, "q4_k", native=False)}}
    pparams = params_from_numpy(export_numpy(jparams), device="cpu")
    x = np.random.default_rng(7).normal(size=(1, 1, 256)).astype(np.float32)
    alpha = np.random.default_rng(8).normal(1, 0.1, (256,)).astype(
        np.float32)
    ref = np.asarray(_jax_pallas(lambda: jax_gating(
        jparams, jnp.asarray(x), "gelu", pre_norm_alpha=jnp.asarray(alpha))))
    got = gating_mlp(pparams, torch.from_numpy(x), "gelu",
                     pre_norm_alpha=torch.from_numpy(alpha))
    assert _rel(got, ref) < 2e-3
    silu = gating_mlp(pparams, torch.from_numpy(x), "silu",
                      pre_norm_alpha=torch.from_numpy(alpha))
    assert _rel(silu, ref) > 1e-2          # the activation does matter
    with pytest.raises(ValueError, match="activation"):
        gating_mlp(pparams, torch.from_numpy(x), "relu")


# ---------------------------------------------------------------------------
# the TTS class with both options
# ---------------------------------------------------------------------------

_TTS = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
            card=64, n_q=4, dep_q=4, text_card=512, delays=(0, 0, 2, 2, 2),
            depformer_dim=256, depformer_heads=4, depformer_layers=2,
            depformer_hidden=576, depformer_low_rank=32,
            cross_attention=True, delay_steps=3,
            demux_second_stream=True, depformer_pos_emb="rope")
_TTS_FRAMES = 6
_SCRIPT = [([10, 11], "hi", 1), ([12], "yo", 0), ([13, 14], "ab", 0),
           ([15], "z", 0)]


def _machine(module):
    return module.StateMachine(text_card=_TTS["text_card"] + 1,
                               second_stream_ahead=2, max_padding=4,
                               initial_padding=1)


def _tts_run(pkg, params, mimi_params, cond_sum, cross):
    """``_TTS_FRAMES`` step_device frames at temp 0 in package ``pkg``,
    with every sampled logits row."""
    from tests.test_torch_pipeline import _SEANET
    from tests.test_torch_tts import _MIMI
    logged = []
    if pkg == "jax":
        from moshi_tpu.models import state_machine as sm
        from moshi_tpu.models.device_machine import (compile_script,
                                                     init_device_state)
        from moshi_tpu.models.mimi import MimiConfig, MimiModel
        from moshi_tpu.nn.seanet import SEANetConfig
        from moshi_tpu.nn.transformer import transformer_cross_kv
        from moshi_tpu.runtime.pipeline import TTSPipeline
        lm, cfg = jax_lm, JaxLMConfig(**_TTS)
        arr, kw = jnp.asarray, dict(mimi_dtype=jnp.float32)
    else:
        from moshi_tpu_torch.models import state_machine as sm
        from moshi_tpu_torch.models.device_machine import (compile_script,
                                                           init_device_state)
        from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
        from moshi_tpu_torch.nn.seanet import SEANetConfig
        from moshi_tpu_torch.nn.transformer import transformer_cross_kv
        from moshi_tpu_torch.runtime.pipeline import TTSPipeline
        lm, cfg = port_lm, port_lm.LMConfig(**_TTS)
        arr = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        kw = dict(mimi_dtype=torch.float32, device="cpu")
    orig = lm.sample_token

    def sample(logits, *a, **k):
        if pkg == "jax":
            jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                               ordered=True)
        else:
            logged.append(logits.numpy().copy())
        return orig(logits, *a, **k)

    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    lm.sample_token = sample
    if pkg == "jax":
        enable_pallas(True)
    frames = []
    try:
        with (pallas_interpret() if pkg == "jax"
              else torch.inference_mode()):
            mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET),
                                        **_MIMI))
            pipe = TTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0, **kw)
            dm = pipe.enable_device_fsm(_machine(sm))
            entries = [sm.Entry(list(t), w, p) for t, w, p in _SCRIPT]
            if pkg == "jax":
                script = compile_script([entries], dm)
                state = pipe.init_state(1, jax.random.PRNGKey(0))
            else:
                script = compile_script([entries], dm, device="cpu")
                state = pipe.init_state(1)
            mstate = init_device_state(dm, script)
            ckv = transformer_cross_kv(cfg.transformer, params["transformer"],
                                       arr(cross))
            for _ in range(_TTS_FRAMES):
                out, state, mstate = pipe.step_device(
                    mimi_params, params, state, mstate, script,
                    condition_sum=arr(cond_sum), cross_kv=ckv)
                frames.append({k: np.asarray(v) for k, v in out.items()})
            if pkg == "jax":
                jax.effects_barrier()
    finally:
        lm.sample_token = orig
        if pkg == "jax":
            enable_pallas(False)
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return frames, logged


def test_tts_frames_with_demux_and_rope_match_jax():
    from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
    from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
    from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
    from tests.test_torch_pipeline import _SEANET, _mimi_params, _np
    from tests.test_torch_tts import _MIMI, _voice
    from tests.test_torch_gguf import jax_tree
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    pp = synth_lm_params(port_lm.LMConfig(**_TTS), "q4_k", device="cpu",
                         seed=5)
    jp = jax_tree(pp)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    mimi_np = _mimi_params(JaxMimiModel(mcfg), 4)
    _, _, cond_sum, cross = _voice(24)
    rframes, rlog = _tts_run("jax", jp, mimi_np, cond_sum, cross)
    gframes, glog = _tts_run("port", pp, params_from_numpy(
        _np(mimi_np), device="cpu"), cond_sum, cross)
    per = 1 + _TTS["dep_q"]
    assert len(rlog) == len(glog) == _TTS_FRAMES * per
    for i, (lr, lg) in enumerate(zip(rlog, glog)):
        assert _rel(lg, lr) < (5e-3 if i % per else 1e-5), (i, _rel(lg, lr))
        np.testing.assert_array_equal(np.argmax(lg, -1), np.argmax(lr, -1))
    for r, g in zip(rframes, gframes):
        for key in ("machine_text", "audio_tokens", "valid", "end_step",
                    "text"):
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    # the second stream ran: some muxed token carries a word ahead
    n = _TTS["text_card"] + 1
    assert any(int(f["machine_text"][0]) >= n for f in rframes)
