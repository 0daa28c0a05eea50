"""The port's speech-to-text path against the JAX package's, on the CPU.

* ``configs/bench/stt-1b-class.json`` parsed by both packages gives equal
  ``LMConfig`` fields.
* The tiny dense (bf16) STT LM: ``lm_gen_step`` at temp 0 over 32 frames
  (the temporal ring holds 24, so it wraps), with dep_q = 0 and four
  extra heads of width 6 (head 2 is the VAD).  Its temporal stack takes
  the generic layer path at T = 1 in both packages: K11 writes k and v,
  K9 attends, the rms pre-norms fuse into the projections, and the gated
  FFN runs dense.  JAX runs its Pallas kernels in interpret mode; the
  port, every kernel's plain version.
* ``STTPipeline``: a tiny Mimi (f32) and the tiny STT, frame by frame.
* ``gating_mlp`` routes quantized weights as the JAX package does.

Inputs are seeded numpy draws or JAX's synthetic weights exported to numpy.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
import moshi_tpu.nn.pallas_attention as jax_pallas_attention
import moshi_tpu.nn.pallas_ring as jax_pallas_ring
from moshi_tpu.config import load_config as jax_load_config
from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import QuantTensor as JaxQuantTensor
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.pipeline import STTPipeline as JaxSTTPipeline
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.config import load_config
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn import decode_attention as port_da
from moshi_tpu_torch.nn import ring as port_ring
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.pipeline import STTPipeline

_ROOT = Path(__file__).resolve().parents[1]
# a tiny STT: dense, dep_q 0, the stt-1b's four extra heads of width 6, its
# all-zero delays and its audio delay of 0.5 s (6 frames); card 64 is the
# tiny Mimi's codebook size (the LM's audio ids index its codebooks)
_KW = dict(dim=128, num_heads=4, num_layers=2, hidden_dim=256, context=24,
           card=64, n_q=4, dep_q=0, text_card=96, delays=(0,) * 5,
           extra_heads_num=4, extra_heads_dim=6, delay_steps=6)
_MIMI = dict(n_q=4, total_codebooks=8, dim=32, codebook_dim=16,
             codebook_size=64, transformer_layers=2, transformer_heads=4,
             transformer_context=16, transformer_hidden=64)
_SEANET = dict(dimension=32, n_filters=4, ratios=(4, 3, 2, 2))
_FRAMES = 32
_PIPE_FRAMES = 8
# JAX's dense path forms exact products of bf16 operands and sums them in
# f32, as the port's CPU path does; the two differ only in the order of the
# f32 sums.  Readings over the 32 frames: transformer_out 1.9e-7, text
# logits 2.3e-7 (relative to the largest value), VAD 1.5e-8 (absolute).
# A last-bit difference that straddles the bf16 rounding of an activation
# before a product would move an output by up to ~1e-5 (one element of
# 128 moved by 2^-9), so the limit is set there; tokens must match where
# JAX's top-1/top-2 gap exceeds it.
_RTOL = 1e-5
_VAD_TOL = 1e-6


def _np(tree):
    if isinstance(tree, JaxQuantTensor):
        out = {"fmt": tree.fmt, "shape": tuple(tree.shape)}
        for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
            a = getattr(tree, f)
            out[f] = None if a is None else np.asarray(a)
        return out
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _gap(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.max(np.abs(logits), axis=-1)


def test_stt_config_parses_equal_in_both_packages():
    path = _ROOT / "configs" / "bench" / "stt-1b-class.json"
    mc, jmc = load_config(str(path)), jax_load_config(str(path))
    delay = mc.stt_config.audio_delay_seconds
    assert delay == jmc.stt_config.audio_delay_seconds == 0.5
    cfg = port_lm.LMConfig.from_moshi_config(mc, audio_delay=delay)
    ref = jax_lm.LMConfig.from_moshi_config(jmc, audio_delay=delay)
    fields = [f.name for f in dataclasses.fields(cfg)]
    # neither package reads causal
    assert {f.name for f in dataclasses.fields(ref)} - set(fields) == \
        {"causal"}
    for name in fields:
        assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.hidden_dim == 8448 and cfg.dep_q == 0
    assert cfg.extra_heads_num == 4 and cfg.extra_heads_dim == 6
    assert cfg.delay_steps == 6 and cfg.context == 750


@pytest.mark.parametrize("field", ["demux_second_stream"])
def test_unported_lm_options_raise(field):
    """The demuxed text stream, which raised until it was ported, builds
    as the JAX package's config does (``tests/test_torch_demux_rope.py``
    holds it against JAX); an LM option the port does not take, a ring
    dtype outside bf16 and fp8, still raises."""
    cfg = port_lm.LMConfig(**{field: True})
    assert getattr(cfg, field) == getattr(jax_lm.LMConfig(**{field: True}),
                                          field) is True
    with pytest.raises(ValueError, match="kv_dtype"):
        port_lm.LMConfig(kv_dtype="float16")


def _run_jax(cfg, params, other):
    """JAX's frames (jitted), the text logits recorded through a
    ``jax.debug.callback`` around ``sample_token``, and the traces of K9
    and K11."""
    logged, traced = [], {"decode_attention": 0, "ring_write": 0}
    orig_sample = jax_lm.sample_token
    orig_da = jax_pallas_attention.decode_attention
    orig_rw = jax_pallas_ring.ring_write

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    def spy(fn, name):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            traced[name] += 1
            return fn(*a, **kw)
        return wrapped

    def step(p, s, o):
        text, h, s = jax_lm.lm_text_step(cfg, p, s, other_audio=o,
                                         temp_text=0.0)
        out, s = jax_lm.lm_audio_step(cfg, p, s, text, h, temp=0.0)
        return out, s, h

    frames = []
    jax_lm.sample_token = sample
    jax_pallas_attention.decode_attention = spy(orig_da, "decode_attention")
    jax_pallas_ring.ring_write = spy(orig_rw, "ring_write")
    enable_pallas(True)
    try:
        with pallas_interpret():
            jstep = jax.jit(step)
            state = jax_lm.init_gen_state(cfg, 1, jax.random.PRNGKey(5))
            for o in other:
                out, state, h = jstep(params, state, jnp.asarray(o))
                frames.append({"out": {k: np.asarray(v)
                                       for k, v in out.items()},
                               "h": np.asarray(h)})
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        jax_pallas_attention.decode_attention = orig_da
        jax_pallas_ring.ring_write = orig_rw
    assert len(logged) == len(frames)
    for fr, lg in zip(frames, logged):
        fr["logits"] = lg
    return frames, traced


def _run_port(cfg, params, other):
    """The port's frames at temp 0, with transformer_out and the text
    logits taken on the way, the calls of K9's and K11's plain versions
    counted, and the rings each K11 call wrote."""
    frames, taps = [], {}
    calls = {"decode_attention4": 0, "ring_write4": 0}
    written = []
    orig_tf, orig_sample = port_lm.temporal_forward, port_lm.sample_token
    orig_da = port_da.decode_attention4_plain
    orig_rw = port_ring.ring_write_kv_plain

    def tf(*a, **kw):
        h, logits, kv = orig_tf(*a, **kw)
        taps["h"] = h[:, -1].numpy().copy()
        return h, logits, kv

    def sample(logits, *a, **kw):
        taps["logits"] = logits.numpy().copy()
        return orig_sample(logits, *a, **kw)

    def counted(fn, name):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def kv_spy(k_ring, v_ring, *a, **kw):
        written.append((k_ring.data_ptr(), v_ring.data_ptr()))
        return orig_rw(k_ring, v_ring, *a, **kw)

    port_lm.temporal_forward, port_lm.sample_token = tf, sample
    port_da.decode_attention4_plain = counted(orig_da, "decode_attention4")
    port_ring.ring_write_kv_plain = counted(kv_spy, "ring_write4")
    try:
        state = port_lm.init_gen_state(cfg, 1, device="cpu")
        for o in other:
            out, state = port_lm.lm_gen_step(
                cfg, params, state, other_audio=torch.from_numpy(o),
                temp=0.0, temp_text=0.0)
            frames.append({"out": {k: v.numpy() for k, v in out.items()},
                           **taps})
    finally:
        port_lm.temporal_forward, port_lm.sample_token = orig_tf, orig_sample
        port_da.decode_attention4_plain = orig_da
        port_ring.ring_write_kv_plain = orig_rw
    rings = state["transformer"]
    return frames, calls, written, rings


@pytest.fixture(scope="module")
def stt_runs():
    cfg = jax_lm.LMConfig(**_KW)
    params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg)     # dense bf16
    rng = np.random.default_rng(7)
    other = rng.integers(0, cfg.card, (_FRAMES, 1, cfg.n_q), dtype=np.int32)
    ref, traced = _run_jax(cfg, params, other)
    pparams = params_from_numpy(_np(params), device="cpu")
    got, calls, written, rings = _run_port(port_lm.LMConfig(**_KW), pparams,
                                           other)
    return dict(ref=ref, got=got, traced=traced, calls=calls,
                written=written, rings=rings, params=pparams)


def _compared(ref, got):
    """Frames before the first token that legitimately differs."""
    for f, (r, g) in enumerate(zip(ref, got)):
        diff = r["out"]["sampled_text"] != g["out"]["sampled_text"]
        if np.any(diff & (_gap(r["logits"]) <= _RTOL)):
            return f
    return len(ref)


def test_stt_weights_are_dense_bf16(stt_runs):
    lay = stt_runs["params"]["transformer"]["layers"]
    for w in (lay["self_attn"]["in_proj"]["weight"],
              lay["gating"]["linear_in"]["weight"],
              stt_runs["params"]["extra_heads"]["weight"]):
        assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
    assert stt_runs["params"]["extra_heads"]["weight"].shape == (4, 6, 128)
    assert "depformer" not in stt_runs["params"]


def test_stt_transformer_out_logits_and_vad_match(stt_runs):
    ref, got = stt_runs["ref"], stt_runs["got"]
    n = _compared(ref, got)
    assert n == _FRAMES, f"token streams diverged at frame {n}"
    for f in range(n):
        assert _rel_err(got[f]["h"], ref[f]["h"]) < _RTOL, f
        assert _rel_err(got[f]["logits"], ref[f]["logits"]) < _RTOL, f
        vad, vref = got[f]["out"]["vad"], ref[f]["out"]["vad"]
        assert vad.dtype == np.float32 and vad.shape == (1,)
        assert np.max(np.abs(vad - vref)) < _VAD_TOL, f


def test_stt_tokens_and_delay_cache_match(stt_runs):
    ref, got = stt_runs["ref"], stt_runs["got"]
    checked = 0
    for f in range(_compared(ref, got)):
        r, g = ref[f]["out"], got[f]["out"]
        decided = _gap(ref[f]["logits"]) > _RTOL
        np.testing.assert_array_equal(g["sampled_text"][decided],
                                      r["sampled_text"][decided])
        checked += int(decided.sum())
        for key in ("text", "audio", "valid"):
            np.testing.assert_array_equal(g[key], r[key])
        assert g["audio"].shape == (1, 0)
    assert checked >= _FRAMES - 2
    # and the tokens follow the input (not a constant stream)
    assert len({int(fr["out"]["sampled_text"][0]) for fr in got}) > 8


def test_stt_runs_k9_and_k11_in_both_packages(stt_runs):
    """JAX traced its Pallas decode_attention and ring_write; the port
    called K9 once and K11 once per layer and frame, that call writing
    the layer's k ring and its v ring, and the stacked decode's K3 and K4
    never."""
    assert stt_runs["traced"]["decode_attention"] >= 1
    assert stt_runs["traced"]["ring_write"] >= 2
    nl = _KW["num_layers"]
    assert stt_runs["calls"] == {"decode_attention4": nl * _FRAMES,
                                 "ring_write4": nl * _FRAMES}
    rings = stt_runs["rings"]
    per_layer = [(rings["k"][i].data_ptr(), rings["v"][i].data_ptr())
                 for i in range(nl)]
    assert stt_runs["written"] == per_layer * _FRAMES


def test_stt_takes_the_generic_path():
    from moshi_tpu_torch.nn.transformer import can_use_stacked_decode
    cfg = port_lm.LMConfig(**_KW)
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    params = synth_lm_params(cfg, None, device="cpu", seed=1)
    x = torch.zeros((1, 1, cfg.dim))
    assert not can_use_stacked_decode(cfg.transformer, params["transformer"],
                                      x)


def test_gating_mlp_routes_quantized_weights():
    """One row with an int8-eligible q4_k weight goes to K1's GLU; at the
    default MOSHI_TPU_INT8_MAX_M of 1 other row counts take K7, the flat
    dequant GLU."""
    from moshi_tpu_torch.nn.gating import gating_mlp
    from moshi_tpu_torch.quant.matmul import glu_matmul_stacked
    from moshi_tpu_torch.runtime.synth import synth_quant_tensor
    gen = torch.Generator().manual_seed(4)
    params = {"linear_in": {"weight": synth_quant_tensor(
                  "q4_k", (), 2 * 256, 256, gen, "cpu")},
              "linear_out": {"weight": synth_quant_tensor(
                  "q4_k", (), 256, 256, gen, "cpu")}}
    alpha = torch.rand(256) + 0.5
    x = torch.randn((1, 1, 256))
    y = gating_mlp(params, x, pre_norm_alpha=alpha)
    hv = glu_matmul_stacked(x, params["linear_in"]["weight"], alpha=alpha)
    from moshi_tpu_torch.nn.layers import linear
    torch.testing.assert_close(y, linear(params["linear_out"], hv),
                               rtol=0, atol=0)
    from moshi_tpu_torch.quant.matmul import glu_matmul
    x2 = torch.randn((1, 2, 256))
    hv2 = glu_matmul(x2, params["linear_in"]["weight"], alpha=alpha)
    torch.testing.assert_close(
        gating_mlp(params, x2, pre_norm_alpha=alpha),
        linear(params["linear_out"], hv2), rtol=0, atol=0)


def _run_jax_pipeline(cfg, mcfg, lm_params, mimi_params, audio):
    mimi = JaxMimiModel(mcfg)
    logged, codes = [], []
    orig_sample = jax_lm.sample_token
    encode = mimi.encode_step

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    def encode_rec(*a):
        c, s = encode(*a)
        jax.debug.callback(lambda v: codes.append(np.array(v)), c,
                           ordered=True)
        return c, s

    mimi.encode_step = encode_rec
    frames = []
    jax_lm.sample_token = sample
    enable_pallas(True)
    try:
        with pallas_interpret():
            pipe = JaxSTTPipeline(mimi, cfg, mimi_dtype=jnp.float32)
            state = pipe.init_state(1, jax.random.PRNGKey(2))
            for a in audio:
                out, state = pipe.step(mimi_params, lm_params, state, a)
                frames.append({k: np.asarray(v) for k, v in out.items()})
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
    for fr, lg, c in zip(frames, logged, codes):
        fr.update(logits=lg, codes=c)
    return frames


def _run_port_pipeline(lm_params, mimi_params, audio):
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    logged, codes = [], []
    orig_sample = port_lm.sample_token
    encode = mimi.encode_step

    def sample(logits, *a, **kw):
        logged.append(logits.numpy().copy())
        return orig_sample(logits, *a, **kw)

    def encode_rec(*a):
        c, s = encode(*a)
        codes.append(c.numpy().copy())
        return c, s

    mimi.encode_step = encode_rec
    port_lm.sample_token = sample
    frames = []
    try:
        pipe = STTPipeline(mimi, port_lm.LMConfig(**_KW),
                           mimi_dtype=torch.float32, device="cpu")
        state = pipe.init_state(1, seed=2)
        for a in audio:
            out, state = pipe.step(mimi_params, lm_params, state,
                                   torch.from_numpy(a))
            frames.append({k: v.numpy() for k, v in out.items()})
    finally:
        port_lm.sample_token = orig_sample
    for fr, lg, c in zip(frames, logged, codes):
        fr.update(logits=lg, codes=c)
    return frames


def _mimi_params(model, seed):
    """Mimi's tree drawn with numpy (as ``test_torch_pipeline.py`` draws
    it): N(0, 1) codebooks, fan-in scaled matrices and kernels, vectors
    N(0, 0.1) around 1 (norm weights) or 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=sd.shape)
        if "embeddings" in name:
            pass
        elif "norm" in name or "bias" in name or "layer_scale" in name:
            x = 0.1 * x + (1.0 if "norm" in name and "weight" in name
                           else 0.0)
        elif "transformer" in name or "proj" in name:
            x = x * sd.shape[-1] ** -0.5
        else:
            x = x * float(np.prod(sd.shape[1:])) ** -0.5
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init_params, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def pipe_runs():
    cfg = jax_lm.LMConfig(**_KW)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    lm_params = jax_synth_lm_params(jax.random.PRNGKey(8), cfg)
    mimi_params = _mimi_params(JaxMimiModel(mcfg), 9)
    rng = np.random.default_rng(10)
    fs = mcfg.seanet.hop_length * mcfg.frames_per_step
    audio = [(rng.normal(size=(1, fs)) * 0.1).astype(np.float32)
             for _ in range(_PIPE_FRAMES)]
    ref = _run_jax_pipeline(cfg, mcfg, lm_params, mimi_params, audio)
    got = _run_port_pipeline(params_from_numpy(_np(lm_params), device="cpu"),
                             params_from_numpy(_np(mimi_params), device="cpu"),
                             audio)
    return ref, got


def test_stt_pipeline_matches_jax(pipe_runs):
    """Mimi's codes identical, the text token equal where decided (every
    frame is, at these readings), the VAD within its limit."""
    ref, got = pipe_runs
    assert len(ref) == len(got) == _PIPE_FRAMES
    decided = 0
    for f, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(g["codes"], r["codes"])
        assert _rel_err(g["logits"], r["logits"]) < _RTOL, f
        ok = _gap(r["logits"]) > _RTOL
        np.testing.assert_array_equal(g["text"][ok], r["text"][ok])
        decided += int(ok.sum())
        assert g["vad"].dtype == np.float32 and g["vad"].shape == (1,)
        assert np.max(np.abs(g["vad"] - r["vad"])) < _VAD_TOL, f
    assert decided == _PIPE_FRAMES


def test_stt_pipeline_without_vad_head_returns_zeros():
    mimi = MimiModel(MimiConfig(seanet=SEANetConfig(**_SEANET), **_MIMI))
    cfg = port_lm.LMConfig(**dict(_KW, extra_heads_num=0))
    from moshi_tpu_torch.runtime.synth import synth_lm_params, \
        synth_mimi_params
    pipe = STTPipeline(mimi, cfg, mimi_dtype=torch.float32, device="cpu")
    state = pipe.init_state(2)
    out, state = pipe.step(synth_mimi_params(mimi.cfg, device="cpu",
                                             dtype=torch.float32),
                           synth_lm_params(cfg, None, device="cpu"), state,
                           torch.zeros((2, pipe.frame_samples)))
    assert out["text"].shape == (2,)
    torch.testing.assert_close(out["vad"], torch.zeros(2))
