"""The port's LM frame step (moshi_tpu_torch.models.lm.lm_gen_step) against
the JAX package's, on the same q4_k weights, on the CPU, in both forms of
the mid-layer fusion (MOSHI_TPU_FUSE_MID = 1, the default: out_proj +
residual + norm2 + GLU as the fused K5; 0: separate matvecs), with both
packages in the same form.

JAX runs with its Pallas kernels in interpret mode; the port runs every
kernel's plain PyTorch version.  The JAX package's capture recorder turns
the fusion off, so the logits are recorded by wrapping its
``sample_token`` with ``jax.debug.callback`` instead, and transformer_out
is taken from ``lm_text_step``'s return.  The tiny configuration mirrors
the 7B's dispatch: every projection is q4_k on the int8 matvec except the
depformer linear_out, whose hidden width (576, nb = 18) makes it q4_0 and
sends it to the dequant matvec, as the 7B's K = 4224 does.  The temporal
ring holds 16 positions, so 24 frames wrap it.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.models.lm as jax_lm
import moshi_tpu.quant.pallas_fused as jax_fused
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_gen_state as jax_init_gen_state
from moshi_tpu.quant.formats import QuantTensor as JaxQuantTensor
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.quant import fused as port_fused
from moshi_tpu_torch.quant.formats import QuantTensor
from moshi_tpu_torch.quant.matmul_int8 import int8_matvec_plain
from moshi_tpu_torch.runtime.convert import params_from_numpy

_KW = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
           card=256, n_q=4, dep_q=2, text_card=512, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=4, depformer_layers=2,
           depformer_hidden=576, depformer_low_rank=32)
_FRAMES = 24
# transformer_out and the logits pass through a chain of int8-activation
# matvecs; where JAX's and PyTorch's f32 arithmetic (rsqrt, sum order)
# differ in the last bit, one activation's int8 rounding can flip, which
# moves a result by up to about one quantization step (1/127 of a block's
# largest value).  So outputs are held to 0.2% of their largest magnitude,
# and a token is required to match only where JAX's top-1/top-2 logit gap
# exceeds that same 0.2%.
_RTOL = 2e-3
# The depformer's logits are held tighter, below the ~1e-3 to 2.3e-3 by
# which the fused form's f32 h_mid moves them against a bf16-rounded one
# (the JAX package's two forms on this configuration), so that a port that
# rounds h_mid to bf16 before norm2 fails (test_lm_depformer_control_*).
# Readings: sound 2.2e-4 (form 0) and 1.8e-4 (form 1) over 24 frames; the
# control 2.7e-3 at its largest.
_DEP_RTOL = 5e-4


def export_numpy(tree):
    """A JAX parameter tree as numpy leaves, QuantTensors as field dicts."""
    if isinstance(tree, JaxQuantTensor):
        out = {"fmt": tree.fmt, "shape": tuple(tree.shape)}
        for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
            a = getattr(tree, f)
            out[f] = None if a is None else np.asarray(a)
        return out
    if isinstance(tree, dict):
        return {k: export_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _gap(logits):
    """Top-1 minus top-2 of each row, relative to the row's largest
    magnitude."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.max(np.abs(logits), axis=-1)


def _split_logits(logged, cfg, frames):
    """The logits each frame sampled from, in call order: the text
    logits [B, text_card], then dep_q depformer steps [B, card]."""
    dep_q = cfg.dep_q
    per = 1 + dep_q
    assert len(logged) == frames * per, len(logged)
    out = []
    for f in range(frames):
        chunk = logged[f * per:(f + 1) * per]
        assert chunk[0].shape[-1] == cfg.text_card
        out.append({"logits": chunk[0],
                    "dep_logits": np.stack(chunk[1:], 1)})
    return out


def _run_jax(cfg, params, other, form):
    """JAX's frames, jitted as one program, in fusion form ``form``; the
    logits come from a ``jax.debug.callback`` around ``sample_token``,
    and the traces of the fused kernel are counted."""
    logged, traced = [], []
    orig_sample = jax_lm.sample_token
    orig_fused = jax_fused.attn_ffn_fused_i8

    def sample(logits, *a, **kw):
        jax.debug.callback(lambda v: logged.append(np.array(v)), logits,
                           ordered=True)
        return orig_sample(logits, *a, **kw)

    @functools.wraps(orig_fused)
    def fused(*a, **kw):
        traced.append(1)
        return orig_fused(*a, **kw)

    def step(p, s, o):
        text, h, s = jax_lm.lm_text_step(cfg, p, s, other_audio=o,
                                         temp_text=0.0)
        out, s = jax_lm.lm_audio_step(cfg, p, s, text, h, temp=0.0)
        return out, s, h

    outs, hs = [], []
    old = os.environ.get("MOSHI_TPU_FUSE_MID")
    os.environ["MOSHI_TPU_FUSE_MID"] = form
    jax_lm.sample_token = sample
    jax_fused.attn_ffn_fused_i8 = fused
    enable_pallas(True)
    try:
        with pallas_interpret():
            jstep = jax.jit(step)
            state = jax_init_gen_state(cfg, 1, jax.random.PRNGKey(5))
            for f in range(len(other)):
                out, state, h = jstep(params, state, jnp.asarray(other[f]))
                outs.append({k: np.asarray(v) for k, v in out.items()})
                hs.append(np.asarray(h))
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        jax_fused.attn_ffn_fused_i8 = orig_fused
        if old is None:
            os.environ.pop("MOSHI_TPU_FUSE_MID", None)
        else:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    frames = _split_logits(logged, cfg, len(other))
    for f, fr in enumerate(frames):
        fr.update(out=outs[f], h=hs[f])
    return frames, len(traced)


def _run_port(cfg, params, other, form, fused_plain=None):
    """The port's frames at temp 0 in fusion form ``form``, with
    transformer_out from temporal_forward and every sampled logits row
    from sample_token on the way; also the number of K5 calls.
    ``fused_plain`` replaces K5's plain version (a control)."""
    frames, taps, logged = [], {}, []
    calls = []
    orig = port_lm.temporal_forward
    orig_sample = port_lm.sample_token
    orig_fused = port_fused.attn_ffn_fused_plain
    inner = fused_plain or orig_fused

    def spy(*a, **kw):
        h, logits, kv = orig(*a, **kw)
        taps["h"] = h[:, -1].numpy().copy()
        return h, logits, kv

    def sample(logits, *a, **kw):
        logged.append(logits.numpy().copy())
        return orig_sample(logits, *a, **kw)

    def fused_spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    old = os.environ.get("MOSHI_TPU_FUSE_MID")
    os.environ["MOSHI_TPU_FUSE_MID"] = form
    state = port_lm.init_gen_state(cfg, 1, device="cpu")
    port_lm.temporal_forward = spy
    port_lm.sample_token = sample
    port_fused.attn_ffn_fused_plain = fused_spy
    try:
        for f in range(len(other)):
            out, state = port_lm.lm_gen_step(
                cfg, params, state, other_audio=torch.from_numpy(other[f]),
                temp=0.0, temp_text=0.0)
            frames.append({"out": {k: v.numpy() for k, v in out.items()},
                           **taps})
    finally:
        port_lm.temporal_forward = orig
        port_lm.sample_token = orig_sample
        port_fused.attn_ffn_fused_plain = orig_fused
        if old is None:
            os.environ.pop("MOSHI_TPU_FUSE_MID", None)
        else:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    for fr, lg in zip(frames, _split_logits(logged, cfg, len(other))):
        fr.update(lg)
        fr["gen_audio"] = np.argmax(lg["dep_logits"], -1)
    return frames, len(calls)


_RUNS = {}


def _runs(form):
    """(port params, JAX frames, port frames, JAX fused traces, port K5
    calls) for one fusion form, made once per module."""
    if form not in _RUNS:
        cfg = JaxLMConfig(**_KW)
        params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
        rng = np.random.default_rng(7)
        other = rng.integers(0, cfg.card, (_FRAMES, 1, cfg.n_q - cfg.dep_q),
                             dtype=np.int32)
        ref, traced = _run_jax(cfg, params, other, form)
        pcfg = port_lm.LMConfig(**_KW)
        pparams = params_from_numpy(export_numpy(params), device="cpu")
        got, calls = _run_port(pcfg, pparams, other, form)
        _RUNS[form] = dict(params=pparams, ref=ref, got=got, traced=traced,
                           calls=calls, cfg=pcfg, other=other)
    return _RUNS[form]


@pytest.fixture(scope="module", params=["0", "1"], ids=lambda f: f"fuse{f}")
def runs(request):
    r = _runs(request.param)
    return r["params"], r["ref"], r["got"]


def _compared_frames(ref, got):
    """Frames before the first legitimate token divergence: a token that
    differs where JAX's gap is within the tolerance feeds different inputs
    to every later frame, so comparison stops there."""
    for f, (r, g) in enumerate(zip(ref, got)):
        text_diff = r["out"]["sampled_text"] != g["out"]["sampled_text"]
        if np.any(text_diff & (_gap(r["logits"]) <= _RTOL)):
            return f
        audio_diff = np.argmax(r["dep_logits"], -1) != g["gen_audio"]
        if np.any(audio_diff & (_gap(r["dep_logits"]) <= _RTOL)):
            return f
    return len(ref)


def test_lm_config_dispatch_mirrors_7b(runs):
    """Every temporal and depformer projection is q4_k except the
    depformer linear_out, which is q4_0 with a block count the int8 matvec
    refuses (as the 7B's K = 4224)."""
    from moshi_tpu_torch.quant.formats import int8_shape_ok
    params = runs[0]
    lay = params["transformer"]["layers"]
    dep = params["depformer"]["layers"]
    for w in (lay["self_attn"]["in_proj"]["weight"],
              lay["self_attn"]["out_proj"]["weight"],
              lay["gating"]["linear_in"]["weight"],
              lay["gating"]["linear_out"]["weight"],
              dep["self_attn"]["in_proj"]["weight"],
              dep["gating"]["linear_in"]["weight"],
              params["text_linear"]["weight"],
              params["depformer"]["linears"]["weight"]):
        assert isinstance(w, QuantTensor) and w.fmt == "q4_k"
        assert int8_shape_ok(w, 1)
    lout = dep["gating"]["linear_out"]["weight"]
    assert lout.fmt == "q4_0" and not int8_shape_ok(lout, 1)


def test_lm_transformer_out_and_logits_match(runs):
    _, ref, got = runs
    n = _compared_frames(ref, got)
    assert n >= 20, f"token streams diverged at frame {n}"
    for f in range(n):
        assert _rel_err(got[f]["h"], ref[f]["h"]) < _RTOL, f
        assert _rel_err(got[f]["logits"], ref[f]["logits"]) < _RTOL, f


def test_lm_tokens_match_where_gap_exceeds_tolerance(runs):
    _, ref, got = runs
    n = _compared_frames(ref, got)
    assert n >= 20, f"token streams diverged at frame {n}"
    checked = 0
    for f in range(n):
        r, g = ref[f]["out"], got[f]["out"]
        decided = _gap(ref[f]["logits"]) > _RTOL
        np.testing.assert_array_equal(g["sampled_text"][decided],
                                      r["sampled_text"][decided])
        checked += int(decided.sum())
        # the generated audio tokens (argmax of each depformer step's
        # logits at temp 0), before the delay cache
        dep_decided = _gap(ref[f]["dep_logits"]) > _RTOL
        gen_ref = np.argmax(ref[f]["dep_logits"], -1)
        np.testing.assert_array_equal(got[f]["gen_audio"][dep_decided],
                                      gen_ref[dep_decided])
        checked += int(dep_decided.sum())
    assert checked >= n


def test_lm_delay_cache_outputs_exact(runs):
    _, ref, got = runs
    n = _compared_frames(ref, got)
    assert n >= 20, f"token streams diverged at frame {n}"
    for f in range(n):
        r, g = ref[f]["out"], got[f]["out"]
        np.testing.assert_array_equal(g["text"], r["text"])
        np.testing.assert_array_equal(g["audio"], r["audio"])
        np.testing.assert_array_equal(g["valid"], r["valid"])


@pytest.mark.parametrize("form", ["0", "1"])
def test_lm_fused_form_is_exercised(form):
    """Form 1 runs K5 in every temporal and depformer layer of every frame
    in both packages; form 0 nowhere."""
    r = _runs(form)
    cfg = r["cfg"]
    per_frame = cfg.num_layers + cfg.dep_q * cfg.depformer_layers
    if form == "1":
        assert r["calls"] == per_frame * _FRAMES
        assert r["traced"] >= 2        # the temporal stack and the depformer
    else:
        assert r["calls"] == 0 and r["traced"] == 0


def _dep_logit_err(ref, got):
    n = _compared_frames(ref, got)
    assert n >= 20, f"token streams diverged at frame {n}"
    return max(_rel_err(got[f]["dep_logits"], ref[f]["dep_logits"])
               for f in range(n))


@pytest.mark.parametrize("form", ["0", "1"])
def test_lm_depformer_logits_match(form):
    r = _runs(form)
    assert _dep_logit_err(r["ref"], r["got"]) < _DEP_RTOL


def _bf16_h_mid_rounding(attn, hcur, out_qt, glu_qt, alpha, layer):
    """K5's plain version with h_mid rounded to the bf16 carry before
    norm2, as the unfused depformer does."""
    o = int8_matvec_plain(attn, out_qt, layer)
    h_mid = hcur.float() + o
    if hcur.dtype == torch.bfloat16:
        h_mid = h_mid.to(torch.bfloat16).float()
    return int8_matvec_plain(h_mid, glu_qt, layer, alpha, glu=True), h_mid


def test_lm_depformer_control_fails_the_limit():
    """The depformer check can see the unfused depformer's rounding: the
    port with h_mid rounded to bf16 before norm2 misses JAX's fused form
    by more than the limit."""
    r = _runs("1")
    got, calls = _run_port(r["cfg"], r["params"], r["other"], "1",
                           fused_plain=_bf16_h_mid_rounding)
    assert calls == r["calls"]
    n = _compared_frames(r["ref"], got)
    err = max(_rel_err(got[f]["dep_logits"], r["ref"][f]["dep_logits"])
              for f in range(n))
    assert err > _DEP_RTOL, err
