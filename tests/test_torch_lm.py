"""The port's LM frame step (moshi_tpu_torch.models.lm.lm_gen_step) against
the JAX package's, on the same q4_k weights, on the CPU.

JAX runs with its Pallas kernels in interpret mode and the mid-layer fusion
off (MOSHI_TPU_FUSE_MID=0, the path the port implements); the port runs
every kernel's plain PyTorch version.  The tiny configuration mirrors the
7B's dispatch: every projection is q4_k on the int8 matvec except the
depformer linear_out, whose hidden width (576, nb = 18) makes it q4_0 and
sends it to the dequant matvec, as the 7B's K = 4224 does.  The temporal
ring holds 16 positions, so 24 frames wrap it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.models.lm import init_gen_state as jax_init_gen_state
from moshi_tpu.models.lm import lm_gen_step as jax_lm_gen_step
from moshi_tpu.quant.formats import QuantTensor as JaxQuantTensor
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.capture import recording
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.quant.formats import QuantTensor
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


def _run_jax(cfg, params, other):
    """JAX's frames, the step jitted as a whole (as bench.py runs it), with
    transformer_out, the text logits and each depformer step's logits
    recorded through the package's capture taps."""
    outs = []
    old = os.environ.get("MOSHI_TPU_FUSE_MID")
    os.environ["MOSHI_TPU_FUSE_MID"] = "0"
    enable_pallas(True)
    try:
        with pallas_interpret(), recording() as rec:
            step = jax.jit(lambda p, s, o: jax_lm_gen_step(
                cfg, p, s, other_audio=o, temp=0.0, temp_text=0.0))
            state = jax_init_gen_state(cfg, 1, jax.random.PRNGKey(5))
            for f in range(len(other)):
                out, state = step(params, state, jnp.asarray(other[f]))
                outs.append({k: np.asarray(v) for k, v in out.items()})
            jax.effects_barrier()
        dep_q = cfg.runtime_dep_q
        dep_logits = rec.values["lm/dep/logits"]
        frames = [{
            "out": out,
            "h": rec.values["lm/transformer_out"][f][:, -1],
            "logits": rec.values["lm/text_logits"][f][:, -1],
            "dep_logits": np.stack(dep_logits[f * dep_q:(f + 1) * dep_q], 1),
        } for f, out in enumerate(outs)]
    finally:
        enable_pallas(False)
        if old is None:
            os.environ.pop("MOSHI_TPU_FUSE_MID", None)
        else:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    return frames


def _run_port(cfg, params, other):
    """The port's frames at temp 0, with transformer_out and the text
    logits of each frame taken from temporal_forward, and the generated
    audio tokens from depformer_generate, on the way."""
    frames = []
    taps = {}
    orig = port_lm.temporal_forward

    def spy(*a, **kw):
        h, logits, kv = orig(*a, **kw)
        taps["h"] = h[:, -1].numpy().copy()
        taps["logits"] = logits[:, -1].numpy().copy()
        return h, logits, kv

    orig_dep = port_lm.depformer_generate

    def spy_dep(*a, **kw):
        tokens = orig_dep(*a, **kw)
        taps["gen_audio"] = tokens.numpy().copy()
        return tokens

    state = port_lm.init_gen_state(cfg, 1, device="cpu")
    port_lm.temporal_forward = spy
    port_lm.depformer_generate = spy_dep
    try:
        for f in range(len(other)):
            out, state = port_lm.lm_gen_step(
                cfg, params, state, other_audio=torch.from_numpy(other[f]),
                temp=0.0, temp_text=0.0)
            frames.append({"out": {k: v.numpy() for k, v in out.items()},
                           **taps})
    finally:
        port_lm.temporal_forward = orig
        port_lm.depformer_generate = orig_dep
    return frames


@pytest.fixture(scope="module")
def runs():
    cfg = JaxLMConfig(**_KW)
    params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
    rng = np.random.default_rng(7)
    other = rng.integers(0, cfg.card, (_FRAMES, 1, cfg.n_q - cfg.dep_q),
                         dtype=np.int32)
    ref = _run_jax(cfg, params, other)
    pcfg = port_lm.LMConfig(**_KW)
    pparams = params_from_numpy(export_numpy(params), device="cpu")
    got = _run_port(pcfg, pparams, other)
    return pparams, ref, got


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
