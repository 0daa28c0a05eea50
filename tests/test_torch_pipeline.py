"""The port's full-duplex frame (``moshi_tpu_torch.runtime.pipeline
.STSPipeline``) against the JAX package's, on the CPU, at temp 0 over 8
frames: Mimi encode -> LM frame (in the default fused form) -> Mimi
decode, on the same weights and audio.

The LM is the tiny q4_k configuration of ``test_torch_lm.py`` with
card = 64, Mimi's codebook size: the LM's audio ids index Mimi's
codebooks, and JAX's gather clamps an out-of-range id where PyTorch's
indexing raises.  Mimi runs in f32 here, where the two packages' codes
agree exactly (its bf16 numerics are ``test_torch_mimi.py``'s).  JAX runs
with its Pallas kernels in interpret mode; its logits are recorded
through a ``jax.debug.callback`` around ``sample_token``.
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
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.quant.formats import QuantTensor as JaxQuantTensor
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.pipeline import STSPipeline as JaxSTSPipeline
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime.convert import params_from_numpy
from moshi_tpu_torch.runtime.pipeline import STSPipeline

_LM = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
           card=64, n_q=4, dep_q=2, text_card=512, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=4, depformer_layers=2,
           depformer_hidden=576, depformer_low_rank=32)
_MIMI = dict(n_q=4, total_codebooks=8, dim=32, codebook_dim=16,
             codebook_size=64, transformer_layers=2, transformer_heads=4,
             transformer_context=16, transformer_hidden=64)
_SEANET = dict(dimension=32, n_filters=4, ratios=(4, 3, 2, 2))
_FRAMES = 8
# As in test_torch_lm.py: a token must match where JAX's top-1/top-2 logit
# gap exceeds 0.2% of the row's largest magnitude (a flipped int8
# activation rounding moves a logit by up to about that much).
_RTOL = 2e-3
# The decoded audio of equal codes: f32 Mimi, sums in another order.
_AUDIO_TOL = 1e-5


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


def _mimi_params(model, seed):
    """Mimi's tree drawn with numpy: N(0, 1) codebooks, fan-in scaled
    matrices and kernels, vectors N(0, 0.1) around 1 (norm weights) or 0."""
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


def _gap(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.max(np.abs(logits), axis=-1)


def _split(logged, frames, dep_q):
    per = 1 + dep_q
    assert len(logged) == frames * per, len(logged)
    return [{"logits": logged[f * per],
             "dep_logits": np.stack(logged[f * per + 1:(f + 1) * per], 1)}
            for f in range(frames)]


def _run_jax(cfg, mcfg, lm_params, mimi_params, audio):
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
    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    jax_lm.sample_token = sample
    enable_pallas(True)
    try:
        with pallas_interpret():
            pipe = JaxSTSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                                  mimi_dtype=jnp.float32)
            state = pipe.init_state(1, jax.random.PRNGKey(2))
            for a in audio:
                out, state = pipe.step(mimi_params, lm_params, state, a)
                frames.append({k: np.asarray(v) for k, v in out.items()})
            jax.effects_barrier()
    finally:
        enable_pallas(False)
        jax_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    for fr, lg, c in zip(frames, _split(logged, len(audio), cfg.dep_q),
                         codes):
        fr.update(lg, codes=c)
    return frames


def _run_port(lm_params, mimi_params, audio):
    cfg = port_lm.LMConfig(**_LM)
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
    old = os.environ.pop("MOSHI_TPU_FUSE_MID", None)
    try:
        pipe = STSPipeline(mimi, cfg, temp=0.0, temp_text=0.0,
                           mimi_dtype=torch.float32, device="cpu")
        state = pipe.init_state(1, seed=2)
        for a in audio:
            out, state = pipe.step(mimi_params, lm_params, state,
                                   torch.from_numpy(a))
            frames.append({k: v.numpy() for k, v in out.items()})
    finally:
        port_lm.sample_token = orig_sample
        if old is not None:
            os.environ["MOSHI_TPU_FUSE_MID"] = old
    for fr, lg, c in zip(frames, _split(logged, len(audio), cfg.dep_q),
                         codes):
        fr.update(lg, codes=c)
    return frames


@pytest.fixture(scope="module")
def runs():
    cfg = JaxLMConfig(**_LM)
    mcfg = JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_MIMI)
    lm_params = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
    mimi_params = _mimi_params(JaxMimiModel(mcfg), 4)
    rng = np.random.default_rng(5)
    fs = mcfg.seanet.hop_length * mcfg.frames_per_step
    audio = [(rng.normal(size=(1, fs)) * 0.1).astype(np.float32)
             for _ in range(_FRAMES)]
    ref = _run_jax(cfg, mcfg, lm_params, mimi_params, audio)
    got = _run_port(params_from_numpy(_np(lm_params), device="cpu"),
                    params_from_numpy(_np(mimi_params), device="cpu"), audio)
    return ref, got


def _compared(ref, got):
    """Frames before the first token that legitimately differs (JAX's gap
    within the tolerance): later frames take other inputs."""
    for f, (r, g) in enumerate(zip(ref, got)):
        if np.any((np.argmax(r["logits"], -1) != np.argmax(g["logits"], -1))
                  & (_gap(r["logits"]) <= _RTOL)):
            return f
        if np.any((np.argmax(r["dep_logits"], -1)
                   != np.argmax(g["dep_logits"], -1))
                  & (_gap(r["dep_logits"]) <= _RTOL)):
            return f
    return len(ref)


def test_sts_mimi_codes_identical(runs):
    ref, got = runs
    n = _compared(ref, got)
    assert n >= 6, f"token streams diverged at frame {n}"
    for f in range(n):
        np.testing.assert_array_equal(got[f]["codes"], ref[f]["codes"])


def test_sts_tokens_match_where_decided(runs):
    ref, got = runs
    n = _compared(ref, got)
    assert n >= 6, f"token streams diverged at frame {n}"
    checked = 0
    for f in range(n):
        for key in ("logits", "dep_logits"):
            decided = _gap(ref[f][key]) > _RTOL
            np.testing.assert_array_equal(
                np.argmax(got[f][key], -1)[decided],
                np.argmax(ref[f][key], -1)[decided])
            checked += int(decided.sum())
        for key in ("text", "audio_tokens", "valid"):
            np.testing.assert_array_equal(got[f][key], ref[f][key])
    assert checked >= 2 * n


def test_sts_audio_out_close(runs):
    ref, got = runs
    n = _compared(ref, got)
    assert n >= 6, f"token streams diverged at frame {n}"
    for f in range(n):
        a, b = got[f]["audio_out"], ref[f]["audio_out"]
        assert a.shape == b.shape == (1, 96) and a.dtype == np.float32
        assert np.all(np.isfinite(a))
        err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
        assert err < _AUDIO_TOL, (f, err)
