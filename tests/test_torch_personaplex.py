"""The port's PersonaPlex priming (``moshi_tpu_torch.models.personaplex``)
against the JAX package's, on the CPU, on the same q4_k weights.

The configuration is PersonaPlex's at a small size: 16 codebooks, 16
per-step depformer weights run at 8 steps, a depformer ring of 8, a delay
cache one row longer, and the 7B's dispatch (the stacked decode and the
stacked depformer on the int8 matvec, the depformer linear_out q4_0).
JAX runs its Pallas kernels in interpret mode; the port the plain
versions.  After priming, the delay cache and the offset must be equal,
and the KV rings each element within the LM tests' 2e-3 of the ring's
largest magnitude or within one bf16 step (their bf16 rounding turns a
last-bit difference into a whole step).  The frames after priming are
held tap for tap as ``tests/test_torch_capture.py`` holds a frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.config import load_config as jax_load_config
from moshi_tpu.models import lm as jax_lm
from moshi_tpu.models import personaplex as jax_pp
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.utils import capture as jax_capture
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.config import load_config
from moshi_tpu_torch.io.gguf import GGUFWriter
from moshi_tpu_torch.io.safetensors import save_safetensors
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.models import personaplex as pp
from moshi_tpu_torch.quant.formats import QuantTensor
from moshi_tpu_torch.runtime.synth import synth_lm_params
from moshi_tpu_torch.utils.capture import recording
from tests.test_torch_capture import _bf16_steps, _held
from tests.test_torch_gguf import jax_tree

_RTOL = 2e-3          # tests/test_torch_lm.py:54
_KW = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=32,
           card=2100, n_q=16, dep_q=16, text_card=512,
           delays=(0, 0) + (1,) * 7 + (0,) + (1,) * 7,
           depformer_dim=256, depformer_heads=4, depformer_layers=2,
           depformer_hidden=576, depformer_context=8, depformer_low_rank=32,
           personaplex=True)
_CFG = port_lm.LMConfig(**_KW)
_JCFG = jax_lm.LMConfig(**_KW)
_CONFIG = "configs/personaplex-config.json"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODEL = {}


def _model():
    """(port params, JAX params) of the small PersonaPlex, made once."""
    if not _MODEL:
        p = synth_lm_params(_CFG, "q4_k", device="cpu", seed=2)
        _MODEL.update(port=p, jax=jax_tree(p))
    return _MODEL["port"], _MODEL["jax"]


def _rings_held(got, ref):
    """Every element within _RTOL of the ring's largest magnitude or
    within one bf16 step."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    close = np.abs(got - ref) <= _RTOL * np.max(np.abs(ref))
    return bool(np.all(close | (_bf16_steps(got, ref) <= 1)))


def test_personaplex_config_in_both_packages():
    cfg = port_lm.LMConfig.from_moshi_config(load_config(_CONFIG))
    jcfg = jax_lm.LMConfig.from_moshi_config(jax_load_config(_CONFIG))
    for c in (cfg, jcfg):
        assert c.personaplex and c.dep_q == 16
        assert c.runtime_dep_q == 8
        assert c.cache_len == c.max_delay + 3 == 4
        assert c.num_codebooks == 17 == len(pp.PROMPT_TOKENS)
        assert c.depformer_num_weights == 16
        assert c.depformer.mha.cap == 8
    assert pp.PROMPT_TOKENS == jax_pp.PROMPT_TOKENS
    assert (pp._audio_prompt_frames([[1] * 16, [2] * 3]).tolist()
            == jax_pp._audio_prompt_frames([[1] * 16, [2] * 3]).tolist())


@pytest.mark.parametrize("t", [1, 3], ids=["stacked", "generic_T3"])
def test_forward_embedding_matches_jax(t):
    params, jparams = _model()
    rng = np.random.default_rng(t)
    emb = rng.normal(size=(1, t, _CFG.dim)).astype(np.float32)
    state = port_lm.init_gen_state(_CFG, 1, device="cpu")
    offset = torch.zeros(1, dtype=torch.int32)
    h, logits, _ = pp.forward_embedding(_CFG, params, state["transformer"],
                                        torch.from_numpy(emb), offset)
    enable_pallas(True)
    try:
        with pallas_interpret():
            js = jax_lm.init_gen_state(_JCFG, 1, jax.random.PRNGKey(0))
            jh, jlogits, _ = jax.jit(
                lambda p, kv, e: jax_pp.forward_embedding(
                    _JCFG, p, kv, e, jnp.zeros((1,), jnp.int32)))(
                jparams, js["transformer"], jnp.asarray(emb))
    finally:
        enable_pallas(False)
    for got, ref in ((h, jh), (logits, jlogits)):
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape
        err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
        assert err <= _RTOL, err


_PRIMED = {}


def _voice(rng):
    emb = rng.normal(size=(4, _CFG.dim)).astype(np.float32) * 0.5
    cache = rng.integers(0, _CFG.card, (_CFG.cache_len, _CFG.num_codebooks),
                         dtype=np.int32)
    return emb, cache


def _primed(kind):
    """The JAX and the port states after ``prime_system_prompts`` with a
    voice file's embeddings and cache ("voice") or a voice sample's Mimi
    codes ("audio"), each followed by 2 silence frames, 4 text frames and
    2 silence frames; and both packages' recorders over 2 frames after."""
    if kind in _PRIMED:
        return _PRIMED[kind]
    params, jparams = _model()
    rng = np.random.default_rng(5)
    text = [7, 8, 9, 10]
    if kind == "voice":
        emb, cache = _voice(rng)
        kw = dict(voice_embeddings=emb, voice_cache=cache)
    else:
        codes = rng.integers(0, _CFG.card, (4, 16)).tolist()
        kw = dict(voice_audio_codes=codes)
    others = rng.integers(0, _CFG.card, (2, 1, 8), dtype=np.int32)
    enable_pallas(True)
    try:
        with pallas_interpret():
            js = jax_lm.init_gen_state(_JCFG, 1, jax.random.PRNGKey(1))
            js = jax_pp.prime_system_prompts(
                _JCFG, jparams, js, text, silence_frames=2, temp=0.0,
                temp_text=0.0, **kw)
            primed = jax.tree_util.tree_map(np.asarray, js)
            with jax_capture.recording() as jrec:
                step = jax.jit(lambda p, s, o: jax_lm.lm_gen_step(
                    _JCFG, p, s, other_audio=o, temp=0.0, temp_text=0.0))
                for o in others:
                    out, js = step(jparams, js, jnp.asarray(o))
                jax.block_until_ready(out["audio"])
            jax.effects_barrier()
    finally:
        enable_pallas(False)
    ps = port_lm.init_gen_state(_CFG, 1, device="cpu")
    ps = pp.prime_system_prompts(_CFG, params, ps, text, silence_frames=2,
                                 **kw)
    snap = {"k": ps["transformer"]["k"].clone(),
            "v": ps["transformer"]["v"].clone(),
            "cache": ps["cache"].clone(), "offset": ps["offset"].clone()}
    with recording() as prec:
        for o in others:
            _, ps = port_lm.lm_gen_step(_CFG, params, ps,
                                        other_audio=torch.from_numpy(o),
                                        temp=0.0, temp_text=0.0)
    _PRIMED[kind] = dict(jax=primed, port=snap, jrec=jrec, prec=prec)
    return _PRIMED[kind]


@pytest.mark.parametrize("kind", ["voice", "audio"])
def test_primed_state_matches_jax(kind):
    r = _primed(kind)
    j, p = r["jax"], r["port"]
    n = 4 + 2 + 4 + 2
    np.testing.assert_array_equal(p["offset"].numpy(), j["offset"])
    assert int(p["offset"][0]) == n
    np.testing.assert_array_equal(p["cache"].numpy(), j["cache"])
    for name in ("k", "v"):
        assert _rings_held(p[name], j["transformer"][name]), name
    # every slot the priming wrote is non-zero: the rings hold n positions
    assert bool((p["k"][:, 0, :n].abs().amax(dim=(-1, -2)) > 0).all())


@pytest.mark.parametrize("kind", ["voice", "audio"])
def test_frames_after_priming_match_jax(kind):
    r = _primed(kind)
    jrec, prec = r["jrec"], r["prec"]
    assert prec.order == jrec.order
    assert len(prec.values["lm/dep/token"]) == 2 * _CFG.runtime_dep_q
    assert _held(jrec, prec, _RTOL) == len(jrec.order)


def test_per_step_weights_are_views_for_the_prefix_schedule():
    params, _ = _model()
    dep = params["depformer"]
    step_w = port_lm._per_step_weights(_CFG, dep)
    idx = list(range(_CFG.runtime_dep_q))
    general = dataclasses.replace(
        _CFG, depformer_schedule=(1, 0) + tuple(range(2, 16)))
    gathered = port_lm._per_step_weights(general, dep)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(tree, QuantTensor):
            for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
                if getattr(tree, f) is not None:
                    yield f"{path}.{f}", getattr(tree, f)
        else:
            yield path, tree

    src = {"in": dep["in"], "attn": dep["layers"]["self_attn"],
           "gating": dep["layers"]["gating"], "linears": dep["linears"]}
    n = 0
    for key in src:
        full = dict(leaves(src[key]))
        for path, leaf in leaves(step_w[key]):
            ref = full[path]
            assert leaf.shape[0] == _CFG.runtime_dep_q
            assert leaf.untyped_storage().data_ptr() == \
                ref.untyped_storage().data_ptr(), (key, path)
            assert leaf.is_contiguous()
            assert torch.equal(leaf, ref[idx])
            n += 1
        if key == "linears":
            continue
        # a general schedule gathers: a copy, in its order
        for path, leaf in leaves(gathered[key]):
            ref = full[path]
            assert leaf.untyped_storage().data_ptr() != \
                ref.untyped_storage().data_ptr(), (key, path)
            assert torch.equal(leaf, ref[[1, 0] + idx[2:]])
    assert n >= 20


def _write_voice(tmp_path, fmt, tensors):
    path = str(tmp_path / f"voice.{fmt}")
    if fmt == "safetensors":
        save_safetensors(path, tensors)
    else:
        w = GGUFWriter()
        for name, a in tensors.items():
            w.add_tensor(name, a)
        w.write(path)
    return path


@pytest.mark.parametrize("orient", ["k_ct", "ct_k", "neither"])
@pytest.mark.parametrize("fmt", ["safetensors", "gguf"])
def test_load_voice_file(tmp_path, fmt, orient):
    """The cache stored [K, CT] or [CT, K], with CT > K, is oriented from
    the config's K (a longest-axis rule would misread [K, CT]); a shape
    that fits neither raises.  Both packages read the same file alike."""
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(_CFG, dep_q=4, n_q=8,
                              delays=(0,) * 9)           # K = 9
    k, ct = cfg.num_codebooks, 12
    emb = rng.normal(size=(5, 64)).astype(np.float32)
    shape = {"k_ct": (k, ct), "ct_k": (ct, k), "neither": (ct, k + 1)}[orient]
    cache = rng.integers(0, 100, shape, dtype=np.int32)
    path = _write_voice(tmp_path, fmt, {"voice.embeddings": emb,
                                        "voice.cache": cache})
    jcfg = jax_lm.LMConfig(**{**_KW, "dep_q": 4, "n_q": 8,
                              "delays": (0,) * 9})
    if orient == "neither":
        for load, c in ((pp.load_voice_file, cfg),
                        (jax_pp.load_voice_file, jcfg)):
            with pytest.raises(ValueError, match="voice.cache shape"):
                load(path, c)
        return
    e, c, wavs = pp.load_voice_file(path, cfg)
    je, jc, jwavs = jax_pp.load_voice_file(path, jcfg)
    np.testing.assert_array_equal(e, emb)
    np.testing.assert_array_equal(c, cache.T if orient == "k_ct" else cache)
    assert c.dtype == np.int32 and c.shape == (ct, k)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(c, jc)
    assert wavs is None and jwavs is None
