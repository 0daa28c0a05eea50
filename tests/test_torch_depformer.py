"""K14, the depformer megakernels (``moshi_tpu_torch.nn.depformer``),
against the JAX package's ``dep_full_step``, ``dep_layer_step`` and
``dep_frame_step`` in interpret mode, on the CPU, and the depformer
predicates against the JAX package's.

The geometry: a 256-wide depformer of 2 layers and 4 heads, dep_q 4 with
a 4-slot ring, card 256, on the JAX package's q4_k synthetic weights
carried across with ``params_from_numpy``.  A depformer hidden of 576 (a
multiple of 64, not of 256) makes the quantization policy store
linear_out in q4_0, as the 7B's 4224 does; 512 keeps it q4_k.

Limits, relative to the reference's largest value: h within ``_TOL`` =
1e-6 (sound readings below 1e-7: f32 sums in another order), the ring
rows within one bf16 ulp; the frame's tokens equal.  Control above the
limit: p * v rounded to bf16 before the sum (K13's form; 1.5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models import lm as jax_lm
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.nn import pallas_depformer as jax_dep
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import depformer as port_dep
from moshi_tpu_torch.runtime.convert import (params_from_numpy,
                                             tensor_from_numpy)
from test_torch_lm import export_numpy
from test_torch_temporal import _rel, _ulps

_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(hidden, **over):
    return {**dict(dim=256, num_heads=4, num_layers=1, hidden_dim=256,
                   context=16, card=256, n_q=8, dep_q=4, text_card=512,
                   delays=(0,) * 9, depformer_dim=256, depformer_heads=4,
                   depformer_layers=2, depformer_hidden=hidden,
                   depformer_low_rank=32), **over}


_MODELS = {}


def _model(hidden):
    """(JAX config, params, per-step weights; the port's params) for a
    depformer hidden width, made once per module."""
    if hidden not in _MODELS:
        cfg = JaxLMConfig(**_kw(hidden))
        p = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
        sw = jax_lm._per_step_weights(cfg, p["depformer"])
        _MODELS[hidden] = (cfg, p, sw,
                           params_from_numpy(export_numpy(p), device="cpu"))
    return _MODELS[hidden]


def _step_weights(p, sw, step, tree_map):
    lay = p["depformer"]["layers"]
    return {"qkv": tree_map(sw["attn"]["in_proj"]["weight"], step),
            "out": tree_map(sw["attn"]["out_proj"]["weight"], step),
            "glu": tree_map(sw["gating"]["linear_in"]["weight"], step),
            "lout": tree_map(sw["gating"]["linear_out"]["weight"], step),
            "n1": lay["norm1"]["alpha"], "n2": lay["norm2"]["alpha"]}


def _jax_at(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _port_weights(hidden, step):
    cfg, p, sw, pp = _model(hidden)
    psw = port_lm._per_step_weights(port_lm.LMConfig(**_kw(hidden)),
                                    pp["depformer"])
    return _step_weights(pp, psw, step, lambda qt, i: qt._map(
        lambda a: a[i]))


def _inputs(cap, seed, layers=2):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((1, 256)).astype(np.float32)
    kc = rng.standard_normal((layers, cap, 256)).astype(jnp.bfloat16)
    vc = rng.standard_normal((layers, cap, 256)).astype(jnp.bfloat16)
    return h, kc, vc


def _full_step_both(hidden, cb, cap=4, step=1):
    cfg, p, sw, _ = _model(hidden)
    h, kc, vc = _inputs(cap, seed=10 + cb)
    with pallas_interpret():
        ref = jax_dep.dep_full_step(
            jnp.asarray(h), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(cb),
            _step_weights(p, sw, step, _jax_at), cap=cap, heads=4,
            nlayers=2)
    args = (torch.from_numpy(h), tensor_from_numpy(kc, "cpu"),
            tensor_from_numpy(vc, "cpu"), cb, _port_weights(hidden, step))
    return [np.asarray(a) for a in ref], args


@pytest.mark.parametrize("cb", range(4))
@pytest.mark.parametrize("hidden,lout", [(576, "q4_0"), (512, "q4_k")])
def test_k14a_plain_matches_pallas(hidden, lout, cb):
    """``dep_full_step`` at every step of a 4-slot ring, linear_out in
    q4_0 and in q4_k; the rings are written in place at row cb."""
    ref, args = _full_step_both(hidden, cb)
    assert args[4]["lout"].fmt == lout
    y, k, v = port_dep.dep_full_step(*args, cap=4, heads=4, nlayers=2)
    assert k is args[1] and v is args[2]
    assert y.shape == (1, 256) and y.dtype == torch.float32
    assert _rel(y.numpy(), ref[0]) < _TOL
    assert _ulps(k.float().numpy(), ref[1].astype(np.float32)) <= 1
    assert _ulps(v.float().numpy(), ref[2].astype(np.float32)) <= 1


def _values_rounded(p, v, hd):
    pe = torch.repeat_interleave(p.to(torch.bfloat16).float(), hd, dim=1)
    return (pe * v.float()).to(torch.bfloat16).float().sum(0)


def test_k14a_control_fails_the_limit(monkeypatch):
    """p * v rounded to bf16 before the sum (K13's form) misses the Pallas
    kernel by more than the limit: K14's products are exact."""
    ref, args = _full_step_both(576, 3)
    monkeypatch.setattr(port_dep, "_dep_values", _values_rounded)
    y = port_dep.dep_full_step(*args, cap=4, heads=4, nlayers=2)[0]
    assert _rel(y.numpy(), ref[0]) > _TOL


@pytest.mark.parametrize("cb", range(4))
def test_k14b_layer_step_matches_pallas(cb):
    """``dep_layer_step`` (one layer, all four weights q4_k) against the
    Pallas kernel, through ``dep_full_step`` at one layer."""
    cfg, p, sw, _ = _model(512)
    h, kc, vc = _inputs(4, seed=20 + cb, layers=1)
    w = _step_weights(p, sw, 2, _jax_at)
    w1 = {n: _jax_at(w[n], 0) for n in ("qkv", "out", "glu", "lout")}
    w1["n1"], w1["n2"] = w["n1"][0], w["n2"][0]
    with pallas_interpret():
        ref = jax_dep.dep_layer_step(
            jnp.asarray(h), jnp.asarray(kc[0]), jnp.asarray(vc[0]),
            jnp.int32(cb), w1, cap=4, heads=4)
    pw = _port_weights(512, 2)
    pw1 = {n: pw[n]._map(lambda a: a[0])
           for n in ("qkv", "out", "glu", "lout")}
    pw1["n1"], pw1["n2"] = pw["n1"][0], pw["n2"][0]
    k, v = tensor_from_numpy(kc[0], "cpu"), tensor_from_numpy(vc[0], "cpu")
    y, k2, v2 = port_dep.dep_layer_step(torch.from_numpy(h), k, v, cb, pw1,
                                        cap=4, heads=4)
    assert k2 is k and v2 is v
    assert _rel(y.numpy(), np.asarray(ref[0])) < _TOL
    assert _ulps(k.float().numpy(), np.asarray(ref[1]).astype(np.float32)) \
        <= 1


def test_k14a_past_the_ring_writes_nothing():
    """With fewer ring slots than steps (cap 2 < dep_q 4) the Pallas
    kernel writes no row at cb >= cap and attends every slot; the port
    does the same (the XLA depformer wraps to slot cb % cap instead:
    ROADMAP.md, C)."""
    for cb in (2, 3):
        cfg, p, sw, _ = _model(576)
        h, kc, vc = _inputs(2, seed=30 + cb)
        with pallas_interpret():
            ref = jax_dep.dep_full_step(
                jnp.asarray(h), jnp.asarray(kc), jnp.asarray(vc),
                jnp.int32(cb), _step_weights(p, sw, 1, _jax_at), cap=2,
                heads=4, nlayers=2)
        k = tensor_from_numpy(kc, "cpu")
        y, k2, _ = port_dep.dep_full_step(
            torch.from_numpy(h), k, tensor_from_numpy(vc, "cpu"), cb,
            _port_weights(576, 1), cap=2, heads=4, nlayers=2)
        np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(kc))
        assert torch.equal(k2, tensor_from_numpy(kc, "cpu"))
        assert _rel(y.numpy(), np.asarray(ref[0])) < _TOL


def _frame_inputs(hidden, seed):
    """The frame kernel's inputs as ``_depformer_generate_frame_kernel``
    builds them: h_in [dep_q, 1, dd], text_emb [1, dd], the per-step
    weights (emb and lr_w with a dummy row 0)."""
    cfg, p, sw, pp = _model(hidden)
    dep = p["depformer"]
    rng = np.random.default_rng(seed)
    h_in = (rng.standard_normal((4, 1, 256))).astype(np.float32)
    text = (rng.standard_normal((1, 256)) * 0.5).astype(np.float32)
    jw = {"qkv": sw["attn"]["in_proj"]["weight"],
          "out": sw["attn"]["out_proj"]["weight"],
          "glu": sw["gating"]["linear_in"]["weight"],
          "lout": sw["gating"]["linear_out"]["weight"],
          "n1": dep["layers"]["norm1"]["alpha"],
          "n2": dep["layers"]["norm2"]["alpha"],
          "linears": sw["linears"]["weight"],
          "emb": sw["emb"]["weight"],
          "lr_w": sw["emb"]["low_rank"]["weight"]}
    pw = params_from_numpy(export_numpy(jw), device="cpu")
    return h_in, text, jw, pw


@pytest.mark.parametrize("temp,top_k", [(0.0, 250), (0.8, 250), (0.8, 0),
                                        (1.2, 17)])
@pytest.mark.parametrize("hidden", [576, 512])
def test_k14c_frame_tokens_match_pallas(hidden, temp, top_k):
    """The whole frame: every step's embedding, layers, dequant logits and
    sampling, at temp 0 and at temp > 0 on JAX's Gumbel noise; the
    tokens equal."""
    h_in, text, jw, pw = _frame_inputs(hidden, seed=hidden + top_k)
    noise = np.array(jax.random.gumbel(jax.random.PRNGKey(top_k),
                                       (4, 1, 256), jnp.float32))
    kw = dict(cap=4, heads=4, nlayers=2, card=256, temp=temp, top_k=top_k)
    with pallas_interpret():
        ref = np.asarray(jax_dep.dep_frame_step(
            jnp.asarray(h_in), jnp.asarray(text), jw, jnp.asarray(noise),
            **kw))
    got = port_dep.dep_frame_step(torch.from_numpy(h_in),
                                  torch.from_numpy(text), pw,
                                  torch.from_numpy(noise), **kw)
    assert got.dtype == torch.int32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_topk_threshold_and_argmax_follow_pallas():
    """The bisection threshold and the first-index argmax, value for value
    (ties included), against the Pallas kernel's helpers."""
    rng = np.random.default_rng(4)
    for k in (1, 5, 250, 256):
        v = rng.standard_normal((1, 256)).astype(np.float32)
        v[0, 10] = v[0, 200] = v.max()           # a tie for the argmax
        thr = jax_dep._topk_threshold(jnp.asarray(v), k)
        got = port_dep._topk_threshold(torch.from_numpy(v[0]), k)
        assert float(got) == float(thr)
        assert int(port_dep._argmax_lane(torch.from_numpy(v[0]))) == \
            int(jax_dep._argmax_lane(jnp.asarray(v))) == 10


_PRED_CONFIGS = {
    "7b-like": {},
    "card 192": dict(card=192),
    "ring 2": dict(depformer_context=2),
    "dep_q 1": dict(dep_q=1, n_q=1, delays=(0, 0)),
    # the TTS class's kind: cross-attention, dep_q = n_q
    "tts": dict(cross_attention=True, n_q=4, delays=(0, 0, 2, 2, 2)),
}


_PRED_PARAMS = {}


def _pred_params(name, fmt):
    if (name, fmt) not in _PRED_PARAMS:
        kw = _kw(576, **_PRED_CONFIGS[name])
        p = jax_synth_lm_params(jax.random.PRNGKey(0), JaxLMConfig(**kw),
                                fmt=fmt)
        _PRED_PARAMS[name, fmt] = (
            kw, p, params_from_numpy(export_numpy(p), device="cpu"))
    return _PRED_PARAMS[name, fmt]


@pytest.mark.parametrize("knob", [None, "temporal", "dep", "all"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", None])
@pytest.mark.parametrize("name", list(_PRED_CONFIGS))
def test_dep_predicates_match_jax(monkeypatch, knob, batch, fmt, name):
    """``_can_use_dep_megakernel`` and ``_can_use_dep_frame_kernel`` equal
    the JAX package's (its Pallas switch on) for each knob value, B, weight
    format and configuration: a card that is not a multiple of 128 or a
    ring shorter than dep_q leaves K14a without K14c."""
    if knob is None:
        monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL", raising=False)
    else:
        monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", knob)
    kw, p, pp = _pred_params(name, fmt)
    cfg = JaxLMConfig(**kw)
    enable_pallas(True)
    try:
        sw = jax_lm._per_step_weights(cfg, p["depformer"])
        want = (jax_lm._can_use_dep_megakernel(cfg, p["depformer"], batch),
                jax_lm._can_use_dep_frame_kernel(cfg, p["depformer"], sw,
                                                 batch))
    finally:
        enable_pallas(False)
    pcfg = port_lm.LMConfig(**kw)
    psw = port_lm._per_step_weights(pcfg, pp["depformer"])
    got = (port_lm._can_use_dep_megakernel(pcfg, pp["depformer"], batch),
           port_lm._can_use_dep_frame_kernel(pcfg, pp["depformer"], psw,
                                             batch))
    assert got == want
    on = knob in ("dep", "all") and batch == 1 and fmt == "q4_k"
    assert got[0] == on
    assert got[1] == (on and name in ("7b-like", "tts"))
