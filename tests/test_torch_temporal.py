"""K13, the temporal megakernel (``moshi_tpu_torch.nn.temporal``), and the
flat KV layout of ``nn/transformer.py`` against the JAX package's
``temporal_full_step`` in interpret mode, on the CPU.

The geometry is ``tests/test_pallas_temporal.py``'s (dim 256, 4 heads,
2 layers), with the JAX package's q4_k synthetic weights carried across
with ``params_from_numpy``.  The port runs K13's plain version.

Limits, relative to the reference's largest value: h_out within
``_TOL`` = 1e-6 (sound readings 2.3e-8 to 4.7e-8: the f32 sums in another
order); the k/v rows within one bf16 ulp (their f32 values differ in the
last bits, which can straddle a bf16 rounding).  Controls, each a plain
version with one rounding changed, land above the limit: p kept in f32
(2.6e-5 on the 600-slot ring), the score and p * v products left exact in
f32 (2.5e-5 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.nn import pallas_temporal as jax_temporal
from moshi_tpu.nn import transformer as jax_tr
from moshi_tpu.nn.rope import rope_angles as jax_rope_angles
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import temporal as port_temporal
from moshi_tpu_torch.nn import transformer as port_tr
from moshi_tpu_torch.nn.rope import rope_angles
from moshi_tpu_torch.runtime.convert import (params_from_numpy,
                                             tensor_from_numpy)
from test_torch_lm import export_numpy

_KW = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=256, context=16,
           card=256, n_q=4, dep_q=2, text_card=512, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=4, depformer_layers=1,
           depformer_hidden=256, depformer_low_rank=16)
_TOL = 1e-6
_STEPS = 20


@pytest.fixture(scope="module")
def tparams():
    """(JAX transformer params, the port's)."""
    p = jax_synth_lm_params(jax.random.PRNGKey(0), JaxLMConfig(**_KW),
                            fmt="q4_k")["transformer"]
    return p, params_from_numpy(export_numpy(p), device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(lay):
    return {"qkv": lay["self_attn"]["in_proj"]["weight"],
            "out": lay["self_attn"]["out_proj"]["weight"],
            "glu": lay["gating"]["linear_in"]["weight"],
            "lout": lay["gating"]["linear_out"]["weight"],
            "n1": lay["norm1"]["alpha"], "n2": lay["norm2"]["alpha"]}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _ulps(got, ref):
    """Largest distance in bf16 ulps between two bf16 arrays."""
    a = np.asarray(got, np.float32).view(np.int32) >> 16
    b = np.asarray(ref, np.float32).view(np.int32) >> 16
    return int(np.max(np.abs(a.astype(np.int64) - b)))


@pytest.mark.parametrize("dd,hidden,cap", [(256, 256, 16), (256, 512, 600),
                                           (4096, 11264, 3000),
                                           (2048, 8448, 750)])
def test_plan_stages_matches_jax(dd, hidden, cap):
    assert port_temporal.plan_stages(dd, hidden, cap) == \
        jax_temporal.plan_stages(dd, hidden, cap)


def _prefilled(cap, offset, seed):
    """A JAX flat ring of this geometry [2, cap_pad, 256] holding random
    bf16 rows (zeros past cap), h and the position's rope angles."""
    chunk, cap_pad = port_temporal.plan_stages(256, 256, cap)[4:6]
    rng = np.random.default_rng(seed)
    kc = (rng.standard_normal((2, cap_pad, 256)) * 2).astype(jnp.bfloat16)
    vc = rng.standard_normal((2, cap_pad, 256)).astype(jnp.bfloat16)
    kc[:, cap:] = 0
    vc[:, cap:] = 0
    h = rng.standard_normal((1, 256)).astype(np.float32)
    return h, kc, vc


def _run_both(tparams, cap, context, offset, seed):
    p, pp = tparams
    h, kc, vc = _prefilled(cap, offset, seed)
    cos, sin = jax_rope_angles(jnp.asarray([offset], jnp.int32), 64,
                               10_000.0)
    kw = dict(cap=cap, context=context, heads=4, hidden=256, nlayers=2)
    with pallas_interpret():
        ref = jax_temporal.temporal_full_step(
            jnp.asarray(h), jnp.asarray(kc), jnp.asarray(vc),
            jnp.int32(offset), (cos, sin), _weights(p["layers"]), **kw)
    args = (torch.from_numpy(h), tensor_from_numpy(kc, "cpu"),
            tensor_from_numpy(vc, "cpu"),
            torch.tensor(offset, dtype=torch.int32),
            rope_angles(torch.tensor([offset]), 64),
            _weights(pp["layers"]))
    return [np.asarray(a) for a in ref], args, kw


@pytest.mark.parametrize("cap,context,offset", [(600, 600, 700),
                                                (600, 300, 1201)])
def test_k13_plain_matches_pallas_on_a_prefilled_ring(tparams, cap, context,
                                                      offset):
    """Two chunks of 512, the second cut at cap, at an offset past cap:
    the online softmax crosses a chunk and the mask cuts the last one."""
    ref, args, kw = _run_both(tparams, cap, context, offset, seed=1)
    assert port_temporal.plan_stages(256, 256, cap)[4:6] == (512, 1024)
    h_out, k_new, v_new = port_temporal.temporal_full_step(*args, **kw)
    assert h_out.shape == (1, 256) and h_out.dtype == torch.float32
    assert k_new.shape == v_new.shape == (2, 1, 256)
    assert _rel(h_out.numpy(), ref[0]) < _TOL
    assert _ulps(k_new.float().numpy(), ref[1].astype(np.float32)) <= 1
    assert _ulps(v_new.float().numpy(), ref[2].astype(np.float32)) <= 1


def _p_in_f32(p, v, hd):
    pe = torch.repeat_interleave(p, hd, dim=1)
    return port_temporal._bf16_product(pe, v).sum(0)


def _exact_products(k, q, hd):
    prod = k.float() * q.float()
    return prod.reshape(prod.shape[0], -1, hd).sum(-1)


def _exact_values(p, v, hd):
    pe = torch.repeat_interleave(p.to(torch.bfloat16).float(), hd, dim=1)
    return (pe * v.float()).sum(0)


@pytest.mark.parametrize("control", ["p in f32", "exact products"])
def test_k13_controls_fail_the_limit(tparams, monkeypatch, control):
    """The limit sees one rounding: K13's plain version with p kept in f32,
    or with the bf16 products of the scores and of p * v left exact (the
    form the XLA path computes, and K14's), misses the Pallas kernel by
    more than the limit."""
    ref, args, kw = _run_both(tparams, 600, 600, 700, seed=1)
    if control == "p in f32":
        monkeypatch.setattr(port_temporal, "_weighted_values", _p_in_f32)
    else:
        monkeypatch.setattr(port_temporal, "_head_scores", _exact_products)
        monkeypatch.setattr(port_temporal, "_weighted_values", _exact_values)
    h_out = port_temporal.temporal_full_step(*args, **kw)[0]
    assert _rel(h_out.numpy(), ref[0]) > _TOL


def test_k13_forward_matches_pallas_through_a_ring_wrap(tparams,
                                                         monkeypatch):
    """20 steps of ``_forward_megakernel`` (K13, then the ring write at
    offset % cap) at context 16: the outputs every step, and the rings at
    the end, written through a wrap."""
    monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", "temporal")
    p, pp = tparams
    jcfg = JaxLMConfig(**_KW).transformer
    pcfg = port_lm.LMConfig(**_KW).transformer
    j_state = jax_tr.init_transformer_state(jcfg, 1, flat=True)
    p_state = port_tr.init_transformer_state(pcfg, 1, "cpu", flat=True)
    assert tuple(p_state["k"].shape) == j_state["k"].shape == (2, 128, 256)
    rng = np.random.default_rng(7)
    errs = []
    for step in range(_STEPS):
        x = rng.standard_normal((1, 1, 256)).astype(np.float32)
        with pallas_interpret():
            y_ref, j_state = jax_tr._forward_megakernel(
                jcfg, p, j_state, jnp.asarray(x),
                jnp.full((1,), step, jnp.int32))
        y, p_state = port_tr.transformer_forward(
            pcfg, pp, p_state, torch.from_numpy(x),
            torch.full((1,), step, dtype=torch.int32))
        assert y.shape == (1, 1, 256)
        errs.append(_rel(y.numpy(), y_ref))
    assert max(errs) < _TOL, errs
    for name in ("k", "v"):
        assert _ulps(p_state[name].float().numpy(),
                     np.asarray(j_state[name]).astype(np.float32)) <= 1


def test_k13_refuses_a_ring_of_another_plan(tparams):
    _, args, kw = _run_both(tparams, 600, 600, 700, seed=1)
    h, kc, vc, *rest = args
    with pytest.raises(ValueError, match="cap_pad"):
        port_temporal.temporal_full_step(h, kc[:, :512], vc[:, :512], *rest,
                                         **kw)


_PRED_PARAMS = {}
# the 7B-like geometry; the TTS class's kind (cross-attention: no K13);
# the STT class's kind (no depformer, extra heads)
_PRED_CONFIGS = {
    "7b-like": {},
    "tts": dict(cross_attention=True, dep_q=4, delays=(0, 0, 2, 2, 2)),
    "stt": dict(dep_q=0, extra_heads_num=4, extra_heads_dim=6),
}


@pytest.mark.parametrize("knob", [None, "temporal", "dep", "all"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", None])
@pytest.mark.parametrize("name", list(_PRED_CONFIGS))
def test_temporal_predicate_matches_jax(monkeypatch, knob, batch, fmt,
                                        name):
    """``can_use_temporal_megakernel`` equals the JAX package's (with its
    Pallas switch on) for each knob value, B, weight format and model
    class."""
    if knob is None:
        monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL", raising=False)
    else:
        monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", knob)
    kw = {**_KW, **_PRED_CONFIGS[name]}
    cfg = JaxLMConfig(**kw)
    if (name, fmt) not in _PRED_PARAMS:
        p = jax_synth_lm_params(jax.random.PRNGKey(0), cfg, fmt=fmt)
        _PRED_PARAMS[name, fmt] = (p, params_from_numpy(export_numpy(p),
                                                        device="cpu"))
    p, pp = _PRED_PARAMS[name, fmt]
    enable_pallas(True)
    try:
        want = jax_tr.can_use_temporal_megakernel(
            cfg.transformer, p["transformer"], batch)
    finally:
        enable_pallas(False)
    got = port_tr.can_use_temporal_megakernel(
        port_lm.LMConfig(**kw).transformer, pp["transformer"], batch)
    assert got == want
    assert got == (knob in ("temporal", "all") and batch == 1
                   and fmt == "q4_k" and name != "tts")


def test_flat_layout_is_opt_in(tparams, monkeypatch):
    """Without the knob the weights do not change the layout; with it the
    flat layout is chosen at B = 1 only."""
    _, pp = tparams
    cfg = port_lm.LMConfig(**_KW)
    params = {"transformer": pp}
    monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL", raising=False)
    st = port_lm.init_gen_state(cfg, 1, device="cpu", params=params)
    assert st["transformer"]["k"].shape == (2, 1, 16, 4, 64)
    monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", "all")
    st = port_lm.init_gen_state(cfg, 1, device="cpu", params=params)
    assert st["transformer"]["k"].shape == (2, 128, 256)
    assert port_lm.init_gen_state(cfg, 1, device="cpu")["transformer"][
        "k"].dim() == 5
    st2 = port_lm.init_gen_state(cfg, 2, device="cpu", params=params)
    assert st2["transformer"]["k"].shape == (2, 2, 16, 4, 64)
    with pytest.raises(ValueError):
        port_tr.init_transformer_state(cfg.transformer, 2, "cpu", flat=True)


def test_flat_layout_refuses_prefill_and_cross_attention(tparams):
    _, pp = tparams
    tcfg = port_lm.LMConfig(**_KW).transformer
    state = port_tr.init_transformer_state(tcfg, 1, "cpu", flat=True)
    off = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="T=1"):
        port_tr.transformer_forward(tcfg, pp, state,
                                    torch.zeros((1, 2, 256)), off)
    kv = {"k": torch.zeros((2, 1, 3, 4, 64)), "v": torch.zeros((2, 1, 3, 4,
                                                                   64))}
    with pytest.raises(ValueError, match="cross"):
        port_tr.transformer_forward(tcfg, pp, state,
                                    torch.zeros((1, 1, 256)), off,
                                    cross_kv=kv)
