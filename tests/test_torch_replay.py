"""Replay-style divergence localization in the port
(``moshi_tpu_torch.utils.replay``): the counterparts of
``tests/test_replay.py``'s cases, on the CPU, where every op re-executes
on its kernel's plain version.

A planted fault is named at its tap and layer, a clean repeat matches,
``replay_ops`` reproduces every recorded op (with and without the
attention op) and names a planted fault, the f32 ring-attention oracle
agrees across backends within ``TOL_GPU`` (the reference's cross-backend
tolerance, replay.h:332-341) and with the JAX package's oracle, a JAX
trace replays on the port's plain versions within ``TOL_GPU``, SEANet's
encoder and decoder convs replay from their recorded state, and
``qt_layer`` slices a stacked QuantTensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models import lm as jax_lm
from moshi_tpu.quant.formats import enable_pallas
from moshi_tpu.utils import capture as jax_capture
from moshi_tpu.utils import replay as jax_replay
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn.decode_attention import decode_attention_plain
from moshi_tpu_torch.nn.seanet import (SEANetConfig, SEANetDecoder,
                                       SEANetEncoder)
from moshi_tpu_torch.runtime.synth import synth_lm_params
from moshi_tpu_torch.utils.capture import TOL_CPU, TOL_GPU, recording
from moshi_tpu_torch.utils.replay import (first_divergence, qt_layer,
                                          replay_ops, seanet_ops,
                                          stacked_layer_ops,
                                          xla_ring_attention)
from tests.test_torch_gguf import jax_tree

# tests/test_replay.py's configuration: 3 layers, so a fault at layer 1
# has a clean layer on each side
_KW = dict(dim=256, num_heads=4, num_layers=3, hidden_dim=256, context=32,
           card=256, n_q=4, dep_q=2, text_card=512, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=4, depformer_layers=1,
           depformer_hidden=256, depformer_low_rank=16)
_CFG = port_lm.LMConfig(**_KW)
_SEANET = SEANetConfig(dimension=32, n_filters=4, ratios=(4, 3, 2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _params():
    if not _PARAMS:
        _PARAMS["p"] = synth_lm_params(_CFG, "q4_k", device="cpu", seed=0)
    return _PARAMS["p"]


def _record(params, steps=2):
    """A recorder over ``steps`` frames of a fresh session at temp 0."""
    state = port_lm.init_gen_state(_CFG, 1, device="cpu")
    with recording() as rec:
        for f in range(steps):
            other = torch.full((1, _CFG.n_q - _CFG.dep_q), 7 + f)
            _, state = port_lm.lm_gen_step(_CFG, params, state,
                                           other_audio=other, temp=0.0,
                                           temp_text=0.0)
    return rec


_RECS = {}


def _golden():
    if not _RECS:
        _RECS["rec"] = _record(_params())
    return _RECS["rec"]


def _trace(rec):
    return {k: list(v) for k, v in rec.values.items()}


def _corrupt_layer(params, layer):
    """One layer's in_proj rows with every packed bit flipped."""
    w = params["transformer"]["layers"]["self_attn"]["in_proj"]["weight"]
    q = w.q.clone()
    q[layer] ^= 0xFF
    out = {**params, "transformer": {**params["transformer"]}}
    lay = out["transformer"]["layers"] = {**params["transformer"]["layers"]}
    lay["self_attn"] = {**lay["self_attn"],
                        "in_proj": {"weight": dataclasses.replace(w, q=q)}}
    return out


def test_deep_taps_recorded():
    rec = _golden()
    for op in ("x_in", "qkv", "attn_ctx", "attn_out", "ffn_in", "glu_out",
               "layer_out"):
        assert len(rec.values[f"lm/temporal/{op}"]) == 2 * _CFG.num_layers
    for name in ("ring_k", "ring_v", "offset"):
        assert len(rec.values[f"lm/temporal/{name}"]) == 2
    assert rec.order[0] == ("lm/embed", 0)


@pytest.mark.parametrize("fault", [None, 1, 2], ids=["clean", "layer1",
                                                     "layer2"])
def test_first_divergence_names_the_faulty_layer(fault):
    params = _params()
    other = _record(params if fault is None else _corrupt_layer(params,
                                                                 fault))
    hit = first_divergence(_golden(), other, tol=1e-6)
    if fault is None:
        assert hit is None
        return
    name, layer, err = hit
    # the layers before match; the corrupt in_proj shows first at its qkv
    assert (name, layer) == ("lm/temporal/qkv", fault)
    assert err > 1e-3


@pytest.mark.parametrize("with_attn", [False, True], ids=["projections",
                                                          "with_attention"])
def test_replay_ops_reexecute_and_localize(with_attn):
    params = _params()
    trace = _trace(_golden())
    cfg = _CFG.transformer if with_attn else None
    ops = stacked_layer_ops(params, trace, cfg=cfg)
    assert len(ops) == (5 if with_attn else 4) * _CFG.num_layers
    first, lines = replay_ops(ops, tol=TOL_CPU)
    assert first is None, "\n".join(lines)
    if with_attn:
        # layer 1's recorded ring corrupted (k so the stale slot wins the
        # softmax, v so the winner's content is wrong): only layer 1's
        # attn op may fail
        rk = trace["lm/temporal/ring_k"][-1].copy()
        rv = trace["lm/temporal/ring_v"][-1].copy()
        rk[1] = np.abs(rk[1]) + 3.0
        rv[1] = rv[1] + 50.0
        trace["lm/temporal/ring_k"][-1] = rk
        trace["lm/temporal/ring_v"][-1] = rv
        want, also = "layer1/attn", set()
    else:
        # layer 2's recorded GLU output scaled: replay names that op (and
        # the op that takes it as input)
        key = "lm/temporal/glu_out"
        trace[key][-1] = trace[key][-1] * 1.5 + 0.1
        want, also = "layer2/glu", {"layer2/ffn+res"}
    first, lines = replay_ops(stacked_layer_ops(params, trace, cfg=cfg),
                              tol=TOL_CPU)
    assert first is not None and first[0] == want, "\n".join(lines)
    fails = {ln.split()[1].rstrip(":") for ln in lines
             if ln.startswith("FAIL")}
    assert fails == {want} | also, fails


def test_replay_attention_oracle_across_backends():
    """The f32 oracle (p unrounded) re-executes the recorded attention of
    every layer within the cross-backend tolerance."""
    ops = stacked_layer_ops(_params(), _trace(_golden()),
                            cfg=_CFG.transformer, oracle=True)
    first, lines = replay_ops(ops, tol=TOL_GPU)
    assert first is None, "\n".join(lines)
    errs = [float(ln.split()[-1]) for ln in lines if "/attn:" in ln]
    assert len(errs) == _CFG.num_layers and max(errs) > 0.0


def test_oracle_matches_jax_oracle_and_the_plain_kernel(rng):
    b, cap, h, hd = 2, 32, 4, 64
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    rk = rng.normal(size=(b, cap, h, hd)).astype(np.float32)
    rv = rng.normal(size=(b, cap, h, hd)).astype(np.float32)
    ck = rng.normal(size=(b, h, hd)).astype(np.float32)
    cv = rng.normal(size=(b, h, hd)).astype(np.float32)
    offset = np.array([5, 70], np.int32)       # a partial and a wrapped ring
    t = torch.from_numpy
    got = xla_ring_attention(t(q), t(rk), t(rv), t(ck), t(cv), t(offset),
                             cap=cap, context=cap)
    ref = jax_replay.xla_ring_attention(q, rk, rv, ck, cv, offset, cap=cap,
                                        context=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    bf = [t(a).to(torch.bfloat16) for a in (q, rk, rv, ck, cv)]
    plain = decode_attention_plain(*bf, t(offset), cap=cap, context=cap,
                                   chunk=8)
    oracle = xla_ring_attention(*bf, t(offset), cap=cap, context=cap)
    err = float((plain - oracle).abs().max() / oracle.abs().max())
    assert 0.0 < err < TOL_GPU


def test_jax_trace_replays_on_the_port():
    """A trace the JAX package recorded (Pallas in interpret mode) re-runs
    op for op on the port's plain versions within the cross-backend
    tolerance."""
    cfg = jax_lm.LMConfig(**_KW)
    params = jax_tree(_params())
    enable_pallas(True)
    try:
        with pallas_interpret():
            state = jax_lm.init_gen_state(cfg, 1, jax.random.PRNGKey(5))
            with jax_capture.recording() as jrec:
                step = jax.jit(lambda p, s, o: jax_lm.lm_gen_step(
                    cfg, p, s, other_audio=o, temp=0.0, temp_text=0.0))
                out, _ = step(params, state,
                              jnp.full((1, cfg.n_q - cfg.dep_q), 7,
                                       jnp.int32))
                jax.block_until_ready(out["audio"])
            jax.effects_barrier()
    finally:
        enable_pallas(False)
    ops = stacked_layer_ops(_params(), _trace(jrec), cfg=_CFG.transformer)
    first, lines = replay_ops(ops, tol=TOL_GPU)
    assert first is None, "\n".join(lines)


@pytest.mark.parametrize("net", [SEANetEncoder, SEANetDecoder],
                         ids=["encoder", "decoder"])
def test_seanet_conv_replay_localizes(net):
    """Streaming convs (the decoder's transposed ones with their overlap
    carry) re-execute from their recorded input and state; one conv's
    weights corrupted fail at exactly that conv."""
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    m = net(_SEANET)
    params = MimiModel(MimiConfig(seanet=_SEANET, dim=32)).init_params(
        torch.Generator().manual_seed(0), device="cpu")[
        "encoder" if net is SEANetEncoder else "decoder"]
    state = m.init_state(1, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    shape = ((1, _SEANET.hop_length, 1) if net is SEANetEncoder
             else (1, 2, _SEANET.dimension))
    with recording() as rec:
        for _ in range(2):
            x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            _, state = m(params, state, x, tap="net")
    trace = _trace(rec)
    ops = seanet_ops(m, params, trace, "net")
    assert len(ops) == 2 * len(m.modules)
    first, lines = replay_ops(ops, tol=TOL_CPU)
    assert first is None, "\n".join(lines)
    victim = sorted(m.modules)[3]
    bad = dict(params)
    bad[victim] = dict(params[victim],
                       weight=params[victim]["weight"] * 1.5 + 0.01)
    first, lines = replay_ops(seanet_ops(m, bad, trace, "net"), tol=TOL_CPU)
    assert first is not None and first[0] == f"{victim}@0", "\n".join(lines)
    fails = {ln.split()[1].rstrip(":").split("@")[0]
             for ln in lines if ln.startswith("FAIL")}
    assert fails == {victim}, fails


def test_qt_layer_slices_components():
    w = _params()["transformer"]["layers"]["self_attn"]["in_proj"]["weight"]
    one = qt_layer(w, 1)
    assert one.shape == tuple(w.shape[-2:]) and one.fmt == w.fmt
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a, full = getattr(one, f), getattr(w, f)
        assert torch.equal(a, full[1]), f
        assert a.data_ptr() == full[1].data_ptr(), f     # a view
