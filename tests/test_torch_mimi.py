"""The port's Mimi (``moshi_tpu_torch.models.mimi``) and its parts against
the JAX package's, on the CPU, on the same weights and audio.

In f32 each part, and the streaming encode/decode over 4 frames, must
agree to f32 rounding: the convolutions, matmuls and softmax of XLA and
of PyTorch sum in other orders (~1e-6 of the largest value), so outputs
are held to 1e-5 of their largest magnitude and the codes must be
identical.  In bf16 every layer rounds its output, and a last-bit
difference there moves a nearest-centroid score; codes are then held
equal where the top-1/top-2 score gap exceeds the stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
from moshi_tpu.nn import conv as jconv
from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
from moshi_tpu.nn.seanet import SEANetDecoder as JaxSEANetDecoder
from moshi_tpu.nn.seanet import SEANetEncoder as JaxSEANetEncoder
from moshi_tpu.nn.transformer import init_transformer_params
from moshi_tpu.nn.transformer import init_transformer_state as jax_tr_state
from moshi_tpu.nn.transformer import transformer_forward as jax_tr_forward

from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn import conv as pconv
from moshi_tpu_torch.nn.seanet import SEANetConfig, SEANetDecoder, \
    SEANetEncoder
from moshi_tpu_torch.nn.transformer import init_transformer_state, \
    transformer_forward
from moshi_tpu_torch.nn.vq import SplitRVQ, codebook_encode
from moshi_tpu_torch.runtime.convert import params_from_numpy

_SMALL = dict(n_q=4, total_codebooks=8, dim=32, codebook_dim=16,
              codebook_size=64, transformer_layers=2, transformer_heads=4,
              transformer_context=16, transformer_hidden=64)
_SEANET = dict(dimension=32, n_filters=4, ratios=(4, 3, 2, 2))
_FRAMES = 4
_TOL = 1e-5
# bf16: both sides compute each op in f32 and round its output to bf16 at
# the same places, so they differ only where the two f32 sums straddle a
# bf16 rounding boundary: there one element moves by one bf16 step (2^-8
# of it).  Such a step moves a nearest-centroid score by well under 1e-3
# of the row's largest |score|, so codes must agree where the top-1/top-2
# gap exceeds that.  Through the decoder such a step reaches the audio at
# a fraction of a bf16 step; audio is held to 1e-3 of its largest
# magnitude (readings: codes all equal; audio within 5e-7, and 1.5e-4 in
# the one frame where a straddle happened).
_BF16_GAP = 1e-3
_BF16_AUDIO = 1e-3


def _jax_cfg():
    return JaxMimiConfig(seanet=JaxSEANetConfig(**_SEANET), **_SMALL)


def _port_cfg():
    return MimiConfig(seanet=SEANetConfig(**_SEANET), **_SMALL)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _draw(init_fn, seed):
    """A parameter tree of init_fn's shapes drawn with numpy, without
    JAX's eager random draws (which compile one program per shape):
    N(0, 1) codebooks, fan-in scaled normals for the other matrices and
    conv kernels, and N(0, 0.1) around 1 (norm weights) or 0 (biases,
    layer scales) for the vectors."""
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
            x = x * sd.shape[-1] ** -0.5          # linear [.., O, I]
        else:
            x = x * float(np.prod(sd.shape[1:])) ** -0.5   # conv [O, I/g, K]
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init_fn, jax.random.PRNGKey(0)))


def _to_torch(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the convolutions, over 3 streaming calls each
# ---------------------------------------------------------------------------

_CONVS = [
    # (kind, kwargs, T per call)
    ("conv", dict(in_ch=3, out_ch=5, kernel=7), 6),
    ("conv", dict(in_ch=4, out_ch=8, kernel=8, stride=4), 8),
    ("conv", dict(in_ch=4, out_ch=6, kernel=3, groups=2), 5),
    ("conv", dict(in_ch=6, out_ch=6, kernel=4, stride=2, bias=False), 4),
    ("stateless", dict(in_ch=4, out_ch=7, kernel=1), 5),
    ("convtr", dict(in_ch=8, out_ch=4, kernel=8, stride=4), 3),
    ("convtr", dict(in_ch=6, out_ch=4, kernel=6, stride=3, groups=2), 2),
    ("convtr", dict(in_ch=6, out_ch=6, kernel=4, stride=2, groups=6,
                    bias=False), 3),                   # Mimi's upsample
]


@pytest.mark.parametrize("kind,kw,t", _CONVS)
def test_conv_matches_jax(kind, kw, t):
    jcls, pcls = {"conv": (jconv.StreamingConv1d, pconv.StreamingConv1d),
                  "stateless": (jconv.StatelessConv1d,
                                pconv.StatelessConv1d),
                  "convtr": (jconv.StreamingConvTranspose1d,
                             pconv.StreamingConvTranspose1d)}[kind]
    jm, pm = jcls(**kw), pcls(**kw)
    params = _draw(jm.init_params, 1)
    pparams = _to_torch(params)
    rng = np.random.default_rng(3)
    js, ps = jm.init_state(2), pm.init_state(2, torch.float32, "cpu")
    for _ in range(3):
        x = rng.normal(size=(2, t, kw["in_ch"])).astype(np.float32)
        jy, js = jm(params, js, jnp.asarray(x))
        py, ps = pm(pparams, ps, _t(x))
        assert py.shape == jy.shape
        assert _rel(py.numpy(), jy) < _TOL
    for key in js:
        np.testing.assert_allclose(ps[key].numpy(), np.asarray(js[key]),
                                   rtol=0, atol=_TOL * max(
                                       1.0, float(np.abs(js[key]).max())))


def test_convtr_weight_layout_matches_jax_converter():
    """The port's per-group transpose is the JAX package's
    oiw_to_torch_convtr (no kernel flip)."""
    w = np.random.default_rng(4).normal(size=(6, 2, 5)).astype(np.float32)
    got = pconv.oiw_to_torch_convtr(torch.from_numpy(w), groups=3).numpy()
    np.testing.assert_array_equal(got, jconv.oiw_to_torch_convtr(w, 3))


# ---------------------------------------------------------------------------
# SEANet, the quantizer and the T = 2 transformer stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_seanet_matches_jax(which):
    jcfg, pcfg = JaxSEANetConfig(**_SEANET), SEANetConfig(**_SEANET)
    if which == "encoder":
        jm, pm = JaxSEANetEncoder(jcfg), SEANetEncoder(pcfg)
        shape = (1, jcfg.hop_length * 2, 1)
    else:
        jm, pm = JaxSEANetDecoder(jcfg), SEANetDecoder(pcfg)
        shape = (1, 2, jcfg.dimension)
    assert list(pm.modules) == list(jm.modules) and pm.order == jm.order
    params = _draw(jm.init_params, 5)
    pparams = _to_torch(params)
    js, ps = jm.init_state(1), pm.init_state(1, torch.float32, "cpu")
    rng = np.random.default_rng(6)
    step = jax.jit(lambda p, s, x: jm(p, s, x))
    for _ in range(3):
        x = (rng.normal(size=shape) * 0.1).astype(np.float32)
        jy, js = step(params, js, jnp.asarray(x))
        py, ps = pm(pparams, ps, _t(x))
        assert py.shape == jy.shape
        assert _rel(py.numpy(), jy) < _TOL


def test_split_rvq_matches_jax():
    jmodel = JaxMimiModel(_jax_cfg())
    params = _draw(jmodel.quantizer.init_params, 7)
    pq = SplitRVQ(_port_cfg().quantizer)
    pparams = _to_torch(params)
    x = np.random.default_rng(8).normal(size=(2, 3, 32)).astype(np.float32)
    jcodes = np.asarray(jmodel.quantizer.encode(params, jnp.asarray(x)))
    pcodes = pq.encode(pparams, _t(x)).numpy()
    np.testing.assert_array_equal(pcodes, jcodes)
    # the runtime n_q: the first codebooks of the chain only
    np.testing.assert_array_equal(pq.encode(pparams, _t(x), 3).numpy(),
                                  jcodes[..., :3])
    for n in (8, 4):
        jy = jmodel.quantizer.decode(params, jnp.asarray(jcodes[..., :n]))
        py = pq.decode(pparams, torch.from_numpy(jcodes[..., :n].copy()))
        assert _rel(py.numpy(), jy) < _TOL


def test_codebook_encode_first_index_wins_a_tie():
    e = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    assert codebook_encode(e, torch.tensor([[2.0, 0.0]])).tolist() == [0]


def test_transformer_stack_t2_matches_jax():
    """Mimi's T = 2 stack over 10 steps: the 16-slot ring wraps, and the
    generic path (layer norms, layer scales, gelu FFN) runs."""
    jtc, ptc = _jax_cfg().transformer, _port_cfg().transformer
    params = _draw(lambda k: init_transformer_params(k, jtc), 9)
    pparams = _to_torch(params)
    js = jax_tr_state(jtc, 1)
    ps = init_transformer_state(ptc, 1, "cpu")
    rng = np.random.default_rng(10)
    step = jax.jit(lambda p, s, x, o: jax_tr_forward(jtc, p, s, x, o))
    for i in range(10):
        x = rng.normal(size=(1, 2, jtc.dim)).astype(np.float32)
        off = np.array([2 * i], np.int32)
        jy, js = step(params, js, jnp.asarray(x), jnp.asarray(off))
        py, ps = transformer_forward(ptc, pparams, ps, _t(x),
                                     torch.from_numpy(off))
        assert _rel(py.numpy(), jy) < _TOL, i
    np.testing.assert_array_equal(
        ps["k"].float().numpy(), np.asarray(js["k"].astype(jnp.float32)))


def test_generic_stack_one_position_matches_jax():
    """One position per step through the generic stack runs K11 (the ring
    write) and K9 (the post-insert decode attention), as the JAX package
    does with Pallas on.  Mimi's layer-norm stack over 20 steps (the
    16-slot ring wraps) against JAX's in interpret mode."""
    from moshi_tpu.quant.formats import enable_pallas
    from moshi_tpu.utils.pallas_mode import pallas_interpret
    jtc, ptc = _jax_cfg().transformer, _port_cfg().transformer
    params = _draw(lambda k: init_transformer_params(k, jtc), 9)
    pparams = _to_torch(params)
    js = jax_tr_state(jtc, 1)
    ps = init_transformer_state(ptc, 1, "cpu")
    rng = np.random.default_rng(11)
    enable_pallas(True)
    try:
        with pallas_interpret():
            step = jax.jit(lambda p, s, x, o: jax_tr_forward(jtc, p, s, x, o))
            for i in range(20):
                x = rng.normal(size=(1, 1, jtc.dim)).astype(np.float32)
                off = np.array([i], np.int32)
                jy, js = step(params, js, jnp.asarray(x), jnp.asarray(off))
                py, ps = transformer_forward(ptc, pparams, ps, _t(x),
                                             torch.from_numpy(off))
                assert _rel(py.numpy(), jy) < _TOL, i
    finally:
        enable_pallas(False)
    np.testing.assert_array_equal(
        ps["k"].float().numpy(), np.asarray(js["k"].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the whole codec, streaming
# ---------------------------------------------------------------------------

def _jax_stream(dtype, audio, jparams):
    """JAX's streaming encode of each frame, then decode of its codes;
    also the quantizer's input per frame (through a debug callback)."""
    m = JaxMimiModel(_jax_cfg())
    q_in = []
    encode = m.quantizer.encode

    def recorded(params, x):
        jax.debug.callback(lambda v: q_in.append(np.asarray(v, np.float32)),
                           x.astype(jnp.float32), ordered=True)
        return encode(params, x)

    m.quantizer.encode = recorded
    enc = jax.jit(m.encode_step)
    dec = jax.jit(m.decode_step)
    es, ds = m.init_encode_state(1, dtype), m.init_decode_state(1, dtype)
    codes, wavs = [], []
    for a in audio:
        c, es = enc(jparams, es, jnp.asarray(a).astype(dtype))
        w, ds = dec(jparams, ds, c)
        codes.append(np.asarray(c))
        wavs.append(np.asarray(w.astype(jnp.float32)))
    jax.effects_barrier()
    return codes, wavs, q_in


def _port_stream(dtype, audio, pparams, dec_codes):
    """The port's streaming encode of each frame, and its decode of
    ``dec_codes`` (JAX's codes, so that both decoders take the same
    input)."""
    m = MimiModel(_port_cfg())
    es = m.init_encode_state(1, dtype, "cpu")
    ds = m.init_decode_state(1, dtype, "cpu")
    codes, wavs = [], []
    for a, dc in zip(audio, dec_codes):
        c, es = m.encode_step(pparams, es, _t(a, dtype))
        w, ds = m.decode_step(pparams, ds, torch.from_numpy(dc.copy()))
        codes.append(c.numpy())
        wavs.append(w.float().numpy())
    return codes, wavs


def _mimi_inputs(dtype):
    jm = JaxMimiModel(_jax_cfg())
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                     _draw(jm.init_params, 0))
    rng = np.random.default_rng(11)
    fs = _jax_cfg().seanet.hop_length * 2
    audio = [(rng.normal(size=(1, fs)) * 0.1).astype(np.float32)
             for _ in range(_FRAMES)]
    return jparams, _to_torch(jparams), audio


def test_mimi_streaming_f32_matches_jax():
    jparams, pparams, audio = _mimi_inputs(jnp.float32)
    jcodes, jwavs, _ = _jax_stream(jnp.float32, audio, jparams)
    pcodes, pwavs = _port_stream(torch.float32, audio, pparams, jcodes)
    for f in range(_FRAMES):
        assert pcodes[f].shape == (1, 1, 4)
        np.testing.assert_array_equal(pcodes[f], jcodes[f])
        assert _rel(pwavs[f], jwavs[f]) < _TOL, f


def _chain_gaps(pparams, q_in, codes, cfg):
    """Per codebook of the chain, the top-1/top-2 score gap relative to
    the row's largest |score|, along JAX's own codes from JAX's quantizer
    input."""
    from moshi_tpu_torch.nn.layers import linear
    from moshi_tpu_torch.nn.vq import codebook_decode
    x = torch.from_numpy(q_in.copy()).to(torch.bfloat16)
    gaps = []
    for name, lo, hi in (("rvq_first", 0, 1), ("rvq_rest", 1, cfg.n_q)):
        br = pparams["quantizer"][name]
        r = linear(br["input_proj"], x)
        for i in range(hi - lo):
            e = br["embeddings"][i].float()
            s = 2.0 * torch.matmul(r.float(), e.T) - (e * e).sum(-1)
            top2 = torch.topk(s, 2, dim=-1).values
            gaps.append(float(((top2[..., 0] - top2[..., 1])
                               / s.abs().amax(-1)).min()))
            code = torch.from_numpy(codes[..., lo + i]).long()
            r = r - codebook_decode(br["embeddings"][i], code).to(r.dtype)
    return gaps


def test_mimi_streaming_bf16_codes_match_where_decided():
    jparams, pparams, audio = _mimi_inputs(jnp.bfloat16)
    jcodes, jwavs, q_in = _jax_stream(jnp.bfloat16, audio, jparams)
    pcodes, pwavs = _port_stream(torch.bfloat16, audio, pparams, jcodes)
    cfg = _port_cfg()
    decided = 0
    for f in range(_FRAMES):
        gaps = _chain_gaps(pparams, q_in[f], jcodes[f], cfg)
        for i, gap in enumerate(gaps):
            if gap <= _BF16_GAP:
                break          # later books follow another residual
            assert pcodes[f][..., i] == jcodes[f][..., i], (f, i, gap)
            decided += 1
        assert np.all(np.isfinite(pwavs[f]))
        assert _rel(pwavs[f], jwavs[f]) < _BF16_AUDIO, f
    assert decided >= 2 * _FRAMES
