"""The port's checkpoint loader against the JAX package's, on the CPU.

Checkpoints are synthesized under the reference's tensor names, as
``tests/test_loader.py`` writes them (safetensors, f32), at widths the
quantization policy takes (256).  ``runtime/loader.py``
``load_lm_params`` / ``load_mimi_params`` must give the tree that
``params_from_numpy`` makes of the JAX loader's, bit for bit, every leaf,
for ``fmt`` None, q8_0, q4_0, q4_k and q8_r (both packages quantize with
the native quantizer, q8_r with numpy), on three LMs: one with extra
heads and the depformer, the same with the demuxed text stream, and the
cross-attention TTS class (demuxed, with its conditioners, read by
``models/tts.py`` ``load_conditioners``).  End to end: 4 ``lm_gen_step``
frames at temp 0 from each package's loaded q4_k tree (JAX's Pallas
kernels in interpret mode, the port's plain versions), tokens equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.io.safetensors import save_safetensors
from moshi_tpu.models.lm import LMConfig as JaxLMConfig

from moshi_tpu_torch.models.lm import LMConfig
from tests.test_torch_gguf import assert_trees_equal, port_tree

_BASE = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=16,
             card=256, n_q=4, dep_q=2, text_card=300,
             delays=(0, 0, 1, 1, 2), depformer_dim=256, depformer_heads=4,
             depformer_layers=2, depformer_hidden=576, depformer_low_rank=32,
             extra_heads_num=3, extra_heads_dim=2)
_CASES = {
    "sts": _BASE,
    "demux": dict(_BASE, demux_second_stream=True),
    "tts": dict(_BASE, cross_attention=True, demux_second_stream=True,
                extra_heads_num=0),
}
_COND = "lm.condition_provider.conditioners"


def _lm_checkpoint(c: JaxLMConfig, seed: int):
    """A random LM checkpoint under the reference's names (f32)."""
    rng = np.random.default_rng(seed)
    t = {}

    def w(name, *shape, scale=0.05):
        t[name] = (rng.normal(size=shape) * scale).astype(np.float32)

    def alpha(name, d):
        t[name] = rng.normal(1.0, 0.1, (1, 1, d)).astype(np.float32)

    def text_emb(prefix, d):
        w(prefix + ".weight", c.text_card + 1, d)
        if c.demux_second_stream:
            w(prefix + ".out1.weight", d, d)
            w(prefix + ".out2.weight", d, d)

    d, dd = c.dim, c.depformer_dim
    text_emb("lm.text_emb", d)
    for i in range(c.n_q):
        w(f"lm.emb.{i}.weight", c.card + 1, d)
    for i in range(c.num_layers):
        lp = f"lm.transformer.layers.{i}"
        alpha(f"{lp}.norm1.alpha", d)
        alpha(f"{lp}.norm2.alpha", d)
        w(f"{lp}.self_attn.in_proj_weight", 3 * d, d)
        w(f"{lp}.self_attn.out_proj.weight", d, d)
        w(f"{lp}.gating.linear_in.weight", 2 * c.hidden_dim, d)
        w(f"{lp}.gating.linear_out.weight", d, c.hidden_dim)
        if c.cross_attention:
            w(f"{lp}.norm_cross.weight", d, scale=1.0)
            w(f"{lp}.norm_cross.bias", d)
            w(f"{lp}.cross_attention.in_proj_weight", 3 * d, d)
            w(f"{lp}.cross_attention.out_proj.weight", d, d)
    alpha("lm.out_norm.alpha", d)
    w("lm.text_linear.weight", c.text_card, d)
    for i in range(c.extra_heads_num):
        w(f"lm.extra_heads.{i}.weight", c.extra_heads_dim, d)
    for i in range(c.depformer_num_weights):
        w(f"lm.depformer_in.{i}.weight", dd, d)
    text_emb("lm.depformer_text_emb", dd)
    for i in range(c.dep_q - 1):
        w(f"lm.depformer_emb.{i}.weight", c.card + 1, c.depformer_low_rank)
        w(f"lm.depformer_emb.{i}.low_rank.weight", dd, c.depformer_low_rank)
    for i in range(c.dep_q):
        w(f"lm.linears.{i}.weight", c.card, dd)
    for i in range(c.depformer_layers):
        lp = f"lm.depformer.layers.{i}"
        alpha(f"{lp}.norm1.alpha", dd)
        alpha(f"{lp}.norm2.alpha", dd)
        for j in range(c.depformer_num_weights):
            w(f"{lp}.self_attn.in_projs.{j}.weight", 3 * dd, dd)
            w(f"{lp}.self_attn.out_projs.{j}.weight", dd, dd)
            w(f"{lp}.gating.{j}.linear_in.weight", 2 * c.depformer_hidden, dd)
            w(f"{lp}.gating.{j}.linear_out.weight", dd, c.depformer_hidden)
    if c.cross_attention:
        for lut, rows in (("cfg", 7), ("control", 1)):
            w(f"{_COND}.{lut}.embed.weight", rows, 24, scale=1.0)
            w(f"{_COND}.{lut}.learnt_padding", 1, d, scale=1.0)
            w(f"{_COND}.{lut}.output_proj.weight", d, 24)
        w(f"{_COND}.speaker_wavs.learnt_padding", 1, d, scale=1.0)
        w(f"{_COND}.speaker_wavs.output_proj.weight", d, 48)
    return t


_PATHS = {}


def _checkpoint(tmp_path_factory, case):
    if case not in _PATHS:
        path = tmp_path_factory.mktemp("ckpt") / f"{case}.safetensors"
        save_safetensors(str(path), _lm_checkpoint(
            JaxLMConfig(**_CASES[case]), seed=len(_PATHS)))
        _PATHS[case] = str(path)
    return _PATHS[case]


@pytest.mark.parametrize("fmt", [None, "q8_0", "q4_0", "q4_k", "q8_r"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_lm_tree_matches_jax(tmp_path_factory, case, fmt):
    from moshi_tpu.runtime.loader import load_lm_params as jax_load
    from moshi_tpu_torch.runtime.loader import load_lm_params
    path = _checkpoint(tmp_path_factory, case)
    ref = port_tree(jax_load(path, JaxLMConfig(**_CASES[case]), fmt=fmt))
    got = load_lm_params(path, LMConfig(**_CASES[case]), fmt=fmt,
                         device="cpu")
    assert_trees_equal(got, ref)
    if fmt is not None:
        # the policy quantized the big weights (the depformer linear_out,
        # hidden 576, falls back from q4_k to q4_0)
        w = got["transformer"]["layers"]["self_attn"]["in_proj"]["weight"]
        assert w.fmt == fmt
        lo = got["depformer"]["layers"]["gating"]["linear_out"]["weight"]
        assert lo.fmt == ("q4_0" if fmt == "q4_k" else fmt)
        if "out1" in got["text_emb"]:
            assert got["text_emb"]["out1"]["weight"].fmt == fmt


def test_lm_tree_f32_dtype_matches_jax(tmp_path_factory):
    from moshi_tpu.runtime.loader import load_lm_params as jax_load
    from moshi_tpu_torch.runtime.loader import load_lm_params
    path = _checkpoint(tmp_path_factory, "demux")
    ref = port_tree(jax_load(path, JaxLMConfig(**_CASES["demux"]),
                             dtype=jnp.float32))
    got = load_lm_params(path, LMConfig(**_CASES["demux"]),
                         dtype=torch.float32, device="cpu")
    assert_trees_equal(got, ref)


def test_load_conditioners_matches_jax(tmp_path_factory):
    from moshi_tpu.models.tts import load_conditioners as jax_cond
    from moshi_tpu.runtime.loader import _Source as JaxSource
    from moshi_tpu_torch.models.tts import load_conditioners
    from moshi_tpu_torch.runtime.loader import _Source
    path = _checkpoint(tmp_path_factory, "tts")
    src = JaxSource(path)
    try:
        ref = port_tree(jax_cond(src))
    finally:
        src.close()
    assert_trees_equal(load_conditioners(path, device="cpu"), ref)
    psrc = _Source(torch.device("cpu"), path)
    try:
        assert_trees_equal(load_conditioners(psrc, device="cpu"), ref)
    finally:
        psrc.close()


def _port_mimi_cfg():
    from moshi_tpu_torch.models.mimi import MimiConfig
    from moshi_tpu_torch.nn.seanet import SEANetConfig
    from tests.test_loader import _mimi_cfg
    s = _mimi_cfg.seanet
    return MimiConfig(
        n_q=_mimi_cfg.n_q, total_codebooks=_mimi_cfg.total_codebooks,
        dim=_mimi_cfg.dim,
        seanet=SEANetConfig(dimension=s.dimension, n_filters=s.n_filters,
                            ratios=tuple(s.ratios)),
        codebook_dim=_mimi_cfg.codebook_dim,
        codebook_size=_mimi_cfg.codebook_size,
        transformer_layers=_mimi_cfg.transformer_layers,
        transformer_heads=_mimi_cfg.transformer_heads,
        transformer_context=_mimi_cfg.transformer_context,
        transformer_hidden=_mimi_cfg.transformer_hidden)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mimi_tree_matches_jax(tmp_path, dtype):
    from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
    from moshi_tpu.runtime.loader import load_mimi_params as jax_load
    from moshi_tpu_torch.models.mimi import MimiModel
    from moshi_tpu_torch.runtime.loader import load_mimi_params
    from tests.test_loader import _mimi_cfg, _mimi_checkpoint
    path = str(tmp_path / "mimi.safetensors")
    save_safetensors(path, _mimi_checkpoint(np.random.default_rng(8)))
    ref = port_tree(jax_load(path, JaxMimiModel(_mimi_cfg),
                             dtype=getattr(jnp, dtype)))
    model = MimiModel(_port_mimi_cfg())
    got = load_mimi_params(path, model, dtype=getattr(torch, dtype),
                           device="cpu")
    assert_trees_equal(got, ref)
    # the loaded tree runs an encode / decode step
    hop2 = model.cfg.frame_samples
    audio = torch.randn((1, hop2), generator=torch.Generator().manual_seed(
        0)) * 0.1
    codes, _ = model.encode_step(got, model.init_encode_state(
        1, getattr(torch, dtype), "cpu"), audio)
    out, _ = model.decode_step(got, model.init_decode_state(
        1, getattr(torch, dtype), "cpu"), codes)
    assert out.shape == (1, hop2) and torch.isfinite(out.float()).all()


def test_loaded_trees_generate_the_same_tokens(tmp_path_factory):
    """4 frames at temp 0 from each package's q4_k tree loaded from the
    demuxed checkpoint: every text and audio token equal."""
    from moshi_tpu.runtime.loader import load_lm_params as jax_load
    from moshi_tpu_torch.runtime.loader import load_lm_params
    from tests.test_torch_lm import _run_jax, _run_port
    case = "demux"
    path = _checkpoint(tmp_path_factory, case)
    jcfg, pcfg = JaxLMConfig(**_CASES[case]), LMConfig(**_CASES[case])
    jparams = jax_load(path, jcfg, fmt="q4_k")
    pparams = load_lm_params(path, pcfg, fmt="q4_k", device="cpu")
    rng = np.random.default_rng(9)
    other = rng.integers(0, jcfg.card, (4, 1, jcfg.n_q - jcfg.dep_q),
                         dtype=np.int32)
    ref, _ = _run_jax(jcfg, jparams, other, "1")
    got, _ = _run_port(pcfg, pparams, other, "1")
    for r, g in zip(ref, got):
        for key in ("sampled_text", "text", "audio", "valid"):
            np.testing.assert_array_equal(g["out"][key], r["out"][key],
                                          err_msg=key)
        np.testing.assert_array_equal(g["gen_audio"],
                                      np.argmax(r["dep_logits"], -1))
    assert any(bool(r["out"]["valid"][0]) for r in ref)
