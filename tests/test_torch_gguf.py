"""The port's GGUF files, repacks and quantized cache against the JAX
package's, on the CPU.

* ``io/gguf.py``: the CRC tensor names (against the JAX package's and the
  reference's bit-by-bit CRC as ``tests/test_gguf.py`` writes it); every
  repack, planar -> ggml bytes and ggml bytes -> planar fields, bit for
  bit, in q8_0, q4_0 and q4_k, on blocks quantized here and on foreign
  blocks whose f16 scales bf16 does not hold (snapped as JAX snaps them,
  es/em from the full f16 value); the container with every metadata type.
* ``runtime/loader.py`` ``save_lm_gguf`` / ``save_mimi_gguf``: the files
  written from the same tree are byte-identical between the packages, a
  file written by JAX loads in the port to JAX's tree, and the port's
  file loads back to the tree it came from.
* ``quant/policy.py`` ``quantize_tree`` against JAX's.
* ``runtime/cache.py``: the cache files byte-identical between the
  packages, and each package reads the other's to the same tree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.io import gguf as jg
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.quant.formats import quantize as jax_quantize

from moshi_tpu_torch.io import gguf as pg
from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.quant.formats import QuantTensor
from moshi_tpu_torch.runtime.convert import params_from_numpy
from tests.test_gguf import _ref_crc_name
from tests.test_torch_lm import export_numpy
from tests.test_torch_quantize import _bits, assert_same_qt


_QT_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


def port_tree(jtree):
    """The port's tensor tree (on the CPU) of a JAX parameter tree."""
    return params_from_numpy(export_numpy(jtree), device="cpu")


def export_port(tree):
    """A port tree as numpy leaves (bf16 as ml_dtypes' bfloat16),
    QuantTensors as field dicts: the form ``params_from_numpy`` takes."""
    import ml_dtypes

    def arr(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    if isinstance(tree, dict):
        return {k: export_port(v) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return {"fmt": tree.fmt, "shape": tuple(tree.shape),
                **{f: arr(getattr(tree, f)) for f in _QT_FIELDS}}
    return arr(tree)


def jax_tree(ptree):
    """The JAX package's tree of a port tree (bits kept): the port draws
    synthetic trees in a fraction of the JAX package's time."""
    from moshi_tpu.quant.formats import QuantTensor as JaxQuantTensor

    def build(node):
        if isinstance(node, dict) and "fmt" in node:
            return JaxQuantTensor(node["fmt"], node["shape"], *(
                None if node[f] is None else jnp.asarray(node[f])
                for f in _QT_FIELDS))
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return jnp.asarray(node)

    return build(export_port(ptree))


def assert_trees_equal(got, ref, path=""):
    """Two port trees leaf for leaf: the same keys, QuantTensor formats and
    shapes, and every tensor the same dtype, shape and bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (
            path, sorted(got) if isinstance(got, dict) else got, sorted(ref))
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    if isinstance(ref, QuantTensor):
        assert isinstance(got, QuantTensor), path
        assert (got.fmt, tuple(got.shape)) == (ref.fmt, tuple(ref.shape)), path
        for f in _QT_FIELDS:
            a, b = getattr(got, f), getattr(ref, f)
            assert (a is None) == (b is None), (path, f)
            if b is not None:
                assert_trees_equal(a, b, f"{path}#{f}")
        return
    assert isinstance(got, torch.Tensor), path
    assert got.dtype == ref.dtype and got.shape == ref.shape, (
        path, got.dtype, ref.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(_bits(got.cpu()), _bits(ref.cpu()),
                                  err_msg=path)


# ---------------------------------------------------------------------------
# names and repacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "lm.text_linear.weight",
    "mimi.encoder_transformer.transformer.layers.0.self_attn"
    ".in_projs.0.weight",
    "mimi.decoder_transformer.transformer.layers.7.layer_scale_1.scale",
    "x" * 63, "x" * 64, "lm." + "a" * 100])
def test_crc_names_match(name):
    got = pg.gguf_tensor_name(name)
    assert got == jg.gguf_tensor_name(name) == _ref_crc_name(name)
    assert (got == name) == (len(name) < 64)


def _jax_qt_port(jqt):
    return params_from_numpy(export_numpy(jqt), device="cpu")


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k"])
def test_repacks_bit_exact(fmt):
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((64, 1024)) * 0.05).astype(np.float32)
    jqt = jax_quantize(w, fmt, native=False)
    jt, jraw = jg.quant_to_ggml(jqt)
    pt, praw = pg.quant_to_ggml(_jax_qt_port(jqt))
    assert jt == pt and praw.dtype == np.uint8
    assert praw.tobytes() == jraw
    assert_same_qt(jg.ggml_to_quant(jt, jraw, (64, 1024)),
                   pg.ggml_to_quant(pt, jraw, (64, 1024), device="cpu"))


def _foreign_blocks(rng, fmt, o, i):
    """Random ggml blocks with f16 scales that bf16 does not hold."""
    def f16_bytes(shape):
        return rng.uniform(0.001, 0.01, shape).astype(np.float16)[
            ..., None].view(np.uint8)
    if fmt == "q8_0":
        b = np.empty((o, i // 32, 34), np.uint8)
        b[:, :, :2] = f16_bytes((o, i // 32))
        b[:, :, 2:] = rng.integers(0, 256, (o, i // 32, 32), np.uint8)
    elif fmt == "q4_0":
        b = np.empty((o, i // 32, 18), np.uint8)
        b[:, :, :2] = f16_bytes((o, i // 32))
        b[:, :, 2:] = rng.integers(0, 256, (o, i // 32, 16), np.uint8)
    else:
        b = np.empty((o, i // 256, 144), np.uint8)
        b[:, :, 0:2] = f16_bytes((o, i // 256))
        b[:, :, 2:4] = f16_bytes((o, i // 256))
        b[:, :, 4:] = rng.integers(0, 256, (o, i // 256, 140), np.uint8)
    return b.tobytes()


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k"])
def test_foreign_f16_scales(fmt):
    """A file written elsewhere: the planar fields equal JAX's bit for bit
    (each f16 scale snapped to bf16 by nearest even, q4_k's es/em from the
    full f16 value), and, as ``tests/test_gguf.py`` holds JAX's, within
    2^-8 of the blocks' own values."""
    rng = np.random.default_rng(11)
    o, i = 8, 512
    raw = _foreign_blocks(rng, fmt, o, i)
    t = jg.GGML_TYPE_OF_FMT[fmt]
    ref = jg.ggml_to_quant(t, raw, (o, i))
    got = pg.ggml_to_quant(t, raw, (o, i), device="cpu")
    assert_same_qt(ref, got)
    # the snap moved some scales: f16 held values bf16 does not
    d16 = np.frombuffer(raw, np.uint8).reshape(o, -1, len(raw) // o // (
        i // (256 if fmt == "q4_k" else 32)))[:, :, :2].copy().view(
            np.float16)[..., 0].astype(np.float32)
    assert np.any(got.d.float().numpy() != d16)
    assert np.allclose(got.d.float().numpy(), d16, rtol=2 ** -8)
    if fmt == "q4_k":
        es = got.es.float().numpy().reshape(o, -1, 8)
        np.testing.assert_allclose(es, d16[..., None] * got.sc.numpy(),
                                   rtol=2 ** -8)


def test_container_roundtrip_across_packages(tmp_path):
    """Every metadata type and plain tensor dtype: the files written by
    both packages are byte-identical and each reads the other's."""
    rng = np.random.default_rng(12)
    f32 = rng.normal(size=(5, 48)).astype(np.float32)
    f16 = rng.normal(size=(3, 32)).astype(np.float16)
    i32 = rng.integers(0, 100, (4,), dtype=np.int32)
    bf = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32)).to(
        torch.bfloat16)
    qt_w = (rng.standard_normal((32, 256)) * 0.05).astype(np.float32)
    jqt = jax_quantize(qt_w, "q4_k", native=False)
    paths = {}
    for pkg, mod in (("jax", jg), ("port", pg)):
        w = mod.GGUFWriter()
        w.add_kv("general.architecture", "moshi")
        w.add_kv("moshi.count", 7)
        w.add_kv("moshi.neg", -3)
        w.add_kv("moshi.f", 2.5)
        w.add_kv("moshi.flag", True)
        w.add_kv("moshi.list", ["a", "b"])
        w.add_kv("moshi.ints", [1, 2, 3])
        w.add_tensor("a.f32", f32)
        w.add_tensor("a.f16", f16)
        w.add_tensor("a.i32", i32)
        w.add_tensor("a." + "long" * 20, f32[:2])
        if pkg == "jax":
            w.add_tensor("a.bf16", jnp.asarray(bf.float().numpy(),
                                               jnp.bfloat16))
            w.add_tensor("a.q4k", jqt)
        else:
            w.add_tensor("a.bf16", bf)
            w.add_tensor("a.q4k", _jax_qt_port(jqt))
        paths[pkg] = str(tmp_path / f"{pkg}.gguf")
        w.write(paths[pkg])
    blob = open(paths["jax"], "rb").read()
    assert blob == open(paths["port"], "rb").read()
    r = pg.GGUFReader(paths["jax"])
    assert r.metadata["moshi.neg"] == -3 and r.metadata["moshi.flag"] is True
    assert r.metadata["moshi.list"] == ["a", "b"]
    np.testing.assert_array_equal(r.get("a.f32"), f32)
    np.testing.assert_array_equal(r.get("a.f16"), f16.astype(np.float32))
    np.testing.assert_array_equal(r.get("a.i32"), i32)
    np.testing.assert_array_equal(r.get(pg.gguf_tensor_name(
        "a." + "long" * 20)), f32[:2])
    np.testing.assert_array_equal(r.get("a.bf16"), bf.float().numpy())
    assert_same_qt(jqt, r.get_quant("a.q4k", "cpu"))
    r.close()


# ---------------------------------------------------------------------------
# LM and Mimi snapshots
# ---------------------------------------------------------------------------

_LM = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=256, context=16,
           card=32, n_q=4, dep_q=2, text_card=48, delays=(0, 0, 1, 1, 2),
           depformer_dim=256, depformer_heads=2, depformer_layers=2,
           depformer_hidden=256, depformer_low_rank=32, extra_heads_num=2,
           extra_heads_dim=2)
# the TTS kind: cross-attention and the demuxed text stream
_LM_TTS = dict(_LM, cross_attention=True, demux_second_stream=True,
               extra_heads_num=0)


@pytest.mark.parametrize("kind", ["sts", "tts"])
@pytest.mark.parametrize("fmt", [None, "q8_0", "q4_k"])
def test_lm_gguf_files_identical_and_cross_read(tmp_path, fmt, kind):
    from moshi_tpu.runtime.loader import load_lm_params as jax_load
    from moshi_tpu.runtime.loader import save_lm_gguf as jax_save
    from moshi_tpu_torch.runtime.loader import load_lm_params, save_lm_gguf
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    kw = _LM if kind == "sts" else _LM_TTS
    jcfg, pcfg = JaxLMConfig(**kw), LMConfig(**kw)
    ptree = synth_lm_params(pcfg, fmt, device="cpu", seed=3)
    jtree = jax_tree(ptree)
    jpath, ppath = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    jax_save(jpath, jtree, jcfg, metadata={"moshi.seed": 3})
    save_lm_gguf(ppath, ptree, pcfg, metadata={"moshi.seed": 3})
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    # a file JAX wrote loads in the port to JAX's loaded tree
    ref = port_tree(jax_load(jpath, jcfg, fmt=fmt))
    got = load_lm_params(jpath, pcfg, fmt=fmt, device="cpu")
    assert_trees_equal(got, ref)


_NORMS = ("norm1", "norm2", "norm_cross", "out_norm")


def as_loaded(tree, key=""):
    """A synthesized tree as the loader returns it: norms in f32 (their
    bf16 values widened, exact), everything else as it is."""
    if isinstance(tree, dict):
        return {k: (as_loaded(v, k) if k not in _NORMS
                    else {n: t.float() for n, t in v.items()})
                for k, v in tree.items()}
    return tree


def test_lm_gguf_roundtrip_to_the_same_tree(tmp_path):
    """The port's own q4_k tree through its file: every quantized leaf
    and every bf16 weight back bit for bit; norms come back f32 (the
    loader's dtype for them, as the JAX package's), equal in value."""
    from moshi_tpu_torch.runtime.loader import load_lm_params, save_lm_gguf
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    cfg = LMConfig(**_LM_TTS)
    tree = synth_lm_params(cfg, "q4_k", device="cpu", seed=4)
    path = str(tmp_path / "lm.gguf")
    save_lm_gguf(path, tree, cfg)
    back = load_lm_params(path, cfg, device="cpu")

    assert_trees_equal(back, as_loaded(tree))


def _mimi_cfgs():
    from moshi_tpu.models.mimi import MimiConfig as JaxMimiConfig
    from moshi_tpu.nn.seanet import SEANetConfig as JaxSEANetConfig
    from moshi_tpu_torch.models.mimi import MimiConfig
    from moshi_tpu_torch.nn.seanet import SEANetConfig
    kw = dict(n_q=4, total_codebooks=4, dim=32, codebook_dim=16,
              codebook_size=32, transformer_layers=2, transformer_heads=4,
              transformer_context=16, transformer_hidden=64)
    sk = dict(dimension=32, n_filters=4, ratios=(4, 3, 2, 2))
    return (JaxMimiConfig(seanet=JaxSEANetConfig(**sk), **kw),
            MimiConfig(seanet=SEANetConfig(**sk), **kw))


def test_mimi_gguf_files_identical_and_cross_read(tmp_path):
    from moshi_tpu.models.mimi import MimiModel as JaxMimiModel
    from moshi_tpu.runtime.loader import load_mimi_params as jax_load
    from moshi_tpu.runtime.loader import save_mimi_gguf as jax_save
    from moshi_tpu_torch.models.mimi import MimiModel
    from moshi_tpu_torch.runtime.loader import load_mimi_params, \
        save_mimi_gguf
    jcfg, pcfg = _mimi_cfgs()
    from moshi_tpu_torch.runtime.synth import synth_mimi_params
    jm, pm = JaxMimiModel(jcfg), MimiModel(pcfg)
    ptree = synth_mimi_params(pcfg, device="cpu", seed=5)
    jtree = jax_tree(ptree)
    jpath, ppath = str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")
    jax_save(jpath, jtree, jm)
    save_mimi_gguf(ppath, ptree, pm)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    ref = port_tree(jax_load(jpath, jm))
    got = load_mimi_params(jpath, pm, device="cpu")
    assert_trees_equal(got, ref)


def test_quantize_tree_matches_jax():
    from moshi_tpu.quant.policy import quantize_tree as jax_qtree
    from moshi_tpu_torch.quant.policy import quantize_tree
    rng = np.random.default_rng(13)
    tree = {"big": {"weight": rng.normal(size=(512, 512)).astype(np.float32),
                    "bias": rng.normal(size=(512,)).astype(np.float32)},
            "odd": {"weight": rng.normal(size=(256, 320)).astype(np.float32)},
            "norm": {"alpha": rng.normal(size=(512,)).astype(np.float32)},
            "small": {"weight": rng.normal(size=(8, 512)).astype(np.float32)},
            "list": [rng.normal(size=(256, 256)).astype(np.float32)]}
    for fmt in ("q4_k", "q8_0", "q8_r"):
        ref = jax_qtree(tree, fmt)
        got = quantize_tree(tree, fmt, device="cpu")
        assert_same_qt(ref["big"]["weight"], got["big"]["weight"])
        assert_same_qt(ref["list"][0], got["list"][0])
        odd = ref["odd"]["weight"]
        assert_same_qt(odd, got["odd"]["weight"])
        assert got["odd"]["weight"].fmt == ("q4_0" if fmt == "q4_k" else fmt)
        for key in ("norm", "small"):
            leaf = got[key]["alpha" if key == "norm" else "weight"]
            assert not isinstance(leaf, QuantTensor)
        assert got["big"]["bias"] is tree["big"]["bias"]


# ---------------------------------------------------------------------------
# the quantized cache
# ---------------------------------------------------------------------------

def _cache_trees():
    from moshi_tpu.quant.policy import quantize_tree as jax_qtree
    rng = np.random.default_rng(14)
    mixed = jax_qtree(
        {"big": {"weight": rng.normal(size=(512, 512)).astype(np.float32)},
         "norm": {"alpha": np.ones(512, np.float32)},
         "emb": {"weight": rng.normal(size=(300, 512)).astype(np.float32)},
         "r": {"weight": rng.normal(size=(256, 256)).astype(np.float32)}},
        "q4_k")
    mixed["r8"] = jax_qtree(
        {"weight": rng.normal(size=(256, 256)).astype(np.float32)}, "q8_r")
    mixed["bf"] = jnp.asarray(rng.normal(size=(4, 8)), jnp.bfloat16)
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    lm = jax_tree(synth_lm_params(LMConfig(**_LM_TTS), "q4_k", device="cpu",
                                  seed=6))
    return {"mixed": mixed, "lm": lm}


@pytest.mark.parametrize("which", ["mixed", "lm"])
def test_cache_files_identical_and_cross_read(tmp_path, which):
    from moshi_tpu.runtime.cache import load_quantized as jax_load
    from moshi_tpu.runtime.cache import save_quantized as jax_save
    from moshi_tpu_torch.runtime.cache import load_quantized, save_quantized
    jtree = _cache_trees()[which]
    ptree = port_tree(jtree)
    jpath = str(tmp_path / "jax.safetensors")
    ppath = str(tmp_path / "port.safetensors")
    jax_save(jpath, jtree, metadata={"model": "test"})
    save_quantized(ppath, ptree, metadata={"model": "test"})
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    # each reads the other's file to the tree it was written from
    assert_trees_equal(load_quantized(jpath, device="cpu"), ptree)
    assert_trees_equal(port_tree(jax_load(ppath)), ptree)
