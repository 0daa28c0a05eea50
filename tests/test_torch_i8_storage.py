"""Unpacked int8 weight storage (``QuantTensor.with_i8_storage``,
``i8_storage_tree``: the JAX package's ``bench.py --i8-storage``) in the
port against the JAX package, on the CPU.

* The storage: ``with_i8_storage`` and ``i8_storage_tree`` bit for bit
  against JAX's (q4_k, q4_0 with its zero point folded in, q8_0 a no-op;
  the embeddings and the depformer linear_out, whose block count K1
  refuses, left packed), and ``dequantize`` on it.
* K1's plain version on unpacked storage against ``qmatmul_i8`` /
  ``glu_matmul_i8`` in interpret mode (the Pallas kernel's ``packed=False``
  body), q4_k and q4_0, with and without the fused norm; on q4_k it also
  equals the packed storage's plain version bit for bit.
* K5's plain version with out_proj and linear_in each packed or unpacked
  against ``attn_ffn_fused_i8`` in interpret mode.
* The routing: ``storage_ok`` against JAX's, K1's refusal at two rows,
  K2, K6, K7 and K8 raising on unpacked storage, the megakernel gates
  raising on it, and the reference's K13 misreading it.
* The frame: ``lm_gen_step`` on unpacked storage against JAX's over 24
  frames that wrap the 16-slot ring (``test_torch_lm.py``'s limits), and
  against the port's own packed frames, bit for bit.

Inputs are seeded numpy draws handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as tl
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.nn import pallas_temporal as jax_temporal
from moshi_tpu.nn import transformer as jax_tr
from moshi_tpu.nn.rope import rope_angles as jax_rope_angles
from moshi_tpu.quant import formats as jf
from moshi_tpu.quant import pallas_matmul as jax_pm
from moshi_tpu.quant.pallas_fused import attn_ffn_fused_i8 as jax_fused
from moshi_tpu.quant.pallas_matmul_int8 import glu_matmul_i8 as jax_glu_i8
from moshi_tpu.quant.pallas_matmul_int8 import qmatmul_i8 as jax_qmatmul_i8
from moshi_tpu.runtime.synth import synth_lm_params as jax_synth_lm_params
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import transformer as port_tr
from moshi_tpu_torch.quant import formats as pf
from moshi_tpu_torch.quant import fused, matmul, matmul_int8
from moshi_tpu_torch.runtime.convert import params_from_numpy

# K1 and K5 on either storage form the same int8 activations and integer
# block dots as the Pallas kernels and differ in the f32 order of the
# scale sums (~1e-7 of the largest value): test_torch_fused's limit.
_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(qt):
    out = {"fmt": qt.fmt, "shape": tuple(qt.shape)}
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a = getattr(qt, f)
        out[f] = None if a is None else np.asarray(a)
    return out


def _both(rng, fmt, layers, o, k):
    """A stacked JAX QuantTensor [layers, o, k] quantized from N(0, 0.05)
    draws, and the port's with the same bytes."""
    qts = [jf.quantize(rng.normal(0, 0.05, (o, k)).astype(np.float32), fmt,
                       native=False) for _ in range(layers)]
    qt = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *qts)
    return qt, params_from_numpy({"w": _fields(qt)}, device="cpu")["w"]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _same_bits(port_qt, jax_qt):
    assert port_qt.fmt == jax_qt.fmt and tuple(port_qt.shape) == \
        tuple(jax_qt.shape)
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a, b = getattr(port_qt, f), getattr(jax_qt, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        b = np.asarray(b)
        ints = {2: np.int16, 1: np.uint8}.get(b.dtype.itemsize)
        if b.dtype.kind == "V" or b.dtype.name == "bfloat16":
            b = b.view(ints)
            a = a.view(torch.int16 if ints is np.int16 else torch.uint8)
        assert str(a.dtype).endswith(b.dtype.name), (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", "q8_0"])
def test_with_i8_storage_matches_jax(fmt):
    """The unpacked bytes equal JAX's (q4_0's zero point folded in), q8_0
    stays as it is, and ``dequantize`` reads both storages alike."""
    rng = np.random.default_rng(1)
    jq, pq = _both(rng, fmt, 2, 64, 512)
    ji, pi = jq.with_i8_storage(), pq.with_i8_storage()
    _same_bits(pi, ji)
    assert pi.unpacked and ji.unpacked
    if fmt == "q8_0":
        assert pi is pq
    else:
        assert pi.q.dtype == torch.int8 and pi.q.shape == (2, 64, 512)
        assert pf.i8_storage(pi) and not pf.i8_storage(pq)
        assert pi.nbytes - pq.nbytes == pq.q.numel()
    assert pi.with_i8_storage() is pi
    np.testing.assert_array_equal(
        pf.dequantize(pi, torch.float32).numpy(),
        np.asarray(jf.dequantize(ji, jnp.float32)))
    np.testing.assert_array_equal(pf.dequantize(pi, torch.float32).numpy(),
                                  pf.dequantize(pq, torch.float32).numpy())
    rows = torch.tensor([[3, 0], [63, 7]])
    np.testing.assert_array_equal(
        pf.dequantize_rows(pf.flatten_lead(pi), rows).float().numpy(),
        pf.dequantize_rows(pf.flatten_lead(pq), rows).float().numpy())


_TREE = {}


def _trees():
    """(JAX packed params, JAX i8 params, port packed params) of
    ``test_torch_lm``'s configuration and weights (whose draws set its
    limits), made once per module."""
    if not _TREE:
        cfg = JaxLMConfig(**tl._KW)
        p = jax_synth_lm_params(jax.random.PRNGKey(3), cfg, fmt="q4_k")
        _TREE.update(jax=p, jax_i8=jf.i8_storage_tree(p),
                     port=params_from_numpy(tl.export_numpy(p),
                                            device="cpu"))
    return _TREE


def test_i8_storage_tree_matches_jax():
    """Every leaf of the port's ``i8_storage_tree`` equals JAX's bit for
    bit: the int8-eligible 4-bit leaves unpacked, the embeddings (text_emb,
    emb, the depformer's text_emb and low-rank emb) and the depformer
    linear_out (K = 576, 18 blocks: K1 refuses it, as the 7B's 4224)
    packed."""
    t = _trees()
    got = pf.i8_storage_tree(t["port"])
    want = params_from_numpy(tl.export_numpy(t["jax_i8"]), device="cpu")
    unpacked = []

    def walk(g, w, path):
        if isinstance(g, dict):
            assert g.keys() == w.keys(), path
            for k in g:
                walk(g[k], w[k], path + (k,))
        elif isinstance(g, pf.QuantTensor):
            assert (g.fmt, tuple(g.shape)) == (w.fmt, tuple(w.shape)), path
            for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
                a, b = getattr(g, f), getattr(w, f)
                assert (a is None) == (b is None), (path, f)
                assert a is None or (a.dtype == b.dtype and torch.equal(
                    a.view(torch.uint8), b.view(torch.uint8))), (path, f)
            if pf.i8_storage(g):
                unpacked.append("/".join(path))
        else:
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.float().numpy())
    walk(got, want, ())
    assert sorted(unpacked) == sorted([
        "transformer/layers/self_attn/in_proj/weight",
        "transformer/layers/self_attn/out_proj/weight",
        "transformer/layers/gating/linear_in/weight",
        "transformer/layers/gating/linear_out/weight",
        "text_linear/weight", "depformer/in/weight",
        "depformer/layers/self_attn/in_proj/weight",
        "depformer/layers/self_attn/out_proj/weight",
        "depformer/layers/gating/linear_in/weight",
        "depformer/linears/weight"])
    lout = got["depformer"]["layers"]["gating"]["linear_out"]["weight"]
    assert lout.fmt == "q4_0" and lout.q.dtype == torch.uint8


# (fmt, O, K, alpha, glu)
_K1_CASES = [("q4_k", 96, 512, False, False), ("q4_k", 96, 512, True, True),
             ("q4_0", 96, 512, True, False), ("q4_0", 96, 1024, False, True)]


@pytest.mark.parametrize("fmt,o,k,norm,glu", _K1_CASES)
def test_k1_plain_on_i8_storage_matches_pallas(fmt, o, k, norm, glu):
    rng = np.random.default_rng(5)
    jq, pq = _both(rng, fmt, 2, o, k)
    ji, pi = jq.with_i8_storage(), pq.with_i8_storage()
    x = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    alpha = (rng.uniform(0.5, 1.5, (2, k)).astype(np.float32) if norm
             else None)
    build.COUNTS.clear()
    for layer in (0, 1):
        fn = jax_glu_i8 if glu else jax_qmatmul_i8
        ref = fn(jnp.asarray(x), ji, layer=jnp.int32(layer),
                 alpha=None if alpha is None else jnp.asarray(alpha),
                 interpret=True)
        pfn = matmul_int8.glu_matmul_i8 if glu else matmul_int8.qmatmul_i8
        ta = None if alpha is None else torch.from_numpy(alpha)
        got = pfn(torch.from_numpy(x), pi, layer=layer, alpha=ta)
        assert got.shape == (1, o // 2 if glu else o)
        assert _rel(got.numpy(), ref) < _TOL, layer
        packed = pfn(torch.from_numpy(x), pq, layer=layer, alpha=ta)
        if fmt == "q4_k":
            # the same integer dots and epilogue: the same bits
            assert torch.equal(got, packed)
        else:
            assert _rel(got.numpy(), packed.numpy()) < _TOL
    assert not build.COUNTS     # the CPU runs the plain version


@pytest.mark.parametrize("out_i8,glu_i8", [(True, True), (True, False),
                                           (False, True)])
def test_k5_plain_on_i8_storage_matches_pallas(out_i8, glu_i8):
    """K5 with each group in its own storage, as the Pallas kernel's
    per-group packed flag."""
    rng = np.random.default_rng(11)
    k, h = 512, 768
    out_j, out_p = _both(rng, "q4_k", 2, k, k)
    glu_j, glu_p = _both(rng, "q4_k", 2, 2 * h, k)
    if out_i8:
        out_j, out_p = out_j.with_i8_storage(), out_p.with_i8_storage()
    if glu_i8:
        glu_j, glu_p = glu_j.with_i8_storage(), glu_p.with_i8_storage()
    attn = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    hcur = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, (2, k)).astype(np.float32)
    assert fused.can_fuse_mid(out_p, glu_p, 1)
    for layer in (0, 1):
        g_ref, h_ref = jax_fused(
            jnp.asarray(attn).astype(jnp.bfloat16), jnp.asarray(hcur),
            out_j, glu_j, jnp.asarray(alpha), jnp.int32(layer),
            interpret=True)
        g, h_mid = fused.attn_ffn_fused_i8(
            torch.from_numpy(attn).to(torch.bfloat16),
            torch.from_numpy(hcur), out_p, glu_p, torch.from_numpy(alpha),
            layer)
        assert _rel(h_mid.numpy(), h_ref) < _TOL, layer
        assert _rel(g.numpy(), g_ref) < _TOL, layer


@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", "q8_0"])
@pytest.mark.parametrize("m", [1, 2])
def test_storage_ok_and_the_row_refusal_match_jax(fmt, m, monkeypatch):
    """``storage_ok`` and ``int8_shape_ok`` equal JAX's on both storages;
    K1 refuses unpacked storage at two rows (MOSHI_TPU_INT8_MAX_M 8)."""
    monkeypatch.setenv("MOSHI_TPU_INT8_MAX_M", "8")
    rng = np.random.default_rng(2)
    jq, pq = _both(rng, fmt, 1, 64, 512)
    from moshi_tpu.quant.pallas_matmul_int8 import int8_shape_ok
    for j, p in ((jq, pq), (jq.with_i8_storage(), pq.with_i8_storage())):
        assert pf.storage_ok(p, m) == jax_pm.storage_ok(j, m)
        assert pf.int8_shape_ok(p, m) == int8_shape_ok(j, m)
    pi = pq.with_i8_storage()
    x = torch.ones((m, 512))
    if m > 1 and fmt != "q8_0":
        assert not pf.storage_ok(pi, m)
        with pytest.raises(ValueError, match="one activation row"):
            matmul_int8.qmatmul_i8(x, pi, layer=0)
    else:
        matmul_int8.qmatmul_i8(x, pi, layer=0)


@pytest.mark.parametrize("kernel", ["K2", "K6", "K7", "K8"])
def test_dequant_kernels_raise_on_i8_storage(kernel):
    """The dequant wrappers read packed nibbles: on unpacked storage they
    raise, as the JAX package's ``_check_packed`` does, and the flat GLU
    router returns None where ``glu_matmul_pallas`` does."""
    from moshi_tpu_torch.nn.gating import glu_matmul_fused
    rng = np.random.default_rng(3)
    jq, pq = _both(rng, "q4_k", 1 if kernel in ("K6", "K7") else 2, 64,
                   512)
    pi = pq.with_i8_storage()
    if kernel in ("K6", "K7"):
        pi = pf.QuantTensor(pi.fmt, pi.shape, *(
            None if getattr(pi, f) is None else getattr(pi, f)[0]
            for f in ("q", "d", "sc", "mn", "dmin", "es", "em")))
    x = torch.ones((3, 512))
    run = {"K2": lambda: matmul.dequant_matvec(x, pi, layer=1),
           "K6": lambda: matmul.qmatmul_dequant(x, pi),
           "K7": lambda: matmul.glu_matmul(x, pi),
           "K8": lambda: matmul.glu_matvec(x, pi, layer=1)}[kernel]
    with pytest.raises(ValueError, match="unpacked i8 storage"):
        run()
    if kernel == "K7":
        assert glu_matmul_fused(x, pi) is None
        with pytest.raises(ValueError, match="unpacked i8 storage"):
            jax_pm._check_packed(jq.with_i8_storage())


def test_megakernel_gates_raise_on_i8_storage(monkeypatch):
    """Under MOSHI_TPU_MEGAKERNEL the port's gates raise on unpacked
    storage, naming the reference's misreading, where JAX's pass."""
    t = _trees()
    pp = pf.i8_storage_tree(t["port"])
    cfg = port_lm.LMConfig(**tl._KW)
    jcfg = JaxLMConfig(**tl._KW)
    monkeypatch.setenv("MOSHI_TPU_MEGAKERNEL", "all")
    jf.enable_pallas(True)
    try:
        assert jax_tr.can_use_temporal_megakernel(
            jcfg.transformer, t["jax_i8"]["transformer"], 1)
    finally:
        jf.enable_pallas(False)
    with pytest.raises(NotImplementedError, match="misreads"):
        port_tr.can_use_temporal_megakernel(cfg.transformer,
                                            pp["transformer"], 1)
    with pytest.raises(NotImplementedError, match="misreads"):
        port_lm.init_gen_state(cfg, 1, device="cpu", params=pp)
    with pytest.raises(NotImplementedError, match="K14"):
        port_lm._can_use_dep_megakernel(cfg, pp["depformer"], 1)
    monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL")
    assert not port_tr.can_use_temporal_megakernel(cfg.transformer,
                                                   pp["transformer"], 1)


def test_reference_k13_misreads_i8_storage():
    """The fault the port's gate refuses (ROADMAP C): the JAX package's K13
    on i8 storage runs, and reads the int8 values as nibbles.  Its
    residual update y - x then misses the packed weights' by more than the
    update itself."""
    t = _trees()
    lay = t["jax"]["transformer"]["layers"]
    lay_i8 = t["jax_i8"]["transformer"]["layers"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 256)).astype(np.float32)
    cos, sin = jax_rope_angles(jnp.asarray([3], jnp.int32), 64, 10_000.0)
    cap_pad = jax_temporal.plan_stages(256, 512, 16)[5]
    ring = jnp.zeros((2, cap_pad, 256), jnp.bfloat16)
    kw = dict(cap=16, context=16, heads=4, hidden=512, nlayers=2)

    def run(layers):
        w = {"qkv": layers["self_attn"]["in_proj"]["weight"],
             "out": layers["self_attn"]["out_proj"]["weight"],
             "glu": layers["gating"]["linear_in"]["weight"],
             "lout": layers["gating"]["linear_out"]["weight"],
             "n1": layers["norm1"]["alpha"], "n2": layers["norm2"]["alpha"]}
        with pallas_interpret():
            y = jax_temporal.temporal_full_step(
                jnp.asarray(x), ring, ring, jnp.int32(3), (cos, sin), w,
                **kw)[0]
        return np.asarray(y) - x

    good, bad = run(lay), run(lay_i8)
    assert np.all(np.isfinite(bad))
    assert np.max(np.abs(bad - good)) > np.max(np.abs(good))


_FRAMES = {}


def _i8_frames():
    """(JAX's frames on i8 storage, the port's on i8 storage, the port's
    on packed storage), fused form, made once per module."""
    if not _FRAMES:
        t = _trees()
        cfg = JaxLMConfig(**tl._KW)
        rng = np.random.default_rng(7)
        other = rng.integers(0, cfg.card,
                             (tl._FRAMES, 1, cfg.n_q - cfg.dep_q),
                             dtype=np.int32)
        ref, _ = tl._run_jax(cfg, t["jax_i8"], other, "1")
        pcfg = port_lm.LMConfig(**tl._KW)
        build.COUNTS.clear()
        got, calls = tl._run_port(pcfg, pf.i8_storage_tree(t["port"]),
                                  other, "1")
        packed, _ = tl._run_port(pcfg, t["port"], other, "1")
        _FRAMES.update(ref=ref, got=got, packed=packed, calls=calls,
                       cfg=pcfg)
    return _FRAMES


def test_i8_frames_match_jax():
    """24 frames on i8 storage (the ring wraps at 16): transformer_out and
    the text logits within ``test_torch_lm``'s limit, the depformer logits
    within its tighter one, the decided tokens and the delay cache's
    outputs equal; K5 in every layer, as on packed storage."""
    r = _i8_frames()
    ref, got, cfg = r["ref"], r["got"], r["cfg"]
    n = tl._compared_frames(ref, got)
    assert n >= 20, f"token streams diverged at frame {n}"
    for f in range(n):
        assert tl._rel_err(got[f]["h"], ref[f]["h"]) < tl._RTOL, f
        assert tl._rel_err(got[f]["logits"], ref[f]["logits"]) < tl._RTOL
        assert tl._rel_err(got[f]["dep_logits"],
                           ref[f]["dep_logits"]) < tl._DEP_RTOL, f
        decided = tl._gap(ref[f]["logits"]) > tl._RTOL
        np.testing.assert_array_equal(
            got[f]["out"]["sampled_text"][decided],
            ref[f]["out"]["sampled_text"][decided])
        for key in ("text", "audio", "valid"):
            np.testing.assert_array_equal(got[f]["out"][key],
                                          ref[f]["out"][key])
    assert r["calls"] == (cfg.num_layers + cfg.dep_q
                          * cfg.depformer_layers) * tl._FRAMES


def test_i8_frames_equal_the_packed_frames():
    """Every i8 product is q4_k (the one q4_0 weight stays packed), whose
    integer dots and epilogue are the packed storage's: the port's frames
    on both storages agree bit for bit."""
    r = _i8_frames()
    for g, p in zip(r["got"], r["packed"]):
        np.testing.assert_array_equal(g["h"], p["h"])
        np.testing.assert_array_equal(g["logits"], p["logits"])
        np.testing.assert_array_equal(g["dep_logits"], p["dep_logits"])
        for key in g["out"]:
            np.testing.assert_array_equal(g["out"][key], p["out"][key])
