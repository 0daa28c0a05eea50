"""K5's plain version (``moshi_tpu_torch.quant.fused``) against the JAX
package's Pallas ``attn_ffn_fused_i8`` in interpret mode, on the CPU, and
the two packages' ``can_fuse_mid`` on the same shapes.

Weights are quantized from seeded numpy draws by the JAX package's own
quantizers and handed to the port through numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.quant import formats as jf
from moshi_tpu.quant.pallas_fused import attn_ffn_fused_i8 as jax_fused
from moshi_tpu.quant.pallas_fused import can_fuse_mid as jax_can_fuse_mid

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.quant import fused
from moshi_tpu_torch.runtime.convert import params_from_numpy

# Both sides form the same int8 activations and integer block dots; they
# differ in the f32 order of the scale sums (~1e-7 of the largest value)
# and, for norm2, in the last bit of rsqrt, which could flip one int8
# rounding of n2 (~1e-3); no seeded case here does.  h_mid is the f32 sum
# of the residual and out_proj's output.
_TOL = 1e-5


def _stacked_qt(rng, fmt, layers, o, k):
    """A stacked JAX QuantTensor [layers, o, k] from N(0, 0.05) draws, and
    the port's QuantTensor with the same bytes."""
    qts = [jf.quantize(rng.normal(0, 0.05, (o, k)).astype(np.float32), fmt,
                       native=False) for _ in range(layers)]
    qt = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *qts)
    fields = {"fmt": fmt, "shape": (o, k)}
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a = getattr(qt, f)
        fields[f] = None if a is None else np.asarray(a)
    return qt, params_from_numpy({"w": fields}, device="cpu")["w"]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


# (fmt, K, H, hcur dtype): the temporal stack's carry is f32, the
# depformer's bf16 (K = 1024 as the 7B depformer's)
_CASES = [("q4_k", 512, 768, "f32"), ("q4_0", 512, 768, "f32"),
          ("q8_0", 512, 768, "bf16"), ("q4_k", 1024, 1024, "bf16")]


@pytest.mark.parametrize("fmt,k,h,hdt", _CASES)
def test_fused_plain_matches_pallas(fmt, k, h, hdt):
    rng = np.random.default_rng(11)
    out_j, out_p = _stacked_qt(rng, fmt, 2, k, k)
    glu_j, glu_p = _stacked_qt(rng, fmt, 2, 2 * h, k)
    assert jax_can_fuse_mid(out_j, glu_j, 1)
    assert fused.can_fuse_mid(out_p, glu_p, 1)
    attn = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    hcur = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, (2, k)).astype(np.float32)
    jdt = jnp.float32 if hdt == "f32" else jnp.bfloat16
    tdt = torch.float32 if hdt == "f32" else torch.bfloat16
    build.COUNTS.clear()
    for layer in (0, 1):
        g_ref, h_ref = jax_fused(
            jnp.asarray(attn).astype(jnp.bfloat16),
            jnp.asarray(hcur).astype(jdt), out_j, glu_j,
            jnp.asarray(alpha), jnp.int32(layer), interpret=True)
        g, h_mid = fused.attn_ffn_fused_i8(
            torch.from_numpy(attn).to(torch.bfloat16),
            torch.from_numpy(hcur).to(tdt), out_p, glu_p,
            torch.from_numpy(alpha), layer)
        assert g.shape == (1, h) and h_mid.shape == (1, k)
        assert g.dtype == h_mid.dtype == torch.float32
        assert _rel(h_mid.numpy(), h_ref) < _TOL, layer
        assert _rel(g.numpy(), g_ref) < _TOL, layer
    # on the CPU the wrapper runs the plain version, which counts nothing
    assert build.COUNTS["attn_ffn_fused"] == 0


def test_fused_keeps_h_mid_in_f32():
    """With a bf16 carry, rounding h_mid to bf16 before norm2 (what the
    unfused depformer does) is a different function: the port's fused
    form must not do it."""
    rng = np.random.default_rng(12)
    k, h = 512, 768
    out_j, out_p = _stacked_qt(rng, "q4_k", 1, k, k)
    glu_j, glu_p = _stacked_qt(rng, "q4_k", 1, 2 * h, k)
    attn = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    hcur = (rng.normal(size=(1, k)) * 0.5).astype(np.float32)
    alpha = np.ones((1, k), np.float32)
    g_ref, _ = jax_fused(jnp.asarray(attn).astype(jnp.bfloat16),
                         jnp.asarray(hcur).astype(jnp.bfloat16), out_j,
                         glu_j, jnp.asarray(alpha), jnp.int32(0),
                         interpret=True)
    a_t = torch.from_numpy(attn).to(torch.bfloat16)[0]
    h_t = torch.from_numpy(hcur).to(torch.bfloat16)[0]
    qo, qg = out_p.with_eff_scales(), glu_p.with_eff_scales()
    g, h_mid = fused.attn_ffn_fused_plain(a_t, h_t, qo, qg,
                                          torch.ones(k), 0)
    assert _rel(g.numpy(), g_ref[0]) < _TOL
    from moshi_tpu_torch.quant.matmul_int8 import int8_matvec_plain
    g_bf16 = int8_matvec_plain(h_mid.to(torch.bfloat16), qg, 0,
                               torch.ones(k), glu=True)
    assert _rel(g_bf16.numpy(), g_ref[0]) > 10 * _TOL


def _shape_only(fmt, o, k):
    """A port QuantTensor and a JAX one of the given shape (zero bytes):
    eligibility reads only formats and shapes."""
    qt = jf.quantize(np.zeros((o, k), np.float32), fmt, native=False)
    fields = {"fmt": fmt, "shape": (o, k)}
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a = getattr(qt, f)
        fields[f] = None if a is None else np.asarray(a)
    return qt, params_from_numpy({"w": fields}, device="cpu")["w"]


# (out fmt, out (O, K), GLU fmt, GLU (rows, K), m)
_ELIGIBILITY = [
    ("q4_k", (512, 512), "q4_k", (1536, 512), 1),     # eligible
    ("q4_k", (512, 512), "q4_k", (1536, 512), 2),     # two rows
    ("q4_k", (256, 512), "q4_k", (1536, 512), 1),     # out_proj not square
    ("q4_0", (576, 576), "q4_0", (1536, 576), 1),     # K/32 = 18, not % 8
    ("q4_k", (512, 512), "q4_k", (1536, 256), 1),     # GLU K differs
    ("q8_0", (256, 256), "q8_0", (1026, 256), 1),     # H = 513, one tile
    ("q8_0", (256, 256), "q8_0", (1025, 256), 1),     # odd GLU rows
    ("q4_0", (1024, 1024), "q4_k", (2048, 1024), 1),  # mixed formats
]


@pytest.mark.parametrize("ofmt,oshape,gfmt,gshape,m", _ELIGIBILITY)
def test_can_fuse_mid_matches_jax(ofmt, oshape, gfmt, gshape, m):
    out_j, out_p = _shape_only(ofmt, *oshape)
    glu_j, glu_p = _shape_only(gfmt, *gshape)
    assert fused.can_fuse_mid(out_p, glu_p, m) == \
        bool(jax_can_fuse_mid(out_j, glu_j, m))


def test_fuse_mid_switch_follows_the_environment(monkeypatch):
    monkeypatch.delenv("MOSHI_TPU_FUSE_MID", raising=False)
    assert fused.fuse_mid_enabled()
    monkeypatch.setenv("MOSHI_TPU_FUSE_MID", "0")
    assert not fused.fuse_mid_enabled()
    monkeypatch.setenv("MOSHI_TPU_FUSE_MID", "1")
    assert fused.fuse_mid_enabled()
