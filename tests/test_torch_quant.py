"""The port's quantized-weight code against the JAX package, on the CPU.

* ``dequantize`` / ``dequantize_rows`` are bit-exact against JAX's.
* K1's plain version (``moshi_tpu_torch.quant.matmul_int8``) against the
  Pallas ``qmatmul_i8`` / ``glu_matmul_i8`` in interpret mode.
* K2's plain version (``moshi_tpu_torch.quant.matmul``) against the Pallas
  ``qmatmul_pallas_stacked`` (f32-dequant kernels) in interpret mode.
* K6's and K8's plain versions against the Pallas ``qmatmul_pallas`` and
  ``glu_matmul_pallas_stacked`` at 2, 8 and 12 activation rows, each
  limit held against a control that changes one rounding, and the GLU
  routing (q4_0 takes the two-call form, where the JAX kernel returns
  None).

Weights are quantized from seeded numpy draws by the JAX package's own
quantizers and handed to the port through numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.quant import formats as jf
from moshi_tpu.quant.pallas_matmul import (glu_matmul_pallas_stacked,
                                           qmatmul_pallas,
                                           qmatmul_pallas_stacked)
from moshi_tpu.quant.pallas_matmul_int8 import glu_matmul_i8, qmatmul_i8

from moshi_tpu_torch.quant import formats as pf
from moshi_tpu_torch.quant import matmul as pm
from moshi_tpu_torch.quant.matmul import dequant_matvec, qmatmul_stacked
from moshi_tpu_torch.quant.matmul_int8 import glu_matmul_i8 as port_glu_i8
from moshi_tpu_torch.quant.matmul_int8 import qmatmul_i8 as port_qmatmul_i8
from moshi_tpu_torch.runtime.convert import params_from_numpy

# K1: both sides form the same int8 activation and the same integer block
# dots; they differ only in the f32 order of the scale epilogue's sums
# (about 1e-7 of the output's largest value).  A last-bit difference in
# JAX's rsqrt against PyTorch's could flip one activation's int8 rounding
# and move the result by about 1e-3; no seeded case here does, so the
# tolerance is 1e-5 of the output's largest value.
_TOL_I8 = 1e-5
# K2: bf16 x bf16 products are exact in f32 on both sides; only the f32
# summation order differs.
_TOL_DQ = 1e-5


def _stacked_qt(rng, fmt, lead, o, k):
    """A stacked JAX QuantTensor [*lead, o, k] quantized from N(0, 0.05)
    draws, and its numpy field dict."""
    n = int(np.prod(lead)) if lead else 1
    qts = [jf.quantize(rng.normal(0, 0.05, (o, k)).astype(np.float32), fmt,
                       native=False) for _ in range(n)]
    qt = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs).reshape(tuple(lead) + xs[0].shape), *qts) \
        if lead else qts[0]
    fields = {"fmt": fmt, "shape": (o, k)}
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a = getattr(qt, f)
        fields[f] = None if a is None else np.asarray(a)
    return qt, fields


def _port_qt(fields):
    return params_from_numpy({"w": fields}, device="cpu")["w"]


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))
                 / max(float(np.max(np.abs(np.asarray(ref)))), 1e-30))


@pytest.mark.parametrize("fmt,k", [("q4_k", 512), ("q4_0", 576),
                                   ("q8_0", 256), ("q4_0", 4224)])
def test_dequantize_bit_exact(fmt, k):
    rng = np.random.default_rng(0)
    qt, fields = _stacked_qt(rng, fmt, (2,), 64, k)
    pqt = _port_qt(fields)
    ref = np.asarray(jf.dequantize(qt, jnp.float32))
    got = pf.dequantize(pqt, torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
    ref16 = np.asarray(jf.dequantize(qt, jnp.bfloat16).astype(jnp.float32))
    got16 = pf.dequantize(pqt).float().numpy()
    np.testing.assert_array_equal(got16, ref16)


@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", "q8_0"])
def test_dequantize_rows_bit_exact(fmt):
    rng = np.random.default_rng(1)
    qt, fields = _stacked_qt(rng, fmt, (), 300, 512)
    rows = rng.integers(0, 300, (2, 5))
    ref = np.asarray(jf.dequantize_rows(qt, jnp.asarray(rows), jnp.float32))
    got = pf.dequantize_rows(_port_qt(fields), torch.from_numpy(rows),
                             torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_with_eff_scales_matches():
    rng = np.random.default_rng(2)
    qt, fields = _stacked_qt(rng, "q4_k", (3,), 32, 512)
    fields = dict(fields, es=None, em=None)
    got = _port_qt(fields).with_eff_scales()
    for name in ("es", "em"):
        np.testing.assert_array_equal(
            getattr(got, name).float().numpy(),
            np.asarray(getattr(qt, name).astype(jnp.float32)))


# (fmt, lead, O, K, layer, norm, glu)
_I8_CASES = [
    ("q4_k", (), 256, 512, None, False, False),
    ("q4_k", (3,), 256, 512, 2, True, False),
    ("q4_k", (2, 3), 128, 256, 4, True, False),      # depformer [W, L, ...]
    ("q4_k", (2,), 512, 256, 1, True, True),          # GLU, fused norm
    ("q4_k", (), 256, 256, None, False, True),
    ("q4_0", (2,), 256, 512, 1, True, False),
    ("q4_0", (), 256, 512, None, False, True),
    ("q8_0", (2,), 256, 512, 0, True, False),
    ("q8_0", (), 256, 256, None, False, True),
    ("q4_k", (), 64, 4096, None, True, False),        # 7B width
    ("q4_k", (), 32, 11264, None, False, False),      # 7B linear_out K
]


@pytest.mark.parametrize("fmt,lead,o,k,layer,norm,glu", _I8_CASES)
def test_int8_matvec_plain_matches_pallas(fmt, lead, o, k, layer, norm,
                                          glu):
    rng = np.random.default_rng(3)
    qt, fields = _stacked_qt(rng, fmt, lead, o, k)
    x = rng.normal(0, 1, (1, k)).astype(np.float32)
    nl = int(np.prod(lead)) if lead else 1
    alpha = (rng.normal(1, 0.1, (nl, k)).astype(np.float32) if norm
             else None)
    jfn = glu_matmul_i8 if glu else qmatmul_i8
    ref = np.asarray(jfn(jnp.asarray(x), qt,
                         layer=None if layer is None else jnp.int32(layer),
                         alpha=None if alpha is None else jnp.asarray(alpha),
                         interpret=True))
    pfn = port_glu_i8 if glu else port_qmatmul_i8
    got = pfn(torch.from_numpy(x), _port_qt(fields), layer=layer,
              alpha=None if alpha is None else torch.from_numpy(alpha))
    assert got.shape == ref.shape
    assert _rel(got, ref) < _TOL_I8


def test_int8_block_scale_rounds_like_xla():
    """XLA computes the Pallas kernel's amax / 127 as amax * f32(1/127),
    which differs from the quotient in the last bit for some amax.  A bf16
    element equal to amax / 2 then sits just off the .5 tie (x/dx = 63.5
    exactly under the quotient) and rounds the other way.  The port forms
    dx as XLA does, so the int8 activations and the outputs agree."""
    rng = np.random.default_rng(7)
    k = 512
    nb = k // 32
    qt, fields = _stacked_qt(rng, "q4_k", (), 256, k)
    # bf16 block maxima whose quotient and reciprocal product differ
    cand = np.float32(1) + np.arange(128, dtype=np.float32) / 128
    inv = np.float32(1) / np.float32(127)
    cand = cand[cand / np.float32(127) != cand * inv]
    assert len(cand) >= nb // 4
    amax = rng.choice(cand, nb)
    x = rng.uniform(-0.4, 0.4, (nb, 32)).astype(np.float32)
    x[:, 0] = amax
    x[:, 1:9] = amax[:, None] / 2 * rng.choice([-1.0, 1.0], (nb, 8))
    xb = torch.from_numpy(x.reshape(1, k)).to(torch.bfloat16)
    ref = np.asarray(qmatmul_i8(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), qt, interpret=True))
    got = port_qmatmul_i8(xb, _port_qt(fields))
    assert _rel(got, ref) < _TOL_I8
    # the case tells the two roundings apart: the quotient moves xq
    xf = xb.float().reshape(nb, 32)
    am = xf.abs().amax(dim=-1, keepdim=True)
    assert not torch.equal(torch.round(xf / (am / 127.0)),
                           torch.round(xf / (am * (1.0 / 127.0))))


@pytest.mark.parametrize("fmt,m,k,norm", [
    ("q4_0", 1, 4224, False),     # the 7B depformer linear_out (nb = 132)
    ("q4_0", 1, 4224, True),
    ("q4_0", 2, 576, False),
    ("q4_k", 2, 512, True),
    ("q8_0", 2, 256, False),
])
def test_dequant_matvec_plain_matches_pallas(fmt, m, k, norm):
    rng = np.random.default_rng(4)
    qt, fields = _stacked_qt(rng, fmt, (2,), 256, k)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (2, k)).astype(np.float32) if norm else None
    ref = np.asarray(qmatmul_pallas_stacked(
        jnp.asarray(x), qt, jnp.int32(1),
        alpha=None if alpha is None else jnp.asarray(alpha), interpret=True))
    got = dequant_matvec(torch.from_numpy(x), _port_qt(fields), layer=1,
                         alpha=None if alpha is None
                         else torch.from_numpy(alpha))
    assert got.shape == ref.shape
    assert _rel(got, ref) < _TOL_DQ


def test_qmatmul_dispatch_follows_int8_rule():
    """One row with nb % 8 == 0 goes to the int8 matvec; the 7B depformer
    linear_out (q4_0, K = 4224, nb = 132) and, at the default
    MOSHI_TPU_INT8_MAX_M of 1, any second row go to the dequant matvec; a
    plain tensor goes to torch.matmul."""
    rng = np.random.default_rng(5)
    _, f_i8 = _stacked_qt(rng, "q4_k", (), 256, 512)
    _, f_dq = _stacked_qt(rng, "q4_0", (), 256, 4224)
    w_i8, w_dq = _port_qt(f_i8), _port_qt(f_dq)
    assert pf.int8_dispatch(w_i8, 1) and not pf.int8_dispatch(w_i8, 2)
    assert not pf.int8_dispatch(w_dq, 1)
    x1 = torch.from_numpy(rng.normal(0, 1, (1, 512)).astype(np.float32))
    torch.testing.assert_close(qmatmul_stacked(x1, w_i8),
                               port_qmatmul_i8(x1, w_i8), rtol=0, atol=0)
    x2 = torch.from_numpy(rng.normal(0, 1, (1, 4224)).astype(np.float32))
    torch.testing.assert_close(qmatmul_stacked(x2, w_dq),
                               dequant_matvec(x2, w_dq), rtol=0, atol=0)
    dense = torch.from_numpy(rng.normal(0, 1, (8, 512)).astype(np.float32))
    torch.testing.assert_close(pf.qmatmul(x1, dense), x1 @ dense.T)


def test_int8_matvec_matches_jax_through_qmatmul_pallas():
    """The flat dispatch (the text head, the depformer input projection):
    JAX's qmatmul with Pallas on reaches qmatmul_i8, the port's reaches
    its plain version; same result."""
    rng = np.random.default_rng(6)
    qt, fields = _stacked_qt(rng, "q4_k", (), 512, 256)
    x = rng.normal(0, 1, (1, 1, 256)).astype(np.float32)
    from moshi_tpu.utils.pallas_mode import pallas_interpret
    jf.enable_pallas(True)
    try:
        with pallas_interpret():
            ref = np.asarray(jf.qmatmul(jnp.asarray(x), qt))
    finally:
        jf.enable_pallas(False)
    got = pf.qmatmul(torch.from_numpy(x), _port_qt(fields))
    assert got.shape == ref.shape
    assert _rel(got, ref) < _TOL_I8


# K6 and K8: K2's arithmetic (products exact in f32 on both sides, f32 sums
# in another order: <= 5.7e-7 (K6) and 8.7e-7 (K8) of the output's largest
# value on these cases; K8's silu takes exp on both sides, last-bit
# apart).  The limit is K2's.  Controls, each changing one rounding: K6
# with the activation left in f32 (the kernels round it to bf16), >=
# 1.5e-3; K8 with the gate rounded to bf16 before the silu, >= 1.8e-3.
_TOL_K68 = 1e-5


def _act_f32_control(x, qt, alpha):
    """K6's plain version with the activation not rounded to bf16."""
    qt = qt.with_eff_scales()
    xn = x.float() if alpha is None else pf.rms_pre_norm(x, alpha)
    w = pm.dequantize_layer_bf16(qt, 0).float()
    y = xn @ w.T
    if qt.fmt == "q4_k":
        y = y - xn.reshape(xn.shape[0], -1, 32).sum(-1) @ qt.em.float().T
    return y


@pytest.mark.parametrize("m", [2, 8, 12])
@pytest.mark.parametrize("fmt,k,norm", [("q4_k", 512, True),
                                        ("q4_0", 576, False),
                                        ("q8_0", 256, True)])
def test_k6_plain_matches_qmatmul_pallas(fmt, k, norm, m):
    rng = np.random.default_rng(8)
    qt, fields = _stacked_qt(rng, fmt, (), 192, k)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (k,)).astype(np.float32) if norm else None
    ref = np.asarray(qmatmul_pallas(
        jnp.asarray(x), qt, alpha=None if alpha is None
        else jnp.asarray(alpha), interpret=True))
    pqt = _port_qt(fields)
    a = None if alpha is None else torch.from_numpy(alpha)
    got = pm.qmatmul_dequant(torch.from_numpy(x), pqt, alpha=a)
    assert got.shape == ref.shape == (m, 192)
    assert _rel(got, ref) < _TOL_K68
    assert _rel(_act_f32_control(torch.from_numpy(x), pqt, a), ref) > \
        10 * _TOL_K68


@pytest.mark.parametrize("m", [2, 8, 12])
@pytest.mark.parametrize("fmt,lead,layer,norm", [
    ("q4_k", (2,), 1, True),          # [L, 2H, K], fused norm
    ("q4_k", (2, 3), 4, False),       # [W, L, 2H, K], the depformer's
    ("q8_0", (2,), 0, False),
    ("q8_0", (2, 3), 5, True),
])
def test_k8_plain_matches_glu_matmul_pallas_stacked(fmt, lead, layer, norm,
                                                    m):
    rng = np.random.default_rng(9)
    k = 512
    qt, fields = _stacked_qt(rng, fmt, lead, 256, k)
    nl = int(np.prod(lead))
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    alpha = (rng.normal(1, 0.1, (nl, k)).astype(np.float32) if norm
             else None)
    ref = np.asarray(glu_matmul_pallas_stacked(
        jnp.asarray(x), qt, jnp.int32(layer),
        alpha=None if alpha is None else jnp.asarray(alpha), interpret=True))
    pqt = _port_qt(fields)
    a = None if alpha is None else torch.from_numpy(alpha)
    got = pm.glu_matvec(torch.from_numpy(x), pqt, layer=layer, alpha=a)
    assert got.shape == ref.shape == (m, 128)
    assert _rel(got, ref) < _TOL_K68
    # the control: the gate rounded to bf16 before the silu
    gv = pm.dequant_matvec(torch.from_numpy(x), pqt, layer=layer, alpha=a)
    ctl = pm._silu(gv[:, :128].to(torch.bfloat16).float()) * gv[:, 128:]
    assert _rel(ctl, ref) > 10 * _TOL_K68


def test_glu_routing_follows_glu_matmul_pallas_stacked():
    """One int8-eligible row takes K1's GLU; q4_k and q8_0 at m > 1 take
    K8; q4_0, where the JAX kernel returns None, the two-call form (K2
    over the 2H rows, then silu(gate) * value)."""
    rng = np.random.default_rng(10)
    k = 512
    x1 = torch.from_numpy(rng.normal(0, 1, (1, k)).astype(np.float32))
    x4 = torch.from_numpy(rng.normal(0, 1, (4, k)).astype(np.float32))
    for fmt in ("q4_k", "q8_0", "q4_0"):
        qt, fields = _stacked_qt(rng, fmt, (2,), 256, k)
        pqt = _port_qt(fields)
        torch.testing.assert_close(pm.glu_matmul_stacked(x1, pqt, 1),
                                   port_glu_i8(x1, pqt, layer=1),
                                   rtol=0, atol=0)
        got = pm.glu_matmul_stacked(x4, pqt, 1)
        jax_out = glu_matmul_pallas_stacked(jnp.asarray(x4.numpy()), qt,
                                            jnp.int32(1), interpret=True)
        if fmt == "q4_0":
            assert jax_out is None
            gh = pm.dequant_matvec(x4, pqt, layer=1)
            two_call = torch.nn.functional.silu(gh[:, :128]) * gh[:, 128:]
            torch.testing.assert_close(got, two_call, rtol=0, atol=0)
            with pytest.raises(ValueError, match="K8"):
                pm.glu_matvec(x4, pqt, layer=1)
        else:
            torch.testing.assert_close(got, pm.glu_matvec(x4, pqt, layer=1),
                                       rtol=0, atol=0)
            assert _rel(got, jax_out) < _TOL_K68


def test_flat_qmatmul_takes_k6_at_several_rows():
    """The flat dispatch at m > 1 (the text head and the depformer
    in-projection of a batched frame): JAX's qmatmul with Pallas on
    reaches qmatmul_pallas, the port's reaches K6's plain version."""
    rng = np.random.default_rng(11)
    qt, fields = _stacked_qt(rng, "q4_k", (), 512, 256)
    x = rng.normal(0, 1, (4, 1, 256)).astype(np.float32)
    from moshi_tpu.utils.pallas_mode import pallas_interpret
    jf.enable_pallas(True)
    try:
        with pallas_interpret():
            ref = np.asarray(jf.qmatmul(jnp.asarray(x), qt))
    finally:
        jf.enable_pallas(False)
    pqt = _port_qt(fields)
    got = pf.qmatmul(torch.from_numpy(x), pqt)
    assert got.shape == ref.shape == (4, 1, 512)
    assert _rel(got, ref) < _TOL_K68
    torch.testing.assert_close(got, pm.qmatmul_dequant(torch.from_numpy(x),
                                                       pqt), rtol=0, atol=0)
    with pytest.raises(ValueError, match="flat"):
        pm.qmatmul_dequant(torch.from_numpy(x),
                           _port_qt(_stacked_qt(rng, "q4_k", (2,), 64,
                                                256)[1]))
