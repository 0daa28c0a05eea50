"""K6's and K2's plain versions against the Pallas kernels on the CPU: the
dequantization probe of ``chip_smoke.py`` and the ragged widths.

* The probe (``chip_smoke.probe_weight``): one-hot activation rows
  against weights whose 32-blocks carry every bf16 exponent with a few
  mantissas as their scale, both signs, in q4_k, q4_0 and q8_0.  Each
  output is one dequantized weight element, so the port's plain K6 must
  equal ``dequantize_layer_bf16`` exactly, and so must JAX's
  ``qmatmul_pallas`` in interpret mode wherever XLA's CPU runtime keeps
  the value: it reads subnormal numbers as zero, so a block with a
  subnormal scale reads 0 there.  On the card the same construction runs
  over every finite scale through the kernels (chip_smoke phase 3).
* K2's plain version against ``qmatmul_pallas_stacked`` (interpret) at
  8 rows and the widths whose halves are not whole 512-column steps of
  the kernel (K = 4224, 8448), narrow O.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.quant import formats as jf
from moshi_tpu.quant.pallas_matmul import (qmatmul_pallas,
                                           qmatmul_pallas_stacked)

from moshi_tpu_torch.quant import matmul as pm
from moshi_tpu_torch.quant.formats import rms_pre_norm

_K = 64            # the probe's K and its one-hot rows
# K2 at the ragged widths: products exact in f32 on both sides, f32 sums
# in another order (as test_torch_quant's _TOL_DQ); the control, the
# activation left in f32, reads >= 1e-3.  With the fused norm a last-bit
# difference between JAX's rsqrt and 1 / sqrt can flip one activation's
# bf16 rounding (1.8e-4 at q8_0, K = 4224, this seed): the norm is
# checked at the one width where no rounding flips.
_TOL_DQ = 1e-5


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_qt(qt):
    """The JAX QuantTensor of a port QuantTensor (bf16 bits kept)."""
    def arr(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jax.lax.bitcast_convert_type(
                jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jf.QuantTensor(qt.fmt, tuple(qt.shape), arr(qt.q), arr(qt.d),
                          es=arr(qt.es), em=arr(qt.em))


@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", "q8_0"])
def test_probe_plain_k6_matches_qmatmul_pallas(fmt):
    smoke = _smoke()
    bits = smoke.probe_scale_bits(fmt, full=False)
    # every exponent (0: the zeros and subnormals) up to the first whose
    # largest product overflows bf16, both signs
    exps = set(((bits.int() >> 7) & 0xFF).tolist())
    top = max(exps)
    assert exps == set(range(top + 1)) and bool((bits < 0).any())
    over = torch.tensor(smoke._PROBE_MAX[fmt] * 2.0 ** (top + 1 - 127))
    assert torch.isinf(over.to(torch.bfloat16))
    qt = smoke.probe_weight(fmt, bits, _K)
    w = pm.dequantize_layer_bf16(qt, 0).float().T            # [K, O]
    x = torch.eye(_K)
    got = pm.qmatmul_dequant(x, qt)
    assert got.shape == w.shape
    assert torch.equal(got, w)
    ref = torch.from_numpy(np.asarray(qmatmul_pallas(
        jnp.asarray(x.numpy()), _jax_qt(qt), interpret=True)))
    # each element's block scale; XLA's CPU runtime reads a subnormal one
    # as zero
    s = torch.repeat_interleave((qt.es if fmt == "q4_k" else qt.d).float(),
                                32, dim=-1).T
    sub = (s != 0) & (s.abs() < torch.finfo(torch.float32).tiny)
    assert int(sub.sum()) > 0
    assert torch.equal(ref[~sub], w[~sub])
    assert bool((ref[sub] == 0).all())


@pytest.mark.parametrize("fmt,k,norm", [("q4_0", 4224, False),
                                        ("q4_k", 8448, True),
                                        ("q8_0", 4224, False)])
def test_k2_plain_matches_pallas_at_ragged_widths(fmt, k, norm):
    rng = np.random.default_rng(11)
    qts = [jf.quantize(rng.normal(0, 0.05, (32, k)).astype(np.float32),
                       fmt, native=False) for _ in range(2)]
    qt = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qts)
    x = rng.normal(0, 1, (8, k)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (2, k)).astype(np.float32) if norm else None
    ref = np.asarray(qmatmul_pallas_stacked(
        jnp.asarray(x), qt, jnp.int32(1),
        alpha=None if alpha is None else jnp.asarray(alpha), interpret=True))
    from moshi_tpu_torch.runtime.convert import params_from_numpy
    fields = {"fmt": fmt, "shape": (32, k)}
    for f in ("q", "d", "sc", "mn", "dmin", "es", "em"):
        a = getattr(qt, f)
        fields[f] = None if a is None else np.asarray(a)
    pqt = params_from_numpy({"w": fields}, device="cpu")["w"]
    a = None if alpha is None else torch.from_numpy(alpha)
    xt = torch.from_numpy(x)
    got = pm.dequant_matvec(xt, pqt, layer=1, alpha=a)
    scale = float(np.abs(ref).max())
    assert got.shape == ref.shape == (8, 32)
    assert float(np.abs(got.numpy() - ref).max()) / scale < _TOL_DQ
    # the control: the activation left in f32 (the kernels round it)
    qte = pqt.with_eff_scales()
    xn = xt if a is None else rms_pre_norm(xt, a[1])
    ctl = xn @ pm.dequantize_layer_bf16(qte, 1).float().T
    if fmt == "q4_k":
        em = pm.layer_rows(qte.em, 32, 1).float()
        ctl = ctl - xn.reshape(8, -1, 32).sum(-1) @ em.T
    assert float(np.abs(ctl.numpy() - ref).max()) / scale > 10 * _TOL_DQ
