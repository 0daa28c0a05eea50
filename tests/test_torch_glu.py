"""K7's and K8's plain versions (``moshi_tpu_torch/quant/matmul.py``
``glu_matmul`` / ``glu_matvec`` on the CPU) against the Pallas
``glu_matmul_pallas`` / ``glu_matmul_pallas_stacked`` in interpret mode,
where the CUDA kernel (``csrc/glu_matvec.cu`` on ``dequant_tile.cuh``)
branches: walked widths that are not a multiple of 512 (q8_0 at K = 4224,
q4_k at K = 8448 with the norm), H = 128 at 8 and 12 rows (one and two
row groups), activations and norm in bf16, and gates past |g| = 90, where
exp(-g) overflows or underflows.  The limit is ``_TOL_K68``, each case
held against the gate rounded to bf16 before the silu (>= 10x the limit).

With the norm fused, the two sides' f32 norms differ in their last bits
(JAX's mean and rsqrt against PyTorch's), and at these widths that flips
the bf16 rounding of an activation or two, which moves an output by about
2e-4 of the largest: a rounding of another f32 value, not of another
function.  So there the Pallas kernel takes the activation the port
normed, as its unnormed input (the same arithmetic from there on), and the
norm itself is held apart against JAX's to f32 rounding.

And one check that ``dequant_ab.py``'s shapes cover every K7 and K8
product that ``chip_smoke.py`` times, so that its bit-identity rounds miss
no GLU the pools launch.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.quant.pallas_matmul import (glu_matmul_pallas,
                                           glu_matmul_pallas_stacked)

from moshi_tpu_torch.models.lm import LMConfig
from moshi_tpu_torch.quant import formats as pf
from moshi_tpu_torch.quant import matmul as pm
from moshi_tpu_torch.runtime import synth
from tests.test_torch_quant import _TOL_K68, _port_qt, _rel, _stacked_qt

_H = 128
_SATURATE = 64.0    # activations times this: |g| well past 90
# (fmt, K, norm, dtype of x and alpha, activation scale)
_CASES = [
    ("q8_0", 4224, False, np.float32, 1.0),   # walked width 8 steps + 128
    ("q4_k", 8448, True, np.float32, 1.0),    # walked width 4224
    ("q4_k", 1024, True, "bf16", 1.0),
    ("q8_0", 1024, True, "bf16", 1.0),
    ("q4_k", 1024, False, np.float32, _SATURATE),
]


def _both(a, dtype):
    """One numpy array as the JAX and the port operand, rounded to bf16 on
    both sides where asked (round to nearest even on both)."""
    if a is None:
        return None, None
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("m", [8, 12])
@pytest.mark.parametrize("kernel", ["K7", "K8"])
@pytest.mark.parametrize("fmt,k,norm,dtype,scale", _CASES)
def test_glu_plain_matches_pallas_where_the_kernel_branches(
        fmt, k, norm, dtype, scale, kernel, m):
    rng = np.random.default_rng(30)
    stacked = kernel == "K8"
    layer = 1
    qt, fields = _stacked_qt(rng, fmt, (2,) if stacked else (), 2 * _H, k)
    x = (rng.normal(0, 1, (m, k)) * scale).astype(np.float32)
    alpha = (rng.normal(1, 0.1, ((2, k) if stacked else (k,)))
             .astype(np.float32) if norm else None)
    jx, px = _both(x, dtype)
    ja, pa = _both(alpha, dtype)
    pqt = _port_qt(fields)
    if not stacked:
        layer = 0
    if norm:
        # the port's norm against JAX's (_maybe_norm's arithmetic), then
        # the Pallas kernel on the activation the port normed
        a_row = pa[layer] if stacked else pa
        xn = pf.rms_pre_norm(px, a_row)
        xf = jx.astype(jnp.float32)
        jn = np.asarray(xf * jax.lax.rsqrt(
            jnp.mean(xf * xf, axis=-1, keepdims=True) + 1e-8)
            * jnp.asarray(a_row.float().numpy()))
        assert _rel(xn, jn) < 1e-6
        jx = jnp.asarray(xn.numpy())
    if stacked:
        ref = glu_matmul_pallas_stacked(jx, qt, jnp.int32(layer),
                                        interpret=True)
        got = pm.glu_matvec(px, pqt, layer=layer, alpha=pa)
        gv = pm.dequant_matvec(px, pqt, layer=layer, alpha=pa)
    else:
        ref = glu_matmul_pallas(jx, qt, interpret=True)
        got = pm.glu_matmul(px, pqt, alpha=pa)
        gv = pm._dequant_product(px, pqt.with_eff_scales(), 0, pa)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (m, _H)
    assert np.isfinite(ref).all() and torch.isfinite(got).all()
    assert _rel(got, ref) < _TOL_K68
    if scale == _SATURATE:
        gate = gv[:, :_H]
        assert (gate > 90).any() and (gate < -90).any()
    # the control: the gate rounded to bf16 before the silu
    ctl = pm._silu(gv[:, :_H].to(torch.bfloat16).float()) * gv[:, _H:]
    assert _rel(ctl, ref) > 10 * _TOL_K68


def _load(name):
    """A script at the root of the repository, as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta_params(cfg):
    """A parameter tree of ``cfg`` at its full widths on the meta device
    (shapes only), quantized as ``synth_lm_params`` quantizes."""
    def make(name, shape):
        fmt = (synth.choose_format(name, shape[-2:], "q4_k")
               if len(shape) >= 2 else None)
        if fmt:
            return synth.synth_quant_tensor(fmt, shape[:-2], shape[-2],
                                            shape[-1], None, "meta")
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in tree.items()}
        return make(path, tree)

    return walk(synth.lm_param_shapes(cfg), "")


def test_dequant_ab_covers_every_timed_glu():
    """Every K8 product of the STS and TTS pools' lists and the K7 GLU of
    ``_tts_products`` (kernel, 2H, K, format, norm, activation dtype) is
    one of ``dequant_ab.SHAPES``."""
    chip_smoke, dequant_ab = _load("chip_smoke"), _load("dequant_ab")
    cfg = LMConfig(delays=chip_smoke._7B_DELAYS)
    params = _meta_params(cfg)
    tcfg = chip_smoke.tts_config()
    tparams = _meta_params(tcfg)
    timed = set()
    for cases in (chip_smoke.pool_matvec_cases(params, cfg),
                  chip_smoke.tts_pool_matvec_cases(tparams, tcfg)):
        for _, kernel, qt, _, xdt, alpha, _ in cases:
            if kernel == "glu_matvec":
                timed.add(("K8", qt.q.shape[-2], qt.shape[-1], qt.fmt,
                           alpha is not None, xdt))
    for _, qt, _, alpha, glu in chip_smoke._tts_products(tparams, tcfg):
        if glu:      # check_k7 times it with f32 activations
            timed.add(("K7", qt.q.shape[-2], qt.shape[-1], qt.fmt,
                       alpha is not None, torch.float32))
    assert {t[0] for t in timed} == {"K7", "K8"} and len(timed) == 3
    shapes = {(kernel, o, k, fmt, norm, xdt)
              for kernel, _, o, k, fmt, norm, xdt, _ in dequant_ab.SHAPES}
    assert timed <= shapes
