"""The port's host quantizers and the q8_r product against the JAX
package's, on the CPU.

* ``quant/formats.py`` ``quantize(..., native=False)``: the numpy
  quantizers, every field bit for bit against JAX's
  ``quantize(..., native=False)``, in q8_0, q4_0, q4_k and q8_r, on f32
  weights and on bf16-valued ones (where a block's products land on
  exact ties).
* The native path (``native_quant.py``: ``native/quant.cpp`` built at
  first use) against the JAX package's native path, bit for bit, and
  against numpy: equal but at exact ties, where it rounds half away from
  zero and numpy half to even.
* q8_r: ``int8_mm`` exact in int32 where an f32 sum is not (K = 4096 at
  127 x 127); ``qmatmul`` on a q8_r weight equal to JAX's in f32, bit for
  bit (with the fused rms pre-norm within 1e-6: its f32 mean and rsqrt
  round apart by an ulp); ``dequantize``.
* A failing build raises; numpy is taken only when asked for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.quant import formats as jf

from moshi_tpu_torch import native_quant
from moshi_tpu_torch.quant import formats as pf

_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


def _bits(a):
    """A JAX or torch array as comparable numpy bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_qt(jqt, pqt):
    assert jqt.fmt == pqt.fmt and tuple(jqt.shape) == tuple(pqt.shape)
    for f in _FIELDS:
        a, b = getattr(jqt, f), getattr(pqt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            ja, pb = _bits(a), _bits(b)
            assert ja.dtype == pb.dtype, (f, ja.dtype, pb.dtype)
            np.testing.assert_array_equal(ja, pb, err_msg=f)


def _weights(kind, shape=(256, 1024), seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if kind == "bf16":
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    return w


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q8_r"])
def test_numpy_quantize_matches_jax(fmt, kind):
    w = _weights(kind)
    assert_same_qt(jf.quantize(w, fmt, native=False),
                   pf.quantize(w, fmt, native=False, device="cpu"))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k"])
def test_native_quantize_matches_jax_native(fmt, kind):
    from moshi_tpu.native_quant import available
    # the JAX package falls back to numpy when its library does not load:
    # the comparison would then not be native against native
    assert available()
    w = _weights(kind, seed=1)
    assert_same_qt(jf.quantize(w, fmt, native=True),
                   pf.quantize(w, fmt, device="cpu"))


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_native_differs_from_numpy_only_at_ties(fmt):
    """bf16-valued weights put many block products on exact ties: there
    the native quantizer rounds half away from zero, numpy half to even;
    everywhere else (and in every scale) they agree."""
    w = _weights("bf16", (512, 1024), seed=2)
    nat = pf.quantize(w, fmt, device="cpu")
    ref = pf.quantize(w, fmt, native=False, device="cpu")
    np.testing.assert_array_equal(_bits(nat.d), _bits(ref.d))
    o, i = w.shape
    d = nat.d.float().numpy()
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0) \
        if fmt == "q8_0" else \
        np.where(np.abs(d) > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    x = (w.reshape(o, i // 32, 32) * inv.astype(np.float32)[..., None])
    x = x.reshape(o, i)
    x64 = x.astype(np.float64)                # x +- 0.5 exact in f64
    away = np.sign(x64) * np.floor(np.abs(x64) + 0.5)
    if fmt == "q8_0":
        q_nat = nat.q.numpy().astype(np.int32)
        q_ref = ref.q.numpy().astype(np.int32)
        expect = np.clip(away, -127, 127)
    else:
        q_nat = torch.cat([nat.q & 15, nat.q >> 4], -1).numpy().astype(
            np.int32)
        q_ref = torch.cat([ref.q & 15, ref.q >> 4], -1).numpy().astype(
            np.int32)
        expect = np.clip(away + 8, 0, 15)
    tie = np.abs(x - np.trunc(x)) == 0.5
    assert tie.sum() > 100                    # the data does hold ties
    np.testing.assert_array_equal(q_nat, expect)
    np.testing.assert_array_equal(q_nat[~tie], q_ref[~tie])
    assert (q_nat != q_ref).sum() > 0


def test_native_q4_k_within_the_format_of_numpy():
    """q4_k: the same fit, other roundings; the JAX package's own bound
    (mean |native - numpy| / mean |w| < 0.02) on the dequantized
    weights."""
    w = _weights("bf16", (256, 1024), seed=3)
    a = pf.dequantize(pf.quantize(w, "q4_k", device="cpu"), torch.float32)
    b = pf.dequantize(pf.quantize(w, "q4_k", native=False, device="cpu"),
                      torch.float32)
    assert float((a - b).abs().mean()) / float(np.abs(w).mean()) < 0.02


def test_int8_mm_is_exact_where_f32_is_not():
    k = 4096
    a = torch.full((3, k), 127, dtype=torch.int8)
    a[1, ::2] = -127
    b = torch.full((k, 16), 127, dtype=torch.int8)
    b[5, 0] = 126                       # a sum past 2^24 that f32 rounds
    got = pf.int8_mm(a, b)
    ref = a.long() @ b.long()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    f32 = (a.float() @ b.float()).double()
    assert not torch.equal(f32, ref.double())   # f32 would not have held


@pytest.mark.parametrize("shape", [(3, 512), (2, 5, 512)])
@pytest.mark.parametrize("norm", [False, True])
def test_q8r_qmatmul_matches_jax(shape, norm):
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((384, 512)) * 0.05).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    alpha = rng.normal(1, 0.1, (512,)).astype(np.float32) if norm else None
    jqt = jf.quantize(w, "q8_r")
    pqt = pf.quantize(w, "q8_r", device="cpu")
    assert_same_qt(jqt, pqt)
    ref = np.asarray(jf.qmatmul(jnp.asarray(x), jqt,
                                pre_norm_alpha=None if alpha is None
                                else jnp.asarray(alpha)))
    got = pf.qmatmul(torch.from_numpy(x), pqt,
                     pre_norm_alpha=None if alpha is None
                     else torch.from_numpy(alpha))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if norm:
        # the pre-norm's mean and rsqrt round apart in the last bit of f32
        # (XLA's and PyTorch's), which moves the activation scale by an
        # ulp: 2.9e-7 relative here
        err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
        assert err < 1e-6, err
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        pf.dequantize(pqt, torch.float32).numpy(),
        np.asarray(jf.dequantize(jqt, jnp.float32)))


def test_failed_build_raises_and_numpy_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(native_quant, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_quant, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    w = _weights("f32", (256, 256))
    with pytest.raises(RuntimeError, match="failed to build"):
        pf.quantize(w, "q4_k", device="cpu")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        pf.quantize(w, "q8_0", device="cpu")
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())
    qt = pf.quantize(w, "q4_k", native=False, device="cpu")
    assert qt.fmt == "q4_k" and qt.es is not None

