"""K12, the int8 matvec's split-spread and k-segment forms, on the CPU.

* The plain versions (``int8_matvec_kseg_plain``,
  ``int8_matvec_split_plain`` in ``moshi_tpu_torch.quant.matmul_int8``)
  against the JAX package's ``qmatmul_i8`` in interpret mode under
  ``MOSHI_TPU_KSEG=1`` / ``MOSHI_TPU_SPLIT_SPREAD=1``, at K 5120 (a short
  last segment), 8192 (whole segments), 9216 (a last segment of one
  512-column chunk) and 11264 (the 7B linear_out: three segments, the
  last with 48 lo and 48 hi blocks), with and without the fused norm, at
  layers 0 and 1 of a stacked weight.  Both sides form the same int8
  activation and integer dots and differ only in the f32 order of the
  block terms' sums: readings at most 4.1e-7 of the output's largest
  value here, held to ``_TOL_SPLIT`` = 2e-6.  The control, the block
  scale formed as amax / 127 (the quotient, where XLA multiplies by
  f32(1/127)), moves roundings of the activation on an input built with
  ties (``_tie_input``): 1.1e-2 in both forms.
* ``kseg_ok`` / ``split_ok`` against ``_kseg_ok`` / ``_split_ok`` over
  eligible and ineligible weights; which form a call takes under each
  setting of the two knobs (the k-segment form first); the lane map
  against both ``_kseg_index`` and ``_pair_index``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.quant.formats as jf
import moshi_tpu.quant.pallas_matmul_int8 as jmi

from moshi_tpu_torch.quant import matmul_int8 as pmi
from tests.test_torch_quant import _port_qt, _rel, _stacked_qt

_TOL_SPLIT = 2e-6

_KNOBS = {"kseg": "MOSHI_TPU_KSEG", "split": "MOSHI_TPU_SPLIT_SPREAD"}
_PLAIN = {"kseg": "int8_matvec_kseg_plain",
          "split": "int8_matvec_split_plain"}


def _knob(monkeypatch, form):
    """Exactly one form's knob on (JAX reads it when it traces)."""
    for f, name in _KNOBS.items():
        monkeypatch.setenv(name, "1" if f == form else "0")
    jax.clear_caches()


def _weights(k, o=128, seed=11):
    rng = np.random.default_rng(seed)
    qt, fields = _stacked_qt(rng, "q4_k", (2,), o, k)
    return rng, qt, _port_qt(fields)


def _tie_input(rng, k):
    """A bf16 row on which the block scale's two roundings differ: each
    32-block's largest value is one whose quotient by 127 and product
    with f32(1/127) differ in the last bit, and 8 of its elements are
    +-half of it, so x / dx lands on or just off a .5 tie."""
    nb = k // 32
    cand = np.float32(1) + np.arange(128, dtype=np.float32) / 128
    cand = cand[cand / np.float32(127) != cand * (np.float32(1) /
                                                  np.float32(127))]
    amax = rng.choice(cand, nb)
    x = rng.uniform(-0.4, 0.4, (nb, 32)).astype(np.float32)
    x[:, 0] = amax
    x[:, 1:9] = amax[:, None] / 2 * rng.choice([-1.0, 1.0], (nb, 8))
    return torch.from_numpy(x.reshape(1, k)).to(torch.bfloat16)


def _jax(x, qt, layer, alpha):
    return np.asarray(jmi.qmatmul_i8(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), qt,
        layer=jnp.int32(layer),
        alpha=None if alpha is None else jnp.asarray(alpha.numpy()),
        interpret=True))


@pytest.mark.parametrize("form", ["kseg", "split"])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("k", [5120, 8192, 9216, 11264])
def test_split_forms_match_pallas(k, norm, form, monkeypatch):
    rng, qt, pqt = _weights(k)
    x = torch.from_numpy(rng.normal(0, 1, (1, k)).astype(np.float32)).to(
        torch.bfloat16)
    alpha = (torch.from_numpy(rng.normal(1, 0.1, (2, k)).astype(np.float32))
             if norm else None)
    _knob(monkeypatch, form)
    calls = []
    plain = getattr(pmi, _PLAIN[form])
    monkeypatch.setattr(pmi, _PLAIN[form],
                        lambda *a, **kw: (calls.append(1), plain(*a, **kw))[1])
    try:
        for layer in (0, 1):
            ref = _jax(x, qt, layer, alpha)
            got = pmi.qmatmul_i8(x, pqt, layer=layer, alpha=alpha)
            assert got.shape == ref.shape == (1, 128)
            assert _rel(got, ref) < _TOL_SPLIT, (layer, _rel(got, ref))
    finally:
        jax.clear_caches()
    assert len(calls) == 2


@pytest.mark.parametrize("form", ["kseg", "split"])
def test_split_control_fails_the_limit(form, monkeypatch):
    """On an input with ties the forms agree with JAX, and the block scale
    formed as a quotient moves the output by more than the limit."""
    rng, qt, pqt = _weights(11264, seed=12)
    x = _tie_input(rng, 11264)
    _knob(monkeypatch, form)
    try:
        ref = _jax(x, qt, 1, None)
    finally:
        jax.clear_caches()
    got = pmi.qmatmul_i8(x, pqt, layer=1)
    assert _rel(got, ref) < _TOL_SPLIT
    quantize = pmi.quantize_activation

    def quantize_by_quotient(xx, alpha=None):
        blocks = xx.float().reshape(tuple(xx.shape[:-1]) + (-1, 32))
        amax = blocks.abs().amax(dim=-1)
        dx = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                         torch.ones_like(amax))
        xq = torch.round(blocks / dx[..., None])
        return xq, dx, xq.sum(dim=-1) * dx

    monkeypatch.setattr(pmi, "quantize_activation", quantize_by_quotient)
    ctl = pmi.qmatmul_i8(x, pqt, layer=1)
    monkeypatch.setattr(pmi, "quantize_activation", quantize)
    assert _rel(ctl, ref) > _TOL_SPLIT


def _q4k_fake(o, k, dtype=np.uint8, fmt="q4_k"):
    q = np.zeros((2, 16), dtype)
    d = np.zeros((2, 1), np.float32)
    jqt = jf.QuantTensor(fmt, (o, k), jnp.asarray(q), jnp.asarray(d))
    pqt = pmi.QuantTensor(fmt, (o, k), torch.from_numpy(q),
                          torch.from_numpy(d))
    return jqt, pqt


# (fmt, K, storage, m, glu): the 7B linear_out and its neighbours
_ELIGIBILITY = [
    ("q4_k", 11264, np.uint8, 1, False),    # eligible: the 7B linear_out
    ("q4_k", 5120, np.uint8, 1, False),     # eligible: nb 160
    ("q4_k", 4096, np.uint8, 1, False),     # nb = 128, not over 128
    ("q4_k", 8448, np.uint8, 1, False),     # K/2 = 4224, not 512-aligned
    ("q4_k", 11264, np.uint8, 2, False),    # two rows
    ("q4_0", 11264, np.uint8, 1, False),    # q4_0
    ("q4_k", 11264, np.uint8, 1, True),     # GLU
    ("q4_k", 11264, np.int8, 1, False),     # unpacked storage
    ("q4_k", 11280, np.uint8, 1, False),    # K % 32 != 0
]


@pytest.mark.parametrize("fmt,k,dtype,m,glu", _ELIGIBILITY)
def test_eligibility_matches_jax(fmt, k, dtype, m, glu):
    jqt, pqt = _q4k_fake(4096, k, dtype, fmt)
    assert pmi.kseg_ok(pqt, m, glu) == jmi._kseg_ok(jqt, m, glu)
    assert pmi.split_ok(pqt, m, glu) == jmi._split_ok(jqt, m, glu)
    assert pmi.kseg_ok(pqt, m, glu) == pmi.split_ok(pqt, m, glu)


def test_eligibility_cases_cover_both_answers():
    seen = {pmi.kseg_ok(_q4k_fake(4096, k, dt, f)[1], m, g)
            for f, k, dt, m, g in _ELIGIBILITY}
    assert seen == {True, False}


@pytest.mark.parametrize("kseg,split,want", [
    ("0", "0", "int8_matvec_plain"), ("1", "0", "int8_matvec_kseg_plain"),
    ("0", "1", "int8_matvec_split_plain"),
    ("1", "1", "int8_matvec_kseg_plain")])
def test_knob_precedence(kseg, split, want, monkeypatch):
    """The k-segment form wins when both knobs are set, as in the JAX
    package; an ineligible weight keeps K1 under both."""
    monkeypatch.setenv("MOSHI_TPU_KSEG", kseg)
    monkeypatch.setenv("MOSHI_TPU_SPLIT_SPREAD", split)
    taken = []
    for name in ("int8_matvec_plain", "int8_matvec_kseg_plain",
                 "int8_matvec_split_plain"):
        fn = getattr(pmi, name)
        monkeypatch.setattr(pmi, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    rng, _, pqt = _weights(5120, o=64)
    x = torch.from_numpy(rng.normal(0, 1, (1, 5120)).astype(np.float32))
    pmi.qmatmul_i8(x, pqt, layer=0)
    _, _, narrow = _weights(4096, o=64)
    pmi.qmatmul_i8(x[:, :4096], narrow, layer=0)
    assert taken == [want, "int8_matvec_plain"]


@pytest.mark.parametrize("k", [5120, 8192, 9216, 11264])
def test_lane_map_matches_jax(k):
    """The k-segment and the pair-order maps of the JAX package are one
    map, the port's ``kseg_index``."""
    assert np.array_equal(pmi.kseg_index(k).numpy(), jmi._kseg_index(k))
    assert np.array_equal(pmi.kseg_index(k).numpy(), jmi._pair_index(k))
    # every block on exactly one lane
    idx = pmi.kseg_index(k)
    assert sorted(idx[idx >= 0].tolist()) == list(range(k // 32))


def test_split_launch_raises_without_a_toolchain():
    """No fallback: a call that would launch K12 builds it, and without
    nvcc the build raises instead of running the plain version."""
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    _, _, pqt = _weights(5120, o=64)
    x = torch.zeros((1, 5120))
    with pytest.raises(RuntimeError, match="nvcc"):
        pmi._launch_split(x, pqt.with_eff_scales(), 0, None, 64, "kseg")


def _misaligned(t):
    """A copy of ``t`` whose data starts 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    off = 1 + (-buf.data_ptr() // t.element_size()) % 8
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 2
    return out


@pytest.mark.parametrize("fault", ["es misaligned", "em misaligned",
                                   "q unpacked int8", "q int16"])
def test_split_launch_checks_operands_before_building(fault, monkeypatch):
    """The one-launch wrapper checks its weight through ``_weight_operands``
    (the 16-byte alignment of es/em, which the kernel copies 16 bytes at
    a time, and q's dtype) and takes packed q4_k alone: each fault raises
    before any library is built or loaded."""
    import dataclasses

    from moshi_tpu_torch.kernels import build

    def no_build(*a, **kw):
        raise AssertionError("a library was asked for")

    monkeypatch.setattr(build, "entry", no_build)
    monkeypatch.setattr(build, "load", no_build)
    _, _, pqt = _weights(5120, o=64)
    qt = pqt.with_eff_scales()
    if fault == "es misaligned":
        qt = dataclasses.replace(qt, es=_misaligned(qt.es))
        match = "scale must be 16-byte aligned"
    elif fault == "em misaligned":
        qt = dataclasses.replace(qt, em=_misaligned(qt.em))
        match = "min must be 16-byte aligned"
    elif fault == "q unpacked int8":
        qt = qt.with_i8_storage()
        match = "packed q4_k"
    else:
        qt = dataclasses.replace(qt, q=qt.q.to(torch.int16))
        match = "dtype torch.int16"
    x = torch.zeros((1, 5120))
    for form in ("kseg", "split"):
        with pytest.raises(ValueError, match=match):
            pmi._launch_split(x, qt, 0, None, 64, form)
