"""The int8 routing (MOSHI_TPU_INT8, MOSHI_TPU_INT8_MAX_M) and K1 at up to
8 activation rows, on the CPU.

* ``formats.int8_dispatch`` against the JAX package's ``_int8_dispatch``
  on the same weights, row counts and knobs; and the products that follow
  it (``qmatmul``, ``glu_matmul_stacked``, the generic GLU of
  ``gating_mlp`` and the fusion's ``fuse_mid_ok``) take the kernel the JAX
  package takes, with the same result.
* K1's plain version at m = 2 and 8 rows against ``qmatmul_i8`` /
  ``glu_matmul_i8`` in interpret mode: each row is normed and quantized
  on its own, so the products are the same integer dots and the rows
  differ from JAX's only in the order of their f32 scale sums (<= 5.2e-7
  of the row's largest value here), unless a last-bit difference in the
  fused norm flips an activation's rounding.  The limit is K1's one-row
  test's (``test_torch_quant.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moshi_tpu.quant.formats as jf
import moshi_tpu.quant.pallas_matmul as jpm
from moshi_tpu.quant.pallas_fused import can_fuse_mid as jax_can_fuse_mid
from moshi_tpu.quant.pallas_matmul_int8 import glu_matmul_i8, qmatmul_i8
from moshi_tpu.quant.pallas_matmul_int8 import \
    int8_shape_ok as jax_int8_shape_ok
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.nn import gating as port_gating
from moshi_tpu_torch.quant import formats as pf
from moshi_tpu_torch.quant import fused as pfused
from moshi_tpu_torch.quant import matmul as pm
from moshi_tpu_torch.quant import matmul_int8 as pmi
from tests.test_torch_quant import _TOL_I8, _port_qt, _rel, _stacked_qt


@pytest.fixture
def int8_knob():
    """Set the int8 switch in both packages; restored afterwards."""
    before = (pf.int8_enabled(), jpm.int8_enabled())

    def set_both(flag):
        pf.set_int8(flag)
        jpm.set_int8(flag)

    yield set_both
    pf.set_int8(before[0])
    jpm.set_int8(before[1])


def _fake_qt(fmt, o, k, dtype=np.uint8):
    """A weight of declared shape [o, k] whose routing is all that is
    asked (the rule reads the format, the shape and the storage dtype)."""
    q = np.zeros((2, 16), dtype)
    d = np.zeros((2, 1), np.float32)
    jqt = jf.QuantTensor(fmt, (o, k), jnp.asarray(q), jnp.asarray(d))
    pqt = pf.QuantTensor(fmt, (o, k), torch.from_numpy(q),
                         torch.from_numpy(d))
    return jqt, pqt


_ROUTED = [("q4_k", 6144, 2048), ("q4_0", 1024, 4224), ("q8_0", 512, 256),
           ("q4_k", 2048, 8448), ("q4_k", 4096, 11264), ("q4_0", 64, 48)]


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("max_m", [None, "1", "4", "8"])
def test_int8_dispatch_matches_jax(int8, max_m, int8_knob, monkeypatch):
    """Every weight at every row count 1..9 under both knobs: the same
    decision (the 18 MiB spread cap refuses K = 11264 above m = 4, and
    nothing passes m = 8)."""
    if max_m is None:
        monkeypatch.delenv("MOSHI_TPU_INT8_MAX_M", raising=False)
    else:
        monkeypatch.setenv("MOSHI_TPU_INT8_MAX_M", max_m)
    int8_knob(int8)
    seen = set()
    for fmt, o, k in _ROUTED:
        jqt, pqt = _fake_qt(fmt, o, k)
        for m in range(1, 10):
            want = jpm._int8_dispatch(jqt, m)
            assert pf.int8_dispatch(pqt, m) == want, (fmt, o, k, m)
            seen.add(want)
    assert seen == ({True, False} if int8 else {False})


def test_unpacked_storage_stays_one_row(monkeypatch):
    """4-bit weights stored unpacked (int8 values) take the int8 kernels
    at one row only, in both packages."""
    monkeypatch.setenv("MOSHI_TPU_INT8_MAX_M", "8")
    jqt, pqt = _fake_qt("q4_k", 512, 256, np.int8)
    for m in (1, 2, 8):
        assert pf.int8_shape_ok(pqt, m) == jax_int8_shape_ok(jqt, m)
        assert pf.int8_dispatch(pqt, m) == jpm._int8_dispatch(jqt, m) == \
            (m == 1)


@pytest.mark.parametrize("value,want", [("1", True), ("0", False),
                                        ("2", None), ("on", None)])
def test_int8_env_is_read_as_jax_reads_it(value, want, monkeypatch):
    monkeypatch.setenv("MOSHI_TPU_INT8", value)
    if want is None:
        with pytest.raises(ValueError, match="MOSHI_TPU_INT8"):
            pf._int8_from_env()
    else:
        assert pf._int8_from_env() is want


def _spy(monkeypatch, module, name, hits):
    fn = getattr(module, name)

    def counted(*a, **kw):
        hits.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("int8,max_m,m", [
    (True, "1", 1), (True, "1", 2), (True, "8", 2), (True, "8", 8),
    (False, "8", 1), (False, "1", 3)])
def test_products_route_and_match_jax(int8, max_m, m, int8_knob,
                                      monkeypatch):
    """qmatmul (a flat weight), glu_matmul_stacked (a layer of a stacked
    one), the generic GLU and fuse_mid_ok take the kernel JAX's routing
    names, and qmatmul gives JAX's result (its Pallas kernels in
    interpret mode)."""
    monkeypatch.setenv("MOSHI_TPU_INT8_MAX_M", max_m)
    int8_knob(int8)
    rng = np.random.default_rng(7)
    jw, fw = _stacked_qt(rng, "q4_k", (), 256, 256)
    jg, fg = _stacked_qt(rng, "q4_k", (2,), 512, 256)
    w, g = _port_qt(fw), _port_qt(fg)
    x = rng.normal(0, 1, (m, 256)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (256,)).astype(np.float32)
    xt = torch.from_numpy(x)
    want_i8 = jpm._int8_dispatch(jw, m)
    hits = []
    for name in ("qmatmul_i8", "glu_matmul_i8"):
        _spy(monkeypatch, pmi, name, hits)
    for name in ("qmatmul_dequant", "glu_matvec"):
        _spy(monkeypatch, pm, name, hits)
    monkeypatch.setattr(pm, "qmatmul_i8", pmi.qmatmul_i8)
    monkeypatch.setattr(pm, "glu_matmul_i8", pmi.glu_matmul_i8)
    monkeypatch.setattr(port_gating, "glu_matmul_i8", pmi.glu_matmul_i8)
    _spy(monkeypatch, port_gating, "glu_matmul", hits)

    got = pf.qmatmul(xt, w)
    pm.glu_matmul_stacked(xt, g, layer=1)
    port_gating.gating_mlp(
        {"linear_in": {"weight": g._map(lambda a: a[0])},
         "linear_out": {"weight": w}}, xt[None],
        pre_norm_alpha=torch.from_numpy(alpha))
    i8 = "qmatmul_i8" if want_i8 else "qmatmul_dequant"
    glu_i8 = "glu_matmul_i8" if want_i8 else "glu_matvec"
    flat_glu = "glu_matmul_i8" if want_i8 else "glu_matmul"
    lout = "qmatmul_i8" if want_i8 else "qmatmul_dequant"
    assert hits == [i8, glu_i8, flat_glu, lout]
    jf.enable_pallas(True)
    jax.clear_caches()   # the JAX package reads the knobs when it traces
    try:
        with pallas_interpret():
            ref = np.asarray(jf.qmatmul(jnp.asarray(x), jw))
    finally:
        jf.enable_pallas(False)
    assert _rel(got, ref) < (_TOL_I8 if want_i8 else 1e-5)
    # the fusion: both weights must route to the int8 kernels
    jo, fo = _stacked_qt(rng, "q4_k", (2,), 256, 256)
    want_fuse = (jpm._int8_dispatch(jo, m) and jpm._int8_dispatch(jg, m)
                 and jax_can_fuse_mid(jo, jg, m))
    assert pfused.fuse_mid_ok(_port_qt(fo), g, m) == want_fuse
    assert want_fuse == (int8 and m == 1)


@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("fmt,k,norm,glu", [
    ("q4_k", 512, True, False), ("q4_k", 256, True, True),
    ("q4_0", 512, False, False), ("q8_0", 256, True, True),
    ("q8_0", 512, False, False)])
def test_k1_rows_plain_matches_pallas(m, fmt, k, norm, glu):
    rng = np.random.default_rng(8)
    qt, fields = _stacked_qt(rng, fmt, (2,), 128, k)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (2, k)).astype(np.float32) if norm else None
    fn = glu_matmul_i8 if glu else qmatmul_i8
    ref = np.asarray(fn(jnp.asarray(x), qt, layer=jnp.int32(1),
                        alpha=None if alpha is None else jnp.asarray(alpha),
                        interpret=True))
    port_fn = pmi.glu_matmul_i8 if glu else pmi.qmatmul_i8
    got = port_fn(torch.from_numpy(x), _port_qt(fields), layer=1,
                  alpha=None if alpha is None else torch.from_numpy(alpha))
    assert got.shape == ref.shape == (m, 64 if glu else 128)
    assert _rel(got, ref) < _TOL_I8
    # each row is the one-row product of that row
    for r in (0, m - 1):
        one = port_fn(torch.from_numpy(x[r:r + 1]), _port_qt(fields),
                      layer=1,
                      alpha=None if alpha is None
                      else torch.from_numpy(alpha))
        torch.testing.assert_close(got[r], one[0], rtol=0, atol=0)


def test_k1_takes_at_most_eight_rows():
    rng = np.random.default_rng(9)
    _, fields = _stacked_qt(rng, "q4_k", (), 64, 256)
    with pytest.raises(ValueError, match="1 to 8"):
        pmi.qmatmul_i8(torch.zeros((9, 256)), _port_qt(fields))
