"""K13 on fp8 flat rings (``LMConfig.kv_dtype = "float8_e4m3fn"`` under
``MOSHI_TPU_MEGAKERNEL``) in the port against the JAX package, on the
CPU.

* 20 steps of ``_forward_megakernel`` on fp8 flat rings at the geometry
  of ``tests/test_pallas_temporal.py`` (dim 256, 4 heads, 2 layers,
  context 16, so the ring wraps) against JAX's in interpret mode: the
  outputs within ``test_torch_temporal``'s limit, and the rings by
  ``test_torch_fp8``'s flip rule (each element the rule's cast of the
  port's f32 row, equal to JAX's but for flips at ties), with its
  control.
* K13's plain version on an fp8 ring against itself on the ring widened
  to bf16 (exact): the same h, bit for bit; the rows it returns against
  JAX's on a probe whose rows pass 464 (NaN in the same places, where
  PyTorch's own cast saturates).
* The whole ``lm_gen_step`` under ``all`` on fp8 rings against JAX's over
  22 frames (``test_torch_megakernel``'s limits and token rule).

Inputs are seeded numpy draws handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fp8 as tf8
import test_torch_megakernel as tmk
import test_torch_temporal as tt
from moshi_tpu.models.lm import LMConfig as JaxLMConfig
from moshi_tpu.nn import pallas_temporal as jax_temporal
from moshi_tpu.nn import transformer as jax_tr
from moshi_tpu.utils.pallas_mode import pallas_interpret

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.models import lm as port_lm
from moshi_tpu_torch.nn import ring as port_ring
from moshi_tpu_torch.nn import temporal as port_temporal
from moshi_tpu_torch.nn import transformer as port_tr
from moshi_tpu_torch.nn.rope import rope_angles
from moshi_tpu_torch.runtime.convert import tensor_from_numpy

FP8 = "float8_e4m3fn"
_KW = dict(tt._KW, kv_dtype=FP8)

tparams = tt.tparams      # the module's q4_k transformer params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread
    hand-offs than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RUN = {}


def _wrap_run(tparams):
    """20 steps of both packages' ``_forward_megakernel`` on fp8 flat
    rings, with the f32 rows the port's plain version cast for its ring
    replayed into an f32 shadow of each ring; made once per module."""
    if _RUN:
        return _RUN
    p, pp = tparams
    jcfg = JaxLMConfig(**_KW).transformer
    pcfg = port_lm.LMConfig(**_KW).transformer
    j_state = jax_tr.init_transformer_state(jcfg, 1, flat=True)
    p_state = port_tr.init_transformer_state(pcfg, 1, "cpu", flat=True)
    assert p_state["k"].dtype == torch.float8_e4m3fn
    assert j_state["k"].dtype == jnp.float8_e4m3fn
    shadow = {"k": torch.zeros(p_state["k"].shape),
              "v": torch.zeros(p_state["v"].shape)}
    cast = port_temporal.to_ring_dtype
    written = []

    def record(x, dtype):
        written.append(x.float().clone())
        return cast(x, dtype)

    rng = np.random.default_rng(7)
    errs = []
    port_temporal.to_ring_dtype = record
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MOSHI_TPU_MEGAKERNEL", "temporal")
            for step in range(tt._STEPS):
                x = rng.standard_normal((1, 1, 256)).astype(np.float32)
                with pallas_interpret():
                    y_ref, j_state = jax_tr._forward_megakernel(
                        jcfg, p, j_state, jnp.asarray(x),
                        jnp.full((1,), step, jnp.int32))
                written.clear()
                y, p_state = port_tr.transformer_forward(
                    pcfg, pp, p_state, torch.from_numpy(x),
                    torch.full((1,), step, dtype=torch.int32))
                # k then v for each layer, written at slot step % cap
                for li in range(pcfg.num_layers):
                    for j, name in enumerate("kv"):
                        shadow[name][li, step % pcfg.mha.cap] = \
                            written[2 * li + j]
                errs.append(tt._rel(y.numpy(), y_ref))
    finally:
        port_temporal.to_ring_dtype = cast
    _RUN.update(errs=errs, port=p_state, jax=j_state, shadow=shadow)
    return _RUN


def test_k13_fp8_forward_matches_pallas_through_a_ring_wrap(tparams):
    r = _wrap_run(tparams)
    assert max(r["errs"]) < tt._TOL, r["errs"]


@pytest.mark.parametrize("name", ["k", "v"])
def test_k13_fp8_rings_match_jax_by_the_flip_rule(tparams, name):
    """The port's fp8 flat ring is its f32 rows cast by the rule, bit for
    bit, and equals JAX's but for flips at ties; rows rounded to bf16
    first (a double rounding) flip more elements than the rule allows."""
    r = _wrap_run(tparams)
    cap = tt._KW["context"]           # the written slots; the pad stays 0
    ring, shadow = r["port"][name], r["shadow"][name]
    assert ring.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tf8._tbits(ring),
                                  tf8._tbits(port_ring.fp8_cast(shadow)))
    ring, shadow = ring[:, :cap], shadow[:, :cap]
    flips, n, _ = tf8._flips(tf8._tbits(ring),
                             tf8._f8_bits(r["jax"][name][:, :cap]),
                             shadow.numpy())
    assert flips <= n * tf8._FLIPS, (flips, n)
    twice = tf8._tbits(port_ring.fp8_cast(shadow.to(torch.bfloat16)))
    assert (twice != tf8._tbits(ring)).sum() > n * tf8._FLIPS


def _fp8_ring_args(tparams, seed, alpha_scale=1.0, layers=2):
    """JAX's and the port's arguments for one K13 step on a prefilled fp8
    flat ring of 600 slots at offset 700 (two chunks, the second cut at
    cap) over the first ``layers`` layers, norm1 scaled by
    ``alpha_scale``."""
    p, pp = tparams
    h, kc, vc = tt._prefilled(600, 700, seed)
    kc8 = kc[:layers].astype(jnp.float8_e4m3fn)
    vc8 = vc[:layers].astype(jnp.float8_e4m3fn)
    cos, sin = tt.jax_rope_angles(jnp.asarray([700], jnp.int32), 64,
                                  10_000.0)
    jw = {k: jax.tree_util.tree_map(lambda a: a[:layers], v)
          for k, v in tt._weights(p["layers"]).items()}
    pw = {k: v._map(lambda a: a[:layers]) if hasattr(v, "_map")
          else v[:layers] for k, v in tt._weights(pp["layers"]).items()}
    if alpha_scale != 1.0:       # the same bf16 bits on both sides
        n1 = (np.asarray(jw["n1"], np.float32) * alpha_scale).astype(
            jnp.bfloat16)
        jw = dict(jw, n1=jnp.asarray(n1))
        pw = dict(pw, n1=tensor_from_numpy(n1, "cpu"))
    kw = dict(cap=600, context=600, heads=4, hidden=256, nlayers=layers)
    jargs = (jnp.asarray(h), jnp.asarray(kc8), jnp.asarray(vc8),
             jnp.int32(700), (cos, sin), jw)
    pargs = (torch.from_numpy(h), tf8._t8(kc8), tf8._t8(vc8),
             torch.tensor(700, dtype=torch.int32),
             rope_angles(torch.tensor([700]), 64), pw)
    return jargs, pargs, kw


def test_k13_fp8_equals_bf16_on_the_rings_widened(tparams):
    """Widening an fp8 ring to bf16 is exact, so K13's plain version gives
    the same h on the fp8 ring and on its bf16 widening, bit for bit, and
    the Pallas kernel's within K13's frame limit (``test_torch_megakernel``
    ``_H_TOL``, controls 2.5e-5 and above): on this draw the two packages'
    last bits flip one bf16 activation rounding in the second layer
    (2.9e-6; 9.4e-8 over the first layer alone, as on other draws)."""
    jargs, pargs, kw = _fp8_ring_args(tparams, seed=1)
    build.COUNTS.clear()
    h8, k8, v8 = port_temporal.temporal_full_step(*pargs, **kw)
    wide = (pargs[0], pargs[1].to(torch.bfloat16),
            pargs[2].to(torch.bfloat16)) + pargs[3:]
    h16, k16, _ = port_temporal.temporal_full_step(*wide, **kw)
    assert torch.equal(h8, h16)
    assert k8.dtype == torch.float8_e4m3fn and k16.dtype == torch.bfloat16
    with pallas_interpret():
        ref = jax_temporal.temporal_full_step(*jargs, **kw)
    assert tt._rel(h8.numpy(), np.asarray(ref[0])) < tmk._H_TOL
    assert not build.COUNTS     # the CPU runs the plain version


def test_k13_fp8_rows_follow_the_reference_cast(tparams):
    """With norm1 scaled so that the qkv rows pass 464, the rows K13
    returns on fp8 rings are NaN exactly where JAX's are (XLA's convert),
    and equal elsewhere but for flips at ties; PyTorch's own cast
    (saturating at 448) would differ on every such element."""
    jargs, pargs, kw = _fp8_ring_args(tparams, seed=2, alpha_scale=3e5,
                                      layers=1)
    with pallas_interpret():
        ref = jax_temporal.temporal_full_step(*jargs, **kw)
    _, k8, v8 = port_temporal.temporal_full_step(*pargs, **kw)
    for got, want in ((k8, ref[1]), (v8, ref[2])):
        gb, wb = tf8._tbits(got), tf8._f8_bits(want)
        nan = np.isnan(np.asarray(want).astype(np.float32))
        assert nan.sum() > 10
        np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan)
        # a flip at a tie moves a value to the next e4m3 step: 1 in bits
        close = np.abs(gb.astype(np.int16) - wb.astype(np.int16)) <= 1
        assert np.all(close | nan)
        assert (gb != wb).sum() <= max(2, gb.size * tf8._FLIPS)
    big = torch.full((4,), 500.0)
    assert torch.isnan(port_ring.fp8_cast(big).float()).all()
    assert not torch.isnan(big.to(torch.float8_e4m3fn).float()).any()


@pytest.fixture
def fp8_case(monkeypatch):
    """``test_torch_megakernel``'s "all" case on fp8 rings."""
    monkeypatch.setitem(tmk._CASES, "all-fp8",
                        ("all", dict(kv_dtype=FP8)))
    return "all-fp8"


def test_lm_step_under_all_on_fp8_rings_matches_jax(fp8_case):
    """22 frames of ``lm_gen_step`` under ``all`` (K13 on fp8 flat rings,
    K14c) at temp 0 against JAX's: transformer_out within K13's limit, the
    decided tokens and the delay cache's outputs equal, one K13 call per
    frame; the state's rings are fp8."""
    tmk.check_lm_step(fp8_case, "greedy")
    ref, got, cfg, calls = tmk._runs(fp8_case, "greedy")
    assert cfg.transformer.kv_dtype == torch.float8_e4m3fn
    assert ref["state0"]["transformer"]["k"].dtype == jnp.float8_e4m3fn
