"""K10, the stacked decode attention's MXU form, on the CPU.

K10's plain version (``decode_attention_mxu_plain``, taken by
``moshi_tpu_torch.nn.decode_attention.decode_attention_stacked`` on CPU
tensors under ``MOSHI_TPU_ATTN_MXU=1``) against the JAX package's
``decode_attention_stacked`` in interpret mode under the same knob (read
when JAX traces, so its caches are cleared between settings): the cases
of ``test_pallas_attn_mxu.py`` (B 2, H 4, hd 128, cap 16 and 240 at
several offsets and contexts), a 1000-slot ring where the two kernels'
chunks differ (K10 200, K3 250) fresh, partly filled and wrapped, and the
depformer's ring (H 16, hd 64, cap 8) with 8 sessions at ages 0-7.

Both sides form the same exact f32 products and round q * scale, p and
each chunk's p . v to bf16; their f32 sums run in another order.  Where
two such sums straddle a bf16 rounding boundary a rounding flips: a
probability's moves its head's elements a little, a chunk's p . v moves
its one element by one bf16 step of that chunk's contribution (1.1e-3 of
the output's largest value on the wrapped 1000-slot ring here, as large
as a control reads there).  Flips are rare and the controls move every
element, so the rule (``_held``) is on the root mean square of the error
per session, relative to the session's largest value: at most
``_TOL_RMS`` = 2e-4 (readings: <= 9.5e-8 where nothing flipped, 9.5e-7
and 1.1e-4 where something did), with every element within
``_TOL_FLIP`` = 5e-3 of the largest value.  Controls, each the plain
version with one pin changed, must read above ``_TOL_RMS``: K3's
function (>= 4.5e-4), p . v left in f32 (>= 4.5e-4), the scale applied
after the sum (>= 5.6e-4 at hd 128; at hd 64, where the scale is 1/8, it
equals the sound version exactly), and K3's chunk with K10's roundings
(>= 7.1e-4 at cap 1000; elsewhere the two chunks coincide).
On a ring with no valid slot (age 0) every form returns the seed alone.

Also: ``use_mxu_attn`` and ``chunk_for_mxu`` against ``_use_mxu_attn`` /
``_chunk_for_mxu``; K3's chunk check stays first; without the knob K3 is
what it was; and a launch without nvcc raises.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.nn import pallas_attention as jpa

from moshi_tpu_torch.nn import decode_attention as da

_TOL_RMS = 2e-4
_TOL_FLIP = 5e-3
_TOL_K3 = 1e-5      # K3 against JAX (test_torch_attention._TOL_ATTN)


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))
                 / max(float(np.max(np.abs(np.asarray(ref)))), 1e-30))


def _rms(got, ref):
    """Per session (the leading axis), the root mean square of the error
    relative to the session's largest value; the largest of these."""
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    err = np.asarray(got, np.float64).reshape(ref.shape) - ref
    scale = np.maximum(np.max(np.abs(ref), axis=1), 1e-30)
    return float(np.max(np.sqrt(np.mean(err ** 2, axis=1)) / scale))


def _held(got, ref):
    return _rms(got, ref) <= _TOL_RMS and _rel(got, ref) <= _TOL_FLIP


def _case(cap, offsets, h, hd, nl=3, seed=0):
    """bf16-valued q, current k/v [B, H, hd] and rings [L, B, cap, H, hd]
    as numpy f32."""
    rng = np.random.default_rng(seed)
    b = len(offsets)

    def bf(shape):
        return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                          .astype(jnp.float32))

    cur = [bf((b, h, hd)) for _ in range(3)]
    rings = [bf((nl, b, cap, h, hd)) for _ in range(2)]
    return cur, rings, np.asarray(offsets, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a)).to(torch.bfloat16)


def _jax(cur, rings, off, layer, cap, context):
    jax.clear_caches()
    try:
        return np.asarray(jpa.decode_attention_stacked(
            *(jnp.asarray(a, jnp.bfloat16) for a in (cur[0], *rings,
                                                     cur[1], cur[2])),
            jnp.asarray(off), jnp.int32(layer), cap=cap, context=context,
            interpret=True))
    finally:
        jax.clear_caches()


@contextlib.contextmanager
def _swapped(name, value):
    old = getattr(da, name)
    setattr(da, name, value)
    try:
        yield
    finally:
        setattr(da, name, old)


def _controls(cur, rings, off, layer, cap, context, plain):
    """name -> output of each control: K10's plain version ``plain`` with
    one pin changed, or K3's."""
    args = (_t(cur[0]), _t(rings[0])[layer], _t(rings[1])[layer],
            _t(cur[1]), _t(cur[2]), torch.from_numpy(off))
    kw = dict(cap=cap, context=context)
    chunk = da.chunk_for_mxu(cap)
    out = {"K3": da.decode_attention_plain(*args, chunk=da.chunk_for(cap),
                                           **kw)}
    with _swapped("_pv_round", lambda t: t):
        out["p.v in f32"] = plain(*args, chunk=chunk, **kw)
    with _swapped("_scores_query", lambda qf, scale: (qf, scale)):
        out["scale after the sum"] = plain(*args, chunk=chunk, **kw)
    out["K3's chunk"] = plain(*args, chunk=da.chunk_for(cap), **kw)
    return out


_CASES = [  # cap, context, offsets, H, hd
    (16, 16, [5, 2], 4, 128), (16, 8, [12, 9], 4, 128),
    (16, 16, [40, 37], 4, 128), (240, 200, [123, 120], 4, 128),
    (1000, 1000, [300, 1777], 4, 128), (1000, 1000, [1000, 2999], 4, 128),
    (8, 8, list(range(8)), 16, 64),
]


@pytest.mark.parametrize("cap,context,offsets,h,hd", _CASES)
def test_k10_plain_matches_pallas(cap, context, offsets, h, hd,
                                  monkeypatch):
    monkeypatch.setenv("MOSHI_TPU_ATTN_MXU", "1")
    cur, rings, off = _case(cap, offsets, h, hd)
    nl = rings[0].shape[0]
    taken = []
    plain = da.decode_attention_mxu_plain
    monkeypatch.setattr(da, "decode_attention_mxu_plain",
                        lambda *a, **kw: (taken.append(1), plain(*a, **kw))[1])
    for layer in (0, nl - 1):
        ref = _jax(cur, rings, off, layer, cap, context)
        got = da.decode_attention_stacked(
            _t(cur[0]), _t(rings[0]), _t(rings[1]), _t(cur[1]), _t(cur[2]),
            torch.from_numpy(off), layer, cap=cap, context=context)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _held(got, ref), (layer, _rms(got, ref), _rel(got, ref))
        ctl = _controls(cur, rings, off, layer, cap, context, plain)
        # sessions with at least one valid ring slot tell the pins apart
        live = off > 0
        for name, y in ctl.items():
            y, r = y.numpy()[live], ref[live]
            if name == "scale after the sum" and hd == 64:
                # the scale is a power of two: the same function
                assert np.array_equal(y, got.numpy()[live])
            elif name == "K3's chunk" and da.chunk_for(cap) == \
                    da.chunk_for_mxu(cap):
                assert _held(y, r)
            else:
                assert _rms(y, r) > _TOL_RMS, (name, layer, _rms(y, r))
        fresh = ~live
        if fresh.any():      # only the seed: every form returns v_cur
            for y in ctl.values():
                np.testing.assert_array_equal(y.numpy()[fresh], ref[fresh])
    assert len(taken) == 2


def test_k3_chunk_differs_at_cap_1000():
    assert (da.chunk_for_mxu(1000), da.chunk_for(1000)) == (200, 250)
    assert (da.chunk_for_mxu(3000), da.chunk_for(3000)) == (200, 250)
    assert (da.chunk_for_mxu(48), da.chunk_for(48)) == (24, 16)


def test_chunk_for_mxu_matches_jax():
    for cap in list(range(1, 300)) + [500, 750, 1000, 3000, 3072, 4096]:
        assert da.chunk_for_mxu(cap) == jpa._chunk_for_mxu(cap), cap


_PREDICATE = [  # torch dtype, jax dtype, H, hd, cap
    (torch.bfloat16, jnp.bfloat16, 32, 128, 3000),
    (torch.bfloat16, jnp.bfloat16, 16, 64, 8),
    (torch.bfloat16, jnp.bfloat16, 16, 64, 32),
    (torch.bfloat16, jnp.bfloat16, 4, 128, 250),    # no K10 chunk
    (torch.bfloat16, jnp.bfloat16, 4, 128, 5),      # cap below 8
    (torch.bfloat16, jnp.bfloat16, 2, 32, 16),      # H * hd = 64
    (torch.bfloat16, jnp.bfloat16, 3, 64, 16),      # H * hd = 192
    (torch.float32, jnp.float32, 32, 128, 3000),
    (torch.float16, jnp.float16, 32, 128, 3000),
    (torch.float8_e4m3fn, jnp.float8_e4m3fn, 4, 128, 16),
]


@pytest.mark.parametrize("knob", ["1", "0", None])
@pytest.mark.parametrize("tdt,jdt,h,hd,cap", _PREDICATE)
def test_use_mxu_attn_matches_jax(tdt, jdt, h, hd, cap, knob, monkeypatch):
    if knob is None:
        monkeypatch.delenv("MOSHI_TPU_ATTN_MXU", raising=False)
    else:
        monkeypatch.setenv("MOSHI_TPU_ATTN_MXU", knob)
    want = jpa._use_mxu_attn(jdt, h, hd, cap)
    assert da.use_mxu_attn(tdt, h, hd, cap) == want
    if knob != "1":
        assert not want


def test_k3_chunk_check_comes_first(monkeypatch):
    """cap 7 has a K10 chunk (7) but no K3 chunk: both packages raise
    under the knob, as K3's check runs before the K10 test."""
    monkeypatch.setenv("MOSHI_TPU_ATTN_MXU", "1")
    cur, rings, off = _case(7, [3], 1, 128, nl=1)
    assert da.chunk_for_mxu(7) == 7 and da.chunk_for(7) == 1
    with pytest.raises(ValueError, match="chunk"):
        _jax(cur, rings, off, 0, 7, 7)
    with pytest.raises(ValueError, match="chunk"):
        da.decode_attention_stacked(
            _t(cur[0]), _t(rings[0]), _t(rings[1]), _t(cur[1]), _t(cur[2]),
            torch.from_numpy(off), 0, cap=7, context=7)


@pytest.mark.parametrize("knob,cap", [(None, 240), ("0", 1000),
                                      ("1", 250)])
def test_k3_is_unchanged_without_k10(knob, cap, monkeypatch):
    """Knob off, or on where K10 has no chunk (cap 250): the call is K3's
    plain version to the last bit, and it matches JAX's K3."""
    if knob is None:
        monkeypatch.delenv("MOSHI_TPU_ATTN_MXU", raising=False)
    else:
        monkeypatch.setenv("MOSHI_TPU_ATTN_MXU", knob)
    cur, rings, off = _case(cap, [cap // 2, cap + 3], 4, 128, nl=2)
    got = da.decode_attention_stacked(
        _t(cur[0]), _t(rings[0]), _t(rings[1]), _t(cur[1]), _t(cur[2]),
        torch.from_numpy(off), 1, cap=cap, context=cap)
    want = da.decode_attention_plain(
        _t(cur[0]), _t(rings[0])[1], _t(rings[1])[1], _t(cur[1]),
        _t(cur[2]), torch.from_numpy(off), cap=cap, context=cap,
        chunk=da.chunk_for(cap))
    assert torch.equal(got, want)
    ref = _jax(cur, rings, off, 1, cap, cap)
    assert _rel(got, ref) < _TOL_K3


def test_k10_launch_raises_without_a_toolchain():
    """No fallback: the K10 launch builds the kernels, and without nvcc
    that raises instead of running the plain version."""
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    cur, rings, off = _case(16, [5], 4, 128, nl=1)
    with pytest.raises(RuntimeError, match="nvcc"):
        da._launch(_t(cur[0]), _t(rings[0]), _t(rings[1]), _t(cur[1]),
                   _t(cur[2]), torch.from_numpy(off), 0, 16, 16, 16,
                   mxu=True)
