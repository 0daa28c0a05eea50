"""The port's attention-side code against the JAX package, on the CPU.

* K3's plain version (``moshi_tpu_torch.nn.decode_attention``) against the
  Pallas ``decode_attention_stacked`` in interpret mode: the temporal-like
  ring (cap 300, walked in three chunks of 100) at offsets before, at and
  after the wrap, and the depformer-like ring (cap 8).
* K4's plain version (``moshi_tpu_torch.nn.ring``) against the Pallas
  ``ring_write_stacked``: exact.
* K9's plain version against the Pallas ``decode_attention`` (the 4-D
  post-insert ring of the generic stacks) over rings of 750 slots (a
  padded tail chunk), 256, 32 and 8, with contexts equal to and below the
  ring, at offsets of a fresh, a partly filled and a wrapped ring, and of
  one whose leading chunk is fully masked; and controls: K3's chunking or
  its ``context - 1`` mask miss the limit.
* K11's plain version against the Pallas ``ring_write``: exact.
* RoPE, rms_norm, layer_norm and sample_token (greedy, and top-k with
  JAX's Gumbel draw injected as ``noise``).

Inputs are seeded numpy draws handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.nn import layers as jl
from moshi_tpu.nn.pallas_attention import \
    decode_attention as jax_decode_attention
from moshi_tpu.nn.pallas_attention import \
    decode_attention_stacked as jax_decode_attention_stacked
from moshi_tpu.nn.pallas_ring import ring_write as jax_ring_write4
from moshi_tpu.nn.pallas_ring import ring_write_stacked as jax_ring_write
from moshi_tpu.nn.rope import apply_rope as jax_apply_rope
from moshi_tpu.nn.sampling import sample_token as jax_sample_token

from moshi_tpu_torch.nn import layers as pl_
from moshi_tpu_torch.nn.decode_attention import (chunk_for,
                                                 decode_attention,
                                                 decode_attention4_plain,
                                                 decode_attention_stacked)
from moshi_tpu_torch.nn.ring import ring_write, ring_write_stacked
from moshi_tpu_torch.nn.rope import apply_rope
from moshi_tpu_torch.nn.sampling import sample_token

# K3: both sides form the same exact f32 products of bf16 inputs and round
# the probabilities to bf16; the f32 sums run in another order and exp may
# differ in its last bit (measured: under 1e-7 on outputs of unit scale).
# A last-bit exp difference could move one bf16-rounded probability by one
# bf16 step; held to 1e-5 absolute.
_TOL_ATTN = 1e-5


# K9: the same arithmetic as K3's plain version, without the seed.
# Readings against the Pallas kernel: at most 2.6e-7 of the largest output
# over these cases (sums in another order; no bf16 probability flipped).
# A flipped probability would move an output by about 2^-9 of its
# weight, well above the limit; K3's chunking reads >= 4.7e-5 and the
# context - 1 mask >= 1e-2 (test_decode_attention4_controls_fail_the_limit).
_TOL_ATTN4 = 1e-6


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t_bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _attention_case(rng, cap, context, offsets, h=4, hd=32, nl=2):
    b = len(offsets)
    ring = rng.normal(0, 1, (2, nl, b, cap, h, hd)).astype(np.float32)
    cur = rng.normal(0, 1, (3, b, h, hd)).astype(np.float32)
    # bf16 values on both sides
    ring = np.asarray(_bf16(ring).astype(jnp.float32))
    cur = np.asarray(_bf16(cur).astype(jnp.float32))
    off = np.asarray(offsets, np.int32)
    return ring, cur, off


@pytest.mark.parametrize("cap,context,offsets", [
    (300, 300, (0, 5)),           # empty ring, then a few positions
    (300, 300, (150, 299)),       # before the wrap
    (300, 300, (300, 301)),       # at the wrap
    (300, 300, (450, 1000)),      # after the wrap
    (300, 200, (250, 777)),       # window shorter than the ring
    (8, 8, (0, 3)),               # the depformer ring
    (8, 8, (7, 7)),
])
def test_decode_attention_plain_matches_pallas(cap, context, offsets):
    rng = np.random.default_rng(cap + offsets[1])
    ring, cur, off = _attention_case(rng, cap, context, offsets)
    layer = 1
    ref = np.asarray(jax_decode_attention_stacked(
        _bf16(cur[0]), _bf16(ring[0]), _bf16(ring[1]), _bf16(cur[1]),
        _bf16(cur[2]), jnp.asarray(off), jnp.int32(layer), cap=cap,
        context=context, interpret=True))
    got = decode_attention_stacked(
        _t_bf16(cur[0]), _t_bf16(ring[0]), _t_bf16(ring[1]), _t_bf16(cur[1]),
        _t_bf16(cur[2]), torch.from_numpy(off), layer, cap=cap,
        context=context)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_TOL_ATTN)


def test_chunk_for_matches_pallas():
    from moshi_tpu.nn.pallas_attention import _chunk_for
    for cap in (8, 16, 300, 3000, 250, 64, 7, 1000):
        assert chunk_for(cap) == _chunk_for(cap)
    assert chunk_for(300) == 100 and chunk_for(3000) == 250


@pytest.mark.parametrize("slots", [(0, 5), (7, 7), (3, 0)])
def test_ring_write_plain_matches_pallas(slots):
    rng = np.random.default_rng(11)
    nl, b, cap, h, hd = 3, 2, 8, 4, 16
    rings = np.asarray(_bf16(rng.normal(0, 1, (2, nl, b, cap, h, hd)))
                       .astype(jnp.float32))
    rows = np.asarray(_bf16(rng.normal(0, 1, (2, nl, b, h, hd)))
                      .astype(jnp.float32))
    slot = np.asarray(slots, np.int32)
    rk, rv = jax_ring_write(_bf16(rings[0]), _bf16(rings[1]),
                            _bf16(rows[0]), _bf16(rows[1]),
                            jnp.asarray(slot), interpret=True)
    k, v = _t_bf16(rings[0]), _t_bf16(rings[1])
    out_k, out_v = ring_write_stacked(k, v, _t_bf16(rows[0]),
                                      _t_bf16(rows[1]),
                                      torch.from_numpy(slot))
    assert out_k is k and out_v is v           # written in place
    np.testing.assert_array_equal(k.float().numpy(),
                                  np.asarray(rk.astype(jnp.float32)))
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(rv.astype(jnp.float32)))


_K9_CASES = [
    (750, 750, (5, 300)),         # fresh; partly filled across a chunk
    (750, 750, (600, 2000)),      # three chunks; wrapped
    (750, 300, (700, 1200)),      # leading chunk fully masked; wrapped
    (256, 256, (3, 900)),         # one chunk, fresh and wrapped
    (32, 32, (40, 7)),
    (32, 20, (31, 100)),          # window shorter than the ring
    (8, 8, (0, 13)),
]


def _attention4(cap, context, offsets, control=None, h=4, hd=32):
    """(port, Pallas) outputs on the same seeded inputs; ``control``
    replaces the port's chunk or context."""
    rng = np.random.default_rng(cap + offsets[1] + context)
    b = len(offsets)
    ring = np.asarray(_bf16(rng.normal(0, 1, (2, b, cap, h, hd)))
                      .astype(jnp.float32))
    q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
    off = np.asarray(offsets, np.int32)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), _bf16(ring[0]), _bf16(ring[1]), jnp.asarray(off),
        cap=cap, context=context, interpret=True))
    args = (torch.from_numpy(q), _t_bf16(ring[0]), _t_bf16(ring[1]),
            torch.from_numpy(off))
    if control is None:
        got = decode_attention(*args, cap=cap, context=context)
    else:
        got = decode_attention4_plain(*args, cap=cap, **control)
    return got, ref


@pytest.mark.parametrize("cap,context,offsets", _K9_CASES)
def test_decode_attention4_plain_matches_pallas(cap, context, offsets):
    got, ref = _attention4(cap, context, offsets)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert err <= _TOL_ATTN4, err


@pytest.mark.parametrize("cap,context,offsets,control", [
    (750, 750, (500, 700), {"context": 750, "chunk": 250}),
    (750, 750, (1337, 2000), {"context": 750, "chunk": 250}),
    (750, 750, (1337, 2000), {"context": 749}),
    (32, 20, (31, 100), {"context": 19}),
], ids=["chunk-partial", "chunk-wrapped", "mask-wrapped", "mask-window"])
def test_decode_attention4_controls_fail_the_limit(cap, context, offsets,
                                                   control):
    """The limit sees K3's pins: its chunk (250 at cap 750) or its
    context - 1 mask in place of K9's."""
    got, ref = _attention4(cap, context, offsets, control)
    err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert err > _TOL_ATTN4, err


def test_chunk4_is_min_256_cap():
    from moshi_tpu_torch.nn.decode_attention import chunk4_for
    assert [chunk4_for(c) for c in (750, 256, 32, 8, 3000)] == \
        [256, 256, 32, 8, 256]
    assert chunk_for(750) == 250      # K3's chunk, a divisor


@pytest.mark.parametrize("slots", [(0, 5), (7, 7), (3, 0)])
def test_ring_write4_plain_matches_pallas(slots):
    rng = np.random.default_rng(16)
    b, cap, h, hd = 2, 8, 4, 16
    ring = np.asarray(_bf16(rng.normal(0, 1, (b, cap, h, hd)))
                      .astype(jnp.float32))
    rows = rng.normal(0, 1, (b, h, hd)).astype(np.float32)   # cast inside
    slot = np.asarray(slots, np.int32)
    ref = jax_ring_write4(_bf16(ring), jnp.asarray(rows), jnp.asarray(slot),
                          interpret=True)
    cache = _t_bf16(ring)
    out = ring_write(cache, torch.from_numpy(rows), torch.from_numpy(slot))
    assert out is cache                        # written in place
    np.testing.assert_array_equal(cache.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("per_batch", [False, True])
def test_rope_matches(per_batch):
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (2, 1, 8, 64)).astype(np.float32)
    pos = (np.asarray([[3], [2999]], np.int32) if per_batch
           else np.asarray([17], np.int32))
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    # cos/sin of angles up to ~3000 rad: f32 range reduction differs
    # between the two libraries by a few ulp of the angle
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_rms_norm_and_layer_norm_match():
    rng = np.random.default_rng(13)
    x = rng.normal(0, 3, (2, 3, 512)).astype(np.float32)
    alpha = rng.normal(1, 0.1, (512,)).astype(np.float32)
    ref = np.asarray(jl.rms_norm({"alpha": jnp.asarray(alpha)},
                                 jnp.asarray(x)))
    got = pl_.rms_norm({"alpha": torch.from_numpy(alpha)},
                       torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    w = rng.normal(1, 0.1, (512,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (512,)).astype(np.float32)
    ref = np.asarray(jl.layer_norm({"weight": jnp.asarray(w),
                                    "bias": jnp.asarray(bias)},
                                   jnp.asarray(x)))
    got = pl_.layer_norm({"weight": torch.from_numpy(w),
                          "bias": torch.from_numpy(bias)},
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_rms_norm_eps_is_1e8():
    """A zero row normalizes by sqrt(1e-8): the eps that JAX pins."""
    x = torch.zeros((1, 4))
    x[0, 0] = 1e-4
    y = pl_.rms_norm({"alpha": torch.ones(4)}, x)
    expect = 1e-4 / np.sqrt(1e-8 / 4 + 1e-8)
    assert abs(float(y[0, 0]) - expect) < 1e-3 * expect


def test_sample_token_greedy_matches():
    rng = np.random.default_rng(14)
    logits = rng.normal(0, 1, (3, 2048)).astype(np.float32)
    ref = np.asarray(jax_sample_token(jnp.asarray(logits),
                                      jax.random.PRNGKey(0), 0.0, 250))
    got = sample_token(torch.from_numpy(logits), 0.0, 250)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("temp,top_k,seed", [(0.8, 250, 0), (0.7, 25, 1),
                                             (1.0, 0, 2)])
def test_sample_token_topk_with_injected_gumbel_matches(temp, top_k, seed):
    rng = np.random.default_rng(15 + seed)
    logits = rng.normal(0, 2, (4, 2048)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_sample_token(jnp.asarray(logits), key, temp, top_k))
    k = top_k if top_k > 0 else logits.shape[-1]
    # the same draw JAX's sample_token makes from this key
    noise = np.asarray(jax.random.gumbel(key, (4, k), jnp.float32))
    got = sample_token(torch.from_numpy(logits), temp, top_k,
                       noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sample_token_uses_generator():
    logits = torch.zeros((2, 100))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = sample_token(logits, 1.0, 50, generator=g1)
    b = sample_token(logits, 1.0, 50, generator=g2)
    torch.testing.assert_close(a, b)
    assert a.dtype == torch.int64 and a.shape == (2,)
