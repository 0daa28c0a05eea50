"""The offset-indexed bias table (``moshi_tpu_torch/nn/attention.py``
``build_bias_pattern`` / ``bias_pattern_lookup``) against the JAX
package's, and each looked-up row against the bias computed at its
offset, as ``tests/test_attention.py`` holds the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moshi_tpu.nn.attention import bias_pattern_lookup as jax_lookup
from moshi_tpu.nn.attention import build_bias_pattern as jax_build

from moshi_tpu_torch.nn.attention import (bias_pattern_lookup,
                                          build_bias_pattern,
                                          streaming_attn_bias)


@pytest.mark.parametrize("cap,context,t", [(8, 5, 1), (8, 8, 2), (12, 7, 3)])
def test_bias_pattern_matches_jax_and_the_computed_bias(cap, context, t):
    pattern = build_bias_pattern(cap, context, t)
    assert pattern.shape == (2 * cap, t, cap)
    np.testing.assert_array_equal(pattern.numpy(),
                                  np.asarray(jax_build(cap, context, t)))
    offs = [0, 1, 3, cap - 1, cap, cap + 1, 2 * cap - 1, 2 * cap, 3 * cap + 5,
            100]
    off = torch.tensor(offs, dtype=torch.int32)
    got = bias_pattern_lookup(pattern, off, cap)
    np.testing.assert_array_equal(got.numpy(), streaming_attn_bias(
        off, t, cap, context).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_lookup(
        jax_build(cap, context, t), jnp.asarray(offs, jnp.int32), cap)))
