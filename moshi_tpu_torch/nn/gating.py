"""The FFNs of the generic stacks: the gated MLP (silu or gelu), and the plain
linear1 -> gelu -> linear2 FFN of non-gating stacks (Mimi's transformers).

Counterpart of ``moshi_tpu/nn/gating.py``.  ``gating_mlp``: linear_in
projects to 2 * hidden (the gate half, then the value half), the
activation (silu, or gelu by its tanh approximation) is computed in f32
and cast back to the gate's dtype, and it multiplies the value before
linear_out.  A silu stack's quantized linear_in without a bias takes the
fused GLU as the JAX package's ``glu_matmul_pallas`` routes it
(``glu_matmul_fused``): rows that ``formats.int8_dispatch`` admits go to
K1's GLU, q4_k and q8_0 weights to K7; q4_0 takes the two-call form, and
so does a gelu stack (the fused GLUs are silu only, as the JAX
package's).  ``mlp_gelu``: gelu is the tanh approximation, computed in
f32 and cast back to the activation's dtype.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.nn.layers import linear
from moshi_tpu_torch.quant.formats import (QuantTensor, i8_storage,
                                           int8_dispatch)
from moshi_tpu_torch.quant.matmul import GLU_FORMATS, glu_matmul
from moshi_tpu_torch.quant.matmul_int8 import glu_matmul_i8


def glu_matmul_fused(x, qt: QuantTensor, alpha=None):
    """silu(x @ Wg.T) * (x @ Wv.T) for a flat fused linear_in [2H, K]
    (rms pre-norm with ``alpha`` fused) -> [..., H] f32, or None where the
    JAX package's ``glu_matmul_pallas`` returns None (q4_0, unpacked
    4-bit storage) and its caller takes the two-call form."""
    m = x.numel() // x.shape[-1]
    if qt.q.shape[-2] % 2 == 0 and int8_dispatch(qt, m):
        return glu_matmul_i8(x, qt, alpha=alpha)
    if qt.fmt not in GLU_FORMATS or i8_storage(qt):
        return None
    return glu_matmul(x, qt, alpha=alpha)


def gating_mlp(params, x, activation: str = "silu", pre_norm_alpha=None):
    w_in = params["linear_in"]["weight"]
    if activation not in ("silu", "gelu"):
        raise ValueError(f"unknown gating activation {activation!r}")
    if (activation == "silu" and isinstance(w_in, QuantTensor)
            and params["linear_in"].get("bias") is None):
        hv = glu_matmul_fused(x, w_in, alpha=pre_norm_alpha)
        if hv is not None:
            return linear(params["linear_out"], hv.to(x.dtype))
    h = linear(params["linear_in"], x, pre_norm_alpha=pre_norm_alpha)
    gate, value = torch.chunk(h, 2, dim=-1)
    if activation == "silu":
        act = torch.nn.functional.silu(gate.float())
    else:
        act = torch.nn.functional.gelu(gate.float(), approximate="tanh")
    return linear(params["linear_out"], act.to(gate.dtype) * value)


def mlp_gelu(params, x):
    h = linear(params["linear1"], x)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(h.dtype)
    return linear(params["linear2"], h)
