"""The FFNs of the generic stacks: the silu-gated MLP, and the plain
linear1 -> gelu -> linear2 FFN of non-gating stacks (Mimi's transformers).

Counterpart of ``moshi_tpu/nn/gating.py``.  ``gating_mlp``: linear_in
projects to 2 * hidden (the gate half, then the value half), the
activation is computed in f32 and cast back to the gate's dtype, and it
multiplies the value before linear_out (silu only: the JAX package's gelu
gating has no caller on the ported paths).  A quantized linear_in is
routed as the JAX package routes it with Pallas on: one row with an
int8-eligible weight takes K1's GLU (``quant/matmul.py`` ``glu_matmul_stacked``); every
other quantized case is the JAX package's K7 (``glu_matmul_pallas``),
which is not ported and raises.  ``mlp_gelu``: gelu is the tanh
approximation, computed in f32 and cast back to the activation's dtype.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.nn.layers import linear
from moshi_tpu_torch.quant.formats import QuantTensor, int8_shape_ok
from moshi_tpu_torch.quant.matmul import glu_matmul_stacked


def gating_mlp(params, x, activation: str = "silu", pre_norm_alpha=None):
    w_in = params["linear_in"]["weight"]
    if activation != "silu":
        raise ValueError(f"gating activation {activation!r} is not ported")
    if (isinstance(w_in, QuantTensor)
            and params["linear_in"].get("bias") is None):
        m = x.numel() // x.shape[-1]
        if w_in.q.shape[-2] % 2 or not int8_shape_ok(w_in, m):
            raise NotImplementedError("K7 glu_matmul_pallas is not ported")
        hv = glu_matmul_stacked(x, w_in, alpha=pre_norm_alpha)
        return linear(params["linear_out"], hv.to(x.dtype))
    h = linear(params["linear_in"], x, pre_norm_alpha=pre_norm_alpha)
    gate, value = torch.chunk(h, 2, dim=-1)
    act = torch.nn.functional.silu(gate.float()).to(gate.dtype)
    return linear(params["linear_out"], act * value)


def mlp_gelu(params, x):
    h = linear(params["linear1"], x)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(h.dtype)
    return linear(params["linear2"], h)
