"""The plain linear1 -> gelu -> linear2 FFN of non-gating stacks (Mimi's
transformers).

Counterpart of ``moshi_tpu/nn/gating.py`` ``mlp_gelu``: gelu is the tanh
approximation, computed in f32 and cast back to the activation's dtype.
The silu-gated FFN of the LM stacks runs through the kernels
(``quant/matmul.py``, ``quant/fused.py``).
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.nn.layers import linear


def mlp_gelu(params, x):
    h = linear(params["linear1"], x)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(h.dtype)
    return linear(params["linear2"], h)
