"""Per-tensor quantization policy with shape-based fallback.

A copy of ``choose_format``, ``quantize_tree`` and ``serving_format``
from ``moshi_tpu/quant/policy.py`` (the port imports nothing of the JAX
package): only large 2-D matmul/embedding weights are quantized; q4_k falls back to q4_0 when the inner dim is not a
multiple of 256, and q4_0/q8_0 to unquantized when it is not a multiple
of 32; norm scales and biases stay unquantized.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from moshi_tpu_torch.quant.formats import QK, QK_K, QuantTensor, quantize

_KEEP_F32 = ("alpha", "bias", "scale", "layer_scale")
_MIN_ROWS = 256
_MIN_COLS = 256


def choose_format(name: str, shape, fmt: str) -> Optional[str]:
    """The quant format for a parameter, or None to keep it unquantized.
    ``fmt`` is the requested format (q8_0 / q4_0 / q4_k / q8_r)."""
    if fmt is None:
        return None
    if any(name.endswith(sfx) for sfx in _KEEP_F32):
        return None
    if len(shape) != 2:
        return None
    o, i = shape
    if o < _MIN_ROWS or i < _MIN_COLS:
        return None
    if fmt == "q8_r":
        return fmt
    if fmt == "q4_k" and i % QK_K != 0:
        fmt = "q4_0"
    if fmt in ("q4_0", "q8_0") and i % QK != 0:
        return None
    return fmt


def quantize_tree(params, fmt: str, path: str = "", native: bool = True,
                  device="cuda"):
    """A nested dict (or list/tuple) of weights with every leaf the policy
    picks quantized to ``fmt`` on ``device`` (``quantize``); other leaves
    and QuantTensors are returned as they are.  Leaves are host arrays or
    tensors, named by their dotted path."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, fmt, f"{path}.{k}" if path else k,
                                 native, device)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v, fmt, f"{path}.{i}", native,
                                          device)
                            for i, v in enumerate(params))
    if isinstance(params, QuantTensor):
        return params
    shape = tuple(params.shape)
    actual = choose_format(path, shape, fmt)
    if actual is None:
        return params
    arr = (params.detach().float().cpu().numpy()
           if isinstance(params, torch.Tensor) else np.asarray(params))
    return quantize(arr.astype(np.float32), actual, native=native,
                    device=device)


def serving_format(requested: str, batch: int = 1,
                   model_sharded: bool = False) -> str:
    """The weight format for a serving deployment, the JAX package's
    rule: a 4-bit or q8_0 request stays as it is on one device and under
    explicit tensor parallelism (``parallel/tp.py`` keeps the kernels'
    formats), and becomes q8_r on a mesh that shards the model by
    ``parallel/sharding.py``'s specs alone, whose frame has no kernel of
    its own (the JAX package leaves it to XLA's partitioner; the port
    gathers the shards each frame).  q8_r and formats it does not know
    pass through.  ``batch`` is accepted as the JAX package's is, and not
    read."""
    if requested not in ("q4_k", "q4_0", "q8_0", "q8_r"):
        return requested
    if requested == "q8_r":
        return requested
    if model_sharded:
        return "q8_r"
    return requested
