"""Per-tensor quantization policy with shape-based fallback.

A copy of ``choose_format`` from ``moshi_tpu/quant/policy.py`` (the port
imports nothing of the JAX package): only large 2-D matmul/embedding
weights are quantized; q4_k falls back to q4_0 when the inner dim is not a
multiple of 256, and q4_0/q8_0 to unquantized when it is not a multiple
of 32; norm scales and biases stay unquantized.
"""

from __future__ import annotations

from typing import Optional

from moshi_tpu_torch.quant.formats import QK, QK_K

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
