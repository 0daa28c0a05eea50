"""Core layers: linear, norms, embeddings (functional, quant-aware).

Counterpart of ``moshi_tpu/nn/layers.py``.  Activations are [B, T, C];
weights are [O, I]; params are nested dicts of tensors, with quantized
weights as ``QuantTensor`` leaves routed by ``qmatmul``.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.quant.formats import QuantTensor, dequantize_rows, qmatmul


def linear(params, x, out_dtype=None, pre_norm_alpha=None):
    """y = x @ W.T + b; ``pre_norm_alpha`` fuses an rms pre-norm of x."""
    y = qmatmul(x, params["weight"], out_dtype=out_dtype or x.dtype,
                pre_norm_alpha=pre_norm_alpha)
    if params.get("bias") is not None:
        y = y + params["bias"].to(y.dtype)
    return y


def layer_norm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["weight"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm(params, x, eps: float = 1e-8):
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * params["alpha"].float()
    return y.to(x.dtype)


def embedding_lookup(params, ids, out_dtype=torch.float32):
    """Table lookup; quantized tables are dequantized row by row."""
    table = params["weight"]
    if isinstance(table, QuantTensor):
        return dequantize_rows(table, ids, out_dtype)
    return table[ids].to(out_dtype)


def scaled_embedding(params, ids, out_dtype=torch.float32):
    """Embedding where any negative id (zero = -1, ungenerated = -2) maps
    to the zero vector."""
    mask = ids >= 0
    safe = torch.where(mask, ids, torch.zeros_like(ids))
    emb = embedding_lookup(params, safe, out_dtype)
    return emb * mask[..., None].to(out_dtype)


def demux_embedding(params, ids, card: int, out_dtype=torch.float32):
    """The demuxed two-stream text embedding: a muxed id t carries first =
    t % N and second = t // N - 1 (N = ``card``, text_card + 1; -1 means
    absent).  Both are looked up in the shared table (negative ids give
    zero rows), projected by ``out1`` and ``out2``, and summed.
    params = {"weight": [N, D], "out1": linear, "out2": linear}."""
    has = ids >= 0
    neg = torch.full_like(ids, -1)
    first = torch.where(has, torch.remainder(ids, card), neg)
    second = torch.where(has, torch.div(ids, card, rounding_mode="floor")
                         - 1, neg)
    e1 = linear(params["out1"], scaled_embedding(params, first, out_dtype))
    e2 = linear(params["out2"], scaled_embedding(params, second, out_dtype))
    return (e1 + e2).to(out_dtype)


def apply_norm(norm_type: str, params, x):
    if norm_type in ("rms_norm", "rms_norm_f32"):
        return rms_norm(params, x)
    if norm_type in ("layer_norm", "layer_norm_f32"):
        return layer_norm(params, x)
    raise ValueError(f"unknown norm {norm_type!r}")


def layer_scale(params, x):
    """Per-channel learned residual-branch scale."""
    if params is None:
        return x
    return x * params["scale"].to(x.dtype)
