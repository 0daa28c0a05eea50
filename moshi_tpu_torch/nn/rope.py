"""Rotary position embedding on interleaved (even, odd) channel pairs.

Counterpart of ``moshi_tpu/nn/rope.py``.
"""

from __future__ import annotations

import math

import torch


def rope_angles(positions: torch.Tensor, dim: int,
                max_period: float = 10_000.0):
    """positions [..., T] -> (cos, sin), each [..., T, dim // 2] f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=positions.device)
        / half)
    theta = positions.float()[..., None] * freqs
    return torch.cos(theta), torch.sin(theta)


def apply_rope(x: torch.Tensor, positions=None, max_period: float = 10_000.0,
               cos_sin=None) -> torch.Tensor:
    """x [B, T, H, D] with interleaved pairs; positions [T] or [B, T], or
    precomputed ``cos_sin`` shared by a whole stack."""
    b, t, h, d = x.shape
    if cos_sin is None:
        cos_sin = rope_angles(positions, d, max_period)
    cos, sin = cos_sin
    if cos.dim() == 2:      # positions [T]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == 3:    # positions [B, T]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float().reshape(b, t, h, d // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    yr = xr * cos - xi * sin
    yi = xr * sin + xi * cos
    return torch.stack([yr, yi], dim=-1).reshape(b, t, h, d).to(x.dtype)
