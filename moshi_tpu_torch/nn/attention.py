"""Streaming multi-head attention configuration and KV-ring state.

Counterpart of ``moshi_tpu/nn/attention.py`` for the decode path: the
ring holds ``cap`` positions per session, masked with -1e9 (not -inf) and
attended one query at a time by ``nn/decode_attention.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MHAConfig:
    dim: int
    num_heads: int
    context: int            # attention window
    capacity: int = 0       # ring size; 0 -> context
    rope_max_period: float = 10_000.0  # 0 -> no rope
    kv_dtype: torch.dtype = torch.bfloat16

    @property
    def cap(self) -> int:
        return self.capacity or self.context

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def init_kv_state(cfg: MHAConfig, batch: int, device, num_layers=None):
    """Zeroed KV ring {k, v}: [B, cap, H, hd] in ``cfg.kv_dtype``, with a
    leading [L] axis for a stack of ``num_layers``."""
    shape = ((num_layers,) if num_layers else ()) + (
        batch, cfg.cap, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.kv_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.kv_dtype, device=device)}
