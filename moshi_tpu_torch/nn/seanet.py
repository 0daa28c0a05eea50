"""SEANet streaming convolutional encoder/decoder (Mimi's acoustic stack).

Counterpart of ``moshi_tpu/nn/seanet.py``, with the same module names
(``model.N`` and ``model.N.block.M``, the checkpoint's) and order:

  encoder: conv(1 -> 64, k7); per ratio r in (4, 5, 6, 8):
           resblock(ch) -> elu -> conv(ch -> 2ch, k=2r, stride=r);
           elu -> conv(1024 -> 512, k3)                (24 kHz -> 25 Hz)
  decoder: conv(512 -> 1024, k7); per ratio r in (8, 6, 5, 4):
           elu -> convtr(ch -> ch/2, k=2r, stride=r) -> resblock(ch/2);
           elu -> conv(64 -> 1, k3)                    (25 Hz -> 24 kHz)
  resblock: [elu -> conv k3 (ch -> ch/2) -> elu -> 1x1 conv (ch/2 -> ch)]
            + identity skip

ELU is computed in f32 and cast back to the activation's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from moshi_tpu_torch.nn.conv import (StatelessConv1d, StreamingConv1d,
                                     StreamingConvTranspose1d)


def _elu(x):
    return torch.nn.functional.elu(x.float()).to(x.dtype)


@dataclass(frozen=True)
class SEANetConfig:
    channels: int = 1
    dimension: int = 512
    n_filters: int = 64
    ratios: Tuple[int, ...] = (8, 6, 5, 4)   # decoder order; encoder reversed
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out


def _resblock_modules(ch: int, rk: int):
    return {
        "block.1": StreamingConv1d(ch, ch // 2, rk),
        "block.3": StatelessConv1d(ch // 2, ch, 1),
    }


class _SEANet:
    modules: Dict[str, object]
    order: List[str]

    def init_state(self, batch: int, dtype, device):
        return {name: m.init_state(batch, dtype, device)
                for name, m in self.modules.items()}

    def __call__(self, params, state, x):
        new_state = {}

        def run(name, h):
            y, new_state[name] = self.modules[name](params[name],
                                                    state[name], h)
            return y

        h = x
        for step in self.order:
            if step.startswith("resblock:"):
                i = int(step.split(":")[1])
                skip = h
                h = run(f"model.{i}.block.1", _elu(h))
                h = run(f"model.{i}.block.3", _elu(h))
                h = h + skip
            else:
                name = step.split("+")[-1]
                if step.startswith("elu+"):
                    h = _elu(h)
                h = run(name, h)
        return h, new_state


class SEANetEncoder(_SEANet):
    """1 channel at 24 kHz -> ``dimension`` at 24000/hop Hz.
    x [B, T, 1] (T a multiple of hop) -> ([B, T/hop, dim], state)."""

    def __init__(self, cfg: SEANetConfig = SEANetConfig()):
        self.cfg = cfg
        mult = 1
        mods: Dict[str, object] = {}
        order: List[str] = []
        idx = 0
        mods[f"model.{idx}"] = StreamingConv1d(cfg.channels,
                                               mult * cfg.n_filters,
                                               cfg.kernel_size)
        order.append(f"model.{idx}")
        idx += 1
        for r in reversed(cfg.ratios):
            ch = mult * cfg.n_filters
            for name, m in _resblock_modules(
                    ch, cfg.residual_kernel_size).items():
                mods[f"model.{idx}.{name}"] = m
            order.append(f"resblock:{idx}")
            idx += 2  # resblock + elu
            mods[f"model.{idx}"] = StreamingConv1d(ch, ch * 2, 2 * r,
                                                   stride=r)
            order.append(f"elu+model.{idx}")
            idx += 1
            mult *= 2
        idx += 1  # elu
        mods[f"model.{idx}"] = StreamingConv1d(mult * cfg.n_filters,
                                               cfg.dimension,
                                               cfg.last_kernel_size)
        order.append(f"elu+model.{idx}")
        self.modules = mods
        self.order = order


class SEANetDecoder(_SEANet):
    """``dimension`` at 25 Hz -> 1 channel at 24 kHz.
    x [B, T, dim] -> ([B, T*hop, 1], state)."""

    def __init__(self, cfg: SEANetConfig = SEANetConfig()):
        self.cfg = cfg
        mult = 2 ** len(cfg.ratios)
        mods: Dict[str, object] = {}
        order: List[str] = []
        idx = 0
        mods[f"model.{idx}"] = StreamingConv1d(cfg.dimension,
                                               mult * cfg.n_filters,
                                               cfg.kernel_size)
        order.append(f"model.{idx}")
        idx += 2  # conv + elu
        for r in cfg.ratios:
            ch = mult * cfg.n_filters
            mods[f"model.{idx}"] = StreamingConvTranspose1d(ch, ch // 2,
                                                            2 * r, stride=r)
            order.append(f"elu+model.{idx}")
            idx += 1
            for name, m in _resblock_modules(
                    ch // 2, cfg.residual_kernel_size).items():
                mods[f"model.{idx}.{name}"] = m
            order.append(f"resblock:{idx}")
            idx += 2  # resblock + elu
            mult //= 2
        mods[f"model.{idx}"] = StreamingConv1d(cfg.n_filters, cfg.channels,
                                               cfg.last_kernel_size)
        order.append(f"elu+model.{idx}")
        self.modules = mods
        self.order = order
