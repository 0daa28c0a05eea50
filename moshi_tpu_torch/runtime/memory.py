"""Device-memory-aware session sizing.

Counterpart of ``moshi_tpu/runtime/memory.py``: the number of concurrent
sessions, or the context length, that fits the card's memory next to the
weights (the reference shrinks the context to fit VRAM before loading,
tools/moshi-sts.cpp:254-264).

``hbm_bytes`` reads the card's total memory; it raises for a device that
is not a CUDA card (the JAX package assumed 16 GB when the runtime gave no
figure).  ``KV_TRANSIENT`` is the port's own factor on the live KV bytes,
measured on the card (see its comment); the JAX package's 2.05 was XLA
double-buffering the rings, which the port's in-place ring writes do not.
"""

from __future__ import annotations

import dataclasses

import torch


def hbm_bytes(device=None) -> int:
    """Total memory of the CUDA card ``device`` (default: the current
    one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"device memory is read from a CUDA card, not "
                         f"{dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available to size against")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def kv_bytes_per_session(cfg, context: int | None = None) -> int:
    """Temporal KV-ring bytes of one session of an LMConfig (k and v, every
    layer, ``context`` positions)."""
    ctx = context or cfg.context
    itemsize = torch.empty((), dtype=cfg.transformer.kv_dtype).element_size()
    per_layer = ctx * cfg.num_heads * (cfg.dim // cfg.num_heads) * 2
    return int(cfg.num_layers * per_layer * itemsize)


# Peak device memory of the B = 8 SessionPool run over the live memory
# before it, per session's KV rings: (peak - before) / (8 *
# kv_bytes_per_session) read 1.1374 on the 7B q4_k with Mimi and bf16
# rings (13.329 GiB over 11.719 GiB of rings) and 1.1498 with fp8 rings
# (6.737 GiB over 5.859 GiB; chip_smoke.py phases 7 and 9, NVIDIA H100
# 80GB HBM3, 700.00 W).  The rings are written in place; the rest is the
# B = 1 slot template's rings (1/8) and the frame's activations and Mimi
# states, which do not shrink with the rings, so the fp8 reading is the
# larger.  The factor covers both.
KV_TRANSIENT = 1.16


def suggest_sessions(cfg, weight_bytes: int, device=None,
                     headroom: float = 0.85,
                     kv_transient: float = KV_TRANSIENT) -> int:
    """Max concurrent sessions for the given weights and per-session KV."""
    budget = int(hbm_bytes(device) * headroom) - weight_bytes
    per = int(kv_bytes_per_session(cfg) * kv_transient)
    return max(budget // per, 0) if per else 0


def suggest_context(cfg, weight_bytes: int, sessions: int = 1, device=None,
                    headroom: float = 0.95,
                    kv_transient: float = KV_TRANSIENT) -> int:
    """Largest context fitting ``sessions`` concurrent streams next to the
    weights (the reference's auto-shrink)."""
    budget = int(hbm_bytes(device) * headroom) - weight_bytes
    per_ctx = int(kv_bytes_per_session(cfg, context=1) * sessions
                  * kv_transient)
    return max(min(budget // per_ctx, cfg.context), 0) if per_ctx else 0


def auto_shrink_context(cfg, weight_bytes: int, sessions: int = 1,
                        device=None):
    """(cfg', shrunk?, suggested): ``cfg`` with its context reduced to what
    fits ``sessions`` concurrent streams next to the weights, rounded down
    to a multiple of 8 (the identity when everything fits).  Callers
    report the trade so that the shrink is never silent."""
    ctx = suggest_context(cfg, weight_bytes, sessions=sessions,
                          device=device)
    if 0 < ctx < cfg.context:
        ctx = max(ctx // 8 * 8, 8)
        return dataclasses.replace(cfg, context=ctx), True, ctx
    return cfg, False, cfg.context
