"""Streaming multi-head attention: configuration, KV-ring state, and the
step of the generic stacks.

Counterpart of ``moshi_tpu/nn/attention.py`` in its Pallas-on form.  The
ring holds ``cap`` positions per session, masked with -1e9 (not -inf).
The LM's T = 1 stacked decode attends one query at a time through
``nn/decode_attention.py`` (K3).  ``streaming_mha`` is the generic
stacks' step:

- T = 1 (the dense STT LM's decode): k and v go into their rings through
  K11 (``nn/ring.py`` ``ring_write_kv``: one launch for both, at the
  offset's floor mod, reading the rows where the projection and the rope
  left them), and K9
  (``nn/decode_attention.py`` ``decode_attention``) attends the query over
  the post-insert ring with its window mask in-kernel, so no additive
  bias is built;
- T > 1 (Mimi's transformers take 2): the positions are inserted into the
  ring, then attended by the JAX package's einsum branch, written out
  with ``torch.matmul`` on bf16-rounded f32 tensors so that its numerics
  follow XLA's (exact f32 products of bf16 inputs, f32 softmax,
  probabilities rounded to bf16).

A ring may be float8_e4m3fn (``kv_dtype``): every write converts by the
reference's rule (``nn/ring.py`` ``fp8_cast``; K11 inside its kernel), and
the einsum branch widens the ring to bf16, exact for e4m3, as the JAX
package's ``.astype(bf16)``.

Cross-attention (the voice-conditioned TTS models): ``cross_attention_kv``
projects the conditioning once per session with the k and v rows [D:3D]
of the fused in_proj (dequantized to bf16), and ``cross_mha`` attends the
stream's rows to it, unmasked and without RoPE, with the same numerics;
its queries take the whole fused in_proj through ``linear`` (so a
quantized one runs K1, or K6 at several rows) and keep rows [0:D].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from moshi_tpu_torch.nn.decode_attention import decode_attention
from moshi_tpu_torch.nn.layers import linear
from moshi_tpu_torch.quant.formats import QuantTensor, dequantize
from moshi_tpu_torch.nn.ring import (ring_index_copy_, ring_write_kv,
                                     to_ring_dtype)
from moshi_tpu_torch.nn.rope import apply_rope, rope_angles

NEG_BIAS = -1e9


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


def ring_insert(cache, values, positions, cap: int):
    """Write values [B, T, ...] into the ring cache [B, cap, ...] at
    positions % cap, in place; with T > cap the last write to a slot
    wins.  Returns the cache."""
    b, t = values.shape[:2]
    if t > cap:       # positions are consecutive: the last cap win
        values, positions, t = values[:, -cap:], positions[:, -cap:], cap
    slots = torch.remainder(positions.long(), cap)
    rows = to_ring_dtype(values, cache.dtype)
    for i in range(b):
        ring_index_copy_(cache[i], 0, slots[i], rows[i])
    return cache


def ring_key_positions(last, cap: int):
    """Absolute position held by each ring slot after writing up to
    ``last`` [B]: p[j] = last - ((last - j) mod cap); never-written slots
    resolve to negative positions.  -> [B, cap] int64."""
    j = torch.arange(cap, device=last.device)[None, :]
    lastb = last.long()[:, None]
    return lastb - torch.remainder(lastb - j, cap)


def streaming_attn_bias(offset, t: int, cap: int, context: int):
    """Additive bias [B, T, cap] f32: 0 where the key slot holds a valid
    (written, causal, in-window) position for the query, -1e9 elsewhere."""
    last = offset.long() + (t - 1)
    p = ring_key_positions(last, cap)[:, None, :]
    qp = (offset.long()[:, None]
          + torch.arange(t, device=offset.device)[None, :])[:, :, None]
    valid = (p >= 0) & (p <= qp) & (p > qp - context)
    zero = torch.zeros((), dtype=torch.float32, device=offset.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_BIAS))


def attn_shared(cfg: MHAConfig, offset, t: int):
    """Per-step quantities shared by every layer of a generic stack:
    positions [B, T], rope cos/sin, the additive bias (None at T = 1,
    where K9 masks in-kernel)."""
    positions = (offset.long()[:, None]
                 + torch.arange(t, device=offset.device)[None, :])
    cos_sin = (rope_angles(positions, cfg.head_dim, cfg.rope_max_period)
               if cfg.rope_max_period else None)
    bias = (None if t == 1
            else streaming_attn_bias(offset, t, cfg.cap, cfg.context))
    return {"positions": positions, "cos_sin": cos_sin, "bias": bias}


def _bf16_exact(x):
    """x rounded to bf16 and held in f32, where products are exact."""
    return x.to(torch.bfloat16).float()


def streaming_mha(cfg: MHAConfig, params, state, x, offset, shared=None,
                  pre_norm_alpha=None):
    """x [B, T, D], offset [B] (position of x[:, 0]) -> (y [B, T, D],
    state with k/v [B, cap, H, hd] written in place).  ``pre_norm_alpha``
    fuses the pre-attention rms norm into the qkv projection."""
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    if shared is None:
        shared = attn_shared(cfg, offset, t)
    qkv = linear(params["in_proj"], x,
                 pre_norm_alpha=pre_norm_alpha)                # [B, T, 3D]
    if cfg.rope_max_period:
        qk = apply_rope(qkv[..., : 2 * d].reshape(b, t, 2 * h, hd),
                        cos_sin=shared["cos_sin"])
        q, k = qk[:, :, :h], qk[:, :, h:]
    else:
        q = qkv[..., :d].reshape(b, t, h, hd)
        k = qkv[..., d:2 * d].reshape(b, t, h, hd)
    v = qkv[..., 2 * d:].reshape(b, t, h, hd)
    if t == 1 and state["k"].dim() == 4:
        kc, vc = ring_write_kv(state["k"], state["v"], k[:, 0], v[:, 0],
                               offset)
    else:
        kc = ring_insert(state["k"], k, shared["positions"], cfg.cap)
        vc = ring_insert(state["v"], v, shared["positions"], cfg.cap)
    if t == 1:
        out = decode_attention(q[:, 0], kc, vc, offset, cap=cfg.cap,
                               context=cfg.context)            # [B, H, hd]
        out = out[:, None].reshape(b, 1, d).to(x.dtype)
        return linear(params["out_proj"], out), {"k": kc, "v": vc}
    qf = _bf16_exact(q).transpose(1, 2)                       # [B, H, T, hd]
    kf = _bf16_exact(kc).permute(0, 2, 3, 1)                  # [B, H, hd, S]
    vf = _bf16_exact(vc).transpose(1, 2)                      # [B, H, S, hd]
    scores = torch.matmul(qf, kf) * (hd ** -0.5) + shared["bias"][:, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(_bf16_exact(probs), vf)                # [B, H, T, hd]
    out = out.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    return linear(params["out_proj"], out), {"k": kc, "v": vc}


def cross_attention_kv(cfg: MHAConfig, params, cond):
    """Cross K/V {k, v: [B, S, H, hd]} in ``cfg.kv_dtype`` from the
    conditioning [B, S, D], once per session: bf16 operands (a quantized
    in_proj dequantized to bf16) with the product rounded to the weight's
    dtype, as the JAX package's einsum without a preferred type."""
    b, s, d = cond.shape
    h, hd = cfg.num_heads, cfg.head_dim
    w = params["in_proj"]["weight"]
    if isinstance(w, QuantTensor):
        w = dequantize(w, torch.bfloat16)
    wk, wv = w[d:2 * d], w[2 * d:3 * d]
    c = cond.to(w.dtype).float()
    k = torch.matmul(c, wk.float().T).to(w.dtype)
    v = torch.matmul(c, wv.float().T).to(w.dtype)
    bias = params["in_proj"].get("bias")
    if bias is not None:
        k = k + bias[d:2 * d].to(k.dtype)
        v = v + bias[2 * d:3 * d].to(v.dtype)
    return {"k": to_ring_dtype(k.reshape(b, s, h, hd), cfg.kv_dtype),
            "v": to_ring_dtype(v.reshape(b, s, h, hd), cfg.kv_dtype)}


def cross_mha(cfg: MHAConfig, params, x, kv):
    """Unmasked, un-roped attention of x [B, T, D] to the cross K/V
    {k, v: [B, S, H, hd]} -> [B, T, D] in x's dtype."""
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = linear(params["in_proj"], x)
    q = q[..., :d] if q.shape[-1] == 3 * d else q
    qf = _bf16_exact(q).reshape(b, t, h, hd).transpose(1, 2)  # [B, H, T, hd]
    kf = _bf16_exact(kv["k"]).permute(0, 2, 3, 1)            # [B, H, hd, S]
    vf = _bf16_exact(kv["v"]).transpose(1, 2)                # [B, H, S, hd]
    probs = torch.softmax(torch.matmul(qf, kf) * (hd ** -0.5), dim=-1)
    out = torch.matmul(_bf16_exact(probs), vf)               # [B, H, T, hd]
    out = out.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    return linear(params["out_proj"], out)
