"""Streaming transformer stack: the T=1 stacked decode.

Counterpart of ``moshi_tpu/nn/transformer.py`` (``TransformerConfig``,
``init_transformer_state`` and ``_forward_stacked_decode`` with the
out_proj + norm2 + GLU steps as separate matvecs).  Each layer passes the
whole stacked weight and ring tensors to the kernels with its layer
index; the current token's k/v seed the attention, and after the layer
loop one ring write stores every layer's k/v at slot offset % cap.

The KV rings [L, B, cap, H, hd] are bf16 and are updated IN PLACE: the
state returned holds the same tensors as the state passed in.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from moshi_tpu_torch.nn.attention import MHAConfig, init_kv_state
from moshi_tpu_torch.nn.decode_attention import decode_attention_stacked
from moshi_tpu_torch.nn.ring import ring_write_stacked
from moshi_tpu_torch.nn.rope import apply_rope, rope_angles
from moshi_tpu_torch.quant.formats import QuantTensor
from moshi_tpu_torch.quant.matmul import glu_matmul_stacked, qmatmul_stacked


@dataclass(frozen=True)
class TransformerConfig:
    dim: int
    num_heads: int
    num_layers: int
    hidden_dim: int                    # FFN hidden (gating: per half)
    context: int
    capacity: int = 0                  # 0 -> context
    norm: str = "rms_norm_f32"
    gating: str = "silu"
    rope_max_period: float = 10_000.0  # 0 -> no positional embedding
    kv_dtype: torch.dtype = torch.bfloat16

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(dim=self.dim, num_heads=self.num_heads,
                         context=self.context, capacity=self.capacity,
                         rope_max_period=self.rope_max_period,
                         kv_dtype=self.kv_dtype)


def init_transformer_state(cfg: TransformerConfig, batch: int, device):
    """Zeroed KV rings {k, v}: [L, B, cap, H, hd] in ``cfg.kv_dtype``."""
    return init_kv_state(cfg.mha, batch, device, cfg.num_layers)


def _check_stacked(cfg: TransformerConfig, params, x):
    """The decode path this port covers: T = 1, rms norms, silu gating,
    quantized projections without biases (the JAX package's
    can_use_stacked_decode)."""
    if x.shape[1] != 1:
        raise NotImplementedError(
            f"only T=1 decode is ported (got T={x.shape[1]})")
    if not cfg.norm.startswith("rms_norm") or cfg.gating != "silu":
        raise NotImplementedError("only rms-norm + silu-gating stacks")
    lay = params["layers"]
    for mod in (lay["self_attn"]["in_proj"], lay["self_attn"]["out_proj"],
                lay["gating"]["linear_in"], lay["gating"]["linear_out"]):
        if not isinstance(mod["weight"], QuantTensor) or \
                mod.get("bias") is not None:
            raise NotImplementedError(
                "only quantized projections without biases are ported")


def transformer_forward(cfg: TransformerConfig, params, state, x, offset):
    """x [B, 1, D] f32, offset [B] int32 (position of x) ->
    (y [B, 1, D], state with the rings written in place)."""
    _check_stacked(cfg, params, x)
    lay = params["layers"]
    b = x.shape[0]
    mha = cfg.mha
    hd = mha.head_dim
    in_w = lay["self_attn"]["in_proj"]["weight"]
    out_w = lay["self_attn"]["out_proj"]["weight"]
    glu_w = lay["gating"]["linear_in"]["weight"]
    lout_w = lay["gating"]["linear_out"]["weight"]
    n1, n2 = lay["norm1"]["alpha"], lay["norm2"]["alpha"]
    dl = in_w.q.shape[-2] // 3
    h = dl // hd
    k_stack, v_stack = state["k"], state["v"]
    cos_sin = (rope_angles(offset[:, None], hd, mha.rope_max_period)
               if mha.rope_max_period else None)
    ks = torch.empty((cfg.num_layers, b, h, hd), dtype=k_stack.dtype,
                     device=x.device)
    vs = torch.empty_like(ks)
    hcur = x[:, 0]
    for layer in range(cfg.num_layers):
        qkv = qmatmul_stacked(hcur, in_w, layer, alpha=n1)       # [B, 3dl]
        if cos_sin is not None:
            qk = apply_rope(qkv[:, :2 * dl].reshape(b, 1, 2 * h, hd),
                            cos_sin=cos_sin)
            q, k_new = qk[:, 0, :h], qk[:, 0, h:]
        else:
            q = qkv[:, :dl].reshape(b, h, hd)
            k_new = qkv[:, dl:2 * dl].reshape(b, h, hd)
        v_new = qkv[:, 2 * dl:].reshape(b, h, hd)
        ks[layer] = k_new
        vs[layer] = v_new
        attn = decode_attention_stacked(
            q.to(torch.bfloat16).contiguous(), k_stack, v_stack,
            ks[layer].to(torch.bfloat16), vs[layer].to(torch.bfloat16),
            offset, layer, cap=mha.cap, context=cfg.context)
        attn = attn.reshape(b, dl).to(torch.bfloat16)
        o = qmatmul_stacked(attn, out_w, layer)
        hcur = hcur + o.to(hcur.dtype)
        g = glu_matmul_stacked(hcur, glu_w, layer, alpha=n2)
        ffn = qmatmul_stacked(g.to(torch.bfloat16), lout_w, layer)
        hcur = hcur + ffn.to(hcur.dtype)
    slot = torch.remainder(offset, mha.cap).to(torch.int32)
    ring_write_stacked(k_stack, v_stack, ks, vs, slot)
    return hcur[:, None], {"k": k_stack, "v": v_stack}
