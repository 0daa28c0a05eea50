"""Streaming transformer stack: the T = 1 stacked decode of the LM, and the
generic layer path of Mimi's stacks.

Counterpart of ``moshi_tpu/nn/transformer.py`` (``TransformerConfig``,
``init_transformer_state``, ``_forward_stacked_decode``,
``transformer_layer`` and the dispatch of ``transformer_forward``).

The stacked decode passes the whole stacked weight and ring tensors to
the kernels with its layer index; the current token's k/v seed the
attention, and after the layer loop one ring write stores every layer's
k/v at slot offset % cap.  Between attention and the FFN's linear_out it
takes, as the JAX package does by default, the fused K5 form
(``quant/fused.py``: out_proj + residual + norm2 + GLU in one launch,
h_mid kept in f32) wherever ``fuse_mid_ok`` allows (the switch
MOSHI_TPU_FUSE_MID and the shapes), and otherwise out_proj, the residual, and the norm-fused GLU as separate
matvecs.  While a capture recorder is active (``utils/capture.py``) it
takes the separate form too, as the JAX package does, and records, under
the ``tap`` prefix the LM passes (``lm/temporal``), the rings and the
offset once a frame before the ring write (``ring_k``, ``ring_v``,
``offset``) and per layer ``x_in``, ``qkv``, ``attn_ctx``, ``attn_out``,
``ffn_in``, ``glu_out`` and ``layer_out``, in the JAX package's order.  The
generic path records each layer's ``attn_out`` and ``ffn_out``.  With
several sessions (B > 1) the fusion is off, as it takes one row, and
every product takes the dequant kernels (``quant/matmul.py``): K2 for the
projections and K8 for a q4_k or q8_0 GLU; K3 and K4 take each session's
own offset.

The generic path runs layer by layer on each layer's slice of the stacked
parameters and rings (views, written in place): with rms norms, as the
dense STT LM has, the pre-norms fuse into the qkv projection and the
gated FFN's linear_in (``gating_mlp``), and its T = 1 attention runs K11
and K9; with layer norms (Mimi's stacks, T = 2) the norms run apart,
with layer scales and the gelu FFN.  A stack with cross-attention (the
voice-conditioned TTS models) always takes the generic path, quantized or
not, as in the JAX package: after the self-attention's residual each
layer adds ``cross_mha`` of its layer-normed (eps 1e-5) stream to that
layer's cross K/V (``transformer_cross_kv``), where one is given.  Its
quantized GLU then takes K1 at one row and K7 (the flat dequant GLU) at
several.

The KV rings [L, B, cap, H, hd] are bf16 or float8_e4m3fn
(``kv_dtype``) and are updated IN PLACE: the state returned holds the same
tensors as the state passed in.  On fp8 rings the stacked decode keeps
each layer's k/v rows in f32 until the ring write, which converts them
straight to fp8 (``nn/ring.py`` ``fp8_cast``'s rule), and seeds K3 with
the rows rounded to bf16, as the JAX package does.

The megakernel path (``MOSHI_TPU_MEGAKERNEL`` = temporal or all, read at
each call; ``can_use_temporal_megakernel``) runs the whole q4_k stack at
B = 1 as one K13 launch (``nn/temporal.py``).  It is chosen by the state's
layout: ``init_transformer_state(..., flat=True)`` allocates flat rings
[L, cap_pad, dim] in ``kv_dtype`` (cap padded to K13's ring chunk), and
``transformer_forward`` sends a state with 3-D rings to
``_forward_megakernel``, which writes the kernel's k/v rows (already in
the rings' dtype, fp8 by ``fp8_cast``'s rule) at slot offset % cap with
one in-place write per ring.  The flat layout takes only T = 1 without
cross-attention; anything else raises.

Weights in unpacked int8 storage (``quant/formats.py``
``i8_storage_tree``) take the stacked decode at one row only
(``storage_ok``), as in the JAX package.  Under ``MOSHI_TPU_MEGAKERNEL``
they raise: K13 reads packed nibbles, and the JAX package's gate, which
checks the format and not the storage, sends such weights to its K13,
which misreads them (ROADMAP C).

Under a parallel scope (``parallel/``), read at each call, the stacked
decode of the stack runs sharded, in the JAX package's precedence: a
``pp_scope`` that matches the stack pipelines its layers
(``parallel/pp.py``), with ``tp_scope`` too each stage on its TP shards
(``parallel/tp_pp.py``), and ``tp_scope`` alone runs the stack on this
rank's head and column shards (``parallel/tp.py``).  Under TP the stacked
decode takes the separate form (the psum over ``model`` lands between
out_proj and the residual, and after linear_out) and records no taps.  A
quantized stack that misses the stacked decode's preconditions under
either scope raises, as in the JAX package: the generic path would compute
on shards as if they were whole weights.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from moshi_tpu_torch.nn.attention import (MHAConfig, attn_shared,
                                          cross_attention_kv, cross_mha,
                                          init_kv_state, streaming_mha)
from moshi_tpu_torch.nn.decode_attention import chunk_for, \
    decode_attention_stacked
from moshi_tpu_torch.nn.gating import gating_mlp, mlp_gelu
from moshi_tpu_torch.nn.layers import apply_norm, layer_scale
from moshi_tpu_torch.nn.ring import ring_index_copy_, ring_write_stacked
from moshi_tpu_torch.nn.rope import apply_rope, rope_angles
from moshi_tpu_torch.nn.temporal import plan_stages, temporal_full_step
from moshi_tpu_torch.parallel.mesh import psum
from moshi_tpu_torch.parallel.pp import current_pp, pipeline_decode
from moshi_tpu_torch.parallel.tp import current_tp
from moshi_tpu_torch.quant.formats import (QuantTensor, i8_storage,
                                           layout_ok, storage_ok)
from moshi_tpu_torch.quant.fused import attn_ffn_fused_i8, fuse_mid_ok
from moshi_tpu_torch.quant.matmul import glu_matmul_stacked, qmatmul_stacked
from moshi_tpu_torch.utils.capture import capture, recording_active


@dataclass(frozen=True)
class TransformerConfig:
    dim: int
    num_heads: int
    num_layers: int
    hidden_dim: int                    # FFN hidden (gating: per half)
    context: int
    capacity: int = 0                  # 0 -> context
    norm: str = "rms_norm_f32"         # or "layer_norm"
    gating: str = "silu"               # "" -> linear1/linear2 gelu FFN
    use_layer_scale: bool = False
    rope_max_period: float = 10_000.0  # 0 -> no positional embedding
    bias_proj: bool = False            # attention projection biases
    bias_ffn: bool = False             # FFN biases
    cross_attention: bool = False
    norm_cross: str = "layer_norm"     # the cross-attention's pre-norm
    kv_dtype: torch.dtype = torch.bfloat16

    @property
    def mha(self) -> MHAConfig:
        return MHAConfig(dim=self.dim, num_heads=self.num_heads,
                         context=self.context, capacity=self.capacity,
                         rope_max_period=self.rope_max_period,
                         kv_dtype=self.kv_dtype)


def init_transformer_state(cfg: TransformerConfig, batch: int, device,
                           flat: bool = False):
    """Zeroed KV rings {k, v}: [L, B, cap, H, hd] in ``cfg.kv_dtype``, or
    with ``flat`` the megakernel's layout [L, cap_pad, dim] (B = 1 only;
    cap padded to K13's chunk multiple, the ring arithmetic still on
    cap)."""
    if flat:
        if batch != 1:
            raise ValueError(f"the flat KV layout holds one session, not "
                             f"{batch}")
        cap_pad = plan_stages(cfg.dim, cfg.hidden_dim, cfg.mha.cap)[5]
        shape = (cfg.num_layers, cap_pad, cfg.dim)
        return {"k": torch.zeros(shape, dtype=cfg.kv_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.kv_dtype, device=device)}
    return init_kv_state(cfg.mha, batch, device, cfg.num_layers)


def refuse_i8_storage(w, kernel: str):
    """Raise on a q4_k weight in unpacked int8 storage that a megakernel
    would take: K13 and K14 read packed nibbles.  The JAX package's gates
    check the format only, and its kernels then read the int8 values as
    nibbles (ROADMAP C)."""
    if isinstance(w, QuantTensor) and i8_storage(w):
        raise NotImplementedError(
            f"{kernel} (MOSHI_TPU_MEGAKERNEL) reads packed q4_k nibbles, and "
            f"this {w.fmt} weight holds unpacked i8 storage: the JAX "
            f"package's gate admits it and its kernel misreads the int8 "
            f"values as nibbles (ROADMAP C).  Keep packed storage, or leave "
            f"MOSHI_TPU_MEGAKERNEL unset")


def can_use_temporal_megakernel(cfg: TransformerConfig, params,
                                batch: int) -> bool:
    """K13's preconditions, as the JAX package's (its Pallas switch is
    always on here): MOSHI_TPU_MEGAKERNEL temporal or all (read at each
    call), B = 1, rope with an even head dim, rms norms + silu gating, no
    cross-attention or layer scale, and all four projections q4_k
    QuantTensors without a bias.  A projection in unpacked int8 storage
    raises (``refuse_i8_storage``) where the JAX package goes on."""
    if os.environ.get("MOSHI_TPU_MEGAKERNEL", "") not in ("temporal", "all"):
        return False
    if batch != 1:
        return False
    if cfg.cross_attention or cfg.use_layer_scale:
        return False
    if not cfg.norm.startswith("rms_norm") or cfg.gating != "silu":
        return False
    if not cfg.rope_max_period or (cfg.dim // cfg.num_heads) % 2:
        return False
    lay = params["layers"]
    if "gating" not in lay:
        return False
    for lf in (lay["self_attn"]["in_proj"], lay["self_attn"]["out_proj"],
               lay["gating"]["linear_in"], lay["gating"]["linear_out"]):
        w = lf.get("weight")
        if not (isinstance(w, QuantTensor) and w.fmt == "q4_k"):
            return False
        if "bias" in lf:
            return False
        refuse_i8_storage(w, "the temporal megakernel (K13)")
    return True


def _forward_megakernel(cfg: TransformerConfig, params, state, x, offset):
    """The whole stack in one K13 launch on the flat state: x [1, 1, D],
    offset [1] -> (y [1, 1, D], state with the rings written in place at
    slot offset % cap)."""
    lay = params["layers"]
    pos = offset.reshape(-1)[:1].to(torch.int32)
    cos_sin = rope_angles(pos, cfg.mha.head_dim, cfg.rope_max_period)
    weights = {
        "qkv": lay["self_attn"]["in_proj"]["weight"],
        "out": lay["self_attn"]["out_proj"]["weight"],
        "glu": lay["gating"]["linear_in"]["weight"],
        "lout": lay["gating"]["linear_out"]["weight"],
        "n1": lay["norm1"]["alpha"],
        "n2": lay["norm2"]["alpha"],
    }
    h_out, k_new, v_new = temporal_full_step(
        x[:, 0], state["k"], state["v"], pos, cos_sin, weights,
        cap=cfg.mha.cap, context=cfg.context, heads=cfg.num_heads,
        hidden=cfg.hidden_dim, nlayers=cfg.num_layers)
    slot = torch.remainder(pos.long(), cfg.mha.cap)
    for name, rows in (("k", k_new), ("v", v_new)):
        ring_index_copy_(state[name], 1, slot, rows)
    return h_out[:, None].to(x.dtype), state


def can_use_stacked_decode(cfg: TransformerConfig, params, x,
                           cross_kv=None) -> bool:
    """The stacked decode's preconditions, as the JAX package's with
    Pallas on: T = 1, no cross-attention (in the config or in the call),
    no layer scale, rms norms + silu gating, a ring the attention kernel
    can chunk, and all four projections quantized in a kernel layout and
    a storage the kernels take at B rows (``storage_ok``: unpacked int8
    at one row only), without biases.  (The JAX package also reads
    MOSHI_TPU_NO_STACKED, its switch back to a weight layout the port does
    not have.)"""
    if x.shape[1] != 1 or cross_kv is not None:
        return False
    if cfg.cross_attention or cfg.use_layer_scale:
        return False
    if not cfg.norm.startswith("rms_norm") or cfg.gating != "silu":
        return False
    lay = params["layers"]
    if "gating" not in lay:
        return False
    c = chunk_for(cfg.mha.cap)
    if c < 8 and c != cfg.mha.cap:
        return False
    for mod in (lay["self_attn"]["in_proj"], lay["self_attn"]["out_proj"],
                lay["gating"]["linear_in"], lay["gating"]["linear_out"]):
        w = mod.get("weight")
        if not (isinstance(w, QuantTensor) and layout_ok(w)):
            return False
        if not storage_ok(w, x.shape[0]):
            return False
        if mod.get("bias") is not None:
            return False
    return True


def _forward_stacked_decode(cfg: TransformerConfig, params, state, x,
                            offset, tap=None, tp=None):
    """x [B, 1, D], offset [B] int32 -> (y [B, 1, D], state).  ``tap``
    prefixes the capture points, recorded only while a recorder is
    active (the rings before their write).  ``tp`` (a
    ``parallel.tp.TPContext``): the weights are this rank's head and
    column shards, the local head count follows from the fused qkv's
    rows, and out_proj's and linear_out's partials are summed over the
    model axis."""
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
    recording = recording_active()
    if not recording or tp is not None:
        tap = None
    fuse_mid = not recording and tp is None and fuse_mid_ok(out_w, glu_w, b)
    cos_sin = (rope_angles(offset[:, None], hd, mha.rope_max_period)
               if mha.rope_max_period else None)
    # the rows as K4 takes them: bf16 for a bf16 ring, f32 for fp8 (the
    # JAX package casts its f32 rows straight to fp8)
    row_dtype = (torch.bfloat16 if k_stack.dtype == torch.bfloat16
                 else torch.float32)
    ks = torch.empty((cfg.num_layers, b, h, hd), dtype=row_dtype,
                     device=x.device)
    vs = torch.empty_like(ks)
    hcur = x[:, 0]
    if tap:
        capture(f"{tap}/ring_k", k_stack)
        capture(f"{tap}/ring_v", v_stack)
        capture(f"{tap}/offset", offset)
    for layer in range(cfg.num_layers):
        if tap:
            capture(f"{tap}/x_in", hcur)
        qkv = qmatmul_stacked(hcur, in_w, layer, alpha=n1)       # [B, 3dl]
        if tap:
            capture(f"{tap}/qkv", qkv)
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
            _bf16_row(ks[layer], k_new), _bf16_row(vs[layer], v_new),
            offset, layer, cap=mha.cap, context=cfg.context)
        attn = attn.reshape(b, dl).to(torch.bfloat16)
        if tap:
            capture(f"{tap}/attn_ctx", attn)
        if fuse_mid:
            g, h_mid = attn_ffn_fused_i8(attn, hcur, out_w, glu_w, n2, layer)
            ffn = qmatmul_stacked(g.to(torch.bfloat16), lout_w, layer)
            hcur = (h_mid + ffn).to(hcur.dtype)
            continue
        o = qmatmul_stacked(attn, out_w, layer)
        if tp is not None:
            o = psum(tp.mesh, tp.model_axis, o)
        if tap:
            capture(f"{tap}/attn_out", o)
        hcur = hcur + o.to(hcur.dtype)
        if tap:
            capture(f"{tap}/ffn_in", hcur)
        g = glu_matmul_stacked(hcur, glu_w, layer, alpha=n2)
        if tap:
            capture(f"{tap}/glu_out", g)
        ffn = qmatmul_stacked(g.to(torch.bfloat16), lout_w, layer)
        if tp is not None:
            ffn = psum(tp.mesh, tp.model_axis, ffn)
        hcur = hcur + ffn.to(hcur.dtype)
        if tap:
            capture(f"{tap}/layer_out", hcur)
    ring_write_stacked(k_stack, v_stack, ks, vs, offset)  # at offset % cap
    return hcur[:, None], {"k": k_stack, "v": v_stack}


def _bf16_row(stored, row):
    """K3's seed: the layer's f32 row rounded to bf16 (the JAX package's
    k_new.astype(bf16)), which a bf16 ring's stored row already is."""
    if stored.dtype == torch.bfloat16:
        return stored
    return row.to(torch.bfloat16).contiguous()


def _layer_slice(tree, layer: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, layer) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return tree._map(lambda a: a[layer])
    return tree[layer]


def transformer_layer(cfg: TransformerConfig, params, kv_state, x, offset,
                      cross_kv=None, shared=None, tap=None):
    """One layer of the generic path: x [B, T, D] -> (y, kv_state with
    its rings [B, cap, H, hd] written in place).  With rms norms the
    pre-norms fuse into the following projections; ``cross_kv`` {k, v:
    [B, S, H, hd]} is this layer's cross K/V.  ``tap`` prefixes the
    layer's capture points (``attn_out``, ``ffn_out``)."""
    fuse_rms = cfg.norm.startswith("rms_norm")
    if fuse_rms:
        attn, new_kv = streaming_mha(
            cfg.mha, params["self_attn"], kv_state, x, offset,
            shared=shared, pre_norm_alpha=params["norm1"]["alpha"])
    else:
        h = apply_norm(cfg.norm, params["norm1"], x)
        attn, new_kv = streaming_mha(cfg.mha, params["self_attn"], kv_state,
                                     h, offset, shared=shared)
    if cfg.use_layer_scale:
        attn = layer_scale(params["layer_scale_1"], attn)
    if tap:
        capture(f"{tap}/attn_out", attn)
    x = x + attn
    if cfg.cross_attention and cross_kv is not None:
        hc = apply_norm(cfg.norm_cross, params["norm_cross"], x)
        x = x + cross_mha(cfg.mha, params["cross_attention"], hc, cross_kv)
    if cfg.gating and fuse_rms:
        ffn = gating_mlp(params["gating"], x, cfg.gating,
                         pre_norm_alpha=params["norm2"]["alpha"])
    else:
        h2 = apply_norm(cfg.norm, params["norm2"], x)
        ffn = (gating_mlp(params["gating"], h2, cfg.gating) if cfg.gating
               else mlp_gelu(params, h2))
    if cfg.use_layer_scale:
        ffn = layer_scale(params["layer_scale_2"], ffn)
    if tap:
        capture(f"{tap}/ffn_out", ffn)
    return x + ffn, new_kv


def transformer_forward(cfg: TransformerConfig, params, state, x, offset,
                        cross_kv=None, tap=None):
    """x [B, T, D], offset [B] int32 (position of x[:, 0]) ->
    (y [B, T, D], state with the rings written in place).  ``cross_kv``
    {k, v: [L, B, S, H, hd]} holds every layer's cross K/V.  A flat state
    ([L, cap_pad, D] rings) takes the megakernel; otherwise the stacked
    decode where its preconditions hold (sharded under a parallel scope),
    else the generic path.  ``tap``
    prefixes the capture points of either path (the megakernel has
    none)."""
    if state["k"].dim() == 3:
        # the megakernel decodes one position: T > 1 (prefill) or
        # cross-attention against the flat layout must fail, not drop
        # tokens
        if x.shape[1] != 1 or cross_kv is not None:
            raise ValueError(
                "flat megakernel KV layout only supports T=1 decode "
                f"without cross-attention (got T={x.shape[1]}, "
                f"cross_kv={'set' if cross_kv is not None else 'None'})")
        return _forward_megakernel(cfg, params, state, x, offset)
    pp = current_pp()
    pp = pp if pp is not None and pp.matches(cfg) else None
    tp = current_tp()
    if can_use_stacked_decode(cfg, params, x, cross_kv):
        if pp is not None:
            # the GPipe schedule over this stage's layers (on TP shards
            # under both scopes)
            return pipeline_decode(cfg, params, state, x, offset, pp, tp=tp)
        return _forward_stacked_decode(cfg, params, state, x, offset, tap,
                                       tp=tp)
    if (tp is not None or pp is not None) and isinstance(
            params["layers"]["self_attn"]["in_proj"].get("weight"),
            QuantTensor):
        # a quantized stack under a scope holds shards: the generic path
        # would run them as whole weights
        raise ValueError(
            "tp_scope/pp_scope is active but this quantized transformer "
            "does not satisfy the stacked-decode preconditions "
            f"(T={x.shape[1]}, cross={cross_kv is not None})")
    shared = attn_shared(cfg.mha, offset, x.shape[1])
    if not recording_active():
        tap = None
    for layer in range(cfg.num_layers):
        kv = {"k": state["k"][layer], "v": state["v"][layer]}
        ckv = (None if cross_kv is None else
               {"k": cross_kv["k"][layer], "v": cross_kv["v"][layer]})
        x, _ = transformer_layer(cfg, _layer_slice(params["layers"], layer),
                                 kv, x, offset, cross_kv=ckv, shared=shared,
                                 tap=tap)
    return x, state


def transformer_cross_kv(cfg: TransformerConfig, params, cond):
    """Every layer's cross K/V for the conditioning [B, S, D], once per
    session: {k, v: [L, B, S, H, hd]}."""
    per_layer = [cross_attention_kv(
        cfg.mha, _layer_slice(params["layers"]["cross_attention"], layer),
        cond) for layer in range(cfg.num_layers)]
    return {name: torch.stack([kv[name] for kv in per_layer])
            for name in ("k", "v")}
