"""Moshi dual-transformer LM frame step: temporal transformer + depformer
+ delay cache.

Counterpart of ``moshi_tpu/models/lm.py`` for the decode frame
(``lm_gen_step``): embed the delayed input frame, run the temporal stack
(``nn/transformer.py``), out_norm, text head and text sampling, then the
depformer's dep_q steps over their per-step weights, and the delay-cache
update and read.  Tokens use the same sentinels (UNGENERATED = -2,
ZERO = -1).

The temporal stack takes the stacked decode where its preconditions hold
(the q4_k 7B) and otherwise the generic layer path (the dense bf16 STT
models and every model with cross-attention, the voice-conditioned TTS
class, whose T = 1 attention runs K9 and K11); with ``extra_heads_num >
2`` the frame also returns the VAD probability of extra head 2.  The
depformer takes its stacked form where ``_can_use_dep_stacked`` holds
(quantized projections without biases, a ring of at least dep_q slots)
and otherwise the generic form: per step, ``transformer_layer`` on each of
its layers at T = 1 (K11 and K9 at its ring), with an f32 carry.

With ``MOSHI_TPU_MEGAKERNEL`` (read at each call, as in the JAX package)
the frame at B = 1 takes the megakernels: ``temporal`` or ``all`` runs
the temporal stack as one K13 launch where ``init_gen_state`` was given
the weights and chose the flat ring layout (``nn/transformer.py``);
``dep`` or ``all`` runs the depformer as one K14c launch per frame
(``_can_use_dep_frame_kernel``: embedding, layers, logits and sampling,
the Gumbel noise drawn from the generator beforehand), or, where that
does not hold but ``_can_use_dep_megakernel`` does, one K14a launch per
step with the logits through ``linear`` (K1) and ``sample_token``.

``LMConfig.kv_dtype = "float8_e4m3fn"`` stores the temporal rings in fp8
(half the KV bytes of bf16): K3/K4 (stacked), K9/K11 (generic) or K13
(the megakernel, on fp8 flat rings) take their fp8 forms; the
depformer's rings stay bf16.

Weights in unpacked int8 storage (``quant/formats.py``
``i8_storage_tree``, the JAX package's ``bench.py --i8-storage``) run at
B = 1: every product they hold goes to K1 or K5 in their i8 form, and the
weights left packed (the 7B depformer's q4_0 linear_out, the embeddings)
as before.  Under ``MOSHI_TPU_MEGAKERNEL`` such weights raise.

With ``demux_second_stream`` the text stream is demuxed
(``nn/layers.py`` ``demux_embedding``: two ids from one, each through the
shared table and its own dim x dim projection, ``out1`` / ``out2``, which
the q4_k policy quantizes, so at one row they run K1), in the temporal
embedding and in the depformer's text embedding.  With
``depformer_pos_emb = "rope"`` the depformer's q and k are rotated at the
step index (its ring's position), in the stacked form between the qkv
product and the bf16 cast, as the JAX package does; the megakernels'
gates refuse it.

Differences from the JAX package, by design: sampling takes an explicit
``torch.Generator`` (the JAX state carried a threefry key), the KV rings
are updated in place, and there is no tensor/pipeline parallelism.
Both stacks take the fused K5 form between
attention and linear_out wherever the JAX package does (its default,
``MOSHI_TPU_FUSE_MID`` unset or 1); with ``MOSHI_TPU_FUSE_MID=0`` out_proj,
the residual and the norm-fused GLU run as separate matvecs.  With several
sessions in a frame (B > 1) nothing takes the int8 kernels: the text head
and the depformer in-projection run on K6 (``formats.qmatmul``), the
layers on K2 and K8, the depformer's logits on K2, and each session
samples its own row from the shared generator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import torch

from moshi_tpu_torch.config import MoshiConfig
from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.nn.decode_attention import decode_attention_stacked
from moshi_tpu_torch.nn.layers import (demux_embedding, linear, rms_norm,
                                       scaled_embedding)
from moshi_tpu_torch.nn.rope import apply_rope, rope_angles
from moshi_tpu_torch.nn.sampling import gumbel, sample_token
from moshi_tpu_torch.nn.attention import attn_shared
from moshi_tpu_torch.nn.depformer import dep_frame_step, dep_full_step
from moshi_tpu_torch.nn.transformer import (TransformerConfig, _layer_slice,
                                            can_use_temporal_megakernel,
                                            init_transformer_state,
                                            refuse_i8_storage,
                                            transformer_forward,
                                            transformer_layer)
from moshi_tpu_torch.quant.formats import (QuantTensor, flatten_lead,
                                           layout_ok, qmatmul, storage_ok)
from moshi_tpu_torch.quant.fused import attn_ffn_fused_i8, fuse_mid_ok
from moshi_tpu_torch.quant.matmul import glu_matmul_stacked, qmatmul_stacked

UNGENERATED = -2
ZERO = -1
# LMConfig.kv_dtype, spelled as the JAX package spells it: the temporal
# rings' storage (fp8 halves each session's KV bytes; the depformer's
# rings stay bf16, as the JAX package's ``depformer`` property passes no
# kv_dtype)
KV_DTYPES = {"bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn}


@dataclass(frozen=True)
class LMConfig:
    dim: int = 4096
    num_heads: int = 32
    num_layers: int = 32
    hidden_dim: int = 11264
    context: int = 3000
    max_period: float = 10_000.0
    cross_attention: bool = False
    card: int = 2048
    n_q: int = 16
    dep_q: int = 8
    text_card: int = 32_000
    delays: Tuple[int, ...] = ()
    demux_second_stream: bool = False
    depformer_dim: int = 1024
    depformer_heads: int = 16
    depformer_layers: int = 6
    depformer_hidden: int = 4224
    depformer_context: int = 0       # 0 -> weights_per_step count
    depformer_max_period: float = 10_000.0
    depformer_pos_emb: str = "none"
    depformer_multi_linear: bool = True
    depformer_schedule: Tuple[int, ...] = ()
    depformer_low_rank: int = 128
    extra_heads_num: int = 0
    extra_heads_dim: int = 2
    delay_steps: int = 0             # audio_delay * frame_rate
    personaplex: bool = False
    kv_dtype: str = "bfloat16"       # temporal KV rings: or float8_e4m3fn

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r}: the rings are "
                             f"one of {sorted(KV_DTYPES)}")

    @property
    def num_codebooks(self) -> int:
        return self.n_q + 1

    @property
    def runtime_dep_q(self) -> int:
        return 8 if self.personaplex else self.dep_q

    @property
    def max_delay(self) -> int:
        return max(self.delays) if self.delays else 0

    @property
    def cache_len(self) -> int:
        return self.max_delay + 2 + (1 if self.personaplex else 0)

    @property
    def schedule(self) -> Tuple[int, ...]:
        if self.depformer_schedule:
            return self.depformer_schedule
        return tuple(range(self.dep_q))

    @property
    def depformer_num_weights(self) -> int:
        return (max(self.schedule) + 1) if self.depformer_multi_linear else 1

    @property
    def text_initial(self) -> int:
        return self.text_card

    @property
    def audio_initial(self) -> int:
        return self.card

    @property
    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, num_heads=self.num_heads,
            num_layers=self.num_layers, hidden_dim=self.hidden_dim,
            context=self.context, rope_max_period=self.max_period,
            cross_attention=self.cross_attention, norm_cross="layer_norm",
            kv_dtype=KV_DTYPES[self.kv_dtype])

    @property
    def depformer(self) -> TransformerConfig:
        cap = self.depformer_context or len(self.schedule) or self.dep_q
        rope = (self.depformer_max_period
                if self.depformer_pos_emb == "rope" else 0.0)
        return TransformerConfig(
            dim=self.depformer_dim, num_heads=self.depformer_heads,
            num_layers=self.depformer_layers,
            hidden_dim=self.depformer_hidden, context=cap, capacity=cap,
            rope_max_period=rope)

    @classmethod
    def from_moshi_config(cls, c: MoshiConfig, frame_rate: float = 12.5,
                          audio_delay: float = 0.0) -> "LMConfig":
        return cls(
            dim=c.dim, num_heads=c.num_heads, num_layers=c.num_layers,
            hidden_dim=int(c.dim * c.hidden_scale), context=c.context,
            max_period=float(c.max_period),
            cross_attention=c.cross_attention, card=c.card, n_q=c.n_q,
            dep_q=c.dep_q, text_card=c.text_card,
            delays=tuple(c.delays or [0] * (c.n_q + 1)),
            demux_second_stream=c.demux_second_stream,
            depformer_dim=c.depformer_dim,
            depformer_heads=c.depformer_num_heads,
            depformer_layers=c.depformer_num_layers,
            depformer_hidden=(c.depformer_dim_feedforward
                              or int(c.depformer_dim *
                                     (c.depformer_hidden_scale or 4.125))),
            depformer_context=c.depformer_context,
            depformer_max_period=float(c.depformer_max_period or 10_000),
            depformer_pos_emb=c.depformer_pos_emb,
            depformer_multi_linear=c.depformer_multi_linear,
            depformer_schedule=tuple(c.depformer_weights_per_step_schedule),
            depformer_low_rank=c.depformer_low_rank_embeddings,
            extra_heads_num=c.extra_heads_num_heads,
            extra_heads_dim=c.extra_heads_dim or 2,
            delay_steps=int(round(audio_delay * frame_rate)),
            personaplex=(c.model_type == "personaplex"),
        )


# ---------------------------------------------------------------------------
# temporal transformer
# ---------------------------------------------------------------------------

def embed_frame(cfg: LMConfig, params, tokens, condition_sum=None):
    """tokens [B, T, K] (text stream 0 + n_q audio) -> [B, T, dim] f32."""
    x = _text_embed(cfg, params["text_emb"], tokens[..., 0])
    table = params["emb"]["weight"]                  # [n_q, card+1, dim]
    audio = []
    for i in range(cfg.n_q):
        ti = (table._map(lambda a: a[i]) if isinstance(table, QuantTensor)
              else table[i])
        audio.append(scaled_embedding({"weight": ti}, tokens[..., 1 + i]))
    x = x + torch.stack(audio).sum(dim=0)
    if condition_sum is not None:
        x = x + condition_sum[:, None, :].to(x.dtype)
    return x


def _text_embed(cfg: LMConfig, params, ids):
    if cfg.demux_second_stream:
        return demux_embedding(params, ids, cfg.text_card + 1)
    return scaled_embedding(params, ids)


def temporal_forward(cfg: LMConfig, params, kv_state, tokens, offset,
                     condition_sum=None, cross_kv=None):
    """tokens [B, 1, K] -> (transformer_out [B, 1, dim] after out_norm,
    text_logits [B, 1, text_card] f32, kv_state written in place)."""
    x = embed_frame(cfg, params, tokens, condition_sum)
    h, new_kv = transformer_forward(cfg.transformer, params["transformer"],
                                    kv_state, x, offset, cross_kv)
    h = rms_norm(params["out_norm"], h)
    logits = linear(params["text_linear"], h, out_dtype=torch.float32)
    return h, logits, new_kv


# ---------------------------------------------------------------------------
# depformer
# ---------------------------------------------------------------------------

def _per_step_weights(cfg: LMConfig, dep):
    """The per-step weights [dep_q, ...] in schedule order (a no-op view
    for the identity schedule)."""
    dep_q = cfg.runtime_dep_q
    sched = (list(cfg.schedule[:dep_q]) if len(cfg.schedule) >= dep_q
             else list(range(dep_q)))
    ident = (sched == list(range(dep_q))
             and cfg.depformer_num_weights == dep_q)

    def sel(tree):
        if ident:
            return tree
        if isinstance(tree, dict):
            return {k: sel(v) for k, v in tree.items()}
        if isinstance(tree, QuantTensor):
            return tree._map(lambda a: a[sched])
        return tree[sched]

    def head(tree, n):
        if isinstance(tree, dict):
            return {k: head(v, n) for k, v in tree.items()}
        if isinstance(tree, QuantTensor):
            return tree._map(lambda a: a[:n])
        return tree[:n]

    xs = {
        "in": sel(dep["in"]),                         # [dep_q, dd, dim]
        "attn": sel(dep["layers"]["self_attn"]),      # [dep_q, L, ...]
        "gating": sel(dep["layers"]["gating"]),       # [dep_q, L, ...]
        "linears": head(dep["linears"], dep_q),       # [dep_q, card, dd]
    }
    if cfg.dep_q > 1:
        # step cb uses emb[cb - 1]; step 0 embeds the text token instead
        xs["emb"] = dep["emb"]
    return xs


def _depformer_text_embed(cfg: LMConfig, dep, text_token):
    return _text_embed(cfg, dep["text_emb"], text_token)


def _depformer_generate_stacked(cfg: LMConfig, norms, text_emb,
                                transformer_out, text_token, step_w,
                                temp: float, top_k: int, generator=None):
    """The dep_q-step loop: per step, the (step, layer) weights are read
    from the whole stacked buffers by the flat index cb * L + l; the
    per-frame KV rings start at zero and take one row per step (a plain
    tensor write, as the JAX package's dynamic_update_slice).  In the
    fused form the residual h_mid stays f32 through norm2 and the carry
    ``hh`` is rounded to bf16 only after linear_out's residual."""
    dcfg = cfg.depformer
    dep_q = cfg.runtime_dep_q
    b = transformer_out.shape[0]
    nl, dd = dcfg.num_layers, dcfg.dim
    mha = dcfg.mha
    hd, cap = mha.head_dim, mha.cap
    attn_in = step_w["attn"]["in_proj"]["weight"]             # [W, L, ...]
    attn_out = step_w["attn"]["out_proj"]["weight"]
    glu_in = step_w["gating"]["linear_in"]["weight"]
    glu_out = step_w["gating"]["linear_out"]["weight"]
    lin_w = step_w["linears"]["weight"]                       # [W, card, dd]
    ddl = attn_in.q.shape[-2] // 3
    nh = ddl // hd
    h_in = qmatmul(transformer_out.to(torch.bfloat16),
                   flatten_lead(step_w["in"]["weight"]))
    h_in_all = h_in.reshape(b, dep_q, dd).transpose(0, 1)     # [W, B, dd]
    # norms are shared across steps: row cb*L + l of the tiled alpha
    # matches the weights' flat (step, layer) order
    n1t = norms["norm1"]["alpha"].repeat(dep_q, 1)
    n2t = norms["norm2"]["alpha"].repeat(dep_q, 1)
    dev = transformer_out.device
    k_stack = torch.zeros((nl, b, cap, nh, hd), dtype=dcfg.kv_dtype,
                          device=dev)
    v_stack = torch.zeros_like(k_stack)
    ks = torch.empty((nl, b, nh, hd), dtype=dcfg.kv_dtype, device=dev)
    vs = torch.empty_like(ks)
    fuse_mid = fuse_mid_ok(attn_out, glu_in, b)
    prev = text_token
    tokens = []
    for cb in range(dep_q):
        if cb == 0 or cfg.dep_q == 1:
            tok_emb = text_emb
        else:
            w_emb = step_w["emb"]
            e = scaled_embedding({"weight": w_emb["weight"][cb - 1]}, prev)
            lr = {k: v[cb - 1] for k, v in w_emb["low_rank"].items()}
            tok_emb = linear(lr, e)
        hh = (h_in_all[cb] + tok_emb).to(torch.bfloat16)       # [B, dd]
        offset_b = torch.full((b,), cb, dtype=torch.int32, device=dev)
        # the rope's angles at the step index, shared by the step's layers
        cos_sin = (rope_angles(offset_b[:, None], hd, dcfg.rope_max_period)
                   if dcfg.rope_max_period else None)
        for layer in range(nl):
            n = cb * nl + layer
            qkv = qmatmul_stacked(hh, attn_in, n, alpha=n1t)
            if cos_sin is not None:
                qk = apply_rope(qkv[:, :2 * ddl].reshape(b, 1, 2 * nh, hd),
                                cos_sin=cos_sin)
                q, ks[layer] = qk[:, 0, :nh], qk[:, 0, nh:]
            else:
                q = qkv[:, :ddl].reshape(b, nh, hd)
                ks[layer] = qkv[:, ddl:2 * ddl].reshape(b, nh, hd)
            vs[layer] = qkv[:, 2 * ddl:].reshape(b, nh, hd)
            attn = decode_attention_stacked(
                q.to(torch.bfloat16).contiguous(),
                k_stack, v_stack, ks[layer], vs[layer], offset_b, layer,
                cap=cap, context=dcfg.context)
            attn = attn.reshape(b, ddl).to(torch.bfloat16)
            if fuse_mid:
                g, h_mid = attn_ffn_fused_i8(attn, hh, attn_out, glu_in, n2t,
                                             n)
                ffn = qmatmul_stacked(g.to(torch.bfloat16), glu_out, n)
                hh = (h_mid + ffn).to(hh.dtype)
                continue
            o = qmatmul_stacked(attn, attn_out, n)
            hh = hh + o.to(hh.dtype)
            g = glu_matmul_stacked(hh, glu_in, n, alpha=n2t)
            ffn = qmatmul_stacked(g.to(torch.bfloat16), glu_out, n)
            hh = hh + ffn.to(hh.dtype)
        slot = cb % cap
        k_stack[:, :, slot] = ks
        v_stack[:, :, slot] = vs
        if isinstance(lin_w, QuantTensor):
            logits = qmatmul_stacked(hh, lin_w, cb)
        else:
            logits = torch.matmul(hh.to(lin_w.dtype).float(),
                                  lin_w[cb].float().T)
        prev = sample_token(logits.float(), temp, top_k, generator)
        tokens.append(prev)
    return torch.stack(tokens, dim=1)                          # [B, dep_q]


def _can_use_dep_stacked(cfg: LMConfig, step_w, b: int) -> bool:
    """The stacked depformer's preconditions at B = ``b``, as the JAX
    package's with Pallas on: rms norms and silu gating, a ring of at
    least dep_q slots, the per-step projections and the input projection
    quantized in a kernel layout and a storage the kernels take at ``b``
    rows (``storage_ok``) without biases, the output linears dense or in a
    kernel layout, and neither they nor the low-rank embedding with a
    bias."""
    dcfg = cfg.depformer
    if not dcfg.norm.startswith("rms_norm") or dcfg.gating != "silu":
        return False
    if dcfg.mha.cap < cfg.runtime_dep_q:
        return False
    for mod in (step_w["attn"]["in_proj"], step_w["attn"]["out_proj"],
                step_w["gating"]["linear_in"], step_w["gating"]["linear_out"],
                step_w["in"]):
        w = mod.get("weight")
        if not (isinstance(w, QuantTensor) and layout_ok(w)):
            return False
        if not storage_ok(w, b):
            return False
        if mod.get("bias") is not None:
            return False
    lw = step_w["linears"].get("weight")
    if isinstance(lw, QuantTensor) and not layout_ok(lw):
        return False
    if step_w["linears"].get("bias") is not None:
        return False
    if cfg.dep_q > 1 and step_w["emb"]["low_rank"].get("bias") is not None:
        return False
    return True


def _depformer_generate_generic(cfg: LMConfig, dep, text_emb,
                                transformer_out, text_token, step_w,
                                temp: float, top_k: int, generator=None):
    """The JAX package's scan form: per step cb, the input projection of
    transformer_out plus the token embedding (the text's at step 0, the
    low-rank embedding of the previous token after), then each layer's
    ``transformer_layer`` at T = 1 on its (step, layer) weights with the
    shared norms (its attention K11 and K9 over the per-frame rings, which
    start at zero), in the carry's dtype (f32), and the step's logits."""
    dcfg = cfg.depformer
    dep_q = cfg.runtime_dep_q
    b = transformer_out.shape[0]
    dev = transformer_out.device
    kv = init_transformer_state(dcfg, b, dev)
    shared_norms = {"norm1": dep["layers"]["norm1"],
                    "norm2": dep["layers"]["norm2"]}
    prev = text_token
    tokens = []
    for cb in range(dep_q):
        w = _layer_slice({k: v for k, v in step_w.items() if k != "emb"}, cb)
        h = linear(w["in"], transformer_out)                   # [B, dd]
        if cb == 0 or cfg.dep_q == 1:
            tok_emb = text_emb
        else:
            w_emb = step_w["emb"]
            e = scaled_embedding({"weight": w_emb["weight"][cb - 1]}, prev)
            lr = {k: v[cb - 1] for k, v in w_emb["low_rank"].items()}
            tok_emb = linear(lr, e)
        x = (h + tok_emb)[:, None, :]                           # [B, 1, dd]
        offset_b = torch.full((b,), cb, dtype=torch.int32, device=dev)
        shared = attn_shared(dcfg.mha, offset_b, 1)
        for layer in range(dcfg.num_layers):
            lp = {"norm1": _layer_slice(shared_norms["norm1"], layer),
                  "norm2": _layer_slice(shared_norms["norm2"], layer),
                  "self_attn": _layer_slice(w["attn"], layer),
                  "gating": _layer_slice(w["gating"], layer)}
            kv_l = {"k": kv["k"][layer], "v": kv["v"][layer]}
            x, _ = transformer_layer(dcfg, lp, kv_l, x, offset_b,
                                     shared=shared)
        logits = linear(w["linears"], x[:, 0]).float()
        prev = sample_token(logits, temp, top_k, generator)
        tokens.append(prev)
    return torch.stack(tokens, dim=1)                          # [B, dep_q]


def _can_use_dep_megakernel(cfg: LMConfig, dep, b: int) -> bool:
    """K14a's preconditions, as the JAX package's (its Pallas switch is
    always on here): MOSHI_TPU_MEGAKERNEL dep or all (read at each call),
    B = 1, no depformer rope, a gated FFN, the qkv, out_proj and GLU
    weights q4_k and linear_out q4_k or q4_0 in a kernel layout, none with
    a bias.  One of them in unpacked int8 storage raises
    (``refuse_i8_storage``: K14 reads packed nibbles) where the JAX
    package goes on."""
    if os.environ.get("MOSHI_TPU_MEGAKERNEL", "") not in ("dep", "all"):
        return False
    if b != 1:
        return False
    if cfg.depformer.rope_max_period or not cfg.depformer.gating:
        return False
    lay = dep["layers"]
    for lf in (lay["self_attn"]["in_proj"], lay["self_attn"]["out_proj"],
               lay["gating"]["linear_in"]):
        w = lf.get("weight")
        if not (isinstance(w, QuantTensor) and w.fmt == "q4_k"):
            return False
        if "bias" in lf:
            return False
        refuse_i8_storage(w, "the depformer megakernel (K14)")
    lo = lay["gating"]["linear_out"]
    w = lo.get("weight")
    if not (isinstance(w, QuantTensor) and w.fmt in ("q4_k", "q4_0")
            and layout_ok(w)):
        return False
    if "bias" in lo:
        return False
    refuse_i8_storage(w, "the depformer megakernel (K14)")
    return True


def _can_use_dep_frame_kernel(cfg: LMConfig, dep, step_w, b: int) -> bool:
    """K14c's preconditions, as the JAX package's: K14a's, dep_q > 1 with
    a low-rank embedding stack, q4_k per-step linears, a card that is a
    multiple of 128, a ring of at least dep_q slots, a quantized input
    projection, unquantized embeddings, and no bias on the input
    projection, the linears or the low-rank embedding."""
    if not _can_use_dep_megakernel(cfg, dep, b):
        return False
    if cfg.runtime_dep_q <= 1 or "emb" not in step_w:
        return False
    lw = step_w["linears"]["weight"]
    if not (isinstance(lw, QuantTensor) and lw.fmt == "q4_k"):
        return False
    if cfg.card % 128:
        return False
    if cfg.depformer.mha.cap < cfg.runtime_dep_q:
        return False
    if not isinstance(step_w["in"]["weight"], QuantTensor):
        return False
    ew = step_w["emb"]["weight"]
    lrw = step_w["emb"]["low_rank"]["weight"]
    if isinstance(ew, QuantTensor) or isinstance(lrw, QuantTensor):
        return False
    for mod in (step_w["in"], step_w["linears"], step_w["emb"]["low_rank"]):
        if mod.get("bias") is not None:
            return False
    return True


def _step_padded(a: torch.Tensor, dep_q: int) -> torch.Tensor:
    """[dep_q - 1, ...] per-step embedding leaves -> [dep_q, ...] with a
    dummy row 0 (step s embeds with row s), the frame kernel's layout."""
    return torch.cat([a[:1], a[:dep_q - 1]], dim=0)


def _depformer_generate_frame_kernel(cfg: LMConfig, params, transformer_out,
                                     text_token, step_w, temp: float,
                                     top_k: int, generator=None):
    """The whole depformer frame in one K14c launch.  The per-step input
    projections do not depend on the tokens, so they are one K1 product
    of transformer_out against the stacked [dep_q * dd, dim] weight; the
    Gumbel noise [dep_q, 1, card] comes from ``generator`` at temp > 0
    (zeros at temp 0)."""
    dep = params["depformer"]
    dcfg = cfg.depformer
    dep_q = cfg.runtime_dep_q
    dd = dcfg.dim
    card = cfg.card
    dev = transformer_out.device
    text_emb = _depformer_text_embed(cfg, dep, text_token)       # [1, dd]
    h_in = qmatmul(transformer_out, flatten_lead(step_w["in"]["weight"]))
    h_in_all = h_in.reshape(dep_q, 1, dd)
    if temp == 0.0:
        noise = torch.zeros((dep_q, 1, card), dtype=torch.float32,
                            device=dev)
    else:
        noise = gumbel((dep_q, 1, card), generator, dev)
    lay = dep["layers"]
    weights = {
        "qkv": step_w["attn"]["in_proj"]["weight"],       # [W, L, 3dd, dd]
        "out": step_w["attn"]["out_proj"]["weight"],
        "glu": step_w["gating"]["linear_in"]["weight"],
        "lout": step_w["gating"]["linear_out"]["weight"],
        "n1": lay["norm1"]["alpha"], "n2": lay["norm2"]["alpha"],
        "linears": step_w["linears"]["weight"],           # [W, card, dd]
        "emb": _step_padded(step_w["emb"]["weight"], dep_q),
        "lr_w": _step_padded(step_w["emb"]["low_rank"]["weight"], dep_q),
    }
    tokens = dep_frame_step(
        h_in_all, text_emb.float(), weights, noise, cap=dcfg.mha.cap,
        heads=dcfg.num_heads, nlayers=dcfg.num_layers, card=card,
        temp=float(temp), top_k=int(top_k))
    return tokens[None, :].long()                                 # [1, W]


def _depformer_generate_megakernel(cfg: LMConfig, params, transformer_out,
                                   text_token, step_w, temp: float,
                                   top_k: int, generator=None):
    """Per step, all depformer layers in one K14a launch on flat rings
    [L, cap, dd] (zeroed per frame), then the step's logits through
    ``linear`` (K1) and ``sample_token``."""
    dep = params["depformer"]
    dcfg = cfg.depformer
    dep_q = cfg.runtime_dep_q
    dd, cap, nl = dcfg.dim, dcfg.mha.cap, dcfg.num_layers
    dev = transformer_out.device
    text_emb = _depformer_text_embed(cfg, dep, text_token)
    k_ring = torch.zeros((nl, cap, dd), dtype=torch.bfloat16, device=dev)
    v_ring = torch.zeros_like(k_ring)
    lay = dep["layers"]
    prev = text_token
    tokens = []
    for cb in range(dep_q):
        w = _layer_slice({k: v for k, v in step_w.items() if k != "emb"}, cb)
        h = linear(w["in"], transformer_out)                      # [1, dd]
        if cb == 0 or cfg.dep_q == 1:
            tok_emb = text_emb
        else:
            w_emb = step_w["emb"]
            e = scaled_embedding({"weight": w_emb["weight"][cb - 1]}, prev)
            lr = {k: v[cb - 1] for k, v in w_emb["low_rank"].items()}
            tok_emb = linear(lr, e)
        hh = (h + tok_emb).float()
        weights = {
            "qkv": w["attn"]["in_proj"]["weight"],                # [L, ...]
            "out": w["attn"]["out_proj"]["weight"],
            "glu": w["gating"]["linear_in"]["weight"],
            "lout": w["gating"]["linear_out"]["weight"],
            "n1": lay["norm1"]["alpha"], "n2": lay["norm2"]["alpha"],
        }
        y, k_ring, v_ring = dep_full_step(hh, k_ring, v_ring, cb, weights,
                                          cap=cap, heads=dcfg.num_heads,
                                          nlayers=nl)
        logits = linear(w["linears"], y).float()                  # [1, card]
        prev = sample_token(logits, temp, top_k, generator)
        tokens.append(prev)
    return torch.stack(tokens, dim=1)                             # [1, W]


def depformer_generate(cfg: LMConfig, params, transformer_out, text_token,
                       temp: float, top_k: int, generator=None):
    """dep_q audio tokens [B, dep_q] for one frame; the depformer KV state
    is per frame and starts fresh.  In the JAX package's order: the frame
    kernel (K14c), the step megakernel (K14a), the stacked form where
    ``_can_use_dep_stacked`` holds, else the generic one."""
    dep = params["depformer"]
    step_w = _per_step_weights(cfg, dep)
    b = transformer_out.shape[0]
    if _can_use_dep_frame_kernel(cfg, dep, step_w, b):
        return _depformer_generate_frame_kernel(
            cfg, params, transformer_out, text_token, step_w, temp, top_k,
            generator)
    if _can_use_dep_megakernel(cfg, dep, b):
        return _depformer_generate_megakernel(
            cfg, params, transformer_out, text_token, step_w, temp, top_k,
            generator)
    text_emb = _depformer_text_embed(cfg, dep, text_token)
    if not _can_use_dep_stacked(cfg, step_w, b):
        return _depformer_generate_generic(cfg, dep, text_emb,
                                           transformer_out, text_token,
                                           step_w, temp, top_k, generator)
    norms = {"norm1": dep["layers"]["norm1"], "norm2": dep["layers"]["norm2"]}
    return _depformer_generate_stacked(cfg, norms, text_emb, transformer_out,
                                       text_token, step_w, temp, top_k,
                                       generator)


# ---------------------------------------------------------------------------
# delay cache
# ---------------------------------------------------------------------------

def init_gen_state(cfg: LMConfig, batch: int, device="cuda", params=None):
    """Fresh generation state on ``device``: KV rings, the delay cache
    [B, CT, K] filled with UNGENERATED, and the stream offsets [B].  Given
    the weights ``params``, the rings take the temporal megakernel's flat
    layout where ``can_use_temporal_megakernel`` holds (the forward
    dispatches on the layout)."""
    dev = resolve_device(device)
    flat = params is not None and can_use_temporal_megakernel(
        cfg.transformer, params["transformer"], batch)
    return {
        "transformer": init_transformer_state(cfg.transformer, batch, dev,
                                              flat=flat),
        "cache": torch.full((batch, cfg.cache_len, cfg.num_codebooks),
                            UNGENERATED, dtype=torch.int64, device=dev),
        "offset": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _delays_arr(cfg: LMConfig, device):
    d = list(cfg.delays) if cfg.delays else [0] * cfg.num_codebooks
    d = (d + [0] * cfg.num_codebooks)[: cfg.num_codebooks]
    return torch.tensor(d, dtype=torch.int64, device=device)


def write_stream_tokens(cfg: LMConfig, cache, offset, tokens, stream_start):
    """Scatter tokens [B, n] for streams [start, start + n) at slots
    (offset + delay) % CT; returns a new cache."""
    b, n = tokens.shape
    delays = _delays_arr(cfg, cache.device)[stream_start: stream_start + n]
    slots = (offset.long()[:, None] + delays[None, :]) % cfg.cache_len
    bi = torch.arange(b, device=cache.device)[:, None]
    si = torch.arange(stream_start, stream_start + n, device=cache.device)
    cache = cache.clone()
    cache[bi, slots, si[None, :]] = tokens.long()
    return cache


def build_input_frame(cfg: LMConfig, cache, offset):
    """Model input tokens [B, 1, K] for the current step."""
    b = cache.shape[0]
    pos = offset.long() % cfg.cache_len
    cached = cache[torch.arange(b, device=cache.device), pos]   # [B, K]
    delays = _delays_arr(cfg, cache.device)
    initial = torch.tensor([cfg.text_initial] + [cfg.audio_initial] * cfg.n_q,
                           dtype=torch.int64, device=cache.device)
    is_init = offset.long()[:, None] <= delays[None, :]
    return torch.where(is_init, initial[None, :], cached)[:, None, :]


def write_generated(cfg: LMConfig, cache, new_offset, text_token,
                    audio_tokens):
    """Write this step's tokens at slot new_offset % CT (after offset++)."""
    b = cache.shape[0]
    pos = new_offset.long() % cfg.cache_len
    bi = torch.arange(b, device=cache.device)
    cache = cache.clone()
    cache[bi, pos, 0] = text_token.long()
    dep_q = audio_tokens.shape[1]
    si = torch.arange(1, dep_q + 1, device=cache.device)[None, :]
    cache[bi[:, None], pos[:, None], si] = audio_tokens.long()
    return cache


def read_output(cfg: LMConfig, cache, new_offset):
    """The un-delayed output frame: (text [B], audio [B, dep_q],
    valid [B])."""
    b = cache.shape[0]
    dep_q = cfg.runtime_dep_q
    delays = _delays_arr(cfg, cache.device)[: dep_q + 1]
    slots = (new_offset.long()[:, None] - cfg.max_delay
             + delays[None, :]) % cfg.cache_len
    bi = torch.arange(b, device=cache.device)[:, None]
    si = torch.arange(dep_q + 1, device=cache.device)[None, :]
    frame = cache[bi, slots, si]
    text, audio = frame[:, 0], frame[:, 1:]
    valid = ((new_offset > cfg.max_delay) & torch.all(audio != ZERO, dim=-1)
             & torch.all(audio != UNGENERATED, dim=-1))
    return text, audio, valid


# ---------------------------------------------------------------------------
# generation steps
# ---------------------------------------------------------------------------

def lm_text_step(cfg: LMConfig, params, state, other_audio=None,
                 forced_frame=None, condition_sum=None, cross_kv=None,
                 temp_text: float = 0.0, top_k_text: int = 25,
                 generator=None):
    """Phase A of a frame: write the provided inputs, run the temporal
    transformer, sample the text token.  Returns (sampled_text [B],
    transformer_out [B, dim], new_state)."""
    cache = state["cache"]
    offset = state["offset"]
    if forced_frame is not None:
        cache = write_stream_tokens(cfg, cache, offset, forced_frame, 0)
    elif other_audio is not None and other_audio.shape[1] > 0:
        cache = write_stream_tokens(cfg, cache, offset, other_audio,
                                    cfg.runtime_dep_q + 1)
    tokens = build_input_frame(cfg, cache, offset)
    h, logits, new_kv = temporal_forward(cfg, params, state["transformer"],
                                         tokens, offset, condition_sum,
                                         cross_kv)
    text_token = sample_token(logits[:, -1], temp_text, top_k_text,
                              generator)
    new_state = {"transformer": new_kv, "cache": cache, "offset": offset}
    return text_token, h[:, -1], new_state


def lm_audio_step(cfg: LMConfig, params, state, text_token, transformer_out,
                  provided: bool = False, forced_audio=None,
                  depformer_replace: bool = False, temp: float = 0.0,
                  top_k: int = 250, generator=None):
    """Phase B: depformer generation, delay-cache update and output read.
    Returns (outputs {text, audio, valid, sampled_text and, with more
    than two extra heads, vad [B] f32}, new_state)."""
    cache = state["cache"]
    offset = state["offset"]
    b = cache.shape[0]
    dep_q = cfg.runtime_dep_q
    if cfg.dep_q > 0 and not depformer_replace:
        audio = depformer_generate(cfg, params, transformer_out, text_token,
                                   temp, top_k, generator)
    else:
        audio = torch.full((b, dep_q), ZERO, dtype=torch.int64,
                           device=cache.device)
    if cfg.delay_steps:
        delays = _delays_arr(cfg, cache.device)[1: dep_q + 1]
        early = offset.long()[:, None] < (delays[None, :] + cfg.delay_steps)
        audio = torch.where(early, torch.full_like(audio, ZERO), audio)
    if forced_audio is not None:
        forced_audio = forced_audio.to(audio.device).long()
        audio = torch.where(forced_audio != UNGENERATED, forced_audio, audio)
    new_offset = offset + 1
    if not provided:
        cache = write_generated(cfg, cache, new_offset, text_token, audio)
    out_text, out_audio, valid = read_output(cfg, cache, new_offset)
    if depformer_replace:
        valid = torch.zeros_like(valid)
    outputs = {"text": out_text, "audio": out_audio, "valid": valid,
               "sampled_text": text_token}
    if cfg.extra_heads_num > 2:
        vad_w = {"weight": params["extra_heads"]["weight"][2]}
        vad_logits = linear(vad_w, transformer_out).float()
        outputs["vad"] = torch.softmax(vad_logits, dim=-1)[:, 0]
    new_state = {"transformer": state["transformer"], "cache": cache,
                 "offset": new_offset}
    return outputs, new_state


def lm_gen_step(cfg: LMConfig, params, state, other_audio=None,
                forced_frame=None, forced_text=None, forced_audio=None,
                condition_sum=None, cross_kv=None,
                depformer_replace: bool = False,
                temp: float = 0.8, temp_text: float = 0.7,
                top_k: int = 250, top_k_text: int = 25, generator=None):
    """One 80 ms frame (STS / STT / machine-less TTS): temporal forward,
    text sampling, depformer and delay cache.  ``forced_text`` [B] (>= 0
    entries) overrides the sampled text token.  The KV rings in ``state``
    are updated in place; the returned state holds them."""
    text_token, h, state = lm_text_step(
        cfg, params, state, other_audio=other_audio,
        forced_frame=forced_frame, condition_sum=condition_sum,
        cross_kv=cross_kv, temp_text=temp_text, top_k_text=top_k_text,
        generator=generator)
    if forced_text is not None:
        forced_text = forced_text.to(text_token.device).long()
        text_token = torch.where(forced_text >= 0, forced_text, text_token)
    return lm_audio_step(
        cfg, params, state, text_token, h,
        provided=forced_frame is not None, forced_audio=forced_audio,
        depformer_replace=depformer_replace, temp=temp, top_k=top_k,
        generator=generator)
