"""Mimi streaming neural audio codec: 24 kHz audio <-> RVQ tokens at 12.5 Hz.

Counterpart of ``moshi_tpu/models/mimi.py`` (``MimiConfig``, ``MimiModel``
with its streaming steps):

  encode:  [B, n*1920] audio -> SEANet encoder (24 kHz -> 25 Hz, dim 512)
           -> 8-layer streaming transformer (context 250, T = 2 per step)
           -> downsample conv k4 s2 (25 -> 12.5 Hz)
           -> split RVQ nearest-centroid encode -> codes [B, n, n_q]
  decode:  codes -> split RVQ decode -> depthwise upsample convtr k4 s2
           (12.5 -> 25 Hz) -> 8-layer streaming transformer
           -> SEANet decoder -> [B, n*1920] audio

No kernel of the port runs here: the convs are PyTorch's (cuDNN on the
card, in full f32: each step runs inside ``nn/conv.py``
``full_f32_convs``, whatever the caller set; the JAX package left them
to XLA), and the transformers take the
generic path (``nn/transformer.py``).  The state holds the conv carries,
the transformers' KV rings (bf16, written in place) and the stream
offsets.  The steps have the JAX package's capture taps
(``utils/capture.py``): ``mimi/encoder_out``, ``mimi/enc_tx_out``,
``mimi/downsample_out``, ``mimi/codes``, ``mimi/rvq_decode``,
``mimi/upsample_out``, ``mimi/dec_tx_out`` and ``mimi/decode_out``, with
the SEANet modules' under ``mimi/enc`` / ``mimi/dec`` and the
transformers' layers under ``mimi/enc_tx`` / ``mimi/dec_tx``.

``init_params`` draws the JAX package's tree (its keys, shapes, dtypes and
distributions) from an explicit ``torch.Generator``: threefry draws cannot
be matched, so a test carries the JAX package's weights across with
``runtime/convert.py`` instead.  ``encode`` and ``decode`` run one step
from a fresh state, as the JAX package's conveniences do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.nn.conv import (StreamingConv1d,
                                     StreamingConvTranspose1d,
                                     full_f32_convs)
from moshi_tpu_torch.nn.seanet import SEANetConfig, SEANetDecoder, \
    SEANetEncoder
from moshi_tpu_torch.nn.transformer import (TransformerConfig,
                                            init_transformer_state,
                                            transformer_forward)
from moshi_tpu_torch.nn.vq import SplitRVQ, SplitRVQConfig
from moshi_tpu_torch.utils.capture import capture


@dataclass(frozen=True)
class MimiConfig:
    n_q: int = 32                   # runtime codebooks (<= total)
    total_codebooks: int = 32
    dim: int = 512
    seanet: SEANetConfig = field(default_factory=SEANetConfig)
    codebook_dim: int = 256
    codebook_size: int = 2048
    transformer_layers: int = 8
    transformer_heads: int = 8
    transformer_context: int = 250
    transformer_hidden: int = 2048
    frames_per_step: int = 2        # 25 Hz positions per 12.5 Hz token
    transformer_capacity: int = 0   # ring slots; 0 -> context

    @property
    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            dim=self.dim, num_heads=self.transformer_heads,
            num_layers=self.transformer_layers,
            hidden_dim=self.transformer_hidden,
            context=self.transformer_context,
            capacity=self.transformer_capacity,
            norm="layer_norm", gating="", use_layer_scale=True,
            rope_max_period=10_000.0, bias_proj=False, bias_ffn=False)

    @property
    def quantizer(self) -> SplitRVQConfig:
        return SplitRVQConfig(n_q=self.total_codebooks, n_q_semantic=1,
                              dim=self.dim, codebook_dim=self.codebook_dim,
                              codebook_size=self.codebook_size)

    @property
    def frame_samples(self) -> int:
        return self.seanet.hop_length * self.frames_per_step


class MimiModel:
    """params = {encoder, encoder_transformer, downsample, quantizer,
    upsample, decoder_transformer, decoder} (the JAX package's tree)."""

    def __init__(self, cfg: MimiConfig = MimiConfig()):
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg.seanet)
        self.decoder = SEANetDecoder(cfg.seanet)
        self.quantizer = SplitRVQ(cfg.quantizer)
        self.downsample = StreamingConv1d(cfg.dim, cfg.dim, 4, stride=2,
                                          bias=False)
        self.upsample = StreamingConvTranspose1d(cfg.dim, cfg.dim, 4,
                                                 stride=2, groups=cfg.dim,
                                                 bias=False)

    def param_shapes(self):
        """The parameter tree as {name: (shape, init)}: init is "normal"
        with its scale, "ones", "zeros" or ("const", value), as the JAX
        package's ``init_params`` draws it."""
        cfg = self.cfg

        def conv(m, groups=1):
            k = m.kernel
            tree = {"weight": ((m.out_ch, m.in_ch // groups, k),
                               ("normal", (m.in_ch // groups * k) ** -0.5))}
            if m.bias:
                tree["bias"] = ((m.out_ch,), ("zeros",))
            return tree

        def seanet(mods):
            return {name: conv(m, getattr(m, "groups", 1))
                    for name, m in mods.items()}

        tc = cfg.transformer
        nl, d, hid = tc.num_layers, tc.dim, tc.hidden_dim

        def norm():
            return {"weight": ((nl, d), ("ones",)),
                    "bias": ((nl, d), ("zeros",))}

        def stack():
            return {"layers": {
                "norm1": norm(),
                "self_attn": {
                    "in_proj": {"weight": ((nl, 3 * d, d),
                                           ("normal", d ** -0.5))},
                    "out_proj": {"weight": ((nl, d, d),
                                            ("normal", d ** -0.5))}},
                "norm2": norm(),
                "linear1": {"weight": ((nl, hid, d), ("normal", d ** -0.5))},
                "linear2": {"weight": ((nl, d, hid),
                                       ("normal", hid ** -0.5))},
                "layer_scale_1": {"scale": ((nl, d), ("const", 0.01))},
                "layer_scale_2": {"scale": ((nl, d), ("const", 0.01))},
            }}

        q = cfg.quantizer

        def branch(n):
            return {
                "embeddings": ((n, q.codebook_size, q.codebook_dim),
                               ("normal", 1.0)),
                "input_proj": {"weight": ((q.codebook_dim, q.dim),
                                          ("normal", q.dim ** -0.5))},
                "output_proj": {"weight": ((q.dim, q.codebook_dim),
                                           ("normal",
                                            q.codebook_dim ** -0.5))},
            }

        return {
            "encoder": seanet(self.encoder.modules),
            "encoder_transformer": stack(),
            "downsample": conv(self.downsample),
            "quantizer": {"rvq_first": branch(q.n_q_semantic),
                          "rvq_rest": branch(q.n_q - q.n_q_semantic)},
            "upsample": conv(self.upsample, cfg.dim),
            "decoder_transformer": stack(),
            "decoder": seanet(self.decoder.modules),
        }

    def init_params(self, generator: torch.Generator, dtype=torch.float32,
                    device="cuda"):
        """Random parameters on ``device`` in ``dtype``, every normal leaf
        drawn in f32 from ``generator`` (on ``device``) in the tree's
        order."""
        dev = resolve_device(device)

        def make(shape, init):
            if init[0] == "normal":
                w = torch.randn(shape, generator=generator,
                                device=dev) * init[1]
            elif init[0] == "ones":
                w = torch.ones(shape, device=dev)
            elif init[0] == "zeros":
                w = torch.zeros(shape, device=dev)
            else:
                w = torch.full(shape, init[1], device=dev)
            return w.to(dtype)

        def walk(tree):
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            return make(*tree)

        return walk(self.param_shapes())

    def init_encode_state(self, batch: int, dtype=torch.float32,
                          device="cuda"):
        dev = resolve_device(device)
        return {
            "encoder": self.encoder.init_state(batch, dtype, dev),
            "transformer": init_transformer_state(self.cfg.transformer,
                                                  batch, dev),
            "offset": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "downsample": self.downsample.init_state(batch, dtype, dev),
        }

    def init_decode_state(self, batch: int, dtype=torch.float32,
                          device="cuda"):
        dev = resolve_device(device)
        return {
            "upsample": self.upsample.init_state(batch, dtype, dev),
            "transformer": init_transformer_state(self.cfg.transformer,
                                                  batch, dev),
            "offset": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "decoder": self.decoder.init_state(batch, dtype, dev),
        }

    def encode_step(self, params, state, audio):
        """audio [B, n*frame_samples] -> (codes [B, n, n_q] int64,
        new_state)."""
        t = audio.shape[1]
        if t % self.cfg.frame_samples:
            raise ValueError(f"encode needs multiples of "
                             f"{self.cfg.frame_samples} samples, got {t}")
        with full_f32_convs():
            h, enc_state = self.encoder(params["encoder"], state["encoder"],
                                        audio[..., None], tap="mimi/enc")
            capture("mimi/encoder_out", h)
            h, tr_state = transformer_forward(
                self.cfg.transformer, params["encoder_transformer"],
                state["transformer"], h, state["offset"], tap="mimi/enc_tx")
            capture("mimi/enc_tx_out", h)
            new_offset = state["offset"] + h.shape[1]
            h, ds_state = self.downsample(params["downsample"],
                                          state["downsample"], h)
            capture("mimi/downsample_out", h)
            codes = capture("mimi/codes", self.quantizer.encode(
                params["quantizer"], h, self.cfg.n_q))
        return codes, {"encoder": enc_state, "transformer": tr_state,
                       "offset": new_offset, "downsample": ds_state}

    def decode_step(self, params, state, codes):
        """codes [B, n, n_q] -> (audio [B, n*frame_samples], new_state)."""
        with full_f32_convs():
            h = capture("mimi/rvq_decode",
                        self.quantizer.decode(params["quantizer"], codes))
            h, up_state = self.upsample(params["upsample"],
                                        state["upsample"], h)
            capture("mimi/upsample_out", h)
            h, tr_state = transformer_forward(
                self.cfg.transformer, params["decoder_transformer"],
                state["transformer"], h, state["offset"], tap="mimi/dec_tx")
            capture("mimi/dec_tx_out", h)
            new_offset = state["offset"] + h.shape[1]
            audio, dec_state = self.decoder(params["decoder"],
                                            state["decoder"], h,
                                            tap="mimi/dec")
            capture("mimi/decode_out", audio)
        return audio[..., 0], {"upsample": up_state, "transformer": tr_state,
                               "offset": new_offset, "decoder": dec_state}

    def encode(self, params, audio):
        """audio [B, n*frame_samples] -> codes [B, n, n_q]: one step from
        a fresh state in the audio's dtype, on its device."""
        state = self.init_encode_state(audio.shape[0], audio.dtype,
                                       audio.device)
        return self.encode_step(params, state, audio)[0]

    def decode(self, params, codes):
        """codes [B, n, n_q] -> audio [B, n*frame_samples]: one step from
        a fresh f32 state on the codes' device."""
        state = self.init_decode_state(codes.shape[0], device=codes.device)
        return self.decode_step(params, state, codes)[0]
