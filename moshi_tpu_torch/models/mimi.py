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
offsets.  There are no capture taps.
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
                                        audio[..., None])
            h, tr_state = transformer_forward(
                self.cfg.transformer, params["encoder_transformer"],
                state["transformer"], h, state["offset"])
            new_offset = state["offset"] + h.shape[1]
            h, ds_state = self.downsample(params["downsample"],
                                          state["downsample"], h)
            codes = self.quantizer.encode(params["quantizer"], h,
                                          self.cfg.n_q)
        return codes, {"encoder": enc_state, "transformer": tr_state,
                       "offset": new_offset, "downsample": ds_state}

    def decode_step(self, params, state, codes):
        """codes [B, n, n_q] -> (audio [B, n*frame_samples], new_state)."""
        with full_f32_convs():
            h = self.quantizer.decode(params["quantizer"], codes)
            h, up_state = self.upsample(params["upsample"],
                                        state["upsample"], h)
            h, tr_state = transformer_forward(
                self.cfg.transformer, params["decoder_transformer"],
                state["transformer"], h, state["offset"])
            new_offset = state["offset"] + h.shape[1]
            audio, dec_state = self.decoder(params["decoder"],
                                            state["decoder"], h)
        return audio[..., 0], {"upsample": up_state, "transformer": tr_state,
                               "offset": new_offset, "decoder": dec_state}
