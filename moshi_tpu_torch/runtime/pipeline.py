"""The streaming frames: full-duplex speech-to-speech and speech-to-text.

Counterpart of ``moshi_tpu/runtime/pipeline.py`` ``STSPipeline`` and
``STTPipeline`` (the frame function, ``init_state`` and ``step``).  Per
80 ms frame, STS runs

    mic audio [B, 1920] -> Mimi encode -> the other stream's tokens
    -> LM frame (temporal stack, text sampling, depformer, delay cache)
    -> Mimi decode of the generated audio tokens -> speaker audio [B, 1920]

and STT runs Mimi encode -> the LM frame (dep_q = 0: no depformer) -> the
text token and the VAD probability.

The JAX package jits the whole frame into one program; here the frame
runs eagerly, its kernels launched by the LM's wrappers.  Sampling draws
from a ``torch.Generator`` held in the state (the JAX state held a
threefry key).  Not ported yet: the offline ``scan_frames`` (STS and
STT) and the TTS pipeline.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.device import resolve_device
from moshi_tpu_torch.models.lm import LMConfig, init_gen_state, lm_gen_step
from moshi_tpu_torch.models.mimi import MimiModel


class STSPipeline:
    """Full-duplex speech-to-speech, one frame per ``step``."""

    def __init__(self, mimi: MimiModel, lm_cfg: LMConfig, *,
                 temp: float = 0.8, temp_text: float = 0.7,
                 top_k: int = 250, top_k_text: int = 25,
                 mimi_dtype=torch.bfloat16, device="cuda"):
        self.mimi = mimi
        self.lm_cfg = lm_cfg
        self.temp, self.temp_text = temp, temp_text
        self.top_k, self.top_k_text = top_k, top_k_text
        self.mimi_dtype = mimi_dtype
        self.device = resolve_device(device)
        self.frame_samples = mimi.cfg.frame_samples

    def init_state(self, batch: int, seed: int = 0):
        """Fresh Mimi and LM states on the pipeline's device, and the
        sampling generator seeded with ``seed``."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "enc": self.mimi.init_encode_state(batch, self.mimi_dtype, dev),
            "lm": init_gen_state(self.lm_cfg, batch, device=dev),
            "dec": self.mimi.init_decode_state(batch, self.mimi_dtype, dev),
            "generator": gen,
        }

    def step(self, mimi_params, lm_params, state, audio_in,
             condition_sum=None):
        """audio_in [B, frame_samples] f32 -> (outputs {audio_out [B,
        frame_samples] f32, text [B], valid [B], audio_tokens [B, dep_q]},
        new_state).  The states' rings are updated in place."""
        lm_cfg = self.lm_cfg
        n_other = lm_cfg.n_q - lm_cfg.runtime_dep_q
        dep_q = lm_cfg.runtime_dep_q
        mimi_n_q = self.mimi.cfg.n_q
        audio_in = torch.as_tensor(audio_in, device=self.device)
        codes, enc_state = self.mimi.encode_step(
            mimi_params, state["enc"], audio_in.to(self.mimi_dtype))
        other = codes[:, 0, :n_other] if n_other else None
        out, lm_state = lm_gen_step(
            lm_cfg, lm_params, state["lm"], other_audio=other,
            condition_sum=condition_sum, temp=self.temp,
            temp_text=self.temp_text, top_k=self.top_k,
            top_k_text=self.top_k_text, generator=state["generator"])
        # decode our dep_q streams: -1/-2 -> 0, the other books padded with 0
        audio_codes = torch.where(out["audio"] < 0,
                                  torch.zeros_like(out["audio"]),
                                  out["audio"])
        if dep_q < mimi_n_q:
            pad = torch.zeros((audio_codes.shape[0], mimi_n_q - dep_q),
                              dtype=audio_codes.dtype,
                              device=audio_codes.device)
            audio_codes = torch.cat([audio_codes, pad], dim=-1)
        wav, dec_state = self.mimi.decode_step(
            mimi_params, state["dec"], audio_codes[:, None, :mimi_n_q])
        new_state = {"enc": enc_state, "lm": lm_state, "dec": dec_state,
                     "generator": state["generator"]}
        return {"audio_out": wav.float(), "text": out["text"],
                "valid": out["valid"], "audio_tokens": out["audio"]}, \
            new_state


class STTPipeline:
    """Speech-to-text: Mimi encode and the LM frame (dep_q = 0), with the
    VAD head's probability, one frame per ``step``."""

    def __init__(self, mimi: MimiModel, lm_cfg: LMConfig, *,
                 temp_text: float = 0.0, top_k_text: int = 25,
                 mimi_dtype=torch.bfloat16, device="cuda"):
        self.mimi = mimi
        self.lm_cfg = lm_cfg
        self.temp_text, self.top_k_text = temp_text, top_k_text
        self.mimi_dtype = mimi_dtype
        self.device = resolve_device(device)
        self.frame_samples = mimi.cfg.frame_samples

    def init_state(self, batch: int, seed: int = 0):
        """Fresh Mimi encoder and LM states on the pipeline's device, and
        the sampling generator seeded with ``seed``."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return {
            "enc": self.mimi.init_encode_state(batch, self.mimi_dtype, dev),
            "lm": init_gen_state(self.lm_cfg, batch, device=dev),
            "generator": gen,
        }

    def step(self, mimi_params, lm_params, state, audio_in):
        """audio_in [B, frame_samples] f32 -> (outputs {text [B] (the
        sampled text token), vad [B] f32 (zeros without a VAD head)},
        new_state).  The states' rings are updated in place."""
        lm_cfg = self.lm_cfg
        n_other = lm_cfg.n_q - lm_cfg.runtime_dep_q
        audio_in = torch.as_tensor(audio_in, device=self.device)
        codes, enc_state = self.mimi.encode_step(
            mimi_params, state["enc"], audio_in.to(self.mimi_dtype))
        out, lm_state = lm_gen_step(
            lm_cfg, lm_params, state["lm"], other_audio=codes[:, 0, :n_other],
            temp_text=self.temp_text, top_k_text=self.top_k_text,
            generator=state["generator"])
        vad = out.get("vad")
        if vad is None:
            vad = torch.zeros(audio_in.shape[0], dtype=torch.float32,
                              device=self.device)
        return {"text": out["sampled_text"], "vad": vad}, \
            {"enc": enc_state, "lm": lm_state,
             "generator": state["generator"]}
